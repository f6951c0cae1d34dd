"""Mean ms of the train step's loss function (`fcaf3d_loss`, `votenet_loss`),
a span around it as `train.trainer` calls it."""


def read(run):
    if run["mode"] != "train" or not run["traced"]:
        return None
    return run["spans"].get("loss")
