"""Mean ms of the model's forward in a train step: a host-clock span with a
synchronise at each end, from forward hooks on the model."""


def read(run):
    if run["mode"] != "train" or not run["traced"]:
        return None
    return run["spans"].get("forward")
