"""Mean ms of `ClipAdamW.step`: a span around the optimizer's `step`."""


def read(run):
    if run["mode"] != "train" or not run["traced"]:
        return None
    return run["spans"].get("optimizer")
