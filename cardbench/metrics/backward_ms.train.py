"""Mean ms from the loss's end to the optimizer's start: the backward (and
the step's code between them)."""


def read(run):
    if run["mode"] != "train" or not run["traced"]:
        return None
    return run["spans"].get("backward")
