"""Mean ms of the model's forward in a detection request (forward hooks, a
synchronise at each end)."""


def read(run):
    if run["mode"] != "infer" or not run["traced"]:
        return None
    return run["spans"].get("forward")
