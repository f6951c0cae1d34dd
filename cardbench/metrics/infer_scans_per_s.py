"""Scans whose detections reached the host as numpy in the window, over the
whole window (host clock)."""


def read(run):
    if run["mode"] != "infer" or run["traced"]:
        return None
    w = run["window"]
    return w["requests"] * run["batch"] / w["seconds"]
