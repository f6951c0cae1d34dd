"""Scans that completed a train step in the window, over the whole window
(host clock, ended by a synchronise)."""


def read(run):
    if run["mode"] != "train" or run["traced"]:
        return None
    w = run["window"]
    return w["steps"] * run["batch"] / w["seconds"]
