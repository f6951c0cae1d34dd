"""Kernel launches a detection request, counted from the profiler's device
kernels (copies and fills left out)."""


def read(run):
    if run["mode"] != "infer" or not run.get("device"):
        return None
    return run["device"]["launches_per_item"]
