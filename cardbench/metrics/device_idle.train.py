"""The device's idle share in the profiled steps or requests: 1 - the union
of the kernels' intervals over the profiled window."""


def read(run):
    if run["mode"] != "train" or not run.get("device"):
        return None
    d = run["device"]
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
