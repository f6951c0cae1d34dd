"""The 95th percentile (nearest rank) of every batch request's latency in
the window, from the call into `detect_batch` to its detections on the
host."""


def read(run):
    if run["mode"] != "infer" or run["traced"]:
        return None
    from cardbench.window import percentile
    return percentile(run["window"]["latencies"], 95) * 1e3
