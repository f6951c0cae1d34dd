"""Device ms a train step of K5 (farthest-point sampling) and K6 (ball
query), from the profiler (`kernels/pointnet.json`). K5 is bound by its
serial steps, not by a roofline."""


def read(run):
    if run["mode"] != "train" or not run.get("device"):
        return None
    t = run["device"]["per_item_s"].get("pointnet", 0.0)
    return t * 1e3 if t > 0 else None
