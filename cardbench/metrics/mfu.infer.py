"""A detection request's model FLOPs (forward only) over the request time
of the traced run's untraced share, against the published dense peak of
the configuration's compute dtype (`peaks.json`)."""


def read(run):
    if run["mode"] != "infer" or not run["traced"]:
        return None
    from cardbench import spec
    peak = spec.peaks()["cards"]["H100"]["flops"][run["work"]["dtype"]]
    w = run["window"]
    return 100.0 * run["work"]["flops"] * w["requests"] / w["seconds"] / peak
