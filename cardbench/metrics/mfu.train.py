"""The whole train step's model FLOPs (`work.model_flops`: the sparse
convolutions' dense-equivalent 2 * B * M * K * C * E a K2 / K4 call, the
dense layers' products and their gradients) over the step time of the
traced run's untraced share, against the published dense peak of the
configuration's compute dtype (`peaks.json`: bf16 989 TFLOP/s, float32
67 TFLOP/s on the CUDA cores)."""


def read(run):
    if run["mode"] != "train" or not run["traced"]:
        return None
    from cardbench import spec
    peak = spec.peaks()["cards"]["H100"]["flops"][run["work"]["dtype"]]
    w = run["window"]
    return 100.0 * run["work"]["flops"] * w["steps"] / w["seconds"] / peak
