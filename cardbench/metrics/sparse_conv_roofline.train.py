"""K2 and K4's share of their roofline in a train step: the least time of
the step's gather-GEMM and weight-gradient calls (`work.gemm_work`,
`work.bound`: operations 2 * hits * C * E at the bf16 tensor-core peak of
`peaks.json`, bytes at its HBM rate, counted by the benchmark from the
reference's maps of the same batches) over their profiler device time a
step (`kernels/sparse_conv.json`)."""


def read(run):
    if run["mode"] != "train" or not run.get("device"):
        return None
    t = run["device"]["per_item_s"].get("sparse_conv", 0.0)
    if t <= 0:
        return None
    return 100.0 * run["work"]["sparse_conv_bound_s"] / t
