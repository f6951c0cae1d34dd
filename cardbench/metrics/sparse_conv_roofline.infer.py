"""K2's share of its roofline in a detection request, as
`sparse_conv_roofline.train` counts it."""


def read(run):
    if run["mode"] != "infer" or not run.get("device"):
        return None
    t = run["device"]["per_item_s"].get("sparse_conv", 0.0)
    if t <= 0:
        return None
    return 100.0 * run["work"]["sparse_conv_bound_s"] / t
