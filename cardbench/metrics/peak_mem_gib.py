"""`torch.cuda.max_memory_allocated()` over the window, after
`reset_peak_memory_stats()` at its start, in GiB."""


def read(run):
    if run["traced"]:
        return None
    return run["peak_bytes"] / 2 ** 30
