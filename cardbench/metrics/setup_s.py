"""Seconds from the process's start to the first timed request or step:
imports, the weights drawn on the card, the pool of batches, the port's
build and its warm-up."""


def read(run):
    if run["traced"]:
        return None
    return run["setup_s"]
