"""Data parallelism of the port (`comm.py`) and its CPU dry run
(`dryrun.py`)."""
from .comm import (  # noqa: F401
    Group,
    all_gather_object,
    all_reduce_grads,
    barrier,
    broadcast_module,
    current_group,
    data_parallel,
    destroy,
    global_batch,
    global_sums,
    init_from_env,
    init_group,
    rank,
    spawn,
    world,
)
