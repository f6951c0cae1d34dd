"""Constant tables of the sparse ops, made once a device.

The sparse ops read small constant tables: kernel offsets, the routing of
a generated child map, the trilinear slot weights, the padding coordinate
EXTENT. Built from a host list or array and copied to the card on every
call, each is a pageable host-to-device copy, which the host ends by
waiting on the stream (`cudaStreamSynchronize`): the queue drains, and the
launches that follow run against an idle card. `const_table` makes each
table once per (build function, arguments, device, dtype) and returns
that same tensor on every later request, so a warmed forward copies no
table and never waits on one.

The tables are shared by every caller: none writes into one in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

from ...utils import tracing

_TABLES: Dict[Tuple, torch.Tensor] = {}


def const_table(build: Callable, *args: Hashable, device: torch.device,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`torch.as_tensor(build(*args), dtype=dtype, device=device)`, made on
    the first request for these arguments, and the same tensor on every
    later one (`device`: a tensor's device, with its index).

    While tracing, counts `const_table_builds` in the open span: 1 where
    the table was made, 0 where it was reused."""
    key = (build, args, device, dtype)
    table = _TABLES.get(key)
    built = table is None
    if built:
        # setdefault: threads that race here all get the first one stored
        made = torch.as_tensor(build(*args), dtype=dtype, device=device)
        table = _TABLES.setdefault(key, made)
        built = table is made
    tracing.count("const_table_builds", int(built))
    return table
