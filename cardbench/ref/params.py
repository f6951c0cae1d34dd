"""Loading a flax-layout `{"params", "batch_stats"}` tree into the
reference's modules, whose names are the flax names (flax `a/b/c` is the
state_dict entry `a.b.c`)."""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """{"a": {"b": x}} -> {"a.b": x}."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flatten(value, name + "."))
        else:
            out[name] = value
    return out


def load_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Copy a flax-layout `{"params", "batch_stats"}` tree into `model`.
    Raises ValueError unless its names and shapes are exactly the model's."""
    flat = {**flatten(variables["params"]),
            **flatten(variables.get("batch_stats", {}))}
    state = model.state_dict()
    if set(flat) != set(state):
        missing = sorted(set(state) - set(flat))[:5]
        extra = sorted(set(flat) - set(state))[:5]
        raise ValueError(f"variable tree does not match the model: missing "
                         f"{missing}, unexpected {extra}")
    with torch.no_grad():
        for name, value in flat.items():
            src = torch.as_tensor(np.asarray(value, np.float32))
            if tuple(src.shape) != tuple(state[name].shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)}, model "
                                 f"wants {tuple(state[name].shape)}")
            state[name].copy_(src)
