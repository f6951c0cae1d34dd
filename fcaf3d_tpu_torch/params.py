"""Parameters of the port as the JAX package's flax variable tree.

`init_variables(cfg, seed)` draws a `{"params", "batch_stats"}` tree of
numpy arrays with the flax paths and shapes of `fcaf3d_tpu.models.FCAF3D`,
so the same tree can drive both packages; `load_variables` copies such a
tree (or a converted checkpoint's) into the torch modules, whose names are
the flax names (flax `a/b/c` is state_dict `a.b.c`).

The draw is made so that a forward pass does real work at full size: normal
conv kernels at the kaiming (fan_out) scale, norm gains in [0.5, 1.5], BN
running variances in [0.5, 2], a zero `cls_conv` bias, and head kernels
scaled down (`_HEAD_GAIN`) so that on a ScanNet-size scan the logits stay
O(1) and the exp-decoded box distances near 1 m. Scores then spread over
(0, 1) and detections pass `score_thr`. (The flax init's cls bias of -4.6
puts every score near 0.005, below the threshold.)
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from .configs.fcaf3d import FCAF3DConfig
from .models.detector import FCAF3D

_HEAD_GAIN = {"centerness_conv": 0.15, "cls_conv": 0.15, "reg_conv": 0.02}


def variable_shapes(cfg: FCAF3DConfig):
    """({param name: shape}, {batch-stat name: shape}) in state_dict names."""
    model = FCAF3D(cfg, device="meta")
    return ({n: tuple(p.shape) for n, p in model.named_parameters()},
            {n: tuple(b.shape) for n, b in model.named_buffers()})


def _draw_param(rng, name, shape):
    module, leaf = name.rsplit(".", 1)
    owner = module.rsplit(".", 1)[-1]
    if leaf == "kernel":
        k, cin, cout = shape
        std = (_HEAD_GAIN[owner] / np.sqrt(cin) if owner in _HEAD_GAIN
               else np.sqrt(2.0 / (k * cout)))
        return rng.standard_normal(shape) * std
    if leaf.startswith("scale_"):  # the head's per-level exp scale
        return np.ones(shape)
    if leaf == "bias" and owner == "cls_conv":
        return np.zeros(shape)
    if leaf == "scale":  # norm gains
        return rng.uniform(0.5, 1.5, shape)
    if leaf == "bias":
        return rng.normal(0.0, 0.1, shape)
    raise ValueError(f"no draw rule for parameter {name}")


def _draw_stat(rng, name, shape):
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "mean":
        return rng.normal(0.0, 0.1, shape)
    if leaf == "var":
        return rng.uniform(0.5, 2.0, shape)
    raise ValueError(f"no draw rule for batch stat {name}")


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


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


def init_variables(cfg: FCAF3DConfig, seed: int = 0) -> dict:
    """Seeded numpy `{"params", "batch_stats"}` tree (float32 leaves) with
    the flax paths and shapes of `FCAF3D(cfg)`."""
    rng = np.random.default_rng(seed)
    pshapes, sshapes = variable_shapes(cfg)
    params = {n: _draw_param(rng, n, pshapes[n]).astype(np.float32)
              for n in sorted(pshapes)}
    stats = {n: _draw_stat(rng, n, sshapes[n]).astype(np.float32)
             for n in sorted(sshapes)}
    return {"params": _nest(params), "batch_stats": _nest(stats)}


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
