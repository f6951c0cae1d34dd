"""Fold BatchNorm multiplies into the preceding sparse-conv kernels: the
port's counterpart of `fcaf3d_tpu/utils/fuse_bn.py` (the reference's
`tools/misc/fuse_conv_bn.py` + mmcv `fuse_conv_bn`), on the flax-layout
`{"params", "batch_stats"}` tree of `params.export_variables`.

Inference BatchNorm is `(x - mean) * scale / sqrt(var + eps) + bias`; the
multiply is folded into the conv kernel's output channels (in float32,
then cast back to the kernel's dtype) and the BN is rewritten into a pure
bias-add (scale 1, mean 0, var 1 - eps), which the unchanged model
computes to within rounding. The fused tree is what a published
deployment pickle carries (`tools.publish_model`).
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Tuple

import numpy as np

BN_EPS = 1e-5

# BN module name -> producing conv module name, within the same scope
_PAIR_RULES: Tuple[Tuple[str, str], ...] = (
    ("norm1", "conv1"),
    ("norm2", "conv2"),
    ("downsample_norm", "downsample_conv"),
    ("_bn1", "_tr"),
    ("_bn2", "_conv"),
    ("_bn", "_conv"),
)


def _conv_name_for(bn_name: str):
    for suffix, conv_suffix in _PAIR_RULES:
        if bn_name.endswith(suffix):
            return bn_name[: -len(suffix)] + conv_suffix
    return None


def _to_numpy(tree: Mapping) -> dict:
    """A copy of the nested mapping with numpy leaves (CPU tensors too)."""
    return {k: _to_numpy(v) if isinstance(v, Mapping) else np.asarray(v)
            for k, v in tree.items()}


def fuse_conv_bn(variables: Mapping) -> Tuple[dict, int]:
    """Return (fused variables with numpy leaves, number of conv + BN pairs
    fused). `variables` holds 'params' and 'batch_stats' (numpy arrays or
    CPU tensors) and is not mutated."""
    params = _to_numpy(variables["params"])
    stats = _to_numpy(variables.get("batch_stats", {}))
    n = 0

    def walk(pscope: dict, sscope: dict):
        nonlocal n
        for name in list(pscope.keys()):
            sub = pscope[name]
            if not isinstance(sub, dict):
                continue
            if set(sub.keys()) >= {"scale", "bias"} and name in sscope and \
                    set(sscope[name].keys()) >= {"mean", "var"}:
                conv_name = _conv_name_for(name)
                if conv_name is None or conv_name not in pscope:
                    continue
                conv = pscope[conv_name]
                if "kernel" not in conv:
                    continue
                mean = sscope[name]["mean"]
                var = sscope[name]["var"]
                inv = sub["scale"] / np.sqrt(var + np.float32(BN_EPS))
                kernel = conv["kernel"]
                if kernel.shape[-1] != inv.shape[0]:
                    continue
                conv["kernel"] = (
                    kernel.astype(np.float32) * inv[None, None, :]
                ).astype(kernel.dtype)
                sub["bias"] = sub["bias"] - mean * inv
                sub["scale"] = np.ones_like(sub["scale"])
                sscope[name]["mean"] = np.zeros_like(mean)
                sscope[name]["var"] = np.full_like(var, 1.0 - BN_EPS)
                n += 1
            else:
                walk(sub, sscope.get(name, {}))

    walk(params, stats)
    out = dict(variables)
    out["params"] = params
    out["batch_stats"] = stats
    return out, n
