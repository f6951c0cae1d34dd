"""Parameters of the port as the JAX package's flax variable tree.

`init_variables(cfg, seed)` draws a `{"params", "batch_stats"}` tree of
numpy arrays with the flax paths and shapes of `fcaf3d_tpu.models.FCAF3D`
(`init_votenet_variables` of `fcaf3d_tpu.models.votenet.VoteNet`, or of
`fcaf3d_tpu.models.votenet_v1.VoteNetV1` for a v1 config;
`init_detector2d_variables` of `fcaf3d_tpu.models.detector2d.Detector2D`,
`init_imvotenet_variables` of `fcaf3d_tpu.models.imvotenet.ImVoteNet`), so
the same tree can drive both packages; `load_variables` copies such a tree (or
a converted checkpoint's) into the torch modules, whose names are the flax
names (flax `a/b/c` is state_dict `a.b.c`).

The draw is made so that a forward pass does real work at full size: normal
kernels at the kaiming scale (fan_out for sparse convs, fan_in for dense
layers and for 2D convs, whose HWIO kernels have fan-in H x W x Cin), norm
gains in [0.5, 1.5], BN running variances in [0.5, 2], and
head kernels scaled (`_HEAD_GAIN`, `_VOTE_HEAD_GAIN`), a Bottleneck's last
norm gain too (`_RESIDUAL_GAIN`). For FCAF3D, on a
ScanNet-size scan the logits then stay O(1) and the exp-decoded box
distances near 1 m; with a zero `cls_conv` bias scores spread over (0, 1)
and detections pass `score_thr`. (The flax init's cls bias of -4.6 puts
every score near 0.005, below the threshold.)
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from .configs.fcaf3d import FCAF3DConfig
from .configs.votenet import VoteNetConfig
from .models.detector import FCAF3D
from .models.detector2d import Detector2D
from .models.imvotenet import ImVoteNet
from .models.votenet_v1 import build_votenet

_HEAD_GAIN = {"centerness_conv": 0.15, "cls_conv": 0.15, "reg_conv": 0.02}
# the last BN gain of a Bottleneck's residual branch: with evaluation-mode
# BN the 23 blocks of depth 101's third stage add their branches' variance
# to the residual stream, and at gains of ~1 its scale grows ~100x by the
# stage's end, and the exp-decoded box distances overflow
_RESIDUAL_GAIN = {"norm3": 0.25}
# VoteNet: at random init the class scores obj x sem sit near 0.5 x 1/C,
# right at `score_thr` = 0.05 for C = 10, and unscaled votes and box
# regressions throw proposals and boxes away from the points, leaving
# fewer than the 5 points inside that a detection needs. So the class
# logits get a gain of 2 (some classes clearly win, objectness ~0.8 without
# saturating), and the votes and box regressions are scaled down (offsets
# of centimetres, boxes near 0.5 x 0.6 x 1 m around their proposal). The
# aggregation's first layer reads unit-norm 256-channel vote features
# (~1/16 per channel): its gain of 16 gives them the scale of the other
# layers' inputs. The v1 head's `conv_reg` takes the same gain: its bin
# logits stay near 0, so each proposal's box is the mean size of a class
# with a small residual, around its proposal.
_VOTE_HEAD_GAIN = {"conv_cls": 2.0, "conv_reg": 0.02, "conv_out": 0.05,
                   "vote_aggregation.mlp0.Dense_0": 16.0}
# Detector2D: flax's `cls_pred` bias of -4 puts every 2D score near 0.02,
# below `score_thr` = 0.1, and the fused path would see no box. With a zero
# bias and a gain of 1 (fan-in scale without kaiming's sqrt 2) the class and
# centerness logits of the GroupNorm-ReLU features are O(1), so scores
# spread over ~0.1-0.6 and the per-class NMS keeps dozens of boxes a frame
# (on chip_smoke's 480 x 640 frames all 64 slots of the decode fill);
# `reg_pred`'s gain of 0.5 keeps the exp-decoded distances near one stride
# (boxes ~2 strides wide at each level). ImVoteNet's towers take
# `_VOTE_HEAD_GAIN`: the same modules and names as VoteNet's, 512-wide seeds.
_DET2D_HEAD_GAIN = {"cls_pred": 1.0, "ctr_pred": 1.0, "reg_pred": 0.5}


def variable_shapes(cfg: FCAF3DConfig):
    """({param name: shape}, {batch-stat name: shape}) in state_dict names."""
    return _model_shapes(FCAF3D(cfg, device="meta"))


def _model_shapes(model: torch.nn.Module):
    params = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return params, {n: tuple(b.shape) for n, b in model.state_dict().items()
                    if n not in params}


def votenet_variable_shapes(cfg: VoteNetConfig, coder=None):
    """`variable_shapes` of `VoteNet(cfg)`, or of `VoteNetV1(cfg, coder)`
    for a v1 config."""
    return _model_shapes(build_votenet(cfg, coder, device="meta"))


def _draw_param(rng, name, shape, gains, zero_bias):
    module, _, leaf = name.rpartition(".")
    owner = module.rsplit(".", 1)[-1]
    if leaf == "kernel":
        gain = gains.get(module, gains.get(owner))
        # fan-in: Cin of a sparse conv [K, Cin, Cout] (gained only), in of a
        # dense [in, out], H x W x Cin of a 2D conv's HWIO kernel
        fan_in = shape[-2] if len(shape) == 3 else int(np.prod(shape[:-1]))
        if gain is not None:
            std = gain / np.sqrt(fan_in)
        elif len(shape) == 3:  # sparse conv [K, Cin, Cout]: fan_out
            std = np.sqrt(2.0 / (shape[0] * shape[2]))
        else:
            std = np.sqrt(2.0 / fan_in)
        return rng.standard_normal(shape) * std
    if leaf.startswith("scale_") or not module:
        # the heads' per-level exp scales (FCAF3D's `scale_*`, Detector2D's
        # top-level 0-d `scale0..2`)
        return np.ones(shape)
    if leaf == "bias" and owner in zero_bias:
        return np.zeros(shape)
    if leaf == "scale":  # norm gains
        return rng.uniform(0.5, 1.5, shape) * _RESIDUAL_GAIN.get(owner, 1.0)
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


def _draw_tree(shapes, seed, gains, zero_bias) -> dict:
    rng = np.random.default_rng(seed)
    pshapes, sshapes = shapes
    params = {n: _draw_param(rng, n, pshapes[n], gains,
                             zero_bias).astype(np.float32)
              for n in sorted(pshapes)}
    stats = {n: _draw_stat(rng, n, sshapes[n]).astype(np.float32)
             for n in sorted(sshapes)}
    tree = {"params": _nest(params)}
    if stats:
        tree["batch_stats"] = _nest(stats)
    return tree


def init_variables(cfg: FCAF3DConfig, seed: int = 0) -> dict:
    """Seeded numpy `{"params", "batch_stats"}` tree (float32 leaves) with
    the flax paths and shapes of `FCAF3D(cfg)`."""
    return _draw_tree(variable_shapes(cfg), seed, _HEAD_GAIN, {"cls_conv"})


def init_votenet_variables(cfg: VoteNetConfig, seed: int = 0,
                           coder=None) -> dict:
    """The same for `VoteNet(cfg)` (the JAX module built with the config's
    n_classes, num_proposal and backbone_num_points), or for a v1 config
    `VoteNetV1(cfg, coder)`."""
    return _draw_tree(votenet_variable_shapes(cfg, coder), seed,
                      _VOTE_HEAD_GAIN, {"conv_cls"})


def init_detector2d_variables(n_classes: int = 10, width: int = 64,
                              fpn_ch: int = 128, seed: int = 0) -> dict:
    """The same for `Detector2D(n_classes, width, fpn_ch)`: `params` only
    (GroupNorm keeps no batch statistics)."""
    return _draw_tree(_model_shapes(Detector2D(n_classes, width, fpn_ch,
                                               device="meta")),
                      seed, _DET2D_HEAD_GAIN, {"cls_pred"})


def init_imvotenet_variables(cfg: VoteNetConfig, seed: int = 0,
                             num_sampled_seed: int = 1024,
                             max_imvote: int = 3) -> dict:
    """The same for `ImVoteNet` (the JAX module built with the config's
    n_classes, n_reg_outs, num_proposal and backbone_num_points, and these
    `num_sampled_seed` and `max_imvote`)."""
    return _draw_tree(_model_shapes(ImVoteNet(cfg, num_sampled_seed,
                                              max_imvote, device="meta")),
                      seed, _VOTE_HEAD_GAIN, {"conv_cls"})


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


def export_variables(model: torch.nn.Module) -> dict:
    """The inverse of `load_variables`: the model's `{"params",
    "batch_stats"}` tree in the flax layout, numpy float32 leaves on the
    host (`load_variables(m, export_variables(m))` changes nothing)."""
    names = {n for n, _ in model.named_parameters()}
    params, stats = {}, {}
    for name, value in model.state_dict().items():
        leaf = value.detach().to("cpu", torch.float32).numpy().copy()
        (params if name in names else stats)[name] = leaf
    tree = {"params": _nest(params)}
    if stats:
        tree["batch_stats"] = _nest(stats)
    return tree
