"""Checkpoints of a training run (port of `fcaf3d_tpu/train/checkpoint.py`):
one file per epoch under `work_dir/ckpts/`, the newest `max_keep` kept, the
run's `meta.json` beside them, and the `load_from` (weights only) vs
`resume` (model and optimizer) distinction.

A checkpoint `ckpts/epoch_{N}.pt` is written with `torch.save` and read
with `torch.load(weights_only=True)`: {"epoch": N, "count": the
optimizer's step count, "variables": {flax name: CPU tensor}, "mu" and
"nu": ClipAdamW's moments by the same names}. Flax names join the
collection and the module path with "/", e.g.
"params/backbone/conv1/kernel", "batch_stats/backbone/norm1/mean".
`count` is saved here because `torch.optim.Optimizer.state_dict` does not
hold it, and without it a resumed run would restart the LR schedule and
the bias corrections.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import torch

from ..params import _nest, load_variables
from .optim import ClipAdamW

_CKPT = re.compile(r"epoch_(\d+)\.pt$")


def _ckpt_dir(work_dir: str) -> str:
    return os.path.join(work_dir, "ckpts")


def _ckpt_path(work_dir: str, epoch: int) -> str:
    return os.path.join(_ckpt_dir(work_dir), f"epoch_{epoch}.pt")


def save_meta(work_dir: str, meta: dict):
    """Write the run's metadata (classes, config snapshot, seed) to
    `ckpts/meta.json`, in the JAX package's layout."""
    path = _ckpt_dir(work_dir)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_meta(work_dir: str) -> Optional[dict]:
    """Read back checkpoint metadata (classes/config), or None if absent."""
    path = os.path.join(_ckpt_dir(work_dir), "meta.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _flax_names(model: torch.nn.Module) -> Dict[str, str]:
    """{state_dict name: flax name} of every parameter and batch stat."""
    params = {n for n, _ in model.named_parameters()}
    return {n: ("params/" if n in params else "batch_stats/")
            + n.replace(".", "/") for n in model.state_dict()}


def save_checkpoint(work_dir: str, epoch: int, model: torch.nn.Module,
                    optimizer: ClipAdamW, max_keep: int = 1):
    """Save the model's variables and the optimizer's moments and count as
    `ckpts/epoch_{epoch}.pt`, then delete all but the newest `max_keep`
    checkpoints. The file is written under a temporary name and renamed,
    so a run killed while saving leaves the previous latest checkpoint."""
    names = _flax_names(model)
    mu, nu = {}, {}
    for name, p in model.named_parameters():
        # no step taken yet: optax's initial moments are zeros
        state = optimizer.state[p] or {"mu": torch.zeros_like(p),
                                       "nu": torch.zeros_like(p)}
        mu[names[name]] = state["mu"].cpu()
        nu[names[name]] = state["nu"].cpu()
    ckpt = {"epoch": int(epoch), "count": int(optimizer.count),
            "variables": {names[n]: t.detach().cpu()
                          for n, t in model.state_dict().items()},
            "mu": mu, "nu": nu}
    os.makedirs(_ckpt_dir(work_dir), exist_ok=True)
    path = _ckpt_path(work_dir, epoch)
    torch.save(ckpt, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in _epochs(work_dir)[:-max_keep]:
        os.remove(_ckpt_path(work_dir, old))


def _epochs(work_dir: str) -> List[int]:
    path = _ckpt_dir(work_dir)
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(path))
                  if m)


def latest_epoch(work_dir: str) -> Optional[int]:
    """The newest saved epoch, or None when there is no checkpoint."""
    epochs = _epochs(work_dir)
    return epochs[-1] if epochs else None


def _load(work_dir: str, epoch: Optional[int]) -> dict:
    if epoch is None:
        epoch = latest_epoch(work_dir)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint under {work_dir}/ckpts")
    return torch.load(_ckpt_path(work_dir, epoch), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(work_dir: str, model: torch.nn.Module,
                       optimizer: Optional[ClipAdamW] = None,
                       epoch: Optional[int] = None) -> int:
    """Load epoch `epoch`'s checkpoint (default the latest) into `model`
    and, if given, `optimizer` (moments and count), in place; returns the
    epoch. Raises FileNotFoundError without a checkpoint and ValueError
    unless its variables are exactly the model's names and shapes."""
    ckpt = _load(work_dir, epoch)
    load_variables(model, _nest({k.replace("/", "."): v
                                 for k, v in ckpt["variables"].items()}))
    if optimizer is not None:
        names = _flax_names(model)
        for name, p in model.named_parameters():
            optimizer.state[p] = {
                "mu": ckpt["mu"][names[name]].to(p.device),
                "nu": ckpt["nu"][names[name]].to(p.device)}
        optimizer.count = ckpt["count"]
    return ckpt["epoch"]


def load_params(work_dir: str, model: torch.nn.Module) -> List[str]:
    """Weights-only load of the latest checkpoint (`load_from`): every
    variable whose name, shape and dtype the checkpoint has is copied into
    `model`; the others (e.g. the cls conv when a ScanNet-trained run is
    loaded into S3DIS's 5 classes) keep their fresh values and are reported
    and returned by flax name. The optimizer is not touched."""
    saved = _load(work_dir, None)["variables"]
    names = _flax_names(model)
    skipped = []
    with torch.no_grad():
        for name, t in model.state_dict().items():
            flax = names[name]
            src = saved.get(flax)
            if src is None or src.shape != t.shape or src.dtype != t.dtype:
                skipped.append(flax)
                continue
            t.copy_(src)
    if skipped:
        print(f"load_params: kept fresh init for {len(skipped)} leaves "
              f"(shape/path mismatch): {', '.join(skipped[:8])}"
              + (" ..." if len(skipped) > 8 else ""))
    return skipped
