"""The optimizer step on the card: kernel K8 (`csrc/clip_adamw.cu`), the
global-norm gradient clip and AdamW over every leaf of a train state in two
launches, and a copy of the leaves' table to the card when it changes.

`ClipAdamWKernel.step(leaves, ...)` takes the leaves of one step as
(p, g, mu, nu) tuples, g None for a leaf without a gradient (read as
zeros), and returns the global norm of the gradients before the clip as a
0-dim f32 tensor on the card, with no host wait: `clip_adamw_norm` writes
it, `clip_adamw_update` reads it and updates p, mu and nu in place in the
plain loop's order of operations (`train/optim.py`) and with its rounding
on the card: ATen's CUDA kernels divide a tensor by a Python float (the
two bias corrections) as a multiply by its f32 reciprocal, and so does K8.
Every tensor must be f32, contiguous and on one CUDA device, g, mu and nu
of p's shape: anything else raises before any launch, and nothing falls
back to the plain loop.

The kernels read the leaves from a table on the card (`work_rows`: each
leaf's parameter and moment addresses, its length and its first chunk of
CHUNK elements), which the step checks the leaves for, lays out and
uploads, from pinned memory with `non_blocking=True`, only when one of
those addresses changes (a new train state, a checkpoint's restore). The
gradients move from step to step (`zero_grad(set_to_none=True)`): their
addresses go to the kernels as a kernel parameter, at most MAX_LEAVES of
them, so a step copies nothing to the card. PyTorch's `.grad` setter and
the autograd engine keep a gradient's dtype, device and shape its
parameter's; the step checks that it is contiguous.

`_native.LAUNCHES["clip_adamw"]` counts the launches, `VARIANT_LAUNCHES`
each kernel ("norm", "update").
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import _native

CHUNK = 16384  # kChunk of csrc/clip_adamw.cu: elements a CTA
FIELDS = 5  # kFields: p, mu, nu, numel, first chunk
MAX_LEAVES = 480  # kMaxLeaves: the gradients' addresses a launch takes

Leaf = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor,
             torch.Tensor]


def check_leaves(leaves: Sequence[Leaf]) -> torch.device:
    """The leaves' one CUDA device; raises TypeError on a dtype other than
    float32 and ValueError on another device, a non-contiguous tensor, a
    moment or gradient of another shape than its parameter, or more than
    MAX_LEAVES leaves that hold an element."""
    dev = leaves[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"K8 takes CUDA tensors, got a leaf on {dev}")
    for i, leaf in enumerate(leaves):
        shape = leaf[0].shape
        for name, t in zip(("parameter", "gradient", "mu", "nu"), leaf):
            if t is None:
                continue
            if t.dtype != torch.float32:
                raise TypeError(f"K8 takes float32 leaves: leaf {i}'s {name} "
                                f"is {t.dtype}")
            if t.device != dev or t.shape != shape or not t.is_contiguous():
                raise ValueError(
                    f"K8 needs every leaf's parameter, gradient and moments "
                    f"contiguous, of one shape, on one CUDA device: leaf "
                    f"{i}'s {name} is {tuple(t.shape)} on {t.device}, "
                    f"contiguous {t.is_contiguous()}")
    n = sum(leaf[0].numel() > 0 for leaf in leaves)
    if n > MAX_LEAVES:
        raise ValueError(f"K8 takes at most {MAX_LEAVES} leaves, got {n}")
    return dev


def work_rows(leaves: Sequence[Leaf]) -> Tuple[List[tuple], int]:
    """The kernels' table: a row (p, mu, nu addresses, numel, first chunk)
    for each leaf that holds an element, and the chunks of CHUNK elements
    in all (the launches' CTAs)."""
    rows, chunks = [], 0
    for p, _, mu, nu in leaves:
        n = p.numel()
        if n == 0:
            continue
        rows.append((p.data_ptr(), mu.data_ptr(), nu.data_ptr(), n, chunks))
        chunks += -(-n // CHUNK)
    return rows, chunks


def hyper(lr: float, c1: float, c2: float, b1: float, b2: float, eps: float,
          weight_decay: float, grad_clip: float) -> Tuple[float, ...]:
    """`fcaf3d_clip_adamw_update`'s scalars (grad_clip, b1, 1 - b1, b2,
    1 - b2, 1 / c1, 1 / c2, eps, weight decay, -lr), each rounded to f32 as
    PyTorch rounds the plain loop's Python scalars (1 - b1 taken in double
    first); 1 / c divided in f32, as ATen's CUDA division by a host scalar
    takes it."""
    f32 = np.float32
    inv = [f32(1) / f32(c) for c in (c1, c2)]
    vals = (grad_clip, b1, 1 - b1, b2, 1 - b2, *inv, eps, weight_decay, -lr)
    return tuple(float(f32(v)) for v in vals)


class ClipAdamWKernel:
    """K8's state for one optimizer: the parameters' and moments' addresses
    the table was laid out for, the table on the card, the leaves that
    hold an element, the last step's gradient addresses, the norm's slots
    and ticket, the tables uploaded so far."""

    def __init__(self):
        self.key = self.device = None
        self.kept: List[int] = []
        self.chunks = 0
        self.grads = np.zeros(0, np.int64)
        self.table = self.slots = self.ticket = None
        self.uploads = 0

    def _layout(self, leaves: Sequence[Leaf], key: list) -> None:
        dev = check_leaves(leaves)
        rows, self.chunks = work_rows(leaves)
        self.kept = [i for i, leaf in enumerate(leaves) if leaf[0].numel()]
        like = leaves[0][0]
        if self.device != dev:
            self.device, self.slots = dev, None
            self.ticket = like.new_zeros(1, dtype=torch.int32)
        if self.slots is None or self.slots.numel() < self.chunks:
            self.slots = like.new_empty(self.chunks, dtype=torch.float32)
        src = torch.tensor(rows, dtype=torch.int64)
        self.table = like.new_empty(src.shape, dtype=torch.int64)
        if self.table.is_cuda:
            src = src.pin_memory()
        self.table.copy_(src, non_blocking=True)
        self.uploads += 1
        self.key = key

    def step(self, leaves: Sequence[Leaf], lr: float, c1: float, c2: float,
             b1: float, b2: float, eps: float, weight_decay: float,
             grad_clip: float) -> Tuple[torch.Tensor, int]:
        """One clip + AdamW step of `leaves` in place (module docstring).
        Returns (the norm before the clip, tables uploaded: 0 or 1)."""
        key = [(p.data_ptr(), mu.data_ptr(), nu.data_ptr())
               for p, _, mu, nu in leaves]
        uploads = self.uploads
        if key != self.key:
            self._layout(leaves, key)
        else:
            for i, leaf in enumerate(leaves):
                if leaf[1] is not None and not leaf[1].is_contiguous():
                    raise ValueError(f"K8 needs contiguous gradients: leaf "
                                     f"{i}'s is not")
        lib = _native.load()
        self.grads = np.array([0 if leaves[i][1] is None
                               else leaves[i][1].data_ptr()
                               for i in self.kept], np.int64)
        grads = self.grads.ctypes.data
        stream = _native.stream_ptr(self.device)
        norm = leaves[0][0].new_empty((), dtype=torch.float32)
        n = len(self.kept)
        _launch("norm", lib.fcaf3d_clip_adamw_norm(
            self.table.data_ptr(), n, self.chunks, grads,
            self.slots.data_ptr(), self.ticket.data_ptr(), norm.data_ptr(),
            stream))
        _launch("update", lib.fcaf3d_clip_adamw_update(
            self.table.data_ptr(), n, self.chunks, grads, norm.data_ptr(),
            *hyper(lr, c1, c2, b1, b2, eps, weight_decay, grad_clip),
            stream))
        return norm, self.uploads - uploads


def _launch(kernel: str, err: int) -> None:
    _native.count_launch("clip_adamw", kernel, torch.float32)
    _native.check(err, f"clip_adamw ({kernel})")
