"""Optimizer and LR schedule (port of `fcaf3d_tpu/train/optim.py`).

The reference recipe: AdamW lr 1e-3, weight decay 1e-4, gradient clip at
global norm 10, LR x0.1 at epochs 8 and 11 of 12, no warm-up. The step is
optax's `chain(clip_by_global_norm, adamw)` in the same f32 arithmetic, so
the same gradients give the JAX package's parameters:

- clip: scale by `max_norm / norm` only when `norm >= max_norm` (torch's
  `clip_grad_norm_` adds 1e-6 to the norm instead);
- AdamW: `m / (sqrt(v) + eps)` on bias-corrected moments, then the
  decoupled decay `+ weight_decay * p` on every parameter, times `-lr`
  (`torch.optim.AdamW` decays by `p * (1 - lr * wd)` and orders eps
  differently).

On the card `step()` runs kernel K8 (`ops/optim/clip_adamw.py`): the norm
and the update over every leaf in two launches, with no host wait; CPU
leaves run the plain loop, in PyTorch ops (`_plain_update`). K8 rounds as
the plain loop rounds on the card, op for op; only the norm's order of
summation differs.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from ..ops.optim import ClipAdamWKernel
from ..utils import tracing


def step_lr_schedule(base_lr: float, steps_per_epoch: int,
                     lr_steps: Sequence[int], gamma: float = 0.1):
    """count -> LR (an f32 value as a Python float): `base_lr` times `gamma`
    for each boundary `epoch * steps_per_epoch` that `count` has reached,
    multiplied in f32 as optax's `piecewise_constant_schedule` does."""
    boundaries = sorted(int(e * steps_per_epoch) for e in lr_steps)

    def schedule(count: int) -> float:
        v = np.float32(base_lr)
        for b in boundaries:
            if count >= b:
                v = np.float32(gamma) * v
        return float(v)

    return schedule


def constant_schedule(lr: float):
    """count -> `lr` as an f32 value (optax's float learning rate)."""
    value = float(np.float32(lr))
    return lambda count: value


class ClipAdamW(torch.optim.Optimizer):
    """Global-norm clip then AdamW, step for step optax's
    `chain(clip_by_global_norm(grad_clip), adamw(schedule, weight_decay))`
    with optax's b1 0.9, b2 0.999, eps 1e-8.

    `step()` reads each parameter's `.grad` (a missing gradient counts as
    zero), updates in place and returns the global gradient norm before
    the clip. `count` is the number of steps taken; the schedule reads it
    before the increment, as optax does. Leaves on a CUDA device take K8
    (every leaf f32, contiguous, on one device, or it raises); CPU leaves
    the plain loop. While tracing is on, a step adds the counters
    `adamw_leaves`, `adamw_fused_leaves` (the leaves K8 took) and
    `adamw_table_uploads` to the open span."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule,
                 weight_decay: float = 1e-4, grad_clip: float = 10.0):
        super().__init__(params, {})
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.count = 0
        self.kernel = ClipAdamWKernel()

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError("ClipAdamW.step takes no closure")
        params = [p for group in self.param_groups for p in group["params"]]
        lr = self.schedule(self.count)
        self.count += 1
        # bias corrections 1 - b ** count, in f32 as optax computes them
        c1 = float(1 - np.float32(self.B1) ** np.float32(self.count))
        c2 = float(1 - np.float32(self.B2) ** np.float32(self.count))
        states = [self.state[p] for p in params]
        for p, state in zip(params, states):
            if not state:
                state["mu"] = torch.zeros_like(p)
                state["nu"] = torch.zeros_like(p)
        fused = params[0].device.type != "cpu"
        tracing.count("adamw_leaves", len(params))
        tracing.count("adamw_fused_leaves", len(params) if fused else 0)
        if fused:
            norm, uploads = self.kernel.step(
                [(p, p.grad, s["mu"], s["nu"]) for p, s in zip(params, states)],
                lr, c1, c2, self.B1, self.B2, self.EPS, self.weight_decay,
                self.grad_clip)
            tracing.count("adamw_table_uploads", uploads)
            return norm
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        self._plain_update(params, grads, states, norm, lr, c1, c2)
        return norm

    def _plain_update(self, params, grads, states, norm, lr, c1, c2) -> None:
        """The clip by `norm` and the AdamW update of each leaf, in PyTorch
        ops; `states` holds each leaf's "mu" and "nu", replaced."""
        clip = norm >= self.grad_clip
        b1, b2 = self.B1, self.B2
        for p, g, state in zip(params, grads, states):
            g = torch.where(clip, g / norm * self.grad_clip, g)
            mu = (1 - b1) * g + b1 * state["mu"]
            nu = (1 - b2) * (g * g) + b2 * state["nu"]
            state["mu"], state["nu"] = mu, nu
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.EPS)
            update = update + self.weight_decay * p
            p.add_(-lr * update)


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-3,
                   weight_decay: float = 1e-4, grad_clip: float = 10.0,
                   steps_per_epoch: int = 1,
                   lr_steps: Sequence[int] = (8, 11)) -> ClipAdamW:
    return ClipAdamW(params, step_lr_schedule(lr, steps_per_epoch, lr_steps),
                     weight_decay=weight_decay, grad_clip=grad_clip)
