"""The masked norm of the sparse path with the residual add and the
activation after it: kernel K7 (`csrc/masked_norm.cu`) and its plain
version.

`masked_norm(feats, keys, scale, bias, mode, act, residual, running)`
computes, over the rows whose key is not SENTINEL,

    act(round(round(norm(feats)) + residual))

with `norm` one of

- "batch": train-mode BatchNorm: the two-pass mean and the biased variance
  of the valid rows of the whole batch (under a data-parallel group, of
  the global batch: the count and sum, then the squared deviations, are
  summed over the ranks), eps 1e-5; the running statistics move by
  `(1 - momentum) * running + momentum * batch`, outside the graph;
- "instance": InstanceNorm, the same statistics per sample;
- "running": eval-mode BatchNorm with the running statistics;

then `* scale + bias`, each in the plain path's order of operations.
`round` is the cast to the activations' dtype,
`act` None, "relu" (`torch.maximum(x, 0)`: gradient 1/2 at exactly 0) or
"elu" (expm1 on the negative side). Invalid rows of the result are 0.

A CPU tensor runs the plain version (`masked_norm_plain`, the PyTorch ops
of `models/blocks.py` as the JAX package writes them). A CUDA tensor runs
K7 through `MaskedNorm`, an autograd Function whose forward is three
kernels (sums, squared deviations, apply; "running" the apply alone) and
whose backward is two (sums of g and g * (x - mean), then dx and the
residual's gradient), or raises on what the kernels do not take; there is
no fallback from one to the other. The backward's per-channel sums are
summed over the ranks of a data-parallel group, so the gradient is the
plain path's through `global_sums`. `norm_plan` fixes each launch's grid
from the shapes alone.

`_native.LAUNCHES["masked_norm"]` counts the kernel launches,
`VARIANT_LAUNCHES` each kernel ("stats", "dev", "apply", "bwd_reduce",
"bwd_apply") by dtype. While tracing is on, each call adds the counters
`norm_rows` (valid rows) and `norm_budget_rows` (rows launched over) to
the open span.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ... import _native
from ...parallel.comm import current_group, global_sums
from ...utils import tracing
from .tensor import SENTINEL

MODES = {"running": 0, "batch": 1, "instance": 2}  # -> the kernels' code
_ACTS = {None: 0, "relu": 1, "elu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NORM_THREADS = 256  # threads a CTA where a row needs fewer
MAX_THREADS = 512  # kMaxThreads of csrc/masked_norm.cu
MIN_PASSES = 4  # rows a thread at least, per CTA
# the partial floats a reducing launch writes at most (groups x CTAs a
# group x C): the last CTA adds them all
MAX_PARTIAL = 65536


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """`x` in f32, or in its own dtype when that is wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def relu_half_tie(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with the JAX package's gradient: 1/2 at exactly 0, where
    `relu` and `clamp_min` give 0 and 1."""
    return torch.maximum(x, x.new_zeros(()))


def elu_masked(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """ELU with expm1 (the fused epilogue's ELU is exp(min(x, 0)) - 1),
    invalid rows 0."""
    out = torch.where(x > 0, x, torch.expm1(x))
    return torch.where(valid[..., None], out, 0.0)


def masked_norm_plain(feats, keys, scale, bias, mode, act=None,
                      residual=None, running=None, eps=1e-5, momentum=0.1):
    """Plain PyTorch version of `masked_norm`, the same arguments and
    result; it moves `running` in place in "batch" mode."""
    valid = keys != SENTINEL
    feats32 = at_least_f32(feats)
    mask = valid[..., None].float()
    if mode == "instance":
        count = torch.clamp_min(mask.sum(dim=1, keepdim=True), 1.0)
        mean = (feats32 * mask).sum(dim=1, keepdim=True) / count
        var = (((feats32 - mean) ** 2) * mask).sum(dim=1,
                                                   keepdim=True) / count
        out = (feats32 - mean) / torch.sqrt(var + eps) * scale + bias
    else:
        if mode == "batch":
            count, total = global_sums(mask.sum(),
                                       (feats32 * mask).sum(dim=(0, 1)))
            count = torch.clamp_min(count, 1.0)
            mean = total / count
            (sq,) = global_sums((((feats32 - mean) ** 2) * mask).sum(
                dim=(0, 1)))
            var = sq / count
            if running is not None:
                with torch.no_grad():
                    for buf, batch in zip(running, (mean, var)):
                        buf.copy_((1 - momentum) * buf + momentum * batch)
        else:
            mean, var = running
        inv = scale / torch.sqrt(var + eps)
        out = (feats32 - mean) * inv + bias
    out = torch.where(valid[..., None], out, 0.0).to(feats.dtype)
    if residual is not None:
        out = out + residual
    if act == "relu":
        out = relu_half_tie(out)
    elif act == "elu":
        out = elu_masked(out, valid)
    return out


class NormPlan(NamedTuple):
    vec: int  # channels a thread: 16 bytes' worth, or 1
    threads: int  # a whole number of rows of C / vec threads
    rows_per_cta: int
    blocks: int  # CTAs a group


def norm_plan(groups: int, rows: int, c: int, dtype) -> NormPlan:
    """K7's grid for `groups` groups of `rows` rows of C channels: a thread
    holds 16 bytes of a row's channels where C fills them (else one
    channel), a CTA at least NORM_THREADS threads' worth of whole rows
    side by side, each thread at least MIN_PASSES rows of its CTA's block;
    the blocks grow until the reducing kernels' partials (groups x CTAs a
    group x C floats) fit MAX_PARTIAL, so that the last CTA's sum of them
    stays short. Raises ValueError where a row needs more than MAX_THREADS
    threads."""
    elt = 2 if dtype == torch.bfloat16 else 4
    vec = 16 // elt if c * elt % 16 == 0 else 1
    tpr = c // vec
    if tpr > MAX_THREADS:
        raise ValueError(f"K7 takes at most {MAX_THREADS} threads a row: "
                         f"C {c} in {dtype} needs {tpr}")
    rp = max(1, NORM_THREADS // tpr)
    cap = max(1, MAX_PARTIAL // (groups * c))  # CTAs a group at most
    passes = max(MIN_PASSES, -(-rows // (rp * cap)))
    per_cta = rp * passes
    return NormPlan(vec, rp * tpr, per_cta, -(-rows // per_cta))


# (device, stream) -> int32 tickets of the reducing kernels (0 between
# launches): a launch may reuse them only after the one before it ran to
# its end, which the launches of one stream do
_TICKETS: dict = {}


def _tickets(like: torch.Tensor, groups: int, stream: int) -> torch.Tensor:
    """The launch ticket and one count a group, zero, on `like`'s device,
    for the launches on `stream`; the kernels leave them zero."""
    key = (like.device, stream)
    have = _TICKETS.get(key)
    if have is None or have.numel() < 1 + groups:
        have = like.new_zeros(1 + groups, dtype=torch.int32)
        _TICKETS[key] = have
    return have


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _operand(t: Optional[torch.Tensor], plan: NormPlan):
    """`t` contiguous, at a 16-byte aligned address where the kernels read
    it by vector."""
    if t is None:
        return None
    t = t.contiguous()
    if plan.vec > 1 and t.data_ptr() % 16:
        t = t.clone()
    return t


def _launch(kernel: str, err: int, dtype) -> None:
    _native.count_launch("masked_norm", kernel, dtype)
    _native.check(err, f"masked_norm ({kernel})")


def _check(feats, keys, scale, bias, residual, running, mode, act):
    dev = feats.device
    if mode not in MODES:
        raise ValueError(f"K7 mode must be one of {tuple(MODES)}, got "
                         f"{mode!r}")
    if act not in _ACTS:
        raise ValueError(f"K7 act must be one of {tuple(_ACTS)}, got {act!r}")
    if feats.dtype not in _DTYPES:
        raise TypeError(f"K7 takes float32 or bfloat16 features, got "
                        f"{feats.dtype}")
    if feats.dim() != 3 or keys.shape != feats.shape[:2] \
            or keys.dtype != torch.int64:
        raise ValueError(f"K7 takes feats [B, N, C] and int64 keys [B, N], "
                         f"got {tuple(feats.shape)} and {tuple(keys.shape)} "
                         f"{keys.dtype}")
    c = feats.shape[2]
    stats = [scale, bias] + list(running or ())
    if any(t.dtype != torch.float32 or t.shape != (c,) for t in stats):
        raise ValueError("K7 takes float32 scale, bias and running "
                         f"statistics of shape [{c}]")
    if residual is not None and (residual.dtype != feats.dtype
                                 or residual.shape != feats.shape):
        raise ValueError("K7 takes a residual of the features' shape and "
                         "dtype")
    if (mode == "running" and running is None
            or mode == "instance" and running is not None):
        raise ValueError(f"K7 mode {mode!r}: 'running' takes running "
                         "statistics, 'instance' none")
    if any(t is not None and t.device != dev
           for t in [keys, residual] + stats):
        raise ValueError("K7 needs every tensor on one CUDA device")


class MaskedNorm(torch.autograd.Function):
    """K7 on CUDA tensors: `apply(feats, scale, bias, residual, keys,
    running_mean, running_var, mode, act, eps, momentum, group)`."""

    @staticmethod
    def forward(ctx, feats, scale, bias, residual, keys, running_mean,
                running_var, mode, act, eps, momentum, group):
        lib = _native.load()
        b, n, c = feats.shape
        groups, rows = (b, n) if mode == "instance" else (1, b * n)
        plan = norm_plan(groups, rows, c, feats.dtype)
        feats, residual = _operand(feats, plan), _operand(residual, plan)
        keys = keys.contiguous()
        geo = (groups, rows, c, plan.rows_per_cta, plan.blocks)
        tail = (_DTYPES[feats.dtype], plan.vec, plan.threads,
                _native.stream_ptr(feats.device))
        if mode == "running":
            stat_a, stat_b = running_mean, running_var
        else:
            tickets = _tickets(feats, groups, tail[-1])
            part = feats.new_empty((groups * plan.blocks, c),
                                   dtype=torch.float32)
            sums = feats.new_empty((groups, 1 + c), dtype=torch.float32)
            _launch("stats", lib.fcaf3d_masked_norm_stats(
                feats.data_ptr(), keys.data_ptr(), part.data_ptr(),
                sums.data_ptr(), tickets.data_ptr(), *geo, *tail),
                feats.dtype)
            local = sums
            if group is not None and mode == "batch":
                sums = group.all_reduce(sums)
            sq = feats.new_empty((groups, c), dtype=torch.float32)
            _launch("dev", lib.fcaf3d_masked_norm_dev(
                feats.data_ptr(), keys.data_ptr(), sums.data_ptr(),
                part.data_ptr(), sq.data_ptr(), tickets.data_ptr(), *geo,
                *tail), feats.dtype)
            if group is not None and mode == "batch":
                sq = group.all_reduce(sq)
            stat_a, stat_b = sums, sq
        if tracing.enabled():
            tracing.count("norm_rows", (keys != SENTINEL).sum()
                          if mode == "running" else local[:, 0].sum())
            tracing.count("norm_budget_rows", b * n)
        update = mode == "batch" and running_mean is not None
        out = torch.empty_like(feats)
        _launch("apply", lib.fcaf3d_masked_norm_apply(
            feats.data_ptr(), keys.data_ptr(), _ptr(residual),
            stat_a.data_ptr(), stat_b.data_ptr(), MODES[mode],
            scale.data_ptr(), bias.data_ptr(),
            _ptr(running_mean if update else None),
            _ptr(running_var if update else None), 1 - momentum, momentum,
            out.data_ptr(), *geo, _ACTS[act], eps, *tail), feats.dtype)
        ctx.save_for_backward(feats, keys, residual, scale, bias, stat_a,
                              stat_b)
        ctx.meta = (mode, act, eps, group, plan)
        return out

    @staticmethod
    def backward(ctx, dout):
        feats, keys, residual, scale, bias, stat_a, stat_b = ctx.saved_tensors
        mode, act, eps, group, plan = ctx.meta
        lib = _native.load()
        b, n, c = feats.shape
        groups, rows = (b, n) if mode == "instance" else (1, b * n)
        dout = _operand(dout.to(feats.dtype), plan)
        geo = (groups, rows, c, plan.rows_per_cta, plan.blocks)
        tail = (_DTYPES[feats.dtype], plan.vec, plan.threads,
                _native.stream_ptr(feats.device))
        part = feats.new_empty((groups * plan.blocks, 2 * c),
                               dtype=torch.float32)
        gsum = feats.new_empty((groups, 2 * c), dtype=torch.float32)
        dscale = torch.empty_like(scale)
        dbias = torch.empty_like(bias)
        _launch("bwd_reduce", lib.fcaf3d_masked_norm_bwd_reduce(
            feats.data_ptr(), keys.data_ptr(), _ptr(residual),
            dout.data_ptr(), stat_a.data_ptr(), stat_b.data_ptr(),
            MODES[mode], scale.data_ptr(), bias.data_ptr(), part.data_ptr(),
            gsum.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
            _tickets(feats, groups, tail[-1]).data_ptr(), *geo, _ACTS[act],
            eps,
            *tail), feats.dtype)
        if group is not None and mode == "batch":
            gsum = group.all_reduce(gsum)
        dx = torch.empty_like(feats)
        dres = (torch.empty_like(residual)
                if residual is not None and ctx.needs_input_grad[3] else None)
        _launch("bwd_apply", lib.fcaf3d_masked_norm_bwd_apply(
            feats.data_ptr(), keys.data_ptr(), _ptr(residual),
            dout.data_ptr(), stat_a.data_ptr(), stat_b.data_ptr(),
            MODES[mode], scale.data_ptr(), bias.data_ptr(), gsum.data_ptr(),
            dx.data_ptr(), _ptr(dres), *geo, _ACTS[act], eps, *tail),
            feats.dtype)
        return (dx, dscale, dbias, dres) + (None,) * 8


def masked_norm(feats: torch.Tensor, keys: torch.Tensor,
                scale: torch.Tensor, bias: torch.Tensor, mode: str,
                act: Optional[str] = None,
                residual: Optional[torch.Tensor] = None,
                running: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                eps: float = 1e-5, momentum: float = 0.1) -> torch.Tensor:
    """`act(round(norm(feats)) + residual)` over the valid rows (module
    docstring), invalid rows 0.

    Args:
        feats: [B, N, C]; keys: [B, N] int64 (SENTINEL on padding rows).
        scale, bias: [C]. mode: "batch", "instance" or "running".
        act: None, "relu" or "elu". residual: optional [B, N, C], added
            after the norm's rounding, before `act`.
        running: (mean, var) [C]: read in "running" mode, moved in place in
            "batch" mode (None: not moved).
    """
    if feats.device.type == "cpu":
        return masked_norm_plain(feats, keys, scale, bias, mode, act,
                                 residual, running, eps, momentum)
    _check(feats, keys, scale, bias, residual, running, mode, act)
    running_mean, running_var = running or (None, None)
    return MaskedNorm.apply(feats, scale, bias, residual, keys, running_mean,
                            running_var, mode, act, eps, momentum,
                            current_group())
