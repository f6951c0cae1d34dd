"""Gather-GEMM, gather-max and the gather weight gradient in plain
PyTorch: the plain versions of kernels K2, K3 and K4, frozen from the port
with the kernel dispatch removed, so they run as written on any device.

- `fused_gather_gemm`: out[b, m] = sum_k feats[b, idx[b, m, k]] @ W[k], a
  miss (idx == N) adding zero, with the optional inference epilogue
  `act(out * scale + shift [+ add]) * vmask`.
- `fused_gather_max`: out[b, m] = max_k feats[b, idx[b, m, k]] per channel,
  a miss being -inf and an all-miss row finfo.min.
- `fused_gather_dw`: dW[k] = sum_{b,m} feats[b, idx[b, m, k]]^T dout[b, m]
  in f32, a miss adding zero.

Each K2 and K4 call is reported to the active `record.calls` recorders
(its shapes and its map), from which the benchmark counts model FLOPs,
operations and bytes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...record import record_call

_ACTS = {None: 0, "relu": 1, "elu": 2}
N_CHUNKS = 3  # offset chunks summed in order


def _apply_act(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """Epilogue activation in f32. ELU's negative branch is
    expm1(min(x, 0)), which ATen computes with its own vectorised code: on
    a float32 CPU tensor `torch.exp` runs MKL's VML, whose result on one
    intra-op thread's share of a tensor once came out ~4e-5 off in a long
    test run (ROADMAP Queue 3). The kernels compute exp(min(x, 0)) - 1, as
    the TPU kernel does; the two agree within 1e-7."""
    if act == "relu":
        return torch.clamp_min(x, 0.0)
    if act == "elu":
        return torch.where(x > 0, x, torch.expm1(torch.clamp_max(x, 0.0)))
    if act is not None:
        raise ValueError(f"act must be None, 'relu' or 'elu', got {act!r}")
    return x


def apply_epilogue(out, scale, shift, act, vmask=None, add=None):
    """`act(out * scale + shift [+ add]) [* vmask]` in f32, cast back."""
    y = out.float() * scale + shift
    if add is not None:
        y = y + add.float()
    y = _apply_act(y, act)
    if vmask is not None:
        y = y * vmask[..., None].float()
    return y.to(out.dtype)


def _check_epilogue(scale, shift, act, vmask, add):
    if scale is None:
        if shift is not None or act is not None or vmask is not None \
                or add is not None:
            raise ValueError("shift/act/vmask/add need the epilogue's scale")
        return False
    if shift is None or vmask is None:
        raise ValueError("the epilogue needs scale, shift and vmask")
    if act not in _ACTS:
        raise ValueError(f"act must be None, 'relu' or 'elu', got {act!r}")
    return True


def chunk_bounds(k: int):
    """Offsets [lo, hi) of the summation chunks, in order."""
    bounds = np.linspace(0, k, N_CHUNKS + 1).astype(int)
    return [(int(lo), int(hi)) for lo, hi in zip(bounds[:-1], bounds[1:])]


def gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats [B, N, C], idx [B, M, Kc] -> [B, M, Kc, C] with miss -> 0."""
    b, _, c = feats.shape
    fpad = torch.cat([feats, torch.zeros_like(feats[:, :1])], dim=1)
    g = torch.take_along_dim(fpad, idx.reshape(b, -1, 1).long(), dim=1)
    return g.reshape(tuple(idx.shape) + (c,))


def fused_gather_gemm_plain(feats, idx, weight, scale=None, shift=None,
                            act=None, vmask=None, add=None):
    """Plain PyTorch version of K2, same arguments and result. The offsets
    are summed in three chunks, each one product over (offset, channel)
    in the feats dtype, added in order (the JAX package's XLA path)."""
    has_epi = _check_epilogue(scale, shift, act, vmask, add)
    b, _, c = feats.shape
    m = idx.shape[1]
    e = weight.shape[-1]
    out = torch.zeros((b, m, e), dtype=feats.dtype, device=feats.device)
    for lo, hi in chunk_bounds(weight.shape[0]):
        if lo == hi:
            continue
        g = gather_rows(feats, idx[:, :, lo:hi]).reshape(b, m, (hi - lo) * c)
        out = out + g @ weight[lo:hi].reshape((hi - lo) * c, e)
    if has_epi:
        out = apply_epilogue(out, scale, shift, act, vmask, add)
    return out


def fused_gather_max_plain(feats: torch.Tensor, idx: torch.Tensor):
    """Plain PyTorch version of K3, same arguments and result."""
    b, _, c = feats.shape
    m, k = idx.shape[1:]
    neg = torch.full((b, 1, c), torch.finfo(feats.dtype).min,
                     dtype=feats.dtype, device=feats.device)
    fpad = torch.cat([feats, neg], dim=1)
    g = torch.take_along_dim(fpad, idx.reshape(b, -1, 1).long(), dim=1)
    return g.reshape(b, m, k, c).amax(dim=2)


def fused_gather_dw_plain(feats: torch.Tensor, idx: torch.Tensor,
                          dout: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4, same arguments and result: the gathered
    rows [B, M, K, C], then one f32 contraction over (b, m) (float64 in
    float64)."""
    g = gather_rows(feats, idx)
    dtype = torch.promote_types(feats.dtype, torch.float32)
    return torch.einsum("bmkc,bme->kce", g.to(dtype), dout.to(dtype))



def fused_gather_gemm(feats, idx, weight, scale=None, shift=None, act=None,
                      vmask=None, add=None):
    """out[b, m] = sum_k feats[b, idx[b, m, k]] @ weight[k]; a miss row
    (idx == N) contributes zero. feats [B, N, C]; idx [B, M, K] int32 in
    [0, N]; weight [K, C, E]; scale / shift the folded-BN affine [E]; act
    None, 'relu' or 'elu'; vmask [B, M] row validity; add [B, M, E]."""
    record_call("k2", feats, idx, weight.shape[-1], epilogue=scale is not None,
                add=add is not None)
    return fused_gather_gemm_plain(feats, idx, weight, scale, shift, act,
                                   vmask, add)


def fused_gather_max(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m] = max_k feats[b, idx[b, m, k]] per channel; a miss is
    -inf and an all-miss row returns finfo.min (callers mask)."""
    return fused_gather_max_plain(feats, idx)


def fused_gather_dw(feats: torch.Tensor, idx: torch.Tensor,
                    dout: torch.Tensor) -> torch.Tensor:
    """dW[k] = sum_{b,m} feats[b, idx[b, m, k]]^T dout[b, m] in f32; a miss
    adds zero."""
    record_call("k4", feats, idx, dout.shape[-1])
    return fused_gather_dw_plain(feats, idx, dout)
