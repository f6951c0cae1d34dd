"""Gather-GEMM and gather-max (port of `fcaf3d_tpu/ops/sparse/gather_kernel.py`).

- `fused_gather_gemm`: out[b, m] = sum_k feats[b, idx[b, m, k]] @ W[k], a
  miss (idx == N) adding zero, with the optional inference epilogue
  `act(out * scale + shift [+ add]) * vmask`. Kernel K2: bf16 on the tensor
  cores (`csrc/gather_gemm_tc.cu`), f32 on the CUDA cores
  (`csrc/gather_gemm_simt.cu`).
- `fused_gather_max`: out[b, m] = max_k feats[b, idx[b, m, k]] per channel,
  a miss being -inf and an all-miss row finfo.min. Kernel K3
  (`csrc/gather_max.cu`): a thread a vector of channels of one output row,
  16 bytes where C fills them, else 8, 4 or 2 (`k3_plan`).
- `fused_gather_dw`: dW[k] = sum_{b,m} feats[b, idx[b, m, k]]^T dout[b, m]
  in f32, a miss adding zero: the weight gradient of `fused_gather_gemm`.
  Kernel K4: bf16 on the tensor cores (`csrc/gather_dw_tc.cu`), f32 on the
  CUDA cores (`csrc/gather_dw.cu`).

The variants are picked by `k2_variant` / `k4_variant` from (C, E, K,
dtype) alone: "tc" (bf16, C % 8 == 0: cp.async row gathers into a
shared-memory ring, ldmatrix, mma.sync m16n8k16 with f32 accumulators) and
"tc_folded" (bf16, C < 16: the K offsets folded into the MMA's depth, or
into its M for K4) for both; K2 in f32 (whose gates hold the card to the
CPU), and in bf16 at shapes the tensor-core kernels do not take, runs float
FMAs on the CUDA cores: "simt_narrow" (C < 16, a thread an output row) or
"simt_tiled" (C >= 16, register-tiled, cp.async ring), both rounding as
one fmaf chain a summation chunk (`csrc/gather_gemm_simt.cu`). K4 off the
tensor cores is "simt" (`csrc/gather_dw.cu`). Tiles and slices are
functions of the shapes only (`k2_tiles`, `k4_tiles`, `dw_slices`).

The K2 and K4 wrappers record their dense-equivalent FLOPs,
2 * B * M * K * C * E, with `utils.flops.record_flops` on both paths.

Each wrapper runs its kernel on a CUDA tensor and its plain PyTorch version
(`*_plain`, the same function) on a CPU tensor; there is no fallback from
one to the other. The kernels are not differentiable: on a CUDA tensor the
K2 and K3 wrappers raise when autograd would record them, and the autograd
Functions of `conv.py` (`gather_gemm`, `sparse_max_pool`) are the way to a
gradient.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ... import _native
from ..._native import SMS
from ...utils.flops import record_flops

_ACTS = {None: 0, "relu": 1, "elu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
N_CHUNKS = 3  # offset chunks summed in order (the JAX fallback's n_chunks)
K2_VARIANTS = ("simt_narrow", "simt_tiled", "tc", "tc_folded")
K4_VARIANTS = ("simt", "tc", "tc_folded")
_TC_VARIANT_IDS = {"tc": 1, "tc_folded": 2}
_SIMT_VARIANT_IDS = {"simt_narrow": 1, "simt_tiled": 2}
NARROW_MAX_C = 16  # K2 narrow: C below this
NARROW_ROWS = 128  # K2 narrow: output rows (threads) a block
K2_FOLD_MAX_DEPTH = 512  # K2 folded: K * C, padded to 16, at most this
K4_FOLD_ROWS = 128  # K4 folded: K * C rows fit one block tile of this


def fold_depth(k: int, c: int) -> int:
    """K * C rounded up to the MMA depth of 16: the folded A row's width."""
    return -(-k * c // 16) * 16


def k2_variant(c: int, e: int, k: int, dtype) -> str:
    """K2's variant for C input and E output channels over K offsets: bf16
    on the tensor cores ("tc_folded" below 16 channels, "tc" at C % 8 ==
    0), everything else (f32, or E or C off the 8-channel granule) on the
    CUDA cores ("simt_narrow" below 16 channels, else "simt_tiled")."""
    if dtype == torch.bfloat16 and e % 8 == 0:
        if c < 16 and fold_depth(k, c) <= K2_FOLD_MAX_DEPTH:
            return "tc_folded"
        if c % 8 == 0:
            return "tc"
    return "simt_narrow" if c < NARROW_MAX_C else "simt_tiled"


def k2_tiles(variant: str, b: int, m: int, e: int, k: int):
    """K2's (tile rows, tile channels, offset chunks). On the tensor cores
    128 x 128 where those tiles fill the SMs and E > 64, else 64 x 64; the
    folded variant 128 x 8 for E <= 8. "simt_tiled" 128 x 64 where those
    tiles fill the SMs, else 64 x 64; "simt_narrow" NARROW_ROWS rows by 8
    channels for E <= 8, else by 16. Where even the 64 x 64 tiles do not
    fill the SMs, "tc" and "simt_tiled" split K >= 3 offsets into the
    `N_CHUNKS` chunks of the plain version, each in blocks of its own. A
    function of the shapes only, so a shape always sums in one order."""
    if variant == "tc_folded":
        return ((128, 8) if e <= 8 else (64, 64)) + (1,)
    if variant == "simt_narrow":
        return (NARROW_ROWS, 8 if e <= 8 else 16, 1)
    if variant == "simt_tiled" and b * -(-m // 128) * -(-e // 64) >= SMS:
        return (128, 64, 1)
    if variant == "tc" and e > 64 \
            and b * -(-m // 128) * -(-e // 128) >= SMS:
        return (128, 128, 1)
    small = b * -(-m // 64) * -(-e // 64) < SMS and k >= N_CHUNKS
    return (64, 64, N_CHUNKS if small else 1)


def k4_variant(c: int, e: int, k: int, dtype) -> str:
    """K4's variant, by the rule of `k2_variant`; the folded variant needs
    the K * C rows of dW in one block tile."""
    if dtype != torch.bfloat16 or e % 8:
        return "simt"
    if c < 16 and k * c <= K4_FOLD_ROWS:
        return "tc_folded"
    return "tc" if c % 8 == 0 else "simt"


def k4_tiles(variant: str, c: int, e: int):
    """K4's block tile (rows of dW, columns of dW): the SIMT kernel's
    64 x 64; on the tensor cores 128 x 128 where C and E are both >= 128,
    else 64 x 64; folded, all K * C rows in one 128-row tile by 64."""
    if variant == "tc_folded":
        return (K4_FOLD_ROWS, 64)
    if variant == "tc" and c >= 128 and e >= 128:
        return (128, 128)
    return (64, 64)


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


def _same_device(device, *tensors):
    return all(t is None or t.device == device for t in tensors)


def _check_no_grad(kernel, *tensors):
    """A CUDA kernel returns a tensor without `grad_fn`: refuse to run one
    where autograd would record the call, rather than cut the graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} is not differentiable: call it through "
            "ops.sparse.conv.gather_gemm / sparse_max_pool, or under "
            "torch.no_grad()")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it at a fresh allocation when its data does not
    start on the 16 bytes that cp.async reads."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fused_gather_gemm_cuda(feats, idx, weight, scale, shift, act, vmask, add,
                            has_epi):
    _check_no_grad("K2", feats, weight, scale, shift, add)
    lib = _native.load()
    dev = feats.device
    if dev.type != "cuda" or not _same_device(dev, idx, weight, scale, shift,
                                              vmask, add):
        raise ValueError("K2 needs every tensor on one CUDA device")
    if feats.dtype not in _DTYPES or weight.dtype != feats.dtype:
        raise TypeError("K2 takes float32 or bfloat16 feats and weight of one "
                        f"dtype, got {feats.dtype} and {weight.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"K2 takes an int32 kernel map, got {idx.dtype}")
    b, n, c = feats.shape
    if idx.dim() != 3 or idx.shape[0] != b or weight.dim() != 3 \
            or weight.shape[:2] != (idx.shape[2], c):
        raise ValueError(f"K2 shapes: feats {tuple(feats.shape)}, idx "
                         f"{tuple(idx.shape)}, weight {tuple(weight.shape)}")
    m, k = idx.shape[1:]
    e = weight.shape[2]
    if has_epi:
        if scale.dtype != torch.float32 or shift.dtype != torch.float32 \
                or scale.shape != (e,) or shift.shape != (e,):
            raise ValueError("K2 takes float32 scale and shift of shape [E]")
        if vmask.dtype != torch.bool or vmask.shape != (b, m):
            raise ValueError("K2 takes a bool vmask of shape [B, M]")
        if add is not None and (add.dtype != feats.dtype
                                or add.shape != (b, m, e)):
            raise ValueError("K2 takes `add` of shape [B, M, E] in the feats "
                             "dtype")
    operands = (feats, idx, weight, scale, shift, vmask, add)
    if not all(t is None or t.is_contiguous() for t in operands):
        raise ValueError("K2 takes contiguous tensors")
    variant = k2_variant(c, e, k, feats.dtype)
    out = feats.new_empty((b, m, e))
    (_, k1), (_, k2), _ = chunk_bounds(k)
    tile_m, tile_n, n_split = k2_tiles(variant, b, m, e, k)
    part = (feats.new_empty((n_split, b, m, e), dtype=torch.float32)
            if n_split > 1 else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    if variant in _SIMT_VARIANT_IDS:
        err = lib.fcaf3d_gather_gemm_simt(
            feats.data_ptr(), idx.data_ptr(), weight.data_ptr(), ptr(scale),
            ptr(shift), ptr(add), ptr(vmask), out.data_ptr(), ptr(part), b,
            n, m, k, c, e, k1, k2, _DTYPES[feats.dtype], _ACTS[act],
            _SIMT_VARIANT_IDS[variant], tile_m, tile_n, n_split,
            _native.stream_ptr(dev))
    else:
        feats, weight = _aligned(feats), _aligned(weight)
        err = lib.fcaf3d_gather_gemm_tc(
            feats.data_ptr(), idx.data_ptr(), weight.data_ptr(), ptr(scale),
            ptr(shift), ptr(add), ptr(vmask), out.data_ptr(), ptr(part), b, n,
            m, k, c, e, _ACTS[act], _TC_VARIANT_IDS[variant], tile_m, tile_n,
            n_split, k1, k2, _native.stream_ptr(dev))
    _native.count_launch("gather_gemm", variant, feats.dtype)
    _native.check(err, f"gather_gemm ({variant})")
    return out


def fused_gather_gemm(feats, idx, weight, scale=None, shift=None, act=None,
                      vmask=None, add=None):
    """out[b, m] = sum_k feats[b, idx[b, m, k]] @ weight[k]; a miss row
    (idx == N) contributes zero.

    Args:
        feats: [B, N, C]; idx: [B, M, K] int32 in [0, N]; weight: [K, C, E].
        scale/shift: optional folded-BN affine [E] f32 (inference epilogue).
        act: None | 'relu' | 'elu' epilogue activation (needs scale).
        vmask: [B, M] bool row validity (required with scale): padding rows
            get zero.
        add: optional [B, M, E] residual added after the affine, before act.

    Raises ValueError when act/vmask/add come without scale (the TPU kernel
    silently dropped them).
    """
    has_epi = _check_epilogue(scale, shift, act, vmask, add)
    b, _, c = feats.shape
    m, k = idx.shape[1:]
    record_flops(2.0 * b * m * k * c * weight.shape[-1])
    if feats.device.type == "cpu":
        return fused_gather_gemm_plain(feats, idx, weight, scale, shift, act,
                                       vmask, add)
    return _fused_gather_gemm_cuda(feats, idx, weight, scale, shift, act,
                                   vmask, add, has_epi)


K3_VARIANTS = ("vec16", "vec8", "vec4", "vec2")


class K3Plan(NamedTuple):
    variant: str  # "vec<vector_bytes>"
    vector_bytes: int  # channels a thread: 16, 8, 4 or (bf16) 2 bytes
    map_vector: int  # map entries a load: 4 (int4) where K % 4 == 0, else 1


def k3_plan(c: int, k: int, dtype) -> K3Plan:
    """K3's vector kernel for C channels over K offsets: the widest vector
    of 16, 8, 4 or 2 bytes (never narrower than one element) that divides a
    row of C channels, so every thread holds whole channels of one row and
    no thread straddles two rows; the map read by int4 where K % 4 == 0."""
    elt = 2 if dtype == torch.bfloat16 else 4
    vb = next(v for v in (16, 8, 4, 2) if v >= elt and c * elt % v == 0)
    return K3Plan(f"vec{vb}", vb, 4 if k % 4 == 0 else 1)


def fused_gather_max_plain(feats: torch.Tensor, idx: torch.Tensor):
    """Plain PyTorch version of K3, same arguments and result."""
    b, _, c = feats.shape
    m, k = idx.shape[1:]
    neg = torch.full((b, 1, c), torch.finfo(feats.dtype).min,
                     dtype=feats.dtype, device=feats.device)
    fpad = torch.cat([feats, neg], dim=1)
    g = torch.take_along_dim(fpad, idx.reshape(b, -1, 1).long(), dim=1)
    return g.reshape(b, m, k, c).amax(dim=2)


def _fused_gather_max_cuda(feats, idx):
    _check_no_grad("K3", feats)
    lib = _native.load()
    dev = feats.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError("K3 needs feats and idx on one CUDA device")
    if feats.dtype not in _DTYPES or idx.dtype != torch.int32:
        raise TypeError(f"K3 takes float32/bfloat16 feats and an int32 map, "
                        f"got {feats.dtype} and {idx.dtype}")
    if feats.dim() != 3 or idx.dim() != 3 or idx.shape[0] != feats.shape[0]:
        raise ValueError(f"K3 shapes: feats {tuple(feats.shape)}, idx "
                         f"{tuple(idx.shape)}")
    if not (feats.is_contiguous() and idx.is_contiguous()):
        raise ValueError("K3 takes contiguous tensors")
    b, n, c = feats.shape
    m, k = idx.shape[1:]
    out = feats.new_empty((b, m, c))
    plan = k3_plan(c, k, feats.dtype)
    feats, idx = _aligned(feats), _aligned(idx)
    err = lib.fcaf3d_gather_max_vec(
        feats.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, m, k, c,
        _DTYPES[feats.dtype], plan.vector_bytes, plan.map_vector,
        torch.finfo(feats.dtype).min, _native.stream_ptr(dev))
    _native.count_launch("gather_max", plan.variant, feats.dtype)
    _native.check(err, f"gather_max ({plan.variant})")
    return out


def fused_gather_max(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m] = max_k feats[b, idx[b, m, k]] per channel; a miss
    (idx == N) is -inf and an all-miss row returns finfo.min (callers mask).

    Args:
        feats: [B, N, C]; idx: [B, M, K] int32 in [0, N].
    """
    if feats.device.type == "cpu":
        return fused_gather_max_plain(feats, idx)
    return _fused_gather_max_cuda(feats, idx)


def fused_gather_dw_plain(feats: torch.Tensor, idx: torch.Tensor,
                          dout: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4, same arguments and result: the gathered
    rows [B, M, K, C], then one f32 contraction over (b, m) (float64 in
    float64)."""
    g = gather_rows(feats, idx)
    dtype = torch.promote_types(feats.dtype, torch.float32)
    return torch.einsum("bmkc,bme->kce", g.to(dtype), dout.to(dtype))


DW_TARGET_BLOCKS = 1024  # K4 cuts the rows into slices until about this many
DW_TC_TARGET_BLOCKS = 2 * SMS  # ... on the tensor cores: two blocks an SM
DW_TILE_ROWS = 32  # K4's row tile (a slice is a whole number of tiles)


def dw_slices(b: int, m: int, k: int, c: int, e: int, variant: str = "simt"):
    """K4's (rows per slice, slices): enough (offset, C tile, E tile, slice)
    blocks to fill the card (the folded variant has no offset or C axis),
    at least 8 row tiles per slice. A function of the shapes only, so the
    slice sums always add in the same order."""
    rows = b * m
    tiles = -(-rows // DW_TILE_ROWS)
    tm, tn = k4_tiles(variant, c, e)
    base = (1 if variant == "tc_folded" else k * -(-c // tm)) * -(-e // tn)
    target = DW_TARGET_BLOCKS if variant == "simt" else DW_TC_TARGET_BLOCKS
    n = max(1, min(-(-target // base), tiles // 8, 65535 // k))
    per = max(1, -(-tiles // n)) * DW_TILE_ROWS
    return per, max(1, -(-rows // per))


def _fused_gather_dw_cuda(feats, idx, dout):
    lib = _native.load()
    dev = feats.device
    if dev.type != "cuda" or not _same_device(dev, idx, dout):
        raise ValueError("K4 needs feats, idx and dout on one CUDA device")
    if feats.dtype not in _DTYPES or dout.dtype != feats.dtype:
        raise TypeError("K4 takes float32 or bfloat16 feats and dout of one "
                        f"dtype, got {feats.dtype} and {dout.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"K4 takes an int32 kernel map, got {idx.dtype}")
    if feats.dim() != 3 or idx.dim() != 3 or dout.dim() != 3 \
            or idx.shape[0] != feats.shape[0] \
            or dout.shape[:2] != idx.shape[:2]:
        raise ValueError(f"K4 shapes: feats {tuple(feats.shape)}, idx "
                         f"{tuple(idx.shape)}, dout {tuple(dout.shape)}")
    if not (feats.is_contiguous() and idx.is_contiguous()
            and dout.is_contiguous()):
        raise ValueError("K4 takes contiguous tensors")
    b, n, c = feats.shape
    m, k = idx.shape[1:]
    e = dout.shape[2]
    variant = k4_variant(c, e, k, feats.dtype)
    per, n_slices = dw_slices(b, m, k, c, e, variant)
    out = torch.empty((k, c, e), dtype=torch.float32, device=dev)
    part = (torch.empty((n_slices, k, c, e), dtype=torch.float32, device=dev)
            if n_slices > 1 else None)
    part_ptr = None if part is None else part.data_ptr()
    if variant == "simt":
        err = lib.fcaf3d_gather_dw(
            feats.data_ptr(), idx.data_ptr(), dout.data_ptr(), part_ptr,
            out.data_ptr(), b, n, m, k, c, e, per, n_slices,
            _DTYPES[feats.dtype], _native.stream_ptr(dev))
    else:
        tile_m, tile_n = k4_tiles(variant, c, e)
        feats, dout = _aligned(feats), _aligned(dout)
        err = lib.fcaf3d_gather_dw_tc(
            feats.data_ptr(), idx.data_ptr(), dout.data_ptr(), part_ptr,
            out.data_ptr(), b, n, m, k, c, e, per, n_slices,
            _TC_VARIANT_IDS[variant], tile_m, tile_n, _native.stream_ptr(dev))
    _native.count_launch("gather_dw", variant, feats.dtype)
    _native.check(err, f"gather_dw ({variant})")
    return out


def fused_gather_dw(feats: torch.Tensor, idx: torch.Tensor,
                    dout: torch.Tensor) -> torch.Tensor:
    """dW[k] = sum_{b,m} feats[b, idx[b, m, k]]^T (outer) dout[b, m]; a miss
    (idx == N) adds zero. The weight gradient of `fused_gather_gemm`.

    Args:
        feats: [B, N, C]; idx: [B, M, K] int32 in [0, N]; dout: [B, M, E].
    Returns:
        dW [K, C, E] float32.
    """
    b, _, c = feats.shape
    m, k = idx.shape[1:]
    record_flops(2.0 * b * m * k * c * dout.shape[-1])
    if feats.device.type == "cpu":
        return fused_gather_dw_plain(feats, idx, dout)
    return _fused_gather_dw_cuda(feats, idx, dout)
