"""Farthest-point sampling, kernel K5 (port of the contract of
`fcaf3d_tpu/ops/pointnet/ops.py::furthest_point_sample` and its TPU kernel
`fps_kernel.py::fps_tpu`).

D-FPS from the first valid index: each step takes the valid point farthest
from the chosen set, the lowest index among equal distances. When S exceeds
the number of valid points, every distance is 0 after they are all chosen
and the selection repeats the first valid index, as the JAX package's does.

On a CUDA tensor the sampling is kernel K5 (`csrc/fps.cu`); on a CPU tensor
it is the plain PyTorch version, `furthest_point_sample_plain`. Both round
the distance as `(dx*dx + dy*dy) + dz*dz`, one operation at a time, so they
pick the same indices.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import _native

_BIG = 1e10
# largest N whose running minima the kernel keeps in shared memory (192 KB
# of the H100's 227 KB per block); larger clouds use a global scratch row
SMEM_POINTS = 48 * 1024


def furthest_point_sample_plain(points: torch.Tensor, num_samples: int,
                                valid: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of K5, same arguments and result. Each step's
    distance is written per column, so its order of operations is fixed."""
    b, n, _ = points.shape
    pts = points.float()
    x, y, z = (pts[..., c].contiguous() for c in range(3))
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=points.device)
    out = torch.zeros((b, num_samples), dtype=torch.int64,
                      device=points.device)
    if num_samples == 0:
        return out.int()
    # argmax of a bool row: its first True, 0 when there is none
    out[:, 0] = torch.argmax(valid.to(torch.uint8), dim=1)
    dcur = torch.full((b, n), _BIG, dtype=torch.float32, device=points.device)
    neg = torch.full((), -1.0, dtype=torch.float32, device=points.device)
    for i in range(1, num_samples):
        last = out[:, i - 1:i]
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        d = (dx * dx + dy * dy) + dz * dz
        dcur = torch.minimum(dcur, d)
        out[:, i] = torch.argmax(torch.where(valid, dcur, neg), dim=1)
    return out.int()


def _fps_cuda(points, num_samples, valid):
    lib = _native.load()
    dev = points.device
    if dev.type != "cuda" or (valid is not None and valid.device != dev):
        raise ValueError(f"K5 needs its tensors on one CUDA device, got "
                         f"{dev} and {None if valid is None else valid.device}")
    if points.dtype != torch.float32 or points.dim() != 3 \
            or points.shape[2] != 3:
        raise TypeError(f"K5 takes f32 points [B, N, 3], got {points.dtype} "
                        f"{tuple(points.shape)}")
    b, n, _ = points.shape
    if valid is not None and (valid.dtype != torch.bool
                              or tuple(valid.shape) != (b, n)):
        raise TypeError(f"K5 takes a bool valid mask [B, N], got "
                        f"{valid.dtype} {tuple(valid.shape)}")
    if not points.is_contiguous() or (valid is not None
                                      and not valid.is_contiguous()):
        raise ValueError("K5 takes contiguous points and valid mask")
    out = torch.empty((b, num_samples), dtype=torch.int32, device=dev)
    scratch = (torch.empty((b, n), dtype=torch.float32, device=dev)
               if n > SMEM_POINTS else None)
    err = lib.fcaf3d_fps(
        points.data_ptr(), None if valid is None else valid.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        b, n, num_samples, _native.stream_ptr(dev))
    _native.LAUNCHES["fps"] += 1
    _native.check(err, "fps")
    return out


def furthest_point_sample(points: torch.Tensor, num_samples: int,
                          valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Iterative farthest-point sampling.

    Args:
        points: [B, N, 3] f32.
        num_samples: S, the number of indices per cloud.
        valid: optional [B, N] bool; invalid points are never selected.

    Returns:
        [B, S] int32, starting at the first valid index.
    """
    if points.device.type == "cpu":
        return furthest_point_sample_plain(points, num_samples, valid)
    return _fps_cuda(points, num_samples, valid)
