"""The precision the reference computes in.

"float32": float32 with TF32 off, the reference proper. The controls of
the benchmark's check run it one step lower than the configuration
states: "fp8" rounds each operand of a sparse convolution (its input
features and its kernel) to float8 e4m3 with one scale a tensor (its
largest magnitude onto 448), the step below bfloat16, the gradient passing
through the rounding unchanged; "tf32" lets the matrix products run in
TF32, the step below float32 with TF32 off."""
from __future__ import annotations

import contextlib

import torch

MODES = ("float32", "fp8", "tf32")
E4M3_MAX = 448.0
_MODE = ["float32"]


@contextlib.contextmanager
def operands(mode: str):
    if mode not in MODES:
        raise ValueError(f"precision must be one of {MODES}, got {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _MODE.append(mode)
    try:
        yield
    finally:
        _MODE.pop()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def mode() -> str:
    return _MODE[-1]


def operand(x: torch.Tensor) -> torch.Tensor:
    """`x` as the active precision holds a convolution operand."""
    if _MODE[-1] != "fp8":
        return x
    scale = torch.clamp_min(x.detach().abs().amax(), 1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())
