"""Model-FLOP accounting of the gather kernels (port of
`fcaf3d_tpu/utils/flops.py`, its `model` total).

The sparse convolutions' GEMM work runs in hand-written kernels that no
profiler counts as FLOPs, so each wrapper records its dense-equivalent
GEMM work, 2 * B * M * K * C * E, when it is called: `fused_gather_gemm`
(K2, the forward and the backward's dFeats) and `fused_gather_dw` (K4, the
weight gradient), on the kernel path and the plain path alike. The total
is the numerator of a model-FLOP utilisation (MFU).

The port runs eagerly, so a counter around one forward counts that
forward; the JAX package records at trace time, so its counter around one
`jax.jit(...).lower` of a forward counts the same. With no counter active
recording is a no-op: it reads only the shapes, never the device.
"""
from __future__ import annotations

_ACTIVE: list = []


class flop_counter:
    """Context manager summing the FLOPs recorded inside it.

    Usage:
        with flop_counter() as fc:
            model(points, colors, valid)
        gflops = fc.model / 1e9
    """

    def __init__(self):
        self.model = 0.0

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False


def record_flops(model: float) -> None:
    """Add `model` FLOPs to every active counter (no-op when none is)."""
    for c in _ACTIVE:
        c.model += model
