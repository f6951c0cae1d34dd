"""The work a step or a request does, counted by the benchmark from the
reference's calls (`ref.record`): the configuration's layer shapes and the
batch's own maps, whatever implements them.

- `model_flops`: the dense-equivalent work of the sparse convolutions'
  gather-GEMMs, 2 * B * M * K * C * E a call (forward K2, the backward's
  dFeats K2 and weight-gradient K4), as the port's `utils.flops` counts
  it, plus 2 * rows * in * out for each dense layer's product and, in
  training, for its weight gradient and (where its input needs one) its
  input gradient. The numerator of an MFU.
- `gemm_work` and `bound`: frozen from the port's on-card checks: a
  K2 / K4 call's operations (2 * hits * C * E, hits the map entries that
  are not misses) and bytes (each input read once, each output written
  once), and the least time the card needs for them.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def model_flops(records: Iterable[tuple], train: bool) -> float:
    total = 0.0
    for r in records:
        if r[0] in ("k2", "k4"):
            _, b, m, k, c, e = r[:6]
            total += 2.0 * b * m * k * c * e
        elif r[0] == "dense":
            _, rows, fin, fout, input_grad = r
            passes = 1 + (train and 1) + (train and input_grad and 1)
            total += passes * 2.0 * rows * fin * fout
    return total


def gemm_work(b: int, m: int, k: int, c: int, e: int, n: int, hits: int,
              elt: int, epilogue: bool = False, add: bool = False,
              weight_grad: bool = False) -> Tuple[float, float]:
    """(operations, bytes) of K2 on a map [B, M, K] over N input rows with
    `hits` entries that are not misses, or of K4 with `weight_grad`:
    2 * hits * C * E FLOPs, and each input read once and each output
    written once: feats [B, N, C] and the map, then for K2 W [K, C, E], the
    epilogue's scale, shift and vmask, `add` [B, M, E] and out [B, M, E]
    (`elt` bytes an element), for K4 dout [B, M, E] and dW [K, C, E] in
    float32."""
    flops = 2.0 * hits * c * e
    nbytes = b * n * c * elt + b * m * k * 4
    if weight_grad:
        return flops, nbytes + b * m * e * elt + k * c * e * 4
    nbytes += k * c * e * elt + b * m * e * elt
    if epilogue:
        nbytes += 2 * e * 4 + b * m
    if add:
        nbytes += b * m * e * elt
    return flops, nbytes


def bound(ops: float, nbytes: float, peak_flops: float,
          bytes_per_s: float) -> float:
    """The least seconds: the larger of `ops` over the peak and `nbytes`
    over the memory rate."""
    return max(ops / peak_flops, nbytes / bytes_per_s)


def sparse_conv_bound(records: Iterable[tuple], elt: int, peak_flops: float,
                      bytes_per_s: float) -> float:
    """The summed least seconds of the recorded K2 and K4 calls."""
    records = [r for r in records if r[0] in ("k2", "k4")]
    if not records:
        return 0.0
    hits = torch.stack([r[7] for r in records]).tolist()
    total = 0.0
    for r, h in zip(records, hits):
        kind, b, m, k, c, e, n, _, epilogue, add, _ = r
        ops, nbytes = gemm_work(b, m, k, c, e, n, h, elt, epilogue, add,
                                weight_grad=kind == "k4")
        total += bound(ops, nbytes, peak_flops, bytes_per_s)
    return total
