"""Data parallelism over `torch.distributed`: one process a rank (the
counterpart of `fcaf3d_tpu/parallel/mesh.py`).

The reference trains with NCCL DDP (`tools/dist_train.sh`,
`MMDistributedDataParallel`). The JAX package runs one pjit step over a
1-D `Mesh(('data',))`, and pjit keeps the single-device program: its
masked BatchNorm statistics are taken over the valid rows of the GLOBAL
batch (which subsumes `NaiveSyncBatchNorm`) and its loss normalisers are
global-batch means (the reference's `reduce_mean`). Averaging per-rank
gradients, as DDP does, computes another function. The port computes the
JAX package's:

- a step enters `data_parallel(group)`; the train-mode BatchNorms and the
  losses read `current_group()` and take their statistics and normalisers
  over every rank (`global_sums`, `global_batch`), gradients flowing
  through both collectives;
- each rank's loss is then its share of the global loss (or the global
  loss itself, with the gradient flowing back to the rank's own rows), so
  the gradient of the global loss is the SUM of the ranks' gradients:
  `all_reduce_grads` sums, it does not average;
- the variables start equal (`broadcast_module`) and every rank applies the
  same update to the same summed gradients.

Backends: "nccl" runs each collective on the rank's card (one rank a card).
"gloo" copies the operands of every collective to host tensors and the
result back, always: by design, not as a fallback, it runs the CPU tests
and lets several ranks share one card for checks. With no group active
every function here is the identity, and the model code computes what it
computes in one process.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import itertools
import os
import tempfile
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from ..utils import tracing

BACKENDS = ("nccl", "gloo")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# a rank waits this long in a collective before it raises
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Group:
    """The ranks of one data-parallel run: the backend, this process's rank,
    the world size and the device this rank computes on."""

    backend: str
    rank: int
    world: int
    device: torch.device

    def _operand(self, t: torch.Tensor) -> torch.Tensor:
        """A fresh tensor holding `t` where the backend reduces it: on the
        host for gloo; for NCCL `t` must lie on this rank's card."""
        if self.backend == "gloo":
            return t.detach().to("cpu", copy=True)
        if t.device != self.device:
            raise ValueError(f"rank {self.rank}: an NCCL collective takes "
                             f"tensors on {self.device}, got {t.device}")
        return t.detach().clone()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`op` ("sum" or "max") of `t` over the ranks, a new tensor on
        `t`'s device."""
        buf = self._operand(t)
        dist.all_reduce(buf, op=_OPS[op])
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (one shape on every rank), stacked in rank order:
        [world, *t.shape] on `t`'s device."""
        buf = self._operand(t)
        out = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(out, buf)
        return torch.stack(out).to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `t`, a new tensor on `t`'s device."""
        buf = self._operand(t)
        dist.broadcast(buf, src)
        return buf.to(t.device)

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every rank's picklable `obj`, in rank order."""
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def init_group(backend: str, rank: int, world: int, device,
               init_method: str) -> Group:
    """Join the default process group as `rank` of `world` and return its
    `Group`. `device` is where this rank computes ("cpu" with gloo only);
    a card becomes the current device. NCCL needs one card a rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError(f"NCCL runs on a card, not on {device}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return Group(backend, rank, world, device)


def init_from_env(backend: str, device="cuda") -> Group:
    """`init_group` from the variables `torchrun` sets (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`). A card
    without an index ("cuda") is card `LOCAL_RANK`; "cuda:i" is card i
    (ranks sharing a card over gloo)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return init_group(backend, int(os.environ["RANK"]),
                      int(os.environ["WORLD_SIZE"]), device, "env://")


def destroy(group: Optional[Group]) -> None:
    if group is not None:
        dist.destroy_process_group()


def rank(group: Optional[Group]) -> int:
    return 0 if group is None else group.rank


def world(group: Optional[Group]) -> int:
    return 1 if group is None else group.world


def barrier(group: Optional[Group]) -> None:
    if group is not None:
        group.barrier()


def all_gather_object(obj: Any, group: Optional[Group]) -> List[Any]:
    return [obj] if group is None else group.all_gather_object(obj)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the upstream gradients of every
    rank, since each rank's loss reads the same sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad), None


class _AllGather(torch.autograd.Function):
    """[world, *x.shape]; the backward hands each rank the gradient of its
    own slice: every rank computes the same function of the gathered rows,
    and only its own rows carry its graph."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.group.rank], None


_ACTIVE = contextvars.ContextVar("fcaf3d_data_parallel_group", default=None)


@contextlib.contextmanager
def data_parallel(group: Optional[Group]):
    """Within, `current_group()` is `group` (None: one process)."""
    token = _ACTIVE.set(group)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def current_group() -> Optional[Group]:
    return _ACTIVE.get()


def global_sums(*tensors: torch.Tensor):
    """The sums of `tensors` over the ranks of the active group, in one
    all-reduce through which gradients flow, each in its own shape and
    dtype; with no group active, the tensors themselves."""
    group = current_group()
    if group is None:
        return tensors
    total = _AllReduceSum.apply(
        torch.cat([t.reshape(-1) for t in tensors]), group)
    parts = total.split([t.numel() for t in tensors])
    return tuple(p.reshape(t.shape).to(t.dtype)
                 for p, t in zip(parts, tensors))


def global_batch(*vectors: torch.Tensor):
    """Per-sample vectors [B_local] of every rank of the active group,
    concatenated in rank order ([B_global], the global batch's sample
    order), each contiguous in its own dtype, in one all-gather; a rank's
    gradient flows back to its own samples. With no group active, the
    vectors themselves."""
    group = current_group()
    if group is None:
        return vectors
    b = vectors[0].shape[0]
    gathered = _AllGather.apply(torch.cat(vectors), group)
    rows = gathered.reshape(group.world, len(vectors), b).transpose(
        0, 1).reshape(len(vectors), group.world * b)
    return tuple(r.to(v.dtype) for r, v in zip(rows, vectors))


@tracing.spanned("all_reduce_grads")
def all_reduce_grads(model: torch.nn.Module, group: Optional[Group]) -> None:
    """Sum every parameter's gradient over the ranks, in one flat buffer. A
    parameter without a gradient keeps none (every rank runs the same
    graph, so the same parameters have one)."""
    if group is None:
        return
    params = [p for p in model.parameters() if p.grad is not None]
    flat = group.all_reduce(torch.cat([p.grad.reshape(-1) for p in params]))
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


@torch.no_grad()
def broadcast_module(model: torch.nn.Module, group: Optional[Group],
                     src: int = 0) -> None:
    """Copy rank `src`'s parameters and buffers to every rank, one flat
    buffer a dtype."""
    if group is None:
        return
    tensors = list(itertools.chain(model.parameters(), model.buffers()))
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = group.broadcast(torch.cat([t.reshape(-1) for t in same]), src)
        for t, v in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(v.view_as(t))


def _run_rank(rank_index, world_size, fn, args, backend, device, store):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank_index)
    group = init_group(backend, rank_index, world_size, device,
                       f"file://{store}")
    try:
        fn(group, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, *args, backend: str = "gloo",
          device="cpu") -> None:
    """Run `fn(group, *args)` in `world_size` fresh processes (the spawn
    start method: safe after CUDA is initialised), the ranks of one group
    met through a file store in a temporary directory. `device` "cuda"
    puts rank r on card r; "cuda:i" puts every rank on card i. `fn` must
    be importable by the new processes (module level). Raises if a rank
    fails; the others are then stopped."""
    with tempfile.TemporaryDirectory(prefix="fcaf3d_dp_") as tmp:
        torch.multiprocessing.spawn(
            _run_rank, args=(world_size, fn, args, backend, device,
                             os.path.join(tmp, "store")),
            nprocs=world_size, join=True)
