"""Training state and the train steps of FCAF3D, VoteNet-v2, the
bin-based VoteNet-v1 (port of `fcaf3d_tpu/train/trainer.py`, its `mesh=`
data parallelism as `group=`: `parallel/comm.py`), and of ImVoteNet's 2D
detector and stage 2 (the step bodies of `tools/train_detector2d.py` and
`tools/train_imvotenet.py`, at a constant learning rate, on one device).

PyTorch runs eagerly and updates in place: the model holds the parameters
and batch statistics, the optimizer its moments and step count, and a step
mutates both.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs.fcaf3d import FCAF3DConfig
from ..configs.votenet import VoteNetConfig
from ..models.detector import FCAF3D, loss_config
from ..models.detector2d import Detector2D, detector2d_loss
from ..models.fcaf3d_head import fcaf3d_loss
from ..models.imvotenet import ImVoteNet, imvotenet_loss
from ..models.votenet import VoteNet, votenet_loss
from ..models.votenet_v1 import VoteNetV1, build_votenet, votenet_v1_loss
from ..parallel.comm import (Group, all_reduce_grads, broadcast_module,
                             data_parallel)
from ..params import (
    init_detector2d_reference_variables,
    init_imvotenet_reference_variables,
    init_reference_variables,
    init_votenet_reference_variables,
    load_variables,
)
from ..utils import tracing
from .optim import ClipAdamW, constant_schedule, make_optimizer

BATCH_KEYS = ("points", "colors", "valid", "gt_boxes", "gt_labels",
              "gt_valid")
VOTENET_BATCH_KEYS = ("points", "gt_boxes", "gt_labels", "gt_valid")
DETECTOR2D_BATCH_KEYS = ("images", "gt_boxes", "gt_labels", "gt_valid")
IMVOTENET_BATCH_KEYS = ("points", "images", "depth2img", "boxes2d",
                        "boxes2d_valid") + VOTENET_BATCH_KEYS[1:]
# `tools/train_detector2d.py`'s optimizer: clip 10, then AdamW at a constant
# 1e-3 with weight decay 1e-4.
DETECTOR2D_GRAD_CLIP = 10.0
DETECTOR2D_LR = 1e-3
DETECTOR2D_WEIGHT_DECAY = 1e-4


def _train_state(model, variables, cfg, steps_per_epoch):
    load_variables(model, variables)
    opt = make_optimizer(model.parameters(), lr=cfg.lr,
                         weight_decay=cfg.weight_decay,
                         grad_clip=cfg.grad_clip,
                         steps_per_epoch=steps_per_epoch,
                         lr_steps=cfg.lr_steps)
    return model.train(), opt, opt.count


def create_train_state(cfg: FCAF3DConfig, seed: int = 0, device="cuda",
                       steps_per_epoch: int = 1
                       ) -> Tuple[FCAF3D, ClipAdamW, int]:
    """(model in train mode with the seeded `params.init_reference_variables`
    draw, the reference's init, its optimizer from the config's recipe,
    step counter 0). The step counter lives on as `optimizer.count`."""
    return _train_state(FCAF3D(cfg, device=device),
                        init_reference_variables(cfg, seed), cfg,
                        steps_per_epoch)


def create_votenet_train_state(cfg: VoteNetConfig, seed: int = 0,
                               device="cuda", steps_per_epoch: int = 1,
                               coder=None) -> Tuple[VoteNet, ClipAdamW, int]:
    """`create_train_state` for VoteNet: `VoteNet(cfg)`, or for a v1 config
    `VoteNetV1(cfg, coder)`, with the seeded
    `params.init_votenet_reference_variables` draw (flax's default init,
    where `tools/train_votenet.py` starts), and the config's optimizer
    (AdamW lr 0.008, weight decay 0.01, clip 10, LR x0.1 at the `lr_steps`
    epochs)."""
    return _train_state(build_votenet(cfg, coder, device=device),
                        init_votenet_reference_variables(cfg, seed, coder),
                        cfg, steps_per_epoch)


def create_detector2d_train_state(n_classes: int = 10, width: int = 64,
                                  fpn_ch: int = 128, seed: int = 0,
                                  device="cuda", lr: float = DETECTOR2D_LR
                                  ) -> Tuple[Detector2D, ClipAdamW, int]:
    """(Detector2D in train mode with the seeded
    `params.init_detector2d_reference_variables` draw (flax's default
    init, `cls_pred`'s bias -4), its optimizer, 0):
    `tools/train_detector2d.py`'s recipe, clip 10 then AdamW at `lr` (its
    `--lr`, default 1e-3), weight decay 1e-4, at a constant learning
    rate."""
    model = Detector2D(n_classes, width, fpn_ch, device=device)
    load_variables(model, init_detector2d_reference_variables(
        n_classes, width, fpn_ch, seed))
    opt = ClipAdamW(model.parameters(), constant_schedule(lr),
                    weight_decay=DETECTOR2D_WEIGHT_DECAY,
                    grad_clip=DETECTOR2D_GRAD_CLIP)
    return model.train(), opt, opt.count


def create_imvotenet_train_state(cfg: VoteNetConfig, seed: int = 0,
                                 device="cuda", num_sampled_seed: int = 1024,
                                 max_imvote: int = 3
                                 ) -> Tuple[ImVoteNet, ClipAdamW, int]:
    """(ImVoteNet in train mode with the seeded
    `params.init_imvotenet_reference_variables` draw (flax's default
    init), its optimizer, 0):
    `tools/train_imvotenet.py`'s recipe, clip `cfg.grad_clip` then AdamW
    `cfg.lr`, `cfg.weight_decay`, at a constant learning rate."""
    model = ImVoteNet(cfg, num_sampled_seed, max_imvote, device=device)
    load_variables(model, init_imvotenet_reference_variables(
        cfg, seed, num_sampled_seed, max_imvote))
    opt = ClipAdamW(model.parameters(), constant_schedule(cfg.lr),
                    weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip)
    return model.train(), opt, opt.count


def make_train_step(model: FCAF3D, cfg: FCAF3DConfig, optimizer: ClipAdamW,
                    group: Optional[Group] = None
                    ) -> Callable[[Mapping[str, np.ndarray]],
                                  Dict[str, torch.Tensor]]:
    """The train step `step(batch) -> metrics`.

    `batch` holds numpy arrays or tensors: points [B, P, 3], colors
    [B, P, C], valid [B, P], gt_boxes [B, G, 7], gt_labels [B, G], gt_valid
    [B, G]. One step runs the forward in train mode, `fcaf3d_loss`, the
    backward, the global-norm clip and AdamW. The metrics are 0-dim tensors
    on the model's device: loss_cls, loss_centerness, loss_bbox, loss,
    grad_norm (before the clip) and overflow_max (voxels any budget
    dropped).

    With a data-parallel `group` (`parallel.init_group`; the JAX step's
    `mesh=`), `batch` is this rank's rows of the global batch and the step
    computes what one process computes at the global batch: the model's
    variables are broadcast from rank 0 when the step is made; BN
    statistics and loss normalisers are the global batch's, the losses
    (global on every rank) flow back to this rank's samples, the gradients
    are summed over the ranks before the clip; overflow_max is the max over
    the ranks."""
    lcfg = loss_config(cfg)
    device = next(model.parameters()).device
    broadcast_module(model, group)

    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        t = {k: torch.as_tensor(batch[k], device=device) for k in BATCH_KEYS}
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with data_parallel(group):
            with tracing.span("forward"):
                outs, overflow = model(t["points"], t["colors"], t["valid"])
            with tracing.span("loss"):
                losses = fcaf3d_loss(outs, t["gt_boxes"], t["gt_labels"],
                                     t["gt_valid"], lcfg)
                total = (losses["loss_cls"] + losses["loss_centerness"]
                         + losses["loss_bbox"])
        with tracing.span("backward"):
            total.backward()
        all_reduce_grads(model, group)
        with tracing.span("optimizer"):
            grad_norm = optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        overflow_max = torch.stack([v.max() for v in overflow.values()]).max()
        metrics["overflow_max"] = (overflow_max if group is None else
                                   group.all_reduce(overflow_max, "max"))
        return metrics

    return step


def _loss_step(model: torch.nn.Module, optimizer: ClipAdamW, keys,
               forward, loss_fn, group: Optional[Group] = None):
    """A step whose loss is the sum of `loss_fn(forward(t), t)`'s values in
    their order, `t` the tensors of batch[keys]; metrics: the losses, loss
    and grad_norm. With a
    data-parallel `group`, `loss_fn` gives this rank's shares of the global
    losses: the variables are broadcast from rank 0 when the step is made,
    the gradients and the metrics' losses summed over the ranks."""
    device = next(model.parameters()).device
    broadcast_module(model, group)

    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        t = {k: torch.as_tensor(batch[k], device=device) for k in keys}
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with data_parallel(group):
            with tracing.span("forward"):
                outs = forward(t)
            with tracing.span("loss"):
                losses = loss_fn(outs, t)
                total = sum(losses.values())
        with tracing.span("backward"):
            total.backward()
        all_reduce_grads(model, group)
        with tracing.span("optimizer"):
            grad_norm = optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        if group is not None:
            summed = group.all_reduce(torch.stack(list(metrics.values())))
            metrics = dict(zip(metrics, summed))
        metrics["grad_norm"] = grad_norm
        return metrics

    return step


def make_votenet_train_step(model: VoteNet, cfg: VoteNetConfig,
                            optimizer: ClipAdamW,
                            group: Optional[Group] = None
                            ) -> Callable[[Mapping[str, np.ndarray]],
                                          Dict[str, torch.Tensor]]:
    """The VoteNet-v2 train step `step(batch) -> metrics`.

    `batch` holds numpy arrays or tensors: points [B, N, 3 + F], gt_boxes
    [B, G, 7], gt_labels [B, G], gt_valid [B, G]. One step runs the forward
    in train mode (proposals sampled over the votes), `votenet_loss`, the
    backward, the global-norm clip and AdamW. The metrics are 0-dim tensors
    on the model's device: the five losses, loss (their sum) and grad_norm
    (before the clip). With a data-parallel `group`, `batch` is this rank's
    rows of the global batch and the step computes what one process
    computes at the global batch (`make_train_step`)."""
    return _loss_step(
        model, optimizer, VOTENET_BATCH_KEYS, lambda t: model(t["points"]),
        lambda preds, t: votenet_loss(
            preds, t["points"], t["gt_boxes"], t["gt_labels"], t["gt_valid"],
            n_classes=cfg.n_classes, with_yaw=cfg.with_yaw,
            gt_per_seed=cfg.gt_per_seed), group)


def make_votenet_v1_train_step(model: VoteNetV1, cfg: VoteNetConfig,
                               optimizer: ClipAdamW,
                               group: Optional[Group] = None
                               ) -> Callable[[Mapping[str, np.ndarray]],
                                             Dict[str, torch.Tensor]]:
    """`make_votenet_train_step` for the bin-based VoteNet-v1, whose coder
    drives the targets: `votenet_v1_loss`, metrics the eight losses, loss
    and grad_norm."""
    return _loss_step(
        model, optimizer, VOTENET_BATCH_KEYS, lambda t: model(t["points"]),
        lambda preds, t: votenet_v1_loss(
            preds, t["points"], t["gt_boxes"], t["gt_labels"], t["gt_valid"],
            coder=model.coder, n_classes=cfg.n_classes,
            gt_per_seed=cfg.gt_per_seed), group)


def make_detector2d_train_step(model: Detector2D, optimizer: ClipAdamW
                               ) -> Callable[[Mapping[str, np.ndarray]],
                                             Dict[str, torch.Tensor]]:
    """The Detector2D train step `step(batch) -> metrics`
    (`tools/train_detector2d.py`'s step body).

    `batch` holds numpy arrays or tensors: images [B, H, W, 3] f32 0-255,
    gt_boxes [B, G, 4] xyxy, gt_labels [B, G], gt_valid [B, G]. One step
    runs the forward, `detector2d_loss`, the backward, the clip and AdamW.
    The metrics are 0-dim tensors: cls_loss, reg_loss, ctr_loss, loss
    (their sum) and grad_norm (before the clip)."""
    return _loss_step(
        model, optimizer, DETECTOR2D_BATCH_KEYS, lambda t: model(t["images"]),
        lambda preds, t: detector2d_loss(preds, t["gt_boxes"], t["gt_labels"],
                                         t["gt_valid"]))


def make_imvotenet_train_step(model: ImVoteNet, cfg: VoteNetConfig,
                              optimizer: ClipAdamW
                              ) -> Callable[[Mapping[str, np.ndarray]],
                                            Dict[str, torch.Tensor]]:
    """The ImVoteNet stage-2 train step `step(batch) -> metrics`
    (`tools/train_imvotenet.py`'s step body).

    `batch` holds numpy arrays or tensors: points [B, N, 3 + F], images [B,
    H, W, 3], depth2img [B, 3, 3], the 2D boxes boxes2d [B, D, 6] (GT boxes
    with confidence 1, or `extract_bboxes_2d(train=True)`'s) and
    boxes2d_valid [B, D], gt_boxes [B, G, 7], gt_labels [B, G], gt_valid
    [B, G]. One step runs the three towers in train mode (proposals sampled
    over the votes), `imvotenet_loss`, the backward, the clip and AdamW.
    The metrics are 0-dim tensors: the fifteen "{tower}_{loss}" losses,
    loss (their sum) and grad_norm (before the clip)."""
    def forward(t):
        return model(t["points"], t["images"], t["boxes2d"],
                     t["boxes2d_valid"], depth2img=t["depth2img"])

    def losses(outs, t):
        return imvotenet_loss(outs, t["points"], t["gt_boxes"],
                              t["gt_labels"], t["gt_valid"],
                              n_classes=cfg.n_classes)

    return _loss_step(model, optimizer, IMVOTENET_BATCH_KEYS, forward,
                      losses)
