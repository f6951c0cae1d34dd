"""Training state and the train steps of FCAF3D, VoteNet-v2 and the
bin-based VoteNet-v1 (port of the single-device path of
`fcaf3d_tpu/train/trainer.py`; data parallelism is not ported yet).

PyTorch runs eagerly and updates in place: the model holds the parameters
and batch statistics, the optimizer its moments and step count, and a step
mutates both.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from ..configs.fcaf3d import FCAF3DConfig
from ..configs.votenet import VoteNetConfig
from ..models.detector import FCAF3D, loss_config
from ..models.fcaf3d_head import fcaf3d_loss
from ..models.votenet import VoteNet, votenet_loss
from ..models.votenet_v1 import VoteNetV1, build_votenet, votenet_v1_loss
from ..params import init_variables, init_votenet_variables, load_variables
from .optim import ClipAdamW, make_optimizer

BATCH_KEYS = ("points", "colors", "valid", "gt_boxes", "gt_labels",
              "gt_valid")
VOTENET_BATCH_KEYS = ("points", "gt_boxes", "gt_labels", "gt_valid")


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
    """(model in train mode with the seeded `params.init_variables` draw,
    its optimizer from the config's recipe, step counter 0). The step
    counter lives on as `optimizer.count`."""
    return _train_state(FCAF3D(cfg, device=device),
                        init_variables(cfg, seed), cfg, steps_per_epoch)


def create_votenet_train_state(cfg: VoteNetConfig, seed: int = 0,
                               device="cuda", steps_per_epoch: int = 1,
                               coder=None) -> Tuple[VoteNet, ClipAdamW, int]:
    """`create_train_state` for VoteNet: `VoteNet(cfg)`, or for a v1 config
    `VoteNetV1(cfg, coder)`, with the seeded `params.init_votenet_variables`
    draw, and the config's optimizer (AdamW lr 0.008, weight decay 0.01,
    clip 10, LR x0.1 at the `lr_steps` epochs)."""
    return _train_state(build_votenet(cfg, coder, device=device),
                        init_votenet_variables(cfg, seed, coder), cfg,
                        steps_per_epoch)


def make_train_step(model: FCAF3D, cfg: FCAF3DConfig, optimizer: ClipAdamW
                    ) -> Callable[[Mapping[str, np.ndarray]],
                                  Dict[str, torch.Tensor]]:
    """The train step `step(batch) -> metrics`.

    `batch` holds numpy arrays or tensors: points [B, P, 3], colors
    [B, P, C], valid [B, P], gt_boxes [B, G, 7], gt_labels [B, G], gt_valid
    [B, G]. One step runs the forward in train mode, `fcaf3d_loss`, the
    backward, the global-norm clip and AdamW. The metrics are 0-dim tensors
    on the model's device: loss_cls, loss_centerness, loss_bbox, loss,
    grad_norm (before the clip) and overflow_max (voxels any budget
    dropped)."""
    lcfg = loss_config(cfg)
    device = next(model.parameters()).device

    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        t = {k: torch.as_tensor(batch[k], device=device) for k in BATCH_KEYS}
        model.train()
        optimizer.zero_grad(set_to_none=True)
        outs, overflow = model(t["points"], t["colors"], t["valid"])
        losses = fcaf3d_loss(outs, t["gt_boxes"], t["gt_labels"],
                             t["gt_valid"], lcfg)
        total = (losses["loss_cls"] + losses["loss_centerness"]
                 + losses["loss_bbox"])
        total.backward()
        grad_norm = optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        metrics["overflow_max"] = torch.stack(
            [v.max() for v in overflow.values()]).max()
        return metrics

    return step


def _votenet_step(model: VoteNet, optimizer: ClipAdamW, loss_fn):
    device = next(model.parameters()).device

    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        t = {k: torch.as_tensor(batch[k], device=device)
             for k in VOTENET_BATCH_KEYS}
        model.train()
        optimizer.zero_grad(set_to_none=True)
        losses = loss_fn(model(t["points"]), t)
        total = sum(losses.values())
        total.backward()
        grad_norm = optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    return step


def make_votenet_train_step(model: VoteNet, cfg: VoteNetConfig,
                            optimizer: ClipAdamW
                            ) -> Callable[[Mapping[str, np.ndarray]],
                                          Dict[str, torch.Tensor]]:
    """The VoteNet-v2 train step `step(batch) -> metrics`.

    `batch` holds numpy arrays or tensors: points [B, N, 3 + F], gt_boxes
    [B, G, 7], gt_labels [B, G], gt_valid [B, G]. One step runs the forward
    in train mode (proposals sampled over the votes), `votenet_loss`, the
    backward, the global-norm clip and AdamW. The metrics are 0-dim tensors
    on the model's device: the five losses, loss (their sum) and grad_norm
    (before the clip)."""
    return _votenet_step(model, optimizer, lambda preds, t: votenet_loss(
        preds, t["points"], t["gt_boxes"], t["gt_labels"], t["gt_valid"],
        n_classes=cfg.n_classes, with_yaw=cfg.with_yaw,
        gt_per_seed=cfg.gt_per_seed))


def make_votenet_v1_train_step(model: VoteNetV1, cfg: VoteNetConfig,
                               optimizer: ClipAdamW
                               ) -> Callable[[Mapping[str, np.ndarray]],
                                             Dict[str, torch.Tensor]]:
    """`make_votenet_train_step` for the bin-based VoteNet-v1, whose coder
    drives the targets: `votenet_v1_loss`, metrics the eight losses, loss
    and grad_norm."""
    return _votenet_step(model, optimizer, lambda preds, t: votenet_v1_loss(
        preds, t["points"], t["gt_boxes"], t["gt_labels"], t["gt_valid"],
        coder=model.coder, n_classes=cfg.n_classes,
        gt_per_seed=cfg.gt_per_seed))
