"""Training state and the train step (port of the single-device path of
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
from ..models.detector import FCAF3D, loss_config
from ..models.fcaf3d_head import fcaf3d_loss
from ..params import init_variables, load_variables
from .optim import ClipAdamW, make_optimizer

BATCH_KEYS = ("points", "colors", "valid", "gt_boxes", "gt_labels",
              "gt_valid")


def create_train_state(cfg: FCAF3DConfig, seed: int = 0, device="cuda",
                       steps_per_epoch: int = 1
                       ) -> Tuple[FCAF3D, ClipAdamW, int]:
    """(model in train mode with the seeded `params.init_variables` draw,
    its optimizer from the config's recipe, step counter 0). The step
    counter lives on as `optimizer.count`."""
    model = FCAF3D(cfg, device=device)
    load_variables(model, init_variables(cfg, seed))
    opt = make_optimizer(model.parameters(), lr=cfg.lr,
                         weight_decay=cfg.weight_decay,
                         grad_clip=cfg.grad_clip,
                         steps_per_epoch=steps_per_epoch,
                         lr_steps=cfg.lr_steps)
    return model.train(), opt, opt.count


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
