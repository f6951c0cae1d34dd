"""FCAF3D on the benchmark: the port's entries that a cell drives, and the
reference's (`cardbench.ref`) that its check compares them with."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import weights
from . import common

# `params.init_variables`' draw: the heads' gains, the class bias at zero
GAINS = {"centerness_conv": 0.15, "cls_conv": 0.15, "reg_conv": 0.02}
ZERO_BIAS = ("cls_conv",)
RESIDUAL_GAIN = {"norm3": 0.25}
# the port's train-step loss, by its name in `train.trainer`
LOSS = "fcaf3d_loss"
TRAIN_KEYS = ("points", "colors", "valid", "gt_boxes", "gt_labels",
              "gt_valid")
# the lower precision of the check's control
CONTROL = "fp8"


def program_config(config: dict):
    from fcaf3d_tpu_torch.configs.fcaf3d import FCAF3DConfig
    return common.config_from(FCAF3DConfig, config["config"])


def ref_config(config: dict):
    """The reference runs the configuration in float32; its fp8 control
    in the configuration's dtype with fp8 convolution operands (the port
    with its matrix products one step lower)."""
    from ..ref import precision
    from ..ref.configs.fcaf3d import FCAF3DConfig
    dtype = (config["config"]["compute_dtype"] if precision.mode() == "fp8"
             else "float32")
    return common.config_from(FCAF3DConfig, {**config["config"],
                                             "compute_dtype": dtype})


def draw(config: dict, seed: int, device) -> dict:
    from ..ref.models.detector import FCAF3D
    shapes = weights.model_shapes(FCAF3D(ref_config(config), device="meta"))
    return weights.draw(shapes, seed, device, GAINS, ZERO_BIAS,
                        RESIDUAL_GAIN)


def prepare(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return batch


def program_train(config: dict, tree: dict, device):
    """(model, optimizer, step): `make_train_step` on `FCAF3D` with the
    drawn variables and the configuration's optimizer recipe."""
    from fcaf3d_tpu_torch.models.detector import FCAF3D
    from fcaf3d_tpu_torch.params import load_variables
    from fcaf3d_tpu_torch.train.optim import make_optimizer
    from fcaf3d_tpu_torch.train.trainer import make_train_step

    cfg = program_config(config)
    model = FCAF3D(cfg, device=device)
    load_variables(model, tree)
    opt = make_optimizer(model.parameters(), lr=cfg.lr,
                         weight_decay=cfg.weight_decay,
                         grad_clip=cfg.grad_clip,
                         steps_per_epoch=config["steps_per_epoch"],
                         lr_steps=cfg.lr_steps)
    model.train()
    return model, opt, make_train_step(model, cfg, opt)


def program_infer(config: dict, tree: dict, device):
    """(model, request): a request is a collated batch's `detect_batch`,
    then `detections_to_numpy` of each scan, as `evaluate_dataset` runs
    one."""
    from fcaf3d_tpu_torch.apis.test import detect_batch, detections_to_numpy
    from fcaf3d_tpu_torch.models.detector import FCAF3D
    from fcaf3d_tpu_torch.params import load_variables

    cfg = program_config(config)
    model = FCAF3D(cfg, device=device)
    load_variables(model, tree)
    model.eval()

    @torch.inference_mode()
    def request(batch):
        dets = detect_batch(model, cfg, batch["points"], batch)
        return [detections_to_numpy(dets, j)
                for j in range(batch["points"].shape[0])]

    return model, request


def ref_train(config: dict, tree: dict, batches: List[dict], device) -> dict:
    """The reference's steps over `batches` (`common.run_ref_steps`)."""
    from ..ref.models.detector import FCAF3D, loss_config
    from ..ref.models.fcaf3d_head import fcaf3d_loss
    from ..ref.params import load_variables
    from ..ref.train.optim import make_optimizer

    cfg = ref_config(config)
    model = FCAF3D(cfg, device=device)
    load_variables(model, tree)
    opt = make_optimizer(model.parameters(), lr=cfg.lr,
                         weight_decay=cfg.weight_decay,
                         grad_clip=cfg.grad_clip,
                         steps_per_epoch=config["steps_per_epoch"],
                         lr_steps=cfg.lr_steps)
    lcfg = loss_config(cfg)

    def loss_of(t):
        outs, _ = model(t["points"], t["colors"], t["valid"])
        return fcaf3d_loss(outs, t["gt_boxes"], t["gt_labels"],
                           t["gt_valid"], lcfg)

    return common.run_ref_steps(model, opt, loss_of, batches, TRAIN_KEYS,
                                device, cfg.grad_clip)


def ref_detect(config: dict, tree: dict, batches: List[dict], device
               ) -> List[List[dict]]:
    """The reference's detections of each batch, a dict a scan: numpy
    arrays over every post-processing candidate, boxes [Ct, 7]
    (bottom-centred), scores [Ct], labels [Ct] and keep [Ct] (NMS's
    verdict), and, as tensors on the device, every valid row of every
    level, rows_boxes [R, 7] (bottom-centred) and rows_scores [R, C]."""
    from ..ref.models.detector import FCAF3D, infer_config
    from ..ref.models.fcaf3d_head import (_box7, bbox_pred_to_bbox,
                                          fcaf3d_get_bboxes)
    from ..ref.params import load_variables

    cfg = ref_config(config)
    model = FCAF3D(cfg, device=device)
    load_variables(model, tree)
    model.eval()
    out = []
    with torch.inference_mode():
        for batch in batches:
            t = {k: torch.as_tensor(batch[k], device=device)
                 for k in ("points", "colors", "valid")}
            outs, _ = model(t["points"], t["colors"], t["valid"])
            d = fcaf3d_get_bboxes(outs, infer_config(cfg))
            valid = torch.cat([o.valid for o in outs], 1)
            scores = torch.cat([torch.sigmoid(o.cls_scores.float())
                                * torch.sigmoid(o.centerness.float())
                                for o in outs], 1)
            boxes = _box7(bbox_pred_to_bbox(
                torch.cat([o.points for o in outs], 1),
                torch.cat([o.bbox_pred.float() for o in outs], 1),
                cfg.yaw_parametrization))
            boxes = torch.cat([boxes[..., :2], boxes[..., 2:3]
                               - boxes[..., 5:6] / 2, boxes[..., 3:]], -1)
            out.append([{"boxes": d.boxes[j].cpu().numpy(),
                         "scores": d.scores[j].cpu().numpy(),
                         "labels": d.labels[j].cpu().numpy(),
                         "keep": d.valid[j].cpu().numpy(),
                         "rows_boxes": boxes[j][valid[j]],
                         "rows_scores": scores[j][valid[j]]}
                        for j in range(d.boxes.shape[0])])
    return out
