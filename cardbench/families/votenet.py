"""VoteNet-v2 on the benchmark: the port's train step and the reference's
(`cardbench.ref`) that its check compares it with."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .. import weights
from ..traffic.generator import add_height
from . import common

# `params.init_votenet_variables`' draw
GAINS = {"conv_cls": 2.0, "conv_reg": 0.02, "conv_out": 0.05,
         "vote_aggregation.mlp0.Dense_0": 16.0}
ZERO_BIAS = ("conv_cls",)
LOSS = "votenet_loss"
TRAIN_KEYS = ("points", "gt_boxes", "gt_labels", "gt_valid")
# the configuration runs float32 with TF32 off; the control turns it on
CONTROL = "tf32"


def program_config(config: dict):
    from fcaf3d_tpu_torch.configs.votenet import VoteNetConfig
    return common.config_from(VoteNetConfig, config["config"])


def ref_config(config: dict):
    from ..ref.configs.votenet import VoteNetConfig
    return common.config_from(VoteNetConfig, config["config"])


def draw(config: dict, seed: int, device) -> dict:
    from ..ref.models.votenet import VoteNet
    shapes = weights.model_shapes(VoteNet(ref_config(config), device="meta"))
    return weights.draw(shapes, seed, device, GAINS, ZERO_BIAS)


def prepare(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The generic batch as VoteNet reads it: xyz and the height column."""
    return {"points": np.stack([add_height(p) for p in batch["points"]]),
            **{k: batch[k] for k in TRAIN_KEYS[1:]}}


def program_train(config: dict, tree: dict, device):
    from fcaf3d_tpu_torch.models.votenet import VoteNet
    from fcaf3d_tpu_torch.params import load_variables
    from fcaf3d_tpu_torch.train.optim import make_optimizer
    from fcaf3d_tpu_torch.train.trainer import make_votenet_train_step

    cfg = program_config(config)
    model = VoteNet(cfg, device=device)
    load_variables(model, tree)
    opt = make_optimizer(model.parameters(), lr=cfg.lr,
                         weight_decay=cfg.weight_decay,
                         grad_clip=cfg.grad_clip,
                         steps_per_epoch=config["steps_per_epoch"],
                         lr_steps=cfg.lr_steps)
    model.train()
    return model, opt, make_votenet_train_step(model, cfg, opt)


def ref_train(config: dict, tree: dict, batches: List[dict], device) -> dict:
    from ..ref.models.votenet import VoteNet, votenet_loss
    from ..ref.params import load_variables
    from ..ref.train.optim import make_optimizer

    cfg = ref_config(config)
    model = VoteNet(cfg, device=device)
    load_variables(model, tree)
    opt = make_optimizer(model.parameters(), lr=cfg.lr,
                         weight_decay=cfg.weight_decay,
                         grad_clip=cfg.grad_clip,
                         steps_per_epoch=config["steps_per_epoch"],
                         lr_steps=cfg.lr_steps)

    def loss_of(t):
        return votenet_loss(model(t["points"]), t["points"], t["gt_boxes"],
                            t["gt_labels"], t["gt_valid"],
                            n_classes=cfg.n_classes, with_yaw=cfg.with_yaw,
                            gt_per_seed=cfg.gt_per_seed)

    return common.run_ref_steps(model, opt, loss_of, batches, TRAIN_KEYS,
                                device, cfg.grad_clip)
