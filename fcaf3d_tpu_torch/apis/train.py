"""Epoch loop with JSON-line logging (port of the loop of
`fcaf3d_tpu/apis/train.py`). Checkpoints, `resume`, `load_from` and the
eval hook are not ported yet."""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np

from ..configs.fcaf3d import FCAF3DConfig
from ..train.trainer import create_train_state, make_train_step


def train_model(cfg: FCAF3DConfig, loader, work_dir: str, seed: int = 0,
                log_interval: int = 50, eval_hook: Optional[Callable] = None,
                resume: bool = False, load_from: Optional[str] = None,
                device="cuda"):
    """Train FCAF3D for `cfg.max_epochs` epochs on `device`; returns
    (model, optimizer).

    `loader` is any object with `steps_per_epoch()` and `epoch(e)` yielding
    batch dicts (as `fcaf3d_tpu.data.loader.Loader` does). Every
    `log_interval` steps and at the end of an epoch a record {epoch, iter,
    total, time, <metrics>} is appended to `work_dir/train_log.jsonl`, and
    after each epoch {epoch, epoch_time}, as the JAX loop writes them.
    Raises NotImplementedError for `eval_hook`, `resume` and `load_from`.
    """
    if eval_hook is not None or resume or load_from:
        raise NotImplementedError(
            "eval_hook, resume and load_from need checkpoints, which the "
            "port does not save yet")
    os.makedirs(work_dir, exist_ok=True)
    log_path = os.path.join(work_dir, "train_log.jsonl")
    steps_per_epoch = loader.steps_per_epoch()
    model, opt, _ = create_train_state(cfg, seed, device, steps_per_epoch)
    step_fn = make_train_step(model, cfg, opt)

    def log(record):
        with open(log_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    for epoch in range(cfg.max_epochs):
        t_epoch = time.time()
        window = []
        for i, batch in enumerate(loader.epoch(epoch)):
            t0 = time.time()
            metrics = step_fn(batch)
            if (i + 1) % log_interval == 0 or i + 1 == steps_per_epoch:
                metrics = {k: float(v) for k, v in metrics.items()}
                window.append(time.time() - t0)
                rec = {"epoch": epoch + 1, "iter": i + 1,
                       "total": steps_per_epoch,
                       "time": round(float(np.mean(window)), 3),
                       **{k: round(v, 4) for k, v in metrics.items()}}
                print(f"Epoch [{rec['epoch']}/{cfg.max_epochs}]"
                      f"[{rec['iter']}/{steps_per_epoch}] "
                      + " ".join(f"{k}: {v}" for k, v in rec.items()
                                 if "loss" in k))
                log(rec)
            else:
                window.append(time.time() - t0)
        log({"epoch": epoch + 1,
             "epoch_time": round(time.time() - t_epoch, 1)})
    return model, opt
