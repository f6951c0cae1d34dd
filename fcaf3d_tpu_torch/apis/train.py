"""The training loop (port of `fcaf3d_tpu/apis/train.py`): epochs of train
steps, JSON-line logging (the analog of `TextLoggerHook`), a checkpoint
after every epoch, `resume` / `load_from`, an optional eval hook, and data
parallelism over a `parallel.Group` (the JAX loop's mesh)."""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

from ..configs.fcaf3d import FCAF3DConfig
from ..parallel.comm import Group, barrier, rank
from ..train.checkpoint import (latest_epoch, load_params,
                                restore_checkpoint, save_checkpoint,
                                save_meta)
from ..train.trainer import create_train_state, make_train_step
from ..utils import tracing


def train_model(cfg: FCAF3DConfig, loader, work_dir: str, seed: int = 0,
                log_interval: int = 50, eval_hook: Optional[Callable] = None,
                resume: bool = False, load_from: Optional[str] = None,
                classes: Optional[tuple] = None, device="cuda",
                group: Optional[Group] = None):
    """Train FCAF3D for `cfg.max_epochs` epochs on `device`; returns
    (model, optimizer).

    `loader` has `steps_per_epoch()` and `epoch(e)` yielding batch dicts
    (`data.loader.Loader`). Before the first step the run's metadata
    (`classes`, the config, its class name and `seed`) goes to
    `work_dir/ckpts/meta.json`. Every `log_interval` steps and at the end
    of an epoch a record {epoch, iter, total, time, <metrics>} is appended
    to `work_dir/train_log.jsonl`: `time` is the wall time a step, loading
    included, from the end of the previous logged step (or the epoch's
    start) to the end of this one. Each step is a `tracing.item()`. After
    each epoch a checkpoint is saved,
    then {epoch, epoch_time} is logged, then `eval_hook(model, epoch)`
    runs and {epoch, eval: its result} is logged.

    `resume` continues from the latest checkpoint of `work_dir` (if any)
    at its epoch boundary; `load_from` (a work dir; ignored with `resume`)
    loads another run's weights only (`train.checkpoint.load_params`).

    With a data-parallel `group` every rank calls this with its shard of
    the loader (`Loader(shard_index=rank, num_shards=world)`, whose steps
    count the global batches) and its own `device`; the steps are
    `make_train_step(group=)`'s; every rank restores on `resume` /
    `load_from` and runs the eval hook (which may shard its evaluation
    over the group); rank 0 alone writes the metadata, the log and the
    checkpoints, and prints, and every rank waits for each save.
    """
    main = rank(group) == 0
    os.makedirs(work_dir, exist_ok=True)
    if main:
        save_meta(work_dir, {
            "classes": list(classes) if classes is not None else None,
            "config": dataclasses.asdict(cfg),
            "config_class": type(cfg).__name__,
            "seed": seed,
        })
    log_path = os.path.join(work_dir, "train_log.jsonl")
    # the LR boundaries are epochs of this loader's steps: a resumed run
    # must count steps the same way
    steps_per_epoch = loader.steps_per_epoch()
    model, opt, _ = create_train_state(cfg, seed, device, steps_per_epoch)
    step_fn = make_train_step(model, cfg, opt, group=group)

    start_epoch = 0
    if load_from and not resume:
        load_params(load_from, model)
        if main:
            print(f"loaded weights from {load_from}")
    if resume and latest_epoch(work_dir) is not None:
        start_epoch = restore_checkpoint(work_dir, model, opt)
        if main:
            print(f"resumed from epoch {start_epoch}")

    def log(record):
        if main:
            with open(log_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    for epoch in range(start_epoch, cfg.max_epochs):
        t_epoch = time.time()
        t_logged, steps = t_epoch, 0
        for i, batch in enumerate(loader.epoch(epoch)):
            with tracing.item():
                metrics = step_fn(batch)
            steps += 1
            # the metrics are device tensors: reading them waits for the
            # step, so only the logged steps do
            if (i + 1) % log_interval == 0 or i + 1 == steps_per_epoch:
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                rec = {"epoch": epoch + 1, "iter": i + 1,
                       "total": steps_per_epoch,
                       "time": round((now - t_logged) / steps, 3),
                       **{k: round(v, 4) for k, v in metrics.items()}}
                t_logged, steps = now, 0
                if main:
                    print(f"Epoch [{rec['epoch']}/{cfg.max_epochs}]"
                          f"[{rec['iter']}/{steps_per_epoch}] "
                          + " ".join(f"{k}: {v}" for k, v in rec.items()
                                     if "loss" in k))
                log(rec)
        if main:
            save_checkpoint(work_dir, epoch + 1, model, opt)
        barrier(group)
        log({"epoch": epoch + 1,
             "epoch_time": round(time.time() - t_epoch, 1)})
        if eval_hook is not None:
            log({"epoch": epoch + 1, "eval": eval_hook(model, epoch + 1)})
    return model, opt
