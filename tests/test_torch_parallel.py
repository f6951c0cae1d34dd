"""Data parallelism of the port (`fcaf3d_tpu_torch/parallel/`) on the CPU:
W = 2 gloo ranks against one process at the same global batch (W = 1),
and the data-parallel train steps against the JAX package.

One spawn serves the module (fixture `ranks`): each rank runs `_rank` on
its rows of every global batch and saves what it computed, while the
parent computes the W = 1 and JAX references; the tests then compare. The
ranks import this module, so it imports no JAX at its top: JAX is the
parent's alone (imported where a reference needs it).

Tolerances. In float64, W = 2 differs from W = 1 only in the order of the
cross-rank sums (BN statistics, loss normalisers, gradients): every value
within RTOL = 1e-10 of its leaf's largest. Against the JAX package the W = 2 steps are held as
`tests/test_torch_train.py` (FCAF3D, f32) and
`tests/test_torch_votenet_train.py` (VoteNet-v2, float64) hold the
single-process steps. Sharded evaluation gives the single process's metric
dict exactly.
"""
import concurrent.futures as cf
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch import data as tdata
from fcaf3d_tpu_torch.apis import train as tapis_train
from fcaf3d_tpu_torch.apis.inference import init_detector
from fcaf3d_tpu_torch.apis.test import evaluate_dataset, make_test_pipeline
from fcaf3d_tpu_torch.models import pointnet2
from fcaf3d_tpu_torch.models.blocks import SparseBatchNorm
from fcaf3d_tpu_torch.models.detector import loss_config
from fcaf3d_tpu_torch.models.fcaf3d_head import HeadLevelOutput, fcaf3d_loss
from fcaf3d_tpu_torch.models.votenet import votenet_loss
from fcaf3d_tpu_torch.models.votenet_v1 import votenet_v1_loss
from fcaf3d_tpu_torch.ops.sparse.tensor import SENTINEL, SparseTensor
from fcaf3d_tpu_torch.parallel import (Group, all_reduce_grads,
                                       broadcast_module, data_parallel,
                                       global_batch, global_sums, init_group,
                                       spawn)
from fcaf3d_tpu_torch.params import init_variables, init_votenet_variables
from fcaf3d_tpu_torch.train import (create_train_state,
                                    create_votenet_train_state,
                                    make_train_step, make_votenet_train_step,
                                    make_votenet_v1_train_step)
from fcaf3d_tpu_torch.train.checkpoint import latest_epoch

W = 2
RTOL = 1e-10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NANO_EXTENT = (0.3, 0.3, 0.15)  # `tests/test_torch_model.py`'s for nano
CLASSES = ("a", "b", "c", "d")
STEPS = 2  # data-parallel train steps held against W = 1
# AdamW's update g / (|g| + 1e-8) turns the rounding-level difference of a
# gradient element near its eps into a parameter difference lr / eps ~ 1e6
# times larger: VoteNet's variables after two steps are held within
# ADAM_RTOL of their leaf's largest; FCAF3D's, whose gradients stay far
# from eps, within RTOL
ADAM_RTOL = 1e-7


def draw(tag, i, shape):
    return np.random.default_rng([tag, i]).standard_normal(shape)


def rows(tree, r, w):
    """Rank r's rows of every batch-leading array of `tree` (a dict, list or
    tuple of numpy arrays)."""
    if isinstance(tree, dict):
        return {k: rows(v, r, w) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rows(v, r, w) for v in tree)
    b = tree.shape[0] // w
    return tree[r * b:(r + 1) * b]


def f64(batch):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


# --------------------------------------------------- what a rank computes

def collectives(group):
    """Each rank's draws through the differentiable sum and gather, the max,
    the object gather, `broadcast_module` and `all_reduce_grads`."""
    r, w = group.rank, group.world
    x = torch.tensor(draw(1, r, (3, 4)), requires_grad=True)
    v = torch.tensor(draw(3, r, (5,)), requires_grad=True)
    with data_parallel(group):
        (y,) = global_sums(x)
        (g,) = global_batch(v)
    ((y * torch.tensor(draw(2, r, (3, 4)))).sum()
     + (g * torch.tensor(draw(4, 0, (5 * w,)))).sum()).backward()
    lin = torch.nn.Linear(3, 2).double()
    with torch.no_grad():
        lin.weight.fill_(r + 1.0)
        lin.bias.fill_(-r)
    broadcast_module(lin, group)
    for p in lin.parameters():
        p.grad = torch.full_like(p, r + 1.0)
    all_reduce_grads(lin, group)
    return {"y": y.detach(), "x_grad": x.grad, "g": g.detach(),
            "v_grad": v.grad,
            "max": group.all_reduce(torch.tensor([r, -r]), "max"),
            "objects": group.all_gather_object(("rank", r)),
            "params": [p.detach().clone() for p in lin.parameters()],
            "grads": [p.grad.clone() for p in lin.parameters()]}


def sparse_tensor(feats, valid):
    b, n = valid.shape
    keys = torch.where(torch.as_tensor(valid), torch.arange(n).expand(b, n),
                       SENTINEL)
    return SparseTensor(coords=torch.zeros((b, n, 3), dtype=torch.int32),
                        feats=feats, keys=keys,
                        shift=torch.zeros((b, 3), dtype=torch.int32))


def batch_norm(spec, group, sparse):
    """One train-mode BN forward and backward on spec's batch (x, the
    upstream gradient up, with `sparse` the valid mask): output, input and
    parameter gradients, running statistics."""
    batch = spec["batch"]
    x = torch.tensor(batch["x"], requires_grad=True)
    c = x.shape[-1]
    bn = (SparseBatchNorm(c) if sparse else pointnet2.BatchNorm(c)).double()
    with torch.no_grad():
        bn.scale.copy_(torch.tensor(spec["scale"]))
        bn.bias.copy_(torch.tensor(spec["bias"]))
    with data_parallel(group):
        out = (bn(sparse_tensor(x, batch["valid"])).feats if sparse
               else bn(x))
    (out * torch.tensor(batch["up"])).sum().backward()
    return {"out": out.detach(), "x_grad": x.grad,
            "scale_grad": bn.scale.grad, "bias_grad": bn.bias.grad,
            "mean": bn.mean.clone(), "var": bn.var.clone()}


def leaves(tree):
    """numpy arrays as tensors, the float64 ones leaves requiring grad."""
    if isinstance(tree, dict):
        return {k: leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(leaves(v) for v in tree)
    return torch.tensor(tree, requires_grad=tree.dtype == np.float64)


def grads_of(tree):
    if isinstance(tree, dict):
        return {k: grads_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [grads_of(v) for v in tree]
    return tree.grad


def loss_and_grads(spec, group, which):
    """One of the three losses on spec's rows of its head outputs or
    predictions (float64 leaves) and GT: the losses and their inputs'
    gradients."""
    inputs = leaves(spec["inputs"])
    gt = {k: torch.as_tensor(v) for k, v in spec["gt"].items()}
    with data_parallel(group):
        if which == "fcaf3d":
            losses = fcaf3d_loss([HeadLevelOutput(*lv) for lv in inputs],
                                 gt["gt_boxes"], gt["gt_labels"],
                                 gt["gt_valid"],
                                 loss_config(tconfigs.fcaf3d_nano()))
        else:
            cfg = tconfigs.votenet_tiny()
            kw = dict(n_classes=cfg.n_classes, gt_per_seed=cfg.gt_per_seed)
            if which == "votenet":
                fn, kw["with_yaw"] = votenet_loss, cfg.with_yaw
            else:
                fn, kw["coder"] = votenet_v1_loss, chip_smoke.tiny_coder()
            losses = fn(inputs, gt["points"], gt["gt_boxes"],
                        gt["gt_labels"], gt["gt_valid"], **kw)
    sum(losses.values()).backward()
    return {"losses": {k: float(v.detach()) for k, v in losses.items()},
            "grads": grads_of(inputs)}


def model_state(model, opt):
    """Every variable, AdamW's moments and count, as CPU tensors."""
    out = {f"var/{k}": v.detach().clone()
           for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        for k in ("mu", "nu"):
            out[f"{k}/{name}"] = opt.state[p][k].clone()
    out["count"] = torch.tensor(opt.count)
    return out


def train_steps(batch, group, model, opt, make_step, cfg, steps):
    """`steps` steps of `make_step(model, cfg, opt, group=group)` on one
    batch: each step's metrics, the first step's gradients, batch
    statistics and parameters, the state after the last."""
    step = make_step(model, cfg, opt, group=group)
    out = {"metrics": []}
    for i in range(steps):
        out["metrics"].append({k: float(v) for k, v in step(batch).items()})
        if i == 0:
            out["grads"] = {n: p.grad.clone()
                            for n, p in model.named_parameters()}
            out["stats"] = {n: v.clone() for n, v in model.named_buffers()}
            out["params"] = {n: p.detach().clone()
                             for n, p in model.named_parameters()}
    out["state"] = model_state(model, opt)
    return out


def fcaf3d_steps(batch, group, dtype, steps):
    cfg = dataclasses.replace(tconfigs.fcaf3d_nano(),
                              compute_dtype=str(dtype).split(".")[1])
    model, opt, _ = chip_smoke.seeded(create_train_state(cfg, 0, "cpu"),
                                      init_variables(cfg, 0))
    model.to(dtype)  # in place: the optimizer keeps the parameters
    return train_steps(batch, group, model, opt, make_train_step, cfg, steps)


def vote_steps(batch, group, v1, steps):
    cfg = tconfigs.votenet_tiny()
    coder, make = None, make_votenet_train_step
    if v1:
        cfg = dataclasses.replace(cfg, head_version="v1")
        coder, make = chip_smoke.tiny_coder(), make_votenet_v1_train_step
    model, opt, _ = chip_smoke.seeded(
        create_votenet_train_state(cfg, 0, "cpu", coder=coder),
        init_votenet_variables(cfg, 0, coder))
    model.to(torch.float64)
    return train_steps(f64(batch), group, model, opt, make, cfg, steps)


def mini_loader(root, cfg, group_rank, group_world):
    """`tools/train.py`'s ScanNet train pipeline over the mini train split,
    this rank's shard."""
    d = tdata
    pipe = d.Compose([
        d.GlobalAlignment(), d.PointSample(cfg.num_points),
        d.RandomFlip(0.5, 0.5, with_yaw=False),
        d.GlobalRotScaleTrans((-0.087266, 0.087266), (0.9, 1.1), (0.1,) * 3,
                              with_yaw=False)])
    ds = d.IndoorDetDataset(
        root, os.path.join(root, "scannet_infos_train.pkl"), CLASSES, pipe)
    return d.Loader(ds, cfg.batch_size, cfg.num_points, cfg.max_gt_boxes,
                    num_workers=2, shard_index=group_rank,
                    num_shards=group_world)


def float64_state(cfg, seed, device, steps_per_epoch):
    """`create_train_state` with the model in float64 (the seam that
    `train_model` runs in float64 through)."""
    model, opt, count = create_train_state(cfg, seed, device,
                                           steps_per_epoch)
    return model.to(torch.float64), opt, count


TRAIN_CFG = dict(batch_size=2, max_epochs=2, lr_steps=(1,),
                 compute_dtype="float64")


def train_run(root, work, group):
    """`train_model` at fcaf3d_nano in float64, 2 epochs of 2 global
    batches of 2 (LR x0.1 after the first)."""
    cfg = dataclasses.replace(tconfigs.fcaf3d_nano(), **TRAIN_CFG)
    real = tapis_train.create_train_state
    tapis_train.create_train_state = float64_state
    try:
        model, opt = tapis_train.train_model(
            cfg, mini_loader(root, cfg, group.rank if group else 0,
                             group.world if group else 1),
            work, log_interval=1, device="cpu", group=group)
    finally:
        tapis_train.create_train_state = real
    return model_state(model, opt)


def val_set(root, cfg):
    return tdata.IndoorDetDataset(
        root, os.path.join(root, "scannet_infos_val.pkl"), CLASSES,
        make_test_pipeline(cfg), test_mode=True)


def evaluations(root, group, batch_size):
    """fcaf3d_tiny's metrics on the val split, without and with TTA."""
    cfg = tconfigs.fcaf3d_tiny()
    model = init_detector(cfg, seed=0, device="cpu")
    return {tta: evaluate_dataset(model, val_set(root, cfg), cfg,
                                  batch_size=batch_size, tta=tta,
                                  group=group)
            for tta in (False, True)}


def _rank(group, spec, out_dir):
    torch.set_num_threads(1)
    r, w = group.rank, group.world
    out = {"collectives": collectives(group)}
    for name in ("sparse_bn", "pointnet2_bn"):
        out[name] = batch_norm({**spec[name],
                                "batch": rows(spec[name]["batch"], r, w)},
                               group, name == "sparse_bn")
    for which in ("fcaf3d", "votenet", "votenet_v1"):
        out[f"{which}_loss"] = loss_and_grads(rows(spec[which], r, w), group,
                                              which)
    local = rows(spec["fcaf3d_batch"], r, w)
    out["fcaf3d_f64"] = fcaf3d_steps(local, group, torch.float64, STEPS)
    out["fcaf3d_f32"] = fcaf3d_steps(local, group, torch.float32, 1)
    local = rows(spec["vote_batch"], r, w)
    out["votenet"] = vote_steps(local, group, False, STEPS)
    out["votenet_v1"] = vote_steps(local, group, True, STEPS)
    for n_val, root in spec["val_roots"].items():
        out[f"eval_{n_val}"] = evaluations(root, group, W)
    out["train"] = train_run(spec["train_root"], spec["train_work"], group)
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))


# ------------------------------------------------------ the parent's side

def head_outputs(batch):
    """fcaf3d_nano's train-mode head outputs in float64 on `batch`, as
    numpy level tuples (centerness, bbox_pred, cls_scores, points,
    valid)."""
    cfg = dataclasses.replace(tconfigs.fcaf3d_nano(), compute_dtype="float64")
    model, _, _ = chip_smoke.seeded(create_train_state(cfg, 0, "cpu"),
                                    init_variables(cfg, 0))
    model.to(torch.float64)
    with torch.no_grad():
        outs, _ = model(*(torch.as_tensor(batch[k])
                          for k in ("points", "colors", "valid")))
    return [tuple(f.numpy() for f in lv) for lv in outs]


def vote_predictions(batch, v1):
    cfg = tconfigs.votenet_tiny()
    coder = None
    if v1:
        cfg = dataclasses.replace(cfg, head_version="v1")
        coder = chip_smoke.tiny_coder()
    model, _, _ = chip_smoke.seeded(
        create_votenet_train_state(cfg, 0, "cpu", coder=coder),
        init_votenet_variables(cfg, 0, coder))
    model.to(torch.float64)
    with torch.no_grad():
        preds = model(torch.as_tensor(batch["points"]))
    return {k: v.numpy() for k, v in preds.items()}


def no_gt_for_sample_1(batch):
    """The batch's GT with sample 1's boxes dropped: its rank holds no
    positives."""
    gt = {k: batch[k].copy() for k in ("gt_boxes", "gt_labels", "gt_valid")}
    gt["gt_valid"][1] = False
    return gt


def write_roots(tmp):
    """A val root of 3 scenes (odd: the sharded evaluation pads its last
    batch) and one of 4, their GT from the port's detections, and the
    mini train root (5 scenes)."""
    cfg = tconfigs.fcaf3d_tiny()
    model = init_detector(cfg, seed=0, device="cpu")
    val_roots = {}
    for n_val in (3, 4):
        root = str(tmp / f"val{n_val}")
        chip_smoke.write_scannet_root(root, 1, n_val, len(CLASSES),
                                      n_boxes=4, extent=0.6, box_points=150,
                                      floor_points=100)
        ann = os.path.join(root, "scannet_infos_val.pkl")
        chip_smoke.gt_from_detections(root, ann, ann, cfg, model)
        val_roots[n_val] = root
    train_root = str(tmp / "train")
    chip_smoke.write_scannet_root(train_root, 5, 1, len(CLASSES), n_boxes=4,
                                  extent=0.6, box_points=150,
                                  floor_points=100)
    return val_roots, train_root


def jax_steps(fcaf3d_batch, vote_batch):
    """The JAX package's single-device train steps at the global batch,
    through the single-process tests' harnesses, compiled in this process
    without the persistent compilation cache (as `tests/test_torch_ops.py`'s
    `jax_without_persistent_cache` runs them): {"fcaf3d": the f32
    fcaf3d_nano step, "fcaf3d_mesh": `jax_mesh_step`'s, "votenet": (the
    float64 votenet_tiny step, its lr, its ball queries' overflows)}."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    from fcaf3d_tpu import configs as jconfigs
    from fcaf3d_tpu.models import pointnet2 as jp2
    from tests import test_torch_train, test_torch_votenet_train

    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    jax.clear_caches()
    overflows = []
    try:
        _, fcaf3d = test_torch_train.step_on_both_sides(
            tconfigs.fcaf3d_nano(), jconfigs.fcaf3d_nano(), fcaf3d_batch)
        fcaf3d_mesh = jax_mesh_step(fcaf3d_batch)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jp2, "ball_query",
                       test_torch_votenet_train.grid_ball_query_into(
                           overflows))
            _, votenet, lr = test_torch_votenet_train.step_on_both_sides(
                tconfigs.votenet_tiny(), vote_batch)
    finally:
        jax.config.update("jax_enable_compilation_cache", was)
        compilation_cache.reset_cache()
    return {"fcaf3d": fcaf3d, "fcaf3d_mesh": fcaf3d_mesh,
            "votenet": (votenet, lr, overflows)}


def jax_mesh_step(batch):
    """The JAX package's own data-parallel step: its trainer's
    `make_train_step(mesh=data_mesh(jax.devices()[:2]))` at fcaf3d_nano
    from the port's seed-0 variables, on the global batch: the metrics, the
    parameters and batch statistics after it, by the port's names."""
    import jax
    import jax.numpy as jnp

    from fcaf3d_tpu import configs as jconfigs
    from fcaf3d_tpu.models.detector import FCAF3D as JFCAF3D
    from fcaf3d_tpu.parallel import data_mesh
    from fcaf3d_tpu.train import make_optimizer, make_train_step as j_step
    from fcaf3d_tpu.train.trainer import TrainState
    from fcaf3d_tpu_torch.params import flatten, init_variables

    cfg = jconfigs.fcaf3d_nano()
    tx = make_optimizer(lr=cfg.lr, weight_decay=cfg.weight_decay,
                        grad_clip=cfg.grad_clip, steps_per_epoch=1,
                        lr_steps=cfg.lr_steps)
    v = jax.tree_util.tree_map(
        jnp.asarray, init_variables(tconfigs.fcaf3d_nano(), seed=0))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]))
    step = j_step(JFCAF3D(cfg), cfg, tx, mesh=data_mesh(jax.devices()[:W]))
    state, metrics = step(state, {k: jnp.asarray(a)
                                  for k, a in batch.items()})
    return {"metrics": {k: float(x) for k, x in metrics.items()},
            "params": {k: np.asarray(x)
                       for k, x in flatten(state.params).items()},
            "stats": {k: np.asarray(x)
                      for k, x in flatten(state.batch_stats).items()}}


@pytest.fixture(scope="module")
def one_intra_op_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, one_intra_op_thread):
    """(each rank's results, the spec they ran on, the W = 1 results): the
    W = 2 ranks run in a spawn while the parent computes W = 1."""
    tmp = tmp_path_factory.mktemp("dp")
    nano = tconfigs.fcaf3d_nano()
    fcaf3d_batch = chip_smoke.head_batch(torch, nano, NANO_EXTENT)
    vote_batch = chip_smoke.vote_head_batch(tconfigs.votenet_tiny())
    val_roots, train_root = write_roots(tmp)
    spec = {
        "sparse_bn": {
            "batch": {"x": draw(5, 0, (2, 40, 6)),
                      "valid": np.arange(40)[None] < np.array([[33], [17]]),
                      "up": draw(6, 0, (2, 40, 6))},
            "scale": draw(7, 0, 6), "bias": draw(8, 0, 6)},
        "pointnet2_bn": {
            "batch": {"x": 3 + draw(9, 0, (2, 9, 5, 4)),
                      "up": draw(10, 0, (2, 9, 5, 4))},
            "scale": draw(11, 0, 4), "bias": draw(12, 0, 4)},
        "fcaf3d": {"inputs": head_outputs(fcaf3d_batch),
                   "gt": no_gt_for_sample_1(fcaf3d_batch)},
        "fcaf3d_batch": fcaf3d_batch,
        "vote_batch": vote_batch,
        "val_roots": val_roots,
        "train_root": train_root,
        "train_work": str(tmp / "work_w2"),
    }
    vote64 = f64(vote_batch)
    for which, v1 in (("votenet", False), ("votenet_v1", True)):
        spec[which] = {"inputs": vote_predictions(vote64, v1),
                       "gt": {"points": vote64["points"],
                              **no_gt_for_sample_1(vote64)}}
    out_dir = tmp / "out"
    out_dir.mkdir()
    with cf.ThreadPoolExecutor(1) as pool:
        job = pool.submit(spawn, _rank, W, spec, str(out_dir))
        single = {name: batch_norm(spec[name], None, name == "sparse_bn")
                  for name in ("sparse_bn", "pointnet2_bn")}
        for which in ("fcaf3d", "votenet", "votenet_v1"):
            single[f"{which}_loss"] = loss_and_grads(spec[which], None,
                                                     which)
        single["fcaf3d_f64"] = fcaf3d_steps(fcaf3d_batch, None,
                                            torch.float64, STEPS)
        single["votenet"] = vote_steps(vote_batch, None, False, STEPS)
        single["votenet_v1"] = vote_steps(vote_batch, None, True, STEPS)
        for n_val, root in val_roots.items():
            single[f"eval_{n_val}"] = evaluations(root, None, W)
        single["train"] = train_run(train_root, str(tmp / "work_w1"), None)
        single["jax"] = jax_steps(fcaf3d_batch, vote_batch)
        job.result()
    got = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
           for r in range(W)]
    return got, spec, single


# ----------------------------------------------------------------- checks

def assert_close(got, want, what, rtol=RTOL):
    """Every element within `rtol` of the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def test_no_group_is_the_identity():
    """With no group active the collectives hand back their inputs: the
    model code computes what one process computes."""
    x, v = torch.ones(3), torch.zeros(2)
    assert global_sums(x, v)[0] is x and global_batch(v)[0] is v
    with data_parallel(None):
        assert global_sums(x)[0] is x


def test_refuses_unknown_backends_and_misplaced_tensors(tmp_path):
    """An unknown backend and NCCL off a card refuse to start; an NCCL
    collective refuses a tensor off its rank's card (before any
    communication)."""
    store = f"file://{tmp_path / 'store'}"
    with pytest.raises(ValueError, match="backend"):
        init_group("mpi", 0, 1, "cpu", store)
    with pytest.raises(ValueError, match="NCCL runs on a card"):
        init_group("nccl", 0, 1, "cpu", store)
    group = Group("nccl", 0, 1, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="tensors on cuda:0"):
        group.all_reduce(torch.ones(2))


def test_collectives_match_their_closed_form(ranks):
    """The differentiable sum: forward the sum of the ranks' inputs,
    backward the sum of their upstream gradients; the gather: the ranks'
    rows in rank order, each rank's gradient its own rows' slice; the max,
    the object gather, `broadcast_module` (rank 0's values) and
    `all_reduce_grads` (summed, not averaged)."""
    got, _, _ = ranks
    y = sum(draw(1, r, (3, 4)) for r in range(W))
    x_grad = sum(draw(2, r, (3, 4)) for r in range(W))
    g = np.concatenate([draw(3, r, (5,)) for r in range(W)])
    d = draw(4, 0, (5 * W,))
    for r, res in enumerate(got):
        c = res["collectives"]
        assert_close(c["y"], y, "sum")
        assert_close(c["x_grad"], x_grad, "sum backward")
        np.testing.assert_array_equal(c["g"].numpy(), g)
        np.testing.assert_array_equal(c["v_grad"].numpy(),
                                      d[r * 5:(r + 1) * 5])
        assert c["max"].tolist() == [W - 1, 0]
        assert c["objects"] == [("rank", i) for i in range(W)]
        assert all((p == v).all() for p, v in zip(c["params"], (1.0, 0.0)))
        assert all((p == W * (W + 1) / 2).all() for p in c["grads"])


@pytest.mark.parametrize("name", ["sparse_bn", "pointnet2_bn"])
def test_batch_norm_statistics_are_the_global_batch(ranks, name):
    """`SparseBatchNorm` (samples with 33 and 17 valid rows) and the
    PointNet++ `BatchNorm` at W = 2 against W = 1 on the concatenated batch
    in float64: outputs and input gradients by rows, parameter gradients
    summed over the ranks, running statistics on every rank."""
    got, _, single = ranks
    want = single[name]
    for r, res in enumerate(got):
        b = res[name]
        for k in ("out", "x_grad"):
            assert_close(b[k], want[k][r:r + 1], f"{name} rank {r} {k}")
        for k in ("mean", "var"):
            assert_close(b[k], want[k], f"{name} rank {r} {k}")
    for k in ("scale_grad", "bias_grad"):
        assert_close(sum(res[name][k] for res in got), want[k],
                     f"{name} {k}")


@pytest.mark.parametrize("which", ["fcaf3d", "votenet", "votenet_v1"])
def test_losses_use_global_normalisers(ranks, which):
    """`fcaf3d_loss`, `votenet_loss` and `votenet_v1_loss` at W = 2 against
    W = 1 in float64, the rank of sample 1 holding no positives: FCAF3D's
    losses are the global ones on every rank, VoteNet's ranks' shares sum
    to them; each rank's input gradients are W = 1's at its rows."""
    got, _, single = ranks
    want = single[f"{which}_loss"]
    assert want["losses"]["loss_bbox" if which == "fcaf3d"
                          else "center_loss"] > 0
    for k, v in want["losses"].items():
        if which == "fcaf3d":
            parts = [res[f"{which}_loss"]["losses"][k] for res in got]
            assert all(abs(p - v) <= RTOL * abs(v) for p in parts), (k, parts)
        else:
            total = sum(res[f"{which}_loss"]["losses"][k] for res in got)
            assert abs(total - v) <= RTOL * max(abs(v), 1e-30), (k, total, v)

    def check(got_tree, want_tree, r, what):
        if isinstance(want_tree, dict):
            for k in want_tree:
                check(got_tree[k], want_tree[k], r, f"{what}/{k}")
        elif isinstance(want_tree, list):
            for i, (a, b) in enumerate(zip(got_tree, want_tree)):
                check(a, b, r, f"{what}/{i}")
        elif want_tree is None:
            assert got_tree is None, what
        else:
            assert_close(got_tree, want_tree[r:r + 1], what)

    for r, res in enumerate(got):
        check(res[f"{which}_loss"]["grads"], want["grads"], r, which)


def zero_grad_scale(name, grads):
    """A Dense bias ahead of a train-mode BN has an exact gradient of 0
    (the BN removes the batch mean), so both sides hold rounding noise:
    its scale is the largest gradient of the layer's kernel. None for
    every other leaf."""
    if not name.endswith("Dense_0.bias"):
        return None
    return float(grads[name[:-4] + "kernel"].abs().max())


@pytest.mark.parametrize("path", ["fcaf3d_f64", "votenet", "votenet_v1"])
def test_dp_steps_match_one_process(ranks, path):
    """Two data-parallel steps at W = 2 (fcaf3d_nano, votenet_tiny v2 and
    v1; float64) against the W = 1 steps at the global batch: metrics of
    both steps and the first step's summed gradients within RTOL; then
    every variable, both AdamW moments and the count within RTOL for
    FCAF3D and ADAM_RTOL for VoteNet, whose exact-zero gradients
    (`zero_grad_scale`) and their moments are held to RTOL of their
    kernel's gradients; every rank's state bitwise equal to rank 0's."""
    got, _, single = ranks
    want = single[path]
    rtol = RTOL if path.startswith("fcaf3d") else ADAM_RTOL
    for r, res in enumerate(got):
        mine = res[path]
        for i, (m, mw) in enumerate(zip(mine["metrics"], want["metrics"])):
            assert set(m) == set(mw)
            for k, v in mw.items():
                assert abs(m[k] - v) <= RTOL * max(abs(v), 1e-30), (i, k)
        assert set(mine["grads"]) == set(want["grads"])
        for name, g in want["grads"].items():
            scale = zero_grad_scale(name, want["grads"])
            if scale is None:
                assert_close(mine["grads"][name], g, f"{path} grad {name}")
            else:
                for side in (mine["grads"][name], g):
                    assert float(side.abs().max()) <= RTOL * scale, name
        assert set(mine["state"]) == set(want["state"])
        for k, v in want["state"].items():
            kind, _, name = k.partition("/")
            scale = (zero_grad_scale(name, want["grads"])
                     if kind in ("mu", "nu") else None)
            if not v.dtype.is_floating_point:
                assert torch.equal(mine["state"][k], v), k
            elif scale is not None:
                atol = RTOL * scale if kind == "mu" else (RTOL * scale) ** 2
                assert float((mine["state"][k] - v).abs().max()) <= atol, k
            else:
                assert_close(mine["state"][k], v, f"{path} {k}", rtol)
        for k, v in got[0][path]["state"].items():
            assert torch.equal(mine["state"][k], v), (r, k)


def test_fcaf3d_dp_step_matches_jax(ranks):
    """The W = 2 step at fcaf3d_nano in f32 against the JAX package's
    single-device step at the global batch of 2, with the JAX variables
    carried across by `params.py`: `tests/test_torch_train.py`'s
    `assert_step_matches` (losses and gradient norm 1e-4, gradients 1e-4
    of a leaf's largest, batch statistics 1e-5)."""
    from tests.test_torch_train import assert_step_matches

    got, _, single = ranks
    for res in got:
        mine = res["fcaf3d_f32"]
        assert_step_matches({"metrics": mine["metrics"][0],
                             "grads": mine["grads"],
                             "stats": mine["stats"]},
                            single["jax"]["fcaf3d"])


def test_fcaf3d_dp_step_matches_the_jax_mesh_step(ranks):
    """The W = 2 step (f32, fcaf3d_nano) against the JAX package's own
    data-parallel step on a mesh of 2 CPU devices (`jax_mesh_step`):
    losses and gradient norm within 1e-4, overflow equal, batch statistics
    within 1e-5; parameters after AdamW within 1e-6 where the port's
    clipped gradient exceeds 1e-4 and its leaf's tolerance (there the
    first update, g / (|g| + 1e-8), is fixed), elsewhere within the step's
    bound, 2 lr plus the decay (Adam maps a gradient at rounding level to
    anything in [-lr, lr])."""
    got, _, single = ranks
    want = single["jax"]["fcaf3d_mesh"]
    cfg = tconfigs.fcaf3d_nano()
    for res in got:
        mine = res["fcaf3d_f32"]
        m = mine["metrics"][0]
        for k in ("loss_cls", "loss_centerness", "loss_bbox", "loss",
                  "grad_norm"):
            np.testing.assert_allclose(m[k], want["metrics"][k], rtol=1e-4,
                                       err_msg=k)
        assert m["overflow_max"] == want["metrics"]["overflow_max"]
        assert m["loss_bbox"] > 0
        for name, v in want["stats"].items():
            np.testing.assert_allclose(mine["stats"][name].numpy(), v,
                                       rtol=0, atol=1e-5, err_msg=name)
        clip = min(1.0, cfg.grad_clip / m["grad_norm"])
        assert set(want["params"]) == set(mine["params"])
        for name, p_want in want["params"].items():
            g = np.abs(mine["grads"][name].numpy())
            p_got = mine["params"][name].numpy()
            fixed = (g * clip > 1e-4) & (g > 10 * 1e-4 * g.max())
            np.testing.assert_allclose(p_got[fixed], p_want[fixed], rtol=0,
                                       atol=1e-6, err_msg=name)
            assert (np.abs(p_got - p_want)[~fixed] <= 2 * cfg.lr * (
                1 + cfg.weight_decay * np.abs(p_want[~fixed])) + 1e-6).all()


def test_votenet_dp_step_matches_jax(ranks):
    """The W = 2 VoteNet-v2 step at votenet_tiny in float64 against the JAX
    trainer's step at the global batch of 2 (float64, its ball query the
    grid formulation, no call overflowing), held as
    `tests/test_torch_votenet_train.py` holds the single-process step
    (losses 1e-4, gradients 1e-4 of a leaf's largest, parameters after
    AdamW, batch statistics 1e-5)."""
    from tests.test_torch_votenet_train import V2_LOSSES, assert_step_matches

    got, _, single = ranks
    want, lr, overflows = single["jax"]["votenet"]
    assert overflows and max(overflows) <= 0
    for res in got:
        mine = res["votenet"]
        assert_step_matches({
            "metrics": mine["metrics"][0],
            "grads": {k: v.numpy() for k, v in mine["grads"].items()},
            "stats": {k: v.numpy() for k, v in mine["stats"].items()},
            "params": {k: v.numpy() for k, v in mine["params"].items()}},
            want, lr, V2_LOSSES)


@pytest.mark.parametrize("n_val", [3, 4])
def test_sharded_evaluation_matches_one_process(ranks, n_val):
    """`evaluate_dataset(group=)` at W = 2, global batch 2, over 3 val
    scenes (the last batch padded, its copy's detections dropped) and 4,
    with and without TTA: every rank returns the single process's metric
    dict, with GT from the port's detections (mAP above 0)."""
    got, _, single = ranks
    want = single[f"eval_{n_val}"]
    assert want[False]["mAP_0.25"] > 0
    for res in got:
        assert res[f"eval_{n_val}"] == want


def test_train_model_dp_matches_one_process(ranks):
    """`train_model(group=)` at W = 2 for 2 epochs (fcaf3d_nano in float64,
    global batch 2 from `Loader(shard_index=, num_shards=)`): rank 0 alone
    wrote the meta, one checkpoint and a log of one record a step and
    epoch; every rank's final state within RTOL of the W = 1 run's and
    bitwise equal to rank 0's."""
    import json

    got, spec, single = ranks
    work = spec["train_work"]
    assert sorted(os.listdir(os.path.join(work, "ckpts"))) == [
        "epoch_2.pt", "meta.json"]
    assert latest_epoch(work) == 2
    with open(os.path.join(work, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [(r["epoch"], r["iter"]) for r in recs if "loss" in r] == [
        (1, 1), (1, 2), (2, 1), (2, 2)]
    assert len(recs) == 6
    for res in got:
        assert set(res["train"]) == set(single["train"])
        for k, v in single["train"].items():
            if v.dtype.is_floating_point:
                assert_close(res["train"][k], v, f"train_model {k}")
            else:
                assert torch.equal(res["train"][k], v), k
        for k, v in got[0]["train"].items():
            assert torch.equal(res["train"][k], v), k


def test_one_rank_group_adds_nothing(tmp_path, one_intra_op_thread):
    """A gloo group of one rank: two FCAF3D steps (f32) and one VoteNet-v2
    step bitwise equal to the steps without a group."""
    fcaf3d_batch = chip_smoke.head_batch(torch, tconfigs.fcaf3d_nano(),
                                         NANO_EXTENT)
    vote_batch = chip_smoke.vote_head_batch(tconfigs.votenet_tiny())
    want = (fcaf3d_steps(fcaf3d_batch, None, torch.float32, 2),
            vote_steps(vote_batch, None, False, 1))
    group = init_group("gloo", 0, 1, "cpu", f"file://{tmp_path / 'store'}")
    try:
        got = (fcaf3d_steps(fcaf3d_batch, group, torch.float32, 2),
               vote_steps(vote_batch, group, False, 1))
    finally:
        torch.distributed.destroy_process_group()
    for g, w in zip(got, want):
        assert g["metrics"] == w["metrics"]
        for k, v in w["state"].items():
            assert torch.equal(g["state"][k], v), k


def test_dryrun_exits_zero():
    """`python -m fcaf3d_tpu_torch.parallel.dryrun 2`: both ranks print the
    three phases."""
    proc = subprocess.run(
        [sys.executable, "-m", "fcaf3d_tpu_torch.parallel.dryrun", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    for r in range(2):
        for phase in ("fcaf3d DP step ok", "sharded eval ok",
                      "votenet DP step ok"):
            assert f"dryrun(2) rank {r}: {phase}" in proc.stdout


