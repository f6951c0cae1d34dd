"""The port's train -> checkpoint loop on the CPU: `train_model` (meta,
per-epoch checkpoints, bitwise resume, `load_from`),
`init_detector(work_dir=)` and the three CLIs (`evaluate_dataset` against
the JAX package: `test_torch_platform_eval.py`).

The resumed run must be bitwise equal to the straight one: the CPU ops and
the loader's per-(seed, epoch, index) draws are deterministic.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu.train.checkpoint import save_meta as jsave_meta
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch import data as tdata
from fcaf3d_tpu_torch.apis import init_detector, train_model
from fcaf3d_tpu_torch.apis.test import evaluate_dataset, make_test_pipeline
from fcaf3d_tpu_torch.params import export_variables, flatten, init_variables
from fcaf3d_tpu_torch.train import latest_epoch, load_params
from tests.test_torch_platform import CLASSES, write_mini_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CLIs at fcaf3d_scannet's widths and 18 classes, at the tiny budgets
TINY_SET = ["num_points=512", "input_budget=512",
            "backbone_budgets=256,128,96,48,24,12", "neck_budgets=96,48,24,12",
            "compute_dtype=float32"]


def train_loader(root, cfg, d=tdata, seed=0):
    """`tools/train.py`'s ScanNet train pipeline over the mini train split
    (5 scenes, batch 2: 2 steps an epoch)."""
    pipe = d.Compose([
        d.GlobalAlignment(), d.PointSample(cfg.num_points),
        d.RandomFlip(0.5, 0.5, with_yaw=False),
        d.GlobalRotScaleTrans((-0.087266, 0.087266), (0.9, 1.1), (0.1,) * 3,
                              with_yaw=False)])
    ds = d.IndoorDetDataset(
        root, os.path.join(root, "scannet_infos_train.pkl"), CLASSES, pipe)
    return d.Loader(ds, cfg.batch_size, cfg.num_points, cfg.max_gt_boxes,
                    seed=seed, num_workers=2)


def val_set(root, cfg, d=tdata, pipeline=make_test_pipeline):
    return d.IndoorDetDataset(
        root, os.path.join(root, "scannet_infos_val.pkl"), CLASSES,
        pipeline(cfg), test_mode=True)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small CPU ops on one thread: the suite runs several test processes
    at once, and their intra-op thread pools would otherwise contend for
    the cores. Restores the setting afterwards."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    return write_mini_root(tmp_path_factory.mktemp("scannet"))


def state_of(model, opt):
    """Every variable, both moments and the count, as CPU tensors."""
    out = {f"var/{k}": v.clone() for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        for k in ("mu", "nu"):
            out[f"{k}/{name}"] = opt.state[p][k].clone()
    out["count"] = torch.tensor(opt.count)
    return out


def test_resume_is_bitwise_equal_to_a_straight_run(mini_root, tmp_path):
    """4 epochs of 2 steps (LR x0.1 at epochs 2 and 3) against 2 epochs,
    then `resume=True` to 4: every variable, mu, nu and count equal, the
    logs' losses equal; an eval hook runs after every epoch on both."""
    cfg = dataclasses.replace(tconfigs.fcaf3d_nano(), batch_size=2,
                              max_epochs=4, lr_steps=(2, 3))
    val = val_set(mini_root, cfg)
    evals = []

    def hook(model, epoch):
        evals.append(epoch)
        return {"mAP_0.25": evaluate_dataset(model, val, cfg)["mAP_0.25"]}

    straight = str(tmp_path / "straight")
    model, opt = train_model(cfg, train_loader(mini_root, cfg), straight,
                             log_interval=1, eval_hook=hook, device="cpu")
    want = state_of(model, opt)
    assert opt.count == 8 and latest_epoch(straight) == 4

    resumed = str(tmp_path / "resumed")
    train_model(dataclasses.replace(cfg, max_epochs=2),
                train_loader(mini_root, cfg), resumed, log_interval=1,
                eval_hook=hook, device="cpu")
    model, opt = train_model(cfg, train_loader(mini_root, cfg), resumed,
                             log_interval=1, eval_hook=hook, resume=True,
                             device="cpu")
    got = state_of(model, opt)
    assert evals == [1, 2, 3, 4, 1, 2, 3, 4]
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert sorted(os.listdir(os.path.join(resumed, "ckpts"))) == [
        "epoch_4.pt", "meta.json"]

    def losses(work):
        with open(os.path.join(work, "train_log.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        return [(r["epoch"], r["iter"], r["loss"]) for r in recs
                if "loss" in r]

    assert losses(resumed) == losses(straight)
    assert all(np.isfinite(x[2]) for x in losses(straight))


def test_train_model_meta_equals_jax(mini_root, tmp_path):
    """`ckpts/meta.json` is byte for byte what the JAX `save_meta` writes
    for the same config, classes and seed."""
    cfg = dataclasses.replace(tconfigs.fcaf3d_nano(), batch_size=2,
                              max_epochs=1)
    work = str(tmp_path / "port")
    train_model(cfg, train_loader(mini_root, cfg, seed=3), work, seed=3,
                classes=CLASSES, device="cpu")
    jcfg = dataclasses.replace(jconfigs.fcaf3d_nano(), batch_size=2,
                               max_epochs=1)
    jsave_meta(str(tmp_path / "jax"), {
        "classes": list(CLASSES), "config": dataclasses.asdict(jcfg),
        "config_class": type(jcfg).__name__, "seed": 3})
    got = (tmp_path / "port" / "ckpts" / "meta.json").read_bytes()
    assert got == (tmp_path / "jax" / "ckpts" / "meta.json").read_bytes()


def test_load_from_and_init_detector_work_dir(mini_root, tmp_path):
    """`load_from` of an 18-class run into a 5-class config: the cls conv
    keeps its fresh value and is reported, every other leaf is loaded.
    `init_detector(work_dir=)` gives the saved variables."""
    src_cfg = dataclasses.replace(tconfigs.fcaf3d_nano(n_classes=18),
                                  batch_size=2, max_epochs=1)
    src = str(tmp_path / "src")
    src_model, _ = train_model(src_cfg, train_loader(mini_root, src_cfg),
                               src, device="cpu")
    saved = flatten(export_variables(src_model))

    restored = init_detector(src_cfg, device="cpu", work_dir=src)
    assert not restored.training
    for k, v in flatten(export_variables(restored)).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    with pytest.raises(ValueError, match="not both"):
        init_detector(src_cfg, device="cpu", work_dir=src, params_file="x")

    cfg = dataclasses.replace(tconfigs.fcaf3d_nano(n_classes=5),
                              batch_size=2, max_epochs=1)
    fresh = flatten(init_variables(cfg, seed=0))
    model = init_detector(cfg, device="cpu")
    skipped = load_params(src, model)
    cls = ["params/neck_with_head/cls_conv/kernel",
           "params/neck_with_head/cls_conv/bias"]
    assert sorted(skipped) == sorted(cls)
    for k, v in flatten(export_variables(model)).items():
        want = fresh[k] if k.replace(".", "/") in cls else saved[k]
        np.testing.assert_array_equal(v, want, err_msg=k)

    # through train_model: the 5-class run starts from the loaded weights
    work = str(tmp_path / "five")
    train_model(cfg, train_loader(mini_root, cfg), work, load_from=src,
                device="cpu")
    assert latest_epoch(work) == 1


def run_cli(tool, *args):
    """`python -m fcaf3d_tpu_torch.tools.<tool> args` with one intra-op
    thread (see `one_intra_op_thread`); asserts exit 0, returns stdout."""
    out = subprocess.run(
        [sys.executable, "-m", f"fcaf3d_tpu_torch.tools.{tool}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """`tools.train` for one epoch on the CPU at tiny budgets: one train
    scene repeated 10 times, batch 4 (2 steps), then eval on 2 scenes."""
    tmp = tmp_path_factory.mktemp("cli")
    root = write_mini_root(tmp / "data", n_train=1, n_val=2)
    work = str(tmp / "work")
    out = run_cli("train", "--dataset", "scannet", "--data-root", root,
                  "--work-dir", work, "--batch", "4", "--epochs", "1",
                  "--device", "cpu", "--profile-steps", "1",
                  "--profile-out", str(tmp / "train_trace.json"),
                  "--set", *TINY_SET)
    return tmp, root, work, out


def trace_ranges(path):
    """{name: count} of the ranges a Chrome trace file holds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X"]
    return {n: names.count(n) for n in set(names)}


def test_train_cli_writes_the_profile_of_its_first_steps(cli_run):
    """`--profile-steps 1`: the first step's spans, once each, in a Chrome
    trace; the run goes on to its log and checkpoint."""
    tmp, _, work, _ = cli_run
    ranges = trace_ranges(tmp / "train_trace.json")
    for name in ("forward", "voxelize", "backbone", "neck_head", "loss",
                 "backward", "all_reduce_grads", "optimizer"):
        assert ranges.get(name) == 1, (name, ranges.get(name))
    assert "get_bboxes" not in ranges  # the evaluation ran after it
    assert os.path.exists(os.path.join(work, "ckpts", "epoch_1.pt"))


def test_train_cli(cli_run):
    _, _, work, out = cli_run
    assert "[eval epoch 1] mAP_0.25=" in out
    assert sorted(os.listdir(os.path.join(work, "ckpts"))) == [
        "epoch_1.pt", "meta.json"]
    with open(os.path.join(work, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["num_points"] == 512 and cfg["n_classes"] == 18
    with open(os.path.join(work, "ckpts", "meta.json")) as f:
        assert json.load(f)["classes"] == list(tdata.SCANNET_CLASSES)
    with open(os.path.join(work, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["iter"] for r in recs if "iter" in r] == [2]
    assert "eval" in recs[-1]


def test_test_cli(cli_run):
    tmp, root, work, _ = cli_run
    metrics = str(tmp / "m.json")
    out = run_cli("test", "--dataset", "scannet", "--data-root", root,
                  "--work-dir", work, "--tta", "--out", metrics,
                  "--show-dir", str(tmp / "show"), "--device", "cpu",
                  "--profile-steps", "1",
                  "--profile-out", str(tmp / "test_trace.json"))
    for key in ("mAP_0.25", "mAP_0.50", "mAR_0.25", "mAR_0.50"):
        assert f"\n{key}: " in "\n" + out
    # the first batch of 4 flips: 4 forwards and post-processings
    ranges = trace_ranges(tmp / "test_trace.json")
    assert ranges.get("voxelize") == 4 and ranges.get("get_bboxes") == 4
    with open(metrics) as f:
        assert {"mAP_0.25", "mAP_0.50"} <= set(json.load(f))
    assert os.listdir(tmp / "show")


def test_pcd_demo_cli(cli_run):
    tmp, root, work, _ = cli_run
    out_dir = tmp / "demo"
    # two steps from the reference's init leave every score under the
    # config's score_thr (its class prior is 0.01): keep them all
    out = run_cli("pcd_demo", os.path.join(root, "points", "val_00000.bin"),
                  "--work-dir", work, "--out-dir", str(out_dir),
                  "--score-thr", "0", "--device", "cpu", "--set", *TINY_SET,
                  "score_thr=0")
    assert "detections above 0.0" in out
    assert sorted(os.listdir(out_dir)) == ["val_00000_points.obj",
                                           "val_00000_pred.obj"]
