"""The port's remaining tools against the JAX package's, on the CPU:
`tools.print_config` (the same JSON for every config of the JAX tool),
`tools.analyze_logs cal_train_time` (the same report on a log that the
port's `train_model` wrote) and `tools.browse_dataset` (byte-equal `.obj`
files on a tree converted by `tools.create_data`). The JAX tools run
in process through `runpy` with their command lines.
"""
import dataclasses
import json
import os
import runpy
import sys

import numpy as np
import pytest

from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import train_model
from fcaf3d_tpu_torch.data import Loader
from fcaf3d_tpu_torch.tools import analyze_logs, browse_dataset, create_data
from fcaf3d_tpu_torch.tools import print_config
from tests.test_torch_prep import scannet_raw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = ("fcaf3d_scannet", "fcaf3d_sunrgbd", "fcaf3d_s3dis",
               "fcaf3d_tiny", "fcaf3d_nano", "votenet_sunrgbd")


def run_jax_tool(name, args, monkeypatch, capsys):
    """`python tools/<name>.py args` in process; returns its stdout."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [name, *args])
    runpy.run_path(os.path.join(REPO, "tools", f"{name}.py"),
                   run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("name", JAX_CONFIGS)
def test_print_config_equals_jax(name, monkeypatch, capsys):
    want = run_jax_tool("print_config", [name], monkeypatch, capsys)
    got = print_config.main([name])
    assert capsys.readouterr().out == want
    assert json.loads(json.dumps(got)) == json.loads(want)


def test_print_config_other_configs_and_overrides(capsys):
    """The port's configs beyond the JAX tool's list, and `--set`."""
    for name in set(print_config.CONFIGS) - set(JAX_CONFIGS):
        got = print_config.main([name])
        assert got == dataclasses.asdict(getattr(tconfigs, name)())
    got = print_config.main(["fcaf3d_tiny", "--set", "lr=0.01",
                             "lr_steps=3,4"])
    assert got["lr"] == 0.01 and tuple(got["lr_steps"]) == (3, 4)
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.rindex("\n{"):]) == json.loads(
        json.dumps(got))


def test_cal_train_time_on_a_train_model_log(tmp_path, monkeypatch, capsys):
    """`train_model` at `fcaf3d_nano` for 2 epochs of 2 steps, logging every
    step: the port's report equals the JAX tool's on that log, and its
    returned statistics are the log's."""
    cfg = dataclasses.replace(tconfigs.fcaf3d_nano(), max_epochs=2,
                              batch_size=1)

    class Scenes:
        classes = ("a", "b", "c", "d")

        def __len__(self):
            return 2

        def __call__(self, i, rng):
            r = np.random.RandomState(i)
            boxes = np.zeros((2, 7), np.float32)
            boxes[:, :2] = r.uniform(0.1, 0.2, (2, 2))
            boxes[:, 3:6] = 0.1
            pts = r.uniform(0, 0.3, (cfg.num_points, 6)).astype(np.float32)
            return {"points": pts, "gt_boxes": boxes,
                    "gt_labels": np.array([0, 1])}

    work = str(tmp_path / "work")
    train_model(cfg, Loader(Scenes(), 1, cfg.num_points, cfg.max_gt_boxes),
                work, log_interval=1, device="cpu")
    log = os.path.join(work, "train_log.jsonl")
    want = run_jax_tool("analyze_logs", ["cal_train_time", log], monkeypatch,
                        capsys)
    stats = analyze_logs.main(["cal_train_time", log])
    assert capsys.readouterr().out == want
    times = [r["time"] for r in analyze_logs.load(log) if "time" in r]
    assert len(times) == 4 and "epoch 2:" in want
    assert stats["mean"] == pytest.approx(np.mean(times))
    assert sorted(stats["epochs"]) == [1, 2]
    assert analyze_logs.cal_train_time([{"epoch": 1}]) is None


@pytest.mark.parametrize("aug", [False, True])
def test_browse_dataset_equals_jax(aug, tmp_path, monkeypatch, capsys):
    """A ScanNet tree converted by `tools.create_data`: the port's tool
    writes byte-equal `.obj` files to the JAX tool's (with `--no-aug`, the
    test pipeline; without, the train augmentation)."""
    root = str(tmp_path / "scannet")
    scannet_raw(root, ("train", "val", "test"))
    create_data.main(["scannet", "--root-path", root, "--workers", "1"])
    args = ["--dataset", "scannet", "--data-root", root, "--max-samples",
            "2"] + ([] if aug else ["--no-aug"])
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    run_jax_tool("browse_dataset", args + ["--out-dir", out_j], monkeypatch,
                 capsys)
    names = browse_dataset.main(args + ["--out-dir", out_t])
    assert len(names) == 2
    files = sorted(os.listdir(out_j))
    assert sorted(os.listdir(out_t)) == files and len(files) == 4
    for f in files:
        with open(os.path.join(out_t, f), "rb") as a, \
                open(os.path.join(out_j, f), "rb") as b:
            assert a.read() == b.read(), f
