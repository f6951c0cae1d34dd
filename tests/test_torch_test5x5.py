"""The port's 5 x 5 evaluation protocol (`fcaf3d_tpu_torch.tools.test5x5`,
the counterpart of `tools/test5x5.py`) on the CPU at `fcaf3d_tiny`.

A work dir holds two epoch checkpoints of numpy weights (the seeded
`init_variables` draw and a jittered copy of it) on a tiny ScanNet-layout
tree whose val GT comes from the first weights' detections
(`tests/test_torch_platform_eval.py`'s fixture). The tool's loop must give
the min / mean / max of the port's `evaluate_dataset` over both epochs and
two seeds, and each (epoch, seed) metric dict must equal the JAX
package's `evaluate_dataset` on the same weights, scenes and seed, unless
an IoU lies within `chip_smoke.IOU_TIE_ATOL` of a threshold. Both sides'
IoU run on their numpy path.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu import data as jdata
from fcaf3d_tpu.apis import test as jtest
from fcaf3d_tpu.models.detector import FCAF3D as JFCAF3D
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import init_detector
from fcaf3d_tpu_torch.apis.test import evaluate_dataset
from fcaf3d_tpu_torch.params import init_variables, load_variables
from fcaf3d_tpu_torch.tools import test5x5 as t5
from fcaf3d_tpu_torch.train import (create_train_state, restore_checkpoint,
                                    save_checkpoint, saved_epochs)
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401
from tests.test_torch_platform import CLASSES, write_mini_root
from tests.test_torch_platform_train import (  # noqa: F401
    one_intra_op_thread, val_set)

N_SEEDS, BATCH = 2, 2


def jittered(tree, seed):
    """Every leaf of `tree` times (1 + 0.02 n), n standard normal."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (x * (1 + 0.02 * rng.standard_normal(x.shape))).astype(
            np.float32), tree)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """(root, work dir, cfg, {epoch: the numpy weights saved there})."""
    root = write_mini_root(tmp_path_factory.mktemp("val"), n_train=1,
                           n_val=4)
    cfg = tconfigs.fcaf3d_tiny()
    ann = os.path.join(root, "scannet_infos_val.pkl")
    chip_smoke.gt_from_detections(root, ann, ann, cfg,
                                  init_detector(cfg, device="cpu"))
    work = str(tmp_path_factory.mktemp("work"))
    weights = {1: init_variables(cfg, 0)}
    weights[2] = jittered(weights[1], 1)
    model, opt, _ = create_train_state(cfg, 0, "cpu")
    for epoch, tree in weights.items():
        load_variables(model, tree)
        save_checkpoint(work, epoch, model, opt, max_keep=2)
    assert saved_epochs(work) == [1, 2]
    return root, work, cfg, weights


@pytest.fixture
def numpy_iou(monkeypatch):
    """Both packages' evaluation IoU on its numpy path; returns the port's
    `indoor_eval` inputs, (GT, detections) a call."""
    import fcaf3d_tpu.native

    monkeypatch.setattr(fcaf3d_tpu.native, "pairwise_iou_3d",
                        lambda a, b: None)
    monkeypatch.setenv("FCAF3D_NATIVE", "0")
    module = sys.modules["fcaf3d_tpu_torch.apis.test"]
    real, calls = module.indoor_eval, []

    def record(gt, dt, *a):
        calls.append((gt, dt))
        return real(gt, dt, *a)
    monkeypatch.setattr(module, "indoor_eval", record)
    return calls


def stats(runs):
    return {k: dict(min=float(np.min(v)), mean=float(np.mean(v)),
                    max=float(np.max(v)))
            for k, v in ((key, [m[key] for _, _, m in runs])
                         for key in ("mAP_0.25", "mAP_0.50"))}


def test_loop_equals_evaluate_dataset_and_jax(work, numpy_iou):
    """The loop's runs are the port's `evaluate_dataset` over epochs 1-2
    and seeds 0-1 (in that order) and its result their min / mean / max;
    each run's metrics equal the JAX package's on the same weights, scenes
    and seed but where an IoU ties a threshold."""
    root, work_dir, cfg, weights = work
    val = val_set(root, cfg)
    runs, result = t5.test5x5(cfg, val, work_dir, n_ckpts=5,
                              n_seeds=N_SEEDS, batch=BATCH, device="cpu")
    assert [(e, s) for e, s, _ in runs] == [(1, 0), (1, 1), (2, 0), (2, 1)]
    assert result == stats(runs)
    assert result["mAP_0.25"]["min"] > 0
    model = init_detector(cfg, device="cpu")
    jcfg = jconfigs.fcaf3d_tiny()
    jval = val_set(root, jcfg, jdata, jtest.make_test_pipeline)
    n_eval = len(numpy_iou)
    compared = 0
    for epoch, seed, got in runs:
        assert restore_checkpoint(work_dir, model, epoch=epoch) == epoch
        assert evaluate_dataset(model, val, cfg, batch_size=BATCH,
                                seed=seed) == got
        want = jtest.evaluate_dataset(
            JFCAF3D(jcfg), jax.tree_util.tree_map(jnp.asarray,
                                                  weights[epoch]),
            jval, jcfg, batch_size=BATCH, seed=seed)
        gt, dt = numpy_iou[-1]
        ties = chip_smoke.iou_ties(gt, dt, (0.25, 0.5))
        print(f"epoch {epoch} seed {seed}: port {got['mAP_0.25']:.4f} / "
              f"{got['mAP_0.50']:.4f}, JAX {want['mAP_0.25']:.4f} / "
              f"{want['mAP_0.50']:.4f}, {len(ties)} IoU ties")
        if not ties:
            assert got == want, (epoch, seed)
            compared += 1
    assert len(numpy_iou) == n_eval + len(runs)
    assert compared > 0
    assert len({m["mAP_0.25"] for _, _, m in runs}) > 1


def test_cli_takes_the_last_epochs(work, numpy_iou, monkeypatch, capsys):
    """`main` with `--n-ckpts 1`: the table's config (here `fcaf3d_tiny`
    for "scannet") on the val split, only the last epoch under each seed,
    one line a run and the JSON of their statistics last."""
    root, work_dir, cfg, _ = work
    monkeypatch.setitem(t5.DATASETS, "scannet",
                        (tconfigs.fcaf3d_tiny, CLASSES,
                         "scannet_infos_val.pkl", True))
    t5.main(["--dataset", "scannet", "--data-root", root, "--work-dir",
             work_dir, "--n-ckpts", "1", "--n-seeds", str(N_SEEDS),
             "--batch", str(BATCH), "--device", "cpu"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:N_SEEDS]] == [
        f"epoch 2 seed {s}" for s in range(N_SEEDS)]
    model = init_detector(cfg, device="cpu")
    restore_checkpoint(work_dir, model, epoch=2)
    val = val_set(root, cfg)
    runs = [(2, s, evaluate_dataset(model, val, cfg, batch_size=BATCH,
                                    seed=s)) for s in range(N_SEEDS)]
    assert json.loads("\n".join(lines[N_SEEDS:])) == stats(runs)
