"""The port's platform copies held against the JAX package, on the CPU: the
`--set` overrides, the point columns, every pipeline transform, the
datasets and the loader over a small ScanNet-layout dataset
(`chip_smoke.write_scannet_root`), `indoor_eval` and its numpy IoU, the
TTA merge, the .obj dumps, `export_variables` and the checkpoint files.

Numpy copies must give exactly the JAX package's arrays and dicts; the TTA
merge's keep masks are exact and its boxes within 1e-6 (float32 flips on
either side).
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu import data as jdata
from fcaf3d_tpu.configs import override as joverride
from fcaf3d_tpu.core import eval as jeval
from fcaf3d_tpu.core import points as jpoints
from fcaf3d_tpu.data import datasets as jdatasets
from fcaf3d_tpu.data import pipelines as jpipes
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch import data as tdata
from fcaf3d_tpu_torch.configs import override as toverride
from fcaf3d_tpu_torch.core import eval as teval
from fcaf3d_tpu_torch.data import datasets as tdatasets
from fcaf3d_tpu_torch.data import pipelines as tpipes
from fcaf3d_tpu_torch.data import points as tpoints
from fcaf3d_tpu_torch.params import (export_variables, flatten,
                                     init_reference_variables,
                                     load_variables)
from fcaf3d_tpu_torch.train import (create_train_state, latest_epoch,
                                    make_train_step, restore_checkpoint,
                                    save_checkpoint)

CLASSES = ("a", "b", "c", "d")
# a z-rotation by 0.3 rad and a shift: GlobalAlignment moves every point
_C, _S = np.cos(0.3), np.sin(0.3)
ALIGN = np.array([[_C, -_S, 0, 0.2], [_S, _C, 0, -0.1], [0, 0, 1, 0.05],
                  [0, 0, 0, 1]], np.float32)


def write_mini_root(root, n_train=5, n_val=2, align=None):
    """`chip_smoke.write_scannet_root` at the tiny configs' scale: 4 boxes
    of 4 classes in a 0.6 m room, ~700 points a scene."""
    chip_smoke.write_scannet_root(str(root), n_train, n_val, len(CLASSES),
                                  n_boxes=4, extent=0.6, box_points=150,
                                  floor_points=100, align=align)
    return str(root)


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    return write_mini_root(tmp_path_factory.mktemp("scannet"), align=ALIGN)


def assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("assignments", [
    ["voxel_size=0.02"], ["lr=1", "lr_steps=8,11"], ["with_yaw=1"],
    ["neck_mode=reference", "max_epochs=3"], ["backbone_budgets=256,128"],
    ["compute_dtype=float32", "nms_cap=16", "score_thr=none"],
    ["neck_budgets=(96, 48)", "yaw_parametrization='naive'"]])
def test_apply_overrides_equals_jax(assignments):
    got = toverride.apply_overrides(tconfigs.fcaf3d_scannet(), assignments)
    want = joverride.apply_overrides(jconfigs.fcaf3d_scannet(), assignments)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("bad", [["nope=1"], ["lr"], ["with_yaw=2.5"]])
def test_apply_overrides_refuses_as_jax(bad):
    with pytest.raises(Exception) as want:
        joverride.apply_overrides(jconfigs.fcaf3d_scannet(), bad)
    with pytest.raises(type(want.value), match=str(want.value)[:20]):
        toverride.apply_overrides(tconfigs.fcaf3d_scannet(), bad)


@pytest.mark.parametrize("n_cols", [3, 4, 6, 7])
@pytest.mark.parametrize("shift_height", [False, True])
@pytest.mark.parametrize("use_color", [False, True])
def test_default_attribute_dims_equals_jax(n_cols, shift_height, use_color):
    assert tpoints.default_attribute_dims(n_cols, shift_height, use_color) \
        == jpoints.default_attribute_dims(n_cols, shift_height, use_color)


@pytest.mark.parametrize("dims", [None, {"color": [3, 4, 5]},
                                  {"color": [3, 4, 5], "height": 6}])
def test_shift_height_equals_jax(dims):
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 3, (500, 6)).astype(np.float32)
    sample = {"points": pts}
    if dims is not None:
        sample["attribute_dims"] = dims
    got = tpipes.ShiftHeight()(dict(sample), None)
    want = jpipes.ShiftHeight()(dict(sample), None)
    assert_samples_equal({"points": got["points"]},
                         {"points": want["points"]})
    assert got["attribute_dims"] == want["attribute_dims"]


def _sample(seed, with_yaw=True):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-2, 2, (400, 3)),
                          rng.uniform(0, 255, (400, 3))], 1)
    boxes = np.concatenate([rng.uniform(-1, 1, (5, 3)),
                            rng.uniform(0.2, 1, (5, 3)),
                            rng.uniform(-3, 3, (5, 1)) * with_yaw], 1)
    return {"points": pts.astype(np.float32),
            "gt_boxes": boxes.astype(np.float32),
            "gt_labels": rng.integers(0, 4, 5),
            "attribute_dims": {"color": [3, 4, 5]},
            "axis_align_matrix": ALIGN}


TRANSFORMS = [
    ("GlobalAlignment", (), {}), ("PointSample", (256,), {}),
    ("PointSample", (1000,), {}), ("RandomFlip", (1.0, 1.0), {}),
    ("RandomFlip", (0.5, 0.5), {"with_yaw": False}),
    ("GlobalRotScaleTrans", (), {}),
    ("GlobalRotScaleTrans", ((-0.5, 0.5), (0.85, 1.15), (0.1,) * 3), {}),
    ("GlobalRotScaleTrans", ((-0.087266, 0.087266), (0.9, 1.1), (0.1,) * 3),
     {"with_yaw": False}),
    ("GlobalRotScaleTrans", ((0.2, 0.2), (1.0, 1.0), (0.0,) * 3), {}),
    ("PointShuffle", (), {}), ("RandomJitterPoints", (), {}),
    ("RandomDropPointsColor", (1.0,), {}),
    ("PointsRangeFilter", ([-1, -1, -1, 1, 1, 1],), {}),
    ("ObjectNameFilter", ([0, 2],), {}), ("ShiftHeight", (), {})]


@pytest.mark.parametrize("name,args,kw", TRANSFORMS)
@pytest.mark.parametrize("seed", [0, 1])
def test_pipeline_transforms_equal_jax(name, args, kw, seed):
    """Each transform on the same sample and generator state gives the
    JAX package's sample exactly."""
    got = getattr(tpipes, name)(*args, **kw)(
        _sample(seed), np.random.default_rng([seed, 7]))
    want = getattr(jpipes, name)(*args, **kw)(
        _sample(seed), np.random.default_rng([seed, 7]))
    assert_samples_equal(got, want)


def _train_pipes(p, cfg, which):
    if which == "scannet":
        return p.Compose([
            p.GlobalAlignment(), p.PointSample(cfg.num_points),
            p.RandomFlip(0.5, 0.5, with_yaw=False),
            p.GlobalRotScaleTrans((-0.087266, 0.087266), (0.9, 1.1),
                                  (0.1,) * 3, with_yaw=False)])
    return p.Compose([
        p.PointSample(cfg.num_points), p.RandomFlip(0.5, 0.0),
        p.GlobalRotScaleTrans((-0.523599, 0.523599), (0.85, 1.15),
                              (0.1,) * 3)])


@pytest.mark.parametrize("which", ["scannet", "sunrgbd"])
def test_loader_epochs_equal_jax(mini_root, which):
    """`Loader.epoch(e)` over `RepeatDataset(IndoorDetDataset)` with the
    train pipeline of `tools/train.py`: every batch of 2 epochs equal
    (shuffle, per-(seed, epoch, index) draws, drop_last, padding)."""
    cfg = tconfigs.fcaf3d_tiny()
    ann = os.path.join(mini_root, "scannet_infos_train.pkl")
    loaders = [
        d.Loader(d.RepeatDataset(d.IndoorDetDataset(
            mini_root, ann, CLASSES, _train_pipes(d, cfg, which)), 2), 3,
            cfg.num_points, cfg.max_gt_boxes, seed=5, num_workers=3)
        for d in (tdata, jdata)]
    assert loaders[0].steps_per_epoch() == loaders[1].steps_per_epoch() == 3
    for epoch in range(2):
        got, want = (list(ld.epoch(epoch)) for ld in loaders)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert_samples_equal(g, w)


def test_collate_equals_jax():
    samples = [_sample(s) for s in range(3)]
    samples[1]["points"] = samples[1]["points"][:100]
    samples[2]["gt_boxes"] = samples[2]["gt_boxes"][:0]
    for args in ((256, 4), (64, 8, 3)):
        assert_samples_equal(tdata.collate(samples, *args),
                             jdata.collate(samples, *args))


def test_datasets_equal_jax(mini_root):
    """`IndoorDetDataset` (with the empty-GT redraw), `RepeatDataset`,
    `ConcatDataset`, `build_scannet` / `build_sunrgbd` / `build_s3dis`,
    the class tuples and `boxes_to_bottom_center`: lengths and samples
    equal."""
    for name in ("SCANNET_CLASSES", "SUNRGBD_CLASSES", "S3DIS_CLASSES"):
        assert getattr(tdatasets, name) == getattr(jdatasets, name)
    raw = np.random.default_rng(0).uniform(0, 1, (4, 7)).astype(np.float32)
    for r in (raw, raw[:, :6], raw[:0]):
        np.testing.assert_array_equal(tdatasets.boxes_to_bottom_center(r),
                                      jdatasets.boxes_to_bottom_center(r))
    ann = os.path.join(mini_root, "scannet_infos_train.pkl")
    val = os.path.join(mini_root, "scannet_infos_val.pkl")
    # an info without GT: the train-mode fetch redraws another index
    with open(ann, "rb") as f:
        infos = pickle.load(f)
    infos[2]["annos"]["gt_num"] = 0
    empty = os.path.join(mini_root, "with_empty.pkl")
    with open(empty, "wb") as f:
        pickle.dump(infos, f)
    pipe = [d.Compose([d.PointSample(300)]) for d in (tpipes, jpipes)]
    sets = [
        [d.build_scannet(mini_root, ann, p), d.build_sunrgbd(mini_root, val),
         d.build_s3dis(mini_root, [ann, val], p, repeat=3),
         d.build_s3dis(mini_root, [ann, val], test_mode=True),
         d.build_s3dis(mini_root, empty, p),
         d.ConcatDataset([d.RepeatDataset(d.build_scannet(mini_root, val),
                                          2),
                          d.build_scannet(mini_root, empty, p)])]
        for d, p in zip((tdatasets, jdatasets), pipe)]
    for got, want in zip(*sets):
        assert len(got) == len(want)
        for i in range(len(want)):
            assert_samples_equal(got(i, np.random.default_rng([3, i])),
                                 want(i, np.random.default_rng([3, i])))


def _rand_boxes(rng, n, rotated):
    b = np.concatenate([rng.uniform(0, 3, (n, 2)), rng.uniform(0, 0.5, (n, 1)),
                        rng.uniform(0.3, 1.2, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1)) * rotated], 1)
    return b.astype(np.float32)


@pytest.mark.parametrize("rotated", [False, True])
def test_pairwise_iou_equals_jax_numpy(rotated, monkeypatch):
    """The port's numpy IoU (`FCAF3D_NATIVE=0`) is bitwise the JAX
    package's numpy path."""
    monkeypatch.setenv("FCAF3D_NATIVE", "0")
    rng = np.random.default_rng(int(rotated))
    a, b = _rand_boxes(rng, 40, rotated), _rand_boxes(rng, 30, rotated)
    b[:5] = a[:5]  # identical pairs: IoU 1
    got = teval.pairwise_iou_3d_np(a, b)
    np.testing.assert_array_equal(got, jeval._pairwise_iou_3d_numpy(a, b))
    assert teval.pairwise_iou_3d_np(a[:0], b).shape == (0, 30)


@pytest.mark.parametrize("rotated", [False, True])
def test_indoor_eval_equals_jax(rotated, monkeypatch):
    """Random detections around jittered GT boxes over 6 scenes: the same
    metric dict as the JAX package's `indoor_eval`, both on their numpy
    IoU."""
    import fcaf3d_tpu.native

    monkeypatch.setattr(fcaf3d_tpu.native, "pairwise_iou_3d",
                        lambda a, b: None)
    monkeypatch.setenv("FCAF3D_NATIVE", "0")
    rng = np.random.default_rng(10 + int(rotated))
    gts, dts = [], []
    for _ in range(6):
        g = _rand_boxes(rng, 5, rotated)
        gl = rng.integers(0, 4, 5)
        d = np.concatenate([g + rng.normal(0, 0.1, g.shape).astype(
            np.float32), _rand_boxes(rng, 4, rotated)])
        gts.append({"gt_boxes_3d": g, "gt_labels_3d": gl})
        dts.append({"boxes_3d": d, "scores_3d": rng.uniform(0, 1, len(d)),
                    "labels_3d": np.concatenate([gl, rng.integers(0, 5, 4)])})
    label2cat = dict(enumerate(CLASSES))
    got = teval.indoor_eval(gts, dts, (0.25, 0.5), label2cat)
    want = jeval.indoor_eval(gts, dts, (0.25, 0.5), label2cat)
    assert got == want and got["mAP_0.25"] > 0
    for mode in ("area", "11points"):
        r, p = rng.uniform(0, 1, (2, 20)), rng.uniform(0, 1, (2, 20))
        np.testing.assert_array_equal(teval.average_precision(r, p, mode),
                                      jeval.average_precision(r, p, mode))


@pytest.mark.parametrize("axis", ["horizontal", "vertical"])
def test_flip_box7_equals_jax(axis):
    from fcaf3d_tpu.core.geometry import flip_box7 as jflip
    from fcaf3d_tpu_torch.core.geometry import flip_box7

    b = _rand_boxes(np.random.default_rng(0), 50, True)
    np.testing.assert_allclose(flip_box7(torch.as_tensor(b), axis).numpy(),
                               np.asarray(jflip(b, axis)), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        flip_box7(torch.as_tensor(b), "diagonal")


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("n_classes,p_valid", [(3, 0.8), (1, 0.8), (5, 1.0),
                                               (3, 0.0)])
def test_merge_aug_detections_equals_jax(rotated, n_classes, p_valid):
    """Four augs of 24 candidates (some or no rows invalid, one or several
    classes, boxes of one aug near another's after the inverse flip): keep
    masks equal, boxes within 1e-6."""
    import jax.numpy as jnp

    from fcaf3d_tpu.core.merge_augs import merge_aug_detections as jmerge
    from fcaf3d_tpu_torch.apis.test import FLIP_TTA
    from fcaf3d_tpu_torch.core.merge_augs import merge_aug_detections

    rng = np.random.default_rng(int(rotated))
    base = _rand_boxes(rng, 24, rotated)
    boxes, scores, labels, valid = [], [], [], []
    metas = [dict(m) for m in FLIP_TTA]
    metas[3]["pcd_scale_factor"] = 1.1
    for meta in metas:
        b = base + rng.normal(0, 0.05, base.shape).astype(np.float32)
        if meta.get("flip_horizontal"):
            b[:, 0], b[:, 6] = -b[:, 0], np.pi - b[:, 6]
        if meta.get("flip_vertical"):
            b[:, 1], b[:, 6] = -b[:, 1], -b[:, 6]
        b[:, :6] *= meta.get("pcd_scale_factor", 1.0)
        boxes.append(b)
        scores.append(rng.uniform(0, 1, 24).astype(np.float32))
        labels.append(rng.integers(0, n_classes, 24).astype(np.int32))
        valid.append(rng.uniform(0, 1, 24) < p_valid)
    got = merge_aug_detections(*([torch.as_tensor(x) for x in xs] for xs in
                                 (boxes, scores, labels, valid)), metas,
                               iou_thr=0.3, rotated=rotated)
    want = jmerge(*([jnp.asarray(x) for x in xs] for xs in
                    (boxes, scores, labels, valid)), metas, iou_thr=0.3,
                  rotated=rotated)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    n_valid = np.concatenate(valid).sum()
    assert 0 < got[3].sum() < n_valid or n_valid == got[3].sum() == 0
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-6)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_show_result_equals_jax(tmp_path):
    """The .obj dumps: the same files, vertices within 1e-6."""
    from fcaf3d_tpu.core.visualizer import show_result as jshow
    from fcaf3d_tpu_torch.core.visualizer import show_result

    rng = np.random.default_rng(0)
    pts = _sample(0)["points"]
    boxes = _rand_boxes(rng, 3, True)
    show_result(pts, boxes, boxes[:2], str(tmp_path / "t"), "s")
    jshow(pts, boxes, boxes[:2], str(tmp_path / "j"), "s")
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names and len(names) == 3
    for name in names:
        got = (tmp_path / "t" / name).read_text().splitlines()
        want = (tmp_path / "j" / name).read_text().splitlines()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.split()[0] == w.split()[0]
            np.testing.assert_allclose([float(x) for x in g.split()[1:]],
                                       [float(x) for x in w.split()[1:]],
                                       rtol=0, atol=1e-6)


def test_export_variables_inverts_load_variables():
    """`export_variables` gives the loaded tree (float32 numpy leaves, flax
    layout), and loading it back changes no value."""
    cfg = tconfigs.fcaf3d_nano()
    model, _, _ = create_train_state(cfg, seed=0, device="cpu")
    want = flatten(init_reference_variables(cfg, seed=0))
    got = flatten(export_variables(model))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_variables(model, export_variables(model))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])


def _trained(cfg, steps=2, seed=0):
    from chip_smoke import head_batch
    from tests.test_torch_model import EXTENT

    model, opt, _ = create_train_state(cfg, seed=seed, device="cpu")
    step = make_train_step(model, cfg, opt)
    for i in range(steps):
        step(head_batch(torch, cfg, EXTENT["fcaf3d_nano"], seed=i))
    return model, opt


def test_checkpoint_round_trip_is_exact(tmp_path):
    """Every variable, moment and the count come back bitwise; the file
    loads with `weights_only=True` and holds flax names."""
    cfg = tconfigs.fcaf3d_nano()
    model, opt = _trained(cfg)
    save_checkpoint(str(tmp_path), 3, model, opt)
    raw = torch.load(tmp_path / "ckpts" / "epoch_3.pt", weights_only=True)
    assert raw["epoch"] == 3 and raw["count"] == 2
    assert "params/backbone/conv1/kernel" in raw["variables"]
    assert set(raw["mu"]) == set(raw["nu"]) == {
        k for k in raw["variables"] if k.startswith("params/")}

    fresh, fopt, _ = create_train_state(cfg, seed=1, device="cpu")
    assert restore_checkpoint(str(tmp_path), fresh, fopt) == 3
    assert fopt.count == opt.count == 2
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), n
    for p, q in zip(model.parameters(), fresh.parameters()):
        for k in ("mu", "nu"):
            assert torch.equal(opt.state[p][k], fopt.state[q][k])


def test_max_keep_and_latest_epoch(tmp_path):
    """No checkpoint: `latest_epoch` None and restore raises; then the
    newest `max_keep` files stay, and no temporary file is left."""
    cfg = tconfigs.fcaf3d_nano()
    model, opt, _ = create_train_state(cfg, seed=0, device="cpu")
    work = str(tmp_path)
    assert latest_epoch(work) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(work, model)
    for epoch, keep in ((1, 1), (2, 1), (3, 2), (4, 2), (5, 3)):
        save_checkpoint(work, epoch, model, opt, max_keep=keep)
    assert sorted(os.listdir(tmp_path / "ckpts")) == [
        "epoch_3.pt", "epoch_4.pt", "epoch_5.pt"]
    assert latest_epoch(work) == 5
    # before any step the moments are optax's zeros
    assert restore_checkpoint(work, model, opt, epoch=4) == 4
    assert all(not v.any() for s in opt.state.values() for v in s.values())


def test_port_modules_import_nothing_of_the_jax_system():
    """Every module of the port, the CLIs included, loads neither jax nor
    the JAX package (run in a fresh interpreter), and no source file names
    `fcaf3d_tpu` or `jax` in an import."""
    import ast
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(repo, "fcaf3d_tpu_torch")
    modules = []
    for root, _, files in os.walk(pkg):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            rel = os.path.relpath(path, repo)[:-3].replace(os.sep, ".")
            modules.append(rel.removesuffix(".__init__"))
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) and not
                         node.level else [])
                roots = {n.split(".")[0] for n in names}
                assert not roots & {"jax", "jaxlib", "flax", "fcaf3d_tpu"}, \
                    (path, roots)
    assert "fcaf3d_tpu_torch.tools.train" in modules
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'fcaf3d_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True,
                   timeout=300)


@pytest.mark.parametrize("tool,argv", [
    ("train", ["--dataset", "scannet", "--data-root", "r", "--work-dir",
               "w"]),
    ("test", ["--dataset", "scannet", "--data-root", "r", "--work-dir",
              "w"]),
    ("pcd_demo", ["scene.bin"])])
def test_clis_default_to_the_card(tool, argv):
    """Without `--device` each CLI runs on "cuda"."""
    import importlib

    mod = importlib.import_module(f"fcaf3d_tpu_torch.tools.{tool}")
    assert mod.parse_args(argv).device == "cuda"
    assert mod.parse_args(argv + ["--device", "cpu"]).device == "cpu"
