"""The port's train CLIs and 2D evaluator held against the JAX package's on
the CPU: `core/eval2d.py`, `tools.train_votenet` (v1 and v2),
`tools.train_detector2d` and `tools.train_imvotenet`, in process at small
sizes and as subprocesses with `--device cpu`.

The datasets are in the reference's prepared SUN RGB-D layout
(`chip_smoke.write_sunrgbd_root`): small crowded scenes for VoteNet, and
`chip_smoke.imvote_frame` frames at 240 x 320 (JPEGs written by Pillow, so
every image is resized and every 2D box scaled by 2) for the 2D detector
and ImVoteNet. The host draws are the parity contract: every batch of two
epochs must equal the JAX tool's exactly. The one departure is the
ImVoteNet tool's GT boxes, which the port hands the loss bottom-centred
(the JAX tool passes the infos' gravity-centred boxes on); the reference
side gets the same conversion here. The 2D branch's train-time half-drop
draws from a `torch.Generator` in the port and a JAX key in the JAX tool,
so that path is held by its structure only.
"""
import dataclasses
import importlib
import importlib.util
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from fcaf3d_tpu import data as jdata
from fcaf3d_tpu.core import eval2d as jeval2d
from fcaf3d_tpu.models import votenet_v1 as jv1
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import init_detector2d, init_imvotenet
from fcaf3d_tpu_torch.core import eval2d as teval2d
from fcaf3d_tpu_torch.data.datasets import boxes_to_bottom_center
from fcaf3d_tpu_torch.data.synth import crowded_scene, densify
from fcaf3d_tpu_torch.models.votenet_v1 import build_votenet, sunrgbd_coder
from fcaf3d_tpu_torch.params import (export_variables, flatten,
                                     init_votenet_reference_variables)
from fcaf3d_tpu_torch.tools import train_detector2d as tdet2d
from fcaf3d_tpu_torch.tools import train_imvotenet as timv
from fcaf3d_tpu_torch.tools import train_votenet as tvote
from fcaf3d_tpu_torch.train import restore_checkpoint
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401
from tests.test_torch_votenet_train import (  # noqa: F401
    assert_step_matches, grid_ball_query, step_on_both_sides)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME_HW, FRAME_FOCAL = (240, 320), 285.0


def jax_tool(name):
    """A module of the JAX package's `tools/` directory, loaded from its
    file under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small CPU ops on one thread: the suite runs several test processes
    at once. Restores the setting afterwards."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def assert_equal_trees(got, want, what=""):
    """Nested dicts of arrays with the same keys and bitwise equal leaves
    (values and dtypes)."""
    g, w = flatten(got), flatten(want)
    assert set(g) == set(w), (what, sorted(set(g) ^ set(w))[:5])
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")


# ------------------------------------------------------------------ eval2d

def random_annos(rng, n_images, n_classes, with_dets=True):
    gts, dts = [], []
    for _ in range(n_images):
        g = int(rng.integers(0, 6))
        xy = rng.uniform(0, 200, (g, 2))
        wh = rng.uniform(5, 60, (g, 2))
        gts.append({"boxes": np.concatenate([xy, xy + wh], 1),
                    "labels": rng.integers(0, n_classes, g)})
        d = int(rng.integers(0, 8)) if with_dets else 0
        # half the detections jitter a GT box, the rest anywhere
        src = gts[-1]["boxes"]
        boxes = rng.uniform(0, 200, (d, 4))
        boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 60, (d, 2))
        for i in range(min(d // 2, len(src))):
            boxes[i] = src[i] + rng.normal(0, 4, 4)
        dts.append({"boxes": boxes, "scores": rng.uniform(0, 1, d),
                    "labels": rng.integers(0, n_classes, d)})
    return gts, dts


@pytest.mark.parametrize("seed,n_classes,iou_thr,fixed", [
    (0, 3, 0.5, False), (1, 3, 0.25, True), (2, 5, 0.5, True),
    (3, 1, 0.7, False)])
def test_eval_det_2d_equals_jax(seed, n_classes, iou_thr, fixed):
    """The metric dicts equal the JAX package's, exactly: greedy matching,
    classes without GT skipped or (with `n_classes`) listed, area AP."""
    gts, dts = random_annos(np.random.default_rng(seed), 6, n_classes)
    kw = {"iou_thr": iou_thr, "n_classes": n_classes if fixed else None}
    got = teval2d.eval_det_2d(gts, dts, **kw)
    want = jeval2d.eval_det_2d(gts, dts, **kw)
    assert got == want and "mAP" in got


def test_eval_det_2d_without_detections_equals_jax():
    gts, dts = random_annos(np.random.default_rng(4), 3, 2, with_dets=False)
    assert teval2d.eval_det_2d(gts, dts) == jeval2d.eval_det_2d(gts, dts)
    assert teval2d.eval_det_2d([], []) == jeval2d.eval_det_2d([], [])


def test_iou_xyxy_and_ap_equal_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 50, (7, 4))
    b = rng.uniform(0, 50, (5, 4))  # some boxes inverted: zero area
    np.testing.assert_array_equal(teval2d.iou_xyxy(a, b),
                                  jeval2d.iou_xyxy(a, b))
    rec = np.sort(rng.uniform(0, 1, 9))
    prec = rng.uniform(0, 1, 9)
    assert teval2d._average_precision(rec, prec) == \
        jeval2d._average_precision(rec, prec)


# ------------------------------------------------------------ VoteNet tool

def tool_cfg(head, max_epochs=2):
    """`votenet_tiny` with SUN RGB-D's 10 classes (the tool's v1 head takes
    `sunrgbd_coder()`, 10 size classes) and the given head."""
    return dataclasses.replace(tconfigs.votenet_tiny(), n_classes=10,
                               head_version=head, max_epochs=max_epochs)


@pytest.fixture(scope="module")
def vote_root(tmp_path_factory):
    """5 crowded scenes of 4 yawed boxes in a 2 m room, ~800 points each:
    with batch 2, 2 steps an epoch and one scene dropped."""
    scenes = []
    for i in range(5):
        rng = np.random.default_rng(i)
        scenes.append(densify(crowded_scene(4, 10, rng, extent=2.0,
                                            with_yaw=True), 150, 200, rng))
    root = str(tmp_path_factory.mktemp("sunrgbd_vote"))
    chip_smoke.write_sunrgbd_root(root, scenes)
    return root


def jax_tool_loader(cfg, root, seed):
    """`tools/train_votenet.py:49-63`'s pipeline, dataset and loader, from
    the JAX package."""
    d = jdata
    pipe = d.Compose([
        d.ShiftHeight(),
        d.PointSample(cfg.num_points),
        d.RandomFlip(0.5, 0.0),
        d.GlobalRotScaleTrans((-0.523599, 0.523599), (0.85, 1.15),
                              (0, 0, 0)),
    ])
    ds = d.RepeatDataset(d.IndoorDetDataset(
        root, os.path.join(root, "sunrgbd_infos_train.pkl"),
        d.SUNRGBD_CLASSES, pipe, use_dim=(0, 1, 2)), times=1)
    return d.Loader(ds, cfg.batch_size, cfg.num_points, cfg.max_gt_boxes,
                    n_feat_dims=cfg.in_feat_dims, seed=seed)


@pytest.mark.parametrize("head", ["v1", "v2"])
def test_votenet_tool_batches_equal_jax(vote_root, head):
    """Every batch of 2 epochs, with the height folded back into the points
    (`tools/train_votenet.py:99-100`), equal to the JAX tool's."""
    cfg = tool_cfg(head)
    got_loader = tvote.build_loader(cfg, vote_root, seed=3)
    want_loader = jax_tool_loader(cfg, vote_root, seed=3)
    assert got_loader.steps_per_epoch() == want_loader.steps_per_epoch() == 2
    for epoch in range(2):
        got = [tvote.votenet_batch(b) for b in got_loader.epoch(epoch)]
        want = list(want_loader.epoch(epoch))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            pts = np.concatenate([w["points"], w["colors"]], axis=-1)
            assert set(g) == {"points", "gt_boxes", "gt_labels", "gt_valid"}
            assert g["points"].shape == (2, cfg.num_points, 4)
            np.testing.assert_array_equal(g["points"], pts)
            for k in ("gt_boxes", "gt_labels", "gt_valid"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def recording(make, store):
    """`make` (a train-step factory) whose steps append (batch, metrics as
    floats) to `store`."""
    def build(*args, **kw):
        step = make(*args, **kw)

        def recorded(batch):
            metrics = step(batch)
            store.append((batch, {k: float(v) for k, v in metrics.items()}))
            return metrics
        return recorded
    return build


@pytest.mark.parametrize("head", ["v1", "v2"])
def test_votenet_tool_first_step_matches_jax(vote_root, tmp_path, head,
                                             grid_ball_query,  # noqa: F811
                                             monkeypatch):
    """`train_votenet.train` for one epoch. Its first step's metrics equal
    the port's own train step on that batch from the same seeded
    variables, the tool's init (`init_votenet_reference_variables`, flax's
    default init). That step run in float64 passes `assert_step_matches`
    against the JAX trainer's `make_votenet_train_step` /
    `make_votenet_v1_train_step` in float64 on the port's numpy variables
    (metrics and gradients within 1e-4, parameters after AdamW, batch
    statistics within 1e-5). The tool's float32 losses lie within 1e-4
    (relative) of the JAX side's, as `assert_float32_step_near` holds
    them, and its gradient norm within 5e-2, that function's rule for a
    gradient in L2 norm (one near-tie in float32 moves the v1 norm by
    1.6e-4 on these batches). The log has one record an epoch with the
    step's metrics rounded to 4 places, and the checkpoint restores into a
    fresh model exactly."""
    cfg = tool_cfg(head, max_epochs=1)
    v1 = head == "v1"
    store = []
    name = "make_votenet_v1_train_step" if v1 else "make_votenet_train_step"
    monkeypatch.setattr(tvote, name, recording(getattr(tvote, name), store))
    work = str(tmp_path / "work")
    model, _ = tvote.train(cfg, tvote.build_loader(cfg, vote_root), work,
                           device="cpu")
    assert len(store) == 2
    batch, first = store[0]
    coder = sunrgbd_coder() if v1 else None
    got, want, lr = step_on_both_sides(
        cfg, batch, coder, jv1.sunrgbd_coder() if v1 else None,
        variables=init_votenet_reference_variables(cfg, 0, coder))
    assert first == got[torch.float32]["metrics"]
    assert_step_matches(got[torch.float64], want, lr, ())
    assert set(first) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(first[k], v, err_msg=k,
                                   rtol=5e-2 if k == "grad_norm" else 1e-4)
    with open(os.path.join(work, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    last = store[-1][1]
    assert recs == [{"epoch": 1, "iter": 2,
                     **{k: round(v, 4) for k, v in last.items()}}]
    fresh = build_votenet(cfg, sunrgbd_coder() if v1 else None,
                          device="cpu")
    assert restore_checkpoint(work, fresh) == 1
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n


# -------------------------------------------------- Detector2D and ImVoteNet

@pytest.fixture(scope="module")
def frame_root(tmp_path_factory):
    """4 `imvote_frame` frames at 240 x 320 (focal 285), 2 000 points, as a
    SUN RGB-D root with Pillow-written JPEGs."""
    frames = [chip_smoke.imvote_frame(s, 2000, 10, hw=FRAME_HW,
                                      focal=FRAME_FOCAL) for s in range(4)]
    root = str(tmp_path_factory.mktemp("sunrgbd_frames"))
    chip_smoke.write_sunrgbd_root(root,
                                  [chip_smoke.frame_scene(f) for f in frames])
    return root


def test_detector2d_tool_samples_equal_jax(frame_root):
    """2 epochs of `tools/train_detector2d.py`'s draws (a permutation an
    epoch, a flip draw a sample) through `load_sample` and `collate`:
    images, scaled and flipped boxes, labels and masks equal the JAX
    tool's, and the flips happened."""
    jtool = jax_tool("train_detector2d")
    infos = tdet2d.load_infos(frame_root)
    assert len(infos) == 4
    rngs = [np.random.default_rng(7), np.random.default_rng(7)]
    for _ in range(2):
        orders = [r.permutation(len(infos)) for r in rngs]
        np.testing.assert_array_equal(*orders)
        for lo in (0, 2):
            idxs = orders[0][lo:lo + 2]
            got = tdet2d.collate([tdet2d.load_sample(frame_root, infos[i],
                                                     rngs[0]) for i in idxs])
            want = jtool.collate([jtool.load_sample(frame_root, infos[i],
                                                    rngs[1]) for i in idxs])
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            assert got[0].shape == (2, 480, 640, 3)
    # the same draws again: some samples were flipped and some not
    draws = np.random.default_rng(7)
    flips = []
    for _ in range(2):
        draws.permutation(4)
        flips += [draws.random() < 0.5 for _ in range(4)]
    assert 0 < sum(flips) < len(flips)


def jax_imvote_load_sample(root, info, rng, num_points):
    """The body of `tools/train_imvotenet.py:71-96`'s `load_sample` closure,
    with the JAX package's `ShiftHeight` and `sunrgbd_depth2img`."""
    from PIL import Image

    from fcaf3d_tpu.data.datasets import sunrgbd_depth2img
    from fcaf3d_tpu.data.pipelines import ShiftHeight

    img_hw = (480, 640)
    pts = np.fromfile(
        os.path.join(root, info["pts_path"]), np.float32
    ).reshape(-1, 6)[:, :3]
    sh = ShiftHeight()({"points": pts}, rng)
    pts = sh["points"]  # [N, 4] xyz + height
    sel = rng.choice(len(pts), num_points, replace=len(pts) < num_points)
    pts = pts[sel]
    im = Image.open(os.path.join(
        root, info["image"]["image_path"])).convert("RGB")
    w0, h0 = im.size
    img = np.asarray(im.resize((img_hw[1], img_hw[0])), np.float32)
    sx, sy = img_hw[1] / w0, img_hw[0] / h0
    annos = info["annos"]
    k = sunrgbd_depth2img(info["calib"], sx, sy)
    boxes3d = annos["gt_boxes_upright_depth"].astype(np.float32)
    if boxes3d.shape[1] == 6:
        boxes3d = np.concatenate(
            [boxes3d, np.zeros((len(boxes3d), 1), np.float32)], 1)
    labels = annos["class"].astype(np.int32)
    gt2d = annos["bbox"].astype(np.float32) * np.asarray(
        [sx, sy, sx, sy], np.float32)
    return pts, img, k, boxes3d, labels, gt2d


def jax_imvote_collate(samples, max_gt, max_det):
    """The body of `tools/train_imvotenet.py:98-120`'s `collate` closure."""
    b = len(samples)
    g = max_gt
    pts = np.stack([s[0] for s in samples])
    imgs = np.stack([s[1] for s in samples])
    calib = np.stack([s[2] for s in samples])
    boxes = np.zeros((b, g, 7), np.float32)
    labels = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    d = max_det
    gt2 = np.zeros((b, d, 6), np.float32)
    gt2v = np.zeros((b, d), bool)
    for i, (_, _, _, bx, lb, b2) in enumerate(samples):
        n = min(len(bx), g)
        boxes[i, :n], labels[i, :n], valid[i, :n] = bx[:n], lb[:n], True
        m = min(len(b2), d)
        gt2[i, :m, :4] = b2[:m]
        gt2[i, :m, 4] = 1.0
        gt2[i, :m, 5] = lb[:m].astype(np.float32)
        gt2v[i, :m] = True
    return pts, imgs, calib, boxes, labels, valid, gt2, gt2v


@pytest.mark.parametrize("num_points,max_det", [(1500, 32), (2500, 3)])
def test_imvotenet_tool_batches_equal_jax(frame_root, num_points, max_det):
    """The draws of `tools/train_imvotenet.py` with `--gt-boxes-2d`: one
    `load_sample` of the first info, then 2 epochs of a permutation and
    batches of 2. Every array equal to the JAX closures' (sampled with and
    without replacement; 2D boxes cut at `max_det`), the GT boxes equal to
    the JAX tool's moved from gravity to bottom centres."""
    infos = tdet2d.load_infos(frame_root)
    cfg = tconfigs.votenet_sunrgbd()
    rngs = [np.random.default_rng(11), np.random.default_rng(11)]
    timv.load_sample(frame_root, infos[0], rngs[0], num_points)
    jax_imvote_load_sample(frame_root, infos[0], rngs[1], num_points)
    for _ in range(2):
        orders = [r.permutation(len(infos)) for r in rngs]
        np.testing.assert_array_equal(*orders)
        for lo in (0, 2):
            idxs = orders[0][lo:lo + 2]
            got = timv.collate(
                [timv.load_sample(frame_root, infos[i], rngs[0], num_points)
                 for i in idxs], cfg.max_gt_boxes, max_det)
            want = list(jax_imvote_collate(
                [jax_imvote_load_sample(frame_root, infos[i], rngs[1],
                                        num_points) for i in idxs],
                cfg.max_gt_boxes, max_det))
            want[3] = np.stack([boxes_to_bottom_center(b) for b in want[3]])
            for name, g, w in zip(("points", "images", "depth2img", "boxes",
                                   "labels", "valid", "boxes2d",
                                   "boxes2d_valid"), got, want):
                assert g.dtype == w.dtype and g.shape == w.shape, name
                np.testing.assert_array_equal(g, w, err_msg=name)
            assert got[0].shape == (2, num_points, 4)
            if max_det == 3:  # every frame has more 2D boxes: all cut
                assert (got[7].sum(1) == 3).all()


def test_imvotenet_tool_keeps_the_init_draw(frame_root, tmp_path,
                                            monkeypatch):
    """`train_imvotenet.train` spends one `load_sample` of the first info
    before the first permutation, as the JAX tool's init batch does: the
    points of its first batch are those of that draw order."""
    store = []
    monkeypatch.setattr(timv, "make_imvotenet_train_step",
                        recording(timv.make_imvotenet_train_step, store))
    timv.train(frame_root, str(tmp_path), batch=2, epochs=1,
               num_points=1500, seed=5, device="cpu")
    infos = tdet2d.load_infos(frame_root)
    rng = np.random.default_rng(5)
    jax_imvote_load_sample(frame_root, infos[0], rng, 1500)
    order = rng.permutation(len(infos))
    want = jax_imvote_collate([jax_imvote_load_sample(
        frame_root, infos[i], rng, 1500) for i in order[:2]], 64, 32)
    batch, metrics = store[0]
    np.testing.assert_array_equal(batch["points"], want[0])
    np.testing.assert_array_equal(batch["boxes2d"], want[6])
    assert np.isfinite(list(metrics.values())).all()
    with open(tmp_path / "train_log.jsonl") as f:
        assert [json.loads(line) for line in f] == [
            {"epoch": 1, "iter": 2, "loss": round(store[-1][1]["loss"], 4)}]


# ------------------------------------------------------------------- CLIs

def run_cli(tool, *args):
    """`python -m fcaf3d_tpu_torch.tools.<tool> args` with one intra-op
    thread; asserts exit 0, returns stdout."""
    out = subprocess.run(
        [sys.executable, "-m", f"fcaf3d_tpu_torch.tools.{tool}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_train_votenet_cli(vote_root, tmp_path):
    """`tools.train_votenet` at `votenet_sunrgbd`'s full widths (20 000
    points) for one epoch of 2 steps at batch 2: one log record with the
    v2 metrics, one checkpoint."""
    work = str(tmp_path / "work")
    out = run_cli("train_votenet", "--data-root", vote_root, "--work-dir",
                  work, "--batch", "2", "--epochs", "1", "--device", "cpu")
    with open(os.path.join(work, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 1 and recs[0]["iter"] == 2
    assert set(recs[0]) == {"epoch", "iter", "vote_loss", "objectness_loss",
                            "center_loss", "semantic_loss", "iou_loss",
                            "loss", "grad_norm"}
    assert np.isfinite(list(recs[0].values())).all() and "'iter': 2" in out
    assert sorted(os.listdir(os.path.join(work, "ckpts"))) == ["epoch_1.pt"]


@pytest.fixture(scope="module")
def detector2d_cli(frame_root, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("det2d"))
    out = run_cli("train_detector2d", "--data-root", frame_root,
                  "--work-dir", work, "--batch", "2", "--epochs", "1",
                  "--lr", "5e-4", "--device", "cpu")
    return work, out


def test_train_detector2d_cli(detector2d_cli):
    """`tools.train_detector2d` for one epoch of 2 steps: the log record's
    keys in the JAX tool's order, and `detector2d.pkl` ({"params",
    "batch_stats"} in the flax layout) loads through
    `init_detector2d(params_file=)`."""
    work, out = detector2d_cli
    assert "4 images with 2D annotations" in out
    with open(os.path.join(work, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [list(r) for r in recs] == [["epoch", "iter", "loss", "cls_loss",
                                        "reg_loss", "ctr_loss"]]
    path = os.path.join(work, "detector2d.pkl")
    with open(path, "rb") as f:
        tree = pickle.load(f)
    assert set(tree) == {"params", "batch_stats"} and tree["batch_stats"] == {}
    model = init_detector2d(10, params_file=path, device="cpu")
    assert_equal_trees(export_variables(model)["params"], tree["params"])


@pytest.mark.parametrize("boxes", ["--detector2d", "--gt-boxes-2d"])
def test_train_imvotenet_cli(frame_root, detector2d_cli, tmp_path, boxes):
    """`tools.train_imvotenet` for one epoch of 2 steps at batch 2, with the
    2D detector's pickle or the GT 2D boxes: a finite loss, and
    `imvotenet.pkl` loads through `init_imvotenet(params_file=)`."""
    work = str(tmp_path / "work")
    args = ([boxes, os.path.join(detector2d_cli[0], "detector2d.pkl")]
            if boxes == "--detector2d" else [boxes])
    out = run_cli("train_imvotenet", "--data-root", frame_root, "--work-dir",
                  work, *args, "--batch", "2", "--epochs", "1",
                  "--num-points", "1500", "--device", "cpu")
    assert "4 scenes" in out
    with open(os.path.join(work, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 1 and list(recs[0]) == ["epoch", "iter", "loss"]
    assert np.isfinite(recs[0]["loss"])
    path = os.path.join(work, "imvotenet.pkl")
    model = init_imvotenet(tconfigs.votenet_sunrgbd(), params_file=path,
                           device="cpu")
    with open(path, "rb") as f:
        assert_equal_trees(export_variables(model), pickle.load(f))


def test_train_imvotenet_cli_needs_2d_boxes(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "fcaf3d_tpu_torch.tools.train_imvotenet",
         "--data-root", str(tmp_path), "--work-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "need --detector2d CKPT or --gt-boxes-2d" in out.stderr


@pytest.mark.parametrize("tool,argv", [
    ("train_votenet", ["--data-root", "r", "--work-dir", "w"]),
    ("train_detector2d", ["--data-root", "r", "--work-dir", "w"]),
    ("train_imvotenet", ["--data-root", "r", "--work-dir", "w",
                         "--gt-boxes-2d"]),
    ("fuse_conv_bn", ["--work-dir", "w", "--out-dir", "o"]),
    ("test5x5", ["--dataset", "scannet", "--data-root", "r", "--work-dir",
                 "w"]),
    ("parity_check", ["--config", "fcaf3d_tiny", "--points", "p.bin"])])
def test_new_clis_default_to_the_card(tool, argv):
    """Without `--device` each CLI that builds a model runs on "cuda"."""
    mod = importlib.import_module(f"fcaf3d_tpu_torch.tools.{tool}")
    assert mod.parse_args(argv).device == "cuda"
    assert mod.parse_args(argv + ["--device", "cpu"]).device == "cpu"
