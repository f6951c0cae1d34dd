"""The port's deploy tools held against the JAX package's on the CPU: the
mmdet3d `.pth` converter (`tools.convert_checkpoint`), BN fusing
(`utils/fuse_bn.py`, `tools.fuse_conv_bn`) and `tools.publish_model`.

The converter's inputs are reference-named state dicts: the JAX tests'
synthesizers (`tests/test_checkpoint_convert.py`) and
`chip_smoke.reference_state_dict`, which writes the port's seeded
variables under the reference's names and layouts, so that a converted
detector has detections. Converted and fused trees must equal the JAX
package's bitwise; forwards are held at the tolerances stated where they
are used.
"""
import dataclasses
import hashlib
import importlib.util
import json
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu.apis.inference import inference_detector as j_inference
from fcaf3d_tpu.models.detector import FCAF3D as JFCAF3D
from fcaf3d_tpu.utils.fuse_bn import fuse_conv_bn as j_fuse_conv_bn
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import (inference_detector, init_detector,
                                   init_imvotenet, init_votenet)
from fcaf3d_tpu_torch.ops.sparse import conv as tconv
from fcaf3d_tpu_torch.ops.sparse import tensor as tt
from fcaf3d_tpu_torch.params import (export_variables, flatten,
                                     init_imvotenet_variables,
                                     init_variables, init_votenet_variables,
                                     load_variables)
from fcaf3d_tpu_torch.tools import convert_checkpoint as tconv_ckpt
from fcaf3d_tpu_torch.train import (latest_epoch, load_checkpoint,
                                    make_optimizer, save_checkpoint)
from fcaf3d_tpu_torch.utils.fuse_bn import BN_EPS, fuse_conv_bn
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401
from tests.test_torch_tools import assert_equal_trees, run_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4  # the FCAF3D slice's float tolerance (`test_torch_model.py`)
EXTENT = (0.6, 0.6, 0.3)  # a scene the tiny budgets hold


def load_file(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the JAX converter and the JAX tests' synthesizers, from their files
jconv = load_file("jax_tools_convert_checkpoint",
                  os.path.join(REPO, "tools", "convert_checkpoint.py"))
jsynth = load_file("jax_test_checkpoint_convert",
                   os.path.join(REPO, "tests", "test_checkpoint_convert.py"))


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def imvotenet_state_dict(rng):
    """`tests/test_checkpoint_convert.py::test_convert_imvotenet_tree_matches`'s
    reference-named ImVoteNet state dict: the VoteNet synthesizer under the
    point-tower prefixes, the joint tower's 512-wide seed inputs and the
    image MLP."""
    sd = jsynth.make_votenet_state_dict(rng, head_prefix="pts_bbox_head_joint",
                                        backbone_prefix="pts_backbone")
    sd["pts_bbox_head_joint.vote_module.vote_conv.0.conv.weight"] = (
        rng.randn(256, 512, 1).astype(np.float32) * 0.05)
    for j, (cin, ch) in enumerate(((512 + 3, 128), (128, 128), (128, 128))):
        sd[f"pts_bbox_head_joint.vote_aggregation.mlps.0.layer{j}"
           ".conv.weight"] = rng.randn(ch, cin, 1, 1).astype(np.float32) * 0.05
    sd["pts_bbox_head_joint.vote_module.conv_out.weight"] = (
        rng.randn(3 + 512, 256, 1).astype(np.float32) * 0.05)
    sd["pts_bbox_head_joint.vote_module.conv_out.bias"] = np.zeros(
        3 + 512, np.float32)
    for i, (cin, ch) in enumerate(((18, 256), (256, 256))):
        sd[f"img_mlp.mlp.layer{i}.conv.weight"] = (
            rng.randn(ch, cin, 1).astype(np.float32) * 0.05)
        sd[f"img_mlp.mlp.layer{i}.bn.weight"] = np.ones(ch, np.float32)
        sd[f"img_mlp.mlp.layer{i}.bn.bias"] = np.zeros(ch, np.float32)
        sd[f"img_mlp.mlp.layer{i}.bn.running_mean"] = np.zeros(ch, np.float32)
        sd[f"img_mlp.mlp.layer{i}.bn.running_var"] = np.ones(ch, np.float32)
    return sd


# --------------------------------------------------------------- converter

@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("order", ["x_fastest", "x_slowest"])
def test_me_offset_permutation_equals_jax(k, order):
    got = tconv_ckpt.me_offset_permutation(k, order)
    np.testing.assert_array_equal(got, jconv.me_offset_permutation(k, order))
    assert sorted(got.tolist()) == list(range(k ** 3))


@pytest.mark.parametrize("layers", [(1, 1, 1, 1), (2, 2, 2, 2), (3, 4, 6, 3)])
@pytest.mark.parametrize("order", ["x_fastest", "x_slowest"])
def test_convert_equals_jax(layers, order):
    """`convert` on the JAX tests' reference state dict (depth 14, 18, 34):
    the trees bitwise equal to `tools/convert_checkpoint.py`'s."""
    sd = jsynth.make_reference_state_dict(n_classes=18, layers=layers)
    assert_equal_trees(tconv_ckpt.convert(sd, layers, 4, order),
                       jconv.convert(sd, layers, 4, order))


def test_convert_votenet_and_imvotenet_equal_jax():
    """`convert_votenet` and `convert_imvotenet` on the JAX tests' state
    dicts (ConvModule convs without a bias): bitwise equal trees, which
    load into the port's VoteNet-v2 and ImVoteNet."""
    cfg = tconfigs.votenet_sunrgbd()
    sd = jsynth.make_votenet_state_dict(np.random.RandomState(0))
    got = tconv_ckpt.convert_votenet(sd)
    assert_equal_trees(got, jconv.convert_votenet(sd))
    load_variables(init_votenet(cfg, device="cpu"), got)
    sd = imvotenet_state_dict(np.random.RandomState(1))
    got = tconv_ckpt.convert_imvotenet(sd)
    assert_equal_trees(got, jconv.convert_imvotenet(sd))
    load_variables(init_imvotenet(cfg, device="cpu"), got)


@pytest.mark.parametrize("model", ["fcaf3d", "votenet", "imvotenet"])
def test_reference_state_dict_round_trips(model):
    """`chip_smoke.reference_state_dict` of the port's seeded variables,
    converted by either package, gives those variables back bitwise."""
    variables, convert = {
        "fcaf3d": (lambda: init_variables(tconfigs.fcaf3d_tiny()), "convert"),
        "votenet": (lambda: init_votenet_variables(tconfigs.votenet_tiny()),
                    "convert_votenet"),
        "imvotenet": (lambda: init_imvotenet_variables(
            tconfigs.votenet_sunrgbd()), "convert_imvotenet")}[model]
    variables = variables()
    sd = chip_smoke.reference_state_dict(variables, model)
    got = getattr(tconv_ckpt, convert)(sd)
    assert_equal_trees(got, variables)
    assert_equal_trees(getattr(jconv, convert)(sd), variables)


def save_pth(path, sd):
    """`torch.save` a state dict with an mmcv-style meta, as a reference
    training run writes its `epoch_N.pth`."""
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()},
                "meta": {"CLASSES": ("a", "b", "c", "d"), "epoch": 12,
                         "config": "cfg-text", "mmcv_version": "1.3.8"}},
               path)


@pytest.fixture(scope="module")
def converted_fcaf3d(tmp_path_factory):
    """The CLI's pickle of `fcaf3d_tiny`'s seeded variables written as a
    reference `.pth`, and the state dict."""
    tmp = tmp_path_factory.mktemp("convert")
    sd = chip_smoke.reference_state_dict(
        init_variables(tconfigs.fcaf3d_tiny()), "fcaf3d")
    save_pth(tmp / "epoch_12.pth", sd)
    out = str(tmp / "params.pkl")
    printed = run_cli("convert_checkpoint", "--pth",
                      str(tmp / "epoch_12.pth"), "--out", out)
    assert re.search(r"wrote .*params\.pkl \(\d+ param tensors\)", printed)
    return out, sd


def test_convert_cli_equals_jax_convert(converted_fcaf3d):
    path, sd = converted_fcaf3d
    with open(path, "rb") as f:
        assert_equal_trees(pickle.load(f), jconv.convert(sd))


def test_converted_fcaf3d_matches_jax(converted_fcaf3d):
    """`init_detector(params_file=)` of the CLI's pickle at `fcaf3d_tiny`
    (f32) against the JAX model on the JAX converter's tree, through each
    package's `inference_detector`: the same non-empty detections, labels
    exact, boxes and scores within 1e-4."""
    path, sd = converted_fcaf3d
    cfg, jcfg = tconfigs.fcaf3d_tiny(), jconfigs.fcaf3d_tiny()
    xyz, rgb = bench.synth_scene(np.random.RandomState(0), cfg.num_points,
                                 extent=EXTENT)
    points = np.concatenate([xyz, rgb], axis=1)
    got, _ = inference_detector(
        init_detector(cfg, params_file=path, device="cpu"), points)
    jvars = jax.tree_util.tree_map(jnp.asarray, jconv.convert(sd))
    want = j_inference(JFCAF3D(jcfg), jvars, points, jcfg, seed=0)
    assert len(got["scores_3d"]) == len(want["scores_3d"]) > 0
    np.testing.assert_array_equal(got["labels_3d"], want["labels_3d"])
    np.testing.assert_allclose(got["boxes_3d"], want["boxes_3d"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got["scores_3d"], want["scores_3d"], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("model", ["votenet", "imvotenet"])
def test_convert_cli_votenet_and_imvotenet(tmp_path, model):
    """`--model votenet|imvotenet` on the JAX tests' state dicts: the
    pickle equals the JAX converter's tree and loads through
    `init_votenet` / `init_imvotenet(params_file=)`."""
    rng = np.random.RandomState(2)
    sd = (jsynth.make_votenet_state_dict(rng) if model == "votenet"
          else imvotenet_state_dict(rng))
    save_pth(tmp_path / "m.pth", sd)
    out = str(tmp_path / "m.pkl")
    run_cli("convert_checkpoint", "--pth", str(tmp_path / "m.pth"), "--out",
            out, "--model", model)
    with open(out, "rb") as f:
        assert_equal_trees(pickle.load(f), getattr(
            jconv, f"convert_{model}")(sd))
    init = init_votenet if model == "votenet" else init_imvotenet
    init(tconfigs.votenet_sunrgbd(), params_file=out, device="cpu")


def test_convert_cli_depth(tmp_path):
    """`--depth 18` converts a depth-18 reference state dict, equal to the
    JAX converter's tree; `--depth` refuses other values."""
    layers = (2, 2, 2, 2)
    sd = jsynth.make_reference_state_dict(layers=layers)
    save_pth(tmp_path / "d18.pth", sd)
    out = str(tmp_path / "d18.pkl")
    run_cli("convert_checkpoint", "--pth", str(tmp_path / "d18.pth"),
            "--out", out, "--depth", "18")
    with open(out, "rb") as f:
        assert_equal_trees(pickle.load(f), jconv.convert(sd, layers))
    with pytest.raises(SystemExit):
        tconv_ckpt.parse_args(["--pth", "p", "--out", "o", "--depth", "50"])


def test_me_offset_order_impulse():
    """The port's twin of `test_me_offset_order_impulse`: weights in ME's
    offset layout (value k at ME index k, x fastest), permuted by
    `me_offset_permutation`, through the port's sparse conv reproduce a
    dense conv whose kernel is assembled with ME's enumeration, at every
    output voxel; the unpermuted layout does not."""
    rng = np.random.RandomState(0)
    w_me = np.arange(27, dtype=np.float32).reshape(27, 1, 1) + 1.0
    w_dense = np.zeros((3, 3, 3), np.float32)  # [dx, dy, dz]
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                w_dense[dx, dy, dz] = w_me[dx + 3 * dy + 9 * dz, 0, 0]
    size = 6
    grid = rng.rand(size, size, size) < 0.5
    grid[2, 3, 1] = True
    coords = np.argwhere(grid).astype(np.int32)
    feats = rng.randn(len(coords), 1).astype(np.float32)
    dense = np.zeros((size + 2,) * 3, np.float32)  # padded by one voxel
    dense[coords[:, 0] + 1, coords[:, 1] + 1, coords[:, 2] + 1] = feats[:, 0]

    def oracle(c):
        x, y, z = c
        return float((dense[x:x + 3, y:y + 3, z:z + 3] * w_dense).sum())

    cj = torch.as_tensor(coords[None])
    cj, fj, keys = tt.sort_rows(cj, torch.as_tensor(feats[None]),
                                tt.encode_coords(cj))
    st = tt.SparseTensor(coords=cj, feats=fj, keys=keys,
                         shift=torch.zeros((1, 3), dtype=torch.int32))
    perm = tconv_ckpt.me_offset_permutation(3, "x_fastest")
    out = tconv.sparse_conv(st, torch.as_tensor(w_me[perm]), 3, 1)
    got = out.feats[0, :, 0].numpy()
    want = np.array([oracle(c) for c in out.coords[0].numpy()])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    wrong = tconv.sparse_conv(st, torch.as_tensor(w_me), 3, 1)
    assert np.abs(wrong.feats[0, :, 0].numpy() - want).max() > 1.0


# ----------------------------------------------------------------- fuse_bn

FUSE_CONFIGS = {
    "fcaf3d_tiny": lambda c: c.fcaf3d_tiny(),
    "reference_neck": lambda c: dataclasses.replace(
        c.fcaf3d_tiny(), neck_mode="reference"),
    "depth50": lambda c: dataclasses.replace(c.fcaf3d_tiny(), depth=50),
}


@pytest.mark.parametrize("name", sorted(FUSE_CONFIGS))
def test_fuse_conv_bn_equals_jax(name):
    """`fuse_conv_bn` on the port's exported variables: the fused tree
    bitwise equal to the JAX package's on the same numpy tree, the same
    count of fused pairs (every BatchNorm ahead of which a conv's name
    matches a rule), the input untouched, and afterwards every fused BN
    with scale 1, mean 0 and var 1 - eps."""
    cfg = FUSE_CONFIGS[name](tconfigs)
    model = init_detector(cfg, device="cpu")
    variables = export_variables(model)
    before = {k: v.copy() for k, v in flatten(variables).items()}
    fused, n = fuse_conv_bn(variables)
    want, n_want = j_fuse_conv_bn(jax.tree_util.tree_map(jnp.asarray,
                                                         variables))
    assert n == n_want >= 10
    assert_equal_trees(fused, jax.tree_util.tree_map(np.asarray, want))
    assert all(np.array_equal(v, before[k])
               for k, v in flatten(variables).items())
    stats = flatten(fused["batch_stats"])
    moved = [k[:-len(".mean")] for k, v in stats.items()
             if k.endswith(".mean") and not v.any()]
    assert len(moved) == n
    for scope in moved:
        np.testing.assert_array_equal(stats[f"{scope}.var"],
                                      np.float32(1.0 - BN_EPS))
        assert (flatten(fused["params"])[f"{scope}.scale"] == 1).all()


def test_fuse_conv_bn_takes_cpu_tensors():
    """The same tree from CPU tensors: equal to the numpy one's."""
    variables = init_variables(tconfigs.fcaf3d_tiny())
    tensors = jax.tree_util.tree_map(torch.as_tensor, variables)
    got, n = fuse_conv_bn(tensors)
    want, n_want = fuse_conv_bn(variables)
    assert n == n_want
    assert_equal_trees(got, want)


def test_fused_forward_matches_unfused():
    """The fused variables in the unchanged f32 model: every output of the
    forward (class scores, centerness, boxes at each level) within 1e-4 of
    the unfused model's, the JAX test's tolerance, and the same
    detections."""
    cfg = dataclasses.replace(tconfigs.fcaf3d_tiny(), compute_dtype="float32")
    xyz, rgb = bench.synth_scene(np.random.RandomState(1), cfg.num_points,
                                 extent=EXTENT)
    points = np.concatenate([xyz, rgb], axis=1)
    model = init_detector(cfg, device="cpu")
    fused_model = init_detector(cfg, device="cpu")
    fused, n = fuse_conv_bn(export_variables(model))
    load_variables(fused_model, fused)
    p = torch.as_tensor(points[None, :, :3].astype(np.float32))
    c = torch.as_tensor(points[None, :, 3:6].astype(np.float32))
    v = torch.ones(p.shape[:2], dtype=torch.bool)
    with torch.no_grad():
        want, _ = model(p, c, v)
        got, _ = fused_model(p, c, v)
    leaves = [(a, b) for a, b in zip(jax.tree_util.tree_leaves(got),
                                     jax.tree_util.tree_leaves(want))
              if torch.is_tensor(a) and a.is_floating_point()]
    assert len(leaves) >= 3 * cfg.n_outs
    for a, b in leaves:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
    got_d, _ = inference_detector(fused_model, points)
    want_d, _ = inference_detector(model, points)
    assert len(got_d["scores_3d"]) == len(want_d["scores_3d"]) > 0
    np.testing.assert_array_equal(got_d["labels_3d"], want_d["labels_3d"])
    for k in ("boxes_3d", "scores_3d"):
        np.testing.assert_allclose(got_d[k], want_d[k], rtol=0, atol=1e-4)


# ------------------------------------------------------- fuse and publish CLIs

@pytest.fixture(scope="module")
def fused_run(tmp_path_factory):
    """A training run's work dir at `fcaf3d_tiny` (f32): epoch 3's
    checkpoint after one optimizer step (so the moments are not zero) and
    `config.json`; then `tools.fuse_conv_bn` and `tools.publish_model` as
    subprocesses on the CPU."""
    tmp = tmp_path_factory.mktemp("fuse")
    cfg = dataclasses.replace(tconfigs.fcaf3d_tiny(), compute_dtype="float32")
    work, out = str(tmp / "work"), str(tmp / "fused")
    model = init_detector(cfg, device="cpu")
    opt = make_optimizer(model.parameters())
    for p in model.parameters():
        p.grad = torch.full_like(p, 1e-3)
    opt.step()
    save_checkpoint(work, 3, model, opt)
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    printed = run_cli("fuse_conv_bn", "--work-dir", work, "--out-dir", out,
                      "--device", "cpu")
    os.makedirs(tmp / "pub")
    published = run_cli("publish_model", "--work-dir", out, "--out",
                        str(tmp / "pub" / "fcaf3d_tiny"))
    return cfg, work, out, printed, published, tmp


def test_fuse_conv_bn_cli(fused_run):
    """The fused checkpoint: the same epoch, count 0 and zero moments (the
    counterpart of `tx.init`), variables equal to `fuse_conv_bn` of the
    work dir's, and the config copied."""
    cfg, work, out, printed, _, _ = fused_run
    model = init_detector(cfg, work_dir=work, device="cpu")
    want, n = fuse_conv_bn(export_variables(model))
    assert f"fused {n} conv+BN pairs from epoch 3 -> {out}" in printed
    ckpt = load_checkpoint(out)
    assert latest_epoch(out) == ckpt["epoch"] == 3 and ckpt["count"] == 0
    assert all(not v.any() for k in ("mu", "nu") for v in ckpt[k].values())
    fused = init_detector(cfg, work_dir=out, device="cpu")
    assert_equal_trees(export_variables(fused), want)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f) == json.loads(json.dumps(dataclasses.asdict(cfg)))


def test_publish_model_cli(fused_run):
    """`tools.publish_model` on the fused dir: `{out}-{sha256[:8]}.pkl`
    holding {"params", "batch_stats", "epoch"} of the latest checkpoint
    as numpy (no optimizer state), named by its own hash; through
    `init_detector(params_file=)` it gives the fused model's detections
    exactly."""
    cfg, _, out, _, printed, tmp = fused_run
    (name,) = os.listdir(tmp / "pub")
    path = str(tmp / "pub" / name)
    assert printed.strip() == f"wrote {path}"
    with open(path, "rb") as f:
        blob = f.read()
    assert name == f"fcaf3d_tiny-{hashlib.sha256(blob).hexdigest()[:8]}.pkl"
    tree = pickle.loads(blob)
    assert set(tree) == {"params", "batch_stats", "epoch"}
    assert tree["epoch"] == 3
    assert all(isinstance(v, np.ndarray) for v in flatten(tree).values()
               if not isinstance(v, int))
    fused = init_detector(cfg, work_dir=out, device="cpu")
    assert_equal_trees({k: tree[k] for k in ("params", "batch_stats")},
                       export_variables(fused))
    xyz, rgb = bench.synth_scene(np.random.RandomState(2), cfg.num_points,
                                 extent=EXTENT)
    points = np.concatenate([xyz, rgb], axis=1)
    got, _ = inference_detector(
        init_detector(cfg, params_file=path, device="cpu"), points)
    want, _ = inference_detector(fused, points)
    assert len(want["scores_3d"]) > 0
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_publish_and_convert_take_no_device():
    """Publishing and converting run on the host: neither CLI builds a
    model, so neither has a `--device`."""
    from fcaf3d_tpu_torch.tools import publish_model

    for mod, argv in ((publish_model, ["--work-dir", "w", "--out", "o"]),
                      (tconv_ckpt, ["--pth", "p", "--out", "o"])):
        assert not hasattr(mod.parse_args(argv), "device")
