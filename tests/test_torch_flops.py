"""The port's model-FLOP counter (`fcaf3d_tpu_torch/utils/flops.py`) against
the JAX package's (`fcaf3d_tpu/utils/flops.py`), on the CPU.

The port records at call time, on the plain path as on the kernel path;
the JAX package records at trace time and only where its Pallas kernels
run, so its side runs here with the fused convs on
(`conv._use_fused_conv`) and every kernel in interpret mode, and is only
lowered (`jax.jit(...).lower`), never compiled. The totals are FLOP
counts of integer shapes: held exactly equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu.models.detector import FCAF3D as JFCAF3D
from fcaf3d_tpu.models.detector import loss_config as j_loss_config
from fcaf3d_tpu.models.fcaf3d_head import fcaf3d_loss as j_fcaf3d_loss
from fcaf3d_tpu.ops.sparse import conv as jconv
from fcaf3d_tpu.ops.sparse import gather_kernel as jgk
from fcaf3d_tpu.utils import flop_counter as j_flop_counter
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import init_detector
from fcaf3d_tpu_torch.ops.sparse import gather_kernel as tgk
from fcaf3d_tpu_torch.params import init_variables
from fcaf3d_tpu_torch.train import create_train_state, make_train_step
from fcaf3d_tpu_torch.utils import flop_counter, flops
from tests.test_torch_model import EXTENT


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX package's convs on its Pallas kernels in interpret mode
    (forward, and with FCAF3D_FUSED_BWD=force the fused backward), so its
    wrappers record their FLOPs on the CPU."""
    monkeypatch.setattr(jconv, "_use_fused_conv", lambda: True)
    monkeypatch.setattr(jgk, "fused_gather_gemm", functools.partial(
        jgk.fused_gather_gemm, interpret=True))
    monkeypatch.setattr(jgk, "fused_gather_dw", functools.partial(
        jgk.fused_gather_dw, interpret=True))
    monkeypatch.setenv("FCAF3D_FUSED_BWD", "force")


def test_k2_k4_record_dense_flops(jax_fused):
    """K2 and K4 record 2 B M K C E on the plain path, into every active
    counter, nested counters accumulate, and K2's record equals the JAX
    wrapper's on the JAX test's shapes (`test_misc_ops.py`); with no
    counter active nothing is recorded anywhere."""
    b, n, c, m, k, e = 2, 64, 8, 32, 3, 16
    rng = np.random.RandomState(0)
    feats = rng.randn(b, n, c).astype(np.float32)
    idx = rng.randint(0, n + 1, (b, m, k)).astype(np.int32)
    w = rng.randn(k, c, e).astype(np.float32)
    dout = rng.randn(b, m, e).astype(np.float32)
    tf, ti, tw, td = map(torch.as_tensor, (feats, idx, w, dout))
    dense = 2.0 * b * m * k * c * e

    tgk.fused_gather_gemm(tf, ti, tw)  # no counter: a no-op
    assert not flops._ACTIVE
    with flop_counter() as outer:
        tgk.fused_gather_gemm(tf, ti, tw)
        with flop_counter() as inner:
            tgk.fused_gather_dw(tf, ti, td)
            tgk.fused_gather_gemm(tf, ti, tw, scale=torch.ones(e),
                                  shift=torch.zeros(e), act="relu",
                                  vmask=torch.ones(b, m, dtype=torch.bool))
    assert inner.model == 2 * dense and outer.model == 3 * dense
    assert not flops._ACTIVE

    with j_flop_counter() as jfc:
        jgk.fused_gather_gemm(jnp.asarray(feats), jnp.asarray(idx),
                              jnp.asarray(w))
    with flop_counter() as fc:
        tgk.fused_gather_gemm(tf, ti, tw)
    assert fc.model == jfc.model == dense


def test_forward_total_equals_jax(jax_fused):
    """One `fcaf3d_tiny` evaluation-mode forward of the port records the
    JAX counter's model total over one `jax.jit(...).lower` of the same
    forward (same variables and scan)."""
    cfg, jcfg = tconfigs.fcaf3d_tiny(), jconfigs.fcaf3d_tiny()
    model = init_detector(cfg, seed=0, device="cpu")
    xyz, rgb = bench.synth_scene(np.random.RandomState(0), cfg.num_points,
                                 extent=EXTENT["fcaf3d_tiny"])
    p, c = xyz[None].astype(np.float32), rgb[None].astype(np.float32)
    v = np.ones(p.shape[:2], bool)
    with torch.no_grad(), flop_counter() as fc:
        model(torch.as_tensor(p), torch.as_tensor(c), torch.as_tensor(v))
    jmodel = JFCAF3D(jcfg)
    jvars = jax.tree_util.tree_map(jnp.asarray, init_variables(cfg, seed=0))
    with j_flop_counter() as jfc:
        jax.jit(lambda vs, a, b, m: jmodel.apply(vs, a, b, m, train=False)
                ).lower(jvars, jnp.asarray(p), jnp.asarray(c),
                        jnp.asarray(v))
    assert fc.model > 0
    assert fc.model == jfc.model


def test_train_step_total_equals_jax_but_stem_dfeats(jax_fused):
    """One `fcaf3d_nano` train step of the port (forward, K4's dW and K2's
    dFeats) records the JAX counter's total over one lowered
    `jax.value_and_grad` of the same loss, less the stem conv's dFeats
    (2 B N K C E at the input budget): the JAX custom VJP traces (and so
    records) a dFeats for the colours, which the port's autograd never
    computes because the colours need no gradient."""
    cfg, jcfg = tconfigs.fcaf3d_nano(), jconfigs.fcaf3d_nano()
    batch = chip_smoke.head_batch(torch, cfg, EXTENT["fcaf3d_nano"])
    model, opt, _ = create_train_state(cfg, seed=0, device="cpu")
    with flop_counter() as fc:
        make_train_step(model, cfg, opt)(batch)

    jmodel, lcfg = JFCAF3D(jcfg), j_loss_config(jcfg)

    def loss_fn(params, batch_stats, b):
        outs, _ = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, b["points"],
            b["colors"], b["valid"], train=True,
            mutable=["batch_stats", "overflow"])
        losses = j_fcaf3d_loss(outs, b["gt_boxes"], b["gt_labels"],
                               b["gt_valid"], lcfg)
        return losses["loss_cls"] + losses["loss_centerness"] + \
            losses["loss_bbox"]

    jv = jax.tree_util.tree_map(jnp.asarray, init_variables(cfg, seed=0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with j_flop_counter() as jfc:
        jax.jit(jax.value_and_grad(loss_fn)).lower(
            jv["params"], jv["batch_stats"], jb)
    k, c_in, e = model.backbone.conv1.kernel.shape
    b = batch["points"].shape[0]
    stem_dfeats = 2.0 * b * cfg.input_budget * k * c_in * e
    assert fc.model > 0
    assert fc.model == jfc.model - stem_dfeats
