"""The init that the port's VoteNet, VoteNet-v1, Detector2D and ImVoteNet
training starts at, held to the JAX package's: its tools train from flax's
`model.init` (`tools/train_votenet.py`, `tools/train_detector2d.py`,
`tools/train_imvotenet.py`), and `create_votenet_train_state`,
`create_detector2d_train_state` and `create_imvotenet_train_state` load
the seeded numpy draws of flax's default init
(`params.init_votenet_reference_variables`,
`init_detector2d_reference_variables`,
`init_imvotenet_reference_variables`).

Each case builds the JAX module at the CPU tests' size and runs its `init`
(the VoteNet family's ball query `ball_query_grid` in its XLA formulation,
as `tests/test_torch_votenet_train.py` runs it), then holds the port's
draw to it: the same tree of float32 leaves, every constant exactly (the
biases, Detector2D's `cls_pred` bias of -4 and exp scales, the norm gains
and running statistics), every kernel's mean and deviation within
SPREAD_SIGMAS standard errors of the flax draw's, and no kernel element
beyond flax's truncation at twice the draw's scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fcaf3d_tpu.models import detector2d as jd
from fcaf3d_tpu.models import votenet_v1 as jv1
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.params import (
    flatten,
    init_detector2d_reference_variables,
    init_imvotenet_reference_variables,
    init_votenet_reference_variables,
)
from fcaf3d_tpu_torch.train import (
    create_detector2d_train_state,
    create_imvotenet_train_state,
    create_votenet_train_state,
)
from tests.test_torch_imvotenet import INPUTS, K_SEEDS, MAX_IMVOTE, jax_net
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401
from tests.test_torch_votenet_train import (  # noqa: F401
    grid_ball_query, jax_votenet)

# a bound on a sample's mean or deviation, in standard errors
SPREAD_SIGMAS = 4
# flax's `lecun_normal`: a unit normal truncated at +-2 has this deviation
TRUNCATED_STD = 0.87962566103423978
CASES = ("votenet_v2", "votenet_v1", "detector2d", "imvotenet")


def case(which):
    """(the JAX module's init variables as a flat numpy dict, the port's
    draw flat, the port's train state's model) of one case at seed 0."""
    key = jax.random.PRNGKey(0)
    if which.startswith("votenet"):
        cfg = tconfigs.votenet_tiny()
        coder = jcoder = None
        if which == "votenet_v1":
            cfg = dataclasses.replace(cfg, head_version="v1")
            coder = chip_smoke.tiny_coder()
            jcoder = jv1.PartialBinBasedBBoxCoder(**dataclasses.asdict(coder))
        x = jnp.asarray(chip_smoke.vote_head_batch(cfg)["points"][:1])
        want = jax.jit(lambda k, a: jax_votenet(cfg, jcoder).init(
            k, a, train=False))(key, x)
        got = init_votenet_reference_variables(cfg, 0, coder)
        model, _, _ = create_votenet_train_state(cfg, 0, "cpu", coder=coder)
    elif which == "detector2d":
        tiny = chip_smoke.DET2D_TINY
        module = jd.Detector2D(**tiny)
        images = jnp.asarray(chip_smoke.det2d_tiny_batch()["images"][:1])
        want = jax.jit(module.init)(key, images)
        got = init_detector2d_reference_variables(**tiny, seed=0)
        model, _, _ = create_detector2d_train_state(**tiny, seed=0,
                                                    device="cpu")
    else:
        cfg = chip_smoke.imvote_tiny_cfg()
        batch = chip_smoke.tiny_imvote_batch(cfg)
        inputs = [jnp.asarray(batch[k]) for k in INPUTS + ("depth2img",)]
        want = jax.jit(lambda k, *a: jax_net(cfg).init(
            k, *a[:4], depth2img=a[4]))(key, *inputs)
        got = init_imvotenet_reference_variables(cfg, 0, K_SEEDS, MAX_IMVOTE)
        model, _, _ = create_imvotenet_train_state(
            cfg, 0, "cpu", num_sampled_seed=K_SEEDS, max_imvote=MAX_IMVOTE)
    want = flatten({k: jax.tree_util.tree_map(np.asarray, v)
                    for k, v in want.items()})
    return want, flatten(got), model


@pytest.mark.parametrize("which", CASES)
def test_reference_init_matches_flax_init(which, grid_ball_query):  # noqa: F811
    """The port's reference-init draw against the JAX module's `init` (module
    docstring), and the train state holds exactly that draw."""
    want, got, model = case(which)
    assert got.keys() == want.keys()
    kernels = 0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == np.float32, name
        if not name.endswith(".kernel"):
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        kernels += 1
        n, sd = g.size, float(w.std())
        assert abs(float(g.mean())) <= SPREAD_SIGMAS * sd / np.sqrt(n), name
        # the ratio of two sample deviations of n draws: error ~1 / sqrt(n)
        assert abs(float(g.std()) / sd - 1) <= SPREAD_SIGMAS / np.sqrt(n), \
            name
        cut = 2 * np.sqrt(1.0 / np.prod(g.shape[:-1])) / TRUNCATED_STD
        assert np.abs(w).max() <= cut * (1 + 1e-6), name
        assert np.abs(g).max() <= cut * (1 + 1e-6), name
    assert kernels > 0
    if which == "detector2d":
        assert (got["params.cls_pred.bias"] == -4.0).all()
        assert all(got[f"params.scale{i}"] == 1.0 for i in range(3))
    for name, v in model.state_dict().items():
        leaf = got.get(f"params.{name}", got.get(f"batch_stats.{name}"))
        assert torch.equal(v, torch.from_numpy(leaf)), name
