"""The two training proofs of the JAX package, run on the port on the CPU
(`chip_smoke.overfit_run`, `chip_smoke.epoch_proof`; phase 16 (b) and
(c) of `chip_smoke.py` runs them on the card):

- the crowded-rotated overfit with held-out points
  (`tests/test_overfit_fixture.py::
  test_overfit_crowded_rotated_heldout_points`, its config and train
  bar), from `create_train_state`'s init (the reference's init
  distributions) at several seeds, the runs' held-out mean against the
  JAX test's own mean from its flax init at as many PRNGKeys;
- the 12-epoch run with a mid-run resume
  (`tests/test_epoch_stability.py`), the resumed state bitwise the
  straight run's.

Their inputs are held equal to the JAX tests' (`crowded_rotated_sample`,
`EpochProofDataset`), and the training init to the distributions of the
JAX package's flax init. Both proofs take minutes here and are marked
slow.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu.models.detector import FCAF3D as JFCAF3D
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.data import SUNRGBD_CLASSES
from fcaf3d_tpu_torch.data.synth import crowded_rotated_sample
from fcaf3d_tpu_torch.params import flatten, init_reference_variables
from fcaf3d_tpu_torch.train import create_train_state
from tests.test_epoch_stability import SynthDataset
from tests.test_overfit_fixture import _crowded_rotated_sample
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401

# a bound on a sample's mean or deviation, in standard errors
SPREAD_SIGMAS = 4


def test_crowded_rotated_sample_equals_jax():
    """The overfit scene and its held-out resample, as the JAX test draws
    them."""
    got = crowded_rotated_sample(np.random.default_rng(7),
                                 len(SUNRGBD_CLASSES))
    want = _crowded_rotated_sample(np.random.default_rng(7))
    for k in ("points", "gt_boxes", "gt_labels"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    gt = {"gt_boxes": got["gt_boxes"], "gt_labels": got["gt_labels"]}
    held = crowded_rotated_sample(np.random.default_rng(1234),
                                  len(SUNRGBD_CLASSES), gt=gt)
    want = _crowded_rotated_sample(np.random.default_rng(1234), gt=gt)
    np.testing.assert_array_equal(held["points"], want["points"])


def test_epoch_proof_dataset_equals_jax():
    got, want = chip_smoke.EpochProofDataset(), SynthDataset()
    assert len(got) == len(want) and got.classes == want.classes
    for i in range(len(got)):
        a, b = got(i, None), want(i, None)
        for k in ("points", "gt_boxes", "gt_labels"):
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("which", ["overfit", "fcaf3d_tiny"])
def test_reference_init_matches_jax_init(which):
    """`init_reference_variables(cfg, seed)` (what `create_train_state`
    loads) draws the JAX package's `FCAF3D(cfg).init`: the same tree of
    float32 leaves, every constant exactly (norm gains, biases, the class
    prior, the exp scales, the running statistics), and every kernel from
    the same distribution: zero mean and the flax draw's standard
    deviation, each within SPREAD_SIGMAS standard errors of a leaf's
    size."""
    cfg = (chip_smoke.overfit_config(2816, 20) if which == "overfit"
           else tconfigs.fcaf3d_tiny())
    jcfg = jconfigs.FCAF3DConfig(**dataclasses.asdict(cfg))
    z = jnp.zeros((1, cfg.num_points, 3))
    want = jax.jit(JFCAF3D(jcfg).init)(jax.random.PRNGKey(0), z, z,
                                       jnp.ones((1, cfg.num_points), bool))
    want = flatten({k: jax.tree_util.tree_map(np.asarray, want[k])
                    for k in ("params", "batch_stats")})
    got = flatten(init_reference_variables(cfg, 0))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == np.float32, name
        if not name.endswith(".kernel"):
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        n, sd = g.size, float(w.std())
        assert abs(float(g.mean())) <= SPREAD_SIGMAS * sd / np.sqrt(n), name
        # the ratio of two sample deviations of n normals: error 1 / sqrt(n)
        assert abs(float(g.std()) / sd - 1) <= SPREAD_SIGMAS / np.sqrt(n), \
            name
    model, _, _ = create_train_state(cfg, 0, "cpu")
    for name, v in model.state_dict().items():
        leaf = got.get(f"params.{name}", got.get(f"batch_stats.{name}"))
        assert torch.equal(v, torch.from_numpy(leaf)), name


def jax_overfit_heldout(seed):
    """The JAX package's own overfit test
    (`tests/test_overfit_fixture.py::
    test_overfit_crowded_rotated_heldout_points`) from its flax init at
    PRNGKey(`seed`) in place of PRNGKey(0): (held-out mAP@0.25, train-points
    mAP@0.25 at the last evaluation). The test runs as it is, its bars
    not applied."""
    import tests.test_overfit_fixture as t

    real = jax.random.PRNGKey
    printed = []
    t.jax.random.PRNGKey = lambda s: real(seed)
    t.print = lambda *a, **k: printed.append(" ".join(map(str, a)))
    try:
        t.test_overfit_crowded_rotated_heldout_points()
    except AssertionError:
        pass
    finally:
        t.jax.random.PRNGKey = real
        del t.print
    held = [p for p in printed if "held-out" in p]
    train = [p for p in printed if p.startswith("[crowded] step")]
    return (float(held[-1].rsplit(" ", 1)[1]),
            float(train[-1].rsplit(" ", 1)[1]))


@pytest.mark.slow
def test_overfit_proof():
    """The crowded-rotated overfit from `create_train_state`'s init at each
    of `chip_smoke.OVERFIT_SEEDS` (`chip_smoke.overfit_run`): train-points
    mAP@0.25 at least the JAX test's bar in every run, each run's held-out
    mAP equal under both IoUs; and the runs' held-out mean is the JAX
    package's own over the same seeds (its test from its flax init at
    PRNGKey(seed)) within `chip_smoke.OVERFIT_SIGMAS` standard errors of
    the difference, from the runs' measured spread. One run's held-out
    mAP moves by ~0.08 with its init around a mean near the JAX test's
    bar, so a single run cannot tell a fault from an init. Prints both
    packages' values (`chip_smoke.OVERFIT_JAX_HELDOUT` holds the JAX
    package's for the card)."""
    seeds = chip_smoke.OVERFIT_SEEDS
    port = [chip_smoke.overfit_run(torch, "cpu", seed) for seed in seeds]
    got = [r["heldout_map"] for r in port]
    want = [jax_overfit_heldout(seed)[0] for seed in seeds]
    diff, err = chip_smoke.mean_difference(got, want)
    print(f"held-out mAP@0.25 over seeds {seeds[0]}-{seeds[-1]}: port "
          f"{[round(x, 4) for x in got]} mean {np.mean(got):.4f} sd "
          f"{np.std(got, ddof=1):.4f}; JAX {[round(x, 4) for x in want]} "
          f"mean {np.mean(want):.4f} sd {np.std(want, ddof=1):.4f}; "
          f"difference {diff:.4f}, its standard error {err:.4f}")
    assert min(r["train_map"] for r in port) >= \
        chip_smoke.OVERFIT_TRAIN_BAR
    assert abs(diff) <= chip_smoke.OVERFIT_SIGMAS * err


@pytest.mark.slow
def test_epoch_proof(tmp_path):
    """12 epochs at `fcaf3d_tiny`: finite falling losses, bounded BN
    statistics, 12 steps; the 6 + 6 resumed run bitwise equal."""
    rec = chip_smoke.epoch_proof(torch, "cpu", str(tmp_path))
    assert rec["tensors"] > 0
