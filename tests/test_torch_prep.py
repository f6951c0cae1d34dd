"""Data preparation of the port (`data/converters.py`, `tools/create_data`)
against the JAX package's converters, on the CPU.

The same raw tree (the inputs of `tests/test_converters.py`, plus a SUN
RGB-D tree of depth `.mat` clouds, calibrations and labels) goes through
both packages' converters in two copies: the info pickles must be equal
(dicts equal, arrays `array_equal` with the same dtype) and every written
`.bin` byte-equal; the port's `IndoorDetDataset` reads the port's output
as the JAX package's reads the JAX output.
"""
import os
import pickle
import shutil

import numpy as np
import pytest

from fcaf3d_tpu.data import converters as jconv
from fcaf3d_tpu.data import datasets as jdatasets
from fcaf3d_tpu_torch.data import converters as tconv
from fcaf3d_tpu_torch.data import datasets as tdatasets
from fcaf3d_tpu_torch.tools import create_data


def assert_same(a, b, where="info"):
    """Nested dicts / lists / arrays equal, arrays with the same dtype."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def assert_same_trees(got_root, want_root):
    """Every file the converters wrote, pickles by value, the rest by
    bytes."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(got_root) == files(want_root)
    for rel in files(got_root):
        with open(os.path.join(got_root, rel), "rb") as f:
            got = f.read()
        with open(os.path.join(want_root, rel), "rb") as f:
            want = f.read()
        if rel.endswith(".pkl"):
            assert_same(pickle.loads(got), pickle.loads(want), rel)
        else:
            assert got == want, rel


def scannet_raw(root, splits=("train",)):
    """`test_converters.py`'s ScanNet raw tree (two scans a split)."""
    os.makedirs(os.path.join(root, "meta_data"))
    src = os.path.join(root, "scannet_instance_data")
    os.makedirs(src)
    rng = np.random.RandomState(0)
    for j, split in enumerate(splits):
        scans = [f"scene{2 * j:04d}_00", f"scene{2 * j + 1:04d}_00"]
        with open(os.path.join(root, "meta_data",
                               f"scannetv2_{split}.txt"), "w") as f:
            f.write("\n".join(scans))
        for s in scans:
            n = 300
            np.save(os.path.join(src, f"{s}_vert.npy"),
                    rng.rand(n, 6).astype(np.float32))
            np.save(os.path.join(src, f"{s}_ins_label.npy"),
                    rng.randint(0, 5, n))
            np.save(os.path.join(src, f"{s}_sem_label.npy"),
                    rng.randint(0, 40, n))
            boxes = np.zeros((2, 7))
            boxes[:, :6] = rng.rand(2, 6) + 0.5
            boxes[:, 6] = [4, 5]  # bed, chair NYU ids
            np.save(os.path.join(src, f"{s}_aligned_bbox.npy"), boxes)
            np.save(os.path.join(src, f"{s}_unaligned_bbox.npy"), boxes)
            np.save(os.path.join(src, f"{s}_axis_align_matrix.npy"),
                    np.eye(4))


def s3dis_raw(root):
    """`test_converters.py`'s S3DIS room: a table, clutter, a third
    instance."""
    os.makedirs(os.path.join(root, "s3dis_data"))
    rng = np.random.RandomState(0)
    n = 400
    pts = rng.rand(n, 6).astype(np.float32) * 4
    ins = np.zeros(n, np.int64)
    sem = np.full(n, 0, np.int64)
    ins[:100], sem[:100] = 1, 7
    pts[:100, :3] = rng.rand(100, 3) * [2, 1, 0.5] + [1, 1, 0]
    ins[100:150], sem[100:150] = 2, 12
    ins[150:160], sem[150:160] = 3, 0
    for name, arr in (("point", pts), ("ins_label", ins), ("sem_label", sem)):
        np.save(os.path.join(root, "s3dis_data",
                             f"Area_1_office_1_{name}.npy"), arr)


def sunrgbd_raw(root):
    """A SUN RGB-D tree of three frames (train 1, 2; val 3): depth `.mat`
    clouds, calibrations and v1 labels, one label of a class outside the
    ten (skipped) and one frame without objects."""
    from scipy import io as sio

    base = os.path.join(root, "sunrgbd_trainval")
    for d in ("depth", "calib", "label_v1"):
        os.makedirs(os.path.join(base, d))
    for split, ids in (("train", [1, 2]), ("val", [3])):
        with open(os.path.join(base, f"{split}_data_idx.txt"), "w") as f:
            f.write("\n".join(str(i) for i in ids) + "\n")
    rng = np.random.RandomState(1)
    for idx in (1, 2, 3):
        sio.savemat(os.path.join(base, "depth", f"{idx:06d}.mat"),
                    {"instance": rng.rand(200, 6).astype(np.float64) * 3})
        with open(os.path.join(base, "calib", f"{idx:06d}.txt"), "w") as f:
            for _ in range(2):
                f.write(" ".join(f"{v:.6f}" for v in rng.rand(9)) + "\n")
        lines = []
        if idx != 3:
            for name in ("chair", "lamp", "bed"):
                v = np.concatenate([rng.rand(4) * 100, rng.rand(3) * 3,
                                    rng.rand(3) * 0.5 + 0.2,
                                    rng.rand(2) * 2 - 1])
                lines.append(" ".join([name] + [f"{x:.6f}" for x in v]))
        with open(os.path.join(base, "label_v1", f"{idx:06d}.txt"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")


RAW = {"scannet": scannet_raw, "s3dis": s3dis_raw, "sunrgbd": sunrgbd_raw}
CONVERTERS = {"scannet": ("ScanNetConverter", ("train",)),
              "s3dis": ("S3DISConverter", ("Area_1",)),
              "sunrgbd": ("SUNRGBDConverter", ("train", "val"))}


@pytest.mark.parametrize("dataset", ["scannet", "s3dis", "sunrgbd"])
def test_converter_equals_jax(dataset, tmp_path):
    """The same raw tree through both packages' converter: equal returned
    infos, equal pickles, byte-equal `.bin` files."""
    raw = str(tmp_path / "raw")
    RAW[dataset](raw)
    got_root, want_root = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(raw, got_root)
    shutil.copytree(raw, want_root)
    name, splits = CONVERTERS[dataset]
    infos = []
    for split in splits:
        got = getattr(tconv, name)(got_root, split).convert(num_workers=2)
        want = getattr(jconv, name)(want_root, split).convert(num_workers=2)
        assert_same(got, want, f"{dataset} {split}")
        infos += got
    assert any(i["annos"]["gt_num"] for i in infos)
    assert_same_trees(got_root, want_root)


def test_create_data_cli_and_dataset(tmp_path, capsys):
    """`tools.create_data scannet` converts train, val and test (the JAX
    tool's splits) as the JAX converters do, and the port's
    `IndoorDetDataset` reads the output as the JAX dataset reads the JAX
    output."""
    raw = str(tmp_path / "raw")
    scannet_raw(raw, ("train", "val", "test"))
    got_root, want_root = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(raw, got_root)
    shutil.copytree(raw, want_root)
    counts = create_data.main(["scannet", "--root-path", got_root,
                               "--workers", "2"])
    assert counts == {"train": 2, "val": 2, "test": 2}
    assert "scannet test: 2 scenes" in capsys.readouterr().out
    for split in ("train", "val", "test"):
        jconv.ScanNetConverter(want_root, split).convert(num_workers=2)
    assert_same_trees(got_root, want_root)
    for split in ("train", "val"):
        ann = f"scannet_infos_{split}.pkl"
        got = tdatasets.IndoorDetDataset(
            got_root, os.path.join(got_root, ann), tdatasets.SCANNET_CLASSES)
        want = jdatasets.IndoorDetDataset(
            want_root, os.path.join(want_root, ann),
            jdatasets.SCANNET_CLASSES)
        assert len(got) == len(want) == 2
        for i in range(2):
            assert_same(got(i, np.random.default_rng(i)),
                        want(i, np.random.default_rng(i)), f"{split} {i}")

