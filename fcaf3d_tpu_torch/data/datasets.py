"""Indoor detection datasets reading the reference's prepared-data layout:
a copy of `fcaf3d_tpu/data/datasets.py` (its `sunrgbd_depth2img` lives in
`data/calib.py`), held equal to it by a test.

Byte-compatible with mmdetection3d info pickles + point `.bin` files: each
info has `pts_path` pointing at a float32 `.bin` of shape [N, 6] (xyz + rgb
or xyz + extras) and `annos.gt_boxes_upright_depth` [G, 6|7] with origin
(0.5, 0.5, 0.5) (gravity-centered), converted here to the framework's
bottom-centered box7.

Differences from the reference by design: datasets return plain numpy
sample dicts (no DataContainer), pipelines are explicit `Compose` objects
with a passed-in RNG, and empty-GT resampling (`_rand_another`) draws from
the same RNG.
"""
from __future__ import annotations

import os
import pickle
from typing import Callable, Optional, Sequence

import numpy as np

from .points import default_attribute_dims

SCANNET_CLASSES = (
    "cabinet", "bed", "chair", "sofa", "table", "door", "window", "bookshelf",
    "picture", "counter", "desk", "curtain", "refrigerator", "showercurtrain",
    "toilet", "sink", "bathtub", "garbagebin",
)
SUNRGBD_CLASSES = (
    "bed", "table", "sofa", "chair", "toilet", "desk", "dresser",
    "night_stand", "bookshelf", "bathtub",
)
S3DIS_CLASSES = ("table", "chair", "sofa", "bookcase", "board")


def boxes_to_bottom_center(raw: np.ndarray) -> np.ndarray:
    """[G, 6|7] gravity-centered (origin .5,.5,.5) -> bottom-centered box7."""
    g = len(raw)
    out = np.zeros((g, 7), np.float32)
    if g:
        out[:, : raw.shape[1]] = raw
        out[:, 2] -= out[:, 5] / 2.0
    return out


class IndoorDetDataset:
    """Base indoor detection dataset (`Custom3DDataset` equivalent)."""

    def __init__(
        self,
        data_root: str,
        ann_file: str,
        classes: Sequence[str],
        pipeline: Optional[Callable] = None,
        load_dim: int = 6,
        use_dim: Sequence[int] = (0, 1, 2, 3, 4, 5),
        test_mode: bool = False,
        filter_empty_gt: bool = True,
    ):
        self.data_root = data_root
        self.classes = tuple(classes)
        self.pipeline = pipeline
        self.load_dim = load_dim
        self.use_dim = list(use_dim)
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        with open(ann_file, "rb") as f:
            self.data_infos = pickle.load(f)

    def __len__(self):
        return len(self.data_infos)

    def _load_points(self, info) -> np.ndarray:
        path = os.path.join(self.data_root, info["pts_path"])
        pts = np.fromfile(path, dtype=np.float32).reshape(-1, self.load_dim)
        return pts[:, self.use_dim]

    def get_ann(self, index: int):
        info = self.data_infos[index]
        annos = info.get("annos", {})
        if annos.get("gt_num", 0) != 0:
            raw = annos["gt_boxes_upright_depth"].astype(np.float32)
            labels = annos["class"].astype(np.int64)
        else:
            raw = np.zeros((0, 7), np.float32)
            labels = np.zeros((0,), np.int64)
        return boxes_to_bottom_center(raw), labels

    def _axis_align_matrix(self, info):
        annos = info.get("annos", {})
        mat = annos.get("axis_align_matrix")
        return np.asarray(mat, np.float32) if mat is not None else None

    def get_sample(self, index: int, rng: np.random.Generator) -> Optional[dict]:
        info = self.data_infos[index]
        boxes, labels = self.get_ann(index)
        if self.filter_empty_gt and not self.test_mode and len(boxes) == 0:
            return None
        points = self._load_points(info)
        sample = {
            "points": points,
            # typed column map (core.points.Points3D): transforms that touch
            # attribute columns (ShiftHeight, RandomDropPointsColor) address
            # them by name instead of hardcoded slices
            "attribute_dims": default_attribute_dims(points.shape[1]),
            "gt_boxes": boxes,
            "gt_labels": labels,
            "axis_align_matrix": self._axis_align_matrix(info),
            "sample_idx": index,
        }
        if self.pipeline is not None:
            sample = self.pipeline(sample, rng)
        return sample

    def __call__(self, index: int, rng: np.random.Generator) -> dict:
        """Fetch with empty-GT redraw (`prepare_train_data`/`_rand_another`)."""
        for _ in range(64):
            sample = self.get_sample(index, rng)
            if sample is not None:
                return sample
            index = int(rng.integers(len(self)))
        raise RuntimeError("could not draw a sample with ground truth")


class RepeatDataset:
    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def __call__(self, index, rng):
        return self.dataset(index % len(self.dataset), rng)


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._sizes = np.array([len(d) for d in self.datasets])
        self._offsets = np.concatenate([[0], np.cumsum(self._sizes)])

    def __len__(self):
        return int(self._sizes.sum())

    def __call__(self, index, rng):
        d = int(np.searchsorted(self._offsets[1:], index, side="right"))
        return self.datasets[d](index - int(self._offsets[d]), rng)


def build_scannet(data_root, ann_file, pipeline=None, test_mode=False):
    return IndoorDetDataset(
        data_root, ann_file, SCANNET_CLASSES, pipeline, test_mode=test_mode
    )


def build_sunrgbd(data_root, ann_file, pipeline=None, test_mode=False):
    return IndoorDetDataset(
        data_root, ann_file, SUNRGBD_CLASSES, pipeline, test_mode=test_mode
    )


def build_s3dis(data_root, ann_files, pipeline=None, test_mode=False, repeat=13):
    """S3DIS: areas 1-4,6 for train (each repeated, reference config uses
    ConcatDataset x13), area 5 for test."""
    if isinstance(ann_files, str):
        ann_files = [ann_files]
    ds = [
        IndoorDetDataset(data_root, f, S3DIS_CLASSES, pipeline, test_mode=test_mode)
        for f in ann_files
    ]
    if test_mode or len(ds) == 1:
        return ds[0] if len(ds) == 1 else ConcatDataset(ds)
    return ConcatDataset([RepeatDataset(d, repeat) for d in ds])

