"""Batch collation + a deterministic prefetching loader: a copy of
`fcaf3d_tpu/data/loader.py`, held equal to it by a test.

Replaces the torch DataLoader + DataContainer collation of mmdet3d with a
numpy collator that pads to the model's static shapes and a thread-pool
loader with deterministic per-(epoch, index) RNG seeding, the analog of
`DistSamplerSeedHook` + worker seeding.
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator

import numpy as np


def collate(samples, num_points: int, max_gt: int, n_feat_dims: int = 3):
    """Pad a list of pipeline sample dicts into fixed-shape batch arrays.

    Returns dict(points [B,P,3] f32, colors [B,P,C] f32, valid [B,P] bool,
    gt_boxes [B,G,7] f32, gt_labels [B,G] i32, gt_valid [B,G] bool).
    """
    b = len(samples)
    points = np.zeros((b, num_points, 3), np.float32)
    colors = np.zeros((b, num_points, n_feat_dims), np.float32)
    valid = np.zeros((b, num_points), bool)
    gt_boxes = np.zeros((b, max_gt, 7), np.float32)
    gt_labels = np.zeros((b, max_gt), np.int32)
    gt_valid = np.zeros((b, max_gt), bool)
    for i, s in enumerate(samples):
        pts = s["points"]
        n = min(len(pts), num_points)
        points[i, :n] = pts[:n, :3]
        colors[i, :n] = pts[:n, 3 : 3 + n_feat_dims]
        valid[i, :n] = True
        boxes = s.get("gt_boxes")
        if boxes is not None:
            g = min(len(boxes), max_gt)
            gt_boxes[i, :g] = boxes[:g]
            gt_labels[i, :g] = s["gt_labels"][:g]
            gt_valid[i, :g] = True
    return {
        "points": points,
        "colors": colors,
        "valid": valid,
        "gt_boxes": gt_boxes,
        "gt_labels": gt_labels,
        "gt_valid": gt_valid,
    }


class Loader:
    """Shuffled, seeded, thread-prefetched batch loader.

    Determinism: sample i of epoch e is transformed with
    `np.random.default_rng([seed, e, i])` regardless of worker scheduling.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_points: int,
        max_gt: int,
        n_feat_dims: int = 3,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 8,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        """`shard_index`/`num_shards`: multi-host data sharding (the analog
        of mmdet's per-rank `DistributedGroupSampler`, reference
        `tools/train.py:171-176`). `batch_size` stays the GLOBAL batch;
        host h yields rows [h*B/H, (h+1)*B/H) of every global batch, so the
        union over hosts is exactly the single-host stream (same
        per-(seed, epoch, index) RNG per sample) and each host's slab feeds
        its data-parallel rank."""
        if batch_size % num_shards:
            raise ValueError(
                f"global batch {batch_size} not divisible by {num_shards} shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_points = num_points
        self.max_gt = max_gt
        self.n_feat_dims = n_feat_dims
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.shard_index = shard_index
        self.num_shards = num_shards

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch_idx: int) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng([self.seed, epoch_idx]).shuffle(order)
        steps = self.steps_per_epoch()

        def fetch(i):
            rng = np.random.default_rng([self.seed, epoch_idx, int(i)])
            return self.dataset(int(order[i]), rng)

        local = self.batch_size // self.num_shards
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for s in range(steps):
                lo = s * self.batch_size + self.shard_index * local
                hi = min(lo + local, n)
                samples = list(pool.map(fetch, range(lo, hi)))
                yield collate(
                    samples, self.num_points, self.max_gt, self.n_feat_dims
                )
