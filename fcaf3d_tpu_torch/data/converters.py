"""Offline dataset converters producing the mmdetection3d-compatible layout
(a copy of `fcaf3d_tpu/data/converters.py`, held equal to it by a test).

Clean-room equivalents of the reference's `tools/data_converter/
{scannet,sunrgbd,s3dis}_data_utils.py` + `indoor_converter.py`: read the
raw extracted arrays (the outputs of `data/scannet/batch_load_scannet_data
.py`, the SUN RGB-D matlab extraction, `data/s3dis/collect_indoor3d_data
.py`; `tools/data_prep/` of this repository) and write `points/*.bin` +
`<dataset>_infos_<split>.pkl` that the port's datasets (and the
reference's) read. `tools/create_data.py` of the port runs them.
"""
from __future__ import annotations

import os
import pickle
from concurrent import futures

import numpy as np

SCANNET_CAT_IDS = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]
)
S3DIS_CAT_IDS = np.array([7, 8, 9, 10, 11])  # table chair sofa bookcase board


def _read_lines(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


class ScanNetConverter:
    """ScanNet: `scannet_instance_data/{scan}_*.npy` -> points/ + infos pkl
    (reference `scannet_data_utils.py:63-158`)."""

    def __init__(self, root: str, split: str = "train"):
        self.root = root
        self.split = split
        self.test_mode = split == "test"
        self.ids = _read_lines(
            os.path.join(root, "meta_data", f"scannetv2_{split}.txt")
        )
        self.cat_ids2class = {int(c): i for i, c in enumerate(SCANNET_CAT_IDS)}

    def _one(self, sample_idx: str) -> dict:
        src = os.path.join(self.root, "scannet_instance_data")
        info = {"point_cloud": {"num_features": 6, "lidar_idx": sample_idx}}
        points = np.load(os.path.join(src, f"{sample_idx}_vert.npy"))
        os.makedirs(os.path.join(self.root, "points"), exist_ok=True)
        points.astype(np.float32).tofile(
            os.path.join(self.root, "points", f"{sample_idx}.bin")
        )
        info["pts_path"] = os.path.join("points", f"{sample_idx}.bin")

        if not self.test_mode:
            for kind in ("ins", "sem"):
                mask = np.load(os.path.join(src, f"{sample_idx}_{kind}_label.npy"))
                folder = "instance_mask" if kind == "ins" else "semantic_mask"
                os.makedirs(os.path.join(self.root, folder), exist_ok=True)
                mask.astype(np.int64).tofile(
                    os.path.join(self.root, folder, f"{sample_idx}.bin")
                )
                info[f"pts_{'instance' if kind == 'ins' else 'semantic'}_mask_path"] = (
                    os.path.join(folder, f"{sample_idx}.bin")
                )

            aligned = np.load(os.path.join(src, f"{sample_idx}_aligned_bbox.npy"))
            unaligned = np.load(os.path.join(src, f"{sample_idx}_unaligned_bbox.npy"))
            annos = {"gt_num": aligned.shape[0]}
            if annos["gt_num"] != 0:
                classes = aligned[:, -1].astype(int)
                annos["gt_boxes_upright_depth"] = aligned[:, :-1]
                annos["unaligned_gt_boxes_upright_depth"] = unaligned[:, :-1]
                annos["location"] = aligned[:, :3]
                annos["dimensions"] = aligned[:, 3:6]
                annos["index"] = np.arange(annos["gt_num"], dtype=np.int32)
                annos["class"] = np.array(
                    [self.cat_ids2class[c] for c in classes]
                )
            annos["axis_align_matrix"] = np.load(
                os.path.join(src, f"{sample_idx}_axis_align_matrix.npy")
            )
            info["annos"] = annos
        return info

    def convert(self, out_path: str = None, num_workers: int = 8):
        with futures.ThreadPoolExecutor(num_workers) as pool:
            infos = list(pool.map(self._one, self.ids))
        out = out_path or os.path.join(
            self.root, f"scannet_infos_{self.split}.pkl"
        )
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        return infos


class SUNRGBDConverter:
    """SUN RGB-D: depth .mat point clouds + label txts + calib -> layout
    (reference `sunrgbd_data_utils.py:57-230`; note the reference keeps the
    full cloud — no 50k subsample)."""

    CLASSES = (
        "bed", "table", "sofa", "chair", "toilet", "desk", "dresser",
        "night_stand", "bookshelf", "bathtub",
    )

    def __init__(self, root: str, split: str = "train", use_v1: bool = True):
        self.root = root
        self.split = split
        self.split_dir = os.path.join(root, "sunrgbd_trainval")
        self.ids = [int(x) for x in _read_lines(
            os.path.join(self.split_dir, f"{split}_data_idx.txt"))]
        self.label_dir = os.path.join(
            self.split_dir, "label_v1" if use_v1 else "label"
        )
        self.cat2label = {c: i for i, c in enumerate(self.CLASSES)}

    def _parse_label(self, idx: int):
        objs = []
        path = os.path.join(self.label_dir, f"{idx:06d}.txt")
        for line in _read_lines(path):
            parts = line.split(" ")
            name = parts[0]
            if name not in self.cat2label:
                continue
            vals = [float(x) for x in parts[1:]]
            box2d = np.array([vals[0], vals[1], vals[0] + vals[2], vals[1] + vals[3]])
            centroid = np.array(vals[4:7])
            w, l, h = vals[7], vals[8], vals[9]
            heading = -np.arctan2(vals[11], vals[10])
            box3d = np.concatenate(
                [centroid, [l * 2, w * 2, h * 2, heading]]
            )
            objs.append((name, box2d, box3d))
        return objs

    def _one(self, idx: int) -> dict:
        from scipy import io as sio

        pc = sio.loadmat(
            os.path.join(self.split_dir, "depth", f"{idx:06d}.mat")
        )["instance"]
        os.makedirs(os.path.join(self.root, "points"), exist_ok=True)
        pc.astype(np.float32).tofile(
            os.path.join(self.root, "points", f"{idx:06d}.bin")
        )
        calib_lines = _read_lines(
            os.path.join(self.split_dir, "calib", f"{idx:06d}.txt")
        )
        rt = np.reshape(
            [float(x) for x in calib_lines[0].split(" ")], (3, 3), order="F"
        ).astype(np.float32)
        k = np.reshape(
            [float(x) for x in calib_lines[1].split(" ")], (3, 3), order="F"
        ).astype(np.float32)

        info = {
            "point_cloud": {"num_features": 6, "lidar_idx": idx},
            "pts_path": os.path.join("points", f"{idx:06d}.bin"),
            "image": {
                "image_idx": idx,
                "image_path": os.path.join("image", f"{idx:06d}.jpg"),
            },
            "calib": {"K": k, "Rt": rt},
        }
        objs = self._parse_label(idx)
        annos = {"gt_num": len(objs)}
        if objs:
            annos["name"] = np.array([o[0] for o in objs])
            annos["bbox"] = np.stack([o[1] for o in objs])
            annos["gt_boxes_upright_depth"] = np.stack([o[2] for o in objs])
            annos["location"] = annos["gt_boxes_upright_depth"][:, :3]
            annos["dimensions"] = annos["gt_boxes_upright_depth"][:, 3:6]
            annos["rotation_y"] = annos["gt_boxes_upright_depth"][:, 6]
            annos["index"] = np.arange(len(objs), dtype=np.int32)
            annos["class"] = np.array([self.cat2label[o[0]] for o in objs])
        info["annos"] = annos
        return info

    def convert(self, out_path: str = None, num_workers: int = 8):
        with futures.ThreadPoolExecutor(num_workers) as pool:
            infos = list(pool.map(self._one, self.ids))
        out = out_path or os.path.join(
            self.root, f"sunrgbd_infos_{self.split}.pkl"
        )
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        return infos


class S3DISConverter:
    """S3DIS: per-room point/ins/sem npy -> layout; boxes are min/max extents
    of furniture instances (reference `s3dis_data_utils.py:44-149`)."""

    def __init__(self, root: str, split: str = "Area_1"):
        self.root = root
        self.split = split
        data_dir = os.path.join(root, "s3dis_data")
        self.ids = sorted(
            {
                f[len(split) + 1:].split("_point")[0]
                for f in os.listdir(data_dir)
                if f.startswith(split) and f.endswith("_point.npy")
            }
        )
        self.cat_ids2class = {int(c): i for i, c in enumerate(S3DIS_CAT_IDS)}

    def _one(self, sample_idx: str) -> dict:
        src = os.path.join(self.root, "s3dis_data")
        name = f"{self.split}_{sample_idx}"
        points = np.load(os.path.join(src, f"{name}_point.npy")).astype(np.float32)
        ins = np.load(os.path.join(src, f"{name}_ins_label.npy")).astype(np.int64)
        sem = np.load(os.path.join(src, f"{name}_sem_label.npy")).astype(np.int64)
        for folder, arr in (
            ("points", points),
            ("instance_mask", ins),
            ("semantic_mask", sem),
        ):
            os.makedirs(os.path.join(self.root, folder), exist_ok=True)
            arr.tofile(os.path.join(self.root, folder, f"{name}.bin"))

        bboxes, labels = [], []
        for i in range(1, int(ins.max())):
            ids = ins == i
            label = int(sem[ids][0])
            if label in self.cat_ids2class:
                pts = points[ids, :3]
                mn, mx = pts.min(0), pts.max(0)
                bboxes.append(np.concatenate([(mn + mx) / 2, mx - mn]))
                labels.append(self.cat_ids2class[label])
        info = {
            "point_cloud": {"num_features": 6, "lidar_idx": name},
            "pts_path": os.path.join("points", f"{name}.bin"),
            "pts_instance_mask_path": os.path.join("instance_mask", f"{name}.bin"),
            "pts_semantic_mask_path": os.path.join("semantic_mask", f"{name}.bin"),
            "annos": {
                "gt_boxes_upright_depth": np.array(bboxes),
                "class": np.array(labels),
                "gt_num": len(labels),
            },
        }
        return info

    def convert(self, out_path: str = None, num_workers: int = 8):
        with futures.ThreadPoolExecutor(num_workers) as pool:
            infos = list(pool.map(self._one, self.ids))
        out = out_path or os.path.join(
            self.root, f"s3dis_infos_{self.split}.pkl"
        )
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        return infos
