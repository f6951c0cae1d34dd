"""Point-cloud detection demo of the port (the torch counterpart of
`demo/pcd_demo.py`): run FCAF3D on one `.bin` cloud and dump .obj files
for MeshLab.

    python -m fcaf3d_tpu_torch.tools.pcd_demo scene.bin --dataset scannet \
        --work-dir work_dirs/fcaf3d_scannet --out-dir demo_out [--device cpu]

Without `--work-dir` the detector has the seeded random weights of
`params.init_variables`.
"""
import argparse
import os

import numpy as np

from ..apis.inference import inference_detector, init_detector
from ..configs import (add_set_argument, apply_overrides, fcaf3d_s3dis,
                       fcaf3d_scannet, fcaf3d_sunrgbd)
from ..core.visualizer import show_result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pcd", help=".bin float32 [N, 6] xyz+rgb point cloud")
    ap.add_argument("--dataset", choices=["scannet", "sunrgbd", "s3dis"],
                    default="scannet")
    ap.add_argument("--work-dir", default=None, help="trained checkpoint dir")
    ap.add_argument("--out-dir", default="demo_out")
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default the card)")
    add_set_argument(ap)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    cfg = {"scannet": fcaf3d_scannet, "sunrgbd": fcaf3d_sunrgbd,
           "s3dis": fcaf3d_s3dis}[args.dataset]()
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    model = init_detector(cfg, work_dir=args.work_dir, device=args.device)

    points = np.fromfile(args.pcd, dtype=np.float32).reshape(-1, 6)
    result, _ = inference_detector(model, points)
    keep = result["scores_3d"] > args.score_thr
    boxes = result["boxes_3d"][keep]
    print(f"{keep.sum()} detections above {args.score_thr}")
    name = os.path.splitext(os.path.basename(args.pcd))[0]
    show_result(points, boxes, None, args.out_dir, name)
    print(f"wrote {args.out_dir}/{name}_points.obj"
          + (" and _pred.obj" if len(boxes) else ""))


if __name__ == "__main__":
    main()
