"""Smoke run of the PyTorch/CUDA port (`fcaf3d_tpu_torch`) on one GPU.

Run from the repository root, on a machine with an NVIDIA Hopper GPU, nvcc
and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile the CUDA kernels K1-K6 from `fcaf3d_tpu_torch/csrc/`
   (one nvcc per source, in parallel).
3. Kernels against their plain PyTorch versions on the card, at the shapes
   of the main path's maps on a real-size scan: K1 exact (with and without
   `with_miss`, also on edge clouds: N = 1, N < L, N = 1 mod L, runs of
   equal keys across every L-th key, a compaction cumsum, random-order and
   all-SENTINEL queries, both K1 variants), K2 in f32 and bf16 with every
   epilogue (f32, and bf16 off the tensor cores' granule, equal to the
   earlier kernel), K3 exact (`torch.equal`) and equal to the first,
   scalar kernel on the stem pool maps of batch 1 and batch 8 in f32 and
   bf16, and on edge cases (C off the 16-byte vector, all-miss rows, ties,
   K = 27). Device times (CUDA events behind a sleep
   kernel, so that the host's enqueue rate does not set them), timed in
   turns with the plain version and the yardsticks: for K1 the binary-search
   kernel and, for positions, `torch.searchsorted(out_int32=True)`;
   for f32 K2 the earlier kernel, for bf16 K2 and K4 the SIMT kernel, and one
   matmul on the pre-gathered rows (not the same function: it shows what
   the GEMM alone costs), for K3 the scalar kernel. Each time is printed
   beside its bound (FLOPs over the peak, bytes over the memory rate, from
   the real map's hits) and its share of it.
4. The backward kernels, the same way, on the maps of one scan (batch 1)
   and of the batch-8 training batch: K4 (weight gradient) at every
   (C, E, K) of the training path in f32 and bf16, bitwise equal over two
   runs; K2 as dFeats on a reversed self map and on an inverted k3 s2 map
   (the inverse map card vs CPU exactly), and K2's training forward at
   s16 C128 E128 (at batch 8 its 128 x 128 tile).
5. Inference: `init_detector(fcaf3d_scannet())` in bf16 and
   `inference_detector` on three 100 000-point scans, with zero overflow,
   every inference kernel launched, every bf16 K2 launch on the tensor
   cores, every f32 K2 launch on the narrow or tiled kernel, every K1
   launch on the gallop kernel and every K3 launch on the vector kernel
   (launches by variant printed); the warm-up
   scan's K1 calls, each distinct one exact against plain and the
   earlier kernel and timed beside them; then one scan in f32 on the card
   against the plain path on the CPU (voxel keys and backbone kernel maps exactly
   equal, detections equal within tolerance), and that scan's K2 calls
   replayed on the card, as the path runs them and on the earlier kernel.
6. Training: `create_train_state` / `make_train_step` at `fcaf3d_scannet`
   in bf16, batch 8 of crowded synthetic scenes (50 000 raw points each,
   sampled to 100 000): one warm-up step (its K1 calls checked and timed
   as in phase 5, its K2 and K3 calls held to plain and its K4 calls to
   float64, `hold_calls_to_plain`), five timed steps with finite losses, a live box loss,
   zero overflow, finite non-zero gradients on every conv kernel, K1-K4
   launched and the variant gate of phase 5; then f32 steps on the card
   against the CPU plain path: `fcaf3d_tiny` at batch 2 (every gradient
   element within 1e-3 of its leaf's largest) and `fcaf3d_scannet` at
   batch 1 (kernel maps and pruned neck maps exactly equal, losses within
   1e-5, each gradient leaf within 5% in L2 norm), their f32 K2 launches
   on the narrow or tiled kernel and K1 on the gallop kernel.
7. K5 (farthest-point sampling) and K6 (ball query) against their plain
   versions at every shape of the VoteNet-v2 path (SA1-SA4, the seeds and
   the vote aggregation on two 20 000-point scans), at batch 1 and at
   batch 2 with a valid mask: exactly equal; plus S above the valid count,
   N beyond shared memory, N beyond the K5 cluster's registers, lattice tie
   clouds (SA1 and each side of every `fps_plan` boundary), every K5
   cluster size of the sweep at SA1; K6 also equal to its first kernel at
   every shape, and on edge clouds (N % 4 != 0, N below one tile, M off
   the CTA's centres, nsample above N, points at exactly r^2, masked and
   not, centres without a hit). Times at batch 1; K5's beside its
   single-CTA kernel (the earlier one), the operations bound and the
   serial floor (the cluster kernel at the plan's cluster and CTA size
   with one point a thread, on a cloud with one valid point a CTA: S - 1
   steps of the protocol alone); K6's beside its first kernel (one warp a
   centre), summed over a scan's five calls, and each call's host enqueue
   time beside the first kernel's.
8. VoteNet-v2 inference: `init_votenet(votenet_sunrgbd())` in f32 and
   `inference_votenet` on three 20 000-point scans, non-empty detections,
   five K5 and five K6 launches per scan, every K5 launch on the cluster
   kernel and every K6 launch on the tiled kernel; then one scan in f32 on
   the card against the CPU (every FPS and SA1-SA4 group exactly equal,
   aggregation groups equal but for members within 1e-4 of r^2, detections
   within tolerance), one scan in "vote" mode, and the scans' wall, FPS and
   ball-query device time with K5 and K6 against the kernels they replaced,
   in turns.
9. The other FCAF3D configs: `fcaf3d_scannet_3scales`,
   `fcaf3d_scannet_2scales` (2 cm voxels), `fcaf3d_s3dis` (5 classes) and
   `fcaf3d_sunrgbd` (10 classes, rotated boxes), each as phase 5 runs
   ScanNet: `init_detector` in bf16 and `inference_detector` on two scans
   of the config's own acquisition model (ScanNet's 50 000-point scans, a
   dense 1M-point room sampled to 100 000 points for S3DIS, one z-buffered
   Kinect frame for SUN RGB-D), zero overflow, K1-K3 launched, the variant
   gate, the warm-up scan's K1 calls exact and timed and its K2 and K3
   calls held to their plain versions; K2 at the stem and K3 at the s2
   pool of SUN RGB-D and S3DIS timed with bound and share; the rotated BEV
   NMS of a SUN RGB-D scan timed beside the axis-aligned one, with its peak
   memory; one SUN RGB-D scan in f32 on the card against the CPU (maps,
   rotated NMS keep masks, detections with yaw); SUN RGB-D training in
   bf16 at batch 8 of crowded scenes with yawed boxes (a warm-up step, then
   three timed steps with the checks of phase 6, K1-K4 launched); and the
   tight f32 gate of phase 6 at `fcaf3d_tiny(with_yaw=True)`.
10. The rest of FCAF3D, at `fcaf3d_scannet`'s budgets and widths. The
   reference-order neck (`neck_mode="reference"`: conv3 over all 8P
   generated children, union-add, prune): bf16 inference on two of phase
   5's scans as phase 9 runs its configs (zero overflow, K1-K3, the
   variant gate, the warm-up scan's K1 calls exact and its K2 calls, the
   child-map calls among them, held to plain), walls in turns with the
   prune-early neck on the same scans with each neck's peak memory; one
   f32 scan card against CPU (maps and child maps exactly, each prune's
   kept keys exactly but for rows within PRUNE_RTOL of the budget-th
   score, detections within phase 5's tolerances); bf16 training at batch
   8 with phase 6's checks (a warm-up step held to plain and to float64,
   three timed steps, peak memory) and the tight f32 gate at
   `fcaf3d_tiny(neck_mode="reference")`. Depth 50 and 101 (Bottleneck
   backbones, outputs up to 2048 wide): two bf16 scans each with phase 9's
   checks, one f32 depth-50 scan card against CPU, bf16 training at batch
   8 (depth 50 two timed steps, depth 101 one, each after a held warm-up
   step, with peak memory), the tight f32 gate at `fcaf3d_tiny(depth=50)`.
   K2 (batch 1) and K4 (batch 8) timed with bound and share at the child
   maps' and the widest shapes (REFERENCE_ROWS, DEEP_ROWS).
   `voxelize_reduce` mean and max on a scan at the ScanNet input budget:
   keys equal to the CPU's, features within VOXEL_REDUCE_ATOL, two card
   runs bitwise equal.
11. VoteNet training and VoteNet-v1, f32. (a) `create_votenet_train_state`
   / `make_votenet_train_step` at `votenet_sunrgbd`, batch 16 of phase
   9's crowded scenes with yawed boxes (20 000 points with the height
   column, GT padded to 64): a warm-up step whose K5 and K6 calls are
   held to plain (`torch.equal`; the proposals' FPS and ball query take
   the votes, contiguous and requiring grad), then VOTE_TRAIN_STEPS timed
   steps (finite losses, live vote, centre and IoU losses, finite non-zero
   gradients on every Dense kernel, every running statistic moved; 5 K5 on
   the cluster kernel and 5 K6 on the tiled kernel a step), step wall and
   CUDA-event span, peak memory, and how many of SA1's K5 clusters the card
   holds at once (`max_active_clusters`). (b) The tight f32 gate at
   `votenet_tiny`, batch 2, card against CPU from the same numpy variables
   and batch (`compare_vote_train_tiny`): backbone FPS indices and groups
   exactly equal, a proposal FPS index may flip only at a running-minimum
   tie (VOTE_FPS_RTOL) and a group member only within AGG_D2_TOL of r^2
   (the CPU then takes the card's), losses within TRAIN_LOSS_RTOL of the
   total, running statistics within VOTE_STATS_ATOL, gradient elements
   within TINY_GRAD_RTOL of their leaf's largest, or every leaf within
   TRAIN_GRAD_RTOL in norm where a ReLU input changes sign within
   RELU_TIE_ATOL of 0; TF32 off. (c) VoteNet-v1 inference through
   `init_votenet(cfg, coder=...)`: V1_SCANS 20 000-point scans at
   `votenet_v1_sunrgbd` and V1_SCANS 50 000-point ScanNet scans sampled to
   40 000 at `votenet_v1_scannet` (non-empty detections, 5 + 5 launches a
   scan on the path's variants, the ScanNet scan's K5 / K6 calls held to
   plain, walls), one SUN RGB-D scan card against CPU (phase 8's rules and
   the decoded direction and size bins exactly). (d) v1 training at
   `votenet_v1_sunrgbd` (batch 16) and `votenet_v1_scannet` (batch 8,
   40 000 points) as in (a), V1_TRAIN_STEPS timed steps, and (b)'s gate
   at `votenet_tiny` with the v1 head and `tiny_coder`. (e) K5 and K6
   timed against plain, with bound and share, on the warm-up steps' calls:
   SA1 at B = 16 N = 20 000, SA1 at B = 8 N = 40 000, the proposals' FPS
   at B = 16 over 1 024 votes.
12. ImVoteNet, f32 with cuDNN's TF32 off, on camera-consistent synthetic
   SUN RGB-D frames (`imvote_frame`: `crowded_scene` + `densify` boxes on
   a floor in front of a 640 x 480 camera at f 570, 20 000 points; GT 2D
   boxes from the projected corners, painted into the image). (a)
   `init_detector2d` at width 64, FPN 128 and `extract_bboxes_2d` on
   IMVOTE_FRAMES frames at batch 1 (at least one valid 2D detection each),
   the decode card vs CPU on the same outputs (top-k indices, keep masks,
   valid masks and classes exactly, boxes within DET2D_BOX_ATOL, scores
   within SCORE_ATOL). (b) `init_imvotenet(votenet_sunrgbd())` and
   `inference_imvotenet` on each frame with its extracted, its GT and no
   2D boxes, and on frame 0 with one small box at confidence 0.9
   (`few_vote_boxes`: fewer than FEW_SEEDS distinct votes reach the
   aggregation's K5 and K6): walls, non-empty detections with GT boxes, 5
   K5 on the cluster kernel and 5 K6 on the tiled kernel a scan, every call
   `torch.equal` to plain; frame 0 with its extracted boxes card vs CPU
   (the fusion mask, the resampled seeds and the backbone's FPS indices
   and groups exactly, the aggregation by phase 11's tie and r^2 rules,
   detections within BOX_ATOL / SCORE_ATOL). (c)
   `make_imvotenet_train_step` at batch IMVOTE_TRAIN_BATCH, with GT 2D
   boxes, then with
   `extract_bboxes_2d(train=True)`'s (half dropped, a fresh draw each
   step), each a warm-up step held to plain and IMVOTE_TRAIN_STEPS timed
   steps (phase 11's checks, every tower's vote, centre and IoU loss live,
   7 K5 and 7 K6 a step); `make_detector2d_train_step` at the same batch
   of 480 x 640 images (finite losses, non-zero conv gradients, step walls,
   peak memory). (d) The tight f32 gates card vs CPU at the CPU tests'
   sizes: the ImVoteNet step (`train_gate`, phase 11's rules) and the
   Detector2D step (`compare_det2d_train_tiny`). (e) K5 and K6 timed
   against plain, with bound and share, at the aggregation shapes (1 024
   votes -> 256, r 0.3, 16 samples): B = 1 (frame 0 with GT boxes and the
   few-vote scan) and B = 8 (the joint tower of the training warm-up).
13. The platform at `fcaf3d_scannet`'s widths and budgets, on a dataset in
   the reference's prepared ScanNet layout written to a temporary
   directory (`write_scannet_root`: PLATFORM_SCENES train and val scenes
   of phase 6's kind, float32 `.bin` clouds and info pickles). (a) The
   dataset. (b) `train_model` in bf16 at batch 8 for 2 epochs (LR x0.1
   after the first) through `tools/train.py`'s ScanNet train pipeline and
   its 10 repeats, the port's `Loader` and an eval hook on the val scenes:
   finite losses and zero overflow at every step, the log's losses and
   eval records, one checkpoint kept, `meta.json`, K1-K4 launched on phase
   5's variants, the first step's K1 calls exact and its K2 / K3 / K4
   calls held as phase 6's (`hold_recorded`); each epoch's wall, its mean
   step wall beside phase 6's bare step and the share of it the host
   waited for the loader, also over the steps after the first. (c) The
   restore round trip exactly (every variable, mu, nu, count, epoch), the
   checkpoint's bytes and save / restore ms; 1 epoch then `resume=True` to
   2: the straight run's count and last LR, finite losses, the largest
   relative difference per leaf logged (not gated: the card's scatter-add
   atomics). (d) `evaluate_dataset` through `init_detector(work_dir=)`,
   bf16: the K1-K3 calls of the first batch at batch 1 and at
   PLATFORM_EVAL_BATCH and of the three flipped forwards of a TTA batch
   held as phase 5's; then timed at both batch sizes with and without the
   4-flip TTA: K1-K3 launched on the path's variants, scenes/s and
   `indoor_eval`'s share; then f32 on the card against the plain path on
   the CPU on PLATFORM_F32_SCENES val scenes whose GT comes from the
   card's detections (`gt_from_detections`): the same detections, centres
   and yaw within BOX_ATOL, dims within BOX_DIM_RTOL of their size, scores
   within SCORE_ATOL, the same metric dict unless an IoU lies within
   IOU_TIE_ATOL of a threshold. (e) `python -m fcaf3d_tpu_torch.tools.test
   --tta --out`, `tools.pcd_demo` and `tools.train --epochs 1` as
   subprocesses on the card, exit 0 with their metric keys and files.
14. The rest of the platform's tools at full widths, on datasets in the
   reference's prepared SUN RGB-D layout written to a temporary directory
   (`write_sunrgbd_root`: 32 of phase 6's crowded scenes with yawed boxes;
   16 `imvote_frame` frames with their clouds, calibration and 2D boxes,
   the images as `.npy`, read through `tools.train_detector2d.read_image`
   pointed at them). (a) `tools.train_votenet` in process for 1 epoch of
   TOOL_STEPS steps at batch 16, head v2 then v1: finite metrics and live
   vote and centre losses at every step, the log record, 5 K5 on the
   cluster kernel and 5 K6 on the tiled kernel a step, the first step's
   calls `torch.equal` to plain, the checkpoint restored exactly; each
   step's wall beside phase 11's bare step and the loader's share. (b)
   `tools.train_detector2d` for 1 epoch of TOOL_STEPS steps at batch 8:
   finite losses, `detector2d.pkl` equal to the trained model and loaded
   by `init_detector2d(params_file=)`, whose `extract_bboxes_2d` gives the
   in-memory model's boxes. (c) `tools.train_imvotenet` with (b)'s pickle,
   then with `--gt-boxes-2d`, each 1 epoch of TOOL_STEPS steps at batch
   8: 7 K5 and 7 K6 a step on their variants, the first step's calls held
   to plain, `imvotenet.pkl` through `init_imvotenet(params_file=)` giving
   the trained model's predictions bitwise, `inference_imvotenet` on it.
   (d) The converter: the seeded variables of `fcaf3d_scannet`,
   `votenet_sunrgbd` and ImVoteNet written under the reference's names and
   layouts (`reference_state_dict`: ME-order kernels, 1x1 conv weights),
   `torch.save`d with an mmcv-style meta and converted by `python -m
   fcaf3d_tpu_torch.tools.convert_checkpoint` as subprocesses, each pickle
   equal to those variables; the converted stem conv's ME-order taps on
   the card against a dense float64 conv (the impulse); FCAF3D through
   `init_detector(params_file=)` as phase 5 runs it on two scans and one
   f32 scan card vs CPU; one VoteNet scan and one ImVoteNet frame (5 K5 +
   5 K6, held to plain). (e) `tools.fuse_conv_bn` in process on a work
   dir of the converted weights: every BatchNorm fused, count 0 and zero
   moments; the fused model's f32 detections within FUSE_ATOL of the
   unfused; bf16 inference on the path's variants; `tools.publish_model`:
   the hash-named pickle gives bitwise the fused work dir's detections.
15. Data parallelism (`fcaf3d_tpu_torch/parallel/`) at DP_WORLD gloo ranks
   sharing the card (spawned, one process a rank; gloo stages every
   collective through the host), the rank work in one spawn. (a)
   `make_train_step(group=)` at `fcaf3d_scannet` in bf16, global batch 8
   of phase 6's scenes: each rank's warm-up step with its K1 calls exact
   and K2-K4 calls held as phase 6's (`hold_recorded`), DP_TRAIN_STEPS
   timed steps and one with its collectives timed (each between
   synchronises), finite metrics, a live box loss, zero overflow, K1-K4
   on the path's variants; every rank's variables bitwise equal; step
   wall, the collectives' share of the timed step and peak memory per
   rank, beside phase 6's bare step.
   (b) The tight f32 gate at `fcaf3d_tiny`, W = DP_WORLD against one
   process on the card (`dp_tiny_gate`: losses TRAIN_LOSS_RTOL of the
   total, gradients TINY_GRAD_RTOL of a leaf's largest). (c)
   `make_votenet_train_step(group=)` at `votenet_sunrgbd` in f32, global
   batch 16 of phase 11's scenes, as phase 11 runs it
   (`held_and_timed_steps`: K5 / K6 calls of the warm-up step equal to
   plain, 5 + 5 launches a step on the path's variants), variables
   bitwise equal over the ranks, and (b)'s gate at `votenet_tiny` (its
   gradients in L2 norm: `dp_tiny_gate`). (d)
   `evaluate_dataset(group=)` of the seeded bf16 detector on a dataset of
   phase 13's kind (DP_TRAIN_SCENES train and PLATFORM_SCENES[1] val
   scenes, the val GT from the seeded detector's own detections:
   `gt_from_detections`) at global batch DP_EVAL_BATCH, with and without
   TTA: each rank's K1-K3 calls of its first forward and of the flipped
   forwards of its first TTA batch held to plain (`hold_recorded`), then
   every rank's metrics (mAP_0.25 above 0) and per-scene detections equal
   to one process's at DP_EVAL_BATCH / DP_WORLD scenes a forward. The CLI
   runs, started together as subprocesses (`run_together`): (e)
   `tools.train` for one epoch under `torchrun --nproc_per_node=1 ...
   --launcher pytorch --dist-backend nccl`, its checkpoint bitwise equal
   to the launcher-less run's; (f) the same at
   `--nproc_per_node=DP_WORLD --dist-backend gloo` on the one card,
   finishing with one checkpoint; `tools.test --sharded` at DP_WORLD gloo
   ranks on the seeded weights (`--params`), its metrics equal to (d)'s
   one process's.

Output: progress lines, then a JSON line of per-kernel results (launches
of each main path: FCAF3D inference, FCAF3D training, VoteNet inference,
the inference of each phase-9 config and SUN RGB-D training, phase
10's reference-neck and depth-50 / 101 inference and training and
`voxelize_reduce`, phase 11's VoteNet-v2 training and v1 inference
and training of both configs, phase 12's ImVoteNet inference and
training, phase 13's platform training (with its eval hook) and
evaluation, and phase 14's tool loops (VoteNet v2 / v1, ImVoteNet with
extracted and GT 2D boxes) and converted, fused and published inference,
and phase 15's data-parallel FCAF3D and VoteNet training and sharded
evaluation, summed over the ranks;
K1-K6 also by variant; the recorded shape's times, bound and share; K1 at
every distinct call of the two FCAF3D paths, K2 at every f32 path shape and
over the f32 scan, K3 at both stem pool maps, K6 at every VoteNet shape,
K2 and K4 at phase 10's rows, K5 and K6 at phase 11's training shapes
and phase 12's aggregation shapes, and phases 11-12's walls, step times,
peak memory and tiny gates under K5's entry),
the `nvidia-smi` name/power-limit line, and last `{"ok": true, ...}`.

Two further modes measure instead of checking (device and build first):

    python3 chip_smoke.py --profile         # kernel profile of a bf16
                                            # inference scan; stage split
                                            # and kernel profile of a
                                            # VoteNet scan and of the
                                            # batch-8 bf16 train step
    python3 chip_smoke.py --grad-control 3  # f32 ScanNet gradients, seeds
                                            # 0-2: card vs CPU against CPU vs
                                            # CPU with colours x (1 + 1e-6)
    python3 chip_smoke.py --nccl 4          # phase 15 over NCCL at 4 ranks,
                                            # one a card (needs 4 cards),
                                            # and (a) at 8 a rank, beside
                                            # the bare steps of phases 6
                                            # and 11
"""
import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SCAN_POINTS = 50000  # raw points per synthetic ScanNet-like scan
K2_SHAPES = ((3, 64, 27), (1, 8, 27), (64, 64, 27), (256, 512, 1),
             (512, 512, 27), (128, 128, 27))
# K2 tolerances, relative to the largest reference value: f32 differs only
# by summation order; the bf16 plain version rounds each offset chunk and
# the pre-epilogue sum to bf16, the kernel only its output
K2_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the epilogue each K2 shape has on the main path (timed)
PATH_VARIANT = {(3, 64, 27): "plain sum", (1, 8, 27): "plain sum",
                (64, 64, 27): "act=relu add=True",
                (256, 512, 1): "act=None add=False",
                (512, 512, 27): "act=relu add=True",
                (128, 128, 27): "act=relu add=True"}
# the f32 slice on the card against the CPU plain path
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-4
# K4 at every (C, E, K) of the training path, with the map that gives that
# shape its rows (neck levels: the backbone map of that stride padded to the
# neck budget, a subset of the pruned neck map)
K4_SHAPES = (
    ((3, 64, 27), "s1_k3s2"), ((64, 64, 27), "s8_k3s1"),
    ((64, 128, 27), "s8_k3s2"), ((128, 128, 27), "s16_k3s1"),
    ((128, 256, 27), "s16_k3s2"), ((256, 256, 27), "s32_k3s1"),
    ((256, 512, 27), "s32_k3s2"), ((512, 512, 27), "s64_k3s1"),
    ((64, 64, 1), "s4_k1s2"), ((64, 128, 1), "s8_k1s2"),
    ((128, 256, 1), "s16_k1s2"), ((256, 512, 1), "s32_k1s2"),
    ((64, 64, 27), "neck_s8"), ((128, 128, 27), "neck_s16"),
    ((256, 256, 27), "neck_s32"), ((64, 128, 27), "neck_s8"),
    ((128, 128, 27), "neck_s16"), ((256, 128, 27), "neck_s32"),
    ((512, 128, 27), "s64_k3s1"))
# K4 tolerance relative to the largest |dW|, both dtypes: both sides sum f32
# products of the same (bf16-exact) inputs, in another order
K4_RTOL = 1e-4
# The tensor-core K4 sums a slice's rows (`dw_slices`) in one chain of
# mma.sync steps, 16 rows a step, into f32 accumulators that the tensor
# cores add with truncation, not rounding: its distance from the exact dW
# grows with the chain, by about one f32 ulp (K4_ULP) of the accumulated
# value a step. The replay of a full-size step holds each K4 call against
# float64 within max(K4_RTOL, K4_ULP x steps) of the largest |dW|, and the
# f32 plain version within K4_RTOL; a wrong tile or offset is off by O(1).
K4_ULP = 2.0 ** -23
TRAIN_BATCH, TRAIN_STEPS = 8, 5
TRAIN_BOXES, TRAIN_BOX_POINTS, TRAIN_FLOOR_POINTS = 20, 2400, 2000
# f32 train steps on the card against the CPU plain path. At fcaf3d_tiny
# (batch 2) the gate is tight: every gradient element within 1e-3 of its
# leaf's largest |g|, as the CPU port holds to `jax.grad`. At ScanNet size
# the deep gradients at random init are chaotic in ReLU flips (on the CPU
# alone, colours x (1 + 1e-6) move whole leaves by ~1% in L2 norm:
# `--grad-control`), so that step is a loose sanity gate on each leaf's
# difference in L2 norm relative to the leaf's norm
TRAIN_LOSS_RTOL, TINY_GRAD_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-3, 5e-2
TINY_EXTENT = (0.6, 0.6, 0.3)  # scene extent that the tiny budgets hold
VOTE_SCANS = 3  # VoteNet-v2 scans at votenet_sunrgbd
VOTE_TINY_EXTENT = (2.0, 2.0, 1.4)  # a small room: the tiny radii see groups
# phase 11: timed train steps of VoteNet-v2 (batch 16) and of each v1
# config (after a held warm-up step), v1 inference scans per config
VOTE_TRAIN_STEPS, V1_TRAIN_STEPS, V1_SCANS = 3, 2, 2
# the tiny VoteNet gates card vs CPU: a proposal FPS index may flip where
# the two candidates' running minima lie within VOTE_FPS_RTOL (relative);
# the running statistics within VOTE_STATS_ATOL; a ReLU input may change
# sign only within RELU_TIE_ATOL of 0
VOTE_FPS_RTOL, VOTE_STATS_ATOL, RELU_TIE_ATOL = 1e-5, 1e-5, 1e-4
# the f32 VoteNet slice card vs CPU: aggregation-group members may flip
# within AGG_D2_TOL of r^2 (its centres are an MLP output); detections of
# proposals with equal groups within BOX_ATOL / SCORE_ATOL
AGG_D2_TOL = 1e-4
# phase 12: ImVoteNet at votenet_sunrgbd and its Detector2D (width 64, FPN
# 128) on 480 x 640 frames (`tools/train_imvotenet.py:27`): IMVOTE_FRAMES
# inference frames, each with its extracted, its GT and no 2D boxes; the
# training batch (`tools/train_imvotenet.py:38`) with at most
# IMVOTE_MAX_DET 2D boxes a frame (its `--max-det2d`), timed steps after
# each held warm-up step; the 2D decode card vs CPU within DET2D_BOX_ATOL;
# the few-vote scan's aggregation holds fewer than FEW_SEEDS distinct votes
IMVOTE_FRAMES, IMVOTE_TRAIN_BATCH, IMVOTE_MAX_DET = 3, 8, 32
IMVOTE_HW, IMVOTE_FOCAL = (480, 640), 570.0
DET2D_WIDTH, DET2D_FPN = 64, 128
IMVOTE_TRAIN_STEPS, DET2D_TRAIN_STEPS = 2, 2
DET2D_BOX_ATOL, FEW_SEEDS = 1e-3, 256
DET2D_TINY = {"n_classes": 4, "width": 16, "fpn_ch": 32}  # the CPU tests'
# phase 13: the platform on a ScanNet-layout dataset of (train, val) scenes
# of phase 6's kind; evaluation at batch 1 and PLATFORM_EVAL_BATCH; the f32
# card-vs-CPU evaluation on the first PLATFORM_F32_SCENES val scenes, a
# difference in mAP allowed only where an IoU lies within IOU_TIE_ATOL of a
# threshold
PLATFORM_SCENES = (16, 4)
PLATFORM_EVAL_BATCH, PLATFORM_F32_SCENES = 4, 2
IOU_TIE_ATOL = 1e-4
# and the boxes' dims within BOX_DIM_RTOL of their size (centres and yaw
# within BOX_ATOL, as elsewhere)
BOX_DIM_RTOL = 1e-3
# `indoor_eval`'s floor under an IoU's union (m^3): a GT box made from a
# detection at least this large has its true IoU with that detection
GT_MIN_VOLUME = 1e-8
# phase 14: the platform's other tools at full widths: each train loop runs
# 1 epoch of TOOL_STEPS steps (VoteNet at batch 16, Detector2D and ImVoteNet
# at IMVOTE_TRAIN_BATCH); the fused model's f32 detections within FUSE_ATOL
# of the unfused model's (the JAX package's fuse test's tolerance)
TOOL_STEPS = 2
FUSE_ATOL = 1e-4
# phase 15: data parallelism at DP_WORLD gloo ranks on the one card; FCAF3D's
# DP_TRAIN_STEPS timed steps after a held warm-up step; the ScanNet-layout
# root of phase 13's kind with DP_TRAIN_SCENES train scenes (x 10 repeats:
# 2 steps of the CLI's epoch at batch 8) and PLATFORM_SCENES[1] val scenes,
# evaluated at global batch DP_EVAL_BATCH
DP_WORLD, DP_TRAIN_STEPS, DP_TRAIN_SCENES, DP_EVAL_BATCH = 2, 3, 2, 4
# published dense peaks of one H100 SXM: a kernel's bound is the larger of
# its operations over the peak of their type (bf16 on the tensor cores;
# float32 and integer work on the CUDA cores) and its bytes over the memory
# rate
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
SLEEP_CYCLES = 20_000_000  # ~10 ms of device clock ahead of timed launches
# a sleep ahead of each timed FPS / ball query in a VoteNet scan, longer
# than the host's enqueue of one call
TURN_SLEEP_CYCLES = 1_000_000
FPS_OPS = 9  # per K5 distance update: 3 sub, 3 mul, 2 add, 1 min
FPS_SWEEP = (2, 4, 8, 16)  # K5 cluster sizes tried at SA1
K1_EDGE_RUN = 7  # K1 gallop rows a thread on the edge clouds
K1_EDGE_LINE = 16  # K1 edge clouds' L: N < L, N = 1 mod L, runs across L
FPS_TIE_S = 64  # samples of the K5 tie clouds at the plan's boundaries
BALLQ_OPS = 9  # per K6 point scanned: 3 sub, 3 mul, 2 add, 1 compare
# (what, kernel ms, SIMT ms, plain ms) of every bf16 K2/K4 path shape where
# the tensor-core kernel is not faster than its plain version and the SIMT
# one: printed at the end, for PERF.md
NOT_FASTER = []
# the other FCAF3D configs of phase 9: bf16 inference scans of each after
# a warm-up scan, and SUN RGB-D's timed batch-8 train steps
OTHER_CONFIGS = ("fcaf3d_scannet_3scales", "fcaf3d_scannet_2scales",
                 "fcaf3d_s3dis", "fcaf3d_sunrgbd")
OTHER_SCANS, SUN_TRAIN_STEPS = 2, 3
NMS_REPS = 5  # timed calls of the rotated and the axis-aligned BEV NMS
# phase 10: bf16 scans of the reference neck and of depth 50 / 101 after a
# warm-up scan, the reference neck's and depth 50's timed batch-8 steps
# (depth 101: one, for its time and peak memory), reference-neck walls in
# turns with the prune-early neck (REST_TURNS passes over the scans)
REST_SCANS, REST_TRAIN_STEPS, REST_TURNS = 2, 3, 2
DEEP_TRAIN_STEPS = {50: 2, 101: 1}
# a row kept on one side of an f32 card-vs-CPU prune and not on the other
# is allowed only where its score lies this close (relative) to the
# budget-th score
PRUNE_RTOL = 1e-5
VOXEL_REDUCE_ATOL = 1e-6  # voxelize_reduce features, card vs CPU
# K2 (batch 1) and K4 (batch 8) rows timed at phase 10's new shapes, by
# (M, K, C, E): the reference neck's up-block conv3 on the 8P children of
# each level, and depth 50's widest neck conv3, out block and downsample
REFERENCE_ROWS = ((8192, 27, 256, 256), (49152, 27, 128, 128),
                  (131072, 27, 64, 64))
DEEP_ROWS = ((6144, 27, 1024, 1024), (1024, 27, 2048, 128),
             (1024, 1, 1024, 2048))
# which kernels each main path runs
INFERENCE_KERNELS = ("searchsorted", "gather_gemm", "gather_max")
TRAINING_KERNELS = INFERENCE_KERNELS + ("gather_dw",)
PATH_KERNELS = {
    "fcaf3d_inference": INFERENCE_KERNELS,
    "fcaf3d_training": TRAINING_KERNELS,
    "votenet_inference": ("fps", "ball_query"),
    **{f"{name}_inference": INFERENCE_KERNELS for name in OTHER_CONFIGS},
    "fcaf3d_sunrgbd_training": TRAINING_KERNELS,
    "fcaf3d_reference_inference": INFERENCE_KERNELS,
    "fcaf3d_reference_training": TRAINING_KERNELS,
    "fcaf3d_depth50_inference": INFERENCE_KERNELS,
    "fcaf3d_depth101_inference": INFERENCE_KERNELS,
    "fcaf3d_depth50_training": TRAINING_KERNELS,
    "fcaf3d_depth101_training": TRAINING_KERNELS,
    "voxelize_reduce": ("searchsorted",),
    "votenet_training": ("fps", "ball_query"),
    "votenet_v1_sunrgbd_inference": ("fps", "ball_query"),
    "votenet_v1_scannet_inference": ("fps", "ball_query"),
    "votenet_v1_sunrgbd_training": ("fps", "ball_query"),
    "votenet_v1_scannet_training": ("fps", "ball_query"),
    "imvotenet_inference": ("fps", "ball_query"),
    "imvotenet_training": ("fps", "ball_query"),
    "fcaf3d_platform_training": TRAINING_KERNELS,
    "fcaf3d_platform_eval": INFERENCE_KERNELS,
    "votenet_tool_training": ("fps", "ball_query"),
    "votenet_v1_tool_training": ("fps", "ball_query"),
    "imvotenet_tool_training_detector2d": ("fps", "ball_query"),
    "imvotenet_tool_training_gt": ("fps", "ball_query"),
    "converted_fcaf3d_inference": INFERENCE_KERNELS,
    "converted_votenet_inference": ("fps", "ball_query"),
    "converted_imvotenet_inference": ("fps", "ball_query"),
    "fused_fcaf3d_inference": INFERENCE_KERNELS,
    "fcaf3d_dp_training": TRAINING_KERNELS,
    "votenet_dp_training": ("fps", "ball_query"),
    "fcaf3d_dp_eval": INFERENCE_KERNELS,
}


_T0 = time.perf_counter()


def log(msg):
    """Print a progress line; phase headers ("== ...") carry the seconds
    since the script started."""
    if msg.startswith("== "):
        msg = f"{msg} [{time.perf_counter() - _T0:.1f} s]"
    print(msg, flush=True)


def device_phase(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"== 1 device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_phase():
    from fcaf3d_tpu_torch import _native

    t0 = time.perf_counter()
    path, build_log = _native.build()
    dt = time.perf_counter() - t0
    _native.load()
    log(f"== 2 build: {dt:.2f} s -> {os.path.relpath(path, REPO)}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"   ptxas: {line.strip()}")


def scan(seed):
    """One synthetic ScanNet-like scan [SCAN_POINTS, 6] (xyz + rgb)."""
    from fcaf3d_tpu_torch.data.synth import synth_scene

    xyz, rgb = synth_scene(np.random.RandomState(seed), SCAN_POINTS)
    return np.concatenate([xyz, rgb], axis=1)


def sample(points, cfg, seed=0):
    """One scan's points sampled to `cfg.num_points` as `inference_detector`
    samples them."""
    rng = np.random.default_rng(seed)
    return points[rng.choice(len(points), cfg.num_points,
                             replace=len(points) < cfg.num_points)]


def backbone_maps(clouds, cfg, device):
    """The voxel keys and every kernel map the backbone builds for a batch
    of sampled clouds [B, N, 6] (xyz + rgb). The maps depend only on
    coordinates, so this replays `MEResNet3D`'s map construction."""
    import torch

    from fcaf3d_tpu_torch.ops.sparse import (
        SparseTensor, build_kernel_map, build_kernel_map_self, conv_plan,
        downsample_coords, kernel_offsets, voxelize)

    p = torch.as_tensor(clouds[..., :3].astype(np.float32), device=device)
    c = torch.as_tensor(clouds[..., 3:6].astype(np.float32), device=device)
    valid = torch.ones(p.shape[:2], dtype=torch.bool, device=device)
    st = voxelize(p, c, valid, cfg.voxel_size, cfg.input_budget)
    maps = {"voxel_keys": (st.keys, None)}

    def coords_only(coords, keys, stride, shift):
        empty = torch.empty(coords.shape[:2] + (0,), device=device)
        return SparseTensor(coords=coords, feats=empty, keys=keys,
                            shift=shift, stride=stride)

    b2, b4, *stage_budgets = cfg.backbone_budgets
    oc, ok, idx, _ = conv_plan(st, 3, 2, b2)
    maps["s1_k3s2"] = (idx, st.capacity)
    x = coords_only(oc, ok, 2, st.shift)
    oc, ok, _ = downsample_coords(x, 2, b4)
    maps["s2_pool_k2s2"] = (build_kernel_map(x.keys, oc,
                                             kernel_offsets(2, 2)), x.capacity)
    x = coords_only(oc, ok, 4, st.shift)
    for budget in stage_budgets[:cfg.n_outs]:
        s = x.stride
        oc, ok, idx, _ = conv_plan(x, 3, 2, budget)
        maps[f"s{s}_k3s2"] = (idx, x.capacity)
        maps[f"s{s}_k1s2"] = (build_kernel_map(x.keys, oc,
                                               kernel_offsets(1, s)),
                              x.capacity)
        maps[f"s{2 * s}_k3s1"] = (build_kernel_map_self(ok, oc, 2 * s),
                                  oc.shape[1])
        maps[f"s{2 * s}_keys"] = (ok, None)
        x = coords_only(oc, ok, 2 * s, st.shift)
    return maps


def neck_maps(torch, maps, cfg):
    """Self maps at the neck levels' shapes: the backbone keys of stride s
    (which the pruned neck map always keeps) padded to the neck budget."""
    from fcaf3d_tpu_torch.ops.sparse import (
        SENTINEL, build_kernel_map_self, decode_coords)

    out = {}
    for s, budget in zip((8, 16, 32), cfg.neck_budgets):
        keys = maps[f"s{s}_keys"][0]
        pad = torch.full((keys.shape[0], budget - keys.shape[1]), SENTINEL,
                         dtype=keys.dtype, device=keys.device)
        keys = torch.cat([keys, pad], dim=1)
        out[f"neck_s{s}"] = (build_kernel_map_self(keys, decode_coords(keys),
                                                   s), budget)
    return out


def cuda_ms(torch, fn, reps=10):
    """Mean device time of `fn` over `reps` launches (CUDA events), after
    one warm-up. A sleep kernel ahead of the timed launches holds the device
    while the host enqueues them, so that the time is the device's and not
    the host's enqueue rate (which sets the pace of back-to-back calls at
    shapes near launch latency), as long as the enqueue fits in the sleep."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_us(torch, fn, reps=50):
    """Host microseconds that a call of `fn` takes to return (its enqueue),
    after one warm-up, while a sleep kernel holds the device so that no call
    waits for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def host_turns(torch, fns, reps=50):
    """`enqueue_us` of each of `fns` (name -> callable), in turns as
    `timed_turns` takes them. Returns name -> (mean, first, second)."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        times[name].append(enqueue_us(torch, fns[name], reps))
    return {name: (sum(t) / len(t), t[0], t[1]) for name, t in times.items()}


def timed_turns(torch, fns, reps=10):
    """Device ms of each of `fns` (name -> callable), timed in turns: in
    order, then in reverse order (plain, kernel, ..., kernel, plain). Returns
    name -> (mean, first reading, second reading)."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        times[name].append(cuda_ms(torch, fns[name], reps))
    return {name: (sum(t) / len(t), t[0], t[1]) for name, t in times.items()}


def count_hits(idx, n):
    """Hits (entries < N) of a kernel map [B, M, K], per offset."""
    return [int(v) for v in (idx < n).sum(dim=(0, 1)).tolist()]


def gemm_work(idx, n, c, e, elt, epilogue=False, add=False,
              weight_grad=False):
    """(operations, bytes) of K2 on a map [B, M, K] over N input rows, or of
    K4 with `weight_grad`: 2 * hits * C * E FLOPs, and each input read once
    and each output written once: feats [B, N, C] and the map, then for K2
    W [K, C, E], the epilogue's scale, shift and vmask, `add` [B, M, E] and
    out [B, M, E] (elt bytes an element), for K4 dout [B, M, E] and dW
    [K, C, E] in float32."""
    b, m, k = idx.shape
    flops = 2 * sum(count_hits(idx, n)) * c * e
    nbytes = b * n * c * elt + b * m * k * 4
    if weight_grad:
        return flops, nbytes + b * m * e * elt + k * c * e * 4
    nbytes += k * c * e * elt + b * m * e * elt
    if epilogue:
        nbytes += 2 * e * 4 + b * m
    if add:
        nbytes += b * m * e * elt
    return flops, nbytes


def bound(ops, nbytes, peak):
    """(bound_ms, what bounds it): the larger of `ops` over `peak` and
    `nbytes` over the memory rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timing_record(times, work, peak):
    """The kernel's timing record: its ms, the yardsticks' ms, its bound
    and share of the bound, from `timed_turns` output and (ops, bytes)."""
    bound_ms, by = bound(*work, peak)
    rec = {"ms": times["kernel"][0], "bound_ms": bound_ms, "bound_by": by,
           "share": bound_ms / times["kernel"][0],
           "library_ms": times["library"][0] if "library" in times else None}
    for name in ("plain", "simt", "gemm_only", "earlier"):
        if name in times:
            rec[f"{name}_ms"] = times[name][0]
    if "floor" in times:
        rec["serial_floor_ms"] = times["floor"][0]
        rec["serial_share"] = times["floor"][0] / times["kernel"][0]
    return rec


def report(rec):
    """One log fragment of a timing record."""
    out = f"kernel {rec['ms']:.4f} ms"
    for name in ("earlier", "simt", "plain", "library", "gemm_only"):
        if rec.get(f"{name}_ms") is not None:
            out += f", {name} {rec[f'{name}_ms']:.4f}"
    if "gemm_only_ms" in rec:
        out += " (gemm_only: one matmul on the pre-gathered rows, not the " \
               "same function)"
    out += (f"; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
            f"share {rec['share']:.3f}")
    if "serial_floor_ms" in rec:
        out += (f"; serial floor {rec['serial_floor_ms']:.4f} ms, share "
                f"{rec['serial_share']:.3f}")
    return out


def tc_yardsticks(what, rec):
    """Record `what` in NOT_FASTER when a tensor-core kernel's time is not
    below its plain version's and the SIMT kernel's."""
    if rec["ms"] >= min(rec["plain_ms"], rec["simt_ms"]):
        NOT_FASTER.append((what, rec["ms"], rec["simt_ms"], rec["plain_ms"]))
        log(f"   NOT FASTER: {what}")


def k1_case(torch, name, kk, qq, miss, shapes=None, time_plain=True):
    """K1 (the gallop kernel) exactly equal to its plain version and to the
    earlier binary-search kernel on keys `kk` [B, N] and queries `qq`, timed in
    turns with the earlier kernel, the plain version unless `time_plain` is
    false and, for positions, `torch.searchsorted(out_int32=True)`
    (checked equal too). Returns the timing record (with the plan); adds it
    to `shapes` under `name`."""
    from fcaf3d_tpu_torch.ops.sparse import search

    got = search.searchsorted_segments(kk, qq, with_miss=miss, layout="ms")
    want = search.searchsorted_segments_plain(kk, qq, with_miss=miss)
    old = search.searchsorted_segments(kk, qq, with_miss=miss, layout="ms",
                                       _variant="binary")
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not (torch.equal(got, want) and torch.equal(old, want)):
        raise AssertionError(f"K1 {name}: kernel != plain (max abs diff "
                             f"{err}) or the earlier kernel != plain")
    fns = {"kernel": lambda: search.searchsorted_segments(
               kk, qq, with_miss=miss, layout="ms"),
           "earlier": lambda: search.searchsorted_segments(
               kk, qq, with_miss=miss, layout="ms", _variant="binary")}
    if time_plain:
        fns["plain"] = lambda: search.searchsorted_segments_plain(
            kk, qq, with_miss=miss)
    flat = qq.reshape(qq.shape[0], -1)
    if not miss:  # the positions alone: one library call computes them
        lib = torch.searchsorted(kk, flat, out_int32=True)
        if not torch.equal(lib.reshape(got.shape), got):
            raise AssertionError(f"K1 {name}: torch.searchsorted != K1")
        fns["library"] = lambda: torch.searchsorted(kk, flat, out_int32=True)
    times = timed_turns(torch, fns)
    # bytes: keys, queries (int64) and out (int32); operations: one
    # compare per step of a binary search, on the CUDA cores
    q_n, n_keys = flat.numel(), kk.numel()
    steps = int(np.ceil(np.log2(kk.shape[1] + 1)))
    r = timing_record(times, (q_n * steps, 8 * n_keys + 12 * q_n),
                      PEAK_OPS["float32"])
    r["max_abs_err"] = err
    b = kk.shape[0]
    m, s = (qq.shape[1], qq.shape[2]) if qq.dim() == 3 else (q_n // b, 1)
    r["plan"] = search.k1_gallop_plan(b, m, s)
    r["shape"] = [list(kk.shape), list(qq.shape), miss]
    spread = ", ".join(f"{k} {v[1]:.4f}/{v[2]:.4f}" for k, v in times.items())
    log(f"   K1 {name} {tuple(qq.shape)} in N={kk.shape[1]}"
        f"{', with_miss' if miss else ''}: exact (and the earlier kernel); "
        f"{r['plan']} rows a thread; {report(r)}; readings {spread}")
    if r["ms"] >= min(r["earlier_ms"], r.get("library_ms") or np.inf):
        NOT_FASTER.append((f"K1 {name}", r["ms"], r["earlier_ms"],
                           r.get("library_ms")))
        log(f"   NOT FASTER: K1 {name}")
    if shapes is not None:
        shapes[name] = {k: r.get(k) for k in (
            "shape", "plan", "ms", "earlier_ms", "plain_ms", "library_ms",
            "bound_ms", "share")}
    return r


def k1_edge_keys(line, rng):
    """(name, keys [2, N] int64) of K1's edge clouds for a line of `line`
    keys: N = 1, N < L, N = 1 mod L, runs of equal keys across every L-th
    key, a compaction cumsum with a long flat run and a flat tail."""
    sent = 0xFFFFFFFF
    n = 8 * line + 3
    mask = rng.random((2, 10 * line + 7)) < 0.3
    mask[:, 4 * line:6 * line] = False
    mask[:, -3 * line:] = False
    return [
        ("N = 1", np.array([[5], [sent]])),
        ("N < L", np.sort(rng.integers(1, 50, (2, line // 2 + 1)), axis=1)),
        ("N = 1 mod L", np.sort(rng.integers(1, 2 ** 20, (2, 3 * line + 1)),
                                axis=1)),
        ("runs across every L-th key", np.stack([
            (np.arange(n) + line // 2) // line + 1,
            (np.arange(n) + 5) // (3 * line) * 7 + 2])),
        ("compaction cumsum", np.cumsum(mask, axis=1)),
    ]


def k1_edge_queries(keys, rng, m=512):
    """[B, m, 3] queries on `keys`: the keys themselves and their
    neighbours, values below the first and above the last key, SENTINEL."""
    sent = 0xFFFFFFFF
    b, n = keys.shape
    pick = rng.integers(0, n, (b, m))
    q = rng.integers(0, sent, (b, m, 3)).astype(np.int64)
    q[:, :, 0] = np.take_along_axis(keys, pick, 1)
    q[:, :, 1] = q[:, :, 0] + rng.integers(-1, 2, (b, m))
    q[:, :3, 2] = [0, sent - 1, sent]
    q[:, -5:, :] = sent
    return np.clip(q, 0, sent)


def k1_phase(torch, cfg, maps):
    """K1 at the s8 self-map lookup (with_miss and positions) and the voxel
    compaction (`k1_case`); both variants on the edge clouds (random-order
    and all-SENTINEL queries), exactly equal to plain. Returns the s8
    positions record."""
    from fcaf3d_tpu_torch.ops.sparse import (
        SENTINEL, decode_coords, encode_coords, kernel_offsets)
    from fcaf3d_tpu_torch.ops.sparse import search

    dev = maps["voxel_keys"][0].device
    s8_keys = maps["s8_keys"][0]
    q = encode_coords(decode_coords(s8_keys)[:, :, None, :] + torch.as_tensor(
        kernel_offsets(3, 8), device=dev)).contiguous()
    # compaction: source row of the j-th valid voxel, as compact_positions
    csum = torch.cumsum((maps["voxel_keys"][0] != SENTINEL).int(), dim=1)
    csum = csum.long().contiguous()
    qc = torch.arange(1, cfg.backbone_budgets[0] + 1, device=dev)
    qc = qc[None, :, None].contiguous()
    shapes = {}
    k1_case(torch, "s8 self-map lookup", s8_keys, q, True, shapes)
    rec = k1_case(torch, "s8 self-map lookup, positions", s8_keys, q, False,
                  shapes)
    k1_case(torch, "voxel keys compaction", csum, qc, False, shapes)
    rec["shapes"] = shapes

    rng = np.random.default_rng(0)
    n_edge = 0
    for name, keys in k1_edge_keys(K1_EDGE_LINE, rng):
        kk = torch.as_tensor(keys.astype(np.int64), device=dev)
        for qq in (k1_edge_queries(keys, rng),
                   np.full((2, 64, 1), SENTINEL, np.int64)):
            qq = torch.as_tensor(qq, device=dev)
            for variant, plan in (("gallop", None), ("gallop", K1_EDGE_RUN),
                                  ("binary", None)):
                for miss in (False, True):
                    got = search.searchsorted_segments(
                        kk, qq, with_miss=miss, layout="ms",
                        _variant=variant, _plan=plan)
                    want = search.searchsorted_segments_plain(kk, qq, miss)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"K1 {variant} ({plan} rows a thread) edge "
                            f"{name}, L={K1_EDGE_LINE}, with_miss={miss}: "
                            "!= plain")
                    n_edge += 1
    log(f"   K1 edge clouds (N = 1, N < L, N = 1 mod L, runs across every "
        f"L-th key, a compaction cumsum; random-order and all-SENTINEL "
        f"queries) at L = {K1_EDGE_LINE}, gallop at the plan's and at "
        f"{K1_EDGE_RUN} rows a thread, binary: {n_edge} cases exact")
    return rec


def kernel_phase(torch, cfg, maps, maps8):
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    dev = maps["voxel_keys"][0].device
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}

    rec["searchsorted"] = k1_phase(torch, cfg, maps)
    # K2 at every (C, E, K) of the path, on that shape's real map
    map_for = {(3, 64, 27): "s1_k3s2", (1, 8, 27): "s16_k3s1",
               (64, 64, 27): "s8_k3s1", (256, 512, 1): "s32_k1s2",
               (512, 512, 27): "s64_k3s1", (128, 128, 27): "s16_k3s1"}
    k2_err = {"float32": 0.0, "bfloat16": 0.0}
    f32_shapes = {}
    for (c, e, k) in K2_SHAPES:
        idx, n = maps[map_for[(c, e, k)]]
        b, m, _ = idx.shape
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            feats = torch.randn(b, n, c, generator=gen, device=dev).to(dt)
            w = (torch.randn(k, c, e, generator=gen, device=dev)
                 / np.sqrt(k * c)).to(dt)
            scale = torch.rand(e, generator=gen, device=dev) + 0.5
            shift = torch.randn(e, generator=gen, device=dev) * 0.1
            add = torch.randn(b, m, e, generator=gen, device=dev).to(dt)
            vmask = torch.rand(b, m, generator=gen, device=dev) < 0.9
            variants = [("plain sum", {})]
            for act in (None, "relu", "elu"):
                for with_add in (False, True):
                    variants.append((f"act={act} add={with_add}", dict(
                        scale=scale, shift=shift, act=act, vmask=vmask,
                        add=add if with_add else None)))
            for vname, kw in variants:
                got = gk.fused_gather_gemm(feats, idx, w, **kw)
                want = gk.fused_gather_gemm_plain(feats, idx, w, **kw)
                torch.cuda.synchronize()
                ref = want.float()
                diff = float((got.float() - ref).abs().max())
                tol = K2_RTOL[dname] * max(float(ref.abs().max()), 1.0)
                if not (diff <= tol and torch.isfinite(got).all()):
                    raise AssertionError(
                        f"K2 C={c} E={e} K={k} {dname} {vname}: max abs "
                        f"diff {diff} > {tol}")
                if dname == "float32":
                    k2_equal_simt(torch, got, feats, idx, w, kw,
                                  f"C={c} E={e} K={k} {vname}")
                k2_err[dname] = max(k2_err[dname], diff)
            kw = dict(variants)[PATH_VARIANT[(c, e, k)]]
            r = k2_timing(torch, feats, idx, w, kw, dname)
            log(f"   K2 C={c} E={e} K={k} {dname} idx {tuple(idx.shape)} "
                f"N={n}: {len(variants)} variants ok (max abs diff so far "
                f"{k2_err[dname]:.3g}); {r['variant']}: {report(r)}")
            if dname == "bfloat16":
                tc_yardsticks(f"K2 C={c} E={e} K={k} "
                              f"{PATH_VARIANT[(c, e, k)]}", r)
            if dname == "float32":
                f32_shapes[f"C{c} E{e} K{k}"] = {key: r[key] for key in (
                    "variant", "tile", "ms", "earlier_ms", "plain_ms",
                    "gemm_only_ms", "bound_ms", "bound_by", "share")}
                if not r["ms"] < min(r["earlier_ms"], r["plain_ms"]):
                    NOT_FASTER.append((f"K2 f32 C={c} E={e} K={k}", r["ms"],
                                       r["earlier_ms"], r["plain_ms"]))
                    log(f"   NOT FASTER than the earlier kernel and plain: K2 "
                        f"f32 C={c} E={e} K={k}")
            if (c, e, k, dname) == (64, 64, 27, "bfloat16"):
                rec["gather_gemm"] = r
    rec["gather_gemm"]["max_abs_err"] = k2_err["bfloat16"]
    rec["gather_gemm"]["max_abs_err_f32"] = k2_err["float32"]
    rec["gather_gemm"]["f32_shapes"] = f32_shapes
    k2_off_granule(torch, maps, gen)

    rec["gather_max"] = k3_phase(torch, maps, maps8, gen)
    return rec


def k3_phase(torch, maps, maps8, gen):
    """K3 (the vector kernel) exactly equal (`torch.equal`) to its plain
    version and to the first kernel (`_variant="scalar"`) on the stem pool
    map at batch 1 and batch 8, in f32 and bf16, timed in turns beside both;
    then on edge cases: C off the 16-byte vector, all-miss rows and ties.
    Returns the batch-1 bf16 record with every shape's times."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    def exact(feats, idx, what):
        got = gk.fused_gather_max(feats, idx)
        want = gk.fused_gather_max_plain(feats, idx)
        old = gk.fused_gather_max(feats, idx, _variant="scalar")
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not (torch.equal(got, want) and torch.equal(old, want)):
            raise AssertionError(f"K3 {what}: kernel != plain (max abs diff "
                                 f"{err}) or the first kernel != plain")
        return err

    k3_err, shapes, rec = 0.0, {}, None
    for batch, (idx, n) in ((1, maps["s2_pool_k2s2"]),
                            (TRAIN_BATCH, maps8["s2_pool_k2s2"])):
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            feats = torch.randn(idx.shape[0], n, 64, generator=gen,
                                device=idx.device).to(dt)
            k3_err = max(k3_err, exact(feats, idx, f"B={batch} {dname}"))
            r = k3_timing(torch, feats, idx)
            log(f"   K3 {dname} idx {tuple(idx.shape)} N={n} C=64: exact (and "
                f"the first kernel); {r['variant']}: {report(r)}")
            shapes[f"B{batch} {dname}"] = {key: r[key] for key in (
                "variant", "ms", "earlier_ms", "plain_ms", "bound_ms",
                "bound_by", "share")}
            if r["ms"] >= r["earlier_ms"]:
                NOT_FASTER.append((f"K3 B={batch} {dname}", r["ms"],
                                   r["earlier_ms"], r["plain_ms"]))
                log(f"   NOT FASTER than the first kernel: K3 B={batch} "
                    f"{dname}")
            if (batch, dname) == (1, "bfloat16"):
                rec = r
    # edge cases on the batch-1 map: C off the 16-byte vector (every narrower
    # vector width), all-miss rows, ties (few distinct values), and K = 27
    idx, n = maps["s2_pool_k2s2"]
    idx27, n27 = maps["s1_k3s2"]
    cases = 0
    for dname, channels in (("float32", (1, 3, 6, 10, 64)),
                            ("bfloat16", (1, 3, 12, 20, 68))):
        dt = getattr(torch, dname)
        for c in channels:
            for kidx, kn in ((idx, n), (idx27, n27)):
                miss = kidx.clone()
                miss[:, ::7] = kn  # every 7th row: all miss
                ties = torch.randint(-2, 3, (1, kn, c), generator=gen,
                                     device=idx.device).to(dt)
                k3_err = max(k3_err, exact(ties, miss, f"{dname} C={c} K="
                                           f"{kidx.shape[2]} edge"))
                cases += 1
    log(f"   K3 edge cases exact (and the first kernel): {cases} (C off the "
        "16-byte vector, every 7th row all miss, values in -2..2, K 8 and 27)")
    rec["max_abs_err"] = k3_err
    rec["shapes"] = shapes
    return rec


def k3_timing(torch, feats, idx):
    """K3 timed in turns with its plain version and the first kernel, with
    its bound (bytes: feats, the map and out; operations: one max per
    gathered element, on the CUDA cores) and its variant."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    times = timed_turns(torch, {
        "plain": lambda: gk.fused_gather_max_plain(feats, idx),
        "kernel": lambda: gk.fused_gather_max(feats, idx),
        "earlier": lambda: gk.fused_gather_max(feats, idx,
                                               _variant="scalar")})
    b, m, k = idx.shape
    n, c = feats.shape[1:]
    elt = feats.element_size()
    r = timing_record(times, (b * m * k * c, b * n * c * elt + b * m * k * 4
                              + b * m * c * elt), PEAK_OPS["float32"])
    r["variant"] = gk.k3_plan(c, k, feats.dtype).variant
    return r


def k2_equal_simt(torch, got, feats, idx, w, kw, what):
    """`got` (K2 as the path runs it) equal to the earlier kernel on the same
    inputs: the f32 kernels keep its arithmetic."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    old = gk.fused_gather_gemm(feats, idx, w, **kw, _variant="simt")
    torch.cuda.synchronize()
    if not torch.equal(got, old):
        diff = float((got.float() - old.float()).abs().max())
        k, c, e = w.shape
        raise AssertionError(f"K2 {feats.dtype} {what}: "
                             f"{gk.k2_variant(c, e, k, feats.dtype)} != the "
                             f"earlier kernel (max abs diff {diff})")


def k2_off_granule(torch, maps, gen):
    """K2 at shapes off the path's: bf16 where the tensor-core kernels do
    not take it (E or C off the 8-channel granule), on the narrow and tiled
    kernels, and the same shapes in f32 (C and E off 16 and 64, partial
    channel groups, C and E off the 4-channel granule of 16-byte copies):
    equal to the earlier kernel, within K2_RTOL of plain, three epilogues
    each."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    # (18, 30): f32 off 16-byte copies, staged 4 bytes at a time
    cases = ((3, 18, "s1_k3s2"), (5, 20, "s16_k3s1"), (20, 64, "s8_k3s1"),
             (64, 36, "s16_k3s1"), (18, 30, "s16_k3s1"))
    for c, e, name in cases:
        idx, n = maps[name]
        b, m, k = idx.shape
        dev = idx.device
        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            feats = torch.randn(b, n, c, generator=gen, device=dev).to(dt)
            w = (torch.randn(k, c, e, generator=gen, device=dev)
                 / np.sqrt(k * c)).to(dt)
            epi = dict(scale=torch.rand(e, generator=gen, device=dev) + 0.5,
                       shift=torch.randn(e, generator=gen, device=dev) * 0.1,
                       vmask=torch.rand(b, m, generator=gen, device=dev) < 0.9)
            add = torch.randn(b, m, e, generator=gen, device=dev).to(dt)
            variant = gk.k2_variant(c, e, k, dt)
            if not variant.startswith("simt_"):
                raise AssertionError(f"K2 {dname} C={c} E={e}: variant "
                                     f"{variant}")
            for kw in ({}, dict(epi, act="relu", add=add),
                       dict(epi, act="elu")):
                got = gk.fused_gather_gemm(feats, idx, w, **kw)
                want = gk.fused_gather_gemm_plain(feats, idx, w, **kw).float()
                torch.cuda.synchronize()
                diff = float((got.float() - want).abs().max())
                if not diff <= K2_RTOL[dname] * max(float(want.abs().max()),
                                                    1.0):
                    raise AssertionError(f"K2 {dname} C={c} E={e} {variant}:"
                                         f" max abs diff {diff}")
                k2_equal_simt(torch, got, feats, idx, w, kw, f"C={c} E={e}")
            log(f"   K2 {dname} off the path C={c} E={e} K={k} idx "
                f"{tuple(idx.shape)}: {variant}, 3 epilogues equal to the "
                "earlier kernel and within tolerance of plain")


def k2_timing(torch, feats, idx, w, kw, dname):
    """K2 timed in turns with its plain version, one matmul on the
    pre-gathered rows and the earlier kernel ("earlier" in f32, the f32
    variants' predecessor; "simt" in bf16, the tensor cores'); with its
    bound."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    b, n, c = feats.shape
    m, k = idx.shape[1:]
    e = w.shape[2]
    fns = {"plain": lambda: gk.fused_gather_gemm_plain(feats, idx, w, **kw),
           "kernel": lambda: gk.fused_gather_gemm(feats, idx, w, **kw)}
    variant = gk.k2_variant(c, e, k, feats.dtype)
    g = gk.gather_rows(feats, idx).reshape(b, m, k * c)
    w2 = w.reshape(k * c, e)
    fns["gemm_only"] = lambda: torch.matmul(g, w2)
    fns["simt" if dname == "bfloat16" else "earlier"] = (
        lambda: gk.fused_gather_gemm(feats, idx, w, **kw, _variant="simt"))
    times = timed_turns(torch, fns)
    work = gemm_work(idx, n, c, e, feats.element_size(),
                     epilogue="scale" in kw, add=kw.get("add") is not None)
    rec = timing_record(times, work, PEAK_OPS[dname])
    rec["variant"] = variant
    if variant != "simt":
        rec["tile"] = list(gk.k2_tiles(variant, b, m, e, k))
    return rec


def compare_f32(torch, cfg, points, device, params_file=None):
    """One scan in f32: the card against the plain path on the CPU (voxel
    keys and backbone maps exactly; with the reference neck its child maps
    exactly and its pruned maps by `check_reference_neck`; every BEV NMS
    keep mask exactly, detections within BOX_ATOL / SCORE_ATOL), every f32
    K2 launch on the narrow and tiled kernels and every K1 launch on the
    gallop kernel; the weights of both the seeded draw or `params_file`'s.
    Returns the scan's K2 device time (`k2_scan_times`)."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import inference_detector, init_detector

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cloud = sample(points, cfg32)[None]
    gpu_maps = backbone_maps(cloud, cfg32, device)
    cpu_maps = backbone_maps(cloud, cfg32, "cpu")
    for name, (m, _) in gpu_maps.items():
        if not torch.equal(m.cpu(), cpu_maps[name][0]):
            raise AssertionError(f"f32 slice: {name} differs card vs CPU")
    log(f"   f32: voxel keys and {len(gpu_maps) - 1} backbone maps equal "
        "card vs CPU")
    model = init_detector(cfg32, 0, params_file, device=device)
    _native.reset_launches()
    k2_calls, keep_got, keep_want = {"fused_gather_gemm": []}, [], []
    neck_got, neck_want = [], []
    with recorded_conv_calls(k2_calls), recorded_nms(keep_got), \
            recorded_reference_neck(neck_got):
        got, got_ovf = inference_detector(model, points)
    check_variants(f"f32 inference scan, {cfg.n_classes} classes", f32=True)
    with recorded_nms(keep_want), recorded_reference_neck(neck_want):
        want, want_ovf = inference_detector(
            init_detector(cfg32, 0, params_file, device="cpu"), points)
    if cfg.neck_mode == "reference":
        check_reference_neck(torch, neck_got, neck_want, "f32 reference scan")
    if len(keep_got) != len(keep_want) or not all(
            torch.equal(g[1].cpu(), w[1]) for g, w in zip(keep_got,
                                                        keep_want)):
        raise AssertionError("f32 slice: the NMS keep masks differ card vs "
                             "CPU")
    n_got, n_want = len(got["scores_3d"]), len(want["scores_3d"])
    if n_got != n_want or got_ovf != want_ovf:
        raise AssertionError(f"f32 slice: {n_got} detections on the card, "
                             f"{n_want} on the CPU (overflow {got_ovf} vs "
                             f"{want_ovf})")
    box_err = float(np.abs(got["boxes_3d"] - want["boxes_3d"]).max(initial=0))
    score_err = float(np.abs(got["scores_3d"] - want["scores_3d"]).max(
        initial=0))
    if not (np.array_equal(got["labels_3d"], want["labels_3d"])
            and box_err <= BOX_ATOL and score_err <= SCORE_ATOL):
        raise AssertionError(f"f32 slice: labels equal "
                             f"{np.array_equal(got['labels_3d'], want['labels_3d'])}"
                             f", box err {box_err} (tol {BOX_ATOL}), score "
                             f"err {score_err} (tol {SCORE_ATOL})")
    kept = sum(int(k.sum()) for _, k in keep_want)
    log(f"   f32: {n_got} detections equal card vs CPU; "
        f"{'rotated' if cfg.with_yaw else 'axis-aligned'} NMS keep masks "
        f"equal ({kept} kept of {keep_want[0][1].numel()} candidates); max "
        f"box err {box_err:.3g} (tol {BOX_ATOL}), max score err "
        f"{score_err:.3g} (tol {SCORE_ATOL})")
    return k2_scan_times(torch, k2_calls["fused_gather_gemm"],
                         f"the f32 inference scan, {cfg.n_classes} classes")


@contextlib.contextmanager
def recorded_conv_calls(calls):
    """Every call of a kernel named in `calls` ("fused_gather_gemm", K2;
    "fused_gather_max", K3; "fused_gather_dw", K4) that the sparse convs and
    pools make inside (through `ops.sparse.conv`) is appended to
    calls[name] as (args, kwargs)."""
    from fcaf3d_tpu_torch.ops.sparse import conv as sconv

    real = {name: getattr(sconv, name) for name in calls}

    def recorder(name):
        def call(*args, **kw):
            calls[name].append((args, kw))
            return real[name](*args, **kw)
        return call

    for name in calls:
        setattr(sconv, name, recorder(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(sconv, name, fn)


@contextlib.contextmanager
def recorded_nms(calls):
    """Every BEV NMS of `fcaf3d_get_bboxes` made inside is appended to
    `calls` as ((boxes7, scores, iou_thr, valid, rotated), keep)."""
    from fcaf3d_tpu_torch.models import fcaf3d_head

    real = fcaf3d_head.nms_bev

    def call(boxes7, scores, iou_thr, valid=None, rotated=True):
        keep = real(boxes7, scores, iou_thr, valid=valid, rotated=rotated)
        calls.append(((boxes7, scores, iou_thr, valid, rotated), keep))
        return keep

    fcaf3d_head.nms_bev = call
    try:
        yield
    finally:
        fcaf3d_head.nms_bev = real


@contextlib.contextmanager
def recorded_reference_neck(calls):
    """Every child map the reference neck expands (`conv.gen_child_idx`) and
    every prune it makes (`sparse_prune`) inside is appended to `calls`, in
    order, as ("child", parent map, child map) and ("prune", union keys,
    scores, budget, kept keys), on the CPU."""
    from fcaf3d_tpu_torch.models import fcaf3d_head
    from fcaf3d_tpu_torch.ops.sparse import conv as sconv

    real_child, real_prune = sconv.gen_child_idx, fcaf3d_head.sparse_prune

    def child(parent_idx):
        out = real_child(parent_idx)
        calls.append(("child", parent_idx.cpu(), out.cpu()))
        return out

    def prune(st, scores, budget):
        out = real_prune(st, scores, budget)
        calls.append(("prune", st.keys.cpu(), scores.float().cpu(), budget,
                      out.keys.cpu()))
        return out

    sconv.gen_child_idx, fcaf3d_head.sparse_prune = child, prune
    try:
        yield
    finally:
        sconv.gen_child_idx, fcaf3d_head.sparse_prune = real_child, real_prune


def check_reference_neck(torch, got, want, what):
    """The reference neck's maps on the card (`got`) against the CPU's
    (`want`, `recorded_reference_neck`), level by level: parent and child
    maps and the union's keys exactly equal, and the kept key sets equal
    but for rows whose CPU score lies within PRUNE_RTOL (relative) of the
    budget-th score, where card and CPU scores differ in the last bits.
    After a level with such a flip the finer levels' maps are other maps
    and are not compared. Logs the flips; returns their count."""
    from fcaf3d_tpu_torch.ops.sparse import SENTINEL

    if [c[0] for c in got] != [c[0] for c in want] or not want:
        raise AssertionError(f"{what}: the neck's calls differ card vs CPU")
    flips, compared = 0, 0
    for g, w in zip(got, want):
        if flips:
            break
        compared += 1
        if g[0] == "child":
            if not (torch.equal(g[1], w[1]) and torch.equal(g[2], w[2])):
                raise AssertionError(f"{what}: a parent or child map "
                                     f"{tuple(w[2].shape)} differs")
            continue
        _, keys_g, _, budget, kept_g = g
        _, keys, scores, _, kept_w = w
        if not torch.equal(keys_g, keys):
            raise AssertionError(f"{what}: union keys differ card vs CPU")
        for b in range(keys.shape[0]):
            valid = keys[b] != SENTINEL
            s = scores[b][valid]
            if s.numel() <= budget:
                if not torch.equal(kept_g[b], kept_w[b]):
                    raise AssertionError(f"{what}: unpruned map differs")
                continue
            kth = float(torch.sort(s, descending=True).values[budget - 1])
            a = kept_g[b][kept_g[b] != SENTINEL]
            c = kept_w[b][kept_w[b] != SENTINEL]
            flipped = torch.cat([a[~torch.isin(a, c)], c[~torch.isin(c, a)]])
            row = torch.isin(keys[b], flipped)
            far = (scores[b][row] - kth).abs() > PRUNE_RTOL * abs(kth)
            if far.any():
                raise AssertionError(
                    f"{what}: {int(far.sum())} kept rows differ card vs CPU "
                    f"with scores off the budget-th {kth} by more than "
                    f"{PRUNE_RTOL} relative")
            flips += int(row.sum())
    log(f"   {what}: {sum(c[0] == 'child' for c in want)} child maps and "
        f"{sum(c[0] == 'prune' for c in want)} prunes; {compared} compared "
        f"card vs CPU, equal; {flips} rows flipped at a prune boundary")
    return flips


def k4_float64(torch, feats, idx, dout):
    """K4 in float64, one offset at a time (the gathered rows of every
    offset at once would not fit at batch 8): [K, C, E]."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    d = dout.double()
    return torch.stack([
        torch.einsum("bmc,bme->ce",
                     gk.gather_rows(feats, idx[..., k:k + 1])[:, :, 0].double(),
                     d) for k in range(idx.shape[-1])])


def hold_calls_to_plain(torch, calls, what):
    """Every K2, K3 and K4 call a run made (`recorded_conv_calls`), replayed
    on its own inputs: K2 within K2_RTOL of the largest plain value, K3
    exactly equal to plain, K4 and its f32 plain version against float64
    (`k4_float64`, K4_ULP). Logs the counts, the worst readings and the K2
    (C, E, K) shapes by variant; returns the worst readings."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    worst, by_variant = {}, {}

    def fail(name, args, err, tol):
        raise AssertionError(
            f"{what}: {name} {tuple(args[0].shape)} {tuple(args[1].shape)} "
            f"{args[0].dtype}: max abs diff {err} of the largest value > {tol}")

    with torch.inference_mode():
        for args, kw in calls.get("fused_gather_gemm", ()):
            got = gk.fused_gather_gemm(*args, **kw).float()
            want = gk.fused_gather_gemm_plain(*args, **kw).float()
            err = (float((got - want).abs().max())
                   / max(float(want.abs().max()), 1.0))
            tol = K2_RTOL[str(args[0].dtype).split(".")[1]]
            if not (err <= tol and torch.isfinite(got).all()):
                fail("K2", args, err, tol)
            worst["K2"] = max(worst.get("K2", 0.0), err)
            k, c, e = args[2].shape
            by_variant.setdefault(gk.k2_variant(c, e, k, args[0].dtype),
                                  set()).add((c, e, k))
        for args, kw in calls.get("fused_gather_dw", ()):
            feats, idx, dout = args
            b, m, k = idx.shape
            c, e = feats.shape[-1], dout.shape[-1]
            variant = gk.k4_variant(c, e, k, feats.dtype)
            steps = 0 if variant == "simt" else -(-gk.dw_slices(
                b, m, k, c, e, variant)[0] // 16)
            tol = max(K4_RTOL, K4_ULP * steps)
            ref = k4_float64(torch, *args)
            scale = max(float(ref.abs().max()), 1e-30)
            got = gk.fused_gather_dw(*args, **kw)
            err = float((got.double() - ref).abs().max()) / scale
            if not (err <= tol and torch.isfinite(got).all()):
                fail("K4 (against float64)", args, err, tol)
            plain = float((gk.fused_gather_dw_plain(*args, **kw).double()
                           - ref).abs().max()) / scale
            if not plain <= K4_RTOL:
                fail("K4's f32 plain version (against float64)", args, plain,
                     K4_RTOL)
            worst["K4"] = max(worst.get("K4", 0.0), err)
            worst["K4 f32 plain"] = max(worst.get("K4 f32 plain", 0.0), plain)
            if err / tol > worst.get("K4 of its limit", 0.0):
                worst["K4 of its limit"] = err / tol
                worst["its mma steps"] = steps
        for args, kw in calls.get("fused_gather_max", ()):
            if not torch.equal(gk.fused_gather_max(*args, **kw),
                               gk.fused_gather_max_plain(*args, **kw)):
                raise AssertionError(f"{what}: K3 {tuple(args[1].shape)} "
                                     "differs from plain")
    log(f"   {what}: "
        + ", ".join(f"its {len(v)} {k} calls" for k, v in calls.items())
        + " held (largest diff of the largest value: K2 from plain, K4 and "
        "its f32 plain from float64: "
        + ", ".join(f"{k} {v:.4g}" for k, v in worst.items())
        + "); K2 (C, E, K) by variant: "
        + "; ".join(f"{v} {sorted(cek)}" for v, cek in by_variant.items()))
    return worst


def k2_scan_times(torch, calls, what):
    """Device ms of a run's recorded K2 calls replayed on their own inputs,
    as the path runs them and on the earlier kernel, in turns."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    def replay(variant):
        def run():
            with torch.inference_mode():  # as the scan ran them
                for args, kw in calls:
                    gk.fused_gather_gemm(*args, **kw, _variant=variant)
        return run

    times = timed_turns(torch, {"kernel": replay(None),
                                "earlier": replay("simt")}, reps=3)
    rec = {"calls": len(calls), "ms": times["kernel"][0],
           "earlier_ms": times["earlier"][0]}
    log(f"   K2 device time of {what}, its {len(calls)} calls replayed: "
        f"{rec['ms']:.4f} ms (the earlier kernel {rec['earlier_ms']:.4f}); "
        "readings " + ", ".join(f"{k} {v[1]:.4f}/{v[2]:.4f}"
                                for k, v in times.items()))
    return rec


def slice_phase(torch, cfg, scans, device, path="fcaf3d_inference",
                on_calls=None, params_file=None):
    """bf16 inference on every scan after a warm-up scan whose K1 calls are
    checked and timed (`k1_path_phase`) and whose K2 and K3 calls are held
    to their plain versions (`hold_calls_to_plain`), then handed to
    `on_calls` if given; zero overflow and well-formed detections (with
    rotated boxes, some yaw non-zero) on every scan. The weights are the
    seeded draw or, with `params_file`, that pickle's. Returns launches per
    kernel, the launches by variant (`check_variants`) and the K1
    record."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import inference_detector, init_detector

    model = init_detector(cfg, seed=0, params_file=params_file,
                          device=device)
    calls = {}
    conv_calls = {"fused_gather_gemm": [], "fused_gather_max": []}
    with recorded_k1_calls(calls), recorded_conv_calls(conv_calls):
        inference_detector(model, scans[0])  # warm-up: cuBLAS and allocator
    torch.cuda.synchronize()
    k1 = k1_path_phase(torch, calls, 1, f"one bf16 {path} scan")
    hold_calls_to_plain(torch, conv_calls, f"one bf16 {path} scan")
    if on_calls is not None:
        on_calls(conv_calls)
    calls.clear()
    conv_calls.clear()
    _native.reset_launches()
    results = []
    for pts in scans:
        t0 = time.perf_counter()
        dets, overflow = inference_detector(model, pts)
        results.append((time.perf_counter() - t0, dets, overflow))
    launches = dict(_native.LAUNCHES)
    for i, (dt, dets, overflow) in enumerate(results):
        n = len(dets["scores_3d"])
        log(f"   scan {i}: {dt * 1e3:.1f} ms wall, {n} detections, "
            f"overflow {overflow}")
        if any(overflow.values()):
            raise AssertionError(f"scan {i}: budgets dropped voxels "
                                 f"{overflow}")
        boxes = dets["boxes_3d"]
        if n == 0 or boxes.shape != (n, 7) or not np.isfinite(boxes).all() \
                or not np.isfinite(dets["scores_3d"]).all() \
                or not ((dets["labels_3d"] >= 0)
                        & (dets["labels_3d"] < cfg.n_classes)).all() \
                or (np.abs(boxes[:, 6]) > 0).any() != cfg.with_yaw:
            raise AssertionError(f"scan {i}: malformed detections")
    log(f"   launches over {len(scans)} scans: {launches}")
    check_path_launches(launches, path)
    return (launches, check_variants(f"bf16 {path}", ("gather_gemm",)),
            k1)


def check_variants(what, tc_kernels=(), f32=False):
    """The launches since the last reset of the counts went through the
    path's kernels: every bf16 K2 and K4 launch through a tensor-core
    variant (and each of `tc_kernels` had one), every f32 K2 launch through
    "simt_narrow" / "simt_tiled" (never the first "simt"), every K1 launch
    through the gallop kernel, every K3 launch through the vector kernel
    (never the first "scalar"); with `f32`, at least one f32 K2 and one K1
    launch. Logs and returns the launches by "kernel/variant/dtype"."""
    from fcaf3d_tpu_torch import _native

    counts = {"/".join(key): n
              for key, n in sorted(_native.VARIANT_LAUNCHES.items())}
    log(f"   {what}: K1-K4 launches by variant: {counts}")
    off = {key: n for key, n in counts.items()
           if key.endswith("/simt/bfloat16")
           or key == "gather_gemm/simt/float32"
           or key.startswith("gather_max/scalar/")
           or (key.startswith("searchsorted/")
               and key != "searchsorted/gallop/int64")}
    if off:
        raise AssertionError(f"{what}: launches off the path's kernels: "
                             f"{off}")
    for kernel in tc_kernels:
        if not any(key.startswith(f"{kernel}/tc") and key.endswith("bfloat16")
                   for key in counts):
            raise AssertionError(f"{what}: no bf16 {kernel} launch on the "
                                 "tensor cores")
    if f32 and not (any(key.startswith("gather_gemm/simt_")
                        and key.endswith("/float32") for key in counts)
                    and "searchsorted/gallop/int64" in counts):
        raise AssertionError(f"{what}: no f32 K2 launch on the narrow or "
                             "tiled kernel, or no K1 launch")
    return counts


@contextlib.contextmanager
def recorded_k1_calls(calls):
    """Every K1 call (`search.searchsorted_segments`) made inside is
    counted in `calls` by (site, keys shape, queries shape, with_miss),
    with a copy of its first keys and queries: site is the chain of the
    three callers above it, e.g. "conv_plan/build_kernel_map/lookup"."""
    from fcaf3d_tpu_torch.ops.sparse import search

    real = search.searchsorted_segments

    def call(keys, queries, with_miss=False, layout="sm", **kw):
        f = sys._getframe(1)
        site = "/".join(g.f_code.co_name for g in (
            f.f_back.f_back, f.f_back, f))
        key = (site, tuple(keys.shape), tuple(queries.shape), with_miss)
        if key not in calls:
            calls[key] = [0, keys.clone(), queries.clone()]
        calls[key][0] += 1
        return real(keys, queries, with_miss, layout, **kw)

    search.searchsorted_segments = call
    try:
        yield
    finally:
        search.searchsorted_segments = real


def k1_path_phase(torch, calls, runs, what):
    """K1 at every distinct call of a path recorded over `runs` runs
    (`recorded_k1_calls`): exactly equal to plain and to the earlier kernel,
    timed beside the earlier kernel and `torch.searchsorted` (`k1_case`).
    Returns the
    records by call, each with its launches a run, and the device ms a run
    of K1 and of the earlier kernel summed over the calls."""
    shapes = {}
    for (site, kshape, qshape, miss), (n, kk, qq) in sorted(
            calls.items(), key=lambda kv: -kv[1][2].numel()):
        name = (f"{site} B{kshape[0]} N{kshape[1]} Q{list(qshape[1:])}"
                f"{' with_miss' if miss else ''}")
        k1_case(torch, name, kk, qq, miss, shapes, time_plain=False)
        shapes[name]["launches"] = n / runs
    total = {k: sum(r[k] * r["launches"] for r in shapes.values())
             for k in ("ms", "earlier_ms")}
    log(f"   K1 over the {len(shapes)} distinct calls of {what}: "
        f"{sum(r['launches'] for r in shapes.values()):g} launches a run, "
        f"{total['ms']:.4f} ms of device time a run (the earlier kernel "
        f"{total['earlier_ms']:.4f})")
    return {"calls": shapes, "ms_per_run": total["ms"],
            "earlier_ms_per_run": total["earlier_ms"]}


def check_path_launches(launches, path):
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")


def backward_kernel_phase(torch, cfg, maps_by_batch):
    """K4 against its plain version at every (C, E, K) of the training path
    (f32 and bf16, bitwise repeatable), K2 as dFeats on a reversed self map
    and on an inverted k3 s2 map, and K2's training forward at s16 C128
    E128, on each batch's maps. The record is K4 at s8 C64 E64 bf16 on the
    largest batch."""
    rec = {}
    k4_err = {"float32": 0.0, "bfloat16": 0.0}
    for maps in maps_by_batch:
        maps = {**maps, **neck_maps(torch, maps, cfg)}
        for (c, e, k), name in K4_SHAPES:
            for dname in ("float32", "bfloat16"):
                r, diff = k4_case(torch, maps[name], c, e, dname,
                                  f"{name} C={c} E={e} K={k}")
                k4_err[dname] = max(k4_err[dname], diff)
                if (c, e, k, name, dname) == (64, 64, 27, "s8_k3s1",
                                              "bfloat16"):
                    rec["gather_dw"] = r
        k2_train_case(torch, maps["s8_k3s1"], 64, 64,
                      "dFeats reversed self map")
        k2_train_case(torch, maps["s8_k3s2"], 64, 128,
                      "dFeats inverted k3 s2 map")
        # at batch 8 the forward takes K2's 128 x 128 tile
        k2_train_case(torch, maps["s16_k3s1"], 128, 128, "forward")
    rec["gather_dw"]["max_abs_err"] = k4_err["bfloat16"]
    rec["gather_dw"]["max_abs_err_f32"] = k4_err["float32"]
    return rec


def k4_case(torch, idx_n, c, e, dname, what):
    """K4 against its plain version on one map: within K4_RTOL of the
    largest |dW|, bitwise equal over two runs; timed in turns with its
    plain version and, in bf16, with the SIMT kernel and one matmul on the
    pre-gathered rows. Returns (timing record, max abs diff)."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    idx, n = idx_n
    b, m, k = idx.shape
    gen = torch.Generator(device=idx.device).manual_seed(b * m + c + e)
    dt = getattr(torch, dname)
    feats = torch.randn(b, n, c, generator=gen, device=idx.device).to(dt)
    dout = torch.randn(b, m, e, generator=gen, device=idx.device).to(dt)
    got = gk.fused_gather_dw(feats, idx, dout)
    again = gk.fused_gather_dw(feats, idx, dout)
    want = gk.fused_gather_dw_plain(feats, idx, dout)
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    tol = K4_RTOL * float(want.abs().max())
    if not (diff <= tol and torch.isfinite(got).all()):
        raise AssertionError(f"K4 {what} {dname} B={b}: max abs diff {diff} "
                             f"> {tol}")
    if not torch.equal(got, again):
        raise AssertionError(f"K4 {what} {dname} B={b}: two runs differ")
    fns = {"plain": lambda: gk.fused_gather_dw_plain(feats, idx, dout),
           "kernel": lambda: gk.fused_gather_dw(feats, idx, dout)}
    if dname == "bfloat16":
        g = gk.gather_rows(feats, idx).reshape(b * m, k * c)
        d2 = dout.reshape(b * m, e)
        fns["simt"] = lambda: gk.fused_gather_dw(feats, idx, dout,
                                                 _variant="simt")
        fns["gemm_only"] = lambda: torch.matmul(g.t(), d2)
    times = timed_turns(torch, fns)
    r = timing_record(times, gemm_work(idx, n, c, e, feats.element_size(),
                                       weight_grad=True), PEAK_OPS[dname])
    r["variant"] = gk.k4_variant(c, e, k, dt)
    log(f"   K4 {what} {dname} idx {tuple(idx.shape)} N={n}: ok, bitwise "
        f"repeatable (max abs diff {diff:.3g}, tol {tol:.3g}); "
        f"{r['variant']}: {report(r)}")
    if dname == "bfloat16":
        tc_yardsticks(f"K4 {what} B={b}", r)
    return r, diff


def k2_train_case(torch, idx_n, c, e, how):
    """K2 as the training path calls it, without an epilogue, in f32 and
    bf16: the forward of a conv C -> E on its map ("forward"), or dFeats,
    dout [B, M, E] through the inverse map with W^T ("dFeats reversed self
    map"; "dFeats inverted k3 s2 map", the inverse held card vs CPU
    exactly)."""
    from fcaf3d_tpu_torch.ops.sparse import conv as sconv
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    idx, n = idx_n
    b, m, k = idx.shape
    dev = idx.device
    gen = torch.Generator(device=dev).manual_seed(b * m + c + e)
    if how == "forward":
        src, rows, cin, cout = idx, n, c, e
    elif how == "dFeats reversed self map":
        src, rows, cin, cout = idx.flip(-1).contiguous(), m, e, c
    else:
        src, rows, cin, cout = sconv.invert_kernel_map(idx, n), m, e, c
        if not torch.equal(src.cpu(), sconv.invert_kernel_map(idx.cpu(), n)):
            raise AssertionError(f"inverse map B={b} differs card vs CPU")
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        x = torch.randn(b, rows, cin, generator=gen, device=dev).to(dt)
        w = (torch.randn(k, cin, cout, generator=gen, device=dev)
             / np.sqrt(k * cin)).to(dt)
        got = gk.fused_gather_gemm(x, src, w)
        want = gk.fused_gather_gemm_plain(x, src, w)
        torch.cuda.synchronize()
        ref = want.float()
        diff = float((got.float() - ref).abs().max())
        tol = K2_RTOL[dname] * max(float(ref.abs().max()), 1.0)
        if not (diff <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"K2 {how} {dname} B={b}: max abs diff "
                                 f"{diff} > {tol}")
        if dname == "float32":
            k2_equal_simt(torch, got, x, src, w, {}, f"{how} B={b}")
        r = k2_timing(torch, x, src, w, {}, dname)
        log(f"   K2 {how} {dname} map {tuple(src.shape)} C={cin} -> "
            f"E={cout}: ok (max abs diff {diff:.3g}); {r['variant']} "
            f"{r.get('tile', '')}: {report(r)}")
        if dname == "bfloat16":
            tc_yardsticks(f"K2 {how} C={cin} E={cout} B={b}", r)


def train_batch(cfg, batch, seed0):
    """`batch` crowded synthetic scenes (`data.synth`), each 50 000 raw
    points sampled to `cfg.num_points` as `inference_detector` samples,
    with GT boxes (yawed with `cfg.with_yaw`) padded to
    `cfg.max_gt_boxes`."""
    from fcaf3d_tpu_torch.data.synth import crowded_scene, densify

    out = {"points": [], "colors": [], "gt_boxes": [], "gt_labels": [],
           "gt_valid": []}
    g = cfg.max_gt_boxes
    for i in range(batch):
        rng = np.random.default_rng(seed0 + i)
        scene = densify(crowded_scene(TRAIN_BOXES, cfg.n_classes, rng,
                                      extent=5.0, with_yaw=cfg.with_yaw),
                        TRAIN_BOX_POINTS, TRAIN_FLOOR_POINTS, rng)
        pts = scene["points"]
        pick = np.random.default_rng(0).choice(
            len(pts), cfg.num_points, replace=len(pts) < cfg.num_points)
        out["points"].append(pts[pick, :3])
        out["colors"].append(pts[pick, 3:6])
        n = len(scene["gt_boxes"])
        boxes = np.zeros((g, 7), np.float32)
        labels = np.zeros(g, np.int32)
        boxes[:n], labels[:n] = scene["gt_boxes"], scene["gt_labels"]
        out["gt_boxes"].append(boxes)
        out["gt_labels"].append(labels)
        out["gt_valid"].append(np.arange(g) < n)
    batch_np = {k: np.stack(v) for k, v in out.items()}
    batch_np["valid"] = np.ones(batch_np["points"].shape[:2], bool)
    return batch_np


def write_scannet_root(root, n_train, n_val, n_classes, n_boxes=TRAIN_BOXES,
                       extent=5.0, box_points=TRAIN_BOX_POINTS,
                       floor_points=TRAIN_FLOOR_POINTS, align=None):
    """A dataset in the reference's prepared ScanNet layout under `root`:
    `scannet_infos_{train,val}.pkl` and one float32 [N, 6] `.bin` a scene,
    each scene `crowded_scene(n_boxes, n_classes, extent)` + `densify`
    (the defaults: phase 6's 50 000-point scenes), its info with
    gravity-centred `gt_boxes_upright_depth`, `class`, `gt_num` and
    `axis_align_matrix` (`align`, default the identity). Scene i of the
    train split draws from seed i, of the val split from seed n_train + i.
    """
    import pickle

    from fcaf3d_tpu_torch.data.synth import crowded_scene, densify

    mat = np.eye(4, dtype=np.float32) if align is None else align
    os.makedirs(os.path.join(root, "points"), exist_ok=True)
    for split, n, first in (("train", n_train, 0), ("val", n_val, n_train)):
        infos = []
        for i in range(n):
            rng = np.random.default_rng(first + i)
            scene = densify(crowded_scene(n_boxes, n_classes, rng,
                                          extent=extent),
                            box_points, floor_points, rng)
            rel = f"points/{split}_{i:05d}.bin"
            scene["points"].astype(np.float32).tofile(os.path.join(root, rel))
            boxes = scene["gt_boxes"][:, :6].copy()
            boxes[:, 2] += boxes[:, 5] / 2  # bottom -> gravity centre
            infos.append({"pts_path": rel, "annos": {
                "gt_num": len(boxes), "gt_boxes_upright_depth": boxes,
                "class": scene["gt_labels"], "axis_align_matrix": mat}})
        with open(os.path.join(root, f"scannet_infos_{split}.pkl"),
                  "wb") as f:
            pickle.dump(infos, f)


def write_sunrgbd_root(root, scenes, image_suffix=".jpg"):
    """A SUN RGB-D train split in the reference's prepared layout under
    `root`: `sunrgbd_infos_train.pkl` and one float32 [N, 6] `.bin` a scene
    (xyz + rgb, zero colours where the scene has none), its info with
    gravity-centred `gt_boxes_upright_depth`, `class` and `gt_num`. A
    scene with an "image" also gets the image file (`image_suffix` ".jpg"
    through Pillow, or ".npy"), its `calib` and the 2D boxes `annos.bbox`,
    one a 3D box. `scenes`: dicts {points [N, 3|6], gt_boxes [n, 7]
    bottom-centred, gt_labels [n]} and optionally {image [H, W, 3], calib,
    bbox [n, 4] xyxy}."""
    import pickle

    os.makedirs(os.path.join(root, "points"), exist_ok=True)
    os.makedirs(os.path.join(root, "image"), exist_ok=True)
    infos = []
    for i, sc in enumerate(scenes):
        pts = np.zeros((len(sc["points"]), 6), np.float32)
        pts[:, :sc["points"].shape[1]] = sc["points"]
        rel = f"points/{i:06d}.bin"
        pts.tofile(os.path.join(root, rel))
        boxes = np.asarray(sc["gt_boxes"], np.float32).copy()
        boxes[:, 2] += boxes[:, 5] / 2  # bottom -> gravity centre
        info = {"pts_path": rel, "annos": {
            "gt_num": len(boxes), "gt_boxes_upright_depth": boxes,
            "class": np.asarray(sc["gt_labels"], np.int64)}}
        if "image" in sc:
            img = f"image/{i:06d}{image_suffix}"
            if image_suffix == ".npy":
                np.save(os.path.join(root, img), sc["image"])
            else:
                from PIL import Image

                Image.fromarray(sc["image"].astype(np.uint8)).save(
                    os.path.join(root, img))
            info["image"] = {"image_path": img}
            info["calib"] = sc["calib"]
            info["annos"]["bbox"] = np.asarray(sc["bbox"], np.float32)
        infos.append(info)
    with open(os.path.join(root, "sunrgbd_infos_train.pkl"), "wb") as f:
        pickle.dump(infos, f)


def frame_scene(frame):
    """An `imvote_frame` as a `write_sunrgbd_root` scene: the GT boxes that
    have a 2D box, with it."""
    idx = frame["boxes2d_index"]
    return {"points": frame["points"], "image": frame["image"],
            "calib": frame["calib"], "gt_boxes": frame["gt_boxes"][idx],
            "gt_labels": frame["gt_labels"][idx],
            "bbox": frame["boxes2d"][:, :4]}


def read_npy_image(path, hw):
    """`tools.train_detector2d.read_image` for `.npy` frames already at
    `hw`: (float32 [H, W, 3], (width, height))."""
    img = np.load(path).astype(np.float32)
    if img.shape[:2] != tuple(hw):
        raise AssertionError(f"{path}: frame {img.shape}, expected {hw}")
    return img, (hw[1], hw[0])


def crowded_scenes(n, cfg, seed0=0):
    """`train_batch`'s crowded scenes (yawed boxes with `cfg.with_yaw`) as
    `write_sunrgbd_root` scenes: 50 000 raw points, xyz + rgb."""
    from fcaf3d_tpu_torch.data.synth import crowded_scene, densify

    out = []
    for i in range(n):
        rng = np.random.default_rng(seed0 + i)
        out.append(densify(crowded_scene(TRAIN_BOXES, cfg.n_classes, rng,
                                         extent=5.0, with_yaw=cfg.with_yaw),
                           TRAIN_BOX_POINTS, TRAIN_FLOOR_POINTS, rng))
    return out


def _me_order(kernel):
    """A [K^3, Cin, Cout] kernel in the framework's offset order (x
    slowest) written in MinkowskiEngine's (x fastest): the inverse of the
    converter's permutation."""
    from fcaf3d_tpu_torch.tools.convert_checkpoint import me_offset_permutation

    if kernel.shape[0] not in (8, 27):
        return kernel
    k = round(kernel.shape[0] ** (1 / 3))
    out = np.empty_like(kernel)
    out[me_offset_permutation(k)] = kernel
    return out


def reference_state_dict(variables, model):
    """A state dict with the reference's module names and tensor layouts
    (MinkowskiEngine kernels [K^3, Cin, Cout] in ME's offset order, 1x1
    conv weights [out, in, 1(, 1)]) holding the flax-layout `variables` of
    the port's FCAF3D at depth 34 (`model` "fcaf3d"), VoteNet-v2
    ("votenet") or ImVoteNet ("imvotenet"): the input of
    `tools/convert_checkpoint.py`, written independently of it from the
    reference's names. The converter must give `variables` back."""
    from fcaf3d_tpu_torch.params import flatten

    p = flatten(variables["params"])
    b = flatten(variables.get("batch_stats", {}))
    sd = {}

    def bn(dst, src):
        sd[f"{dst}.weight"] = p[f"{src}.scale"]
        sd[f"{dst}.bias"] = p[f"{src}.bias"]
        sd[f"{dst}.running_mean"] = b[f"{src}.mean"]
        sd[f"{dst}.running_var"] = b[f"{src}.var"]

    def conv(dst, src):
        sd[dst] = _me_order(p[f"{src}.kernel"])

    if model == "fcaf3d":
        conv("backbone.conv1.0.kernel", "backbone.conv1")
        sd["backbone.conv1.1.weight"] = p["backbone.norm1.scale"]
        sd["backbone.conv1.1.bias"] = p["backbone.norm1.bias"]
        for i, n_blocks in enumerate((3, 4, 6, 3)):
            for j in range(n_blocks):
                src, dst = f"backbone.layer{i + 1}_{j}", \
                    f"backbone.layer{i + 1}.{j}"
                for c in (1, 2):
                    conv(f"{dst}.conv{c}.kernel", f"{src}.conv{c}")
                    bn(f"{dst}.norm{c}", f"{src}.norm{c}")
                if f"{src}.downsample_conv.kernel" in p:
                    conv(f"{dst}.downsample.0.kernel",
                         f"{src}.downsample_conv")
                    bn(f"{dst}.downsample.1.bn", f"{src}.downsample_norm")
        h = "neck_with_head"
        for i in range(1, 4):
            conv(f"{h}.up_block_{i}.0.kernel", f"{h}.up_block_{i}_tr")
            bn(f"{h}.up_block_{i}.1.bn", f"{h}.up_block_{i}_bn1")
            conv(f"{h}.up_block_{i}.3.kernel", f"{h}.up_block_{i}_conv")
            bn(f"{h}.up_block_{i}.4.bn", f"{h}.up_block_{i}_bn2")
        for i in range(4):
            conv(f"{h}.out_block_{i}.0.kernel", f"{h}.out_block_{i}_conv")
            bn(f"{h}.out_block_{i}.1.bn", f"{h}.out_block_{i}_bn")
            sd[f"{h}.scales.{i}.scale"] = p[f"{h}.scale_{i}"].reshape(1)
        for name in ("centerness_conv", "reg_conv", "cls_conv"):
            conv(f"{h}.{name}.kernel", f"{h}.{name}")
        sd[f"{h}.cls_conv.bias"] = p[f"{h}.cls_conv.bias"]
        return sd

    def dense(dst, src, ndim):
        w = p[f"{src}.kernel"].T
        sd[f"{dst}.weight"] = w.reshape(w.shape + (1,) * (ndim - 2))
        sd[f"{dst}.bias"] = p[f"{src}.bias"]

    def dense_bn(dst, src, ndim):
        dense(f"{dst}.conv", f"{src}.Dense_0", ndim)
        bn(f"{dst}.bn", f"{src}.BatchNorm_0")

    def layers(dst, src, ndim):
        j = 0
        while f"{src}{j}.Dense_0.kernel" in p:
            dense_bn(f"{dst}{j}", f"{src}{j}", ndim)
            j += 1

    bb, hd = (("backbone", "bbox_head") if model == "votenet"
              else ("pts_backbone", "pts_bbox_head_joint"))
    for i in range(4):
        layers(f"{bb}.SA_modules.{i}.mlps.0.layer", f"backbone.sa{i}.mlp", 4)
    for i in range(2):
        layers(f"{bb}.FP_modules.{i}.mlps.layer", f"backbone.fp{i}.mlp", 4)
    layers(f"{hd}.vote_module.vote_conv.", "vote_module.vote_conv", 3)
    dense(f"{hd}.vote_module.conv_out", "vote_module.conv_out", 3)
    layers(f"{hd}.vote_aggregation.mlps.0.layer", "vote_aggregation.mlp", 4)
    layers(f"{hd}.conv_pred.shared_convs.layer", "shared_conv", 3)
    for name in ("cls", "reg"):
        dense(f"{hd}.conv_pred.conv_{name}", f"conv_{name}", 3)
    if model == "imvotenet":
        layers("img_mlp.mlp.layer", "img_mlp", 3)
    return sd


def train_phase(torch, cfg, batch, device, steps=TRAIN_STEPS,
                path="fcaf3d_training", on_calls=None):
    """bf16 training at batch 8: a warm-up step whose K1 calls are checked
    and timed (`k1_path_phase`) and whose K2 and K3 calls are held to
    their plain versions and K4 calls to float64 (`hold_calls_to_plain`),
    then handed to `on_calls` if given; then `steps` timed steps.
    Returns launches per kernel over the timed steps, the launches by
    variant (`check_variants`), the K1 record and the mean step wall in
    ms."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.train import create_train_state, make_train_step

    model, opt, _ = create_train_state(cfg, seed=0, device=device)
    step = make_train_step(model, cfg, opt)
    calls = {}
    conv_calls = {"fused_gather_gemm": [], "fused_gather_max": [],
                  "fused_gather_dw": []}
    with recorded_k1_calls(calls), recorded_conv_calls(conv_calls):
        step(batch)  # warm-up: cuBLAS and the allocator
    torch.cuda.synchronize()
    what = f"one batch-{TRAIN_BATCH} {path} step"
    k1 = k1_path_phase(torch, calls, 1, what)
    hold_calls_to_plain(torch, conv_calls, what)
    if on_calls is not None:
        on_calls(conv_calls)
    # the recorded inputs must not count in the peak memory
    calls.clear()
    conv_calls.clear()
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launches()
    times, metrics = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in step(batch).items()}
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append(m)
    launches = dict(_native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for i, (dt, m) in enumerate(zip(times, metrics)):
        log(f"   step {i}: {dt * 1e3:.1f} ms wall, " + ", ".join(
            f"{k} {v:.5g}" for k, v in m.items()))
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"step {i}: non-finite metrics {m}")
        if m["loss_bbox"] <= 0 or m["overflow_max"] != 0:
            raise AssertionError(f"step {i}: loss_bbox {m['loss_bbox']}, "
                                 f"overflow_max {m['overflow_max']}")
    n_conv = 0
    for name, p in model.named_parameters():
        if name.endswith("kernel"):
            n_conv += 1
            if p.grad is None or not torch.isfinite(p.grad).all() \
                    or not p.grad.abs().max() > 0:
                raise AssertionError(f"{name}: gradient missing, non-finite "
                                     "or zero")
    log(f"   {steps} steps at batch {TRAIN_BATCH}: mean "
        f"{np.mean(times) * 1e3:.1f} ms/step (min {min(times) * 1e3:.1f}); "
        f"peak memory {peak / 2**30:.2f} GiB; {n_conv} conv kernels with "
        f"finite non-zero gradients; launches {launches}")
    check_path_launches(launches, path)
    return (launches, check_variants(f"bf16 {path}",
                                     ("gather_gemm", "gather_dw")), k1,
            float(np.mean(times)) * 1e3)


def head_batch(torch, cfg, extent, b=2, boxes_per_scene=3, seed=0):
    """B `data.synth.synth_scene` scans of `extent` for a miniature config, with
    GT boxes of ~0.2 m around level-0 head locations of the training
    forward (on the CPU; weights and pruning are the same on the card), so
    that the assigner finds positives and the box loss is live; with
    `cfg.with_yaw` the boxes get random yaws."""
    from fcaf3d_tpu_torch.data.synth import synth_scene
    from fcaf3d_tpu_torch.train import create_train_state

    pts, cols = zip(*(synth_scene(np.random.RandomState(seed + s),
                                  cfg.num_points, extent=extent)
                      for s in range(b)))
    batch = {"points": np.stack(pts).astype(np.float32),
             "colors": np.stack(cols).astype(np.float32),
             "valid": np.ones((b, cfg.num_points), bool)}
    model, _, _ = create_train_state(cfg, 0, device="cpu")
    with torch.no_grad():
        outs, _ = model(*(torch.as_tensor(batch[k])
                          for k in ("points", "colors", "valid")))
    g = cfg.max_gt_boxes
    batch.update(gt_boxes=np.zeros((b, g, 7), np.float32),
                 gt_labels=np.zeros((b, g), np.int32),
                 gt_valid=np.zeros((b, g), bool))
    rng = np.random.default_rng(seed)
    for i in range(b):
        heads = outs[0].points[i][outs[0].valid[i]].numpy()
        for j, h in enumerate(heads[rng.choice(len(heads), boxes_per_scene,
                                               replace=False)]):
            dims = rng.uniform(0.18, 0.26, 3).astype(np.float32)
            yaw = rng.uniform(-np.pi, np.pi) if cfg.with_yaw else 0.0
            batch["gt_boxes"][i, j] = [h[0], h[1], h[2] - dims[2] / 2,
                                       *dims, yaw]
            batch["gt_labels"][i, j] = rng.integers(0, cfg.n_classes)
            batch["gt_valid"][i, j] = True
    return batch


def step_grads(torch, cfg, batch, dev, seed=0):
    """Forward in train mode, `fcaf3d_loss` and backward on `dev`: the
    head-level maps, overflow counts, losses and every parameter's
    gradient, on the CPU."""
    from fcaf3d_tpu_torch.models.detector import loss_config
    from fcaf3d_tpu_torch.models.fcaf3d_head import fcaf3d_loss
    from fcaf3d_tpu_torch.train import create_train_state

    model, _, _ = create_train_state(cfg, seed=seed, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    outs, overflow = model(t["points"], t["colors"], t["valid"])
    losses = fcaf3d_loss(outs, t["gt_boxes"], t["gt_labels"], t["gt_valid"],
                         loss_config(cfg))
    sum(losses.values()).backward()
    return ([(o.points.cpu(), o.valid.cpu()) for o in outs],
            {k: v.cpu().tolist() for k, v in overflow.items()},
            {k: float(v.detach()) for k, v in losses.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()})


def leaf_errs(got, want):
    """Per gradient leaf: (|got - want| in L2 norm / |want|, largest
    |got - want| / largest |want|, name), sorted by the first."""
    return sorted(
        (float((got[n] - w).norm() / max(float(w.norm()), 1e-30)),
         float((got[n] - w).abs().max() / max(float(w.abs().max()), 1e-30)),
         n) for n, w in want.items())


def card_vs_cpu(torch, cfg, batch, device, what, seed=0):
    """One f32 train step on the card and on the CPU from the same weights
    and batch: head-level maps and overflow counts exactly equal. Returns
    the card's and the CPU's losses and the per-leaf errors."""
    lv_g, ovf_g, loss_g, grad_g = step_grads(torch, cfg, batch, device, seed)
    lv_c, ovf_c, loss_c, grad_c = step_grads(torch, cfg, batch, "cpu", seed)
    for i, ((pg, vg), (pc, vc)) in enumerate(zip(lv_g, lv_c)):
        if not (torch.equal(pg, pc) and torch.equal(vg, vc)):
            raise AssertionError(f"{what}: level {i} map differs card vs CPU "
                                 "(neck keep mask)")
    if ovf_g != ovf_c:
        raise AssertionError(f"{what}: overflow {ovf_g} vs {ovf_c}")
    return loss_g, loss_c, ovf_c, leaf_errs(grad_g, grad_c)


def report_errs(errs):
    return (f"median {errs[len(errs) // 2][0]:.3g}, worst "
            + ", ".join(f"{n} {a:.3g} ({b:.3g})" for a, b, n in errs[-3:]))


def compare_train_tiny(torch, device, with_yaw=False, **over):
    """One f32 train step at `fcaf3d_tiny` (`with_yaw`: rotated boxes, 8
    regression outputs, yawed GT boxes; `over`: fields replaced, e.g.
    depth=50), batch 2, card against CPU, with the tight per-element
    gate."""
    from fcaf3d_tpu_torch.configs import fcaf3d_tiny

    cfg = dataclasses.replace(fcaf3d_tiny(with_yaw=with_yaw), **over)
    what = (f"f32 tiny{' with_yaw' if with_yaw else ''}"
            + "".join(f" {k}={v}" for k, v in over.items()) + " train")
    batch = head_batch(torch, cfg, TINY_EXTENT)
    loss_g, loss_c, _, errs = card_vs_cpu(torch, cfg, batch, device, what)
    loss_err = max(abs(loss_g[k] / loss_c[k] - 1) for k in loss_c)
    worst = max(errs, key=lambda x: x[1])
    log(f"   {what}, batch 2: head-level maps equal card vs CPU; "
        f"losses {loss_c} (max rel err {loss_err:.3g}, tol "
        f"{TRAIN_LOSS_RTOL}); gradient leaves, largest-element rel err: "
        f"worst {worst[2]} {worst[1]:.3g} (tol {TINY_GRAD_RTOL}); norm rel "
        f"err {report_errs(errs)}")
    if loss_c["loss_bbox"] <= 0 or loss_err > TRAIN_LOSS_RTOL \
            or worst[1] > TINY_GRAD_RTOL:
        raise AssertionError(f"{what}: card and CPU disagree")


def compare_train_f32(torch, cfg, device):
    """One f32 train step at batch 1: the card against the plain path on
    the CPU, from the same weights and batch (the loose gate)."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    batch = train_batch(cfg32, 1, seed0=100)
    cloud = np.concatenate([batch["points"], batch["colors"]], axis=-1)
    gpu_maps = backbone_maps(cloud, cfg32, device)
    cpu_maps = backbone_maps(cloud, cfg32, "cpu")
    for name, (m, _) in gpu_maps.items():
        if not torch.equal(m.cpu(), cpu_maps[name][0]):
            raise AssertionError(f"f32 train: {name} differs card vs CPU")
    loss_g, loss_c, ovf, errs = card_vs_cpu(torch, cfg32, batch, device,
                                            "f32 train")
    if any(max(v) for v in ovf.values()):
        raise AssertionError(f"f32 train: overflow {ovf}")
    loss_err = max(abs(loss_g[k] / loss_c[k] - 1) for k in loss_c)
    log(f"   f32 train: voxel keys, {len(gpu_maps) - 1} backbone maps and "
        f"the pruned head-level maps equal card vs CPU; losses {loss_c} "
        f"(max rel err {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}); gradient "
        f"leaves, norm rel err (largest-element rel err): {report_errs(errs)}"
        f" (tol {TRAIN_GRAD_RTOL} in norm)")
    if loss_c["loss_bbox"] <= 0 or loss_err > TRAIN_LOSS_RTOL \
            or errs[-1][0] > TRAIN_GRAD_RTOL:
        raise AssertionError("f32 train: card and CPU disagree")


def grad_control(torch, cfg, device, seeds):
    """The f32 ScanNet gradients' sensitivity, for weight seed s and the
    batch-1 scene of data seed 100 + s: the card against the CPU, beside
    the CPU against itself with the input colours scaled by (1 + 1e-6)."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    for s in range(seeds):
        batch = train_batch(cfg32, 1, seed0=100 + s)
        nudged = {**batch, "colors": batch["colors"] * np.float32(1 + 1e-6)}
        _, _, _, grad_c = step_grads(torch, cfg32, batch, "cpu", s)
        _, _, _, grad_n = step_grads(torch, cfg32, nudged, "cpu", s)
        _, _, _, grad_g = step_grads(torch, cfg32, batch, device, s)
        for what, got in (("card vs CPU", grad_g),
                          ("CPU nudged vs CPU", grad_n)):
            errs = leaf_errs(got, grad_c)
            log(f"   seed {s} {what}: norm rel err (largest-element rel "
                f"err) {report_errs(errs)}; largest-element rel err over "
                f"leaves {max(e[1] for e in errs):.3g}")


def profile_inference(torch, cfg, scans):
    """One bf16 `inference_detector` scan under `torch.profiler` (after a
    warm-up scan): device time by kernel, busy share, launches; and the
    K2 launches by variant of that scan."""
    from torch.profiler import ProfilerActivity, profile

    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import inference_detector, init_detector

    model = init_detector(cfg, seed=0, device="cuda")
    inference_detector(model, scans[0])
    torch.cuda.synchronize()
    _native.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference_detector(model, scans[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_profile(prof, wall, "1 bf16 inference scan")
    log(f"   port launches {dict(_native.LAUNCHES)}")
    check_variants("profiled scan", ("gather_gemm",))


def profile_train(torch, cfg, batch):
    """The batch-8 bf16 train step: stage split on the host clock with a
    synchronise after each stage (3 steps), then 2 steps under
    `torch.profiler`: device time by kernel, busy share, host time."""
    from torch.profiler import ProfilerActivity, profile

    from fcaf3d_tpu_torch.models.detector import loss_config
    from fcaf3d_tpu_torch.models.fcaf3d_head import fcaf3d_loss
    from fcaf3d_tpu_torch.train import create_train_state, make_train_step
    from fcaf3d_tpu_torch.train.trainer import BATCH_KEYS

    model, opt, _ = create_train_state(cfg, seed=0, device="cuda")
    step = make_train_step(model, cfg, opt)
    step(batch)
    step(batch)
    lcfg = loss_config(cfg)
    for _ in range(3):
        t = {k: torch.as_tensor(batch[k], device="cuda") for k in BATCH_KEYS}
        marks = []

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        mark()
        opt.zero_grad(set_to_none=True)
        outs, _ = model(t["points"], t["colors"], t["valid"])
        mark()
        total = sum(fcaf3d_loss(outs, t["gt_boxes"], t["gt_labels"],
                                t["gt_valid"], lcfg).values())
        mark()
        total.backward()
        mark()
        opt.step()
        mark()
        ms = np.diff(marks) * 1e3
        log("   stages ms: " + ", ".join(
            f"{k} {v:.1f}" for k, v in zip(
                ("forward", "loss", "backward", "optimizer"), ms))
            + f", total {ms.sum():.1f}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_profile(prof, wall, "2 steps")


def log_profile(prof, wall, what):
    """Device time by kernel, busy share of `wall` and the host's largest
    items, from a finished `torch.profiler` run."""
    from torch.autograd import DeviceType

    ka = prof.key_averages()
    # device events, less the ranges the profiler books to annotations
    # such as `Optimizer.step`
    kern = [e for e in ka if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"   profiled {what}: wall {wall * 1e3:.1f} ms, kernel device time "
        f"{dev_ms:.1f} ms (busy {dev_ms / (wall * 1e3):.3f}), "
        f"{sum(e.count for e in kern)} kernel launches")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:16]:
        log(f"   device {e.self_device_time_total / 1e3:9.2f} ms "
            f"n {e.count:6d}  {e.key[:90]}")
    for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:10]:
        log(f"   host   {e.self_cpu_time_total / 1e3:9.2f} ms "
            f"n {e.count:6d}  {e.key[:80]}")


def profile_votenet(torch, cfg, device):
    """VoteNet-v2 inference (f32, batch 1, test mode): the stage split of
    three scans on the host clock, each stage ended by a synchronise (FPS
    and ball queries inside the SA modules, the rest of each SA module, the
    FP modules, the vote module, the head, `votenet_get_bboxes`), then one
    scan under `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile

    from fcaf3d_tpu_torch.apis import inference_votenet, init_votenet
    from fcaf3d_tpu_torch.apis.inference import votenet_inputs
    from fcaf3d_tpu_torch.models import votenet

    model = init_votenet(cfg, seed=0, device=device)
    scans = [vote_scan(s, cfg.num_points) for s in range(3)]
    inference_votenet(model, scans[0])
    spans = {}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    stages = {"sa": [model.backbone.get_submodule(f"sa{i}")
                     for i in range(model.backbone.n_sa)]
              + [model.vote_aggregation],
              "fp": [model.backbone.get_submodule(f"fp{i}")
                     for i in range(model.backbone.n_fp)],
              "vote_module": [model.vote_module]}
    for name, mods in stages.items():
        for m in mods:
            m.forward = timed(name, m.forward)
    try:
        with wrapped_selections(timed):
            for s, pts in enumerate(scans):
                spans.clear()
                x = torch.as_tensor(votenet_inputs(pts, cfg.num_points)[None],
                                    device=device)
                with torch.inference_mode():
                    fwd = timed("forward", model)(
                        x, sample_mod=cfg.sample_mod_test)
                    timed("get_bboxes", votenet.votenet_get_bboxes)(
                        fwd, x, cfg.n_classes, nms_thr=cfg.nms_thr,
                        score_thr=cfg.score_thr,
                        per_class_proposal=cfg.per_class_proposal)
                spans["sa_rest"] = (spans["sa"] - spans["fps"]
                                    - spans["ball_query"])
                spans["head_rest"] = (spans["forward"] - spans["sa"]
                                      - spans["fp"] - spans["vote_module"]
                                      - spans["seed_fps"])
                log(f"   scan {s} stages ms: " + ", ".join(
                    f"{k} {spans[k] * 1e3:.2f}" for k in (
                        "fps", "seed_fps", "ball_query", "sa_rest", "fp",
                        "vote_module", "head_rest", "get_bboxes"))
                    + "; total "
                    f"{(spans['forward'] + spans['get_bboxes']) * 1e3:.2f}")
    finally:
        for mods in stages.values():
            for m in mods:
                del m.forward
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference_votenet(model, scans[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_profile(prof, wall, "1 VoteNet scan")


def tiny_coder(n_classes=4):
    """The JAX tests' miniature v1 box coder (`tests/test_votenet_v1.py`):
    6 direction bins, one mean size a class."""
    from fcaf3d_tpu_torch.models.votenet_v1 import PartialBinBasedBBoxCoder

    return PartialBinBasedBBoxCoder(
        num_dir_bins=6, num_sizes=n_classes,
        mean_sizes=tuple((0.5 + 0.1 * i, 0.6, 0.7) for i in range(n_classes)),
        with_rot=True)


def vote_head_batch(cfg, b=2, seed=0):
    """A training batch for a miniature VoteNet config: B `synth_scene`
    scans of VOTE_TINY_EXTENT with the height column, and GT boxes centred
    on scan points (so that proposals near them are positives): three nested
    boxes about one point, so that points lie in 0, 1, 2 and 3 boxes, and
    one about another, yawed with `cfg.with_yaw`, padded to
    `cfg.max_gt_boxes`."""
    from fcaf3d_tpu_torch.data.points import add_height
    from fcaf3d_tpu_torch.data.synth import synth_scene

    g = cfg.max_gt_boxes
    out = {"points": [], "gt_boxes": np.zeros((b, g, 7), np.float32),
           "gt_labels": np.zeros((b, g), np.int32),
           "gt_valid": np.zeros((b, g), bool)}
    rng = np.random.default_rng(seed)
    for i in range(b):
        xyz, _ = synth_scene(np.random.RandomState(seed + i), cfg.num_points,
                             extent=VOTE_TINY_EXTENT)
        out["points"].append(add_height(xyz))
        anchors = xyz[rng.choice(len(xyz), 2, replace=False)]
        for j, (a, side) in enumerate(((0, 0.5), (0, 0.7), (0, 0.9),
                                       (1, 0.6))):
            dims = side * rng.uniform(0.8, 1.2, 3)
            yaw = rng.uniform(-np.pi, np.pi) if cfg.with_yaw else 0.0
            c = anchors[a]
            out["gt_boxes"][i, j] = [c[0], c[1], c[2] - dims[2] / 2, *dims,
                                     yaw]
            out["gt_labels"][i, j] = rng.integers(0, cfg.n_classes)
            out["gt_valid"][i, j] = True
    out["points"] = np.stack(out["points"])
    return out


def imvote_frame(seed, n_points, n_classes, with_yaw=True, hw=(480, 640),
                 focal=570.0, n_boxes=8, extent=3.0, near=2.0,
                 cam_height=1.0):
    """One synthetic SUN RGB-D frame: a depth-frame scene (y forward, z up)
    in front of a camera of `focal` pixels at the image centre with Rt = I
    (`data.calib.sunrgbd_depth2img`), `crowded_scene` boxes on a floor
    `cam_height` below the camera, `extent` wide and deep from `near`
    ahead, sampled by `densify` to `n_points` (4/5 on the boxes). Returns
    {points [n_points, 3], image [H, W, 3] f32 (grey, each box's projection
    painted in its class's colour, far boxes first), depth2img [3, 3],
    gt_boxes [n, 7] bottom-centred, gt_labels [n], boxes2d [m, 6]: the
    boxes' projected corners' bounds clipped to the image, conf 1, of every
    box wholly in front of the camera whose bounds keep an area,
    boxes2d_index [m]: the GT box of each, calib: the SUN RGB-D {"K",
    "Rt"} of depth2img}."""
    from fcaf3d_tpu_torch.data.calib import sunrgbd_depth2img
    from fcaf3d_tpu_torch.data.synth import crowded_scene, densify

    rng = np.random.default_rng(seed)
    sample = crowded_scene(n_boxes, n_classes, rng, extent=extent,
                           with_yaw=with_yaw)
    sample["gt_boxes"][:, :3] += np.float32([-extent / 2, near, -cam_height])
    per_box = n_points * 4 // 5 // n_boxes
    scene = densify(sample, per_box, n_points - per_box * n_boxes, rng)
    h, w = hw
    calib = {"K": np.float32([[focal, 0, 0], [0, focal, 0],
                              [w / 2, h / 2, 1]]),
             "Rt": np.eye(3, dtype=np.float32)}
    d2i = sunrgbd_depth2img(calib)
    image = np.full((h, w, 3), 110.0, np.float32)
    boxes2d, depth, index = [], [], []
    for j, (box, label) in enumerate(zip(sample["gt_boxes"],
                                         sample["gt_labels"])):
        cx, cy, cz, dx, dy, dz, yaw = box
        unit = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                         for z in (0.0, 1.0)], np.float32)
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        corners = (unit * [dx, dy, dz]) @ rot.T + [cx, cy, cz]
        proj = corners @ d2i.T
        if (proj[:, 2] < 0.1).any():
            continue
        uv = proj[:, :2] / proj[:, 2:]
        x1, y1 = np.clip(uv.min(0), 0, [w, h])
        x2, y2 = np.clip(uv.max(0), 0, [w, h])
        if x2 - x1 >= 1 and y2 - y1 >= 1:
            boxes2d.append([x1, y1, x2, y2, 1.0, label])
            depth.append(cy)
            index.append(j)
    for i in np.argsort(depth)[::-1]:
        x1, y1, x2, y2, _, label = boxes2d[i]
        image[int(y1):int(np.ceil(y2)), int(x1):int(np.ceil(x2))] = (
            40 + 20 * label, 200 - 15 * label, 60 + 17 * label)
    return {"points": scene["points"][:, :3], "image": image,
            "depth2img": d2i.astype(np.float32),
            "gt_boxes": sample["gt_boxes"],
            "gt_labels": sample["gt_labels"].astype(np.int32),
            "boxes2d": np.asarray(boxes2d, np.float32).reshape(-1, 6),
            "boxes2d_index": np.asarray(index, np.int64), "calib": calib}


def imvote_batch(cfg, frames, max_det=32, seed=0):
    """ImVoteNet's training batch of `imvote_frame`s, as
    `tools/train_imvotenet.py --gt-boxes-2d` collates it: points with the
    height column sampled to `cfg.num_points`, images, depth2img, the GT 2D
    boxes (conf 1) padded to `max_det`, GT boxes padded to
    `cfg.max_gt_boxes`."""
    from fcaf3d_tpu_torch.apis.inference import votenet_inputs

    b, g = len(frames), cfg.max_gt_boxes
    out = {"points": np.stack([votenet_inputs(f["points"], cfg.num_points,
                                              seed + i)
                               for i, f in enumerate(frames)]),
           "images": np.stack([f["image"] for f in frames]),
           "depth2img": np.stack([f["depth2img"] for f in frames]),
           "boxes2d": np.zeros((b, max_det, 6), np.float32),
           "boxes2d_valid": np.zeros((b, max_det), bool),
           "gt_boxes": np.zeros((b, g, 7), np.float32),
           "gt_labels": np.zeros((b, g), np.int32),
           "gt_valid": np.zeros((b, g), bool)}
    for i, f in enumerate(frames):
        m, n = min(len(f["boxes2d"]), max_det), min(len(f["gt_boxes"]), g)
        out["boxes2d"][i, :m] = f["boxes2d"][:m]
        out["boxes2d_valid"][i, :m] = True
        out["gt_boxes"][i, :n] = f["gt_boxes"][:n]
        out["gt_labels"][i, :n] = f["gt_labels"][:n]
        out["gt_valid"][i, :n] = True
    return out


def vote_scan(seed, n):
    """One synthetic SUN RGB-D-like scan [n, 3] (xyz of
    `data.synth.synth_scene`)."""
    from fcaf3d_tpu_torch.data.synth import synth_scene

    return synth_scene(np.random.RandomState(seed), n)[0]


def pointnet_cases(torch, cfg, device):
    """The K5 and K6 cases of the VoteNet path of `cfg` on two scans
    [2, N, 3]: the backbone's xyz levels (each the FPS sample of the one
    before, by the plain version), and votes (the seeds moved by ~5 cm) for
    the aggregation. Returns (fps cases (name, points, S), ball-query cases
    (name, centres, points, radius, nsample))."""
    from fcaf3d_tpu_torch.models.votenet import VoteNet
    from fcaf3d_tpu_torch.ops.pointnet import gather_points
    from fcaf3d_tpu_torch.ops.pointnet.fps import furthest_point_sample_plain

    net = VoteNet(cfg, device="meta")
    lv = [torch.as_tensor(np.stack([vote_scan(s, cfg.num_points)
                                    for s in (0, 1)]), device=device)]
    for s in cfg.backbone_num_points:
        lv.append(gather_points(lv[-1], furthest_point_sample_plain(lv[-1],
                                                                    s)))
    seeds = lv[net.backbone.n_sa - net.backbone.n_fp]
    noise = np.random.default_rng(0).normal(0, 0.05, seeds.shape)
    votes = seeds + torch.as_tensor(noise.astype(np.float32), device=device)
    proposals = gather_points(votes, furthest_point_sample_plain(
        seeds, cfg.num_proposal))
    fps = [(f"SA{i + 1}", lv[i], s)
           for i, s in enumerate(cfg.backbone_num_points)]
    fps.append(("seeds", seeds, cfg.num_proposal))
    ballq = []
    for i in range(net.backbone.n_sa):
        sa = getattr(net.backbone, f"sa{i}")
        ballq.append((f"SA{i + 1}", lv[i + 1], lv[i], sa.radius,
                      sa.num_sample))
    agg = net.vote_aggregation
    ballq.append(("aggregation", proposals, votes, agg.radius,
                  agg.num_sample))
    return fps, ballq


def mask_of(torch, b, n, device, n_valid=None):
    """[b, n] bool: the first cloud all valid; the last with its first 3
    points and ~5% of the rest invalid (only the first `n_valid` of them
    valid when that is given)."""
    rng = np.random.default_rng(n)
    m = np.ones((b, n), bool)
    m[-1] = rng.random(n) > 0.05
    m[-1, :3] = False
    if n_valid is not None:
        m[-1, np.flatnonzero(m[-1])[n_valid:]] = False
    return torch.as_tensor(m, device=device)


def lattice_cloud(torch, b, n, device, seed=0):
    """[b, n, 3] f32 integer lattice points, each site drawn many times: a
    cloud of exact ties (equal distances and duplicated points)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, (9, 7, 5), (b, n, 3)).astype(
        np.float32), device=device)


def fps_plan_boundaries(s, n_max):
    """Every N up to n_max after which `fps_plan`'s variant (cluster size,
    points a thread, where the minima live) changes."""
    from fcaf3d_tpu_torch.ops.pointnet.fps import fps_plan

    out, last = [], None
    for n in range(1, n_max + 1):
        p = fps_plan(1, n, s)
        key = (p.cs, p.points_per_thread, p.where)
        if last is not None and key != last:
            out.append(n - 1)
        last = key
    return out


def empty_step(torch, plan, s, device):
    """The serial floor's launch: the cluster kernel at `plan`'s cluster
    and CTA size with one point a thread (P = 1, the smallest instance), on
    a cloud of one CTA's worth of points a rank whose first is its only
    valid one. Every step runs the whole protocol (warp argmax, candidate
    exchange, wait, the reduction of cs x warps candidates) and one
    distance update a thread. Not a strict bound: P = 1 is another compiled
    instance, whose step can read above the plan's own where the protocol
    is all of it (one CTA of 4 warps at SA4 and the seeds: PERF.md)."""
    from fcaf3d_tpu_torch.ops.pointnet.fps import furthest_point_sample

    one = plan._replace(points_per_thread=1)
    n = one.cs * one.threads
    x = torch.rand(1, n, 3, device=device)
    valid = torch.zeros(1, n, dtype=torch.bool, device=device)
    valid[0, ::one.threads] = True
    return lambda: furthest_point_sample(x, s, valid, _plan=one)


def pointnet_kernel_phase(torch, cfg, device):
    """K5 and K6 against their plain versions at every shape of the VoteNet
    path, at batch 1 and at batch 2 with a valid mask: exactly equal. Plus
    K5 with S above the valid count, with N beyond shared memory and beyond
    the cluster kernel's registers, on lattice tie clouds (SA1 and each
    side of every boundary of `fps_plan`) and at every cluster size of the
    sweep at SA1; K6 with centres that find no point. Times (batch 1) of
    each kernel and its plain version; K5 also beside its single-CTA kernel
    (the earlier one), its operations bound and its serial floor."""
    from fcaf3d_tpu_torch.ops.pointnet.ball_query import (
        ball_query, ball_query_plain, ball_query_plan)
    from fcaf3d_tpu_torch.ops.pointnet.fps import (
        CLUSTER_SIZE, MAX_CTA_POINTS, fps_plan, furthest_point_sample,
        furthest_point_sample_plain)

    gen = torch.Generator(device=device).manual_seed(0)
    fps_cases, ballq_cases = pointnet_cases(torch, cfg, device)
    small = torch.rand(2, 64, 3, generator=gen, device=device)
    big = torch.rand(2, 60000, 3, generator=gen, device=device) * 5
    beyond = CLUSTER_SIZE * MAX_CTA_POINTS + 1024
    huge = torch.rand(2, beyond, 3, generator=gen, device=device) * 5
    extra_fps = [("S > valid count", small, 32,
                  mask_of(torch, 2, 64, device, n_valid=20)),
                 ("no valid point", lattice_cloud(torch, 2, 20000, device),
                  16, torch.zeros(2, 20000, dtype=torch.bool, device=device)),
                 ("N beyond shared memory", big, 128,
                  mask_of(torch, 2, 60000, device)),
                 ("N beyond the cluster's registers", huge, 128,
                  mask_of(torch, 2, beyond, device))]
    far = torch.cat([small[:, :8], small[:, :4] + 10.0], dim=1)
    extra_ballq = [("centres without a hit", far, small, 0.3, 24,
                    mask_of(torch, 2, 64, device))]
    rec = {"fps": {"max_abs_err": 0}, "ball_query": {"max_abs_err": 0}}

    def check(name, what, got, want):
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: kernel != plain (max abs "
                                 f"index diff {err})")

    shapes = {}
    for what, pts, s in fps_cases:
        n = pts.shape[1]
        for b in (1, 2):
            x = pts[:b].contiguous()
            v = None if b == 1 else mask_of(torch, b, n, device)
            check("fps", f"{what} B={b}", furthest_point_sample(x, s, v),
                  furthest_point_sample_plain(x, s, v))
        x = pts[:1].contiguous()
        plan = fps_plan(1, n, s)
        times = timed_turns(torch, {
            "plain": lambda: furthest_point_sample_plain(x, s),
            "kernel": lambda: furthest_point_sample(x, s),
            "earlier": lambda: furthest_point_sample(x, s, _variant="single"),
            "floor": empty_step(torch, plan, s, device)})
        # the S x N distance updates; xyz read once, the indices written
        r = timing_record(times, (s * n * FPS_OPS, n * 12 + s * 4),
                          PEAK_OPS["float32"])
        r["plan"] = list(plan)
        log(f"   K5 {what} {n} -> {s}: exact at B=1 and B=2 (masked); plan "
            f"{tuple(plan)}; {report(r)}")
        shapes[what] = {k: r[k] for k in (
            "ms", "earlier_ms", "plain_ms", "bound_ms", "serial_floor_ms",
            "plan")}
        if "ms" not in rec["fps"]:
            rec["fps"].update(r)
    rec["fps"]["shapes"] = shapes
    for what, x, s, v in extra_fps:
        check("fps", what, furthest_point_sample(x, s, v),
              furthest_point_sample_plain(x, s, v))
        log(f"   K5 {what} ({x.shape[1]} -> {s}, B=2, masked, plan "
            f"{tuple(fps_plan(2, x.shape[1], s))}): exact")

    rec["fps"]["sweep"] = fps_sweeps(torch, fps_cases, check, device)
    fps_ties(torch, fps_cases[0], check, device)

    shapes = {}
    for what, cent, pts, r, ns in ballq_cases:
        m, n = cent.shape[1], pts.shape[1]
        for b in (1, 2):
            c, x = cent[:b].contiguous(), pts[:b].contiguous()
            v = None if b == 1 else mask_of(torch, b, n, device)
            want = ball_query_plain(c, x, r, ns, v)
            check("ball_query", f"{what} B={b}", ball_query(c, x, r, ns, v),
                  want)
            check("ball_query", f"{what} B={b} first kernel",
                  ball_query(c, x, r, ns, v, _variant="warp"), want)
        c, x = cent[:1].contiguous(), pts[:1].contiguous()
        times = timed_turns(torch, {
            "plain": lambda: ball_query_plain(c, x, r, ns),
            "kernel": lambda: ball_query(c, x, r, ns),
            "earlier": lambda: ball_query(c, x, r, ns, _variant="warp")})
        # each centre scans its points in index order up to its ns-th hit
        # (or all N); centres and points read once, the indices written
        rt = timing_record(times, (ballq_scanned(torch, c, x, r, ns)
                                   * BALLQ_OPS, (m + n) * 12 + m * ns * 4),
                           PEAK_OPS["float32"])
        rt["plan"] = list(ball_query_plan(1, m, n))
        host = host_turns(torch, {
            "kernel": lambda: ball_query(c, x, r, ns),
            "earlier": lambda: ball_query(c, x, r, ns, _variant="warp")})
        rt["enqueue_us"], rt["earlier_enqueue_us"] = (
            host["kernel"][0], host["earlier"][0])
        log(f"   K6 {what} M={m} N={n} r={r} ns={ns}: exact at B=1 and B=2 "
            f"(masked), and the first kernel; plan {tuple(rt['plan'])}; "
            f"{report(rt)}; host enqueue {rt['enqueue_us']:.1f} us a call "
            f"(the first kernel {rt['earlier_enqueue_us']:.1f})")
        shapes[what] = {k: rt[k] for k in (
            "ms", "earlier_ms", "plain_ms", "bound_ms", "share", "plan",
            "enqueue_us", "earlier_enqueue_us")}
        if rt["ms"] >= rt["earlier_ms"]:
            NOT_FASTER.append((f"K6 {what}", rt["ms"], rt["earlier_ms"],
                               rt["plain_ms"]))
            log(f"   NOT FASTER than the first kernel: K6 {what}")
        if "ms" not in rec["ball_query"]:
            rec["ball_query"].update(rt)
    scan = {k: sum(r[k] for r in shapes.values())
            for k in ("ms", "earlier_ms")}
    log(f"   K6 over a scan's {len(shapes)} calls: {scan['ms']:.4f} ms of "
        f"device time (the first kernel {scan['earlier_ms']:.4f})")
    rec["ball_query"].update(shapes=shapes, scan_ms=scan["ms"],
                             earlier_scan_ms=scan["earlier_ms"])
    for what, c, x, r, ns, v in extra_ballq + ballq_edges(torch, gen,
                                                          device):
        want = ball_query_plain(c, x, r, ns, v)
        b, m, n = c.shape[0], c.shape[1], x.shape[1]
        check("ball_query", what, ball_query(c, x, r, ns, v), want)
        if what == "centres without a hit" and want[:, 8:].any():
            raise AssertionError(f"K6 {what}: a centre without a hit is not "
                                 "all zeros")
        log(f"   K6 {what} (M={m}, N={n}, ns={ns}, B={b}"
            f"{', masked' if v is not None else ''}): exact")
    return rec


def ballq_edges(torch, gen, device):
    """K6's edge clouds (name, centres, points, radius, nsample, valid), B=2:
    N % 4 != 0 beyond one tile, N below one tile, M not a multiple of the
    CTA's centres, nsample above N, each masked and not; and a lattice
    cloud where points lie at exactly r^2 (r = 1, and sqrt 2, whose f32 r^2
    is 2.0), masked."""
    from fcaf3d_tpu_torch.ops.pointnet.ball_query import (
        BQ_TILE_POINTS, squared_radius)

    out = []
    for n, m in ((4099, 70), (BQ_TILE_POINTS * 2 + 1, 129), (1000, 33),
                 (7, 5)):
        x = torch.rand(2, n, 3, generator=gen, device=device) * 2
        c = torch.rand(2, m, 3, generator=gen, device=device) * 2
        for ns in (16, n + 5):
            for v in (None, mask_of(torch, 2, n, device)):
                out.append((f"N={n} M={m}", c, x, 0.3, ns, v))
    x = lattice_cloud(torch, 2, 3001, device)
    for r in (1.0, 2.0 ** 0.5):
        out.append((f"lattice r^2={squared_radius(r)}",
                    x[:, :50].contiguous(), x, r, 32,
                    mask_of(torch, 2, 3001, device)))
    return out


def fps_sweeps(torch, fps_cases, check, device):
    """K5 at SA1 at every cluster size of FPS_SWEEP, exact at B=1 and B=2
    (masked) through `check`, timed in turns beside its serial floor.
    Returns the times by cluster size."""
    from fcaf3d_tpu_torch.ops.pointnet.fps import (
        fps_plan, furthest_point_sample, furthest_point_sample_plain)

    what, pts, s = fps_cases[0]
    n = pts.shape[1]
    fns, sweep = {}, {}
    for cs in FPS_SWEEP:
        for b in (1, 2):
            x = pts[:b].contiguous()
            v = None if b == 1 else mask_of(torch, b, n, device)
            check("fps", f"{what} cluster of {cs} B={b}",
                  furthest_point_sample(x, s, v, _plan=fps_plan(
                      b, n, s, cluster=cs)),
                  furthest_point_sample_plain(x, s, v))
        plan = fps_plan(1, n, s, cluster=cs)
        fns[cs] = (lambda x=pts[:1].contiguous(), p=plan:
                   furthest_point_sample(x, s, _plan=p))
        fns[(cs, "floor")] = empty_step(torch, plan, s, device)
    times = timed_turns(torch, fns)
    for cs in FPS_SWEEP:
        ms, floor = times[cs][0], times[(cs, "floor")][0]
        plan = fps_plan(1, n, s, cluster=cs)
        sweep[str(cs)] = {"ms": ms, "serial_floor_ms": floor,
                          "plan": list(plan)}
        log(f"   K5 sweep {what} {n} -> {s}, {tuple(plan)}: exact at B=1 "
            f"and B=2 (masked); kernel {ms:.4f} ms, serial floor "
            f"{floor:.4f} ms (share {floor / ms:.3f})")
    return sweep


def fps_ties(torch, sa1_case, check, device):
    """K5 exactly equal to plain through `check` on lattice tie clouds (B=2,
    the second masked): at SA1, and at FPS_TIE_S samples on each side of
    every boundary of `fps_plan` up to the cluster's register capacity."""
    from fcaf3d_tpu_torch.ops.pointnet.fps import (
        CLUSTER_SIZE, MAX_CTA_POINTS, fps_plan, furthest_point_sample,
        furthest_point_sample_plain)

    _, pts, s = sa1_case
    n = pts.shape[1]
    ties = [(n, s)] + [(m, FPS_TIE_S) for edge in fps_plan_boundaries(
        FPS_TIE_S, CLUSTER_SIZE * MAX_CTA_POINTS + 1) for m in (edge,
                                                                edge + 1)]
    for m, s in ties:
        x = lattice_cloud(torch, 2, m, device, seed=m)
        v = mask_of(torch, 2, m, device)
        check("fps", f"tie cloud {m} -> {s}", furthest_point_sample(x, s, v),
              furthest_point_sample_plain(x, s, v))
    log(f"   K5 lattice tie clouds (B=2, the second masked) exact at "
        + ", ".join(f"{m} -> {s} {tuple(fps_plan(2, m, s))[:3]}"
                    for m, s in ties))


def ballq_scanned(torch, centers, points, radius, nsample):
    """Points a ball query scans for centres [1, M, 3] over points [1, N,
    3]: for each centre, up to and including its nsample-th hit (the
    direct d^2 < r^2), or all N."""
    d2 = ((points[0][None] - centers[0][:, None]) ** 2).sum(-1)
    count = torch.cumsum((d2 < radius * radius).int(), dim=1)
    full = count[:, -1] >= nsample
    first = torch.argmax((count >= nsample).int(), dim=1) + 1
    return int(torch.where(full, first, points.shape[1]).sum())


@contextlib.contextmanager
def wrapped_selections(wrap):
    """Every FPS and ball query of the VoteNet and ImVoteNet forwards goes
    through `wrap(kind, fn)` (kind "fps" in the SA modules, "ball_query",
    or "seed_fps" for the proposals of the "seed" mode), by the names the
    model modules call."""
    from fcaf3d_tpu_torch.models import imvotenet, pointnet2, votenet

    names = ((pointnet2, "furthest_point_sample", "fps"),
             (pointnet2, "ball_query", "ball_query"),
             (votenet, "furthest_point_sample", "seed_fps"),
             (imvotenet, "furthest_point_sample", "seed_fps"))
    saved = [getattr(mod, name) for mod, name, _ in names]
    for (mod, name, kind), fn in zip(names, saved):
        setattr(mod, name, wrap(kind, fn))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(names, saved):
            setattr(mod, name, fn)


def recorder(torch, calls):
    """A `wrapped_selections` wrapper appending (kind, arguments, result),
    on the CPU, to `calls`."""
    def wrap(kind, fn):
        def call(*args):
            out = fn(*args)
            calls.append((kind, [a.cpu() if torch.is_tensor(a) else a
                                 for a in args], out.cpu()))
            return out
        return call
    return wrap


def votenet_run(torch, model, x):
    """The body of `inference_votenet` on a prepared input [1, N, 4]:
    forward in the test mode and raw `VoteDetections`, with every FPS and
    ball query recorded; and the v1 head's decoded bins (the argmax of
    `dir_class` and `size_class`), on the CPU."""
    from fcaf3d_tpu_torch.models.votenet import votenet_get_bboxes

    cfg = model.cfg
    calls = []
    with torch.inference_mode(), wrapped_selections(recorder(torch, calls)):
        preds = model(x, sample_mod=cfg.sample_mod_test)
        dets = votenet_get_bboxes(preds, x, cfg.n_classes,
                                  nms_thr=cfg.nms_thr, score_thr=cfg.score_thr,
                                  per_class_proposal=cfg.per_class_proposal)
    bins = {k: preds[k].argmax(-1).cpu() for k in ("dir_class", "size_class")
            if k in preds}
    return calls, dets._replace(**{k: v.cpu() for k, v in
                                   dets._asdict().items()}), bins


def compare_votenet_f32(torch, model, cfg, scan_xyz, device):
    """One scan, card against CPU (same weights, same input): every FPS and
    the SA1-SA4 groups exactly equal; aggregation groups equal but for
    members within AGG_D2_TOL of r^2; on proposals whose group is equal the
    same detections (NMS keep masks exactly), boxes within BOX_ATOL and
    scores within SCORE_ATOL, and for the v1 head the same decoded
    direction and size bins."""
    from fcaf3d_tpu_torch.apis import init_votenet
    from fcaf3d_tpu_torch.apis.inference import votenet_inputs

    x = votenet_inputs(scan_xyz, cfg.num_points)[None]
    calls_g, dets_g, bins_g = votenet_run(torch, model, torch.as_tensor(
        x, device=device))
    calls_c, dets_c, bins_c = votenet_run(
        torch, init_votenet(cfg, 0, device="cpu",
                            coder=getattr(model, "coder", None)),
        torch.as_tensor(x))
    if [c[0] for c in calls_g] != [c[0] for c in calls_c]:
        raise AssertionError("VoteNet f32: the card and the CPU made other "
                             "FPS / ball-query calls")
    n_bq = sum(c[0] == "ball_query" for c in calls_c)
    seen_bq, flipped, eq_rows = 0, 0, None
    for (name, _, got), (_, args, want) in zip(calls_g, calls_c):
        if name == "ball_query":
            seen_bq += 1
        if seen_bq < n_bq or name != "ball_query":
            if not torch.equal(got, want):
                raise AssertionError(f"VoteNet f32: {name} call "
                                     f"{seen_bq} differs card vs CPU")
            continue
        # the aggregation: disputed members must lie within AGG_D2_TOL of r^2
        cent, pts, radius = args[0][0].double(), args[1][0].double(), args[2]
        eq_rows = (got[0] == want[0]).all(-1)
        for r in torch.nonzero(~eq_rows).flatten().tolist():
            disputed = set(got[0, r].tolist()) ^ set(want[0, r].tolist())
            d2 = ((pts[sorted(disputed)] - cent[r]) ** 2).sum(-1)
            flipped += len(disputed)
            if ((d2 - radius * radius).abs() > AGG_D2_TOL).any():
                raise AssertionError(f"VoteNet f32: aggregation group {r} "
                                     f"differs away from r^2: {d2.tolist()}")
    for k, b in bins_c.items():
        if not torch.equal(bins_g[k][0][eq_rows], b[0][eq_rows]):
            raise AssertionError(f"VoteNet f32: decoded {k} bins differ card "
                                 "vs CPU")
    same = eq_rows.repeat(cfg.n_classes if cfg.per_class_proposal else 1)
    vg, vc = dets_g.valid[0] & same, dets_c.valid[0] & same
    if not (vc.any() and torch.equal(vg, vc) and torch.equal(
            dets_g.labels[0][vc], dets_c.labels[0][vc])):
        raise AssertionError(f"VoteNet f32: {int(vg.sum())} detections on "
                             f"the card, {int(vc.sum())} on the CPU, or "
                             "other labels")
    box_err = float((dets_g.boxes[0][vc] - dets_c.boxes[0][vc]).abs().max())
    score_err = float((dets_g.scores[0][vc] - dets_c.scores[0][vc]).abs()
                      .max())
    log(f"   f32 card vs CPU: {len(calls_c)} FPS / ball-query calls, all "
        f"FPS and SA1-SA4 groups equal; aggregation: "
        f"{int((~eq_rows).sum())} of {len(eq_rows)} groups differ "
        f"({flipped} members within {AGG_D2_TOL} of r^2); "
        f"{int(vc.sum())} detections equal"
        + (f", decoded {' and '.join(bins_c)} bins equal" if bins_c else "")
        + f", max box err {box_err:.3g} "
        f"(tol {BOX_ATOL}), max score err {score_err:.3g} (tol {SCORE_ATOL})")
    if box_err > BOX_ATOL or score_err > SCORE_ATOL:
        raise AssertionError("VoteNet f32: card and CPU disagree")


def votenet_turns(torch, model, scans):
    """Per-scan wall ms of `inference_votenet` and device ms of its FPS and
    of its ball-query calls, with K5 and K6 as planned ("new") and with the
    kernels they replaced wrapped in ("earlier": K5's single-CTA kernel,
    K6's first kernel, one warp a centre), in turns: new, earlier, earlier,
    new. Each scan runs twice: bare for the wall time, then with CUDA events
    around each call behind a sleep kernel (TURN_SLEEP_CYCLES), so that an
    event times the kernel and not the host's enqueue of it. Returns
    variant -> (wall ms, FPS ms, ball-query ms) lists."""
    from fcaf3d_tpu_torch.apis import inference_votenet

    spans = {"fps": [], "ball_query": []}
    earlier = {"fps": "single", "seed_fps": "single", "ball_query": "warp"}

    def wrap_with(old, timed):
        def wrap(kind, fn):
            key = "ball_query" if kind == "ball_query" else "fps"

            def call(*args):
                variant = earlier[kind] if old else None
                if not timed:
                    return fn(*args, _variant=variant)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(TURN_SLEEP_CYCLES)
                start.record()
                out = fn(*args, _variant=variant)
                end.record()
                spans[key].append((start, end))
                return out
            return call
        return wrap

    res = {"new": ([], [], []), "earlier": ([], [], [])}
    for variant in ("new", "earlier", "earlier", "new"):
        for pts in scans:
            with wrapped_selections(wrap_with(variant == "earlier", False)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inference_votenet(model, pts)
                res[variant][0].append((time.perf_counter() - t0) * 1e3)
            for kept in spans.values():
                kept.clear()
            with wrapped_selections(wrap_with(variant == "earlier", True)):
                inference_votenet(model, pts)
            torch.cuda.synchronize()
            for i, key in ((1, "fps"), (2, "ball_query")):
                res[variant][i].append(sum(a.elapsed_time(b)
                                           for a, b in spans[key]))
    return res


def votenet_phase(torch, cfg, device):
    """`init_votenet(cfg)` in f32 and `inference_votenet` on VOTE_SCANS
    scans: per-scan wall time, non-empty finite detections, five K5 and five
    K6 launches per scan, every K5 launch on the cluster kernel (SA1 on a
    cluster of more than one CTA) and every K6 launch on the tiled kernel.
    Then the f32 card-vs-CPU comparison, one scan in "vote" mode (launches
    by variant and finiteness), and the scans' wall, FPS and ball-query
    device time with K5 and K6 against the kernels they replaced, in turns.
    Returns launches per kernel and by variant over the timed scans, and the
    turns' medians."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import inference_votenet, init_votenet
    from fcaf3d_tpu_torch.ops.pointnet.fps import fps_plan

    model = init_votenet(cfg, seed=0, device=device)
    scans = [vote_scan(s, cfg.num_points) for s in range(VOTE_SCANS)]

    def checked(dets, what):
        return check_detections(dets, cfg.n_classes, f"VoteNet {what}")

    inference_votenet(model, scans[0])  # warm-up: cuBLAS and allocator
    torch.cuda.synchronize()
    _native.reset_launches()
    times, counts = [], []
    for pts in scans:
        t0 = time.perf_counter()
        dets = inference_votenet(model, pts)
        times.append(time.perf_counter() - t0)
        counts.append(checked(dets, f"scan {len(counts)}"))
    launches = dict(_native.LAUNCHES)
    variants = {"/".join(key): n
                for key, n in sorted(_native.VARIANT_LAUNCHES.items())}
    for i, (dt, n) in enumerate(zip(times, counts)):
        log(f"   scan {i}: {dt * 1e3:.1f} ms wall, {n} detections")
    log(f"   launches over {len(scans)} scans: {launches}; K5 / K6 by "
        f"variant {variants}")
    check_vote_launches(launches, variants, 5, len(scans), "VoteNet")
    sa1 = fps_plan(1, cfg.num_points, cfg.backbone_num_points[0])
    if sa1.cs < 2:
        raise AssertionError(f"VoteNet: SA1 plan {sa1}, expected a cluster "
                             "of more than one CTA")
    compare_votenet_f32(torch, model, cfg, scans[0], device)
    _native.reset_launches()
    n = checked(inference_votenet(model, scans[1], sample_mod="vote"),
                "vote mode")
    vote_launches = dict(_native.LAUNCHES)
    vote_variants = {"/".join(key): n
                     for key, n in sorted(_native.VARIANT_LAUNCHES.items())}
    check_vote_launches(vote_launches, vote_variants, 5, 1,
                        "VoteNet vote mode")
    log(f"   \"vote\" mode, scan 1: {n} detections, launches {vote_launches}")
    turns = votenet_turns(torch, model, scans)
    for variant, (wall, fps, ballq) in turns.items():
        log(f"   K5 / K6 {variant}: scan wall ms "
            + " ".join(f"{t:.1f}" for t in wall) + "; FPS device ms "
            + " ".join(f"{t:.3f}" for t in fps) + "; ball-query device ms "
            + " ".join(f"{t:.4f}" for t in ballq))
    medians = {variant: {k: float(np.median(v)) for k, v in zip(
        ("wall_ms", "fps_ms", "ball_query_ms"), lists)}
        for variant, lists in turns.items()}
    return launches, variants, medians


def config_scan(name, seed):
    """One scan [N, 6] (xyz + rgb) of a config's own acquisition model
    (`data.synth`): for the ScanNet variants the 50 000-point synthetic
    scans of phase 5, for S3DIS a dense 1M-point room sampled to 100 000
    points, for SUN RGB-D one z-buffered Kinect frame sampled to 100 000
    points; colours drawn from the seed."""
    from fcaf3d_tpu_torch.data.synth import synth_s3dis, synth_sunrgbd

    if name.startswith("fcaf3d_scannet"):
        return scan(seed)
    rng = np.random.RandomState(seed)
    xyz = synth_sunrgbd(rng) if name == "fcaf3d_sunrgbd" else synth_s3dis(rng)
    rgb = rng.uniform(0, 255, xyz.shape).astype(np.float32)
    return np.concatenate([xyz, rgb], axis=1)


def stem_rows(torch, cfg, points, gen):
    """K2 at the stem (C3 E64 K27, as the path runs it: the plain sum) and
    K3 at the s2 pool, bf16, on the stride-1 and stride-2 maps of one of
    the config's scans: within K2_RTOL of / exactly equal to plain, timed
    in turns (`k2_timing`; K3 beside its plain version and the first
    kernel), with bound and share. Returns {"gather_gemm": record,
    "gather_max": record}."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    maps = backbone_maps(sample(points, cfg)[None], cfg, "cuda")
    idx, n = maps["s1_k3s2"]
    feats = torch.randn(1, n, 3, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn(27, 3, 64, generator=gen, device="cuda")
         / np.sqrt(81)).to(torch.bfloat16)
    got = gk.fused_gather_gemm(feats, idx, w).float()
    want = gk.fused_gather_gemm_plain(feats, idx, w).float()
    diff = float((got - want).abs().max())
    if not diff <= K2_RTOL["bfloat16"] * max(float(want.abs().max()), 1.0):
        raise AssertionError(f"K2 stem {tuple(idx.shape)}: max abs diff "
                             f"{diff}")
    k2 = k2_timing(torch, feats, idx, w, {}, "bfloat16")
    k2["max_abs_err"] = diff
    k2["shape"] = [list(idx.shape), n, 3, 64]
    log(f"   K2 stem C=3 E=64 K=27 bf16 idx {tuple(idx.shape)} N={n}: "
        f"within tolerance of plain (max abs diff {diff:.3g}); "
        f"{k2['variant']}: {report(k2)}")
    idx, n = maps["s2_pool_k2s2"]
    feats = torch.randn(1, n, 64, generator=gen, device="cuda").to(
        torch.bfloat16)
    if not torch.equal(gk.fused_gather_max(feats, idx),
                       gk.fused_gather_max_plain(feats, idx)):
        raise AssertionError(f"K3 pool {tuple(idx.shape)}: kernel != plain")
    k3 = k3_timing(torch, feats, idx)
    k3["max_abs_err"] = 0.0
    k3["shape"] = [list(idx.shape), n, 64]
    log(f"   K3 pool bf16 idx {tuple(idx.shape)} N={n} C=64: exact; "
        f"{k3['variant']}: {report(k3)}")
    return {"gather_gemm": k2, "gather_max": k3}


def rotated_nms_cost(torch, cfg, points):
    """The BEV NMS of one bf16 scan replayed on its own candidates
    ([1, C, nms_cap] boxes): device-synchronised wall ms over NMS_REPS calls
    and the peak memory above what was allocated before, rotated (the
    path's) and axis-aligned, in turns; the rotated keep mask equal to the
    path's. Returns {"rotated": (ms, peak bytes), "aligned": ...}."""
    from fcaf3d_tpu_torch.apis import inference_detector, init_detector
    from fcaf3d_tpu_torch.core.nms import nms_bev

    calls = []
    with recorded_nms(calls):
        inference_detector(init_detector(cfg, seed=0, device="cuda"), points)
    (boxes, scores, thr, valid, rotated), keep = calls[0]
    if not rotated or not torch.equal(
            nms_bev(boxes, scores, thr, valid=valid, rotated=True), keep):
        raise AssertionError("rotated NMS: replay != the path's keep mask")

    def run(rot):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(NMS_REPS):
            nms_bev(boxes, scores, thr, valid=valid, rotated=rot)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) / NMS_REPS * 1e3,
                torch.cuda.max_memory_allocated() - base)

    run(True)  # warm-up
    got = {"rotated": [], "aligned": []}
    for rot in (True, False, False, True):
        got["rotated" if rot else "aligned"].append(run(rot))
    out = {k: (float(np.mean([t for t, _ in v])), max(b for _, b in v))
           for k, v in got.items()}
    b, c, k = boxes.shape[:-1]
    log(f"   BEV NMS of one scan, [{b}, {c}, {k}] candidates ({b * c * k * k} "
        f"pairs, 24 vertex candidates a pair rotated): rotated "
        f"{out['rotated'][0]:.2f} ms, peak "
        f"{out['rotated'][1] / 2**20:.0f} MiB above the scan's; axis-aligned "
        f"{out['aligned'][0]:.2f} ms, {out['aligned'][1] / 2**20:.0f} MiB "
        "(readings " + ", ".join(f"{k} " + "/".join(f"{t:.2f}" for t, _ in v)
                                 for k, v in got.items()) + ")")
    return out


def other_configs_phase(torch, device):
    """Phase 9: the other FCAF3D configs (module docstring). Returns
    (launches by path, launches by variant by path, K1 records by path,
    {config: `stem_rows`} for SUN RGB-D and S3DIS)."""
    from fcaf3d_tpu_torch import _native, configs

    launches, variants, k1 = {}, {}, {}
    gen = torch.Generator(device=device).manual_seed(0)
    rows = {}
    for name in OTHER_CONFIGS:
        cfg = getattr(configs, name)()
        path = f"{name}_inference"
        log(f"   -- {name}: {cfg.n_classes} classes, {cfg.n_reg_outs} "
            f"regression outputs, {cfg.n_outs} scales, "
            f"{cfg.voxel_size * 100:g} cm voxels, with_yaw {cfg.with_yaw}")
        scans = [config_scan(name, seed) for seed in range(OTHER_SCANS)]
        launches[path], variants[path], k1[path] = slice_phase(
            torch, cfg, scans, device, path)
        if name in ("fcaf3d_sunrgbd", "fcaf3d_s3dis"):
            rows[name] = stem_rows(torch, cfg, scans[0], gen)
    sun = configs.fcaf3d_sunrgbd()
    sun_scan = config_scan("fcaf3d_sunrgbd", 0)
    rotated_nms_cost(torch, sun, sun_scan)
    log("   -- fcaf3d_sunrgbd f32, one scan, card against the CPU")
    compare_f32(torch, sun, sun_scan, device)
    log(f"   -- fcaf3d_sunrgbd training, bf16, batch {TRAIN_BATCH} of "
        f"crowded scenes with yawed boxes")
    path = "fcaf3d_sunrgbd_training"
    batch = train_batch(sun, TRAIN_BATCH, seed0=0)
    launches[path], variants[path], k1[path], _ = train_phase(
        torch, sun, batch, device, steps=SUN_TRAIN_STEPS, path=path)
    _native.reset_launches()
    compare_train_tiny(torch, device, with_yaw=True)
    check_variants("f32 tiny with_yaw train step", f32=True)
    return launches, variants, k1, rows


def shape_rows(torch, calls, k2_shapes, k4_shapes, rows, what):
    """The first recorded call (`recorded_conv_calls`) of a run at each
    (M, K, C, E) of `k2_shapes` (K2 on its own inputs and epilogue,
    `k2_timing`) and of `k4_shapes` (K4 on its map, `k4_case`), timed with
    bound and share, into rows["gather_gemm"] / rows["gather_dw"] under
    "`what` M.. K.. C.. E..". Fails unless every shape was found."""
    found = set()
    for args, kw in calls.get("fused_gather_gemm", ()):
        feats, idx, w = args
        key = (idx.shape[1],) + tuple(w.shape)
        if key not in k2_shapes or ("K2",) + key in found:
            continue
        found.add(("K2",) + key)
        name = f"{what} M{key[0]} K{key[1]} C{key[2]} E{key[3]}"
        dname = str(feats.dtype).split(".")[1]
        with torch.inference_mode():
            r = k2_timing(torch, feats, idx, w, kw, dname)
        r["shape"] = [list(idx.shape), feats.shape[1], key[2], key[3]]
        rows["gather_gemm"][name] = r
        log(f"   K2 {name} {dname} N={feats.shape[1]}"
            f"{' with epilogue' if kw else ''}: {r['variant']} "
            f"{r.get('tile', '')}: {report(r)}")
        if dname == "bfloat16":
            tc_yardsticks(f"K2 {name}", r)
    for args, _ in calls.get("fused_gather_dw", ()):
        feats, idx, dout = args
        key = (idx.shape[1], idx.shape[2], feats.shape[2], dout.shape[2])
        if key not in k4_shapes or ("K4",) + key in found:
            continue
        found.add(("K4",) + key)
        name = f"{what} M{key[0]} K{key[1]} C{key[2]} E{key[3]}"
        r, _ = k4_case(torch, (idx, feats.shape[1]), key[2], key[3],
                       "bfloat16", name)
        r["shape"] = [list(idx.shape), feats.shape[1], key[2], key[3]]
        rows["gather_dw"][name] = r
    want = {("K2",) + k for k in k2_shapes} | {("K4",) + k for k in k4_shapes}
    if found != want:
        raise AssertionError(f"{what}: no recorded call at {want - found}")


def neck_turns(torch, cfg, scans, device):
    """bf16 walls of `inference_detector` with each neck order on the same
    scans, in turns (prune-early, reference, then reversed; REST_TURNS
    passes), after a warm-up scan each, with each order's peak memory above
    what was allocated before. Returns {mode: (mean ms, [ms], peak
    bytes)}."""
    from fcaf3d_tpu_torch.apis import inference_detector, init_detector

    modes = ("prune_early", "reference")
    models = {m: init_detector(dataclasses.replace(cfg, neck_mode=m), 0,
                               device=device) for m in modes}
    walls, peaks = {m: [] for m in modes}, {m: 0 for m in modes}
    for m in modes:
        inference_detector(models[m], scans[0])
    for t in range(REST_TURNS):
        for m in (modes if t % 2 == 0 else modes[::-1]):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for pts in scans:
                t0 = time.perf_counter()
                inference_detector(models[m], pts)
                walls[m].append((time.perf_counter() - t0) * 1e3)
            peaks[m] = max(peaks[m], torch.cuda.max_memory_allocated() - base)
    out = {m: (float(np.mean(walls[m])), walls[m], peaks[m]) for m in modes}
    log("   bf16 walls a scan in turns, " + "; ".join(
        f"{m} mean {v[0]:.1f} ms (" + "/".join(f"{t:.1f}" for t in v[1])
        + f"), peak {v[2] / 2**20:.0f} MiB above the model's"
        for m, v in out.items()))
    return out


def voxelize_reduce_phase(torch, cfg, points, device):
    """`voxelize_reduce`, mean and max, on one scan sampled to
    `cfg.num_points` at `cfg.input_budget`: keys, coords, shift and
    `dropped` equal to the CPU's, features within VOXEL_REDUCE_ATOL, and
    two runs on the card bitwise equal; each timed (CUDA events). Returns
    the launches of the four checked runs and their launches by variant."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.ops.sparse import voxelize_reduce

    cloud = sample(points, cfg)[None]

    def run(dev, reduce):
        p = torch.as_tensor(cloud[..., :3].astype(np.float32), device=dev)
        c = torch.as_tensor(cloud[..., 3:6].astype(np.float32) / 255.0,
                            device=dev)
        v = torch.ones(p.shape[:2], dtype=torch.bool, device=dev)
        return voxelize_reduce(p, c, v, cfg.voxel_size, cfg.input_budget,
                               reduce)

    _native.reset_launches()
    results = {}
    for reduce in ("mean", "max"):
        got, again, want = run(device, reduce), run(device, reduce),             run("cpu", reduce)
        for name in ("keys", "coords", "shift", "dropped"):
            if not torch.equal(getattr(got, name).cpu(), getattr(want, name)):
                raise AssertionError(f"voxelize_reduce {reduce}: {name} "
                                     "differs card vs CPU")
        err = float((got.feats.cpu() - want.feats).abs().max())
        if not (err <= VOXEL_REDUCE_ATOL and torch.equal(got.feats,
                                                         again.feats)):
            raise AssertionError(f"voxelize_reduce {reduce}: feats err {err}"
                                 f" (tol {VOXEL_REDUCE_ATOL}), two runs "
                                 f"bitwise equal {torch.equal(got.feats, again.feats)}")
        results[reduce] = (err, int((want.keys != (2 ** 32 - 1)).sum()),
                           int(want.dropped.sum()))
    launches = dict(_native.LAUNCHES)
    variants = check_variants("voxelize_reduce")
    check_path_launches(launches, "voxelize_reduce")
    for reduce, (err, n, dropped) in results.items():
        ms = cuda_ms(torch, lambda: run(device, reduce), reps=5)
        log(f"   voxelize_reduce {reduce}: {n} voxels of {cfg.input_budget} "
            f"from {cfg.num_points} points, dropped {dropped}; keys equal "
            f"card vs CPU, feats max abs err {err:.3g} (tol "
            f"{VOXEL_REDUCE_ATOL}), two card runs bitwise equal; {ms:.3f} "
            "ms")
    return launches, variants


def rest_of_fcaf3d_phase(torch, cfg, scans, batch, device):
    """Phase 10: the reference neck, depth 50 and 101 and `voxelize_reduce`
    (module docstring). Returns (launches by path, launches by variant by
    path, K1 records by path, {"gather_gemm": rows, "gather_dw": rows} of
    `shape_rows`)."""
    from fcaf3d_tpu_torch import _native

    launches, variants, k1 = {}, {}, {}
    rows = {"gather_gemm": {}, "gather_dw": {}}
    scans = scans[:REST_SCANS]
    ref = dataclasses.replace(cfg, neck_mode="reference")
    log("   -- the reference neck: bf16 inference, batch 1")
    path = "fcaf3d_reference_inference"
    launches[path], variants[path], k1[path] = slice_phase(
        torch, ref, scans, device, path, on_calls=lambda calls: shape_rows(
            torch, calls, REFERENCE_ROWS, (), rows, "reference up conv"))
    neck_turns(torch, cfg, scans, device)
    log("   -- the reference neck, f32, one scan, card against the CPU")
    compare_f32(torch, ref, scans[0], device)
    log(f"   -- the reference neck: bf16 training, batch {TRAIN_BATCH}")
    path = "fcaf3d_reference_training"
    launches[path], variants[path], k1[path], _ = train_phase(
        torch, ref, batch, device, steps=REST_TRAIN_STEPS, path=path,
        on_calls=lambda calls: shape_rows(
            torch, calls, (), REFERENCE_ROWS, rows, "reference up conv"))
    _native.reset_launches()
    compare_train_tiny(torch, device, neck_mode="reference")
    check_variants("f32 tiny reference-neck train step", f32=True)
    for depth in DEEP_TRAIN_STEPS:
        log(f"   -- depth {depth}: bf16 inference, batch 1")
        path = f"fcaf3d_depth{depth}_inference"
        on_calls = None if depth != 50 else (
            lambda calls: shape_rows(torch, calls, DEEP_ROWS, (), rows,
                                     "depth 50"))
        launches[path], variants[path], k1[path] = slice_phase(
            torch, dataclasses.replace(cfg, depth=depth), scans, device,
            path, on_calls=on_calls)
    log("   -- depth 50, f32, one scan, card against the CPU")
    compare_f32(torch, dataclasses.replace(cfg, depth=50), scans[0], device)
    for depth, steps in DEEP_TRAIN_STEPS.items():
        log(f"   -- depth {depth}: bf16 training, batch {TRAIN_BATCH}")
        path = f"fcaf3d_depth{depth}_training"
        on_calls = None if depth != 50 else (
            lambda calls: shape_rows(torch, calls, (), DEEP_ROWS, rows,
                                     "depth 50"))
        launches[path], variants[path], k1[path], _ = train_phase(
            torch, dataclasses.replace(cfg, depth=depth), batch, device,
            steps=steps, path=path, on_calls=on_calls)
    _native.reset_launches()
    compare_train_tiny(torch, device, depth=50)
    check_variants("f32 tiny depth-50 train step", f32=True)
    log("   -- voxelize_reduce at the ScanNet input budget")
    path = "voxelize_reduce"
    launches[path], variants[path] = voxelize_reduce_phase(torch, cfg,
                                                           scans[0], device)
    return launches, variants, k1, rows


def vote_train_batch(cfg, batch, seed0):
    """`train_batch`'s crowded scenes (yawed boxes with `cfg.with_yaw`),
    sampled to `cfg.num_points`, as VoteNet input: xyz and the height
    column (`data.points.add_height`); GT padded to `cfg.max_gt_boxes`."""
    from fcaf3d_tpu_torch.data.points import add_height

    b = train_batch(cfg, batch, seed0)
    return {"points": np.stack([add_height(p) for p in b["points"]]),
            **{k: b[k] for k in ("gt_boxes", "gt_labels", "gt_valid")}}


def grad_recorder(torch, calls):
    """A `wrapped_selections` wrapper appending (kind, arguments detached,
    result, which arguments required grad, which were contiguous) to
    `calls`, on the device."""
    def wrap(kind, fn):
        def call(*args):
            out = fn(*args)
            calls.append((kind, [a.detach() if torch.is_tensor(a) else a
                                 for a in args], out,
                          [torch.is_tensor(a) and a.requires_grad
                           for a in args],
                          [torch.is_tensor(a) and a.is_contiguous()
                           for a in args]))
            return out
        return call
    return wrap


def hold_selections_to_plain(torch, calls, what):
    """Every recorded K5 and K6 call (`grad_recorder`) replayed through its
    plain version on its own inputs: `torch.equal` to the kernel's result.
    Returns the number of calls whose first argument required grad (the
    proposals' FPS and ball query over the votes in "vote" mode)."""
    from fcaf3d_tpu_torch.ops.pointnet.ball_query import ball_query_plain
    from fcaf3d_tpu_torch.ops.pointnet.fps import furthest_point_sample_plain

    with_grad = 0
    shapes = []
    for kind, args, out, req, contig in calls:
        plain = (ball_query_plain if kind == "ball_query"
                 else furthest_point_sample_plain)
        if not torch.equal(out, plain(*args)):
            raise AssertionError(f"{what}: {kind} {tuple(args[0].shape)} "
                                 "differs from its plain version")
        if req[0]:
            if not contig[0]:
                raise AssertionError(f"{what}: {kind} took a non-contiguous "
                                     "tensor that requires grad")
            with_grad += 1
        shapes.append(f"{kind} {tuple(args[0].shape)}"
                      + (" (requires grad)" if req[0] else ""))
    log(f"   {what}: its {len(calls)} K5 / K6 calls equal to plain: "
        + "; ".join(shapes))
    return with_grad


def check_vote_launches(launches, variants, calls_per_run, runs, what):
    """`calls_per_run` K5 and as many K6 launches a run, every K5 on the
    cluster kernel and every K6 on the tiled kernel, nothing else."""
    want = {k: calls_per_run * runs if k in ("fps", "ball_query") else 0
            for k in launches}
    on_path = {"fps/cluster/float32": want["fps"],
               "ball_query/tiled/float32": want["ball_query"]}
    if launches != want or variants != on_path:
        raise AssertionError(f"{what}: launches {launches}, by variant "
                             f"{variants}; expected {want}, {on_path}")


def vote_train_phase(torch, cfg, batch, device, steps, path, coder=None):
    """VoteNet training at `cfg` (v2, or v1 with `coder`) in f32 on the
    card, from `create_votenet_train_state`: `held_and_timed_steps` with
    live vote, centre and IoU (v1: size-class) losses, 5 K5 and 5 K6
    launches a step. Returns its (launches, launches by variant, record,
    the warm-up's recorded calls)."""
    from fcaf3d_tpu_torch.train import (
        create_votenet_train_state, make_votenet_train_step,
        make_votenet_v1_train_step)

    model, opt, _ = create_votenet_train_state(cfg, seed=0, device=device,
                                               coder=coder)
    make = (make_votenet_v1_train_step if cfg.head_version == "v1"
            else make_votenet_train_step)
    live = (("vote_loss", "center_loss", "iou_loss")
            if cfg.head_version == "v2"
            else ("vote_loss", "center_loss", "size_class_loss"))
    return held_and_timed_steps(torch, model, make(model, cfg, opt), batch,
                                steps, path, live, 5, cfg)


def held_and_timed_steps(torch, model, step, batch, steps, path, live,
                         calls_per_step, cfg):
    """A warm-up step whose K5 and K6 calls are held to their plain
    versions (`hold_selections_to_plain`; the proposals' FPS and ball query
    take the votes, which require grad: at least two such calls), then
    `steps` timed steps, each with finite metrics, the losses `live` above
    0, finite non-zero gradients on every Dense kernel and every running BN
    statistic moved; `calls_per_step` K5 and as many K6 launches a step on
    the path's variants. Logs the step walls (after a synchronise) and
    CUDA-event spans, the peak memory and how many of SA1's K5 clusters the
    card holds at once. Returns (launches, launches by variant, record, the
    warm-up's recorded calls)."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.ops.pointnet.fps import (
        fps_plan, max_active_clusters)

    b = len(batch["points"])
    what = f"one batch-{b} {path} step"
    calls = []
    with wrapped_selections(grad_recorder(torch, calls)):
        step(batch)  # warm-up: cuBLAS and the allocator
    torch.cuda.synchronize()
    if hold_selections_to_plain(torch, calls, what) < 2:
        raise AssertionError(f"{what}: the proposals' FPS and ball query "
                             "did not take the votes (vote mode)")
    kept = calls[:]
    del calls
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launches()
    walls, spans = [], []
    for i in range(steps):
        before = {n: v.clone() for n, v in model.named_buffers()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        m = step(batch)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        spans.append(start.elapsed_time(end))
        m = {k: float(v) for k, v in m.items()}
        log(f"   step {i}: {walls[-1]:.1f} ms wall, {spans[-1]:.1f} ms "
            "between CUDA events; " + ", ".join(f"{k} {v:.5g}"
                                                for k, v in m.items()))
        if not all(np.isfinite(v) for v in m.values()) \
                or min(m[k] for k in live) <= 0:
            raise AssertionError(f"{path} step {i}: metrics {m}, expected "
                                 f"finite and live {live}")
        for name, p in model.named_parameters():
            if name.endswith("kernel") and (
                    p.grad is None or not torch.isfinite(p.grad).all()
                    or not p.grad.abs().max() > 0):
                raise AssertionError(f"{path} step {i}: {name} gradient "
                                     "missing, non-finite or zero")
        still = [n for n, v in model.named_buffers()
                 if torch.equal(v, before[n])]
        if still:
            raise AssertionError(f"{path} step {i}: running statistics "
                                 f"unchanged: {still[:4]}")
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_native.LAUNCHES)
    variants = {"/".join(key): n
                for key, n in sorted(_native.VARIANT_LAUNCHES.items())}
    check_vote_launches(launches, variants, calls_per_step, steps, path)
    sa1 = fps_plan(b, cfg.num_points, cfg.backbone_num_points[0])
    clusters = max_active_clusters(sa1)
    n_kernels = sum(n.endswith("kernel") for n, _ in model.named_parameters())
    log(f"   {steps} steps at batch {b}: wall {np.mean(walls):.1f} ms/step "
        f"(min {min(walls):.1f}), CUDA-event span {np.mean(spans):.1f} "
        f"ms/step; peak memory {peak / 2**30:.2f} GiB; {n_kernels} Dense "
        f"kernels with finite non-zero gradients; every running statistic "
        f"moved; launches {launches}; SA1's K5 plan {tuple(sa1)} at B={b}: "
        f"{clusters} clusters fit at once"
        + (f" (FEWER than the {b} clouds: the rest wait)" if clusters < b
           else ""))
    rec = {"batch": b, "step_wall_ms": float(np.mean(walls)),
           "step_event_ms": float(np.mean(spans)),
           "peak_gib": peak / 2**30, "sa1_plan": list(sa1),
           "sa1_active_clusters": clusters}
    return launches, variants, rec, kept


def relu_sides(torch, model, store, types):
    """Forward hooks that keep the output (on the CPU) of every module of
    `types` in `store` by module name: a ReLU's input (a BatchNorm ahead of
    one) or output (a block ending in one), whose sign says the side the
    ReLU took; returns the handles."""
    def hook(name):
        def keep(mod, args, out):
            store[name] = out.detach().cpu()
        return keep
    return [mod.register_forward_hook(hook(name))
            for name, mod in model.named_modules()
            if isinstance(mod, types)]


def fps_flip_is_a_tie(torch, points, got, want):
    """At the first index where two FPS selections over `points` [N, 3]
    differ, the two candidates' running-minimum distances to the common
    prefix lie within VOTE_FPS_RTOL (relative) of each other. Returns that
    relative gap (0 when they are equal)."""
    diff = torch.nonzero(got != want).flatten()
    if len(diff) == 0:
        return 0.0
    k = int(diff[0])
    pts = points.double()
    prefix = pts[want[:k].long()]
    d = ((pts[None, :, :] - prefix[:, None, :]) ** 2).sum(-1).amin(0)
    a, b = float(d[int(got[k])]), float(d[int(want[k])])
    gap = abs(a - b) / max(a, b)
    if gap > VOTE_FPS_RTOL:
        raise AssertionError(f"proposal FPS differs card vs CPU at step {k} "
                             f"away from a tie: running minima {a}, {b}")
    return gap


BACKBONE_CALLS = 8  # FPS and ball query of SA1-SA4, the first calls


def replaying(torch, calls, replay, flips):
    """A `wrapped_selections` wrapper appending (kind, arguments, result)
    on the CPU to `calls`; with `replay` (another device's calls) it checks
    the backbone's calls equal to the replayed ones exactly, each later FPS
    equal but for a flip at a running-minimum tie (`fps_flip_is_a_tie`) and
    each later group equal but for members within AGG_D2_TOL of r^2
    (counted in `flips`), then returns the replayed result."""
    def wrap(kind, fn):
        def call(*args):
            out = fn(*args)
            i = len(calls)
            calls.append((kind, [a.detach().cpu() if torch.is_tensor(a)
                                 else a for a in args], out.cpu()))
            if replay is None:
                return out
            want = replay[i][2]
            if i < BACKBONE_CALLS and not torch.equal(out, want):
                raise AssertionError(f"{kind} call {i} (backbone) differs "
                                     "from the replayed device's")
            if kind in ("fps", "seed_fps"):
                for j in range(out.shape[0]):
                    flips["fps_gap"] = max(flips["fps_gap"], fps_flip_is_a_tie(
                        torch, args[0][j].detach(), want[j], out[j]))
            elif not torch.equal(out, want):
                cent, pts, radius = args[0].detach(), args[1].detach(), args[2]
                for bb, r in torch.nonzero((out != want).any(-1)).tolist():
                    disputed = sorted(set(out[bb, r].tolist())
                                      ^ set(want[bb, r].tolist()))
                    d2 = ((pts[bb, disputed].double() - cent[bb, r].double())
                          ** 2).sum(-1)
                    flips["members"] += len(disputed)
                    if ((d2 - radius * radius).abs() > AGG_D2_TOL).any():
                        raise AssertionError(
                            f"aggregation group {r} differs from the "
                            f"replayed device's away from r^2: "
                            f"{d2.tolist()}")
            return want.to(out.device)
        return call
    return wrap


def vote_step_on(torch, build, batch, device, relu_types, replay=None):
    """One f32 train step on `device` of `build(device)` -> (model, step)
    from the seed-0 variables: (its FPS / ball-query calls (kind, arguments,
    result) on the CPU, the metrics, the gradients, the running statistics
    and the output of every module of `relu_types` (`relu_sides`), on the
    CPU, and the flips `replaying` found, with `replay`, the card's calls,
    whose proposals and groups the CPU run then takes)."""
    model, step = build(device)
    calls, bn, flips = [], {}, {"fps_gap": 0.0, "members": 0}
    handles = relu_sides(torch, model, bn, relu_types)
    with wrapped_selections(replaying(torch, calls, replay, flips)):
        metrics = step(batch)
    for h in handles:
        h.remove()
    return (calls, {k: float(v) for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: v.cpu() for n, v in model.named_buffers()}, bn, flips)


def compare_vote_train_tiny(torch, device, head_version, coder=None):
    """The tight f32 gate at `votenet_tiny` (`head_version`, v1 with
    `coder`), batch 2 (`vote_head_batch`): `train_gate` of
    `make_votenet_train_step` (v1: `make_votenet_v1_train_step`)."""
    from fcaf3d_tpu_torch.configs import votenet_tiny
    from fcaf3d_tpu_torch.train import (
        create_votenet_train_state, make_votenet_train_step,
        make_votenet_v1_train_step)

    cfg = dataclasses.replace(votenet_tiny(), head_version=head_version)
    make = (make_votenet_v1_train_step if cfg.head_version == "v1"
            else make_votenet_train_step)

    def build(dev):
        model, opt, _ = create_votenet_train_state(cfg, seed=0, device=dev,
                                                   coder=coder)
        return model, make(model, cfg, opt)

    return train_gate(torch, build, vote_head_batch(cfg), device,
                      f"f32 tiny VoteNet-{head_version} train step")


def train_gate(torch, build, batch, device, what, relu_types=None):
    """The same train step (`build(device)` -> (model, step)) on the card
    and on the CPU from the same numpy variables and batch. Every backbone
    FPS index and SA group exactly equal; the proposals and their groups as
    `replaying` holds them; each loss within TRAIN_LOSS_RTOL of the total
    loss (a random v1 head's size-residual loss is ~2e-4 of it, and its own
    relative error reads ~1.5e-5 on an H100 against the CPU); the running
    statistics within VOTE_STATS_ATOL; every gradient element within
    TINY_GRAD_RTOL of its leaf's largest (a Dense bias ahead of a
    train-mode BN, whose exact gradient is 0, of its kernel's largest).
    Where a ReLU's input changes sign card vs CPU (each such input within
    RELU_TIE_ATOL of 0: the max-pools see a group's padding duplicates, so
    one such tie moves a leaf by up to ~1%), every leaf is held to
    TRAIN_GRAD_RTOL in L2 norm instead, and the flips are logged. The signs
    are read from the outputs of the modules of `relu_types` (`relu_sides`;
    by default every BatchNorm)."""
    from fcaf3d_tpu_torch.models.pointnet2 import BatchNorm

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for the f32 matmuls")
    relu_types = relu_types or BatchNorm
    calls_g, loss_g, grad_g, stats_g, bn_g, _ = vote_step_on(
        torch, build, batch, device, relu_types)
    _, loss_c, grad_c, stats_c, bn_c, flips = vote_step_on(
        torch, build, batch, "cpu", relu_types, replay=calls_g)
    loss_errs = {k: abs(loss_g[k] - v) / max(abs(v), 1e-30)
                 for k, v in loss_c.items() if k != "grad_norm"}
    loss_err = max(abs(loss_g[k] - loss_c[k]) for k in loss_errs) \
        / loss_c["loss"]
    stats_err = max(float((stats_g[n] - v).abs().max())
                    for n, v in stats_c.items())
    relu = []
    for n, y in bn_c.items():
        flip = (bn_g[n] > 0) != (y > 0)
        if flip.any():
            relu.append((n, int(flip.sum()), float(torch.maximum(
                bn_g[n].abs(), y.abs())[flip].max())))
    if any(at > RELU_TIE_ATOL for _, _, at in relu):
        raise AssertionError(f"{what}: ReLU inputs change sign card vs CPU "
                             f"away from 0: {relu}")
    worst, norm = (0.0, ""), (0.0, "")
    for name, g in grad_c.items():
        if name.endswith("Dense_0.bias"):
            scale = float(grad_c[name[:-4] + "kernel"].abs().max())
            err = max(float(grad_g[name].abs().max()),
                      float(g.abs().max())) / scale
        else:
            err = float((grad_g[name] - g).abs().max()
                        / max(float(g.abs().max()), 1e-30))
            n_err = float((grad_g[name] - g).norm()
                          / max(float(g.norm()), 1e-30))
            norm = max(norm, (n_err, name))
        worst = max(worst, (err, name))
    selections = (f"backbone FPS indices and groups equal card vs CPU; "
                  f"proposals: largest FPS running-minimum gap "
                  f"{flips['fps_gap']:.3g} (tol {VOTE_FPS_RTOL}), "
                  f"{flips['members']} group members within {AGG_D2_TOL} "
                  "of r^2; " if calls_g else "")
    log(f"   {what}, batch {len(next(iter(batch.values())))}: {selections}"
        f"losses on the CPU {loss_c}, on the card {loss_g}, rel err "
        + ", ".join(f"{k} {v:.3g}" for k, v in loss_errs.items())
        + f"; largest error {loss_err:.3g} of the total loss (tol "
        f"{TRAIN_LOSS_RTOL}); running stats max abs "
        f"err {stats_err:.3g} (tol {VOTE_STATS_ATOL}); gradients: worst "
        f"largest-element rel err {worst[1]} {worst[0]:.3g} (tol "
        f"{TINY_GRAD_RTOL}), worst norm rel err {norm[1]} {norm[0]:.3g}; "
        f"ReLU sign flips card vs CPU {relu or 'none'}")
    grads_ok = (worst[0] <= TINY_GRAD_RTOL if not relu
                else norm[0] <= TRAIN_GRAD_RTOL)
    if loss_err > TRAIN_LOSS_RTOL or stats_err > VOTE_STATS_ATOL \
            or not grads_ok or loss_c["loss"] <= 0:
        raise AssertionError(f"{what}: card and CPU disagree")
    return {"loss_rel_err": loss_err, "stats_abs_err": stats_err,
            "grad_rel_err": worst[0], "grad_norm_rel_err": norm[0],
            "relu_flips": relu, "fps_gap": flips["fps_gap"]}


def check_detections(dets, n_classes, what):
    """Non-empty, finite detections with labels in range; returns their
    count."""
    n = len(dets["scores_3d"])
    if n == 0 or dets["boxes_3d"].shape != (n, 7) \
            or not np.isfinite(dets["boxes_3d"]).all() \
            or not np.isfinite(dets["scores_3d"]).all() \
            or not ((dets["labels_3d"] >= 0)
                    & (dets["labels_3d"] < n_classes)).all():
        raise AssertionError(f"{what}: malformed detections")
    return n


def votenet_v1_inference_phase(torch, device):
    """VoteNet-v1 inference in f32 through `init_votenet(cfg, coder=...)`
    and `inference_votenet`: V1_SCANS 20 000-point scans at
    `votenet_v1_sunrgbd` and V1_SCANS 50 000-point ScanNet scans (sampled to
    40 000) at `votenet_v1_scannet`, after a warm-up scan: non-empty
    detections, 5 K5 and 5 K6 launches a scan on the path's variants, the
    ScanNet scan's K5 and K6 calls held to plain, walls per scan; one SUN
    RGB-D scan card against CPU (`compare_votenet_f32`, decoded bins
    too). Returns (launches by path, by variant by path, walls by path)."""
    from fcaf3d_tpu_torch import _native, configs
    from fcaf3d_tpu_torch.apis import inference_votenet, init_votenet
    from fcaf3d_tpu_torch.models.votenet_v1 import (
        scannet_coder, sunrgbd_coder)

    launches, variants, walls = {}, {}, {}
    for name, coder, raw in (("votenet_v1_sunrgbd", sunrgbd_coder(), 20000),
                             ("votenet_v1_scannet", scannet_coder(),
                              SCAN_POINTS)):
        cfg = getattr(configs, name)()
        path = f"{name}_inference"
        model = init_votenet(cfg, seed=0, device=device, coder=coder)
        scans = [vote_scan(s, raw) for s in range(V1_SCANS)]
        inference_votenet(model, scans[0])  # warm-up: cuBLAS and allocator
        if name == "votenet_v1_scannet":
            calls = []
            with wrapped_selections(grad_recorder(torch, calls)):
                inference_votenet(model, scans[0])
            hold_selections_to_plain(torch, calls, f"one {name} scan")
            del calls
        torch.cuda.synchronize()
        _native.reset_launches()
        times, counts = [], []
        for pts in scans:
            t0 = time.perf_counter()
            dets = inference_votenet(model, pts)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts.append(check_detections(dets, cfg.n_classes,
                                           f"{name} scan {len(counts)}"))
        launches[path] = dict(_native.LAUNCHES)
        variants[path] = {"/".join(key): n for key, n in
                          sorted(_native.VARIANT_LAUNCHES.items())}
        check_vote_launches(launches[path], variants[path], 5,
                            len(scans), path)
        walls[path] = times
        log(f"   {name}: {cfg.num_points} points, {cfg.n_classes} classes, "
            f"coder {coder.num_dir_bins} direction bins x {coder.num_sizes} "
            f"sizes; scan walls " + " ".join(f"{t:.1f}" for t in times)
            + f" ms; detections {counts}; launches {launches[path]}")
        if name == "votenet_v1_sunrgbd":
            compare_votenet_f32(torch, model, cfg, scans[0], device)
    return launches, variants, walls


def vote_kernel_rows(torch, cases):
    """K5 and K6 timed in turns with their plain versions on recorded calls
    of the training paths ((name, kind, arguments)), with bound and share
    as phase 7 computes them for B clouds: K5 B S N FPS_OPS operations
    (xyz read once, indices written), K6 the points each centre scans
    (`ballq_scanned`) times BALLQ_OPS."""
    from fcaf3d_tpu_torch.ops.pointnet.ball_query import (
        ball_query, ball_query_plain)
    from fcaf3d_tpu_torch.ops.pointnet.fps import (
        furthest_point_sample, furthest_point_sample_plain)

    rows = {"fps": {}, "ball_query": {}}
    for what, kind, args in cases:
        if kind == "fps":
            x, s, v = args
            b, n = x.shape[:2]
            times = timed_turns(torch, {
                "plain": lambda: furthest_point_sample_plain(x, s, v),
                "kernel": lambda: furthest_point_sample(x, s, v)}, reps=3)
            r = timing_record(times, (b * s * n * FPS_OPS,
                                      b * (n * 12 + s * 4)),
                              PEAK_OPS["float32"])
            log(f"   K5 {what}: B={b} {n} -> {s}: {report(r)}")
        else:
            c, x, radius, ns, v = args
            b, m, n = c.shape[0], c.shape[1], x.shape[1]
            times = timed_turns(torch, {
                "plain": lambda: ball_query_plain(c, x, radius, ns, v),
                "kernel": lambda: ball_query(c, x, radius, ns, v)}, reps=3)
            scanned = sum(ballq_scanned(torch, c[i:i + 1], x[i:i + 1],
                                        radius, ns) for i in range(b))
            r = timing_record(times, (scanned * BALLQ_OPS,
                                      b * ((m + n) * 12 + m * ns * 4)),
                              PEAK_OPS["float32"])
            log(f"   K6 {what}: B={b} M={m} N={n} r={radius} ns={ns}: "
                f"{report(r)}")
        rows[kind][what] = r
    return rows


def votenet_training_phase(torch, device):
    """Phase 11: VoteNet-v2 training and VoteNet-v1 (module docstring).
    Returns (launches by path, by variant by path, records, K5 / K6 rows
    of `vote_kernel_rows`)."""
    from fcaf3d_tpu_torch import _native, configs
    from fcaf3d_tpu_torch.models.votenet_v1 import (
        scannet_coder, sunrgbd_coder)

    launches, variants, recs, cases = {}, {}, {}, []
    cfg = configs.votenet_sunrgbd()
    log(f"   -- (a) VoteNet-v2 training: votenet_sunrgbd, f32, batch "
        f"{cfg.batch_size} of crowded scenes with yawed boxes")
    path = "votenet_training"
    launches[path], variants[path], recs[path], calls = vote_train_phase(
        torch, cfg, vote_train_batch(cfg, cfg.batch_size, seed0=0), device,
        VOTE_TRAIN_STEPS, path)
    # the warm-up's calls: SA1's FPS and ball query, the proposals' FPS
    cases += [(f"SA1 B={cfg.batch_size}", *calls[i][:2]) for i in (0, 1)]
    cases.append((f"proposals B={cfg.batch_size}", *calls[-2][:2]))
    del calls
    log("   -- (b) the tight f32 gate at votenet_tiny, card against CPU")
    recs["votenet_tiny_gate"] = compare_vote_train_tiny(torch, device, "v2")
    log("   -- (c) VoteNet-v1 inference, f32")
    inf_launches, inf_variants, walls = votenet_v1_inference_phase(torch,
                                                                   device)
    launches.update(inf_launches)
    variants.update(inf_variants)
    recs["v1_inference_walls_ms"] = walls
    for name, coder in (("votenet_v1_sunrgbd", sunrgbd_coder()),
                        ("votenet_v1_scannet", scannet_coder())):
        cfg = getattr(configs, name)()
        log(f"   -- (d) {name} training, f32, batch {cfg.batch_size}")
        path = f"{name}_training"
        launches[path], variants[path], recs[path], calls = vote_train_phase(
            torch, cfg, vote_train_batch(cfg, cfg.batch_size, seed0=0),
            device, V1_TRAIN_STEPS, path, coder)
        if name == "votenet_v1_scannet":
            cases += [(f"SA1 B={cfg.batch_size} N={cfg.num_points}",
                       *calls[i][:2]) for i in (0, 1)]
        del calls
    _native.reset_launches()
    recs["votenet_v1_tiny_gate"] = compare_vote_train_tiny(
        torch, device, "v1", tiny_coder())
    log("   -- (e) K5 and K6 at the training shapes, against plain")
    return launches, variants, recs, vote_kernel_rows(torch, cases)


def tiny_imvote_frames(n_classes, with_yaw=True, seeds=(0, 1)):
    """Two camera-consistent frames at the CPU tests' size: 400 points in
    front of a 16 x 24 camera of focal length 10 (sampled to 256)."""
    return [imvote_frame(s, 400, n_classes, with_yaw, hw=(16, 24),
                         focal=10.0, n_boxes=4, extent=2.0, near=1.0,
                         cam_height=0.6) for s in seeds]


def tiny_imvote_batch(cfg):
    """The CPU tests' training batch at `cfg`: `tiny_imvote_frames` with
    their GT 2D boxes (6 rows), frame 1's at confidence 0.8 (a detector's:
    only the pairs inside a box are kept, and the resampling cycles)."""
    batch = imvote_batch(cfg, tiny_imvote_frames(cfg.n_classes,
                                                 cfg.with_yaw), max_det=6)
    batch["boxes2d"][1, :, 4] = np.where(batch["boxes2d_valid"][1], 0.8, 0)
    return batch


def imvote_tiny_cfg():
    """The CPU tests' ImVoteNet size: `votenet_tiny` at 256 points, 16
    proposals, SA (64, 32, 16, 8) (and 32 sampled seeds)."""
    from fcaf3d_tpu_torch.configs import votenet_tiny

    return dataclasses.replace(votenet_tiny(), num_points=256,
                               num_proposal=16,
                               backbone_num_points=(64, 32, 16, 8))


def few_vote_boxes(frame):
    """One 2D box at confidence 0.9 (below 1: only the seeds inside it
    count) over the middle third of the frame's smallest GT 2D box: the
    valid imvotes cover a few seeds, the 1 024 resampled seeds repeat them,
    and the votes that the aggregation's FPS and ball query take hold
    exact duplicates."""
    boxes = frame["boxes2d"]
    x1, y1, x2, y2, _, cls = boxes[np.argmin(
        (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))]
    w, h = (x2 - x1) / 3, (y2 - y1) / 3
    return np.float32([[x1 + w, y1 + h, x2 - w, y2 - h, 0.9, cls]])


def det2d_decode_card_vs_cpu(torch, det, images, device):
    """The 2D decode on the card and on the CPU from the same outputs (the
    card's forward of `images`): each level's top-k indices, the per-class
    NMS keep masks and the detections' valid masks and classes exactly
    equal; boxes within DET2D_BOX_ATOL, scores within SCORE_ATOL. Returns
    (box error, score error, valid detections)."""
    from fcaf3d_tpu_torch.models.detector2d import (
        class_nms, decode_topk, detector2d_get_bboxes)

    with torch.no_grad():
        outs = det(images)
    res = {}
    for dev in (device, "cpu"):
        o = [{k: v.to(dev) for k, v in lvl.items()} for lvl in outs]
        boxes, scores, classes, idx = decode_topk(
            o, image_hw=images.shape[1:3])
        keep = class_nms(boxes, scores, classes)
        dets = detector2d_get_bboxes(o, det.n_classes,
                                     image_hw=images.shape[1:3])
        res[dev] = [t.cpu() for t in (idx, classes, keep, dets.valid,
                                      dets.boxes[..., 5], boxes,
                                      dets.boxes[..., :4], scores,
                                      dets.boxes[..., 4])]
    g, c = res[device], res["cpu"]
    for name, a, b in zip(("top-k indices", "classes", "keep masks",
                           "valid masks", "detection classes"), g, c):
        if not torch.equal(a, b):
            raise AssertionError(f"Detector2D decode: {name} differ card vs "
                                 "CPU")
    box_err = max(float((a - b).abs().max()) for a, b in zip(g[5:7], c[5:7]))
    score_err = max(float((a - b).abs().max()) for a, b in zip(g[7:], c[7:]))
    if box_err > DET2D_BOX_ATOL or score_err > SCORE_ATOL:
        raise AssertionError(f"Detector2D decode: boxes {box_err}, scores "
                             f"{score_err} card vs CPU")
    return box_err, score_err, int(g[3].sum())


def imvote_run(torch, model, args, replay=None):
    """`inference_imvotenet(model, *args)`, its FPS and ball-query calls
    through `replaying` (with `replay`, the card's calls, whose proposals and
    groups it takes) and `sample_valid_seeds` recorded. Returns (calls, the
    fusion mask and `sample_valid_seeds`' indices on the CPU, the numpy
    detections, the flips)."""
    from fcaf3d_tpu_torch.apis import inference_imvotenet
    from fcaf3d_tpu_torch.models import imvotenet

    calls, fused, flips = [], [], {"fps_gap": 0.0, "members": 0}
    sample = imvotenet.sample_valid_seeds

    def recorded(mask, k):
        out = sample(mask, k)
        fused.append((mask.cpu(), out.cpu()))
        return out

    imvotenet.sample_valid_seeds = recorded
    try:
        with wrapped_selections(replaying(torch, calls, replay, flips)):
            dets = inference_imvotenet(model, *args,
                                       n_classes=model.cfg.n_classes)
    finally:
        imvotenet.sample_valid_seeds = sample
    return calls, fused[0], dets, flips


def compare_imvotenet_f32(torch, model, cfg, frame, boxes, device):
    """One frame card against CPU through `inference_imvotenet` (same
    weights, same input): the fusion mask and `sample_valid_seeds`' indices
    and every backbone FPS index and group exactly equal; the aggregation's
    FPS over the votes equal but for a flip at a running-minimum tie and its
    groups but for members within AGG_D2_TOL of r^2 (the CPU then takes the
    card's); the detections' count and labels exactly equal, boxes within
    BOX_ATOL and scores within SCORE_ATOL."""
    from fcaf3d_tpu_torch.apis import init_imvotenet

    args = (frame["points"], frame["image"], boxes, frame["depth2img"],
            cfg.num_points)
    calls_g, (mask_g, inds_g), dets_g, _ = imvote_run(torch, model, args)
    _, (mask_c, inds_c), dets_c, flips = imvote_run(
        torch, init_imvotenet(cfg, 0, device="cpu"), args, replay=calls_g)
    if not (torch.equal(mask_g, mask_c) and torch.equal(inds_g, inds_c)):
        raise AssertionError("ImVoteNet f32: the fusion mask or the "
                             "resampled seeds differ card vs CPU")
    n = len(dets_c["labels_3d"])
    if not (n and np.array_equal(dets_g["labels_3d"], dets_c["labels_3d"])):
        raise AssertionError(f"ImVoteNet f32: {len(dets_g['labels_3d'])} "
                             f"detections on the card, {n} on the CPU, or "
                             "other labels")
    box_err = float(np.abs(dets_g["boxes_3d"] - dets_c["boxes_3d"]).max())
    score_err = float(np.abs(dets_g["scores_3d"] - dets_c["scores_3d"])
                      .max())
    log(f"   f32 card vs CPU: fusion mask ({int(mask_c.sum())} of "
        f"{mask_c.numel()} imvotes valid) and resampled seeds equal, "
        f"{len(calls_g)} FPS / ball-query calls, backbone's equal; "
        f"aggregation: largest FPS running-minimum gap "
        f"{flips['fps_gap']:.3g} (tol {VOTE_FPS_RTOL}), {flips['members']} "
        f"group members within {AGG_D2_TOL} of r^2; {n} detections equal, "
        f"max box err {box_err:.3g} (tol {BOX_ATOL}), max score err "
        f"{score_err:.3g} (tol {SCORE_ATOL})")
    if box_err > BOX_ATOL or score_err > SCORE_ATOL:
        raise AssertionError("ImVoteNet f32: card and CPU disagree")
    return {"box_err": box_err, "score_err": score_err,
            "fps_gap": flips["fps_gap"], "members": flips["members"]}


def detector2d_inference(torch, det, frames, device):
    """(a) `extract_bboxes_2d` on each frame at batch 1: at least one valid
    detection each (walls logged); the decode card vs CPU on frame 0.
    Returns (each frame's valid boxes [n, 6] as numpy, record)."""
    from fcaf3d_tpu_torch.models.detector2d import extract_bboxes_2d

    extract_bboxes_2d(det, torch.as_tensor(frames[0]["image"][None],
                                           device=device))  # warm-up
    boxes, walls = [], []
    for f in frames:
        img = torch.as_tensor(f["image"][None], device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b, v = extract_bboxes_2d(det, img)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        boxes.append(b[0][v[0]].cpu().numpy())
        if len(boxes[-1]) < 1 or not np.isfinite(boxes[-1]).all():
            raise AssertionError("Detector2D: no valid 2D detection")
    box_err, score_err, n = det2d_decode_card_vs_cpu(
        torch, det, torch.as_tensor(frames[0]["image"][None], device=device),
        device)
    log(f"   Detector2D (width {det.width}, FPN {det.fpn_ch}), "
        f"{frames[0]['image'].shape[0]} x {frames[0]['image'].shape[1]}, "
        f"batch 1: extract walls " + " ".join(f"{t:.1f}" for t in walls)
        + f" ms; valid 2D detections {[len(b) for b in boxes]}; decode card "
        f"vs CPU on frame 0: top-k indices, keep masks and {n} detections "
        f"equal, max box err {box_err:.3g} (tol {DET2D_BOX_ATOL}), max score "
        f"err {score_err:.3g} (tol {SCORE_ATOL})")
    return boxes, {"extract_wall_ms": walls, "detections": [
        len(b) for b in boxes], "decode_box_err": box_err,
        "decode_score_err": score_err}


def imvotenet_inference(torch, model, cfg, frames, extracted, device):
    """(b) `inference_imvotenet` on each frame with its extracted 2D boxes,
    its GT 2D boxes and none, then on frame 0 with `few_vote_boxes`: walls,
    non-empty detections with GT boxes, 5 K5 and 5 K6 launches a scan on
    the cluster and tiled kernels, every call held to plain, fewer than
    FEW_SEEDS distinct votes in the few-vote scan's aggregation; then
    `compare_imvotenet_f32` on frame 0 with its extracted boxes (their
    confidences below 1 keep only the pairs inside a box). Returns
    (launches, by variant, record, the recorded calls by scan name)."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import inference_imvotenet

    runs = []
    for i, f in enumerate(frames):
        runs += [(f"frame {i} extracted", f, extracted[i]),
                 (f"frame {i} GT", f, f["boxes2d"]),
                 (f"frame {i} no box", f, np.zeros((0, 6), np.float32))]
    runs.append(("frame 0 few votes", frames[0], few_vote_boxes(frames[0])))
    kw = dict(num_points=cfg.num_points, n_classes=cfg.n_classes)
    inference_imvotenet(model, frames[0]["points"], frames[0]["image"],
                        frames[0]["boxes2d"], frames[0]["depth2img"],
                        **kw)  # warm-up: cuBLAS and the allocator
    torch.cuda.synchronize()
    _native.reset_launches()
    calls, by_run, walls, counts = [], {}, {}, {}
    with wrapped_selections(grad_recorder(torch, calls)):
        for name, f, boxes in runs:
            t0 = time.perf_counter()
            dets = inference_imvotenet(model, f["points"], f["image"], boxes,
                                       f["depth2img"], **kw)
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t0) * 1e3
            by_run[name] = calls[-10:]
            if "GT" in name:
                counts[name] = check_detections(dets, cfg.n_classes, name)
            elif len(dets["scores_3d"]):
                counts[name] = check_detections(dets, cfg.n_classes, name)
            else:
                counts[name] = 0
    launches = dict(_native.LAUNCHES)
    variants = {"/".join(key): n
                for key, n in sorted(_native.VARIANT_LAUNCHES.items())}
    check_vote_launches(launches, variants, 5, len(runs),
                        "imvotenet_inference")
    hold_selections_to_plain(torch, calls, f"{len(runs)} ImVoteNet scans")
    votes = by_run["frame 0 few votes"][-2][1][0][0]
    distinct = len(torch.unique(votes, dim=0))
    if not 0 < distinct < FEW_SEEDS:
        raise AssertionError(f"few-vote scan: {distinct} distinct votes of "
                             f"{len(votes)}, expected 1-{FEW_SEEDS - 1}")
    for name in walls:
        log(f"   {name}: {walls[name]:.1f} ms wall, {counts[name]} "
            "detections")
    log(f"   launches over {len(runs)} scans: {launches}; by variant "
        f"{variants}; every call equal to plain; the few-vote scan's "
        f"aggregation took {distinct} distinct votes of {len(votes)}")
    gate = compare_imvotenet_f32(torch, model, cfg, frames[0], extracted[0],
                                 device)
    return launches, variants, {"walls_ms": walls, "detections": counts,
                                "few_vote_distinct": distinct,
                                "card_vs_cpu": gate}, by_run


def add_counts(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def imvotenet_training(torch, cfg, det, frames, device):
    """(c) `make_imvotenet_train_step` at batch IMVOTE_TRAIN_BATCH with GT
    2D boxes, then with `extract_bboxes_2d(train=True)`'s boxes (a fresh
    half drop each step), each by `held_and_timed_steps` (live vote, centre
    and IoU losses of every tower, 7 K5 and 7 K6 a step); then
    `make_detector2d_train_step` at the same batch: finite losses, finite
    non-zero gradients on every conv kernel, step walls, CUDA-event spans
    and peak memory. Returns (launches, by variant, record, the warm-up's
    calls with GT boxes)."""
    from fcaf3d_tpu_torch.models.detector2d import extract_bboxes_2d
    from fcaf3d_tpu_torch.train import (
        create_detector2d_train_state, create_imvotenet_train_state,
        make_detector2d_train_step, make_imvotenet_train_step)

    batch = imvote_batch(cfg, frames, IMVOTE_MAX_DET)
    live = [f"{t}_{k}" for t in ("joint", "pts", "img")
            for k in ("vote_loss", "center_loss", "iou_loss")]
    model, opt, _ = create_imvotenet_train_state(cfg, seed=0, device=device)
    step = make_imvotenet_train_step(model, cfg, opt)
    log(f"   ImVoteNet, GT 2D boxes (up to {IMVOTE_MAX_DET} a frame, conf 1)")
    launches, variants, rec_gt, calls = held_and_timed_steps(
        torch, model, step, batch, IMVOTE_TRAIN_STEPS, "imvotenet_training",
        live, 7, cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.as_tensor(batch["images"], device=device)

    def extracted_step(b):
        boxes, valid = extract_bboxes_2d(det, images, generator=gen,
                                         train=True, max_det=IMVOTE_MAX_DET)
        return step({**b, "boxes2d": boxes, "boxes2d_valid": valid})

    log("   ImVoteNet, extracted 2D boxes, half dropped each step")
    l2, v2, rec_x, _ = held_and_timed_steps(
        torch, model, extracted_step, batch, IMVOTE_TRAIN_STEPS,
        "imvotenet_training", live, 7, cfg)
    dmodel, dopt, _ = create_detector2d_train_state(
        cfg.n_classes, det.width, det.fpn_ch, seed=0, device=device)
    dstep = make_detector2d_train_step(dmodel, dopt)
    dbatch = {"images": batch["images"],
              "gt_boxes": batch["boxes2d"][..., :4],
              "gt_labels": batch["boxes2d"][..., 5].astype(np.int32),
              "gt_valid": batch["boxes2d_valid"]}
    dstep(dbatch)  # warm-up: cuDNN and the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, spans = [], []
    for i in range(DET2D_TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        m = {k: float(v) for k, v in dstep(dbatch).items()}
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        spans.append(start.elapsed_time(end))
        if not all(np.isfinite(v) for v in m.values()) or m["loss"] <= 0:
            raise AssertionError(f"Detector2D step {i}: metrics {m}")
        for name, p in dmodel.named_parameters():
            if name.endswith("kernel") and not (
                    torch.isfinite(p.grad).all() and p.grad.abs().max() > 0):
                raise AssertionError(f"Detector2D step {i}: {name} gradient "
                                     "non-finite or zero")
        log(f"   Detector2D step {i}: {walls[-1]:.1f} ms wall, "
            f"{spans[-1]:.1f} ms between CUDA events; "
            + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"   Detector2D, batch {len(dbatch['images'])}: wall "
        f"{np.mean(walls):.1f} ms/step, CUDA-event span {np.mean(spans):.1f}"
        f" ms/step, peak memory {peak:.2f} GiB; every conv kernel's gradient "
        "finite and non-zero")
    rec = {"gt_boxes": rec_gt, "extracted_boxes": rec_x,
           "detector2d": {"batch": len(dbatch["images"]),
                          "step_wall_ms": float(np.mean(walls)),
                          "step_event_ms": float(np.mean(spans)),
                          "peak_gib": peak}}
    return (add_counts(launches, l2), add_counts(variants, v2), rec, calls)


def det2d_tiny_batch(b=2, hw=(96, 128), g=3, seed=0, noise=False):
    """The CPU tests' Detector2D batch: grey (or uniform-noise) images with
    g boxes of 16-90 x 16-80 pixels painted flat ((j + 1) x 60), GT boxes
    [b, g + 1, 4] xyxy (a last, invalid one), labels and valid."""
    rng = np.random.default_rng(seed)
    imgs = (rng.uniform(0, 255, (b, hw[0], hw[1], 3)) if noise
            else np.full((b, hw[0], hw[1], 3), 128.0)).astype(np.float32)
    boxes = np.zeros((b, g + 1, 4), np.float32)
    for i in range(b):
        for j in range(g):
            w, h = rng.uniform(16, 90), rng.uniform(16, 80)
            x1, y1 = rng.uniform(0, hw[1] - w), rng.uniform(0, hw[0] - h)
            boxes[i, j] = [x1, y1, min(x1 + w, hw[1]), min(y1 + h, hw[0])]
            x1, y1, x2, y2 = boxes[i, j].astype(int)
            imgs[i, y1:y2, x1:x2] = (j + 1) * 60.0
    labels = rng.integers(0, DET2D_TINY["n_classes"], (b, g + 1))
    valid = np.ones((b, g + 1), bool)
    valid[:, -1] = False
    return {"images": imgs, "gt_boxes": boxes,
            "gt_labels": labels.astype(np.int32), "gt_valid": valid}


def compare_det2d_train_tiny(torch, device):
    """(d) The tight f32 gate of the Detector2D step at the CPU tests' size
    (`det2d_tiny_batch`), card against CPU, cuDNN's TF32 off: `train_gate`
    with the ReLU sides read from every `ConvBNRelu` and `ResBlock2D`
    output."""
    from fcaf3d_tpu_torch.models.detector2d import ConvBNRelu, ResBlock2D
    from fcaf3d_tpu_torch.train import (
        create_detector2d_train_state, make_detector2d_train_step)

    if torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on for the f32 convs")

    def build(dev):
        model, opt, _ = create_detector2d_train_state(**DET2D_TINY, seed=0,
                                                      device=dev)
        return model, make_detector2d_train_step(model, opt)

    return train_gate(torch, build, det2d_tiny_batch(), device,
                      "f32 tiny Detector2D train step (width 16, FPN 32, "
                      "96 x 128)", relu_types=(ConvBNRelu, ResBlock2D))


def imvotenet_phase(torch, device):
    """Phase 12: ImVoteNet and its 2D detector (module docstring), f32 with
    cuDNN's TF32 off. Returns (launches by path, by variant by path,
    records, K5 / K6 rows of `vote_kernel_rows`)."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import init_detector2d, init_imvotenet
    from fcaf3d_tpu_torch.configs import votenet_sunrgbd
    from fcaf3d_tpu_torch.train import create_imvotenet_train_state
    from fcaf3d_tpu_torch.train import make_imvotenet_train_step

    cfg = votenet_sunrgbd()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        def frame(seed):
            return imvote_frame(seed, cfg.num_points, cfg.n_classes,
                                cfg.with_yaw, hw=IMVOTE_HW,
                                focal=IMVOTE_FOCAL)

        frames = [frame(s) for s in range(IMVOTE_FRAMES)]
        log(f"   -- (a) Detector2D at width {DET2D_WIDTH}, FPN {DET2D_FPN}: "
            f"{[len(f['boxes2d']) for f in frames]} GT 2D boxes a frame")
        det = init_detector2d(cfg.n_classes, DET2D_WIDTH, DET2D_FPN, seed=0,
                              device=device)
        extracted, rec_a = detector2d_inference(torch, det, frames, device)
        log("   -- (b) inference_imvotenet at votenet_sunrgbd")
        model = init_imvotenet(cfg, seed=0, device=device)
        l_inf, v_inf, rec_b, inf_calls = imvotenet_inference(
            torch, model, cfg, frames, extracted, device)
        del model
        log(f"   -- (c) training at batch {IMVOTE_TRAIN_BATCH}")
        train_frames = [frame(100 + s) for s in range(IMVOTE_TRAIN_BATCH)]
        l_tr, v_tr, rec_c, tr_calls = imvotenet_training(
            torch, cfg, det, train_frames, device)
        log("   -- (d) the tight f32 gates card vs CPU at the CPU tests' "
            "sizes")
        _native.reset_launches()
        tiny = imvote_tiny_cfg()

        def build(dev):
            m, opt, _ = create_imvotenet_train_state(
                tiny, seed=0, device=dev, num_sampled_seed=32)
            return m, make_imvotenet_train_step(m, tiny, opt)

        rec_d = {"imvotenet": train_gate(
            torch, build, tiny_imvote_batch(tiny), device,
            "f32 tiny ImVoteNet train step"),
            "detector2d": compare_det2d_train_tiny(torch, device)}
        log("   -- (e) K5 and K6 at the aggregation shapes, against plain")
        cases = []
        for what, calls in (("aggregation B=1", inf_calls["frame 0 GT"]),
                            ("aggregation B=1 few votes",
                             inf_calls["frame 0 few votes"]),
                            (f"aggregation B={IMVOTE_TRAIN_BATCH}",
                             tr_calls[BACKBONE_CALLS:BACKBONE_CALLS + 2])):
            cases += [(what, kind, args) for kind, args, *_ in calls[-2:]]
        rows = vote_kernel_rows(torch, cases)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    recs = {"detector2d_inference": rec_a, "imvotenet_inference": rec_b,
            "training": rec_c, "tiny_gates": rec_d}
    return ({"imvotenet_inference": l_inf, "imvotenet_training": l_tr},
            {"imvotenet_inference": v_inf, "imvotenet_training": v_tr},
            recs, rows)


def gt_from_detections(root, ann, out, cfg, model, n=None, seed=0):
    """Write to `out` the first `n` infos of `ann` with their GT replaced by
    `model`'s own detections on each scene (the test pipeline's draw of
    scene i, `default_rng([seed, i])`), so that an mAP comparison has
    matches on both sides of each threshold: of the detections of at least
    GT_MIN_VOLUME, the top one by score with its dims x 1.1 (IoU 0.75) and
    the second with its dims x 1.5 (IoU 0.30); and one box far from the
    scene (a miss). Raises where a scene has fewer than two such
    detections. Returns, per scene, (detections, detections below
    GT_MIN_VOLUME, the two detections taken [2, 7])."""
    import pickle

    import torch

    from fcaf3d_tpu_torch.apis.test import (detect_batch, detections_to_numpy,
                                            make_test_pipeline)
    from fcaf3d_tpu_torch.data import IndoorDetDataset, collate

    with open(ann, "rb") as f:
        infos = pickle.load(f)[:n]
    val = IndoorDetDataset(root, ann, [str(c) for c in range(cfg.n_classes)],
                           make_test_pipeline(cfg), test_mode=True)
    taken = []
    for i, info in enumerate(infos):
        s = val(i, np.random.default_rng([seed, i]))
        batch = collate([s], cfg.num_points, cfg.max_gt_boxes)
        with torch.inference_mode():
            det = detections_to_numpy(
                detect_batch(model, cfg, batch["points"], batch), 0)
        volume = np.prod(det["boxes_3d"][:, 3:6], axis=1)
        big = volume >= GT_MIN_VOLUME
        top = np.argsort(-det["scores_3d"], kind="stable")
        top = top[big[top]][:2]
        if len(top) < 2:
            raise AssertionError(
                f"scene {i}: {int(big.sum())} of {len(big)} detections of at "
                f"least {GT_MIN_VOLUME} m^3, volumes up to "
                f"{volume.max(initial=0):.3g}")
        taken.append((len(big), int((~big).sum()), det["boxes_3d"][top]))
        boxes = det["boxes_3d"][top][:, :6].copy()
        boxes[0, 3:6] *= 1.1
        boxes[1, 3:6] *= 1.5
        boxes = np.concatenate([boxes, [[99, 99, 0, 0.5, 0.5, 0.5]]]).astype(
            np.float32)
        boxes[:, 2] += boxes[:, 5] / 2  # bottom -> gravity centre
        info["annos"].update({
            "gt_num": 3, "gt_boxes_upright_depth": boxes,
            "class": np.concatenate([det["labels_3d"][top], [0]])})
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    return taken


class TimedLoader:
    """A loader that records, for each epoch, how long its consumer waited
    for each batch (`waits`, s) and the epoch's span from the first request
    to the end of the batches (`span`, s)."""

    def __init__(self, loader):
        self.loader = loader
        self.epochs = []

    def steps_per_epoch(self):
        return self.loader.steps_per_epoch()

    def epoch(self, e):
        rec = {"waits": []}
        self.epochs.append(rec)
        t0 = time.perf_counter()
        batches = self.loader.epoch(e)
        while True:
            t = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            rec["waits"].append(time.perf_counter() - t)
            yield batch
        rec["span"] = time.perf_counter() - t0


@contextlib.contextmanager
def recorded_step_metrics(store, k1_calls=None, conv_calls=None):
    """Every train step that `apis.train.train_model` builds inside appends
    its metrics (0-dim device tensors, not read: no synchronisation) to
    `store`. With `k1_calls` and `conv_calls`, the first step runs under
    `recorded_k1_calls` / `recorded_conv_calls`."""
    from fcaf3d_tpu_torch.apis import train as api_train

    real = api_train.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def recorded(batch):
            if k1_calls is not None and not store:
                with recorded_k1_calls(k1_calls), \
                        recorded_conv_calls(conv_calls):
                    metrics = step(batch)
            else:
                metrics = step(batch)
            store.append(metrics)
            return metrics
        return recorded

    api_train.make_train_step = make
    try:
        yield
    finally:
        api_train.make_train_step = real


@contextlib.contextmanager
def recorded_forwards(which, k1_calls, conv_calls):
    """The forwards of `apis.test.evaluate_dataset` inside (its
    `detect_batch` calls, counted from 0) whose index is in `which` run
    under `recorded_k1_calls` / `recorded_conv_calls`."""
    from fcaf3d_tpu_torch.apis import test as api_test

    real = api_test.detect_batch
    count = itertools.count()

    def forward(*args, **kw):
        if next(count) not in which:
            return real(*args, **kw)
        with recorded_k1_calls(k1_calls), recorded_conv_calls(conv_calls):
            return real(*args, **kw)

    api_test.detect_batch = forward
    try:
        yield
    finally:
        api_test.detect_batch = real


def hold_recorded(torch, k1_calls, conv_calls, runs, what):
    """`k1_path_phase` and `hold_calls_to_plain` on the calls of `runs`
    recorded runs, each kernel of `conv_calls` called at least once.
    Returns the K1 record."""
    torch.cuda.synchronize()
    empty = [k for k, v in {"searchsorted_segments": k1_calls,
                            **conv_calls}.items() if not v]
    if empty:
        raise AssertionError(f"{what}: no {empty} call recorded")
    k1 = k1_path_phase(torch, k1_calls, runs, what)
    hold_calls_to_plain(torch, conv_calls, what)
    return k1


@contextlib.contextmanager
def recorded_indoor_eval(store):
    """Every `indoor_eval` of `apis.test.evaluate_dataset` inside appends
    (its seconds, its GT annos, its detections) to `store`."""
    from fcaf3d_tpu_torch.apis import test as api_test

    real = api_test.indoor_eval

    def timed(gt, dt, *args):
        t0 = time.perf_counter()
        out = real(gt, dt, *args)
        store.append((time.perf_counter() - t0, gt, dt))
        return out

    api_test.indoor_eval = timed
    try:
        yield
    finally:
        api_test.indoor_eval = real


def check_step_metrics(metrics, what):
    """Finite metrics, a live box loss and zero overflow at every step."""
    for i, m in enumerate(metrics):
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()) \
                or m["loss_bbox"] <= 0 or m["overflow_max"] != 0:
            raise AssertionError(f"{what}, step {i}: {m}")


def platform_training(torch, cfg, train_set, val, work, bare_step_ms,
                      device):
    """(b) `train_model` at `cfg` for its epochs through the port's Loader
    and an eval hook on `val`: finite losses in the log, zero overflow, one
    checkpoint kept, meta.json, K1-K4 launched on the path's variants, and
    the K1-K4 calls of its first step held to plain (`hold_recorded`).
    Logs each epoch's wall, its mean step wall beside phase 6's bare step
    and the loader's share, over all steps and over the steps after the
    first. Returns (model, optimizer, launches, variants, K1 record)."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import train_model
    from fcaf3d_tpu_torch.apis.test import evaluate_dataset
    from fcaf3d_tpu_torch.data import SCANNET_CLASSES, Loader
    from fcaf3d_tpu_torch.train import latest_epoch, load_meta

    loader = TimedLoader(Loader(train_set, cfg.batch_size, cfg.num_points,
                                cfg.max_gt_boxes))
    evals, metrics = [], []

    def hook(model, epoch):
        t0 = time.perf_counter()
        m = evaluate_dataset(model, val, cfg)
        evals.append(time.perf_counter() - t0)
        return {k: v for k, v in m.items() if k.startswith(("mAP", "mAR"))}

    calls = {}
    conv_calls = {"fused_gather_gemm": [], "fused_gather_max": [],
                  "fused_gather_dw": []}
    torch.cuda.synchronize()
    _native.reset_launches()
    t0 = time.perf_counter()
    with recorded_step_metrics(metrics, calls, conv_calls):
        model, opt = train_model(cfg, loader, work, eval_hook=hook,
                                 classes=SCANNET_CLASSES, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_native.LAUNCHES)
    path = "fcaf3d_platform_training"
    check_path_launches(launches, path)
    variants = check_variants(f"bf16 {path}", ("gather_gemm", "gather_dw"))
    k1 = hold_recorded(torch, calls, conv_calls, 1,
                       f"the first batch-{cfg.batch_size} step of {path}")
    del calls, conv_calls
    steps = loader.steps_per_epoch()
    if len(metrics) != steps * cfg.max_epochs:
        raise AssertionError(f"{len(metrics)} steps, expected "
                             f"{steps} x {cfg.max_epochs}")
    check_step_metrics(metrics, path)
    with open(os.path.join(work, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    evals_logged = [r["eval"] for r in recs if "eval" in r]
    if len(losses) != cfg.max_epochs or not np.isfinite(losses).all() \
            or len(evals_logged) != cfg.max_epochs:
        raise AssertionError(f"train_log.jsonl: {recs}")
    meta = load_meta(work)
    ckpts = sorted(os.listdir(os.path.join(work, "ckpts")))
    if latest_epoch(work) != cfg.max_epochs or ckpts != [
            f"epoch_{cfg.max_epochs}.pt", "meta.json"] \
            or meta["classes"] != list(SCANNET_CLASSES) \
            or meta["config"] != json.loads(json.dumps(
                dataclasses.asdict(cfg))):
        raise AssertionError(f"checkpoints {ckpts}, meta {meta}")
    epoch_times = [r["epoch_time"] for r in recs if "epoch_time" in r]
    log(f"   train_model: {cfg.max_epochs} epochs of {steps} steps at batch "
        f"{cfg.batch_size} in {wall:.2f} s (epoch_time {epoch_times} s, "
        f"eval hook {', '.join(f'{t:.2f}' for t in evals)} s); launches "
        f"{launches}; losses {losses}; eval {evals_logged}")
    for e, rec in enumerate(loader.epochs):
        waits, span = rec["waits"], rec["span"]
        # after the first batch: the loader's threads can work while a
        # step runs (the first batch has no step to overlap)
        after = span - waits[0]
        log(f"   epoch {e + 1}: {span * 1e3:.1f} ms over {len(waits)} "
            f"steps, {span / len(waits) * 1e3:.1f} ms a step (phase 6's "
            f"bare step {bare_step_ms:.1f}); waited for the loader "
            f"{sum(waits) * 1e3:.1f} ms, share {sum(waits) / span:.3f}; "
            f"first batch {waits[0] * 1e3:.1f} ms; after it "
            f"{after / (len(waits) - 1) * 1e3:.1f} ms a step, waited "
            f"{sum(waits[1:]) * 1e3:.1f} ms, share "
            f"{sum(waits[1:]) / after:.3f} (largest wait "
            f"{max(waits[1:]) * 1e3:.1f} ms)")
    return model, opt, launches, variants, k1


def platform_resume(torch, cfg, train_set, work, tmp, model, opt, device):
    """(c) The restore round trip exactly (every variable, mu, nu, count,
    epoch), the checkpoint's bytes and save / restore ms; then 1 epoch and
    `resume=True` to `cfg.max_epochs`: the same count and last LR as the
    straight run, finite losses, the largest relative difference per leaf
    logged (the card's scatter-add atomics differ run to run in the last
    bits, so it is not gated)."""
    from fcaf3d_tpu_torch.apis import train_model
    from fcaf3d_tpu_torch.data import Loader
    from fcaf3d_tpu_torch.train import (create_train_state,
                                        restore_checkpoint, save_checkpoint)

    def loader():
        return Loader(train_set, cfg.batch_size, cfg.num_points,
                      cfg.max_gt_boxes)

    timing = os.path.join(tmp, "save_timing")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(timing, cfg.max_epochs, model, opt)
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = os.path.getsize(os.path.join(timing, "ckpts",
                                          f"epoch_{cfg.max_epochs}.pt"))
    fresh, fopt, _ = create_train_state(cfg, seed=1, device=device,
                                        steps_per_epoch=loader()
                                        .steps_per_epoch())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch = restore_checkpoint(work, fresh, fopt)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    same = epoch == cfg.max_epochs and fopt.count == opt.count and all(
        torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                          fresh.state_dict().values()))
    same = same and all(torch.equal(opt.state[p][k], fopt.state[q][k])
                        for p, q in zip(model.parameters(),
                                        fresh.parameters())
                        for k in ("mu", "nu"))
    if not same:
        raise AssertionError("the restored checkpoint differs from the "
                             "trained state")
    del fresh, fopt
    log(f"   checkpoint: {nbytes} bytes ({nbytes / 2**20:.1f} MiB), save "
        f"{save_ms:.1f} ms, restore {restore_ms:.1f} ms; every variable, "
        f"mu, nu, count ({opt.count}) and epoch ({epoch}) equal after the "
        "round trip")

    resumed = os.path.join(tmp, "resumed")
    metrics = []
    with recorded_step_metrics(metrics):
        train_model(dataclasses.replace(cfg, max_epochs=1), loader(),
                    resumed, device=device)
        rmodel, ropt = train_model(cfg, loader(), resumed, resume=True,
                                   device=device)
    check_step_metrics(metrics, "resumed run")
    lr, rlr = opt.schedule(opt.count - 1), ropt.schedule(ropt.count - 1)
    if ropt.count != opt.count or rlr != lr or not lr < cfg.lr:
        raise AssertionError(f"resumed count {ropt.count} LR {rlr}, straight "
                             f"count {opt.count} LR {lr}")
    with torch.no_grad():
        rel = sorted(((float((a - b).abs().max()
                             / b.abs().max().clamp_min(1e-30)), n)
                      for (n, a), b in zip(rmodel.named_parameters(),
                                           model.parameters())),
                     reverse=True)
    log(f"   resume: 1 epoch, then resume=True to {cfg.max_epochs}: count "
        f"{ropt.count} and last LR {rlr:.6g} equal to the straight run's "
        f"(first epoch's {cfg.lr:.6g}); largest relative difference per "
        "leaf against the straight run: "
        + ", ".join(f"{n} {r:.3g}" for r, n in rel[:4])
        + f"; median {rel[len(rel) // 2][0]:.3g}")


def platform_eval(torch, cfg, val, work, device):
    """(d) `evaluate_dataset` on the last checkpoint through
    `init_detector(work_dir=)` in bf16, batch 1 and PLATFORM_EVAL_BATCH,
    with and without TTA: K1-K3 launched on the path's variants, metric
    dicts well formed. Before the timed runs, the K1-K3 calls of the first
    batch of each size and of the flipped forwards of a TTA batch are held
    to plain (`hold_recorded`). Logs scenes/s and `indoor_eval`'s share of
    the wall. Returns (launches, variants, K1 records)."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import init_detector
    from fcaf3d_tpu_torch.apis.test import FLIP_TTA, evaluate_dataset

    path = "fcaf3d_platform_eval"
    model = init_detector(cfg, work_dir=work, device=device)
    k1 = {}
    flipped = set(range(1, len(FLIP_TTA)))  # FLIP_TTA[0] flips nothing
    for bs, tta, which, what in (
            (1, False, {0}, "batch 1"),
            (PLATFORM_EVAL_BATCH, False, {0}, f"batch {PLATFORM_EVAL_BATCH}"),
            (1, True, flipped, "the flipped TTA forwards of batch 1")):
        calls = {}
        conv_calls = {"fused_gather_gemm": [], "fused_gather_max": []}
        with recorded_forwards(which, calls, conv_calls):
            evaluate_dataset(model, val, cfg, batch_size=bs, tta=tta,
                             max_scenes=bs)
        k1[what] = hold_recorded(torch, calls, conv_calls, len(which),
                                 f"bf16 {path}, {what}")
        del calls, conv_calls
    torch.cuda.synchronize()
    _native.reset_launches()
    for tta in (False, True):
        for bs in (1, PLATFORM_EVAL_BATCH):
            store = []
            t0 = time.perf_counter()
            with recorded_indoor_eval(store):
                m = evaluate_dataset(model, val, cfg, batch_size=bs, tta=tta)
            wall = time.perf_counter() - t0
            dets = [len(d["scores_3d"]) for d in store[0][2]]
            if not all(0 <= v <= 1 for v in m.values()) \
                    or {"mAP_0.25", "mAP_0.50"} - set(m) or 0 in dets:
                raise AssertionError(f"eval batch {bs} tta {tta}: {m}, "
                                     f"detections {dets}")
            log(f"   eval batch {bs}{', TTA' if tta else ''}: {len(val)} "
                f"scenes in {wall * 1e3:.1f} ms, "
                f"{len(val) / wall:.2f} scenes/s; indoor_eval "
                f"{store[0][0] * 1e3:.1f} ms, share {store[0][0] / wall:.3f}"
                f"; detections {dets}; mAP_0.25 {m['mAP_0.25']:.4f}, "
                f"mAP_0.50 {m['mAP_0.50']:.4f}")
    launches = dict(_native.LAUNCHES)
    check_path_launches(launches, path)
    log(f"   launches over the 4 evaluations: {launches}")
    return launches, check_variants(f"bf16 {path}", ("gather_gemm",)), k1


def iou_ties(gt_annos, dt_annos, thresholds):
    """(scene, detection, GT, IoU) of every detection whose IoU with a GT box
    of its scene lies within IOU_TIE_ATOL of a threshold."""
    from fcaf3d_tpu_torch.core.eval import pairwise_iou_3d_np

    out = []
    for i, (g, d) in enumerate(zip(gt_annos, dt_annos)):
        iou = pairwise_iou_3d_np(d["boxes_3d"], g["gt_boxes_3d"])
        for thr in thresholds:
            for j, k in zip(*np.nonzero(np.abs(iou - thr) <= IOU_TIE_ATOL)):
                out.append((i, int(j), int(k), float(iou[j, k])))
    return out


def platform_f32(torch, cfg, root, work, tmp, device):
    """(d) f32: the last checkpoint on the card against the plain path on
    the CPU on the first PLATFORM_F32_SCENES val scenes, whose GT comes
    from the card's detections (`gt_from_detections`): the same detections,
    centres and yaw within BOX_ATOL, dims within BOX_DIM_RTOL of their
    size, scores within SCORE_ATOL, and the same metric dict unless an IoU
    lies within IOU_TIE_ATOL of a threshold (then logged)."""
    from fcaf3d_tpu_torch.apis import init_detector
    from fcaf3d_tpu_torch.apis.test import (evaluate_dataset,
                                            make_test_pipeline)
    from fcaf3d_tpu_torch.data import SCANNET_CLASSES, IndoorDetDataset

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    card = init_detector(cfg32, work_dir=work, device=device)
    ann = os.path.join(tmp, "f32_val.pkl")
    taken = gt_from_detections(
        root, os.path.join(root, "scannet_infos_val.pkl"), ann, cfg32, card,
        n=PLATFORM_F32_SCENES)
    for i, (n, small, boxes) in enumerate(taken):
        log(f"   f32 scene {i}: GT from 2 of {n} card detections ({small} "
            f"below {GT_MIN_VOLUME} m^3), dims "
            + " / ".join(" x ".join(f"{v:.3g}" for v in b[3:6])
                         for b in boxes))
    val = IndoorDetDataset(root, ann, SCANNET_CLASSES,
                           make_test_pipeline(cfg32), test_mode=True)
    got, want = [], []
    t0 = time.perf_counter()
    with recorded_indoor_eval(got):
        m_card = evaluate_dataset(card, val, cfg32)
    t1 = time.perf_counter()
    with recorded_indoor_eval(want):
        m_cpu = evaluate_dataset(init_detector(cfg32, work_dir=work,
                                               device="cpu"), val, cfg32)
    t2 = time.perf_counter()
    err = {"box": 0.0, "dims": 0.0, "score": 0.0}
    for i, (g, w) in enumerate(zip(got[0][2], want[0][2])):
        if len(g["scores_3d"]) != len(w["scores_3d"]) \
                or not np.array_equal(g["labels_3d"], w["labels_3d"]):
            raise AssertionError(f"f32 eval scene {i}: detections differ "
                                 "card vs CPU")
        gb, wb = g["boxes_3d"], w["boxes_3d"]
        d = np.abs(gb - wb)
        err["box"] = max(err["box"], float(np.delete(d, np.s_[3:6], axis=1)
                                           .max(initial=0)))
        err["dims"] = max(err["dims"], float(
            (d[:, 3:6] / np.abs(wb[:, 3:6])).max(initial=0)))
        err["score"] = max(err["score"], float(np.abs(
            g["scores_3d"] - w["scores_3d"]).max(initial=0)))
    if err["box"] > BOX_ATOL or err["dims"] > BOX_DIM_RTOL \
            or err["score"] > SCORE_ATOL:
        raise AssertionError(f"f32 eval: {err} (limits: centres and yaw "
                             f"{BOX_ATOL}, dims {BOX_DIM_RTOL} of their "
                             f"size, scores {SCORE_ATOL})")
    if m_card != m_cpu:
        ties = iou_ties(got[0][1], got[0][2], (0.25, 0.5))
        diff = {k: (m_card[k], m_cpu[k]) for k in m_card
                if m_card[k] != m_cpu[k]}
        if not ties:
            raise AssertionError(f"f32 eval: metrics differ card vs CPU "
                                 f"{diff} with no IoU at a threshold")
        log(f"   f32 eval: metrics differ {diff} at IoU ties {ties}")
    log(f"   f32 eval of {len(val)} scenes, card {(t1 - t0) * 1e3:.1f} ms, "
        f"CPU {(t2 - t1) * 1e3:.1f} ms: "
        f"{[len(d['scores_3d']) for d in got[0][2]]} detections equal "
        f"(centre and yaw err {err['box']:.3g} m, tol {BOX_ATOL}; dims "
        f"{err['dims']:.3g} of their size, tol {BOX_DIM_RTOL}; score err "
        f"{err['score']:.3g}, tol {SCORE_ATOL}); metrics "
        f"{'equal' if m_card == m_cpu else 'differ at ties'}: "
        + ", ".join(f"{k} {v:.4g}" for k, v in m_card.items()
                    if k.startswith(("mAP", "mAR"))))


def run_tool(tool, *args):
    """`python -m fcaf3d_tpu_torch.tools.<tool> args` from the repository
    root; raises unless it exits 0. Returns (stdout, seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          f"fcaf3d_tpu_torch.tools.{tool}", *args], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"tools.{tool} exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout, time.perf_counter() - t0


def platform_clis(root, work, tmp, device):
    """(e) The three CLIs as subprocesses on the card: `tools.test --tta
    --out` prints the mAP keys and writes its JSON, `tools.pcd_demo` writes
    its .obj files, `tools.train --epochs 1` exits 0 with a checkpoint."""
    out_json = os.path.join(tmp, "m.json")
    out, dt = run_tool("test", "--dataset", "scannet", "--data-root", root,
                       "--work-dir", work, "--tta", "--out", out_json,
                       "--device", device)
    with open(out_json) as f:
        metrics = json.load(f)
    if not all(f"{k}: " in out for k in ("mAP_0.25", "mAP_0.50")) \
            or {"mAP_0.25", "mAP_0.50"} - set(metrics):
        raise AssertionError(f"tools.test printed {out!r}")
    log(f"   tools.test --tta: {dt:.1f} s, mAP_0.25 "
        f"{metrics['mAP_0.25']:.4f}, mAP_0.50 {metrics['mAP_0.50']:.4f}")
    demo = os.path.join(tmp, "demo")
    out, dt = run_tool("pcd_demo", os.path.join(root, "points",
                                                "val_00000.bin"),
                       "--work-dir", work, "--out-dir", demo,
                       "--score-thr", "0.1", "--device", device)
    objs = sorted(os.listdir(demo))
    if "val_00000_points.obj" not in objs:
        raise AssertionError(f"tools.pcd_demo wrote {objs}: {out!r}")
    log(f"   tools.pcd_demo: {dt:.1f} s, {out.splitlines()[0]}, wrote {objs}")
    cli_work = os.path.join(tmp, "cli_train")
    out, dt = run_tool("train", "--dataset", "scannet", "--data-root", root,
                       "--work-dir", cli_work, "--batch", str(TRAIN_BATCH),
                       "--epochs", "1", "--device", device)
    ckpts = sorted(os.listdir(os.path.join(cli_work, "ckpts")))
    if ckpts != ["epoch_1.pt", "meta.json"] or "[eval epoch 1]" not in out:
        raise AssertionError(f"tools.train: {ckpts}, {out[-2000:]!r}")
    log(f"   tools.train --epochs 1 --batch {TRAIN_BATCH}: {dt:.1f} s, "
        f"{out.strip().splitlines()[-1]}")


def platform_phase(torch, cfg, bare_step_ms, device):
    """Phase 13: the train -> checkpoint -> evaluate platform at `cfg`'s
    widths and budgets on a ScanNet-layout dataset written to a temporary
    directory. Returns launches, launches by variant and K1 records of the
    training path (with its eval hook) and of the evaluation path."""
    import tempfile

    from fcaf3d_tpu_torch.tools.train import build_datasets

    tcfg = dataclasses.replace(cfg, max_epochs=2, lr_steps=(1,),
                               batch_size=TRAIN_BATCH)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_platform_") as tmp:
        root = os.path.join(tmp, "scannet")
        t0 = time.perf_counter()
        write_scannet_root(root, *PLATFORM_SCENES, cfg.n_classes)
        log(f"   -- (a) {PLATFORM_SCENES[0]} train and {PLATFORM_SCENES[1]} "
            f"val scenes of {TRAIN_BOXES} boxes, {SCAN_POINTS} points, "
            f"written in {time.perf_counter() - t0:.2f} s")
        # tools/train.py's ScanNet pipelines and its 10 repeats
        _, train_set, val = build_datasets("scannet", root, tcfg)
        work = os.path.join(tmp, "work")
        log(f"   -- (b) train_model: {tcfg.max_epochs} epochs, LR x0.1 "
            f"after the first, batch {TRAIN_BATCH}, bf16, eval hook")
        model, opt, l_tr, v_tr, k1_tr = platform_training(
            torch, tcfg, train_set, val, work, bare_step_ms, device)
        log("   -- (c) restore and resume")
        platform_resume(torch, tcfg, train_set, work, tmp, model, opt,
                        device)
        del model, opt
        log(f"   -- (d) evaluate_dataset through init_detector(work_dir=), "
            f"bf16, batch 1 and {PLATFORM_EVAL_BATCH}, with and without TTA")
        l_ev, v_ev, k1_ev = platform_eval(torch, tcfg, val, work, device)
        platform_f32(torch, tcfg, root, work, tmp, device)
        log("   -- (e) the CLIs as subprocesses on the card")
        platform_clis(root, work, tmp, device)
    return ({"fcaf3d_platform_training": l_tr, "fcaf3d_platform_eval": l_ev},
            {"fcaf3d_platform_training": v_tr, "fcaf3d_platform_eval": v_ev},
            {"fcaf3d_platform_training": k1_tr, "fcaf3d_platform_eval": k1_ev})


@contextlib.contextmanager
def recorded_tool_steps(torch, module, name, store, calls=None):
    """The train steps that a tool builds through `module.<name>` inside
    append (metrics, wall ms after a synchronise) to `store`; with `calls`,
    the first step's K5 / K6 calls are recorded into it (`grad_recorder`)."""
    real = getattr(module, name)

    def make(*args, **kw):
        step = real(*args, **kw)

        def recorded(batch):
            t0 = time.perf_counter()
            if calls is not None and not store:
                with wrapped_selections(grad_recorder(torch, calls)):
                    metrics = step(batch)
            else:
                metrics = step(batch)
            torch.cuda.synchronize()
            store.append((metrics, (time.perf_counter() - t0) * 1e3))
            return metrics
        return recorded

    setattr(module, name, make)
    try:
        yield
    finally:
        setattr(module, name, real)


def check_tool_run(torch, store, work, path, steps, live=()):
    """Finite metrics at every one of `steps` recorded steps, the losses
    `live` above 0, and one `train_log.jsonl` record (the epoch's last
    iteration) with the last step's metrics rounded to 4 places. Returns
    the step walls (ms)."""
    if len(store) != steps:
        raise AssertionError(f"{path}: {len(store)} steps, expected {steps}")
    metrics = [{k: float(v) for k, v in m.items()} for m, _ in store]
    for i, m in enumerate(metrics):
        if not all(np.isfinite(v) for v in m.values()) \
                or min([m[k] for k in live], default=1) <= 0:
            raise AssertionError(f"{path}, step {i}: {m}")
    with open(os.path.join(work, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != 1 or recs[0]["iter"] != steps or any(
            v != round(metrics[-1][k], 4) for k, v in recs[0].items()
            if k not in ("epoch", "iter")):
        raise AssertionError(f"{path}: train_log.jsonl {recs}, last step "
                             f"{metrics[-1]}")
    log(f"   {path}: " + "; ".join(
        f"step {i} {w:.1f} ms, loss {m['loss']:.5g}"
        for i, ((_, w), m) in enumerate(zip(store, metrics))))
    return [w for _, w in store]


def held_tool_calls(torch, calls, what):
    """The first step's K5 / K6 calls equal to plain, the proposals' taking
    the votes (`hold_selections_to_plain`)."""
    if hold_selections_to_plain(torch, calls, what) < 2:
        raise AssertionError(f"{what}: the proposals' FPS and ball query "
                             "did not take the votes (vote mode)")


def tool_launches(path, calls_per_step, steps):
    """The launches since the last reset: `calls_per_step` K5 and K6 a step
    on the cluster and tiled kernels (`check_vote_launches`)."""
    from fcaf3d_tpu_torch import _native

    launches = dict(_native.LAUNCHES)
    variants = {"/".join(key): n
                for key, n in sorted(_native.VARIANT_LAUNCHES.items())}
    check_vote_launches(launches, variants, calls_per_step, steps, path)
    return launches, variants


def votenet_tool_loop(torch, root, tmp, bare_ms, device):
    """(a) `tools.train_votenet.train` for 1 epoch of TOOL_STEPS steps at
    `votenet_sunrgbd`'s batch 16, head v2 then v1, on the SUN RGB-D root:
    finite metrics and live losses at every step, the log record, 5 K5
    and 5 K6 launches a step on the path's variants, the first step's
    calls held to plain, the checkpoint restored exactly into a fresh
    model and optimizer. Logs each step's wall beside phase 11's bare step
    (`bare_ms` by head) and the share of the run the host waited for the
    loader. Returns (launches, variants) by path."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.models.votenet_v1 import sunrgbd_coder
    from fcaf3d_tpu_torch.tools import train_votenet
    from fcaf3d_tpu_torch.train import (create_votenet_train_state,
                                        restore_checkpoint)

    launches, variants = {}, {}
    for head in ("v2", "v1"):
        cfg = train_votenet.build_config(head, epochs=1)
        path = f"votenet{'_v1' if head == 'v1' else ''}_tool_training"
        factory = ("make_votenet_v1_train_step" if head == "v1"
                   else "make_votenet_train_step")
        loader = TimedLoader(train_votenet.build_loader(cfg, root))
        work = os.path.join(tmp, f"votenet_{head}")
        store, calls = [], []
        torch.cuda.synchronize()
        _native.reset_launches()
        t0 = time.perf_counter()
        with recorded_tool_steps(torch, train_votenet, factory, store,
                                 calls):
            model, opt = train_votenet.train(cfg, loader, work,
                                             device=device)
        wall = time.perf_counter() - t0
        launches[path], variants[path] = tool_launches(path, 5, TOOL_STEPS)
        walls = check_tool_run(torch, store, work, path, TOOL_STEPS,
                               ("vote_loss", "center_loss"))
        held_tool_calls(torch, calls, f"the first step of {path}")
        del calls
        coder = sunrgbd_coder() if head == "v1" else None
        fresh, fopt, _ = create_votenet_train_state(cfg, seed=1,
                                                    device=device,
                                                    coder=coder)
        epoch = restore_checkpoint(work, fresh, fopt)
        same = epoch == 1 and fopt.count == opt.count == TOOL_STEPS and all(
            torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                              fresh.state_dict().values()))
        same = same and all(torch.equal(opt.state[p][k], fopt.state[q][k])
                            for p, q in zip(model.parameters(),
                                            fresh.parameters())
                            for k in ("mu", "nu"))
        if not same or sorted(os.listdir(os.path.join(work, "ckpts"))) \
                != ["epoch_1.pt"]:
            raise AssertionError(f"{path}: the checkpoint does not restore "
                                 "the trained state")
        del model, opt, fresh, fopt
        waits = loader.epochs[0]["waits"]
        log(f"   {path}: batch {cfg.batch_size}, {TOOL_STEPS} steps in "
            f"{wall * 1e3:.1f} ms (the run, checkpoint included); steps "
            + ", ".join(f"{w:.1f}" for w in walls)
            + f" ms beside phase 11's bare step {bare_ms[head]:.1f} ms; "
            f"waited for the loader {sum(waits) * 1e3:.1f} ms (first batch "
            f"{waits[0] * 1e3:.1f}), share {sum(waits) / wall:.3f}; "
            "checkpoint restored exactly; launches "
            f"{launches[path]}")
    return launches, variants


def detector2d_tool_loop(torch, root, tmp, frames, bare_ms, device):
    """(b) `tools.train_detector2d.train` for 1 epoch of TOOL_STEPS steps
    at batch IMVOTE_TRAIN_BATCH on the frames (`read_image` pointed at
    their `.npy` files): finite losses, the log record, `detector2d.pkl`
    equal to the trained model and loaded through
    `init_detector2d(params_file=)`, whose `extract_bboxes_2d` on a frame
    gives the in-memory model's boxes exactly. Returns the pickle's path."""
    import pickle

    from fcaf3d_tpu_torch.apis import init_detector2d
    from fcaf3d_tpu_torch.models.detector2d import extract_bboxes_2d
    from fcaf3d_tpu_torch.params import export_variables, flatten
    from fcaf3d_tpu_torch.tools import train_detector2d

    work = os.path.join(tmp, "detector2d")
    store = []
    t0 = time.perf_counter()
    with recorded_tool_steps(torch, train_detector2d,
                             "make_detector2d_train_step", store):
        model, _ = train_detector2d.train(root, work,
                                          batch=IMVOTE_TRAIN_BATCH, epochs=1,
                                          device=device)
    wall = (time.perf_counter() - t0) * 1e3
    walls = check_tool_run(torch, store, work, "detector2d tool",
                           TOOL_STEPS)
    path = os.path.join(work, "detector2d.pkl")
    loaded = init_detector2d(model.n_classes, params_file=path,
                             device=device)
    with open(path, "rb") as f:
        tree = pickle.load(f)
    want = flatten(export_variables(model))
    if set(flatten(tree)) != set(want) or not all(
            np.array_equal(v, want[k]) for k, v in flatten(tree).items()):
        raise AssertionError("detector2d.pkl differs from the trained model")
    img = torch.as_tensor(frames[0]["image"][None], device=device)
    model.eval()
    got, want_b = extract_bboxes_2d(loaded, img), extract_bboxes_2d(model,
                                                                    img)
    if not all(torch.equal(a, b) for a, b in zip(got, want_b)) \
            or not got[1].any():
        raise AssertionError("extract_bboxes_2d of the loaded detector "
                             "differs from the trained model's, or is empty")
    log(f"   detector2d tool: batch {IMVOTE_TRAIN_BATCH}, the run "
        f"{wall:.1f} ms, steps " + ", ".join(f"{w:.1f}" for w in walls)
        + f" ms beside phase 12's bare step {bare_ms:.1f} ms, host share "
        f"(reading and collating the frames) {1 - sum(walls) / wall:.3f}; "
        f"detector2d.pkl ({os.path.getsize(path)} bytes) loads, "
        f"{int(got[1].sum())} extracted boxes on frame 0 equal the trained "
        "model's")
    return path


def imvotenet_tool_loop(torch, root, tmp, frames, det2d, bare_ms, device):
    """(c) `tools.train_imvotenet.train` for 1 epoch of TOOL_STEPS steps at
    batch IMVOTE_TRAIN_BATCH, with the 2D pickle of (b) and then with the
    GT 2D boxes: finite losses, the log record, 7 K5 and 7 K6 launches a
    step on the path's variants, the first step's calls held to plain;
    `imvotenet.pkl` loads through `init_imvotenet(params_file=)`, and on
    frame 0 with its GT boxes the loaded model's joint-tower predictions
    are finite and bitwise the trained model's (in eval mode), and
    `inference_imvotenet` gives non-empty detections. Returns (launches,
    variants) by path."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import inference_imvotenet, init_imvotenet
    from fcaf3d_tpu_torch.apis.inference import imvotenet_inputs
    from fcaf3d_tpu_torch.configs import votenet_sunrgbd
    from fcaf3d_tpu_torch.tools import train_imvotenet

    cfg = votenet_sunrgbd()
    launches, variants = {}, {}
    for boxes, bare, path in (
            (det2d, bare_ms["extracted_boxes"],
             "imvotenet_tool_training_detector2d"),
            (None, bare_ms["gt_boxes"], "imvotenet_tool_training_gt")):
        work = os.path.join(tmp, path)
        store, calls = [], []
        torch.cuda.synchronize()
        _native.reset_launches()
        t0 = time.perf_counter()
        with recorded_tool_steps(torch, train_imvotenet,
                                 "make_imvotenet_train_step", store, calls):
            trained, _ = train_imvotenet.train(
                root, work, detector2d=boxes, batch=IMVOTE_TRAIN_BATCH,
                epochs=1, num_points=cfg.num_points,
                max_det2d=IMVOTE_MAX_DET, device=device)
        wall = (time.perf_counter() - t0) * 1e3
        launches[path], variants[path] = tool_launches(path, 7, TOOL_STEPS)
        walls = check_tool_run(torch, store, work, path, TOOL_STEPS)
        held_tool_calls(torch, calls, f"the first step of {path}")
        del calls, store
        model = init_imvotenet(cfg, params_file=os.path.join(
            work, "imvotenet.pkl"), device=device)
        f = frames[0]
        inputs = imvotenet_inputs(f["points"], f["image"], f["boxes2d"],
                                  f["depth2img"], cfg.num_points, 0, device)
        with torch.inference_mode():
            got = model(*inputs[:4], depth2img=inputs[4], towers=("joint",))
            want = trained.eval()(*inputs[:4], depth2img=inputs[4],
                                  towers=("joint",))
        got, want = got["joint"], want["joint"]
        if set(got) != set(want) or not all(
                torch.equal(got[k], want[k]) for k in want) or not all(
                torch.isfinite(v).all() for v in got.values()
                if v.is_floating_point()):
            raise AssertionError(f"{path}: imvotenet.pkl's predictions differ "
                                 "from the trained model's or are not "
                                 "finite")
        dets = inference_imvotenet(model, f["points"], f["image"],
                                   f["boxes2d"], f["depth2img"],
                                   num_points=cfg.num_points,
                                   n_classes=cfg.n_classes)
        n = check_detections(dets, cfg.n_classes,
                             f"{path}: imvotenet.pkl, frame 0, GT boxes")
        del model, trained
        log(f"   {path}: batch {IMVOTE_TRAIN_BATCH}, the run {wall:.1f} ms, "
            "steps " + ", ".join(f"{w:.1f}" for w in walls)
            + f" ms beside phase 12's bare step {bare:.1f} ms, host share "
            f"{1 - sum(walls) / wall:.3f}; imvotenet.pkl loads, its "
            f"predictions on frame 0 equal the trained model's; {n} "
            f"detections with the GT boxes; launches {launches[path]}")
    return launches, variants


def convert_tool(tmp, name, sd, model, *args):
    """`torch.save` `sd` with an mmcv-style meta and convert it with `python
    -m fcaf3d_tpu_torch.tools.convert_checkpoint --model model args` as a
    subprocess. Returns (pickle path, .pth bytes, seconds)."""
    import torch

    pth = os.path.join(tmp, f"{name}.pth")
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()},
                "meta": {"CLASSES": tuple(str(i) for i in range(18)),
                         "epoch": 12, "config": "synthetic"}}, pth)
    out = os.path.join(tmp, f"{name}.pkl")
    printed, dt = run_tool("convert_checkpoint", "--pth", pth, "--out", out,
                           "--model", model, *args)
    if not printed.startswith(f"wrote {out} ("):
        raise AssertionError(f"convert_checkpoint printed {printed!r}")
    return out, os.path.getsize(pth), dt


def same_tree(path, variables, what):
    """The pickle at `path` holds `variables` exactly."""
    import pickle

    from fcaf3d_tpu_torch.params import flatten

    with open(path, "rb") as f:
        got = {c: flatten(t) for c, t in pickle.load(f).items()}
    want = {c: flatten(t) for c, t in variables.items()}
    if {c: set(t) for c, t in got.items()} != \
            {c: set(t) for c, t in want.items()} or not all(
                np.array_equal(v, want[c][k])
                for c, t in got.items() for k, v in t.items()):
        raise AssertionError(f"{what}: the converted tree differs from the "
                             "variables written as the reference's")


def stem_impulse(torch, sd, converted, device):
    """The card's twin of `test_me_offset_order_impulse` on the converted
    stem conv: on a random 8^3 occupancy (3 channels), the f32 sparse conv
    with the converted kernel equals, at every output voxel, a dense
    float64 conv whose taps are assembled from the reference's ME-order
    kernel (x fastest: tap dx + 3 dy + 9 dz), within 1e-5 of the largest
    output; the unpermuted ME-order kernel does not."""
    from fcaf3d_tpu_torch.ops.sparse import conv as sconv
    from fcaf3d_tpu_torch.ops.sparse import tensor as stensor

    w_me = sd["backbone.conv1.0.kernel"].astype(np.float64)  # [27, 3, 64]
    w_ours = converted["params"]["backbone"]["conv1"]["kernel"]
    rng = np.random.default_rng(0)
    size = 8
    grid = rng.random((size,) * 3) < 0.5
    coords = np.argwhere(grid).astype(np.int32)
    feats = rng.standard_normal((len(coords), 3)).astype(np.float32)
    dense = np.zeros((size + 2,) * 3 + (3,))
    dense[tuple((coords + 1).T)] = feats
    taps = np.stack([w_me[dx + 3 * dy + 9 * dz] for dx in range(3)
                     for dy in range(3) for dz in range(3)])  # ours' order

    c = torch.as_tensor(coords[None], device=device)
    c, f, keys = stensor.sort_rows(c, torch.as_tensor(feats[None],
                                                      device=device),
                                   stensor.encode_coords(c))
    st = stensor.SparseTensor(coords=c, feats=f, keys=keys, shift=torch.zeros(
        (1, 3), dtype=torch.int32, device=device))
    out = sconv.sparse_conv(st, torch.as_tensor(w_ours, device=device), 3, 1)
    wrong = sconv.sparse_conv(st, torch.as_tensor(
        w_me.astype(np.float32), device=device), 3, 1)
    oc = out.coords[0].cpu().numpy()
    want = np.stack([np.einsum("kc,kce->e", np.stack(
        [dense[x + dx, y + dy, z + dz] for dx in range(3) for dy in range(3)
         for dz in range(3)]), taps) for x, y, z in oc])
    tol = 1e-5 * np.abs(want).max()
    err = np.abs(out.feats[0].cpu().numpy() - want).max()
    wrong_err = np.abs(wrong.feats[0].cpu().numpy() - want).max()
    if err > tol or wrong_err <= 100 * tol:
        raise AssertionError(f"stem impulse: converted kernel err {err:.3g} "
                             f"(tol {tol:.3g}), unpermuted kernel err "
                             f"{wrong_err:.3g}")
    log(f"   stem impulse on the card: {len(oc)} output voxels of the "
        f"converted stem conv equal the ME-order dense conv within "
        f"{err:.3g} (tol {tol:.3g}); the unpermuted kernel is off by "
        f"{wrong_err:.3g}")


def converter_phase(torch, cfg, scans, tmp, frame, device):
    """(d) The converter: reference-named state dicts of the seeded
    variables of `fcaf3d_scannet`, `votenet_sunrgbd` and ImVoteNet
    (`reference_state_dict`), `torch.save`d and converted by the CLI as
    subprocesses, each pickle equal to those variables and loaded through
    its `init_*(params_file=)`: FCAF3D bf16 on two scans (`slice_phase`)
    and one f32 scan card vs CPU (`compare_f32`); one VoteNet scan and one
    ImVoteNet frame (with its GT boxes) with 5 K5 and 5 K6 launches on the
    path's variants, held to plain; the stem impulse. Returns (launches,
    variants, K1 record, the FCAF3D pickle's path)."""
    import pickle

    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import (inference_imvotenet,
                                       inference_votenet, init_imvotenet,
                                       init_votenet)
    from fcaf3d_tpu_torch.configs import votenet_sunrgbd
    from fcaf3d_tpu_torch.params import (init_imvotenet_variables,
                                         init_variables,
                                         init_votenet_variables)

    launches, variants, k1 = {}, {}, {}
    variables = init_variables(cfg, seed=0)
    sd = reference_state_dict(variables, "fcaf3d")
    path, nbytes, dt = convert_tool(tmp, "fcaf3d_scannet", sd, "fcaf3d",
                                    "--depth", str(cfg.depth))
    same_tree(path, variables, "fcaf3d_scannet")
    with open(path, "rb") as f:
        converted = pickle.load(f)
    del variables
    stem_impulse(torch, sd, converted, device)
    del sd, converted
    log(f"   fcaf3d_scannet: {nbytes} bytes of .pth, converted in "
        f"{dt:.1f} s (the subprocess) to {os.path.getsize(path)} bytes, "
        "equal to the seeded variables")
    p = "converted_fcaf3d_inference"
    launches[p], variants[p], k1[p] = slice_phase(
        torch, cfg, scans[:2], device, path=p, params_file=path)
    compare_f32(torch, cfg, scans[0], device, params_file=path)

    vcfg = votenet_sunrgbd()
    for model_name, draw, p in (
            ("votenet", lambda: init_votenet_variables(vcfg, seed=0),
             "converted_votenet_inference"),
            ("imvotenet", lambda: init_imvotenet_variables(vcfg, seed=0),
             "converted_imvotenet_inference")):
        variables = draw()
        vpath, nbytes, dt = convert_tool(
            tmp, model_name, reference_state_dict(variables, model_name),
            model_name)
        same_tree(vpath, variables, model_name)
        del variables
        if model_name == "votenet":
            model = init_votenet(vcfg, params_file=vpath, device=device)

            def run():
                return inference_votenet(model, vote_scan(0, vcfg.num_points))
        else:
            model = init_imvotenet(vcfg, params_file=vpath, device=device)

            def run():
                return inference_imvotenet(
                    model, frame["points"], frame["image"], frame["boxes2d"],
                    frame["depth2img"], num_points=vcfg.num_points,
                    n_classes=vcfg.n_classes)
        run()  # warm-up
        torch.cuda.synchronize()
        _native.reset_launches()
        calls = []
        t0 = time.perf_counter()
        with wrapped_selections(grad_recorder(torch, calls)):
            n = check_detections(run(), vcfg.n_classes, p)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches[p], variants[p] = tool_launches(p, 5, 1)
        hold_selections_to_plain(torch, calls, p)
        del model, calls
        log(f"   {model_name}: {nbytes} bytes of .pth, converted in "
            f"{dt:.1f} s to {os.path.getsize(vpath)} bytes, equal to the "
            f"seeded variables; {p}: {wall:.1f} ms wall, {n} detections, "
            f"launches {launches[p]}")
    return launches, variants, k1, path


def fuse_publish_phase(torch, cfg, scans, converted, tmp, device):
    """(e) A work dir holding the converted FCAF3D weights as an epoch-12
    checkpoint and `config.json`; `tools.fuse_conv_bn` on it: the fused
    checkpoint at epoch 12 with count 0 and zero moments, every BatchNorm
    of the tree fused (scale 1, mean 0, var 1 - eps); the fused model's
    f32 detections on a scan equal to the unfused model's in count and
    labels, boxes and scores within FUSE_ATOL; bf16 inference on the path's
    variants; `tools.publish_model` on the fused dir: the
    `{out}-{sha256[:8]}.pkl` named by its own hash, whose
    `init_detector(params_file=)` gives bitwise the detections of
    `init_detector(work_dir=fused)`. Returns (launches, variants)."""
    import hashlib
    import pickle

    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import inference_detector, init_detector
    from fcaf3d_tpu_torch.tools import fuse_conv_bn, publish_model
    from fcaf3d_tpu_torch.train import (load_checkpoint, make_optimizer,
                                        save_checkpoint)
    from fcaf3d_tpu_torch.utils.fuse_bn import BN_EPS

    work, fused = os.path.join(tmp, "work"), os.path.join(tmp, "fused")
    model = init_detector(cfg, params_file=converted, device=device)
    save_checkpoint(work, 12, model, make_optimizer(model.parameters()))
    n_bn = sum(name.endswith(".mean") for name, _ in model.named_buffers())
    del model
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    t0 = time.perf_counter()
    fuse_conv_bn.main(["--work-dir", work, "--out-dir", fused, "--device",
                       device])
    fuse_s = time.perf_counter() - t0
    ckpt = load_checkpoint(fused)
    v = ckpt["variables"]
    means = [k for k in v if k.startswith("batch_stats/")
             and k.endswith("/mean")]
    done = [k for k in means if not v[k].any()
            and (v[k[:-4] + "var"] == np.float32(1 - BN_EPS)).all()
            and (v["params/" + k[len("batch_stats/"):-4] + "scale"]
                 == 1).all()]
    if ckpt["epoch"] != 12 or ckpt["count"] != 0 or len(done) != n_bn \
            or len(means) != n_bn or any(
                t.any() for k in ("mu", "nu") for t in ckpt[k].values()):
        raise AssertionError(f"fused checkpoint: epoch {ckpt['epoch']}, count "
                             f"{ckpt['count']}, {len(done)} of {n_bn} BNs "
                             "fused, or non-zero moments")
    del ckpt, v
    sizes = {d: os.path.getsize(os.path.join(d, "ckpts", "epoch_12.pt"))
             for d in (work, fused)}

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    got, _ = inference_detector(init_detector(cfg32, work_dir=fused,
                                              device=device), scans[0])
    want, _ = inference_detector(init_detector(cfg32, work_dir=work,
                                               device=device), scans[0])
    n = len(want["scores_3d"])
    box_err = float(np.abs(got["boxes_3d"] - want["boxes_3d"]).max(initial=0)
                    ) if len(got["scores_3d"]) == n else np.inf
    score_err = float(np.abs(got["scores_3d"] - want["scores_3d"]).max(
        initial=0)) if len(got["scores_3d"]) == n else np.inf
    if not n or len(got["scores_3d"]) != n or not np.array_equal(
            got["labels_3d"], want["labels_3d"]) or box_err > FUSE_ATOL \
            or score_err > FUSE_ATOL:
        raise AssertionError(f"fused f32: {len(got['scores_3d'])} detections,"
                             f" unfused {n}; box err {box_err}, score err "
                             f"{score_err} (tol {FUSE_ATOL})")
    log(f"   fuse_conv_bn: {n_bn} BatchNorms fused in {fuse_s:.1f} s "
        f"(in process; checkpoints {sizes[work]} and {sizes[fused]} bytes); "
        f"f32 scan: {n} detections equal to the unfused model's, max box err "
        f"{box_err:.3g}, max score err {score_err:.3g} (tol {FUSE_ATOL})")

    path = "fused_fcaf3d_inference"
    model = init_detector(cfg, work_dir=fused, device=device)
    inference_detector(model, scans[0])  # warm-up
    torch.cuda.synchronize()
    _native.reset_launches()
    dets = [inference_detector(model, pts) for pts in scans[:2]]
    launches = dict(_native.LAUNCHES)
    check_path_launches(launches, path)
    var = check_variants(f"bf16 {path}", ("gather_gemm",))
    for d, overflow in dets:
        if any(overflow.values()):
            raise AssertionError(f"{path}: budgets dropped voxels {overflow}")
    t0 = time.perf_counter()
    published = publish_model.main(["--work-dir", fused, "--out",
                                    os.path.join(tmp, "fcaf3d_scannet")])
    publish_s = time.perf_counter() - t0
    with open(published, "rb") as f:
        blob = f.read()
    sha = hashlib.sha256(blob).hexdigest()[:8]
    tree = pickle.loads(blob)
    del blob
    if not published.endswith(f"fcaf3d_scannet-{sha}.pkl") \
            or set(tree) != {"params", "batch_stats", "epoch"} \
            or tree["epoch"] != 12:
        raise AssertionError(f"published {published}: keys {set(tree)}")
    del tree
    pub = init_detector(cfg, params_file=published, device=device)
    for i, ((want_d, _), pts) in enumerate(zip(dets, scans[:2])):
        got_d, _ = inference_detector(pub, pts)
        if not all(np.array_equal(got_d[k], want_d[k]) for k in want_d):
            raise AssertionError(f"published scan {i}: detections differ "
                                 "from the fused work dir's")
    log(f"   bf16 {path}: {[len(d['scores_3d']) for d, _ in dets]} "
        f"detections, zero overflow, launches {launches}; publish_model "
        f"{publish_s:.1f} s -> {os.path.basename(published)} "
        f"({os.path.getsize(published)} bytes), its detections bitwise "
        "those of the fused work dir on both scans")
    return {path: launches}, {path: var}


def tools_phase(torch, cfg, scans, vt_recs, iv_recs, device):
    """Phase 14: the rest of the platform's tools at full widths (module
    docstring). Returns launches, launches by variant and K1 records of the
    paths that run K1-K6."""
    import tempfile

    from fcaf3d_tpu_torch.configs import votenet_sunrgbd
    from fcaf3d_tpu_torch.tools import train_detector2d

    launches, variants = {}, {}
    vcfg = votenet_sunrgbd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        t0 = time.perf_counter()
        vote_root = os.path.join(tmp, "sunrgbd_votenet")
        n = vcfg.batch_size * TOOL_STEPS
        write_sunrgbd_root(vote_root, [
            {"points": s["points"], "gt_boxes": s["gt_boxes"],
             "gt_labels": s["gt_labels"]} for s in crowded_scenes(n, vcfg)])
        frames = [imvote_frame(100 + s, vcfg.num_points, vcfg.n_classes)
                  for s in range(IMVOTE_TRAIN_BATCH * TOOL_STEPS)]
        frame_root = os.path.join(tmp, "sunrgbd_frames")
        write_sunrgbd_root(frame_root, [frame_scene(f) for f in frames],
                           image_suffix=".npy")
        log(f"   -- (a) VoteNet loop: {n} crowded scenes of {TRAIN_BOXES} "
            f"yawed boxes and {len(frames)} frames written in "
            f"{time.perf_counter() - t0:.2f} s")
        l, v = votenet_tool_loop(
            torch, vote_root, tmp,
            {"v2": vt_recs["votenet_training"]["step_wall_ms"],
             "v1": vt_recs["votenet_v1_sunrgbd_training"]["step_wall_ms"]},
            device)
        launches.update(l)
        variants.update(v)
        real_read = train_detector2d.read_image
        train_detector2d.read_image = read_npy_image
        try:
            log("   -- (b) the Detector2D loop")
            det2d = detector2d_tool_loop(
                torch, frame_root, tmp, frames,
                iv_recs["training"]["detector2d"]["step_wall_ms"], device)
            log("   -- (c) the ImVoteNet loop, with (b)'s 2D boxes, then GT")
            l, v = imvotenet_tool_loop(
                torch, frame_root, tmp, frames, det2d,
                {k: iv_recs["training"][k]["step_wall_ms"]
                 for k in ("extracted_boxes", "gt_boxes")}, device)
        finally:
            train_detector2d.read_image = real_read
        launches.update(l)
        variants.update(v)
        log("   -- (d) the converter: fcaf3d_scannet, votenet_sunrgbd, "
            "ImVoteNet")
        l, v, k1, converted = converter_phase(torch, cfg, scans, tmp,
                                              frames[0], device)
        launches.update(l)
        variants.update(v)
        log("   -- (e) fuse and publish")
        l, v = fuse_publish_phase(torch, cfg, scans, converted, tmp, device)
        launches.update(l)
        variants.update(v)
    return launches, variants, k1


def rank_rows(batch, group):
    """This rank's rows of every global-batch array of `batch`."""
    b = len(next(iter(batch.values()))) // group.world
    return {k: v[group.rank * b:(group.rank + 1) * b]
            for k, v in batch.items()}


@contextlib.contextmanager
def timed_collectives(torch, spent):
    """Every collective of a `parallel.Group` inside appends its seconds to
    `spent`, from a synchronise before it (so that the device's pending
    work is not counted) to one after it."""
    from fcaf3d_tpu_torch.parallel.comm import Group

    names = ("all_reduce", "all_gather", "broadcast")
    real = {name: getattr(Group, name) for name in names}

    def timed(fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t0)
            return out
        return call

    for name, fn in real.items():
        setattr(Group, name, timed(fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(Group, name, fn)


def state_digest(model):
    """sha256 of every variable's bytes, in state-dict order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def dp_fcaf3d_rank(torch, group, cfg, batch, held=True):
    """(a) on one rank: `make_train_step(group=)` at `cfg` on this rank's
    rows, a warm-up step whose K1 calls are checked and K2-K4 calls held as
    phase 6's (`hold_recorded`; not with `held` False), DP_TRAIN_STEPS
    timed steps (K1-K4 launched on the path's variants), then one step
    with its collectives timed; finite metrics, a live box loss, zero
    overflow at every step. Returns the record, the launches and the
    launches by variant of the timed steps."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.train import create_train_state, make_train_step

    what = (f"rank {group.rank}: one data-parallel fcaf3d step, "
            f"{len(batch['points'])} of the global batch")
    model, opt, _ = create_train_state(cfg, seed=0, device=group.device)
    step = make_train_step(model, cfg, opt, group=group)
    k1_calls = {}
    conv_calls = {"fused_gather_gemm": [], "fused_gather_max": [],
                  "fused_gather_dw": []}
    if held:
        with recorded_k1_calls(k1_calls), recorded_conv_calls(conv_calls):
            step(batch)  # warm-up: cuBLAS and the allocator
        # the K1 times it logs are taken with the other ranks on the card
        hold_recorded(torch, k1_calls, conv_calls, 1, what)
    else:
        step(batch)
    k1_calls.clear()
    conv_calls.clear()
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launches()
    walls, metrics, spent = [], [], []

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        metrics.append({k: float(v) for k, v in m.items()})
        return (time.perf_counter() - t0) * 1e3

    for _ in range(DP_TRAIN_STEPS):
        walls.append(timed_step())
    launches = dict(_native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    variants = check_variants(what, ("gather_gemm", "gather_dw"))
    # one more step with every collective timed between synchronises (the
    # synchronises cost NCCL its overlap; gloo's host copies wait anyway)
    with timed_collectives(torch, spent):
        timed_wall = timed_step()
    check_step_metrics(metrics, what)
    check_path_launches(launches, "fcaf3d_dp_training")
    for i, (wall, m) in enumerate(zip(walls + [timed_wall], metrics)):
        timed = (f" with its {len(spent)} collectives timed, "
                 f"{sum(spent) * 1e3:.1f} ms in them "
                 f"({max(spent) * 1e3:.1f} the largest)")
        log(f"   rank {group.rank} step {i}: {wall:.1f} ms wall"
            + (timed if i == len(walls) else "") + "; "
            + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))
    rec = {"step_wall_ms": float(np.mean(walls)),
           "timed_step_wall_ms": timed_wall,
           "collective_ms": sum(spent) * 1e3,
           "grad_all_reduce_ms": max(spent) * 1e3,  # the largest
           "collective_share": sum(spent) * 1e3 / timed_wall,
           "collectives_a_step": len(spent), "peak_gib": peak,
           "metrics": metrics, "digest": state_digest(model)}
    return rec, launches, variants


def dp_tiny_grads(torch, group, device, batch, vote):
    """One f32 train step at `fcaf3d_tiny` (`vote`: `votenet_tiny`) on
    this rank's rows of `batch` (the whole batch with no group): metrics,
    the (summed) gradients and the running statistics, on the CPU."""
    from fcaf3d_tpu_torch.configs import fcaf3d_tiny, votenet_tiny
    from fcaf3d_tpu_torch.train import (create_train_state,
                                        create_votenet_train_state,
                                        make_train_step,
                                        make_votenet_train_step)

    if vote:
        cfg = votenet_tiny()
        model, opt, _ = create_votenet_train_state(cfg, 0, device)
        step = make_votenet_train_step(model, cfg, opt, group=group)
    else:
        cfg = fcaf3d_tiny()
        model, opt, _ = create_train_state(cfg, 0, device)
        step = make_train_step(model, cfg, opt, group=group)
    m = step(batch if group is None else rank_rows(batch, group))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
            "stats": {n: v.cpu() for n, v in model.named_buffers()}}


def dp_evaluations(torch, cfg, root, params, group, world, device):
    """(d) `evaluate_dataset` of the seeded bf16 detector (`params`: the
    pickle of its seeded draw) over the val split, whose GT comes from its
    own detections, at global batch DP_EVAL_BATCH (DP_EVAL_BATCH / `world`
    scenes a forward with no group, as a rank runs them), without and with
    TTA: {tta: (metrics, per-scene detections)}; the launches of the run.
    Under a group, the K1-K3 calls of the rank's first forward and of the
    flipped forwards of its first TTA batch are first held to plain
    (`hold_recorded`), as phase 13 holds its evaluations."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import init_detector
    from fcaf3d_tpu_torch.apis.test import (FLIP_TTA, evaluate_dataset,
                                            make_test_pipeline)
    from fcaf3d_tpu_torch.data import SCANNET_CLASSES, IndoorDetDataset

    model = init_detector(cfg, params_file=params, device=device)
    val = IndoorDetDataset(root, os.path.join(root, "scannet_infos_val.pkl"),
                           SCANNET_CLASSES, make_test_pipeline(cfg),
                           test_mode=True)
    batch = DP_EVAL_BATCH if group is not None else DP_EVAL_BATCH // world
    if group is not None:
        flipped = set(range(1, len(FLIP_TTA)))  # FLIP_TTA[0] flips nothing
        for tta, which, what in (
                (False, {0}, "its first forward"),
                (True, flipped, "the flipped forwards of its first TTA "
                 "batch")):
            calls = {}
            conv_calls = {"fused_gather_gemm": [], "fused_gather_max": []}
            with recorded_forwards(which, calls, conv_calls):
                evaluate_dataset(model, val, cfg, batch_size=batch, tta=tta,
                                 max_scenes=batch, group=group)
            hold_recorded(torch, calls, conv_calls, len(which),
                          f"bf16 fcaf3d_dp_eval rank {group.rank}, {what}")
            del calls, conv_calls
        torch.cuda.synchronize()
    _native.reset_launches()
    out = {}
    for tta in (False, True):
        store = []
        with recorded_indoor_eval(store):
            metrics = evaluate_dataset(model, val, cfg, batch_size=batch,
                                       tta=tta, group=group)
        out[tta] = (metrics, store[0][2])
    return out, dict(_native.LAUNCHES), {
        "/".join(k): n for k, n in sorted(_native.VARIANT_LAUNCHES.items())}


def same_metrics(a, b):
    """The same keys and values, a NaN equal to a NaN."""
    return set(a) == set(b) and all(
        a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])) for k in a)


def dp_rank(group, spec, out_dir):
    """Phase 15's work on one rank: (a), (b) and (c)'s steps, (d)'s sharded
    evaluation and, with a `weak_batch` (`--nccl`), (a)'s step at
    TRAIN_BATCH a rank; saves the records to `out_dir`."""
    import torch

    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.configs import votenet_sunrgbd
    from fcaf3d_tpu_torch.train import (create_votenet_train_state,
                                        make_votenet_train_step)

    _native.load()  # built by the parent
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = group.device
    out = {"launches": {}, "variants": {}}
    out["fcaf3d"], out["launches"]["fcaf3d_dp_training"], \
        out["variants"]["fcaf3d_dp_training"] = dp_fcaf3d_rank(
            torch, group, spec["cfg"], rank_rows(spec["batch"], group))
    out["tiny"] = dp_tiny_grads(torch, group, device, spec["tiny_batch"],
                                False)
    vcfg = votenet_sunrgbd()
    model, opt, _ = create_votenet_train_state(vcfg, seed=0, device=device)
    step = make_votenet_train_step(model, vcfg, opt, group=group)
    l, v, out["votenet"], _ = held_and_timed_steps(
        torch, model, step, rank_rows(spec["vote_batch"], group),
        VOTE_TRAIN_STEPS, f"votenet_dp_training rank {group.rank}",
        ("vote_loss", "center_loss", "iou_loss"), 5, vcfg)
    out["votenet"]["digest"] = state_digest(model)
    out["launches"]["votenet_dp_training"] = l
    out["variants"]["votenet_dp_training"] = v
    del model, opt, step
    out["vote_tiny"] = dp_tiny_grads(torch, group, device,
                                     spec["vote_tiny_batch"], True)
    out["eval"], out["launches"]["fcaf3d_dp_eval"], \
        out["variants"]["fcaf3d_dp_eval"] = dp_evaluations(
            torch, spec["cfg"], spec["root"], spec["params"], group,
            group.world, device)
    if spec["weak_batch"] is not None:
        out["weak"] = dp_fcaf3d_rank(
            torch, group, spec["cfg"], rank_rows(spec["weak_batch"], group),
            held=False)[0]
    torch.save(out, os.path.join(out_dir, f"dp_rank{group.rank}.pt"))


def dp_tiny_gate(got, want, what, by_norm=False):
    """W ranks against one process on the card: each loss within
    TRAIN_LOSS_RTOL of the total, each gradient element within
    TINY_GRAD_RTOL of its leaf's largest, or with `by_norm` each leaf
    within TINY_GRAD_RTOL in L2 norm (VoteNet: flax's fast variance
    E[x^2] - E[x]^2 cancels in f32, so the ranks' other summation order
    scatters single elements, 3.6e-3 of a leaf's largest and 8.5e-4 in
    norm at `--nccl 4`, where float64 on the CPU holds W = 2 to one process
    within 1e-10, `tests/test_torch_parallel.py`); a
    Dense bias ahead of a train-mode BN, whose gradient is exactly 0,
    within 1e-4 of its kernel's largest on both sides; running statistics
    within VOTE_STATS_ATOL."""
    total = want["metrics"]["loss"]
    loss_err = max(abs(got["metrics"][k] - v) for k, v in
                   want["metrics"].items() if "loss" in k) / abs(total)
    worst = {"element": (0.0, None), "norm": (0.0, None)}
    for name, g in want["grads"].items():
        if name.endswith("Dense_0.bias"):
            scale = float(want["grads"][name[:-4] + "kernel"].abs().max())
            if max(float(got["grads"][name].abs().max()),
                   float(g.abs().max())) > 1e-4 * scale:
                raise AssertionError(f"{what}: {name} gradient not ~0")
            continue
        d = got["grads"][name] - g
        for kind, err in (
                ("element", float(d.abs().max()) / max(float(g.abs().max()),
                                                        1e-30)),
                ("norm", float(d.norm()) / max(float(g.norm()), 1e-30))):
            worst[kind] = max(worst[kind], (err, name))
    stats = max(float((got["stats"][n] - v).abs().max())
                for n, v in want["stats"].items())
    gated = "norm" if by_norm else "element"
    log(f"   {what}: losses {want['metrics']} (max err {loss_err:.3g} of "
        f"the total, tol {TRAIN_LOSS_RTOL}); worst gradient leaf by element "
        f"{worst['element'][1]} {worst['element'][0]:.3g} of its largest, "
        f"in L2 norm {worst['norm'][1]} {worst['norm'][0]:.3g} (tol "
        f"{TINY_GRAD_RTOL} {'in norm' if by_norm else 'by element'}); "
        f"running statistics within {stats:.3g} (tol {VOTE_STATS_ATOL})")
    if loss_err > TRAIN_LOSS_RTOL or worst[gated][0] > TINY_GRAD_RTOL \
            or stats > VOTE_STATS_ATOL:
        raise AssertionError(f"{what}: the ranks and one process disagree")


def torchrun(tool, nproc, *args):
    """The arguments after `python -m` of `torch.distributed.run
    --standalone --nproc_per_node=N -m fcaf3d_tpu_torch.tools.<tool>
    args`."""
    return ["torch.distributed.run", "--standalone",
            f"--nproc_per_node={nproc}", "-m",
            f"fcaf3d_tpu_torch.tools.{tool}", *args]


def run_together(jobs, timeout=600):
    """Start every command of `jobs` ({name: the arguments after `python
    -m`}) at once from the repository root, each in a session of its own;
    raises unless each exits 0 within `timeout` s, and then kills every
    session still running (torchrun's ranks with their launcher). Returns
    {name: (stdout, seconds from the start to its exit)}."""
    import signal
    import tempfile

    t0 = time.perf_counter()
    procs, done = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        try:
            for name, argv in jobs.items():
                out, err = (open(os.path.join(tmp, f"{name}.{k}"), "w+")
                            for k in ("out", "err"))
                procs[name] = (subprocess.Popen(
                    [sys.executable, "-m", *argv], cwd=REPO, stdout=out,
                    stderr=err, text=True, start_new_session=True), out, err)
            while len(done) < len(procs):
                if time.perf_counter() - t0 > timeout:
                    raise AssertionError(f"{sorted(set(procs) - set(done))}"
                                         f" still running after {timeout} s")
                for name, (p, out, err) in procs.items():
                    if name in done or p.poll() is None:
                        continue
                    out.seek(0)
                    err.seek(0)
                    if p.returncode != 0:
                        raise AssertionError(
                            f"{name} exited {p.returncode}:\n"
                            f"{out.read()[-3000:]}\n{err.read()[-3000:]}")
                    done[name] = (out.read(), time.perf_counter() - t0)
                time.sleep(0.1)
        finally:
            for p, out, err in procs.values():
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
                out.close()
                err.close()
    return done


def dp_clis(torch, root, params, want, tmp, device, backend, world):
    """The CLIs under torchrun, started together (`run_together`). Over
    gloo: (e) `tools.train` for one epoch at one NCCL rank, its checkpoint
    bitwise equal to the launcher-less run's; (f) the same at `world` gloo
    ranks sharing card 0, one checkpoint. Over NCCL: at `world` ranks, one
    card a rank, one checkpoint. Both: `tools.test --sharded` at `world`
    ranks on the seeded detector's weights (`params`), DP_EVAL_BATCH /
    `world` scenes a rank a forward, its metrics (mAP_0.25 above 0: the
    val GT comes from these weights' detections) equal to `want`, (d)'s
    one process at the same scenes a forward."""
    base = ["--dataset", "scannet", "--data-root", root, "--batch",
            str(TRAIN_BATCH), "--epochs", "1", "--no-eval"]
    # gloo's ranks share card 0; NCCL's rank r takes card r
    args = ["--dist-backend", backend] + (
        ["--device", f"{device}:0"] if backend == "gloo" else [])
    work = os.path.join(tmp, f"cli_{backend}")
    sharded = os.path.join(tmp, "sharded.json")
    jobs = {"train": torchrun("train", world, *base, "--work-dir", work,
                              "--launcher", "pytorch", *args),
            "test": torchrun("test", world, "--dataset", "scannet",
                             "--data-root", root, "--params", params,
                             "--sharded", "--batch", str(DP_EVAL_BATCH),
                             "--out", sharded, *args)}
    plain, nccl = (os.path.join(tmp, f"cli_{k}") for k in ("plain", "nccl1"))
    if backend == "gloo":
        jobs["plain"] = ["fcaf3d_tpu_torch.tools.train", *base,
                         "--work-dir", plain, "--device", device]
        jobs["nccl1"] = torchrun("train", 1, *base, "--work-dir", nccl,
                                 "--launcher", "pytorch", "--dist-backend",
                                 "nccl")
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0] / 2**30
    done = run_together(jobs)
    log(f"   the {len(jobs)} CLI runs started together ({free:.1f} GiB free "
        "on card 0 at their start): "
        + ", ".join(f"{k} {dt:.1f} s" for k, (_, dt) in done.items()))
    if backend == "gloo":
        a, b = (torch.load(os.path.join(w, "ckpts", "epoch_1.pt"),
                           weights_only=True) for w in (plain, nccl))
        differ = [k for k in a["variables"] if not torch.equal(
            a["variables"][k], b["variables"][k])] + [
            f"{m}/{k}" for m in ("mu", "nu") for k in a[m]
            if not torch.equal(a[m][k], b[m][k])]
        if differ or (a["count"], a["epoch"]) != (b["count"], b["epoch"]) \
                or set(a["variables"]) != set(b["variables"]):
            raise AssertionError("(e) the NCCL W = 1 checkpoint differs from "
                                 f"the launcher-less run's: {differ[:8]}")
        log(f"   (e) tools.train, 1 epoch of {a['count']} steps at batch "
            f"{TRAIN_BATCH}, without a launcher and under torchrun at 1 "
            f"NCCL rank: checkpoints bitwise equal ({len(a['variables'])} "
            "variables, both moments, count)")
    ckpts = sorted(os.listdir(os.path.join(work, "ckpts")))
    with open(os.path.join(work, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f if "loss" in line]
    if ckpts != ["epoch_1.pt", "meta.json"] or not recs or not all(
            np.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"torchrun at {world} {backend} ranks: {ckpts}, "
                             f"{recs}")
    log(f"   {'(f) ' if backend == 'gloo' else ''}tools.train under "
        f"torchrun at {world} {backend} ranks: {ckpts}, last step record "
        f"{recs[-1]}")
    with open(sharded) as f:
        got = json.load(f)
    if not same_metrics(got, want) or not got["mAP_0.25"] > 0:
        raise AssertionError(f"tools.test --sharded at {world} {backend} "
                             f"ranks: {got} against {want}")
    log(f"   tools.test --sharded under torchrun at {world} {backend} ranks, "
        f"batch {DP_EVAL_BATCH}: its {len(got)} metrics equal to one "
        f"process's (mAP_0.25 {got['mAP_0.25']:.4f}, mAP_0.50 "
        f"{got['mAP_0.50']:.4f})")


def data_parallel_phase(torch, cfg, bare_step_ms, vote_bare_ms, device,
                        backend="gloo", world=DP_WORLD):
    """Phase 15: data parallelism at `world` ranks, gloo ranks sharing card
    0 or (`--nccl`) NCCL ranks one a card (module docstring). Returns
    launches, launches by variant and records of the three DP paths."""
    import pickle
    import tempfile

    from fcaf3d_tpu_torch.apis import init_detector
    from fcaf3d_tpu_torch.configs import fcaf3d_tiny, votenet_sunrgbd
    from fcaf3d_tpu_torch.configs import votenet_tiny
    from fcaf3d_tpu_torch.parallel import spawn
    from fcaf3d_tpu_torch.params import init_variables

    vcfg = votenet_sunrgbd()
    where = (f"{backend} ranks sharing {device}:0" if backend == "gloo"
             else f"{backend} ranks, one a card")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        root = os.path.join(tmp, "scannet")
        write_scannet_root(root, DP_TRAIN_SCENES, PLATFORM_SCENES[1],
                           cfg.n_classes)
        params = os.path.join(tmp, "seeded.pkl")
        with open(params, "wb") as f:
            pickle.dump(init_variables(cfg, 0), f)
        # the val GT from the seeded detector's own detections, so that
        # (d)'s and tools.test's metric comparisons see matches
        val_ann = os.path.join(root, "scannet_infos_val.pkl")
        taken = gt_from_detections(
            root, val_ann, val_ann, cfg,
            init_detector(cfg, params_file=params, device=device))
        log(f"   val GT from the seeded detector's detections: 2 of "
            + ", ".join(str(n) for n, _, _ in taken) + " a scene")
        spec = {"cfg": cfg, "root": root, "params": params,
                "batch": train_batch(cfg, TRAIN_BATCH, seed0=0),
                "weak_batch": (train_batch(cfg, TRAIN_BATCH * world, seed0=0)
                               if backend == "nccl" else None),
                "tiny_batch": head_batch(torch, fcaf3d_tiny(), TINY_EXTENT,
                                         b=world),
                "vote_batch": vote_train_batch(vcfg, 16, seed0=0),
                "vote_tiny_batch": vote_head_batch(votenet_tiny(), b=world)}
        one = {"tiny": dp_tiny_grads(torch, None, device, spec["tiny_batch"],
                                     False),
               "vote_tiny": dp_tiny_grads(torch, None, device,
                                          spec["vote_tiny_batch"], True)}
        one["eval"] = dp_evaluations(torch, cfg, root, params, None, world,
                                     device)[0]
        if not one["eval"][False][0]["mAP_0.25"] > 0:
            raise AssertionError(f"(d) one process: {one['eval'][False][0]}")
        torch.cuda.empty_cache()  # gloo's ranks share the card
        t0 = time.perf_counter()
        spawn(dp_rank, world, spec, tmp, backend=backend,
              device=f"{device}:0" if backend == "gloo" else device)
        log(f"   -- (a)-(d) at {world} {where}: "
            f"{time.perf_counter() - t0:.1f} s with the ranks' start")
        ranks = [torch.load(os.path.join(tmp, f"dp_rank{r}.pt"),
                            weights_only=False) for r in range(world)]
        a = [r["fcaf3d"] for r in ranks]
        if len({r["digest"] for r in a}) != 1 or any(
                r["metrics"] != a[0]["metrics"] for r in a):
            raise AssertionError("(a) the ranks' variables or metrics differ")
        log(f"   (a) fcaf3d_scannet bf16, global batch {TRAIN_BATCH} at "
            f"{world} {where}: " + "; ".join(
                f"rank {i} {r['step_wall_ms']:.1f} ms/step; with its "
                f"{r['collectives_a_step']} collectives timed "
                f"{r['timed_step_wall_ms']:.1f} ms, {r['collective_ms']:.1f} "
                f"in them (share {r['collective_share']:.3f}; the gradients' "
                f"{r['grad_all_reduce_ms']:.1f}); peak {r['peak_gib']:.2f} GiB"
                for i, r in enumerate(a))
            + f"; the bare batch-{TRAIN_BATCH} step {bare_step_ms:.1f} ms; "
            "variables bitwise equal over the ranks")
        for i, r in enumerate(ranks):
            dp_tiny_gate(r["tiny"], one["tiny"],
                         f"(b) f32 fcaf3d_tiny rank {i}, W = {world} vs 1")
            dp_tiny_gate(r["vote_tiny"], one["vote_tiny"],
                         f"(c) f32 votenet_tiny rank {i}, W = {world} vs 1",
                         by_norm=True)
            for tta, (metrics, dets) in r["eval"].items():
                m1, d1 = one["eval"][tta]
                if not same_metrics(metrics, m1) or len(dets) != len(d1) \
                        or not all(
                        np.array_equal(x[k], y[k]) for x, y in zip(dets, d1)
                        for k in x):
                    raise AssertionError(f"(d) rank {i} tta={tta}: sharded "
                                         "evaluation differs")
        c = [r["votenet"] for r in ranks]
        if len({r["digest"] for r in c}) != 1:
            raise AssertionError("(c) the ranks' VoteNet variables differ")
        log(f"   (c) votenet_sunrgbd f32, global batch 16 at {world} ranks: "
            + "; ".join(f"rank {i} {r['step_wall_ms']:.1f} ms/step, peak "
                        f"{r['peak_gib']:.2f} GiB" for i, r in enumerate(c))
            + f"; the bare batch-16 step {vote_bare_ms:.1f} ms; variables "
            "bitwise equal over the ranks")
        log(f"   (d) sharded evaluation of {PLATFORM_SCENES[1]} val scenes at "
            f"global batch {DP_EVAL_BATCH}: every rank's metrics and "
            "detections equal to one process's, with and without TTA "
            f"(mAP_0.25 {one['eval'][False][0]['mAP_0.25']:.4f}, with "
            f"TTA {one['eval'][True][0]['mAP_0.25']:.4f})")
        weak = [r["weak"] for r in ranks if "weak" in r]
        if weak:
            if len({r["digest"] for r in weak}) != 1:
                raise AssertionError("the weak-scaling ranks' variables "
                                     "differ")
            dp_ms = max(r["step_wall_ms"] for r in weak)
            log(f"   weak scaling: fcaf3d_scannet bf16, {TRAIN_BATCH} a rank "
                f"(global batch {TRAIN_BATCH * world}) at {world} {where}: "
                + "; ".join(f"rank {i} {r['step_wall_ms']:.1f} ms/step, "
                            f"peak {r['peak_gib']:.2f} GiB"
                            for i, r in enumerate(weak))
                + f"; the bare batch-{TRAIN_BATCH} step {bare_step_ms:.1f} "
                f"ms; an epoch {world * bare_step_ms / dp_ms:.2f} x faster "
                f"than on one card ({world} x {bare_step_ms:.1f} / "
                f"{dp_ms:.1f}, the slowest rank); variables bitwise equal "
                "over the ranks")
        dp_clis(torch, root, params, one["eval"][False][0], tmp, device,
                backend, world)
    paths = ("fcaf3d_dp_training", "votenet_dp_training", "fcaf3d_dp_eval")
    launches, variants = {}, {}
    for p in paths:
        launches[p], variants[p] = {}, {}
        for r in ranks:
            launches[p] = add_counts(launches[p], r["launches"][p])
            variants[p] = add_counts(variants[p], r["variants"][p])
        check_path_launches(launches[p], p)
    return launches, variants, {"fcaf3d": a, "votenet": c, "weak": weak}


def nccl_phase(torch, cfg, world):
    """`--nccl N`: phase 15 over NCCL at N ranks, one a card, with (a)'s
    step also at TRAIN_BATCH a rank (weak scaling: global batch N x
    TRAIN_BATCH), beside the bare single-card steps of phases 6 and 11
    (card 0)."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.configs import votenet_sunrgbd

    if torch.cuda.device_count() < world:
        raise SystemExit(f"chip_smoke --nccl {world}: "
                         f"{torch.cuda.device_count()} cards")
    log(f"== bare steps on card 0: fcaf3d_scannet bf16 batch {TRAIN_BATCH}, "
        "votenet_sunrgbd f32 batch 16")
    *_, step_ms = train_phase(torch, cfg, train_batch(cfg, TRAIN_BATCH, 0),
                              "cuda")
    vcfg = votenet_sunrgbd()
    _, _, vrec, _ = vote_train_phase(torch, vcfg, vote_train_batch(vcfg, 16,
                                                                   0),
                                     "cuda", VOTE_TRAIN_STEPS,
                                     "votenet_training")
    _native.reset_launches()
    log(f"== 15 over NCCL: {world} ranks, one a card")
    return data_parallel_phase(torch, cfg, step_ms, vrec["step_wall_ms"],
                               "cuda", backend="nccl", world=world)


KERNELS = (
    ("searchsorted", "fcaf3d_tpu_torch/csrc/search.cu",
     "fcaf3d_tpu/ops/sparse/search.py:149"),
    ("gather_gemm", "fcaf3d_tpu_torch/csrc/gather_gemm_tc.cu",
     "fcaf3d_tpu/ops/sparse/gather_kernel.py:410"),
    ("gather_max", "fcaf3d_tpu_torch/csrc/gather_max.cu",
     "fcaf3d_tpu/ops/sparse/gather_kernel.py:991"),
    ("gather_dw", "fcaf3d_tpu_torch/csrc/gather_dw_tc.cu",
     "fcaf3d_tpu/ops/sparse/gather_kernel.py:755"),
    ("fps", "fcaf3d_tpu_torch/csrc/fps.cu",
     "fcaf3d_tpu/ops/pointnet/fps_kernel.py:98"),
    ("ball_query", "fcaf3d_tpu_torch/csrc/ball_query.cu",
     "fcaf3d_tpu/ops/pointnet/ballq_kernel.py:157"),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile a bf16 inference scan, a VoteNet scan and "
                         "the batch-8 bf16 train step instead")
    ap.add_argument("--grad-control", type=int, metavar="SEEDS",
                    help="measure the f32 ScanNet gradients' sensitivity "
                         "over SEEDS seeds instead")
    ap.add_argument("--nccl", type=int, metavar="N",
                    help="run phase 15 over NCCL at N ranks, one a card, "
                         "instead")
    args = ap.parse_args()
    import torch

    t_start = time.perf_counter()
    smi = device_phase(torch)
    sys.path.insert(0, REPO)
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.configs import fcaf3d_scannet, votenet_sunrgbd

    build_phase()
    cfg = fcaf3d_scannet()
    batch = train_batch(cfg, TRAIN_BATCH, seed0=0)
    if args.profile:
        profile_inference(torch, cfg, [scan(seed) for seed in range(2)])
        profile_votenet(torch, votenet_sunrgbd(), "cuda")
        return profile_train(torch, cfg, batch)
    if args.grad_control:
        return grad_control(torch, cfg, "cuda", args.grad_control)
    if args.nccl:
        return nccl_phase(torch, cfg, args.nccl)
    scans = [scan(seed) for seed in range(3)]
    log("== 3 kernels against their plain versions, main-path shapes")
    maps = backbone_maps(sample(scans[0], cfg)[None], cfg, "cuda")
    clouds = np.concatenate([batch["points"], batch["colors"]], axis=-1)
    maps8 = backbone_maps(clouds, cfg, "cuda")
    rec = kernel_phase(torch, cfg, maps, maps8)
    log(f"== 4 backward kernels against their plain versions, training "
        f"shapes, batch 1 and batch {TRAIN_BATCH}")
    rec.update(backward_kernel_phase(torch, cfg, [maps, maps8]))
    del maps8  # phase 6's peak memory counts no map of phases 3-4
    log("== 5 inference: fcaf3d_scannet, bf16, batch 1, 100000 points per "
        "scan")
    infer_launches, infer_variants, k1_infer = slice_phase(torch, cfg, scans,
                                                           "cuda")
    rec["gather_gemm"]["f32_scan"] = compare_f32(torch, cfg, scans[0], "cuda")
    log(f"== 6 training: fcaf3d_scannet, bf16, batch {TRAIN_BATCH}, "
        f"{cfg.num_points} points per scan")
    train_launches, train_variants, k1_train, step_ms = train_phase(
        torch, cfg, batch, "cuda")
    _native.reset_launches()
    compare_train_tiny(torch, "cuda")
    compare_train_f32(torch, cfg, "cuda")
    check_variants("f32 train steps", f32=True)
    rec["searchsorted"]["path_calls"] = {"fcaf3d_inference": k1_infer,
                                         "fcaf3d_training": k1_train}
    vcfg = votenet_sunrgbd()
    log("== 7 K5 and K6 against their plain versions, VoteNet-path shapes")
    rec.update(pointnet_kernel_phase(torch, vcfg, "cuda"))
    log(f"== 8 inference: votenet_sunrgbd, f32, batch 1, {vcfg.num_points} "
        "points per scan")
    vote_launches, vote_variants, turns = votenet_phase(torch, vcfg, "cuda")
    rec["fps"]["scan_turns"] = {v: {k: t[k] for k in ("wall_ms", "fps_ms")}
                                for v, t in turns.items()}
    rec["ball_query"]["scan_turns"] = {
        v: {k: t[k] for k in ("wall_ms", "ball_query_ms")}
        for v, t in turns.items()}
    log("== 9 the other FCAF3D configs: " + ", ".join(OTHER_CONFIGS)
        + f"; bf16 inference, {OTHER_SCANS} scans each; SUN RGB-D f32 card "
        f"vs CPU and bf16 training at batch {TRAIN_BATCH}")
    other_launches, other_variants, other_k1, rows = other_configs_phase(
        torch, "cuda")
    rec["searchsorted"]["path_calls"].update(other_k1)
    for kernel in ("gather_gemm", "gather_max"):
        rec[kernel]["other_configs"] = {name: r[kernel]
                                        for name, r in rows.items()}
    log("== 10 the rest of FCAF3D: the reference neck (bf16 inference, f32 "
        f"card vs CPU, bf16 training at batch {TRAIN_BATCH}), depth 50 and "
        "101, voxelize_reduce")
    rest_launches, rest_variants, rest_k1, rest_rows = rest_of_fcaf3d_phase(
        torch, cfg, scans, batch, "cuda")
    rec["searchsorted"]["path_calls"].update(rest_k1)
    for kernel, r in rest_rows.items():
        rec[kernel]["rest_of_fcaf3d"] = r
    log("== 11 VoteNet training and VoteNet-v1: votenet_sunrgbd training "
        "(f32, batch 16), tiny gates card vs CPU, v1 inference and training "
        "(SUN RGB-D batch 16, ScanNet batch 8, 40 000 points)")
    vt_launches, vt_variants, vt_recs, vt_rows = votenet_training_phase(
        torch, "cuda")
    for kernel, r in vt_rows.items():
        rec[kernel]["training_shapes"] = r
    rec["fps"]["votenet_training"] = vt_recs
    log("== 12 ImVoteNet: Detector2D (width 64, FPN 128, 480 x 640) and "
        "inference_imvotenet at votenet_sunrgbd (f32, batch 1), training at "
        f"batch {IMVOTE_TRAIN_BATCH}, tiny gates card vs CPU")
    iv_launches, iv_variants, iv_recs, iv_rows = imvotenet_phase(torch,
                                                                 "cuda")
    for kernel, r in iv_rows.items():
        rec[kernel]["aggregation_shapes"] = r
    rec["fps"]["imvotenet"] = iv_recs
    log("== 13 the platform: fcaf3d_scannet, ScanNet-layout dataset, "
        f"train_model (bf16, batch {TRAIN_BATCH}, 2 epochs), checkpoints, "
        "resume, evaluate_dataset with TTA, f32 card vs CPU, the CLIs")
    pf_launches, pf_variants, pf_k1 = platform_phase(torch, cfg, step_ms,
                                                     "cuda")
    rec["searchsorted"]["path_calls"].update(pf_k1)
    log("== 14 the rest of the platform: the VoteNet v2 / v1, Detector2D and "
        "ImVoteNet train loops, the .pth converter (fcaf3d_scannet, VoteNet, "
        "ImVoteNet), BN fusing and publishing")
    tl_launches, tl_variants, tl_k1 = tools_phase(torch, cfg, scans, vt_recs,
                                                  iv_recs, "cuda")
    rec["searchsorted"]["path_calls"].update(tl_k1)
    log(f"== 15 data parallelism: {DP_WORLD} gloo ranks sharing the card: "
        f"fcaf3d_scannet (bf16, global batch {TRAIN_BATCH}), votenet_sunrgbd "
        "(f32, global batch 16), tiny gates against one process, sharded "
        "evaluation, tools.train / tools.test under torchrun (NCCL at 1 "
        "rank, gloo at "
        f"{DP_WORLD})")
    dp_launches, dp_variants, dp_recs = data_parallel_phase(
        torch, cfg, step_ms, vt_recs["votenet_training"]["step_wall_ms"],
        "cuda")
    rec["gather_gemm"]["data_parallel"] = dp_recs["fcaf3d"]
    rec["fps"]["votenet_dp_training"] = dp_recs["votenet"]
    log(f"== all phases passed in {time.perf_counter() - t_start:.1f} s")
    for what, ms, first, second in NOT_FASTER:
        log(f"   not faster than a yardstick: {what}: kernel {ms:.4f} ms, "
            f"yardsticks {first} and {second} ms")
    by_path = {"fcaf3d_inference": infer_launches,
               "fcaf3d_training": train_launches,
               "votenet_inference": vote_launches, **other_launches,
               **rest_launches, **vt_launches, **iv_launches,
               **pf_launches, **tl_launches, **dp_launches}
    variants = {"fcaf3d_inference": infer_variants,
                "fcaf3d_training": train_variants,
                "votenet_inference": vote_variants, **other_variants,
                **rest_variants, **vt_variants, **iv_variants,
                **pf_variants, **tl_variants, **dp_variants}
    kernels = []
    for name, src, tpu in KERNELS:
        k = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
             "launches": sum(p[name] for p in by_path.values()),
             "launches_by_path": {k: p[name] for k, p in by_path.items()},
             **rec[name]}
        k["launches_by_variant"] = {
            path: {key: n for key, n in v.items()
                   if key.startswith(name + "/")}
            for path, v in variants.items()}
        kernels.append(k)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
