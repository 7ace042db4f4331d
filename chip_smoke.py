#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (plant3dvision_tpu_torch) on one GPU.

1. Builds the port's CUDA kernels from kernels/csrc (nvcc, in parallel),
   and for phase 18 its native geometry library (native/geometry.cpp, g++).
2. Drives the geometric main path through the port's task runtime:
   a synthetic 300-view 1440x1080 turntable scan at 1 mm,
   configs/geom_pipe_fast.toml, ImagesFilesetExists -> FusedCarving ->
   PointCloud -> CurveSkeleton -> RefineSkeleton -> TreeGraph ->
   AnglesAndInternodes: one cold pass, then a warm pass after Clean
   (profiled too with --profile). Checks that every kernel was launched
   in the warm pass, that more than 10 angles come out and that their mean error against the
   plant's ground truth is below 1 degree.
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (K1 on one 100-view group, K2-K4 on the carved grid;
   K3 as vol2pcd calls it, the fused smoothed_gradient, one launch a call,
   with `gradient` and `gaussian_filter` alone held equal, untimed)
   and times kernel, plain version and, where one exists, a PyTorch
   library call computing the same function (CUDA events, median; K1's
   `kernel_ms` is its device time from torch.profiler). K4's
   rows (here and in phase 6) also give a call's launches and host syncs
   and its floor_ms: as many empty launches and one 8-byte read.
4. Runs the 60-view 1440x1080 carve into a 301x301x561 grid at 0.5 mm
   (K1 bit-equal to its plain version, with its launches, device time and
   bound) and vol2pcd on its result.
5. Drives the ML path through the port's task runtime at full width: a
   126-view 896x896 photo-domain scan (ProceduralArabidopsis(seed=1); its
   organs' masks in ML_GT_FILESET, phase 21's ground truth), the
   committed TPUSegNet, FusedSegmentationCarving at 0.25 mm (165x146x504
   voxels, 6 labels, bilinear, batches of 32) -> multiclass PointCloud ->
   OrganSegmentation -> AnglesAndInternodes: one cold pass, one warm pass
   after Clean (profiled too with --profile). Checks that K2-K6 were
   launched in the warm pass, that at least 10 angles come out and that
   their mean error (DTW-aligned against the generator's ground truth) is
   below 20 degrees.
6. Holds K5 (accumulate; bilinear, box and log modes, over the whole grid
   in one launch as the pass runs it, and through the 3-slab lane, bit for
   bit) on one real batch of 32 CNN outputs of that scan, with the
   distribution of its tiles' pixel windows, K6 (select; with its device
   time) on the warm pass's label volumes and K2-K4 on its fruit
   selection, against
   their plain versions (K2 also in its 32-bit lane, cap None on the ML
   grid, bit for bit; every K2 row gives its lane, its launches a call and
   `bound_ms_yz`, the bound of the y and z passes' candidates alone),
   and times them beside a PyTorch library chain computing the same
   function. Each kernel row names the path (geometric,
   ml or ml_separate) whose shapes it was measured at and whose launches it
   counts.
7. Drives the separate-task ML route (configs/ml_pipe_virtual.toml without
   its evaluation tasks) on phase 5's scan with the committed ResUNet at
   full width (896x896): Segmentation2D -> Voxels (averaging, 0.25 mm, 5
   labels) -> multiclass PointCloud -> SegmentedPointCloud ->
   OrganSegmentation -> AnglesAndInternodes; one cold pass, one warm pass
   after Clean (profiled too with --profile); then Segmentation2D
   alone with the reference's binarised masks (threshold 0.01, dilation 1).
   Checks that K2-K4, K5-avg, K6 and K7 were launched in the warm pass and
   K8 in the binarised run, that at least 10 angles come out and that their
   mean error is below 25 degrees.
8. Holds K5-avg (one label's 126 masks, plain and log'd; with its tiles'
   windows), K6 (the pass's averaged label volumes, its PointCloud
   settings; with its device time, as phase 6's K6 row), K7 (the warm
   pass's points and 630 masks; with its camera runs and the bound of one
   projection a run, `bound_ms_runs`) and K8 (the pass's 756 masks
   thresholded at 0.01, radius 1 and 3) against their plain versions at
   that route's shapes, and times them beside a PyTorch library chain
   (tools/harris_reproject_ab.py times K7 of two checkouts in turns).
9. Drives the real-scan front end (configs/geom_pipe_real_selfcal.toml's
   tasks after its TurntableCalibration: Undistorted -> Masks -> Voxels
   with vote carving (kill_tolerance 3) at 0.5 mm into phase 4's
   301x301x561 grid -> PointCloud -> CurveSkeleton -> RefineSkeleton ->
   TreeGraph -> AnglesAndInternodes) on a 60-view 1440x1080 RGB scan of the
   north-star plant through a lens with OPENCV k1 = -0.08, as
   TurntableCalibration leaves it (colmap_camera, pose_estimation; two
   views "incorrect", which Undistorted's query drops): one cold pass, one
   warm pass after Clean (profiled too with --profile); then a
   control pass with strict carving, undilated masks and the main path's
   skeleton settings. Checks (after phase 10) that K2-K4 and K8-K11 were
   launched in the warm pass, that 58 undistorted images and 58 masks were
   written, that at least 10 angles come out with a mean error
   (DTW-aligned against the plant's ground truth) below 10 degrees (the
   config's real-plant settings cost accuracy on this plant), and that the
   control gives at least 10 angles below 2 degrees.
10. Holds K9 (the 58 raw images), K10 (linear and excess green, on the 58
   undistorted images; also against compute_mask_numpy) and K11
   (count_kills and carve_tolerant at 3, on the 58 masks) against their
   plain versions at that path's shapes, and times them beside a PyTorch
   library call (grid_sample for K9; for K10 the fast lane's own call,
   imgs[..., k] > t, with the tensordot chain beside it, and the excess
   green chain; none for K11). K9's row gives its device time
   (torch.profiler) and its tiles by lane (staged, global-load, empty) as
   the kernel counted them, held equal to `tile_windows`' prediction.
   K10 is also timed on one image, as live
   carving launches it. Holds K8 at the Masks task's radius 3 on the
   linear lane's 58 masks against its plain version and conv2d with the
   disk.
11. Drives configs/geom_pipe_real_selfcal.toml from TurntableCalibration to
   AnglesAndInternodes (selfcal_config: no TriangleMesh, no evaluation,
   Voxels' box phase 9's) on a 60-view 1440x1080 RGB turntable scan of the
   textured north-star plant on phase 9's ring, whose images carry only CNC
   'approximate_pose' metadata (write_turntable_scan; the true cameras are
   cnc_to_cameras(poses + per-view jitter, theta*)): one cold pass, one
   warm pass after Clean (profiled too with --profile), then phase 9's strict
   control on the calibrated cameras. Prints TurntableCalibration's stage
   seconds (masks, CEM, BA with its detect / match / GN split, polish,
   coverage). Checks (after phase 12) that K8, K9, K10, K11, K11b, K12, K13
   and K2-K4 were launched in the warm pass, that the feature BA gave a
   result, >= 55 views "correct", at least 10 angles with a mean error
   (DTW) below 15 degrees, and that the calibration is the JAX package's on
   this scan (SELFCAL_REFERENCE: the focal length, the coherence and the
   median reprojection of the plant's surface against the true cameras).
   Prints the reprojection (raw, and up to the turntable's axis gauges)
   and the quality bars the JAX package's calibration misses here too
   (coherence >= 0.9, a median reprojection below 2 px, angles below 10
   degrees). Checks that the cold and the warm pass calibrated the scan to
   equal cameras and prints both passes' angle errors. After phase 12, one
   pass of configs/ml_pipe_real_hybrid.toml's tasks after its calibration
   on phase 11's calibration (segnet_real at 704x528 with resize = true),
   run to the angles with no angle bar.
12. Holds K11b (a round-0 and a round-1 CEM population, the polish's
   robust hull), K12 (the two populations and the polish's V x G launch),
   K8 (the keypoint masks, radius 6) and K13 (the 60 grays in chunks of
   12) against their plain versions at phase 11's shapes
   (selfcal_launches; tools/selfcal_ab.py times K11b and K12 of two
   checkouts in turns), and times them beside a library call for K8
   (conv2d with the disk) and K13 (rolls + avg_pool2d + max_pool2d; none
   for K11b, K12), with harris_keypoints' call and its band sort alone
   timed beside K13 (tools/harris_reproject_ab.py times K13 of two
   checkouts in turns).
13. Drives CurveSkeleton(method="fim") on phase 9's scan (written here if
   phase 9 did not run) through phase 9's strict front end (0.5 mm, the
   301x301x561 grid; bin_size 4 voxels = 2 mm): one cold pass, one warm
   pass after Clean (profiled too with --profile), Undistorted to
   AnglesAndInternodes. Prints the eikonal solve's sweep count, its ms in
   total and a sweep, the host clustering seconds, and the angles' count
   and DTW error (no angle bar). Checks (after phase 14) that K14 was
   launched once in the warm pass and once for the solve alone, that the
   solve read the host once after the compaction's nonzero (torch.cuda's
   sync debug mode counts 2), and that the skeleton is a tree and has the
   solve's clusters.
14. Holds K14 (the whole solve on phase 13's volume, bit for bit, the same
   sweep count) and K15 (2000 steps of 0.5 from the skeleton's leaf nodes,
   on the solve's flow; votes equal) against their plain versions and
   times both (none has a library call); K14's row gives the compaction's
   ms and `floor_ms`, the sweeps times a measured empty grid barrier.
   K15 runs once with the counts set to 0; its row gives the kernel's
   device time without the vote grid's zeroing and the zeroing's, the
   plain walk's steps, the longest and the mean, and
   `floor_ms`, the longest walk's steps times a measured dependent step
   whose reads all hit L1.
15. Live carving: replays phase 2's scan (written here if phase 2 did not
   run) into a fresh scan directory, a copy thread writing the views in
   file order while `python -m plant3dvision_tpu_torch.live_carve` watches
   it in a subprocess (previews every 50 views). Checks that the final
   volume is K1's batch carve of the same 300 masks and carve_plain's, that
   K1 ran once a preview and K10 once a view, and prints the seconds per
   preview, the views ingested per second and the device's idle share.
16. The int8 serving lane: phase 7's route with
   Segmentation2D(conv_mode="int8") on phase 5's scan (needs phase 5), one
   pass to the angles beside phase 7's bf16 pass, both lanes' inference
   seconds and argmax agreement over the 126 views; then K16 (the
   weight quantise, the activation absmax and the conv, which quantises as
   it stages) against its plain version, bit for bit, at every conv shape
   of unet_seg (the pass's batch of 32) and tpusegnet_seg (one image) at
   896x896, timed beside the plain version, the library chain (absmax,
   round, pad, im2col, torch._int_mm (cuBLASLt int8), epilogue) and the
   bf16 cuDNN conv; and K16's weight quantise for all of each net's
   compute weights in one launch (amax and the conv's packed layout, bit
   for bit), timed beside the plain version and the library chain summed
   over the weights. The pass makes one weight quantise launch.
17. The gather probes K17-K19 at exp_pallas_gather.py:main's sizes, each
   equal to its plain version and to a torch.gather / index_select chain;
   M lookups/s, bounds, and the three versions' times; every row gives
   `floor_ms`, the same launch at reps = 0 (the indices, K17's staging
   and the output alone), K18's `lookup_bytes` (128 a lookup, through
   L1/L2).
18. configs/geom_pipe_full.toml (full_config: Colmap -> Undistorted ->
   Masks -> Voxels (carving at 1 mm in Colmap's auto box) -> PointCloud ->
   TriangleMesh (IMLS) -> CurveSkeleton (graph, over the mesh) ->
   RefineSkeleton -> TreeGraph -> AnglesAndInternodes; Colmap's
   distance_threshold 5 in place of 0, FULL_DISTANCE_THRESHOLD says why)
   on a 60-view 1440x1080 RGB scan of the north-star plant on phase 9's
   ring through its lens (SIMPLE_RADIAL k1 = -0.08), written as a rig
   logs it (CNC poses, no camera). The colmap binary is absent here: a
   stand-in (STANDIN_COLMAP, written into the scratch directory and named
   by COLMAP_EXE) plays a COLMAP that recovered the true cameras and a
   sample of the plant's surface; everything after it is the port's. One
   cold pass, one warm pass after Clean (profiled too with --profile). Checks
   (after phase 19) that the cold pass failed at TriangleMesh with no image
   undistorted and no mask with a camera (the JAX runtime's task order on
   a fresh scan), that K1-K4 and K8-K10 were launched in the warm pass,
   K2 by the mesh call too, that Colmap wrote its outputs and every view's
   colmap_camera, that the warm pass undistorted every view, that the mesh
   is non-empty and one component and that at least 10 angles come out;
   prints how many images each pass undistorted (on a fresh scan
   Undistorted runs before Colmap, as in the JAX runtime, and copies them
   as they are), the Colmap task's seconds, the mesh's stage seconds
   (occupancy, K2's call, the IMLS field, the extraction) and the angles'
   DTW error (no angle bar).
19. K2 on phase 18's mesh grid (the point cloud's occupancy padded by 4,
   cap 8, as pcd2mesh calls it) against its plain version, bit for bit,
   with its bound and the pass's launches; then CurveSkeleton(method="mcf")
   once on phase 18's mesh (host C++ contraction), its seconds.

20. geom_pipe_virtual.toml's evaluation sections, as shipped, on phase 2's
   scan after its warm pass (run_geom_evaluation): PointCloudGroundTruth
   (100,000 samples of the VirtualPlant mesh), PointCloudEvaluation (2.0
   mm), AnglesAndInternodesEvaluation (the plant's metadata, free_ends
   0.4) and Visualization (300 images and thumbnails; without matplotlib
   it raises at its figures after writing them, as the JAX task does,
   and the phase checks that instead); virtual_cylinder.toml on a bare
   scan; the main() of `python -m
   plant3dvision_tpu_torch.tools.robustness_evaluation` over 3 replicates
   of a bare copy of the scan through geom_pipe_fast.toml (each launching
   K1-K4), then compare_angles.
   Checks the JSONs, the DTW error below 1 degree, a fitness above 0,
   the cylinder's radius within 0.1, each replicate's angle count equal
   to the warm pass's and the replicates' launches; prints each task's
   seconds and the replicates' pairwise errors.
21. ml_pipe_virtual.toml's seven evaluation sections, as shipped, on phase
   5's scan after phase 7's warm pass (run_ml_evaluation; the ground
   truth: the organs' masks, which phase 5 wrote into ML_GT_FILESET, and
   the OBJ, written first by write_virtual_plant_obj), then
   Segmentation2DEvaluation at dilation_amount 2 (K8 at radius 2 on 4
   labels x 126 masks of 896x896, one launch a label's 126 masks).
   Checks the outputs of the tasks that run and the JAX package's failure
   of SegmentedPointCloudEvaluation on this data; prints each task's
   seconds, the mIoU per label and VoxelsEvaluation's precision and recall
   per label; then K8 at radius 2 on each label's stack against its plain
   version, and on one label's beside library_dilation
   (check_ml_evaluation_kernels).

22. Training: models/train_synth.py's main() at the shipped ResUNet's
   width (24, 48, 96, 192) x 2 blocks, crop 448, batch 8, lr 3e-3, on a
   reduced procedural set (2 plants x 6 views, 24 crops; the recipe's
   12 x 18), 100 steps (of 3000), the launch counts at 0 just before;
   the float16 checkpoint through the port's load_model and
   segmentation_inference on the held-out crops; a 3-chunk run
   checkpointed every chunk, its middle chunk under torch.profiler (the
   device's idle share), resumed from its chunk-0 state and held equal
   bit for bit; a 25-step TPUSegNet run (128, 256, 256). Checks that the
   loss falls, K20-K23 were launched, and a step launched K20, K21's pass,
   its backward and K22 once each; then K20-K23 against their plain
   versions at its shapes, timed beside a PyTorch call or chain, with
   their device time by kernel (check_train_kernels; K21 also as the
   trainers' call, weighted_cross_entropy then .backward()).
23. configs/training_seg.toml: `python -m plant3dvision_tpu_torch.models.
   train` (main) on a copy of phase 5's first 32 views and organ masks,
   widths 32, 64, 128 at 896x896, batch 4, 2 epochs (of 50); then the
   config's Segmentation2D with the trained model (needs phase 5); K21's
   pass, its backward and K22 once a step; then K21 on the phase's first
   batch, (4, 5, 896, 896), against its plain version (ce_rows).
24. models/distill.py's distill_scan on phase 9's scan (its geometric
   route read back), 100 steps (of 2000): pseudo-label stats, losses,
   the held-out views' IoU (needs phase 9); K21's pass two launches a
   step (its kept count first), its backward and K22 one; then K21 with
   the ignored label 255 on a batch of its crops, (8, 3, 448, 448), and
   K23 from a held-out view's predictions with the ignored label,
   1080x1440, against their plain versions (ce_rows, iou_row).
25. parallel/ (needs phases 5 and 7): 8 rank processes sharing the card
   over gloo, and a one-rank NCCL group (ranks share one card: no time
   here is a speed-up). bench.py's workload (phase 4's 60 views of
   1440x1080 into 301x301x561 at 0.5 mm) carved view-sharded at 4 ranks
   and at the NCCL rank, grid-sharded at 4 (x padded to 304), 2-D on
   2 x 2, each bit-equal to the one-device K1 volume; K1 with x_start on
   one slab against its plain version and the grid's rows; the x-slab
   averaging volume at 4 ranks on phase 7's fruit masks (126 x 896x896,
   0.25 mm) bit-equal to one device's K5-avg; dp serving at 2 ranks on 32
   of phase 5's images equal to one device; train_on_crops(use_mesh=True)
   at 8 ranks (dp 8, one image a rank) at phase 22's width: 3 float32
   steps of the trainer's optimizer (clip by the global norm, engaged;
   lr 1e-3; weight decay) whose losses, parameters and both moments are
   bit-equal to one device computing the ranks' decomposition (each
   image's gradient x its share, summed in rank order), the first 20
   step losses in bfloat16 beside one device's (reported), a 2-chunk
   bfloat16 run resumed from chunk 0 bit-identical;
   tools/evaluate_model on phase 5's scan (the comparison's seconds:
   phase 7's Segmentation2D is reused). The launch counts are the
   ranks', set to 0 before the sharded programs.

Prints one JSON object per line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without that line when there is no CUDA device or any
phase fails.

Usage: python3 chip_smoke.py [--only 13,14] [--profile]  (--only 2,20,
5,7,21, 5,23, 9,24 or 5,7,25: the phases with the paths they read;
--profile: each path's warm pass then once more under torch.profiler)
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
L2_BYTES = 50 * 2**20          # H100 SXM L2, NVIDIA data sheet
# --profile: each path's warm pass is followed by a profiled one
# (`warm_pass`); off by default, so that warm_s is an unprofiled pass
PROFILE = False

KERNEL_INFO = {
    "carve": ("plant3dvision_tpu_torch/kernels/csrc/carve.cu",
              "plant3dvision_tpu/ops/carving.py:65"),
    "signed_distance": ("plant3dvision_tpu_torch/kernels/csrc/edt.cu",
                        "plant3dvision_tpu/ops/edt.py:31"),
    "gradient_gaussian": ("plant3dvision_tpu_torch/kernels/csrc/filters.cu",
                          "plant3dvision_tpu/ops/filters.py:40"),
    "band_compact": ("plant3dvision_tpu_torch/kernels/csrc/band.cu",
                     "plant3dvision_tpu/proc3d.py:37"),
    "accumulate_labels": (
        "plant3dvision_tpu_torch/kernels/csrc/accumulate.cu",
        "plant3dvision_tpu/ops/ml_fused.py:30"),
    "multiclass_select": ("plant3dvision_tpu_torch/kernels/csrc/select.cu",
                          "plant3dvision_tpu/ops/multiclass.py:31"),
    "average": ("plant3dvision_tpu_torch/kernels/csrc/accumulate.cu",
                "plant3dvision_tpu/ops/carving.py:99"),
    "reproject_scores": ("plant3dvision_tpu_torch/kernels/csrc/reproject.cu",
                         "plant3dvision_tpu/ops/reproject.py:16"),
    "dilate_disk": ("plant3dvision_tpu_torch/kernels/csrc/dilate.cu",
                    "plant3dvision_tpu/ops/masks.py:55"),
    "undistort": ("plant3dvision_tpu_torch/kernels/csrc/undistort.cu",
                  "plant3dvision_tpu/ops/undistort.py:64"),
    "mask_filter": ("plant3dvision_tpu_torch/kernels/csrc/mask.cu",
                    "plant3dvision_tpu/ops/masks.py:83"),
    "count_kills": ("plant3dvision_tpu_torch/kernels/csrc/carve.cu",
                    "plant3dvision_tpu/ops/carving.py:215"),
    "carve_candidates": ("plant3dvision_tpu_torch/kernels/csrc/carve.cu",
                         "plant3dvision_tpu/ops/selfcal.py:97"),
    "ray_coverage": ("plant3dvision_tpu_torch/kernels/csrc/coverage.cu",
                     "plant3dvision_tpu/ops/selfcal.py:109"),
    "harris_response": ("plant3dvision_tpu_torch/kernels/csrc/harris.cu",
                        "plant3dvision_tpu/ops/sfmlite.py:52"),
    "eikonal_sweep": ("plant3dvision_tpu_torch/kernels/csrc/eikonal.cu",
                      "plant3dvision_tpu/ops/eikonal.py:59"),
    "trace_geodesics": ("plant3dvision_tpu_torch/kernels/csrc/geodesics.cu",
                        "plant3dvision_tpu/ops/geodesics.py:42"),
    "int8_quantize": ("plant3dvision_tpu_torch/kernels/csrc/int8conv.cu",
                      "plant3dvision_tpu/models/quant.py:49"),
    "int8_absmax": ("plant3dvision_tpu_torch/kernels/csrc/int8conv.cu",
                    "plant3dvision_tpu/models/quant.py:49"),
    "int8_conv": ("plant3dvision_tpu_torch/kernels/csrc/int8conv.cu",
                  "plant3dvision_tpu/models/quant.py:49"),
    "gather_axis1": ("plant3dvision_tpu_torch/kernels/csrc/gather.cu",
                     "exp_pallas_gather.py:66"),
    "gather_rows": ("plant3dvision_tpu_torch/kernels/csrc/gather.cu",
                    "exp_pallas_gather.py:96"),
    "gather_select32": ("plant3dvision_tpu_torch/kernels/csrc/gather.cu",
                        "exp_pallas_gather.py:132"),
    "batch_gather": ("plant3dvision_tpu_torch/kernels/csrc/train.cu",
                     "plant3dvision_tpu/models/train_synth.py:273"),
    "weighted_ce": ("plant3dvision_tpu_torch/kernels/csrc/train.cu",
                    "plant3dvision_tpu/models/train_synth.py:257"),
    "weighted_ce_backward": ("plant3dvision_tpu_torch/kernels/csrc/train.cu",
                             "plant3dvision_tpu/models/train_synth.py:288"),
    "adamw": ("plant3dvision_tpu_torch/kernels/csrc/train.cu",
              "plant3dvision_tpu/models/train_synth.py:289"),
    "adamw_tp": ("plant3dvision_tpu_torch/kernels/csrc/train.cu",
                 "plant3dvision_tpu/models/train_synth.py:289"),
    "iou_counts": ("plant3dvision_tpu_torch/kernels/csrc/train.cu",
                   "plant3dvision_tpu/models/train_synth.py:297"),
}

#: the ML path's configuration: bench_e2e.py:run_ml_northstar at 0.25 mm
ML_VOXEL, ML_SIZE, ML_VIEWS, ML_BATCH = 0.25, 896, 126, 32
#: where phase 5 writes its scan's per-organ masks: the fileset that
#: Segmentation2DGroundTruthFilesetExists names by default (phase 21's
#: ground truth), out of the way of the tasks that read every image and
#: kept by the ML routes' Clean
ML_GT_FILESET = "Segmentation2DGroundTruth"
ML_CLEAN = {"no_confirm": True,
            "keep": ["images", "models", "calibration", ML_GT_FILESET]}
ML_CONFIG = {
    "ModelFilesetExists": {"scan_id": "models"},
    "FusedSegmentationCarving": {
        "upstream_task": "ImagesFilesetExists", "camera_metadata": "camera",
        "voxel_size": ML_VOXEL, "Sx": ML_SIZE, "Sy": ML_SIZE,
        "batch_size": ML_BATCH, "log": False, "sample": "bilinear"},
    "PointCloud": {"upstream_task": "FusedSegmentationCarving",
                   "level_set_value": 0.2, "background_prior": 1.0,
                   "min_contrast": 1.0, "min_score": 0.01},
    "OrganSegmentation": {"upstream_task": "PointCloud", "eps": 0.3,
                          "min_points": 5},
    "AnglesAndInternodes": {"upstream_task": "OrganSegmentation",
                            "organ_type": "fruit", "min_fruit_size": 2.0,
                            "min_elongation_ratio": 1.0,
                            "characteristic_length": 1.0, "stem_axis": 2,
                            "stem_axis_inverted": False},
    "Clean": ML_CLEAN,
}

#: the separate-task ML route: configs/ml_pipe_virtual.toml's tasks (its
#: evaluation and visualisation tasks left out) on phase 5's scan, with the
#: committed ResUNet named (phase 5 installed TPUSegNet first), phase 5's
#: 0.25 mm grid and batches of 32
SEP_TASKS = ("ModelFilesetExists", "Segmentation2D", "Voxels", "PointCloud",
             "SegmentedPointCloud", "OrganSegmentation")

from plant3dvision_tpu_torch.tools.dryrun_multichip import \
    NORTHSTAR_PLANT  # noqa: E402  (bench_workload's plant)


#: the real-scan front end (phase 9): configs/geom_pipe_real_selfcal.toml's
#: tasks after its TurntableCalibration, on a 60-view scan of phase 4's
#: camera ring with OPENCV k1 lens distortion (about 30 px at the corners)
FRONTEND_TASKS = ("Undistorted", "Masks", "Voxels", "PointCloud",
                  "CurveSkeleton", "RefineSkeleton", "TreeGraph",
                  "AnglesAndInternodes")
FRONTEND_K1 = -0.08
FRONTEND_BBOX = {"x": [-75.0, 75.0], "y": [-75.0, 75.0], "z": [-20.0, 260.0]}
FRONTEND_INCORRECT = (17, 43)
PLANT_RGB, BACKGROUND_RGB, NOISE_SIGMA = (60, 170, 50), (20, 20, 25), 4.0


def frontend_config(voxel_size=0.5, strict=False):
    """geom_pipe_real_selfcal.toml's tasks after TurntableCalibration, whose
    output (colmap_camera and pose_estimation metadata) the scan already
    holds: Undistorted without its upstream_pose (the calibration task),
    Voxels with upstream_colmap = "ImagesFilesetExists" and phase 4's
    bounding box, no TriangleMesh.

    strict=True is phase 9's control: the same front end with strict
    carving (kill_tolerance 0) and undilated masks, and
    geom_pipe_fast.toml's PointCloud, skeleton, tree and angle settings
    (the main path's, for synthetic scans), in place of the ones the config
    tunes for self-calibrated poses of the real_plant fixture."""
    from plant3dvision_tpu_torch.runtime.config import load_toml
    toml = load_toml(ROOT / "configs" / "geom_pipe_real_selfcal.toml")
    cfg = {t: dict(toml[t]) for t in FRONTEND_TASKS}
    cfg["Undistorted"]["upstream_pose"] = ""
    cfg["Voxels"].update(upstream_colmap="ImagesFilesetExists",
                         bounding_box=FRONTEND_BBOX, voxel_size=voxel_size)
    if strict:
        fast = load_toml(ROOT / "configs" / "geom_pipe_fast.toml")
        for t in ("PointCloud", "CurveSkeleton", "RefineSkeleton",
                  "TreeGraph", "AnglesAndInternodes"):
            cfg[t] = dict(fast[t], upstream_task=cfg[t]["upstream_task"])
        cfg["RefineSkeleton"]["upstream_pcd"] = "PointCloud"
        cfg["Voxels"]["kill_tolerance"] = 0
        cfg["Masks"]["dilation"] = 0
    cfg["Clean"] = {"no_confirm": True}
    return cfg


def frontend_angles(scan, report, plant):
    """(angles, internodes, DTW alignment) of a front-end pass against the
    plant's ground truth."""
    import numpy as np
    from plant3dvision_tpu_torch.evaluation import align_sequences
    out = json.loads(scan.get_fileset(report["AnglesAndInternodes"][
        "fileset"]).get_file("AnglesAndInternodes").read_raw())
    dtw = align_sequences(out["angles"], out["internodes"],
                          np.degrees(plant.gt_angles).tolist(),
                          np.asarray(plant.gt_internodes, float).tolist())
    return np.asarray(out["angles"], float), out["internodes"], dtw


def write_distorted_scan(db, scan_id, plant, n_views, width, height, f,
                         k1=FRONTEND_K1, incorrect=FRONTEND_INCORRECT, seed=0,
                         render_step=0.5, rig=False):
    """A turntable scan of RGB photos through a lens with OPENCV radial
    distortion k1, as TurntableCalibration leaves it: per image
    'colmap_camera' (OPENCV [fx, fy, cx, cy, k1, 0, 0, 0], rotmat, tvec)
    and 'pose_estimation' ("incorrect" for the views in `incorrect`).
    Phase 11 produces that metadata with the calibration itself
    (write_turntable_scan, then TurntableCalibration); this scan holds the
    true cameras, for phases 9-10. rig=True writes the scan as a rig logs
    it, for Colmap (phase 18): per image only the CNC 'pose' [X, Y, Z,
    pan, tilt] (`selfcal_poses`, float32), no camera.

    Each view renders the plant's silhouette through the pinhole camera
    (synth.render_mask), and each distorted pixel samples it (bilinearly) at
    its undistorted position, found by fixed-point iteration in float64;
    the plant is coloured PLANT_RGB over BACKGROUND_RGB with seeded noise.
    Phase 4's camera ring (distance 450, height 120, target (0, 0, 70))."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.synth import render_mask, turntable_cameras

    rng = np.random.default_rng(seed)
    cams = turntable_cameras(n_views, dist=450.0, z=120.0,
                             target=(0, 0, 70.0), f=f, width=width,
                             height=height)
    K = cams[0][0]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    xd, yd = (u - cx) / fx, (v - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(10):                 # x + x*k1*r2 = xd
        r2 = x * x + y * y
        x, y = xd - x * k1 * r2, yd - y * k1 * r2
    su, sv = x * fx + cx, y * fy + cy   # where each photo pixel looks
    x0 = np.clip(np.floor(su), 0, width - 2).astype(np.int64)
    y0 = np.clip(np.floor(sv), 0, height - 2).astype(np.int64)
    wx, wy = np.clip(su - x0, 0, 1), np.clip(sv - y0, 0, 1)
    inside = (su >= 0) & (su <= width - 1) & (sv >= 0) & (sv <= height - 1)
    plant_rgb = np.asarray(PLANT_RGB, np.float64)
    bg_rgb = np.asarray(BACKGROUND_RGB, np.float64)

    scan = db.get_scan(scan_id, create=True)
    images = scan.get_fileset("images", create=True)
    poses = selfcal_poses(n_views)

    def photo(view):
        Kv, R, t = cams[view]
        a = render_mask(plant, Kv, R, t, width, height,
                        step=render_step).astype(np.float64) / 255.0
        alpha = ((a[y0, x0] * (1 - wx) + a[y0, x0 + 1] * wx) * (1 - wy)
                 + (a[y0 + 1, x0] * (1 - wx) + a[y0 + 1, x0 + 1] * wx) * wy)
        return np.where(inside, alpha, 0.0)

    def write(view, alpha, noise):
        Kv, R, t = cams[view]
        img = bg_rgb + alpha[..., None] * (plant_rgb - bg_rgb) + noise
        fimg = images.create_file(f"{view:05d}_rgb")
        io.write_image(fimg, np.clip(np.rint(img), 0, 255).astype(np.uint8),
                       "png")
        if rig:
            fimg.set_metadata({"shot_id": f"{view:06d}", "channel": "rgb",
                               "pose": poses[view].tolist()})
            return
        fimg.set_metadata({
            "shot_id": f"{view:06d}", "channel": "rgb",
            "colmap_camera": {
                "camera_model": {"model": "OPENCV",
                                 "params": [fx, fy, cx, cy, k1, 0.0, 0.0,
                                            0.0],
                                 "width": width, "height": height},
                "rotmat": np.asarray(R).tolist(),
                "tvec": np.asarray(t).tolist()},
            "pose_estimation": ("incorrect" if view in incorrect
                                else "correct")})

    with scan.deferred_store(), ThreadPoolExecutor(8) as ex:
        alphas = ex.map(photo, range(n_views))
        noise = (rng.normal(0.0, NOISE_SIGMA, (height, width, 3))
                 for _ in range(n_views))
        list(ex.map(write, range(n_views), alphas, noise))
    return scan


#: phase 11's turntable: the true calibration theta* and per-view CNC jitter
#: (degrees, sigma) of the rig, which the scan's metadata does not hold. No
#: tangential mount error (dpan, mx): with 1.5 deg and 5 mm the JAX
#: package's CEM leaves this 3-4 mm thin plant in the wrong roll quadrant
#: (tools/selfcal_reference.py --mount-errors; PERF.md, Findings)
SELFCAL_THETA = {"f": 1300.0, "dpan": 0.0, "dtilt": 0.8, "roll": -1.0,
                 "mx": 0.0, "my": -4.0}
SELFCAL_JITTER = (0.15, 0.10)
#: the JAX package's result on phase 11's scan (tools/selfcal_reference.py,
#: on the CPU): the focal length, coherence and median reprojection of the
#: plant's surface against the true cameras (px) that the port's
#: calibration must repeat, and its angles' DTW mean error (deg), printed
#: beside the port's
SELFCAL_REFERENCE = {"f": 1292.1177978515625, "coherence": 0.8115234375,
                     "reprojection_median_px": 8.345052886135498,
                     "mean_angle_error_deg": 11.304077853984955}
#: a magenta backdrop: its green channel (20) stays under the Masks task's
#: linear threshold (0.15 x 255) and its excess green (-0.82) far under the
#: calibration's 0.1, so both tasks' masks hold the plant alone; its gray
#: level (the channels' mean, 113.3) is the feature BA's background
SELFCAL_BACKGROUND, SELFCAL_NOISE = (160, 20, 160), 3.0


def selfcal_poses(n_views, dist=450.0, z=120.0, target_z=70.0):
    """(V, 5) CNC poses [X, Y, Z, pan_deg, tilt_deg] of phase 9's camera
    ring: the camera at distance `dist` and height `z`, pan tracking the
    orbit (looking at the turntable axis), the tilt aimed at `target_z`."""
    import numpy as np
    ang = 360.0 * np.arange(n_views) / n_views
    tilt = np.degrees(np.arctan2(target_z - z, dist))
    return np.stack([dist * np.cos(np.radians(ang)),
                     dist * np.sin(np.radians(ang)), np.full(n_views, z),
                     ang + 90.0, np.full(n_views, round(tilt, 1))],
                    1).astype(np.float32)


def textured_surface(plant, density, texture_mm, rng):
    """(points (N, 3), albedo (N,)) on the surface of the plant's capsules:
    uniform samples at `density` per mm^2, the albedo a random value in
    [0.3, 1] per cell of a `texture_mm` lattice (piecewise constant: patches
    with sharp corners), a texture fixed on the surface, so corners are the
    same in every view."""
    import numpy as np
    pts = []
    for a, b, r in plant.capsules:
        ax = b - a
        L = float(np.linalg.norm(ax))
        z = ax / L
        x = np.cross(z, [0.0, 0.0, 1.0])
        if np.linalg.norm(x) < 1e-6:
            x = np.cross(z, [0.0, 1.0, 0.0])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        n_side = int(density * 2 * np.pi * r * L)
        n_cap = int(density * 4 * np.pi * r * r)
        t = rng.uniform(0.0, L, n_side)[:, None]
        th = rng.uniform(0.0, 2 * np.pi, n_side)[:, None]
        pts.append(a + t * z + r * (np.cos(th) * x + np.sin(th) * y))
        s = rng.standard_normal((n_cap, 3))
        s = r * s / np.linalg.norm(s, axis=1, keepdims=True)
        pts.append(np.where((s @ z)[:, None] < 0, a, b) + s)
    pts = np.concatenate(pts)
    lo = pts.min(0) - texture_mm
    shape = np.ceil((pts.max(0) - lo) / texture_mm).astype(int) + 2
    lattice = rng.uniform(0.3, 1.0, shape)
    i0 = np.floor((pts - lo) / texture_mm).astype(int)
    return pts, lattice[i0[:, 0], i0[:, 1], i0[:, 2]]


def render_textured(pts, albedo, cam, width, height, rng):
    """RGB uint8 photo of textured surface points through a packed camera
    (16,): far to near, each point splatted on the 2x2 pixels around it
    (the last write wins), the plant's colour times the albedo over the
    background, with seeded noise."""
    import numpy as np
    R, t = cam[4:13].reshape(3, 3), cam[13:16]
    q = pts @ R.T + t
    ok = q[:, 2] > 1e-6
    q, alb = q[ok], albedo[ok]
    px = q[:, 0] / q[:, 2] * cam[0] + cam[2]
    py = q[:, 1] / q[:, 2] * cam[1] + cam[3]
    order = np.argsort(-q[:, 2], kind="stable")
    px, py, alb = px[order], py[order], alb[order]
    x0 = np.floor(px - 0.5).astype(np.int64)
    y0 = np.floor(py - 0.5).astype(np.int64)
    img = np.empty((height * width, 3), np.float32)
    img[:] = SELFCAL_BACKGROUND
    col = alb[:, None] * np.asarray(PLANT_RGB, np.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            xx, yy = x0 + dx, y0 + dy
            m = (xx >= 0) & (xx < width) & (yy >= 0) & (yy < height)
            img[(yy * width + xx)[m]] = col[m]
    img = img.reshape(height, width, 3) + rng.normal(
        0.0, SELFCAL_NOISE, (height, width, 3))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def write_turntable_scan(db, scan_id, plant, n_views, width, height,
                         density=30.0, texture_mm=2.0, **ring):
    """A turntable scan as a rig with CNC poses writes it, for
    TurntableCalibration: RGB photos of the textured plant
    (`textured_surface`, `render_textured`) and per image its
    'approximate_pose' [X, Y, Z, pan_deg, tilt_deg] (`selfcal_poses`; the
    degree dialect); the images fileset's 'workspace' (FRONTEND_BBOX).
    The true cameras are cnc_to_cameras(poses + per-view jitter
    SELFCAL_JITTER, theta* SELFCAL_THETA with f scaled to `width`); the
    metadata holds neither. Seeded. Returns (true cameras (V, 16), the
    surface points)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.ops.selfcal import THETA_NAMES, cnc_to_cameras

    rng = np.random.default_rng(0)
    theta = dict(SELFCAL_THETA, f=SELFCAL_THETA["f"] * width / 1440.0)
    th = np.array([theta.get(n, 0.0) for n in THETA_NAMES], np.float32)
    poses = selfcal_poses(n_views, **ring)
    true = poses.copy()
    true[:, 3] += rng.normal(0.0, SELFCAL_JITTER[0], n_views)
    true[:, 4] += rng.normal(0.0, SELFCAL_JITTER[1], n_views)
    cams = cnc_to_cameras(true, th, float(width), float(height)).numpy()
    pts, alb = textured_surface(plant, density, texture_mm,
                                np.random.default_rng(0))

    scan = db.get_scan(scan_id, create=True)
    images = scan.get_fileset("images", create=True)
    images.set_metadata("workspace", FRONTEND_BBOX)
    seeds = rng.integers(0, 2 ** 32, n_views)

    def write(view):
        img = render_textured(pts, alb, cams[view], width, height,
                              np.random.default_rng(seeds[view]))
        f = images.create_file(f"{view:05d}_rgb")
        io.write_image(f, img, "png")
        f.set_metadata({"shot_id": f"{view:06d}", "channel": "rgb",
                        "approximate_pose": poses[view].tolist()})

    with scan.deferred_store(), ThreadPoolExecutor(8) as ex:
        list(ex.map(write, range(n_views)))
    return cams, pts


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=7, warmup=2):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cold_turns(make, n_bytes):
    """A call that runs make()'s calls in turn, as many as it takes for
    their inputs (`n_bytes` each) to pass twice the card's L2 between two
    runs of one, so each finds its inputs in HBM, not in the L2."""
    fns = [make() for _ in range(-(-2 * L2_BYTES // n_bytes))]
    turn = [0]

    def call():
        fns[turn[0] % len(fns)]()
        turn[0] += 1
    return call


def device_ms(fn, reps=10, tries=3):
    """Mean device milliseconds of fn() (its kernels' time on the card,
    torch.profiler), after one warm-up call; None ("not measured") when
    `tries` profiler sessions in a row record no device time (seen once in
    a long run of this script)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages())
        if total > 0:
            return total / reps / 1e3
    return None


def device_ms_by_kernel(fn, reps=10, tries=6, need=None, recorded=None):
    """Mean device milliseconds of one launch of each kernel of fn(), by
    name (torch.profiler), after one warm-up call: a kernel's device time
    over `reps` calls divided by the launches of it the profiler recorded,
    so a kernel launched once a call reads its call's time; those counts
    go into the dict `recorded`, where given. The profiler records only
    some launches in some sessions (3 of 10 of K6's), and the durations it
    keeps there can be wrong (one K6 read half its bound), so a session
    counts only when it recorded every kernel a whole number of times a
    call (a multiple of `reps`), and one with a kernel whose name holds
    `need` where given. None ("not measured") when `tries` sessions in a
    row do not."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        if not ev or any(e.count % reps for e in ev):
            continue
        out = {e.key[:80]: e.self_device_time_total / e.count / 1e3
               for e in ev}
        if need is None or any(need in k for k in out):
            if recorded is not None:
                recorded.update({e.key[:80]: e.count for e in ev})
            return out
    return None


def queued_ms(fn, n=20):
    """Milliseconds a call of fn() over n calls queued back to back
    between two CUDA events, after one warm-up call: a call's device time,
    gaps between its launches included, where the host enqueues a call
    faster than the card runs it."""
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def host_syncs(fn):
    """fn()'s result and the synchronizing CUDA operations it made, as
    torch.cuda's sync debug mode reports them."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(str(w.message).startswith(
        "called a synchronizing CUDA operation") for w in caught)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_db(path):
    from plant3dvision_tpu_torch.fsdb import FSDB
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    (path / "romidb").touch()
    db = FSDB(path)
    db.connect(unsafe=True)
    return db


def grid_of(bbox, vs):
    import numpy as np
    shape = tuple(int((bbox[a][1] - bbox[a][0]) / vs) + 1 for a in "xyz")
    return np.array([bbox["x"][0], bbox["y"][0], bbox["z"][0]]), shape


def run_main_path(db, device_name):
    """Phase 2: the north-star scan through the port's runtime."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.runtime.config import load_toml
    from plant3dvision_tpu_torch.synth import SyntheticPlant, generate_scan

    plant = SyntheticPlant(**NORTHSTAR_PLANT)
    t0 = time.perf_counter()
    generate_scan(db, "northstar", n_views=300, width=1440, height=1080,
                  f=1400.0, plant=plant, render_step=0.5)
    gen_s = time.perf_counter() - t0
    cfg = load_toml(ROOT / "configs" / "geom_pipe_fast.toml")
    cfg["Clean"] = {"no_confirm": True}

    ctx = RunContext(db, "northstar", cfg, device="cuda")
    t0 = time.perf_counter()
    run_task(ctx, "AnglesAndInternodes", report=False)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    warm, report, launches = [], None, None
    for _ in range(1):
        run_task(ctx, "Clean", report=False)
        ctx = RunContext(db, "northstar", cfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        report, wall, ctx, prof = warm_pass(ctx)
        warm.append(wall)
        launches = dict(kernels.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6

    fs = ctx.scan.get_fileset(report["AnglesAndInternodes"]["fileset"])
    out = json.loads(fs.get_file("AnglesAndInternodes").read_raw())
    angles = np.asarray(out["angles"], float)
    gt = np.degrees(plant.gt_angles)
    n = min(len(angles), len(gt))
    err = float(np.abs(angles[:n] - gt[:n]).mean()) if n else float("nan")
    emit({"main_path": {
        "device": device_name, "n_views": 300, "image": [1440, 1080],
        "voxel_mm": 1.0, "scan_generation_s": gen_s, "cold_s": cold_s,
        "warm_s": warm,
        "task_s": {k: v["seconds"] for k, v in report.items()},
        "n_angles": int(len(angles)), "mean_angle_error_deg": err,
        "max_memory_allocated_mb": peak_mb,
        "launches_per_warm_pass": launches}})
    if prof is not None:
        emit({"main_path_profile": prof})
    missing = [k for k in ("carve", "signed_distance", "gradient_gaussian",
                           "band_compact") if launches[k] <= 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    assert len(angles) > 10, f"only {len(angles)} angles"
    assert err < 1.0, f"mean angle error {err} deg"
    vfile = ctx.scan.get_fileset(
        report["FusedCarving"]["fileset"]).get_files()[0]
    return ctx.scan, vfile, launches


def warm_pass(ctx):
    """The warm pass (AnglesAndInternodes in `ctx`, after Clean), not
    profiled: (its task report, its wall seconds (the phase's warm_s), the
    context to read its outputs from, the profile or None). With
    `--profile` a second pass follows, after Clean, under torch.profiler
    (`profile_pass`): the context returned is that pass's (the same
    filesets), the launch counts stay the first pass's (the peak memory
    covers both), and the profile gains the profiler's cost, its wall
    seconds less the first pass's."""
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.runtime import RunContext, run_task

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = run_task(ctx, "AnglesAndInternodes", report=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not PROFILE:
        return report, wall, ctx, None
    launches = dict(kernels.LAUNCHES)
    run_task(ctx, "Clean", report=False)
    ctx = RunContext(ctx.db, ctx.scan.id, ctx.config, device=ctx.device)
    _, prof = profile_pass(ctx)
    kernels.LAUNCHES.clear()
    kernels.LAUNCHES.update(launches)
    prof["unprofiled_wall_s"] = wall
    prof["profiler_cost_s"] = prof["wall_s"] - wall
    return report, wall, ctx, prof


def idle_share(prof):
    """[the profile's device idle share], or [] without --profile."""
    return [] if prof is None else [prof["device_idle_share"]]


def profile_pass(ctx):
    """A warm pass (AnglesAndInternodes in `ctx`) under torch.profiler,
    device activity only: (its task report, the card's busy time (sum of
    the device time of its kernels and copies; one stream, so nothing
    overlaps; the stage ranges' device spans left out) against the pass's
    wall time, the top device entries and the tasks' stage seconds). Host
    tracing is left off: it slowed a calibrated pass's host code and took
    minutes to summarise, and nothing here reads it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from plant3dvision_tpu_torch.runtime import run_task

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = run_task(ctx, "AnglesAndInternodes", report=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sorted(((e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda r: -r[1])
    busy = sum(r[1] for r in dev) / 1e6
    out = {"wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1.0 - busy / wall,
           "top_device": [{"name": k[:80], "s": t / 1e6, "calls": c}
                          for k, t, c in dev[:10]]}
    stages = {k: v["stages"] for k, v in report.items() if "stages" in v}
    if stages:      # synchronised at each stage's end (runtime stage)
        out["stages"] = stages
    return report, out


def load_group(scan, n_views):
    """The first `n_views` images of the scan as FusedCarving packs them."""
    import numpy as np
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.ops.carving import (camera_from_metadata,
                                                     pack_masks)
    from plant3dvision_tpu_torch.ops.masks import compute_mask_numpy
    files = scan.get_fileset("images").get_files()[:n_views]
    rows, cams, hw = [], [], None
    for f in files:
        m = compute_mask_numpy(io.read_image(f), coefs=(1.0, 0.0, 0.0),
                               threshold=0.3, as_bool=True)
        hw = m.shape
        rows.append(pack_masks(m))
        cams.append(camera_from_metadata(f.get_metadata("camera")))
    return np.stack(rows), np.stack(cams), hw


def kernel_row(name, launches, err, ms, plain, nbytes, nops, library=None,
               extra=None, kernel_ms=...):
    """One entry of the `kernels` line (bound from the bytes and operations
    of this run's inputs); `kernel_ms` the kernel's device time as the
    profiler gave it (None: not measured) where the row profiles, else the
    call's time."""
    b, by = bound_ms(nbytes, nops)
    src, rep = KERNEL_INFO[name]
    r = {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches, "max_abs_err": err, "match": True,
         "ms": ms, "kernel_ms": ms if kernel_ms is ... else kernel_ms,
         "plain_ms": plain, "bound_ms": b, "bound_by": by,
         "library_ms": library}
    r.update(extra or {})
    return r


def library_dilation(binm, r):
    """One PyTorch call for K8's function: `conv2d` of the (N, H, W) bool
    stack with the disk's footprint, `> 0` (sums of at most a few thousand
    ones: exact in TF32 too)."""
    import torch
    import torch.nn.functional as F
    from plant3dvision_tpu_torch.ops import masks as masks_ops
    offs = masks_ops._disk_offsets(r)
    fp = torch.zeros((1, 1, 2 * r + 1, 2 * r + 1), device=binm.device)
    fp[0, 0, offs[:, 0] + r, offs[:, 1] + r] = 1.0
    return F.conv2d(binm[:, None].float(), fp, padding=r)[:, 0] > 0


def library_smoothed_gradient(x, taps):
    """One PyTorch chain for K3's function: torch.gradient, then per axis
    a symmetric pad and one grouped conv3d over the three gradients
    (call with cuDNN's TF32 off)."""
    import torch
    import torch.nn.functional as F
    from plant3dvision_tpu_torch.ops import filters
    w = torch.from_numpy(taps).to(x.device)
    r = len(taps) // 2
    g = torch.stack(torch.gradient(x))[None]          # (1, 3, nx, ny, nz)
    for axis in range(3):
        idx = filters._symmetric_index(x.shape[axis], r, x.device)
        g = g.index_select(2 + axis, idx)
        kshape = [1, 1, 1]
        kshape[axis] = len(taps)
        g = F.conv3d(g, w.reshape(kshape).expand(3, 1, *kshape), groups=3)
    return g


def dilation_row(binm, r, launches, extra):
    """K8 (`binary_dilation`) on a bool (N, H, W) mask stack at radius r:
    held equal to its plain version and to one PyTorch call for the same
    function (`conv2d` with the disk, `> 0`), timed beside both; the bound
    is the masks read and written once."""
    import torch
    from plant3dvision_tpu_torch.ops import masks as masks_ops

    got = masks_ops.binary_dilation(binm, r)
    want = masks_ops.binary_dilation_plain(binm, r)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"dilate kernel != plain (radius {r})"
    assert torch.equal(library_dilation(binm, r), got), \
        f"conv2d footprint != K8 (r {r})"
    return kernel_row(
        "dilate_disk", launches, 0.0,
        cuda_ms(lambda: masks_ops.binary_dilation(binm, r)),
        cuda_ms(lambda: masks_ops.binary_dilation_plain(binm, r), reps=3,
                warmup=1),
        2 * binm.numel(), 0,
        library=cuda_ms(lambda: library_dilation(binm, r), reps=3, warmup=1),
        extra={"radius": r, "shape": list(binm.shape),
               "offsets": len(masks_ops._disk_offsets(r)),
               "true_in": int(binm.sum()), "true_out": int(got.sum()),
               **extra})


def check_kernels(scan, vfile, launches):
    """Phase 3: every kernel against its plain version at main-path shapes."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.ops import carving

    dev = torch.device("cuda")

    # K1: one 100-view group of the north-star scan
    packed, cams, hw = load_group(scan, 100)
    origin, shape = grid_of(scan.get_metadata("bounding_box"), 1.0)
    pk = torch.from_numpy(packed).to(dev)
    cm = torch.from_numpy(cams).to(dev)
    va = torch.ones(len(cams), dtype=torch.bool, device=dev)
    args = (pk, cm, va, origin, 1.0, shape, hw)
    k1 = carving.carve(*args)
    p1, tests, mask_bytes = carving.carve_plain(*args, count_work=True)
    torch.cuda.synchronize()
    err = int((k1.to(torch.int16) - p1.to(torch.int16)).abs().max())
    assert err == 0, f"carve kernel != plain ({int((k1 != p1).sum())} voxels)"
    nvox = int(np.prod(shape))
    # the bound: 24 operations a test of the least work that any view
    # order needs (carve_least_work), the distinct mask bytes those tests
    # read, the cameras and flags, the int8 grid written once
    least, least_bytes = carving.carve_least_work(p1, *args)
    rows = [kernel_row(
        "carve", launches["carve"], err,
        cuda_ms(lambda: carving.carve(*args)),
        cuda_ms(lambda: carving.carve_plain(*args), reps=5, warmup=1),
        least_bytes + cm.numel() * 4 + va.numel() + nvox, 24 * least,
        kernel_ms=device_ms(lambda: carving.carve(*args)),
        extra={"path": "geometric", "shape": list(shape), "views": len(cams),
               "voxel_view_tests": tests, "mask_bytes_read": mask_bytes,
               "least_voxel_view_tests": least,
               "least_mask_bytes": least_bytes,
               "mask_bytes_held": pk.numel()})]

    # K2-K4 on the scan's carved grid (the FusedCarving volume)
    vol = torch.from_numpy(io.read_volume(vfile).astype(np.float32)).to(dev)
    rows += check_vol2pcd_kernels(vol, 0.0, launches, "geometric")
    emit({"kernel_checks": {"grid": list(vol.shape),
                            "group_views": len(cams)}})
    return rows


def check_vol2pcd_kernels(vol, level, launches, path):
    """K2-K4 on one vol2pcd input (a float32 volume on the card, at the
    cap and band that vol2pcd gives them), against their plain versions;
    one kernel row each, with the launches counted on `path`."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels, proc3d
    from plant3dvision_tpu_torch.ops import edt, filters

    dev = vol.device
    rows = []

    def row(name, *args, extra=None, **kw):
        rows.append(kernel_row(name, launches[name], *args, **kw,
                               extra={"path": path, "shape": list(vol.shape),
                                      **(extra or {})}))

    n = vol.numel()
    cap = int(min(16 + level + 4, max(vol.shape)))     # as vol2pcd sets it
    before = kernels.LAUNCHES["signed_distance"]
    sd = edt.signed_distance(vol, cap)
    per_call = kernels.LAUNCHES["signed_distance"] - before
    sd_p = edt.signed_distance_plain(vol, cap)
    torch.cuda.synchronize()
    err = float((sd - sd_p).abs().max())
    assert torch.equal(sd, sd_p), \
        f"signed distance kernel != plain (max {err}, {path})"
    assert torch.equal(edt.squared_edt(vol > 0.5, cap),
                       edt.squared_edt_plain(vol > 0.5, cap)), \
        f"squared EDT kernel != plain ({path})"
    del sd_p
    extra = {"cap": cap, "launches_a_call": per_call,
             "lane": "16-bit" if edt.lane16(edt.axis_caps(vol.shape, cap))
             else "32-bit"}
    if path == "ml":
        # the 32-bit lane: cap None on the ML grid, bit for bit
        wide = edt.signed_distance(vol, None)
        wide_p = edt.signed_distance_plain(vol, None)
        torch.cuda.synchronize()
        assert not edt.lane16(edt.axis_caps(vol.shape, None))
        assert torch.equal(wide, wide_p), \
            "signed distance kernel != plain in the 32-bit lane (cap None)"
        del wide, wide_p
        extra["lane32_cap_none"] = {
            "bit_equal": True,
            "ms": cuda_ms(lambda: edt.signed_distance(vol, None), reps=3,
                          warmup=1),
            "plain_ms": cuda_ms(lambda: edt.signed_distance_plain(vol, None),
                                reps=3, warmup=1)}
    reads = [sum(2 * (vol.shape[a] - s) * (n // vol.shape[a])
                 for s in range(1, min(cap, vol.shape[a] - 1) + 1))
             for a in range(3)]
    # the x pass of a binary input needs O(1) a voxel, not its 2c + 1
    # candidates: the bound of the y and z passes' candidates alone
    extra["bound_ms_yz"] = bound_ms(8 * n, 2 * 2 * sum(reads[1:]))[0]
    reads = sum(reads)
    row("signed_distance", err,
        cuda_ms(lambda: edt.signed_distance(vol, cap)),
        cuda_ms(lambda: edt.signed_distance_plain(vol, cap), reps=5,
                warmup=1),
        8 * n, 2 * 2 * reads, extra=extra)

    def k3_plain(x):
        return [filters.gaussian_filter_plain(g, 1.0)
                for g in filters.gradient_plain(x)]

    # K3 as vol2pcd calls it: the fused smoothed_gradient, bit for bit
    taps = filters.gaussian_kernel1d(1.0).astype(np.float32)
    before = kernels.LAUNCHES["gradient_gaussian"]
    gk = filters.smoothed_gradient(sd, 1.0)
    per_call = kernels.LAUNCHES["gradient_gaussian"] - before
    gp = k3_plain(sd)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
    assert all(torch.equal(a, b) for a, b in zip(gk, gp)), \
        f"smoothed gradient kernel != plain: max {err} ({path})"
    del gp
    # the standalone per-axis kernels (one launch an axis), bit for bit
    for a, b in zip(filters.gradient(sd), filters.gradient_plain(sd)):
        assert torch.equal(a, b), f"gradient kernel != plain ({path})"
        assert torch.equal(filters.gaussian_filter(a, 1.0),
                           filters.gaussian_filter_plain(b, 1.0)), \
            f"gaussian_filter kernel != plain ({path})"

    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    lib3 = cuda_ms(lambda: library_smoothed_gradient(sd, taps))
    torch.backends.cudnn.allow_tf32 = prev_tf32
    row("gradient_gaussian", err,
        cuda_ms(lambda: filters.smoothed_gradient(sd, 1.0)),
        cuda_ms(lambda: k3_plain(sd), reps=5, warmup=1),
        16 * n, (6 + 3 * 3 * 18) * n, library=lib3,
        extra={"launches_per_call": per_call})

    gx, gy, gz = gk
    ik, dk, vk = proc3d.band_compact(sd, gx, gy, gz, level)
    ip, dp, vp = proc3d.band_compact_plain(sd, gx, gy, gz, level)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip), f"band index set differs from plain ({path})"
    err = max(float((dk - dp).abs().max()), float((vk - vp).abs().max()))
    assert err == 0.0, f"band records differ from plain: {err} ({path})"
    lo, hi = proc3d.band_limits(level)

    def k4_library():
        flat = sd.reshape(-1)
        idx = torch.nonzero((flat > float(lo)) & (flat <= float(hi)))
        idx = idx.reshape(-1)
        return [t.reshape(-1).index_select(0, idx) for t in (sd, gx, gy, gz)]

    # a call's launches and host reads; its floor: as many empty launches
    # and one 8-byte read from the card
    before = kernels.LAUNCHES["band_compact"]
    _, syncs = host_syncs(lambda: proc3d.band_compact(sd, gx, gy, gz, level))
    per_call = kernels.LAUNCHES["band_compact"] - before
    so, stream = kernels.lib(), kernels.stream_ptr(dev)
    word = torch.zeros(1, dtype=torch.int64, device=dev)

    def floor():
        kernels.check("band_compact", so.p3d_band_empty(per_call, stream))
        return int(word[0])

    row("band_compact", err,
        cuda_ms(lambda: proc3d.band_compact(sd, gx, gy, gz, level)),
        cuda_ms(lambda: proc3d.band_compact_plain(sd, gx, gy, gz, level)),
        4 * n + 36 * len(ik), 2 * n, library=cuda_ms(k4_library),
        extra={"n_band": int(len(ik)), "launches_a_call": per_call,
               "host_syncs_a_call": syncs, "floor_ms": cuda_ms(floor)})
    return rows


_WORKLOAD = []


def real_grid_workload():
    """bench.py's workload (tools/dryrun_multichip.bench_workload),
    rendered once a run (phases 4 and 25)."""
    from plant3dvision_tpu_torch.tools.dryrun_multichip import bench_workload
    if not _WORKLOAD:
        _WORKLOAD.append(bench_workload())
    return _WORKLOAD[0]


def run_real_grid():
    """Phase 4: the 60-view 0.5 mm carve (held against its plain version)
    + vol2pcd (301x301x561 voxels)."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels, proc3d
    from plant3dvision_tpu_torch.ops.carving import (carve,
                                                     carve_least_work,
                                                     carve_plain)

    t0 = time.perf_counter()
    rows, cams, origin, vs, shape, (H, W) = real_grid_workload()
    V = len(rows)
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    pk = torch.from_numpy(rows).to(dev)
    cm = torch.from_numpy(cams).to(dev)
    va = torch.ones(V, dtype=torch.bool, device=dev)
    args = (pk, cm, va, origin, vs, shape, (H, W))
    carve_ms = cuda_ms(lambda: carve(*args), reps=5, warmup=1)
    kernel_ms = device_ms(lambda: carve(*args), reps=5)
    before = kernels.LAUNCHES["carve"]
    vol = carve(*args)
    launches = kernels.LAUNCHES["carve"] - before
    plain, tests, mask_bytes = carve_plain(*args, count_work=True)
    assert torch.equal(vol, plain), "real-grid carve != plain"
    # the bound as phase 3's K1 row: 24 operations a test of the least
    # work, the mask bytes those tests read, cameras, flags, the grid
    least, least_bytes = carve_least_work(plain, *args)
    b, by = bound_ms(least_bytes + cm.numel() * 4 + V + int(np.prod(shape)),
                     24 * least)
    del plain
    t0 = time.perf_counter()
    pcd = proc3d.vol2pcd(vol, origin, vs, 0.0)
    torch.cuda.synchronize()
    pcd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcd = proc3d.vol2pcd(vol, origin, vs, 0.0)
    torch.cuda.synchronize()
    pcd_warm_s = time.perf_counter() - t0
    nvox = int(np.prod(shape))
    alive = int((vol == 1).sum())
    assert alive > 1000 and len(pcd) > 1000, (alive, len(pcd))
    assert np.isfinite(pcd.points).all() and np.isfinite(pcd.normals).all()
    emit({"real_grid": {
        "views": V, "image": [W, H], "shape": list(shape), "voxel_mm": vs,
        "workload_build_s": build_s, "carve_ms": carve_ms,
        "kernel_ms": kernel_ms, "launches": launches, "bound_ms": b,
        "bound_by": by, "bit_equal": True, "mask_bytes_read": mask_bytes,
        "grid_view_pairs_per_s": V * nvox / (carve_ms / 1e3),
        "voxel_view_tests": tests,
        "voxel_view_tests_per_s": tests / (carve_ms / 1e3),
        "least_voxel_view_tests": least, "least_mask_bytes": least_bytes,
        "alive_voxels": alive, "vol2pcd_first_s": pcd_s,
        "vol2pcd_s": pcd_warm_s, "n_points": len(pcd)}})


def run_ml_path(db, device_name):
    """Phase 5: the ML path (bench_e2e.py:run_ml_northstar at 0.25 mm)
    through the port's runtime, with the committed TPUSegNet."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.evaluation import align_sequences
    from plant3dvision_tpu_torch.models.zoo import (TPUSEGNET_CHECKPOINT,
                                                    install_checkpoint)
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.synth_photo import (ProceduralArabidopsis,
                                                     generate_photo_scan)

    plant = ProceduralArabidopsis(seed=1)
    t0 = time.perf_counter()
    generate_photo_scan(db, "ml_northstar", n_views=ML_VIEWS, width=ML_SIZE,
                        height=ML_SIZE, plant=plant, gt_fileset=ML_GT_FILESET)
    gen_s = time.perf_counter() - t0
    assert install_checkpoint(db, path=TPUSEGNET_CHECKPOINT,
                              model_id="tpusegnet_seg") is not None

    ctx = RunContext(db, "ml_northstar", ML_CONFIG, device="cuda")
    t0 = time.perf_counter()
    run_task(ctx, "AnglesAndInternodes", report=False)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    warm = []
    run_task(ctx, "Clean", report=False)
    ctx = RunContext(db, "ml_northstar", ML_CONFIG, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    report, wall, ctx, prof = warm_pass(ctx)
    warm.append(wall)
    launches = dict(kernels.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    scan = ctx.scan
    fs = scan.get_fileset(report["AnglesAndInternodes"]["fileset"])
    out = json.loads(fs.get_file("AnglesAndInternodes").read_raw())
    labels = scan.get_fileset(report["PointCloud"]["fileset"]).get_files()[
        0].get_metadata("labels")
    organs = [f.id for f in scan.get_fileset(
        report["OrganSegmentation"]["fileset"]).get_files()]
    angles = np.asarray(out["angles"], float)
    dtw = align_sequences(angles.tolist(), out["internodes"],
                          np.degrees(plant.gt_angles).tolist(),
                          np.asarray(plant.gt_internodes, float).tolist())
    err = dtw["mean_angle_error"]
    ml = {"device": device_name, "n_views": ML_VIEWS,
          "image": [ML_SIZE, ML_SIZE], "voxel_mm": ML_VOXEL,
          "batch": ML_BATCH, "scan_generation_s": gen_s, "cold_s": cold_s,
          "warm_s": warm,
          "task_s": {k: v["seconds"] for k, v in report.items()},
          "n_points": {l: labels.count(l) for l in sorted(set(labels))},
          "n_organs": {l: sum(o.startswith(l + "_") for o in organs)
                       for l in ("fruit", "stem", "leaf", "pedicel")},
          "n_angles": int(len(angles)), "n_gt": int(len(plant.gt_angles)),
          "dtw_normalized_cost": dtw["normalized_cost"],
          "mean_angle_error_deg": err,
          "max_memory_allocated_mb": peak_mb,
          "launches_per_warm_pass": launches}
    emit({"ml_path": ml})
    if prof is not None:
        emit({"ml_path_profile": prof})
    # the label volumes of the profiled pass (the same as the warm pass's)
    vfile = scan.get_fileset(
        report["FusedSegmentationCarving"]["fileset"]).get_files()[0]
    need = ("signed_distance", "gradient_gaussian", "band_compact",
            "accumulate_labels", "multiclass_select")
    missing = [k for k in need if launches[k] <= 0]
    assert not missing, f"kernels not launched on the ML path: {missing}"
    assert len(angles) >= 10, f"only {len(angles)} angles"
    assert err is not None and err < 20.0, f"mean angle error {err} deg"
    nums = [cold_s, *warm, peak_mb, dtw["normalized_cost"], err,
            *idle_share(prof), *angles, *out["internodes"]]
    assert np.isfinite(nums).all(), "a number of the ML path is not finite"
    return scan, vfile, launches


def _library_accumulate(probs, cams, origin, vs, shape, sample):
    """One PyTorch library chain computing the accumulate's function (plain
    f32 projection, no fused multiply-adds): per view, grid_sample
    (bilinear) or avg_pool2d + nearest grid_sample (box)."""
    import torch
    import torch.nn.functional as F
    B, C, H, W = probs.shape
    dev = probs.device
    ax = [float(origin[a]) + vs * torch.arange(shape[a], dtype=torch.float32,
                                               device=dev) for a in range(3)]
    x = ax[0].view(-1, 1, 1)
    y = ax[1].view(1, -1, 1)
    z = ax[2].view(1, 1, -1)
    img = probs
    if sample == "box":
        img = F.avg_pool2d(F.pad(probs, (1, 0, 1, 0), mode="replicate"), 2,
                           stride=1)
    acc = torch.zeros((C, *shape), device=dev)
    for b in range(B):
        c = cams[b]
        pz = c[10] * x + c[11] * y + c[12] * z + c[15]
        px = (c[4] * x + c[5] * y + c[6] * z + c[13]) / pz * c[0] + c[2]
        py = (c[7] * x + c[8] * y + c[9] * z + c[14]) / pz * c[1] + c[3]
        inside = (pz > 0) & (px > -1) & (px < W) & (py > -1) & (py < H)
        if sample == "box":
            px = px.floor().clamp(0, W - 2)
            py = py.floor().clamp(0, H - 2)
        grid = torch.stack([px / (W - 1) * 2 - 1, py / (H - 1) * 2 - 1],
                           -1).view(1, 1, -1, 2)
        v = F.grid_sample(img[b:b + 1], grid, align_corners=True,
                          mode="nearest" if sample == "box" else "bilinear")
        acc += torch.where(inside, v.view(C, *shape), 0.0)
    return acc


def window_stats(cams, valid, origin, vs, shape, hw, C, box, grid_fma):
    """The tiled accumulate's footprints on one launch's inputs
    (ml_fused.tile_windows, the kernel's rule): tile-views staged, read
    from global memory (a window over the budget, or a corner behind the
    camera) and skipped, the staged windows' pixel percentiles, and the
    in-frame voxels whose taps fell outside their staged window."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch.ops import ml_fused
    counts = np.zeros(3, np.int64)
    pix, outside = [], 0
    for b in range(len(cams)):
        if not bool(valid[b]):
            continue
        st, px, out = ml_fused.tile_windows(cams[b], origin, vs, 0, shape,
                                            hw, C, box, grid_fma=grid_fma)
        counts += np.bincount(st.cpu().numpy(), minlength=3)
        pix.append(px[st == ml_fused.STAGED].cpu())
        outside += out
    pix = torch.cat(pix).double().numpy() if pix else np.zeros(1)
    n = int(counts.sum())
    q = np.percentile(pix, [50, 90, 99, 100]) if pix.size else [0] * 4
    return {"tile": list(ml_fused.TILE), "region_floats": ml_fused.REGION,
            "labels": C, "tile_views": n,
            "staged": int(counts[ml_fused.STAGED]),
            "global": int(counts[ml_fused.GLOBAL]),
            "skipped": int(counts[ml_fused.SKIP]),
            "global_share": float(counts[ml_fused.GLOBAL] / max(n, 1)),
            "window_px_p50_p90_p99_max": [float(v) for v in q],
            "window_floats_max": float(q[-1]) * C,
            "taps_outside_window": int(outside)}


def check_ml_kernels(scan, vfile, launches):
    """Phase 6: K5 on one real batch of the ML scan (every mode; the whole
    grid in one launch, as the pass runs it on the card, and the 3-slab
    lane, which must give the same volume), with the tiles' window
    footprints, K6 on the warm pass's label volumes and K2-K4 on its fruit
    selection, against their plain versions, at the ML path's own
    shapes."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch.fsdb import handoff, io
    from plant3dvision_tpu_torch.models.checkpoint import load_model
    from plant3dvision_tpu_torch.models.unet import forward_probs
    from plant3dvision_tpu_torch.ops import ml_fused
    from plant3dvision_tpu_torch.ops.carving import (_avg_chunk_voxels,
                                                     camera_from_metadata)

    dev = torch.device("cuda")
    rows = []
    model, config = load_model(
        scan.db.get_scan("models").get_fileset("models").get_files()[0])
    model = model.to(device=dev, dtype=torch.bfloat16).eval()
    labels = config["label_names"]
    C = len(labels)
    files = scan.get_fileset("images").get_files()[:ML_BATCH]
    imgs = torch.from_numpy(np.stack([io.read_image(f)[..., :3]
                                      for f in files])).to(dev)
    cams = torch.from_numpy(np.stack([camera_from_metadata(
        f.get_metadata("camera")) for f in files])).to(dev)
    probs = forward_probs(model, imgs)
    del imgs
    valid = torch.ones(len(files), dtype=torch.bool, device=dev)
    origin, shape = grid_of(scan.get_metadata("bounding_box"), ML_VOXEL)
    nvox = int(np.prod(shape))
    slab_nx = min(shape[0], _avg_chunk_voxels() // (C * shape[1] * shape[2]))
    nx_pad = -(-shape[0] // slab_nx) * slab_nx
    assert nx_pad // slab_nx == 3, (shape, slab_nx)

    def k5_slabs(vol, log_mode, sample):
        for xs in range(0, nx_pad, slab_nx):
            ml_fused.accumulate(vol, probs, cams, valid, origin, ML_VOXEL,
                                xs, slab_nx, log_mode, sample)
        return vol

    def whole(fn, vol, log_mode, sample):
        return fn(vol, probs, cams, valid, origin, ML_VOXEL, 0, shape[0],
                  log_mode, sample)

    def fresh(nx=shape[0]):
        return torch.zeros((C, nx, *shape[1:]), device=dev)

    # the data-dependent work: voxel-view pairs, and those in frame
    in_frame = sum(int(ml_fused.project(cams[b], origin, ML_VOXEL, 0, shape,
                                        probs.shape[2:])[2].sum())
                   for b in range(len(files)))
    pairs = len(files) * nvox
    modes = {}
    for mode, log_mode, sample in (("bilinear", False, "bilinear"),
                                   ("box", False, "box"),
                                   ("log", True, "bilinear")):
        got = whole(ml_fused.accumulate, fresh(), log_mode, sample)
        want = whole(ml_fused.accumulate_plain, fresh(), log_mode, sample)
        slabs = k5_slabs(fresh(nx_pad), log_mode, sample)[:, :shape[0]]
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        n_diff = int((got != want).sum())
        assert torch.equal(got, want), \
            f"accumulate ({mode}) kernel != plain ({n_diff} voxels)"
        assert torch.equal(slabs, got), f"accumulate ({mode}) slabs != whole"
        del got, want, slabs
        vol = fresh()
        ms = cuda_ms(lambda: whole(ml_fused.accumulate, vol, log_mode,
                                   sample))
        vol = fresh(nx_pad)
        slab_ms = cuda_ms(lambda: k5_slabs(vol, log_mode, sample))
        del vol
        plain = cuda_ms(lambda: whole(ml_fused.accumulate_plain, fresh(),
                                      log_mode, sample), reps=3, warmup=1)
        lib = cuda_ms(lambda: _library_accumulate(probs, cams, origin,
                                                  ML_VOXEL, shape, sample),
                      reps=3, warmup=1)
        # the function's work, not the kernel's: per voxel-view pair ~30
        # operations of projection and frame test; per pixel of the batch
        # one log (log mode) and the 2x2 prefilter (box: 3 adds, 1
        # multiply); per in-frame pair 16 operations of bilinear weights
        # and per label 8 (the 4 taps weighted: 1 multiply + 3 fused
        # multiply-adds at 2 each; the add into the sum), or in box mode 10
        # of indices and per label 1 (the one tap added)
        nops = (30 * pairs + (int(log_mode) + 4 * (sample == "box"))
                * probs.numel()
                + ((16 + 8 * C) if sample == "bilinear" else (10 + C))
                * in_frame)
        # the batch read once, the volume read and written once
        nbytes = probs.numel() * 4 + 2 * C * nvox * 4 + cams.numel() * 4 \
            + valid.numel()
        modes[mode] = kernel_row(
            "accumulate_labels", launches["accumulate_labels"], err, ms,
            plain, nbytes, nops, library=lib,
            extra={"path": "ml", "mode": mode, "n_differ": n_diff,
                   "tolerance": "bit-equal", "batch": len(files),
                   "unit": "one batch, the whole grid in one launch",
                   "slab_lane_ms": slab_ms, "slabs": nx_pad // slab_nx,
                   "slab_nx": slab_nx, "voxel_view_pairs": pairs,
                   "in_frame_pairs": in_frame,
                   "windows": window_stats(cams, valid, origin, ML_VOXEL,
                                           shape, probs.shape[2:], C,
                                           sample == "box", True)})
    rows.append(dict(modes["bilinear"], modes={
        m: {k: r[k] for k in ("ms", "slab_lane_ms", "plain_ms", "library_ms",
                              "bound_ms", "bound_by", "max_abs_err",
                              "n_differ", "windows")}
        for m, r in modes.items()}))
    emit({"ml_k5_windows": {m: r["windows"] for m, r in modes.items()}})
    del probs

    # K6 on the warm pass's label volumes (in the handoff cache, else the NPZ)
    vols = handoff.cache_get(vfile) or io.read_npz(vfile)
    stack = torch.stack([torch.as_tensor(vols[l]).to(dev, torch.float32)
                         for l in labels]).contiguous()
    pc = ML_CONFIG["PointCloud"]
    sel, row = k6_row("ml", stack, labels, pc, launches)
    rows.append(row)

    # K2-K4 on one label's selection at the path's grid (fruit: the organ
    # whose angles are measured)
    fruit = sel[labels.index("fruit")].to(torch.float32).contiguous()
    del stack, sel
    assert int(fruit.sum()) > 0, "no fruit voxel selected"
    rows += check_vol2pcd_kernels(fruit, pc["level_set_value"], launches,
                                  "ml")
    emit({"ml_kernel_checks": {"grid": list(shape), "labels": labels,
                               "batch": ML_BATCH, "slab_nx": slab_nx}})
    return rows


def k6_row(path, stack, labels, pc, launches):
    """K6 on a route's label volumes with its PointCloud settings (and
    at contrast 10) bit-equal to its plain version and to one PyTorch
    chain (the library), timed beside both, with its kernel's device
    time (the profiler's, and 20 calls queued back to back between two
    events): (the selection at the route's settings, the row)."""
    import torch
    from plant3dvision_tpu_torch.ops import multiclass

    C = stack.shape[0]
    bg = labels.index("background")
    for contrast in (pc["min_contrast"], 10.0):
        args = (pc["background_prior"], contrast, pc["min_score"], bg,
                contrast > 1.0)
        k = multiclass.select_labels(stack, *args)
        p = multiclass.select_labels_plain(stack, *args)
        torch.cuda.synchronize()
        assert torch.equal(k, p), \
            f"select kernel != plain on {path} (contrast {contrast})"
    args = (pc["background_prior"], pc["min_contrast"], pc["min_score"], bg,
            pc["min_contrast"] > 1.0)

    def k6_library():
        s = stack.clone()
        s[bg] *= pc["background_prior"]
        org = s.clone()
        org[bg] = -torch.inf
        res = torch.where(s[bg] > org.amax(0), bg, org.argmax(0))
        lane = torch.arange(C, device=stack.device).view(-1, 1, 1, 1)
        out = (res[None] == lane) & (s > pc["min_score"])
        out[bg] = False
        return out

    sel = multiclass.select_labels(stack, *args)
    recorded = {}
    by = device_ms_by_kernel(lambda: multiclass.select_labels(stack, *args),
                             need="select_kernel", recorded=recorded)
    kms = next((v for k, v in (by or {}).items() if "select_kernel" in k),
               None)
    if not args[-1]:
        assert torch.equal(k6_library(), sel), f"K6 library != kernel ({path})"
    n = stack[0].numel()
    return sel, kernel_row(
        "multiclass_select", launches["multiclass_select"], 0,
        cuda_ms(lambda: multiclass.select_labels(stack, *args)),
        cuda_ms(lambda: multiclass.select_labels_plain(stack, *args)),
        C * n * 4 + C * n, (2 * C * C + 4 * C) * n,
        library=cuda_ms(k6_library),
        kernel_ms=kms,
        extra={"path": path, "shape": list(stack.shape),
               "profiled_launches": sum(v for k, v in recorded.items()
                                        if "select_kernel" in k),
               "queued_ms": queued_ms(
                   lambda: multiclass.select_labels(stack, *args)),
               "selected": {l: int(sel[i].sum())
                            for i, l in enumerate(labels)}})


def separate_config(**seg):
    """The separate route's configuration (SEP_TASKS of ml_pipe_virtual.toml
    with phase 7's changes); `seg` overrides Segmentation2D settings."""
    from plant3dvision_tpu_torch.runtime.config import load_toml
    toml = load_toml(ROOT / "configs" / "ml_pipe_virtual.toml")
    cfg = {t: dict(toml[t]) for t in SEP_TASKS}
    cfg["Segmentation2D"].update(model_id="unet_seg", batch_size=ML_BATCH,
                                 **seg)
    cfg["Voxels"]["voxel_size"] = ML_VOXEL
    cfg["AnglesAndInternodes"] = dict(ML_CONFIG["AnglesAndInternodes"])
    cfg["Clean"] = ML_CLEAN
    return cfg


def run_ml_separate_path(db, device_name):
    """Phase 7: the separate-task ML route through the port's runtime on
    phase 5's scan, with the committed ResUNet."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.evaluation import align_sequences
    from plant3dvision_tpu_torch.models.zoo import install_checkpoint
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.synth_photo import ProceduralArabidopsis

    plant = ProceduralArabidopsis(seed=1)      # phase 5's plant: its GT
    assert install_checkpoint(db).id == "unet_seg"
    cfg = separate_config()
    toml = cfg["Segmentation2D"]
    assert (toml["Sx"], toml["Sy"], toml["binarize"], toml["dilation"]) == \
        (ML_SIZE, ML_SIZE, False, 0)

    ctx = RunContext(db, "ml_northstar", cfg, device="cuda")
    run_task(ctx, "Clean", report=False)
    t0 = time.perf_counter()
    run_task(ctx, "AnglesAndInternodes", report=False)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    warm = []
    run_task(ctx, "Clean", report=False)
    ctx = RunContext(db, "ml_northstar", cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    report, wall, ctx, prof = warm_pass(ctx)
    warm.append(wall)
    launches = dict(kernels.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    scan = ctx.scan
    out = json.loads(scan.get_fileset(report["AnglesAndInternodes"][
        "fileset"]).get_file("AnglesAndInternodes").read_raw())
    labels = scan.get_fileset(report["SegmentedPointCloud"][
        "fileset"]).get_files()[0].get_metadata("labels")
    organs = [f.id for f in scan.get_fileset(
        report["OrganSegmentation"]["fileset"]).get_files()]
    angles = np.asarray(out["angles"], float)
    dtw = align_sequences(angles.tolist(), out["internodes"],
                          np.degrees(plant.gt_angles).tolist(),
                          np.asarray(plant.gt_internodes, float).tolist())
    err = dtw["mean_angle_error"]

    # the reference's mask settings: Segmentation2D alone, binarised and
    # dilated (K8's path)
    bcfg = separate_config(binarize=True, threshold=0.01, dilation=1)
    bctx = RunContext(db, "ml_northstar", bcfg, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    brep = run_task(bctx, "Segmentation2D", report=False)
    torch.cuda.synchronize()
    bin_s = time.perf_counter() - t0
    bin_launches = dict(kernels.LAUNCHES)
    bfs = scan.get_fileset(brep["Segmentation2D"]["fileset"])
    assert len(bfs.get_files()) == ML_VIEWS * 6
    scan.delete_fileset(bfs.id)

    ml = {"device": device_name, "n_views": ML_VIEWS,
          "image": [ML_SIZE, ML_SIZE], "voxel_mm": ML_VOXEL,
          "batch": ML_BATCH, "model": "unet_seg", "cold_s": cold_s,
          "warm_s": warm,
          "task_s": {k: v["seconds"] for k, v in report.items()},
          "n_points": {l: labels.count(l) for l in sorted(set(labels))},
          "n_organs": {l: sum(o.startswith(l + "_") for o in organs)
                       for l in ("fruit", "stem", "leaf", "pedicel")},
          "n_angles": int(len(angles)), "n_gt": int(len(plant.gt_angles)),
          "dtw_normalized_cost": dtw["normalized_cost"],
          "mean_angle_error_deg": err,
          "max_memory_allocated_mb": peak_mb,
          "launches_per_warm_pass": launches,
          "binarised_segmentation_s": bin_s,
          "binarised_launches": bin_launches}
    emit({"ml_separate_path": ml})
    if prof is not None:
        emit({"ml_separate_path_profile": prof})
    need = ("signed_distance", "gradient_gaussian", "band_compact", "average",
            "multiclass_select", "reproject_scores")
    missing = [k for k in need if launches[k] <= 0]
    assert not missing, f"kernels not launched on the separate route: " \
        f"{missing}"
    assert bin_launches["dilate_disk"] > 0, "K8 not launched (binarised run)"
    assert len(angles) >= 10, f"only {len(angles)} angles"
    assert err is not None and err < 25.0, f"mean angle error {err} deg"
    nums = [cold_s, *warm, peak_mb, bin_s, dtw["normalized_cost"], err,
            *idle_share(prof), *angles, *out["internodes"]]
    assert np.isfinite(nums).all(), "a number of the separate route is " \
        "not finite"
    # K8's launches are the binarised run's (the route itself does not
    # binarise)
    return scan, report, dict(launches, dilate_disk=bin_launches[
        "dilate_disk"]), warm[0]


def _library_reproject(points, masks, cams, label_idx, L):
    """One PyTorch chain computing K7's function: every point-file
    projection at once (matmuls), one gather, one index_add_ into the
    labels (its sums in another order)."""
    import torch
    F, H, W = masks.shape
    R = cams[:, 4:13].view(F, 3, 3)
    p = torch.einsum("fij,nj->fni", R, points) + cams[:, None, 13:16]
    pz = p[..., 2].clamp(min=1e-9)
    px = (p[..., 0] / pz * cams[:, None, 0] + cams[:, None, 2]).long()
    py = (p[..., 1] / pz * cams[:, None, 1] + cams[:, None, 3]).long()
    inside = (p[..., 2] > 0) & (px >= 0) & (px < W) & (py >= 0) & (py < H)
    lin = py.clamp(0, H - 1) * W + px.clamp(0, W - 1)
    vals = torch.gather(masks.view(F, -1), 1, lin).float() / 255.0
    scores = torch.zeros((L, points.shape[0]), device=points.device)
    scores.index_add_(0, label_idx.long(), torch.where(inside, vals, 0.0))
    return scores.T


def check_separate_kernels(scan, report, launches):
    """Phase 8: K5-avg, K6, K7 and K8 against their plain versions at the
    separate route's shapes (the warm pass's masks, volumes, grid and
    points)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.ops import carving, reproject

    dev = torch.device("cuda")
    rows = []
    fs = scan.get_fileset(report["Segmentation2D"]["fileset"])
    files = fs.get_files()
    with ThreadPoolExecutor(8) as ex:
        stack = np.stack(list(ex.map(io.read_image, files)))   # (756, H, W)
    channels = [f.get_metadata("channel") for f in files]
    cams = np.stack([carving.camera_from_metadata(f.get_metadata("camera"))
                     for f in files])
    H, W = stack.shape[1:]

    # K5-avg: one label's 126 masks (fruit), / 255 as Backprojection scales
    # them, and the same masks log'd
    origin, shape = grid_of(scan.get_metadata("bounding_box"), ML_VOXEL)
    nvox = int(np.prod(shape))
    sel = [i for i, c in enumerate(channels) if c == "fruit"]
    cm = torch.from_numpy(cams[sel]).to(dev)
    va = torch.ones(len(sel), dtype=torch.bool, device=dev)
    fm = stack[sel].astype(np.float32) / 255.0
    in_frame = sum(int(carving.project(cm[v], origin, ML_VOXEL, 0, shape,
                                       (H, W), grid_fma=False)[2].sum())
                   for v in range(len(sel)))
    pairs = len(sel) * nvox
    windows = window_stats(cm, va, origin, ML_VOXEL, shape, (H, W), 1,
                           False, False)
    emit({"ml_separate_k5avg_windows": windows})
    modes = {}
    for mode, m in (("plain", fm), ("log", np.log(carving.EPS + fm))):
        mt = torch.from_numpy(m).to(dev)
        args = (mt, cm, va, origin, ML_VOXEL, shape)
        got = carving.average(*args)
        want = carving.average_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert torch.equal(got, want), f"average ({mode}) kernel != plain"
        lib = cuda_ms(lambda: _library_accumulate(
            mt[:, None], cm, origin, ML_VOXEL, shape, "bilinear"), reps=3,
            warmup=1)
        # per voxel-view pair ~30 operations of projection and frame test;
        # per in-frame pair 16 of weights and 8 for the four taps and the
        # sum; bytes: the masks read once, the volume written once
        modes[mode] = kernel_row(
            "average", launches["average"], err,
            cuda_ms(lambda: carving.average(*args)),
            cuda_ms(lambda: carving.average_plain(*args), reps=2, warmup=1),
            mt.numel() * 4 + nvox * 4 + cm.numel() * 4 + len(sel),
            30 * pairs + 24 * in_frame, library=lib,
            extra={"path": "ml_separate", "mode": mode, "shape": list(shape),
                   "views": len(sel), "voxel_view_pairs": pairs,
                   "in_frame_pairs": in_frame, "windows": windows})
        del mt, got, want
    rows.append(dict(modes["plain"], modes={
        m: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by", "max_abs_err")}
        for m, r in modes.items()}))

    # K6 on the pass's averaged label volumes with its PointCloud settings
    from plant3dvision_tpu_torch.fsdb import handoff
    vfile = scan.get_fileset(report["Voxels"]["fileset"]).get_files()[0]
    vols = handoff.cache_get(vfile) or io.read_npz(vfile)
    vlabels = list(vols.keys())
    vstack = torch.stack([torch.as_tensor(vols[l]).to(dev, torch.float32)
                          for l in vlabels]).contiguous()
    rows.append(k6_row("ml_separate", vstack, vlabels,
                       separate_config()["PointCloud"], launches)[1])
    del vols, vstack

    # K7: the warm pass's points and its 630 organ masks, in fileset order
    pfile = scan.get_fileset(report["PointCloud"]["fileset"]).get_files()[0]
    pts = torch.from_numpy(np.asarray(io.read_point_cloud(pfile).points,
                                      np.float32)).to(dev)
    organ = [i for i, c in enumerate(channels) if c != "background"]
    labels = [l for l in fs.get_metadata("label_names") if l != "background"]
    mk = torch.from_numpy(stack[organ]).to(dev)
    ck = torch.from_numpy(cams[organ]).to(dev)
    lk = torch.tensor([labels.index(channels[i]) for i in organ],
                      dtype=torch.int32, device=dev)
    L = len(labels)
    args = (pts, mk, ck, lk, L)
    got = reproject.score_points_by_masks(*args)
    want = reproject.score_points_by_masks_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "reproject kernel != plain"
    lib_scores = _library_reproject(*args)
    touched, in_pairs = 0, 0
    for f in range(len(organ)):
        lin, inside = reproject.project_points(pts, ck[f], (H, W))
        touched += int(torch.unique(lin[inside]).numel())
        in_pairs += int(inside.sum())
    n = pts.shape[0]
    runs = int(reproject.camera_runs(ck, None).numel())
    # per point-file pair ~32 operations (three dot products, two
    # divisions and fused multiply-adds, frame test, / 255, the add); bytes:
    # the points, cameras and labels read once, the distinct mask bytes the
    # in-frame pairs read, the scores written once. bound_ms_runs: ~30
    # operations a point and camera run (the projection and frame test) and
    # 2 a point-file pair (/ 255, the add), the same bytes
    k7_bytes = 12 * n + ck.numel() * 4 + lk.numel() * 4 + touched + 4 * n * L
    rows.append(kernel_row(
        "reproject_scores", launches["reproject_scores"], 0.0,
        cuda_ms(lambda: reproject.score_points_by_masks(*args)),
        cuda_ms(lambda: reproject.score_points_by_masks_plain(*args), reps=3,
                warmup=1),
        k7_bytes, 32 * n * len(organ),
        library=cuda_ms(lambda: _library_reproject(*args), reps=3, warmup=1),
        extra={"path": "ml_separate", "points": n, "files": len(organ),
               "labels": L, "camera_runs": runs,
               "camera_runs_chunked": int(reproject.camera_runs(ck).numel()),
               "bound_ms_runs": bound_ms(
                   k7_bytes, 30 * n * runs + 2 * n * len(organ))[0],
               "in_frame_pairs": in_pairs,
               "mask_bytes_read": touched, "mask_bytes_held": mk.numel(),
               "library_max_abs_diff": float((lib_scores - got).abs().max())}))
    del mk, lib_scores

    # K8: the pass's 756 masks thresholded at 0.01, radius 1 and 3
    m = torch.from_numpy(stack).to(dev)
    binm = carving.div_f32(m.float(), 255.0) > float(np.float32(0.01))
    del m
    radii = {r: dilation_row(binm, r, launches["dilate_disk"], {
        "path": "ml_separate",
        "launches_counted_in": "binarised Segmentation2D"}) for r in (1, 3)}
    rows.append(dict(radii[1], radii={
        r: {k: x[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by")} for r, x in radii.items()}))
    emit({"ml_separate_kernel_checks": {
        "grid": list(shape), "masks": list(stack.shape), "points": n}})
    return rows


def run_frontend_path(db, device_name):
    """Phase 9: the real-scan front end (frontend_config) on a 60-view
    1440x1080 distorted photo scan of the north-star plant, two views marked
    "incorrect"; the 0.5 mm grid of phase 4; then the strict control pass
    (frontend_config(strict=True)) on the same scan. Returns the scan, the
    warm pass's report and launches, and the checks, which main() asserts
    after phase 10."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.synth import SyntheticPlant

    V, W, H = 60, 1440, 1080
    plant = SyntheticPlant(**NORTHSTAR_PLANT)
    t0 = time.perf_counter()
    write_distorted_scan(db, "frontend", plant, V, W, H, 1400.0)
    gen_s = time.perf_counter() - t0
    cfg = frontend_config()

    ctx = RunContext(db, "frontend", cfg, device="cuda")
    t0 = time.perf_counter()
    run_task(ctx, "AnglesAndInternodes", report=False)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    warm = []
    run_task(ctx, "Clean", report=False)
    ctx = RunContext(db, "frontend", cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    report, wall, ctx, prof = warm_pass(ctx)
    warm.append(wall)
    launches = dict(kernels.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    scan = ctx.scan
    n_files = {t: len(scan.get_fileset(report[t]["fileset"]).get_files())
               for t in ("Undistorted", "Masks")}
    vol = np.load(scan.get_fileset(report["Voxels"]["fileset"])
                  .get_files()[0].path())["volume"]
    angles, internodes, dtw = frontend_angles(scan, report, plant)
    gt = np.degrees(plant.gt_angles)
    n = min(len(angles), len(gt))
    pos_err = float(np.abs(angles[:n] - gt[:n]).mean()) if n else None
    err = dtw["mean_angle_error"]
    emit({"frontend_path": {
        "device": device_name, "n_views": V, "image": [W, H],
        "k1": FRONTEND_K1, "incorrect_views": list(FRONTEND_INCORRECT),
        "voxel_mm": cfg["Voxels"]["voxel_size"], "shape": list(vol.shape),
        "kill_tolerance": cfg["Voxels"]["kill_tolerance"],
        "scan_generation_s": gen_s, "cold_s": cold_s, "warm_s": warm,
        "task_s": {k: v["seconds"] for k, v in report.items()},
        "files_written": n_files,
        "voxels": {"alive": int((vol == 1).sum()),
                   "killed": int((vol == -1).sum())},
        "n_angles": int(len(angles)), "n_gt": int(len(gt)),
        "angles": angles.tolist(),
        "mean_angle_error_deg": err, "positional_mean_error_deg": pos_err,
        "dtw_normalized_cost": dtw["normalized_cost"],
        "max_memory_allocated_mb": peak_mb,
        "launches_per_warm_pass": launches}})
    if prof is not None:
        emit({"frontend_path_profile": prof})

    # the control: the profiled pass's Undistorted output is reused
    strict = frontend_config(strict=True)
    t0 = time.perf_counter()
    srep = run_task(RunContext(db, "frontend", strict, device="cuda"),
                    "AnglesAndInternodes", report=False)
    torch.cuda.synchronize()
    s_s = time.perf_counter() - t0
    s_angles, _, s_dtw = frontend_angles(scan, srep, plant)
    s_err = s_dtw["mean_angle_error"]
    emit({"frontend_strict_control": {
        "settings": {"Voxels.kill_tolerance": 0, "Masks.dilation": 0,
                     "skeleton and angles": "geom_pipe_fast.toml"},
        "s": s_s, "task_s": {k: v["seconds"] for k, v in srep.items()},
        "n_angles": int(len(s_angles)), "angles": s_angles.tolist(),
        "mean_angle_error_deg": s_err,
        "dtw_normalized_cost": s_dtw["normalized_cost"]}})
    need = ("undistort", "mask_filter", "dilate_disk", "count_kills",
            "signed_distance", "gradient_gaussian", "band_compact")
    checks = {
        "kernels launched in the warm pass": not [
            k for k in need if launches[k] <= 0],
        "58 undistorted images and 58 masks": n_files == {
            "Undistorted": V - len(FRONTEND_INCORRECT),
            "Masks": V - len(FRONTEND_INCORRECT)},
        "at least 10 angles": len(angles) >= 10,
        # the config's vote tolerance, dilation and 6 mm skeleton bins are
        # the real_plant fixture's; on this plant's 6 mm internodes they
        # cost accuracy (PERF.md): the control holds the front end to
        # the main path's accuracy
        "mean angle error below 10 deg": err is not None and err < 10.0,
        "control: at least 10 angles, mean error below 2 deg":
            len(s_angles) >= 10 and s_err is not None and s_err < 2.0,
        "finite numbers": bool(np.isfinite(
            [cold_s, *warm, s_s, peak_mb, *idle_share(prof),
             *angles, *internodes, *s_angles]).all()),
    }
    return scan, report, launches, checks


def _library_undistort(imgs, K, dist):
    """One PyTorch library chain for K9's function: the source map in plain
    f32 tensor operations (no fused multiply-adds), grid_sample (bilinear,
    zeros outside, pixel centres at integers), round and clip."""
    import torch
    import torch.nn.functional as F
    from plant3dvision_tpu_torch.ops.undistort import _params
    N, H, W, C = imgs.shape
    dev = imgs.device
    (fx, fy, cx, cy), (k1, k2, p1, p2, k3) = _params(K, dist)
    u = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    v = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    x, y = (u - float(cx)) / float(fx), (v - float(cy)) / float(fy)
    r2 = x * x + y * y
    rm = r2 * (float(k1) + r2 * (float(k2) + r2 * float(k3)))
    dx = x * rm + 2 * float(p1) * x * y + float(p2) * (r2 + 2 * x * x)
    dy = y * rm + float(p1) * (r2 + 2 * y * y) + 2 * float(p2) * x * y
    px, py = u + dx * float(fx), v + dy * float(fy)
    grid = torch.stack([px / (W - 1) * 2 - 1, py / (H - 1) * 2 - 1], -1)
    out = F.grid_sample(imgs.permute(0, 3, 1, 2).float(),
                        grid[None].expand(N, H, W, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


def fast_lane_library(imgs, channel, fast_t):
    """K10's fast lane (uint8, linear, binarised, one positive
    coefficient) as one PyTorch call on a (N, H, W, C) stack: PyTorch
    compares the uint8 channel with the float threshold in float32, as the
    kernel and compute_mask_numpy do. `channel` and `fast_t` are the
    lane's, from ops/masks.py:_lane."""
    return imgs[..., channel] > fast_t


def check_frontend_kernels(scan, report, launches):
    """Phase 10: K9 on the 58 raw images, K10 (linear and excess green) on
    the warm pass's 58 undistorted images, K11 (count_kills and
    carve_tolerant at 3) on its 58 masks, each against its plain version
    (K10 also against compute_mask_numpy) and timed beside it and, where one
    exists, a PyTorch library chain."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from plant3dvision_tpu_torch import camera as cameralib
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.ops import carving, masks, undistort

    dev = torch.device("cuda")
    rows = []
    cfg = frontend_config()
    query = json.loads(cfg["Undistorted"]["query"])
    raw_files = scan.get_fileset("images").get_files(query=query)
    with ThreadPoolExecutor(8) as ex:
        raw = np.stack(list(ex.map(io.read_image, raw_files)))
    cam = cameralib.get_camera_kwargs_from_images_metadata(raw_files[0])
    K, dist = cam["K"].astype(np.float32), cam["dist"].astype(np.float32)

    # K9: the 58 raw images, with the kernel's lane counts
    imgs = torch.from_numpy(raw).to(dev)
    lanes = torch.zeros(3, dtype=torch.int32, device=dev)
    got = undistort.undistort_batch(imgs, K, dist, lane_counts=lanes)
    want = undistort.undistort_plain(imgs, K, dist)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    assert n_diff == 0, f"undistort kernel != plain ({n_diff} values)"
    tiles = undistort.tile_windows(imgs.shape[1:3], K, dist, imgs.shape[3])
    predicted = [int(tiles["staged"].sum()),
                 int((tiles["any"] & ~tiles["staged"]).sum()),
                 int((~tiles["any"]).sum())]
    assert lanes.tolist() == predicted, (lanes.tolist(), predicted)
    lib = _library_undistort(imgs, K, dist)
    lib_diff = int((lib != got).sum())
    N, H, W, C = imgs.shape
    # bytes: the stack read once, written once; operations: ~40 for a
    # pixel's source position and weights, 8 per value for the lerps
    rows.append(kernel_row(
        "undistort", launches["undistort"], 0,
        cuda_ms(lambda: undistort.undistort_batch(imgs, K, dist)),
        cuda_ms(lambda: undistort.undistort_plain(imgs, K, dist), reps=1,
                warmup=0),
        2 * imgs.numel(), 40 * H * W + 8 * imgs.numel(),
        library=cuda_ms(lambda: _library_undistort(imgs, K, dist)),
        kernel_ms=device_ms(lambda: undistort.undistort_batch(imgs, K, dist)),
        extra={"path": "frontend", "shape": list(imgs.shape),
               "k1": float(dist[0]),
               "library_values_differing": lib_diff,
               "tiles": dict(zip(("staged", "global_load", "empty"),
                                 lanes.tolist())),
               "window_bytes_max": int(tiles["bytes"].max())}))
    del imgs, got, want, lib

    # K10: the warm pass's 58 undistorted images
    und = scan.get_fileset(report["Undistorted"]["fileset"]).get_files()
    with ThreadPoolExecutor(8) as ex:
        und = np.stack(list(ex.map(io.read_image, und)))
    imgs = torch.from_numpy(und).to(dev)
    mcfg = cfg["Masks"]
    coefs = tuple(map(float, json.loads(mcfg["parameters"])))
    lanes = {}
    for ftype, thr in (("linear", float(mcfg["threshold"])),
                       ("excess_green", 0.15)):
        args = (imgs, ftype, coefs, thr, True)
        got = masks.mask_filter(*args)
        want = masks.mask_filter_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"mask kernel != plain ({ftype})"
        with ThreadPoolExecutor(8) as ex:
            host = np.stack(list(ex.map(
                lambda im: masks.compute_mask_numpy(im, ftype, coefs, thr,
                                                    as_bool=True), und)))
        n_host = int((got.cpu().numpy() != host).sum())
        assert n_host == 0, f"mask kernel != compute_mask_numpy ({ftype}, " \
            f"{n_host} pixels)"
        cvec = torch.tensor(coefs, device=dev)
        mode, _, ch, fast_t = masks._lane(imgs, ftype, coefs, thr, True)

        def chain():
            # the general lanes' chain: rescale, filter, compare
            x = carving.div_f32(imgs.float(), 255.0)
            if ftype == "linear":
                return torch.tensordot(x, cvec, dims=([3], [0])) > thr
            s = x.sum(-1).clamp(min=1e-12)
            return (2 * x[..., 1] - x[..., 0] - x[..., 2]) / s > thr

        lib = ((lambda: fast_lane_library(imgs, ch, fast_t))
               if mode == masks.FAST else chain)
        # bytes: the images read once, the masks written once; operations:
        # 1 compare per pixel (the fast lane) or 3 divisions, 2 adds and
        # the filter (~12) per pixel
        npx = N * H * W
        one = imgs[:1]          # a live-carving view: one image a launch
        extra = {"path": "frontend", "filter": ftype, "threshold": thr,
                 "fast_lane": mode == masks.FAST, "shape": list(imgs.shape),
                 "true": int(got.sum()),
                 "library_pixels_differing": int((lib() != got).sum()),
                 "compute_mask_numpy_pixels_differing": n_host,
                 "one_image_ms": cuda_ms(lambda: masks.mask_filter(
                     one, ftype, coefs, thr, True), reps=21),
                 "one_image_bound_ms": bound_ms(
                     one.numel() + H * W,
                     (1 if ftype == "linear" else 12) * H * W)[0]}
        if mode == masks.FAST:
            extra["chain_ms"] = cuda_ms(chain)
            extra["one_image_library_ms"] = cuda_ms(
                lambda: fast_lane_library(one, ch, fast_t), reps=21)
        lanes[ftype] = kernel_row(
            "mask_filter", launches["mask_filter"], 0,
            cuda_ms(lambda: masks.mask_filter(*args)),
            cuda_ms(lambda: masks.mask_filter_plain(*args)),
            imgs.numel() + npx, (1 if ftype == "linear" else 12) * npx,
            library=cuda_ms(lib), extra=extra)
    rows.append(dict(lanes["linear"], filters={
        f: {k: r.get(k) for k in ("ms", "plain_ms", "library_ms", "chain_ms",
                                  "bound_ms", "bound_by", "one_image_ms",
                                  "one_image_library_ms",
                                  "one_image_bound_ms", "true")}
        for f, r in lanes.items()}))
    # K8: the Masks task's dilation of those masks (radius 3)
    fm = masks.mask_filter(imgs, "linear", coefs, float(mcfg["threshold"]),
                           True)
    del imgs, got, want
    rows.append(dilation_row(fm, int(mcfg["dilation"]),
                             launches["dilate_disk"], {
                                 "path": "frontend",
                                 "launches_counted_in": "front-end warm pass"
                                 " (Masks)"}))
    del fm

    # K11: the warm pass's 58 masks, count_kills and carve_tolerant at 3
    mfiles = scan.get_fileset(report["Masks"]["fileset"]).get_files()
    with ThreadPoolExecutor(8) as ex:
        mstack = np.stack(list(ex.map(io.read_image, mfiles)))
    cams = np.stack([carving.camera_from_metadata(
        f.get_metadata("colmap_camera")) for f in mfiles])
    origin, shape = grid_of(FRONTEND_BBOX, 0.5)
    pk = torch.from_numpy(carving.pack_masks(mstack)).to(dev)
    cm = torch.from_numpy(cams).to(dev)
    va = torch.ones(len(cams), dtype=torch.bool, device=dev)
    hw = mstack.shape[1:]
    args = (pk, cm, va, origin, 0.5, shape, hw)
    tol = int(cfg["Voxels"]["kill_tolerance"])
    kills, seen = carving.count_kills(*args)
    kp, sp, mask_bytes = carving.count_kills_plain(*args, count_work=True)
    vt = carving.carve_tolerant(*args, tol)
    vp = carving.carve_tolerant_plain(*args, tol)
    torch.cuda.synchronize()
    assert torch.equal(kills, kp) and torch.equal(seen, sp), \
        "count_kills kernel != plain"
    assert torch.equal(vt, vp), "carve_tolerant kernel != plain"
    assert torch.equal(vt, carving.tolerance_verdict(kills, seen, tol))
    # carve_tolerant's tests: a voxel stops at its (tol+1)-th kill
    tests, alive = 0, torch.ones(shape, dtype=torch.bool, device=dev)
    k = torch.zeros(shape, dtype=torch.int16, device=dev)
    for in_img, hit, _ in carving._view_tests(*args):
        tests += int(alive.sum())
        k += (alive & in_img & ~hit).to(torch.int16)
        alive &= k <= tol
    nvox = int(np.prod(shape))
    pairs = len(cams) * nvox
    # bytes: the distinct mask bytes the in-frame tests read, the cameras,
    # the outputs written once (int16 + bool, or int8); operations: 24 per
    # voxel-view test (as K1)
    modes = {
        "count_kills": kernel_row(
            "count_kills", launches["count_kills"], 0,
            cuda_ms(lambda: carving.count_kills(*args)),
            cuda_ms(lambda: carving.count_kills_plain(*args), reps=1,
                    warmup=0),
            mask_bytes + cm.numel() * 4 + 3 * nvox, 24 * pairs,
            extra={"path": "frontend", "shape": list(shape),
                   "views": len(cams), "voxel_view_tests": pairs,
                   "mask_bytes_read": mask_bytes,
                   "mask_bytes_held": pk.numel(),
                   "killed_at_tolerance": int((vt == -1).sum()),
                   "alive_at_tolerance": int((vt == 1).sum())}),
        "carve_tolerant": kernel_row(
            "count_kills", launches["count_kills"], 0,
            cuda_ms(lambda: carving.carve_tolerant(*args, tol)),
            cuda_ms(lambda: carving.carve_tolerant_plain(*args, tol),
                    reps=1, warmup=0),
            mask_bytes + cm.numel() * 4 + nvox, 24 * tests,
            extra={"voxel_view_tests": tests, "max_kills": tol})}
    rows.append(dict(modes["count_kills"], modes={
        m: {key: r[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "voxel_view_tests")}
        for m, r in modes.items()}))
    emit({"frontend_kernel_checks": {
        "images": list(raw.shape), "masks": list(mstack.shape),
        "grid": list(shape)}})
    return rows


def selfcal_config():
    """geom_pipe_real_selfcal.toml's tasks from TurntableCalibration to
    AnglesAndInternodes (no TriangleMesh, no evaluation), with Voxels' box
    set to phase 9's (FRONTEND_BBOX)."""
    from plant3dvision_tpu_torch.runtime.config import load_toml
    toml = load_toml(ROOT / "configs" / "geom_pipe_real_selfcal.toml")
    cfg = {t: dict(toml[t]) for t in SELFCAL_TASKS}
    cfg["Voxels"]["bounding_box"] = FRONTEND_BBOX
    cfg["Clean"] = {"no_confirm": True}
    return cfg


SELFCAL_TASKS = ("TurntableCalibration",) + FRONTEND_TASKS


def _project(c, pts):
    import numpy as np
    q = pts @ c[4:13].reshape(3, 3).T + c[13:16]
    return np.stack([q[:, 0] / q[:, 2] * c[0] + c[2],
                     q[:, 1] / q[:, 2] * c[1] + c[3]], 1)


def reprojection_px(cams, true_cams, pts, views, seen=None):
    """Per point and view, the distance (px) between the projections of
    `seen` (default `pts`) through `cams` and of `pts` through `true_cams`,
    over `views`."""
    import numpy as np
    seen = pts if seen is None else seen
    return np.concatenate([np.linalg.norm(
        _project(cams[v], seen) - _project(true_cams[v], pts), axis=1)
        for v in views])


def axis_gauge_reprojection_px(cams, true_cams, pts, views):
    """reprojection_px up to the two gauges of a turntable calibrated from
    CNC poses: a shift along the turntable axis (the mount offset `my`
    moves every camera along it alike) and a scale about the axis (the
    focal length against the object's size, to first order). Fits the
    scale s of x, y, z and the shift b of z (least squares) that bring the
    points, seen through `cams`, closest to their true projections, and
    returns (the distances of all points, (s, b))."""
    import numpy as np
    from scipy.optimize import least_squares
    sub = pts[::max(1, len(pts) // 2000)]
    truth = [_project(true_cams[v], sub) for v in views]

    def moved(p, X):
        return X * p[0] + np.array([0.0, 0.0, p[1]])

    def resid(p):
        X = moved(p, sub)
        return np.concatenate([(_project(cams[v], X) - t).ravel()
                               for v, t in zip(views, truth)])

    fit = least_squares(resid, np.array([1.0, 0.0]))
    return (reprojection_px(cams, true_cams, pts, views, moved(fit.x, pts)),
            (float(fit.x[0]), float(fit.x[1])))


def calibration_errors(cams, true_cams, pts, views, n=20000):
    """The calibrated cameras' reprojection of `n` of the plant's surface
    points (a seeded sample) against the true cameras over `views`: raw,
    and up to the axis gauges (axis_gauge_reprojection_px); median, p95
    and max in px."""
    import numpy as np
    sample = pts[np.random.default_rng(0).choice(len(pts), min(n, len(pts)),
                                                 replace=False)]

    def summary(e):
        return {"median": float(np.median(e)),
                "p95": float(np.percentile(e, 95)), "max": float(e.max())}
    raw = reprojection_px(cams, true_cams, sample, views)
    err, (s, b) = axis_gauge_reprojection_px(cams, true_cams, sample, views)
    return {"reprojection_px": summary(raw),
            "axis_gauge_reprojection_px": {**summary(err), "scale": s,
                                           "z_shift_mm": b}}


def run_selfcal_path(db, device_name):
    """Phase 11: geom_pipe_real_selfcal.toml from TurntableCalibration to
    AnglesAndInternodes (selfcal_config) on a 60-view 1440x1080 textured
    turntable scan with CNC poses (write_turntable_scan): one cold pass, one
    warm pass after Clean (profiled too with --profile); then the strict
    control of phase 9 (frontend_config(strict=True)) on the calibrated
    cameras.
    Returns the scan, the warm pass's report and launches, the true
    cameras and the checks, which main() asserts after phase 12."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops.carving import camera_from_metadata
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.synth import SyntheticPlant

    V, W, H = 60, 1440, 1080
    plant = SyntheticPlant(**NORTHSTAR_PLANT)
    t0 = time.perf_counter()
    true_cams, pts = write_turntable_scan(db, "selfcal", plant, V, W, H)
    gen_s = time.perf_counter() - t0
    cfg = selfcal_config()

    def calibrated_cameras(scan):
        return np.stack([camera_from_metadata(f.get_metadata(
            "colmap_camera")) for f in scan.get_fileset("images").get_files()])

    ctx = RunContext(db, "selfcal", cfg, device="cuda")
    t0 = time.perf_counter()
    crep = run_task(ctx, "TurntableCalibration", report=False)
    torch.cuda.synchronize()
    cal_cold_s = time.perf_counter() - t0
    emit({"selfcal_cold_calibration": {"s": cal_cold_s, **json.loads(
        ctx.scan.get_fileset(crep["TurntableCalibration"]["fileset"])
        .get_file("calibration").read_raw())}})
    crep = run_task(ctx, "AnglesAndInternodes", report=False)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cold_cams = calibrated_cameras(ctx.scan)
    cold_err = frontend_angles(ctx.scan, crep, plant)[2]["mean_angle_error"]

    run_task(ctx, "Clean", report=False)
    ctx = RunContext(db, "selfcal", cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    report, warm_s, ctx, prof = warm_pass(ctx)
    launches = dict(kernels.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    scan = ctx.scan
    cal = json.loads(scan.get_fileset(report["TurntableCalibration"][
        "fileset"]).get_file("calibration").read_raw())
    files = scan.get_fileset("images").get_files()
    cams = calibrated_cameras(scan)
    # the cold and the warm pass calibrate the same scan: the same cameras
    # bit for bit (no float atomics in the BA's sums)
    repeats = bool(np.array_equal(cams, cold_cams))
    correct = [i for i, f in enumerate(files)
               if f.get_metadata("pose_estimation") == "correct"]
    errors = calibration_errors(cams, true_cams, pts, correct)
    angles, internodes, dtw = frontend_angles(scan, report, plant)
    emit({"selfcal_path": {
        "device": device_name, "n_views": V, "image": [W, H],
        "theta_true": SELFCAL_THETA, "jitter_true_deg": list(SELFCAL_JITTER),
        "scan_generation_s": gen_s, "cold_s": cold_s, "warm_s": warm_s,
        "task_s": {k: v["seconds"] for k, v in report.items()},
        "calibration_s": report["TurntableCalibration"].get("stages"),
        "theta": cal["theta"], "coherence": cal["coherence"],
        "silhouette_stage": cal["silhouette_stage"],
        "feature_ba": cal["feature_ba"], "n_correct": len(correct),
        **errors, "reference": SELFCAL_REFERENCE,
        "n_angles": int(len(angles)), "angles": angles.tolist(),
        "mean_angle_error_deg": dtw["mean_angle_error"],
        "dtw_normalized_cost": dtw["normalized_cost"],
        "calibration_repeats": {
            "cameras_equal": repeats,
            "max_abs_camera_diff": float(np.abs(cams - cold_cams).max()),
            "cold_mean_angle_error_deg": cold_err,
            "warm_mean_angle_error_deg": dtw["mean_angle_error"]},
        "max_memory_allocated_mb": peak_mb,
        "launches_per_warm_pass": launches}})
    if prof is not None:
        emit({"selfcal_path_profile": prof})

    # the control: phase 9's strict front end on the calibrated cameras
    strict = frontend_config(strict=True)
    t0 = time.perf_counter()
    srep = run_task(RunContext(db, "selfcal", strict, device="cuda"),
                    "AnglesAndInternodes", report=False)
    torch.cuda.synchronize()
    s_s = time.perf_counter() - t0
    s_angles, _, s_dtw = frontend_angles(scan, srep, plant)
    emit({"selfcal_strict_control": {
        "s": s_s, "n_angles": int(len(s_angles)),
        "angles": s_angles.tolist(),
        "mean_angle_error_deg": s_dtw["mean_angle_error"],
        "phase_9_true_cameras_deg": 0.527}})
    need = ("mask_filter", "dilate_disk", "carve_candidates", "ray_coverage",
            "harris_response", "undistort", "count_kills", "signed_distance",
            "gradient_gaussian", "band_compact")
    ref = SELFCAL_REFERENCE
    med = errors["reprojection_px"]["median"]
    err = dtw["mean_angle_error"]
    # the quality bars first asked of this path, which the JAX package's
    # calibration misses on this scan too (SELFCAL_REFERENCE): printed
    emit({"selfcal_quality_bars": {
        "coherence >= 0.9": cal["coherence"] >= 0.9,
        "median reprojection against the true cameras below 2 px": med < 2.0,
        "mean angle error below 10 deg": err is not None and err < 10.0}})
    checks = {
        "kernels launched in the warm pass": not [
            k for k in need if launches[k] <= 0],
        "feature_ba not null": cal["feature_ba"] is not None,
        "two calibrations of the scan give equal cameras": repeats,
        "at least 55 views correct": len(correct) >= 55,
        "at least 10 angles": len(angles) >= 10,
        "mean angle error below 15 deg": err is not None and err < 15.0,
        # the port's calibration is the JAX package's on this scan
        "focal length within 0.1 % of the reference's": abs(
            cal["theta"]["f"] / ref["f"] - 1.0) < 1e-3,
        "coherence within 0.01 of the reference's": abs(
            cal["coherence"] - ref["coherence"]) < 0.01,
        "median reprojection within 1 px of the reference's":
            abs(med - ref["reprojection_median_px"]) < 1.0,
        "finite numbers": bool(np.isfinite(
            [cold_s, warm_s, peak_mb, *idle_share(prof),
             *angles, *internodes, med]).all()),
    }
    return scan, report, launches, true_cams, checks


HYBRID_TASKS = ("Undistorted", "Masks", "ModelFilesetExists",
                "Segmentation2D", "Voxels", "PointCloud",
                "SegmentedPointCloud", "OrganSegmentation",
                "AnglesAndInternodes")


def hybrid_config():
    """configs/ml_pipe_real_hybrid.toml's tasks after its calibration (no
    evaluation), on phase 11's calibration (selfcal_config's
    TurntableCalibration, complete in the DB) and phase 9's box: the
    committed segnet_real at 704x528 with resize = true (the input shrunk
    as cv2 INTER_AREA, the probabilities grown back as INTER_LINEAR)."""
    from plant3dvision_tpu_torch.runtime.config import load_toml
    toml = load_toml(ROOT / "configs" / "ml_pipe_real_hybrid.toml")
    cfg = {t: dict(toml[t]) for t in HYBRID_TASKS}
    cfg["TurntableCalibration"] = selfcal_config()["TurntableCalibration"]
    cfg["Voxels"]["bounding_box"] = FRONTEND_BBOX
    cfg["Clean"] = {"no_confirm": True}
    return cfg


def run_hybrid_pass(db, device_name):
    """Phase 11's last step: one pass of hybrid_config on phase 11's
    calibrated scan, Undistorted to AnglesAndInternodes (organ angles; the
    net was trained for the real_plant fixture, so no angle bar). Returns
    its checks."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.models.zoo import install_checkpoint
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.synth import SyntheticPlant

    assert install_checkpoint(db, model_id="segnet_real", path=ROOT /
                              "checkpoints" / "segnet_real.npz") is not None
    cfg = hybrid_config()
    ctx = RunContext(db, "selfcal", cfg, device="cuda")
    t0 = time.perf_counter()
    report = run_task(ctx, "AnglesAndInternodes", report=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scan = ctx.scan
    seg = scan.get_fileset(report["Segmentation2D"]["fileset"])
    seg_files = seg.get_files()
    png = io.read_image(seg_files[0])
    img = io.read_image(scan.get_fileset("images").get_files()[0])
    organs = [f.id for f in scan.get_fileset(
        report["OrganSegmentation"]["fileset"]).get_files()]
    angles, internodes, dtw = frontend_angles(
        scan, report, SyntheticPlant(**NORTHSTAR_PLANT))
    emit({"hybrid_pass": {
        "device": device_name, "config": "ml_pipe_real_hybrid.toml",
        "model": "segnet_real", "net_input": [cfg["Segmentation2D"]["Sx"],
                                              cfg["Segmentation2D"]["Sy"]],
        "s": wall, "task_s": {k: v["seconds"] for k, v in report.items()},
        "task_status": {k: v["status"] for k, v in report.items()},
        "segmentation_files": len(seg_files),
        "label_names": seg.get_metadata("label_names"),
        "n_organs": len(organs), "n_angles": int(len(angles)),
        "mean_angle_error_deg": dtw["mean_angle_error"]}})
    return {
        "hybrid: AnglesAndInternodes reached":
            report["AnglesAndInternodes"]["status"] == "done",
        "hybrid: the calibration reused":
            report["TurntableCalibration"]["status"] == "skipped",
        "hybrid: probabilities grown back to the image size":
            png.shape == img.shape[:2],
        "hybrid: finite numbers": bool(np.isfinite(
            [wall, *angles, *internodes]).all()),
    }


def _population(theta, scale, B, seed):
    """B CEM-like candidates around `theta`: DEFAULT_STD widths times
    `scale` on the free parameters, the first the incumbent."""
    import numpy as np
    from plant3dvision_tpu_torch.ops.selfcal import (DEFAULT_FREE,
                                                     DEFAULT_STD, THETA_NAMES)
    std = np.array([(DEFAULT_STD[n] * (theta[0] if n == "f" else 1.0)
                     if n in DEFAULT_FREE else 0.0) for n in THETA_NAMES],
                   np.float32) * scale
    c = theta[None] + std * np.random.default_rng(seed).standard_normal(
        (B, 9)).astype(np.float32)
    c[0] = theta
    return c.astype(np.float32)


def _harris_library(gray, mask, border, kappa):
    """One PyTorch chain for K13's function: rolls for the gradients,
    avg_pool2d for the 3x3 sums, max_pool2d for the suppression."""
    import torch
    import torch.nn.functional as F
    ix = (torch.roll(gray, -1, -1) - torch.roll(gray, 1, -1)) * 0.5
    iy = (torch.roll(gray, -1, -2) - torch.roll(gray, 1, -2)) * 0.5
    p = torch.stack([ix * ix, iy * iy, ix * iy], 1)
    s = F.avg_pool2d(p, 3, 1, 1)
    sxx, syy, sxy = s[:, 0], s[:, 1], s[:, 2]
    r = sxx * syy - sxy * sxy - kappa * (sxx + syy) ** 2
    rmax = F.max_pool2d(r[:, None], 3, 1, 1)[:, 0]
    V, H, W = gray.shape
    y = torch.arange(H, device=gray.device)[:, None]
    x = torch.arange(W, device=gray.device)[None, :]
    inside = ((y >= border) & (y < H - border)
              & (x >= border) & (x < W - border))
    return torch.where((r >= rmax) & mask & inside, r, -torch.inf)


def selfcal_launches(masks, poses, theta_cem, theta, jitter, hull,
                     workspace, device="cuda"):
    """Phase 12's K11b and K12 launches at phase 11's shapes. From the
    full-resolution silhouettes (V, H, W) bool numpy, the CNC poses (V, 5),
    the CEM's theta (each round's population of 48 is drawn around it), the
    polished calibration (theta and the per-view jitter (V, 3) [dpan,
    dtilt, droll] on the card), the calibrated hull's box and the
    workspace (mm): round 0 at 4 mm and 1/8 over the workspace, round 1 at
    2 mm and 1/4 over a 16-quantized crop of the hull (as the CEM's crop
    rule), the polish at 2 mm and 1/4 over the workspace (60 views x 77
    deltas against the robust hull). Returns (k11b, k12): k11b maps a
    launch (round0, round1: the population at tolerance 0; robust: the
    polish's robust hull, one candidate at tolerance 2) to carve_candidates'
    arguments; k12 maps a launch to (the k11b launch whose alive volumes it
    reads, a function of those volumes giving ray_coverage_counts'
    arguments, its number of groups)."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch.ops import carving, selfcal

    dev = torch.device(device)
    V, H, W = masks.shape
    rng = np.random.default_rng(0)

    def lowres(k):
        m_lo = selfcal._dilate1(selfcal._maxpool2d(masks, k))
        uv, ok = selfcal._sample_sil(selfcal._maxpool2d(masks, k),
                                     192 if k == 8 else 256, rng)
        return (torch.from_numpy(carving.pack_masks(m_lo)).to(dev),
                torch.from_numpy(uv).to(dev), torch.from_numpy(ok).to(dev),
                m_lo.shape[1:])

    origin0, shape0 = grid_of(workspace, 4.0)
    lo = np.array([hull[a][0] for a in "xyz"])
    n16 = np.ceil((np.floor((np.array([hull[a][1] for a in "xyz"]) - lo)
                            / 2.0) + 1) / 16).astype(int) * 16
    crop = {a: [float(lo[i]), float(lo[i] + (n16[i] - 0.5) * 2.0)]
            for i, a in enumerate("xyz")}
    origin1, shape1 = grid_of(crop, 2.0)
    poses_t = torch.from_numpy(np.asarray(poses, np.float32)).to(dev)
    k11b, k12 = {}, {}
    for rnd, (k, vs, origin, shape) in enumerate(
            ((8, 4.0, origin0, shape0), (4, 2.0, origin1, shape1))):
        packed, uv, ok, hw = lowres(k)
        pop = torch.from_numpy(_population(theta_cem, 1.0 / (1 + rnd), 48,
                                           rnd)).to(dev)
        cams = selfcal.cnc_to_cameras(poses_t, pop, np.float32(W),
                                      np.float32(H), np.float32(1.0 / k))
        k11b[f"round{rnd}"] = (packed, cams, origin, vs, shape, hw, 0)
        # K12 on the population's hulls: a group per candidate and view
        B = cams.shape[0]
        steps = int(np.ceil(np.linalg.norm(shape) * 0.75))
        cand = torch.arange(B, dtype=torch.int32, device=dev)
        view = torch.arange(V, dtype=torch.int32, device=dev)
        k12[f"cem_round{rnd}"] = (
            f"round{rnd}",
            lambda alive, c=(cams.reshape(B * V, 16), cand.repeat_interleave(
                V), view.repeat(B)), rest=(uv, ok, origin, vs, shape, steps):
            (*c, alive, *rest), B * V)
    # the polish: 60 views x 77 deltas against the robust hull of the
    # calibrated cameras
    packed, uv, ok, hw = lowres(4)
    origin, shape = grid_of(workspace, 2.0)
    cams_v = selfcal.cnc_to_cameras(
        torch.stack([poses_t[:, 0], poses_t[:, 1], poses_t[:, 2],
                     poses_t[:, 3] + jitter[:, 0],
                     poses_t[:, 4] + jitter[:, 1]], 1), theta,
        np.float32(W), np.float32(H), np.float32(0.25), droll=jitter[:, 2])
    k11b["robust"] = (packed, cams_v[None].contiguous(), origin, 2.0, shape,
                      hw, 2)
    dp = np.linspace(-1.5, 1.5, 11, dtype=np.float32)
    dt = np.linspace(-1.0, 1.0, 7, dtype=np.float32)
    deltas = torch.from_numpy(np.stack(np.meshgrid(
        dp, dt, np.zeros(1, np.float32), indexing="ij"), -1).reshape(
        -1, 3)).to(dev)
    var = selfcal._variant_cameras(poses_t, theta, jitter, deltas,
                                   np.float32(W), np.float32(H),
                                   np.float32(0.25))
    G = deltas.shape[0]
    view = torch.arange(V, dtype=torch.int32, device=dev).repeat_interleave(G)
    steps = int(np.ceil(np.linalg.norm(shape) * 0.9))
    k12["polish"] = (
        "robust",
        lambda alive: (var.reshape(V * G, 16), torch.zeros_like(view), view,
                       alive, uv, ok, origin, 2.0, shape, steps), V * G)
    return k11b, k12


def k11b_work(args, tests):
    """(bytes, operations) of a K11b launch: the masks and cameras read,
    the alive volumes written once; 24 operations a voxel-view test made
    (`tests`, the plain version's count_work)."""
    import numpy as np
    packed, cams, shape = args[0], args[1], args[4]
    return (packed.numel() + cams.numel() * 4
            + cams.shape[0] * int(np.prod(shape)), 24 * tests)


def k12_work(cargs, groups, n_valid, steps):
    """(bytes, operations) of a K12 launch: the alive volumes, cameras,
    indices, samples and counts once; ~60 operations a valid ray and ~12 a
    step walked (`steps`, the plain version's count_work)."""
    return (cargs[3].numel() + groups * (16 * 4 + 8) + cargs[4].numel() * 4
            + cargs[5].numel(), 60 * n_valid + 12 * steps)


def check_selfcal_kernels(scan, report, launches):
    """Phase 12: K11b on a round-0 and a round-1 CEM population and on the
    polish's robust hull, K12 on the polish's V x G launch and on the CEM
    populations (selfcal_launches), K8 on the keypoint masks (radius 6),
    K13 on the 60 grays in build_matches' chunks of 12, each against its
    plain version at phase 11's shapes, timed beside it (and beside a
    library call for K8 and K13)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.ops import carving, selfcal, sfmlite
    from plant3dvision_tpu_torch.ops.masks import binary_dilation, mask_filter

    dev = torch.device("cuda")
    rows = []
    cfg = selfcal_config()["TurntableCalibration"]
    files = sorted(scan.get_fileset("images").get_files(
        query=json.loads(cfg["query"])), key=lambda f: f.id)
    with ThreadPoolExecutor(8) as ex:
        imgs = torch.from_numpy(np.stack(list(ex.map(io.read_image,
                                                     files)))).to(dev)
    masks_t = mask_filter(imgs, "excess_green", (0.0, 1.0, 0.0),
                          float(cfg["mask_threshold"]), True)
    masks = masks_t.cpu().numpy()
    gray = carving.div_f32(carving.div_f32(
        imgs.to(torch.float64).sum(-1), 3.0).to(torch.float32), 255.0)
    kp = binary_dilation(masks_t, 6)
    del imgs
    V, H, W = masks.shape
    poses = np.array([f.get_metadata("approximate_pose") for f in files],
                     np.float32)
    cal = json.loads(scan.get_fileset(report["TurntableCalibration"][
        "fileset"]).get_file("calibration").read_raw())
    hull = scan.get_fileset(report["TurntableCalibration"][
        "fileset"]).get_metadata("bounding_box")
    workspace = scan.get_fileset("images").get_metadata("workspace")
    jit = torch.tensor(np.stack([cal["dpan_view"], cal["dtilt_view"],
                                 cal["droll_view"]], 1), dtype=torch.float32,
                       device=dev)
    k11b_args, k12_args = selfcal_launches(
        masks, poses, np.array([cal["silhouette_stage"]["theta"][n]
                                for n in selfcal.THETA_NAMES], np.float32),
        torch.tensor([cal["theta"][n] for n in selfcal.THETA_NAMES],
                     device=dev), jit, hull, workspace)

    k11b, alive = {}, {}
    for name, args in k11b_args.items():
        got = carving.carve_candidates(*args)
        want, tests = carving.carve_candidates_plain(*args, count_work=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"carve_candidates != plain ({name})"
        alive[name] = got
        k11b[name] = kernel_row(
            "carve_candidates", launches["carve_candidates"], 0,
            cuda_ms(lambda: carving.carve_candidates(*args)),
            cuda_ms(lambda: carving.carve_candidates_plain(*args), reps=1,
                    warmup=0),
            *k11b_work(args, tests),
            extra={"path": "selfcal", "launch": name, "shape": list(args[4]),
                   "candidates": args[1].shape[0], "views": V,
                   "max_kills": args[6], "low_res": list(args[5]),
                   "voxel_view_tests": tests, "alive": int(got.sum())})
    modes = {}
    for name, (src, make, groups) in k12_args.items():
        cargs = make(alive[src])
        got = selfcal.ray_coverage_counts(*cargs)
        *want, work = selfcal.ray_coverage_counts_plain(*cargs,
                                                        count_work=True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            f"ray_coverage != plain ({name})"
        n_valid = int(got[1].sum())
        modes[name] = kernel_row(
            "ray_coverage", launches["ray_coverage"], 0,
            cuda_ms(lambda: selfcal.ray_coverage_counts(*cargs)),
            cuda_ms(lambda: selfcal.ray_coverage_counts_plain(*cargs),
                    reps=1, warmup=0),
            *k12_work(cargs, groups, n_valid, work),
            extra={"path": "selfcal", "launch": name, "groups": groups,
                   "volumes": cargs[3].shape[0], "shape": list(cargs[8]),
                   "voxel_size": cargs[7], "n_steps": cargs[9],
                   "valid_rays": n_valid, "covered_rays": int(got[0].sum()),
                   "steps_walked": work})
    rows.append(dict(k11b["round0"], launches_by={
        m: {k: x[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "shape", "candidates", "max_kills",
                              "voxel_view_tests", "alive")}
        for m, x in k11b.items()}))
    rows.append(dict(modes["polish"], launches_by={
        m: {k: x[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "groups", "steps_walked")}
        for m, x in modes.items()}))
    # K8: the keypoint masks' dilation (radius 6; the Masks task's radius 3
    # is phase 10's row)
    rows.append(dilation_row(masks_t, 6, launches["dilate_disk"], {
        "path": "selfcal", "launches_counted_in": "calibrated warm pass "
        "(the Masks task at radius 3, the keypoint masks at radius 6)"}))

    # K13: the 60 grays in chunks of 12, against the plain version
    n_cand = 0
    for c0 in range(0, V, 12):
        g, m = gray[c0:c0 + 12].contiguous(), kp[c0:c0 + 12].contiguous()
        got = sfmlite.harris_response(g, m)
        want = sfmlite.harris_response_plain(g, m)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"harris_response != plain ({c0})"
        n_cand += int(torch.isfinite(got).sum())
    g, m = gray[:12].contiguous(), kp[:12].contiguous()
    lib = _harris_library(g, m, 16, 0.06)
    npx = g.numel()
    # harris_keypoints' band selection (a stable sort of each band), timed
    # beside K13 on the same chunk: the whole call and the sort alone
    r = sfmlite.harris_response(g, m)
    hb = -(-H // 6)
    rb = torch.nn.functional.pad(r, (0, 0, 0, 6 * hb - H),
                                 value=-torch.inf).reshape(12, 6, hb * W)
    selection = {
        "keypoints_ms": cuda_ms(lambda: sfmlite.harris_keypoints(g, m)),
        "band_sort_ms": cuda_ms(lambda: torch.sort(
            rb, dim=-1, descending=True, stable=True)),
        "bands": 6, "values_a_band": hb * W}
    del r, rb
    rows.append(kernel_row(
        "harris_response", launches["harris_response"], 0.0,
        cuda_ms(lambda: sfmlite.harris_response(g, m)),
        cuda_ms(lambda: sfmlite.harris_response_plain(g, m), reps=3,
                warmup=1),
        9 * npx, 45 * npx,
        library=cuda_ms(lambda: _harris_library(g, m, 16, 0.06)),
        extra={"path": "selfcal", "chunk": list(g.shape),
               "chunks": -(-V // 12), "band_selection": selection,
               "candidates_60_views": n_cand,
               "library_candidates_differing": int(
                   (torch.isfinite(lib) != torch.isfinite(
                       sfmlite.harris_response(g, m))).sum())}))
    emit({"selfcal_kernel_checks": {
        "masks": list(masks.shape),
        **{f"{m}_grid": list(a[4]) for m, a in k11b_args.items()}}})
    return rows


def fim_config():
    """Phase 13: phase 9's strict front end (frontend_config(strict=True):
    Voxels at 0.5 mm into FRONTEND_BBOX) with the eikonal skeleton,
    CurveSkeleton.method = "fim" at bin_size 4 (voxels: 2 mm, the strict
    control's bin)."""
    cfg = frontend_config(strict=True)
    cfg["CurveSkeleton"].update(method="fim", bin_size=4.0)
    return cfg


def fim_inputs(scan, report, cfg):
    """The eikonal solve's inputs as CurveSkeleton(method="fim") forms them
    from the pass's Voxels volume: the occupied voxels and their root
    plane, on the card."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch.tasks.proc3d import root_plane_seeds
    vol = np.load(scan.get_fileset(report["Voxels"]["fileset"])
                  .get_files()[0].path())["volume"]
    mask = torch.from_numpy(vol).cuda() > 0.5
    skel = cfg["CurveSkeleton"]
    return mask, root_plane_seeds(mask, int(skel.get("stem_axis", 2)),
                                  bool(skel.get("stem_axis_inverted")))


def run_fim_path(db, device_name):
    """Phase 13: the eikonal skeleton (fim_config) on phase 9's 60-view
    1440x1080 distorted scan (written here if phase 9 did not run): one
    cold pass, one warm pass after Clean (profiled too with --profile),
    each from Undistorted to AnglesAndInternodes; then the solve alone on the pass's
    volume (the sweep count, ms per sweep and in total) and the host
    clustering seconds. Returns the scan, the warm pass's report, launches
    and checks, which main() asserts after phase 14."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import eikonal
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.synth import SyntheticPlant
    from plant3dvision_tpu_torch.tasks.proc3d import distance_bin_clusters

    V, W, H = 60, 1440, 1080
    plant = SyntheticPlant(**NORTHSTAR_PLANT)
    gen_s = 0.0
    if db.get_scan("frontend") is None:
        t0 = time.perf_counter()
        write_distorted_scan(db, "frontend", plant, V, W, H, 1400.0)
        gen_s = time.perf_counter() - t0
    cfg = fim_config()
    run_task(RunContext(db, "frontend", cfg, device="cuda"), "Clean",
             report=False)

    ctx = RunContext(db, "frontend", cfg, device="cuda")
    t0 = time.perf_counter()
    run_task(ctx, "AnglesAndInternodes", report=False)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    run_task(ctx, "Clean", report=False)
    ctx = RunContext(db, "frontend", cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    report, warm_s, ctx, prof = warm_pass(ctx)
    launches = dict(kernels.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    scan = ctx.scan
    skel = json.loads(scan.get_fileset(report["CurveSkeleton"]["fileset"])
                      .get_files()[0].read_raw())
    angles, internodes, dtw = frontend_angles(scan, report, plant)

    mask, seeds = fim_inputs(scan, report, cfg)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    dist, sweeps = eikonal.geodesic_distance(mask, seeds, return_sweeps=True)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    solve_launches = kernels.LAUNCHES["eikonal_sweep"]
    _, syncs = host_syncs(lambda: eikonal.geodesic_distance(mask, seeds))
    mask_np, dist_np = mask.cpu().numpy(), dist.cpu().numpy()
    t0 = time.perf_counter()
    centers, edges = distance_bin_clusters(mask_np, dist_np, 4.0)
    clusters_s = time.perf_counter() - t0
    stages = report["CurveSkeleton"].get("stages", {})
    emit({"fim_path": {
        "device": device_name, "n_views": V, "image": [W, H],
        "voxel_mm": cfg["Voxels"]["voxel_size"], "shape": list(mask.shape),
        "bin_size_voxels": cfg["CurveSkeleton"]["bin_size"],
        "mask_voxels": int(mask.sum()), "seed_voxels": int(seeds.sum()),
        "reached_voxels": int((dist < 1e9).sum()),
        "scan_generation_s": gen_s, "cold_s": cold_s, "warm_s": warm_s,
        "task_s": {k: v["seconds"] for k, v in report.items()},
        "curve_skeleton_stages_s": stages,
        "sweeps": sweeps, "solve_ms": solve_s * 1e3,
        "ms_per_sweep": solve_s * 1e3 / max(sweeps, 1),
        "active_voxels": int((mask & ~seeds).sum()),
        "solve_launches": solve_launches,
        "solve_host_syncs": syncs,
        "host_clusters_s": clusters_s,
        "skeleton_nodes": len(skel["points"]),
        "skeleton_edges": len(skel["lines"]),
        "n_angles": int(len(angles)), "angles": angles.tolist(),
        "mean_angle_error_deg": dtw["mean_angle_error"],
        "dtw_normalized_cost": dtw["normalized_cost"],
        "max_memory_allocated_mb": peak_mb,
        "launches_per_warm_pass": launches}})
    if prof is not None:
        emit({"fim_path_profile": prof})
    need = ("eikonal_sweep", "undistort", "mask_filter", "signed_distance",
            "gradient_gaussian", "band_compact")
    n_nodes = len(skel["points"])
    checks = {
        "kernels launched in the warm pass": not [
            k for k in need if launches[k] <= 0],
        "AnglesAndInternodes reached": report["AnglesAndInternodes"][
            "status"] == "done",
        "the skeleton is a tree of at least 20 nodes":
            n_nodes >= 20 and len(skel["lines"]) == n_nodes - 1,
        "the task's skeleton has the solve's clusters": n_nodes == len(
            centers),
        "one K14 launch a solve": 0 < sweeps and solve_launches == 1
            and launches["eikonal_sweep"] == 1,
        "one host read a solve (the sweep count, after the compaction's "
        "nonzero)": syncs == 2,
        "finite numbers": bool(np.isfinite(
            [cold_s, warm_s, solve_s, clusters_s, peak_mb,
             *idle_share(prof), *np.ravel(skel["points"]),
             *angles, *internodes]).all()),
    }
    return scan, report, launches, checks


def check_fim_kernels(scan, report, launches):
    """Phase 14: K14 (the whole solve on phase 13's volume, 301x301x561)
    against its plain version, bit for bit with the same sweep count; K15
    on the solve's flow and where(mask, d, 0) from the skeleton's leaf
    nodes (index coordinates), 2000 steps of 0.5, votes equal."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import eikonal
    from plant3dvision_tpu_torch.ops.eikonal import (
        geodesic_distance, geodesic_distance_plain, gradient_flow)
    from plant3dvision_tpu_torch.ops.geodesics import (trace_geodesics,
                                                       trace_geodesics_plain)

    cfg = fim_config()
    mask, seeds = fim_inputs(scan, report, cfg)
    k, nk = geodesic_distance(mask, seeds, return_sweeps=True)
    t0 = time.perf_counter()
    p, np_ = geodesic_distance_plain(mask, seeds, return_sweeps=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert nk == np_, f"K14 stopped at sweep {nk}, its plain version {np_}"
    diff = int((k != p).sum())
    assert diff == 0, f"K14 != plain on {diff} voxels"
    ms = cuda_ms(lambda: geodesic_distance(mask, seeds), reps=5, warmup=1)
    compaction_ms = cuda_ms(lambda: eikonal.compact_neighbors(mask, seeds))
    nvox = mask.numel()
    active = int((mask & ~seeds).sum())
    # the floor: the sweeps times one empty grid barrier over the blocks
    # the solve takes
    so, dev = kernels.lib(), mask.device
    iters = 10000

    def barriers(n):
        kernels.check("grid_barriers", so.p3d_grid_barriers(
            active, n, kernels.stream_ptr(dev)))

    barrier_us = (cuda_ms(lambda: barriers(iters + 1))
                  - cuda_ms(lambda: barriers(1))) * 1e3 / iters
    # bytes: mask and seeds read once, the distances written once;
    # operations: ~45 f32 operations a sweep for each voxel it updates
    rows = [kernel_row(
        "eikonal_sweep", launches["eikonal_sweep"], 0.0, ms, plain_ms,
        2 * nvox + 4 * nvox, 45 * active * nk,
        extra={"path": "fim", "shape": list(mask.shape), "sweeps": nk,
               "ms_per_sweep": ms / nk, "active_voxels": active,
               "compaction_ms": compaction_ms,
               "barrier_us": barrier_us, "floor_ms": nk * barrier_us / 1e3,
               "launches_per_solve": launches["eikonal_sweep"]})]

    flow = gradient_flow(k, mask)
    values = torch.where(mask, k, 0.0)
    skel = json.loads(scan.get_fileset(report["CurveSkeleton"]["fileset"])
                      .get_files()[0].read_raw())
    vfile = scan.get_fileset(report["Voxels"]["fileset"]).get_files()[0]
    origin = np.asarray(vfile.get_metadata("origin"))
    vs = float(vfile.get_metadata("voxel_size"))
    lines = np.asarray(skel["lines"]).reshape(-1, 2)
    deg = np.bincount(lines.ravel(), minlength=len(skel["points"]))
    leaves = (np.asarray(skel["points"])[deg == 1] - origin) / vs
    tips = torch.from_numpy(leaves.astype(np.float32)).cuda()
    # K15's own run: the counts set to 0, one call (no task calls it)
    kernels.reset_launches()
    vk = trace_geodesics(flow, values, tips, step=0.5, n_steps=2000)
    trace_launches = kernels.LAUNCHES["trace_geodesics"]
    t0 = time.perf_counter()
    vp, psteps = trace_geodesics_plain(flow, values, tips, step=0.5,
                                       n_steps=2000, return_steps=True)
    torch.cuda.synchronize()
    tplain_ms = (time.perf_counter() - t0) * 1e3
    vdiff = int((vk - vp).abs().sum())
    assert vdiff == 0, f"K15 votes differ from the plain version's by {vdiff}"
    n_steps_all, longest = int(psteps.sum()), int(psteps.max())

    def trace():
        return trace_geodesics(flow, values, tips, step=0.5, n_steps=2000)
    tms = cuda_ms(trace)
    by_kernel = device_ms_by_kernel(trace)
    trace_kernel_ms = next((v for k, v in (by_kernel or {}).items()
                            if "trace_kernel" in k), None)
    zero_ms = cuda_ms(lambda: torch.zeros(values.shape, dtype=torch.int32,
                                          device=dev))
    # the floor: the longest walk's steps, each one warp's dependent step
    # (two trilinear samples) with every read an L1 hit
    sink = torch.zeros(1, device=dev)
    scratch = torch.zeros(4 * 4096, device=dev)
    scratch[3 * 4096:] = 1.0

    def floor_steps(n):
        kernels.check("trace_step_floor", so.p3d_trace_step_floor(
            n, scratch.data_ptr(), sink.data_ptr(),
            kernels.stream_ptr(dev)))

    step_us = (cuda_ms(lambda: floor_steps(iters + 1))
               - cuda_ms(lambda: floor_steps(1))) * 1e3 / iters
    votes = int(vk.sum())
    # bytes: the tips read once, the dense votes written once, and each
    # step's two trilinear samples, 8 corners of the flow (12 B) and of the
    # values (4 B); operations: ~130 a step (the samples, the step, the
    # clip, the tests)
    rows.append(kernel_row(
        "trace_geodesics", trace_launches, 0, tms, tplain_ms,
        tips.numel() * 4 + 4 * nvox + 8 * 16 * n_steps_all,
        130 * n_steps_all, kernel_ms=trace_kernel_ms,
        extra={"path": "phase 14 only (no task calls it)",
               "particles": len(leaves), "votes": votes,
               "n_steps": 2000, "steps": n_steps_all,
               "longest_steps": longest,
               "mean_steps": n_steps_all / max(len(leaves), 1),
               "zeroing_ms": zero_ms,
               "device_ms_by_kernel": by_kernel,
               "step_floor_us": step_us,
               "floor_ms": longest * step_us / 1e3}))
    emit({"fim_kernel_checks": {"grid": list(mask.shape), "sweeps": nk,
                                "particles": len(leaves), "votes": votes}})
    return rows


#: phase 15: live_carve's arguments for phase 2's scan (its masks as
#: FusedCarving reads them in geom_pipe_fast.toml: the first channel above
#: 0.3), previews every 50 views; the copy thread's pause between views
LIVE_ARGS = ("--voxel-size", "1.0", "--filter", "linear", "--coefs", "1,0,0",
             "--threshold", "0.3", "--every", "50", "--idle-stop", "3",
             "--poll", "0.2")
LIVE_PACE_S = 0.02


def run_live_path(db, device_name):
    """Phase 15: live carving. Replays phase 2's 300-view 1440x1080 scan
    (written here if phase 2 did not run) into a fresh scan directory, a
    copy thread writing each view's metadata and then its image (renamed
    into place whole) in file order, while `python -m
    plant3dvision_tpu_torch.live_carve` watches it in a subprocess (previews
    every 50 views, a 3 s idle stop, --report). Checks that the final volume
    is K1's batch carve of the same 300 masks and carve_plain's on the card,
    and prints the seconds per preview, the K1 and K10 launches, the views
    ingested per second and the device's idle share (the tool's report)."""
    import os
    import threading

    import numpy as np
    import torch
    from plant3dvision_tpu_torch.live_carve import read_rgb
    from plant3dvision_tpu_torch.ops.carving import (camera_from_metadata,
                                                     carve, carve_plain)
    from plant3dvision_tpu_torch.ops.masks import compute_masks_batch
    from plant3dvision_tpu_torch.ops.streaming import pack_mask_row
    from plant3dvision_tpu_torch.synth import SyntheticPlant, generate_scan

    gen_s = 0.0
    if db.get_scan("northstar") is None:
        t0 = time.perf_counter()
        generate_scan(db, "northstar", n_views=300, width=1440, height=1080,
                      f=1400.0, plant=SyntheticPlant(**NORTHSTAR_PLANT),
                      render_step=0.5)
        gen_s = time.perf_counter() - t0
    src = db.get_scan("northstar")
    files = src.get_fileset("images").get_files()
    bbox = src.get_metadata("bounding_box")
    live = ROOT / ".smoke" / "live"
    shutil.rmtree(live, ignore_errors=True)
    scan_dir = live / "replay"
    (scan_dir / "images").mkdir(parents=True)
    (scan_dir / "metadata" / "images").mkdir(parents=True)
    (live / "romidb").touch()
    out, rep_path = live / "live_volume.npz", live / "report.json"
    bbox_arg = ",".join(str(v) for ax in "xyz" for v in bbox[ax])
    cmd = [sys.executable, "-m", "plant3dvision_tpu_torch.live_carve",
           str(scan_dir), f"--bbox={bbox_arg}", *LIVE_ARGS, "--out", str(out),
           "--device", "cuda", "--report", str(rep_path)]

    def writer():
        for f in files:
            name = f.path().name
            shutil.copy(src.path() / "metadata" / "images" / f"{f.id}.json",
                        scan_dir / "metadata" / "images" / f"{f.id}.json")
            tmp = scan_dir / "images" / (name + ".part")
            shutil.copy(f.path(), tmp)
            os.replace(tmp, scan_dir / "images" / name)
            time.sleep(LIVE_PACE_S)

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:             # the tool is up and watching
            lines.append(line.rstrip())
            if line.startswith("live_carve: grid"):
                break
        th = threading.Thread(target=writer)
        th.start()
        th.join()
        rest, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    tool_s = time.perf_counter() - t0
    lines += rest.splitlines()
    assert proc.returncode == 0, "live_carve failed:\n" + "\n".join(
        lines[-40:])
    rep = json.loads(rep_path.read_text())
    meta = json.loads(out.with_suffix(".json").read_text())
    volume = np.load(out)["volume"]

    # the batch oracle: the same 300 masks, K1 and carve_plain on the card
    dev = torch.device("cuda")
    rows, cams, hw = [], [], None
    for f in files:
        img = torch.from_numpy(read_rgb(f.path())).to(dev)
        m = compute_masks_batch(img[None], filter_type="linear",
                                coefs=(1.0, 0.0, 0.0), threshold=0.3)[0]
        hw = tuple(m.shape)
        rows.append(pack_mask_row(m))
        cams.append(camera_from_metadata(f.get_metadata("camera")))
    packed = torch.stack(rows)
    cams_t = torch.from_numpy(np.stack(cams)).to(dev)
    valid = torch.ones(len(files), dtype=torch.bool, device=dev)
    origin, shape = grid_of(bbox, 1.0)
    vol_k = carve(packed, cams_t, valid, origin, 1.0, shape, hw)
    vol_p = carve_plain(packed, cams_t, valid, origin, 1.0, shape, hw)
    torch.cuda.synchronize()
    equal_k1 = bool(np.array_equal(volume, (vol_k == 1).cpu().numpy()))
    equal_plain = bool(torch.equal(vol_k, vol_p))
    launches = rep["launches"]
    previews = rep["previews"]
    emit({"live_path": {
        "device": device_name, "n_views": meta["n_views"],
        "image": [1440, 1080], "voxel_mm": 1.0, "grid": list(shape),
        "scan_generation_s": gen_s, "pace_s": LIVE_PACE_S,
        "state": meta["state"],
        "previews": previews, "s_per_preview": [p["s"] for p in previews],
        "views_per_s": rep["views_per_s"], "ingest_s": rep["ingest_s"],
        "tool_wall_s": rep["wall_s"], "subprocess_s": tool_s,
        "launches": {k: launches[k] for k in ("carve", "mask_filter",
                                              "dilate_disk")},
        "device_busy_s": rep["device_busy_s"],
        "device_idle_share": rep["device_idle_share"],
        "alive_voxels": int(volume.sum()),
        "final_equals_batch_k1": equal_k1,
        "k1_equals_carve_plain": equal_plain}})
    assert meta["n_views"] == len(files) == 300 and meta["state"] == "final"
    assert equal_k1, "the live volume is not the batch carve"
    assert equal_plain, "K1 differs from carve_plain on the 300 views"
    assert launches["carve"] == len(previews) >= 2, launches
    assert launches["mask_filter"] == 300, launches
    assert volume.sum() > 1000, "no plant carved"


#: H100 SXM dense int8 tensor-core peak (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12


def int8_bound_ms(n_bytes, macs):
    """K16's bound: the bytes over the memory rate or 2 operations a MAC
    over the int8 tensor-core peak, the larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library_int8_conv(x, qw, bias, stride, pads):
    """The library chain for K16's whole function, in PyTorch calls: the
    activation's absmax, division, round and clamp to int8, the SAME pads,
    im2col (a strided view copied into (B*OH*OW, kh*kw*Cp), the depth
    padded to a multiple of 8), one torch._int_mm (cuBLASLt int8) against
    the weights (N padded to a multiple of 8), then the epilogue. qw: the
    plain version's weight (`quantize_weight_plain`, which keeps q)."""
    import torch
    import torch.nn.functional as F
    from plant3dvision_tpu_torch.models import quant
    from plant3dvision_tpu_torch.ops.carving import fma_f32
    B, C, H, W = x.shape
    K, kh, kw, Cp = qw.q.shape
    (pt, pb), (pl, pr) = pads
    s = int(stride)
    xf = x.float()
    xmax = xf.abs().amax()
    sx = torch.clamp(xmax, min=quant.X_FLOOR) * quant.INV127
    xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
    xq = F.pad(xq.permute(0, 2, 3, 1), (0, Cp - C, pl, pr, pt, pb))
    Hp, Wp = H + pt + pb, W + pl + pr
    OH, OW = (Hp - kh) // s + 1, (Wp - kw) // s + 1
    cols = xq.contiguous().as_strided(
        (B, OH, OW, kh, kw, Cp),
        (Hp * Wp * Cp, s * Wp * Cp, s * Cp, Wp * Cp, Cp, 1))
    depth = kh * kw * Cp
    pad_k, pad_n = (-depth) % 8, (-K) % 8
    a = F.pad(cols.reshape(B * OH * OW, depth), (0, pad_k))
    b = F.pad(qw.q.reshape(K, depth), (0, pad_k, 0, pad_n)).t()
    acc = torch._int_mm(a, b)[:, :K].to(torch.float32)
    scale = torch.clamp(qw.amax, min=quant.W_FLOOR) * (
        torch.clamp(xmax, min=quant.X_FLOOR) * quant.INV127_SQ)
    y = fma_f32(acc, scale, bias.float()) if bias is not None else acc * scale
    return y.view(B, OH, OW, K).permute(0, 3, 1, 2)


def _library_quantize_weight(w):
    """One PyTorch chain for K16's weight quantise: each output channel's
    absmax over (Cin, kh, kw), its scale (the floored absmax / 127 as the
    lane's reciprocal product), round, clamp, and the permute + pad into
    the (K, kh, kw, Cp) layout the conv's packing starts from."""
    import torch
    import torch.nn.functional as F
    from plant3dvision_tpu_torch.models import quant
    wf = w.float()
    amax = wf.abs().amax(dim=(1, 2, 3))
    s = torch.clamp(amax, min=quant.W_FLOOR) * quant.INV127
    q = torch.round(wf / s.view(-1, 1, 1, 1)).clamp(-127.0, 127.0)
    q = F.pad(q.permute(0, 2, 3, 1), (0, quant._cp(w.shape[1]) - w.shape[1]))
    return q.to(torch.int8), amax


def model_weight_quantise(model):
    """Phase 16's K16w check on one net: all its compute weights, cast as
    `int8_lane` casts them, through `quantize_weights` (one launch): amax
    and packed (the kernel's one copy of q) bit for bit against the plain
    version (`quantize_weight_plain` + `pack_weight`) and the library
    chain's q packed; the call timed beside the plain version and the
    library chain (which stops at q, unpacked), each over all the weights.
    The bound counts the weights read, one int8 copy (the packed layout
    with its pads) and the amaxes written."""
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.models import quant
    ws = [c.weight.detach().to(model.dtype)
          for c in quant.compute_convs(model)]
    before = kernels.LAUNCHES["int8_quantize"]
    qws = quant.quantize_weights(ws)
    per_call = kernels.LAUNCHES["int8_quantize"] - before
    torch.cuda.synchronize()
    for w, qw in zip(ws, qws):
        pw = quant.quantize_weight_plain(w)
        assert torch.equal(qw.amax, pw.amax), \
            f"K16w amax != plain at {tuple(w.shape)}"
        assert torch.equal(qw.packed, quant.pack_weight(pw.q, qw.plan)), \
            f"K16w packed != pack_weight at {tuple(w.shape)}"
        assert torch.equal(quant.pack_weight(_library_quantize_weight(w)[0],
                                             qw.plan), qw.packed), \
            f"K16w's library chain != the kernel at {tuple(w.shape)}"
    del qws

    def plain():
        out = []
        for w in ws:
            pw = quant.quantize_weight_plain(w)
            out.append((pw, quant.pack_weight(pw.q,
                                              quant.conv_plan(*pw.q.shape))))
        return out

    w_bytes = sum(w.numel() * w.element_size() for w in ws)
    a_bytes = sum(4 * w.shape[0] for w in ws)
    p_bytes = sum(sl.plan.n_blocks * sl.plan.nch * sl.plan.nt * sl.plan.dc
                  for sl in quant.weight_arena(tuple(
                      tuple(w.shape) for w in ws)).slots)
    ops = 4 * sum(w.numel() for w in ws)
    b, by = bound_ms(w_bytes + p_bytes + a_bytes, ops)
    return {"weights": len(ws), "launches_a_call": per_call,
            "ms": cuda_ms(lambda: quant.quantize_weights(ws)),
            "plain_ms": cuda_ms(plain, reps=3, warmup=1),
            "library_ms": cuda_ms(lambda: [_library_quantize_weight(w)
                                           for w in ws]),
            "bound_ms": b, "bound_by": by}


def _conv_inputs(model, batch):
    """One int8-lane forward of `batch` (uint8 NHWC on the card) with a
    hook on every compute conv: {shape key: [input in the conv's dtype,
    conv, count]} per distinct (cin, cout, k, stride, H, W)."""
    import torch
    from plant3dvision_tpu_torch.models import quant
    from plant3dvision_tpu_torch.models.unet import forward_probs
    caps, hooks = {}, []

    def hook(conv, args):
        x = args[0]
        key = (x.shape[1], conv.weight.shape[0], conv.k, conv.stride,
               x.shape[2], x.shape[3])
        if key in caps:
            caps[key][2] += 1
        else:
            caps[key] = [x.detach().to(model.dtype).contiguous(), conv, 1]

    for c in quant.compute_convs(model):
        hooks.append(c.register_forward_pre_hook(hook))
    try:
        with quant.int8_lane(model), torch.no_grad():
            forward_probs(model, batch)
    finally:
        for h in hooks:
            h.remove()
    return caps


def check_int8_shapes(net, model, batch, batches_in_pass):
    """Phase 16's K16 checks on one net: every distinct conv shape of a
    forward of `batch`, kernel against plain (bit for bit; and the weight
    quantisation), each timed beside the plain version, the library chain
    (`_library_int8_conv`) and the bf16 cuDNN conv: the whole function
    (absmax + conv launch) and each launch alone (the weight quantisation
    is timed for all the net's weights at once, `model_weight_quantise`).
    Returns (per-shape entries, the net's sums over one forward)."""
    import torch
    import torch.nn.functional as F
    from plant3dvision_tpu_torch.models import quant
    from plant3dvision_tpu_torch.models.segnet import _same_pads
    caps = _conv_inputs(model, batch)
    shapes, tot = [], {}
    for key, (x, conv, n) in sorted(caps.items()):
        cin, cout, k, s, H, W = key
        pads = (_same_pads(H, k, s), _same_pads(W, k, s))
        out_hw = (quant.out_size(H, k, s, *pads[0]),
                  quant.out_size(W, k, s, *pads[1]))
        w = conv.weight.detach().to(model.dtype)
        b = conv.bias.detach().to(model.dtype)
        qw, pw = quant.quantize_weight(w), quant.quantize_weight_plain(w)
        got = quant.int8_conv(x, qw, b, s, pads)
        want = quant.int8_conv_plain(x, pw, b, s, pads)
        lib_equal = bool(torch.equal(
            _library_int8_conv(x, pw, b, s, pads), got))
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        w_equal = bool(torch.equal(qw.packed,
                                   quant.pack_weight(pw.q, qw.plan))
                       and torch.equal(qw.amax, pw.amax))
        wl_equal = bool(torch.equal(quant.pack_weight(
            _library_quantize_weight(w)[0], qw.plan), qw.packed))
        del got, want
        b32 = b.float()
        xmax = quant.activation_absmax(x)
        fn_ms = cuda_ms(lambda: quant.int8_conv(x, qw, b, s, pads))
        a_ms = cuda_ms(lambda: quant.activation_absmax(x))
        c_ms = cuda_ms(lambda: quant.conv_fused(x, xmax, qw, b32, s, pads))
        a_plain = cuda_ms(lambda: quant._quantize_plain(
            x, quant.X_FLOOR, per_group=False)[1])
        a_lib = cuda_ms(lambda: torch.linalg.vector_norm(x, float("inf")))
        plain_ms = cuda_ms(lambda: quant.int8_conv_plain(x, pw, b, s, pads),
                           reps=3, warmup=1)
        lib_ms = cuda_ms(lambda: _library_int8_conv(x, pw, b, s, pads),
                         reps=3, warmup=1)
        wb = conv.weight.detach().to(torch.bfloat16)
        xb = F.pad(x.to(torch.bfloat16), (pads[1][0], pads[1][1],
                                          pads[0][0], pads[0][1]))
        bf16_ms = cuda_ms(lambda: F.conv2d(xb, wb, stride=s), reps=3,
                          warmup=1)
        B = x.shape[0]
        macs = B * out_hw[0] * out_hw[1] * cout * cin * k * k
        x_bytes = x.numel() * x.element_size()
        # the function: the activation read once, the int8 weights and
        # their scales, the bias, the float32 output written once
        fn_bytes = x_bytes + cout * cin * k * k + cout * 8 + \
            B * cout * out_hw[0] * out_hw[1] * 4
        fb, fby = int8_bound_ms(fn_bytes, macs)
        ab, _ = bound_ms(x_bytes, x.numel())
        p = qw.plan
        e = {"net": net, "cin": cin, "cout": cout, "k": k, "stride": s,
             "in_hw": [H, W], "batch": B, "convs": n,
             "launches_in_pass": n * batches_in_pass,
             "plan": {"nt": p.nt, "cc": p.cc, "chunks": p.nch, "dc": p.dc},
             "bit_equal": equal, "weights_equal": w_equal,
             "library_equal": lib_equal,
             "weight_library_equal": wl_equal, "function_ms": fn_ms,
             "function_bound_ms": fb, "function_bound_by": fby,
             "absmax_ms": a_ms, "conv_launch_ms": c_ms,
             "plain_ms": plain_ms,
             "library_ms": lib_ms, "bf16_cudnn_ms": bf16_ms,
             "gmac": macs / 1e9, "tmac_per_s": macs / fn_ms / 1e9}
        shapes.append(e)
        # the forward's sums: each shape as often as the net has it
        for name, val in (("fn", fn_ms), ("fb", fb), ("a", a_ms), ("ab", ab),
                          ("a_plain", a_plain), ("a_lib", a_lib),
                          ("c", c_ms), ("plain", plain_ms),
                          ("lib", lib_ms), ("bf16", bf16_ms),
                          ("bytes", fn_bytes), ("macs", macs),
                          ("convs", 1), ("launches", batches_in_pass)):
            tot[name] = tot.get(name, 0) + n * val
        del xmax, x
    return shapes, tot


def run_int8_path(db, device_name, bf16_pass):
    """Phase 16: the int8 serving lane. Phase 7's separate-task route on
    phase 5's scan with Segmentation2D(conv_mode="int8") (batches of 32, as
    phase 7's): one pass after Clean, to the angles (no angle bar). Prints
    the pass and Segmentation2D seconds beside phase 7's bf16 pass
    (`bf16_pass`: its seconds and report, None if phase 7 did not run), both
    lanes' segmentation_inference seconds over the 126 views and their
    argmax agreement. Then K16 at every conv shape of unet_seg (the pass's
    batch of 32) and tpusegnet_seg (one image) at 896x896: kernel against
    plain, bit for bit, with ms, plain ms, library ms, launches in the pass
    and the bound. Returns the kernel rows."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.evaluation import align_sequences
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.models import checkpoint, quant
    from plant3dvision_tpu_torch.models.unet import segmentation_inference
    from plant3dvision_tpu_torch.models.zoo import (DEFAULT_CHECKPOINT,
                                                    TPUSEGNET_CHECKPOINT)
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.synth_photo import ProceduralArabidopsis

    plant = ProceduralArabidopsis(seed=1)
    cfg = separate_config(conv_mode="int8")
    run_task(RunContext(db, "ml_northstar", cfg, device="cuda"), "Clean",
             report=False)
    ctx = RunContext(db, "ml_northstar", cfg, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    report = run_task(ctx, "AnglesAndInternodes", report=False)
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    scan = ctx.scan
    out = json.loads(scan.get_fileset(report["AnglesAndInternodes"][
        "fileset"]).get_file("AnglesAndInternodes").read_raw())
    angles = np.asarray(out["angles"], float)
    dtw = align_sequences(angles.tolist(), out["internodes"],
                          np.degrees(plant.gt_angles).tolist(),
                          np.asarray(plant.gt_internodes, float).tolist())

    # both lanes over the 126 views, as Segmentation2D runs them
    dev = torch.device("cuda")
    files = scan.get_fileset("images").get_files()
    with ThreadPoolExecutor(8) as ex:
        imgs = np.stack(list(ex.map(lambda f: io.read_image(f)[..., :3],
                                    files)))

    def load(path):
        params, config = checkpoint.params_from_npz_bytes(path.read_bytes())
        m = checkpoint.model_from_config(config)
        m.load_state_dict(checkpoint.state_dict_from_flax(
            checkpoint._upcast_f16(params)))
        return m.to(dev, torch.bfloat16).eval()

    unet = load(DEFAULT_CHECKPOINT)
    lanes = {}
    for mode in ("bf16", "int8"):
        segmentation_inference(unet, imgs[:ML_BATCH], batch_size=ML_BATCH,
                               conv_mode=mode, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = segmentation_inference(unet, imgs, batch_size=ML_BATCH,
                                   conv_mode=mode, device=dev)
        torch.cuda.synchronize()
        lanes[mode] = (time.perf_counter() - t0, p.argmax(1))
        del p
    agree = float((lanes["int8"][1] == lanes["bf16"][1]).float().mean())
    n_batches = -(-len(files) // ML_BATCH)

    shapes_u, tot_u = check_int8_shapes(
        "unet_seg", unet, torch.from_numpy(imgs[:ML_BATCH]).to(dev),
        n_batches)
    seg = load(TPUSEGNET_CHECKPOINT)
    shapes_s, tot_s = check_int8_shapes(
        "tpusegnet_seg", seg, torch.from_numpy(imgs[:1]).to(dev), 0)
    emit({"int8_conv_shapes": shapes_u + shapes_s,
          "int8_ops_per_s": INT8_OPS_PER_S})
    wq = {"unet_seg": model_weight_quantise(unet),
          "tpusegnet_seg": model_weight_quantise(seg)}
    emit({"int8_weight_quantise": wq})

    seg_task = report["Segmentation2D"]["seconds"]
    res = {"device": device_name, "n_views": len(files),
           "image": [ML_SIZE, ML_SIZE], "batch": ML_BATCH,
           "model": "unet_seg", "pass_s": pass_s,
           "task_s": {k: v["seconds"] for k, v in report.items()},
           "segmentation2d_s": seg_task,
           "bf16_pass_s": bf16_pass[0] if bf16_pass else None,
           "bf16_segmentation2d_s": (bf16_pass[1]["Segmentation2D"]["seconds"]
                                     if bf16_pass else None),
           "inference_s": {m: v[0] for m, v in lanes.items()},
           "argmax_agreement_int8_vs_bf16": agree,
           "n_angles": int(len(angles)), "n_gt": int(len(plant.gt_angles)),
           "mean_angle_error_deg": dtw["mean_angle_error"],
           "launches_in_pass": {k: launches[k] for k in (
               "int8_quantize", "int8_absmax", "int8_conv",
               "signed_distance")},
           "forward_ms": {net: {"function": t["fn"], "absmax": t["a"],
                                "conv_launch": t["c"],
                                "weight_quantize": wq[net]["ms"],
                                "plain": t["plain"],
                                "library_int_mm": t["lib"],
                                "bf16_cudnn": t["bf16"],
                                "function_bound": t["fb"],
                                "tmac_per_s": t["macs"] / t["fn"] / 1e9}
                          for net, t in (("unet_seg", tot_u),
                                         ("tpusegnet_seg", tot_s))}}
    emit({"int8_path": res})
    bad = [(e["net"], e["cin"], e["cout"], e["k"], e["stride"], e["in_hw"])
           for e in shapes_u + shapes_s
           if not (e["bit_equal"] and e["weights_equal"])]
    assert not bad, f"K16 differs from its plain version at {bad}"
    bad = [(e["net"], e["cin"], e["cout"], e["k"], e["stride"], e["in_hw"])
           for e in shapes_u + shapes_s
           if not (e["library_equal"] and e["weight_library_equal"])]
    assert not bad, f"K16's library chains differ from the kernels at {bad}"
    assert launches["int8_conv"] == tot_u["launches"] > 0, launches
    assert launches["int8_absmax"] == tot_u["launches"], launches
    # one int8_lane entry (the pass's one segmentation_inference call): one
    # launch quantises all of unet_seg's weights
    assert launches["int8_quantize"] == 1, launches
    assert all(q["launches_a_call"] == 1 for q in wq.values()), wq
    assert len(angles) > 0, "the int8 pass reached no angle"
    nums = [pass_s, agree, dtw["mean_angle_error"], *angles,
            *out["internodes"]]
    assert np.isfinite(nums).all(), "a number of the int8 pass is not finite"

    rows = []
    for net, t, launched in (("unet_seg", tot_u, launches),
                             ("tpusegnet_seg", tot_s, None)):
        path = ("phase 16's Segmentation2D pass" if launched
                else "phase 16 check only (no pass runs it)")
        unit = (f"one forward of {net} at {ML_SIZE}x{ML_SIZE}, batch "
                f"{ML_BATCH if launched else 1}: the sum over its "
                f"{t['convs']} compute convs")
        fby = ("bytes" if t["bytes"] / HBM_BYTES_PER_S >=
               2 * t["macs"] / INT8_OPS_PER_S else "operations")
        for name, ms, plain, b, by, lib, extra in (
                ("int8_conv", t["fn"], t["plain"], t["fb"], fby, t["lib"],
                 {"what": "the whole function: the absmax launch and the "
                          "conv launch, which quantises as it stages",
                  "conv_launch_ms": t["c"], "absmax_ms": t["a"],
                  "bf16_cudnn_ms": t["bf16"],
                  "tmac_per_s": t["macs"] / t["fn"] / 1e9}),
                ("int8_absmax", t["a"], t["a_plain"], t["ab"], "bytes",
                 t["a_lib"], {"library": "torch.linalg.vector_norm(x, inf)"}),
                ("int8_quantize", wq[net]["ms"], wq[net]["plain_ms"],
                 wq[net]["bound_ms"], wq[net]["bound_by"],
                 wq[net]["library_ms"],
                 {"what": f"all {wq[net]['weights']} compute weights in one "
                          "launch: amax and q in the conv's packed layout",
                  "launches_a_call": wq[net]["launches_a_call"],
                  "library": "per weight: amax over (Cin, kh, kw), scale, "
                             "round, clamp, permute + pad (no packing), "
                             "summed"})):
            src, rep = KERNEL_INFO[name]
            rows.append(dict({
                "name": name, "route": "cuda", "source": src,
                "replaces": rep,
                "launches": launched[name] if launched else 0,
                "max_abs_err": 0.0, "match": True, "ms": ms,
                "kernel_ms": ms, "plain_ms": plain, "bound_ms": b,
                "bound_by": by, "library_ms": lib, "path": path,
                "unit": unit}, **extra))
    return rows


def _library_gathers():
    """One PyTorch chain per probe (the library yardstick; the port never
    calls them): the rolled indices, one torch.gather or index_select, the
    sum over the reps in int32."""
    import torch

    def rolled(i, reps, n):
        return (i.long()[..., None] + torch.arange(reps, device=i.device)) % n

    def axis1(tab, idx, reps):
        k = rolled(idx, reps, tab.shape[1])
        return torch.gather(tab, 1, k.flatten(1)).view(k.shape).sum(
            -1, dtype=torch.int32)

    def rows(tab, r, reps):
        k = rolled(r, reps, tab.shape[0])
        return torch.index_select(tab, 0, k.flatten()).view(
            *k.shape, 32).sum(1, dtype=torch.int32)

    def select32(T, dy, reps):
        return torch.gather(T, 1, rolled(dy, reps, 32)).sum(
            1, dtype=torch.int32)

    return {"gather_axis1": axis1, "gather_rows": rows,
            "gather_select32": select32}


def run_gather_probes(device_name):
    """Phase 17: K17-K19 at exp_pallas_gather.py:main's sizes (axis1 at L =
    8K, 32K, 128K; rows at R = 4K, 32K; select32), each through its probe's
    wrapper once with the counts set to 0 (the probe's own run), then equal
    to its plain version on the same inputs, timed beside it. Prints M
    lookups/s and the bounds."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.tools import gather_probe as gp

    plain = {"gather_axis1": gp.axis1_gather_plain,
             "gather_rows": gp.rows_gather_plain,
             "gather_select32": gp.select32_plain}
    names = {gp.axis1_gather: "gather_axis1", gp.rows_gather: "gather_rows",
             gp.select32: "gather_select32"}
    library = _library_gathers()
    rows, probes = [], []
    for i, (label, make, fn, size, lookups) in enumerate(gp.PROBES):
        name = names[fn]
        np.random.seed(i)
        args = make(size, device="cuda")
        kernels.reset_launches()
        got = fn(*args, 64)
        launched = kernels.LAUNCHES[name]
        want = plain[name](*args, 64)
        torch.cuda.synchronize()
        lib_out = library[name](*args, 64)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"{name} ({label}) differs from plain"
        assert torch.equal(lib_out, got), f"{name} ({label}): library differs"
        # all timed as calls replayed from a CUDA graph: a probe's launch
        # is shorter than the host's time to issue it
        ms = gp.timed(lambda: fn(*args, 64)) * 1e3
        plain_ms = gp.timed(lambda: plain[name](*args, 64)) * 1e3
        lib_ms = gp.timed(lambda: library[name](*args, 64)) * 1e3
        # the floor: the same launch with no lookups (the indices, K17's
        # staging, the output)
        extra = {"floor_ms": gp.timed(lambda: fn(*args, 0)) * 1e3}
        if name == "gather_rows":
            # a lookup is a 128-byte table row read through L1/L2
            extra["lookup_bytes"] = 128 * lookups
        n_bytes = sum(a.numel() * 4 for a in args) + got.numel() * 4
        b, by = bound_ms(n_bytes, 4 * lookups)
        where = ("registers (warp shuffle)" if name == "gather_select32"
                 else "shared memory" if name == "gather_axis1"
                 and gp.axis1_staged(size) else "L1/L2")
        probes.append({"probe": label, "M_lookups_per_s": lookups / ms / 1e3,
                       "ms": ms, "bound_ms": b, "table_in": where})
        rows.append(kernel_row(name, launched, 0.0, ms, plain_ms, n_bytes,
                               4 * lookups, library=lib_ms, extra={
                                   "path": "phase 17 (gather_probe's run)",
                                   "probe": label, "table_in": where,
                                   "M_lookups_per_s": lookups / ms / 1e3,
                                   **extra}))
    emit({"gather_probes": {"device": device_name, "probes": probes}})
    return rows


#: phase 18: configs/geom_pipe_full.toml's angle chain (COLMAP poses, 1 mm,
#: the skeleton over TriangleMesh's mesh)
FULL_TASKS = ("Colmap", "Undistorted", "Masks", "Voxels", "PointCloud",
              "TriangleMesh", "CurveSkeleton", "RefineSkeleton", "TreeGraph",
              "AnglesAndInternodes")
#: the one departure from geom_pipe_full.toml: Colmap's pose check keeps a
#: view whose estimated centre is within distance_threshold of its CNC pose,
#: and a centre computed from COLMAP's quaternion is never bit-equal to the
#: logged pose, so the shipped 0 marks every view "incorrect" and the blind
#: angle raises; 5 mm is geom_pipe_real.toml's
FULL_DISTANCE_THRESHOLD = 5.0
FULL_VIEWS, FULL_W, FULL_H, FULL_F = 60, 1440, 1080, 1400.0

#: the stand-in for the colmap binary (written by write_standin_colmap,
#: behind a `#!` line naming this interpreter): a COLMAP that recovered the
#: cameras of `colmap_model.json` beside it. `-h` prints its version;
#: `mapper` writes, through the port's colmap/read_model.py, the model's
#: camera, the images found in --image_path with their true poses, and the
#: model's points as points3D (a second model of two images as well when
#: "extra_model" is set); `model_aligner` copies the model and, as COLMAP
#: does, refuses the threshold option of the other version's spelling;
#: `model_analyzer` prints the model's counts; every other subcommand
#: succeeds without output.
STANDIN_COLMAP = r'''
import json
import shutil
import sys
from pathlib import Path

MODEL = json.loads(Path(__file__).with_name("colmap_model.json").read_text())
VERSION = tuple(int(x) for x in MODEL["version"].split("."))

if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
    print(f"COLMAP {MODEL['version']} -- Structure-from-Motion and "
          "Multi-View Stereo (stand-in)")
    sys.exit(0)
sub, args = sys.argv[1], dict(zip(sys.argv[2::2], sys.argv[3::2]))


def write_model(out, names):
    sys.path.insert(0, MODEL["root"])
    import numpy as np
    from plant3dvision_tpu_torch.colmap import read_model as rm
    cam = MODEL["camera"]
    out.mkdir(parents=True, exist_ok=True)
    rm.write_cameras_binary({1: rm.Camera(
        1, cam["model"], cam["width"], cam["height"],
        np.asarray(cam["params"], float))}, out / "cameras.bin")
    images = {}
    for i, name in enumerate(names, start=1):
        im = MODEL["images"][name]
        images[i] = rm.Image(i, rm.rotmat2qvec(np.asarray(im["rotmat"])),
                             np.asarray(im["tvec"], float), 1, name,
                             np.zeros((0, 2)), np.zeros(0, np.int64))
    rm.write_images_binary(images, out / "images.bin")
    rm.write_points3d_binary({j: rm.Point3D(
        j, np.asarray(xyz, float), np.array([0, 200, 0], np.uint8), 0.3,
        np.zeros(0, np.int32), np.zeros(0, np.int32))
        for j, xyz in enumerate(MODEL["points"], start=1)},
        out / "points3D.bin")


if sub == "mapper":
    staged = Path(args["--image_path"])
    names = sorted(n for n in MODEL["images"] if (staged / n).exists())
    write_model(Path(args["--output_path"]) / "0", names)
    if MODEL.get("extra_model"):
        write_model(Path(args["--output_path"]) / "1", names[:2])
elif sub == "model_aligner":
    want = ("--robust_alignment_max_error" if VERSION <= (3, 9)
            else "--alignment_max_error")
    if want not in args:
        sys.exit(f"model_aligner: COLMAP {MODEL['version']} takes {want}; "
                 f"got {sorted(args)}")
    src, dst = Path(args["--input_path"]), Path(args["--output_path"])
    dst.mkdir(parents=True, exist_ok=True)
    for f in src.glob("*.bin"):
        shutil.copy(f, dst / f.name)
elif sub == "model_analyzer":
    print(f"Cameras: 1\nImages: {len(MODEL['images'])}\n"
          f"Points: {len(MODEL['points'])}")
sys.exit(0)
'''


def write_standin_colmap(directory, camera, images, points, version="3.8",
                         extra_model=False):
    """Write the stand-in colmap (STANDIN_COLMAP) and its model into
    `directory`; returns the executable's path, for COLMAP_EXE. `camera`
    is {"model", "width", "height", "params"}, `images` {file name: (R,
    t)} the cameras it recovers, `points` (N, 3) its sparse cloud."""
    import numpy as np
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    model = {"root": str(ROOT), "version": version,
             "extra_model": bool(extra_model), "camera": camera,
             "images": {name: {"rotmat": np.asarray(R, float).tolist(),
                               "tvec": np.asarray(t, float).tolist()}
                        for name, (R, t) in images.items()},
             "points": np.asarray(points, float).tolist()}
    (directory / "colmap_model.json").write_text(json.dumps(model))
    exe = directory / "colmap"
    exe.write_text(f"#!{sys.executable}\n" + STANDIN_COLMAP)
    exe.chmod(0o755)
    return exe


def full_scan_model(plant, n_views, width, height, f, n_points=4000,
                    seed=0):
    """The stand-in's model of a `write_distorted_scan(..., rig=True)`
    scan: its SIMPLE_RADIAL camera [f, cx, cy, k1] (the scan's OPENCV
    lens, k1 alone), the true cameras of phase 9's ring by image file name,
    and `n_points` seeded samples of the plant's surface."""
    import numpy as np
    from plant3dvision_tpu_torch.synth import turntable_cameras
    cams = turntable_cameras(n_views, dist=450.0, z=120.0,
                             target=(0, 0, 70.0), f=f, width=width,
                             height=height)
    rng = np.random.default_rng(seed)
    pts, _ = textured_surface(plant, 1.0, 2.0, rng)
    pts = pts[rng.choice(len(pts), min(n_points, len(pts)), replace=False)]
    camera = {"model": "SIMPLE_RADIAL", "width": width, "height": height,
              "params": [f, width / 2.0, height / 2.0, FRONTEND_K1]}
    images = {f"{v:05d}_rgb.png": (R, t) for v, (_, R, t) in enumerate(cams)}
    return camera, images, pts


def full_config():
    """configs/geom_pipe_full.toml's angle chain (FULL_TASKS) with
    FULL_DISTANCE_THRESHOLD, its one departure."""
    from plant3dvision_tpu_torch.runtime.config import load_toml
    toml = load_toml(ROOT / "configs" / "geom_pipe_full.toml")
    cfg = {t: dict(toml[t]) for t in FULL_TASKS if t in toml}
    cfg["Colmap"]["distance_threshold"] = FULL_DISTANCE_THRESHOLD
    cfg["Clean"] = {"no_confirm": True}
    return cfg


def undistorted_count(scan, fileset_id):
    """How many of an Undistorted fileset's images differ from their input
    images (the others were copied as they are: no camera yet)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from plant3dvision_tpu_torch.fsdb import io
    raw = scan.get_fileset("images")
    out = scan.get_fileset(fileset_id).get_files()

    def differs(f):
        return not np.array_equal(io.read_image(f),
                                  io.read_image(raw.get_file(f.id)))
    with ThreadPoolExecutor(8) as ex:
        return int(sum(ex.map(differs, out)))


def run_full_path(db, device_name):
    """Phase 18: configs/geom_pipe_full.toml (full_config) on a 60-view
    1440x1080 RGB scan of the north-star plant on phase 9's ring through
    its lens (SIMPLE_RADIAL k1 = -0.08), written as a rig logs it (CNC
    poses only), with the stand-in colmap: one cold pass, one warm pass
    after Clean (profiled too with --profile). On the fresh scan the cold pass
    runs Undistorted and Masks before Colmap (Voxels lists its masks before
    its cameras), as the JAX runtime does: no mask has a camera when Voxels
    carves, the volume is empty and TriangleMesh fails, as the JAX
    package's does; the phase checks that and goes on (Colmap has written
    every image's camera by then). Returns the scan, the warm pass's report
    and launches and the checks, which main() asserts after phase 19."""
    import os

    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.ops import edt
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.runtime.runner import TaskFailure
    from plant3dvision_tpu_torch.synth import SyntheticPlant

    V, W, H, F = FULL_VIEWS, FULL_W, FULL_H, FULL_F
    plant = SyntheticPlant(**NORTHSTAR_PLANT)
    t0 = time.perf_counter()
    scan = write_distorted_scan(db, "full", plant, V, W, H, F, rig=True)
    gen_s = time.perf_counter() - t0
    work = ROOT / ".smoke" / "colmap"
    os.environ["COLMAP_EXE"] = str(write_standin_colmap(
        work / "bin", *full_scan_model(plant, V, W, H, F)))
    os.environ["COLMAP_WD"] = str(work / "wd")
    cfg = full_config()
    try:
        ctx = RunContext(db, "full", cfg, device="cuda")
        t0 = time.perf_counter()
        try:
            run_task(ctx, "AnglesAndInternodes", report=False)
            cold_failure = cold_cause = None
        except TaskFailure as e:
            cold_failure, cold_cause = str(e), repr(e.__cause__)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        cold_undistorted = undistorted_count(
            scan, ctx.get_task("Undistorted").output().fileset_id)
        cold_masks_with_camera = sum(
            bool(f.get_metadata("colmap_camera")) for f in scan.get_fileset(
                ctx.get_task("Masks").output().fileset_id).get_files())

        run_task(ctx, "Clean", report=False)
        ctx = RunContext(db, "full", cfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        report, warm_s, ctx, prof = warm_pass(ctx)
        launches = dict(kernels.LAUNCHES)
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        warm_undistorted = undistorted_count(
            scan, report["Undistorted"]["fileset"])
    finally:
        os.environ.pop("COLMAP_EXE", None)
        os.environ.pop("COLMAP_WD", None)

    files = scan.get_fileset("images").get_files()
    cfs = scan.get_fileset(report["Colmap"]["fileset"])
    dists = io.read_json(cfs.get_file("euclidean_distances"))
    mfile = scan.get_fileset(report["TriangleMesh"]["fileset"]).get_files()[0]
    mesh = io.read_triangle_mesh(mfile)
    _, components = mesh.connected_components()
    angles, internodes, dtw = frontend_angles(scan, report, plant)
    mesh_stages = report["TriangleMesh"].get("stages", {})
    # K2's launches a call, on the mesh's grid: the pass makes two calls
    # (vol2pcd's and the mesh's)
    occ = mesh_occupancy(scan, report)
    before = kernels.LAUNCHES["signed_distance"]
    edt.signed_distance(occ, 8)
    k2_call = kernels.LAUNCHES["signed_distance"] - before
    emit({"full_path": {
        "device": device_name, "n_views": V, "image": [W, H],
        "lens": "SIMPLE_RADIAL k1 = %g" % FRONTEND_K1,
        "voxel_mm": cfg["Voxels"]["voxel_size"],
        "departure": {"Colmap.distance_threshold": FULL_DISTANCE_THRESHOLD},
        "scan_generation_s": gen_s, "cold_s": cold_s, "warm_s": warm_s,
        "task_s": {k: v["seconds"] for k, v in report.items()},
        "colmap_s": report["Colmap"]["seconds"],
        "mesh_stages_s": mesh_stages,
        "cold_pass": {"failure": cold_failure, "cause": cold_cause,
                      "undistorted_images": cold_undistorted,
                      "masks_with_camera": cold_masks_with_camera},
        "undistorted_images": warm_undistorted,
        "colmap_bounding_box": cfs.get_metadata("bounding_box"),
        "pose_distance_mean_mm": dists["mean"],
        "correct_views": sum(f.get_metadata("pose_estimation") == "correct"
                             for f in files),
        "mesh": {"vertices": len(mesh.vertices),
                 "triangles": len(mesh.triangles),
                 "components": len(components), "grid": list(occ.shape)},
        "n_angles": int(len(angles)), "n_gt": len(plant.gt_angles),
        "angles": angles.tolist(),
        "mean_angle_error_deg": dtw["mean_angle_error"],
        "dtw_normalized_cost": dtw["normalized_cost"],
        "k2_launches_a_call": k2_call,
        "max_memory_allocated_mb": peak_mb,
        "launches_per_warm_pass": launches}})
    if prof is not None:
        emit({"full_path_profile": prof})
    need = ("carve", "signed_distance", "gradient_gaussian", "band_compact",
            "dilate_disk", "undistort", "mask_filter")
    checks = {
        "the cold pass failed at TriangleMesh, before any camera": (
            cold_failure == "Task TriangleMesh failed after 1 attempt(s)"
            and cold_undistorted == 0 and cold_masks_with_camera == 0),
        "kernels launched in the warm pass": not [
            k for k in need if launches[k] <= 0],
        "K2 launched by the mesh call too": (
            launches["signed_distance"] == 2 * k2_call
            and "signed_distance" in mesh_stages),
        "colmap_camera on every view": all(
            f.get_metadata("colmap_camera") for f in files),
        "Colmap outputs written": all(
            cfs.get_file(n) is not None for n in
            ("cameras", "images", "points3d", "sparse",
             "euclidean_distances")),
        "every view undistorted in the warm pass": warm_undistorted == V,
        "a non-empty mesh of one component": (
            len(mesh.triangles) > 0 and len(components) == 1),
        "at least 10 angles": len(angles) >= 10,
        "finite numbers": bool(np.isfinite(
            [cold_s, warm_s, peak_mb, *idle_share(prof), *angles,
             *internodes]).all()),
    }
    return scan, report, launches, checks


def mesh_occupancy(scan, report):
    """The occupancy grid that the pass's TriangleMesh gave K2
    (proc3d.mesh_occupancy of its point cloud), on the card."""
    import torch
    from plant3dvision_tpu_torch import proc3d
    from plant3dvision_tpu_torch.fsdb import io
    pfile = scan.get_fileset(report["PointCloud"]["fileset"]).get_files()[0]
    occ, _ = proc3d.mesh_occupancy(io.read_point_cloud(pfile).points,
                                   float(pfile.get_metadata("voxel_size")))
    return torch.from_numpy(occ).cuda()


def check_full_kernels(db, scan, report, launches):
    """Phase 19: K2 on phase 18's mesh grid at cap 8 (as pcd2mesh calls
    it) against its plain version, bit for bit, with its bound and the
    pass's launches; then CurveSkeleton(method="mcf") once on the pass's
    mesh (host C++), its seconds."""
    import torch
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.ops import edt
    from plant3dvision_tpu_torch.runtime import RunContext, run_task

    occ = mesh_occupancy(scan, report)
    n, cap = occ.numel(), 8
    sd = edt.signed_distance(occ, cap)
    sd_p = edt.signed_distance_plain(occ, cap)
    torch.cuda.synchronize()
    err = float((sd - sd_p).abs().max())
    assert torch.equal(sd, sd_p), f"signed distance kernel != plain at the " \
        f"mesh grid (max {err})"
    del sd, sd_p
    reads = [sum(2 * (occ.shape[a] - s) * (n // occ.shape[a])
                 for s in range(1, min(cap, occ.shape[a] - 1) + 1))
             for a in range(3)]
    row = kernel_row(
        "signed_distance", launches["signed_distance"], err,
        cuda_ms(lambda: edt.signed_distance(occ, cap)),
        cuda_ms(lambda: edt.signed_distance_plain(occ, cap), reps=5,
                warmup=1),
        8 * n, 2 * 2 * sum(reads),
        extra={"path": "geom_pipe_full mesh (TriangleMesh)",
               "shape": list(occ.shape), "cap": cap,
               "lane": "16-bit" if edt.lane16(edt.axis_caps(occ.shape, cap))
               else "32-bit",
               "bound_ms_yz": bound_ms(8 * n, 2 * 2 * sum(reads[1:]))[0],
               "calls_in_pass": "vol2pcd's and the mesh's"})

    mfile = scan.get_fileset(report["TriangleMesh"]["fileset"]).get_files()[0]
    mesh = io.read_triangle_mesh(mfile)
    cfg = full_config()
    cfg["CurveSkeleton"] = dict(cfg["CurveSkeleton"], method="mcf")
    ctx = RunContext(db, scan.id, cfg, device="cuda")
    t0 = time.perf_counter()
    rep = run_task(ctx, "CurveSkeleton", report=False)
    mcf_s = time.perf_counter() - t0
    skel = io.read_json(ctx.scan.get_fileset(rep["CurveSkeleton"][
        "fileset"]).get_files()[0])
    emit({"full_kernel_checks": {
        "mesh_grid": list(occ.shape), "k2_bit_equal": True,
        "mcf": {"s": mcf_s, "task_s": rep["CurveSkeleton"]["seconds"],
                "mesh_vertices": len(mesh.vertices),
                "mesh_triangles": len(mesh.triangles),
                "skeleton_nodes": len(skel["points"]),
                "skeleton_lines": len(skel["lines"])}}})
    assert len(skel["points"]) > 1, "mcf skeleton has no nodes"
    return [row]


def tube_mesh(a, b, r, n=10):
    """A closed tube from a to b of radius r, as (vertices, triangles): an
    n-gon ring at each end, each end closed by a fan to a tip r beyond it
    (a capsule's cap, coarsely)."""
    import numpy as np
    a, b = np.asarray(a, float), np.asarray(b, float)
    z = (b - a) / max(float(np.linalg.norm(b - a)), 1e-9)
    x = np.cross(z, [0.0, 0.0, 1.0])
    if np.linalg.norm(x) < 1e-6:
        x = np.cross(z, [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    th = 2 * np.pi * np.arange(n) / n
    ring = r * (np.cos(th)[:, None] * x + np.sin(th)[:, None] * y)
    verts = np.concatenate([a + ring, b + ring, [a - r * z, b + r * z]])
    k = np.arange(n)
    k2 = (k + 1) % n
    tris = np.concatenate([
        np.stack([k, k2, n + k], 1), np.stack([k2, n + k2, n + k], 1),
        np.stack([np.full(n, 2 * n), k2, k], 1),
        np.stack([np.full(n, 2 * n + 1), n + k, n + k2], 1)])
    return verts, tris.astype(np.int64)


def virtual_plant_organs(plant):
    """{organ: [(vertices, triangles), ...]} in scanner axes: the generator's
    own geometry (a ProceduralArabidopsis' stem polyline, pedicels, fruits
    and leaf blades; a SyntheticPlant's stem, pedicel and fruit capsules,
    synth.LABEL_CAPSULES)."""
    if hasattr(plant, "stem_pts"):
        p = plant.stem_pts
        return {
            "stem": [tube_mesh(p[i], p[i + 1], plant.stem_radius)
                     for i in range(len(p) - 1)],
            "pedicel": [tube_mesh(*c) for c in plant.pedicels],
            "fruit": [tube_mesh(*c) for c in plant.fruits],
            "leaf": list(plant.leaves)}
    from plant3dvision_tpu_torch.synth import LABEL_CAPSULES
    return {label: [tube_mesh(*c) for c in pick(plant)]
            for label, pick in LABEL_CAPSULES.items()}


def write_virtual_plant_obj(scan, organs):
    """The ground truth that the reference's virtual_plant fixture ships:
    one OBJ with a `usemtl` block per organ of `organs`
    (virtual_plant_organs), in the L-system axes that VoxelsGroundTruth and
    ClusteredMeshGroundTruth undo (scanner (X, Y, Z) written as (X, Z, -Y)),
    as the file of the scan's VirtualPlant* fileset (its angle and
    internode metadata kept). Returns the file."""
    import numpy as np
    lines, faces, off = [], [], 0
    for label, parts in organs.items():
        faces.append(f"usemtl {label}")
        for verts, tris in parts:
            v = np.asarray(verts, float)[:, [0, 2, 1]]
            v[:, 2] *= -1
            lines += [f"v {x!r} {y!r} {z!r}" for x, y, z in v.tolist()]
            faces += [f"f {i + 1} {j + 1} {k + 1}"
                      for i, j, k in (np.asarray(tris) + off).tolist()]
            off += len(v)
    fs_id = next(i for i in scan.list_filesets()
                 if i.startswith("VirtualPlant"))
    f = scan.get_fileset(fs_id).get_files()[0]
    if f.filename and f.path().exists():
        f.path().unlink()
    f.write_raw(("\n".join(lines + faces) + "\n").encode(), "obj")
    return f


#: phase 20: geom_pipe_virtual.toml's evaluation sections, as shipped
GEOM_EVAL_TASKS = ("PointCloudGroundTruth", "PointCloudEvaluation",
                   "AnglesAndInternodesEvaluation", "Visualization")
ROBUST_REPLICATES = 3


def _timed_task(ctx, task):
    """run_task(ctx, task) and its report entry's seconds."""
    from plant3dvision_tpu_torch.runtime import run_task
    rep = run_task(ctx, task, report=False)
    return rep, rep[task]["seconds"]


def _json_output(scan, report, task):
    fs = scan.get_fileset(report[task]["fileset"])
    return json.loads(fs.get_file(task).read_raw())


def run_geom_evaluation(db, scan):
    """Phase 20: geom_pipe_virtual.toml's evaluation sections
    (GEOM_EVAL_TASKS, as shipped) on phase 2's north-star scan after its
    warm pass (geom_pipe_fast.toml's chain, complete in the DB): the
    ground-truth cloud (100,000 samples of the VirtualPlant mesh), the
    point cloud's evaluation at 2.0 mm, the angles' DTW against the
    plant's metadata and Visualization (300 images of 1440x1080 and their
    thumbnails; where matplotlib does not import it raises at its figures
    after writing them, as the JAX task does, and the phase checks that
    instead); then virtual_cylinder.toml on a bare scan; then the
    robustness tool (the main() that `python -m
    plant3dvision_tpu_torch.tools.robustness_evaluation` runs, with its
    arguments) over 3 replicates of a bare copy of the scan through
    geom_pipe_fast.toml (the main path: K1-K4 in each), with the launches
    of that call.
    Returns the checks, which main() asserts."""
    import importlib.util

    import numpy as np
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.runtime.config import load_toml
    from plant3dvision_tpu_torch.tools import robustness_evaluation

    cfg = load_toml(ROOT / "configs" / "geom_pipe_fast.toml")
    virtual = load_toml(ROOT / "configs" / "geom_pipe_virtual.toml")
    cfg.update({t: dict(virtual[t]) for t in GEOM_EVAL_TASKS})
    cfg["Clean"] = {"no_confirm": True}
    ctx = RunContext(db, scan.id, cfg, device="cuda")
    n_angles = len(json.loads(ctx.scan.get_fileset(ctx.get_task(
        "AnglesAndInternodes").output().fileset_id).get_file(
        "AnglesAndInternodes").read_raw())["angles"])
    seconds, results = {}, {}
    for task in GEOM_EVAL_TASKS[:-1]:
        rep, seconds[task] = _timed_task(ctx, task)
        if task != "PointCloudGroundTruth":
            results[task] = _json_output(ctx.scan, rep, task)
    gt_points = len(io.read_point_cloud(ctx.scan.get_fileset(ctx.get_task(
        "PointCloudGroundTruth").output().fileset_id).get_files()[0]))

    # Visualization: whole with matplotlib, else up to its figures
    vis = {"matplotlib": importlib.util.find_spec("matplotlib") is not None}
    t0 = time.perf_counter()
    if vis["matplotlib"]:
        rep, _ = _timed_task(ctx, "Visualization")
        files = ctx.scan.get_fileset(
            rep["Visualization"]["fileset"]).get_files()
        vis["outcome"] = "whole"
    else:
        task = ctx.get_task("Visualization")
        try:
            task.run()
            vis["outcome"] = "whole without matplotlib"
        except ImportError as e:
            vis["outcome"] = f"failed at its figures: {e}"
        files = task.output().get().get_files()
    seconds["Visualization"] = time.perf_counter() - t0
    ids = [f.id for f in files]
    vis.update(images=sum(i.startswith("image_") for i in ids),
               thumbnails=sum(i.startswith("thumbnail_") for i in ids),
               files=len(ids))
    if not vis["outcome"].startswith("whole"):
        ctx.scan.delete_fileset(ctx.get_task("Visualization").output()
                                .fileset_id)

    # virtual_cylinder.toml on a bare scan
    db.get_scan("cylinder", create=True)
    cctx = RunContext(db, "cylinder", load_toml(
        ROOT / "configs" / "virtual_cylinder.toml"), device="cuda")
    rep, seconds["CylinderRadiusEstimation"] = _timed_task(
        cctx, "CylinderRadiusEstimation")
    seconds["CylinderRadiusGroundTruth"] = rep[
        "CylinderRadiusGroundTruth"]["seconds"]
    results["CylinderRadiusEstimation"] = cyl = _json_output(
        cctx.scan, rep, "CylinderRadiusEstimation")

    # the robustness tool on 3 replicates of a bare copy of the scan
    shutil.copytree(scan.path(), db.path() / "rob")
    db._load_scans()
    run_task(RunContext(db, "rob", {"Clean": {"no_confirm": True}},
                        device="cuda"), "Clean", report=False)
    out_json = db.path().parent / "robustness.json"
    kernels.reset_launches()
    t0 = time.perf_counter()
    robustness_evaluation.main(
        [str(db.path() / "rob"), "--task", "AnglesAndInternodes", "--config",
         str(ROOT / "configs" / "geom_pipe_fast.toml"),
         "-n", str(ROBUST_REPLICATES), "--out", str(out_json)])
    robust_s = time.perf_counter() - t0
    sub_launches = dict(kernels.LAUNCHES)
    robust = json.loads(out_json.read_text())["AnglesAndInternodes"][
        "compare_angles"]
    db._load_scans()
    rep_angles = {}
    for i in range(ROBUST_REPLICATES):
        rid = f"rob_rep{i:02d}"
        rctx = RunContext(db, rid, load_toml(
            ROOT / "configs" / "geom_pipe_fast.toml"), device="cuda")
        fs_id = rctx.get_task("AnglesAndInternodes").output().fileset_id
        rep_angles[rid] = len(json.loads(rctx.scan.get_fileset(fs_id).get_file(
            "AnglesAndInternodes").read_raw())["angles"])

    dtw = results["AnglesAndInternodesEvaluation"]
    pce = results["PointCloudEvaluation"]
    emit({"geom_evaluation": {
        "config": "configs/geom_pipe_virtual.toml's evaluation sections "
                  "on phase 2's scan; virtual_cylinder.toml; "
                  "robustness_evaluation -n 3",
        "task_s": seconds, "gt_points": gt_points,
        "point_cloud_evaluation": pce,
        "dtw": {k: dtw[k] for k in ("mean_angle_error",
                                    "mean_internode_error",
                                    "normalized_cost")},
        "dtw_pairs": len(dtw["pairs"]), "visualization": vis,
        "cylinder": cyl, "robustness_s": robust_s,
        "robustness_pairwise": robust,
        "replicate_angles": rep_angles, "warm_pass_angles": n_angles,
        "robustness_launches": {k: v for k, v in sub_launches.items()
                                if v}}})
    need = ("carve", "signed_distance", "gradient_gaussian", "band_compact")
    vis_ok = (vis["images"] == vis["thumbnails"] == 300
              and (vis["outcome"] == "whole" or (
                  not vis["matplotlib"] and "matplotlib" in vis["outcome"])))
    return {
        "evaluation JSONs written": all(results.values()),
        "DTW mean angle error < 1 deg": dtw["mean_angle_error"] is not None
        and dtw["mean_angle_error"] < 1.0,
        "point cloud fitness > 0": pce["fitness"] > 0,
        "cylinder radius within 0.1": abs(
            cyl["calculated_radius"] - cyl["gt_radius"]) < 0.1,
        "every replicate as many angles as the warm pass": all(
            n == n_angles for n in rep_angles.values()),
        "robustness replicates launched K1-K4": all(
            sub_launches.get(k, 0) >= ROBUST_REPLICATES for k in need),
        "pairwise errors finite": bool(robust) and all(
            np.isfinite(v["mean_angle_error"]) for v in robust.values()),
        "Visualization wrote 300 images and thumbnails": vis_ok}


#: phase 21: ml_pipe_virtual.toml's evaluation sections, as shipped
ML_EVAL_TASKS = ("PointCloudGroundTruth", "PointCloudEvaluation",
                 "VoxelsGroundTruth", "VoxelsEvaluation",
                 "Segmentation2DEvaluation", "SegmentedPointCloudEvaluation",
                 "AnglesAndInternodesEvaluation")
#: the organs of phase 5's plant that have masks in ML_GT_FILESET
#: (generate_photo_scan's label channels: no flower)
ML_GT_LABELS = ("fruit", "leaf", "pedicel", "stem")


def run_ml_evaluation(db, scan):
    """Phase 21: ml_pipe_virtual.toml's seven evaluation sections
    (ML_EVAL_TASKS, as shipped) on phase 5's scan after phase 7's warm pass
    of the separate route (complete in the DB). The ground truth is that
    which the reference's virtual_plant fixture ships: the organs' masks,
    which phase 5 wrote with its images into ML_GT_FILESET, the fileset
    that Segmentation2DGroundTruthFilesetExists names by default, and one
    OBJ, written here, a usemtl block for each of the plant's stem,
    pedicel, fruit and leaf meshes, in the L-system axes
    (write_virtual_plant_obj). Then Segmentation2DEvaluation once more at
    dilation_amount 2: K8 at radius 2, one launch a label's stack of 126
    masks. On this data, as in the JAX package:
    SegmentedPointCloudEvaluation fails (TypeError, 'iteration over a 0-d
    array': PointCloudGroundTruth writes no labels), and
    PointCloudEvaluation compares the prediction with a cloud sampled in
    the L-system axes (PointCloudGroundTruth does not undo them). The
    JAX package's PointCloudGroundTruth itself always fails (TypeError,
    it indexes its one input as a list); the port's runs. Returns the
    checks and the K8 launches of the dilated evaluation."""
    import numpy as np
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.runtime import RunContext
    from plant3dvision_tpu_torch.runtime.config import load_toml
    from plant3dvision_tpu_torch.runtime.runner import TaskFailure
    from plant3dvision_tpu_torch.synth_photo import ProceduralArabidopsis

    cfg = separate_config()
    virtual = load_toml(ROOT / "configs" / "ml_pipe_virtual.toml")
    cfg.update({t: dict(virtual[t]) for t in ML_EVAL_TASKS})
    ctx = RunContext(db, scan.id, cfg, device="cuda")
    t0 = time.perf_counter()
    obj = write_virtual_plant_obj(scan, virtual_plant_organs(
        ProceduralArabidopsis(seed=1)))
    seconds = {"ground truth OBJ": time.perf_counter() - t0}
    assert ctx.get_task("Segmentation2DGroundTruthFilesetExists").output(
    ).fileset_id == ML_GT_FILESET
    gt_masks = ctx.scan.get_fileset(ML_GT_FILESET)
    results, failures = {}, {}
    for task in ML_EVAL_TASKS:
        try:
            rep, seconds[task] = _timed_task(ctx, task)
        except TaskFailure as e:
            failures[task] = repr(e.__cause__)
            continue
        if task.endswith("Evaluation"):
            results[task] = _json_output(ctx.scan, rep, task)
        else:
            fs = ctx.scan.get_fileset(rep[task]["fileset"])
            results[task] = {"files": [f.filename for f in fs.get_files()],
                             **(fs.get_files()[0].get_metadata() or {})}
    vgt = results.get("VoxelsGroundTruth", {})
    vgt.pop("angles", None)
    vgt.pop("internodes", None)

    cfg["Segmentation2DEvaluation"]["dilation_amount"] = 2
    dctx = RunContext(db, scan.id, cfg, device="cuda")
    kernels.reset_launches()
    rep, seconds["Segmentation2DEvaluation (dilation 2)"] = _timed_task(
        dctx, "Segmentation2DEvaluation")
    k8 = kernels.LAUNCHES["dilate_disk"]
    dil = _json_output(dctx.scan, rep, "Segmentation2DEvaluation")

    seg = results.get("Segmentation2DEvaluation", {})
    vox = results.get("VoxelsEvaluation", {})
    pick = ("tp", "fp", "fn", "precision", "recall", "miou")
    emit({"ml_evaluation": {
        "config": "configs/ml_pipe_virtual.toml's evaluation sections on "
                  "phase 5's scan, then Segmentation2DEvaluation at "
                  "dilation 2",
        "ground_truth_obj": obj.filename,
        "ground_truth_masks": [ML_GT_FILESET, len(gt_masks.get_files())],
        "task_s": seconds,
        "failed": failures,
        "voxels_ground_truth": vgt,
        "miou": {l: r["miou"] for l, r in seg.get("label-results",
                                                   {}).items()},
        "miou_dilation_2": {l: r["miou"] for l, r in dil[
            "label-results"].items()},
        "segmentation_2d": {l: {k: r[k] for k in pick} for l, r in seg.get(
            "label-results", {}).items()},
        "voxels_evaluation": {l: {k: r[k] for k in ("precision", "recall",
                                                    "tp", "fp", "fn")}
                              for l, r in vox.items()},
        "point_cloud_evaluation": results.get("PointCloudEvaluation"),
        "dtw": {k: results.get("AnglesAndInternodesEvaluation", {}).get(k)
                for k in ("mean_angle_error", "mean_internode_error",
                          "normalized_cost")},
        "k8_launches_dilation_2": k8}})
    checks = {
        "K8 launched, one a label": k8 == len(ML_GT_LABELS),
        "the tasks that run on this data ran": set(failures) == {
            "SegmentedPointCloudEvaluation"},
        "SegmentedPointCloudEvaluation fails as the JAX package's":
            "iteration over a 0-d array" in failures.get(
                "SegmentedPointCloudEvaluation", ""),
        "ground-truth volumes written at 0.15 mm":
            bool(vgt.get("files")) and vgt.get("voxel_size") == 0.15,
        "VoxelsEvaluation scores every organ": set(vox) == set(
            ML_GT_LABELS) and all(r["tp"] + r["fn"] > 0
                                  for r in vox.values()),
        "Segmentation2DEvaluation over 5 labels, 126 views each":
            list(seg.get("label-results", {})) == [
                "flower", "fruit", "leaf", "pedicel", "stem"]
            and len(seg.get("evaluation-results", {})) == 126 * 4,
        "dilation keeps the predictions' true positives or more": all(
            dil["label-results"][l]["tp"] >= seg["label-results"][l]["tp"]
            for l in ML_GT_LABELS) if seg else False,
        "point cloud evaluation written": results.get(
            "PointCloudEvaluation") is not None,
        "DTW aligned": results.get("AnglesAndInternodesEvaluation", {}).get(
            "mean_angle_error") is not None,
        "numbers finite": bool(np.isfinite([
            r["miou"] for r in seg.get("label-results", {}).values()
            if r["miou"] is not None]).all())}
    return checks, k8


def check_ml_evaluation_kernels(scan, k8):
    """Phase 21's K8 row at radius 2 on the stacks Segmentation2DEvaluation
    dilates: one label's 126 ground-truth masks of 896x896 (ML_GT_FILESET),
    built as metrics.dilate_masks receives them. Each of the 4 labels'
    stacks is held to the plain version bit for bit and timed; the row
    gives the first label's call (its ms, plain ms, library ms and bound),
    `launches` the dilated evaluation's (one a label's stack) and
    `ms_a_evaluation` the 4 calls' ms added."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.ops import masks as masks_ops

    fs = scan.get_fileset(ML_GT_FILESET)
    label_ms, row = {}, None
    for label in ML_GT_LABELS:
        files = sorted(fs.get_files(query={"channel": label}),
                       key=lambda f: f.id)
        binm = torch.from_numpy(np.ascontiguousarray(np.stack(
            [io.read_image(f) for f in files]) != 0)).to("cuda")
        if row is None:
            row = dilation_row(binm, 2, k8, {
                "path": "phase 21 (Segmentation2DEvaluation, "
                        "dilation_amount 2)",
                "label": label, "calls_a_evaluation": len(ML_GT_LABELS)})
            label_ms[label] = row["ms"]
        else:
            got = masks_ops.binary_dilation(binm, 2)
            assert torch.equal(got, masks_ops.binary_dilation_plain(
                binm, 2)), f"dilate kernel != plain ({label} masks, r 2)"
            label_ms[label] = cuda_ms(
                lambda: masks_ops.binary_dilation(binm, 2))
        del binm
    row["label_ms"] = label_ms
    row["ms_a_evaluation"] = sum(label_ms.values())
    torch.cuda.empty_cache()
    return [row]


#: phase 22: models/train_synth.py's main() at the shipped ResUNet's width
#: (24, 48, 96, 192) x 2 blocks, crop 448, batch 8, lr 3e-3, on a reduced
#: procedural set (TRAIN_PLANTS plants x TRAIN_VIEWS views, 2 crops a
#: view; the shipped recipe renders 12 x 18), TRAIN_STEPS steps; then a
#: short TPUSegNet run (128, 256, 256)
# (the steps were 200 and 50 before phase 25 took their time)
TRAIN_PLANTS, TRAIN_VIEWS, TRAIN_STEPS, SEGNET_STEPS = 2, 6, 100, 25
#: the training kernels (K20-K23) and their launches a step
TRAIN_KERNELS = ("batch_gather", "weighted_ce", "weighted_ce_backward",
                 "adamw", "iou_counts")


def _profiled_chunk(S, prof_at, marks, prof_box):
    """A `_draw_batch` that starts torch.profiler (device activity only:
    host tracing of the ~10^4 launches of a chunk doubles its wall time)
    before draw `prof_at` and stops it before draw `prof_at +
    STEPS_PER_CALL` (one chunk's steps), synchronising at both ends; the
    draw itself is train_synth's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    orig = S._draw_batch
    count = [0]

    def draw(gen, n, batch_size):
        i = count[0]
        count[0] += 1
        if i in (prof_at, prof_at + S.STEPS_PER_CALL):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if i == prof_at:
                prof_box.append(profile(activities=[ProfilerActivity.CUDA]))
                prof_box[0].__enter__()
            else:
                prof_box[0].__exit__(None, None, None)
        return orig(gen, n, batch_size)
    return draw


def _idle_share(prof, wall):
    """(busy s, idle share, top device entries) of a profiled window."""
    from torch.autograd import DeviceType
    dev = sorted(((e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda r: -r[1])
    busy = sum(r[1] for r in dev) / 1e6
    return busy, 1.0 - busy / wall, [
        {"name": k[:80], "s": t / 1e6, "calls": c} for k, t, c in dev[:8]]


def run_train_synth(work, device_name):
    """Phase 22: train_synth.main() at full width on the reduced procedural
    set (its dataset cache written on the way), the float16 checkpoint
    loaded by the port's load_model and run through segmentation_inference
    on the held-out crops; a 3-chunk run checkpointed every chunk, its
    middle chunk profiled (the device's idle share), resumed from its
    chunk-0 state and held equal bit for bit; a short TPUSegNet run.
    Returns (launches of the ResUNet run, the crops, the trained model's
    held-out crops and labels, checks)."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.models import train_synth as S
    from plant3dvision_tpu_torch.models.checkpoint import load_model
    from plant3dvision_tpu_torch.models.unet import segmentation_inference
    from plant3dvision_tpu_torch.models.zoo import install_checkpoint
    from plant3dvision_tpu_torch.ops.training import iou_counts, iou_from_counts

    tdir = work / "train_synth"
    tdir.mkdir(parents=True, exist_ok=True)
    cache, out = tdir / "crops.npz", tdir / "unet_seg.npz"
    common = ["--n-procedural", str(TRAIN_PLANTS), "--views-per-plant",
              str(TRAIN_VIEWS), "--dataset-cache", str(cache),
              "--skip-fixture-eval", "--device", "cuda"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    assert S.main(["--out", str(out), "--steps", str(TRAIN_STEPS),
                   *common]) == 0
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    hist = json.loads(out.with_suffix(".history.json").read_text())
    h, cfg = hist["history"], hist["config"]
    build_s = cfg["dataset"]["build_seconds"]
    step_s = ((h[-1]["seconds"] - h[0]["seconds"])
              / (h[-1]["step"] - h[0]["step"]))

    # the float16 checkpoint through the port's loader and inference
    z = np.load(cache)
    rgb, lab = z["rgb"], z["lab"]
    sdb = make_db(tdir / "db")
    f = install_checkpoint(sdb, scan_id="models", model_id="trained",
                           path=out)
    model, mcfg = load_model(f)
    sdb.disconnect()
    n = len(rgb)
    val_idx = np.random.default_rng(0).permutation(n)[:max(int(n * 0.05), 2)]
    probs = segmentation_inference(model, rgb[val_idx], batch_size=8,
                                   device=torch.device("cuda"))
    pred = probs.argmax(1).to(torch.uint8)
    vlab = torch.from_numpy(lab[val_idx].astype(np.uint8)).cuda()
    f16_iou = iou_from_counts(iou_counts(vlab, len(S.LABELS), preds=pred))
    f16_iou = {S.LABELS[i]: float(v) for i, v in enumerate(f16_iou)
               if v >= 0}

    # resume: 3 chunks checkpointed every chunk, chunk 1 profiled
    states, marks, box = {}, [], []
    orig = S._draw_batch
    S._draw_batch = _profiled_chunk(S, S.STEPS_PER_CALL, marks, box)
    try:
        full, _, fh = S.train_on_crops(
            rgb, lab, steps=3 * S.STEPS_PER_CALL, checkpoint_every_chunks=1,
            on_checkpoint=lambda b, ch: states.setdefault(ch, b),
            device="cuda")
    finally:
        S._draw_batch = orig
    window = marks[1] - marks[0]
    busy, idle, top = _idle_share(box[0], window)
    res, _, rh = S.train_on_crops(rgb, lab, steps=3 * S.STEPS_PER_CALL,
                                  resume_state=states[0], device="cuda")
    resume_equal = ([x["loss"] for x in rh] == [x["loss"] for x in fh]
                    and all(torch.equal(a, b) for a, b in
                            zip(full.parameters(), res.parameters())))
    del full, res

    # TPUSegNet, the TPU-shaped default widths
    seg_out = tdir / "tpusegnet.npz"
    t0 = time.perf_counter()
    assert S.main(["--out", str(seg_out), "--steps", str(SEGNET_STEPS),
                   "--arch", "tpusegnet", *common]) == 0
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    seg = json.loads(seg_out.with_suffix(".history.json").read_text())
    emit({"train_synth": {
        "device": device_name, "arch": cfg["arch"], "widths": cfg["widths"],
        "blocks_per_stage": cfg["blocks_per_stage"], "crop": 448,
        "batch_size": 8, "lr": 3e-3, "steps": TRAIN_STEPS,
        "reduced": {"procedural_plants": [TRAIN_PLANTS, 12],
                    "views_per_plant": [TRAIN_VIEWS, 18],
                    "steps": [TRAIN_STEPS, 3000]},
        "n_crops": int(n), "dataset_build_s": build_s, "run_s": run_s,
        "s_a_warm_step": step_s, "history": h,
        "val_iou_bf16": cfg["val_iou"],
        "checkpoint_mb": out.stat().st_size / 1e6,
        "f16_checkpoint_val_iou": f16_iou,
        "params_m": cfg["train"]["params_m"],
        "launches": {k: launches[k] for k in TRAIN_KERNELS},
        "profiled_chunk": {"steps": S.STEPS_PER_CALL, "wall_s": window,
                           "device_busy_s": busy,
                           "device_idle_share": idle,
                           # the busy time against the unprofiled steps
                           "device_idle_share_at_warm_step": 1.0 - busy / (
                               S.STEPS_PER_CALL * step_s),
                           "top_device": top},
        "resume_from_chunk_0_bit_identical": resume_equal,
        "tpusegnet": {"widths": seg["config"]["widths"],
                      "steps": SEGNET_STEPS, "run_s": seg_s,
                      "history": seg["history"],
                      "val_iou": seg["config"]["val_iou"],
                      "params_m": seg["config"]["train"]["params_m"]}}})
    checks = {
        "loss falls": h[-1]["loss"] < h[0]["loss"],
        "every training kernel launched": all(
            launches[k] > 0 for k in TRAIN_KERNELS),
        "a step: K20 1 launch, K21's pass 1 and its backward 1, K22 1":
        all(launches[k] == TRAIN_STEPS for k in (
            "batch_gather", "weighted_ce", "weighted_ce_backward", "adamw")),
        "float16 checkpoint loads and segments": mcfg["widths"] == [
            24, 48, 96, 192] and "background" in f16_iou,
        "resume from chunk 0 bit-identical": resume_equal,
        "TPUSegNet loss finite": bool(np.isfinite(
            [x["loss"] for x in seg["history"]]).all()),
        "finite numbers": bool(np.isfinite(
            [x["loss"] for x in h] + [step_s, idle]).all()),
    }
    va = torch.from_numpy(rgb[val_idx]).cuda()
    return launches, (rgb, lab), model, (va, vlab), checks


#: the kernels of train.cu, as the profiler names them
TRAIN_CU_KERNELS = ("gather_batch_kernel", "ce_fused_kernel",
                    "ce_keep_kernel", "ce_backward_kernel", "adamw_kernel",
                    "adamw_chunk_sums_kernel", "adamw_tp_update_kernel",
                    "iou_counts_kernel")


def train_device_ms(fn, profile):
    """(device ms a launch by kernel, their sum over train.cu's kernels) of
    fn() (torch.profiler), for `kernel_row`: a call's kernel time, since
    every row that reads it launches each of train.cu's kernels at most
    once a call (asserted: none recorded more often than the calls).
    (None, ...) where `profile` is off (the row's kernel_ms is its
    call's), (None, None) where the profiler recorded nothing (not
    measured)."""
    if not profile:
        return None, ...
    reps, recorded = 10, {}
    by = device_ms_by_kernel(fn, reps=reps, recorded=recorded)
    if by is None:
        return None, None
    mine = [k for k in by if any(n in k for n in TRAIN_CU_KERNELS)]
    assert all(recorded[k] <= reps for k in mine), \
        f"a train.cu kernel launched more than once a call: {recorded}"
    return by, sum(by[k] for k in mine)


def launches_a_call(fn, names):
    """The launches one fn() call adds to each of `names`."""
    from plant3dvision_tpu_torch import kernels
    before = {k: kernels.LAUNCHES[k] for k in names}
    fn()
    return {k: kernels.LAUNCHES[k] - before[k] for k in names}


def ce_rows(path, logits, y, w, ignore, launches, profile=False):
    """K21 on a path's own logits, labels and class weights: the pass
    alone (the loss; within 2e-5 relative of the plain version, the sums'
    order differing; its denominator equal), the general backward (a fresh
    gradient at incoming gradient 1; within 1e-6 of the largest gradient;
    an ignored pixel's gradient zero) and the trainers' call,
    weighted_cross_entropy then .backward() (the pass with its gradient,
    then the backward's check of the incoming gradient on the card; the
    gradient bit-equal to the general backward's), each timed beside its
    plain version and F.cross_entropy (its sum, its autograd, or both),
    the last also beside the pass and the general backward in turn (two
    reads of the logits): three kernel rows. `profile`: each row's device
    time by kernel too."""
    import torch
    import torch.nn.functional as F
    from plant3dvision_tpu_torch.ops import training as T

    ig = -1 if ignore is None else ignore
    B, C = logits.shape[:2]
    npx = y.numel()
    out = T.ce_forward(logits, y, w, ig)
    ref = T.ce_forward_plain(logits, y, w, ig)
    err = float((out[0] - ref[0]).abs())
    assert err <= 2e-5 * float(ref[0].abs()) and out[1] == ref[1], \
        f"K21 forward != plain on {path} ({err})"
    y64 = y.long()
    lib_kw = dict(weight=w, reduction="sum",
                  ignore_index=-100 if ignore is None else ignore)
    extra = {"path": path, "shape": list(logits.shape),
             "ignore_index": ignore,
             "ignored_px": 0 if ignore is None else int((y == ignore).sum())}
    names = ("weighted_ce", "weighted_ce_backward")

    def loss_alone():
        return T.ce_forward(logits, y, w, ig)
    by, kms = train_device_ms(loss_alone, profile)
    rows = [kernel_row(
        "weighted_ce", launches["weighted_ce"], err,
        cuda_ms(loss_alone),
        cuda_ms(lambda: T.ce_forward_plain(logits, y, w, ig)),
        npx * C * 4 + npx + C * 4, npx * (4 * C + 6),
        library=cuda_ms(lambda: F.cross_entropy(logits, y64, **lib_kw)),
        kernel_ms=kms,
        extra={**extra, "mode": "the pass alone (the loss, no gradient)",
               "launches_a_call": launches_a_call(loss_alone, names),
               "device_ms_by_kernel": by,
               "tolerance": "2e-5 relative (sum order)"})]
    g1 = torch.ones(1, device=logits.device)
    d = T.ce_backward(logits, y, w, out, g1, ig)
    pd = T.ce_backward_plain(logits, y, w, out, g1, ig)
    derr = float((d - pd).abs().max())
    assert derr <= 1e-6 * float(pd.abs().max()), \
        f"K21 backward != plain on {path} ({derr})"
    if ignore is not None:
        assert not d.permute(1, 0, 2, 3)[:, y == ignore].any(), \
            f"K21 backward: an ignored pixel has a gradient on {path}"

    def general():
        return T.ce_backward(logits, y, w, out, g1, ig)
    by, kms = train_device_ms(general, profile)
    leaf = logits.clone().requires_grad_()
    lib_loss = F.cross_entropy(leaf, y64, **lib_kw)
    rows.append(kernel_row(
        "weighted_ce_backward", launches["weighted_ce_backward"], derr,
        cuda_ms(general),
        cuda_ms(lambda: T.ce_backward_plain(logits, y, w, out, g1, ig)),
        npx * C * 4 * 2 + npx + C * 4, npx * (4 * C + 4),
        library=cuda_ms(lambda: torch.autograd.grad(
            lib_loss, leaf, retain_graph=True)),
        kernel_ms=kms,
        extra={**extra, "mode": "the general backward, a fresh gradient",
               "launches_a_call": launches_a_call(general, names),
               "device_ms_by_kernel": by,
               "tolerance": "1e-6 of the largest"}))

    # the trainers' call: the pass with its gradient, then .backward()
    lt = logits.clone().requires_grad_()

    def trainers_call():
        lt.grad = None
        loss = T.weighted_cross_entropy(lt, y, w, ignore)
        loss.backward()
        return loss
    loss = trainers_call()
    ferr = float((loss.detach() - ref[0]).abs())
    assert ferr <= 2e-5 * float(ref[0].abs()), \
        f"K21 pass != plain on {path} ({ferr})"
    assert torch.equal(lt.grad, d), \
        f"K21 pass's gradient != the general backward's on {path}"
    by, kms = train_device_ms(trainers_call, profile)
    lib_leaf = logits.clone().requires_grad_()

    def library_call():
        lib_leaf.grad = None
        F.cross_entropy(lib_leaf, y64, **lib_kw).backward()
    rows.append(kernel_row(
        "weighted_ce", launches["weighted_ce"], max(ferr, derr),
        cuda_ms(trainers_call),
        cuda_ms(lambda: T.ce_backward_plain(
            logits, y, w, T.ce_forward_plain(logits, y, w, ig), g1, ig)),
        npx * C * 4 * 2 + npx + C * 4, npx * (6 * C + 8),
        library=cuda_ms(library_call),
        kernel_ms=kms,
        extra={**extra, "mode": "weighted_cross_entropy + .backward(): "
               "the pass with its gradient, the backward's check",
               "pair_ms": cuda_ms(lambda: T.ce_backward(
                   logits, y, w, T.ce_forward(logits, y, w, ig), g1, ig)),
               "launches_a_call": launches_a_call(trainers_call, names),
               "backward_launches": launches["weighted_ce_backward"],
               "device_ms_by_kernel": by,
               "gradient": "bit-equal to the general backward's",
               "tolerance": "2e-5 relative (loss), 1e-6 of the largest "
               "(gradient)"}))
    del lt, leaf, lib_leaf, lib_loss
    return rows


def iou_row(path, lab, C, ignore, launches, logits=None, preds=None,
            profile=False):
    """K23's counts on a path's own labels and logits or predictions,
    equal to the plain version's, timed beside it and beside
    torch.bincount of the kept (label, prediction) pairs: a kernel row
    (`profile`: with its device time by kernel)."""
    import torch
    from plant3dvision_tpu_torch.ops import training as T

    ig = -1 if ignore is None else ignore
    k = T.iou_counts(lab, C, logits=logits, preds=preds, ignore_index=ignore)
    assert torch.equal(k, T.iou_counts_plain(lab, C, logits, preds, ig)), \
        f"K23 != plain on {path}"
    nv = lab.numel()
    l64 = lab.long().reshape(-1)
    keep = None if ignore is None else l64 != ignore

    def library():
        p = (logits.argmax(1) if preds is None else preds).long().reshape(-1)
        pairs = l64 * C + p
        return torch.bincount(pairs if keep is None else pairs[keep],
                              minlength=C * C)
    src = nv * C * 4 if preds is None else nv

    def call():
        return T.iou_counts(lab, C, logits=logits, preds=preds,
                            ignore_index=ignore)
    by, kms = train_device_ms(call, profile)
    return kernel_row(
        "iou_counts", launches["iou_counts"], 0.0, cuda_ms(call),
        cuda_ms(lambda: T.iou_counts_plain(lab, C, logits, preds, ig)),
        src + nv + 3 * C * 8, nv * (C + 4 if preds is None else 4),
        library=cuda_ms(library), kernel_ms=kms,
        extra={"device_ms_by_kernel": by,
               "path": path, "shape": list((logits if preds is None
                                            else preds).shape),
               "input": "logits" if preds is None else "predictions",
               "ignore_index": ignore,
               "ignored_px": 0 if ignore is None else int(
                   (lab == ignore).sum())})


def check_train_kernels(crops, model, val, launches):
    """K20-K23 at phase 22's shapes against their plain versions, timed
    beside them and beside one PyTorch call (or chain) computing the same
    function: K20 on the resident crop set, batch 8; K21 forward and
    backward on the trained model's logits of a batch (8, 6, 448, 448);
    K22 over the ResUNet's 2.03 M parameters in both modes; K23 on the
    held-out crops' logits."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch.models import train_synth as S
    from plant3dvision_tpu_torch.ops import training as T

    rgb, lab = crops
    dev = torch.device("cuda")
    d_rgb = torch.from_numpy(rgb).to(dev)
    d_lab = torch.from_numpy(lab.astype(np.uint8)).to(dev)
    n, c = rgb.shape[:2]
    B, C = 8, len(S.LABELS)
    gen = torch.Generator(device=dev).manual_seed(7)
    idx, flip, gains = S._draw_batch(gen, n, B)
    flip.fill_(1)
    rows = []
    path = "phase 22 (train_synth, ResUNet 24-192, crop 448, batch 8)"

    # K20
    x, y = T.gather_batch(d_rgb, d_lab, idx, flip, gains)
    px, py = T.gather_batch_plain(d_rgb, d_lab, idx, flip, gains)
    assert torch.equal(x, px) and torch.equal(y, py), "K20 != plain"
    px_ = B * c * c

    def k20():
        return T.gather_batch(d_rgb, d_lab, idx, flip, gains)
    by, kms = train_device_ms(k20, True)
    rows.append(kernel_row(
        "batch_gather", launches["batch_gather"], 0.0, cuda_ms(k20),
        cuda_ms(lambda: T.gather_batch_plain(d_rgb, d_lab, idx, flip,
                                             gains)),
        px_ * 4 + px_ * 3 * 4 + px_ + B * 20, px_ * 3 * 4, kernel_ms=kms,
        extra={"path": path, "shape": [B, 3, c, c], "crops_resident": n,
               "device_ms_by_kernel": by}))

    # K21 on the model's logits
    model = model.to(dev).float()
    model.dtype = torch.bfloat16
    with torch.no_grad():
        logits = model(x).float().contiguous()
    _, w = S.class_weights(lab, C)
    w = torch.tensor(w, dtype=torch.float32, device=dev)
    rows += ce_rows(path, logits, y, w, None, launches, profile=True)

    # K22 over the model's parameters (copies: the model is not stepped)
    flat = torch.cat([p.detach().reshape(-1).float()
                      for p in model.parameters()])
    N = flat.numel()
    gg = torch.Generator(device=dev).manual_seed(8)
    grad = 0.01 * torch.randn(N, generator=gg, device=dev)
    mu = 1e-3 * torch.randn(N, generator=gg, device=dev)
    nu = 1e-6 * torch.rand(N, generator=gg, device=dev)
    sc = dict(b1=0.9, b2=0.999, bc1=np.float32(0.1), bc2=np.float32(1e-3),
              eps=1e-8, eps_root=0.0, wd=1e-4, neg_lr=-np.float32(3e-3),
              max_norm=1.0)
    errs = {}
    for clip in (True, False):
        a = [t.clone() for t in (flat, grad, mu, nu)]
        b = [t.clone() for t in (flat, grad, mu, nu)]
        T.adamw_update(*a, clip=clip, **sc)
        T.adamw_update_plain(*b, clip=clip, **sc)
        errs[clip] = max(float((u - v).abs().max()) for u, v in zip(a, b))
    assert errs[False] == 0.0 and errs[True] <= 1e-6, f"K22 != plain {errs}"
    arena = [t.clone() for t in (flat, grad, mu, nu)]
    lp = [torch.nn.Parameter(p.detach().float().clone())
          for p in model.parameters()]
    gsrc = torch.split(grad, [p.numel() for p in lp])
    for p, g in zip(lp, gsrc):
        p.grad = g.view_as(p).clone()
    opt = torch.optim.AdamW(lp, lr=3e-3, weight_decay=1e-4, fused=True)

    def library_step():
        torch.nn.utils.clip_grad_norm_(lp, 1.0)
        opt.step()
    # the trainers' call: the kernel bound to the arenas (models/optim.py)
    per_step = {k: sc[k] for k in ("bc1", "bc2", "neg_lr")}
    bound = T.adamw_launcher(*arena, clip=True, **{
        k: v for k, v in sc.items() if k not in per_step})

    def k22():
        bound(**per_step)
    by, kms = train_device_ms(k22, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        k22()
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    rows.append(kernel_row(
        "adamw", launches["adamw"], errs[True], cuda_ms(k22),
        cuda_ms(lambda: T.adamw_update_plain(
            *[t.clone() for t in (flat, grad, mu, nu)], clip=True, **sc)),
        N * 28, N * 22, library=cuda_ms(library_step), kernel_ms=kms,
        extra={"path": path, "parameters": N, "mode": "clip + adamw",
               "max_abs_err_no_clip": errs[False],
               "launches_a_step": launches_a_call(k22, ("adamw",))["adamw"],
               "host_us_a_call": host_us,
               "device_ms_by_kernel": by}))

    # K23 on the held-out crops' logits
    va, vlab = val
    with torch.no_grad():
        vx = (va.float() * T.INV255).permute(0, 3, 1, 2).contiguous()
        vlog = model(vx).float().contiguous()
    rows.append(iou_row(path, vlab, C, None, launches, logits=vlog,
                        profile=True))
    del d_rgb, d_lab, logits, vlog
    torch.cuda.empty_cache()
    return rows


#: phase 23: configs/training_seg.toml on phase 5's scan (its first
#: TRAIN_SEG_IMAGES views and their organ masks), 2 epochs; the labels:
#: background and the organs that ML_GT_FILESET holds masks of
TRAIN_SEG_IMAGES, TRAIN_SEG_EPOCHS = 32, 2
TRAIN_SEG_LABELS = ["background", "fruit", "leaf", "pedicel", "stem"]


def run_training_seg(work, ml_scan, device_name):
    """Phase 23: `python -m plant3dvision_tpu_torch.models.train` (main)
    with configs/training_seg.toml (widths 32, 64, 128 at 896x896, batch
    4, lr 1e-4) on a copy of phase 5's first TRAIN_SEG_IMAGES views and
    their organ masks (ML_GT_FILESET, label_names set on it) in a DB of
    its own, 2 epochs (depth reduced from the config's 50); then the
    config's Segmentation2D with the trained model, which
    ModelFilesetExists(scan_id="models") finds in the scan itself (the DB
    holds no "models" scan, as the config's pipeline expects); K21 held
    against its plain version on the phase's first batch. Returns (checks,
    kernel rows)."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.models import train as ptrain
    from plant3dvision_tpu_torch.models.checkpoint import load_model
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.runtime.config import load_toml

    tdb = make_db(work / "db_training_seg")
    src_img = ml_scan.get_fileset("images")
    src_gt = ml_scan.get_fileset(ML_GT_FILESET)
    scan = tdb.get_scan("train", create=True)
    imgs = scan.get_fileset("images", create=True)
    gt = scan.get_fileset(ML_GT_FILESET, create=True)
    files = sorted(src_img.get_files(), key=lambda f: f.id)[:TRAIN_SEG_IMAGES]
    shots = {f.get_metadata("shot_id") for f in files}
    for f in files + [m for m in src_gt.get_files()
                      if m.get_metadata("shot_id") in shots]:
        g = (imgs if f.fileset.id == "images" else gt).create_file(f.id)
        io.from_file(g, f.path())
        g.set_metadata(f.get_metadata())
    # the labels the masks cover: train.py weights a class absent from
    # the data (flower here) with almost all the loss (ROADMAP Queue C)
    gt.set_metadata("label_names", TRAIN_SEG_LABELS)
    tdb.disconnect()

    config = ROOT / "configs" / "training_seg.toml"
    toml = load_toml(config)
    model_id = toml["Training"]["model_id"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    assert ptrain.main([str(work / "db_training_seg" / "train"), "--config",
                        str(config), "--gt-fileset", ML_GT_FILESET,
                        "--epochs", str(TRAIN_SEG_EPOCHS),
                        "--device", "cuda"]) == 0
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    from plant3dvision_tpu_torch.fsdb import FSDB
    tdb = FSDB(work / "db_training_seg")
    tdb.connect(unsafe=True)
    scan = tdb.get_scan("train")
    mf = scan.get_fileset("models").get_file(model_id)
    mcfg = mf.get_metadata("model_config")
    cfg = {k: dict(v) for k, v in toml.items() if k != "Training"}
    t0 = time.perf_counter()
    rep = run_task(RunContext(tdb, "train", cfg, device="cuda"),
                   "Segmentation2D", report=False)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    seg_fs = scan.get_fileset(rep["Segmentation2D"]["fileset"])
    seg_files = seg_fs.get_files()
    fruit = [f for f in seg_files if f.get_metadata("channel") == "fruit"]
    cover = float(np.mean([io.read_image(f).astype(bool).mean()
                           for f in fruit[:8]])) if fruit else None

    # K21 on the phase's own first batch (train's batch order and class
    # weights) through the trained model
    images, labels_int, names = ptrain.load_dataset(scan, ML_GT_FILESET)
    tdb.disconnect()
    dev = torch.device("cuda")
    bs = int(toml["Training"]["batch_size"])
    sel = np.random.default_rng(0).permutation(len(images))[:bs]
    x = torch.from_numpy(images[sel]).to(dev).permute(0, 3, 1, 2)
    y = torch.from_numpy(labels_int[sel].astype(np.uint8)).to(dev)
    w = torch.tensor(ptrain.class_weights(labels_int, len(names)),
                     dtype=torch.float32, device=dev)
    del images
    model, _ = load_model(mf)
    model = model.to(dev)
    model.dtype = torch.bfloat16
    with torch.no_grad():
        logits = model(x.contiguous()).float().contiguous()
    rows = ce_rows("phase 23 (training_seg.toml, ResUNet 32-128, 896x896, "
                   f"batch {bs})", logits, y, w, None, launches)
    del model, x, logits
    torch.cuda.empty_cache()
    emit({"training_seg": {
        "device": device_name, "config": "configs/training_seg.toml",
        "model_id": model_id, "widths": mcfg["widths"],
        "label_names": mcfg["label_names"], "images": len(files),
        "image": [896, 896], "batch_size": 4, "lr": 1e-4,
        "epochs": [TRAIN_SEG_EPOCHS, 50],
        "train_s": train_s, "launches": {
            k: launches[k] for k in TRAIN_KERNELS},
        "segmentation2d_s": seg_s, "segmented_files": len(seg_files),
        "fruit_mask_cover_first_8": cover}})
    return {
        "trained model in the scan's models fileset": mcfg["widths"] == [
            32, 64, 128],
        "a step: K21's pass 1 launch and its backward 1, K22 1": all(
            launches[k] == TRAIN_SEG_EPOCHS * max(TRAIN_SEG_IMAGES // bs, 1)
            for k in ("weighted_ce", "weighted_ce_backward", "adamw")),
        "Segmentation2D wrote masks with the trained model": len(
            seg_files) >= TRAIN_SEG_IMAGES}, rows


#: phase 24: distill_scan on phase 9's scan, steps cut from 2000
DISTILL_STEPS = 100     # 200 before phase 25 took its time


def run_distill(db, device_name):
    """Phase 24: models/distill.py's distill_scan on phase 9's front-end
    scan (frontend_config: its tasks are complete from phase 9, so the
    geometric route is read back), the ResUNet at (24, 48, 96, 192), crop
    448, 10 crops a view, DISTILL_STEPS steps (cut from 2000), every 6th
    view held out; K21 (with the ignored label) and K23 (from a held-out
    view's predictions) held against their plain versions on the phase's
    own inputs. Returns (checks, kernel rows)."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.models import distill
    from plant3dvision_tpu_torch.runtime import RunContext

    ctx = RunContext(db, "frontend", frontend_config(), device="cuda")
    box = {}
    build_crops, heldout_iou = distill.build_crops, distill._heldout_iou

    def keep_crops(*a, **k):
        box["crops"] = build_crops(*a, **k)
        return box["crops"]

    def keep_heldout(model, imgs, label_maps, **k):
        box["heldout"] = (imgs, label_maps)
        return heldout_iou(model, imgs, label_maps, **k)
    distill.build_crops, distill._heldout_iou = keep_crops, keep_heldout
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        model, config, report = distill.distill_scan(ctx,
                                                     steps=DISTILL_STEPS)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        distill.build_crops, distill._heldout_iou = build_crops, heldout_iou
    emit({"distill": {
        "device": device_name, "scan": "frontend (phase 9)",
        "steps": [DISTILL_STEPS, 2000], "s": s,
        "pseudo_labels": report["stats"], "history": report["history"],
        "val_crop_iou": config["val_iou"],
        "heldout_view_iou": report["heldout_iou"],
        "launches": {k: launches[k] for k in TRAIN_KERNELS}}})
    hist = report["history"]

    # K21 with the ignored label on a batch of the phase's own crops (K20
    # gathers it as the trainer does) and K23 from the predictions of its
    # first held-out view, through the distilled model
    from plant3dvision_tpu_torch.models import train_synth as S
    from plant3dvision_tpu_torch.ops import training as T
    path = "phase 24 (distill_scan, ResUNet 24-192, crop 448, batch 8)"
    dev = torch.device("cuda")
    rgb, lab = box["crops"]
    C = len(distill.LABELS_REAL)
    d_rgb = torch.from_numpy(rgb).to(dev)
    d_lab = torch.from_numpy(lab.astype(np.uint8)).to(dev)
    idx, flip, gains = S._draw_batch(
        torch.Generator(device=dev).manual_seed(7), len(rgb), 8)
    x, y = T.gather_batch(d_rgb, d_lab, idx, flip, gains)
    _, w = S.class_weights(lab, C, distill.IGNORE)
    w = torch.tensor(w, dtype=torch.float32, device=dev)
    with torch.no_grad():
        logits = model(x).float().contiguous()
    rows = ce_rows(path, logits, y, w, distill.IGNORE, launches)
    del d_rgb, d_lab, x, logits
    imgs, label_maps = box["heldout"]
    pred = distill._tiled_argmax(model, imgs[0], 448)
    vlab = torch.from_numpy(np.ascontiguousarray(label_maps[0], np.uint8)
                            ).to(dev)
    rows.append(iou_row(path, vlab[None], C, distill.IGNORE, launches,
                        preds=pred[None], profile=True))
    del model
    torch.cuda.empty_cache()
    return {
        "pseudo-labels with both organs": report["stats"][
            "fruit_point_fraction"] > 0 and report["stats"][
            "labeled_plant_px_per_view"] > 0,
        "every training kernel launched": all(
            launches[k] > 0 for k in TRAIN_KERNELS),
        "a step (one K20): K21's pass 2 launches (ignore 255) and its "
        "backward 1, K22 1": launches["weighted_ce"] == 2 * launches[
            "batch_gather"] and launches["weighted_ce_backward"] == launches[
            "adamw"] == launches["batch_gather"],
        "held-out view IoU for stem and background": {
            "background", "stem"} <= set(report["heldout_iou"]),
        "finite loss": bool(np.isfinite([h["loss"] for h in hist]).all())}, \
        rows


#: phase 25: the multi-rank programs (parallel/). One card: the ranks share
#: it over gloo (a one-rank NCCL group besides), so every time here is
#: "ranks share one card: not a speed-up"
PAR_RANKS, PAR_SEG_IMAGES, PAR_TRAIN_STEPS, PAR_CURVE_STEPS = 8, 32, 50, 20
PAR_CHECK_STEPS = 3
#: the trainer's layouts: every rank on dp, and the JAX package's
#: best_dp_tp(8), which train_on_crops(use_mesh=True) lays
PAR_DP, PAR_TP = {"dp": 8}, {"dp": 2, "tp": 4}
#: train_on_crops at PAR_TP runs on the centres of phase 22's 448 crops:
#: over gloo a tp step at 448 all-gathers ~1.2 GB into each rank (bf16)
PAR_TP_CROP = 224
PAR_NOTE = "ranks share one card: not a speed-up"
PAR_KERNELS = ("carve", "average", "batch_gather", "weighted_ce",
               "weighted_ce_backward", "adamw", "adamw_tp", "iou_counts")


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _start_mesh(box, **kw):
    from plant3dvision_tpu_torch.parallel.mesh import make_mesh
    try:
        box["mesh"] = make_mesh(**kw)
    except Exception as e:               # raised by the phase's thread
        box["error"] = e


def _par_crops(work):
    """Phase 22's crop set (its dataset cache when phase 22 ran)."""
    import numpy as np
    from plant3dvision_tpu_torch.models import train_synth as S
    cache = work / "train_synth" / "crops.npz"
    if cache.exists():
        z = np.load(cache)
        return z["rgb"], z["lab"]
    rgb, lab, _ = S.build_training_set(n_procedural=TRAIN_PLANTS,
                                       views_per_plant=TRAIN_VIEWS, crop=448,
                                       seed=0)
    return rgb, lab


def _par_check_batches(rgb, lab, dev):
    """The first PAR_CHECK_STEPS draws of train_on_crops (K20) from
    phase 22's crop set, on the card, and its class weights (CPU)."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch.models import train_synth as S
    from plant3dvision_tpu_torch.ops import training as T

    n = len(rgb)
    perm = np.random.default_rng(0).permutation(n)
    tr_idx = perm[max(int(n * 0.05), 2):]
    d_rgb = torch.from_numpy(np.ascontiguousarray(rgb[tr_idx])).to(dev)
    d_lab = torch.from_numpy(np.ascontiguousarray(
        lab[tr_idx].astype(np.uint8))).to(dev)
    gen = torch.Generator(device=dev)
    batches = []
    for step in range(PAR_CHECK_STEPS):
        gen.manual_seed(S._step_seed(0, step))
        idx, flip, gains = S._draw_batch(gen, len(tr_idx), 8)
        batches.append(T.gather_batch(d_rgb, d_lab, idx, flip,
                                      gains.contiguous()))
    w = torch.tensor(S.class_weights(lab, len(S.LABELS))[1],
                     dtype=torch.float32)
    return batches, w


def _par_make():
    import torch
    from plant3dvision_tpu_torch.models import train_synth as S
    return S._make_model("resunet", 0, (24, 48, 96, 192), 2,
                         dtype=torch.float32)


def _par_reference(layout, batches, w, dev, clip=None):
    """PAR_CHECK_STEPS float32 steps of phase 22's ResUNet with the
    trainer's optimizer (AdamW, the clip by the global norm, weight decay
    1e-4, lr 1e-3) on one device computing the decomposition of
    `layout`'s ranks itself: the convolutions split over tp
    (parallel/tp.py:decompose: each split conv's Cout slices one after
    the other, the input's gradients summed in rank order), each dp
    part's backward x its share of the loss' denominator, summed in rank
    order, then K22 over the ranks' arena layout (at tp > 1 its tp lane,
    the chunk sums in the ranks' order). `clip` None: half the first
    step's gradient norm at this layout, so that every step scales the
    gradient. Returns the spec, the losses, the one-device layout's state
    (flattened flax params, optimizer leaves) and a step's conv
    multiply-adds."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch.models import train_synth as S
    from plant3dvision_tpu_torch.models.checkpoint import _flatten
    from plant3dvision_tpu_torch.models.optim import AdamW
    from plant3dvision_tpu_torch.ops import training as T
    from plant3dvision_tpu_torch.parallel import tp as tpm

    dp, tp = layout.get("dp", 1), layout.get("tp", 1)
    per = 8 // dp
    wd = w.to(dev)

    def build(spec):
        m = _par_make()
        if tp > 1:
            m = tpm.decompose(m, tp)
        m = m.to(dev)
        kw = dict(regions=tpm.regions(m), gather_sums=lambda p: [p]) \
            if tp > 1 else {}
        return m, AdamW(m, **spec, **kw)

    def grad_into(one, opt, x, y):
        """The ranks' gradient on one device; the global loss."""
        parts, total = [], None
        with tpm.conv_macs(one) as macs:
            for r in range(dp):
                h = slice(r * per, (r + 1) * per)
                opt.zero_grad()
                lh = T.weighted_cross_entropy(one(x[h]), y[h], wd)
                lh.backward()
                share = torch.tensor(1.0 / dp, device=dev)  # equal pixels
                parts.append(opt.grad * share)
                t = lh.detach() * share
                total = t if total is None else total + t
        opt.grad.copy_(parts[0])
        for g in parts[1:]:
            opt.grad.add_(g)
        return float(total), macs

    with S.deterministic_backward():
        if clip is None:
            probe, popt = build({"lr": 0.0})
            grad_into(probe, popt, *batches[0])
            clip = float(torch.sqrt((popt.grad * popt.grad).sum())) / 2
            del probe, popt
        spec = {"lr": 1e-3, "clip": clip, "weight_decay": 1e-4}
        one, opt = build(spec)
        losses = []
        for x, y in batches:
            loss, macs = grad_into(one, opt, x, y)
            opt.step()
            losses.append(loss)
    if tp > 1:
        params, leaves = tpm.decomposed_state(one, opt)
    else:
        from plant3dvision_tpu_torch.models.checkpoint import flax_params
        params, leaves = flax_params(one), opt.state_leaves()
    n_params = sum(int(np.prod(np.shape(v)))
                   for v in _flatten(params).values())
    del one, opt
    torch.cuda.empty_cache()
    return {"spec": spec, "loss": losses, "params": _flatten(params),
            "leaves": leaves, "conv_macs": dict(macs),
            "n_params": n_params}


def _par_mesh_steps(mesh, layout, spec, batches, w):
    """The same steps through the MeshTrainer that train_on_crops lays
    over `layout` (a view of `mesh`): losses, seconds a step, the state in
    the one-device layout (the tp slices gathered) and each rank's share
    (`MeshTrainer.rank_stats`)."""
    from plant3dvision_tpu_torch.models.checkpoint import _flatten
    from plant3dvision_tpu_torch.parallel.train import MeshTrainer

    tr = MeshTrainer(mesh.view(layout), _par_make(), spec, weights=w)
    losses, secs = [], []
    for x, y in batches:
        loss, s = _timed(lambda: tr.step(x.cpu(), y.cpu()))
        losses.append(loss)
        secs.append(s)
    params, leaves = tr.state()
    stats = tr.rank_stats()
    tr.close()
    return {"loss": losses, "step_s": secs, "params": _flatten(params),
            "leaves": leaves, "ranks": stats}


def _par_compare(layout, ref, got):
    """The mesh's steps against one device's decomposition: the losses,
    the parameters' and both moments' largest differences (0 where the
    mesh computes the same arithmetic) and their scales, and each rank's
    share against one device's (parameters, conv multiply-adds a step,
    bytes all-gathered into a rank)."""
    import numpy as np
    k = len(ref["params"])

    def diff(a, b):
        return float(max(np.abs(np.asarray(p) - np.asarray(q)).max()
                         for p, q in zip(a, b)))

    def scale(a):
        return float(max(np.abs(np.asarray(p)).max() for p in a))
    pw, pg = ref["params"], got["params"]
    lw, lg = ref["leaves"], got["leaves"]
    r0 = got["ranks"][0]
    return {
        "layout": layout, "steps": PAR_CHECK_STEPS,
        "images_a_rank": 8 // layout.get("dp", 1), "spec": ref["spec"],
        "first_grad_norm": 2 * ref["spec"]["clip"],
        "loss_one_device": ref["loss"], "loss_mesh": got["loss"],
        "step_s": got["step_s"], "note": PAR_NOTE,
        "loss_max_abs_diff": float(np.abs(np.subtract(
            got["loss"], ref["loss"])).max()),
        "same_leaves": list(pg) == list(pw) and len(lg) == len(lw),
        "params_max_abs_diff": diff([pg[n] for n in pw], pw.values()),
        "params_scale": scale(pw.values()),
        "mu_max_abs_diff": diff(lg[1:1 + k], lw[1:1 + k]),
        "mu_scale": scale(lw[1:1 + k]),
        "nu_max_abs_diff": diff(lg[1 + k:1 + 2 * k], lw[1 + k:1 + 2 * k]),
        "nu_scale": scale(lw[1 + k:1 + 2 * k]),
        "count_equal": int(lg[0]) == int(lw[0]) == PAR_CHECK_STEPS,
        "params_one_device": ref["n_params"],
        "params_a_rank": [r["params"] for r in got["ranks"]],
        "arena_a_rank": [r["arena"] for r in got["ranks"]],
        "conv_macs_a_step_one_device": ref["conv_macs"],
        "conv_macs_a_step_rank_0": r0["conv_macs"],
        "conv_macs_equal_on_every_rank": all(
            r["conv_macs"] == r0["conv_macs"] for r in got["ranks"]),
        "gathered_bytes_a_step_rank_0": r0["gathered_bytes"]}


def _par_exact(c):
    return (c["same_leaves"] and c["loss_max_abs_diff"] == 0
            and c["params_max_abs_diff"] == 0 and c["mu_max_abs_diff"] == 0
            and c["nu_max_abs_diff"] == 0 and c["count_equal"])


def par_k22_tp_row(launches, tp=4):
    """K22's tp lane at the shapes the ranks of phase 25's dp 2 x tp 4
    layout give it: a rank's arena of phase 22's ResUNet (the replicated
    parameters, then its Cout rows of the split kernels, each region
    padded to K22's chunk, the padding 0), the replicated gradient equal
    on the 4 ranks and their slices their own. Each rank's first launch
    (the chunk sums) against the plain version; the sums gathered as the
    trainer gathers them (rank 0's replicated chunks, then each rank's
    slice chunks); rank 0's two launches with them against the plain
    version on the same inputs; the lane timed with its arenas in HBM and
    in the L2. Its bound counts g read once (28 bytes a parameter) and the
    sums."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch.ops import training as T
    from plant3dvision_tpu_torch.parallel import tp as tpm

    dev = torch.device("cuda")
    m = _par_make()
    tpm.shard(m, tpm.ColumnParallel(0, tp, None))
    rep, mine = (sum(p.numel() for p in r) for r in tpm.regions(m))
    C = T.ADAMW_CHUNK
    pad = lambda k: -(-k // C) * C                   # noqa: E731
    n, rc = pad(rep) + pad(mine), pad(rep) // C
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    live[:rep] = True
    live[pad(rep):pad(rep) + mine] = True
    gg = torch.Generator(device=dev).manual_seed(8)

    def rand(scale, fn=torch.randn):
        return torch.where(live, scale * fn(n, generator=gg, device=dev),
                           0.0)
    shared = [rand(0.1), rand(0.01), rand(1e-3), rand(1e-6, torch.rand)]
    ranks = []
    for t in range(tp):
        a = [rand(0.1), rand(0.01), rand(1e-3), rand(1e-6, torch.rand)]
        ranks.append([torch.where(torch.arange(n, device=dev) < pad(rep),
                                  s, x) for s, x in zip(shared, a)])
    sc = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, wd=1e-4,
              max_norm=1.0)
    per_step = dict(bc1=np.float32(0.1), bc2=np.float32(1e-3),
                    neg_lr=-np.float32(3e-3))
    sums, part_err = [], 0.0
    for r in ranks:
        got = {}

        def record(part, got=got):
            got["part"] = part.clone()
            return part
        T.adamw_launcher(*[t.clone() for t in r], clip=True, tp_sums=record,
                         **sc)(**per_step)
        want = T.adamw_partials_plain(r[1])
        part_err = max(part_err, float((got["part"] - want).abs().max()))
        sums.append(got["part"])
    gathered = torch.cat([sums[0][:rc]] + [s[rc:] for s in sums])
    norm = T.adamw_norm_plain(gathered)
    a = [t.clone() for t in ranks[0]]
    b = [t.clone() for t in ranks[0]]
    T.adamw_launcher(*a, clip=True, tp_sums=lambda part: gathered,
                     **sc)(**per_step)
    T.adamw_update_plain(*b, clip=True, gnorm=norm, **sc, **per_step)
    err = max(float((u - v).abs().max()) for u, v in zip(a, b))
    assert part_err == 0.0 and err == 0.0, \
        f"K22's tp lane != plain: sums {part_err}, update {err}"
    def make_step():
        step = T.adamw_launcher(*[t.clone() for t in ranks[0]], clip=True,
                                tp_sums=lambda part: gathered, **sc)
        return lambda: step(**per_step)
    # timed cold, as a training step finds p, mu and nu: copies of the
    # arena in turn; and warm, one arena the L2 holds
    k22tp, warm = cold_turns(make_step, 16 * n), make_step()
    plain_arena = [t.clone() for t in ranks[0]]

    def plain():
        T.adamw_partials_plain(plain_arena[1])
        T.adamw_update_plain(*plain_arena, clip=True,
                             gnorm=T.adamw_norm_plain(gathered), **sc,
                             **per_step)
    by, kms = train_device_ms(k22tp, True)
    by_warm, kms_warm = train_device_ms(warm, True)
    m_sums = gathered.numel()
    return kernel_row(
        "adamw_tp", launches["adamw_tp"], err, cuda_ms(k22tp),
        cuda_ms(plain), n * 28 + (n // C + m_sums) * 4, n * 24,
        kernel_ms=kms,
        extra={"path": "parallel", "tp": tp, "rank_arena": n,
               "replicated": rep, "slices": mine, "gathered_sums": m_sums,
               "gradient_norm": float(norm),
               "mode": "tp lane: the chunk sums, then the clipped update "
                       "with the gathered sums' norm",
               "max_abs_err_chunk_sums": part_err,
               "launches_a_step": launches_a_call(
                   k22tp, ("adamw_tp",))["adamw_tp"],
               "library": "none (no one call clips by a norm it is given)",
               "device_ms_by_kernel": by, "kernel_ms_warm": kms_warm,
               "device_ms_by_kernel_warm": by_warm,
               "note": "gathers not timed; ms and kernel_ms over arenas "
                       "in HBM (cold_turns), *_warm over one in the L2"})


def run_parallel(db, work, sep_scan, sep_report, device_name):
    """Phase 25: parallel/ on one card, ranks sharing it over gloo: the
    carves of bench.py's workload (view-sharded at 4 ranks and at 1 NCCL
    rank, grid-sharded at 4 with x padded to 304, 2-D on 2 x 2) bit-equal
    to the one-device K1 volume; K1 with x_start against its plain version
    on one slab; the x-slab averaging volume at 4 ranks on phase 7's fruit
    masks bit-equal to one device's K5-avg; dp serving at 2 ranks on 32 of
    phase 5's images equal to one device; train_on_crops(use_mesh=True)
    on best_dp_tp(8) (dp 2 x tp 4, the convolutions split over tp) at
    phase 22's width on PAR_TP_CROP crops for 2 chunks against the
    one-device run, and a resume from chunk 0 bit-identical; the
    trainer's clipped float32 steps at dp 8 and at dp 2 x tp 4 against
    one device computing the ranks' decomposition (`_par_reference`),
    with each rank's parameters, conv multiply-adds and gathered bytes;
    K22's tp lane against its plain version (bit-equal: the chunk sums and
    the update); then tools/evaluate_model
    on phase 5's scan. The one-device references run first; the launch
    counts are set to 0 just before the sharded programs and read just
    after (the ranks' launches, merged into the controller's
    counts)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.models import train_synth as S
    from plant3dvision_tpu_torch.models.checkpoint import load_model
    from plant3dvision_tpu_torch.models.unet import segmentation_inference
    from plant3dvision_tpu_torch.models.zoo import install_checkpoint
    from plant3dvision_tpu_torch.ops import carving
    from plant3dvision_tpu_torch.parallel.carving import (
        average_grid_sharded, carve_2d_sharded, carve_grid_sharded,
        carve_sharded)
    from plant3dvision_tpu_torch.parallel.mesh import best_dp_tp, make_mesh
    from plant3dvision_tpu_torch.runtime.config import dump_toml

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    nccl = {}
    th = threading.Thread(target=_start_mesh, args=(nccl,), kwargs=dict(
        axis_shapes={"dp": 1}, device="cuda", backend="nccl"))
    th.start()
    mesh, spawn_s = _timed(lambda: make_mesh(
        {"dp": PAR_RANKS}, device="cuda", backend="gloo"))
    th.join()
    if "error" in nccl:
        raise nccl["error"]
    m4 = mesh.view({"dp": 4})

    # the one-device references, before the counts are reset
    rows_np, cams_np, origin, vs, shape, hw = real_grid_workload()
    V = len(rows_np)
    pk = torch.from_numpy(rows_np).to(dev)
    cm = torch.from_numpy(cams_np).to(dev)
    va = torch.ones(V, dtype=torch.bool, device=dev)
    carve = carving.carve
    one, one_s = _timed(lambda: carve(pk, cm, va, origin, vs, shape, hw))
    fs = sep_scan.get_fileset(sep_report["Segmentation2D"]["fileset"])
    files = [f for f in fs.get_files() if f.get_metadata("channel") == "fruit"]
    with ThreadPoolExecutor(8) as ex:
        fm = np.stack(list(ex.map(io.read_image, files))).astype(
            np.float32) / 255.0
    acams = np.stack([carving.camera_from_metadata(f.get_metadata("camera"))
                      for f in files])
    a_origin, a_shape = grid_of(sep_scan.get_metadata("bounding_box"),
                                ML_VOXEL)
    fm_d = torch.from_numpy(fm).to(dev)
    acm = torch.from_numpy(acams).to(dev)
    ava = torch.ones(len(files), dtype=torch.bool, device=dev)
    avg_one, avg_one_s = _timed(lambda: carving.average(
        fm_d, acm, ava, a_origin, ML_VOXEL, a_shape))
    img_files = sep_scan.get_fileset("images").get_files()[:PAR_SEG_IMAGES]
    with ThreadPoolExecutor(8) as ex:
        imgs = np.stack([im[..., :3] for im in ex.map(io.read_image,
                                                      img_files)])
    seg_model, _ = load_model(install_checkpoint(db))
    # dp serving runs each rank's part of a batch of ML_BATCH: the
    # one-device reference runs batches of that part's size (cuDNN picks
    # its algorithms by batch size), and the route's batch is reported
    seg_one, seg_one_s = _timed(lambda: segmentation_inference(
        seg_model, imgs, batch_size=ML_BATCH // 2, data_parallel=False,
        device=dev))
    seg_route = segmentation_inference(seg_model, imgs, batch_size=ML_BATCH,
                                       data_parallel=False, device=dev)
    rgb, lab = _par_crops(work)
    batches, cw = _par_check_batches(rgb, lab, dev)
    ref_dp = _par_reference(PAR_DP, batches, cw, dev)
    ref_tp = _par_reference(PAR_TP, batches, cw, dev,
                            clip=ref_dp["spec"]["clip"])
    lo = (rgb.shape[1] - PAR_TP_CROP) // 2
    rgb = np.ascontiguousarray(rgb[:, lo:lo + PAR_TP_CROP,
                                   lo:lo + PAR_TP_CROP])
    lab = np.ascontiguousarray(lab[:, lo:lo + PAR_TP_CROP,
                                   lo:lo + PAR_TP_CROP])
    # per-step losses of chunk 0 (reported: the dp split's other summation
    # order, amplified by Adam, moves them past the JAX test's bar within
    # a few steps at this width, in float32 too, run 22.3)
    curves = {}

    def curve(key):
        return lambda ch, losses: curves.setdefault(key, losses) if ch == 0 \
            else None
    (_, _, h1), train_one_s = _timed(lambda: S.train_on_crops(
        rgb, lab, steps=PAR_TRAIN_STEPS, device="cuda", use_mesh=False,
        on_chunk=curve("bf16_one")))

    # the sharded programs: the path whose launches the phase counts
    torch.cuda.synchronize()
    kernels.reset_launches()
    v4, v4_s = _timed(lambda: carve_sharded(rows_np, cams_np, np.ones(V, bool),
                                            origin, vs, shape, m4, hw=hw))
    v1, v1_s = _timed(lambda: carve_sharded(
        rows_np, cams_np, np.ones(V, bool), origin, vs, shape, nccl["mesh"],
        hw=hw))
    nxp = -(-shape[0] // 4) * 4
    g4, g4_s = _timed(lambda: carve_grid_sharded(
        rows_np, cams_np, np.ones(V, bool), origin, vs,
        (nxp, *shape[1:]), m4, hw=hw)[:shape[0]])
    d22, d22_s = _timed(lambda: carve_2d_sharded(
        rows_np, cams_np, np.ones(V, bool), origin, vs,
        (nxp, *shape[1:]), mesh.view({"vp": 2, "gp": 2}), hw=hw)[:shape[0]])
    anx = -(-a_shape[0] // 4) * 4
    avg4, avg4_s = _timed(lambda: average_grid_sharded(
        fm, acams, np.ones(len(files), bool), a_origin, ML_VOXEL,
        (anx, *a_shape[1:]), m4)[:a_shape[0]])
    seg2, seg2_s = _timed(lambda: segmentation_inference(
        seg_model, imgs, batch_size=ML_BATCH, data_parallel=True, device=dev,
        mesh=mesh.view({"dp": 2})))
    states = {}
    tmesh = mesh.view(best_dp_tp(PAR_RANKS))
    (full, _, h8), train8_s = _timed(lambda: S.train_on_crops(
        rgb, lab, steps=PAR_TRAIN_STEPS, device="cuda", use_mesh=True,
        mesh=tmesh, checkpoint_every_chunks=1,
        on_checkpoint=lambda b, ch: states.setdefault(ch, b),
        on_chunk=curve("bf16_mesh")))
    got_dp = _par_mesh_steps(mesh, PAR_DP, ref_dp["spec"], batches, cw)
    got_tp = _par_mesh_steps(mesh, PAR_TP, ref_tp["spec"], batches, cw)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    del batches
    check_dp = _par_compare(PAR_DP, ref_dp, got_dp)
    check_tp = _par_compare(PAR_TP, ref_tp, got_tp)
    (res, _, hr), resume_s = _timed(lambda: S.train_on_crops(
        rgb, lab, steps=PAR_TRAIN_STEPS, device="cuda", use_mesh=True,
        mesh=tmesh, resume_state=states[0]))
    resume_equal = ([x["loss"] for x in hr] == [x["loss"] for x in h8]
                    and all(torch.equal(a, b) for a, b in
                            zip(full.parameters(), res.parameters())))
    l1 = np.array([x["loss"] for x in h1])
    l8 = np.array([x["loss"] for x in h8])
    c = {k: v.numpy().astype(float) for k, v in curves.items()}
    # the JAX test's bar on the first 20 step losses, reported
    curve_ok = bool(np.allclose(c["bf16_mesh"][:PAR_CURVE_STEPS],
                                c["bf16_one"][:PAR_CURVE_STEPS], rtol=1e-3,
                                atol=1e-4))

    def rel(a, b):
        return (np.abs(c[a] - c[b]) / np.abs(c[b])).tolist()
    del full, res

    # the kernel row of this path's new argument: K1 with x_start on one
    # slab
    rows = []
    xs, sx = nxp // 4, nxp // 4
    slab = (sx, *shape[1:])
    k1 = lambda: carve(pk, cm, va, origin, vs, slab, hw, x_start=xs)  # noqa
    ks = k1()
    plain = carving.carve_plain(pk, cm, va, origin, vs, slab, hw,
                                x_start=xs)
    least, least_bytes = carving.carve_least_work(
        plain, pk, cm, va, origin, vs, slab, hw, x_start=xs)
    rows.append(kernel_row(
        "carve", launches["carve"],
        int((ks.int() - plain.int()).abs().max()), cuda_ms(k1, reps=5),
        cuda_ms(lambda: carving.carve_plain(pk, cm, va, origin, vs, slab, hw,
                                            x_start=xs), reps=1, warmup=0),
        least_bytes + cm.numel() * 4 + V + int(np.prod(slab)), 24 * least,
        kernel_ms=device_ms(k1, reps=5),
        extra={"path": "parallel", "x_start": xs, "slab": list(slab),
               "views": V, "slab_equals_grid_rows": bool(torch.equal(
                   ks, one[xs:xs + sx]))}))
    del plain
    rows.append(par_k22_tp_row(launches))

    # tools/evaluate_model on phase 5's scan (phase 7's Segmentation2D)
    from plant3dvision_tpu_torch.tools.evaluate_model import main as evaluate
    cfg_path = work / "evaluate_model.toml"
    cfg_path.write_text(dump_toml(separate_config()))
    ev, ev_s = _timed(lambda: evaluate([
        str(db.path()), "--config", str(cfg_path), "--gt-fileset",
        ML_GT_FILESET, "--out", str(work / "model_eval.json"),
        "--device", "cuda"]))
    nccl["mesh"].close()
    mesh.close()
    report = {
        "device": device_name, "ranks": PAR_RANKS, "backend": "gloo",
        "note": PAR_NOTE, "spawn_s": spawn_s,
        "carve": {"views": V, "image": [hw[1], hw[0]], "shape": list(shape),
                  "one_device_s": one_s,
                  "view_sharded_4_s": v4_s, "nccl_1_rank_s": v1_s,
                  "grid_sharded_4_s": g4_s, "grid_padded_x": nxp,
                  "two_d_2x2_s": d22_s},
        "average": {"views": len(files), "label": "fruit",
                    "shape": list(a_shape), "one_device_s": avg_one_s,
                    "x_slabs_4_s": avg4_s, "padded_x": anx},
        "segmentation": {"images": PAR_SEG_IMAGES, "image": [ML_SIZE] * 2,
                         "batch": ML_BATCH, "one_device_batch": ML_BATCH // 2,
                         "u8_elements_differing_from_batch_32_one_device":
                             int((seg2 != seg_route).sum()),
                         "u8_max_abs_diff_from_batch_32_one_device": int(
                             (seg2.int() - seg_route.int()).abs().max()),
                         "one_device_s": seg_one_s, "dp_2_s": seg2_s},
        "train_on_crops": {"mesh": tmesh.shape, "width":
                           [24, 48, 96, 192], "blocks": 2,
                           "crop": PAR_TP_CROP, "batch": 8,
                           "steps": PAR_TRAIN_STEPS,
                           "one_device_s": train_one_s, "mesh_s": train8_s,
                           "resume_s": resume_s,
                           "curve_steps": PAR_CURVE_STEPS,
                           "curve_within_rtol_1e-3_atol_1e-4": curve_ok,
                           "f32_steps_against_one_device": {
                               "dp": check_dp, "dp_tp": check_tp},
                           "bf16_step_losses_one_device":
                               c["bf16_one"].tolist(),
                           "bf16_step_losses_mesh": c["bf16_mesh"].tolist(),
                           "bf16_step_rel_diff": rel("bf16_mesh", "bf16_one"),
                           "bf16_chunk_loss_one_device": l1.tolist(),
                           "bf16_chunk_loss_mesh": l8.tolist(),
                           "bf16_chunk_rel_diff": (np.abs(l8 - l1)
                                                   / np.abs(l1)).tolist()},
        # Segmentation2D is complete from phase 7 (skipped): the seconds
        # are the comparison's, not inference's
        "evaluate_model": {"scans": len(ev), "segmentation_from": "phase 7",
                           "s_a_scan_comparison_only":
                               ev_s / max(len(ev), 1),
                           "labels": {s: sorted(r) for s, r in ev.items()}},
        "launches": {k: launches.get(k, 0) for k in PAR_KERNELS},
        "phase_s": time.perf_counter() - t_phase}
    emit({"parallel": report})
    checks = {
        "view-sharded carve (4 gloo ranks) bit-equal": bool(
            torch.equal(v4, one)),
        "view-sharded carve (1 nccl rank) bit-equal": bool(
            torch.equal(v1, one)),
        "grid-sharded carve bit-equal": bool(torch.equal(g4, one)),
        "2-D carve bit-equal": bool(torch.equal(d22, one)),
        "K1 with x_start equals its plain version and the grid's rows":
            rows[0]["max_abs_err"] == 0 and rows[0]["slab_equals_grid_rows"],
        "sharded averaging bit-equal": bool(torch.equal(avg4, avg_one)),
        "dp serving equals one device (uint8, element for element)": bool(
            torch.equal(seg2, seg_one)),
        "trainer's clipped float32 steps at dp 8: losses, parameters "
        "and both moments bit-equal to one device's decomposition":
            _par_exact(check_dp),
        "trainer's clipped float32 steps at dp 2 x tp 4: losses, "
        "parameters and both moments bit-equal to one device's "
        "decomposition": _par_exact(check_tp),
        "each tp rank holds and computes its share": all(
            p < check_tp["params_one_device"]
            for p in check_tp["params_a_rank"])
            and check_tp["conv_macs_equal_on_every_rank"]
            and check_tp["conv_macs_a_step_rank_0"]["forward"] * PAR_RANKS
            < 1.1 * check_tp["conv_macs_a_step_one_device"]["forward"],
        "train_on_crops laid dp 2 x tp 4": tmesh.shape == PAR_TP,
        "2-chunk resume at dp 2 x tp 4 bit-identical": resume_equal,
        # a label without ground-truth masks (flower) scores None
        "evaluate_model scored the scan": len(ev) >= 1 and all(
            np.isfinite(float(r["precision"])) for s in ev.values()
            for r in s.values() if r["precision"] is not None) and any(
            r["precision"] is not None for s in ev.values()
            for r in s.values()),
        "every kernel of the path launched on the ranks": all(
            launches.get(k, 0) > 0 for k in PAR_KERNELS),
    }
    return checks, rows


PHASES = {"2": "main", "3": "main", "4": "real_grid", "5": "ml", "6": "ml",
          "7": "separate", "8": "separate", "9": "frontend",
          "10": "frontend", "11": "selfcal", "12": "selfcal", "13": "fim",
          "14": "fim", "15": "live", "16": "int8", "17": "gather",
          "18": "full", "19": "full", "20": "eval_geom", "21": "eval_ml",
          "22": "train_synth", "23": "training_seg", "24": "distill",
          "25": "parallel"}


def main(argv=None):
    import argparse

    import torch
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "GPU (phases 1-25, see the docstring)")
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run (2-25; a kernel "
                    "check phase runs with its path, e.g. 13,14); default "
                    "all")
    ap.add_argument("--profile", action="store_true",
                    help="after each path's warm pass, a second one under "
                    "torch.profiler (device idle share, top kernels, the "
                    "profiler's cost)")
    args = ap.parse_args(argv)
    global PROFILE
    PROFILE = args.profile
    groups = ({PHASES[p] for p in args.only.split(",") if p}
              if args.only else set(PHASES.values()))
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs a CUDA device", file=sys.stderr)
        return 1
    from plant3dvision_tpu_torch import kernels

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"card": smi, "torch_device": name, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    kernels.build()
    emit({"kernel_build_s": kernels.last_build_seconds})
    if "full" in groups:
        from plant3dvision_tpu_torch.native import mc
        t0 = time.perf_counter()
        mc.lib()
        emit({"native_build_s": time.perf_counter() - t0})

    if "eval_geom" in groups and "main" not in groups:
        raise SystemExit("phase 20 runs on phase 2's scan: --only 2,20")
    if "eval_ml" in groups and "separate" not in groups:
        raise SystemExit("phase 21 runs after phase 7: --only 5,7,21")
    if "training_seg" in groups and "ml" not in groups:
        raise SystemExit("phase 23 trains on phase 5's scan: --only 5,23")
    if "distill" in groups and "frontend" not in groups:
        raise SystemExit("phase 24 distills phase 9's scan: --only 9,24")
    if "parallel" in groups and "separate" not in groups:
        raise SystemExit("phase 25 reads phases 5 and 7's scan and masks: "
                         "--only 5,7,25")
    work = ROOT / ".smoke"
    db = make_db(work / "db")
    rows = []
    # each phase group's seconds, for the script's 1200 s budget
    phase_s, t_lap = {}, [time.perf_counter()]

    def lap(group):
        now = time.perf_counter()
        phase_s[group] = now - t_lap[0]
        t_lap[0] = now
    try:
        if "main" in groups:
            scan, vfile, launches = run_main_path(db, name)
            rows += check_kernels(scan, vfile, launches)
            lap("main")
        if "eval_geom" in groups:
            failed = [c for c, ok in run_geom_evaluation(db, scan).items()
                      if not ok]
            assert not failed, f"geometric evaluation checks failed: {failed}"
            lap("eval_geom")
        if "real_grid" in groups:
            run_real_grid()
            lap("real_grid")
        if "ml" in groups:
            ml_scan, ml_vfile, ml_launches = run_ml_path(db, name)
            rows += check_ml_kernels(ml_scan, ml_vfile, ml_launches)
            lap("ml")
        if ("separate" in groups or "int8" in groups) and \
                "ml" not in groups:
            raise SystemExit("phases 7-8 and 16 run on phase 5's scan: "
                             "--only 5,7 or 5,16")
        bf16_pass = None
        if "separate" in groups:
            sep_scan, sep_report, sep_launches, sep_s = run_ml_separate_path(
                db, name)
            rows += check_separate_kernels(sep_scan, sep_report,
                                           sep_launches)
            bf16_pass = (sep_s, sep_report)
            lap("separate")
        if "eval_ml" in groups:
            ml_checks, k8 = run_ml_evaluation(db, sep_scan)
            rows += check_ml_evaluation_kernels(sep_scan, k8)
            failed = [c for c, ok in ml_checks.items() if not ok]
            assert not failed, f"ML evaluation checks failed: {failed}"
            lap("eval_ml")
        if "frontend" in groups:
            fe_scan, fe_report, fe_launches, fe_checks = run_frontend_path(
                db, name)
            rows += check_frontend_kernels(fe_scan, fe_report, fe_launches)
            failed = [c for c, ok in fe_checks.items() if not ok]
            assert not failed, f"front-end path checks failed: {failed}"
            lap("frontend")
        if "selfcal" in groups:
            sc_scan, sc_report, sc_launches, _, sc_checks = run_selfcal_path(
                db, name)
            rows += check_selfcal_kernels(sc_scan, sc_report, sc_launches)
            sc_checks.update(run_hybrid_pass(db, name))
            failed = [c for c, ok in sc_checks.items() if not ok]
            assert not failed, f"calibrated path checks failed: {failed}"
            lap("selfcal")
        if "fim" in groups:
            fim_scan, fim_report, fim_launches, fim_checks = run_fim_path(
                db, name)
            rows += check_fim_kernels(fim_scan, fim_report, fim_launches)
            failed = [c for c, ok in fim_checks.items() if not ok]
            assert not failed, f"eikonal skeleton path checks failed: {failed}"
            lap("fim")
        if "live" in groups:
            run_live_path(db, name)
            lap("live")
        if "int8" in groups:
            rows += run_int8_path(db, name, bf16_pass)
            lap("int8")
        if "gather" in groups:
            rows += run_gather_probes(name)
            lap("gather")
        if "full" in groups:
            fu_scan, fu_report, fu_launches, fu_checks = run_full_path(
                db, name)
            rows += check_full_kernels(db, fu_scan, fu_report, fu_launches)
            failed = [c for c, ok in fu_checks.items() if not ok]
            assert not failed, f"geom_pipe_full path checks failed: {failed}"
            lap("full")
        if "train_synth" in groups:
            ts_launches, crops, ts_model, ts_val, ts_checks = \
                run_train_synth(work, name)
            rows += check_train_kernels(crops, ts_model, ts_val, ts_launches)
            del crops, ts_model, ts_val
            failed = [c for c, ok in ts_checks.items() if not ok]
            assert not failed, f"train_synth checks failed: {failed}"
            lap("train_synth")
        if "training_seg" in groups:
            tsg_checks, tsg_rows = run_training_seg(work, ml_scan, name)
            rows += tsg_rows
            failed = [c for c, ok in tsg_checks.items() if not ok]
            assert not failed, f"training_seg checks failed: {failed}"
            lap("training_seg")
        if "distill" in groups:
            di_checks, di_rows = run_distill(db, name)
            rows += di_rows
            failed = [c for c, ok in di_checks.items() if not ok]
            assert not failed, f"distill checks failed: {failed}"
            lap("distill")
        if "parallel" in groups:
            par_checks, par_rows = run_parallel(db, work, sep_scan,
                                                sep_report, name)
            rows += par_rows
            failed = [c for c, ok in par_checks.items() if not ok]
            assert not failed, f"parallel checks failed: {failed}"
            lap("parallel")
    finally:
        db.disconnect()
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase_s": phase_s, "script_s": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
