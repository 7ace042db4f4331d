#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (plant3dvision_tpu_torch) on one GPU.

1. Builds the port's CUDA kernels from kernels/csrc (nvcc, in parallel).
2. Drives the geometric main path through the port's task runtime:
   a synthetic 300-view 1440x1080 turntable scan at 1 mm,
   configs/geom_pipe_fast.toml, ImagesFilesetExists -> FusedCarving ->
   PointCloud -> CurveSkeleton -> RefineSkeleton -> TreeGraph ->
   AnglesAndInternodes: one cold pass, then two warm passes with Clean
   between them. Checks that every kernel was launched in the warm pass,
   that more than 10 angles come out and that their mean error against the
   plant's ground truth is below 1 degree.
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (K1 on one 100-view group, K2-K4 on the carved grid)
   and times kernel, plain version and, where one exists, a PyTorch
   library call computing the same function (CUDA events, median).
4. Runs the 60-view 1440x1080 carve into a 301x301x561 grid at 0.5 mm and
   vol2pcd on its result.
5. Drives the ML path through the port's task runtime at full width: a
   126-view 896x896 photo-domain scan (ProceduralArabidopsis(seed=1)), the
   committed TPUSegNet, FusedSegmentationCarving at 0.25 mm (165x146x504
   voxels, 6 labels, bilinear, batches of 32) -> multiclass PointCloud ->
   OrganSegmentation -> AnglesAndInternodes: one cold pass, two warm passes
   with Clean between them, one profiled warm pass. Checks that K2-K6 were
   launched in the warm pass, that at least 10 angles come out and that
   their mean error (DTW-aligned against the generator's ground truth) is
   below 20 degrees.
6. Holds K5 (accumulate; bilinear, box and log modes, through the 3-slab
   lane) on one real batch of 32 CNN outputs of that scan, K6 (select) on
   the warm pass's label volumes and K2-K4 on its fruit selection, against
   their plain versions, and times them beside a PyTorch library chain
   computing the same function. Each kernel row names the path (geometric,
   ml or ml_separate) whose shapes it was measured at and whose launches it
   counts.
7. Drives the separate-task ML route (configs/ml_pipe_virtual.toml without
   its evaluation tasks) on phase 5's scan with the committed ResUNet at
   full width (896x896): Segmentation2D -> Voxels (averaging, 0.25 mm, 5
   labels) -> multiclass PointCloud -> SegmentedPointCloud ->
   OrganSegmentation -> AnglesAndInternodes; one cold pass, two warm passes
   with Clean between them, one profiled warm pass; then Segmentation2D
   alone with the reference's binarised masks (threshold 0.01, dilation 1).
   Checks that K2-K4, K5-avg, K6 and K7 were launched in the warm pass and
   K8 in the binarised run, that at least 10 angles come out and that their
   mean error is below 25 degrees.
8. Holds K5-avg (one label's 126 masks, plain and log'd), K7 (the warm
   pass's points and 630 masks) and K8 (the pass's 756 masks thresholded at
   0.01, radius 1 and 3) against their plain versions at that route's
   shapes, and times them beside a PyTorch library chain.
9. Drives the real-scan front end (configs/geom_pipe_real_selfcal.toml's
   tasks after its TurntableCalibration: Undistorted -> Masks -> Voxels
   with vote carving (kill_tolerance 3) at 0.5 mm into phase 4's
   301x301x561 grid -> PointCloud -> CurveSkeleton -> RefineSkeleton ->
   TreeGraph -> AnglesAndInternodes) on a 60-view 1440x1080 RGB scan of the
   north-star plant through a lens with OPENCV k1 = -0.08, as
   TurntableCalibration leaves it (colmap_camera, pose_estimation; two
   views "incorrect", which Undistorted's query drops): one cold pass, two
   warm passes with Clean between them, one profiled warm pass; then a
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
   library chain (grid_sample for K9, tensordot + compare for K10; none
   for K11).

Prints one JSON object per line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without that line when there is no CUDA device or any
phase fails.

Usage: python3 chip_smoke.py
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
}

#: the ML path's configuration: bench_e2e.py:run_ml_northstar at 0.25 mm
ML_VOXEL, ML_SIZE, ML_VIEWS, ML_BATCH = 0.25, 896, 126, 32
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
    "Clean": {"no_confirm": True},
}

#: the separate-task ML route: configs/ml_pipe_virtual.toml's tasks (its
#: evaluation and visualisation tasks left out) on phase 5's scan, with the
#: committed ResUNet named (phase 5 installed TPUSegNet first), phase 5's
#: 0.25 mm grid and batches of 32
SEP_TASKS = ("ModelFilesetExists", "Segmentation2D", "Voxels", "PointCloud",
             "SegmentedPointCloud", "OrganSegmentation")

NORTHSTAR_PLANT = dict(n_fruits=15, divergence_deg=137.5, internode=6.0,
                       stem_radius=2.0, fruit_radius=1.5, fruit_length=35.0,
                       first_node=30.0)


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
                         render_step=0.5):
    """A turntable scan of RGB photos through a lens with OPENCV radial
    distortion k1, as TurntableCalibration leaves it: per image
    'colmap_camera' (OPENCV [fx, fy, cx, cy, k1, 0, 0, 0], rotmat, tvec)
    and 'pose_estimation' ("incorrect" for the views in `incorrect`).

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

    prof = profile_pass(db, "northstar", cfg)
    warm, report, launches = [], None, None
    for _ in range(2):
        run_task(ctx, "Clean", report=False)
        ctx = RunContext(db, "northstar", cfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        report = run_task(ctx, "AnglesAndInternodes", report=False)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
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
    emit({"main_path_profile": prof})
    missing = [k for k in ("carve", "signed_distance", "gradient_gaussian",
                           "band_compact") if launches[k] <= 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    assert len(angles) > 10, f"only {len(angles)} angles"
    assert err < 1.0, f"mean angle error {err} deg"
    vfile = ctx.scan.get_fileset(
        report["FusedCarving"]["fileset"]).get_files()[0]
    return ctx.scan, vfile, launches


def profile_pass(db, scan_id, cfg):
    """A warm pass under torch.profiler: the card's busy time (sum
    of the device time of its kernels and copies; one stream, so nothing
    overlaps) against the pass's wall time, and the top device entries."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from plant3dvision_tpu_torch.runtime import RunContext, run_task

    run_task(RunContext(db, scan_id, cfg, device="cuda"), "Clean",
             report=False)
    ctx = RunContext(db, scan_id, cfg, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_task(ctx, "AnglesAndInternodes", report=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sorted(((e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda r: -r[1])
    busy = sum(r[1] for r in dev) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "top_device": [{"name": k[:80], "s": t / 1e6, "calls": c}
                           for k, t, c in dev[:10]]}


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
               extra=None):
    """One entry of the `kernels` line (bound from the bytes and operations
    of this run's inputs)."""
    b, by = bound_ms(nbytes, nops)
    src, rep = KERNEL_INFO[name]
    r = {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches, "max_abs_err": err, "match": True,
         "ms": ms, "kernel_ms": ms, "plain_ms": plain, "bound_ms": b,
         "bound_by": by, "library_ms": library}
    r.update(extra or {})
    return r


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
    # bytes: the distinct mask bytes that the tests the early exit leaves
    # read, the cameras and flags, the int8 grid written once
    rows = [kernel_row(
        "carve", launches["carve"], err,
        cuda_ms(lambda: carving.carve(*args)),
        cuda_ms(lambda: carving.carve_plain(*args), reps=5, warmup=1),
        mask_bytes + cm.numel() * 4 + va.numel() + nvox, 24 * tests,
        extra={"path": "geometric", "shape": list(shape), "views": len(cams),
               "voxel_view_tests": tests, "mask_bytes_read": mask_bytes,
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
    import torch.nn.functional as F
    from plant3dvision_tpu_torch import proc3d
    from plant3dvision_tpu_torch.ops import edt, filters

    dev = vol.device
    rows = []

    def row(name, *args, extra=None, **kw):
        rows.append(kernel_row(name, launches[name], *args, **kw,
                               extra={"path": path, "shape": list(vol.shape),
                                      **(extra or {})}))

    n = vol.numel()
    cap = int(min(16 + level + 4, max(vol.shape)))     # as vol2pcd sets it
    sd = edt.signed_distance(vol, cap)
    sd_p = edt.signed_distance_plain(vol, cap)
    torch.cuda.synchronize()
    err = float((sd - sd_p).abs().max())
    assert err == 0.0, f"signed distance kernel != plain (max {err}, {path})"
    del sd_p
    reads = sum(2 * (vol.shape[a] - s) * (n // vol.shape[a])
                for a in range(3)
                for s in range(1, min(cap, vol.shape[a] - 1) + 1))
    row("signed_distance", err,
        cuda_ms(lambda: edt.signed_distance(vol, cap)),
        cuda_ms(lambda: edt.signed_distance_plain(vol, cap), reps=5,
                warmup=1),
        8 * n, 2 * 2 * reads, extra={"cap": cap})

    def k3(x):
        return [filters.gaussian_filter(g, 1.0) for g in filters.gradient(x)]

    def k3_plain(x):
        return [filters.gaussian_filter_plain(g, 1.0)
                for g in filters.gradient_plain(x)]

    taps = filters.gaussian_kernel1d(1.0).astype(np.float32)
    gk = k3(sd)
    gp = k3_plain(sd)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
    assert err <= 1e-5, f"gradient/gaussian kernel vs plain: {err} ({path})"
    del gp

    w = torch.from_numpy(taps).to(dev)
    r = len(taps) // 2
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False

    def k3_library(x):
        # torch.gradient, then per axis a symmetric pad and one grouped
        # conv3d over the three gradients
        g = torch.stack(torch.gradient(x))[None]          # (1, 3, nx, ny, nz)
        for axis in range(3):
            idx = filters._symmetric_index(x.shape[axis], r, dev)
            g = g.index_select(2 + axis, idx)
            kshape = [1, 1, 1]
            kshape[axis] = len(taps)
            g = F.conv3d(g, w.reshape(kshape).expand(3, 1, *kshape), groups=3)
        return g

    lib3 = cuda_ms(lambda: k3_library(sd))
    torch.backends.cudnn.allow_tf32 = prev_tf32
    row("gradient_gaussian", err, cuda_ms(lambda: k3(sd)),
        cuda_ms(lambda: k3_plain(sd), reps=5, warmup=1),
        16 * n, (6 + 3 * 3 * 18) * n, library=lib3)

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

    row("band_compact", err,
        cuda_ms(lambda: proc3d.band_compact(sd, gx, gy, gz, level)),
        cuda_ms(lambda: proc3d.band_compact_plain(sd, gx, gy, gz, level)),
        4 * n + 36 * len(ik), 2 * n, library=cuda_ms(k4_library),
        extra={"n_band": int(len(ik))})
    return rows


def run_real_grid():
    """Phase 4: the 60-view 0.5 mm carve (held against its plain version)
    + vol2pcd (301x301x561 voxels)."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import proc3d
    from plant3dvision_tpu_torch.ops.carving import (carve, carve_plain,
                                                     pack_camera, pack_masks)
    from plant3dvision_tpu_torch.synth import (SyntheticPlant, render_mask,
                                               turntable_cameras)

    V, H, W = 60, 1080, 1440
    shape, vs = (301, 301, 561), 0.5
    origin = np.array([-75.0, -75.0, -20.0], np.float32)
    plant = SyntheticPlant(**NORTHSTAR_PLANT)
    t0 = time.perf_counter()
    rows = np.zeros((V, (H * W + 7) // 8), np.uint8)
    cams = np.zeros((V, 16), np.float32)
    for v, (K, R, t) in enumerate(turntable_cameras(
            V, dist=450.0, z=120.0, target=(0, 0, 70.0), f=1400.0,
            width=W, height=H)):
        rows[v] = pack_masks(render_mask(plant, K, R, t, W, H, step=0.5))
        cams[v] = pack_camera([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], R, t)
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    pk = torch.from_numpy(rows).to(dev)
    cm = torch.from_numpy(cams).to(dev)
    va = torch.ones(V, dtype=torch.bool, device=dev)
    args = (pk, cm, va, origin, vs, shape, (H, W))
    carve_ms = cuda_ms(lambda: carve(*args), reps=5, warmup=1)
    vol = carve(*args)
    plain, tests, _ = carve_plain(*args, count_work=True)
    assert torch.equal(vol, plain), "real-grid carve != plain"
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
        "grid_view_pairs_per_s": V * nvox / (carve_ms / 1e3),
        "voxel_view_tests": tests,
        "voxel_view_tests_per_s": tests / (carve_ms / 1e3),
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
                        height=ML_SIZE, plant=plant, with_gt_masks=False)
    gen_s = time.perf_counter() - t0
    assert install_checkpoint(db, path=TPUSEGNET_CHECKPOINT,
                              model_id="tpusegnet_seg") is not None

    ctx = RunContext(db, "ml_northstar", ML_CONFIG, device="cuda")
    t0 = time.perf_counter()
    run_task(ctx, "AnglesAndInternodes", report=False)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    warm, report, launches = [], None, None
    for _ in range(2):
        run_task(ctx, "Clean", report=False)
        ctx = RunContext(db, "ml_northstar", ML_CONFIG, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        report = run_task(ctx, "AnglesAndInternodes", report=False)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
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
    prof = profile_pass(db, "ml_northstar", ML_CONFIG)
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
            prof["device_idle_share"], *angles, *out["internodes"]]
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


def check_ml_kernels(scan, vfile, launches):
    """Phase 6: K5 on one real batch of the ML scan (every mode, through the
    3-slab lane), K6 on the warm pass's label volumes and K2-K4 on its
    fruit selection, against their plain versions, at the ML path's own
    shapes."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch.fsdb import handoff, io
    from plant3dvision_tpu_torch.models.checkpoint import load_model
    from plant3dvision_tpu_torch.models.unet import forward_probs
    from plant3dvision_tpu_torch.ops import ml_fused, multiclass
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

    def k5(vol, fn, log_mode, sample):
        for xs in range(0, nx_pad, slab_nx):
            fn(vol, probs, cams, valid, origin, ML_VOXEL, xs, slab_nx,
               log_mode, sample)
        return vol

    def fresh():
        return torch.zeros((C, nx_pad, *shape[1:]), device=dev)

    # the data-dependent work: voxel-view pairs, and those in frame
    in_frame = sum(int(ml_fused.project(cams[b], origin, ML_VOXEL, 0, shape,
                                        probs.shape[2:])[2].sum())
                   for b in range(len(files)))
    pairs = len(files) * nvox
    modes = {}
    for mode, log_mode, sample in (("bilinear", False, "bilinear"),
                                   ("box", False, "box"),
                                   ("log", True, "bilinear")):
        got = k5(fresh(), ml_fused.accumulate, log_mode, sample)
        want = k5(fresh(), ml_fused.accumulate_plain, log_mode, sample)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = float(diff.max())
        rel = float((diff / want.abs().clamp(min=1.0)).max())
        n_diff = int((got != want).sum())
        assert rel <= 1e-6, f"accumulate ({mode}) kernel vs plain: {rel}"
        vol = fresh()
        ms = cuda_ms(lambda: k5(vol, ml_fused.accumulate, log_mode, sample))
        plain = cuda_ms(lambda: k5(fresh(), ml_fused.accumulate_plain,
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
        # the batch read once, the volume (its shape[0] rows, not the slab
        # padding) read and written once
        nbytes = probs.numel() * 4 + 2 * C * nvox * 4 + cams.numel() * 4 \
            + valid.numel()
        modes[mode] = kernel_row(
            "accumulate_labels", launches["accumulate_labels"], err, ms,
            plain, nbytes, nops, library=lib,
            extra={"path": "ml", "mode": mode, "max_rel_err": rel,
                   "n_differ": n_diff, "tolerance_rel": 1e-6, "batch": len(files),
                   "slabs": nx_pad // slab_nx, "slab_nx": slab_nx,
                   "voxel_view_pairs": pairs, "in_frame_pairs": in_frame})
    rows.append(dict(modes["bilinear"], modes={
        m: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by", "max_abs_err", "n_differ")}
        for m, r in modes.items()}))
    del probs

    # K6 on the warm pass's label volumes (in the handoff cache, else the NPZ)
    vols = handoff.cache_get(vfile) or io.read_npz(vfile)
    stack = torch.stack([torch.as_tensor(vols[l]).to(dev, torch.float32)
                         for l in labels]).contiguous()
    pc = ML_CONFIG["PointCloud"]
    bg = labels.index("background")
    for contrast in (pc["min_contrast"], 10.0):
        args = (pc["background_prior"], contrast, pc["min_score"], bg,
                contrast > 1.0)
        k = multiclass.select_labels(stack, *args)
        p = multiclass.select_labels_plain(stack, *args)
        torch.cuda.synchronize()
        assert torch.equal(k, p), f"select kernel != plain (contrast {contrast})"
    args = (pc["background_prior"], pc["min_contrast"], pc["min_score"], bg,
            False)

    def k6_library():
        s = stack.clone()
        s[bg] *= pc["background_prior"]
        org = s.clone()
        org[bg] = -torch.inf
        res = torch.where(s[bg] > org.amax(0), bg, org.argmax(0))
        lane = torch.arange(C, device=dev).view(-1, 1, 1, 1)
        out = (res[None] == lane) & (s > pc["min_score"])
        out[bg] = False
        return out

    sel = multiclass.select_labels(stack, *args)
    assert torch.equal(k6_library(), sel)
    n = stack[0].numel()
    rows.append(kernel_row(
        "multiclass_select", launches["multiclass_select"], 0,
        cuda_ms(lambda: multiclass.select_labels(stack, *args)),
        cuda_ms(lambda: multiclass.select_labels_plain(stack, *args)),
        C * n * 4 + C * n, (2 * C * C + 4 * C) * n,
        library=cuda_ms(k6_library),
        extra={"path": "ml", "shape": list(stack.shape),
               "selected": {l: int(sel[i].sum())
                            for i, l in enumerate(labels)}}))

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
    cfg["Clean"] = {"no_confirm": True}
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

    warm, report, launches = [], None, None
    for _ in range(2):
        run_task(ctx, "Clean", report=False)
        ctx = RunContext(db, "ml_northstar", cfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        report = run_task(ctx, "AnglesAndInternodes", report=False)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
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
    prof = profile_pass(db, "ml_northstar", cfg)
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
            prof["device_idle_share"], *angles, *out["internodes"]]
    assert np.isfinite(nums).all(), "a number of the separate route is " \
        "not finite"
    # K8's launches are the binarised run's (the route itself does not
    # binarise)
    return scan, report, dict(launches, dilate_disk=bin_launches[
        "dilate_disk"])


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
    """Phase 8: K5-avg, K7 and K8 against their plain versions at the
    separate route's shapes (the warm pass's masks, grid and points)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    import torch.nn.functional as F
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.ops import carving, masks as masks_ops
    from plant3dvision_tpu_torch.ops import reproject

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
                   "in_frame_pairs": in_frame})
        del mt, got, want
    rows.append(dict(modes["plain"], modes={
        m: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by", "max_abs_err")}
        for m, r in modes.items()}))

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
    # per point-file pair ~32 operations (three dot products, two
    # divisions and fused multiply-adds, frame test, / 255, the add); bytes:
    # the points, cameras and labels read once, the distinct mask bytes the
    # in-frame pairs read, the scores written once
    rows.append(kernel_row(
        "reproject_scores", launches["reproject_scores"], 0.0,
        cuda_ms(lambda: reproject.score_points_by_masks(*args)),
        cuda_ms(lambda: reproject.score_points_by_masks_plain(*args), reps=3,
                warmup=1),
        12 * n + ck.numel() * 4 + lk.numel() * 4 + touched + 4 * n * L,
        32 * n * len(organ),
        library=cuda_ms(lambda: _library_reproject(*args), reps=3, warmup=1),
        extra={"path": "ml_separate", "points": n, "files": len(organ),
               "labels": L, "in_frame_pairs": in_pairs,
               "mask_bytes_read": touched, "mask_bytes_held": mk.numel(),
               "library_max_abs_diff": float((lib_scores - got).abs().max())}))
    del mk, lib_scores

    # K8: the pass's 756 masks thresholded at 0.01, radius 1 and 3
    m = torch.from_numpy(stack).to(dev)
    binm = carving.div_f32(m.float(), 255.0) > float(np.float32(0.01))
    del m
    radii = {}
    for r in (1, 3):
        got = masks_ops.binary_dilation(binm, r)
        want = masks_ops.binary_dilation_plain(binm, r)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"dilate kernel != plain (radius {r})"
        offs = masks_ops._disk_offsets(r)
        fp = torch.zeros((1, 1, 2 * r + 1, 2 * r + 1), device=dev)
        fp[0, 0, offs[:, 0] + r, offs[:, 1] + r] = 1.0

        def lib():
            return F.conv2d(binm[:, None].float(), fp, padding=r)[:, 0] > 0

        assert torch.equal(lib(), got), f"conv2d footprint != K8 (r {r})"
        radii[r] = kernel_row(
            "dilate_disk", launches["dilate_disk"], 0.0,
            cuda_ms(lambda: masks_ops.binary_dilation(binm, r)),
            cuda_ms(lambda: masks_ops.binary_dilation_plain(binm, r)),
            2 * binm.numel(), len(offs) * binm.numel(),
            library=cuda_ms(lib, reps=3, warmup=1),
            extra={"path": "ml_separate", "radius": r,
                   "launches_counted_in": "binarised Segmentation2D",
                   "shape": list(binm.shape), "offsets": len(offs),
                   "true_in": int(binm.sum()), "true_out": int(got.sum())})
        del got, want
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

    warm, report, launches = [], None, None
    for _ in range(2):
        run_task(ctx, "Clean", report=False)
        ctx = RunContext(db, "frontend", cfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        report = run_task(ctx, "AnglesAndInternodes", report=False)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
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
    prof = profile_pass(db, "frontend", cfg)
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
            [cold_s, *warm, s_s, peak_mb, prof["device_idle_share"],
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

    # K9: the 58 raw images
    imgs = torch.from_numpy(raw).to(dev)
    got = undistort.undistort_batch(imgs, K, dist)
    want = undistort.undistort_plain(imgs, K, dist)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    assert n_diff == 0, f"undistort kernel != plain ({n_diff} values)"
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
        extra={"path": "frontend", "shape": list(imgs.shape),
               "k1": float(dist[0]),
               "library_values_differing": lib_diff}))
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

        def lib():
            x = carving.div_f32(imgs.float(), 255.0)
            if ftype == "linear":
                return torch.tensordot(x, cvec, dims=([3], [0])) > thr
            s = x.sum(-1).clamp(min=1e-12)
            return (2 * x[..., 1] - x[..., 0] - x[..., 2]) / s > thr

        # bytes: the images read once, the masks written once; operations:
        # 1 compare per pixel (the fast lane) or 3 divisions, 2 adds and
        # the filter (~12) per pixel
        npx = N * H * W
        lanes[ftype] = kernel_row(
            "mask_filter", launches["mask_filter"], 0,
            cuda_ms(lambda: masks.mask_filter(*args)),
            cuda_ms(lambda: masks.mask_filter_plain(*args)),
            imgs.numel() + npx, (1 if ftype == "linear" else 12) * npx,
            library=cuda_ms(lib),
            extra={"path": "frontend", "filter": ftype, "threshold": thr,
                   "shape": list(imgs.shape), "true": int(got.sum()),
                   "library_pixels_differing": int((lib() != got).sum()),
                   "compute_mask_numpy_pixels_differing": n_host})
    rows.append(dict(lanes["linear"], filters={
        f: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by", "true")}
        for f, r in lanes.items()}))
    del imgs, got, want

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


def main():
    import torch
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

    work = ROOT / ".smoke"
    db = make_db(work / "db")
    try:
        scan, vfile, launches = run_main_path(db, name)
        rows = check_kernels(scan, vfile, launches)
        run_real_grid()
        ml_scan, ml_vfile, ml_launches = run_ml_path(db, name)
        rows += check_ml_kernels(ml_scan, ml_vfile, ml_launches)
        sep_scan, sep_report, sep_launches = run_ml_separate_path(db, name)
        rows += check_separate_kernels(sep_scan, sep_report, sep_launches)
        fe_scan, fe_report, fe_launches, fe_checks = run_frontend_path(db,
                                                                       name)
        rows += check_frontend_kernels(fe_scan, fe_report, fe_launches)
        failed = [c for c, ok in fe_checks.items() if not ok]
        assert not failed, f"front-end path checks failed: {failed}"
    finally:
        db.disconnect()
        shutil.rmtree(work, ignore_errors=True)
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
