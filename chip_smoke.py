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
}

NORTHSTAR_PLANT = dict(n_fruits=15, divergence_deg=137.5, internode=6.0,
                       stem_radius=2.0, fruit_radius=1.5, fruit_length=35.0,
                       first_node=30.0)


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

    prof = profile_pass(db, cfg)
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
    missing = [k for k, v in launches.items() if v <= 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    assert len(angles) > 10, f"only {len(angles)} angles"
    assert err < 1.0, f"mean angle error {err} deg"
    vfile = ctx.scan.get_fileset(
        report["FusedCarving"]["fileset"]).get_files()[0]
    return ctx.scan, vfile, launches


def profile_pass(db, cfg):
    """A warm pass under torch.profiler: the card's busy time (sum
    of the device time of its kernels and copies; one stream, so nothing
    overlaps) against the pass's wall time, and the top device entries."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from plant3dvision_tpu_torch.runtime import RunContext, run_task

    run_task(RunContext(db, "northstar", cfg, device="cuda"), "Clean",
             report=False)
    ctx = RunContext(db, "northstar", cfg, device="cuda")
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


def check_kernels(scan, vfile, launches):
    """Phase 3: every kernel against its plain version at main-path shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.ops import carving, edt, filters
    from plant3dvision_tpu_torch import proc3d

    dev = torch.device("cuda")
    rows = []

    def row(name, err, ms, plain, nbytes, nops, library=None, extra=None):
        b, by = bound_ms(nbytes, nops)
        src, rep = KERNEL_INFO[name]
        r = {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], "max_abs_err": err, "match": True,
             "ms": ms, "kernel_ms": ms, "plain_ms": plain, "bound_ms": b,
             "bound_by": by, "library_ms": library}
        r.update(extra or {})
        rows.append(r)

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
    row("carve", err, cuda_ms(lambda: carving.carve(*args)),
        cuda_ms(lambda: carving.carve_plain(*args), reps=5, warmup=1),
        mask_bytes + cm.numel() * 4 + va.numel() + nvox, 24 * tests,
        extra={"shape": list(shape), "views": len(cams),
               "voxel_view_tests": tests, "mask_bytes_read": mask_bytes,
               "mask_bytes_held": pk.numel()})

    # K2-K4 on the scan's carved grid (the FusedCarving volume)
    vol = torch.from_numpy(io.read_volume(vfile).astype(np.float32)).to(dev)
    n = vol.numel()
    cap = int(min(20, max(vol.shape)))
    sd = edt.signed_distance(vol, cap)
    sd_p = edt.signed_distance_plain(vol, cap)
    torch.cuda.synchronize()
    err = float((sd - sd_p).abs().max())
    assert err == 0.0, f"signed distance kernel != plain (max {err})"
    reads = sum(2 * (vol.shape[a] - s) * (n // vol.shape[a])
                for a in range(3)
                for s in range(1, min(cap, vol.shape[a] - 1) + 1))
    row("signed_distance", err,
        cuda_ms(lambda: edt.signed_distance(vol, cap)),
        cuda_ms(lambda: edt.signed_distance_plain(vol, cap), reps=5,
                warmup=1),
        8 * n, 2 * 2 * reads)

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
    assert err <= 1e-5, f"gradient/gaussian kernel vs plain: {err}"

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
    ik, dk, vk = proc3d.band_compact(sd, gx, gy, gz, 0.0)
    ip, dp, vp = proc3d.band_compact_plain(sd, gx, gy, gz, 0.0)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip), "band index set differs from plain"
    err = max(float((dk - dp).abs().max()), float((vk - vp).abs().max()))
    assert err == 0.0, f"band records differ from plain: {err}"
    lo, hi = proc3d.band_limits(0.0)

    def k4_library():
        flat = sd.reshape(-1)
        idx = torch.nonzero((flat > float(lo)) & (flat <= float(hi)))
        idx = idx.reshape(-1)
        return [t.reshape(-1).index_select(0, idx) for t in (sd, gx, gy, gz)]

    row("band_compact", err,
        cuda_ms(lambda: proc3d.band_compact(sd, gx, gy, gz, 0.0)),
        cuda_ms(lambda: proc3d.band_compact_plain(sd, gx, gy, gz, 0.0)),
        4 * n + 36 * len(ik), 2 * n, library=cuda_ms(k4_library),
        extra={"n_band": int(len(ik))})
    emit({"kernel_checks": {"grid": list(vol.shape), "cap": cap,
                            "group_views": len(cams)}})
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
