#!/usr/bin/env python3
"""K9 (undistort) and K1 (carve) of one or more checkouts of the port,
timed in turns on one card; with --variants, build variants of this
checkout's two sources and time them on the same inputs.

Each root is measured in its own process (each checkout builds its own
kernels), in the order given, so `--roots parent change change parent`
compares two versions on one card. The inputs, made once from seeds:

- K9: phase 10's stack, 58 RGB uint8 images of 1080x1440 (random bytes:
  the kernel's time does not depend on the values) through phase 10's
  camera (f 1400, k1 = -0.08).
- K1 on phase 3's group: the first 100 of the 300 views of phase 2's
  north-star scan (`chip_smoke.NORTHSTAR_PLANT` rendered by
  `synth.render_mask` as `generate_scan` places the cameras, f 1400,
  1440x1080) into the scan's bounding box at 1 mm (81x80x199).
- K1 on phase 4's grid: `chip_smoke.run_real_grid`'s 60 views into
  301x301x561 voxels at 0.5 mm.

The plain versions (unchanged in both checkouts) run once, in a process of
their own; each root holds its kernels bit-equal to them and times each
call with CUDA events (median) and as its kernels' device time
(torch.profiler), beside its bound. Prints one JSON line a root (or one
for the variants), then the card's name and power limit.

    python tools/undistort_carve_ab.py --roots .chipwork/parent . . .chipwork/parent
    python tools/undistort_carve_ab.py --variants
    python tools/undistort_carve_ab.py --walks      # on the CPU, ~1 min
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "plant3dvision_tpu_torch" / "kernels" / "csrc"

K9_N, K9_H, K9_W, K9_C, K9_F, K9_K1 = 58, 1080, 1440, 3, 1400.0, -0.08
GROUP_VIEWS, SCAN_VIEWS = 100, 300

_K9_NO_SAMPLE = [("    if (staged && rgb8 && rb15 == 0)\n",
                  "    if (n >= 0) {\n    } else if (staged && rgb8 && rb15 == 0)\n")]
_K9_NO_STORE = [("    store_tile(ob0, rowbytes, rows, segb, out_s, opitch);",
                 "    if (n < 0) store_tile(ob0, rowbytes, rows, segb, out_s, "
                 "opitch);")]
_K1_ZRUN4 = [("constexpr int kCarveRun = 1;", "constexpr int kCarveRun = 4;")]
_K1_NO_PHASE2 = [("    if (n > 0) {\n      int g = 1;",
                  "    if (n < 0) {\n      int g = 1;")]

#: --variants: name -> (source, source edits, computes the function); a
#: variant with a part cut out (an ablation) is timed, not checked
VARIANTS = {
    "k9": ("undistort.cu", [], True),
    "k9_stages2": ("undistort.cu", [("constexpr int kStages = 3;",
                                     "constexpr int kStages = 2;")], True),
    "k9_generic_lane": ("undistort.cu", [(
        "const bool rgb8 = sizeof(T) == 1 && CT == 3 && ppt == 4;",
        "const bool rgb8 = false;")], True),
    "k9_no_sample": ("undistort.cu", _K9_NO_SAMPLE, False),
    "k9_only_stage": ("undistort.cu", _K9_NO_SAMPLE + _K9_NO_STORE, False),
    "k1": ("carve.cu", [], True),
    "k1_batch1": ("carve.cu", [("constexpr int kCarveBatch = 4;",
                                "constexpr int kCarveBatch = 1;")], True),
    "k1_a_block_a_tile": ("carve.cu", [(
        "  const long long blocks =\n"
        "      std::min(tiles, (long long)std::max(per_sm, 1) * sms);",
        "  const long long blocks = tiles;")], True),
    "k1_zrun4": ("carve.cu", _K1_ZRUN4, True),
    "k1_no_phase2": ("carve.cu", _K1_NO_PHASE2, False),
    "k1_zrun4_no_phase2": ("carve.cu", _K1_ZRUN4 + _K1_NO_PHASE2, False),
}


def scene(path):
    """Phase 3's group and phase 4's views (bit-packed masks, cameras,
    grids), saved to `path` (npz)."""
    import numpy as np

    import chip_smoke as cs
    from plant3dvision_tpu_torch.ops.carving import pack_camera, pack_masks
    from plant3dvision_tpu_torch.synth import (SyntheticPlant, render_mask,
                                               turntable_cameras)

    plant = SyntheticPlant(**cs.NORTHSTAR_PLANT)
    W, H = 1440, 1080
    # phase 2's scan: generate_scan's box and camera ring
    pts, rads = plant.surface_samples(step=1.0)
    lo = pts.min(axis=0) - rads.max() - 15.0
    hi = pts.max(axis=0) + rads.max() + 15.0
    bbox = {a: [float(lo[i]), float(hi[i])] for i, a in enumerate("xyz")}
    origin, shape = cs.grid_of(bbox, 1.0)
    ring = turntable_cameras(SCAN_VIEWS, dist=2.5 * float(np.max(hi - lo)),
                             z=float(hi[2]) * 0.7,
                             target=(0, 0, float(lo[2] + hi[2]) / 2),
                             f=1400.0, width=W, height=H)[:GROUP_VIEWS]
    ring4 = turntable_cameras(60, dist=450.0, z=120.0, target=(0, 0, 70.0),
                              f=1400.0, width=W, height=H)
    out = {}
    for key, cams, step in (("group", ring, 0.5), ("grid", ring4, 0.5)):
        out[key + "_packed"] = np.stack([pack_masks(render_mask(
            plant, K, R, t, W, H, step=step) > 0) for K, R, t in cams])
        out[key + "_cams"] = np.stack([pack_camera(
            [K[0, 0], K[1, 1], K[0, 2], K[1, 2]], R, t) for K, R, t in cams])
    np.savez(path, group_origin=np.asarray(origin, np.float32),
             group_shape=np.asarray(shape),
             grid_origin=np.array([-75.0, -75.0, -20.0], np.float32),
             grid_shape=np.array([301, 301, 561]), **out)


def inputs(tmp, dev):
    """K9's stack and camera, and K1's two argument tuples, on `dev`."""
    import numpy as np
    import torch
    from plant3dvision_tpu_torch.synth import turntable_cameras
    gen = torch.Generator(device=dev).manual_seed(0)
    imgs = torch.randint(0, 256, (K9_N, K9_H, K9_W, K9_C), generator=gen,
                         device=dev, dtype=torch.uint8)
    K = turntable_cameras(1, f=K9_F, width=K9_W,
                          height=K9_H)[0][0].astype(np.float32)
    dist = np.float32((K9_K1, 0.0, 0.0, 0.0))
    z = np.load(Path(tmp) / "scene.npz")
    k1 = {}
    for key, vs in (("group", 1.0), ("grid", 0.5)):
        pk = torch.from_numpy(z[key + "_packed"]).to(dev)
        cm = torch.from_numpy(z[key + "_cams"]).to(dev)
        va = torch.ones(len(cm), dtype=torch.bool, device=dev)
        k1[key] = (pk, cm, va, z[key + "_origin"], vs,
                   tuple(int(s) for s in z[key + "_shape"]), (K9_H, K9_W))
    return (imgs, K, dist), k1


def plain(tmp):
    """The plain versions' results and the bounds' work counts, saved to
    tmp/plain.pt."""
    import torch
    from plant3dvision_tpu_torch.ops import carving, undistort
    dev = torch.device("cuda")
    (imgs, K, dist), k1 = inputs(tmp, dev)
    out = {"k9": undistort.undistort_plain(imgs, K, dist).cpu()}
    for key, args in k1.items():
        vol, tests, _ = carving.carve_plain(*args, count_work=True)
        out[key] = vol.cpu()
        out[key + "_work"] = (tests,
                              *carving.carve_least_work(vol, *args))
    torch.save(out, Path(tmp) / "plain.pt")


def device_us_by_kernel(fn, reps=20):
    """Mean device microseconds of fn() by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / reps
            for e in prof.key_averages() if e.self_device_time_total > 0}


def k1_bound(args, tests, mask_bytes):
    """K1's bound: 24 operations a test of the least work
    (`carving.carve_least_work`), the mask bytes those tests read, the
    cameras, the flags and the int8 grid written once."""
    from chip_smoke import bound_ms
    pk, cm, va, _, _, shape, _ = args
    nvox = shape[0] * shape[1] * shape[2]
    return bound_ms(mask_bytes + cm.numel() * 4 + va.numel() + nvox,
                    24 * tests)


def measure(root, tmp):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import carving, undistort
    assert Path(kernels.__file__).resolve().is_relative_to(root)
    sys.path.append(str(ROOT))                      # the timing helpers
    from chip_smoke import bound_ms, cuda_ms

    dev = torch.device("cuda")
    out = {"root": str(root)}
    kernels.lib()
    out["build_s"] = kernels.last_build_seconds
    (imgs, K, dist), k1 = inputs(tmp, dev)
    want = torch.load(Path(tmp) / "plain.pt")

    def k9():
        return undistort.undistort_batch(imgs, K, dist)

    before = kernels.LAUNCHES["undistort"]
    got = k9()
    launches = kernels.LAUNCHES["undistort"] - before
    assert torch.equal(got.cpu(), want["k9"]), "undistort kernel != plain"
    del got
    b, by = bound_ms(2 * imgs.numel(), 40 * K9_H * K9_W + 8 * imgs.numel())
    out["k9"] = {"stack": list(imgs.shape), "bit_equal": True,
                 "launches_per_call": launches, "ms": cuda_ms(k9, reps=21),
                 "device_us_by_kernel": device_us_by_kernel(k9),
                 "bound_ms": b, "bound_by": by}
    for key, args in k1.items():
        def k1_call(args=args):
            return carving.carve(*args)

        before = kernels.LAUNCHES["carve"]
        got = k1_call()
        launches = kernels.LAUNCHES["carve"] - before
        assert torch.equal(got.cpu(), want[key]), f"carve kernel != plain " \
            f"({key})"
        del got
        tests, least, mask_bytes = want[key + "_work"]
        b, by = k1_bound(args, least, mask_bytes)
        out["k1_" + key] = {
            "views": int(args[0].shape[0]), "shape": list(args[5]),
            "bit_equal": True, "launches_per_call": launches,
            "voxel_view_tests_ring_order": tests,
            "least_voxel_view_tests": least,
            "least_mask_bytes": mask_bytes, "ms": cuda_ms(k1_call, reps=21),
            "device_us_by_kernel": device_us_by_kernel(k1_call),
            "bound_ms": b, "bound_by": by}
    print(json.dumps(out), flush=True)


def variants(tmp):
    """Build VARIANTS (edits of this checkout's sources), hold those that
    compute the function bit-equal to the plain results and time each
    twice, in turns."""
    import torch
    from plant3dvision_tpu_torch import kernels
    from chip_smoke import cuda_ms
    procs = {}
    for name, (src, edits, _) in VARIANTS.items():
        text = (CSRC / src).read_text()
        for old, new in edits:
            assert old in text, f"{name}: {old!r} not in {src}"
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
             str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, (name, log)
    dev = torch.device("cuda")
    (imgs, K, dist), k1 = inputs(tmp, dev)
    want = torch.load(tmp / "plain.pt")
    stream = torch.cuda.current_stream().cuda_stream
    P_, I_, F_, L_ = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)
    (fx, fy, cx, cy), d = undistort_params(K, dist)
    calls = {}
    for name, (src, _, exact) in VARIANTS.items():
        so = ctypes.CDLL(str(tmp / f"{name}.so"))
        if src == "undistort.cu":
            f = so.p3d_undistort
            f.argtypes = [P_, P_] + [I_] * 5 + [F_] * 9 + [P_, P_]
            out = torch.empty_like(imgs)

            def call(f=f, out=out):
                assert f(imgs.data_ptr(), out.data_ptr(), K9_N, K9_H, K9_W,
                         K9_C, 0, fx, fy, cx, cy, *d, None, stream) == 0
                return out
            call()
            torch.cuda.synchronize()
            assert not exact or torch.equal(out.cpu(), want["k9"]), name
            calls[name] = call
            continue
        f = so.p3d_carve
        f.argtypes = [P_, L_, P_, P_] + [I_] * 3 + [F_] * 4 + [I_] * 4 + \
            [P_, P_]
        for key, (pk, cm, va, o, vs, shape, hw) in k1.items():
            out = torch.empty(shape, dtype=torch.int8, device=dev)

            def call(f=f, out=out, pk=pk, cm=cm, va=va, o=o, vs=vs,
                     shape=shape, hw=hw):
                assert f(pk.data_ptr(), pk.shape[1], cm.data_ptr(),
                         va.data_ptr(), pk.shape[0], hw[0], hw[1],
                         float(o[0]), float(o[1]), float(o[2]), float(vs),
                         0, *shape, out.data_ptr(), stream) == 0
                return out
            call()
            torch.cuda.synchronize()
            assert not exact or torch.equal(out.cpu(), want[key]), \
                (name, key)
            calls[f"{name}_{key}"] = call
    ms = {k: [] for k in calls}
    for _ in range(2):
        for k, fn in calls.items():
            ms[k].append(cuda_ms(fn, reps=21))
    print(json.dumps({"variants_ms": ms}), flush=True)


def undistort_params(K, dist):
    from plant3dvision_tpu_torch.ops.undistort import _params
    (fx, fy, cx, cy), d = _params(K, dist)
    return (float(fx), float(fy), float(cx), float(cy)), [float(v) for v in d]


def walks(tmp):
    """Where K1's walks go on phase 3's group, on the CPU with the plain
    version's tests: the voxels phase 1's first 4 spread views leave open,
    those no view kills (the hull: every view tested), the tests of the
    ring and the spread order until the first miss, the least tests and
    their mask bytes (`carving.carve_least_work`), and the open voxels a
    tile holds at z runs of 1 and 4 (256 runs a tile)."""
    from math import gcd

    import numpy as np
    import torch
    from plant3dvision_tpu_torch.ops import carving
    z = np.load(Path(tmp) / "scene.npz")
    pk = torch.from_numpy(z["group_packed"])
    cm = torch.from_numpy(z["group_cams"])
    shape = tuple(int(v) for v in z["group_shape"])
    V = len(cm)
    args = (pk, cm, torch.ones(V, dtype=torch.bool), z["group_origin"], 1.0,
            shape, (K9_H, K9_W))
    miss = np.stack([(inn & ~hit).reshape(-1).numpy()
                     for inn, hit, _ in carving._view_tests(*args)])
    stride = int(0.618 * V + 0.5)
    while gcd(stride, V) != 1:
        stride += 1
    spread = miss[[k * stride % V for k in range(V)]]
    first = np.where(spread.any(0), spread.argmax(0), V)
    ring = np.where(miss.any(0), miss.argmax(0), V)
    out = {"voxels": int(first.size), "views": V,
           "open_after_4_views": int((first >= 4).sum()),
           "never_killed": int((first == V).sum()),
           "tests_ring_order": int(np.minimum(ring + 1, V).sum()),
           "tests_spread_order": int(np.minimum(first + 1, V).sum())}
    out["tests_least"], out["least_mask_bytes"] = carving.carve_least_work(
        carving.carve_plain(*args), *args)
    nx, ny, nz = shape
    opened = (first >= 4).reshape(nx * ny, nz)
    for zrun in (1, 4):
        nzc = -(-nz // zrun)
        t = np.arange(nx * ny * nzc)
        cnt = np.zeros(t.size, int)
        for q in range(zrun):
            zz = (t % nzc) * zrun + q
            ok = zz < nz
            cnt[ok] += opened[(t // nzc)[ok], zz[ok]]
        tiles = np.add.reduceat(cnt, np.arange(0, t.size, 256))
        out[f"open_a_tile_zrun{zrun}"] = {
            "tiles": int(tiles.size), "max": int(tiles.max()),
            "p99": float(np.percentile(tiles, 99)),
            "over_256": int((tiles > 256).sum())}
    print(json.dumps({"k1_group_walks": out}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--walks", action="store_true",
                    help="K1's walks on phase 3's group, on the CPU")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--plain", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tmp", help=argparse.SUPPRESS)
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if a.one:
        measure(a.one, a.tmp)
        return
    if a.plain:
        plain(a.tmp)
        return
    if a.walks:
        with tempfile.TemporaryDirectory() as tmp:
            scene(Path(tmp) / "scene.npz")
            walks(tmp)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("undistort_carve_ab: needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        scene(Path(tmp) / "scene.npz")
        subprocess.run([sys.executable, __file__, "--plain", "--tmp", tmp],
                       check=True)
        if a.variants:
            variants(Path(tmp))
        else:
            for root in a.roots:
                subprocess.run([sys.executable, __file__, "--one", root,
                                "--tmp", tmp], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
