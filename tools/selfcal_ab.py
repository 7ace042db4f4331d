#!/usr/bin/env python3
"""K11b (candidate hulls) and K12 (silhouette ray coverage) of one or more
checkouts of the port, timed in turns on one card.

The launches are `chip_smoke.py` phase 12's (`selfcal_launches`): K11b on
a round-0 and a round-1 CEM population of 48 candidates (tolerance 0) and
on the polish's robust hull (one candidate, tolerance 2, 76x76x141
voxels); K12 on both populations' hulls and on the polish's 60 views x 77
deltas. The silhouettes are those of phase 11's plant (60 views of
1440x1080, `chip_smoke.NORTHSTAR_PLANT`), drawn by the port's synthetic
turntable code (`synth.render_mask`) through phase 11's true cameras (its
CNC ring, theta* and per-view jitter, seeded), so the walks end where a
plant's do; the CEM's theta and the polish's calibration are the true
ones, the hull box the plant's extent plus 5 %.

The plain versions run once, in a process of their own on the first root:
they give every launch's expected output and the work of the sequential
walk (the bound's tests and steps), and the populations' hulls that K12
reads, so every root's K12 gets the same inputs. Then each root runs in
its own process (each checkout builds its own kernels), in the order
given, holds every launch bit-equal to the plain output and prints one
JSON line: the median milliseconds of each call (CUDA events) and its
kernels' mean device time (torch.profiler) beside its bound. `--roots
parent change change parent` compares two versions on one card. Last,
the card's name and power limit.

    python tools/selfcal_ab.py --roots .chipwork/parent . . .chipwork/parent
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _import(root):
    """The port of `root` (first on sys.path) and chip_smoke's helpers."""
    sys.path.insert(0, str(Path(root).resolve()))
    sys.path.append(str(ROOT))
    from plant3dvision_tpu_torch import kernels
    assert Path(kernels.__file__).resolve().is_relative_to(
        Path(root).resolve())
    import chip_smoke
    return kernels, chip_smoke


def scene(path):
    """Phase 11's silhouettes and calibration, saved to `path` (npz)."""
    import numpy as np
    import chip_smoke as cs
    from plant3dvision_tpu_torch.ops.selfcal import (THETA_NAMES,
                                                     cnc_to_cameras)
    from plant3dvision_tpu_torch.synth import SyntheticPlant, render_mask

    V, W, H = 60, 1440, 1080
    rng = np.random.default_rng(0)
    theta = np.array([cs.SELFCAL_THETA.get(n, 0.0) for n in THETA_NAMES],
                     np.float32)
    poses = cs.selfcal_poses(V)
    jitter = np.zeros((V, 3), np.float32)
    jitter[:, 0] = rng.normal(0.0, cs.SELFCAL_JITTER[0], V)
    jitter[:, 1] = rng.normal(0.0, cs.SELFCAL_JITTER[1], V)
    true = poses.copy()
    true[:, 3:5] += jitter[:, :2]
    cams = cnc_to_cameras(true, theta, float(W), float(H)).numpy()
    plant = SyntheticPlant(**cs.NORTHSTAR_PLANT)
    masks = np.stack([render_mask(
        plant, np.array([[c[0], 0, c[2]], [0, c[1], c[3]], [0, 0, 1]]),
        c[4:13].reshape(3, 3), c[13:16], W, H) > 0 for c in cams])
    pts, rads = plant.surface_samples()
    lo, hi = (pts - rads[:, None]).min(0), (pts + rads[:, None]).max(0)
    lo, hi = lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo)
    np.savez(path, masks=masks, poses=poses, theta=theta, jitter=jitter,
             hull=np.stack([lo, hi], 1))


def launches(tmp):
    """selfcal_launches on the saved scene."""
    import numpy as np
    import torch
    import chip_smoke as cs
    z = np.load(Path(tmp) / "scene.npz")
    hull = {a: list(map(float, z["hull"][i])) for i, a in enumerate("xyz")}
    return cs.selfcal_launches(
        z["masks"], z["poses"], z["theta"],
        torch.from_numpy(z["theta"]).cuda(),
        torch.from_numpy(z["jitter"]).cuda(), hull, cs.FRONTEND_BBOX)


def plain(root, tmp):
    """The plain versions' outputs and work, saved to tmp/plain.pt."""
    import torch
    _import(root)
    from plant3dvision_tpu_torch.ops import carving, selfcal
    k11b, k12 = launches(tmp)
    out = {"k11b": {}, "k12": {}}
    for name, args in k11b.items():
        out["k11b"][name] = carving.carve_candidates_plain(
            *args, count_work=True)
    for name, (src, make, groups) in k12.items():
        out["k12"][name] = selfcal.ray_coverage_counts_plain(
            *make(out["k11b"][src][0]), count_work=True)
    torch.save(out, Path(tmp) / "plain.pt")


def device_us(fn, reps=10):
    """Mean device microseconds of fn()'s kernels (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / reps


def measure(root, tmp, reps):
    import torch
    kernels, cs = _import(root)
    from plant3dvision_tpu_torch.ops import carving, selfcal
    kernels.lib()
    res = {"root": str(Path(root).resolve()),
           "build_s": kernels.last_build_seconds}
    want = torch.load(Path(tmp) / "plain.pt")
    k11b, k12 = launches(tmp)
    for name, args in k11b.items():
        alive, tests = want["k11b"][name]
        got = carving.carve_candidates(*args)
        assert torch.equal(got, alive), f"carve_candidates != plain ({name})"
        res["k11b_" + name] = {
            "ms": cs.cuda_ms(lambda: carving.carve_candidates(*args), reps),
            "device_us": device_us(lambda: carving.carve_candidates(*args)),
            "bound_ms": cs.bound_ms(*cs.k11b_work(args, tests))[0],
            "shape": list(args[4]), "candidates": args[1].shape[0],
            "max_kills": args[6], "voxel_view_tests": tests,
            "alive": int(alive.sum())}
    for name, (src, make, groups) in k12.items():
        cargs = make(want["k11b"][src][0])
        cov, val, work = want["k12"][name]
        got = selfcal.ray_coverage_counts(*cargs)
        assert torch.equal(got[0], cov) and torch.equal(got[1], val), \
            f"ray_coverage != plain ({name})"
        res["k12_" + name] = {
            "ms": cs.cuda_ms(lambda: selfcal.ray_coverage_counts(*cargs),
                             reps),
            "device_us": device_us(
                lambda: selfcal.ray_coverage_counts(*cargs)),
            "bound_ms": cs.bound_ms(*cs.k12_work(cargs, groups,
                                                 int(val.sum()), work))[0],
            "groups": groups, "n_steps": cargs[9], "voxel_size": cargs[7],
            "valid_rays": int(val.sum()), "steps_walked": work}
    print(json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--reps", type=int, default=21,
                    help="timed launches a measurement (the median)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--plain", help=argparse.SUPPRESS)
    ap.add_argument("--tmp", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.plain:
        plain(a.plain, a.tmp)
        return
    if a.one:
        measure(a.one, a.tmp, a.reps)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("selfcal_ab: needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        sys.path.insert(0, str(ROOT))
        scene(Path(tmp) / "scene.npz")
        run = [sys.executable, __file__, "--tmp", tmp]
        subprocess.run([*run, "--plain", a.roots[0]], check=True)
        for root in a.roots:
            subprocess.run([*run, "--one", root, "--reps", str(a.reps)],
                           check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
