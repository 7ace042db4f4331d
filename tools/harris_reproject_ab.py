#!/usr/bin/env python3
"""K13 (Harris response) and K7 (reproject scores) of one or more checkouts
of the port, timed in turns on one card.

Each root is measured in its own process (each checkout builds its own
kernels), in the order given, so `--roots parent change change parent`
compares two versions on one card. The inputs, made once from seeds:

- K13: one calibrated pass's chunk, 12 grays of 1080x1440 (smoothed noise)
  with its keypoint masks: phase 11's plant (`chip_smoke.NORTHSTAR_PLANT`)
  drawn by `synth.render_mask` through 12 of phase 11's true cameras,
  dilated by the disk of radius 6 as `build_matches` dilates them. Neither
  kernel's time depends on the pixels' values.
- K7: phase 8's shapes: 103,445 points (the 0.25 mm voxels of phase 5's
  plant, `ProceduralArabidopsis(seed=1)`, its surface's voxels grown by
  whole voxels until there are as many, taken evenly in C order, as the
  PointCloud task orders them), 630 mask files of 896x896 (random bytes)
  image-major with the cameras of phase 5's 126-view ring
  (`fixture_like_cameras` as `generate_photo_scan` places it), 5 labels.

Each call is held bit-equal to its plain version and timed as a call (CUDA
events, median) and as its kernels' device time (torch.profiler), beside
its bound (and, for K7, `bound_ms_runs`: one projection a point and camera
run). Prints one JSON line a root, then the card's name and power limit.

    python tools/harris_reproject_ab.py --roots .chipwork/parent . . .chipwork/parent
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

K13_VIEWS, K13_H, K13_W = 12, 1080, 1440
K7_POINTS, K7_VIEWS, K7_LABELS, K7_SIZE, K7_VOXEL = 103445, 126, 5, 896, 0.25


def scene(path):
    """The keypoint silhouettes (bit-packed) and K7's points and cameras,
    saved to `path` (npz)."""
    import numpy as np
    from scipy.ndimage import binary_dilation

    import chip_smoke as cs
    from plant3dvision_tpu_torch.ops.carving import pack_camera
    from plant3dvision_tpu_torch.ops.selfcal import (THETA_NAMES,
                                                     cnc_to_cameras)
    from plant3dvision_tpu_torch.synth import SyntheticPlant, render_mask
    from plant3dvision_tpu_torch.synth_photo import (ProceduralArabidopsis,
                                                     fixture_like_cameras)

    rng = np.random.default_rng(0)
    theta = np.array([cs.SELFCAL_THETA.get(n, 0.0) for n in THETA_NAMES],
                     np.float32)
    poses = cs.selfcal_poses(60)[::5]
    cams = cnc_to_cameras(poses, theta, float(K13_W), float(K13_H)).numpy()
    plant = SyntheticPlant(**cs.NORTHSTAR_PLANT)
    sil = np.stack([render_mask(
        plant, np.array([[c[0], 0, c[2]], [0, c[1], c[3]], [0, 0, 1]]),
        c[4:13].reshape(3, 3), c[13:16], K13_W, K13_H) > 0 for c in cams])

    arab = ProceduralArabidopsis(seed=1)
    bbox = arab.bounding_box()
    lo = np.array([bbox[a][0] for a in "xyz"])
    hi = np.array([bbox[a][1] for a in "xyz"])
    shape = np.ceil((hi - lo) / K7_VOXEL).astype(int)
    pts = np.concatenate([p for p, _ in arab.labeled_samples().values()])
    idx = np.clip(((pts - lo) / K7_VOXEL).astype(int), 0, shape - 1)
    occ = np.zeros(shape, bool)
    occ[tuple(idx.T)] = True
    while occ.sum() < K7_POINTS:      # the surface's shell, as a volume's
        occ = binary_dilation(occ)    # band of voxels is thicker
    flat = np.flatnonzero(occ)
    keep = flat[np.linspace(0, flat.size - 1, K7_POINTS).astype(int)]
    centres = (np.stack(np.unravel_index(keep, shape), 1) + 0.5) * K7_VOXEL
    points = (lo + centres).astype(np.float32)
    cz = (bbox["z"][0] + bbox["z"][1]) / 2
    ring = fixture_like_cameras(
        K7_VIEWS, radius=1.55 * (bbox["z"][1] - bbox["z"][0]), z=cz + 10.0,
        target=(0.0, 0.0, cz), width=K7_SIZE, height=K7_SIZE, rng=rng)
    views = np.stack([pack_camera([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], R, t)
                      for K, R, t in ring])
    np.savez(path, silhouettes=np.packbits(sil, axis=-1), points=points,
             cams=np.repeat(views, K7_LABELS, axis=0))


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


def inputs(tmp, dev):
    """The device tensors of both kernels, the same in every root."""
    import numpy as np
    import torch
    from chip_smoke import library_dilation
    z = np.load(Path(tmp) / "scene.npz")
    sil = torch.from_numpy(np.unpackbits(z["silhouettes"], axis=-1)[
        ..., :K13_W].astype(bool)).to(dev)
    mask = library_dilation(sil, 6).contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn((K13_VIEWS, K13_H, K13_W), generator=gen, device=dev)
    for ax in (1, 2):
        g = (g + g.roll(1, ax) + g.roll(-1, ax)) / 3
    gray = (g * 0.1 + 0.5).contiguous()
    F = K7_VIEWS * K7_LABELS
    masks = torch.randint(0, 256, (F, K7_SIZE, K7_SIZE), generator=gen,
                          device=dev, dtype=torch.uint8)
    lab = torch.arange(F, device=dev, dtype=torch.int32) % K7_LABELS
    return (gray, mask), (torch.from_numpy(z["points"]).to(dev), masks,
                          torch.from_numpy(z["cams"]).to(dev), lab,
                          K7_LABELS)


def measure(root, tmp):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import reproject, sfmlite
    assert Path(kernels.__file__).resolve().is_relative_to(root)
    sys.path.append(str(ROOT))                      # the timing helpers
    from chip_smoke import bound_ms, cuda_ms

    dev = torch.device("cuda")
    out = {"root": str(root)}
    kernels.lib()
    out["build_s"] = kernels.last_build_seconds
    (gray, mask), k7 = inputs(tmp, dev)

    def k13():
        return sfmlite.harris_response(gray, mask)

    got = k13()
    assert torch.equal(got, sfmlite.harris_response_plain(gray, mask))
    npx = gray.numel()
    b, by = bound_ms(9 * npx, 45 * npx)
    out["k13"] = {"chunk": list(gray.shape), "bit_equal": True,
                  "candidates": int(torch.isfinite(got).sum()),
                  "ms": cuda_ms(k13, reps=21),
                  "device_us_by_kernel": device_us_by_kernel(k13),
                  "bound_ms": b, "bound_by": by}
    del got

    points, masks, cams, lab, L = k7

    def k7_call():
        return reproject.score_points_by_masks(points, masks, cams, lab, L)

    before = kernels.LAUNCHES["reproject_scores"]
    got = k7_call()
    launches = kernels.LAUNCHES["reproject_scores"] - before
    want = reproject.score_points_by_masks_plain(points, masks, cams, lab, L)
    assert torch.equal(got, want), "reproject kernel != plain"
    H, W = masks.shape[1:]
    touched, in_pairs = 0, 0
    for f in range(cams.shape[0]):
        lin, inside = reproject.project_points(points, cams[f], (H, W))
        touched += int(torch.unique(lin[inside]).numel())
        in_pairs += int(inside.sum())
    N, F = points.shape[0], cams.shape[0]
    n_bytes = 12 * N + cams.numel() * 4 + lab.numel() * 4 + touched + 4 * N * L
    b, by = bound_ms(n_bytes, 32 * N * F)
    runs = int((cams[1:] != cams[:-1]).any(1).sum()) + 1
    out["k7"] = {"points": N, "files": F, "labels": L, "camera_runs": runs,
                 "launches_per_call": launches, "bit_equal": True,
                 "in_frame_pairs": in_pairs, "mask_bytes_read": touched,
                 "ms": cuda_ms(k7_call, reps=21),
                 "device_us_by_kernel": device_us_by_kernel(k7_call),
                 "bound_ms": b, "bound_by": by,
                 "bound_ms_runs": bound_ms(n_bytes,
                                           30 * N * runs + 2 * N * F)[0]}
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--tmp", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        measure(a.one, a.tmp)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("harris_reproject_ab: needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        sys.path.insert(0, str(ROOT))
        scene(Path(tmp) / "scene.npz")
        for root in a.roots:
            subprocess.run([sys.executable, __file__, "--one", root, "--tmp",
                            tmp], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
