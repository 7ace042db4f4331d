#!/usr/bin/env python3
"""K8 (exact-disk dilation) and K3 (smoothed gradient) of one or more
checkouts of the port, timed in turns on one card.

Each root is measured in its own process (each checkout builds its own
kernels), in the order given, so `--roots parent change change parent`
compares two versions on one card. Inputs are made on the card from a
seed, at the passes' shapes. K8: a mask stack of plant-like silhouettes
(one filled ellipse a mask, about 4 % of the frame) at radius 1 on 756 x
896x896 (the binarised Segmentation2D), radius 3 on 58 x 1080x1440 (the
Masks task) and radius 6 on 60 x 1080x1440 (the calibration's keypoint
masks). K3: the signed distance of an ellipsoid on the ML grid
(165x146x504) and on a 1 mm geometric grid (81x80x199), through the
route vol2pcd takes in that checkout (`smoothed_gradient` where it
exists, else `gradient` then `gaussian_filter`), with its launches a call.
Each is held equal to its plain version and timed (CUDA events, median; and
its kernels' device time, torch.profiler) beside one PyTorch call for the
same function (`conv2d` with the disk; `torch.gradient` + pad + grouped
`conv3d`, TF32 off). Prints one JSON line a root, then the card's name and
power limit.

    python tools/dilate_filters_ab.py --roots .chipwork/parent . . .chipwork/parent
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

DILATIONS = (("r1_seg2d", 1, (756, 896, 896)),
             ("r3_masks", 3, (58, 1080, 1440)),
             ("r6_keypoints", 6, (60, 1080, 1440)))
GRIDS = (("ml", (165, 146, 504)), ("geometric", (81, 80, 199)))


def silhouettes(n, H, W, gen, dev):
    """n bool masks of H x W, each a filled ellipse at a seeded place."""
    import torch
    c = torch.rand((n, 4), generator=gen, device=dev)
    cy = (0.3 + 0.4 * c[:, 0]) * H
    cx = (0.3 + 0.4 * c[:, 1]) * W
    ay = (0.15 + 0.1 * c[:, 2]) * H
    ax = (0.06 + 0.04 * c[:, 3]) * W
    yy = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, None, :]
    return (((yy - cy[:, None, None]) / ay[:, None, None]) ** 2
            + ((xx - cx[:, None, None]) / ax[:, None, None]) ** 2) <= 1.0


def measure(root):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import edt, filters, masks
    assert Path(kernels.__file__).resolve().is_relative_to(root)
    sys.path += [str(ROOT), str(ROOT / "tools")]    # the timing helpers
    from chip_smoke import (bound_ms, cuda_ms, library_dilation,
                            library_smoothed_gradient)
    from mask_band_ab import device_us

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"root": str(root)}
    kernels.lib()
    out["build_s"] = kernels.last_build_seconds

    for name, r, (n, H, W) in DILATIONS:
        m = silhouettes(n, H, W, gen, dev)
        got = masks.binary_dilation(m, r)
        assert torch.equal(got, masks.binary_dilation_plain(m, r)), name
        assert torch.equal(library_dilation(m, r), got), name
        out["k8_" + name] = {
            "radius": r, "shape": [n, H, W],
            "true_in": int(m.sum()), "true_out": int(got.sum()),
            "ms": cuda_ms(lambda: masks.binary_dilation(m, r)),
            "device_us": device_us(lambda: masks.binary_dilation(m, r)),
            "library_ms": cuda_ms(lambda: library_dilation(m, r), reps=5,
                                  warmup=1),
            "bound_ms": bound_ms(2 * m.numel(), 0)[0]}
        del m, got

    fused = getattr(filters, "smoothed_gradient", None)

    def k3(x):
        if fused is not None:
            return fused(x, 1.0)
        return [filters.gaussian_filter(g, 1.0) for g in filters.gradient(x)]

    taps = filters.gaussian_kernel1d(1.0).astype(np.float32)
    for name, shape in GRIDS:
        axes = torch.meshgrid(*[torch.linspace(-1, 1, s, device=dev)
                                for s in shape], indexing="ij")
        vol = (sum(a * a for a in axes) < 0.5).float() * 2 - 1
        sd = edt.signed_distance(vol, 20)
        before = kernels.LAUNCHES["gradient_gaussian"]
        got = k3(sd)
        per_call = kernels.LAUNCHES["gradient_gaussian"] - before
        want = [filters.gaussian_filter_plain(g, 1.0)
                for g in filters.gradient_plain(sd)]
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        assert err <= 1e-5, (name, err)
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        lib = cuda_ms(lambda: library_smoothed_gradient(sd, taps))
        torch.backends.cudnn.allow_tf32 = prev
        n = sd.numel()
        out["k3_" + name] = {
            "shape": list(shape), "route": "fused" if fused else "per axis",
            "launches_per_call": per_call, "bit_equal": equal,
            "max_abs_err": err, "ms": cuda_ms(lambda: k3(sd)),
            "device_us": device_us(lambda: k3(sd)), "library_ms": lib,
            "bound_ms": bound_ms(16 * n, (6 + 3 * 3 * 18) * n)[0]}
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        measure(a.one)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("dilate_filters_ab: needs a CUDA device")
    for root in a.roots:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
