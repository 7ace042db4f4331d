#!/usr/bin/env python3
"""K10 (mask filter) and K4 (band compaction) of one or more checkouts of
the port, timed in turns on one card.

Each root is measured in its own process (each checkout builds its own
kernels), in the order given, so `--roots parent change change parent`
compares two versions on one card. Inputs are made on the card from a
seed, at the main path's shapes: 58 RGB uint8 images of 1440x1080 (phase
10's stack) for K10's fast lane (coefficients (0, 1, 0) at 0.15, the front
end's Masks), its excess-green lane and one image of it (a live-carving
view); for K4 the level-set band of an ellipsoid on the ML grid
(165x146x504) and on a 1 mm geometric grid (101x101x131). Each kernel is
held equal to its plain version and timed (CUDA events, median) beside
one PyTorch call for the same function (`imgs[..., k] > t`; `nonzero` +
`index_select`); the one-image calls also by their device time alone
(torch.profiler), since the host sets their call time. Prints one JSON
line a root, then the card's name and power limit.

    python tools/mask_band_ab.py --roots .chipwork/parent . . .chipwork/parent
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def device_us(fn, reps=20):
    """Mean device microseconds of fn() (torch.profiler's kernel times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / reps


def measure(root):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from plant3dvision_tpu_torch import kernels, proc3d
    from plant3dvision_tpu_torch.ops import edt, filters, masks
    assert Path(kernels.__file__).resolve().is_relative_to(root)
    sys.path.append(str(ROOT))        # chip_smoke's timing helpers
    from chip_smoke import bound_ms, cuda_ms, fast_lane_library, host_syncs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"root": str(root)}
    kernels.lib()
    out["build_s"] = kernels.last_build_seconds

    imgs = torch.randint(0, 256, (58, 1080, 1440, 3), generator=g,
                         dtype=torch.uint8, device=dev)
    for name, ftype, stack in (("fast", "linear", imgs),
                               ("excess_green", "excess_green", imgs),
                               ("fast_one_image", "linear", imgs[:1])):
        args = (stack, ftype, (0.0, 1.0, 0.0), 0.15, True)
        assert torch.equal(masks.mask_filter(*args),
                           masks.mask_filter_plain(*args)), name
        reps = 21 if stack.shape[0] == 1 else 7
        r = {"ms": cuda_ms(lambda: masks.mask_filter(*args), reps=reps)}
        if ftype == "linear":
            _, _, ch, t = masks._lane(stack, ftype, (0.0, 1.0, 0.0), 0.15,
                                      True)
            r["library_ms"] = cuda_ms(
                lambda: fast_lane_library(stack, ch, t), reps=reps)
        n = stack.shape[0] * 1080 * 1440
        r["bound_ms"] = bound_ms(4 * n, (1 if ftype == "linear" else 12)
                                 * n)[0]
        if stack.shape[0] == 1:     # host-bound: the kernels' own time
            r["device_us"] = device_us(lambda: masks.mask_filter(*args))
            r["library_device_us"] = device_us(
                lambda: fast_lane_library(stack, ch, t))
        out["k10_" + name] = r
    del imgs

    for name, shape in (("ml", (165, 146, 504)), ("geometric",
                                                  (101, 101, 131))):
        # an ellipsoid filling the grid's middle: a band of a few %
        axes = torch.meshgrid(*[torch.linspace(-1, 1, s, device=dev)
                                for s in shape], indexing="ij")
        vol = (sum(a * a for a in axes) < 0.5).float() * 2 - 1
        sd = edt.signed_distance(vol, 20)
        gx, gy, gz = (filters.gaussian_filter(t, 1.0)
                      for t in filters.gradient(sd))
        k = proc3d.band_compact(sd, gx, gy, gz, 0.0)
        p = proc3d.band_compact_plain(sd, gx, gy, gz, 0.0)
        assert all(torch.equal(a, b) for a, b in zip(k, p)), name
        lo, hi = proc3d.band_limits(0.0)

        def library():
            flat = sd.reshape(-1)
            idx = torch.nonzero((flat > float(lo)) & (flat <= float(hi)))
            idx = idx.reshape(-1)
            return [t.reshape(-1).index_select(0, idx)
                    for t in (sd, gx, gy, gz)]

        before = kernels.LAUNCHES["band_compact"]
        _, syncs = host_syncs(
            lambda: proc3d.band_compact(sd, gx, gy, gz, 0.0))
        per_call = kernels.LAUNCHES["band_compact"] - before
        n = sd.numel()
        out["k4_" + name] = {
            "shape": list(shape), "n_band": len(k[0]),
            "ms": cuda_ms(lambda: proc3d.band_compact(sd, gx, gy, gz, 0.0)),
            "library_ms": cuda_ms(library),
            "bound_ms": bound_ms(4 * n + 36 * len(k[0]), 2 * n)[0],
            "launches_a_call": per_call, "host_syncs_a_call": syncs}
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
        sys.exit("mask_band_ab: needs a CUDA device")
    for root in a.roots:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
