#!/usr/bin/env python3
"""K2 (signed distance) and K16's weight quantise of one or more checkouts
of the port, timed in turns on one card.

Each root is measured in its own process (each checkout builds its own
kernels), in the order given, so `--roots parent change change parent`
compares two versions on one card. K2: the signed distance of an
ellipsoid on the ML grid (165x146x504) and on a 1 mm geometric grid
(81x80x199), at vol2pcd's cap 20 and at cap None, each call with its
launches, held bit-equal to `signed_distance_plain`. K16's weight
quantise: every compute weight of unet_seg and tpusegnet_seg in bf16 (as
`int8_lane` casts them) through the checkout's lane entry
(`quantize_weights` where it exists, else one `quantize_weight` a weight),
amax and the packed layout (and q, where the checkout keeps it) held
bit-equal to the plain version (`quantize_weight_plain` + `pack_weight`),
beside the library chain (chip_smoke's `_library_quantize_weight`) summed
over the weights. Each is
timed as a call (CUDA events, median) and as its kernels' device time
(torch.profiler). Prints one JSON line a root, then the card's name and
power limit.

    python tools/edt_quant_ab.py --roots .chipwork/parent . . .chipwork/parent
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

GRIDS = (("ml", (165, 146, 504)), ("geometric", (81, 80, 199)))
CAPS = (20, None)


def ellipsoid(shape, dev):
    import torch
    axes = torch.meshgrid(*[torch.linspace(-1, 1, s, device=dev)
                            for s in shape], indexing="ij")
    r = (axes[0] / 0.8) ** 2 + (axes[1] / 0.6) ** 2 + (axes[2] / 0.9) ** 2
    return (r < 1.0).float() * 2 - 1


def k2_bound_ms(shape, cap, axes=(0, 1, 2)):
    """The windowed min-plus's operations (2 a candidate and channel) along
    `axes` and the volume's bytes in and out, as chip_smoke's K2 rows count
    them (axes 1 and 2: its `bound_ms_yz`)."""
    from chip_smoke import bound_ms
    n = shape[0] * shape[1] * shape[2]
    reads = sum(2 * (shape[a] - s) * (n // shape[a])
                for a in axes
                for s in range(1, min(shape[a] - 1 if cap is None else cap,
                                      shape[a] - 1) + 1))
    return bound_ms(8 * n, 2 * 2 * reads)


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


def measure(root):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.models import checkpoint, quant
    from plant3dvision_tpu_torch.models.zoo import (DEFAULT_CHECKPOINT,
                                                    TPUSEGNET_CHECKPOINT)
    from plant3dvision_tpu_torch.ops import edt
    assert Path(kernels.__file__).resolve().is_relative_to(root)
    sys.path.append(str(ROOT))                      # the timing helpers
    from chip_smoke import _library_quantize_weight, bound_ms, cuda_ms

    dev = torch.device("cuda")
    out = {"root": str(root)}
    kernels.lib()
    out["build_s"] = kernels.last_build_seconds

    for name, shape in GRIDS:
        vol = ellipsoid(shape, dev)
        for cap in CAPS:
            before = kernels.LAUNCHES["signed_distance"]
            got = edt.signed_distance(vol, cap)
            per_call = kernels.LAUNCHES["signed_distance"] - before
            equal = bool(torch.equal(got, edt.signed_distance_plain(vol, cap)))
            assert equal, (name, cap)
            b, by = k2_bound_ms(shape, cap)
            out[f"k2_{name}_cap{cap}"] = {
                "shape": list(shape), "cap": cap,
                "lane": (None if not hasattr(edt, "lane16") else "16-bit"
                         if edt.lane16(edt.axis_caps(shape, cap))
                         else "32-bit"),
                "launches_per_call": per_call, "bit_equal": equal,
                "ms": cuda_ms(lambda: edt.signed_distance(vol, cap)),
                "device_us_by_kernel": device_us_by_kernel(
                    lambda: edt.signed_distance(vol, cap)),
                "bound_ms": b, "bound_by": by,
                "bound_ms_yz": k2_bound_ms(shape, cap, (1, 2))[0]}
            del got
        del vol

    lane = getattr(quant, "quantize_weights", None)

    def quantise(ws):
        return lane(ws) if lane else [quant.quantize_weight(w) for w in ws]

    for ckpt in (DEFAULT_CHECKPOINT, TPUSEGNET_CHECKPOINT):
        path = ROOT / "checkpoints" / ckpt.name     # a parent has none
        params, config = checkpoint.params_from_npz_bytes(path.read_bytes())
        model = checkpoint.model_from_config(config)
        model.load_state_dict(checkpoint.state_dict_from_flax(
            checkpoint._upcast_f16(params)))
        model = model.to(dev, torch.bfloat16).eval()
        ws = [c.weight.detach().to(model.dtype)
              for c in quant.compute_convs(model)]
        before = kernels.LAUNCHES["int8_quantize"]
        qws = quantise(ws)
        per_call = kernels.LAUNCHES["int8_quantize"] - before
        p_bytes = 0
        for w, qw in zip(ws, qws):
            pw = quant.quantize_weight_plain(w)
            assert qw.q is None or torch.equal(qw.q, pw.q)
            assert torch.equal(qw.amax, pw.amax)
            assert torch.equal(qw.packed, quant.pack_weight(pw.q, qw.plan))
            p_bytes += qw.packed.numel()
        del qws
        # the weights read, one int8 copy (packed, with its pads) and the
        # amaxes written
        w_bytes = sum(w.numel() * w.element_size() for w in ws)
        b, by = bound_ms(w_bytes + p_bytes + sum(4 * w.shape[0] for w in ws),
                         4 * sum(w.numel() for w in ws))
        out["k16w_" + path.stem] = {
            "weights": len(ws), "route": ("quantize_weights" if lane
                                          else "quantize_weight each"),
            "launches_per_call": per_call, "bit_equal": True,
            "ms": cuda_ms(lambda: quantise(ws)),
            "device_us_by_kernel": device_us_by_kernel(lambda: quantise(ws)),
            "library_ms": cuda_ms(lambda: [_library_quantize_weight(w)
                                           for w in ws]),
            "bound_ms": b, "bound_by": by}
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
        sys.exit("edt_quant_ab: needs a CUDA device")
    for root in a.roots:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
