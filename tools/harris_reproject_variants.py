#!/usr/bin/env python3
"""Where K13's and K7's time goes: variants of their sources, each built
alone and timed on one card.

A variant is a copy of `kernels/csrc/harris.cu` or `reproject.cu` with
named edits: another block shape, or a part of the work cut out (an
ablation: its output is wrong by design and is not checked). Each is built
by nvcc with the port's flags into a library of its own and called through
ctypes on `tools/harris_reproject_ab.py`'s inputs (K13: a 12-view
1080x1440 chunk; K7: 103,445 points x 630 image-major 896x896 masks). The
variants that compute the function are held bit-equal to its plain version.
All variants are timed twice, in turns (CUDA events, median ms). Also
counts the 32-byte sectors a warp's K7 gathers touch in a file, for the
points in their own order and in K7's block order. Prints one JSON line,
then the card's name and power limit.

    python tools/harris_reproject_variants.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "plant3dvision_tpu_torch" / "kernels" / "csrc"

_GATHER = ("s_tab[f][t] = __ldg(m);", "s_tab[f][t] = (uint8_t)(lin + f);")
_PHASE2 = ("for (int i = 0; i < c; ++i)",
           "for (int i = 0; i < (c > 0); ++i)")
_PHASE1 = ("for (int r = 0; r < nruns; ++r) {",
           "for (int r = 0; r < 0; ++r) {")
_DIV = [("__fdiv_rn(p0, pz)", "__fmul_rn(p0, pz)"),
        ("__fdiv_rn(p1, pz)", "__fmul_rn(p1, pz)")]
_SORT = ("  if (F > 0) {\n    // the block",
         "  if (F < 0) {\n    // the block")

#: name -> (edits, computes the function)
K7_VARIANTS = {
    "kernel": ([], True),
    "points_128": ([("constexpr int P = 256;", "constexpr int P = 128;")],
                   True),
    "chunk_32": ([("constexpr int FC = 64;", "constexpr int FC = 32;")], True),
    "chunk_128": ([("constexpr int FC = 64;", "constexpr int FC = 128;")],
                  True),
    "unsorted": ([_SORT], True),
    "no_gathers": ([_GATHER], False),
    "no_phase2": ([_PHASE2], False),
    "no_gathers_no_phase2": ([_GATHER, _PHASE2], False),
    "no_gathers_no_phase2_no_division": ([_GATHER, _PHASE2, *_DIV], False),
    "no_gathers_no_phase2_no_sort": ([_GATHER, _PHASE2, _SORT], False),
    "chunks_only": ([_PHASE1, _PHASE2], False),
}
_BOUNDS = "__launch_bounds__(32 * WARPS)"
K13_VARIANTS = {
    "kernel": ([], True),
    "warps_1": ([("constexpr int WARPS = 4;", "constexpr int WARPS = 1;")],
                True),
    "warps_8": ([("constexpr int WARPS = 4;", "constexpr int WARPS = 8;")],
                True),
    "six_blocks_an_sm": ([(_BOUNDS, "__launch_bounds__(32 * WARPS, 6)")],
                         True),
}
K13_ROWS = (16, 24, 32, 40, 64)


def build(tmp, src, name, edits):
    """Start nvcc on `src` with `edits` into tmp/name.so."""
    from plant3dvision_tpu_torch import kernels
    text = (CSRC / src).read_text()
    for old, new in edits:
        assert old in text, f"{name}: {old!r} not in {src}"
        text = text.replace(old, new)
    (tmp / f"{name}.cu").write_text(text)
    return subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
         str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def entry(tmp, name, fn, argtypes):
    f = getattr(ctypes.CDLL(str(tmp / f"{name}.so")), fn)
    f.argtypes, f.restype = argtypes, ctypes.c_int
    return f


def sectors_a_warp_gather(points, cams, H, W, block):
    """The mean number of 32-byte mask sectors that a warp's 32 gathers
    touch in a file, over every camera run's first file: points in their
    own order (`block` None) or each block's points in pixel order of file
    0, as K7 takes them."""
    import torch
    from plant3dvision_tpu_torch.ops.reproject import (camera_runs,
                                                       project_points)
    N = points.shape[0]
    order = torch.arange(N, device=points.device)
    if block:
        lin, inside = project_points(points, cams[0], (H, W))
        key = torch.where(inside, lin, H * W).double() + order / (2.0 * N)
        key = key + (order // block) * float(2 * H * W)
        order = torch.argsort(key)
    n = N // 32 * 32
    total = 0
    runs = camera_runs(cams, None)
    for f in runs.tolist():
        lin, _ = project_points(points[order], cams[f], (H, W))
        sec = torch.sort((lin[:n] // 32).view(-1, 32), dim=1).values
        total += int((sec[:, 1:] != sec[:, :-1]).sum()) + sec.shape[0]
    return total / (len(runs) * (n // 32))


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("harris_reproject_variants: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import harris_reproject_ab as ab
    from chip_smoke import cuda_ms
    from plant3dvision_tpu_torch.ops import reproject, sfmlite

    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        procs = {("k7", n): build(tmp, "reproject.cu", "k7_" + n, e)
                 for n, (e, _) in K7_VARIANTS.items()}
        procs.update({("k13", n): build(tmp, "harris.cu", "k13_" + n, e)
                      for n, (e, _) in K13_VARIANTS.items()})
        for key, proc in procs.items():
            log, _ = proc.communicate()
            assert proc.returncode == 0, (key, log)
        ab.scene(tmp / "scene.npz")
        dev = torch.device("cuda")
        (gray, mask), (points, masks, cams, lab, L) = ab.inputs(tmp, dev)
        stream = torch.cuda.current_stream().cuda_stream
        calls = {}

        N, F = points.shape[0], cams.shape[0]
        H, W = masks.shape[1:]
        want = reproject.score_points_by_masks_plain(points, masks, cams,
                                                     lab, L)
        for name, (_, exact) in K7_VARIANTS.items():
            f = entry(tmp, "k7_" + name, "p3d_reproject",
                      [P_, P_, P_, P_, I_, I_, I_, I_, I_, P_, P_])
            out = torch.empty((N, L), device=dev)

            def k7(f=f, out=out):
                assert f(points.data_ptr(), masks.data_ptr(),
                         cams.data_ptr(), lab.data_ptr(), N, F, H, W, L,
                         out.data_ptr(), stream) == 0
            k7()
            torch.cuda.synchronize()
            assert not exact or torch.equal(out, want), name
            calls[f"k7_{name}"] = k7

        V, Hh, Wh = gray.shape
        want = sfmlite.harris_response_plain(gray, mask)
        for name, (_, exact) in K13_VARIANTS.items():
            f = entry(tmp, "k13_" + name, "p3d_harris",
                      [P_, P_, I_, I_, I_, I_, I_, F_, P_, P_])
            out = torch.empty_like(gray)
            for rows in K13_ROWS if name == "kernel" else (32,):
                def k13(f=f, out=out, rows=rows):
                    assert f(gray.data_ptr(), mask.data_ptr(), V, Hh, Wh,
                             rows, 16, 0.06, out.data_ptr(), stream) == 0
                k13()
                torch.cuda.synchronize()
                assert not exact or torch.equal(out, want), (name, rows)
                calls[f"k13_{name}_rows{rows}"] = k13

        sectors = {"point_order": sectors_a_warp_gather(points, cams, H, W,
                                                        None),
                   "blocks_in_pixel_order": sectors_a_warp_gather(
                       points, cams, H, W, 256)}
        ms = {k: [] for k in calls}
        for _ in range(2):
            for k, fn in calls.items():
                ms[k].append(cuda_ms(fn, reps=21))
    print(json.dumps({"ms": ms, "k7_sectors_a_warp_gather": sectors}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
