#!/usr/bin/env python3
"""K15 (geodesic tracing) and the gather probes K17-K19 of one or more
checkouts of the port, timed in turns on one card; with --variants, build
variants of this checkout's two sources and time them on the same inputs.

Each root is measured in its own process (each checkout builds its own
kernels), in the order given, so `--roots parent change change parent`
compares two versions on one card. The inputs, made once:

- K15 at phase 14's inputs: `chip_smoke.write_distorted_scan`'s 60-view
  1440x1080 scan through `chip_smoke.fim_config()` up to CurveSkeleton on
  the card (this checkout's port), the eikonal solve on its 301x301x561
  volume, the flow (`gradient_flow`) and where(mask, d, 0), and the
  skeleton's leaves as tips: 2000 steps of 0.5, as phase 14 runs them.
- K17 at exp_pallas_gather.py's three sizes (L = 8K, 32K, 128K; an (8, L)
  table, (8, 8192) indices, 64 reps), K18 at its two (R = 4K, 32K; an (R,
  32) table, 4096 rows, 64 reps) and K19 at its one (a (4096, 32) table,
  64 reps), drawn by `gather_probe`'s input makers from numpy seeded as
  phase 17 seeds each.

The plain versions run once, in a process of their own (this checkout's;
unchanged from the parent), K15's with each particle's steps. Each root
holds its kernels equal to them and times each call:
K15 with CUDA events (median, the vote grid's zeroing included) and as
device time by kernel (torch.profiler, `chip_smoke.device_ms_by_kernel`);
K17-K19 as `gather_probe.timed`'s
graph-replayed calls, and at reps = 0 (the floor). Each root also gives
the load and shuffle instructions of K18's and K19's kernels in its
library's SASS (`cuobjdump -sass`). Prints one JSON line a root (or one
for the variants), then the card's name and power limit. `--gather-only`
leaves K15 out (no scan, no solve: a minute instead of a few).

    python tools/trace_gather_ab.py --roots .chipwork/parent . . .chipwork/parent
    python tools/trace_gather_ab.py --variants
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "plant3dvision_tpu_torch" / "kernels" / "csrc"

#: phase 17's three K17 sizes, the seeds phase 17 gives them, N and reps
K17_SIZES = ((0, 8 * 1024), (1, 32 * 1024), (2, 128 * 1024))
K17_N, K17_REPS = 8 * 1024, 64
#: phase 17's K18 sizes (seed, R) and K19's seed; P and reps of both
K18_SIZES = ((3, 4 * 1024), (4, 32 * 1024))
K19_SEED, GATHER_P, GATHER_REPS = 5, 4096, 64
STEP, N_STEPS = 0.5, 2000

def _k15_prefetch(level, a1, a2):
    """K15 with the path ahead prefetched each step: lane j asks `level`
    for the line of its channel at corner row (x + (j >> 2 & 1), y + (j >>
    3 & 1)), a1 (j < 16) or a2 steps ahead along the current flow."""
    anchor = "  return sample_all(vol, stride, px, py, pz, g, nx, ny, nz);"
    code = (
        "  {\n"
        "    const int grp = (threadIdx.x & 31) >> 2;\n"
        f"    const float ah = (float)(grp & 4 ? {a2} : {a1}) * step;\n"
        "    const Corner a = corner(px - ah * g[0], py - ah * g[1],\n"
        "                            pz - ah * g[2], nx, ny, nz);\n"
        "    const long long v = ((long long)(a.x + (grp & 1)) * ny +\n"
        "                         (a.y + (grp >> 1 & 1))) * nz + a.z;\n"
        f"    asm volatile(\"prefetch.global.{level} [%0];\" ::\n"
        "                 \"l\"(vol + v * stride));\n"
        "  }\n" + anchor)
    return [(anchor, code)]


#: --variants: name -> (source, source edits, computes the function); a
#: variant with a part cut out (an ablation) is timed, not checked
VARIANTS = {
    "k15": ("geodesics.cu", [], True),
    "k15_two_warps_a_block": ("geodesics.cu", [(
        "constexpr int kWarps = 1;", "constexpr int kWarps = 2;")], True),
    "k15_four_warps_a_block": ("geodesics.cu", [(
        "constexpr int kWarps = 1;", "constexpr int kWarps = 4;")], True),
    "k15_two_warps_min_blocks_1": ("geodesics.cu", [
        ("constexpr int kWarps = 1;", "constexpr int kWarps = 2;"),
        ("__global__ void __launch_bounds__(32 * kWarps)",
         "__global__ void __launch_bounds__(32 * kWarps, 1)")], True),
    "k15_prefetch_l2_2_4": ("geodesics.cu", _k15_prefetch("L2", 2, 4), True),
    "k17": ("gather.cu", [], True),
    "k17_all_direct": ("gather.cu", [(
        "constexpr int kStageMaxL = 16384;",
        "constexpr int kStageMaxL = 0;")], True),
    "k17_stage_max_56k": ("gather.cu", [(
        "constexpr int kStageMaxL = 16384;",
        "constexpr int kStageMaxL = 58112;")], True),
    "k18": ("gather.cu", [], True),
    "k18_unroll_4": ("gather.cu", [(
        "constexpr int kRowsUnroll = 8;", "constexpr int kRowsUnroll = 4;")],
        True),
    "k18_unroll_16": ("gather.cu", [(
        "constexpr int kRowsUnroll = 8;", "constexpr int kRowsUnroll = 16;")],
        True),
    "k18_warps_4": ("gather.cu", [(
        "constexpr int kRowsWarps = 8;", "constexpr int kRowsWarps = 4;")],
        True),
    "k18_warps_16": ("gather.cu", [(
        "constexpr int kRowsWarps = 8;", "constexpr int kRowsWarps = 16;")],
        True),
    "k19": ("gather.cu", [], True),
    "k19_warps_4": ("gather.cu", [(
        "constexpr int kSelectWarps = 8;", "constexpr int kSelectWarps = 4;")],
        True),
    "k19_warps_32": ("gather.cu", [(
        "constexpr int kSelectWarps = 8;",
        "constexpr int kSelectWarps = 32;")], True),
    # lane l takes i = 32 m + l: its column repeats every round, and ptxas
    # merges the repeated shuffles (the SASS counts show it)
    "k19_column_a_lane": ("gather.cu", [(
        "const unsigned j = (lane + m) & 31u;", "const unsigned j = lane;")],
        True),
}

#: the variants' entry point by the kernel their name starts with
VARIANT_KERNEL = {"k15": "p3d_trace_geodesics", "k17": "p3d_gather_axis1",
                  "k18": "p3d_gather_rows", "k19": "p3d_gather_select32"}


def scene(tmp):
    """Phase 14's K15 inputs, saved to tmp/k15.pt: the mask, the solve's
    distances and the skeleton's leaves (index coordinates)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from plant3dvision_tpu_torch.ops.eikonal import geodesic_distance
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.synth import SyntheticPlant

    db = cs.make_db(Path(tmp) / "db")
    try:
        cs.write_distorted_scan(db, "frontend",
                                SyntheticPlant(**cs.NORTHSTAR_PLANT), 60,
                                1440, 1080, 1400.0)
        cfg = cs.fim_config()
        ctx = RunContext(db, "frontend", cfg, device="cuda")
        report = run_task(ctx, "CurveSkeleton", report=False)
        mask, seeds = cs.fim_inputs(ctx.scan, report, cfg)
        d = geodesic_distance(mask, seeds)
        skel = json.loads(ctx.scan.get_fileset(
            report["CurveSkeleton"]["fileset"]).get_files()[0].read_raw())
        vfile = ctx.scan.get_fileset(
            report["Voxels"]["fileset"]).get_files()[0]
        origin = np.asarray(vfile.get_metadata("origin"))
        vs = float(vfile.get_metadata("voxel_size"))
    finally:
        db.disconnect()
    lines = np.asarray(skel["lines"]).reshape(-1, 2)
    deg = np.bincount(lines.ravel(), minlength=len(skel["points"]))
    leaves = (np.asarray(skel["points"])[deg == 1] - origin) / vs
    torch.save({"mask": mask.cpu(), "d": d.cpu(),
                "tips": torch.from_numpy(leaves.astype(np.float32))},
               Path(tmp) / "k15.pt")


def k15_inputs(tmp, dev):
    import torch
    from plant3dvision_tpu_torch.ops.eikonal import gradient_flow
    z = torch.load(Path(tmp) / "k15.pt")
    mask, d = z["mask"].to(dev), z["d"].to(dev)
    return (gradient_flow(d, mask), torch.where(mask, d, 0.0),
            z["tips"].to(dev))


def k17_inputs(seed, L, dev):
    import numpy as np
    from plant3dvision_tpu_torch.tools import gather_probe as gp
    np.random.seed(seed)
    return gp.axis1_inputs(L, K17_N, dev)


def k18_inputs(seed, R, dev):
    import numpy as np
    from plant3dvision_tpu_torch.tools import gather_probe as gp
    np.random.seed(seed)
    return gp.rows_inputs(R, GATHER_P, dev)


def k19_inputs(dev):
    import numpy as np
    from plant3dvision_tpu_torch.tools import gather_probe as gp
    np.random.seed(K19_SEED)
    return gp.select32_inputs(GATHER_P, dev)


def plain(tmp, with_k15):
    """The plain versions' results (K15's with each particle's steps),
    saved to tmp/plain.pt."""
    import torch
    from plant3dvision_tpu_torch.ops import geodesics
    from plant3dvision_tpu_torch.tools import gather_probe as gp
    dev = torch.device("cuda")
    out = {}
    if with_k15:
        flow, values, tips = k15_inputs(tmp, dev)
        votes, steps = geodesics.trace_geodesics_plain(
            flow, values, tips, STEP, N_STEPS, return_steps=True)
        out.update(k15=votes.cpu(), k15_steps=steps.cpu())
    for seed, L in K17_SIZES:
        out[f"k17_{L}"] = gp.axis1_gather_plain(
            *k17_inputs(seed, L, dev), K17_REPS).cpu()
    for seed, R in K18_SIZES:
        out[f"k18_{R}"] = gp.rows_gather_plain(
            *k18_inputs(seed, R, dev), GATHER_REPS).cpu()
    out["k19"] = gp.select32_plain(*k19_inputs(dev), GATHER_REPS).cpu()
    torch.save(out, Path(tmp) / plain_file(with_k15))


def sass_counts(so):
    """K18's and K19's kernels in a built library's SASS (`cuobjdump
    -sass`): for each kernel (K18 by its <VEC, MOD> lane), the count of
    each global load, store, shuffle and branch opcode."""
    from plant3dvision_tpu_torch import kernels
    tool = Path(kernels._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = re.search(r"(rows|select32)_kernel(?:ILb(\d)ELb(\d)E)?",
                          line)
            name = m and m[0].split("I")[0] + (
                f"<{m[2]},{m[3]}>" if m[2] else "")
            if name:
                out[name] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if name and m and m[1].split(".")[0] in ("LDG", "STG", "SHFL", "BRA"):
            out[name][m[1]] = out[name].get(m[1], 0) + 1
    return out


def k15_bound(values, tips, steps):
    """chip_smoke phase 14's K15 bound: the tips, the dense votes, 8
    corners of flow and values (128 B) and ~130 operations a step."""
    from chip_smoke import bound_ms
    return bound_ms(tips.numel() * 4 + 4 * values.numel() + 128 * steps,
                    130 * steps)


def measure(root, tmp, with_k15):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.tools import gather_probe as gp
    assert Path(kernels.__file__).resolve().is_relative_to(root)
    sys.path.append(str(ROOT))                      # the timing helpers
    from chip_smoke import bound_ms

    dev = torch.device("cuda")
    out = {"root": str(root)}
    kernels.lib()
    out["build_s"] = kernels.last_build_seconds
    out["sass"] = sass_counts(kernels.build())
    want = torch.load(Path(tmp) / plain_file(with_k15))
    if with_k15:
        out["k15"] = measure_k15(tmp, want)
    for seed, L in K17_SIZES:
        tab, idx = k17_inputs(seed, L, dev)
        got = gp.axis1_gather(tab, idx, K17_REPS)
        assert torch.equal(got.cpu(), want[f"k17_{L}"]), f"axis1 L={L}"
        lookups = tab.shape[0] * K17_N * K17_REPS
        b, by = bound_ms(4 * (tab.numel() + 2 * idx.numel()), 4 * lookups)
        out[f"k17_L{L}"] = {
            "equal": True,
            "ms": gp.timed(lambda: gp.axis1_gather(tab, idx, K17_REPS)) * 1e3,
            "floor_ms": gp.timed(lambda: gp.axis1_gather(tab, idx, 0)) * 1e3,
            "bound_ms": b, "bound_by": by}
    probes = [(f"k18_R{R}", f"k18_{R}", gp.rows_gather,
               k18_inputs(seed, R, dev)) for seed, R in K18_SIZES]
    probes.append(("k19", "k19", gp.select32, k19_inputs(dev)))
    for key, plain_key, fn, args in probes:
        got = fn(*args, GATHER_REPS)
        assert torch.equal(got.cpu(), want[plain_key]), key
        # phase 17's bound: inputs and output once, 4 operations a lookup
        b, by = bound_ms(4 * (sum(a.numel() for a in args) + got.numel()),
                         4 * GATHER_P * GATHER_REPS)
        out[key] = {
            "equal": True,
            "ms": gp.timed(lambda: fn(*args, GATHER_REPS)) * 1e3,
            "floor_ms": gp.timed(lambda: fn(*args, 0)) * 1e3,
            "bound_ms": b, "bound_by": by}
    print(json.dumps(out), flush=True)


def measure_k15(tmp, want):
    """K15 at phase 14's inputs, held to the plain votes."""
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import geodesics
    from chip_smoke import cuda_ms, device_ms_by_kernel
    flow, values, tips = k15_inputs(tmp, torch.device("cuda"))

    def k15():
        return geodesics.trace_geodesics(flow, values, tips, STEP, N_STEPS)

    before = kernels.LAUNCHES["trace_geodesics"]
    got = k15()
    launches = kernels.LAUNCHES["trace_geodesics"] - before
    assert torch.equal(got.cpu(), want["k15"]), "trace kernel != plain"
    del got
    steps = want["k15_steps"]
    b, by = k15_bound(values, tips, int(steps.sum()))
    return {"grid": list(values.shape), "particles": len(tips),
            "steps": int(steps.sum()), "longest_steps": int(steps.max()),
            "votes_equal": True, "launches_per_call": launches,
            "ms": cuda_ms(k15, reps=21),
            "device_ms_by_kernel": device_ms_by_kernel(k15, reps=20),
            "bound_ms": b, "bound_by": by}


def step_floor_us(so, iters=10000):
    """Microseconds of one dependent step with every read on chip, from a
    library's p3d_trace_step_floor at two step counts."""
    import torch
    from chip_smoke import cuda_ms
    f = so.p3d_trace_step_floor
    f.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    scratch = torch.zeros(4 * 4096, device="cuda")
    scratch[3 * 4096:] = 1.0
    sink = torch.zeros(1, device="cuda")

    def run(n):
        assert f(n, scratch.data_ptr(), sink.data_ptr(),
                 torch.cuda.current_stream().cuda_stream) == 0
    return (cuda_ms(lambda: run(iters + 1)) - cuda_ms(lambda: run(1))) \
        * 1e3 / iters


def variants(tmp, with_k15):
    """Build VARIANTS (edits of this checkout's sources), hold those that
    compute the function equal to the plain results, time each K15's
    dependent step on chip (`p3d_trace_step_floor`), and time each twice,
    in turns."""
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops.geodesics import upper_bounds
    from plant3dvision_tpu_torch.tools import gather_probe as gp
    from chip_smoke import cuda_ms
    chosen = {k: v for k, v in VARIANTS.items()
              if with_k15 or not k.startswith("k15")}
    procs = {}
    for name, (src, edits, _) in chosen.items():
        text = (CSRC / src).read_text()
        for old, new in edits:
            assert old in text, f"{name}: {old!r} not in {src}"
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", "-o", str(tmp / f"{name}.so"),
             str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    registers, sass = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, (name, log)
        # each kernel's registers and stack, as ptxas reports them
        lines = log.splitlines()
        registers[name] = [
            lines[i].split("for ")[-1][-40:] + ": " + lines[i + 2].split(
                ": ")[-1] + "; " + lines[i + 1].strip()
            for i in range(len(lines) - 2)
            if "Function properties" in lines[i]
            and any(k in lines[i] for k in ("trace_kernel", "axis1",
                                            "rows_kernel", "select32"))]
        if name[:3] in ("k18", "k19"):
            sass[name] = sass_counts(tmp / f"{name}.so")
    dev = torch.device("cuda")
    want = torch.load(tmp / plain_file(with_k15))
    if with_k15:
        flow, values, tips = k15_inputs(tmp, dev)
        nx, ny, nz = values.shape
        bx, by, bz = (float(v) for v in upper_bounds(values.shape))
    # (inputs, out shape, plain result, sizes after the three pointers) a
    # probe, by its variants' kernel
    probes = {
        "k17": [(f"L{L}", k17_inputs(seed, L, dev), (8, K17_N),
                 want[f"k17_{L}"], (8, L, K17_N, K17_REPS))
                for seed, L in K17_SIZES],
        "k18": [(f"R{R}", k18_inputs(seed, R, dev), (GATHER_P, 32),
                 want[f"k18_{R}"], (R, GATHER_P, GATHER_REPS))
                for seed, R in K18_SIZES],
        "k19": [("", k19_inputs(dev), (GATHER_P,), want["k19"],
                 (GATHER_P, GATHER_REPS))]}
    stream = torch.cuda.current_stream().cuda_stream
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    calls, out = {}, {}
    for name, (src, _, exact) in chosen.items():
        so = ctypes.CDLL(str(tmp / f"{name}.so"))
        f = getattr(so, VARIANT_KERNEL[name[:3]])
        if src == "geodesics.cu":
            f.argtypes = [P_, P_, P_] + [I_] * 4 + [F_, I_] + [F_] * 3 + \
                [P_, P_]
            votes = torch.zeros(values.shape, dtype=torch.int32, device=dev)

            def call(f=f, votes=votes):
                assert f(flow.data_ptr(), values.data_ptr(), tips.data_ptr(),
                         len(tips), nx, ny, nz, STEP, N_STEPS, bx, by, bz,
                         votes.data_ptr(), stream) == 0
                return votes
            call()
            torch.cuda.synchronize()
            assert not exact or torch.equal(votes.cpu(), want["k15"]), name
            out[name + "_step_floor_us"] = step_floor_us(so)
            calls[name] = call
            continue
        for label, args, shape, ref, sizes in probes[name[:3]]:
            f.argtypes = [P_, P_, P_] + [I_] * len(sizes) + [P_]
            o = torch.empty(shape, dtype=torch.int32, device=dev)

            def call(f=f, args=args, o=o, sizes=sizes):
                # the current stream: gp.timed captures the calls in a graph
                assert f(args[0].data_ptr(), args[1].data_ptr(),
                         o.data_ptr(), *sizes,
                         torch.cuda.current_stream().cuda_stream) == 0
                return o
            call()
            torch.cuda.synchronize()
            assert not exact or torch.equal(o.cpu(), ref), (name, label)
            calls[f"{name}_{label}".rstrip("_")] = call
    ms = {k: [] for k in calls}
    for _ in range(2):
        for k, fn in calls.items():
            ms[k].append(cuda_ms(fn, reps=21) if k.startswith("k15")
                         else gp.timed(fn) * 1e3)
    print(json.dumps({"variants_ms": ms, "variants_checks": out,
                      "ptxas": registers, "sass": sass}), flush=True)


def plain_file(with_k15):
    return "plain.pt" if with_k15 else "plain_gather.pt"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--gather-only", action="store_true",
                    help="K17-K19 alone: no scan, no K15")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--plain", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--scene", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tmp", help=argparse.SUPPRESS)
    ap.add_argument("--work", help="keep the inputs in this directory and "
                    "reuse them when it holds them (else a temporary one)")
    a = ap.parse_args()
    with_k15 = not a.gather_only
    sys.path.insert(0, str(ROOT))
    if a.one:
        measure(a.one, a.tmp, with_k15)
        return
    if a.plain:
        plain(a.tmp, with_k15)
        return
    if a.scene:
        scene(a.tmp)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("trace_gather_ab: needs a CUDA device")
    flag = [] if with_k15 else ["--gather-only"]
    with tempfile.TemporaryDirectory() as tmp:
        if a.work:
            tmp = str(Path(a.work).resolve())
            Path(tmp).mkdir(parents=True, exist_ok=True)
        steps = ((("--scene", "k15.pt"),) if with_k15 else ()) + \
            (("--plain", plain_file(with_k15)),)
        for step, made in steps:
            if not (Path(tmp) / made).exists():
                subprocess.run([sys.executable, __file__, step, "--tmp", tmp,
                                *flag], check=True)
        if a.variants:
            variants(Path(tmp), with_k15)
        else:
            for root in a.roots:
                subprocess.run([sys.executable, __file__, "--one", root,
                                "--tmp", tmp, *flag], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
