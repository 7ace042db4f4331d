#!/usr/bin/env python3
"""K15 (geodesic tracing) and K17 (the axis-1 gather probe) of one or more
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
  table, (8, 8192) indices, 64 reps), drawn by `gather_probe.axis1_inputs`
  from numpy seeded as phase 17 seeds it.

The plain versions run once, in a process of their own (this checkout's;
unchanged from the parent), K15's with each particle's steps. Each root
holds its kernels equal to them and times each call:
K15 with CUDA events (median, the vote grid's zeroing included) and as
device time by kernel (torch.profiler, `chip_smoke.device_ms_by_kernel`);
K17 as `gather_probe.timed`'s
graph-replayed calls, and at reps = 0 (the floor). Prints one JSON line a
root (or one for the variants), then the card's name and power limit.

    python tools/trace_gather_ab.py --roots .chipwork/parent . . .chipwork/parent
    python tools/trace_gather_ab.py --variants
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

#: phase 17's three K17 sizes, the seeds phase 17 gives them, N and reps
K17_SIZES = ((0, 8 * 1024), (1, 32 * 1024), (2, 128 * 1024))
K17_N, K17_REPS = 8 * 1024, 64
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
}


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


def plain(tmp):
    """The plain versions' results (K15's with each particle's steps),
    saved to tmp/plain.pt."""
    import torch
    from plant3dvision_tpu_torch.ops import geodesics
    from plant3dvision_tpu_torch.tools import gather_probe as gp
    dev = torch.device("cuda")
    flow, values, tips = k15_inputs(tmp, dev)
    votes, steps = geodesics.trace_geodesics_plain(
        flow, values, tips, STEP, N_STEPS, return_steps=True)
    out = {"k15": votes.cpu(), "k15_steps": steps.cpu()}
    for seed, L in K17_SIZES:
        out[f"k17_{L}"] = gp.axis1_gather_plain(
            *k17_inputs(seed, L, dev), K17_REPS).cpu()
    torch.save(out, Path(tmp) / "plain.pt")


def k15_bound(values, tips, steps):
    """chip_smoke phase 14's K15 bound: the tips, the dense votes, 8
    corners of flow and values (128 B) and ~130 operations a step."""
    from chip_smoke import bound_ms
    return bound_ms(tips.numel() * 4 + 4 * values.numel() + 128 * steps,
                    130 * steps)


def measure(root, tmp):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import geodesics
    from plant3dvision_tpu_torch.tools import gather_probe as gp
    assert Path(kernels.__file__).resolve().is_relative_to(root)
    sys.path.append(str(ROOT))                      # the timing helpers
    from chip_smoke import bound_ms, cuda_ms, device_ms_by_kernel

    dev = torch.device("cuda")
    out = {"root": str(root)}
    kernels.lib()
    out["build_s"] = kernels.last_build_seconds
    want = torch.load(Path(tmp) / "plain.pt")
    flow, values, tips = k15_inputs(tmp, dev)

    def k15():
        return geodesics.trace_geodesics(flow, values, tips, STEP, N_STEPS)

    before = kernels.LAUNCHES["trace_geodesics"]
    got = k15()
    launches = kernels.LAUNCHES["trace_geodesics"] - before
    assert torch.equal(got.cpu(), want["k15"]), "trace kernel != plain"
    del got
    steps = want["k15_steps"]
    b, by = k15_bound(values, tips, int(steps.sum()))
    out["k15"] = {"grid": list(values.shape), "particles": len(tips),
                  "steps": int(steps.sum()), "longest_steps":
                  int(steps.max()), "votes_equal": True,
                  "launches_per_call": launches, "ms": cuda_ms(k15, reps=21),
                  "device_ms_by_kernel": device_ms_by_kernel(k15, reps=20),
                  "bound_ms": b, "bound_by": by}
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
    print(json.dumps(out), flush=True)


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


def variants(tmp):
    """Build VARIANTS (edits of this checkout's sources), hold those that
    compute the function equal to the plain results, time each K15's
    dependent step on chip (`p3d_trace_step_floor`), and time each twice,
    in turns."""
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops.geodesics import upper_bounds
    from plant3dvision_tpu_torch.tools import gather_probe as gp
    from chip_smoke import cuda_ms
    procs = {}
    for name, (src, edits, _) in VARIANTS.items():
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
    registers = {}
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
            and ("trace_kernel" in lines[i] or "axis1" in lines[i])]
    dev = torch.device("cuda")
    want = torch.load(tmp / "plain.pt")
    flow, values, tips = k15_inputs(tmp, dev)
    nx, ny, nz = values.shape
    bx, by, bz = (float(v) for v in upper_bounds(values.shape))
    k17 = {L: k17_inputs(seed, L, dev) for seed, L in K17_SIZES}
    stream = torch.cuda.current_stream().cuda_stream
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    calls, out = {}, {}
    for name, (src, _, exact) in VARIANTS.items():
        so = ctypes.CDLL(str(tmp / f"{name}.so"))
        if src == "geodesics.cu":
            f = so.p3d_trace_geodesics
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
        f = so.p3d_gather_axis1
        f.argtypes = [P_, P_, P_] + [I_] * 4 + [P_]
        for L, (tab, idx) in k17.items():
            o = torch.empty_like(idx)

            def call(f=f, tab=tab, idx=idx, o=o, L=L):
                # the current stream: gp.timed captures the calls in a graph
                assert f(tab.data_ptr(), idx.data_ptr(), o.data_ptr(),
                         tab.shape[0], L, K17_N, K17_REPS,
                         torch.cuda.current_stream().cuda_stream) == 0
                return o
            call()
            torch.cuda.synchronize()
            assert not exact or torch.equal(o.cpu(), want[f"k17_{L}"]), \
                (name, L)
            calls[f"{name}_L{L}"] = call
    ms = {k: [] for k in calls}
    for _ in range(2):
        for k, fn in calls.items():
            ms[k].append(cuda_ms(fn, reps=21) if k.startswith("k15")
                         else gp.timed(fn) * 1e3)
    print(json.dumps({"variants_ms": ms, "variants_checks": out,
                      "ptxas": registers}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--plain", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--scene", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tmp", help=argparse.SUPPRESS)
    ap.add_argument("--work", help="keep the inputs in this directory and "
                    "reuse them when it holds them (else a temporary one)")
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if a.one:
        measure(a.one, a.tmp)
        return
    if a.plain:
        plain(a.tmp)
        return
    if a.scene:
        scene(a.tmp)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("trace_gather_ab: needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        if a.work:
            tmp = str(Path(a.work).resolve())
            Path(tmp).mkdir(parents=True, exist_ok=True)
        for step, made in (("--scene", "k15.pt"), ("--plain", "plain.pt")):
            if not (Path(tmp) / made).exists():
                subprocess.run([sys.executable, __file__, step, "--tmp", tmp],
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
