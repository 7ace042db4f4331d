#!/usr/bin/env python3
"""K21 (the weighted cross-entropy and its gradient) and K22 (clipped
AdamW) of one or more checkouts of the port, timed in turns on one card,
with K20 and K23 at phase 22's shapes and 50 warm training steps; with
--variants, build variants of this checkout's train.cu and time them on
the same inputs.

Each root is measured in its own process (each checkout builds its own
kernels), in the order given, so `--roots parent change change parent`
compares two versions on one card. The inputs, the same for every root
(seeded generators on the card, seeded numpy for the crops):

- K21 at `chip_smoke.py`'s three shapes: phase 22's logits (8, 6, 448,
  448), phase 23's (4, 5, 896, 896) and phase 24's (8, 3, 448, 448) with
  30 % of the labels 255 (ignored); logits 3 x N(0, 1), uniform labels,
  class weights in [0.2, 1.2). Timed: the trainers' call
  (weighted_cross_entropy, then .backward()), the loss alone (ce_forward)
  and the general backward (ce_backward at incoming gradient 1).
- K22 as `models/optim.AdamW.step` over the parameters of the ResUNet at
  phase 22's width (24-192 x 2 blocks, 2.03 M), clipped (train_synth) and
  unclipped (train.py), and of TPUSegNet (128, 256, 256; 7.55 M),
  clipped; gradients 0.01 x N(0, 1) (a global norm above 1).
- K20 on 24 resident 448 crops, a batch of 8; K23 on logits (2, 6, 448,
  448): phase 22's shapes.
- 50 warm `train_on_crops` steps at phase 22's size (ResUNet 24-192,
  crop 448, batch 8) on 24 synthetic crops, after 50 warm-up steps, then
  50 more under torch.profiler (device activity only): seconds a step and
  the device's idle share.

For each call: the median of CUDA-event timings (`chip_smoke.cuda_ms`),
the device time by kernel (`chip_smoke.device_ms_by_kernel`), the launches
a call (`kernels.LAUNCHES`), and for K22 the host microseconds a step (50
steps enqueued, no synchronisation inside). Each root saves its K21
losses and gradients and its K22 arenas after one step from the seeded
state; the first root's are compared with every other's (bit-equal, or
the largest relative difference). Prints one JSON line a root (or one
for the variants), a line of comparisons, then the card's name and
power limit.

    python tools/train_kernels_ab.py --roots .chipwork/parent . . .chipwork/parent
    python tools/train_kernels_ab.py --variants
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "plant3dvision_tpu_torch" / "kernels" / "csrc"

#: K21's cases: name, shape, ignored label, seed
CE_CASES = (("phase22", (8, 6, 448, 448), None, 21),
            ("phase23", (4, 5, 896, 896), None, 23),
            ("phase24", (8, 3, 448, 448), 255, 24))
#: K22's cases: name, model config, clip
ADAM_CASES = (
    ("resunet_clip", {"arch": "resunet", "widths": [24, 48, 96, 192]}, True),
    ("resunet_noclip", {"arch": "resunet", "widths": [24, 48, 96, 192]},
     False),
    ("tpusegnet_clip", {"arch": "tpusegnet", "widths": [128, 256, 256]},
     True))
N_CLS, N_CROPS, CROP, BATCH = 6, 24, 448, 8

#: --variants: name -> edits of train.cu
VARIANTS = {
    "base": [],
    "ce_quads_2": [("constexpr int kCeQuads = 1;",
                    "constexpr int kCeQuads = 2;")],
    "ce_quads_4": [("constexpr int kCeQuads = 1;",
                    "constexpr int kCeQuads = 4;")],
    "ce_min_blocks_6": [("__launch_bounds__(kThreads)\n    ce_fused_kernel(",
                         "__launch_bounds__(kThreads, 6)\n"
                         "    ce_fused_kernel(")],
    "ce_min_blocks_8": [("__launch_bounds__(kThreads)\n    ce_fused_kernel(",
                         "__launch_bounds__(kThreads, 8)\n"
                         "    ce_fused_kernel(")],
    "adam_blocks_1": [("constexpr int kAdamBlocksPerSm = 2;",
                       "constexpr int kAdamBlocksPerSm = 1;")],
    "adam_blocks_4": [("constexpr int kAdamBlocksPerSm = 2;",
                       "constexpr int kAdamBlocksPerSm = 4;")],
}


def ce_inputs(shape, ignore, seed, dev):
    import torch
    B, C, H, W = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = 3 * torch.randn(shape, generator=g, device=dev)
    y = torch.randint(0, C, (B, H, W), generator=g, device=dev,
                      dtype=torch.uint8)
    if ignore is not None:
        y[torch.rand((B, H, W), generator=g, device=dev) < 0.3] = ignore
    w = torch.rand(C, generator=g, device=dev) + 0.2
    return logits, y, w


def synthetic_crops():
    """24 seeded 448 crops: a stem and fruits as rectangles on a dark
    background, labels in train_synth's classes."""
    import numpy as np
    rng = np.random.default_rng(0)
    lab = np.zeros((N_CROPS, CROP, CROP), np.int8)
    for i in range(N_CROPS):
        for cls, (h, w) in ((5, (160, 16)), (2, (40, 60)), (1, (60, 30))):
            r0, c0 = rng.integers(8, CROP - 170, 2)
            lab[i, r0:r0 + h, c0:c0 + w] = cls
    rgb = np.full((N_CROPS, CROP, CROP, 3), 40, np.uint8)
    rgb[lab == 5] = (60, 160, 50)
    rgb[lab == 2] = (190, 170, 60)
    rgb[lab == 1] = (80, 200, 90)
    noise = rng.integers(0, 12, rgb.shape, dtype=np.uint8)
    return rgb + noise, lab


def timed_call(fn, names, cuda_ms, device_ms_by_kernel):
    """ms, device ms by kernel and launches a call of fn()."""
    from plant3dvision_tpu_torch import kernels
    before = {k: kernels.LAUNCHES[k] for k in names}
    fn()
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in names}
    return {"ms": cuda_ms(fn, reps=21),
            "device_ms_by_kernel": device_ms_by_kernel(fn, reps=20),
            "launches_a_call": launches}


def measure(root, tmp, index):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from plant3dvision_tpu_torch import kernels
    assert Path(kernels.__file__).resolve().is_relative_to(root)
    sys.path.append(str(ROOT))                      # the timing helpers
    from chip_smoke import bound_ms, cuda_ms, device_ms_by_kernel
    from plant3dvision_tpu_torch.models import train_synth as S
    from plant3dvision_tpu_torch.models.checkpoint import model_from_config
    from plant3dvision_tpu_torch.models.optim import AdamW
    from plant3dvision_tpu_torch.ops import training as T

    dev = torch.device("cuda")
    out = {"root": str(root)}
    kernels.lib()
    out["build_s"] = kernels.last_build_seconds
    saved = {}
    ce_names = ("weighted_ce", "weighted_ce_backward")

    def timed(fn, names):
        return timed_call(fn, names, cuda_ms, device_ms_by_kernel)

    for name, shape, ignore, seed in CE_CASES:
        logits, y, w = ce_inputs(shape, ignore, seed, dev)
        ig = -1 if ignore is None else ignore
        lt = logits.clone().requires_grad_()

        def call():
            lt.grad = None
            loss = T.weighted_cross_entropy(lt, y, w, ignore)
            loss.backward()
            return loss
        loss = call()
        saved[f"{name}_loss"] = loss.detach().cpu()
        saved[f"{name}_grad"] = lt.grad.cpu()
        out_fwd = T.ce_forward(logits, y, w, ig)
        g1 = torch.ones(1, device=dev)
        npx, C = y.numel(), shape[1]
        row = {"shape": list(shape), "ignore_index": ignore,
               "loss": float(loss),
               "trainers_call": timed(call, ce_names),
               "loss_alone": timed(lambda: T.ce_forward(logits, y, w, ig),
                                   ce_names),
               "general_backward": timed(lambda: T.ce_backward(
                   logits, y, w, out_fwd, g1, ig), ce_names)}
        row["bound_ms_pair"] = bound_ms(npx * (8 * C + 1) + 4 * C,
                                        npx * (6 * C + 8))
        row["bound_ms_loss_alone"] = bound_ms(npx * (4 * C + 1) + 4 * C,
                                              npx * (4 * C + 6))
        out[f"k21_{name}"] = row
        del lt, loss, logits, out_fwd
        torch.cuda.empty_cache()

    for name, cfg, clip in ADAM_CASES:
        torch.manual_seed(0)
        model = model_from_config({**cfg, "blocks_per_stage": 2,
                                   "label_names": [str(i) for i in
                                                   range(N_CLS)]})
        opt = AdamW(model.to(dev), 3e-3, clip=1.0 if clip else None)
        g = torch.Generator(device=dev).manual_seed(11)
        opt.grad.copy_(0.01 * torch.randn(opt.grad.numel(), generator=g,
                                          device=dev))
        opt.mu.copy_(1e-3 * torch.randn(opt.mu.numel(), generator=g,
                                        device=dev))
        opt.nu.copy_(1e-6 * torch.rand(opt.nu.numel(), generator=g,
                                       device=dev))
        opt.step()
        saved[name] = torch.stack([opt.arena, opt.mu, opt.nu]).cpu()
        n = opt.arena.numel()
        row = {"parameters": n, "clip": clip,
               "step": timed(opt.step, ("adamw",)),
               "bound_ms": bound_ms(28 * n, 22 * n)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            opt.step()
        row["host_us_a_step"] = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        out[f"k22_{name}"] = row
        del model, opt
        torch.cuda.empty_cache()

    # K20 and K23 at phase 22's shapes
    g = torch.Generator(device=dev).manual_seed(20)
    rgb = torch.randint(0, 256, (N_CROPS, CROP, CROP, 3), generator=g,
                        device=dev, dtype=torch.uint8)
    lab = torch.randint(0, N_CLS, (N_CROPS, CROP, CROP), generator=g,
                        device=dev, dtype=torch.uint8)
    idx, flip, gains = S._draw_batch(g, N_CROPS, BATCH)
    flip.fill_(1)
    px = BATCH * CROP * CROP
    out["k20"] = {**timed(lambda: T.gather_batch(rgb, lab, idx, flip, gains),
                          ("batch_gather",)),
                  "bound_ms": bound_ms(px * 4 + px * 12 + px + BATCH * 20,
                                       px * 12)}
    vlog = torch.randn((2, N_CLS, CROP, CROP), generator=g, device=dev)
    vlab = torch.randint(0, N_CLS, (2, CROP, CROP), generator=g, device=dev,
                         dtype=torch.uint8)
    nv = vlab.numel()
    out["k23"] = {**timed(lambda: T.iou_counts(vlab, N_CLS, logits=vlog),
                          ("iou_counts",)),
                  "bound_ms": bound_ms(nv * N_CLS * 4 + nv + 3 * N_CLS * 8,
                                       nv * (N_CLS + 4))}
    del rgb, lab, vlog, vlab
    torch.cuda.empty_cache()
    out["train_steps"] = warm_steps(S)
    torch.save(saved, Path(tmp) / f"saved_{index}.pt")
    print(json.dumps(out), flush=True)


def warm_steps(S):
    """50 warm train_on_crops steps (draws 50-99) timed, and 50 (draws
    100-149) under torch.profiler: s a step, the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import _idle_share
    rgb, lab = synthetic_crops()
    orig = S._draw_batch
    count, marks, box = [0], [], []

    def draw(gen, n, batch_size):
        i = count[0]
        count[0] += 1
        if i in (50, 100, 150):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if i == 100:
                box.append(profile(activities=[ProfilerActivity.CUDA]))
                box[0].__enter__()
            elif i == 150:
                box[0].__exit__(None, None, None)
        return orig(gen, n, batch_size)
    S._draw_batch = draw
    try:
        S.train_on_crops(rgb, lab, steps=175, device="cuda")
    finally:
        S._draw_batch = orig
    step_s = (marks[1] - marks[0]) / 50
    busy, idle, top = _idle_share(box[0], marks[2] - marks[1])
    return {"s_a_warm_step": step_s, "profiled_s_a_step":
            (marks[2] - marks[1]) / 50, "device_busy_s_50_steps": busy,
            "idle_share_profiled": idle,
            "idle_share_at_warm_step": 1.0 - busy / (50 * step_s),
            "top_device": top}


def compare(tmp, n_roots):
    """Each root's saved results against the first root's."""
    import torch
    first = torch.load(Path(tmp) / "saved_0.pt")
    out = {}
    for i in range(1, n_roots):
        other = torch.load(Path(tmp) / f"saved_{i}.pt")
        for k, a in first.items():
            b = other[k]
            d = float((a - b).abs().max())
            out[f"root{i}_{k}"] = "equal" if torch.equal(a, b) else {
                "max_abs_diff": d,
                "relative": d / max(float(a.abs().max()), 1e-30)}
    print(json.dumps({"against_first_root": out}), flush=True)


def variants(tmp):
    """Build VARIANTS of this checkout's train.cu, and time each one's K21
    pass (with its gradient; phases 22 and 24's shapes) and K22 (clipped,
    2.03 M and 7.55 M elements), twice in turns, then once as device time
    by kernel; gradients and arenas held equal to the base build's, losses
    beside its."""
    import torch
    from plant3dvision_tpu_torch import kernels
    from chip_smoke import cuda_ms, device_ms_by_kernel
    procs = {}
    for name, edits in VARIANTS.items():
        text = (CSRC / "train.cu").read_text()
        for old, new in edits:
            assert old in text, f"{name}: {old!r} not in train.cu"
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-o", str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ptxas = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, (name, log)
        lines = log.splitlines()
        ptxas[name] = [
            lines[i].split("for ")[-1][-48:] + ": " + lines[i + 2].split(
                ": ")[-1] + "; " + lines[i + 1].strip()
            for i in range(len(lines) - 2)
            if "Function properties" in lines[i]
            and ("ce_fused_kernelILi6ELb1ELb1" in lines[i]
                 or "adamw_kernelILb1" in lines[i])]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ce = [(name, *ce_inputs(shape, ig, seed, dev), ig)
          for name, shape, ig, seed in CE_CASES if name != "phase23"]
    g = torch.Generator(device=dev).manual_seed(11)
    arenas = {n: [torch.randn(n, generator=g, device=dev),
                  0.01 * torch.randn(n, generator=g, device=dev),
                  1e-3 * torch.randn(n, generator=g, device=dev),
                  1e-6 * torch.rand(n, generator=g, device=dev)]
              for n in (2_030_000, 7_550_000)}
    # b1, b2, 1 - b1, 1 - b2, bc1, bc2, eps, eps_root, wd, -lr, max_norm
    scal = [0.9, 0.999, 0.1, 1e-3, 0.1, 1e-3, 1e-8, 0.0, 1e-4, -3e-3, 1.0]
    calls, results = {}, {}
    for name in VARIANTS:
        so = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn in ("p3d_ce_blocks", "p3d_ce", "p3d_adamw_partials",
                   "p3d_adamw"):
            getattr(so, fn).argtypes = kernels._ARGTYPES[fn]
            getattr(so, fn).restype = ctypes.c_int
        for cname, logits, y, w, ig in ce:
            B, C, H, W = logits.shape
            n = y.numel()
            part = torch.empty(so.p3d_ce_blocks(n), device=dev)
            ctl = torch.zeros(2, dtype=torch.int64, device=dev)
            o = torch.empty(2, device=dev)
            d = torch.empty_like(logits)

            def call(so=so, logits=logits, y=y, w=w, ig=ig, part=part,
                     ctl=ctl, o=o, d=d, C=C, H=H, W=W, n=n):
                assert so.p3d_ce(logits.data_ptr(), y.data_ptr(),
                                 w.data_ptr(), C, H * W, n,
                                 -1 if ig is None else ig, ctl.data_ptr(),
                                 part.data_ptr(), o.data_ptr(), d.data_ptr(),
                                 stream) == 0
            call()
            torch.cuda.synchronize()
            results[(name, cname)] = (o.clone(), d.clone())
            calls[f"{name}_k21_{cname}"] = call
        for n, src in arenas.items():
            a = [t.clone() for t in src]
            part = torch.empty(so.p3d_adamw_partials(n), device=dev)

            def call(so=so, a=a, part=part, n=n):
                assert so.p3d_adamw(*(t.data_ptr() for t in a), n,
                                    part.data_ptr(), 1, *scal, stream) == 0
            b = [t.clone() for t in src]
            assert so.p3d_adamw(*(t.data_ptr() for t in b), n,
                                part.data_ptr(), 1, *scal, stream) == 0
            torch.cuda.synchronize()
            results[(name, n)] = torch.stack(b)
            calls[f"{name}_k22_{n}"] = call
    checks = {}
    for (name, key), r in results.items():
        base = results[("base", key)]
        if isinstance(r, tuple):
            checks[f"{name}_k21_{key}"] = {
                "gradient_equal": torch.equal(r[1], base[1]),
                "loss_rel_diff": float((r[0][0] - base[0][0]).abs()
                                       / base[0][0].abs()),
                "denominator_equal": bool(r[0][1] == base[0][1])}
        else:
            checks[f"{name}_k22_{key}"] = {"equal": torch.equal(r, base)}
    ms = {k: [] for k in calls}
    for _ in range(2):
        for k, fn in calls.items():
            ms[k].append(cuda_ms(fn, reps=21))
    device = {k: device_ms_by_kernel(fn, reps=20) for k, fn in calls.items()}
    print(json.dumps({"variants_ms": ms, "variants_device_ms": device,
                      "variants_checks": checks, "ptxas": ptxas}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--index", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--tmp", help=argparse.SUPPRESS)
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if a.one:
        measure(a.one, a.tmp, a.index)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_kernels_ab: needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        if a.variants:
            variants(Path(tmp))
        else:
            for i, root in enumerate(a.roots):
                subprocess.run([sys.executable, __file__, "--one", root,
                                "--index", str(i), "--tmp", tmp], check=True)
            compare(tmp, len(a.roots))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
