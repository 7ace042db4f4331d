#!/usr/bin/env python3
"""K21 (the weighted cross-entropy and its gradient), K22 (clipped
AdamW, and its tp lane) and K23 (IoU counts) of one or more checkouts of
the port, timed in turns on one card, with K20 at phase 22's shape and 50
warm training steps; with --variants, build variants of this checkout's
train.cu and time them on the same inputs.

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
- K22's tp lane on a dp 2 x tp 4 rank's arena of that ResUNet (516,096
  elements, TP_N: its 6030 replicated parameters and 506,862 of the split
  ones, each region padded with zeros to a 4096 chunk) with the tp
  group's 498 gathered chunk sums (TP_SUMS):
  its two launches (`adamw_tp`), the gather not timed; cold (copies of
  the arena in turn, `chip_smoke.cold_turns`: p, g, mu and nu in HBM, as
  a training step finds p, mu and nu) and warm (one arena, in the L2);
  its bound counts g read once, 28 bytes a parameter, and the sums.
- K20 on 24 resident 448 crops, a batch of 8; K23 on logits (2, 6, 448,
  448): phase 22's shapes; K23 on phase 24's: the uint8 predictions of a
  1080x1440 view, 3 classes, ignore 255 (a seeded plant-like label map:
  background, a stem and fruits, an ignored band around them, the
  predictions off by 3 %).
- 50 warm `train_on_crops` steps at phase 22's size (ResUNet 24-192,
  crop 448, batch 8) on 24 synthetic crops, after 50 warm-up steps, then
  50 more under torch.profiler (device activity only): seconds a step and
  the device's idle share.

For each call: the median of CUDA-event timings (`chip_smoke.cuda_ms`),
the device time a launch by kernel (`chip_smoke.device_ms_by_kernel`,
with the launches it recorded: the parent's tp lane launches one kernel
twice a call), the launches
a call (`kernels.LAUNCHES`), and for K22 the host microseconds a step (50
steps enqueued, no synchronisation inside). Each root saves its K21
losses and gradients and its K22 arenas after one step from the seeded
state; the first root's are compared with every other's (bit-equal, or
the largest relative difference). Prints one JSON line a root (or one
for the variants), a line of comparisons, then the card's name and
power limit.

    python tools/train_kernels_ab.py --roots .chipwork/parent . . .chipwork/parent
    python tools/train_kernels_ab.py --variants [NAME ...]
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
#: K22's tp lane: a dp 2 x tp 4 rank's arena of the ResUNet (24-192 x 2
#: blocks): its replicated parameters and its slices of the split ones,
#: each region padded with zeros to K22's chunk (phase 25's `rank_arena`),
#: and the gathered chunk sums of its tp group
TP_REP, TP_MINE, TP_N, TP_SUMS = 6030, 506_862, 516_096, 498
#: K23 at phase 24's shape: one view's predictions, distill's classes
VIEW_H, VIEW_W, VIEW_CLS, IGNORE = 1080, 1440, 3, 255

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
    "tp_sum_warps_2": [("constexpr int kSumWarps = 1;",
                        "constexpr int kSumWarps = 2;")],
    "tp_sum_warps_4": [("constexpr int kSumWarps = 1;",
                        "constexpr int kSumWarps = 4;")],
    "tp_upd_quads_1": [("constexpr int kUpdQuads = 2;",
                        "constexpr int kUpdQuads = 1;")],
    "tp_upd_quads_4": [("constexpr int kUpdQuads = 2;",
                        "constexpr int kUpdQuads = 4;")],
    "iou_threads_256": [("LOGITS ? 128 : 256", "LOGITS ? 256 : 256")],
    "iou_threads_128": [("LOGITS ? 128 : 256", "LOGITS ? 128 : 128")],
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


def view_labels(dev):
    """A seeded 1080x1440 label map of distill's classes (0 background, 1
    stem, 2 fruit) with an ignored band around the plant, and predictions
    equal to it but for 3 % of the pixels (uint8, on `dev`)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(24)
    lab = np.zeros((VIEW_H, VIEW_W), np.uint8)
    lab[200:1000, 700:740] = 1
    for r, c in rng.integers([250, 500], [950, 900], (12, 2)):
        lab[r:r + 60, c:c + 40] = 2
    near = np.zeros_like(lab, bool)
    near[180:1020, 480:960] = True
    lab[near & (lab == 0) & (rng.random(lab.shape) < 0.5)] = IGNORE
    pred = np.where(lab == IGNORE, 0, lab).astype(np.uint8)
    flip = rng.random(lab.shape) < 0.03
    pred[flip] = rng.integers(0, VIEW_CLS, int(flip.sum()))
    return (torch.from_numpy(lab[None]).to(dev),
            torch.from_numpy(pred[None]).to(dev))


def tp_arenas(dev):
    """K22's tp lane inputs: p, g, mu, nu of TP_N elements, 0 in the
    regions' padding, and TP_SUMS gathered chunk sums (this rank's first,
    the rest another rank's)."""
    import torch
    from plant3dvision_tpu_torch.ops import training as T
    g = torch.Generator(device=dev).manual_seed(12)
    a = [torch.randn(TP_N, generator=g, device=dev),
         0.01 * torch.randn(TP_N, generator=g, device=dev),
         1e-3 * torch.randn(TP_N, generator=g, device=dev),
         1e-6 * torch.rand(TP_N, generator=g, device=dev)]
    rep = -(-TP_REP // T.ADAMW_CHUNK) * T.ADAMW_CHUNK
    assert rep + -(-TP_MINE // T.ADAMW_CHUNK) * T.ADAMW_CHUNK == TP_N
    for t in a:
        t[TP_REP:rep] = 0.0
        t[rep + TP_MINE:] = 0.0
    own = T.adamw_partials_plain(a[1])
    other = T.adamw_partials_plain(0.01 * torch.randn(
        (TP_SUMS - own.numel()) * T.ADAMW_CHUNK, generator=g, device=dev))
    return a, torch.cat([own, other])


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
    """ms, device ms a launch by kernel (and the launches the profiler
    recorded of each in 20 calls) and launches a call of fn()."""
    from plant3dvision_tpu_torch import kernels
    before = {k: kernels.LAUNCHES[k] for k in names}
    fn()
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in names}
    recorded = {}
    return {"ms": cuda_ms(fn, reps=21),
            "device_ms_by_kernel": device_ms_by_kernel(fn, reps=20,
                                                       recorded=recorded),
            "launches_recorded_in_20_calls": recorded,
            "launches_a_call": launches}


def measure(root, tmp, index):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from plant3dvision_tpu_torch import kernels
    assert Path(kernels.__file__).resolve().is_relative_to(root)
    sys.path.append(str(ROOT))                      # the timing helpers
    from chip_smoke import bound_ms, cold_turns, cuda_ms, device_ms_by_kernel
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

    # K22's tp lane on a rank's arena with its group's gathered sums: cold
    # (copies of the arena in turn, in HBM as a training step finds p, mu
    # and nu) and warm (one arena, which the L2 holds)
    arenas, gathered = tp_arenas(dev)
    sc = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, wd=1e-4,
              max_norm=1.0)
    per_step = dict(bc1=0.1, bc2=1e-3, neg_lr=-3e-3)

    def make_step():
        a = [t.clone() for t in arenas]
        step = T.adamw_launcher(*a, clip=True, tp_sums=lambda part: gathered,
                                **sc)
        return lambda: step(**per_step)
    one = [t.clone() for t in arenas]
    T.adamw_launcher(*one, clip=True, tp_sums=lambda part: gathered,
                     **sc)(**per_step)
    saved["k22_tp_lane"] = torch.stack(one).cpu()
    out["k22_tp_lane"] = {
        "arena": TP_N, "gathered_sums": TP_SUMS,
        "step": timed(cold_turns(make_step, 16 * TP_N), ("adamw_tp",)),
        "step_warm": timed(make_step(), ("adamw_tp",)),
        "bound_ms": bound_ms(TP_N * 28 + (TP_N // T.ADAMW_CHUNK + TP_SUMS)
                             * 4, TP_N * 24)}
    del arenas, one
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
    vlab, vpred = view_labels(dev)
    saved["k23_view"] = T.iou_counts(vlab, VIEW_CLS, preds=vpred,
                                     ignore_index=IGNORE).cpu()
    nv = vlab.numel()
    out["k23_view"] = {**timed(lambda: T.iou_counts(
        vlab, VIEW_CLS, preds=vpred, ignore_index=IGNORE), ("iou_counts",)),
        "ignored_px": int((vlab == IGNORE).sum()),
        "bound_ms": bound_ms(2 * nv + 3 * VIEW_CLS * 8, 4 * nv)}
    del rgb, lab, vlog, vlab, vpred
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


def variants(tmp, names):
    """Build `names` of VARIANTS (all by default; "base" always) of this
    checkout's train.cu, and time each one's K21 pass (with its gradient;
    phases 22 and 24's shapes), K22 (clipped, 2.03 M and 7.55 M elements),
    K22's tp lane (TP_N) and K23 (phase 22's logits, phase 24's
    predictions), twice in turns, then once as device time by kernel;
    gradients, arenas and counts held equal to the base build's, losses
    beside its."""
    import torch
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import training as T
    from chip_smoke import cuda_ms, device_ms_by_kernel
    chosen = {k: v for k, v in VARIANTS.items()
              if k == "base" or not names or k in names}
    procs = {}
    for name, edits in chosen.items():
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
                 or "adamw_kernelILb1" in lines[i]
                 or "adamw_chunk_sums_kernelILb1" in lines[i]
                 or "adamw_tp_update_kernelILb1" in lines[i]
                 or "iou_counts_kernelILi6ELb1ELb1" in lines[i]
                 or "iou_counts_kernelILi3ELb0ELb1" in lines[i])]
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
    tp_src, gathered = tp_arenas(dev)
    vlog = torch.randn((2, N_CLS, CROP, CROP), generator=g, device=dev)
    vl6 = torch.randint(0, N_CLS, (2, CROP, CROP), generator=g, device=dev,
                        dtype=torch.uint8)
    vlab, vpred = view_labels(dev)
    iou_cases = {"logits": (vlog, None, vl6, N_CLS, CROP * CROP, -1),
                 "view": (None, vpred, vlab, VIEW_CLS, VIEW_H * VIEW_W,
                          IGNORE)}
    calls, results = {}, {}
    for name in chosen:
        so = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn in ("p3d_ce_blocks", "p3d_ce", "p3d_adamw_partials",
                   "p3d_adamw", "p3d_adamw_tp_partials",
                   "p3d_adamw_tp_update", "p3d_iou_counts"):
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
        a = [t.clone() for t in tp_src]
        part = torch.empty(so.p3d_adamw_partials(TP_N), device=dev)

        def tp_call(so=so, a=a, part=part):
            assert so.p3d_adamw_tp_partials(a[1].data_ptr(), TP_N,
                                            part.data_ptr(), stream) == 0
            assert so.p3d_adamw_tp_update(
                *(t.data_ptr() for t in a), TP_N, gathered.data_ptr(),
                TP_SUMS, *scal, stream) == 0
        b = [t.clone() for t in tp_src]
        tp_call(a=b)
        torch.cuda.synchronize()
        results[(name, "tp")] = torch.stack(b)
        calls[f"{name}_k22_tp_{TP_N}"] = tp_call
        for cname, (lg, pr, lb, C, HW, ig) in iou_cases.items():
            cnt = torch.empty((3, C), dtype=torch.int64, device=dev)

            def iou_call(so=so, lg=lg, pr=pr, lb=lb, C=C, HW=HW, ig=ig,
                         cnt=cnt):
                assert so.p3d_iou_counts(
                    None if lg is None else lg.data_ptr(),
                    None if pr is None else pr.data_ptr(), lb.data_ptr(), C,
                    HW, lb.numel(), ig, cnt.data_ptr(), stream) == 0
                return cnt
            got = iou_call().clone()
            torch.cuda.synchronize()
            results[(name, f"iou_{cname}")] = got
            calls[f"{name}_k23_{cname}"] = iou_call
    want = {"iou_logits": T.iou_counts_plain(vl6, N_CLS, logits=vlog),
            "iou_view": T.iou_counts_plain(vlab, VIEW_CLS, preds=vpred,
                                           ignore=IGNORE)}
    checks = {f"{name}_{key}_equals_plain": torch.equal(results[(name, key)],
                                                         w)
              for name in chosen for key, w in want.items()}
    for (name, key), r in results.items():
        base = results[("base", key)]
        if isinstance(r, tuple):
            checks[f"{name}_k21_{key}"] = {
                "gradient_equal": torch.equal(r[1], base[1]),
                "loss_rel_diff": float((r[0][0] - base[0][0]).abs()
                                       / base[0][0].abs()),
                "denominator_equal": bool(r[0][1] == base[0][1])}
        else:
            label = key if isinstance(key, str) else f"k22_{key}"
            checks[f"{name}_{label}"] = {"equal": torch.equal(r, base)}
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
    ap.add_argument("--variants", nargs="*", default=None,
                    help="variants of VARIANTS to build (all when none "
                    "is named)")
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
        if a.variants is not None:
            variants(Path(tmp), a.variants)
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
