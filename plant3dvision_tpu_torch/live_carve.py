"""Live carving during acquisition (port of bin/live_carve):

    python -m plant3dvision_tpu_torch.live_carve <db/scan> \\
        --bbox "x0,x1,y0,y1,z0,z1" --voxel-size 0.5 \\
        [--camera-metadata camera] [--filter excess_green] [--coefs 0,1,0] \\
        [--threshold 0.3] [--dilation 0] [--invert] [--every 10] \\
        [--poll 1.0] [--idle-stop 30] [--out live_volume.npz] \\
        [--device cuda] [--report run.json]

Watches a scan directory while the Plant Imager is still writing images,
adds each view to a `StreamingCarver` the moment it and its camera metadata
appear, writes a refreshed volume preview every ``--every`` views and a
final volume once no new image has appeared for ``--idle-stop`` seconds:
`volume` (int32 0/1, the alive voxels) in the NPZ, and {voxel_size,
origin, n_views, state} in the JSON beside it. The final volume is the
batch carve of the same masks, bit for bit.

The same arguments and outputs as the JAX tool, plus `--device` (the card
by default; "cpu" runs the plain versions) and `--report` (a JSON of the
run: each preview's seconds, the ingest time and rate, the kernels'
launches, and on the card the device's busy and idle time, from
torch.profiler). Masks come from `ops/masks.py:mask_filter` on the
device (K10, and `binary_dilation`, K8, when --dilation > 0), kept bool;
images are read as cv2.imread's three colour channels would give them:
PNG by the port's own codec, JPEG by cv2 (which must import).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np


def read_rgb(path: Path) -> np.ndarray:
    """An 8-bit image file as (H, W, 3) uint8 RGB: gray replicated, alpha
    dropped (cv2.imread's IMREAD_COLOR, without cv2 for PNG)."""
    if path.suffix.lower() == ".png":
        from .fsdb.io import png_decode
        img = png_decode(path.read_bytes())
    else:
        import cv2
        img = cv2.imread(str(path))
        if img is None:
            raise ValueError(f"cannot read {path}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[-1] == 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m plant3dvision_tpu_torch.live_carve",
        description="Carve a scan live while it is being acquired")
    ap.add_argument("dataset", help="<db>/<scan> directory being acquired")
    ap.add_argument("--bbox", required=True,
                    help="x0,x1,y0,y1,z0,z1 workspace (scan units)")
    ap.add_argument("--voxel-size", type=float, default=1.0)
    ap.add_argument("--camera-metadata", default="camera",
                    help="per-image metadata key holding camera_model/"
                         "rotmat/tvec (default: camera)")
    ap.add_argument("--filter", default="excess_green",
                    choices=["excess_green", "linear"])
    ap.add_argument("--coefs", default="0,1,0",
                    help="linear-filter coefficients")
    ap.add_argument("--threshold", type=float, default=0.3)
    ap.add_argument("--dilation", type=int, default=0)
    ap.add_argument("--invert", action="store_true")
    ap.add_argument("--every", type=int, default=10,
                    help="write a preview every N new views (0: final only)")
    ap.add_argument("--poll", type=float, default=1.0,
                    help="directory poll interval, seconds")
    ap.add_argument("--idle-stop", type=float, default=30.0,
                    help="stop after this many seconds with no new image")
    ap.add_argument("--out", default="live_volume.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions)")
    ap.add_argument("--report", default="",
                    help="write the run's numbers to this JSON file")
    return ap


def _device_profile(on):
    """torch.profiler over the run when a report on the card is asked for."""
    if not on:
        return contextlib.nullcontext(None)
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _device_busy_s(prof):
    """Seconds of device time of the profiled kernels and copies (one
    stream: nothing overlaps)."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e6


def main(argv=None):
    args = _parser().parse_args(argv)

    import torch

    from . import kernels
    from .ops.masks import binary_dilation, mask_filter
    from .ops.streaming import StreamingCarver

    device = torch.device(args.device)
    scan_dir = Path(args.dataset)
    img_dir = scan_dir / "images"
    md_dir = scan_dir / "metadata" / "images"
    b = [float(v) for v in args.bbox.split(",")]
    origin = np.array([b[0], b[2], b[4]], np.float32)
    vs = args.voxel_size
    shape = tuple(int((b[2 * i + 1] - b[2 * i]) / vs) + 1 for i in range(3))
    coefs = tuple(float(c) for c in args.coefs.split(","))
    if device.type == "cuda":
        # the card's context and the kernel library up before watching, so
        # the first image does not wait for them
        torch.zeros(1, device=device)
        kernels.lib()
    kernels.reset_launches()
    profiled = bool(args.report) and device.type == "cuda"
    sc = None
    seen = set()
    since_preview = 0
    previews = []
    view_s = 0.0
    first_view = last_view = None

    def _write(tag):
        t0 = time.monotonic()
        alive = sc.preview().cpu().numpy()
        np.savez_compressed(args.out, volume=alive.astype(np.int32))
        meta = {"voxel_size": vs, "origin": origin.tolist(),
                "n_views": sc.n_views, "state": tag}
        Path(args.out).with_suffix(".json").write_text(json.dumps(meta))
        dt = time.monotonic() - t0
        previews.append({"state": tag, "n_views": sc.n_views, "s": dt})
        print(f"live_carve: {tag} volume at {sc.n_views} views -> "
              f"{args.out} ({alive.sum()} voxels, {dt:.2f}s)", flush=True)

    with _device_profile(profiled) as prof:
        # watching from here (the profiler, when on, takes seconds to start)
        print(f"live_carve: grid {shape} at {vs}, watching {img_dir}",
              flush=True)
        t_start = time.perf_counter()
        last_new = time.monotonic()
        while True:
            new = 0
            for img in sorted(img_dir.glob("*")) if img_dir.is_dir() else []:
                if img.name in seen or img.suffix.lower() not in (
                        ".png", ".jpg", ".jpeg"):
                    continue
                md_file = md_dir / (img.stem + ".json")
                if not md_file.exists():
                    continue  # metadata not written yet — next poll
                md = json.loads(md_file.read_text())
                cam = md.get(args.camera_metadata)
                if cam is None or (md.get("channel", "rgb") != "rgb"):
                    seen.add(img.name)
                    continue
                t0 = time.perf_counter()
                rgb = torch.from_numpy(read_rgb(img)).to(device)
                mask = binary_dilation(mask_filter(
                    rgb[None], args.filter, coefs, args.threshold, True),
                    args.dilation)[0]
                if args.invert:
                    mask = ~mask
                if sc is None:
                    sc = StreamingCarver(shape, origin, vs,
                                         hw=tuple(mask.shape), device=device)
                sc.add_view(mask, cam)
                t1 = time.perf_counter()
                view_s += t1 - t0
                first_view = t0 if first_view is None else first_view
                last_view = t1
                seen.add(img.name)
                new += 1
                since_preview += 1
            if new:
                last_new = time.monotonic()
                if args.every and since_preview >= args.every:
                    _write("preview")
                    since_preview = 0
            elif time.monotonic() - last_new > args.idle_stop:
                break
            time.sleep(args.poll)

        if sc is None:
            sys.exit("no carvable images appeared")
        _write("final")
    wall = time.perf_counter() - t_start

    if args.report:
        rep = {"device": str(device), "n_views": sc.n_views,
               "previews": previews, "view_s": view_s,
               "views_per_s": sc.n_views / view_s if view_s else None,
               "ingest_s": last_view - first_view,
               "wall_s": wall, "launches": dict(kernels.LAUNCHES)}
        if profiled:
            busy = _device_busy_s(prof)
            rep.update(device_busy_s=busy, device_idle_share=1 - busy / wall)
        Path(args.report).write_text(json.dumps(rep))


if __name__ == "__main__":
    main()
