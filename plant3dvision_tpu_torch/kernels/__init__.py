"""Hand-written CUDA kernels for Hopper (sm_90a): build, load, count.

Each `csrc/*.cu` holds one kernel family behind a plain C interface. At
first use every source is compiled to an object by its own `nvcc` process,
all started together, and the objects are linked into one shared library,
`kernels/_build/<hash>/libp3d.so` (the hash covers the sources and the
flags, so an edit rebuilds), loaded with `ctypes`. Nothing here runs at import: the CPU tests import every module
of the package on a machine without nvcc or a card.

`LAUNCHES` counts kernel launches, one per launch, bumped by the wrappers
in `ops/`, `proc3d.py`, `models/quant.py` and `tools/gather_probe.py`
right where they launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"

#: kernel name -> source file under csrc/ (K5-avg, "average", is a mode of
#: the accumulate kernel, and K11, "count_kills", and K11b,
#: "carve_candidates", kernels of carve.cu; K16's three entry points share
#: int8conv.cu, K17-K19 gather.cu and K20-K23 train.cu: one source each,
#: their own launch counts)
SOURCES = {
    "carve": "carve.cu",
    "signed_distance": "edt.cu",
    "gradient_gaussian": "filters.cu",
    "band_compact": "band.cu",
    "accumulate_labels": "accumulate.cu",
    "average": "accumulate.cu",
    "multiclass_select": "select.cu",
    "reproject_scores": "reproject.cu",
    "dilate_disk": "dilate.cu",
    "undistort": "undistort.cu",
    "mask_filter": "mask.cu",
    "count_kills": "carve.cu",
    "carve_candidates": "carve.cu",
    "ray_coverage": "coverage.cu",
    "harris_response": "harris.cu",
    "eikonal_sweep": "eikonal.cu",
    "trace_geodesics": "geodesics.cu",
    "int8_quantize": "int8conv.cu",
    "int8_absmax": "int8conv.cu",
    "int8_conv": "int8conv.cu",
    "gather_axis1": "gather.cu",
    "gather_rows": "gather.cu",
    "gather_select32": "gather.cu",
    "batch_gather": "train.cu",
    "weighted_ce": "train.cu",
    "weighted_ce_backward": "train.cu",
    "adamw": "train.cu",
    "adamw_tp": "train.cu",
    "iou_counts": "train.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC"]

#: launches per kernel name since the last reset_launches()
LAUNCHES = {name: 0 for name in SOURCES}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C signature of the library's entry points (every kernel entry point
#: returns the cudaError_t of its launches as an int)
_ARGTYPES = {
    # packed, row_bytes, cams, valid, V, H, W, ox, oy, oz, vs,
    # x_start, nx, ny, nz, out, stream
    "p3d_carve": [_P, _L, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                  _I, _I, _I, _I, _P, _P],
    # p3d_carve's arguments up to vs, then nx, ny, nz, max_kills, kills,
    # seen, vol, stream
    "p3d_count_kills": [_P, _L, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                        _I, _I, _I, _I, _P, _P, _P, _P],
    # vol, words, nx, ny, nz, c0, nonzero, wide, stream
    "p3d_edt_x": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # words, out, spill (or null), nx, ny, nz, c1, c2, mode, wide, stream
    "p3d_edt_yz": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # nz, wide -> 1 where p3d_edt_yz needs its spill buffer
    "p3d_edt_yz_spills": [_I, _I],
    # x, g, nx, ny, nz, axis, stream
    "p3d_gradient": [_P, _P, _I, _I, _I, _I, _P],
    # x, y, nx, ny, nz, axis, taps (host float*), radius, stream
    "p3d_gauss": [_P, _P, _I, _I, _I, _I, _P, _I, _P],
    # d, gx, gy, gz, nx, ny, nz, reflect tables (device int32), taps (host
    # float*), radius, stream
    "p3d_smoothed_gradient": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P],
    # d, n, lo, hi, offsets (tiles + 1 int64), stream
    "p3d_band_count": [_P, _L, _F, _F, _P, _P],
    # n -> number of tiles (and of per-tile counts)
    "p3d_band_tiles": [_L],
    # d, gx, gy, gz, n, lo, hi, offsets, idx_out, d_out, g_out, stream
    "p3d_band_scatter": [_P, _P, _P, _P, _L, _F, _F, _P, _P, _P, _P, _P],
    # launches, stream
    "p3d_band_empty": [_I, _P],
    # vol, probs, cams, valid, B, C, H, W, ox, oy, oz, vs, nx, ny, nz,
    # x_start, slab_nx, log_mode, box, avg, store_x0, stream
    "p3d_accumulate": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # stack, out, L, n, bg, prior, min_contrast, min_score, contrast_on,
    # stream
    "p3d_select": [_P, _P, _I, _L, _I, _F, _F, _F, _I, _P],
    # points, masks, cams, label_idx, N, F, H, W, L, scores, stream
    "p3d_reproject": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # in, out, M, H, W, chords (host int32, 2r + 1 half-widths), r, stream
    "p3d_dilate": [_P, _P, _L, _I, _I, _P, _I, _P],
    # in, out, N, H, W, C, dtype, fx, fy, cx, cy, k1, k2, p1, p2, k3,
    # lanes (or null), stream
    "p3d_undistort": [_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                      _F, _F, _F, _P, _P],
    # in, out, N, H, W, C, dtype, mode, coefs (host float*), n, channel,
    # binarize, threshold, fast_t, ranges, stream
    "p3d_mask": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _F, _F, _P,
                 _P],
    # packed, row_bytes, cams, B, V, H, W, ox, oy, oz, vs, nx, ny, nz,
    # max_kills, alive, stream
    "p3d_carve_candidates": [_P, _L, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I,
                             _I, _I, _I, _P, _P],
    # cams, vol_of, view_of, alive, NB, box, uv, valid, G, N, ox, oy, oz,
    # bx, by, bz, vs, inv_vs, nx, ny, nz, n_steps, rcp_steps, covered,
    # valid_out, stream
    "p3d_ray_coverage": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _F, _F, _F,
                         _F, _F, _F, _F, _F, _I, _I, _I, _I, _F, _P, _P, _P],
    # gray, mask, V, H, W, rows (a warp's band), border, kappa, out, stream
    "p3d_harris": [_P, _P, _I, _I, _I, _I, _I, _F, _P, _P],
    # nbr, M, speed_inv (or null), active, out, u0, u1, ctl, max_iters, tol,
    # sweeps, stream
    "p3d_eikonal_grid": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _F, _P, _P],
    # M, iters, stream
    "p3d_grid_barriers": [_I, _I, _P],
    # flow, values, tips, N, nx, ny, nz, step, n_steps, bx, by, bz, votes,
    # stream
    "p3d_trace_geodesics": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _F, _F,
                            _P, _P],
    # iters, scratch (4 x 16^3 float32 on the card), sink, stream
    "p3d_trace_step_floor": [_I, _P, _P, _P],
    # descriptors (host, n x 16 int64), n, arena, eps, stream
    "p3d_int8_quantize_weights": [_P, _I, _P, _F, _P],
    # x, dtype, n, maxbits, stream
    "p3d_int8_absmax": [_P, _I, _L, _P, _P],
    # x, dtype, wp, xmax, wmax, bias (or null), out, B, C, H, W, K, kh, kw,
    # stride, pt, pl, OH, OW, cfg, CC, nch, DC, n_blocks_n, xfloor, wfloor,
    # stream
    "p3d_int8_conv": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # tab, idx, out, R, L, N, reps, stream
    "p3d_gather_axis1": [_P, _P, _P, _I, _I, _I, _I, _P],
    # L -> 1 when the row is staged in shared memory
    "p3d_gather_axis1_staged": [_I],
    # tab, rows, out, R, P, reps, stream
    "p3d_gather_rows": [_P, _P, _P, _I, _I, _I, _P],
    # T, dy, out, P, reps, stream
    "p3d_gather_select32": [_P, _P, _P, _I, _I, _P],
    # rgb, lab, idx, flip, gains, x, y, B, c, inv255, stream
    "p3d_gather_batch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    # n -> blocks (partial sums) of K21's pass
    "p3d_ce_blocks": [_L],
    # logits, labels, w, C, HW, n, ignore, ctl, part, out, dlogits (or
    # null), stream
    "p3d_ce": [_P, _P, _P, _I, _L, _L, _I, _P, _P, _P, _P, _P],
    # logits, labels, w, fwd, grad, C, HW, n, ignore, skip_one, dlogits,
    # stream
    "p3d_ce_backward": [_P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _P, _P],
    # n -> chunk sums K22's norm writes
    "p3d_adamw_partials": [_L],
    # p, g, mu, nu, n, part, clip, b1, b2, omb1, omb2, bc1, bc2, eps,
    # eps_root, wd, neg_lr, max_norm, stream
    "p3d_adamw": [_P, _P, _P, _P, _L, _P, _I, _F, _F, _F, _F, _F, _F, _F,
                  _F, _F, _F, _F, _P],
    # K22's tp lane: g, n, part, stream (the chunk sums), then p, g, mu,
    # nu, n, sums, n_sums, b1, b2, omb1, omb2, bc1, bc2, eps, eps_root, wd,
    # neg_lr, max_norm, stream (the update with the norm of `sums`)
    "p3d_adamw_tp_partials": [_P, _L, _P, _P],
    "p3d_adamw_tp_update": [_P, _P, _P, _P, _L, _P, _I, _F, _F, _F, _F, _F,
                            _F, _F, _F, _F, _F, _F, _P],
    # logits (or null), preds (or null), labels, C, HW, n, ignore, counts,
    # stream
    "p3d_iou_counts": [_P, _P, _P, _I, _L, _L, _I, _P, _P],
}

_lock = threading.Lock()
_lib = None
#: seconds the last build() spent compiling (0.0 when it was cached)
last_build_seconds = 0.0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else [])
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from kernels/csrc at first use")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise with the logs of any that fail."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    errors = []
    for cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def build() -> Path:
    """Build the kernel library if it is not built yet: one nvcc -c per
    source, all in parallel, then one link. Returns the path of the .so."""
    global last_build_seconds
    out_dir = _build_dir()
    so = out_dir / "libp3d.so"
    t0 = time.perf_counter()
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = os.getpid()
        srcs = sorted(set(SOURCES.values()))
        objs = [out_dir / f"{Path(src).stem}.{tag}.o" for src in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
                  for obj, src in zip(objs, srcs)])
        tmp = so.with_suffix(f".{tag}.tmp")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, so)
        for obj in objs:
            obj.unlink()
    last_build_seconds = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with its entry
    points' argtypes set."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            for fn, argtypes in _ARGTYPES.items():
                f = getattr(so, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            so.p3d_errstr.argtypes = [ctypes.c_int]
            so.p3d_errstr.restype = ctypes.c_char_p
            _lib = so
        return _lib


def check(name: str, rc: int) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().p3d_errstr(rc).decode()
        raise RuntimeError(f"CUDA kernel '{name}' failed: {msg} ({rc})")


def stream_ptr(device) -> int:
    """Raw cudaStream_t of PyTorch's current stream on `device` (read as
    torch.cuda.current_stream reads it, without building a Stream object:
    a few microseconds of a one-image call)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(idx)


def require_volume(name: str, x) -> None:
    """The volume kernels take one contiguous 3-D float32 CUDA tensor."""
    if x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"{name}: the CUDA kernel takes a 3-D float32 "
                         f"volume, got {tuple(x.shape)} {x.dtype}")
    require_cuda(name, x)


def require_cuda(name: str, *tensors) -> None:
    """Common wrapper checks: CUDA, contiguous, one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
