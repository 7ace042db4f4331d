"""Fused CNN-segmentation -> multi-label averaging carve: the accumulate
kernel and its plain PyTorch version.

Port of plant3dvision_tpu/ops/ml_fused.py. Each batch of per-view label
probabilities (the CNN's softmax, never leaving the device) is accumulated
into the C-label averaging volume: per voxel and view the grid point is
projected once and a C-vector is sampled at the projection, bilinearly or
(`sample="box"`) as one tap of the 2x2 box prefilter, the reference's OpenCL
LINEAR read at integer coordinates. `log_mode` accumulates log(EPS + p)
(reference Voxels `log=True`).

`accumulate_label_views` (whole grid) and `accumulate_label_views_slab` (one
x-slab, projected with its global x offset) dispatch on the tensors' device:
CUDA goes to the hand-written kernel (kernels/csrc/accumulate.cu: a block
per voxel tile stages each view's pixel window in shared memory), CPU to
`accumulate_plain`. Both update `vol` in place and return it (the JAX
package donates the slab program's accumulator; its whole-grid program
returns a new one). `tile_windows` repeats the kernel's per-tile window
rule, to measure its footprints.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .carving import EPS, _dot3_add, fma_f32, grid_axes, project

SAMPLES = ("bilinear", "box")


def _check_args(vol, probs, cams, valid, x_start, slab_nx, sample):
    if sample not in SAMPLES:
        raise ValueError(f"sample must be one of {SAMPLES}, got {sample!r}")
    if vol.dtype != torch.float32 or vol.ndim != 4:
        raise ValueError("vol must be a (C, nx, ny, nz) float32 volume")
    if probs.dtype != torch.float32 or probs.ndim != 4:
        raise ValueError("probs must be (B, C, H, W) float32")
    B, C, H, W = probs.shape
    if vol.shape[0] != C:
        raise ValueError(f"vol has {vol.shape[0]} labels, probs {C}")
    if H < 2 or W < 2:
        raise ValueError(f"label maps must be at least 2x2, got {H}x{W}")
    if cams.dtype != torch.float32 or tuple(cams.shape) != (B, 16):
        raise ValueError("cams must be (B, 16) float32")
    if valid.dtype != torch.bool or tuple(valid.shape) != (B,):
        raise ValueError("valid must be (B,) bool")
    if not (0 <= x_start and slab_nx >= 1
            and x_start + slab_nx <= vol.shape[1]):
        raise ValueError(f"slab [{x_start}, {x_start + slab_nx}) outside "
                         f"the volume's {vol.shape[1]} x rows")


def accumulate(vol, probs, cams, valid, origin, voxel_size, x_start,
               slab_nx, log_mode, sample="bilinear"):
    """Accumulate one view batch into x rows [x_start, x_start + slab_nx)
    of `vol` (C, nx, ny, nz), in place; returns `vol`.

    probs (B, C, H, W) float32 in [0, 1]; cams (B, 16) float32
    [fx,fy,cx,cy, rotmat(9), tvec(3)]; valid (B,) bool; all on one device.
    """
    _check_args(vol, probs, cams, valid, x_start, slab_nx, sample)
    if vol.device.type == "cpu":
        return accumulate_plain(vol, probs, cams, valid, origin, voxel_size,
                                x_start, slab_nx, log_mode, sample)
    kernels.require_cuda("accumulate_labels", vol, probs, cams, valid)
    if vol.shape[0] > 8:
        raise ValueError("the accumulate kernel takes at most 8 labels")
    B, C, H, W = probs.shape
    _, nx, ny, nz = vol.shape
    o = np.asarray(origin, np.float32)
    valid_u8 = valid.to(torch.uint8)
    rc = kernels.lib().p3d_accumulate(
        vol.data_ptr(), probs.data_ptr(), cams.data_ptr(),
        valid_u8.data_ptr(), B, C, H, W, float(o[0]), float(o[1]),
        float(o[2]), float(np.float32(voxel_size)), nx, ny, nz,
        int(x_start), int(slab_nx), int(bool(log_mode)),
        int(sample == "box"), 0, 0, kernels.stream_ptr(vol.device))
    kernels.LAUNCHES["accumulate_labels"] += 1
    kernels.check("accumulate_labels", rc)
    return vol


def accumulate_plain(vol, probs, cams, valid, origin, voxel_size, x_start,
                     slab_nx, log_mode, sample="bilinear"):
    """Plain PyTorch version of the accumulate kernel: the same f32
    operations in the same order, one view at a time over the slab."""
    B, C, H, W = probs.shape
    _, _, ny, nz = vol.shape
    acc = vol[:, x_start:x_start + slab_nx]          # a view: updated in place
    img = torch.log(EPS + probs) if log_mode else probs
    if sample == "box":
        # 2x2 box prefilter of the edge-padded (top, left) map, in the JAX
        # package's sum order
        pf = torch.nn.functional.pad(img, (1, 0, 1, 0), mode="replicate")
        img = 0.25 * (((pf[:, :, :H, :W] + pf[:, :, :H, 1:])
                       + pf[:, :, 1:, :W]) + pf[:, :, 1:, 1:])
    flat = img.reshape(B, C, H * W)
    for b in range(B):
        if not bool(valid[b]):
            continue
        px, py, in_img = project(cams[b], origin, voxel_size, x_start,
                                 (slab_nx, ny, nz), (H, W))
        fx0 = torch.floor(px).clamp(0, W - 2)
        fy0 = torch.floor(py).clamp(0, H - 2)
        i00 = fy0.long() * W + fx0.long()

        def g(i):
            return flat[b][:, i.reshape(-1)].reshape(C, *i.shape)

        if sample == "box":
            val = g(i00)
        else:
            fx = (px - fx0).clamp(0.0, 1.0)
            fy = (py - fy0).clamp(0.0, 1.0)
            w00 = (1 - fx) * (1 - fy)
            w01 = fx * (1 - fy)
            w10 = (1 - fx) * fy
            w11 = fx * fy
            val = fma_f32(g(i00 + W + 1), w11,
                          fma_f32(g(i00 + W), w10,
                                  fma_f32(g(i00), w00, g(i00 + 1) * w01)))
        acc += torch.where(in_img, val, 0.0)
    return vol


#: the kernel's voxel tile (x, y, z), window margin in pixels and staged
#: floats a window (accumulate.cu: kTX/kTY/kTZ, kMargin, kRegion)
TILE, MARGIN, REGION = (8, 8, 16), 2, 2048
#: tile-view statuses: skipped, read from global memory, staged
SKIP, GLOBAL, STAGED = 0, 1, 2


def tile_windows(cam, origin, voxel_size, x_start, shape, hw, C, box,
                 grid_fma=True):
    """The accumulate kernel's decision for one view and every voxel tile
    of the x rows [x_start, x_start + shape[0]) of a grid (`shape` = (slab
    nx, ny, nz)): (status (tiles,) int8, window pixels (tiles,) int64 (0
    unless staged), in-frame voxels of staged tiles whose taps fall outside
    their window). The window is the bounding box of the tile's 8 projected
    corner voxels widened by MARGIN pixels and clipped to the frame; a tile
    is skipped when that box misses the frame by more than the margin, read
    from global memory when a corner is behind the camera or its C-label
    window (plus a row and a column in box mode, its rows widened to whole
    runs of 4 floats when W is a multiple of 4) exceeds REGION floats."""
    H, W = hw
    px, py, in_img = project(cam, origin, voxel_size, x_start, shape, hw,
                             grid_fma=grid_fma)
    dev = cam.device
    ax = grid_axes(origin, voxel_size, x_start, shape, dev, grid_fma)
    pz = _dot3_add(cam[10], cam[11], cam[12], *ax, cam[15]).expand(px.shape)
    lo = [torch.arange(0, n, t, device=dev) for n, t in zip(shape, TILE)]
    hi = [torch.clamp(l + t - 1, max=n - 1) for l, t, n in
          zip(lo, TILE, shape)]
    idx = []                       # the 8 corner voxels of every tile
    for k in range(8):
        ii = [(hi if (k >> a) & 1 else lo)[a] for a in range(3)]
        idx.append((ii[0].view(-1, 1, 1), ii[1].view(1, -1, 1),
                    ii[2].view(1, 1, -1)))
    cpx = torch.stack([px[i] for i in idx]).flatten(1)
    cpy = torch.stack([py[i] for i in idx]).flatten(1)
    front = torch.stack([pz[i] > 0 for i in idx]).flatten(1).all(0)
    lx, hx = cpx.amin(0), cpx.amax(0)
    ly, hy = cpy.amin(0), cpy.amax(0)
    meets = ((hx >= -1 - MARGIN) & (lx <= W + MARGIN) & (hy >= -1 - MARGIN)
             & (ly <= H + MARGIN))
    x0 = torch.clamp(torch.floor(lx.clamp(min=-8.0)) - MARGIN, min=0)
    x1 = torch.clamp(torch.floor(hx.clamp(max=W + 8.0)) + MARGIN + 1,
                     max=W - 1)
    y0 = torch.clamp(torch.floor(ly.clamp(min=-8.0)) - MARGIN, min=0)
    y1 = torch.clamp(torch.floor(hy.clamp(max=H + 8.0)) + MARGIN + 1,
                     max=H - 1)
    rx0 = torch.clamp(x0 - 1, min=0) if box else x0
    ry0 = torch.clamp(y0 - 1, min=0) if box else y0
    rend = x1 + 1
    if W % 4 == 0:                   # rows copied 4 floats at a time
        rx0 = torch.div(rx0, 4, rounding_mode="floor") * 4
        rend = torch.div(rend + 3, 4, rounding_mode="floor") * 4
    region = C * (y1 - ry0 + 1) * (rend - rx0)
    status = torch.full(lx.shape, SKIP, dtype=torch.int8, device=dev)
    status[~front] = GLOBAL
    ok = front & meets & (x1 >= x0) & (y1 >= y0)
    status[ok & (region > REGION)] = GLOBAL
    staged = ok & (region <= REGION)
    status[staged] = STAGED
    pixels = torch.where(staged, (x1 - x0 + 1) * (y1 - y0 + 1), 0).long()
    # the taps of each in-frame voxel against its tile's window
    fx0 = torch.floor(px).clamp(0, W - 2)
    fy0 = torch.floor(py).clamp(0, H - 2)
    tiles = [torch.arange(n, device=dev) // t for n, t in zip(shape, TILE)]
    nt = [len(l) for l in lo]
    tid = ((tiles[0].view(-1, 1, 1) * nt[1] + tiles[1].view(1, -1, 1))
           * nt[2] + tiles[2].view(1, 1, -1))
    need = 0 if box else 1
    inside = ((fx0 >= x0[tid]) & (fx0 + need <= x1[tid]) & (fy0 >= y0[tid])
              & (fy0 + need <= y1[tid]))
    outside = int((in_img & staged[tid] & ~inside).sum())
    return status, pixels, outside


def accumulate_label_views(vol, probs, cams, valid, origin, voxel_size,
                           shape, log_mode, sample="bilinear"):
    """Accumulate a batch of per-view label probabilities into the
    multi-label averaging volume `vol` (C, *shape) float32 (running sum), in
    place; returns it. probs (B, C, H, W) float32 in [0, 1] (the forward
    program's layout); cams (B, 16); valid (B,) bool (padded batches)."""
    if tuple(vol.shape[1:]) != tuple(int(s) for s in shape):
        raise ValueError(f"vol {tuple(vol.shape)} does not hold grid {shape}")
    return accumulate(vol, probs, cams, valid, origin, voxel_size, 0,
                      vol.shape[1], log_mode, sample)


def accumulate_label_views_slab(vol, probs, cams, valid, origin, voxel_size,
                                x_start, slab_nx, log_mode,
                                sample="bilinear"):
    """Accumulate one view batch into the x-slab [x_start, x_start +
    slab_nx) of the full (C, nx_pad, ny, nz) accumulator `vol`, in place
    (JAX donates it); returns `vol`. `x_start` is a multiple of `slab_nx`
    and `nx_pad` a multiple of `slab_nx` (the caller pads, then crops), as
    in the JAX package. Values equal the whole-grid program's: the slab
    projects with the global x offset and keeps the per-view order."""
    if x_start % slab_nx or vol.shape[1] % slab_nx:
        raise ValueError(f"x_start {x_start} and nx_pad {vol.shape[1]} must "
                         f"be multiples of slab_nx {slab_nx}")
    return accumulate(vol, probs, cams, valid, origin, voxel_size,
                      int(x_start), int(slab_nx), log_mode, sample)
