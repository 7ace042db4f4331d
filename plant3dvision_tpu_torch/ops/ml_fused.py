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
CUDA goes to the hand-written kernel (kernels/csrc/accumulate.cu), CPU to
`accumulate_plain`. Both update `vol` in place and return it (the JAX
package donates the slab program's accumulator; its whole-grid program
returns a new one).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .carving import EPS, fma_f32, project

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
