"""2D mask computation: vegetation filter, threshold, exact-disk dilation.

Port of plant3dvision_tpu/ops/masks.py: the host path that FusedCarving and
Masks use (`compute_mask_numpy`, `_dilate_np`, `_disk_offsets`), and
`binary_dilation`, which Segmentation2D runs on its thresholded masks: on
CUDA the hand-written dilate kernel (kernels/csrc/dilate.cu), on the CPU
`binary_dilation_plain`. The device filter + threshold (`compute_mask`)
waits for the port's image front-end slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels


def _disk_offsets(radius: int) -> np.ndarray:
    """Euclidean disk footprint offsets (skimage.morphology.disk semantics)."""
    r = int(radius)
    dy, dx = np.mgrid[-r: r + 1, -r: r + 1]
    keep = dy ** 2 + dx ** 2 <= r ** 2
    return np.stack([dy[keep], dx[keep]], axis=1)


def binary_dilation(mask, radius: int):
    """Binary dilation of a (..., H, W) bool tensor with the exact Euclidean
    disk of `radius` (`_disk_offsets`): a pixel is true when any in-frame
    pixel of the disk around it is; pixels outside the frame count as
    false. radius <= 0 returns `mask` as it is (as the JAX package does)."""
    if radius <= 0:
        return mask
    if mask.dtype != torch.bool or mask.ndim < 2:
        raise ValueError("mask must be a (..., H, W) bool tensor")
    if mask.device.type == "cpu":
        return binary_dilation_plain(mask, radius)
    kernels.require_cuda("dilate_disk", mask)
    H, W = mask.shape[-2:]
    offsets = np.ascontiguousarray(_disk_offsets(radius), dtype=np.int32)
    out = torch.empty_like(mask)
    rc = kernels.lib().p3d_dilate(
        mask.data_ptr(), out.data_ptr(), mask.numel() // (H * W), H, W,
        offsets.ctypes.data, len(offsets), kernels.stream_ptr(mask.device))
    kernels.LAUNCHES["dilate_disk"] += 1
    kernels.check("dilate_disk", rc)
    return out


def binary_dilation_plain(mask, radius: int):
    """Plain PyTorch version of the dilate kernel: the OR of the mask
    shifted by every offset of the disk, the shifted-in rows and columns
    false."""
    H, W = mask.shape[-2:]
    out = mask.clone()
    for dy, dx in _disk_offsets(radius):
        dy, dx = int(dy), int(dx)
        if abs(dy) >= H or abs(dx) >= W:
            continue
        # out[y, x] |= mask[y - dy, x - dx]
        out[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] |= \
            mask[..., max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)]
    return out


def compute_mask_numpy(image, filter_type="linear", coefs=(0.0, 1.0, 0.0),
                       threshold=0.3, dilation_radius=0, binarize=True,
                       as_bool=False):
    """Pure-numpy compute_mask (identical semantics).

    The standalone Masks task uses this path: thresholding a uint8 image is
    memory-bound host work living between two PNG codecs — shipping the
    bytes to the accelerator per file costs more than the op. The jitted
    version exists for the fused on-device pipeline (tasks.fused).

    as_bool=True (requires binarize) returns the bool mask directly —
    skips a 4-bytes/px float32 materialization for consumers that
    bit-pack or compare anyway (tasks/fused.py decodes 300 such masks
    on one host core; the float copies were ~20% of its decode phase).
    """
    img = np.asarray(image)
    if as_bool and not binarize:
        raise ValueError("as_bool requires binarize=True")

    # fast lane: uint8 + linear + binarize with a single positive coef
    # reduces to one integer comparison (no float copies; GIL-friendly)
    if (binarize and filter_type == "linear" and img.dtype == np.uint8):
        c = np.asarray(coefs, np.float32)
        nz = np.nonzero(c)[0]
        if len(nz) == 1 and c[nz[0]] > 0:
            ch = img if img.ndim == 2 else img[..., nz[0]]
            m = ch > (threshold * 255.0 / c[nz[0]])
            if dilation_radius > 0:
                m = _dilate_np(m, dilation_radius)
            return m if as_bool else m.astype(np.float32)

    if img.ndim == 2:
        img = img[..., None]
    if img.dtype == np.uint8:
        x = img.astype(np.float32) / 255.0
    elif img.dtype == np.uint16:
        x = img.astype(np.float32) / 65535.0
    else:
        x = img.astype(np.float32)
        lo, hi = x.min(), x.max()
        x = (x - lo) / max(hi - lo, 1e-12)
    if filter_type == "linear":
        c = np.asarray(coefs, np.float32)
        n = min(x.shape[-1], len(c))
        out = x[..., :n] @ c[:n]
    elif filter_type == "excess_green":
        s = np.maximum(x[..., :3].sum(axis=-1, keepdims=True), 1e-12)
        chroma = x[..., :3] / s
        out = 2 * chroma[..., 1] - chroma[..., 0] - chroma[..., 2]
    else:
        raise ValueError(f"Unknown mask filter type: {filter_type}")
    if not binarize:
        return np.clip(out, 0.0, 1.0)
    m = out > threshold
    if dilation_radius > 0:
        m = _dilate_np(m, dilation_radius)
    return m if as_bool else m.astype(np.float32)


def _dilate_np(m, radius):
    from scipy.ndimage import binary_dilation as nd_dilation
    r = int(radius)
    size = 2 * r + 1
    fp = np.zeros((size, size), bool)
    for dy, dx in _disk_offsets(r):
        fp[dy + r, dx + r] = True
    return nd_dilation(m, structure=fp)
