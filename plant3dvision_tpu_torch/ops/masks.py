"""2D mask computation: vegetation filter, threshold, exact-disk dilation.

Port of plant3dvision_tpu/ops/masks.py. `mask_filter` is the filter +
threshold of a stack of images (rescale, linear or excess-green filter,
`> threshold` or a clip to [0, 1]): on CUDA the hand-written mask kernel
(kernels/csrc/mask.cu), on the CPU `mask_filter_plain`. Its arithmetic is
that of `compute_mask_numpy`, the host function the JAX Masks task runs,
uint8 fast lane included, so the port's Masks writes the JAX task's PNGs.
`compute_mask` / `compute_masks_batch` (the JAX package's jitted
pipeline) are `mask_filter` followed by `binary_dilation`: on CUDA the
dilate kernel (kernels/csrc/dilate.cu), on the CPU `binary_dilation_plain`.
They follow numpy where the JAX jitted function differs from it: XLA
divides by 255 as a multiply by the reciprocal and sums the linear filter
in another order, which moves a value that lies within an ulp of the
threshold (tests/test_torch_frontend.py counts them).
`compute_mask_numpy` and `_dilate_np` are the host path that FusedCarving
uses.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .carving import div_f32, fma_f32

#: mask_filter lanes (the mask kernel's modes)
FAST, LINEAR, EXCESS_GREEN = 0, 1, 2
#: image dtype -> the mask kernel's type code
_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}


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


# -- filter + threshold (the mask kernel) --------------------------------------

def _ranges(images):
    """(N, 2) float32 (lo, max(hi - lo, 1e-12)) of each float image."""
    flat = images.reshape(images.shape[0], -1)
    lo, hi = flat.amin(1), flat.amax(1)
    d = hi - lo
    eps = torch.tensor(np.float32(1e-12), device=images.device)
    return torch.stack([lo, torch.where(d > eps, d, eps)], 1).contiguous()


def rescale01(image):
    """uint images -> [0, 1] float32 (uint8 / 255, uint16 / 65535, IEEE
    divisions); float images -> (x - lo) / max(hi - lo, 1e-12) with the
    image's own min and max."""
    if image.dtype == torch.uint8:
        return div_f32(image.to(torch.float32), 255.0)
    if image.dtype == torch.uint16:
        return div_f32(image.to(torch.float32), 65535.0)
    x = image.to(torch.float32)
    r = _ranges(x[None])[0]
    return (x - r[0]) / r[1]


def _linear(x, coefs):
    """The linear filter of rescaled (..., C) channels as numpy's matmul
    sums them (see kernels/csrc/mask.cu)."""
    c = [torch.tensor(v, device=x.device) for v in coefs]
    if len(c) == 4:
        return (x[..., 0] * c[0] + x[..., 1] * c[1]) \
            + (x[..., 2] * c[2] + x[..., 3] * c[3])
    out = x[..., 0] * c[0]
    for i in range(1, len(c)):
        out = fma_f32(x[..., i], c[i], out)
    return out


def _excess_green(x):
    s = torch.clamp(x[..., 0] + x[..., 1] + x[..., 2],
                    min=float(np.float32(1e-12)))
    return 2 * (x[..., 1] / s) - x[..., 0] / s - x[..., 2] / s


def linear_filter(image, coefs):
    """Per-channel linear combination of the [0, 1] rescaled (H, W[, C])
    image over its first min(C, len(coefs)) channels."""
    x = rescale01(image)
    if x.ndim == 2:
        x = x[..., None]
    c = np.asarray(coefs, np.float32)
    return _linear(x, c[:min(x.shape[-1], len(c))])


def excess_green(image):
    """EG = 2g - r - b on the chromatic coordinates of the rescaled image."""
    return _excess_green(rescale01(image))


def _lane(images, filter_type, coefs, threshold, binarize):
    """(mode, coefs, channel, fast threshold) of compute_mask_numpy's lane
    for a (N, H, W[, C]) stack."""
    gray = images.ndim == 3
    C = 1 if gray else images.shape[-1]
    c = np.asarray(coefs, np.float32)
    if filter_type == "linear":
        nz = np.nonzero(c)[0]
        if (binarize and images.dtype == torch.uint8 and len(nz) == 1
                and c[nz[0]] > 0):
            if nz[0] >= C and not gray:
                raise ValueError(f"coefficient {nz[0]} of a {C}-channel image")
            # numpy's own expression: float32 under NEP 50
            t = np.float32(threshold * 255.0 / c[nz[0]])
            return FAST, c[:0], 0 if gray else int(nz[0]), float(t)
        n = min(C, len(c))
        if not 1 <= n <= 4:
            raise ValueError(f"the linear filter takes 1-4 channels, got {n}")
        return LINEAR, c[:n], 0, 0.0
    if filter_type == "excess_green":
        if C < 3:
            raise ValueError("excess_green needs 3 channels")
        return EXCESS_GREEN, c[:0], 0, 0.0
    raise ValueError(f"Unknown mask filter type: {filter_type}")


def mask_filter(images, filter_type="linear", coefs=(0.0, 1.0, 0.0),
                threshold=0.3, binarize=True):
    """Filter + threshold of a (N, H, W[, C]) image stack: bool (N, H, W)
    masks (binarize) or float32 filter values clipped to [0, 1], on the
    images' device, equal to compute_mask_numpy's (before any dilation)."""
    if images.ndim not in (3, 4):
        raise ValueError("images must be (N, H, W[, C])")
    mode, c, channel, fast_t = _lane(images, filter_type, coefs, threshold,
                                     binarize)
    if images.device.type == "cpu":
        return mask_filter_plain(images, filter_type, coefs, threshold,
                                 binarize)
    if images.dtype not in _DTYPES:
        raise ValueError(f"mask_filter: the CUDA kernel takes uint8, uint16 "
                         f"or float32 images, got {images.dtype}")
    kernels.require_cuda("mask_filter", images)
    N, H, W = images.shape[:3]
    C = images.shape[3] if images.ndim == 4 else 1
    binary = binarize or mode == FAST
    out = torch.empty((N, H, W), device=images.device,
                      dtype=torch.bool if binary else torch.float32)
    ranges = _ranges(images) if images.dtype == torch.float32 else None
    cc = np.ascontiguousarray(c, np.float32)
    rc = kernels.lib().p3d_mask(
        images.data_ptr(), out.data_ptr(), N, H, W, C,
        _DTYPES[images.dtype], mode, cc.ctypes.data, len(cc), channel,
        int(binary), float(np.float32(threshold)), fast_t,
        ranges.data_ptr() if ranges is not None else None,
        kernels.stream_ptr(images.device))
    kernels.LAUNCHES["mask_filter"] += 1
    kernels.check("mask_filter", rc)
    return out


def mask_filter_plain(images, filter_type="linear", coefs=(0.0, 1.0, 0.0),
                      threshold=0.3, binarize=True):
    """Plain PyTorch version of the mask kernel (the same f32 operations)."""
    mode, c, channel, fast_t = _lane(images, filter_type, coefs, threshold,
                                     binarize)
    x = images if images.ndim == 4 else images[..., None]
    if mode == FAST:
        return x[..., channel].to(torch.float32) > fast_t
    if x.dtype in (torch.uint8, torch.uint16):
        x = rescale01(x)
    else:
        x = torch.stack([rescale01(im) for im in x])
    val = _linear(x, c) if mode == LINEAR else _excess_green(x)
    if binarize:
        return val > float(np.float32(threshold))
    return val.clamp(0.0, 1.0)


def compute_masks_batch(images, filter_type="linear", coefs=(0.0, 1.0, 0.0),
                        threshold=0.3, dilation_radius=0, binarize=True):
    """The Masks pipeline on a (N, H, W[, C]) stack: filter -> threshold ->
    disk dilation. float32 (N, H, W), {0, 1} when binarised, else the
    filter clipped to [0, 1]."""
    m = mask_filter(images, filter_type, coefs, threshold, binarize)
    if binarize and dilation_radius > 0:
        m = binary_dilation(m, int(dilation_radius))
    return m.to(torch.float32)


def compute_mask(image, filter_type="linear", coefs=(0.0, 1.0, 0.0),
                 threshold=0.3, dilation_radius=0, binarize=True):
    """`compute_masks_batch` of one (H, W[, C]) image."""
    return compute_masks_batch(image[None], filter_type, coefs, threshold,
                               dilation_radius, binarize)[0]
