"""2D mask computation on the host (numpy): vegetation filter, threshold,
exact-disk dilation.

The part of plant3dvision_tpu/ops/masks.py that FusedCarving uses
(`compute_mask_numpy`, `_dilate_np`, `_disk_offsets`). The device mask path
of the JAX package waits for the port's image front-end slice.
"""

from __future__ import annotations

import numpy as np


def _disk_offsets(radius: int) -> np.ndarray:
    """Euclidean disk footprint offsets (skimage.morphology.disk semantics)."""
    r = int(radius)
    dy, dx = np.mgrid[-r: r + 1, -r: r + 1]
    keep = dy ** 2 + dx ** 2 <= r ** 2
    return np.stack([dy[keep], dx[keep]], axis=1)


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
