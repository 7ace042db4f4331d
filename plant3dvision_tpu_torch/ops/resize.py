"""OpenCV's image resampling as Segmentation2D(resize=True) and
Visualization use it, in numpy and torch, so the port does not depend on
cv2 for it (cv2 imports on the card's machine too, and
tests/test_torch_resize.py holds these functions to it).

The JAX task shrinks each uint8 image to the net's input with
`cv2.resize(..., INTER_AREA)` (plant3dvision_tpu/tasks/proc2d.py:246-251)
and grows the float32 probabilities back with `INTER_LINEAR` (:319-327).
These functions repeat OpenCV's generic code (imgproc/src/resize.cpp), its
coefficient tables and its float32 operations in their order:

- `resize_area_u8`: an integer scale sums each block in int and rounds
  `sum * float32(1/area)` half to even, except a 2x2 scale of 1, 3 or 4
  channels, which rounds `(sum + 2) >> 2`; any other shrink uses the
  area tables (per destination column the source columns' float32 weights
  cut by the cell edges, the same per row), accumulated in float32
  (`buf += S * alpha` along a row, `sum += beta * buf` over rows) and
  rounded half to even. Host numpy.
- `resize_linear_f32`: per destination pixel f = (d + 0.5) * scale - 0.5
  in float64 (scale = 1 / (dsize / ssize)), s = floor(f), the weight
  float32(f - s); the taps s and s + 1 clipped to the image; a horizontal
  then a vertical pass, each the fused lerp fma(S1 - S0, w, S0) in
  float32 (found against cv2 5.0: 0 values differ, while S0 (1 - w) +
  S1 w in float32 or float64 differs on 2-5 %). Torch on the tensors'
  device.
"""

from __future__ import annotations

import numpy as np
import torch


def _area_tab(ssize: int, dsize: int, scale: float):
    """OpenCV's computeResizeAreaTab: (destination index, source index,
    float32 weight) triples in its order."""
    tab = []
    for d in range(dsize):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, ssize - fs1)
        s1, s2 = int(np.ceil(fs1)), int(np.floor(fs2))
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        if s1 - fs1 > 1e-3:
            tab.append((d, s1 - 1, np.float32((s1 - fs1) / cell)))
        for s in range(s1, s2):
            tab.append((d, s, np.float32(1.0 / cell)))
        if fs2 - s2 > 1e-3:
            tab.append((d, s2, np.float32(min(min(fs2 - s2, 1.0), cell)
                                          / cell)))
    return tab


def _padded(tab, dsize):
    """The table as (dsize, K) source indices and weights, each
    destination's entries in order, padded with weight 0 at source 0."""
    k = max(np.bincount([t[0] for t in tab], minlength=dsize))
    idx = np.zeros((dsize, k), np.int64)
    w = np.zeros((dsize, k), np.float32)
    fill = np.zeros(dsize, np.int64)
    for d, s, a in tab:
        idx[d, fill[d]], w[d, fill[d]] = s, a
        fill[d] += 1
    return idx, w


def resize_area_u8(img, size):
    """cv2.resize(img, size, interpolation=cv2.INTER_AREA) for a uint8
    (H, W) or (H, W, C) image shrunk to size = (W', H') <= (W, H)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("resize_area_u8 takes uint8 images")
    H, W = img.shape[:2]
    dw, dh = int(size[0]), int(size[1])
    if (dw, dh) == (W, H):
        return img.copy()
    if dw > W or dh > H:
        raise ValueError("INTER_AREA growth is not used by the task")
    sx, sy = 1.0 / (dw / W), 1.0 / (dh / H)
    x = img.reshape(H, W, -1)
    cn = x.shape[2]
    ix, iy = int(round(sx)), int(round(sy))
    if abs(sx - ix) < np.finfo(float).eps and abs(sy - iy) < \
            np.finfo(float).eps:
        s = x[:dh * iy, :dw * ix].astype(np.int64).reshape(
            dh, iy, dw, ix, cn).sum(axis=(1, 3))
        if ix == 2 and iy == 2 and cn in (1, 3, 4):
            out = (s + 2) >> 2
        else:
            out = np.rint(s.astype(np.float32)
                          * np.float32(1.0 / np.float32(ix * iy)))
        return np.clip(out, 0, 255).astype(np.uint8).reshape(
            (dh, dw) + img.shape[2:])
    xi, xw = _padded(_area_tab(W, dw, sx), dw)
    yi, yw = _padded(_area_tab(H, dh, sy), dh)
    xf = x.astype(np.float32)
    acc = None
    for j in range(yi.shape[1]):
        rows = xf[yi[:, j]]                              # (dh, W, cn)
        buf = np.zeros((dh, dw, cn), np.float32)
        for k in range(xi.shape[1]):
            buf = buf + rows[:, xi[:, k]] * xw[None, :, k, None]
        term = yw[:, j, None, None] * buf
        acc = term if acc is None else acc + term
    out = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out.reshape((dh, dw) + img.shape[2:])


def _linear_coefs(ssize: int, dsize: int):
    """OpenCV's INTER_LINEAR taps along one axis: the two source indices
    (clipped to the image) and the float32 weight of the second."""
    scale = 1.0 / (dsize / ssize)
    f = (np.arange(dsize) + 0.5) * scale - 0.5
    s = np.floor(f)
    return (np.clip(s, 0, ssize - 1).astype(np.int64),
            np.clip(s + 1, 0, ssize - 1).astype(np.int64),
            (f - s).astype(np.float32))


def resize_linear_f32(x, size):
    """cv2.resize(x, size, interpolation=cv2.INTER_LINEAR) for float32
    images (..., H, W) (a torch tensor; every leading index one image) to
    size = (W', H')."""
    from .carving import fma_f32
    if x.dtype != torch.float32:
        raise ValueError("resize_linear_f32 takes float32 images")
    H, W = x.shape[-2:]
    dw, dh = int(size[0]), int(size[1])
    if (dw, dh) == (W, H):
        return x.clone()
    dev = x.device
    x0, x1, a = (torch.from_numpy(c).to(dev) for c in _linear_coefs(W, dw))
    y0, y1, b = (torch.from_numpy(c).to(dev) for c in _linear_coefs(H, dh))
    s0 = x[..., x0]
    rows = fma_f32(x[..., x1] - s0, a, s0)               # (..., H, W')
    r0 = rows[..., y0, :]
    return fma_f32(rows[..., y1, :] - r0, b[:, None], r0)
