"""Lens undistortion: the undistort kernel and its plain PyTorch version.

Port of plant3dvision_tpu/ops/undistort.py (the role of cv2.undistort in the
reference's Undistorted task): for each undistorted output pixel the forward
OPENCV model (k1, k2, p1, p2[, k3]) gives its source position in the
distorted input, which is sampled bilinearly; pixels whose source lies
outside the frame are 0, and integer images are rounded half to even and
clipped to [0, 255] (a uint16 image is clipped to 255 too, as the JAX
function does).

The f32 operations are those of the JAX function as XLA compiles it on the
CPU, fused multiply-adds included (found by testing contraction patterns on
seeded images; tests/test_torch_frontend.py):

    r2 = fma(x, x, y*y)            rm = r2 * fma(r2, fma(r2, k3, k2), k1)
    dx = fma(p2, fma(2x, x, r2), fma((2 p1) x, y, x*rm))
    dy = fma((2 p2) x, y, fma(p1, r2 + (2y)*y, y*rm))
    px = fma(dx, fx, u)            py = fma(dy, fy, v)
    lerp(a, b, w) = fma(a, 1 - w, b*w)   (top, bottom, then between them)

except that for a 2-D (H, W) image XLA fuses the top and bottom rows'
lerps the other way round, fma(b, w, a*(1 - w)).

`undistort_batch` dispatches on the images' device: CUDA goes to the
hand-written kernel (kernels/csrc/undistort.cu), CPU to `undistort_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .carving import fma_f32

#: image dtype -> the kernel's type code
_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}


def _params(K, dist):
    """(fx, fy, cx, cy) and (k1, k2, p1, p2, k3) as float32 numbers."""
    K = np.asarray(K.cpu() if torch.is_tensor(K) else K, np.float32)
    d = np.asarray(dist.cpu() if torch.is_tensor(dist) else dist, np.float32)
    d = d.reshape(-1)
    if K.shape != (3, 3) or len(d) < 4:
        raise ValueError("K must be 3x3 and dist hold at least (k1, k2, p1, "
                         "p2)")
    k3 = d[4] if len(d) > 4 else np.float32(0.0)
    return ((K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
            (d[0], d[1], d[2], d[3], k3))


def distort_delta(x, y, dist):
    """Distortion displacement (x_d - x, y_d - y) of normalized coordinates
    (float32 tensors), dist = (k1, k2, p1, p2[, k3]), in XLA's operations."""
    k1, k2, p1, p2, k3 = (torch.tensor(np.float32(v), device=x.device)
                          for v in (*dist[:4], dist[4] if len(dist) > 4
                                    else 0.0))
    r2 = fma_f32(x, x, y * y)
    rm = r2 * fma_f32(r2, fma_f32(r2, k3, k2), k1)
    dx = fma_f32(p2, fma_f32(2.0 * x, x, r2), fma_f32((2.0 * p1) * x, y,
                                                      x * rm))
    dy = fma_f32((2.0 * p2) * x, y, fma_f32(p1, r2 + (2.0 * y) * y, y * rm))
    return dx, dy


def distort_normalized(x, y, dist):
    """Forward OPENCV distortion of normalized coordinates."""
    dx, dy = distort_delta(x, y, dist)
    return x + dx, y + dy


def _lerp(a, b, w, fuse_b=False):
    return fma_f32(b, w, a * (1 - w)) if fuse_b else fma_f32(a, 1 - w, b * w)


def bilinear_sample(image, px, py):
    """Bilinear sample of a float32 (H, W[, C]) image at float pixel
    coordinates (px, py), the corner clipped to [0, W-2] x [0, H-2] and the
    weights to [0, 1] (the border is clamped)."""
    H, W = image.shape[0], image.shape[1]
    x0 = torch.nan_to_num(torch.floor(px).clamp(0, W - 2))
    y0 = torch.nan_to_num(torch.floor(py).clamp(0, H - 2))
    fx = (px - x0).clamp(0.0, 1.0)
    fy = (py - y0).clamp(0.0, 1.0)
    if image.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    xi, yi = x0.long(), y0.long()
    gray = image.ndim == 2
    top = _lerp(image[yi, xi], image[yi, xi + 1], fx, gray)
    bot = _lerp(image[yi + 1, xi], image[yi + 1, xi + 1], fx, gray)
    return _lerp(top, bot, fy)


def source_map(hw, K, dist, device="cpu"):
    """(px, py) float32 (H, W): where each undistorted pixel samples the
    distorted image."""
    H, W = hw
    (fx, fy, cx, cy), d = _params(K, dist)
    f32 = torch.float32
    u = torch.arange(W, dtype=f32, device=device)[None, :].expand(H, W)
    v = torch.arange(H, dtype=f32, device=device)[:, None].expand(H, W)
    t = {k: torch.tensor(val, dtype=f32, device=device)
         for k, val in (("fx", fx), ("fy", fy), ("cx", cx), ("cy", cy))}
    x = (u - t["cx"]) / t["fx"]
    y = (v - t["cy"]) / t["fy"]
    dx, dy = distort_delta(x, y, d)
    return fma_f32(dx, t["fx"], u), fma_f32(dy, t["fy"], v)


def _check_images(images):
    if images.ndim not in (3, 4):
        raise ValueError("images must be (N, H, W[, C])")
    if images.shape[1] < 2 or images.shape[2] < 2:
        raise ValueError(f"images must be at least 2x2, got "
                         f"{tuple(images.shape[1:3])}")


def undistort_batch(images, K, dist):
    """Undistort a stack of (N, H, W[, C]) images sharing one camera: K 3x3
    intrinsics, dist (k1, k2, p1, p2[, k3]). Integer images come back in
    their dtype, others as float32, on the images' device."""
    _check_images(images)
    if images.device.type == "cpu":
        return undistort_plain(images, K, dist)
    if images.dtype not in _DTYPES:
        raise ValueError(f"undistort: the CUDA kernel takes uint8, uint16 "
                         f"or float32 images, got {images.dtype}")
    kernels.require_cuda("undistort", images)
    (fx, fy, cx, cy), (k1, k2, p1, p2, k3) = _params(K, dist)
    N, H, W = images.shape[:3]
    C = images.shape[3] if images.ndim == 4 else 1
    out = torch.empty_like(images)
    rc = kernels.lib().p3d_undistort(
        images.data_ptr(), out.data_ptr(), N, H, W, C, _DTYPES[images.dtype],
        int(images.ndim == 3), *(float(v) for v in (fx, fy, cx, cy, k1, k2, p1, p2, k3)),
        kernels.stream_ptr(images.device))
    kernels.LAUNCHES["undistort"] += 1
    kernels.check("undistort", rc)
    return out


def undistort(image, K, dist):
    """Undistort one (H, W[, C]) image (see `undistort_batch`)."""
    return undistort_batch(image[None], K, dist)[0]


def undistort_plain(images, K, dist):
    """Plain PyTorch version of the undistort kernel: the same f32
    operations, one image at a time over the shared source map."""
    _check_images(images)
    N, H, W = images.shape[:3]
    px, py = source_map((H, W), K, dist, images.device)
    inside = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
    if images.ndim == 4:
        inside = inside[..., None]
    integer = not (images.dtype.is_floating_point or images.dtype.is_complex)
    out = torch.empty(images.shape, device=images.device,
                      dtype=images.dtype if integer else torch.float32)
    for n in range(N):
        val = torch.where(inside, bilinear_sample(
            images[n].to(torch.float32), px, py), 0.0)
        out[n] = torch.round(val).clamp(0, 255) if integer else val
    return out
