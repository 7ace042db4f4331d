"""Separable filters on volumes, scipy.ndimage-compatible: the gradient and
Gaussian kernels and their plain PyTorch versions.

Port of plant3dvision_tpu/ops/filters.py (np.gradient and
scipy.ndimage.gaussian_filter with mode='reflect', as vol2pcd uses them).
`smoothed_gradient` (vol2pcd's three Gaussian-smoothed gradients) is one
fused launch on a CUDA tensor (kernels/csrc/filters.cu); `gradient` and
`gaussian_filter` alone are one launch per axis. A CPU tensor goes to the
plain versions. Kernels and plain versions sum the taps in the same order
with the same roundings and agree bit for bit; XLA's convolution sums in
another order, so results agree with the JAX package to float32 rounding
(the tests hold them to atol 1e-5).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Identical to scipy.ndimage._gaussian_kernel1d (order 0)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return phi / phi.sum()


def _symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Source index of each position of [-r, n + r) under scipy 'reflect'
    (= numpy 'symmetric') extension."""
    q = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(q < n, q, 2 * n - 1 - q)


@functools.lru_cache(maxsize=16)
def _reflect_tables(shape, r, device):
    """`_symmetric_index` of a volume's three axes back to back, int32 on
    the card: the tables the fused kernel reads (kept, as a pass calls it
    on one shape several times)."""
    return torch.cat([_symmetric_index(n, r, device) for n in shape]).to(
        torch.int32)


def _conv1d_along_plain(x, taps, axis):
    r = (len(taps) - 1) // 2
    n = x.shape[axis]
    xp = x.index_select(axis, _symmetric_index(n, r, x.device))
    acc = torch.zeros_like(x)
    for t, w in enumerate(taps):
        acc = acc + torch.tensor(w, dtype=x.dtype, device=x.device) * \
            xp.narrow(axis, t, n)
    return acc


def gaussian_filter(x, sigma: float = 1.0, truncate: float = 4.0):
    """scipy.ndimage.gaussian_filter equivalent (mode='reflect')."""
    x = torch.as_tensor(x)
    if x.device.type == "cpu":
        return gaussian_filter_plain(x, sigma, truncate)
    taps = gaussian_kernel1d(sigma, truncate).astype(np.float32)
    x = x.contiguous()
    kernels.require_volume("gaussian_filter", x)
    nx, ny, nz = x.shape
    r = (len(taps) - 1) // 2
    host_taps = np.ascontiguousarray(taps)
    so = kernels.lib()
    stream = kernels.stream_ptr(x.device)
    for axis in range(3):
        y = torch.empty_like(x)
        rc = so.p3d_gauss(x.data_ptr(), y.data_ptr(), nx, ny, nz, axis,
                          host_taps.ctypes.data, r, stream)
        kernels.LAUNCHES["gradient_gaussian"] += 1
        kernels.check("gradient_gaussian", rc)
        x = y
    return x


def gradient(x):
    """np.gradient equivalent: central differences interior, one-sided
    edges. Returns a list of tensors, one per axis."""
    x = torch.as_tensor(x)
    if x.device.type == "cpu":
        return gradient_plain(x)
    x = x.contiguous()
    kernels.require_volume("gradient", x)
    if min(x.shape) < 2:
        raise ValueError("gradient needs at least 2 samples per axis")
    nx, ny, nz = x.shape
    so = kernels.lib()
    stream = kernels.stream_ptr(x.device)
    outs = []
    for axis in range(3):
        g = torch.empty_like(x)
        rc = so.p3d_gradient(x.data_ptr(), g.data_ptr(), nx, ny, nz, axis,
                             stream)
        kernels.LAUNCHES["gradient_gaussian"] += 1
        kernels.check("gradient_gaussian", rc)
        outs.append(g)
    return outs


#: the one Gaussian radius the fused kernel takes (0.875 <= sigma < 1.125:
#: vol2pcd's sigma 1)
FUSED_RADIUS = 4


def smoothed_gradient(dist, sigma: float = 1.0):
    """The three np.gradient components of a (nx, ny, nz) volume, each
    Gaussian-filtered (scipy 'reflect', truncate 4): vol2pcd's normals.
    One fused launch on a CUDA tensor (counted under "gradient_gaussian");
    on a CPU tensor the plain composition, which the kernel equals bit for
    bit. The kernel takes sigmas of Gaussian radius FUSED_RADIUS only."""
    dist = torch.as_tensor(dist)
    if dist.device.type == "cpu":
        return [gaussian_filter_plain(g, sigma) for g in gradient_plain(dist)]
    dist = dist.contiguous()
    kernels.require_volume("smoothed_gradient", dist)
    if min(dist.shape) < 2:
        raise ValueError("gradient needs at least 2 samples per axis")
    if dist.numel() >= 2 ** 31:
        raise ValueError("smoothed_gradient: the CUDA kernel takes fewer "
                         "than 2^31 voxels")
    taps = np.ascontiguousarray(gaussian_kernel1d(sigma), np.float32)
    r = (len(taps) - 1) // 2
    if r != FUSED_RADIUS:
        raise ValueError(f"smoothed_gradient: the CUDA kernel takes a "
                         f"Gaussian radius of {FUSED_RADIUS} only, got {r} "
                         f"(sigma {sigma})")
    nx, ny, nz = dist.shape
    tabs = _reflect_tables((nx, ny, nz), r, dist.device)
    g = dist.new_empty((3, nx, ny, nz))
    rc = kernels.lib().p3d_smoothed_gradient(
        dist.data_ptr(), g[0].data_ptr(), g[1].data_ptr(), g[2].data_ptr(),
        nx, ny, nz, tabs.data_ptr(), taps.ctypes.data, r,
        kernels.stream_ptr(dist.device))
    kernels.LAUNCHES["gradient_gaussian"] += 1
    kernels.check("gradient_gaussian", rc)
    return list(g)


def gaussian_filter_plain(x, sigma: float = 1.0, truncate: float = 4.0):
    """Plain PyTorch version of the Gaussian kernel (any device, any ndim)."""
    taps = gaussian_kernel1d(sigma, truncate).astype(np.float32)
    for axis in range(x.ndim):
        x = _conv1d_along_plain(x, taps, axis)
    return x


def gradient_plain(x):
    """Plain PyTorch version of the gradient kernel (any device, any ndim)."""
    outs = []
    for axis in range(x.ndim):
        xm = x.movedim(axis, 0)
        interior = (xm[2:] - xm[:-2]) * 0.5
        first = (xm[1] - xm[0])[None]
        last = (xm[-1] - xm[-2])[None]
        g = torch.cat([first, interior, last], dim=0)
        outs.append(g.movedim(0, axis).contiguous())
    return outs
