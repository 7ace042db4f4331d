"""Separable filters on volumes, scipy.ndimage-compatible: the gradient and
Gaussian kernels and their plain PyTorch versions.

Port of plant3dvision_tpu/ops/filters.py (np.gradient and
scipy.ndimage.gaussian_filter with mode='reflect', as vol2pcd uses them).
A CUDA tensor goes to kernels/csrc/filters.cu (one launch per axis per
pass), a CPU tensor to the plain version. Both sum the taps in the same
order; XLA's convolution sums in another, so results agree with the JAX
package to float32 rounding (the tests hold them to atol 1e-5).
"""

from __future__ import annotations

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
