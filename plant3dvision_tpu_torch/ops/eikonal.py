"""Geodesic distance in a voxel mask (the eikonal solve of the "fim" curve
skeleton) and its normalised descent field.

Port of plant3dvision_tpu/ops/eikonal.py. `geodesic_distance` runs dense
Jacobi sweeps of the 3-D Godunov upwind update (h = 1) inside the mask from
zero-distance seeds, until the first sweep whose largest finite |du| is at
most `tol`, or `max_iters` sweeps. On CUDA the whole loop is the
hand-written kernel K14 (kernels/csrc/eikonal.cu: one cooperative launch a
solve over the compacted active voxels, `compact_neighbors`, one grid
barrier a sweep; one host read, the sweep count); on the CPU
`geodesic_distance_plain`, the same loop in torch ops with one host read
per sweep. `gradient_flow` is torch ops on every device.

Arithmetic: the float32 operations of XLA's CPU program, in its order and
with its fused multiply-adds (read off its optimized HLO and x86 code, the
same in its 8-wide vector loop and its scalar peel and tail):
  mid   = (((a + b) + c) - lo) - hi     (cancels to 0 when one of a, b, c is
                                         INF = 1e10 and two are finite: a
                                         flaw of the reference, repeated)
  d2    = fma(-(lo - mid), lo - mid, (2f)f)
  sumsq = fma(hi, hi, fma(lo, lo, mid*mid))
  d3    = fma(s3, s3, (sumsq - f*f) * -3)
  u2    = (s2 + sqrt(d2)) * 0.5;  u3 = (s3 + sqrt(d3)) * float32(1/3)
(XLA turns the division by 3 into a product by 0.333333343.)
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .carving import fma_f32

INF = 1e10
#: a value below this counts as reached (the stop test's "finite")
FINITE = 5e9
_THIRD = float(np.float32(1.0) / np.float32(3.0))
#: the compact neighbour table's entries for a neighbour that is not an
#: active voxel: outside the mask or past the grid's edge (INF), a seed (0)
NB_INF = -1
NB_ZERO = -2


def sqrt_f32(x):
    """Correctly rounded float32 square root on every device (PyTorch's
    CPU sqrt of float32 is not: it gave 1.4142016 for sqrt(1.9999664),
    IEEE 1.4142017). The float64 root of a float32 rounds correctly."""
    return torch.sqrt(x.double()).float()


def _neighbor_index(active, shape):
    """For the active voxels' flat indices, the flat indices of their two
    neighbours along each axis, (M, 6): (x-1, x+1, y-1, y+1, z-1, z+1);
    past the grid's edges the index of an INF slot appended after the
    grid (flat index nx*ny*nz)."""
    nx, ny, nz = shape
    n = nx * ny * nz
    x, y, z = active // (ny * nz), (active // nz) % ny, active % nz
    cols = []
    for c, size, stride in ((x, nx, ny * nz), (y, ny, nz), (z, nz, 1)):
        cols.append(torch.where(c > 0, active - stride, n))
        cols.append(torch.where(c < size - 1, active + stride, n))
    return torch.stack(cols, dim=1)


def _godunov_update(u, a, b, c, f):
    """The Godunov upwind update of values u from their smaller axis
    neighbours a, b, c (speed_inv f), in XLA's arithmetic."""
    lo = torch.minimum(torch.minimum(a, b), c)
    hi = torch.maximum(torch.maximum(a, b), c)
    mid = (((a + b) + c) - lo) - hi
    u1 = lo + f
    s2 = lo + mid
    dm = lo - mid
    d2 = fma_f32(-dm, dm, (f * 2.0) * f)
    u2 = torch.where(d2 > 0, (s2 + sqrt_f32(d2.clamp(min=0.0))) * 0.5, INF)
    s3 = s2 + hi
    sumsq = fma_f32(hi, hi, fma_f32(lo, lo, mid * mid))
    d3 = fma_f32(s3, s3, (sumsq - f * f) * -3.0)
    u3 = torch.where(d3 > 0, (s3 + sqrt_f32(d3.clamp(min=0.0))) * _THIRD,
                     INF)
    cand = torch.where(u1 <= mid, u1, torch.where(u2 <= hi, u2, u3))
    return torch.minimum(u, cand)


def _inputs(mask, seeds, speed):
    mask = torch.as_tensor(mask)
    if not torch.is_tensor(seeds):
        seeds = torch.as_tensor(seeds, device=mask.device)
    if mask.ndim != 3 or seeds.shape != mask.shape:
        raise ValueError("mask and seeds must be (nx, ny, nz) of one shape")
    if mask.dtype != torch.bool or seeds.dtype != torch.bool:
        raise ValueError("mask and seeds must be bool")
    if speed is not None:
        if not torch.is_tensor(speed):
            speed = torch.as_tensor(speed, device=mask.device)
        if speed.shape != mask.shape:
            raise ValueError("speed must have the mask's shape")
        speed = speed.to(torch.float32)
    return mask, seeds, speed


def speed_inverse(speed):
    """1 / max(speed, 1e-6) in float32, an IEEE division on every device."""
    s = torch.maximum(speed, torch.tensor(np.float32(1e-6),
                                          device=speed.device))
    return torch.ones_like(s) / s


def compact_neighbors(mask, seeds):
    """The compacted active set of a solve: the C-order flat indices
    (int64, M) of mask & ~seeds and, for each, an int32 row of its 6
    neighbours (x-1, x+1, y-1, y+1, z-1, z+1), (M, 6): the neighbour's
    compact index, NB_INF outside the mask or past the grid's edge, NB_ZERO
    on a seed in the mask. (torch ops; the nonzero reads M on the host.)"""
    fixed = (seeds & mask).reshape(-1)
    active = torch.nonzero(mask.reshape(-1) & ~fixed)[:, 0]
    m, n = len(active), fixed.numel()
    nbr = _neighbor_index(active, tuple(int(s) for s in mask.shape))
    inside = nbr < n
    pos = torch.searchsorted(active, nbr).clamp(max=max(m - 1, 0))
    hit = inside & (active[pos] == nbr) if m else inside & False
    seed = inside & fixed[nbr.clamp(max=n - 1)]
    table = torch.where(hit, pos, torch.where(seed, NB_ZERO, NB_INF))
    return active, table.to(torch.int32)


def geodesic_distance(mask, seeds, speed=None, max_iters: int = 10000,
                      tol: float = 1e-3, return_sweeps: bool = False):
    """Geodesic distance from the seed voxels through the mask.

    mask, seeds: (nx, ny, nz) bool tensors on one device; speed: optional
    (nx, ny, nz) speeds (default 1). Returns the float32 distances (INF =
    1e10 outside the mask and where unreached), and with `return_sweeps`
    also the number of sweeps applied. CUDA tensors go to K14, CPU tensors
    to `geodesic_distance_plain`."""
    mask, seeds, speed = _inputs(mask, seeds, speed)
    if mask.device.type == "cpu":
        return geodesic_distance_plain(mask, seeds, speed, max_iters, tol,
                                       return_sweeps)
    tensors = [mask, seeds] + ([speed] if speed is not None else [])
    kernels.require_cuda("eikonal_sweep", *tensors)
    dev = mask.device
    u = torch.where(seeds & mask, 0.0, INF).to(torch.float32)
    active, table = compact_neighbors(mask, seeds)
    m = len(active)
    tol32 = np.float32(tol)
    if not m:
        # every sweep leaves the field as it is, with |du| = 0
        n = min(int(max_iters), 1)
    elif int(max_iters) <= 0 or not np.float32(2 * tol32) > tol32:
        n = 0
    else:
        nbr = table.t().contiguous()
        f = (speed_inverse(speed).reshape(-1)[active].contiguous()
             if speed is not None else None)
        fp = f.data_ptr() if f is not None else None
        sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
        bufs = torch.full((2, m), INF, dtype=torch.float32, device=dev)
        ctl = torch.zeros(3, dtype=torch.int32, device=dev)
        rc = kernels.lib().p3d_eikonal_grid(
            nbr.data_ptr(), m, fp, active.data_ptr(), u.data_ptr(),
            bufs[0].data_ptr(), bufs[1].data_ptr(), ctl.data_ptr(),
            int(max_iters), float(tol32), sweeps.data_ptr(),
            kernels.stream_ptr(dev))
        kernels.LAUNCHES["eikonal_sweep"] += 1
        kernels.check("eikonal_sweep", rc)
        n = int(sweeps.item())
    return (u, n) if return_sweeps else u


def geodesic_distance_plain(mask, seeds, speed=None, max_iters: int = 10000,
                            tol: float = 1e-3, return_sweeps: bool = False):
    """Plain PyTorch version of K14: the JAX while-loop, one host read of
    the sweep's largest finite |du| per sweep.

    JAX updates the whole grid; outside the mask a sweep writes INF and on
    the seeds 0, the values they start with, so only the other voxels of
    the mask (gathered once, with their neighbours' flat indices) are
    updated here: the same values, at the cost of the mask's size."""
    mask, seeds, speed = _inputs(mask, seeds, speed)
    dev = mask.device
    fixed = seeds & mask
    u0 = torch.where(fixed, 0.0, INF).to(torch.float32)
    active = torch.nonzero((mask & ~fixed).reshape(-1))[:, 0]
    nbr = _neighbor_index(active, tuple(mask.shape))
    f = (speed_inverse(speed).reshape(-1)[active] if speed is not None
         else torch.tensor(1.0, dtype=torch.float32, device=dev))
    u = torch.cat([u0.reshape(-1), torch.full((1,), INF, device=dev)])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tol32 = np.float32(tol)
    it, delta = 0, np.float32(2 * tol)
    while it < max_iters and delta > tol32 and len(active):
        nb = u[nbr]
        old = u[active]
        new = _godunov_update(old, torch.minimum(nb[:, 0], nb[:, 1]),
                              torch.minimum(nb[:, 2], nb[:, 3]),
                              torch.minimum(nb[:, 4], nb[:, 5]), f)
        u = u.index_put((active,), new)
        step = torch.where(new < FINITE, (old - new).abs(), zero)
        delta = np.float32(step.max().item())
        it += 1
    if not len(active):
        # every sweep leaves the field as it is, with |du| = 0
        it = min(int(max_iters), 1)
    u = u[:-1].reshape(mask.shape)
    return (u, it) if return_sweeps else u


def gradient_flow(distance, mask):
    """Normalised mask-aware gradient of the distance map, (nx, ny, nz, 3)
    float32 (zero outside the mask): per axis the mean of the in-mask
    forward and backward differences (torch ops on every device)."""
    mask = torch.as_tensor(mask)
    distance = torch.as_tensor(distance, device=mask.device)
    d = torch.where(mask, distance, 0.0).to(torch.float32)
    comps = []
    for axis in range(3):
        n = d.shape[axis]
        idx = torch.arange(n, device=d.device).view(
            [-1 if i == axis else 1 for i in range(3)])
        fwd_d = torch.roll(d, -1, axis) - d
        bwd_d = d - torch.roll(d, 1, axis)
        fwd_ok = mask & torch.roll(mask, -1, axis) & (idx < n - 1)
        bwd_ok = mask & torch.roll(mask, 1, axis) & (idx > 0)
        num = (torch.where(fwd_ok, fwd_d, 0.0)
               + torch.where(bwd_ok, bwd_d, 0.0))
        den = fwd_ok.to(torch.float32) + bwd_ok.to(torch.float32)
        comps.append(num / den.clamp(min=1.0))
    g = torch.stack(comps, dim=-1)
    norm = sqrt_f32(fma_f32(g[..., 2:], g[..., 2:], fma_f32(
        g[..., 1:2], g[..., 1:2], g[..., :1] * g[..., :1])))
    return torch.where(mask[..., None], g / norm.clamp(min=1e-9), 0.0)
