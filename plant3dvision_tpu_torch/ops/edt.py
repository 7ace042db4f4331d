"""Euclidean distance transforms: the signed-distance kernel and its plain
PyTorch version.

Port of plant3dvision_tpu/ops/edt.py with the same semantics:

- `squared_edt(x, cap)` — the separable squared EDT where each 1-D pass is
  a *windowed min-plus* over parabola shifts: F'[i] = min_s F[i+s] + s^2,
  |s| <= cap. Exact for every voxel whose true distance is <= cap, >= cap
  elsewhere — which is what vol2pcd needs (it only reads a thin band
  around the surface). cap=None uses the full axis length.
- `edt(x, cap)` — sqrt of the above.
- `signed_distance(volume, cap)` — the reference recipe
  (reference proc3d.py:518-522): inside and outside distances combined as
  where(dist > 0.5, dist - 0.5, -mdist + 0.5).

A CUDA tensor goes to kernels/csrc/edt.cu, two launches a call: the
first axis by a march along x, then the other two fused in one launch,
in one of two lanes chosen by range (`lane16`): both channels as int16
halves of a 32-bit word, or the float32 pair. A CPU tensor goes to the
plain version. All finite values are integers below 2^24, so both are
bit-equal to the JAX package.
"""

from __future__ import annotations

import torch

from .. import kernels

_INF = 1e12
#: the 16-bit lane's INF (kernels/csrc/edt.cu kSent16): every finite value
#: of the lane is below it, and it plus any shift^2 stays below 2^15
SENTINEL16 = 16384


def axis_caps(shape, cap):
    """The window of each axis: min(cap, n - 1) (n - 1 for cap None), as
    `_minplus_pass` cuts it."""
    return [max(0, min(n - 1 if cap is None else int(cap), n - 1))
            for n in shape]


def lane16(caps) -> bool:
    """The 16-bit lane holds a grid whose largest finite value, the sum of
    the squared caps, is below its sentinel."""
    return sum(c * c for c in caps) < SENTINEL16


def _edt_cuda(v, cap, signed):
    """Both launches of K2 on a 3-D float32 CUDA volume: the signed
    distance of `v > 0.5` (signed) or the squared EDT of `v != 0`."""
    name = "signed_distance" if signed else "squared_edt"
    c0, c1, c2 = axis_caps(v.shape, cap)
    kernels.require_volume(name, v)
    nx, ny, nz = v.shape
    wide = int(not lane16((c0, c1, c2)))
    words = (torch.empty((nx, ny, nz, 2), dtype=torch.float32, device=v.device)
             if wide else torch.empty(v.shape, dtype=torch.int32,
                                      device=v.device))
    out = torch.empty_like(v)
    so, stream = kernels.lib(), kernels.stream_ptr(v.device)
    # a z row too long for shared memory: the y pass's rows go through here
    spill = torch.empty_like(words) if so.p3d_edt_yz_spills(nz, wide) else None
    rc = so.p3d_edt_x(v.data_ptr(), words.data_ptr(), nx, ny, nz, c0,
                      int(not signed), wide, stream)
    kernels.LAUNCHES["signed_distance"] += 1
    kernels.check("signed_distance", rc)
    rc = so.p3d_edt_yz(words.data_ptr(), out.data_ptr(),
                       None if spill is None else spill.data_ptr(), nx, ny,
                       nz, c1, c2, int(not signed), wide, stream)
    kernels.LAUNCHES["signed_distance"] += 1
    kernels.check("signed_distance", rc)
    return out


def _minplus_pass(f, axis: int, cap: int):
    """Plain version of one 1-D windowed min-plus parabola pass."""
    n = f.shape[axis]
    cap = min(cap, n - 1)
    out = f.clone()
    for s in range(1, cap + 1):
        s2 = torch.tensor(float(s * s), dtype=f.dtype, device=f.device)
        lo = f.narrow(axis, s, n - s)          # f[i + s] for i < n - s
        hi = f.narrow(axis, 0, n - s)          # f[i - s] for i >= s
        up = out.narrow(axis, 0, n - s)
        torch.minimum(up, lo + s2, out=up)
        down = out.narrow(axis, s, n - s)
        torch.minimum(down, hi + s2, out=down)
    return out


def squared_edt(x, cap: int | None = None):
    """Squared Euclidean distance to the nearest zero of `x` (float32),
    exact wherever the true distance <= cap."""
    x = torch.as_tensor(x)
    if x.device.type == "cpu":
        return squared_edt_plain(x, cap)
    return _edt_cuda(x.to(torch.float32).contiguous(), cap, signed=False)


def squared_edt_plain(x, cap: int | None = None):
    """Plain PyTorch version of the squared-EDT kernel (any device, any
    ndim)."""
    f = torch.where(torch.as_tensor(x) != 0, _INF, 0.0).to(torch.float32)
    for axis in range(f.ndim):
        c = f.shape[axis] - 1 if cap is None else cap
        f = _minplus_pass(f, axis, c)
    return f


def edt(x, cap: int | None = None):
    return torch.sqrt(torch.clamp(squared_edt(x, cap), max=_INF))


def signed_distance(volume, cap: int | None = 16):
    """Signed distance of the `volume > 0.5` set (see module docstring):
    positive inside, negative outside, zero half a voxel out."""
    volume = torch.as_tensor(volume)
    if volume.device.type == "cpu":
        return signed_distance_plain(volume, cap)
    return _edt_cuda(volume.to(torch.float32).contiguous(), cap,
                     signed=True)


def signed_distance_plain(volume, cap: int | None = 16):
    """Plain PyTorch version of the signed-distance kernel (any device)."""
    binary = torch.as_tensor(volume) > 0.5
    dist = torch.sqrt(torch.clamp(
        squared_edt_plain(binary.to(torch.float32), cap), max=_INF))
    mdist = torch.sqrt(torch.clamp(
        squared_edt_plain((~binary).to(torch.float32), cap), max=_INF))
    return torch.where(dist > 0.5, dist - 0.5, -mdist + 0.5)
