"""Geodesic particle tracing with vote accumulation.

Port of plant3dvision_tpu/ops/geodesics.py. Each particle starts at a tip
and steps down the descent field: g = trilinear(flow, pos), new_pos =
clip(pos - step*g, 0, shape - 1.001), val = trilinear(values, new_pos); it
goes on while val is below the previous value and above `step`, and each
step it takes adds one vote at the voxel nearest new_pos (rounded half to
even). On CUDA the hand-written kernel K15 (kernels/csrc/geodesics.cu: a
warp a particle, a lane a channel; each step's value corners loaded with
the next step's flow corners, one round trip a step; int32 atomic votes,
exact in any order); on the CPU `trace_geodesics_plain`.

Arithmetic: XLA's CPU program's float32 operations (its optimized HLO and
x86 code). `_trilinear` takes f = pts - floor(pts) before it clips the
corner to [0, n - 2], so a point past n - 2 extrapolates. Each of the eight
terms is ((g * wx) * wy) * wz; XLA rounds the second term, fuses the first
term's last product into the first add and every later term's last product
into the running sum:
  s = fma(t1_xy, wz1, t2);  s = fma(tk_xy, wzk, s) for k = 3..8
and the step as fma(-step, g, pos). The clip's upper bound is float32(n) -
float32(1.001), as XLA folds it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .carving import fma_f32

#: the eight corners in JAX's term order
_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
            (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def upper_bounds(shape) -> np.ndarray:
    """The clip's upper bound per axis, float32(n) - float32(1.001)."""
    return np.asarray(shape, np.float32) - np.float32(1.001)


def _trilinear(vol, pts):
    """Trilinear sample of an (nx, ny, nz[, C]) volume at (N, 3) float32
    points, in XLA's arithmetic."""
    shape = vol.shape[:3]
    p0 = torch.floor(pts).to(torch.int64)
    f = pts - p0.to(torch.float32)
    hi = torch.tensor([s - 2 for s in shape], device=pts.device)
    p0 = torch.minimum(p0.clamp(min=0), hi)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    if vol.ndim == 4:
        fx, fy, fz = fx[:, None], fy[:, None], fz[:, None]
    w = {0: (1 - fx, 1 - fy, 1 - fz), 1: (fx, fy, fz)}
    terms = []
    for dx, dy, dz in _CORNERS:
        g = vol[p0[:, 0] + dx, p0[:, 1] + dy, p0[:, 2] + dz]
        terms.append(((g * w[dx][0]) * w[dy][1], w[dz][2]))
    s = fma_f32(terms[0][0], terms[0][1], terms[1][0] * terms[1][1])
    for t_xy, wz in terms[2:]:
        s = fma_f32(t_xy, wz, s)
    return s


def _check(flow, values, tips):
    if values.ndim != 3 or values.dtype != torch.float32:
        raise ValueError("values must be (nx, ny, nz) float32")
    if tuple(flow.shape) != tuple(values.shape) + (3,) \
            or flow.dtype != torch.float32:
        raise ValueError("flow must be (nx, ny, nz, 3) float32")
    if tips.ndim != 2 or tips.shape[1] != 3:
        raise ValueError("tips must be (N, 3)")
    if min(values.shape) < 2:
        raise ValueError("the grid needs at least 2 voxels along each axis")


def trace_geodesics(flow, values, tips, step: float = 0.5,
                    n_steps: int = 2000):
    """Trace particles from `tips` down `flow`, voting along the way.

    flow (nx, ny, nz, 3) float32 descent field, values (nx, ny, nz) float32
    distance map, tips (N, 3) start points in index coordinates, all on one
    device. Returns the int32 (nx, ny, nz) votes. CUDA tensors go to K15
    (which reads the volumes in C order: others are copied into it first),
    CPU tensors to `trace_geodesics_plain`."""
    tips = torch.as_tensor(tips, device=values.device).to(torch.float32)
    _check(flow, values, tips)
    if values.device.type == "cpu":
        return trace_geodesics_plain(flow, values, tips, step, n_steps)
    flow, values, tips = (t.contiguous() for t in (flow, values, tips))
    kernels.require_cuda("trace_geodesics", flow, values, tips)
    nx, ny, nz = (int(s) for s in values.shape)
    votes = torch.zeros((nx, ny, nz), dtype=torch.int32, device=values.device)
    bx, by, bz = (float(b) for b in upper_bounds(values.shape))
    rc = kernels.lib().p3d_trace_geodesics(
        flow.data_ptr(), values.data_ptr(), tips.data_ptr(), tips.shape[0],
        nx, ny, nz, float(np.float32(step)), int(n_steps), bx, by, bz,
        votes.data_ptr(), kernels.stream_ptr(values.device))
    kernels.LAUNCHES["trace_geodesics"] += 1
    kernels.check("trace_geodesics", rc)
    return votes


def trace_geodesics_plain(flow, values, tips, step: float = 0.5,
                          n_steps: int = 2000, return_steps: bool = False):
    """Plain PyTorch version of K15: every particle steps together; the
    loop ends early once no particle is left (later steps change
    nothing). return_steps: also the (N,) int64 steps each particle
    evaluated (its votes, and the step that stopped it)."""
    tips = torch.as_tensor(tips, device=values.device).to(torch.float32)
    _check(flow, values, tips)
    dev = values.device
    shape = tuple(values.shape)
    step32 = torch.tensor(np.float32(step), device=dev)
    bound = torch.from_numpy(upper_bounds(shape)).to(dev)
    votes = torch.zeros(values.numel(), dtype=torch.int32, device=dev)
    pos = tips.clone()
    alive = torch.ones(len(tips), dtype=torch.bool, device=dev)
    prev = torch.full((len(tips),), 1e10, dtype=torch.float32, device=dev)
    strides = torch.tensor([shape[1] * shape[2], shape[2], 1], device=dev)
    steps = torch.zeros(len(tips), dtype=torch.int64, device=dev)
    for s in range(int(n_steps)):
        steps += alive
        g = _trilinear(flow, pos)
        new_pos = torch.minimum(
            fma_f32(-step32, g, pos).clamp(min=0.0), bound)
        val = _trilinear(values, new_pos)
        still = alive & (val < prev) & (val > step32)
        lin = (torch.round(new_pos[still]).to(torch.int64) * strides).sum(1)
        votes.index_add_(0, lin, torch.ones_like(lin, dtype=torch.int32))
        pos = torch.where(still[:, None], new_pos, pos)
        alive, prev = still, val
        if s % 64 == 63 and not bool(alive.any()):
            break
    votes = votes.reshape(shape)
    return (votes, steps) if return_steps else votes
