"""K15's loop (kernels/csrc/geodesics.cu), modelled on the CPU.

The kernel loads, each step, the value corners of the new position
together with that position's flow corners, and samples both there (a
lane a channel, each channel's sum in JAX's order): the value for this
step's test, the flow for the next step. One round trip to memory a step.
That is exact because a particle that goes on moves to the new position,
whose corner is then the next step's flow corner. The kernel has no CPU
mode, so its loop is written here in torch (the flow sample and its
corner carried from step to step, the four channels summed alike) and
replayed on
tests/test_torch_eikonal.py's scenes, from the flow's leaves, tips on the
grid's faces and tips past n - 2 (whose samples extrapolate): at every
step the carried corner equals the one the plain walk reads at the
particle's position, and the votes, steps and longest walk equal the
plain version's, the votes JAX's.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

from plant3dvision_tpu.ops import geodesics as JG

from plant3dvision_tpu_torch.ops import eikonal as PE
from plant3dvision_tpu_torch.ops import geodesics as PG
from plant3dvision_tpu_torch.ops.carving import fma_f32

torch.set_num_threads(1)

#: the eight corners in JAX's term order
_D = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
      (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def _blob(shape, seed, n=12):
    """tests/test_torch_eikonal.py's blob: spheres of radius 3-8, seeded
    on their lowest z plane."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"),
                 -1).astype(np.float32)
    mask = np.zeros(shape, bool)
    for c in rng.uniform(0, 1, (n, 3)) * np.array(shape):
        r = rng.uniform(3, 8)
        mask |= ((g - c) ** 2).sum(-1) < r * r
    seeds = np.zeros_like(mask)
    z0 = np.nonzero(mask.any((0, 1)))[0].min()
    seeds[:, :, z0] = mask[:, :, z0]
    return mask, seeds


def _scene(name):
    if name == "tube":
        mask = np.zeros((8, 8, 40), bool)
        mask[3:5, 3:5, :] = True
        seeds = np.zeros_like(mask)
        seeds[3:5, 3:5, 0] = True
    elif name == "l_bend":
        mask = np.zeros((30, 5, 30), bool)
        mask[:, 2, 2] = True
        mask[27, 2, 2:28] = True
        seeds = np.zeros_like(mask)
        seeds[0, 2, 2] = True
    elif name == "long_tube":               # walks of 150+ steps
        mask = np.zeros((12, 12, 120), bool)
        mask[4:8, 4:8, :] = True
        seeds = np.zeros_like(mask)
        seeds[4:8, 4:8, 0] = True
    else:
        mask, seeds = _blob((32, 32, 48), int(name[-1]))
    return mask, seeds


def _tips(mask, d, rng):
    """The distance's local maxima and jittered copies, a tip on each of
    the grid's six faces and at its far corner, and tips past n - 2."""
    dn = np.where(mask & (d < 1e9), d, -1)
    tips = np.argwhere((dn == ndi.maximum_filter(dn, size=3)) & (dn > 2))
    tips = np.concatenate([tips, tips + rng.uniform(-0.4, 0.4, tips.shape)])
    n = np.array(mask.shape, np.float32)
    inner = np.argwhere(mask)[len(np.argwhere(mask)) // 2].astype(np.float32)
    faces = []
    for a in range(3):
        for v in (0.0, n[a] - 1.001, n[a] - 1.5, n[a] - 1.0 + 0.25):
            t = inner.copy()
            t[a] = v
            faces.append(t)
    faces += [n - 1.001, n - 1.2, np.zeros(3, np.float32)]
    return np.concatenate([tips, faces]).astype(np.float32)


def _inputs(name):
    mask, seeds = _scene(name)
    m = torch.from_numpy(mask)
    d = PE.geodesic_distance(m, torch.from_numpy(seeds))
    flow = PE.gradient_flow(d, m)
    values = torch.where(m, d, 0.0)
    tips = torch.from_numpy(_tips(mask, d.numpy(), np.random.default_rng(2)))
    return flow, values, tips


def _corner(pts, shape):
    """(clipped corner, fractions), as the kernel's `corner`."""
    p0 = torch.floor(pts)
    hi = torch.tensor([s - 2 for s in shape])
    return torch.minimum(p0.to(torch.int64).clamp(min=0), hi), pts - p0


def _gather8(vol, c):
    """The kernel's gather8: vol at the corner's 8 neighbours, (N, 8[, C])."""
    return torch.stack([vol[c[:, 0] + dx, c[:, 1] + dy, c[:, 2] + dz]
                        for dx, dy, dz in _D], 1)


def _combine(raw, f):
    """The kernel's combine: the trilinear sum of raw (N, 8[, C]) at
    fractions f, in JAX's term order and XLA's contractions."""
    w = {0: 1 - f, 1: f}
    if raw.ndim == 3:
        w = {k: v[:, None, :] for k, v in w.items()}
        raw = raw.transpose(1, 2)                        # (N, C, 8)
        terms = [((raw[..., t] * w[dx][..., 0]) * w[dy][..., 1],
                  w[dz][..., 2]) for t, (dx, dy, dz) in enumerate(_D)]
    else:
        terms = [((raw[:, t] * w[dx][:, 0]) * w[dy][:, 1], w[dz][:, 2])
                 for t, (dx, dy, dz) in enumerate(_D)]
    s = fma_f32(terms[0][0], terms[0][1], terms[1][0] * terms[1][1])
    for t_xy, wz in terms[2:]:
        s = fma_f32(t_xy, wz, s)
    return s


def kernel_loop(flow, values, tips, step=0.5, n_steps=2000, check=None):
    """K15's loop over all particles at once: the flow sample carried from
    the step before (taken at the corner it carries), the new position's
    value and flow corners gathered together and both sampled there.
    check(corner, pos, live) sees the carried corner and the position
    before each step. Returns the votes and each particle's steps."""
    shape = tuple(values.shape)
    N = len(tips)
    step32 = torch.tensor(np.float32(step))
    bound = torch.from_numpy(PG.upper_bounds(shape))
    strides = torch.tensor([shape[1] * shape[2], shape[2], 1])
    votes = torch.zeros(values.numel(), dtype=torch.int32)
    pos = tips.clone()
    c, f = _corner(pos, shape)
    g = _combine(_gather8(flow, c), f)
    prev = torch.full((N,), 1e10, dtype=torch.float32)
    alive = torch.ones(N, dtype=torch.bool)
    steps = torch.zeros(N, dtype=torch.int64)
    for _ in range(int(n_steps)):
        if not bool(alive.any()):
            break
        if check is not None:
            check(c, pos, alive)
        steps += alive
        new = torch.minimum(fma_f32(-step32, g, pos).clamp(min=0.0), bound)
        cn, fn = _corner(new, shape)
        val = _combine(_gather8(values, cn), fn)
        gn = _combine(_gather8(flow, cn), fn)
        still = alive & (val < prev) & (val > step32)
        lin = (torch.round(new[still]).to(torch.int64) * strides).sum(1)
        votes.index_add_(0, lin, torch.ones_like(lin, dtype=torch.int32))
        # the kernel's registers move on for the particles that go on
        keep = still[:, None]
        pos = torch.where(keep, new, pos)
        c = torch.where(keep, cn, c)
        g = torch.where(keep, gn, g)
        alive, prev = still, torch.where(still, val, prev)
    return votes.reshape(shape), steps


@pytest.mark.parametrize("name", ["tube", "l_bend", "long_tube", "blob0",
                                  "blob2"])
def test_kernel_loop_equals_plain_and_jax(name):
    flow, values, tips = _inputs(name)
    shape = tuple(values.shape)
    seen = {"reads": 0}

    def check(c, pos, live):
        want, _ = _corner(pos[live], shape)
        assert torch.equal(c[live], want)
        seen["reads"] += int(live.sum())

    votes, steps = kernel_loop(flow, values, tips, check=check)
    want, psteps = PG.trace_geodesics_plain(flow, values, tips, 0.5, 2000,
                                            return_steps=True)
    assert torch.equal(votes, want)
    assert torch.equal(steps, psteps) and seen["reads"] == int(steps.sum())
    ref = np.asarray(JG.trace_geodesics(
        jnp.asarray(flow.numpy()), jnp.asarray(values.numpy()),
        jnp.asarray(tips.numpy()), step=0.5, n_steps=2000))
    np.testing.assert_array_equal(votes.numpy(), ref)
    if name == "long_tube":
        assert int(steps.max()) > 150


@pytest.mark.parametrize("n_steps", [0, 1, 7])
def test_kernel_loop_with_few_steps(n_steps):
    """No steps: no votes; a walk cut at 1 and 7 steps: the plain
    version's votes and steps."""
    flow, values, tips = _inputs("tube")
    votes, steps = kernel_loop(flow, values, tips, n_steps=n_steps)
    want, psteps = PG.trace_geodesics_plain(flow, values, tips, 0.5, n_steps,
                                            return_steps=True)
    assert torch.equal(votes, want) and torch.equal(steps, psteps)
    assert int(steps.max()) == n_steps
