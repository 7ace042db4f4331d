"""Host-side pieces of K12 (ray coverage) and the one-image mask call, on
the CPU: what the kernels' exactness rests on.

- The step's quotient: at a power-of-two voxel size the kernel multiplies
  by the reciprocal, which must round every value as the division does.
- The walk's range: the kernel skips the steps that lie before or past the
  alive voxels' box, which is exact only because each step's voxel index
  moves monotonically along every axis as the step grows.
- The grid box and the mask lane are cached by their arguments and must
  equal what they were computed as before.
"""

import numpy as np
import pytest
import torch

from plant3dvision_tpu_torch.ops import masks, selfcal
from plant3dvision_tpu_torch.ops.carving import fma_f32


@pytest.mark.parametrize("vs,exact", [
    (1.0, True), (2.0, True), (4.0, True), (0.5, True), (0.25, True),
    (1024.0, True), (1.5, False), (0.7, False), (3.0, False), (0.1, False)])
def test_exact_reciprocal_only_for_powers_of_two(vs, exact):
    inv = selfcal._exact_reciprocal(np.float32(vs))
    assert (inv != 0.0) == exact
    if exact:
        assert np.float32(inv) * np.float32(vs) == np.float32(1.0)


@pytest.mark.parametrize("vs", [0.25, 0.5, 1.0, 2.0, 4.0, 8.0])
def test_power_of_two_product_rounds_as_the_division(vs):
    """x * (1 / vs) and x / vs round the same real number: bit-equal on
    normal, tiny and subnormal float32 values of both signs."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-500, 500, 200000),
        rng.standard_normal(10000) * 1e-36,
        rng.standard_normal(10000) * 1e-42]).astype(np.float32)
    inv = np.float32(selfcal._exact_reciprocal(np.float32(vs)))
    with np.errstate(under="ignore"):
        a = x * inv
        b = x / np.float32(vs)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _cells(seed, N=64, S=160, vs=2.0):
    """Each step's voxel coordinates of N random rays through a 30x28x40
    grid, with the plain version's operations; the rays' directions."""
    rng = np.random.default_rng(seed)
    shape = (30, 28, 40)
    origin = np.array([-30.0, -28.0, -35.0], np.float32)
    o, hi = selfcal._box(origin, vs, shape)
    o, hi = torch.from_numpy(o), torch.from_numpy(hi)
    C = torch.from_numpy(rng.uniform(-90, 90, (N, 3)).astype(np.float32))
    aim = torch.from_numpy(rng.uniform(-20, 20, (N, 3)).astype(np.float32))
    d = aim - C
    d[: N // 8, 0] = 0.0                  # rays parallel to a face
    cein = -C
    tiny = torch.tensor(np.float32(1e-12))
    inv = 1.0 / torch.where(d.abs() < tiny, tiny, d)
    ta, tb = (o + cein) * inv, (hi + cein) * inv
    t0 = torch.minimum(ta, tb).amax(-1).clamp(min=0.0)
    t1 = torch.maximum(ta, tb).amin(-1)
    rcp = torch.tensor(np.float32(1.0) / np.float32(S))
    steps = (torch.arange(S, dtype=torch.float32) + 0.5) * rcp
    ts = fma_f32((t1 - t0)[:, None], steps, t0[:, None])
    p = fma_f32(d[:, None, :], ts[..., None], -cein[:, None, :])
    q = torch.floor((p - o) / torch.tensor(np.float32(vs)))
    return q, d, t1 > t0


@pytest.mark.parametrize("seed", range(4))
def test_step_cells_move_monotonically(seed):
    """Along a ray that meets the grid, each axis's voxel index never
    turns back as the step grows: non-decreasing where the direction is
    positive, non-increasing where it is negative, constant where it is
    zero. The kernel's proof that a skipped step lies before or past the
    alive box rests on this."""
    q, d, live = _cells(seed)
    assert live.sum() > 20
    dq = q[live, 1:] - q[live, :-1]                 # (rays, S - 1, 3)
    dl = d[live][:, None, :].expand_as(dq)
    assert (dq[dl > 0] >= 0).all()
    assert (dq[dl < 0] <= 0).all()
    assert (dq[dl == 0] == 0).all()
    assert (dq != 0).any()


@pytest.mark.parametrize("shape", [(38, 38, 71), (16, 16, 16), (76, 76, 141)])
def test_box_is_cached_and_unchanged(shape):
    """The cached grid box equals the computation it caches (an emulated
    fused multiply-add per axis off a cube, a plain product on one), and a
    caller's edit of the returned arrays does not reach the cache."""
    origin = np.array([-75.0, -75.0, -20.0])
    vs = np.float32(2.0)
    o, hi = selfcal._box(origin, vs, shape)
    want = np.empty(3, np.float32)
    for a, n in enumerate(shape):
        want[a] = (np.float32(origin[a]) + vs * np.float32(n)
                   if len(set(shape)) == 1 else
                   fma_f32(torch.tensor(vs), torch.tensor(np.float32(n)),
                           torch.tensor(np.float32(origin[a]))).item())
    assert np.array_equal(o, origin.astype(np.float32))
    assert np.array_equal(hi, want)
    hi[:] = 0.0
    assert np.array_equal(selfcal._box(origin, vs, shape)[1], want)


@pytest.mark.parametrize("dtype,shape,ftype,coefs,lane", [
    (torch.uint8, (1, 4, 5, 3), "linear", (0.0, 1.0, 0.0), masks.FAST),
    (torch.uint8, (1, 4, 5), "linear", [0, 2.0, 0], masks.FAST),
    (torch.uint8, (1, 4, 5, 3), "linear", (0.5, 1.0, 0.0), masks.LINEAR),
    (torch.uint16, (2, 4, 5, 3), "linear", (0.0, 1.0, 0.0), masks.LINEAR),
    (torch.uint8, (1, 4, 5, 3), "excess_green", (0.0, 1.0, 0.0),
     masks.EXCESS_GREEN)])
def test_mask_lane_is_cached_by_arguments(dtype, shape, ftype, coefs, lane):
    """The mask call's cached plan gives the lane, coefficients and
    threshold of compute_mask_numpy's rule, the same for a list or a tuple
    of coefficients, and the float32 coefficient array the kernel reads
    stays alive at its address."""
    img = torch.zeros(shape, dtype=dtype)
    got = masks._lane(img, ftype, coefs, 0.15, True)
    again = masks._lane(img, ftype, list(coefs), 0.15, True)
    assert got[0] == lane == again[0]
    assert np.array_equal(got[1], again[1])
    plan = masks._plan(dtype, img.ndim == 3, 1 if img.ndim == 3 else
                       shape[-1], ftype, tuple(coefs), 0.15, True)
    assert plan[4].ctypes.data == plan[5]
    assert plan[6] == float(np.float32(0.15))
    if lane == masks.FAST:
        c = np.asarray(coefs, np.float32)
        k = int(np.nonzero(c)[0][0])
        assert got[3] == float(np.float32(0.15 * 255.0 / c[k]))
