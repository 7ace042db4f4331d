"""K1's walk (kernels/csrc/carve.cu, carve_kernel), written in numpy,
against the plain version and the JAX package, on the CPU.

The kernel has no CPU mode, so its control flow is modelled here over the
tests' outcomes, which come from the plain version's arithmetic
(`carving._view_tests`, only for valid views: the model fails if it tests
an invalid one). A block takes 256 z runs of 1 voxel; it stages the
valid views of 256 spread positions at a time (k -> k s mod V, s the
integer nearest 0.618 V prime to V); phase 1 tests each voxel against the
first 4 staged views until its first miss; phase 2 gives each of the n
open voxels g threads (the largest power of two <= 32 with g n <= 256),
which test the remaining views of a staged chunk (thread r the views
start + r + g m) in batches of 1, 2, then 4 views a thread, until a batch
finds a miss.
Killed voxels are -1, the others 1 if a view hit them, else 0.
"""

from math import gcd

import numpy as np
import pytest
import torch

from plant3dvision_tpu.ops.carving import carve as jax_carve

from plant3dvision_tpu_torch.camera import pose_to_extrinsics
from plant3dvision_tpu_torch.ops import carving
from plant3dvision_tpu_torch.ops.carving import pack_camera, pack_masks

torch.set_num_threads(1)

#: carve.cu's constants: threads (= runs) a block, views a staged chunk,
#: phase 1's views, K1's z run, phase 2's largest batch a thread
THREADS, CAM_CHUNK, FIRST_VIEWS, ZRUN, BATCH = 256, 256, 4, 1, 4


def spread_stride(V):
    stride = int(0.618 * V + 0.5)
    while gcd(stride, V) != 1:
        stride += 1
    return stride


def walk(packed, cams, valid, origin, vs, shape, hw, stride=None,
         zrun=ZRUN):
    """K1's verdict by the kernel's walk, and the tests it made (`stride`
    another view order, `zrun` another z run)."""
    nx, ny, nz = shape
    V = packed.shape[0]
    outcomes = {}
    views = iter(carving._view_tests(packed, cams, valid, origin, vs, shape,
                                     hw))
    for v in np.flatnonzero(valid.numpy()):
        in_img, hit, _ = next(views)
        outcomes[int(v)] = (in_img.reshape(-1).numpy(),
                            hit.reshape(-1).numpy())
    stride = stride or spread_stride(V)

    def stage(c0):
        pos = range(c0, min(V, c0 + CAM_CHUNK))
        return [k * stride % V for k in pos if bool(valid[k * stride % V])]

    nzc = -(-nz // zrun)
    runs = nx * ny * nzc
    vol = np.zeros(nx * ny * nz, np.int8)
    tests = 0
    for t0 in range(0, runs, THREADS):
        t = np.arange(t0, min(runs, t0 + THREADS))
        col, zc = t // nzc, t % nzc
        z = zc[:, None] * zrun + np.arange(zrun)
        vox = (col[:, None] * nz + z)[z < nz]
        kills = np.zeros(len(vox), np.int64)
        seen = np.zeros(len(vox), bool)
        c0, staged = 0, stage(0)

        def test(view, sel):
            inn, hit = outcomes[view]          # KeyError: an invalid view
            i = vox[sel]
            kills[sel] += inn[i] & ~hit[i]
            seen[sel] |= inn[i] & hit[i]
            return len(i)

        v1 = min(len(staged), FIRST_VIEWS)
        for view in staged[:v1]:               # phase 1
            tests += test(view, np.flatnonzero(kills == 0))
        vol[vox] = -1
        lst = np.flatnonzero(kills == 0)
        assert len(lst) <= THREADS * zrun
        g = 1
        while g < 32 and 2 * g * len(lst) <= THREADS:
            g *= 2
        start = v1
        while True:                             # phase 2, a chunk at a time
            for e in lst:
                if kills[e]:
                    continue
                rest, pos, nb = staged[start:], 0, 1
                while pos < len(rest):          # g threads, nb views each
                    for view in rest[pos:pos + g * nb]:
                        tests += test(view, np.array([e]))
                    pos, nb = pos + g * nb, min(2 * nb, BATCH)
                    if kills[e]:
                        break
            c0 += CAM_CHUNK
            if c0 >= V or not len(lst):
                break
            staged, start = stage(c0), 0
        lst = lst[kills[lst] == 0]
        vol[vox[lst]] = np.where(seen[lst], 1, 0)
    return vol.reshape(shape), tests


def _scene(rng, V=12, H=72, W=96):
    cams, masks = [], []
    yy, xx = np.mgrid[0:H, 0:W]
    for v in range(V):
        a = 2 * np.pi * v / V
        c = np.array([40 * np.cos(a), 40 * np.sin(a), 5.0])
        R, t = pose_to_extrinsics(c, (0, 0, 0))
        r = 9.0 + rng.uniform(-1, 1)
        m = ((xx - W / 2 - rng.uniform(-2, 2)) ** 2
             + (yy - H / 2) ** 2 <= r * r)
        m &= rng.random((H, W)) > 0.02            # speckle: scattered kills
        cams.append(pack_camera([80.0, 80.0, W / 2, H / 2], R, t))
        masks.append(m)
    return np.stack(masks), np.stack(cams).astype(np.float32), (H, W)


def _check(masks, cams, valid, shape, vs, zrun=ZRUN):
    origin = (-(np.array(shape) - 1) * vs / 2 + 0.3).astype(np.float32)
    args = (torch.from_numpy(pack_masks(masks)), torch.from_numpy(cams),
            torch.from_numpy(valid), origin, vs, shape, masks.shape[1:])
    got, tests = walk(*args, zrun=zrun)
    plain = carving.carve_plain(*args).numpy()
    np.testing.assert_array_equal(got, plain)
    ref = np.asarray(jax_carve(masks.astype(np.uint8), cams, valid, origin,
                               vs, shape))
    np.testing.assert_array_equal(got, ref)
    return got, tests


@pytest.mark.parametrize("zrun", [1, 4])
@pytest.mark.parametrize("shape,vs", [((40, 37, 45), 0.5), ((17, 64, 9), 0.7),
                                      ((9, 11, 1), 1.3)])
def test_walk_with_an_invalid_view(shape, vs, zrun):
    """12 views, one invalid; nz = 45, 9 and 1 (runs of 1 voxel; the model
    also takes runs of 4 that do not divide nz, carve.cu's P3D_K1_ZRUN)."""
    rng = np.random.default_rng(0)
    masks, cams, _ = _scene(rng)
    valid = np.ones(len(cams), bool)
    valid[3] = False
    got, _ = _check(masks, cams, valid, shape, vs, zrun)
    assert (got == 1).any() and (got == -1).any()


def test_walk_behind_the_camera_and_out_of_frame():
    """A camera whose centre plane cuts the grid (pz <= 0 on part of it) and
    a view that sees none of it, the first of the spread order invalid."""
    rng = np.random.default_rng(5)
    masks, cams, hw = _scene(rng, V=10)
    cams[2, 15] = 0.0
    cams[4, 2] += 10 * hw[1]
    valid = np.ones(len(cams), bool)
    valid[0] = False
    _check(masks, cams, valid, (23, 19, 13), 1.1)


def test_walk_stages_more_views_than_a_chunk():
    """300 views (two chunks of spread positions), a few invalid."""
    rng = np.random.default_rng(7)
    masks, cams, _ = _scene(rng, V=300, H=36, W=48)
    valid = np.ones(len(cams), bool)
    valid[[5, 140, 270]] = False
    _, tests = _check(masks, cams, valid, (21, 18, 27), 0.9)
    assert tests > 0


def test_walk_skips_a_chunk_of_invalid_views():
    """600 views whose spread positions 256-511 are all invalid: the second
    chunk stages no view and the walk goes on to the third."""
    rng = np.random.default_rng(8)
    masks, cams, _ = _scene(rng, V=600, H=24, W=32)
    s = spread_stride(600)
    valid = np.ones(600, bool)
    valid[[k * s % 600 for k in range(256, 512)]] = False
    _check(masks, cams, valid, (15, 13, 11), 1.0)


def test_walk_with_every_view_invalid():
    rng = np.random.default_rng(9)
    masks, cams, _ = _scene(rng, V=6)
    got, tests = _check(masks, cams, np.zeros(6, bool), (8, 7, 6), 1.0)
    assert tests == 0 and not got.any()


@pytest.mark.parametrize("stride", [1, 7, 31])
def test_walk_verdict_does_not_depend_on_the_view_order(stride):
    """The verdict is a function of the tests made: the ring order (stride
    1) and other strides prime to V give the spread order's volume, though
    each makes its own number of tests."""
    rng = np.random.default_rng(2)
    masks, cams, hw = _scene(rng, V=60, H=72, W=96)
    shape, vs = (40, 37, 45), 0.5
    valid = np.ones(60, bool)
    valid[11] = False
    origin = (-(np.array(shape) - 1) * vs / 2 + 0.3).astype(np.float32)
    args = (torch.from_numpy(pack_masks(masks)), torch.from_numpy(cams),
            torch.from_numpy(valid), origin, vs, shape, hw)
    spread, n_spread = walk(*args)
    other, n_other = walk(*args, stride=stride)
    np.testing.assert_array_equal(other, spread)
    np.testing.assert_array_equal(spread, carving.carve_plain(*args).numpy())
    assert n_spread > 0 and n_other > 0


@pytest.mark.parametrize("stride", [None, 1, 7, 31])
def test_least_work_is_below_every_walk(stride):
    """`carve_least_work`, the work K1's bound counts: one test a killed
    voxel and every valid view of a voxel that no view kills. The kernel's
    walk in the spread order or another makes at least as many tests, and
    the plain version's ring order reads at least as many mask bytes."""
    rng = np.random.default_rng(3)
    masks, cams, hw = _scene(rng, V=60, H=72, W=96)
    shape, vs = (40, 37, 45), 0.5
    valid = np.ones(60, bool)
    valid[[11, 40]] = False
    origin = (-(np.array(shape) - 1) * vs / 2 + 0.3).astype(np.float32)
    args = (torch.from_numpy(pack_masks(masks)), torch.from_numpy(cams),
            torch.from_numpy(valid), origin, vs, shape, hw)
    vol, ring_tests, ring_bytes = carving.carve_plain(*args, count_work=True)
    tests, mask_bytes = carving.carve_least_work(vol, *args)
    killed = int((vol == -1).sum())
    assert tests == killed + 58 * (vol.numel() - killed)
    assert 0 < killed < vol.numel()
    _, walked = walk(*args, stride=stride)
    assert tests <= walked and tests <= ring_tests
    assert 0 < mask_bytes <= ring_bytes
