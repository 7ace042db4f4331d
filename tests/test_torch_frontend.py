"""The real-scan front end against the JAX package, on the CPU (the kernels'
plain versions): ops/undistort.py (K9), the mask filter of ops/masks.py
(K10), the vote carve of ops/carving.py (K11), the Undistorted, Masks and
Voxels(kill_tolerance) tasks, and the path end to end.

Tolerances, and what is exact:
- undistort: bit-equal. XLA on the CPU compiles the JAX function with fused
  multiply-adds (r2 = fma(x, x, y*y), the radial polynomial, the
  tangential terms, px = fma(dx, fx, u), and lerp(a, b, w) = fma(a, 1 - w,
  b*w), except the row lerps of a 2-D image, fma(b, w, a*(1 - w))); the
  port repeats them. An unfused version differs from JAX on thousands of
  values (the test below counts them). The JAX package's eager helpers
  (distort_normalized, bilinear_sample outside jit) are not fused: within
  1e-6 relative.
- compute_mask: the port computes compute_mask_numpy's arithmetic, which
  the JAX Masks task runs: equal, PNGs included. The jitted JAX
  compute_mask divides by 255 as a multiply by the reciprocal and sums the
  linear filter in another order, so it differs from compute_mask_numpy on
  pixels within an ulp of the threshold (u = 51 at threshold 0.2, for one);
  there the port sides with compute_mask_numpy, and the test counts them.
  numpy's linear filter over the channel slice of an image with more
  channels than coefficients goes through its own matmul loop, whose order
  the port does not repeat: within 2 ulp.
- count_kills / carve_tolerant / the vote Backprojection / Voxels: equal.
- The path end to end: fileset ids equal, volumes equal, angle counts
  equal, angles within 0.05 deg.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plant3dvision_tpu.camera import pose_to_extrinsics
from plant3dvision_tpu.fsdb import io as jio
from plant3dvision_tpu.fsdb.testing import TemporaryDB
from plant3dvision_tpu.ops import masks as jmasks
from plant3dvision_tpu.ops import undistort as jund
from plant3dvision_tpu.ops.carving import carve_tolerant as j_carve_tolerant
from plant3dvision_tpu.ops.carving import count_kills as j_count_kills
from plant3dvision_tpu.ops.carving import pack_camera
from plant3dvision_tpu.runtime import RunContext as JaxRunContext
from plant3dvision_tpu.runtime import run_task as jax_run_task

from plant3dvision_tpu_torch.ops import carving, masks, undistort
from plant3dvision_tpu_torch.runtime import RunContext, run_task

torch.set_num_threads(1)


def _K(H, W):
    return np.array([[W * 1.1 + 0.3, 0, W / 2 - 0.7],
                     [0, W * 1.08, H / 2 + 0.4], [0, 0, 1]], np.float32)


def _images(rng, shape, dtype):
    if dtype == np.float32:
        return rng.random(shape).astype(dtype)
    hi = 256 if dtype == np.uint8 else 65536
    return rng.integers(0, hi, shape).astype(dtype)


DISTS = {"zero": (0.0, 0.0, 0.0, 0.0),
         "opencv": (-0.21, 0.07, 0.011, -0.007),
         "k3": (-0.21, 0.07, 0.011, -0.007, 0.013)}


# -- K9: undistort ------------------------------------------------------------

@pytest.mark.parametrize("dist", list(DISTS))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("channels", [None, 1, 3, 4])
def test_undistort_batch_equals_jax(channels, dtype, dist):
    """Gray (2-D), one-channel, RGB and RGBA stacks of uint8, uint16 and float32, zero
    and nonzero distortion with len(dist) 4 and 5: undistort_batch
    bit-equal to JAX's, and `undistort` of one image to JAX's."""
    rng = np.random.default_rng(len(DISTS[dist]) + (channels or 1))
    H, W = 41, 56
    img = _images(rng, (2, H, W) + (() if channels is None else
                                    (channels,)), dtype)
    K, d = _K(H, W), np.float32(DISTS[dist])
    ref = np.asarray(jund.undistort_batch(jnp.asarray(img), jnp.asarray(K),
                                          jnp.asarray(d)))
    got = undistort.undistort_batch(torch.from_numpy(img), K, d).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    one = undistort.undistort(torch.from_numpy(img[1]), K, d).numpy()
    np.testing.assert_array_equal(one, np.asarray(jund.undistort(
        jnp.asarray(img[1]), jnp.asarray(K), jnp.asarray(d))))
    if dist != "zero":
        assert (got != img).mean() > 0.5


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_undistort_one_channel_stack_is_a_gray_image(dtype):
    """An (N, H, W, 1) stack gives the values of the (N, H, W) stack of the
    same pixels, bit for bit, and both equal JAX's: XLA fuses a
    one-channel stack's row lerps as it fuses a 2-D image's,
    fma(b, w, a*(1 - w)), and so does the port."""
    rng = np.random.default_rng(11)
    H, W = 41, 56
    img = _images(rng, (3, H, W), dtype)
    K, d = _K(H, W), np.float32(DISTS["k3"])
    gray = undistort.undistort_batch(torch.from_numpy(img), K, d).numpy()
    one = undistort.undistort_batch(torch.from_numpy(img[..., None]), K,
                                    d).numpy()
    np.testing.assert_array_equal(one[..., 0], gray)
    np.testing.assert_array_equal(gray, np.asarray(jund.undistort_batch(
        jnp.asarray(img), jnp.asarray(K), jnp.asarray(d))))
    np.testing.assert_array_equal(one, np.asarray(jund.undistort_batch(
        jnp.asarray(img[..., None]), jnp.asarray(K), jnp.asarray(d))))


def _rounding_edge_stack(dtype, n=8):
    """(n, 41, 56) images, image i holding at pixel i's four taps values
    whose bilinear sample rounds to another integer under a multi-channel
    stack's row lerps, fma(a, 1 - w, b*w), than under a 2-D image's; the
    pixels, and both roundings."""
    rng = np.random.default_rng(12)
    H, W = 41, 56
    K, d = _K(H, W), np.float32(DISTS["k3"])
    px, py = undistort.source_map((H, W), K, d)
    x0 = torch.floor(px).clamp(0, W - 2)
    y0 = torch.floor(py).clamp(0, H - 2)
    fx, fy = px - x0, py - y0
    inside = ((px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
              & (fx > 0.01) & (fy > 0.01))
    cand = np.argwhere(inside.numpy())
    imgs = _images(rng, (n, H, W), dtype)
    found = []
    for v, u in cand[rng.permutation(len(cand))]:
        q = torch.from_numpy(rng.integers(0, 256, (4, 50000)).astype(
            np.float32))
        wx, wy = fx[v, u], fy[v, u]

        def sample(fuse_b):
            lerp = undistort._lerp
            return torch.round(lerp(lerp(q[0], q[1], wx, fuse_b),
                                    lerp(q[2], q[3], wx, fuse_b), wy))
        multi, gray = sample(False), sample(True)
        hit = torch.nonzero(multi != gray)[:, 0]
        if len(hit) == 0:
            continue
        j, i = int(hit[0]), len(found)
        yi, xi = int(y0[v, u]), int(x0[v, u])
        imgs[i, yi:yi + 2, xi:xi + 2] = q[:, j].numpy().reshape(2, 2)
        found.append((v, u, float(multi[j]), float(gray[j])))
        if len(found) == n:
            break
    assert len(found) == n
    return imgs, K, d, found


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [None, 1])
def test_undistort_integer_one_channel_rounds_as_jax(dtype, channels):
    """Integer gray and one-channel stacks whose taps put a sample where
    the two lerp fusions round to different integers: the port gives the
    2-D image's rounding, and so does JAX, at every such pixel."""
    imgs, K, d, found = _rounding_edge_stack(dtype)
    if channels == 1:
        imgs = imgs[..., None]
    got = undistort.undistort_batch(torch.from_numpy(imgs), K, d).numpy()
    ref = np.asarray(jund.undistort_batch(jnp.asarray(imgs), jnp.asarray(K),
                                          jnp.asarray(d)))
    np.testing.assert_array_equal(got, ref)
    for i, (v, u, multi, gray) in enumerate(found):
        assert got[i, v, u].item() == gray != multi


def test_undistort_gray_row_tail_differs_by_an_ulp():
    """A 2-D float image whose width is not a multiple of XLA's 8 vector
    lanes: XLA computes the last column of each row in a scalar loop, whose
    source positions can differ from its vector loop's by one ulp. On this
    41x57 image pair 4 values of the last column differ (2 pixels, one
    ulp of px or py each); every other value is bit-equal (ROADMAP Queue
    C)."""
    rng = np.random.default_rng(6)
    H, W = 41, 57
    img = rng.random((2, H, W)).astype(np.float32)
    K, d = _K(H, W), np.float32(DISTS["k3"])
    ref = np.asarray(jund.undistort_batch(jnp.asarray(img), jnp.asarray(K),
                                          jnp.asarray(d)))
    got = undistort.undistort_batch(torch.from_numpy(img), K, d).numpy()
    np.testing.assert_array_equal(got[..., :-1], ref[..., :-1])
    assert (got[..., -1] != ref[..., -1]).sum() == 4
    np.testing.assert_allclose(got, ref, rtol=2e-5)


def test_undistort_identity_is_exact():
    """Zero distortion gives the input back, border included (the JAX
    function's `distort_delta` form makes the identity map exact)."""
    img = _images(np.random.default_rng(0), (1, 30, 40, 3), np.uint8)
    got = undistort.undistort_batch(torch.from_numpy(img), _K(30, 40),
                                    np.zeros(4, np.float32))
    np.testing.assert_array_equal(got.numpy(), img)


def test_undistort_clips_uint16_to_255_like_jax():
    """ops/undistort.py:91-92 clips every integer image to 255, so a uint16
    image loses its range; the port matches it (a flaw kept, ROADMAP Queue
    C)."""
    img = np.full((1, 20, 24), 40000, np.uint16)
    img[0, :, :12] = 100
    K, d = _K(20, 24), np.zeros(4, np.float32)
    got = undistort.undistort_batch(torch.from_numpy(img), K, d).numpy()
    ref = np.asarray(jund.undistort(jnp.asarray(img[0]), jnp.asarray(K),
                                    jnp.asarray(d)))
    np.testing.assert_array_equal(got[0], ref)
    assert got.max() == 255 and got.dtype == np.uint16
    assert (got[0, :, :12] == 100).all()


@pytest.mark.parametrize("gray", [False, True])
def test_undistort_contracts_like_xla(gray):
    """On float images the port is bit-equal to JAX; the same arithmetic
    without fused multiply-adds (plain torch f32 operations) differs on
    thousands of values, so the test tells the patterns apart."""
    rng = np.random.default_rng(3)
    H, W = 120, 160
    img = rng.random((H, W) if gray else (H, W, 3)).astype(np.float32)
    K, d = _K(H, W), np.float32(DISTS["k3"])
    ref = np.asarray(jund.undistort(jnp.asarray(img), jnp.asarray(K),
                                    jnp.asarray(d)))
    got = undistort.undistort(torch.from_numpy(img), K, d).numpy()
    np.testing.assert_array_equal(got, ref)
    # unfused: the JAX expressions evaluated op by op in float32
    u = torch.arange(W, dtype=torch.float32)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32)[:, None].expand(H, W)
    fx, fy, cx, cy = (torch.tensor(K[i, j]) for i, j in
                      ((0, 0), (1, 1), (0, 2), (1, 2)))
    dx, dy = jund.distort_delta(np.asarray((u - cx) / fx),
                                np.asarray((v - cy) / fy), list(d))
    px = u + torch.from_numpy(np.asarray(dx)) * fx
    py = v + torch.from_numpy(np.asarray(dy)) * fy
    unfused = np.asarray(jund.bilinear_sample(jnp.asarray(img),
                                              jnp.asarray(px.numpy()),
                                              jnp.asarray(py.numpy())))
    inside = ((px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)).numpy()
    if not gray:
        inside = inside[..., None]
    assert (np.where(inside, unfused, 0.0) != ref).sum() > 1000


def test_distort_helpers_close_to_jax():
    """distort_normalized / bilinear_sample carry the jitted function's
    fused multiply-adds; the JAX helpers called eagerly do not fuse: within
    1e-6 relative."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.7, 0.7, 5000).astype(np.float32)
    y = rng.uniform(-0.5, 0.5, 5000).astype(np.float32)
    d = DISTS["k3"]
    gx, gy = undistort.distort_normalized(torch.from_numpy(x),
                                          torch.from_numpy(y), d)
    jx, jy = jund.distort_normalized(jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(np.float32(d)))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-9)
    img = rng.random((30, 40, 3)).astype(np.float32)
    px = rng.uniform(-2, 42, (25, 35)).astype(np.float32)
    py = rng.uniform(-2, 32, (25, 35)).astype(np.float32)
    got = undistort.bilinear_sample(torch.from_numpy(img),
                                    torch.from_numpy(px), torch.from_numpy(py))
    ref = jund.bilinear_sample(jnp.asarray(img), jnp.asarray(px),
                               jnp.asarray(py))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_undistort_checks_its_arguments():
    with pytest.raises(ValueError, match="2x2"):
        undistort.undistort_batch(torch.zeros((1, 1, 5, 3)), _K(1, 5),
                                  np.zeros(4))
    with pytest.raises(ValueError, match="k1, k2, p1"):
        undistort.undistort_batch(torch.zeros((1, 4, 5)), _K(4, 5),
                                  np.zeros(3))


# -- K10: the mask filter -----------------------------------------------------

def _threshold_images(rng, dtype=np.uint8, channels=3):
    """Every uint8 level in every channel, next to random pixels (so values
    at each threshold occur), plus a pixel of all zeros."""
    lv = np.arange(256, dtype=np.uint8)
    grid = np.stack(np.meshgrid(lv, lv[::-1], indexing="ij"), -1)
    rgb = np.concatenate([grid, np.roll(grid[..., :1], 7, 0)], -1)
    rand = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    img = np.concatenate([rgb, rand], 1)
    img[0, 0] = 0
    if channels == 4:
        img = np.concatenate([img, rng.integers(0, 256, img.shape[:2] + (1,),
                                                dtype=np.uint8)], -1)
    if dtype == np.uint16:
        return img.astype(np.uint16) * 257
    if dtype == np.float32:
        return img.astype(np.float32) * 0.75 - 3.0
    return img


LANES = [("linear", (0.0, 1.0, 0.0)), ("linear", (1.0, 0.0, 0.0)),
         ("linear", (0.2, 0.7, 0.1)), ("linear", (0.3, -0.2, 0.9)),
         ("excess_green", (0.0, 1.0, 0.0))]


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("threshold", [0.15, 0.2, 0.3])
def test_compute_mask_equals_numpy_and_counts_jax(lane, threshold):
    """The thresholds the configs use, images with values at them: the
    port's compute_mask equals compute_mask_numpy (binarised, dilated and
    clipped); where the jitted JAX compute_mask differs from
    compute_mask_numpy, the port sides with numpy, and those are the only
    pixels where it differs from JAX."""
    ftype, coefs = lane
    img = _threshold_images(np.random.default_rng(5))
    t = torch.from_numpy(img)
    for dil, binarize in ((0, True), (3, True), (0, False)):
        kw = dict(filter_type=ftype, coefs=coefs, threshold=threshold,
                  dilation_radius=dil, binarize=binarize)
        got = masks.compute_mask(t, **kw).numpy()
        host = jmasks.compute_mask_numpy(img, **kw)
        jit = np.asarray(jmasks.compute_mask(jnp.asarray(img), **kw))
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(got != jit, host != jit)
        if binarize:
            assert 0 < got.mean() < 1
            assert (got != jit).mean() < 0.01


def test_jax_compute_mask_differs_from_numpy_at_51_over_255():
    """The trap behind the port's choice: at threshold 0.2 a uint8 value of
    51 is 0.2 exactly. compute_mask_numpy's fast lane compares 51 > 51.0
    (False); the jitted compute_mask multiplies 51 by float32(1/255) and
    gets 0.20000002 > 0.2 (True). The port writes the JAX Masks task's
    (numpy's) False."""
    img = np.zeros((1, 3, 3), np.uint8)
    img[..., 1] = 51
    kw = dict(filter_type="linear", coefs=(0.0, 1.0, 0.0), threshold=0.2)
    assert jmasks.compute_mask_numpy(img, **kw).sum() == 0
    assert np.asarray(jmasks.compute_mask(jnp.asarray(img), **kw)).sum() == 3
    assert masks.compute_mask(torch.from_numpy(img), **kw).sum() == 0


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("lane", LANES[2:])
def test_mask_filter_other_types_equal_numpy(dtype, lane):
    """uint16 (/ 65535) and float images (rescaled by their own min and
    max) in the general lanes: equal to compute_mask_numpy."""
    ftype, coefs = lane
    img = _threshold_images(np.random.default_rng(6), dtype)
    for binarize in (True, False):
        kw = dict(filter_type=ftype, coefs=coefs, threshold=0.2,
                  binarize=binarize)
        got = masks.compute_mask(torch.from_numpy(img), **kw).numpy()
        np.testing.assert_array_equal(got,
                                      jmasks.compute_mask_numpy(img, **kw))


@pytest.mark.parametrize("coefs", [(0.2, 0.5, 0.1, 0.3), (0.2, 0.7, 0.1),
                                   (0.0, 1.0, 0.0)])
def test_mask_filter_rgba(coefs):
    """RGBA images: four coefficients go through numpy's BLAS as (x0 c0 +
    x1 c1) + (x2 c2 + x3 c3), equal; a single coefficient takes the fast
    lane, equal; three coefficients over the four channels go through
    numpy's own matmul loop: the port's values within 2 ulp, its masks
    equal wherever the value is not within 1e-6 of the threshold."""
    img = _threshold_images(np.random.default_rng(8), channels=4)
    kw = dict(filter_type="linear", coefs=coefs, threshold=0.3)
    got = masks.compute_mask(torch.from_numpy(img), binarize=False,
                             **kw).numpy()
    ref = jmasks.compute_mask_numpy(img, binarize=False, **kw)
    mask = masks.compute_mask(torch.from_numpy(img), **kw).numpy()
    ref_mask = jmasks.compute_mask_numpy(img, **kw)
    if len(coefs) == 3 and np.count_nonzero(coefs) > 1:
        np.testing.assert_array_max_ulp(got, ref, maxulp=2)
        far = np.abs(ref - 0.3) > 1e-6
        np.testing.assert_array_equal(mask[far], ref_mask[far])
    else:
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(mask, ref_mask)


def test_mask_filter_refuses_what_it_cannot_take():
    img = torch.zeros((1, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="3 channels"):
        masks.mask_filter(img, "excess_green")
    with pytest.raises(ValueError, match="Unknown mask filter"):
        masks.mask_filter(img, "ndvi")
    with pytest.raises(ValueError, match="1-4 channels"):
        masks.mask_filter(torch.zeros((1, 4, 4, 5)), "linear", (1.0,) * 5)


def _config_fast_lanes():
    """(coefs, threshold) of each shipped config's Masks task whose lane on
    uint8 images is the fast lane (linear, one positive coefficient)."""
    import tomllib
    from pathlib import Path
    lanes = set()
    for path in sorted((Path(__file__).parents[1] / "configs").glob("*.toml")):
        m = tomllib.loads(path.read_text()).get("Masks", {})
        c = tuple(map(float, json.loads(m.get("parameters", "[]"))))
        if (m.get("type") == "linear" and np.count_nonzero(c) == 1
                and max(c) > 0):
            lanes.add((c, float(m["threshold"])))
    return sorted(lanes)


@pytest.mark.parametrize("coefs,threshold", _config_fast_lanes())
def test_fast_lane_library_call_equals_numpy(coefs, threshold):
    """chip_smoke.py times K10's fast lane beside one PyTorch call,
    chip_smoke.fast_lane_library (imgs[..., k] > t). For every shipped
    config's fast lane, at every uint8 level in every channel, that call
    gives compute_mask_numpy's masks and mask_filter_plain's: it computes
    the lane's function."""
    import chip_smoke
    img = _threshold_images(np.random.default_rng(9))
    stack = torch.from_numpy(np.stack([img, img[::-1]]))
    mode, _, ch, fast_t = masks._lane(stack, "linear", coefs, threshold,
                                      True)
    assert mode == masks.FAST
    got = chip_smoke.fast_lane_library(stack, ch, fast_t)
    want = np.stack([jmasks.compute_mask_numpy(im, "linear", coefs,
                                               threshold, as_bool=True)
                     for im in stack.numpy()])
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, masks.mask_filter_plain(stack, "linear", coefs,
                                                    threshold))
    assert 0 < want.mean() < 1


# -- K11: count_kills / carve_tolerant / the vote Backprojection -------------

def _vote_scene(V=9, H=48, W=64, seed=0):
    """A ring of views of a speckled disk (scattered dissenting views)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    ms, cams = [], []
    for v in range(V):
        a = 2 * np.pi * v / V
        R, t = pose_to_extrinsics([30 * np.cos(a), 30 * np.sin(a), 4.0],
                                  (0, 0, 0))
        cams.append(pack_camera([50.0, 51.0, W / 2 + 0.3, H / 2 - 0.2], R, t))
        m = (((xx - W / 2 - rng.uniform(-2, 2)) ** 2 + (yy - H / 2) ** 2
              < 12 ** 2) & (rng.random((H, W)) > 0.05))
        ms.append(m.astype(np.uint8) * 255)
    return np.stack(ms), np.stack(cams)


def test_count_kills_and_carve_tolerant_equal_jax():
    """An invalid view, tolerances 0-4: the int16 counts, the seen flags
    and the verdicts equal JAX's."""
    ms, cams = _vote_scene()
    valid = np.ones(len(ms), bool)
    valid[2] = False
    origin = np.array([-8, -8, -8], np.float32)
    vs, shape = 0.5, (32, 30, 34)
    jargs = (jnp.asarray(ms), jnp.asarray(cams), jnp.asarray(valid), origin,
             vs, shape)
    args = (torch.from_numpy(carving.pack_masks(ms)), torch.from_numpy(cams),
            torch.from_numpy(valid), origin, vs, shape, ms.shape[1:])
    jk, js = j_count_kills(*jargs)
    kills, seen = carving.count_kills(*args)
    assert kills.dtype == torch.int16
    np.testing.assert_array_equal(kills.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(seen.numpy(), np.asarray(js))
    assert len(np.unique(np.asarray(jk))) >= 6
    for tol in range(5):
        ref = np.asarray(j_carve_tolerant(*jargs, tol))
        np.testing.assert_array_equal(
            carving.carve_tolerant(*args, tol).numpy(), ref)
        assert (ref == 1).any() and (ref == -1).any()


def test_backprojection_tolerance_spans_flushes():
    """Two flushes (5 + 4 views) into one vote Backprojection: the counts
    merge across the flushes and the tolerance applies to the sum, as the
    JAX Backprojection does (equal to it and to one carve_tolerant over all
    views); applying it per flush would keep other voxels."""
    from plant3dvision_tpu.ops.carving import Backprojection as JaxBP
    ms, cams = _vote_scene(seed=1)
    shape, origin, vs, tol = (30, 28, 32), [-7.5, -7.0, -8.0], 0.5, 2

    def two_flushes(bp):
        for i, (m, c) in enumerate(zip(ms, cams)):
            bp.process_view(c[0:4], c[4:13].reshape(3, 3), c[13:16], m)
            if i == 4:
                bp.get_values()
        return np.asarray(bp.get_values())

    got = two_flushes(carving.Backprojection(shape, origin, vs,
                                             kill_tolerance=tol,
                                             device="cpu"))
    ref = two_flushes(JaxBP(shape, origin, vs, kill_tolerance=tol))
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    whole = np.asarray(j_carve_tolerant(
        jnp.asarray(ms), jnp.asarray(cams), jnp.ones(len(ms), bool),
        np.float32(origin), vs, shape, tol))
    np.testing.assert_array_equal(got, whole)
    per_flush = [np.asarray(j_carve_tolerant(
        jnp.asarray(ms[s]), jnp.asarray(cams[s]), jnp.ones(len(ms[s]), bool),
        np.float32(origin), vs, shape, tol)) for s in (slice(0, 5),
                                                       slice(5, None))]
    or_merge = np.where((per_flush[0] == -1) | (per_flush[1] == -1), -1,
                        np.where((per_flush[0] == 1) | (per_flush[1] == 1),
                                 1, 0))
    assert (or_merge != got).sum() > 100


# -- the tasks --------------------------------------------------------------

def _colmap_camera(K, dist, R, t, W, H):
    return {"camera_model": {"model": "OPENCV", "width": W, "height": H,
                             "params": [K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                                        *dist]},
            "rotmat": np.asarray(R).tolist(), "tvec": np.asarray(t).tolist()}


def _run_both(db, scan_id, cfg, task):
    """Run `task` through the JAX package, then through the port: the two
    reports and, per package, the output fileset's files (id, filename,
    pixels, metadata)."""
    out = []
    for pkg in ("jax", "port"):
        ctx = (JaxRunContext(db, scan_id, cfg) if pkg == "jax"
               else RunContext(db, scan_id, cfg, device="cpu"))
        rep = (jax_run_task if pkg == "jax" else run_task)(ctx, task,
                                                           report=False)
        fs = ctx.scan.get_fileset(rep[task]["fileset"])
        files = {f.id: (f.filename, jio.read_image(f), f.get_metadata())
                 for f in fs.get_files()}
        out.append((rep, files))
        for t in ("Masks", "Undistorted"):
            if t in rep:
                ctx.scan.delete_fileset(rep[t]["fileset"])
    return out


def _assert_same_files(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k][0] == b[k][0], k
        assert a[k][1].dtype == b[k][1].dtype, k
        np.testing.assert_array_equal(a[k][1], b[k][1], err_msg=k)
        assert a[k][2] == b[k][2], k


def test_undistorted_metadata_cameras_match_jax():
    """Per-image colmap_camera and camera metadata (two camera groups, one
    with a 4-image chunk of mixed sizes), a JPEG (written back as PNG), a
    file without a camera (copied through) and the pose_estimation query:
    equal fileset ids, files, extensions, pixels and metadata."""
    H, W = 48, 64
    rng = np.random.default_rng(9)
    R, t = pose_to_extrinsics([30.0, 0, 5.0], (0, 0, 0))
    K = _K(H, W).astype(float)
    cfg = {"Undistorted": {
        "upstream_task": "ImagesFilesetExists",
        "query": json.dumps({"channel": "rgb",
                             "pose_estimation": "correct"})}}
    with TemporaryDB() as db:
        images = db.get_scan("s", create=True).get_fileset("images",
                                                            create=True)
        for i in range(9):
            h, w = (H, W) if i != 6 else (H + 2, W - 4)
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            f = images.create_file(f"{i:05d}_rgb")
            jio.write_image(f, img, "jpg" if i == 2 else "png")
            md = {"channel": "rgb", "pose_estimation":
                  "incorrect" if i == 8 else "correct", "shot": i}
            if i < 5:
                md["colmap_camera"] = _colmap_camera(
                    K, [-0.12, 0.02, 0.001, -0.002], R, t, W, H)
            elif i < 7:
                md["camera"] = _colmap_camera(K, [0.05, 0, 0, 0], R, t, w, h)
            f.set_metadata(md)
        (jrep, jfiles), (rep, files) = _run_both(db, "s", cfg, "Undistorted")
    assert rep["Undistorted"]["fileset"] == jrep["Undistorted"]["fileset"]
    assert len(files) == 8 and "00008_rgb" not in files
    assert files["00002_rgb"][0] == "00002_rgb.png"
    _assert_same_files(files, jfiles)


def test_undistorted_intrinsic_calibration_matches_jax():
    """camera_model_source = "IntrinsicCalibration" with a
    calibration_scan_id: the camera of another scan's IntrinsicCalibration
    fileset (found by locate_task_filesets), its OPENCV model."""
    from plant3dvision_tpu.utils import locate_task_filesets as jax_locate
    from plant3dvision_tpu_torch.utils import locate_task_filesets
    H, W = 40, 56
    rng = np.random.default_rng(10)
    cfg = {"Undistorted": {"upstream_task": "ImagesFilesetExists",
                           "camera_model_source": "IntrinsicCalibration",
                           "calibration_scan_id": "calib",
                           "calibration_model": "OPENCV"}}
    with TemporaryDB() as db:
        calib = db.get_scan("calib", create=True)
        fs = calib.get_fileset("IntrinsicCalibration_1_abc", create=True)
        calib.get_fileset("IntrinsicCalibrationX", create=True)
        jio.write_json(fs.create_file("camera_model"), {
            "OPENCV": {"model": "OPENCV",
                       "params": [60.5, 61.0, 27.2, 20.4, -0.15, 0.03,
                                  0.002, -0.001]},
            "RADIAL": {"model": "RADIAL",
                       "params": [60.5, 27.2, 20.4, -0.1, 0.0]}})
        images = db.get_scan("s", create=True).get_fileset("images",
                                                            create=True)
        for i in range(3):
            f = images.create_file(f"{i:05d}_rgb")
            jio.write_image(f, rng.integers(0, 256, (H, W, 3),
                                            dtype=np.uint8), "png")
            f.set_metadata({"channel": "rgb"})
        assert locate_task_filesets(calib, ["IntrinsicCalibration", "Colmap"]) \
            == jax_locate(calib, ["IntrinsicCalibration", "Colmap"]) \
            == {"IntrinsicCalibration": "IntrinsicCalibration_1_abc",
                "Colmap": "None"}
        (jrep, jfiles), (rep, files) = _run_both(db, "s", cfg, "Undistorted")
    assert rep["Undistorted"]["fileset"] == jrep["Undistorted"]["fileset"]
    assert len(files) == 3
    _assert_same_files(files, jfiles)


MASKS_CFG = [
    {"type": "linear", "parameters": "[0, 1, 0]", "threshold": 0.15,
     "dilation": 3},
    {"type": "linear", "parameters": "[0, 1, 0]", "threshold": 0.2,
     "dilation": 1},
    {"type": "excess_green", "threshold": 0.15, "dilation": 2},
    {"type": "linear", "parameters": [0.2, 0.7, 0.1], "threshold": 0.3,
     "binarize": False},
]


@pytest.mark.parametrize("mcfg", MASKS_CFG)
def test_masks_task_matches_jax(mcfg):
    """The configs' mask settings on RGB, gray (repeated to 3 channels)
    and differently sized images with values at the thresholds: equal
    fileset ids, PNGs and metadata."""
    rng = np.random.default_rng(11)
    cfg = {"Masks": dict(mcfg, upstream_task="ImagesFilesetExists",
                         query={"channel": "rgb"})}
    with TemporaryDB() as db:
        images = db.get_scan("s", create=True).get_fileset("images",
                                                            create=True)
        full = _threshold_images(rng)
        for i in range(5):
            img = full[:, 160 + 48 * i: 256 + 48 * i]
            if i == 3:
                img = img[:, :, 1]
            if i == 4:
                img = img[:70]
            f = images.create_file(f"{i:05d}_rgb")
            jio.write_image(f, np.ascontiguousarray(img), "png")
            f.set_metadata({"channel": "rgb" if i != 2 else "mask", "i": i})
        (jrep, jfiles), (rep, files) = _run_both(db, "s", cfg, "Masks")
    assert rep["Masks"]["fileset"] == jrep["Masks"]["fileset"]
    assert len(files) == 4 and "00002_rgb" not in files
    _assert_same_files(files, jfiles)
    if mcfg.get("binarize", True):
        assert any(0 < (f[1] > 0).mean() < 1 for f in files.values())
    else:
        assert all(len(np.unique(f[1])) > 100 for f in files.values())


def test_front_end_task_ids_match_jax():
    """Fileset ids (names, significant parameters, upstream ids) of
    Undistorted (both camera sources), Masks and Voxels(kill_tolerance=3)
    under the front end's configs equal the JAX package's."""
    import chip_smoke
    base = chip_smoke.frontend_config(0.5)
    calib = {t: dict(v) for t, v in base.items()}
    calib["Undistorted"].update(camera_model_source="IntrinsicCalibration",
                                calibration_scan_id="calib")
    with TemporaryDB() as db:
        for cfg in (base, calib):
            jctx = JaxRunContext(db, "s", cfg)
            ctx = RunContext(db, "s", cfg, device="cpu")
            for t in ("Undistorted", "Masks", "Voxels", "AnglesAndInternodes"):
                assert ctx.get_task(t).task_id() == \
                    jctx.get_task(t).task_id(), t
            assert ctx.get_task("Voxels").kill_tolerance == 3


# -- the path end to end ------------------------------------------------------

def test_front_end_path_matches_jax():
    """chip_smoke.py phase 9's path (geom_pipe_real_selfcal.toml's tasks
    after TurntableCalibration) on a distorted 28-view 640x480 scan of the
    north-star plant, one view marked "incorrect", at 1 mm in a box around
    the plant, through both packages: equal fileset ids and vote-carved
    volumes, equal angle counts, angles within 0.05 deg. (A 12-view
    320x240 scan gives no angle in either package: the config's 6 mm
    skeleton bins need the finer silhouettes.)"""
    import chip_smoke
    from plant3dvision_tpu_torch.synth import SyntheticPlant
    cfg = chip_smoke.frontend_config(1.0)
    cfg["Voxels"]["bounding_box"] = {"x": [-40, 40], "y": [-40, 40],
                                     "z": [-5, 175]}
    out = []
    with TemporaryDB() as db:
        chip_smoke.write_distorted_scan(
            db, "s", SyntheticPlant(**chip_smoke.NORTHSTAR_PLANT), 28, 640,
            480, 1400.0 * 640 / 1440, incorrect=(3,))
        for pkg in ("jax", "port"):
            ctx = (JaxRunContext(db, "s", cfg) if pkg == "jax"
                   else RunContext(db, "s", cfg, device="cpu"))
            rep = (jax_run_task if pkg == "jax" else run_task)(
                ctx, "AnglesAndInternodes", report=False)
            vf = ctx.scan.get_fileset(rep["Voxels"]["fileset"]).get_files()[0]
            ang = json.loads(ctx.scan.get_fileset(
                rep["AnglesAndInternodes"]["fileset"]).get_file(
                "AnglesAndInternodes").read_raw())
            n_und = len(ctx.scan.get_fileset(
                rep["Undistorted"]["fileset"]).get_files())
            out.append((rep, np.load(vf.path())["volume"], ang, n_und))
            for t in chip_smoke.FRONTEND_TASKS:
                ctx.scan.delete_fileset(rep[t]["fileset"])
    (jrep, jvol, jang, jn), (rep, vol, ang, n) = out
    for t in chip_smoke.FRONTEND_TASKS:
        assert rep[t]["fileset"] == jrep[t]["fileset"], t
    assert n == jn == 27
    assert vol.dtype == jvol.dtype == np.int32
    np.testing.assert_array_equal(vol, jvol)
    assert (vol == 1).sum() > 1000
    assert len(ang["angles"]) == len(jang["angles"]) >= 10
    np.testing.assert_allclose(ang["angles"], jang["angles"], atol=0.05,
                               rtol=0)
    np.testing.assert_allclose(ang["internodes"], jang["internodes"],
                               atol=0.05, rtol=0)
