"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and carries the `cuda` marker; without
a card they skip (the CPU tests in the other test_torch_*.py files cover
the plain versions against the JAX package). This file imports neither
jax nor plant3dvision_tpu, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _scene(rng, V=12, H=72, W=96):
    from plant3dvision_tpu_torch.camera import pose_to_extrinsics
    from plant3dvision_tpu_torch.ops.carving import pack_camera, pack_masks
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
    return pack_masks(np.stack(masks)), np.stack(cams), (H, W)


@pytest.mark.parametrize("shape,vs", [((40, 37, 45), 0.5), ((17, 64, 9), 0.7)])
def test_carve_kernel_matches_plain(dev, shape, vs):
    from plant3dvision_tpu_torch.ops.carving import carve, carve_plain
    rng = np.random.default_rng(0)
    packed, cams, hw = _scene(rng)
    valid = np.ones(len(cams), bool)
    valid[3] = False
    args = (torch.from_numpy(packed).to(dev), torch.from_numpy(cams).to(dev),
            torch.from_numpy(valid).to(dev),
            -(np.array(shape) - 1) * vs / 2 + 0.3, vs, shape, hw)
    k = carve(*args)
    p = carve_plain(*args)
    assert k.dtype == torch.int8 and tuple(k.shape) == shape
    assert torch.equal(k, p)                     # exact: same f32 ops
    assert (k == 1).any() and (k == -1).any()


def _blobs(rng, shape):
    x = rng.random(shape).astype(np.float32)
    from scipy.ndimage import gaussian_filter
    return (gaussian_filter(x, 2.0) > 0.5).astype(np.float32)


@pytest.mark.parametrize("shape", [(30, 26, 41), (5, 64, 3)])
@pytest.mark.parametrize("cap", [3, 20, None])
def test_signed_distance_kernel_matches_plain(dev, shape, cap):
    from plant3dvision_tpu_torch.ops import edt
    rng = np.random.default_rng(1)
    vol = torch.from_numpy(_blobs(rng, shape) * 2 - 1).to(dev)
    assert torch.equal(edt.signed_distance(vol, cap),
                       edt.signed_distance_plain(vol, cap))   # exact
    assert torch.equal(edt.squared_edt(vol > 0, cap),
                       edt.squared_edt_plain(vol > 0, cap))


@pytest.mark.parametrize("shape", [(30, 26, 41), (2, 9, 5)])
def test_gradient_gaussian_kernel_matches_plain(dev, shape):
    from plant3dvision_tpu_torch.ops import filters
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    for k, p in zip(filters.gradient(x), filters.gradient_plain(x)):
        assert torch.equal(k, p)
        # same taps in the same order; 1e-5 is the tolerance held against
        # the JAX package, whose convolution sums in another order
        torch.testing.assert_close(filters.gaussian_filter(k, 1.0),
                                   filters.gaussian_filter_plain(p, 1.0),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_extra", [0, 1, 4095])
def test_band_compact_kernel_matches_plain(dev, n_extra):
    from plant3dvision_tpu_torch.proc3d import band_compact, band_compact_plain
    rng = np.random.default_rng(3)
    shape = (16, 16, 16 + n_extra)
    d = torch.from_numpy((rng.random(shape) * 6 - 3).astype(np.float32)).to(dev)
    d[0, 0, :5] = torch.tensor([0.0, np.float32(np.sqrt(3)), -0.0, 1e-7, 2.0])
    gs = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          .to(dev) for _ in range(3)]
    for level in (0.0, 1.0, 50.0):                # 50: empty band
        k = band_compact(d, *gs, level)
        p = band_compact_plain(d, *gs, level)
        for a, b in zip(k, p):
            assert torch.equal(a, b)


def test_vol2pcd_cuda_matches_cpu(dev):
    from plant3dvision_tpu_torch.proc3d import vol2pcd
    vol = np.zeros((24, 24, 30), np.float32)
    vol[8:16, 8:16, 6:20] = 1.0
    a = vol2pcd(vol, np.zeros(3), 1.0, 1.0, device="cuda")
    b = vol2pcd(vol, np.zeros(3), 1.0, 1.0, device="cpu")
    np.testing.assert_allclose(a.points, b.points, atol=1e-4)
    np.testing.assert_allclose(a.normals, b.normals, atol=1e-4)


def test_entry_points_default_to_cuda(dev):
    from plant3dvision_tpu_torch.fsdb.testing import TemporaryDB
    from plant3dvision_tpu_torch.runtime import RunContext
    with TemporaryDB() as db:
        assert RunContext(db, "s").device.type == "cuda"


def _label_views(rng, B, C, H, W):
    from plant3dvision_tpu_torch.camera import pose_to_extrinsics
    from plant3dvision_tpu_torch.ops.carving import pack_camera
    cams = np.zeros((B, 16), np.float32)
    for v in range(B):
        a = 2 * np.pi * v / B + rng.uniform(0, 0.3)
        R, t = pose_to_extrinsics([30 * np.cos(a), 30 * np.sin(a),
                                   rng.uniform(-4, 6)], rng.uniform(-1, 1, 3))
        cams[v] = pack_camera([40.0, 42.0, W / 2 + 0.3, H / 2 - 0.2], R, t)
    probs = rng.random((B, C, H, W)).astype(np.float32)
    probs[:, :, 3:5, 4:9] = 0.0                       # log(EPS) taps
    return probs, cams


@pytest.mark.parametrize("sample", ["bilinear", "box"])
@pytest.mark.parametrize("log_mode", [False, True])
@pytest.mark.parametrize("C,shape,hw", [(6, (21, 9, 13), (24, 32)),
                                        (1, (7, 33, 5), (31, 17)),
                                        (8, (12, 12, 12), (2, 2))])
def test_accumulate_kernel_matches_plain(dev, sample, log_mode, C, shape,
                                         hw):
    """Every mode, odd sizes, an invalid (padded) view, a non-zero
    accumulator, whole grid and slab lane (x offsets 0, 3, 6, ...):
    bit-equal (the same f32 operations in the same order)."""
    from plant3dvision_tpu_torch.ops import ml_fused
    rng = np.random.default_rng(C)
    H, W = hw
    probs, cams = _label_views(rng, 5, C, H, W)
    valid = np.array([True, False, True, True, True])
    origin = np.array([-16.0, -7.0, -9.0], np.float32)
    vol0 = rng.random((C, *shape)).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (probs, cams, valid)]
    k = ml_fused.accumulate_label_views(torch.from_numpy(vol0).to(dev), *t,
                                        origin, 1.6, shape, log_mode, sample)
    p = ml_fused.accumulate_plain(torch.from_numpy(vol0).to(dev), *t, origin,
                                  1.6, 0, shape[0], log_mode, sample)
    assert torch.equal(k, p)
    assert (k != torch.from_numpy(vol0).to(dev)).any()
    nx_pad = -(-shape[0] // 3) * 3
    slab = torch.zeros((C, nx_pad, *shape[1:]), device=dev)
    slab[:, :shape[0]] = torch.from_numpy(vol0).to(dev)
    for xs in range(0, nx_pad, 3):
        ml_fused.accumulate_label_views_slab(slab, *t, origin, 1.6, xs, 3,
                                             log_mode, sample)
    assert torch.equal(slab[:, :shape[0]], k)


def test_accumulate_kernel_refuses_what_it_cannot_take(dev):
    from plant3dvision_tpu_torch.ops import ml_fused
    vol = torch.zeros((9, 4, 4, 4), device=dev)
    probs = torch.zeros((1, 9, 8, 8), device=dev)
    cams = torch.zeros((1, 16), device=dev)
    valid = torch.ones(1, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="8 labels"):
        ml_fused.accumulate(vol, probs, cams, valid, np.zeros(3), 1.0, 0, 4,
                            False)
    with pytest.raises(ValueError, match="CUDA"):
        ml_fused.accumulate(vol[:2], probs[:, :2].cpu(), cams, valid,
                            np.zeros(3), 1.0, 0, 4, False)


@pytest.mark.parametrize("bg", [0, 5, None])
@pytest.mark.parametrize("contrast_on", [False, True])
@pytest.mark.parametrize("L", [6, 2, 8])
def test_select_kernel_matches_plain(dev, bg, contrast_on, L):
    """Exact ties between organs and between the background and an organ
    (coarse score values), with and without a background label."""
    from plant3dvision_tpu_torch.ops import multiclass
    if bg is not None and bg >= L:
        bg = L - 1
    rng = np.random.default_rng(L)
    s = (rng.integers(0, 5, (L, 17, 19, 23)) / 4.0).astype(np.float32)
    s *= rng.random(s.shape) < 0.5
    stack = torch.from_numpy(s).to(dev)
    args = (1.0 if bg is None else 0.75, 10.0 if contrast_on else 1.0,
            0.2, bg, contrast_on)
    k = multiclass.select_labels(stack, *args)
    p = multiclass.select_labels_plain(stack, *args)
    assert k.dtype == torch.bool and torch.equal(k, p)
    assert k.any()
    if bg is not None:
        assert not k[bg].any()


def test_ml_entry_points_run_on_the_card(dev):
    """multiclass_select keeps its selections on the card, and vol2pcd
    takes them from there."""
    from plant3dvision_tpu_torch.ops.multiclass import multiclass_select
    from plant3dvision_tpu_torch.proc3d import vol2pcd
    vols = {l: np.zeros((24, 24, 30), np.float32)
            for l in ("background", "fruit", "stem")}
    vols["background"][:] = 1.0
    vols["fruit"][8:16, 8:16, 6:20] = 1.0
    sel = multiclass_select(vols, list(vols), 1.0, 1.0, 0.01)
    assert sel["fruit"].device.type == "cuda" and sel["fruit"].sum() > 0
    pcd = vol2pcd(sel["fruit"], np.zeros(3), 1.0, 0.2)
    assert len(pcd) > 100


# -- the separate-task ML route: K5-avg, K7, K8 --------------------------------

@pytest.mark.parametrize("log_masks", [False, True])
@pytest.mark.parametrize("shape,hw,x_offs", [((21, 9, 13), (24, 32), (0, 5)),
                                            ((7, 33, 5), (31, 17), (0, 3)),
                                            ((12, 12, 12), (2, 2), (0,))])
def test_average_kernel_matches_plain(dev, log_masks, shape, hw, x_offs):
    """K5-avg (one label's masks, log'd by the caller or not) at odd sizes,
    an invalid view, and slabs projected with their global x offsets:
    bit-equal to its plain version; the slab lane equals the whole grid."""
    from plant3dvision_tpu_torch.ops import carving
    rng = np.random.default_rng(len(x_offs))
    H, W = hw
    probs, cams = _label_views(rng, 5, 1, H, W)
    masks = probs[:, 0]
    if log_masks:
        masks = np.log(np.float32(1e-9) + masks)
    valid = np.array([True, False, True, True, True])
    origin = np.array([-16.0, -7.0, -9.0], np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (masks, cams, valid)]
    for xo in x_offs:
        k = carving.average(*t, origin, 1.6, shape, x_off=xo)
        p = carving.average_plain(*t, origin, 1.6, shape, x_off=xo)
        assert torch.equal(k, p)
        assert (k != 0).any()
    whole = carving.average(*t, origin, 1.6, shape)
    sx = shape[1] * shape[2] * 2                  # slabs of 2 x-rows
    assert torch.equal(carving.average_chunked(*t, origin, 1.6, shape,
                                               max_slab_voxels=sx), whole)


@pytest.mark.parametrize("L", [1, 2, 5, 6])
def test_reproject_kernel_matches_plain(dev, L):
    """K7 with points out of frame, behind the camera and on it (pz clamped
    to 1e-9), files of every label in mixed order, a label outside [0, L):
    bit-equal to its plain version (the same f32 operations and sums in
    file order)."""
    from plant3dvision_tpu_torch.ops.reproject import (
        score_points_by_masks, score_points_by_masks_plain)
    rng = np.random.default_rng(L)
    H, W, F = 37, 53, 3 * L + 2
    _, cams = _label_views(rng, F, 1, H, W)
    pts = rng.uniform(-12, 12, (4099, 3)).astype(np.float32)
    pts[:300] *= 5                                # behind some cameras
    R, tv = cams[0, 4:13].reshape(3, 3), cams[0, 13:16]
    pts[300] = -R.T @ tv                          # file 0's centre: p = 0
    masks = rng.integers(0, 256, (F, H, W), dtype=np.uint8)
    lab = rng.integers(0, L, F).astype(np.int32)
    lab[-1] = L                                   # adds nothing
    t = [torch.from_numpy(a).to(dev) for a in (pts, masks, cams, lab)]
    k = score_points_by_masks(*t, L)
    p = score_points_by_masks_plain(*t, L)
    assert k.shape == (4099, L) and torch.equal(k, p)
    assert (k > 0).any() and (k == 0).any()


@pytest.mark.parametrize("radius", [0, 1, 2, 3, 5])
def test_dilate_kernel_matches_plain(dev, radius):
    """K8 at radii 0-5 on sparse masks with set pixels on every frame edge
    and corner, a 1-pixel-wide stack and an empty mask: equal."""
    from plant3dvision_tpu_torch.ops.masks import (binary_dilation,
                                                   binary_dilation_plain)
    rng = np.random.default_rng(radius)
    for shape in ((4, 29, 41), (2, 1, 17), (1, 8, 8)):
        m = rng.random(shape) > 0.97
        m[0, 0, :] = m[0, -1, 0] = m[0, :, -1] = True
        m[-1] = False
        t = torch.from_numpy(m).to(dev)
        k = binary_dilation(t, radius)
        p = t if radius == 0 else binary_dilation_plain(t, radius)
        assert k.dtype == torch.bool and torch.equal(k, p)


# -- the real-scan front end: K9, K10, K11 -------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("channels", [None, 1, 3, 4])
@pytest.mark.parametrize("dist", [(0.0, 0.0, 0.0, 0.0),
                                  (-0.21, 0.07, 0.011, -0.007),
                                  (-0.21, 0.07, 0.011, -0.007, 0.013)])
def test_undistort_kernel_matches_plain(dev, dtype, channels, dist):
    """K9 on gray (2-D), 1-, 3- and 4-channel stacks of every type it takes,
    zero and nonzero distortion, len(dist) 4 and 5: bit-equal to its plain
    version (the same f32 operations, the same rounding)."""
    from plant3dvision_tpu_torch.ops.undistort import (undistort_batch,
                                                       undistort_plain)
    rng = np.random.default_rng(len(dist))
    H, W = 61, 83
    shape = (3, H, W) + (() if channels is None else (channels,))
    if dtype == np.float32:
        img = rng.random(shape).astype(dtype)
    else:
        img = rng.integers(0, 256 if dtype == np.uint8 else 65536, shape)
        img = img.astype(dtype)
    K = np.array([[W * 1.1 + 0.3, 0, W / 2 - 0.7],
                  [0, W * 1.08, H / 2 + 0.4], [0, 0, 1]], np.float32)
    t = torch.from_numpy(img).to(dev)
    k = undistort_batch(t, K, np.float32(dist))
    p = undistort_plain(t, K, np.float32(dist))
    assert k.dtype == p.dtype and torch.equal(k, p)
    assert (k != 0).any()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("lane", [("linear", (0.0, 1.0, 0.0), True),
                                  ("linear", (0.2, 0.7, 0.1), True),
                                  ("linear", (0.2, 0.5, 0.1, 0.3), False),
                                  ("excess_green", (0.0, 1.0, 0.0), True),
                                  ("excess_green", (0.0, 1.0, 0.0), False)])
def test_mask_kernel_matches_plain(dev, dtype, lane):
    """K10 in every lane (the uint8 fast lane, the linear filter over 3 and
    4 channels, excess green; binarised and clipped) on uint8, uint16 and
    float32 RGBA stacks: equal to its plain version."""
    from plant3dvision_tpu_torch.ops.masks import mask_filter, mask_filter_plain
    ftype, coefs, binarize = lane
    rng = np.random.default_rng(7)
    shape = (3, 37, 53, 4)
    if dtype == np.float32:
        img = (rng.random(shape) * 3 - 1).astype(dtype)
    else:
        img = rng.integers(0, 256 if dtype == np.uint8 else 65536, shape)
        img = img.astype(dtype)
    t = torch.from_numpy(img).to(dev)
    for thr in (0.15, 0.2, 0.3):
        k = mask_filter(t, ftype, coefs, thr, binarize)
        p = mask_filter_plain(t, ftype, coefs, thr, binarize)
        assert k.dtype == p.dtype and torch.equal(k, p)


@pytest.mark.parametrize("shape,vs", [((40, 37, 45), 0.5), ((17, 64, 9), 0.7)])
def test_kills_kernel_matches_plain(dev, shape, vs):
    """K11: count_kills (int16 counts, seen flags) and carve_tolerant at
    tolerances 0-3 with an invalid view: equal to their plain versions;
    carve_tolerant at 0 is the strict carve (K1)."""
    from plant3dvision_tpu_torch.ops import carving
    rng = np.random.default_rng(0)
    packed, cams, hw = _scene(rng)
    valid = np.ones(len(cams), bool)
    valid[3] = False
    args = (torch.from_numpy(packed).to(dev), torch.from_numpy(cams).to(dev),
            torch.from_numpy(valid).to(dev),
            -(np.array(shape) - 1) * vs / 2 + 0.3, vs, shape, hw)
    kills, seen = carving.count_kills(*args)
    kp, sp = carving.count_kills_plain(*args)
    assert kills.dtype == torch.int16 and seen.dtype == torch.bool
    assert torch.equal(kills, kp) and torch.equal(seen, sp)
    assert int(kills.max()) >= 3
    for tol in range(4):
        k = carving.carve_tolerant(*args, tol)
        assert torch.equal(k, carving.carve_tolerant_plain(*args, tol))
        assert torch.equal(k, carving.tolerance_verdict(kills, seen, tol))
    assert torch.equal(carving.carve_tolerant(*args, 0), carving.carve(*args))
