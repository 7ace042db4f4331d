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


@pytest.mark.parametrize("x_start,nx", [(0, 10), (13, 11), (30, 10)])
def test_carve_kernel_x_start_matches_plain_and_the_grid(dev, x_start, nx):
    """K1 with a global x offset (a slab of a sharded carve): bit-equal to
    its plain version and to rows [x_start, x_start + nx) of the whole
    grid's carve."""
    from plant3dvision_tpu_torch.ops.carving import carve, carve_plain
    rng = np.random.default_rng(1)
    packed, cams, hw = _scene(rng)
    shape, vs = (40, 37, 45), 0.5
    origin = -(np.array(shape) - 1) * vs / 2 + 0.3
    args = (torch.from_numpy(packed).to(dev), torch.from_numpy(cams).to(dev),
            torch.ones(len(cams), dtype=torch.bool, device=dev), origin, vs)
    whole = carve(*args, shape, hw)
    slab = (nx, *shape[1:])
    k = carve(*args, slab, hw, x_start=x_start)
    assert torch.equal(k, carve_plain(*args, slab, hw, x_start=x_start))
    assert torch.equal(k, whole[x_start:x_start + nx])


def test_carve_sharded_two_ranks_share_the_card(dev):
    """parallel.carving's view-sharded and grid-sharded carves with 2 ranks
    on the one card over gloo: bit-equal to K1 on one device; the ranks'
    K1 launches are merged into the controller's counts."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops.carving import carve
    from plant3dvision_tpu_torch.parallel.carving import (carve_grid_sharded,
                                                          carve_sharded)
    from plant3dvision_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(2)
    packed, cams, hw = _scene(rng)
    valid = np.ones(len(cams), bool)
    valid[5] = False
    shape, vs = (40, 37, 45), 0.5
    origin = -(np.array(shape) - 1) * vs / 2
    one = carve(torch.from_numpy(packed).to(dev),
                torch.from_numpy(cams).to(dev), torch.from_numpy(valid).to(dev),
                origin, vs, shape, hw)
    with make_mesh({"dp": 2}, device="cuda", backend="gloo",
                   timeout_s=120) as mesh:
        kernels.reset_launches()
        v = carve_sharded(packed, cams, valid, origin, vs, shape, mesh, hw=hw)
        assert kernels.LAUNCHES["carve"] == 2
        g = carve_grid_sharded(packed, cams, valid, origin, vs, shape, mesh,
                               hw=hw)
    assert v.device.type == "cuda" and torch.equal(v, one)
    assert torch.equal(g, one)


def _carve_case(rng, case):
    """(packed, cams, valid, origin, vs, shape, hw) of a K1 case, on the
    CPU (see test_carve_kernel_matches_plain_cases)."""
    if case == "views_300":
        packed, cams, hw = _scene(rng, V=300, H=36, W=48)
        valid = np.ones(300, bool)
        valid[[5, 140, 270]] = False
        shape, vs = (21, 18, 27), 0.9
    elif case == "all_invalid":
        packed, cams, hw = _scene(rng, V=7)
        valid = np.zeros(7, bool)
        shape, vs = (13, 12, 11), 1.0
    elif case == "behind":
        packed, cams, hw = _scene(rng, V=10)
        cams = cams.copy()
        cams[2, 15] = 0.0            # camera 2's centre plane through the grid
        cams[4, 2] += 10 * hw[1]     # view 4 out of frame everywhere
        valid = np.ones(10, bool)
        valid[0] = False
        shape, vs = (23, 19, 13), 1.1
    elif case == "group":            # phase 3's group: 100 views, 81x80x199
        packed, cams, hw = _scene(rng, V=100, H=270, W=360)
        valid = np.ones(100, bool)
        shape, vs = (81, 80, 199), 0.12
    else:                            # "grid": phase 4's 301x301x561 grid
        packed, cams, hw = _scene(rng, V=12, H=270, W=360)
        valid = np.ones(12, bool)
        shape, vs = (301, 301, 561), 0.05
    origin = -(np.array(shape) - 1) * vs / 2 + 0.3
    return packed, cams, valid, origin, vs, shape, hw


@pytest.mark.parametrize("case", ["views_300", "all_invalid", "behind",
                                  "group", "grid"])
def test_carve_kernel_matches_plain_cases(dev, case):
    """K1, one launch a call, bit-equal to its plain version: 300 views
    (two staged chunks, some invalid), every view invalid (all 0), a
    camera whose centre plane cuts the grid and a view out of frame, phase
    3's group shape (100 views into 81x80x199), phase 4's 301x301x561
    grid."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops.carving import carve, carve_plain
    rng = np.random.default_rng(3)
    packed, cams, valid, origin, vs, shape, hw = _carve_case(rng, case)
    args = (torch.from_numpy(packed).to(dev), torch.from_numpy(cams).to(dev),
            torch.from_numpy(valid).to(dev), origin, vs, shape, hw)
    before = kernels.LAUNCHES["carve"]
    k = carve(*args)
    assert kernels.LAUNCHES["carve"] - before == 1
    p = carve_plain(*args)
    assert torch.equal(k, p)
    if case == "all_invalid":
        assert not k.any()
    else:
        assert (k == -1).any()


@pytest.mark.parametrize("layout", ["packed_columns", "cameras_transposed",
                                    "valid_strided"])
def test_carve_kernel_takes_any_layout(dev, layout):
    """A column-sliced packed table (rows of k of a wider table's bytes), a
    transposed camera table and a strided valid vector: the kernel is given
    them in C order and equals the plain version on the same tensors."""
    from plant3dvision_tpu_torch.ops.carving import carve, carve_plain
    rng = np.random.default_rng(4)
    packed, cams, hw = _scene(rng)
    shape, vs = (40, 37, 45), 0.5
    pk = torch.from_numpy(packed).to(dev)
    cm = torch.from_numpy(cams).to(dev)
    va = torch.ones(len(cams), dtype=torch.bool, device=dev)
    if layout == "packed_columns":
        wide = torch.zeros((len(packed), packed.shape[1] + 37),
                           dtype=torch.uint8, device=dev)
        wide[:, :packed.shape[1]] = pk
        pk = wide[:, :packed.shape[1]]
    elif layout == "cameras_transposed":
        cm = cm.t().contiguous().t()
    else:
        every = torch.ones(2 * len(cams), dtype=torch.bool, device=dev)
        every[7] = False
        va = every[::2]
    args = (pk, cm, va, -(np.array(shape) - 1) * vs / 2 + 0.3, vs, shape, hw)
    assert not all(t.is_contiguous() for t in args[:3])
    assert torch.equal(carve(*args), carve_plain(*args))


def test_carve_kernel_refuses_grids_past_32_bit_indexes(dev):
    from plant3dvision_tpu_torch.ops.carving import carve
    rng = np.random.default_rng(0)
    packed, cams, hw = _scene(rng, V=3)
    args = (torch.from_numpy(packed).to(dev), torch.from_numpy(cams).to(dev),
            torch.ones(3, dtype=torch.bool, device=dev), (0.0, 0.0, 0.0), 1.0)
    with pytest.raises(ValueError, match="32-bit voxel indexes"):
        carve(*args, (2048, 1024, 1024), hw)


def _blobs(rng, shape):
    x = rng.random(shape).astype(np.float32)
    from scipy.ndimage import gaussian_filter
    return (gaussian_filter(x, 2.0) > 0.5).astype(np.float32)


@pytest.mark.parametrize("shape", [(30, 26, 41), (5, 64, 3), (200, 30, 30),
                                   (165, 146, 504), (4, 40, 2000),
                                   (3, 30, 1300)])
@pytest.mark.parametrize("cap", [3, 20, 130, None])
def test_signed_distance_kernel_matches_plain(dev, shape, cap):
    """K2, two launches a call, bit for bit in both lanes: the 16-bit lane
    (caps 3 and 20; cap None on the small grids), the 32-bit lane (the ML
    grid 165x146x504 at caps 130 and None, 200x30x30 at cap None); blocks
    of kR rows, and of fewer where a z row is long (4x40x2000 and
    3x30x1300: 8 rows, tests/test_torch_edt_lanes.py:test_block_rows)."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import edt
    rng = np.random.default_rng(1)
    vol = torch.from_numpy(_blobs(rng, shape) * 2 - 1).to(dev)
    before = kernels.LAUNCHES["signed_distance"]
    sd = edt.signed_distance(vol, cap)
    assert kernels.LAUNCHES["signed_distance"] - before == 2
    assert torch.equal(sd, edt.signed_distance_plain(vol, cap))   # exact
    assert torch.equal(edt.squared_edt(vol > 0, cap),
                       edt.squared_edt_plain(vol > 0, cap))


@pytest.mark.parametrize("shape,cap", [((2, 3, 30000), 20),
                                       ((2, 5, 20000), 130),
                                       ((3, 4, 20000), None),
                                       ((32770, 2, 3), None)])
def test_signed_distance_kernel_takes_any_shape(dev, shape, cap):
    """K2 where a z row does not fit in shared memory (30000 voxels in the
    16-bit lane, 20000 in the 32-bit: G through the spill buffer) and with
    a first-axis window past 32767 (cap None on 32770 x-positions, one
    column all inside): bit for bit, two launches a call."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import edt
    rng = np.random.default_rng(4)
    vol = torch.from_numpy(_blobs(rng, shape) * 2 - 1).to(dev)
    vol[:, 0, 0] = 1.0
    vol[0, 0, 0] = -1.0
    wide = int(not edt.lane16(edt.axis_caps(shape, cap)))
    assert kernels.lib().p3d_edt_yz_spills(shape[2], wide) == (shape[2] >= 20000)
    before = kernels.LAUNCHES["signed_distance"]
    sd = edt.signed_distance(vol, cap)
    assert kernels.LAUNCHES["signed_distance"] - before == 2
    assert torch.equal(sd, edt.signed_distance_plain(vol, cap))
    assert torch.equal(edt.squared_edt(vol > 0, cap),
                       edt.squared_edt_plain(vol > 0, cap))


@pytest.mark.parametrize("shape", [(30, 26, 41), (2, 9, 5), (2, 2, 2),
                                   (5, 5, 5), (33, 17, 65), (165, 146, 504)])
def test_gradient_gaussian_kernel_matches_plain(dev, shape):
    """K3 both ways, bit for bit: `gradient` and `gaussian_filter` alone
    (one launch per axis) against their plain versions, and the fused
    `smoothed_gradient` (one launch a call) against the plain composition,
    on short axes (several reflection periods), a ragged tile and the ML
    grid (165x146x504)."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import filters
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    plain = []
    for k, p in zip(filters.gradient(x), filters.gradient_plain(x)):
        assert torch.equal(k, p)
        plain.append(filters.gaussian_filter_plain(p, 1.0))
        assert torch.equal(filters.gaussian_filter(k, 1.0), plain[-1])
    before = kernels.LAUNCHES["gradient_gaussian"]
    fused = filters.smoothed_gradient(x, 1.0)
    assert kernels.LAUNCHES["gradient_gaussian"] - before == 1
    for k, p in zip(fused, plain):
        assert torch.equal(k, p)
    for sigma in (0.7, 1.2):                 # radius 3 and 5
        with pytest.raises(ValueError, match="radius of 4 only"):
            filters.smoothed_gradient(x, sigma)


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 16, 17), (16, 16, 4111),
                                   (64, 64, 192), (165, 146, 504)])
def test_band_compact_kernel_matches_plain(dev, shape):
    """K4 on one tile, a ragged last tile (n not a multiple of 4 or of the
    4096-voxel tile), 192 tiles (64^3 x 3) and the ML grid's shape: equal
    to its plain version for a thin band, a thick one, an empty one, a band
    that holds every voxel, and a distance view whose base is not 16-byte
    aligned (the scalar loads)."""
    from plant3dvision_tpu_torch.proc3d import band_compact, band_compact_plain
    rng = np.random.default_rng(3)
    d = torch.from_numpy((rng.random(shape) * 6 - 3).astype(np.float32)).to(dev)
    d[0, 0, :5] = torch.tensor([0.0, np.float32(np.sqrt(3)), -0.0, 1e-7, 2.0])
    gs = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          .to(dev) for _ in range(3)]
    shifted = torch.cat([d.new_zeros(1), d.reshape(-1)])[1:].view(shape)
    assert shifted.data_ptr() % 16 != 0
    cases = [(d, 0.0), (d, 1.0), (d, 50.0),      # 50: empty band
             (d * 0.25, 0.8),                    # every voxel in (-0.8, 0.93]
             (shifted, 1.0)]
    for dist, level in cases:
        k = band_compact(dist, *gs, level)
        p = band_compact_plain(dist, *gs, level)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        if level == 0.8:
            assert len(k[0]) == d.numel()
        if level == 50.0:
            assert len(k[0]) == 0


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
    from plant3dvision_tpu_torch.ops.carving import Backprojection
    with TemporaryDB() as db:
        assert RunContext(db, "s").device.type == "cuda"
    assert Backprojection((4, 4, 4), (0, 0, 0), 1.0).device.type == "cuda"


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


def _staging_views(rng, C, H, W):
    """Views of the (-8, 8)^3 box that the tiled kernel takes every way:
    far (windows staged), near (windows over the shared-memory budget),
    one camera inside the grid (tiles with corners behind it), one grazing
    the grid's top face, one invalid."""
    from plant3dvision_tpu_torch.camera import pose_to_extrinsics
    from plant3dvision_tpu_torch.ops.carving import pack_camera
    eyes = [(60, 5, 4), (-5, 70, -3), (0, -55, 20), (14, 3, 2), (9, -10, 1),
            (2.0, 1.0, 0.5), (40, 0, 8.2), (-50, -30, 0)]
    looks = [(0, 0, 0)] * 5 + [(9, 4, 0), (-40, 0, 8.0), (0, 0, 0)]
    cams = np.stack([pack_camera([60.0 + 10 * v, 58.0 + 9 * v,
                                  W / 2 + 0.4, H / 2 - 0.3],
                                 *pose_to_extrinsics(np.add(e, rng.uniform(
                                     -0.2, 0.2, 3)), t))
                     for v, (e, t) in enumerate(zip(eyes, looks))])
    probs = rng.random((len(eyes), C, H, W)).astype(np.float32)
    probs[:, :, 10:14, 20:31] = 0.0                   # log(EPS) taps
    valid = np.ones(len(eyes), bool)
    valid[-1] = False
    return probs, cams.astype(np.float32), valid


@pytest.mark.parametrize("sample,log_mode", [("bilinear", False),
                                             ("bilinear", True),
                                             ("box", False), ("box", True)])
@pytest.mark.parametrize("C", range(1, 9))
def test_accumulate_kernel_stages_every_way_bit_equal(dev, sample, log_mode,
                                                      C):
    """The tiled kernel on views that it stages, reads from global memory
    (windows over its budget; tiles behind a camera inside the grid), skips
    and grazes, over 2 + C labels' worth of odd tiles (37 x 21 x 45
    voxels): bit-equal to the plain version, whole grid and x slabs of 5
    (offsets 0, 5, ...); every tile-view status occurs."""
    from plant3dvision_tpu_torch.ops import ml_fused
    rng = np.random.default_rng(100 + C)
    H, W = 96, 128
    probs, cams, valid = _staging_views(rng, C, H, W)
    origin = np.array([-8.0, -8.0, -8.0], np.float32)
    shape, vs = (37, 21, 45), 0.37
    seen = set()
    for v in range(len(cams) - 1):
        st, _, _ = ml_fused.tile_windows(torch.from_numpy(cams[v]), origin,
                                         vs, 0, shape, (H, W), C,
                                         sample == "box")
        seen |= set(st.unique().tolist())
    assert seen == {ml_fused.SKIP, ml_fused.GLOBAL, ml_fused.STAGED}
    vol0 = rng.random((C, *shape)).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (probs, cams, valid)]
    k = ml_fused.accumulate_label_views(torch.from_numpy(vol0).to(dev), *t,
                                        origin, vs, shape, log_mode, sample)
    p = ml_fused.accumulate_plain(torch.from_numpy(vol0).to(dev), *t, origin,
                                  vs, 0, shape[0], log_mode, sample)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    nx_pad = -(-shape[0] // 5) * 5
    slab = torch.zeros((C, nx_pad, *shape[1:]), device=dev)
    slab[:, :shape[0]] = torch.from_numpy(vol0).to(dev)
    for xs in range(0, nx_pad, 5):
        ml_fused.accumulate_label_views_slab(slab, *t, origin, vs, xs, 5,
                                             log_mode, sample)
    assert torch.equal(slab[:, :shape[0]], k)


@pytest.mark.parametrize("log_masks", [False, True])
def test_average_kernel_stages_every_way_bit_equal(dev, log_masks):
    """K5-avg (the same tiled kernel at C = 1, `average`'s coordinates and
    association) on the staging scene, whole grid and slabs with their
    global x offsets: bit-equal to its plain version."""
    from plant3dvision_tpu_torch.ops import carving
    rng = np.random.default_rng(7)
    H, W = 96, 128
    probs, cams, valid = _staging_views(rng, 1, H, W)
    masks = probs[:, 0]
    if log_masks:
        masks = np.log(np.float32(1e-9) + masks)
    origin = np.array([-8.0, -8.0, -8.0], np.float32)
    shape, vs = (37, 21, 45), 0.37
    t = [torch.from_numpy(a).to(dev) for a in (masks, cams, valid)]
    for xo in (0, 3, 16):
        k = carving.average(*t, origin, vs, shape, x_off=xo)
        p = carving.average_plain(*t, origin, vs, shape, x_off=xo)
        torch.cuda.synchronize()
        assert torch.equal(k, p)
        assert (k != 0).any()
    whole = carving.average(*t, origin, vs, shape)
    sx = shape[1] * shape[2] * 6                  # slabs of 6 x-rows
    assert torch.equal(carving.average_chunked(*t, origin, vs, shape,
                                               max_slab_voxels=sx), whole)


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


@pytest.mark.parametrize("order", ["image_major", "label_major", "apart"])
@pytest.mark.parametrize("L", [1, 8])
def test_reproject_kernel_camera_runs(dev, order, L):
    """K7 over 2000 files (32 chunks of 64, the last one short): image-major
    (runs of L files that cross chunk edges), label-major (runs of one) and
    image-major with every other view's camera repeated two views later
    (equal cameras apart: separate runs); 5037 points (not a multiple of a
    block's 256), a file whose label is L: bit-equal to the plain
    version."""
    from plant3dvision_tpu_torch.ops.reproject import (
        camera_runs, score_points_by_masks, score_points_by_masks_plain)
    rng = np.random.default_rng(L)
    H, W, F = 37, 53, 2000
    V = F // L
    _, views = _label_views(rng, V, 1, H, W)
    if order == "apart":
        views[2::4] = views[0::4][:len(views[2::4])]
    cams = (np.tile(views, (L, 1)) if order == "label_major"
            else np.repeat(views, L, axis=0))
    lab = (np.repeat(np.arange(L), V) if order == "label_major"
           else np.tile(np.arange(L), V)).astype(np.int32)
    lab[5] = L                                    # adds nothing
    pts = rng.uniform(-12, 12, (5037, 3)).astype(np.float32)
    pts[:300] *= 5                                # behind some cameras
    masks = rng.integers(0, 256, (F, H, W), dtype=np.uint8)
    t = [torch.from_numpy(a).to(dev) for a in (pts, masks, cams, lab)]
    k = score_points_by_masks(*t, L)
    p = score_points_by_masks_plain(*t, L)
    assert k.shape == (5037, L) and torch.equal(k, p)
    assert (k > 0).any() and (k == 0).any()
    runs = camera_runs(t[2], None).numel()
    assert runs == {"image_major": V, "label_major": F, "apart": V}[order]


def test_dilate_kernel_at_the_evaluations_shape(dev):
    """K8 at r 2 as Segmentation2DEvaluation(dilation_amount=2) calls it
    (metrics.dilate_masks, one label's ground-truth stack in one call):
    126 x 896x896 uint8 masks of scattered organ-sized blobs, equal to the
    plain version on the card and to the CPU's dilation of the same
    masks, with one launch."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.metrics import dilate_masks
    from plant3dvision_tpu_torch.ops.masks import binary_dilation_plain
    rng = np.random.default_rng(2)
    small = rng.random((126, 56, 56)) > 0.97
    masks = (np.repeat(np.repeat(small, 16, 1), 16, 2)
             & (rng.random((126, 896, 896)) > 0.05)).astype(np.uint8) * 255
    kernels.reset_launches()
    got = dilate_masks(masks, 2, dev)
    assert kernels.LAUNCHES["dilate_disk"] == 1
    want = binary_dilation_plain(torch.from_numpy(masks != 0).to(dev), 2)
    np.testing.assert_array_equal(got, want.cpu().numpy())
    np.testing.assert_array_equal(got[:8], dilate_masks(masks[:8], 2, "cpu"))
    assert got.sum() > (masks != 0).sum()


DILATE_CASES = ([("radius", r) for r in (0, 1, 2, 3, 5, 6, 16, 35, 36)]
                + [("width", w) for w in (31, 32, 33, 63, 64, 65, 1440, 2100,
                                          4100)]
                + [("short", r) for r in (1, 3, 6, 35)]
                + [(name, 0) for name in ("wide_disk", "full", "empty",
                                          "unaligned", "keypoint_stack",
                                          "limit")])


@pytest.mark.parametrize("case", DILATE_CASES,
                         ids=[f"{n}-{v}" for n, v in DILATE_CASES])
def test_dilate_kernel_matches_plain(dev, case):
    """K8 against its plain version, equal:
    - radius: radii 0-36 (the limit) on sparse masks with set pixels on
      every frame edge and corner, a 1-pixel-high stack and an empty mask;
    - width: widths at word edges (31-65), 1440, and past one strip of
      words (2100 at r = 35, 4100 at r = 6);
    - short: heights 1 and below 2r + 1;
    - wide_disk: a disk wider and higher than the frame;
    - full / empty: all-true and all-false masks;
    - unaligned: a stack starting one byte past a 16-byte boundary;
    - keypoint_stack: the calibration's 60 x 1080x1440 masks at r = 6;
    - limit: a radius above 36 raises."""
    from plant3dvision_tpu_torch.ops.masks import (MAX_DILATION_RADIUS,
                                                   binary_dilation,
                                                   binary_dilation_plain)
    name, v = case
    rng = np.random.default_rng(sum(map(ord, name)) + v)

    def check(m, r):
        t = torch.from_numpy(np.ascontiguousarray(m)).to(dev)
        k = binary_dilation(t, r)
        p = t if r == 0 else binary_dilation_plain(t, r)
        assert k.dtype == torch.bool and torch.equal(k, p), (m.shape, r)

    if name == "radius":
        for shape in ((4, 29, 41), (2, 1, 17), (1, 8, 8)):
            m = rng.random(shape) > 0.97
            m[0, 0, :] = m[0, -1, 0] = m[0, :, -1] = True
            m[-1] = False
            check(m, v)
    elif name == "width":
        for r in ((35,) if v == 2100 else (6,) if v == 4100 else (1, 3, 6)):
            m = rng.random((3, 37, v)) > 0.995
            m[0, :, 0] = m[1, :, -1] = True
            check(m, r)
    elif name == "short":
        for H in sorted({1, 2 * v}):
            m = rng.random((3, H, 100)) > 0.98
            m[0, 0, 0] = m[-1, -1, -1] = True
            check(m, v)
    elif name == "wide_disk":
        m = np.zeros((2, 9, 13), bool)
        m[0, 4, 6] = m[1, 0, 12] = True
        check(m, 20)
    elif name in ("full", "empty"):
        for r in (1, 6, 35):
            check(np.full((2, 45, 70), name == "full"), r)
    elif name == "unaligned":
        flat = torch.from_numpy(rng.random(1 + 3 * 40 * 96) > 0.99).to(dev)
        t = flat[1:].view(3, 40, 96)
        assert t.is_contiguous() and t.data_ptr() % 16 == 1
        for r in (1, 6):
            assert torch.equal(binary_dilation(t, r),
                               binary_dilation_plain(t, r))
    elif name == "keypoint_stack":
        g = torch.Generator(device=dev).manual_seed(6)
        t = torch.rand((60, 1080, 1440), generator=g, device=dev) > 0.999
        assert torch.equal(binary_dilation(t, 6), binary_dilation_plain(t, 6))
    else:
        t = torch.zeros((1, 8, 8), dtype=torch.bool, device=dev)
        with pytest.raises(ValueError, match="radius up to 36"):
            binary_dilation(t, MAX_DILATION_RADIUS + 1)


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


#: a wide-angle lens that stretches corner tiles' source windows past the
#: kernel's budget (the global-load lane; tests/test_torch_undistort_tiles.py)
FOLDING = (0.5, 0.2, 0.01, -0.01, 0.05)


def _undistort_case(dev, case):
    """(images on the card, K, dist) of a K9 case."""
    from plant3dvision_tpu_torch.synth import turntable_cameras
    gen = torch.Generator(device=dev).manual_seed(0)

    def stack(shape, dtype=torch.uint8):
        if dtype == torch.float32:
            return torch.rand(shape, generator=gen, device=dev)
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=dtype)

    def camera(H, W, f):
        return np.array([[f, 0, W / 2 - 0.7], [0, f * 1.02, H / 2 + 0.4],
                         [0, 0, 1]], np.float32)

    strong = np.float32((-0.21, 0.07, 0.011, -0.007, 0.013))
    if case == "phase10":            # 58 x 1080x1440x3, k1 = -0.08
        K = turntable_cameras(1, f=1400.0, width=1440,
                              height=1080)[0][0].astype(np.float32)
        return stack((58, 1080, 1440, 3)), K, np.float32((-0.08, 0, 0, 0))
    if case == "edges_rgb":          # 203 x 300: neither tile side divides
        return stack((3, 203, 300, 3)), camera(203, 300, 330.0), strong
    if case == "edges_gray":
        return stack((3, 9, 129)), camera(9, 129, 140.0), strong
    if case == "small_frame":        # smaller than a tile
        return stack((4, 5, 37, 3)), camera(5, 37, 40.0), strong
    if case == "global_rgb":         # corner windows over the budget
        return stack((5, 203, 304, 3)), camera(203, 304, 150.0), \
            np.float32(FOLDING)
    if case == "global_one_f32":     # one channel: a 2-D image's lerps
        return stack((3, 203, 304, 1), torch.float32), \
            camera(203, 304, 150.0), np.float32(FOLDING)
    if case == "global_rgba_f32":
        return stack((3, 203, 304, 4), torch.float32), \
            camera(203, 304, 150.0), np.float32(FOLDING)
    if case == "unaligned":          # a stack starting at byte 1
        flat = stack((1 + 6 * 61 * 77 * 3,))
        return flat[1:].view(6, 61, 77, 3), camera(61, 77, 80.0), strong
    if case == "permuted":           # (N, C, H, W) seen as (N, H, W, C)
        return stack((4, 3, 61, 83)).permute(0, 2, 3, 1), \
            camera(61, 83, 90.0), strong
    if case == "rgba_sliced":        # RGBA -> RGB, a channel slice
        return stack((4, 61, 83, 4))[..., :3], camera(61, 83, 90.0), strong
    raise ValueError(case)


@pytest.mark.parametrize("case", ["phase10", "edges_rgb", "edges_gray",
                                  "small_frame", "global_rgb",
                                  "global_one_f32", "global_rgba_f32",
                                  "unaligned", "permuted",
                                  "rgba_sliced"])
def test_undistort_kernel_matches_plain_cases(dev, case):
    """K9 bit-equal to its plain version at tile and window edges (frames
    whose sides are not multiples of the tile's, a frame smaller than a
    tile), on phase 10's 58 x 1080x1440x3 stack, with tiles forced into
    the global-load lane, on a stack starting at byte 1, and on a permuted
    and a channel-sliced stack (copied into C order first). The kernel's
    lane counts equal `tile_windows`' prediction."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops.undistort import (tile_windows,
                                                       undistort_batch,
                                                       undistort_plain)
    imgs, K, dist = _undistort_case(dev, case)
    lanes = torch.zeros(3, dtype=torch.int32, device=dev)
    before = kernels.LAUNCHES["undistort"]
    k = undistort_batch(imgs, K, dist, lane_counts=lanes)
    assert kernels.LAUNCHES["undistort"] - before == 1
    p = undistort_plain(imgs, K, dist)
    assert k.dtype == p.dtype and torch.equal(k, p)
    assert k.is_contiguous() and (k != 0).any()
    C = imgs.shape[3] if imgs.ndim == 4 else 1
    t = tile_windows(imgs.shape[1:3], K, dist, C * imgs.element_size())
    want = [int(t["staged"].sum()), int((t["any"] & ~t["staged"]).sum()),
            int((~t["any"]).sum())]
    assert lanes.tolist() == want
    if case.startswith("global"):
        assert want[0] > 0 and want[1] > 0
    elif case == "phase10":
        assert want[1] == 0


def test_undistort_kernel_matches_plain_past_2_31_bytes(dev):
    """A 1400 x 1080x1440 gray stack (2.18 GB): the images past byte 2^31
    equal the plain version's."""
    from plant3dvision_tpu_torch.ops.undistort import (undistort_batch,
                                                       undistort_plain)
    gen = torch.Generator(device=dev).manual_seed(1)
    imgs = torch.randint(0, 256, (1400, 1080, 1440), generator=gen,
                         device=dev, dtype=torch.uint8)
    assert imgs.numel() > 2 ** 31
    K = np.array([[1400.0, 0, 720], [0, 1400.0, 540], [0, 0, 1]], np.float32)
    dist = np.float32((-0.08, 0.0, 0.0, 0.0))
    k = undistort_batch(imgs, K, dist)
    for sel in (slice(0, 2), slice(1379, 1382), slice(1397, 1400)):
        assert torch.equal(k[sel], undistort_plain(imgs[sel], K, dist))


MASK_LANES = [("linear", (0.0, 1.0, 0.0), True),
              ("linear", (0.2, 0.7, 0.1), True),
              ("linear", (0.2, 0.5, 0.1, 0.3), False),
              ("excess_green", (0.0, 1.0, 0.0), True),
              ("excess_green", (0.0, 1.0, 0.0), False)]


def _mask_stacks(dev, dtype, layout):
    """K10's test stacks. rgba: (3, 37, 53, 4), 5883 pixels (not a
    multiple of the kernel's 16-pixel run; runs span images); rgb: the
    same with 3 channels, and 5 images of 3 x 4 pixels (a run spans
    several); view: an RGB stack that starts at pixel 1 of a larger one,
    so its base is not 16-byte aligned; gray: (3, 37, 53) and (2, 16, 32);
    huge: one uint8 RGB stack of more than 2^31 bytes (the 64-bit
    indexes), made on the card."""
    if layout == "huge":
        g = torch.Generator(device=dev).manual_seed(7)
        return [torch.randint(0, 256, (684, 1024, 1024, 3), generator=g,
                              dtype=torch.uint8, device=dev)]
    rng = np.random.default_rng(7)
    shapes = {"rgba": [(3, 37, 53, 4)], "rgb": [(3, 37, 53, 3), (5, 3, 4, 3)],
              "view": [(4, 37, 53, 3)],
              "gray": [(3, 37, 53), (2, 16, 32)]}[layout]
    out = []
    for shape in shapes:
        if dtype == np.float32:
            img = (rng.random(shape) * 3 - 1).astype(dtype)
        else:
            img = rng.integers(0, 256 if dtype == np.uint8 else 65536, shape)
            img = img.astype(dtype)
        t = torch.from_numpy(img).to(dev)
        if layout == "view":
            N, H, W, C = shape
            t = t.reshape(-1, C)[1:1 + (N - 1) * H * W].view(N - 1, H, W, C)
            assert t.data_ptr() % 16 != 0
        out.append(t)
    return out


@pytest.mark.parametrize("case", [
    (dtype, lane, layout)
    for dtype in (np.uint8, np.uint16, np.float32)
    for lane in range(len(MASK_LANES))
    for layout in ("rgba", "rgb", "view", "gray")] + [(np.uint8, 0, "huge")])
def test_mask_kernel_matches_plain(dev, case):
    """K10 in every lane (the uint8 fast lane, the linear filter over 1, 3
    and 4 channels, excess green; binarised and clipped) on uint8, uint16
    and float32 stacks (_mask_stacks): equal to its plain version. Gray
    stacks have no excess green: both versions refuse it."""
    from plant3dvision_tpu_torch.ops.masks import mask_filter, mask_filter_plain
    dtype, lane, layout = case
    ftype, coefs, binarize = MASK_LANES[lane]
    for t in _mask_stacks(dev, dtype, layout):
        if ftype == "excess_green" and t.ndim == 3:
            for fn in (mask_filter, mask_filter_plain):
                with pytest.raises(ValueError, match="3 channels"):
                    fn(t, ftype, coefs, 0.15, binarize)
            continue
        for thr in (0.15, 0.2, 0.3):
            k = mask_filter(t, ftype, coefs, thr, binarize)
            p = mask_filter_plain(t, ftype, coefs, thr, binarize)
            assert k.dtype == p.dtype and torch.equal(k, p)
            if layout == "huge":
                assert 0 < int(k.sum()) < k.numel()


@pytest.mark.parametrize("shape,vs", [((40, 37, 45), 0.5), ((17, 64, 9), 0.7)])
def test_kills_kernel_matches_plain(dev, shape, vs):
    """K11: count_kills (int16 counts, seen flags) and carve_tolerant at
    tolerances 0-3 with an invalid view: equal to their plain versions;
    carve_tolerant at 0 is the strict carve (K1). nz = 45 and 9 are not
    multiples of count mode's z run of 8."""
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


@pytest.mark.parametrize("nz", [1, 7, 13])
def test_kills_kernel_out_of_frame_and_behind_the_camera(dev, nz):
    """K11 on a grid that some views see from behind (pz <= 0 on part of
    it), one view that sees none of it (all out of frame), and an nz of a
    partial z run; tolerances 0-3 against the plain versions."""
    from plant3dvision_tpu_torch.ops import carving
    rng = np.random.default_rng(5)
    packed, cams, hw = _scene(rng, V=10)
    cams = cams.copy()
    cams[2, 15] = 0.0            # camera 2's centre plane through the grid
    cams[4, 2] += 10 * hw[1]     # view 4 out of frame everywhere
    shape, vs = (23, 19, nz), 1.1
    args = (torch.from_numpy(packed).to(dev), torch.from_numpy(cams).to(dev),
            torch.ones(len(cams), dtype=torch.bool, device=dev),
            -(np.array(shape) - 1) * vs / 2, vs, shape, hw)
    behind = 0
    for v in (2,):
        c = cams[v]
        g = np.stack(np.meshgrid(*[np.float32(a) + np.float32(vs)
                                   * np.arange(n, dtype=np.float32)
                                   for a, n in zip(args[3], shape)],
                                 indexing="ij"), -1)
        behind += int(((g @ c[10:13]) + c[15] <= 0).sum())
    assert behind > 0
    kills, seen = carving.count_kills(*args)
    kp, sp = carving.count_kills_plain(*args)
    assert torch.equal(kills, kp) and torch.equal(seen, sp)
    for tol in range(4):
        assert torch.equal(carving.carve_tolerant(*args, tol),
                           carving.carve_tolerant_plain(*args, tol))


def test_kills_kernel_stages_the_cameras_in_chunks(dev):
    """More views than a block stages at once (300 > 256, one invalid):
    the kernel stages them a chunk at a time, equal to the plain version
    in both modes."""
    from plant3dvision_tpu_torch.ops import carving
    rng = np.random.default_rng(7)
    packed, cams, hw = _scene(rng, V=300, H=36, W=48)
    valid = np.ones(len(cams), bool)
    valid[270] = False
    shape, vs = (21, 18, 27), 0.9
    args = (torch.from_numpy(packed).to(dev), torch.from_numpy(cams).to(dev),
            torch.from_numpy(valid).to(dev),
            -(np.array(shape) - 1) * vs / 2, vs, shape, hw)
    kills, seen = carving.count_kills(*args)
    kp, sp = carving.count_kills_plain(*args)
    assert torch.equal(kills, kp) and torch.equal(seen, sp)
    assert int(kills.max()) > 10
    for tol in (0, 3, 40):
        assert torch.equal(carving.carve_tolerant(*args, tol),
                           carving.carve_tolerant_plain(*args, tol))


def _perturbed(cams, rng, B):
    """B candidate camera sets: the scene's cameras with their pixel
    centres shifted by up to 3 px."""
    c = np.repeat(cams[None], B, 0).copy()
    c[..., 2:4] += rng.uniform(-3, 3, (B, 1, 2)).astype(np.float32)
    return c


@pytest.mark.parametrize("B", [5, 1, 48])
@pytest.mark.parametrize("tol", [0, 2, 40, 400])
@pytest.mark.parametrize("shape,vs,views", [
    ((40, 37, 45), 0.5, 12), ((17, 64, 9), 0.7, 12),
    ((90, 80, 75), 0.25, 12), ((21, 18, 27), 0.9, 300)])
def test_carve_candidates_kernel_matches_plain(dev, shape, vs, views, tol, B):
    """K11b: B candidate camera sets over one shared mask stack: equal to
    the plain version, and each candidate equal to carve_tolerant(...) == 1.
    Tolerance 0 (the strict carve's alive set: voxels alive through every
    view), 2 (the robust hull's), and at or above the view count (no voxel
    is ever killed: alive = seen); one candidate over a grid of 540 K
    voxels (the polish's robust hull), a CEM population of 48; 300 views,
    more than a block stages at once."""
    from plant3dvision_tpu_torch.ops import carving
    rng = np.random.default_rng(1)
    packed, cams, hw = (_scene(rng) if views == 12
                        else _scene(rng, V=views, H=36, W=48))
    cand = torch.from_numpy(_perturbed(cams, rng, B)).to(dev)
    pk = torch.from_numpy(packed).to(dev)
    origin = -(np.array(shape) - 1) * vs / 2 + 0.3
    k = carving.carve_candidates(pk, cand, origin, vs, shape, hw, tol)
    p = carving.carve_candidates_plain(pk, cand, origin, vs, shape, hw, tol)
    assert k.dtype == torch.bool and tuple(k.shape) == (B, *shape)
    assert torch.equal(k, p)
    valid = torch.ones(len(cams), dtype=torch.bool, device=dev)
    for b in range(B):
        assert torch.equal(k[b], carving.carve_tolerant(
            pk, cand[b].contiguous(), valid, origin, vs, shape, hw, tol) == 1)
    assert not k.all()
    # (300 views of 2 % speckle leave few voxels alive at tolerance 0)
    if views == 12 or tol > 0:
        assert k.any()
        if B > 1:
            assert not torch.equal(k[0], k[1])


def _coverage_case(rng, dev, shape, N, NB, hull="random"):
    """Cameras, samples and NB hulls for K12: a sample in 7 aims far off the
    grid (its ray misses the box); the hulls random, all dead or all
    alive (a ray that meets the box then hits at its first step)."""
    packed, cams, hw = _scene(rng)
    V = len(cams)
    H, W = hw
    uv = np.stack([rng.uniform(W / 2 - 14, W / 2 + 14, (V, N)),
                   rng.uniform(H / 2 - 14, H / 2 + 14, (V, N))],
                  -1).astype(np.float32)
    uv[:, ::7, 0] = -2.0 * W
    valid = rng.random((V, N)) > 0.1
    alive = {"random": rng.random((NB, *shape)) > 0.95,
             "dead": np.zeros((NB, *shape), bool),
             "alive": np.ones((NB, *shape), bool)}[hull]
    return (torch.from_numpy(cams).to(dev), torch.from_numpy(uv).to(dev),
            torch.from_numpy(valid).to(dev), torch.from_numpy(alive).to(dev))


@pytest.mark.parametrize("hull", ["random", "dead", "alive"])
@pytest.mark.parametrize("N", [256, 100, 9, 192])
@pytest.mark.parametrize("shape,n_steps,vs", [
    ((24, 22, 30), 37, 1.0), ((16, 16, 16), 1, 1.5), ((12, 11, 15), 67, 2.0),
    ((6, 6, 8), 160, 4.0), ((34, 31, 43), 160, 0.7)])
def test_ray_coverage_kernel_matches_plain(dev, shape, n_steps, vs, N, hull):
    """K12: CEM-like groups (a volume per candidate, three volumes, every
    view) and polish-like groups (one volume, several cameras per view):
    the integer counts equal the plain version's. Sample counts with and
    without a scalar tail (N = 100, 9) and the CEM's and the polish's (192,
    256); step counts that are not multiples of the lanes a ray (37, 67)
    and the polish's 160; power-of-two voxel sizes (1, 2, 4: the step
    multiplies by the reciprocal) and others (1.5 on a cube, 0.7); rays
    that miss the box; random, all-dead and all-alive hulls."""
    from plant3dvision_tpu_torch.ops import selfcal
    rng = np.random.default_rng(2)
    cams, uv, valid, alive = _coverage_case(rng, dev, shape, N, 3, hull)
    V = cams.shape[0]
    origin = np.array([-12.0, -11.5, -12.2], np.float32)
    shift = torch.zeros((4, 16), device=dev)
    shift[:, 2] = torch.tensor([-1.5, -0.5, 0.5, 1.5])
    groups = [
        (cams.repeat(3, 1), torch.arange(3, device=dev).repeat_interleave(V),
         torch.arange(V, device=dev).repeat(3)),
        (cams.repeat_interleave(4, 0) + shift.repeat(V, 1),
         torch.zeros(4 * V, dtype=torch.int64, device=dev),
         torch.arange(V, device=dev).repeat_interleave(4))]
    for cg, vol_of, view_of in groups:
        args = (cg.contiguous(), vol_of.to(torch.int32),
                view_of.to(torch.int32), alive, uv, valid, origin, vs, shape,
                n_steps)
        kc, kv = selfcal.ray_coverage_counts(*args)
        pc, pv = selfcal.ray_coverage_counts_plain(*args)
        assert kc.dtype == torch.int32
        assert torch.equal(kc, pc) and torch.equal(kv, pv)
        if hull == "dead":
            assert int(kc.sum()) == 0 and int(kv.sum()) > 0
        else:
            assert int(kc.sum()) > 0 and bool((kc < kv).any())


@pytest.mark.parametrize("shape", [(3, 72, 96), (2, 37, 53)])
def test_harris_kernel_matches_plain(dev, shape):
    """K13 on smoothed noise with a mask: the response equal to the plain
    version's at every candidate, the same candidate set (-inf elsewhere),
    and harris_keypoints picks the same corners."""
    from plant3dvision_tpu_torch.ops import sfmlite
    rng = np.random.default_rng(3)
    g = rng.standard_normal(shape).astype(np.float32)
    for ax in (1, 2):
        g = (g + np.roll(g, 1, ax) + np.roll(g, -1, ax)) / 3
    gray = torch.from_numpy(g.astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(shape) > 0.2).to(dev)
    k = sfmlite.harris_response(gray, mask, 8, 0.06)
    p = sfmlite.harris_response_plain(gray, mask, 8, 0.06)
    assert torch.equal(torch.isfinite(k), torch.isfinite(p))
    assert int(torch.isfinite(k).sum()) > 20
    assert torch.equal(k, p)
    uk, sk = sfmlite.harris_keypoints(gray, mask, k=36, border=8)
    up, sp = sfmlite.harris_keypoints(gray.cpu(), mask.cpu(), k=36, border=8)
    assert torch.equal(uk.cpu(), up) and torch.equal(sk.cpu(), sp)


HARRIS_CASES = ([("shape", s) for s in ((1, 33, 121), (2, 97, 241),
                                         (3, 65, 124), (1, 1080, 1443),
                                         (12, 1080, 1440))]
                + [("rows", r) for r in (1, 7, 64)]
                + [(name, 0) for name in ("empty_mask", "constant",
                                          "unaligned", "small")])


@pytest.mark.parametrize("case", HARRIS_CASES,
                         ids=[f"{a}-{b}" for a, b in HARRIS_CASES])
def test_harris_kernel_strip_edges(dev, monkeypatch, case):
    """K13's march at its edges: widths and heights that are not multiples
    of the strip (120 columns) or the band (HARRIS_ROWS), a width that is
    not a multiple of 4 (the scalar lane), a full calibration chunk, bands
    of 1, 7 and 64 rows, an all-false mask, a constant image (r = 0: every
    pixel ties), a stack that starts one pixel into its storage (unaligned),
    a frame smaller than a strip: bit-equal to the plain version, one
    launch a call."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import sfmlite
    kind, arg = case
    shape = arg if kind == "shape" else (2, 75, 248)
    if kind == "small":
        shape = (3, 9, 11)
    if kind == "rows":
        monkeypatch.setattr(sfmlite, "HARRIS_ROWS", arg)
    rng = np.random.default_rng(len(shape) + shape[-1])
    g = rng.standard_normal(shape).astype(np.float32)
    for ax in (1, 2):
        g = (g + np.roll(g, 1, ax) + np.roll(g, -1, ax)) / 3
    gray = torch.from_numpy(g.astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(shape) > 0.2).to(dev)
    if kind == "empty_mask":
        mask[:] = False
    elif kind == "constant":
        gray[:] = 0.375
    elif kind == "unaligned":
        gray = torch.cat([torch.zeros(1, device=dev),
                          gray.flatten()])[1:].view(shape)
        mask = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                          mask.flatten()])[1:].view(shape)
    border = 3 if kind == "small" else 8
    before = kernels.LAUNCHES["harris_response"]
    k = sfmlite.harris_response(gray, mask, border, 0.06)
    assert kernels.LAUNCHES["harris_response"] == before + 1
    p = sfmlite.harris_response_plain(gray, mask, border, 0.06)
    assert torch.equal(k, p)
    kept = int(torch.isfinite(k).sum())
    if kind == "empty_mask":
        assert kept == 0
    elif kind == "constant":
        assert kept > 1000 and bool((k[torch.isfinite(k)] == 0).all())
    else:
        assert kept > 0


# -- K14 (eikonal sweeps), K15 (geodesic tracing), the repeatable BA ----------

def _tube(length, width=1):
    """A straight tube along z seeded at z = 0: the front moves a voxel a
    sweep, so the loop stops at sweep `length` (the first with |du| = 0)."""
    mask = np.zeros((width + 2, width + 2, length), bool)
    mask[1:-1, 1:-1, :] = True
    seeds = np.zeros_like(mask)
    seeds[1:-1, 1:-1, 0] = True
    return mask, seeds


def _blob_mask(rng, shape, n=14):
    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"),
                 -1).astype(np.float32)
    mask = np.zeros(shape, bool)
    for c, r in zip(rng.uniform(0, 1, (n, 3)) * np.array(shape),
                    rng.uniform(3, 9, n)):
        mask |= ((g - c) ** 2).sum(-1) < r * r
    seeds = np.zeros_like(mask)
    z0 = np.nonzero(mask.any((0, 1)))[0].min()
    seeds[:, :, z0] = mask[:, :, z0]
    return mask, seeds


def _eikonal_both(dev, mask, seeds, speed=None, **kw):
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops.eikonal import (
        geodesic_distance, geodesic_distance_plain)
    args = [torch.from_numpy(mask).to(dev), torch.from_numpy(seeds).to(dev),
            None if speed is None else torch.from_numpy(speed).to(dev)]
    before = kernels.LAUNCHES["eikonal_sweep"]
    k, nk = geodesic_distance(*args, return_sweeps=True, **kw)
    launches = kernels.LAUNCHES["eikonal_sweep"] - before
    p, np_ = geodesic_distance_plain(*args, return_sweeps=True, **kw)
    # one launch a solve (none when nothing is active or max_iters is 0)
    solves = bool((mask & ~seeds).any()) and kw.get("max_iters", 1) > 0
    assert launches == int(solves)
    return k, nk, p, np_


@pytest.mark.parametrize("speed", [False, True])
@pytest.mark.parametrize("seed,shape", [(0, (48, 40, 64)), (1, (33, 29, 71))])
def test_eikonal_kernel_matches_plain(dev, seed, shape, speed):
    """K14 bit-equal to its plain version on seeded blob masks, with the
    same sweep count (the stop test on the device)."""
    rng = np.random.default_rng(seed)
    mask, seeds = _blob_mask(rng, shape)
    sp = (rng.uniform(0.3, 2.0, shape).astype(np.float32) if speed
          else None)
    k, nk, p, np_ = _eikonal_both(dev, mask, seeds, sp)
    assert nk == np_ > 5
    assert torch.equal(k, p)
    assert (k < 1e9).sum() > 300


@pytest.mark.parametrize("length", [1, 63, 64, 65, 130])
def test_eikonal_kernel_stops_at_the_plain_sweep(dev, length):
    """One launch a solve stops at sweep 1 (nothing to update), and at
    sweeps 63, 64, 65 and 130 (where the old batched launches turned), with
    one host read (the sweep count) after the compaction's nonzero."""
    import warnings
    from plant3dvision_tpu_torch.ops.eikonal import geodesic_distance
    mask, seeds = _tube(length)
    k, nk, p, np_ = _eikonal_both(dev, mask, seeds)
    assert nk == np_ == max(length, 1)
    assert torch.equal(k, p)
    m, s = torch.from_numpy(mask).to(dev), torch.from_numpy(seeds).to(dev)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            geodesic_distance(m, s)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if str(w.message).startswith(
        "called a synchronizing CUDA operation")]
    assert len(syncs) == (2 if length > 1 else 1), [str(w.message)
                                                    for w in syncs]


@pytest.mark.parametrize("max_iters", [0, 1, 10, 64, 65])
def test_eikonal_kernel_max_iters_binds(dev, max_iters):
    mask, seeds = _tube(150)
    k, nk, p, np_ = _eikonal_both(dev, mask, seeds, max_iters=max_iters)
    assert nk == np_ == max_iters
    assert torch.equal(k, p)


def test_eikonal_kernel_large_active_set(dev):
    """An active set of 409.6 K voxels, more than the cooperative grid's
    threads, so that each thread updates several voxels a sweep:
    bit-equal to the plain version, at the same sweep count."""
    nx, ny, nz = 80, 80, 64
    mask = np.zeros((nx, ny, nz + 1), bool)
    mask[:, :, 1:] = True
    seeds = np.zeros_like(mask)
    seeds[:, :, 1] = True
    mask[:, :, 0] = True             # below the seed plane: nx * ny more
    assert int((mask & ~seeds).sum()) == nx * ny * nz
    k, nk, p, np_ = _eikonal_both(dev, mask, seeds)
    assert nk == np_ > 5
    assert torch.equal(k, p)


@pytest.mark.parametrize("max_iters", [0, 1, 10])
def test_eikonal_kernel_empty_active_set(dev, max_iters):
    """Nothing to update (every mask voxel a seed, or an empty mask): no
    launch, the initial field, min(max_iters, 1) sweeps as the plain
    version counts."""
    mask = np.zeros((5, 6, 7), bool)
    mask[1:3, 2:4, 3] = True
    for seeds in (mask.copy(), np.zeros_like(mask)):
        m = mask if seeds.any() else np.zeros_like(mask)
        k, nk, p, np_ = _eikonal_both(dev, m, seeds, max_iters=max_iters)
        assert nk == np_ == min(max_iters, 1)
        assert torch.equal(k, p)


def test_eikonal_kernel_refuses_what_it_cannot_take(dev):
    from plant3dvision_tpu_torch.ops.eikonal import geodesic_distance
    mask, seeds = _tube(8)
    m = torch.from_numpy(mask).to(dev)
    with pytest.raises(ValueError):
        geodesic_distance(m, torch.from_numpy(seeds))        # two devices
    with pytest.raises(ValueError):
        geodesic_distance(m.float(), m)                      # not bool
    with pytest.raises(ValueError):
        geodesic_distance(m.transpose(0, 2), m.transpose(0, 2))  # strided


def _trace_case(rng, case):
    """(mask, seeds, tips) of a K15 case."""
    import scipy.ndimage as ndi
    if case.startswith("blob"):
        mask, seeds = _blob_mask(rng, (40, 36, 60))
    else:                                   # a straight tube along z
        nz = 1100 if case == "all_steps" else 160
        mask = np.zeros((10, 9, nz), bool)
        mask[3:7, 3:6, :] = True
        seeds = np.zeros_like(mask)
        seeds[3:7, 3:6, 0] = True
    if case == "all_steps":                 # 1000 voxels of 2000 steps
        return mask, seeds, np.array([[4.5, 4.2, 1098.0]], np.float32)
    if case == "one_voxel":                 # 300 particles, one path
        return mask, seeds, np.tile([[4.4, 4.6, 150.3]], (300, 1)).astype(
            np.float32)
    d = _trace_distance(mask, seeds)
    dn = np.where(mask & (d < 1e9), d, -1)
    tips = np.argwhere((dn == ndi.maximum_filter(dn, size=3)) & (dn > 2))
    tips = np.concatenate([tips, tips + rng.uniform(-0.4, 0.4, tips.shape),
                           [[39.5, 35.2, 59.9]]])
    if case == "faces":                     # a tip on each face, past n - 2
        n = np.array(mask.shape, np.float32)
        inner = np.argwhere(mask)[int(mask.sum()) // 2].astype(np.float32)
        for a in range(3):
            for v in (0.0, n[a] - 1.001, n[a] - 1.5, n[a] - 0.75):
                t = inner.copy()
                t[a] = v
                tips = np.concatenate([tips, t[None]])
    return mask, seeds, tips.astype(np.float32)


def _trace_distance(mask, seeds):
    from plant3dvision_tpu_torch.ops.eikonal import geodesic_distance
    return geodesic_distance(torch.from_numpy(mask), torch.from_numpy(
        seeds)).numpy()


@pytest.mark.parametrize("case", ["blob0", "blob1", "faces", "long",
                                  "all_steps", "one_voxel"])
def test_trace_kernel_matches_plain(dev, case):
    """K15's votes equal its plain version's on the flow of a blob's
    distance map, from tips at the distance's local maxima (and jittered
    copies), with extrapolating start points past n - 2; tips on each of
    the grid's faces; walks down a 160-voxel tube; one walk of all 2000
    steps; 300 particles voting the same voxels; a flow that is not in C
    order (copied first)."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops.eikonal import (geodesic_distance,
                                                     gradient_flow)
    from plant3dvision_tpu_torch.ops.geodesics import (trace_geodesics,
                                                       trace_geodesics_plain)
    rng = np.random.default_rng(int(case[-1]) if case[-1].isdigit() else 0)
    mask, seeds, tips = _trace_case(rng, case)
    m = torch.from_numpy(mask).to(dev)
    d = geodesic_distance(m, torch.from_numpy(seeds).to(dev))
    flow = gradient_flow(d, m)
    values = torch.where(m, d, 0.0)
    t = torch.from_numpy(tips).to(dev)
    before = kernels.LAUNCHES["trace_geodesics"]
    vk = trace_geodesics(flow, values, t, step=0.5, n_steps=2000)
    assert kernels.LAUNCHES["trace_geodesics"] - before == 1
    vp, steps = trace_geodesics_plain(flow, values, t, step=0.5,
                                      n_steps=2000, return_steps=True)
    assert vk.dtype == torch.int32
    assert torch.equal(vk, vp)
    assert int(vk.sum()) > 100
    if case == "blob1":
        strided = torch.empty((3,) + tuple(values.shape), device=dev)
        strided = strided.permute(1, 2, 3, 0)
        strided.copy_(flow)
        assert torch.equal(trace_geodesics(strided, values, t), vk)
    if case == "all_steps":
        assert int(steps.max()) == 2000 and int(vk.sum()) == 2000
    if case == "one_voxel":     # one path: every count a multiple of 300
        assert int(vk.max()) >= 300 and not bool((vk % 300).any())


def test_trace_step_floor_runs(dev):
    """The floor of a step (one warp's dependent steps, every read an L1
    hit) launches and writes its sink."""
    from plant3dvision_tpu_torch import kernels
    sink = torch.zeros(1, device=dev)
    scratch = torch.zeros(4 * 4096, device=dev)
    scratch[3 * 4096:] = 1.0
    so = kernels.lib()
    for iters in (1, 1000):
        kernels.check("trace_step_floor", so.p3d_trace_step_floor(
            iters, scratch.data_ptr(), sink.data_ptr(),
            kernels.stream_ptr(dev)))
        torch.cuda.synchronize()
        assert float(sink) > 0


def _ba_scene(V=12, W=320, H=240, seed=3):
    """A ring of turntable views of random points (the JAX unit test's
    scene, built with the port's cameras): the matches refine_turntable
    takes, with 0.3 px noise."""
    from plant3dvision_tpu_torch.ops.selfcal import cnc_to_cameras
    rng = np.random.default_rng(seed)
    ang = 360.0 * np.arange(V) / V
    poses = np.stack([200 * np.cos(np.deg2rad(ang)),
                      200 * np.sin(np.deg2rad(ang)), np.full(V, 60.0),
                      ang + 90.0, np.zeros(V)], 1).astype(np.float32)
    theta = np.zeros(9, np.float32)
    theta[[0, 3, 6, 7]] = 260.0, 1.0, 3.0, -2.0
    true = poses.copy()
    true[:, 3] += 0.15 * rng.standard_normal(V).astype(np.float32)
    cams = cnc_to_cameras(torch.from_numpy(true), torch.from_numpy(theta),
                          W, H).numpy()
    pts = np.stack([rng.uniform(-30, 30, 300), rng.uniform(-30, 30, 300),
                    rng.uniform(10, 120, 300)], 1)
    uv = {}
    for v in range(V):
        q = pts @ cams[v, 4:13].reshape(3, 3).T + cams[v, 13:16]
        uv[v] = (q[:, :2] / q[:, 2:] * cams[v, :2] + cams[v, 2:4]
                 + 0.3 * rng.standard_normal((len(pts), 2)))
    cols = {n: [] for n in ("va", "vb", "ua", "ub", "ka", "kb")}
    for s in (1, 2, 4):
        for a in range(V):
            b = (a + s) % V
            ok = np.nonzero((((uv[a] > 8) & (uv[a] < [W - 8, H - 8]))
                             & ((uv[b] > 8) & (uv[b] < [W - 8, H - 8])))
                            .all(1))[0]
            for n, x in (("va", np.full(len(ok), a)), ("vb", np.full(len(ok), b)),
                         ("ua", uv[a][ok]), ("ub", uv[b][ok]), ("ka", ok),
                         ("kb", ok)):
                cols[n].append(x)
    m = {n: np.concatenate(v) for n, v in cols.items()}
    for n in ("va", "vb", "ka", "kb"):
        m[n] = m[n].astype(np.int32)
    for n in ("ua", "ub"):
        m[n] = m[n].astype(np.float32)
    theta0 = np.zeros(9, np.float32)
    theta0[0], theta0[3] = 240.0, 0.7
    return m, poses, theta0, W, H


def test_bundle_adjustment_repeats_bit_for_bit(dev):
    """Two runs of refine_turntable on one set of matches give bit-equal
    parameters on the card (the track sums take a fixed order; no float
    atomics), and the BA converges."""
    from plant3dvision_tpu_torch.ops.sfmlite import refine_turntable
    m, poses, theta0, W, H = _ba_scene()
    a = refine_turntable(m, poses, theta0, W, H, device=dev)
    b = refine_turntable(m, poses, theta0, W, H, device=dev)
    np.testing.assert_array_equal(a["theta_raw"], b["theta_raw"])
    for k in ("dpan_view", "dtilt_view", "droll_view"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["k1"] == b["k1"] and a["rms_px"] == b["rms_px"]
    assert abs(a["theta"]["f"] - 260.0) < 2.6 and a["rms_px"] < 1.0


# -- K16: the int8 serving lane's convolution ---------------------------------------

#: (kernel, stride, cin, cout): the committed nets' kinds (the 7x7 stem
#: from 3 channels, 1x1 and 3x3 at stride 2, Cout 12, Cin not a multiple of
#: 32), every tile configuration of the conv (16 to 256 output channels a
#: block, and Cout above 256), and Cins of 16 to 113 depth chunks
INT8_KINDS = [(7, 2, 3, 24), (3, 1, 24, 24), (3, 2, 48, 96), (1, 2, 24, 48),
              (3, 1, 512, 20), (3, 1, 1024, 16), (3, 1, 12, 12),
              (3, 1, 72, 24), (3, 1, 144, 48), (3, 1, 288, 96),
              (3, 1, 128, 256), (1, 2, 256, 256), (3, 2, 128, 256),
              (1, 1, 96, 300)]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw", [(33, 30), (16, 18), (5, 301)])
@pytest.mark.parametrize("kind", INT8_KINDS,
                         ids=lambda k: "k%ds%dc%dk%d" % k)
def test_int8_conv_kernel_matches_plain(dev, kind, hw, dtype, bias):
    """K16 (absmax + the conv that quantises as it stages) against the
    plain version on the card: bit for bit (exact int32 sums, the same f32
    quantisation, scale and fma), with ragged pixel tiles at every edge
    (rows of 30, 18 and 301 pixels against tiles of 64-256)."""
    from plant3dvision_tpu_torch.models import quant
    from plant3dvision_tpu_torch.models.segnet import _same_pads
    k, s, cin, cout = kind
    rng = np.random.default_rng(k * 7 + cin)
    x = torch.from_numpy(rng.standard_normal((2, cin, *hw)).astype(
        np.float32)).to(dev, dtype)
    w = torch.from_numpy((0.1 * rng.standard_normal((cout, cin, k, k)))
                         .astype(np.float32)).to(dev, dtype)
    b = (torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
         .to(dev, dtype) if bias else None)
    pads = (_same_pads(hw[0], k, s), _same_pads(hw[1], k, s))
    got = quant.int8_conv(x, w, b, s, pads)
    want = quant.int8_conv_plain(x, w, b, s, pads)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    # the weight quantised once (as the lane does) gives the same
    qw = quant.quantize_weight(w)
    pw = quant.quantize_weight_plain(w)
    assert qw.q is None and torch.equal(qw.amax, pw.amax)
    assert torch.equal(qw.packed, quant.pack_weight(pw.q, qw.plan))
    assert torch.equal(quant.int8_conv(x, qw, b, s, pads), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_conv_kernel_quantises_every_bf16_value(dev, dtype):
    """Every finite bf16 value (65,280, also as float32) through a 1x1
    conv that passes one channel on, under 12 absmaxes from 1e-30 to
    bf16's largest: the conv's division-free quantisation gives the plain
    version's output bit for bit. Rows of 63 values in an odd count: a
    bf16 tensor of odd size, copied 4 bytes at a time, ends mid-unit."""
    from plant3dvision_tpu_torch.models import quant
    bf = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    bf = bf[torch.isfinite(bf.float())].to(dev)
    w = torch.ones((1, 1, 1, 1), device=dev, dtype=dtype)
    for amax in [1e-30, 1e-8, 3e-6, 0.01, 0.7, 1.0, 127.0, 1000.0, 6.1e4,
                 1e20, 1e30, 3.3895314e38]:
        v = bf[bf.float().abs() <= amax]
        x = torch.cat([v, torch.tensor([amax], device=dev).to(
            torch.bfloat16)]).to(dtype)
        rows = x.numel() // 63 - (1 - x.numel() // 63 % 2)
        x = x[:rows * 63].view(1, 1, rows, 63).contiguous()
        got = quant.int8_conv(x, w, None, 1, ((0, 0), (0, 0)))
        want = quant.int8_conv_plain(x, w, None, 1, ((0, 0), (0, 0)))
        assert torch.equal(got, want), amax


def test_int8_conv_kernel_floors_and_counts(dev):
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.models import quant
    x = torch.zeros((1, 5, 9, 8), device=dev)
    w = torch.ones((4, 5, 3, 3), device=dev)
    w[2] = 0
    kernels.reset_launches()
    got = quant.int8_conv(x, w, None, 1, ((1, 1), (1, 1)))
    assert kernels.LAUNCHES["int8_quantize"] == 1      # the weight
    assert kernels.LAUNCHES["int8_absmax"] == 1        # the activation
    assert kernels.LAUNCHES["int8_conv"] == 1
    assert torch.equal(got, quant.int8_conv_plain(x, w, None, 1,
                                                  ((1, 1), (1, 1))))
    assert not got.any()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        quant.int8_conv(x.half(), w.half(), None, 1, ((1, 1), (1, 1)))


def test_int8_segmentation_runs_the_lane_on_the_card(dev):
    """segmentation_inference(conv_mode="int8") with the committed ResUNet:
    every compute conv through K16 (one activation absmax and one conv a
    layer and batch, the weights quantised once), and probabilities close
    to the bf16 lane's."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.models import checkpoint, quant
    from plant3dvision_tpu_torch.models.unet import segmentation_inference
    from plant3dvision_tpu_torch.models.zoo import DEFAULT_CHECKPOINT
    params, config = checkpoint.params_from_npz_bytes(
        DEFAULT_CHECKPOINT.read_bytes())
    model = checkpoint.model_from_config(config)
    model.load_state_dict(checkpoint.state_dict_from_flax(
        checkpoint._upcast_f16(params)))
    img = (np.random.RandomState(0).rand(3, 192, 192, 3) * 255).astype(
        np.uint8)
    n_conv = len(quant.compute_convs(model))
    kernels.reset_launches()
    pi = segmentation_inference(model, img, batch_size=2, conv_mode="int8",
                                output_dtype="float32", device=dev)
    assert kernels.LAUNCHES["int8_conv"] == 2 * n_conv
    assert kernels.LAUNCHES["int8_absmax"] == 2 * n_conv
    assert kernels.LAUNCHES["int8_quantize"] == 1      # all the weights
    pf = segmentation_inference(model, img, batch_size=2, conv_mode="bf16",
                                output_dtype="float32", device=dev)
    agree = (pi.argmax(1) == pf.argmax(1)).float().mean().item()
    assert agree > 0.95 and (pi - pf).abs().mean().item() < 0.02


@pytest.mark.parametrize("path", ["unet_seg", "tpusegnet_seg"])
def test_int8_lane_quantises_a_model_in_one_launch(dev, path):
    """`int8_lane` on a committed net (bf16, as segmentation_inference casts
    it): one "int8_quantize" launch for all its compute convs, and every
    weight's amax and packed layout (its only copy of q) equal to the plain
    version's (`quantize_weight_plain` + `pack_weight`), bit for bit."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.models import checkpoint, quant, zoo
    ckpt = {"unet_seg": zoo.DEFAULT_CHECKPOINT,
            "tpusegnet_seg": zoo.TPUSEGNET_CHECKPOINT}[path]
    params, config = checkpoint.params_from_npz_bytes(ckpt.read_bytes())
    model = checkpoint.model_from_config(config)
    model.load_state_dict(checkpoint.state_dict_from_flax(
        checkpoint._upcast_f16(params)))
    model = model.to(dev, torch.bfloat16)
    convs = quant.compute_convs(model)
    kernels.reset_launches()
    with quant.int8_lane(model):
        assert kernels.LAUNCHES["int8_quantize"] == 1
        for c in convs:
            w = c.weight.detach()
            pw = quant.quantize_weight_plain(w)
            K, kh, kw, cp = pw.q.shape
            assert c.int8.q is None and c.int8.shape == tuple(w.shape)
            assert torch.equal(c.int8.amax, pw.amax)
            assert c.int8.plan == quant.conv_plan(K, kh, kw, cp)
            assert torch.equal(c.int8.packed,
                               quant.pack_weight(pw.q, c.int8.plan))
            assert c.int8.packed.data_ptr() % 16 == 0


# -- K17-K19: the gather probes -----------------------------------------------------

@pytest.mark.parametrize("L,N,reps", [
    (64, 1000, 5), (8192, 8192, 64), (32768, 8192, 64), (60000, 3000, 64),
    (131072, 8192, 64),                     # the probe's sizes and others
    (16384, 4000, 64), (16385, 4000, 64),   # the staging limit either side
    (58112, 4000, 64), (58113, 4000, 64),   # a block's shared memory
    (40, 96, 200), (16385, 33, 20000),      # reps > L, in both lanes
    (1, 40, 7), (31, 50, 70), (33, 77, 64),  # L < 32 (a modulo), L = 33
    (300, 33, 0), (70000, 33, 0),           # reps = 0
    (8192, 65, 33)])                        # N off the warp, reps off 32
def test_gather_axis1_kernel_matches_plain(dev, L, N, reps):
    """K17 equal to its plain version in both lanes (a row staged in
    shared memory up to L = 16384, read through L1/L2 above), with sums
    that wrap."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.tools import gather_probe as gp
    np.random.seed(L % 1000 + N)
    tab, idx = gp.axis1_inputs(L, N, dev)
    tab = tab * 1000003 + 2 ** 30
    assert gp.axis1_staged(L) == (L <= 16384)
    before = kernels.LAUNCHES["gather_axis1"]
    got = gp.axis1_gather(tab, idx, reps)
    assert kernels.LAUNCHES["gather_axis1"] - before == 1
    assert torch.equal(got, gp.axis1_gather_plain(tab, idx, reps))
    # rows 1-7 alone: with L % 4 != 0, a table that starts off 16 bytes
    assert torch.equal(gp.axis1_gather(tab[1:], idx[1:], reps), got[1:])


@pytest.mark.parametrize("R,P,reps", [(48, 100, 9), (4096, 4096, 64),
                                      (32768, 4096, 64),
                                      (5, 37, 23), (48, 64, 200),  # reps > R
                                      (300, 33, 0),                # reps = 0
                                      (1, 10, 7), (3, 50, 13),     # R < 4
                                      (4, 40, 6), (4096, 1001, 66),
                                      (300, 17, 3)])               # reps off 4
def test_gather_rows_kernel_matches_plain(dev, R, P, reps):
    """K18 equal to its plain version: 16-byte loads from the probe's
    table, sums that wrap, and four 4-byte loads from a table whose base
    is off 16 bytes; one launch a call."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.tools import gather_probe as gp
    np.random.seed(R)
    tab, rows = gp.rows_inputs(R, P, dev)
    off = torch.empty(R * 32 + 1, dtype=torch.int32, device=dev)[1:].view(
        R, 32)
    off.copy_(tab * 1000003 + 2 ** 30)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    for t in (tab, tab * 1000003 + 2 ** 30, off):
        before = kernels.LAUNCHES["gather_rows"]
        got = gp.rows_gather(t, rows, reps)
        assert kernels.LAUNCHES["gather_rows"] - before == 1
        assert torch.equal(got, gp.rows_gather_plain(t, rows, reps))


@pytest.mark.parametrize("P,reps", [(1, 3), (1000, 40), (4096, 64),
                                    (37, 0), (33, 1), (1000, 45),
                                    (4096, 200)])
def test_gather_select32_kernel_matches_plain(dev, P, reps):
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.tools import gather_probe as gp
    np.random.seed(P)
    T, dy = gp.select32_inputs(P, dev)
    T[0, :] = 2 ** 30                            # a row whose sum wraps
    before = kernels.LAUNCHES["gather_select32"]
    got = gp.select32(T, dy, reps)
    assert kernels.LAUNCHES["gather_select32"] - before == 1
    assert torch.equal(got, gp.select32_plain(T, dy, reps))


# -- StreamingCarver on the card (K1) ----------------------------------------------

def test_streaming_carver_on_the_card_matches_carve_plain(dev):
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops.carving import carve_plain
    from plant3dvision_tpu_torch.ops.streaming import StreamingCarver
    rng = np.random.default_rng(5)
    packed, cams, hw = _scene(rng, V=20)
    shape, vs = (40, 37, 45), 0.5
    origin = -(np.array(shape) - 1) * vs / 2 + 0.3
    sc = StreamingCarver(shape, origin, vs, hw=hw, device=dev)
    masks = np.unpackbits(packed, axis=1)[:, :hw[0] * hw[1]].reshape(-1, *hw)
    kernels.reset_launches()
    for k in range(20):
        m = torch.from_numpy(masks[k]).to(dev) if k % 2 else packed[k]
        sc.add_view(m, cams[k])
        if k + 1 in (1, 5, 12, 20):
            got = sc.preview(out="int8")
            want = carve_plain(torch.from_numpy(packed[:k + 1]).to(dev),
                               torch.from_numpy(cams[:k + 1]).to(dev),
                               torch.ones(k + 1, dtype=torch.bool,
                                          device=dev),
                               origin, vs, shape, hw)
            assert torch.equal(got, want)
            assert torch.equal(sc.preview(), want == 1)
    assert kernels.LAUNCHES["carve"] == 8
    assert len(sc._packed) == 32 and sc._packed.device.type == "cuda"


# ------------------------------------------------ training (K20-K23)

@pytest.mark.parametrize("N,c,B", [(7, 24, 5), (20, 448, 8)])
def test_batch_gather_kernel_matches_plain(dev, N, c, B):
    """K20 bit for bit, both flips, gains that clip; one launch."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops.training import (gather_batch,
                                                      gather_batch_plain)
    g = torch.Generator(device=dev).manual_seed(0)
    rgb = torch.randint(0, 256, (N, c, c, 3), generator=g, device=dev,
                        dtype=torch.uint8)
    lab = torch.randint(0, 6, (N, c, c), generator=g, device=dev,
                        dtype=torch.uint8)
    idx = torch.randint(0, N, (B,), generator=g, device=dev)
    gains = 1 + 0.6 * torch.randn((B, 3), generator=g, device=dev)
    for f in (0, 1):
        flip = torch.tensor([f], dtype=torch.uint8, device=dev)
        kernels.reset_launches()
        x, y = gather_batch(rgb, lab, idx, flip, gains)
        assert kernels.LAUNCHES["batch_gather"] == 1
        px, py = gather_batch_plain(rgb, lab, idx, flip, gains)
        torch.cuda.synchronize()
        assert torch.equal(x, px) and torch.equal(y, py)
        assert (x == 1).any() and (x == 0).any()


CE_SHAPES = [((3, 6, 17, 13), None), ((3, 3, 17, 13), 255),
             ((8, 6, 448, 448), None), ((8, 3, 448, 448), 255)]


def _ce_inputs(dev, shape, ignore, seed=1, ignored_share=0.3):
    B, C, H, W = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = 3 * torch.randn(shape, generator=g, device=dev)
    y = torch.randint(0, C, (B, H, W), generator=g, device=dev,
                      dtype=torch.uint8)
    if ignore is not None:
        y[torch.rand((B, H, W), generator=g, device=dev)
          < ignored_share] = ignore
    w = torch.rand(C, generator=g, device=dev) + 0.2
    return logits, y, w


@pytest.mark.parametrize("shape,ignore", CE_SHAPES)
def test_weighted_ce_kernels_match_plain(dev, shape, ignore):
    """K21's pass within 2e-5 relative of the plain version (the sums'
    order differs), its denominator equal; its backward within 1e-6 of the
    largest gradient; ignored pixels' gradients zero. The pass's gradient
    (loss.backward()) equals the general backward at incoming gradient 1
    bit for bit. Launches: the pass 1 (2 with an ignored label: its kept
    count first), the backward 1 (the check of the incoming gradient on
    the card)."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import training as T
    logits, y, w = _ce_inputs(dev, shape, ignore)
    ig = -1 if ignore is None else ignore
    pass_launches = 1 if ignore is None else 2
    kernels.reset_launches()
    out = T.ce_forward(logits, y, w, ig)
    assert kernels.LAUNCHES["weighted_ce"] == pass_launches
    ref = T.ce_forward_plain(logits, y, w, ig)
    torch.testing.assert_close(out[0], ref[0], rtol=2e-5, atol=0)
    assert out[1] == ref[1]
    grad = torch.full((1,), 0.7, device=dev)
    d = T.ce_backward(logits, y, w, out, grad, ig)
    assert kernels.LAUNCHES["weighted_ce_backward"] == 1
    pd = T.ce_backward_plain(logits, y, w, out, grad, ig)
    torch.testing.assert_close(d, pd, rtol=0,
                               atol=1e-6 * float(pd.abs().max()))
    if ignore is not None:
        assert not d.permute(1, 0, 2, 3)[:, y == ignore].any()
    lt = logits.clone().requires_grad_()
    kernels.reset_launches()
    loss = T.weighted_cross_entropy(lt, y, w, ignore)
    loss.backward()
    assert kernels.LAUNCHES["weighted_ce"] == pass_launches
    assert kernels.LAUNCHES["weighted_ce_backward"] == 1
    assert torch.equal(loss.detach(), out[0])
    assert torch.equal(lt.grad, T.ce_backward(
        logits, y, w, out, torch.ones(1, device=dev), ig))


@pytest.mark.parametrize("shape,ignore", CE_SHAPES)
def test_weighted_ce_fused_any_incoming_gradient(dev, shape, ignore):
    """Through autograd, an incoming 0.7 (and 2, inside a sum) gives the
    general backward's gradient at that value bit for bit; a second
    backward of the same graph (retain_graph) gives the first one's; under
    torch.no_grad the pass writes no gradient (no logits-sized
    allocation) and gives the same loss; the scalar lane (logits 4 bytes
    off 16) equals the 16-byte lane bit for bit."""
    from plant3dvision_tpu_torch.ops import training as T
    logits, y, w = _ce_inputs(dev, shape, ignore, seed=5)
    ig = -1 if ignore is None else ignore
    out = T.ce_forward(logits, y, w, ig)
    for outer, g in ((lambda l: l.backward(torch.tensor(0.7, device=dev)),
                      0.7), (lambda l: (2 * l).backward(), 2.0)):
        lt = logits.clone().requires_grad_()
        outer(T.weighted_cross_entropy(lt, y, w, ignore))
        assert torch.equal(lt.grad, T.ce_backward(
            logits, y, w, out, torch.full((1,), g, device=dev), ig))
    lt = logits.clone().requires_grad_()
    loss = T.weighted_cross_entropy(lt, y, w, ignore)
    loss.backward(retain_graph=True)
    first = lt.grad.clone()
    lt.grad = None
    loss.backward()
    assert torch.equal(lt.grad, first)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        quiet = T.weighted_cross_entropy(lt, y, w, ignore)
    assert torch.cuda.max_memory_allocated() - base < logits.numel() * 2
    assert torch.equal(quiet, out[0])
    off = torch.empty(logits.numel() + 1, device=dev)[1:].view(shape)
    off.copy_(logits)
    assert off.data_ptr() % 16 == 4
    lo = off.requires_grad_()
    loss_off = T.weighted_cross_entropy(lo, y, w, ignore)
    loss_off.backward()
    assert torch.equal(loss_off.detach(), out[0])
    assert torch.equal(lo.grad, first)


def test_weighted_ce_every_pixel_ignored(dev):
    """A batch whose every pixel is ignored: [loss, denom] = [0, 1], a
    zero gradient, and the kept count reset for the next call (a second
    batch after it gives the plain version's denominator)."""
    from plant3dvision_tpu_torch.ops import training as T
    logits, y, w = _ce_inputs(dev, (8, 3, 448, 448), 255, seed=6)
    y_all = torch.full_like(y, 255)
    lt = logits.clone().requires_grad_()
    loss = T.weighted_cross_entropy(lt, y_all, w, 255)
    loss.backward()
    assert float(loss) == 0.0 and not lt.grad.any()
    out = T.ce_forward(logits, y_all, w, 255)
    assert out.tolist() == [0.0, 1.0]
    after = T.ce_forward(logits, y, w, 255)
    assert after[1] == T.ce_forward_plain(logits, y, w, 255)[1]


@pytest.mark.parametrize("ignore", [None, 255])
def test_weighted_ce_kernel_label_past_classes(dev, ignore):
    """A label >= C that is not ignored counts as C - 1 in K21's kernels
    as in the plain versions (no read past the weights or the logits)."""
    from plant3dvision_tpu_torch.ops import training as T
    B, C, H, W = 2, 3, 33, 29
    g = torch.Generator(device=dev).manual_seed(4)
    logits = torch.randn((B, C, H, W), generator=g, device=dev)
    y = torch.randint(0, C + 4, (B, H, W), generator=g, device=dev,
                      dtype=torch.uint8)
    if ignore is not None:
        y[torch.rand((B, H, W), generator=g, device=dev) < 0.2] = ignore
    w = torch.rand(C, generator=g, device=dev) + 0.2
    ig = -1 if ignore is None else ignore
    out = T.ce_forward(logits, y, w, ig)
    ref = T.ce_forward_plain(logits, y, w, ig)
    torch.testing.assert_close(out[0], ref[0], rtol=2e-5, atol=0)
    assert out[1] == ref[1]
    grad = torch.ones(1, device=dev)
    pd = T.ce_backward_plain(logits, y, w, out, grad, ig)
    d = T.ce_backward(logits, y, w, out, grad, ig)
    torch.testing.assert_close(d, pd, rtol=0,
                               atol=1e-6 * float(pd.abs().max()))
    lt = logits.clone().requires_grad_()
    loss = T.weighted_cross_entropy(lt, y, w, ignore)
    loss.backward()
    torch.testing.assert_close(loss.detach(), ref[0], rtol=2e-5, atol=0)
    assert torch.equal(lt.grad, d)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("n", [1000, 1001, 2_030_000, 7_550_000])
def test_adamw_kernel_matches_plain(dev, clip, n, offset):
    """K22 over one arena (the ResUNet's 2.03 M parameters, TPUSegNet's
    7.55 M, lengths off 4 and off the chunk, arenas as views 4 bytes off
    16 when `offset`: the one-element lane): bit-equal to the plain
    version without the clip (the same float32 operations in the same
    order) and when the norm is under the threshold; clipped, within 1e-6
    relative (the global norm's sum runs in another order). One launch in
    both modes; repeated calls equal (no float atomics)."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import training as T
    g = torch.Generator(device=dev).manual_seed(2)
    sc = dict(clip=clip, b1=0.9, b2=0.999, bc1=np.float32(0.271),
              bc2=np.float32(0.00299), eps=1e-8, eps_root=0.0, wd=1e-4,
              neg_lr=-np.float32(2.9e-3), max_norm=1.0)
    def arena(t):
        a = torch.empty(n + offset, device=dev)[offset:]
        assert (a.data_ptr() % 16 == 0) == (offset == 0)
        return a.copy_(t)

    for gscale in (1e-6, 1.0):
        p = torch.randn(n, generator=g, device=dev)
        gr = gscale * torch.randn(n, generator=g, device=dev)
        mu = 0.01 * torch.randn(n, generator=g, device=dev)
        nu = 1e-4 * torch.rand(n, generator=g, device=dev)
        runs = []
        for _ in range(2):
            a = [arena(t) for t in (p, gr, mu, nu)]
            kernels.reset_launches()
            T.adamw_update(*a, **sc)
            assert kernels.LAUNCHES["adamw"] == 1
            runs.append(a)
        b = [t.clone() for t in (p, gr, mu, nu)]
        T.adamw_update_plain(*b, **sc)
        torch.cuda.synchronize()
        for x, y in zip(runs[0], runs[1]):
            assert torch.equal(x, y)
        clipped = clip and float((gr * gr).sum().sqrt()) >= 1.0
        for x, y in zip(runs[0], b):
            if clipped:
                torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
            else:
                assert torch.equal(x, y)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,tp", [(1001, 2), (300_001, 4), (516_096, 4),
                                  (1_024_000, 2)])
def test_adamw_tp_lane_matches_plain(dev, n, tp, offset):
    """K22's tp lane on a rank's arena (516,096: a dp 2 x tp 4 rank of the
    ResUNet, 1,024,000 a tp 2 rank; 1001 and 300,001 no multiple of 4, of
    the update's 2048 elements a block or of the 4096-element chunk), with
    a run of zeros as a region's padding and zeros scattered, some -0 (the
    update's quotients of 0): its
    chunk sums bit-equal to the plain version's; the update with the other
    tp - 1 ranks' sums appended (the gathered sums of a tp group) bit-equal
    to the plain update at the sums' plain norm, clipped and not; two
    launches a step, counted under "adamw_tp"; the lane over its own sums
    equals the one-arena cooperative launch bit for bit, clipped and
    not."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import training as T
    g = torch.Generator(device=dev).manual_seed(4)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, wd=1e-4)
    per = dict(bc1=np.float32(0.271), bc2=np.float32(0.00299),
               neg_lr=-np.float32(2.9e-3))

    def arena(t):
        a = torch.empty(n + offset, device=dev)[offset:]
        return a.copy_(t)
    src = [torch.randn(n, generator=g, device=dev),
           0.01 * torch.randn(n, generator=g, device=dev),
           0.01 * torch.randn(n, generator=g, device=dev),
           1e-4 * torch.rand(n, generator=g, device=dev)]
    for t in src:
        t[n // 3:n // 3 + 5000] = 0.0
    scatter = torch.rand(n, generator=g, device=dev)
    for t in src[1:]:
        t[scatter < 0.01] = 0.0
        t[scatter < 0.005] = -0.0
    other = torch.cat([T.adamw_partials_plain(
        0.01 * torch.randn(n, generator=g, device=dev))
        for _ in range(tp - 1)])
    for max_norm in (1e-3, 1e3):
        a = [arena(t) for t in src]
        got = {}

        def gather(part):
            got["part"] = part.clone()
            return torch.cat([part, other])
        kernels.reset_launches()
        T.adamw_update(*a, clip=True, max_norm=max_norm, tp_sums=gather,
                       **kw, **per)
        assert kernels.LAUNCHES["adamw_tp"] == 2
        assert kernels.LAUNCHES["adamw"] == 0
        mine = T.adamw_partials_plain(src[1])
        assert torch.equal(got["part"], mine)
        b = [t.clone() for t in src]
        norm = T.adamw_norm_plain(torch.cat([mine, other]))
        assert (float(norm) >= max_norm) == (max_norm == 1e-3)
        T.adamw_update_plain(*b, clip=True, gnorm=norm, max_norm=max_norm,
                             **kw, **per)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for max_norm in (1e-3, 1e3):
        one = [arena(t) for t in src]
        lane = [arena(t) for t in src]
        T.adamw_update(*one, clip=True, max_norm=max_norm, **kw, **per)
        T.adamw_update(*lane, clip=True, max_norm=max_norm,
                       tp_sums=lambda p: p, **kw, **per)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(one, lane))


def _u8_at(t, offset):
    """t copied into a uint8 buffer `offset` bytes past a 16-byte
    boundary (a view of its shape)."""
    buf = torch.empty(t.numel() + 16, dtype=torch.uint8, device=t.device)
    out = buf[offset:offset + t.numel()].view(t.shape)
    assert out.data_ptr() % 16 == offset
    return out.copy_(t)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape,ignore", [((3, 5, 16, 16), None),
                                          ((2, 6, 448, 448), None),
                                          ((1, 3, 1080, 1440), 255),
                                          ((2, 2, 37, 29), None),
                                          ((3, 8, 30, 34), 255),
                                          ((2, 4, 12, 20), 0)])
def test_iou_counts_kernel_matches_plain(dev, shape, ignore, offset):
    """K23's counts equal the plain version's, from logits (with ties)
    and from predictions; one launch a call (after a memset of its
    counts), repeated calls equal, a call under another stream equal, a
    returned result untouched by later calls. C = 2 to
    8; H * W a multiple of 16, of 4 only (30 x 34) and of neither (37 x
    29); label and prediction tensors 1 byte off 16 (`offset`); labels
    and given predictions >= C beside the ignored label."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.ops import training as T
    B, C, H, W = shape
    g = torch.Generator(device=dev).manual_seed(3)
    logits = torch.round(torch.randn(shape, generator=g, device=dev), decimals=1)
    lab = torch.randint(0, C, (B, H, W), generator=g, device=dev,
                        dtype=torch.uint8)
    lab[torch.rand((B, H, W), generator=g, device=dev) < 0.05] = C
    lab[torch.rand((B, H, W), generator=g, device=dev) < 0.05] = 254
    if ignore is not None:
        lab[torch.rand((B, H, W), generator=g, device=dev) < 0.25] = ignore
    lab = _u8_at(lab, offset)
    ig = -1 if ignore is None else ignore
    kernels.reset_launches()
    k = T.iou_counts(lab, C, logits=logits, ignore_index=ignore)
    assert kernels.LAUNCHES["iou_counts"] == 1
    assert torch.equal(k, T.iou_counts_plain(lab, C, logits=logits,
                                             ignore=ig))
    assert torch.equal(T.iou_counts(lab, C, logits=logits,
                                    ignore_index=ignore), k)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        ks = T.iou_counts(lab, C, logits=logits, ignore_index=ignore)
    torch.cuda.current_stream(dev).wait_stream(side)
    assert torch.equal(ks, k)
    pred = _u8_at(logits.argmax(1).to(torch.uint8), offset)
    assert torch.equal(T.iou_counts(lab, C, preds=pred, ignore_index=ignore),
                       k)
    pred[torch.rand((B, H, W), generator=g, device=dev) < 0.1] = C + 1
    pred[torch.rand((B, H, W), generator=g, device=dev) < 0.05] = 255
    want = T.iou_counts_plain(lab, C, preds=pred, ignore=ig)
    for _ in range(2):
        assert torch.equal(T.iou_counts(lab, C, preds=pred,
                                        ignore_index=ignore), want)
    # a result the caller holds is not touched by later calls
    assert torch.equal(k, T.iou_counts_plain(lab, C, logits=logits,
                                             ignore=ig))


@pytest.mark.parametrize("input_", ["logits", "preds"])
@pytest.mark.parametrize("C", [2, 3, 8])
def test_iou_counts_one_class_and_all_ignored(dev, C, input_):
    """K23 on a 1080x1440 image of one class predicted right (every
    pixel's counter the same: the contended case), and on one whose every
    pixel is ignored (all counts 0): equal to the plain version's, and a
    call after each equal to the plain version's on other inputs."""
    from plant3dvision_tpu_torch.ops import training as T
    g = torch.Generator(device=dev).manual_seed(5)
    H, W = 1080, 1440
    one = torch.full((1, H, W), C - 1, dtype=torch.uint8, device=dev)
    logits = torch.zeros((1, C, H, W), device=dev)
    logits[:, C - 1] = 1.0
    src = {"logits": logits} if input_ == "logits" else {"preds": one}
    k = T.iou_counts(one, C, ignore_index=255, **src)
    assert torch.equal(k, T.iou_counts_plain(one, C, ignore=255, **src))
    assert k[0, C - 1] == H * W and k[1, C - 1] == H * W
    ignored = torch.full_like(one, 255)
    k = T.iou_counts(ignored, C, ignore_index=255, **src)
    assert torch.equal(k, torch.zeros_like(k))
    lab = torch.randint(0, C, (1, H, W), generator=g, device=dev,
                        dtype=torch.uint8)
    assert torch.equal(T.iou_counts(lab, C, ignore_index=255, **src),
                       T.iou_counts_plain(lab, C, ignore=255, **src))


def test_train_on_crops_resume_bit_identical_on_card(dev):
    """Two chunks on the card checkpointed after the first: the resumed
    run equals the uninterrupted one bit for bit (deterministic cuDNN, the
    resize's backward as products, no float atomics in K20-K23)."""
    from plant3dvision_tpu_torch import kernels
    from plant3dvision_tpu_torch.models import train_synth as S
    rng = np.random.default_rng(0)
    n, c = 16, 64
    lab = np.zeros((n, c, c), np.int8)
    for i in range(n):
        r0, c0 = rng.integers(4, c - 24, 2)
        lab[i, r0:r0 + 20, c0:c0 + 4] = 5
        lab[i, r0:r0 + 6, c0 + 4:c0 + 14] = 2
    rgb = np.full((n, c, c, 3), 40, np.uint8)
    rgb[lab == 5] = (60, 160, 50)
    rgb[lab == 2] = (190, 170, 60)
    kw = dict(widths=(8, 16, 32), blocks_per_stage=1, steps=50,
              batch_size=4, device="cuda")
    states = {}
    kernels.reset_launches()
    full, _, fh = S.train_on_crops(
        rgb, lab, checkpoint_every_chunks=1,
        on_checkpoint=lambda b, ch: states.setdefault(ch, b), **kw)
    for k in ("batch_gather", "weighted_ce", "weighted_ce_backward",
              "adamw", "iou_counts"):
        assert kernels.LAUNCHES[k] > 0, k
    res, _, rh = S.train_on_crops(rgb, lab, resume_state=states[0], **kw)
    assert [h["loss"] for h in rh] == [h["loss"] for h in fh]
    for a, b in zip(full.parameters(), res.parameters()):
        assert torch.equal(a, b)
