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
