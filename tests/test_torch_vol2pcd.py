"""Port vol2pcd (plain PyTorch versions of the signed-distance, gradient +
Gaussian and band-compaction kernels, on the CPU) against the JAX package.

Tolerances and why:
- squared EDT, signed distance, band index set: exact. Every finite EDT
  value is an integer sum below 2^24 (exact in f32), and the band test only
  reads the signed distance.
- gradients after the Gaussian: atol 1e-5. The port sums the 9 taps in a
  fixed order; XLA's convolution sums in another.
- points and normals: atol 1e-4. They are the band records pushed through
  the same numpy tail, so they inherit the gradients' rounding.
"""

import numpy as np
import pytest
import torch

from plant3dvision_tpu.ops import edt as jax_edt
from plant3dvision_tpu.ops import filters as jax_filters
from plant3dvision_tpu.proc3d import vol2pcd as jax_vol2pcd

from plant3dvision_tpu_torch.ops import edt, filters
from plant3dvision_tpu_torch.proc3d import band_compact, vol2pcd

torch.set_num_threads(1)


def _blob_volume(seed, shape=(26, 22, 30)):
    """Seeded binary blobs with thin parts, as a carved int32 volume
    (-1 / 1) — what FusedCarving hands to PointCloud."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    x = gaussian_filter(rng.random(shape), 1.5)
    inside = x > np.quantile(x, 0.8)
    return np.where(inside, 1, -1).astype(np.int32)


@pytest.mark.parametrize("cap", [None, 3, 20])
def test_squared_edt_bit_equal(cap):
    vol = _blob_volume(0) > 0
    ref = np.asarray(jax_edt.squared_edt(vol, cap))
    out = edt.squared_edt(torch.from_numpy(vol), cap).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("seed,cap", [(1, 20), (2, 4), (3, None)])
def test_signed_distance_bit_equal(seed, cap):
    vol = _blob_volume(seed).astype(np.float32)
    ref = np.asarray(jax_edt.signed_distance(vol, cap))
    out = edt.signed_distance(torch.from_numpy(vol), cap).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out > 0).any() and (out < 0).any()


@pytest.mark.parametrize("shape", [(26, 22, 30), (3, 17, 2)])
def test_gradient_gaussian_close(shape):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32) * 5
    ref = [np.asarray(jax_filters.gaussian_filter(g, 1.0))
           for g in jax_filters.gradient(x)]
    out = [filters.gaussian_filter(g, 1.0).numpy()
           for g in filters.gradient(torch.from_numpy(x))]
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    # the gradient alone is exact: one subtraction and a halving
    for a, b in zip(filters.gradient(torch.from_numpy(x)),
                    jax_filters.gradient(x)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("level", [0.0, 1.0])
def test_band_index_set_equal(level):
    """The band of the port's signed distance equals the indices JAX's
    device program compacts (proc3d._vol2pcd_dense)."""
    import jax.numpy as jnp
    from plant3dvision_tpu.proc3d import _vol2pcd_dense
    vol = _blob_volume(5).astype(np.float32)
    cap = 20
    idx, valid, _, _, n_band = _vol2pcd_dense(
        jnp.asarray(vol), jnp.float32(level), cap, vol.size)
    ref = np.asarray(idx)[:int(n_band)]
    sd = edt.signed_distance(torch.from_numpy(vol), cap)
    gs = filters.gradient(sd)
    out, d, g = band_compact(sd, *gs, level)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(ref) > 100
    np.testing.assert_array_equal(d.numpy(), sd.reshape(-1)[out].numpy())


@pytest.mark.parametrize("seed,level", [(6, 0.0), (7, 1.0)])
def test_vol2pcd_points_normals_close(seed, level):
    vol = _blob_volume(seed)
    origin = np.array([-3.0, 10.0, 2.5])
    ref = jax_vol2pcd(vol, origin, 0.5, level)
    out = vol2pcd(vol, origin, 0.5, level, device="cpu")
    assert len(out) == len(ref) > 100
    np.testing.assert_allclose(out.points, ref.points, atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.normals, ref.normals, atol=1e-4, rtol=0)


def test_vol2pcd_matches_scipy_recipe():
    """The reference algorithm (reference proc3d.py:490-570) re-executed in
    scipy/numpy, as the JAX package's tests/unit/test_ops.py does."""
    from scipy.ndimage import distance_transform_edt, gaussian_filter as sg

    vol = np.zeros((24, 24, 24), dtype=np.float32)
    vol[8:16, 8:16, 6:18] = 1.0
    level = 1.0

    volume = 1.0 * (vol > 0.5)
    dist = distance_transform_edt(volume)
    mdist = distance_transform_edt(1 - volume)
    dist = np.where(dist > 0.5, dist - 0.5, -mdist + 0.5)
    gx, gy, gz = np.gradient(dist)
    gx, gy, gz = sg(gx, 1), sg(gy, 1), sg(gz, 1)
    on_edge = (dist > -level) * (dist <= -level + np.sqrt(3))
    x, y, z = np.nonzero(on_edge)
    pts, normals = [], []
    for i in range(len(x)):
        grad = np.array([gx[x[i], y[i], z[i]], gy[x[i], y[i], z[i]],
                         gz[x[i], y[i], z[i]]])
        gn = np.linalg.norm(grad)
        if gn > 0:
            gh = grad / gn
            val = dist[x[i], y[i], z[i]] + level - np.sqrt(3) / 2
            pts.append([x[i] - gh[0] * val, y[i] - gh[1] * val,
                        z[i] - gh[2] * val])
            normals.append(-gh)
    ref_pts = np.array(pts)
    ref_nrm = np.array(normals)
    ref_nrm /= np.linalg.norm(ref_nrm, axis=1, keepdims=True)

    pcd = vol2pcd(vol, origin=np.zeros(3), voxel_size=1.0,
                  level_set_value=level, device="cpu")
    assert len(pcd) == len(ref_pts)
    np.testing.assert_allclose(pcd.points, ref_pts, atol=1e-3)
    np.testing.assert_allclose(pcd.normals, ref_nrm, atol=1e-3)


def test_vol2pcd_takes_a_tensor_where_it_lies():
    """A tensor volume (FusedCarving's in-memory handoff) is computed on its
    own device; the result equals the numpy-input path."""
    vol = _blob_volume(8)
    a = vol2pcd(torch.from_numpy(vol), np.zeros(3), 1.0, 0.0, device="cpu")
    b = vol2pcd(vol, np.zeros(3), 1.0, 0.0, device="cpu")
    np.testing.assert_array_equal(a.points, b.points)
