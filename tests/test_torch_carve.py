"""Port carve (plain PyTorch version of the carve kernel, on the CPU) against
the JAX package's reference carve and its shipped engine.

Tolerance: none — the port repeats the projection's f32 operations in the
same order, fusing multiply-adds exactly where XLA fuses them, so the int8
volumes must be bit-equal.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from plant3dvision_tpu.ops.carving import carve as jax_carve
from plant3dvision_tpu.ops.carving_hier import pack_masks as jax_pack_masks
from plant3dvision_tpu.parallel.carving_mp import carve_fused

from plant3dvision_tpu_torch.camera import pose_to_extrinsics
from plant3dvision_tpu_torch.ops.carving import carve, pack_camera, pack_masks

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent.parent / "bench_assets" / \
    "real_fixture.npz"


def _sphere_views(n_views=8, H=64, W=64, radius=6.0, dist_cam=40.0):
    """Cameras on a circle looking at the origin; each mask is the disk a
    sphere of `radius` at the origin projects to (the scene of the JAX
    package's tests/unit/test_ops.py:_synthetic_views)."""
    f = 80.0
    cams, masks = [], []
    for v in range(n_views):
        a = 2 * np.pi * v / n_views
        c = np.array([dist_cam * np.cos(a), dist_cam * np.sin(a), 0.0])
        R, t = pose_to_extrinsics(c, (0, 0, 0))
        px_r = f * radius / dist_cam
        yy, xx = np.mgrid[0:H, 0:W]
        mask = ((xx - W / 2) ** 2 + (yy - H / 2) ** 2
                <= px_r ** 2).astype(np.uint8) * 255
        cams.append(pack_camera([f, f, W / 2, H / 2], R, t))
        masks.append(mask)
    return np.stack(masks), np.stack(cams)


def _port(masks, cams, valid, origin, vs, shape):
    V, H, W = masks.shape
    return carve(torch.from_numpy(pack_masks(masks)), torch.from_numpy(cams),
                 torch.from_numpy(valid), origin, vs, shape, (H, W)).numpy()


def _fused(masks, cams, valid, origin, vs, shape):
    return np.asarray(carve_fused(masks, cams, valid, origin, vs, shape))


@pytest.mark.parametrize("shape,vs,origin", [
    ((32, 32, 32), 0.5, (-8.0, -8.0, -8.0)),
    ((23, 41, 17), 0.7, (-7.7, -14.0, -5.6)),   # odd sizes, off-grid origin
])
def test_carve_sphere_scene_bit_equal(shape, vs, origin):
    masks, cams = _sphere_views()
    valid = np.ones(len(cams), bool)
    origin = np.asarray(origin, np.float32)
    ref = np.asarray(jax_carve(masks, cams, valid, origin, vs, shape))
    out = _port(masks, cams, valid, origin, vs, shape)
    assert out.dtype == np.int8
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, _fused(masks, cams, valid, origin, vs,
                                              shape))
    assert (out == 1).sum() > 100 and (out == -1).sum() > 100


def test_carve_invalid_views_bit_equal():
    """valid=False rows are ignored exactly as in JAX — here with masks that
    would kill everything if they were used."""
    masks, cams = _sphere_views(n_views=10)
    masks[[2, 7]] = 0
    valid = np.ones(len(cams), bool)
    valid[[2, 7]] = False
    origin = np.full(3, -8.0, np.float32)
    shape = (32, 32, 32)
    ref = np.asarray(jax_carve(masks, cams, valid, origin, 0.5, shape))
    out = _port(masks, cams, valid, origin, 0.5, shape)
    np.testing.assert_array_equal(out, ref)
    assert (out == 1).sum() > 100
    # the same views marked valid kill the whole grid in both packages
    valid[:] = True
    np.testing.assert_array_equal(
        _port(masks, cams, valid, origin, 0.5, shape),
        np.asarray(jax_carve(masks, cams, valid, origin, 0.5, shape)))


def test_carve_real_fixture_crop_bit_equal():
    """A 64x64x96 crop (0.5 mm) of the real_plant fixture's 60 real masks
    and calibrated cameras, around the plant base."""
    data = np.load(FIXTURE, allow_pickle=False)
    packed, cams = data["packed"], np.asarray(data["cams"], np.float32)
    H, W = (int(x) for x in data["hw"])
    masks = np.unpackbits(packed, axis=1)[:, :H * W].reshape(-1, H, W)
    valid = np.ones(len(cams), bool)
    origin = np.array([384.0, 362.0, -175.0], np.float32)
    shape = (64, 64, 96)
    ref = np.asarray(jax_carve(masks, cams, valid, origin, 0.5, shape))
    out = carve(torch.from_numpy(packed), torch.from_numpy(cams),
                torch.from_numpy(valid), origin, 0.5, shape, (H, W)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out == 1).sum() > 1000 and (out == -1).sum() > 1000
    np.testing.assert_array_equal(out, _fused(masks, cams, valid, origin, 0.5,
                                              shape))


@pytest.mark.parametrize("hw", [(9, 13), (8, 8), (1, 1)])
def test_pack_masks_equals_packbits(hw):
    rng = np.random.default_rng(sum(hw))
    m = rng.random((5, *hw)) > 0.5
    ref = np.packbits(m.reshape(5, -1), axis=1)
    np.testing.assert_array_equal(pack_masks(m), ref)
    np.testing.assert_array_equal(pack_masks(m), jax_pack_masks(m))
    np.testing.assert_array_equal(pack_masks(m[0]), ref[0])


def test_carve_plain_counts_tests():
    """count_work counts the voxel-view tests of a kernel that stops at a
    voxel's first kill, and the distinct mask bytes those tests read (what
    chip_smoke.py bounds the kernel with)."""
    from plant3dvision_tpu_torch.ops.carving import carve_plain
    masks, cams = _sphere_views(n_views=4)
    V, H, W = masks.shape
    args = (torch.from_numpy(pack_masks(masks)), torch.from_numpy(cams),
            torch.ones(V, dtype=torch.bool), np.full(3, -8.0, np.float32),
            0.5, (32, 32, 32), (H, W))
    vol, tests, mask_bytes = carve_plain(*args, count_work=True)
    brute, read = 0, 0
    killed = torch.zeros((32, 32, 32), dtype=torch.bool)
    for v in range(V):
        brute += int((~killed).sum())
        # the bytes of view v that alive, in-frame voxels project into
        pz, px, py = _project_f64(cams[v], np.full(3, -8.0), 0.5, (32,) * 3)
        inside = (pz > 0) & (px >= 0) & (px < W) & (py >= 0) & (py < H)
        lin = np.floor(py).astype(np.int64) * W + np.floor(px).astype(np.int64)
        read += len(np.unique(lin[inside & ~killed.numpy()] >> 3))
        one = carve_plain(args[0][v:v + 1], args[1][v:v + 1],
                          args[2][v:v + 1], *args[3:])
        killed |= one == -1
    assert tests == brute and 32 ** 3 < tests < V * 32 ** 3
    assert torch.equal(vol == -1, killed)
    # the projection here is float64, so a voxel on a pixel border may read
    # its neighbour's byte: the counts agree to a few bytes
    assert abs(mask_bytes - read) <= 0.01 * read
    assert 0 < mask_bytes < args[0].numel()


def _project_f64(cam, origin, vs, shape):
    """Voxel centres projected by one packed camera row, in float64."""
    ax = [origin[a] + vs * np.arange(shape[a]) for a in range(3)]
    p = np.stack(np.meshgrid(*ax, indexing="ij"), -1).astype(np.float64)
    R, t = cam[4:13].reshape(3, 3).astype(np.float64), cam[13:16]
    c = p @ R.T + t
    return (c[..., 2], c[..., 0] / c[..., 2] * cam[0] + cam[2],
            c[..., 1] / c[..., 2] * cam[1] + cam[3])


def _one_view_scene(seed, H=97, W=131):
    """A random camera looking at a random 112^3 grid around the origin."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 2 * np.pi)
    c = np.array([30 * np.cos(a), 30 * np.sin(a), rng.uniform(-10, 10)])
    R, t = pose_to_extrinsics(c, rng.uniform(-1, 1, 3))
    cams = pack_camera([rng.uniform(90, 130), rng.uniform(90, 130),
                        W / 2 + rng.uniform(-3, 3), H / 2 + rng.uniform(-3, 3)],
                       R, t)[None]
    origin = rng.uniform(-8, -6, 3).astype(np.float32)
    vs = float(rng.uniform(0.09, 0.13))
    return rng, cams, origin, vs, (112, 112, 112), (H, W)


@pytest.mark.parametrize("seed", [0, 1])
def test_carve_one_view_random_mask_bit_equal(seed):
    """One view of a random (50 %) pixel mask: every voxel's label is the
    bit of the pixel it projects to, so any rounding difference in the
    projection that crosses a pixel border shows. This is the scene that
    pins down where XLA fuses multiply-adds (see kernels/csrc/carve.cu)."""
    rng, cams, origin, vs, shape, (H, W) = _one_view_scene(seed)
    masks = (rng.random((1, H, W)) > 0.5).astype(np.uint8)
    valid = np.ones(1, bool)
    ref = np.asarray(jax_carve(masks, cams, valid, origin, vs, shape))
    np.testing.assert_array_equal(_port(masks, cams, valid, origin, vs, shape),
                                  ref)


def _pixels(cam, origin, vs, shape, hw, fused):
    """Pixel (flat index) of every voxel, or -1 out of frame, projected in
    float32 with the port's fused multiply-adds or with none."""
    from plant3dvision_tpu_torch.ops.carving import _dot3_add, fma_f32
    c = torch.from_numpy(cam)
    f32 = torch.float32
    x, y, z = ((float(origin[a]) + torch.tensor(vs, dtype=f32)
                * torch.arange(shape[a], dtype=f32)).view(
        [-1 if b == a else 1 for b in range(3)]) for a in range(3))

    def dot(a, b, cc, t):
        if fused:
            return _dot3_add(a, b, cc, x, y, z, t)
        return ((a * x + b * y) + cc * z) + t

    def pix(num, pz, f, off):
        return fma_f32(num / pz, f, off) if fused else (num / pz) * f + off

    pz = dot(c[10], c[11], c[12], c[15])
    px = pix(dot(c[4], c[5], c[6], c[13]), pz, c[0], c[2])
    py = pix(dot(c[7], c[8], c[9], c[14]), pz, c[1], c[3])
    H, W = hw
    inside = (pz > 0) & (px > -1) & (px < W) & (py > -1) & (py < H)
    lin = py.clamp(0, H - 1).long() * W + px.clamp(0, W - 1).long()
    return torch.where(inside, lin, -1).numpy()


def test_jax_carve_contracts_multiply_adds_like_the_port():
    """The port's carve is bit-equal to the JAX carve only because it fuses
    multiply-adds where XLA's CPU backend does: fma(r8, z, fma(r7, y, r6*x))
    + t2 per coordinate and fma(num/pz, f, c) per pixel (ROADMAP.md Queue
    C). That pattern is the compiler's choice, so a jaxlib upgrade can move
    it. This test checks it directly: on voxels whose pixel differs between
    the fused and the unfused projection, the mask is 1 at the fused pixel
    and 0 at the unfused one, and the JAX carve's label says which one it
    read."""
    labels = []
    for seed in range(6):
        _, cams, origin, vs, shape, (H, W) = _one_view_scene(seed)
        fused = _pixels(cams[0], origin, vs, shape, (H, W), True)
        plain = _pixels(cams[0], origin, vs, shape, (H, W), False)
        witness = (fused != plain) & (fused >= 0) & (plain >= 0)
        witness &= ~np.isin(fused, plain[witness])
        mask = np.ones(H * W, np.uint8)
        mask[plain[witness]] = 0
        mask[fused[witness]] = 1
        ref = np.asarray(jax_carve(mask.reshape(1, H, W), cams,
                                   np.ones(1, bool), origin, vs, shape))
        labels.extend(ref[witness].tolist())
    assert len(labels) >= 3, "no voxel tells the two projections apart"
    import jaxlib
    assert labels.count(1) == len(labels), (
        f"jaxlib {jaxlib.__version__} no longer compiles the carve's "
        f"projection as fma(r8, z, fma(r7, y, r6*x)) + t2 and "
        f"fma(num/pz, f, c): {labels.count(-1)} of {len(labels)} witness "
        f"voxels took the unfused pixel. The port's carve repeats the old "
        f"pattern (kernels/csrc/carve.cu, ops/carving.py:_dot3_add); find "
        f"the new one before comparing the port's volumes with JAX's.")
