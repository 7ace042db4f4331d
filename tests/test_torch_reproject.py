"""The separate-task ML route's geometry against the JAX package, on the CPU
(the kernels' plain versions): K5-avg (ops/carving.py:average and its slab
lane), K7 (ops/reproject.py), K8 (ops/masks.py:binary_dilation), and the
Masks + Voxels tasks.

Tolerances, and what is exact:
- average: XLA on the CPU compiles it with the grid coordinate unfused
  (origin + vs*i, as the carve; the fused multiply-add of ml_fused's
  accumulate gives other values), the carve's projection, and the value
  fma(g11*fx, fy, fma(g10*gx, fy, fma(g01*fx, gy, (g00*gx)*gy))). One view
  of a 64^3 grid is bit-equal. Over several views and through the slab lane
  XLA contracts the running sums in other ways (an ulp here and there), so
  those volumes are held to 1e-5 relative + 2e-5 absolute (K5's), and the
  two-valued masks of the tile engine (average_tiled, which computes the
  same function with other sums) to 1e-5 relative + 1e-4 absolute
  (tests/unit/test_averaging_tiled.py).
- score_points_by_masks: the carve's contractions (p_j = fma(R_j2, z,
  fma(R_j1, y, R_j0*x)) + t_j, px = fma(p0/pz, fx, cx)); 0 of the points
  projected next to a pixel edge below land on another pixel than JAX's
  (an unfused px moves thousands), and the scores are bit-equal.
- binary_dilation: boolean, equal to JAX's and to scipy's.
- Masks PNGs and the carving Voxels volume: equal. The averaging Voxels
  volume of two-valued masks: the average_tiled tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plant3dvision_tpu.camera import pose_to_extrinsics
from plant3dvision_tpu.ops.carving import average, average_chunked, pack_camera

from plant3dvision_tpu_torch.ops import carving
from plant3dvision_tpu_torch.ops.reproject import score_points_by_masks

torch.set_num_threads(1)


def _scene(seed, H=97, W=131):
    """A random camera looking at the origin from ~30 units away."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 2 * np.pi)
    c = np.array([30 * np.cos(a), 30 * np.sin(a), rng.uniform(-10, 10)])
    R, t = pose_to_extrinsics(c, rng.uniform(-1, 1, 3))
    f = (rng.uniform(90, 130), rng.uniform(90, 130),
         W / 2 + rng.uniform(-3, 3), H / 2 + rng.uniform(-3, 3))
    return pack_camera(f, R, t), np.asarray(R), np.asarray(t), f


def _views(n, H, W, seed):
    return np.stack([_scene(seed * 100 + v, H, W)[0] for v in range(n)])


# -- K5-avg: average / average_chunked / the tile engine ----------------------

@pytest.mark.parametrize("grid_fma", [False, True])
def test_average_contracts_like_jax(grid_fma):
    """One view, 64^3 voxels: the port's `average` (grid_fma=False) is
    bit-equal to JAX's; the accumulate's fused grid coordinate is not (so
    the test tells the two apart)."""
    H, W = 97, 131
    cams = _views(1, H, W, 0)
    masks = np.random.default_rng(0).random((1, H, W)).astype(np.float32)
    origin = np.array([-7.5, -7.2, -6.9], np.float32)
    vs, shape = 0.23, (64, 64, 64)
    ref = np.asarray(average(jnp.asarray(masks), jnp.asarray(cams),
                             jnp.ones(1, bool), jnp.asarray(origin), vs,
                             shape))
    assert (ref != 0).mean() > 0.3
    if not grid_fma:
        got = carving.average(torch.from_numpy(masks), torch.from_numpy(cams),
                              torch.ones(1, dtype=torch.bool), origin, vs,
                              shape)
        np.testing.assert_array_equal(got.numpy(), ref)
        return
    c = torch.from_numpy(cams[0])
    px, py, inside = carving.project(c, origin, vs, 0, shape, (H, W),
                                     grid_fma=True)
    fx0 = torch.floor(px).clamp(0, W - 2)
    fy0 = torch.floor(py).clamp(0, H - 2)
    fx, fy = (px - fx0).clamp(0, 1), (py - fy0).clamp(0, 1)
    i = (fy0.long() * W + fx0.long()).nan_to_num(0)
    m = torch.from_numpy(masks[0].reshape(-1))
    val = carving.fma_f32(
        m[i + W + 1] * fx, fy, carving.fma_f32(
            m[i + W] * (1 - fx), fy, carving.fma_f32(
                m[i + 1] * fx, 1 - fy, (m[i] * (1 - fx)) * (1 - fy))))
    fused = torch.where(inside, val, 0.0).numpy()
    assert (fused != ref).sum() > 1000


@pytest.mark.parametrize("log", [False, True])
def test_average_matches_jax(log):
    """Six views (one invalid) into a 20x24x18 grid, masks log'd by the
    caller or not: whole grid, and the slab lane with forced small slabs
    (4 x-rows) against JAX's average_chunked."""
    H, W = 48, 64
    rng = np.random.default_rng(3)
    cams = _views(6, H, W, 3)
    cams[:, :2] *= 0.5
    masks = rng.random((6, H, W)).astype(np.float32)
    masks[:, 10:14, 20:30] = 0.0
    if log:
        masks = np.log(1e-9 + masks)
    valid = np.array([True, True, False, True, True, True])
    origin = np.array([-6.0, -7.0, -5.5], np.float32)
    vs, shape = 0.6, (20, 24, 18)
    ref = np.asarray(average(jnp.asarray(masks), jnp.asarray(cams),
                             jnp.asarray(valid), jnp.asarray(origin), vs,
                             shape))
    t = [torch.from_numpy(a) for a in (masks, cams, valid)]
    got = carving.average(*t, origin, vs, shape).numpy()
    assert (ref != 0).mean() > 0.3
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)
    slab = 4 * shape[1] * shape[2]
    ref_c = average_chunked(masks, cams, valid, origin, vs, shape,
                            max_slab_voxels=slab)
    got_c = carving.average_chunked(*t, origin, vs, shape,
                                    max_slab_voxels=slab).numpy()
    np.testing.assert_array_equal(got_c, got)   # the slabs' rows, exactly
    np.testing.assert_allclose(got_c, ref_c, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("log", [False, True])
def test_average_matches_jax_tile_engine(log):
    """Two-valued uint8 masks, which the JAX Backprojection sends to its
    tile engine (ops/averaging_tiled.py): the port computes them with
    `average` after the same scaling."""
    from plant3dvision_tpu.ops.averaging_tiled import average_tiled
    H, W = 64, 80
    rng = np.random.default_rng(4)
    cams = _views(5, H, W, 4)
    cams[:, :2] *= 0.5
    yy, xx = np.mgrid[0:H, 0:W]
    masks = np.stack([((xx - W / 2 - rng.uniform(-4, 4)) ** 2
                       + (yy - H / 2) ** 2 < 15 ** 2) for _ in range(5)])
    masks = (masks * 255).astype(np.uint8)
    valid = np.ones(5, bool)
    origin = np.array([-6.0, -6.0, -6.0], np.float32)
    vs, shape = 0.5, (24, 24, 24)
    v0, v1 = ((float(np.log(1e-9)), float(np.log(1e-9 + 1.0))) if log
              else (0.0, 1.0))
    ref, over = average_tiled(masks, cams, valid, origin, vs, shape,
                              v0=v0, v1=v1)
    assert over == 0
    f = masks.astype(np.float32) / 255.0
    if log:
        f = np.log(1e-9 + f)
    got = carving.average(torch.from_numpy(f), torch.from_numpy(cams),
                          torch.from_numpy(valid), origin, vs, shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


# -- K7: score_points_by_masks --------------------------------------------------

def _edge_points(R, t, f, H, W, n, rng):
    """Points that project within 1e-4 px of a pixel edge (in float64)."""
    fx, fy, cx, cy = f
    u = rng.integers(0, W, n) + rng.uniform(-1e-4, 1e-4, n)
    v = rng.integers(0, H, n) + rng.uniform(-1e-4, 1e-4, n)
    d = rng.uniform(20, 40, n)
    pc = np.stack([(u - cx) / fx * d, (v - cy) / fy * d, d], 1)
    return ((pc - t) @ R).astype(np.float32)


def test_reproject_projects_like_jax():
    """100,000 points next to pixel edges in each of two views: 0 point-file
    pairs on another pixel than JAX's (one random mask per view, so a pixel
    shows in the score); an unfused px lands thousands elsewhere."""
    from plant3dvision_tpu.ops.reproject import score_points_by_masks as jsp
    from plant3dvision_tpu_torch.ops.reproject import project_points
    H, W = 97, 131
    differ, witnesses = 0, 0
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        cam, R, t, f = _scene(seed, H, W)
        pts = _edge_points(R, t, f, H, W, 100_000, rng)
        mask = rng.integers(0, 256, (1, H, W), dtype=np.uint8)
        ref = np.asarray(jsp(jnp.asarray(pts),
                             jnp.asarray(mask.astype(np.float32) / 255.0),
                             jnp.asarray(cam[None]), jnp.zeros(1, jnp.int32),
                             1))
        got = score_points_by_masks(
            torch.from_numpy(pts), torch.from_numpy(mask),
            torch.from_numpy(cam[None]), torch.zeros(1, dtype=torch.int32), 1)
        differ += int((got.numpy() != ref).sum())
        # the same pixels with px, py computed without the fused add
        P, c = torch.from_numpy(pts), torch.from_numpy(cam)
        lin, _ = project_points(P, c, (H, W))
        p = P @ torch.from_numpy(R.astype(np.float32)).T \
            + torch.from_numpy(t.astype(np.float32))
        pxu = (p[:, 0] / p[:, 2] * c[0] + c[2]).long()
        witnesses += int((lin % W != pxu.clamp(0, W - 1)).sum())
    assert differ == 0
    assert witnesses > 1000


def test_reproject_scores_equal_jax():
    """12 mask files of 4 labels in mixed order, points in and out of every
    frame: the (N, 4) scores bit-equal to JAX's (sums in file order)."""
    from plant3dvision_tpu.ops.reproject import score_points_by_masks as jsp
    H, W, F, L = 40, 56, 12, 4
    rng = np.random.default_rng(5)
    cams = _views(F, H, W, 5)
    cams[:, :2] *= 0.4
    pts = rng.uniform(-10, 10, (3000, 3)).astype(np.float32)
    masks = rng.integers(0, 256, (F, H, W), dtype=np.uint8)
    lab = rng.integers(0, L, F).astype(np.int32)
    ref = np.asarray(jsp(jnp.asarray(pts),
                         jnp.asarray(masks.astype(np.float32) / 255.0),
                         jnp.asarray(cams), jnp.asarray(lab), L))
    got = score_points_by_masks(*(torch.from_numpy(a) for a in
                                  (pts, masks, cams, lab)), L).numpy()
    assert (ref > 0).any(axis=1).mean() > 0.5 and (ref == 0).any()
    np.testing.assert_array_equal(got, ref)


def test_reproject_checks_its_arguments():
    pts = torch.zeros((4, 3))
    masks = torch.zeros((2, 8, 8), dtype=torch.uint8)
    cams = torch.zeros((2, 16))
    lab = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        score_points_by_masks(pts, masks.float(), cams, lab, 2)
    with pytest.raises(ValueError, match="n_labels"):
        score_points_by_masks(pts, masks, cams, lab, 9)
    with pytest.raises(ValueError, match="int32"):
        score_points_by_masks(pts, masks, cams, lab.long(), 2)


# -- K8: binary_dilation --------------------------------------------------------

@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5])
def test_binary_dilation_equals_jax_and_scipy(radius):
    """Sparse masks with set pixels on the frame edges and corners (the
    disk is cut at the frame, never wrapped): equal to JAX's and to scipy's
    binary_dilation with the same footprint."""
    from plant3dvision_tpu.ops.masks import binary_dilation as jax_dilate
    from plant3dvision_tpu_torch.ops.masks import _dilate_np, binary_dilation
    rng = np.random.default_rng(radius)
    m = rng.random((3, 23, 31)) > 0.96
    m[0, 0, :] = m[0, :, 0] = m[1, -1, -1] = m[2, :, -1] = True
    got = binary_dilation(torch.from_numpy(m), radius).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_dilate(jnp.asarray(m),
                                                             radius)))
    np.testing.assert_array_equal(got, np.stack([_dilate_np(x, radius)
                                                 for x in m]))
    assert got.sum() > m.sum()


# -- the Masks and Voxels tasks -----------------------------------------------

MASK_CFG = {
    "Masks": {"upstream_task": "ImagesFilesetExists", "type": "linear",
              "parameters": "[1.0, 0.0, 0.0]", "threshold": 0.3,
              "dilation": 1},
    "Voxels": {"upstream_mask": "Masks", "upstream_colmap": "DummyTask",
               "camera_metadata": "camera", "voxel_size": 1.5,
               "type": "carving", "log": False},
}


@pytest.mark.parametrize("vtype,log,labels", [("carving", False, []),
                                              ("averaging", False, []),
                                              ("averaging", True, ["rgb"])])
def test_masks_and_voxels_match_jax(vtype, log, labels):
    """A 10-view 160x160 synthetic scan through both packages' Masks ->
    Voxels: equal fileset ids and PNGs; the carved volume equal; the
    averaging volume of the two-valued masks within the tile engine's
    tolerance (with log, exp on the two sides differs by an ulp). The log
    case names its label: the JAX task's single-volume log path writes
    np.exp into a read-only array and fails (ROADMAP Queue C)."""
    from plant3dvision_tpu.fsdb import io as jio
    from plant3dvision_tpu.fsdb.testing import TemporaryDB
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.runtime import run_task as jax_run_task
    from plant3dvision_tpu.synth import SyntheticPlant, generate_scan
    from plant3dvision_tpu_torch.runtime import RunContext, run_task

    cfg = {k: dict(v) for k, v in MASK_CFG.items()}
    cfg["Voxels"].update(type=vtype, log=log, labels=labels)
    plant = SyntheticPlant(n_fruits=5, stem_radius=2.5, fruit_radius=1.8,
                           fruit_length=25.0, internode=6.0)
    with TemporaryDB() as db:
        generate_scan(db, "s", n_views=10, width=160, height=160, f=170.0,
                      plant=plant)
        out = []
        for pkg in ("jax", "port"):
            ctx = (JaxRunContext(db, "s", cfg) if pkg == "jax"
                   else RunContext(db, "s", cfg, device="cpu"))
            rep = (jax_run_task if pkg == "jax" else run_task)(
                ctx, "Voxels", report=False)
            mfs = ctx.scan.get_fileset(rep["Masks"]["fileset"])
            pngs = {f.id: jio.read_image(f) for f in mfs.get_files()}
            vf = ctx.scan.get_fileset(rep["Voxels"]["fileset"]).get_files()[0]
            vol = dict(np.load(vf.path()))
            out.append((rep, pngs, vol, vf.get_metadata()))
            for t in ("Voxels", "Masks"):
                ctx.scan.delete_fileset(rep[t]["fileset"])
    (jrep, jpngs, jvol, jmeta), (rep, pngs, vol, meta) = out
    for t in ("Masks", "Voxels"):
        assert rep[t]["fileset"] == jrep[t]["fileset"], t
    assert list(pngs) == list(jpngs) and len(pngs) == 10
    for k in pngs:
        np.testing.assert_array_equal(pngs[k], jpngs[k])
    assert meta == jmeta and list(vol) == list(jvol)
    for k in vol:
        assert vol[k].dtype == jvol[k].dtype
        if vtype == "carving":
            np.testing.assert_array_equal(vol[k], jvol[k])
            assert (vol[k] == 1).sum() > 50 and (vol[k] == -1).any()
        else:
            np.testing.assert_allclose(vol[k], jvol[k], rtol=1e-5, atol=1e-4)
            assert (vol[k] > 0.5).sum() > 50
