"""The ML path of the port (FusedSegmentationCarving -> multiclass PointCloud
-> OrganSegmentation -> AnglesAndInternodes) against the JAX package, on the
CPU (the kernels' plain versions).

Tolerances, and what is exact:
- Accumulate (ops/ml_fused.py): the projection of `_accumulate_core` as
  XLA compiles it on the CPU fuses multiply-adds: x = fma(vs, i, origin),
  pz = fma(r8, z, fma(r7, y, r6*x)) + t2 per coordinate, fma(num/pz, f, c)
  per pixel, and the bilinear value fma(v11, w11, fma(v10, w10, fma(v00,
  w00, v01*w01))). The port does the same, so on the coordinate-map scenes
  below 0 of the 5.6 M voxels (whole grid) and 0 of the 2.8 M (slab lane)
  get another in_img, x0 or y0 than JAX. One view's bilinear value is
  bit-equal on a 64^3 grid; elsewhere (small grids, several views added to
  an accumulator) XLA contracts the sums in other ways (1-2 ulp), and with
  log_mode torch.log and XLA's log differ by an ulp, so those volumes are
  held to 1e-5 relative + 2e-5 absolute (measured: 5.1e-6 absolute). Box
  sampling without log is bit-equal.
- Select (ops/multiclass.py): boolean, equal, ties included.
- DBSCAN (proc3d.dbscan) against scikit-learn: equal labels.
- align_sequences: equal.
- Slice end to end: fileset ids equal; label volumes within 0.02 (the CNN
  runs in bfloat16 on both sides, rounded at different places); from one
  NPZ fed to both packages' PointCloud, selections equal, points and normals
  within 1e-4, the same organ files, angles and internodes within 0.05.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plant3dvision_tpu.camera import pose_to_extrinsics
from plant3dvision_tpu.ops.carving import pack_camera
from plant3dvision_tpu.ops.ml_fused import (accumulate_label_views,
                                            accumulate_label_views_slab)
from plant3dvision_tpu.ops.multiclass import _select, multiclass_select

from plant3dvision_tpu_torch.ops import ml_fused, multiclass

torch.set_num_threads(1)


# -- accumulate (K5's plain version) -----------------------------------------

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
    return cams, origin, float(rng.uniform(0.09, 0.13)), (112, 112, 112), (H, W)


def _decode_box(v):
    """The box-sampled coordinate map x + 1 reads x0 + 0.5 (x0 >= 1) or 1
    (x0 = 0); 0 means out of frame (-1 here)."""
    x0 = np.where(v == 1.0, 0, np.round(v - 0.5)).astype(np.int64)
    return np.where(v == 0, -1, x0)


def _port_pixels(cam, origin, vs, x_start, shape, hw, fused=True):
    """(x0, y0) of every voxel, -1 out of frame: the port's projection, or
    (fused=False) the same one with no multiply-add fused."""
    H, W = hw
    c = torch.from_numpy(cam)
    if fused:
        px, py, inside = ml_fused.project(c, origin, vs, x_start, shape, hw)
    else:
        f32 = torch.float32
        x, y, z = ((float(origin[a]) + torch.tensor(vs, dtype=f32)
                    * torch.arange(off, off + shape[a], dtype=f32)).view(
            [-1 if b == a else 1 for b in range(3)])
            for a, off in zip(range(3), (x_start, 0, 0)))

        def dot(a, b, cc, t):
            return ((a * x + b * y) + cc * z) + t
        pz = dot(c[10], c[11], c[12], c[15])
        px = dot(c[4], c[5], c[6], c[13]) / pz * c[0] + c[2]
        py = dot(c[7], c[8], c[9], c[14]) / pz * c[1] + c[3]
        inside = (pz > 0) & (px > -1) & (px < W) & (py > -1) & (py < H)
    x0 = torch.floor(px).clamp(0, W - 2).long()
    y0 = torch.floor(py).clamp(0, H - 2).long()
    return (torch.where(inside, x0, -1).numpy(),
            torch.where(inside, y0, -1).numpy())


@pytest.mark.parametrize("slab", [False, True])
def test_accumulate_projection_contracts_like_jax(slab):
    """One view of the maps x + 1 and y + 1, box-sampled: every voxel's sum
    is its (x0, y0) in frame, or 0. JAX's in_img, x0 and y0 equal the
    port's on every voxel, and the scenes hold voxels where an unfused
    projection gives another pixel (so the test tells the two apart; a
    jaxlib that moves XLA's contraction fails here)."""
    mismatch, witnesses = 0, 0
    for seed in ((0, 1, 2, 3) if not slab else (4, 5)):
        cams, origin, vs, shape, (H, W) = _one_view_scene(seed)
        yy, xx = np.mgrid[0:H, 0:W]
        probs = np.stack([xx + 1, yy + 1]).astype(np.float32)[None]
        args = (jnp.asarray(probs), jnp.asarray(cams), jnp.ones(1, bool),
                jnp.asarray(origin), jnp.float32(vs))
        if slab:
            vol = jnp.zeros((2, *shape), jnp.float32)
            for s in range(4):
                vol = accumulate_label_views_slab(vol, *args, s * 28, 28,
                                                  False, sample="box")
        else:
            vol = accumulate_label_views(jnp.zeros((2, *shape), jnp.float32),
                                         *args, shape, False, sample="box")
        vol = np.asarray(vol)
        jx, jy = _decode_box(vol[0]), _decode_box(vol[1])
        for fused in (True, False):
            parts = [_port_pixels(cams[0], origin, vs, xs, (28, *shape[1:]),
                                  (H, W), fused) for xs in range(0, 112, 28)]
            px = np.concatenate([p[0] for p in parts])
            py = np.concatenate([p[1] for p in parts])
            n = int(((px != jx) | (py != jy)).sum())
            if fused:
                mismatch += n
            else:
                witnesses += n
    assert mismatch == 0
    assert witnesses > 0, "no voxel tells a fused from an unfused projection"


def _views(B, H, W, seed):
    rng = np.random.default_rng(seed)
    cams = np.zeros((B, 16), np.float32)
    for v in range(B):
        a = 2 * np.pi * v / B + rng.uniform(0, 0.3)
        R, t = pose_to_extrinsics([30 * np.cos(a), 30 * np.sin(a),
                                   rng.uniform(-4, 6)], rng.uniform(-1, 1, 3))
        cams[v] = pack_camera([40.0, 42.0, W / 2 + 0.3, H / 2 - 0.2], R, t)
    return cams


@pytest.mark.parametrize("sample", ["bilinear", "box"])
@pytest.mark.parametrize("log_mode", [False, True])
def test_accumulate_plain_matches_jax(sample, log_mode):
    """A 4-view batch with one padded (invalid) view, 3 labels, added to a
    non-zero accumulator: the port's whole-grid and slab lanes against
    JAX's."""
    B, C, H, W = 4, 3, 24, 32
    shape = (20, 9, 11)
    rng = np.random.default_rng(7)
    probs = rng.random((B, C, H, W)).astype(np.float32)
    probs[:, :, 3:5, 4:9] = 0.0                      # log(EPS) taps
    cams = _views(B, H, W, 8)
    valid = np.array([True, True, False, True])
    origin = np.array([-16.0, -7.0, -9.0], np.float32)
    vol0 = rng.random((C, *shape)).astype(np.float32)
    ref = np.asarray(accumulate_label_views(
        jnp.asarray(vol0), jnp.asarray(probs), jnp.asarray(cams),
        jnp.asarray(valid), jnp.asarray(origin), jnp.float32(1.6), shape,
        log_mode, sample=sample))
    t = [torch.from_numpy(a) for a in (probs, cams, valid)]
    got = ml_fused.accumulate_label_views(torch.from_numpy(vol0.copy()), *t,
                                          origin, 1.6, shape, log_mode,
                                          sample)
    seen = (ref != vol0).any(0)
    assert 0.2 < seen.mean() < 1.0              # in and out of frame
    if sample == "box" and not log_mode:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        # XLA contracts the bilinear sum another way here, and its log
        # differs from torch.log by an ulp
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-5)
    # slab lane: 4 slabs of 5 x-rows give the whole grid's values exactly
    slab = torch.from_numpy(vol0.copy())
    for xs in range(0, 20, 5):
        ml_fused.accumulate_label_views_slab(slab, *t, origin, 1.6, xs, 5,
                                             log_mode, sample)
    assert torch.equal(slab, got)


def test_accumulate_slab_matches_jax_slab():
    """JAX's slab program (traced x offset) against the port's slab lane,
    bilinear + log, as FusedSegmentationCarving runs them by default."""
    B, C, H, W = 3, 2, 24, 32
    rng = np.random.default_rng(9)
    probs = rng.random((B, C, H, W)).astype(np.float32)
    cams = _views(B, H, W, 10)
    valid = np.ones(B, bool)
    origin = np.array([-4.0, -4.0, -4.0], np.float32)
    shape = (16, 8, 8)
    vol = jnp.zeros((C, *shape), jnp.float32)
    pvol = torch.zeros((C, *shape))
    t = [torch.from_numpy(a) for a in (probs, cams, valid)]
    for xs in (0, 4, 8, 12):
        vol = accumulate_label_views_slab(
            vol, jnp.asarray(probs), jnp.asarray(cams), jnp.asarray(valid),
            jnp.asarray(origin), jnp.float32(0.5), xs, 4, True)
        ml_fused.accumulate_label_views_slab(pvol, *t, origin, 0.5, xs, 4,
                                             True)
    np.testing.assert_allclose(pvol.numpy(), np.asarray(vol), rtol=1e-5,
                               atol=2e-5)


def test_accumulate_bilinear_bit_equal_to_jax_on_a_real_grid():
    """On a 64^3 grid XLA contracts one view's bilinear value as the port
    does: bit-equal."""
    B, C, H, W = 1, 2, 48, 64
    shape = (64, 64, 64)
    rng = np.random.default_rng(12)
    probs = rng.random((B, C, H, W)).astype(np.float32)
    cams = _views(B, H, W, 13)
    cams[:, 0:2] *= 2.0
    origin = np.array([-8.0, -8.0, -8.0], np.float32)
    vol0 = np.zeros((C, *shape), np.float32)
    ref = np.asarray(accumulate_label_views(
        jnp.asarray(vol0), jnp.asarray(probs), jnp.asarray(cams),
        jnp.ones(B, bool), jnp.asarray(origin), jnp.float32(0.25), shape,
        False))
    got = ml_fused.accumulate_label_views(
        torch.from_numpy(vol0.copy()), torch.from_numpy(probs),
        torch.from_numpy(cams), torch.ones(B, dtype=torch.bool), origin, 0.25,
        shape, False)
    assert (ref != 0).mean() > 0.3
    np.testing.assert_array_equal(got.numpy(), ref)


def test_accumulate_checks_its_arguments():
    vol = torch.zeros((2, 4, 4, 4))
    probs = torch.zeros((1, 2, 8, 8))
    cams = torch.zeros((1, 16))
    valid = torch.ones(1, dtype=torch.bool)
    with pytest.raises(ValueError, match="sample"):
        ml_fused.accumulate(vol, probs, cams, valid, np.zeros(3), 1.0, 0, 4,
                            False, "nearest")
    with pytest.raises(ValueError, match="labels"):
        ml_fused.accumulate(vol[:1], probs, cams, valid, np.zeros(3), 1.0, 0,
                            4, False)
    with pytest.raises(ValueError, match="multiples"):
        ml_fused.accumulate_label_views_slab(vol, probs, cams, valid,
                                             np.zeros(3), 1.0, 2, 3, False)


# -- select (K6's plain version) ----------------------------------------------

def _tied_stack(L, shape, seed):
    """Scores on a coarse grid of values, so organs tie with organs and the
    background with organs on many voxels."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 5, (L, *shape)) / 4.0).astype(np.float32)


@pytest.mark.parametrize("bg", [0, 3, None])
@pytest.mark.parametrize("prior,min_contrast,min_score",
                         [(1.0, 1.0, 0.01), (0.5, 10.0, 0.2),
                          (2.0, 1.5, 0.0)])
def test_select_plain_equals_jax(bg, prior, min_contrast, min_score):
    stack = _tied_stack(6, (9, 10, 11), bg or 1)
    stack *= np.random.default_rng(2).random(stack.shape) < 0.4  # lone labels
    contrast_on = min_contrast > 1.0
    ref = np.asarray(_select(jnp.asarray(stack), jnp.float32(prior),
                             jnp.float32(min_contrast),
                             jnp.float32(min_score), bg, contrast_on))
    got = multiclass.select_labels(torch.from_numpy(stack), prior,
                                   min_contrast, min_score, bg, contrast_on)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.any()


def test_select_ties_go_to_the_organ():
    s = np.zeros((3, 1, 1, 4), np.float32)    # background, a, b
    s[:, 0, 0, 0] = [0.5, 0.5, 0.2]            # bg ties organ a: a
    s[:, 0, 0, 1] = [0.6, 0.5, 0.5]            # bg strictly wins
    s[:, 0, 0, 2] = [0.1, 0.4, 0.4]            # organs tie: first (a)
    s[:, 0, 0, 3] = [0.1, 0.3, 0.4]            # b
    got = multiclass.select_labels(torch.from_numpy(s), 1.0, 1.0, 0.01, 0,
                                   False).numpy()[:, 0, 0]
    assert got.tolist() == [[False] * 4, [True, False, True, False],
                            [False, False, False, True]]


def test_multiclass_select_matches_jax():
    labels = ["background", "fruit", "leaf", "stem"]
    stack = _tied_stack(4, (12, 7, 9), 5)
    vols = {l: stack[i] for i, l in enumerate(labels)}
    ref = multiclass_select(vols, labels, 1.0, 10.0, 0.2)
    got = multiclass.multiclass_select(vols, labels, 1.0, 10.0, 0.2,
                                       device="cpu")
    assert list(got) == list(ref) == labels[1:]
    for l in got:
        np.testing.assert_array_equal(got[l].numpy(), np.asarray(ref[l]))


# -- host code: DBSCAN, sequence alignment, photo scans -------------------------

@pytest.mark.parametrize("seed", range(4))
def test_dbscan_equals_sklearn_on_blobs(seed):
    from sklearn.cluster import DBSCAN
    from plant3dvision_tpu_torch.proc3d import dbscan
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (rng.integers(2, 7), 3))
    pts = np.concatenate(
        [c + rng.standard_normal((rng.integers(5, 200), 3))
         * rng.uniform(0.3, 2) for c in centers]
        + [rng.uniform(-15, 15, (40, 3))])
    rng.shuffle(pts)
    for eps, ms in ((0.5, 5), (1.0, 3), (2.0, 10), (0.3, 1)):
        want = DBSCAN(eps=eps, min_samples=ms).fit(pts).labels_
        np.testing.assert_array_equal(dbscan(pts, eps, ms), want)


def test_dbscan_equals_sklearn_at_exactly_eps():
    """Lattice points at distance exactly eps are neighbours (<= eps)."""
    from sklearn.cluster import DBSCAN
    from plant3dvision_tpu_torch.proc3d import dbscan
    g = np.stack(np.meshgrid(*[np.arange(6.0)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    g = g[np.random.default_rng(0).random(len(g)) > 0.5]
    for ms in (2, 3, 5, 7):
        want = DBSCAN(eps=1.0, min_samples=ms).fit(g).labels_
        np.testing.assert_array_equal(dbscan(g, 1.0, ms), want)
    assert len(dbscan(np.zeros((0, 3)), 1.0, 2)) == 0


def test_align_sequences_equals_jax():
    from plant3dvision_tpu.evaluation import align_sequences as jax_align
    from plant3dvision_tpu_torch.evaluation import align_sequences
    rng = np.random.default_rng(3)
    gt_a = 137.5 + 12 * rng.standard_normal(20)
    gt_i = 2.8 * (1 + 0.3 * rng.standard_normal(20))
    pred_a = np.delete(gt_a + rng.standard_normal(20), [4, 11])
    pred_i = np.delete(gt_i + 0.1 * rng.standard_normal(20), [4, 11])
    assert align_sequences(pred_a, pred_i, gt_a, gt_i) == \
        jax_align(pred_a, pred_i, gt_a, gt_i)


def test_photo_scan_renders_like_jax():
    from plant3dvision_tpu import synth_photo as J
    from plant3dvision_tpu_torch import synth_photo as P
    jp, pp = J.ProceduralArabidopsis(n_fruits=5, seed=2), \
        P.ProceduralArabidopsis(n_fruits=5, seed=2)
    np.testing.assert_array_equal(pp.gt_angles, jp.gt_angles)
    assert pp.bounding_box() == jp.bounding_box()
    js, ps = jp.labeled_samples(40.0), pp.labeled_samples(40.0)
    bb = pp.bounding_box()
    cz = (bb["z"][0] + bb["z"][1]) / 2
    K, R, t = P.fixture_like_cameras(3, radius=1.55 * (bb["z"][1] - bb["z"][0]),
                                     z=cz + 10.0, target=(0.0, 0.0, cz),
                                     width=96, height=80)[1]
    a = J.render_photo(js, K, R, t, 96, 80, rng=np.random.default_rng(1))
    b = P.render_photo(ps, K, R, t, 96, 80, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[2], b[2])
    assert (a[2] > 0).sum() > 50                  # the plant is in view


# -- the slice end to end ---------------------------------------------------------

ML_CFG = {
    "ModelFilesetExists": {"scan_id": "models"},
    "FusedSegmentationCarving": {
        "upstream_task": "ImagesFilesetExists", "camera_metadata": "camera",
        "voxel_size": 1.0, "Sx": 128, "Sy": 112, "batch_size": 3,
        "log": True, "sample": "bilinear"},
    "PointCloud": {"upstream_task": "FusedSegmentationCarving",
                   "level_set_value": 0.2, "background_prior": 1.0,
                   "min_contrast": 1.0, "min_score": 0.01},
    "OrganSegmentation": {"upstream_task": "PointCloud", "eps": 1.2,
                          "min_points": 5},
    "AnglesAndInternodes": {"upstream_task": "OrganSegmentation",
                            "organ_type": "fruit", "min_fruit_size": 2.0,
                            "min_elongation_ratio": 1.0,
                            "characteristic_length": 1.0, "stem_axis": 2,
                            "stem_axis_inverted": False},
    "Clean": {"no_confirm": True},
}
DOWNSTREAM = ("PointCloud", "OrganSegmentation", "AnglesAndInternodes")


def _label_volumes(plant, bbox, vs):
    """Per-label score volumes voxelized from the plant's own surface:
    organs score 0.8 on their (dilated) voxels, the background 1.0 off the
    plant and 0.8 on it (a tie, which goes to the organ)."""
    from scipy.ndimage import binary_dilation
    from plant3dvision_tpu.synth_photo import ML_LABELS
    origin = np.array([bbox[a][0] for a in "xyz"])
    shape = tuple(int((bbox[a][1] - bbox[a][0]) / vs) + 1 for a in "xyz")
    vols = {l: np.zeros(shape, np.float32) for l in ML_LABELS}
    for label, (pts, _) in plant.labeled_samples(density=40.0).items():
        idx = np.round((pts - origin) / vs).astype(int)
        occ = np.zeros(shape, bool)
        occ[tuple(idx.T)] = True
        vols[label] = 0.8 * binary_dilation(occ).astype(np.float32)
    on_plant = np.max([vols[l] for l in ML_LABELS[1:]], axis=0) > 0
    vols["background"] = np.where(on_plant, 0.8, 1.0).astype(np.float32)
    return vols, origin


def _downstream(scan, report):
    pfile = scan.get_fileset(report["PointCloud"]["fileset"]).get_files()[0]
    from plant3dvision_tpu_torch.fsdb.ply import read_ply
    pcd = read_ply(pfile.path())
    organs = sorted(f.id for f in scan.get_fileset(
        report["OrganSegmentation"]["fileset"]).get_files())
    angles = json.loads(scan.get_fileset(
        report["AnglesAndInternodes"]["fileset"]).get_file(
        "AnglesAndInternodes").read_raw())
    return pcd, pfile.get_metadata("labels"), organs, angles


def test_ml_path_matches_jax(temp_db, monkeypatch):
    from plant3dvision_tpu.fsdb import handoff as jax_handoff
    from plant3dvision_tpu.models import create_segnet
    from plant3dvision_tpu.models.checkpoint import save_model
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.runtime import run_task as jax_run_task
    from plant3dvision_tpu.synth_photo import (ML_LABELS,
                                               ProceduralArabidopsis,
                                               generate_photo_scan)
    from plant3dvision_tpu_torch.fsdb import handoff
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from sklearn.cluster import DBSCAN
    from plant3dvision_tpu_torch.proc3d import dbscan

    db = temp_db
    plant = ProceduralArabidopsis(n_fruits=8, seed=1)
    generate_photo_scan(db, "s", n_views=7, width=128, height=128,
                        plant=plant, with_gt_masks=False)
    _, params = create_segnet(jax.random.PRNGKey(0), input_shape=(1, 64, 64, 3),
                              widths=(16, 32), blocks_per_stage=1, n_classes=6)
    mfile = db.get_scan("models", create=True).get_fileset(
        "models", create=True).get_file("tiny", create=True)
    save_model(mfile, jax.tree.map(np.asarray, params),
               {"label_names": ML_LABELS, "arch": "tpusegnet",
                "widths": [16, 32], "blocks_per_stage": 1, "patch": 4})
    # the (34, 41, 66) x 6 grid goes through the slab lane: 3 slabs of 12
    monkeypatch.setenv("P3D_AVG_CHUNK_VOXELS", "200000")

    jctx = JaxRunContext(db, "s", ML_CFG)
    jrep = jax_run_task(jctx, "FusedSegmentationCarving", report=False)
    jfile = jctx.scan.get_fileset(
        jrep["FusedSegmentationCarving"]["fileset"]).get_files()[0]
    jvols, jmeta = dict(np.load(jfile.path())), jfile.get_metadata()
    jax_run_task(jctx, "Clean", report=False)

    ctx = RunContext(db, "s", ML_CFG, device="cpu")
    rep = run_task(ctx, "FusedSegmentationCarving", report=False)
    assert rep["FusedSegmentationCarving"]["fileset"] == \
        jrep["FusedSegmentationCarving"]["fileset"]
    pfile = ctx.scan.get_fileset(
        rep["FusedSegmentationCarving"]["fileset"]).get_files()[0]
    pvols = dict(np.load(pfile.path()))
    assert pfile.get_metadata() == jmeta
    assert list(pvols) == list(jvols) == ML_LABELS
    for l in ML_LABELS:
        assert pvols[l].shape == (34, 41, 66)
        np.testing.assert_allclose(pvols[l], jvols[l], atol=0.02, rtol=0)
    assert (jvols["stem"] > 0).mean() > 0.5           # most voxels seen

    # the same NPZ into both packages' PointCloud -> ... -> angles
    gt, origin = _label_volumes(plant, db.get_scan("s").get_metadata(
        "bounding_box"), 0.5)
    np.savez_compressed(pfile.path(), **gt)
    pfile.set_metadata({"voxel_size": 0.5, "origin": origin.tolist()})
    handoff.reset()
    jsel = multiclass_select(gt, ML_LABELS, 1.0, 1.0, 0.01)
    psel = multiclass.multiclass_select(gt, ML_LABELS, 1.0, 1.0, 0.01,
                                        device="cpu")
    for l in ML_LABELS[1:]:
        np.testing.assert_array_equal(psel[l].numpy(), np.asarray(jsel[l]))

    outs = []
    for pkg in ("jax", "port"):
        jax_handoff.reset()
        handoff.reset()
        if pkg == "jax":
            c = JaxRunContext(db, "s", ML_CFG)
            r = jax_run_task(c, "AnglesAndInternodes", report=False)
        else:
            c = RunContext(db, "s", ML_CFG, device="cpu")
            r = run_task(c, "AnglesAndInternodes", report=False)
        assert r["FusedSegmentationCarving"]["status"] == "skipped"
        outs.append((r, _downstream(c.scan, r)))
        for t in DOWNSTREAM:
            c.scan.delete_fileset(r[t]["fileset"])

    (jr, (jpcd, jlabels, jorgans, jang)), (pr, (ppcd, plabels, porgans,
                                                pang)) = outs
    for t in DOWNSTREAM:
        assert pr[t]["fileset"] == jr[t]["fileset"], t
    assert plabels == jlabels
    np.testing.assert_allclose(ppcd.points, jpcd.points, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ppcd.normals, jpcd.normals, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ppcd.colors, jpcd.colors, atol=1e-6, rtol=0)
    assert porgans == jorgans
    assert sum(o.startswith("fruit_") for o in porgans) >= 5
    assert len(pang["angles"]) == len(jang["angles"]) >= 4
    np.testing.assert_allclose(pang["angles"], jang["angles"], atol=0.05,
                               rtol=0)
    np.testing.assert_allclose(pang["internodes"], jang["internodes"],
                               atol=0.05, rtol=0)
    # DBSCAN on the pipeline's own fruit points, against scikit-learn
    fruit = ppcd.points[np.asarray(plabels) == "fruit"]
    np.testing.assert_array_equal(
        dbscan(fruit, 1.2, 5), DBSCAN(eps=1.2, min_samples=5).fit(fruit).labels_)
