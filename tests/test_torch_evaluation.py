"""The port's evaluation layer against the JAX package on the CPU: utils,
the cylinder, voxelize_surface, metrics.py (the set metrics and mask
comparisons bit-equal, the dilation at r 1-3 through the JAX jitted
binary_dilation against the port's plain version, chamfer / fitness /
RMSE within 1e-9 relative), and every evaluation and ground-truth task
and VoxelsWithPrior through both runtimes on small seeded inputs: equal
fileset ids, equal JSON (integers exactly, floats within 1e-9), equal
volumes. Where the JAX package fails on an input, the port fails the
same way (SegmentedPointCloudEvaluation without ground-truth labels).
The synthetic scans that carry ground-truth masks (synth.generate_ml_scan,
synth_photo.generate_photo_scan's masks in a fileset of their own) equal
the JAX package's file for file.
"""

import json

import numpy as np
import pytest
import torch

from plant3dvision_tpu.fsdb import io as jio
from plant3dvision_tpu.fsdb.geometry import PointCloud as JaxPointCloud
from plant3dvision_tpu.fsdb.geometry import TriangleMesh as JaxTriangleMesh
from plant3dvision_tpu.runtime import RunContext as JaxRunContext
from plant3dvision_tpu.runtime import run_task as jax_run_task

from plant3dvision_tpu_torch.fsdb import io
from plant3dvision_tpu_torch.fsdb.geometry import PointCloud, TriangleMesh
from plant3dvision_tpu_torch.runtime import RunContext, run_task

torch.set_num_threads(1)


def assert_same(got, want, rtol=1e-9, path="$"):
    """JSON-like values equal: same keys and lengths, integers, strings and
    None exactly, floats within `rtol` relative (NaN equal to NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), (path, got, want)
        if np.isnan(want):
            assert np.isnan(got), path
        else:
            assert got == pytest.approx(want, rel=rtol, abs=1e-300), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# -- utils, cylinder, voxelize_surface ---------------------------------------

@pytest.mark.parametrize("values", [[0.1, 2.4, 3.0], [137.5, 140.0],
                                    [], [-7.0, 1.0], [np.nan, 2.0]])
def test_utils_as_jax(values):
    from plant3dvision_tpu import utils as ju
    from plant3dvision_tpu_torch import utils as pu
    assert pu.is_radians(values) == ju.is_radians(values)
    nested = [1, [2, (3, [4])], np.float32(5.5)]
    assert pu.flatten(nested) == ju.flatten(nested)
    obj = {"a": np.arange(3), "b": [np.int64(4), (np.float64(0.5),)],
           "c": {"d": np.array([[1.5]])}, "e": "s"}
    assert json.dumps(pu.jsonify(obj)) == json.dumps(ju.jsonify(obj))
    for n in (0, 1023, 1024, 5 * 1024 ** 2 + 7, 3 * 1024 ** 5):
        assert pu.auto_format_bytes(n) == ju.auto_format_bytes(n)


def test_read_measures_as_jax(temp_db):
    from plant3dvision_tpu.utils import read_measures as jax_read
    from plant3dvision_tpu_torch.utils import read_measures
    scan = temp_db.get_scan("s", create=True)
    assert read_measures(scan) == jax_read(scan) == {}
    (scan.path() / "measures.json").write_text(
        json.dumps({"angles": [2.4, 2.3], "internodes": [5.0, 6.0]}))
    assert read_measures(scan) == jax_read(scan)


@pytest.mark.parametrize("radius,height,noise", [(10.0, 40.0, 0.0),
                                                  (30.0, 12.0, 0.2),
                                                  (3.5, 90.0, 0.05)])
def test_cylinder_as_jax(radius, height, noise):
    from plant3dvision_tpu import evaluation as je
    from plant3dvision_tpu_torch import evaluation as pe
    got = pe.make_cylinder_pcd(radius, height, 5000, noise, seed=3)
    want = je.make_cylinder_pcd(radius, height, 5000, noise, seed=3)
    np.testing.assert_array_equal(got.points, want.points)
    r = pe.estimate_cylinder_radius(got)
    assert r == pytest.approx(je.estimate_cylinder_radius(want), rel=1e-12)
    assert abs(r - radius) < 0.1 * radius


def _random_mesh(seed, n=60, scale=4.0):
    rng = np.random.default_rng(seed)
    v = rng.random((n, 3)) * scale
    t = rng.integers(0, n, (2 * n, 3))
    return v, t


@pytest.mark.parametrize("seed,vs", [(0, 0.25), (1, 0.1), (2, 0.5)])
def test_voxelize_surface_bit_equal(seed, vs):
    from plant3dvision_tpu import proc3d as jp
    from plant3dvision_tpu_torch import proc3d as pp
    v, t = _random_mesh(seed)
    got = pp.voxelize_surface(TriangleMesh(v, t), vs)
    want = jp.voxelize_surface(JaxTriangleMesh(v, t), vs)
    assert got.any()
    np.testing.assert_array_equal(got, want)
    origin, shape = v.min(0) - 0.3, (14, 9, 11)
    np.testing.assert_array_equal(
        pp.voxelize_surface(TriangleMesh(v, t), vs, origin, shape),
        jp.voxelize_surface(JaxTriangleMesh(v, t), vs, origin, shape))


# -- metrics -----------------------------------------------------------------

def _masks(seed, n=3, shape=(37, 53), p=0.08):
    rng = np.random.default_rng(seed)
    return ((rng.random((n,) + shape) < p).astype(np.uint8) * 255,
            (rng.random((n,) + shape) < 0.2).astype(np.uint8) * 255)


@pytest.mark.parametrize("seed", [0, 1])
def test_set_metrics_bit_equal(seed):
    from plant3dvision_tpu.metrics import SetMetrics as JaxSet
    from plant3dvision_tpu_torch.metrics import SetMetrics
    gt, pr = _masks(seed)
    a, b = SetMetrics(), JaxSet()
    for g, p in zip(gt, pr):
        a.add(g, p)
        b.add(g, p)
    assert_same(a.as_dict(), b.as_dict(), rtol=0)
    assert_same((a + SetMetrics(gt[0], pr[0])).as_dict(),
                (b + JaxSet(gt[0], pr[0])).as_dict(), rtol=0)
    assert_same(SetMetrics().as_dict(), JaxSet().as_dict(), rtol=0)


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
def test_compare_masks_dilation_bit_equal(radius):
    """CompareMasks' dilation: the JAX jitted binary_dilation against the
    port's (its plain version on the CPU)."""
    from plant3dvision_tpu.metrics import CompareMasks as JaxCompare
    from plant3dvision_tpu_torch.metrics import CompareMasks, dilate_masks
    from plant3dvision_tpu.ops.masks import binary_dilation
    gt, pr = _masks(radius + 10)
    for g, p in zip(gt, pr):
        got = CompareMasks(g, p, radius, device="cpu").as_dict()
        assert_same(got, JaxCompare(g, p, radius).as_dict(), rtol=0)
    if radius:
        np.testing.assert_array_equal(
            dilate_masks(gt, radius, "cpu"),
            np.asarray(binary_dilation(gt != 0, radius)))


def _mask_filesets(db, seed, views=3, labels=("fruit", "stem", "leaf"),
                   shapes=((29, 41),)):
    """A ground-truth and a prediction fileset of seeded masks, keyed by
    (shot_id, channel) as the task matches them; the prediction has one
    extra view the ground truth lacks and one unlisted channel. View v's
    masks have shape shapes[v % len(shapes)]."""
    scan = db.get_scan("s", create=True)
    rng = np.random.default_rng(seed)
    gt = scan.get_fileset("gt", create=True)
    pr = scan.get_fileset("pred", create=True)
    for v in range(views + 1):
        for label in labels + ("flower",):
            for fs, p in ((gt, 0.06), (pr, 0.1)):
                if fs is gt and v == views:
                    continue
                m = (rng.random(shapes[v % len(shapes)]) < p).astype(
                    np.uint8) * 255
                f = fs.create_file(f"{v:05d}_{label}")
                jio.write_image(f, m, "png")
                f.set_metadata({"shot_id": f"{v:06d}", "channel": label})
    pr.set_metadata("label_names", ["background"] + list(labels))
    return scan, gt, pr


@pytest.mark.parametrize("dilation", [0, 1, 3])
def test_compare_mask_filesets_bit_equal(temp_db, dilation):
    """Each label's ground truth dilated as one stack in the port: the
    counts per file and per label equal the JAX package's per-file ones."""
    from plant3dvision_tpu.metrics import CompareMaskFilesets as JaxCMF
    from plant3dvision_tpu_torch.metrics import CompareMaskFilesets
    _, gt, pr = _mask_filesets(temp_db, dilation)
    labels = ["fruit", "stem", "leaf"]
    want = JaxCMF(gt, pr, labels, dilation).results
    got = CompareMaskFilesets(gt, pr, labels, dilation, device="cpu").results
    assert len(got["evaluation-results"]) == 9
    assert_same(got, want, rtol=0)


@pytest.mark.parametrize("dilation", [0, 2])
def test_compare_mask_filesets_mixed_shapes_bit_equal(temp_db, monkeypatch,
                                                      dilation):
    """Masks of two shapes within a label: the port dilates a label's masks
    of each shape as one stack, one call a (label, shape), and without
    dilation reads and counts pair by pair, never dilating; counts per file
    and per label, and the files' order, equal the JAX package's."""
    from plant3dvision_tpu.metrics import CompareMaskFilesets as JaxCMF
    from plant3dvision_tpu_torch import metrics
    _, gt, pr = _mask_filesets(temp_db, 5, views=5,
                               shapes=((29, 41), (17, 23)))
    labels = ["stem", "fruit", "leaf"]
    want = JaxCMF(gt, pr, labels, dilation).results
    calls = []
    dilate = metrics.dilate_masks
    monkeypatch.setattr(metrics, "dilate_masks", lambda m, r, device: (
        calls.append(np.shape(m)), dilate(m, r, device))[1])
    got = metrics.CompareMaskFilesets(gt, pr, labels, dilation,
                                      device="cpu").results
    assert len(got["evaluation-results"]) == 15
    assert_same(got, want, rtol=0)
    assert sorted(calls) == ([] if dilation == 0 else sorted(
        [(2, 17, 23), (3, 29, 41)] * 3))


def _clouds(seed, n=(700, 900)):
    rng = np.random.default_rng(seed)
    a = rng.random((n[0], 3)) * 10
    b = a[rng.choice(n[0], n[1] // 2)] + rng.normal(0, 0.3, (n[1] // 2, 3))
    b = np.concatenate([b, rng.random((n[1] - len(b), 3)) * 14 - 2])
    return a, b


@pytest.mark.parametrize("seed,max_distance", [(0, 2.0), (1, 0.2),
                                               (2, 1e-9)])
def test_chamfer_and_fitness_as_jax(seed, max_distance):
    from plant3dvision_tpu import metrics as jm
    from plant3dvision_tpu_torch import metrics as pm
    a, b = _clouds(seed)
    assert pm.chamfer_distance(PointCloud(a), PointCloud(b)) == \
        pytest.approx(jm.chamfer_distance(JaxPointCloud(a),
                                          JaxPointCloud(b)), rel=1e-9)
    got = pm.point_cloud_registration_fitness(a, b, max_distance)
    want = jm.point_cloud_registration_fitness(a, b, max_distance)
    assert_same(list(got), list(want))
    assert np.isnan(pm.chamfer_distance(a[:0], b))
    assert_same(list(pm.point_cloud_registration_fitness(a, b[:0])),
                list(jm.point_cloud_registration_fitness(a, b[:0])))


def test_nearest_breaks_ties_by_index():
    from plant3dvision_tpu_torch.metrics import nearest
    ref = np.array([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [0, 0, 5.0]])
    d, i = nearest(ref[::-1].copy(), np.zeros((1, 3)))
    assert d[0] == 1.0 and i[0] == 1          # rows 1-3 of the flip tie
    d, i = nearest(ref, np.array([[0.9, 0, 0]]))
    assert i[0] == 0 and d[0] == pytest.approx(0.1)


def test_compare_segmented_point_clouds_as_jax():
    from plant3dvision_tpu.metrics import CompareSegmentedPointClouds as J
    from plant3dvision_tpu_torch.metrics import CompareSegmentedPointClouds
    a, b = _clouds(5)
    rng = np.random.default_rng(5)
    la = list(rng.choice(["stem", "fruit", "leaf"], len(a)))
    lb = list(rng.choice(["stem", "fruit", "pedicel"], len(b)))
    got = CompareSegmentedPointClouds(PointCloud(a), la, PointCloud(b),
                                      lb).results
    want = J(JaxPointCloud(a), la, JaxPointCloud(b), lb).results
    assert_same(got, want)


def test_compare_segmented_point_clouds_without_labels_fails_as_jax():
    """Ground truth without labels (PointCloudGroundTruth writes none):
    the JAX package raises TypeError ('iteration over a 0-d array') before
    any query; so does the port."""
    from plant3dvision_tpu.metrics import CompareSegmentedPointClouds as J
    from plant3dvision_tpu_torch.metrics import CompareSegmentedPointClouds
    a, b = _clouds(6)
    lb = ["stem"] * len(b)
    msgs = []
    for cls, P in ((J, JaxPointCloud), (CompareSegmentedPointClouds,
                                        PointCloud)):
        with pytest.raises(TypeError) as info:
            cls(P(a), None, P(b), lb)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] == "iteration over a 0-d array"


def test_mesh_ratios_as_jax():
    from plant3dvision_tpu import metrics as jm
    from plant3dvision_tpu_torch import metrics as pm
    import chip_smoke
    v1, t1 = chip_smoke.tube_mesh([0, 0, 0], [0, 0, 5], 1.0)
    v2, t2 = chip_smoke.tube_mesh([0, 1, 0], [2, 0, 3], 0.7, n=7)
    for f in ("surface_ratio", "volume_ratio"):
        assert getattr(pm, f)(TriangleMesh(v1, t1), TriangleMesh(v2, t2)) \
            == getattr(jm, f)(JaxTriangleMesh(v1, t1),
                              JaxTriangleMesh(v2, t2))
    assert np.isnan(pm.volume_ratio(TriangleMesh(v1, t1), TriangleMesh()))


# -- tasks -------------------------------------------------------------------

def _reports(db, cfg, task, scan_id="s", keep=()):
    """`task` through the JAX runtime, then (its output and those of the
    tasks it ran but `keep` deleted) through the port's on the CPU;
    returns the two outputs' files."""
    out = []
    for pkg in ("jax", "port"):
        ctx = (JaxRunContext(db, scan_id, cfg) if pkg == "jax"
               else RunContext(db, scan_id, cfg, device="cpu"))
        rep = (jax_run_task if pkg == "jax" else run_task)(
            ctx, task, report=False)
        fs = ctx.scan.get_fileset(rep[task]["fileset"])
        files = {f.id: (f, f.get_metadata()) for f in fs.get_files()}
        payload = {fid: (f.path().read_bytes() if f.filename else None, md)
                   for fid, (f, md) in files.items()}
        out.append((rep, payload))
        if pkg == "jax":
            for t, r in rep.items():
                if r["status"] == "done" and t not in keep:
                    ctx.scan.delete_fileset(r["fileset"])
    (jrep, jout), (prep, pout) = out
    for t, r in jrep.items():
        assert prep[t]["fileset"] == r["fileset"], t
        assert prep[t]["status"] == ("skipped" if t in keep
                                     else r["status"]), t
    return jout, pout


def _same_json_files(jout, pout):
    assert list(pout) == list(jout)
    for fid in jout:
        if jout[fid][0] is not None and fid != "alignment_figure":
            assert_same(json.loads(pout[fid][0]), json.loads(jout[fid][0]))
        assert_same(pout[fid][1], jout[fid][1])


def _plant_scan(db, seed=0):
    """A small silhouette scan of a seeded synthetic plant (its
    VirtualPlant fileset the plant's PLY mesh), and the plant."""
    from plant3dvision_tpu.synth import SyntheticPlant, generate_scan
    plant = SyntheticPlant(n_fruits=5, stem_radius=2.0, fruit_radius=1.5,
                           fruit_length=14.0, internode=9.0, seed=seed)
    generate_scan(db, "s", n_views=8, width=96, height=96, f=100.0,
                  plant=plant, render_step=1.0)
    return plant


def _write_pcd(db, fs_id, pts, labels=None):
    scan = db.get_scan("s")
    f = scan.get_fileset(fs_id, create=True).create_file(fs_id)
    jio.write_point_cloud(f, JaxPointCloud(pts))
    if labels is not None:
        f.set_metadata("labels", list(labels))
    return f


def test_point_cloud_ground_truth_fails_in_jax_runs_in_the_port(temp_db):
    """The JAX PointCloudGroundTruth always raises TypeError (it indexes
    `input()`, one target, as a list); the port's task, the same fileset
    id, samples the VirtualPlant mesh as it is, as the JAX task means to:
    the points the JAX package's own reader and sampler give, and the
    angle metadata."""
    from plant3dvision_tpu.runtime.runner import TaskFailure as JaxFailure
    _plant_scan(temp_db)
    cfg = {"PointCloudGroundTruth": {"pcd_size": 4000}}
    jctx = JaxRunContext(temp_db, "s", cfg)
    with pytest.raises(JaxFailure) as info:
        jax_run_task(jctx, "PointCloudGroundTruth", report=False)
    assert repr(info.value.__cause__) == ("TypeError(\"'FilesetTarget' "
                                          "object is not subscriptable\")")
    ctx = RunContext(temp_db, "s", cfg, device="cpu")
    rep = run_task(ctx, "PointCloudGroundTruth", report=False)
    fs_id = rep["PointCloudGroundTruth"]["fileset"]
    assert fs_id == jctx.get_task("PointCloudGroundTruth").output().fileset_id
    got, = ctx.scan.get_fileset(fs_id).get_files()
    vp = temp_db.get_scan("s").get_fileset("VirtualPlant_synthetic")
    want = jio.read_triangle_mesh(vp.get_files()[0]) \
        .sample_points_poisson_disk(4000).points
    np.testing.assert_array_equal(io.read_point_cloud(got).points, want)
    assert got.get_metadata("angles") == vp.get_files()[0].get_metadata(
        "angles")


def test_point_cloud_evaluation(temp_db):
    """PointCloudEvaluation of a seeded cloud near the plant (a
    FilesetExists input) against the port's PointCloudGroundTruth (which
    both runtimes then read): equal JSON."""
    plant = _plant_scan(temp_db)
    pts = plant.to_mesh().sample_points_poisson_disk(3000, seed=4).points
    rng = np.random.default_rng(1)
    _write_pcd(temp_db, "pred", pts + rng.normal(0, 0.4, pts.shape))
    cfg = {"PointCloudGroundTruth": {"pcd_size": 4000},
           "NamedFilesetExists": {"fileset_id": "pred"},
           "PointCloudEvaluation": {"upstream_task": "NamedFilesetExists",
                                    "max_distance": 1.0}}
    run_task(RunContext(temp_db, "s", cfg, device="cpu"),
             "PointCloudGroundTruth", report=False)
    jout, pout = _reports(temp_db, cfg, "PointCloudEvaluation",
                          keep=("PointCloudGroundTruth",))
    _same_json_files(jout, pout)
    res = json.loads(next(iter(pout.values()))[0])
    assert 0.5 < res["fitness"] <= 1 and res["n_gt"] > 300


def _ply_points(db, raw):
    from plant3dvision_tpu_torch.fsdb import ply
    p = db.path() / "_tmp.ply"
    p.write_bytes(raw)
    return ply.read_ply(p).points


def test_voxels_ground_truth_and_evaluation(temp_db):
    """VoxelsGroundTruth on the OBJ that chip_smoke writes (one usemtl block
    an organ, L-system axes), and VoxelsEvaluation in both protocols
    (strict argmax with contrast, soft_ratio) against a seeded label
    volume on another grid: equal NPZ volumes and metadata, equal JSON."""
    import chip_smoke
    plant = _plant_scan(temp_db)
    chip_smoke.write_virtual_plant_obj(
        temp_db.get_scan("s"), chip_smoke.virtual_plant_organs(plant))
    cfg = {"VoxelsGroundTruth": {"voxel_size": 1.5},
           "NamedFilesetExists": {"fileset_id": "vox"},
           "VoxelsEvaluation": {"upstream_task": "NamedFilesetExists"}}
    jout, pout = _reports(temp_db, cfg, "VoxelsGroundTruth")
    (fid, (jb, jmd)), = jout.items()
    assert pout[fid][1] == jmd
    p = temp_db.path() / "_gt.npz"
    p.write_bytes(jb)
    want = dict(np.load(p))
    p.write_bytes(pout[fid][0])
    got = dict(np.load(p))
    assert list(got) == list(want) == ["stem", "pedicel", "fruit",
                                       "background"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert want["fruit"].sum() > 20

    # a label volume on the scan's own grid: the ground truth resampled by
    # world coordinates, plus noise
    bbox = temp_db.get_scan("s").get_metadata("bounding_box")
    origin = np.array([bbox[a][0] for a in "xyz"])
    vs = 1.0
    shape = tuple(int((bbox[a][1] - bbox[a][0]) / vs) + 1 for a in "xyz")
    ii = np.stack(np.meshgrid(*(np.arange(s) for s in shape),
                              indexing="ij"), -1)
    gidx = np.round((origin + ii * vs - np.asarray(jmd["origin"]))
                    / jmd["voxel_size"]).astype(int)
    rng = np.random.default_rng(2)
    vols = {}
    for label, arr in want.items():
        inb = np.all((gidx >= 0) & (gidx < arr.shape), -1)
        v = np.zeros(shape)
        g = gidx[inb]
        v[inb] = arr[g[:, 0], g[:, 1], g[:, 2]]
        vols[label] = np.clip(v * 0.8 + rng.random(shape) * 0.3, 0, 1)
    f = temp_db.get_scan("s").get_fileset("vox", create=True).create_file(
        "vox")
    jio.write_npz(f, vols)
    f.set_metadata({"voxel_size": vs, "origin": origin.tolist()})
    for params in ({}, {"contrast": 1.5}, {"soft_ratio": 0.7}):
        cfg["VoxelsEvaluation"].update(params)
        jout, pout = _reports(temp_db, cfg, "VoxelsEvaluation")
        _same_json_files(jout, pout)
        res = json.loads(next(iter(pout.values()))[0])
        assert set(res) == {"stem", "pedicel", "fruit"}
        assert sum(r["tp"] for r in res.values()) > 0


def test_voxels_evaluation_against_a_mesh(temp_db):
    """VoxelsEvaluation's mesh protocol (ground truth a VirtualPlant PLY):
    per label, the volume above the threshold against the voxels the
    mesh's samples fall in."""
    _plant_scan(temp_db)
    bbox = temp_db.get_scan("s").get_metadata("bounding_box")
    origin = [bbox[a][0] for a in "xyz"]
    shape = tuple(int((bbox[a][1] - bbox[a][0]) / 2.0) + 1 for a in "xyz")
    rng = np.random.default_rng(3)
    f = temp_db.get_scan("s").get_fileset("vox", create=True).create_file(
        "vox")
    jio.write_npz(f, {"plant": rng.random(shape),
                      "background": rng.random(shape)})
    f.set_metadata({"voxel_size": 2.0, "origin": origin})
    cfg = {"NamedFilesetExists": {"fileset_id": "vox"},
           "VoxelsEvaluation": {"upstream_task": "NamedFilesetExists",
                                "ground_truth": "VirtualPlantObj"}}
    _same_json_files(*_reports(temp_db, cfg, "VoxelsEvaluation"))


def test_clustered_mesh_ground_truth(temp_db):
    """ClusteredMeshGroundTruth: one file an organ component, the L-system
    axes undone, equal ids, labels and meshes."""
    import chip_smoke
    plant = _plant_scan(temp_db)
    chip_smoke.write_virtual_plant_obj(
        temp_db.get_scan("s"), chip_smoke.virtual_plant_organs(plant))
    jout, pout = _reports(temp_db, {}, "ClusteredMeshGroundTruth")
    assert list(pout) == list(jout) and len(jout) == 1 + 2 * 5
    for fid in jout:
        assert pout[fid] == jout[fid]


def test_segmentation2d_evaluation(temp_db):
    """Segmentation2DEvaluation over NamedFilesetExists' predictions
    against Segmentation2DGroundTruthFilesetExists' masks, labels given and
    from the prediction's label_names, dilation 0 and 2."""
    _mask_filesets(temp_db, 7)
    cfg = {"NamedFilesetExists": {"fileset_id": "pred"},
           "Segmentation2DGroundTruthFilesetExists": {"fileset_id": "gt"},
           "Segmentation2DEvaluation": {
               "upstream_task": "NamedFilesetExists"}}
    for params in ({"labels": ["stem", "fruit"], "dilation_amount": 0},
                   {"labels": [], "dilation_amount": 2}):
        cfg["Segmentation2DEvaluation"].update(params)
        jout, pout = _reports(temp_db, cfg, "Segmentation2DEvaluation")
        _same_json_files(jout, pout)


def test_segmented_point_cloud_evaluation(temp_db):
    """With labelled ground truth both packages give equal JSON; with
    PointCloudGroundTruth's (no labels; the port's, which both read) both
    fail (TypeError inside the task: the runner's TaskFailure, its cause
    the same message)."""
    from plant3dvision_tpu.runtime.runner import TaskFailure as JaxFailure
    from plant3dvision_tpu_torch.runtime.runner import TaskFailure
    _plant_scan(temp_db)
    a, b = _clouds(8)
    rng = np.random.default_rng(8)
    _write_pcd(temp_db, "pred", b, rng.choice(["stem", "fruit"], len(b)))
    _write_pcd(temp_db, "gt", a, rng.choice(["stem", "fruit"], len(a)))
    cfg = {"NamedFilesetExists": {"fileset_id": "pred"},
           "Segmentation2DGroundTruthFilesetExists": {"fileset_id": "gt"},
           "SegmentedPointCloudEvaluation": {
               "upstream_task": "NamedFilesetExists",
               "ground_truth": "Segmentation2DGroundTruthFilesetExists"}}
    _same_json_files(*_reports(temp_db, cfg,
                               "SegmentedPointCloudEvaluation"))
    cfg["SegmentedPointCloudEvaluation"]["ground_truth"] = \
        "PointCloudGroundTruth"
    cfg["PointCloudGroundTruth"] = {"pcd_size": 500}
    run_task(RunContext(temp_db, "s", cfg, device="cpu"),
             "PointCloudGroundTruth", report=False)
    causes = []
    for pkg in ("jax", "port"):
        ctx = (JaxRunContext(temp_db, "s", cfg) if pkg == "jax"
               else RunContext(temp_db, "s", cfg, device="cpu"))
        with pytest.raises((JaxFailure, TaskFailure)) as info:
            (jax_run_task if pkg == "jax" else run_task)(
                ctx, "SegmentedPointCloudEvaluation", report=False)
        causes.append((str(info.value), repr(info.value.__cause__)))
    assert causes[0] == causes[1]
    assert "iteration over a 0-d array" in causes[1][1]


@pytest.mark.parametrize("radius,height", [("random", "random"),
                                           (7.5, 20.0)])
def test_cylinder_tasks(temp_db, radius, height):
    """virtual_cylinder.toml's tasks: the ground truth (its seed out of the
    fileset id) and the radius estimate from its own cloud."""
    temp_db.get_scan("s", create=True)
    cfg = {"CylinderRadiusGroundTruth": {"radius": radius, "height": height,
                                         "seed": 3},
           "CylinderRadiusEstimation": {
               "upstream_task": "CylinderRadiusGroundTruth"}}
    jout, pout = _reports(temp_db, cfg, "CylinderRadiusEstimation")
    _same_json_files(jout, pout)
    res = json.loads(next(iter(pout.values()))[0])
    assert res["err (%)"] < 1.0
    ctx = RunContext(temp_db, "s", dict(cfg, CylinderRadiusGroundTruth=dict(
        cfg["CylinderRadiusGroundTruth"], seed=4)), device="cpu")
    assert ctx.get_task("CylinderRadiusGroundTruth").output().fileset_id \
        == JaxRunContext(temp_db, "s", cfg).get_task(
            "CylinderRadiusGroundTruth").output().fileset_id


@pytest.mark.parametrize("gt_task", ["VirtualPlantObj", "ImagesFilesetExists"])
def test_angles_and_internodes_evaluation(temp_db, gt_task):
    """DTW of a seeded angle sequence (a NamedFilesetExists input) against the
    VirtualPlant metadata or measures.json, in radians; the alignment
    figure is written (matplotlib imports here) and never fatal."""
    plant = _plant_scan(temp_db)
    rng = np.random.default_rng(9)
    scan = temp_db.get_scan("s")
    f = scan.get_fileset("ang", create=True).create_file(
        "AnglesAndInternodes")
    gt = np.degrees(plant.gt_angles)
    jio.write_json(f, {"angles": list(gt[1:] + rng.normal(0, 3, len(gt) - 1)),
                       "internodes": list(plant.gt_internodes[1:])})
    cfg = {"NamedFilesetExists": {"fileset_id": "ang"},
           "AnglesAndInternodesEvaluation": {
               "upstream_task": "NamedFilesetExists", "ground_truth": gt_task}}
    jout, pout = _reports(temp_db, cfg, "AnglesAndInternodesEvaluation")
    assert "alignment_figure" in pout
    _same_json_files(jout, pout)


def test_voxels_with_prior(temp_db):
    """VoxelsWithPrior on a seeded label volume, n_views from the scan's
    images and given: equal volumes within 1e-12."""
    _plant_scan(temp_db)
    rng = np.random.default_rng(11)
    f = temp_db.get_scan("s").get_fileset("vox", create=True).create_file(
        "vox")
    jio.write_npz(f, {k: rng.random((7, 5, 9)) * 1.2 - 0.1
                      for k in ("background", "stem", "fruit")})
    f.set_metadata({"voxel_size": 0.5, "origin": [1.0, 2.0, 3.0]})
    for params in ({}, {"n_views": 12, "recall": {"stem": 0.8},
                        "specificity": {"fruit": 0.95, "stem": 0.7}}):
        cfg = {"NamedFilesetExists": {"fileset_id": "vox"},
               "VoxelsWithPrior": {"upstream_task": "NamedFilesetExists",
                                   **params}}
        jout, pout = _reports(temp_db, cfg, "VoxelsWithPrior")
        (fid, (jb, jmd)), = jout.items()
        assert pout[fid][1] == jmd
        p = temp_db.path() / "_prior.npz"
        p.write_bytes(jb)
        want = dict(np.load(p))
        p.write_bytes(pout[fid][0])
        got = dict(np.load(p))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)


def test_evaluation_task_is_abstract(temp_db):
    from plant3dvision_tpu_torch.runtime.task import TaskRegistry
    temp_db.get_scan("s", create=True)
    ctx = RunContext(temp_db, "s", {}, device="cpu")
    task = ctx.get_task(TaskRegistry.get("EvaluationTask"))
    with pytest.raises(NotImplementedError):
        task.evaluate()


# -- synthetic scans with ground-truth masks ---------------------------------

def _scan_contents(scan, read_image):
    """{fileset id: (fileset metadata, [(file id, filename, metadata,
    decoded image or raw bytes)])} and the scan's metadata."""
    out = {}
    for fs_id in sorted(scan.list_filesets()):
        fs = scan.get_fileset(fs_id)
        files = []
        for f in sorted(fs.get_files(), key=lambda f: f.id):
            data = (read_image(f) if f.filename.endswith(".png")
                    else f.read_raw())
            files.append((f.id, f.filename, f.get_metadata(), data))
        out[fs_id] = (fs.get_metadata(), files)
    return out, scan.get_metadata()


def _assert_same_scans(got, want):
    (gfs, gmd), (wfs, wmd) = got, want
    assert gmd == wmd
    assert list(gfs) == list(wfs)
    for fs_id, (wfmd, wfiles) in wfs.items():
        gfmd, gfiles = gfs[fs_id]
        assert gfmd == wfmd, fs_id
        assert [f[:3] for f in gfiles] == [f[:3] for f in wfiles], fs_id
        for (fid, _, _, g), (_, _, _, w) in zip(gfiles, wfiles):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype, fid
                np.testing.assert_array_equal(g, w, err_msg=fid)
            else:
                assert g == w, fid


def test_generate_ml_scan_bit_equal(temp_db):
    """synth.generate_ml_scan (the colour-coded RGB scan with its gt_masks
    fileset, the ML evaluation's ground truth): the port's and the JAX
    package's scans of one plant have the same filesets, file ids,
    metadata, decoded images and masks, and OBJ bytes."""
    from plant3dvision_tpu.synth import SyntheticPlant as JaxPlant
    from plant3dvision_tpu.synth import generate_ml_scan as jax_generate
    from plant3dvision_tpu_torch.fsdb.testing import TemporaryDB
    from plant3dvision_tpu_torch.synth import SyntheticPlant, generate_ml_scan
    kw = dict(n_fruits=3, internode=8.0, fruit_length=12.0)
    want = _scan_contents(jax_generate(
        temp_db, "s", n_views=3, width=96, height=80, f=90.0,
        plant=JaxPlant(**kw)), jio.read_image)
    with TemporaryDB() as db:
        got = _scan_contents(generate_ml_scan(
            db, "s", n_views=3, width=96, height=80, f=90.0,
            plant=SyntheticPlant(**kw)), io.read_image)
    assert len(want[0]["gt_masks"][1]) == 3 * 4
    _assert_same_scans(got, want)


def test_generate_photo_scan_threads_equal_the_jax_scan(temp_db):
    """More views than the renderer keeps in flight (2 x its threads): the
    port's threaded render writes the JAX package's sequential scan,
    image for image."""
    from plant3dvision_tpu.synth_photo import (
        ProceduralArabidopsis as JaxPlant)
    from plant3dvision_tpu.synth_photo import (
        generate_photo_scan as jax_generate)
    from plant3dvision_tpu_torch.fsdb.testing import TemporaryDB
    from plant3dvision_tpu_torch.synth_photo import (ProceduralArabidopsis,
                                                     generate_photo_scan)
    kw = dict(n_views=19, width=40, height=32, density=20.0)
    jfs, _ = _scan_contents(jax_generate(temp_db, "s", plant=JaxPlant(seed=2),
                                         **kw), jio.read_image)
    with TemporaryDB() as db:
        pfs, _ = _scan_contents(generate_photo_scan(
            db, "s", plant=ProceduralArabidopsis(seed=2), **kw),
            io.read_image)
    want, got = jfs["images"][1], pfs["images"][1]
    assert len(got) == 19 * 6
    assert [f[:3] for f in got] == [f[:3] for f in want]
    for (fid, _, _, g), (_, _, _, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=fid)


def test_generate_photo_scan_gt_fileset(temp_db):
    """synth_photo.generate_photo_scan's `gt_fileset`: the organs' masks
    written into a fileset of their own equal, file for file, those the
    JAX package writes beside the images, and the images are the same."""
    from plant3dvision_tpu.synth_photo import (
        ProceduralArabidopsis as JaxPlant)
    from plant3dvision_tpu.synth_photo import (
        generate_photo_scan as jax_generate)
    from plant3dvision_tpu_torch.fsdb.testing import TemporaryDB
    from plant3dvision_tpu_torch.synth_photo import (ProceduralArabidopsis,
                                                     generate_photo_scan)
    kw = dict(n_views=2, width=72, height=64, density=40.0)
    jfs, _ = _scan_contents(jax_generate(temp_db, "s", plant=JaxPlant(seed=1),
                                         **kw), jio.read_image)
    with TemporaryDB() as db:
        pfs, _ = _scan_contents(generate_photo_scan(
            db, "s", plant=ProceduralArabidopsis(seed=1),
            gt_fileset="Segmentation2DGroundTruth", **kw), io.read_image)
    jimages = jfs["images"][1]
    rgb = [f for f in jimages if f[0].endswith("_rgb")]
    masks = [f for f in jimages if not f[0].endswith("_rgb")]
    assert len(masks) == 2 * 5
    assert list(pfs) == sorted(["Segmentation2DGroundTruth"] + list(jfs))
    for fs_id, want in (("images", rgb), ("Segmentation2DGroundTruth",
                                          masks)):
        got = pfs[fs_id][1]
        assert [f[:3] for f in got] == [f[:3] for f in want], fs_id
        for (fid, _, _, g), (_, _, _, w) in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=fid)
