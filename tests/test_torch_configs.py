"""Which shipped configs the port runs, and the fully ported chains through
both packages on the CPU.

- Every section of every configs/*.toml that names a task (of the JAX
  package's registry): the task classes of its chain (the task and
  everything it requires, as the JAX runtime resolves them) that the
  port's registry lacks must be exactly the ones listed in MISSING (none
  now), so a task that goes missing from the port shows here.
- geom_pipe_synth, test_geom_pipe_virtual, ml_pipe_synth and
  geom_pipe_euler_virtual (every task of their chains is ported) through
  both packages on small synthetic scans, the port on the CPU: equal
  fileset ids for every task of the chain, the same number of angles and
  the angles within 0.05 deg (the path tests' parity). Their cuts:
  small scans; ml_pipe_synth's net replaced in both packages by the same
  probabilities (the plant's organ masks; the CNN's bfloat16 rounding
  is held to JAX in tests/test_torch_seg.py); geom_pipe_euler_virtual's
  CEM population, iterations and polish rounds cut as in
  tests/test_torch_calibration_task.py, with a box around the plant, and
  its calibration (the JAX package's) read by both. geom_pipe_synth's
  angles are held to 0.1 deg (its test says why).
- geom_pipe_full and test_geom_pipe_real (Colmap first) through both
  packages on a small scan written as a rig logs it
  (chip_smoke.write_distorted_scan(rig=True)), with the stand-in colmap
  (chip_smoke.write_standin_colmap) recovering the true cameras. Their
  cuts: 16 views at 320x240; the stand-in's camera OPENCV [f, f, cx, cy,
  k1, 0, 0, 0], the scan's lens, where a COLMAP asked for SIMPLE_RADIAL
  writes [f, cx, cy, k1], which the JAX package's carve misreads
  (test_simple_radial_camera_read_by_its_model); geom_pipe_full's
  distance_threshold 5 (chip_smoke.FULL_DISTANCE_THRESHOLD);
  test_geom_pipe_real's box, the real_plant fixture's, replaced by one
  around this plant. On a fresh scan both packages run Undistorted and
  Masks before Colmap and fail at TriangleMesh (test_geom_pipe_full_on_a_
  fresh_scan_fails_as_jax), so the chains run after a first Colmap.
- The evaluation sections of geom_pipe_virtual, ml_pipe_virtual and
  virtual_cylinder through both packages, after the JAX runtime ran the
  chain they read (on test_geom_pipe_virtual's small virtual-scale plant,
  VIRTUAL_PLANT;
  geom_pipe_virtual's Voxels reads "background" channels, so the scan
  gets an inverted copy of each image; ml_pipe_virtual's scan is
  synth.generate_ml_scan's of that plant, the net replaced by its label
  masks as in the ml_pipe_synth test, the VirtualPlant an OBJ with one
  usemtl block an organ, chip_smoke.write_virtual_plant_obj, and the
  ground-truth masks its gt_masks fileset): equal fileset ids and
  outputs task by task (tests/test_torch_evaluation.py's tolerances).
  The JAX PointCloudGroundTruth always fails (TypeError), so the port's
  runs and both read it; SegmentedPointCloudEvaluation fails in both
  (its ground truth has no labels).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from plant3dvision_tpu.fsdb.testing import TemporaryDB
from plant3dvision_tpu.runtime import RunContext as JaxRunContext
from plant3dvision_tpu.runtime import run_task as jax_run_task
from plant3dvision_tpu.runtime.config import load_toml

from plant3dvision_tpu_torch.runtime import RunContext, TaskRegistry
from plant3dvision_tpu_torch.runtime import run_task

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"

#: per config, the task classes of its sections' chains the port does not
#: have
MISSING = {name: [] for name in (
    "extrinsic_calibration.toml", "fast_geom_pipe_real.toml",
    "geom_pipe_euler_virtual.toml", "geom_pipe_fast.toml",
    "geom_pipe_full.toml", "geom_pipe_real.toml",
    "geom_pipe_real_selfcal.toml", "geom_pipe_synth.toml",
    "geom_pipe_virtual.toml", "intrinsic_calibration.toml",
    "ml_pipe_full.toml", "ml_pipe_real.toml", "ml_pipe_real_hybrid.toml",
    "ml_pipe_synth.toml", "ml_pipe_virtual.toml",
    "test_geom_pipe_real.toml", "test_geom_pipe_virtual.toml",
    "training_seg.toml", "virtual_cylinder.toml")}


def _chain(ctx, name="AnglesAndInternodes"):
    """The task classes of `name` and everything it requires."""
    seen, todo = {}, [ctx.get_task(name)]
    while todo:
        t = todo.pop()
        if type(t).__name__ in seen:
            continue
        seen[type(t).__name__] = t
        req = t.requires()
        req = (list(req.values()) if isinstance(req, dict)
               else list(req) if isinstance(req, (list, tuple)) else [req])
        todo += [r for r in req if r is not None]
    return seen


def test_every_config_chain_is_ported_or_listed():
    """The chain of every task section of every config, resolved by the JAX
    runtime: the classes missing from the port's registry are MISSING's,
    and every CurveSkeleton method is one the port runs (graph, fim,
    mcf)."""
    import plant3dvision_tpu.tasks  # noqa: F401 (registers the tasks)
    import plant3dvision_tpu_torch.tasks  # noqa: F401
    from plant3dvision_tpu.runtime.task import TaskRegistry as JaxRegistry
    found = {}
    with TemporaryDB() as db:
        db.get_scan("s", create=True)
        for path in sorted(CONFIGS.glob("*.toml")):
            cfg = load_toml(path)
            chain = {}
            for section in cfg:
                if section in JaxRegistry._registry:
                    chain.update(_chain(JaxRunContext(db, "s", cfg),
                                        section))
            found[path.name] = sorted(
                n for n in chain if n not in TaskRegistry._registry)
            skel = chain.get("CurveSkeleton")
            if skel is not None:
                assert str(skel.method) in ("graph", "fim", "mcf"), \
                    path.name
    assert found == MISSING


def _angles(scan, report):
    return json.loads(scan.get_fileset(report["AnglesAndInternodes"][
        "fileset"]).get_file("AnglesAndInternodes").read_raw())


def _both(db, cfg, keep=()):
    """The chain through the JAX runtime, then through the port's (on the
    CPU) after deleting the JAX outputs of every task but those in `keep`
    (which the port then reads as they are). Returns both reports and
    angle outputs."""
    out = []
    for pkg in ("jax", "port"):
        ctx = (JaxRunContext(db, "s", cfg) if pkg == "jax"
               else RunContext(db, "s", cfg, device="cpu"))
        rep = (jax_run_task if pkg == "jax" else run_task)(
            ctx, "AnglesAndInternodes", report=False)
        out.append((rep, _angles(ctx.scan, rep)))
        if pkg == "jax":
            for t, r in rep.items():
                if r["status"] == "done" and t not in keep:
                    ctx.scan.delete_fileset(r["fileset"])
    return out


def _assert_same(jax_out, port_out, min_angles, atol=0.05, keep=()):
    (jrep, jang), (rep, ang) = jax_out, port_out
    for t, r in jrep.items():
        assert rep[t]["fileset"] == r["fileset"], t
        assert rep[t]["status"] == ("skipped" if t in keep
                                    else r["status"]), t
    assert len(ang["angles"]) == len(jang["angles"]) >= min_angles
    np.testing.assert_allclose(ang["angles"], jang["angles"], rtol=0,
                               atol=atol)


def test_geom_pipe_synth_through_both_packages(temp_db):
    """Angles within 0.1 deg: the graph skeleton bins the point cloud by
    geodesic level, and the two packages' points (1e-5 apart, gradient
    rounding) put a few points in other bins (nodes 0.06 mm apart on this
    scan), which CPD carries into the refined skeleton (0.3 mm)."""
    from plant3dvision_tpu.synth import SyntheticPlant, generate_scan
    cfg = load_toml(CONFIGS / "geom_pipe_synth.toml")
    generate_scan(temp_db, "s", n_views=24, width=320, height=320, f=340.0,
                  plant=SyntheticPlant(n_fruits=12, stem_radius=2.5,
                                       fruit_radius=1.8, fruit_length=30.0,
                                       internode=6.0))
    _assert_same(*_both(temp_db, cfg), min_angles=5, atol=0.1)


def test_test_geom_pipe_virtual_through_both_packages(temp_db):
    """The config's 0.1-unit voxels, 0.6-unit bins and 0.7-unit fruits are
    a virtual plant's scale: the synthetic plant at a tenth of the
    north-star's size."""
    from plant3dvision_tpu.synth import SyntheticPlant, generate_scan
    cfg = load_toml(CONFIGS / "test_geom_pipe_virtual.toml")
    plant = SyntheticPlant(n_fruits=8, internode=0.6, stem_radius=0.2,
                           fruit_radius=0.15, fruit_length=3.0,
                           first_node=2.0, stem_height=10.5)
    generate_scan(temp_db, "s", n_views=18, width=256, height=256, f=272.0,
                  plant=plant, workspace_margin=1.5, render_step=0.025)
    _assert_same(*_both(temp_db, cfg), min_angles=3)


def test_ml_pipe_synth_through_both_packages(temp_db, monkeypatch):
    """synth.generate_ml_scan's colour-coded scan (the config's input), the
    net's probabilities replaced by the scan's own label masks."""
    import plant3dvision_tpu.models.unet as jax_unet
    from plant3dvision_tpu.fsdb import io as jio
    from plant3dvision_tpu.synth import SyntheticPlant, generate_ml_scan
    from plant3dvision_tpu_torch.models import unet
    from tests.test_torch_seg import ML_LABELS, _save_tiny_resunet

    cfg = load_toml(CONFIGS / "ml_pipe_synth.toml")
    cfg["ModelFilesetExists"] = {"scan_id": "models"}
    generate_ml_scan(temp_db, "s", n_views=12, width=256, height=256,
                     f=300.0, plant=SyntheticPlant(
                         n_fruits=8, stem_radius=2.5, fruit_radius=1.8,
                         fruit_length=30.0, internode=6.0))
    _save_tiny_resunet(temp_db)
    gt = temp_db.get_scan("s").get_fileset("gt_masks")

    def mask(v, label):
        f = gt.get_file(f"{v:05d}_{label}")
        return (jio.read_image(f) if f is not None
                else np.zeros((256, 256), np.uint8))
    probs = np.stack([np.stack([mask(v, label) for label in ML_LABELS])
                      for v in range(12)]).astype(np.uint8)
    monkeypatch.setattr(jax_unet, "segmentation_inference",
                        lambda model, params, batch, **kw: probs)
    monkeypatch.setattr(unet, "segmentation_inference",
                        lambda model, batch, device=None, **kw:
                        torch.from_numpy(probs).to(device))
    _assert_same(*_both(temp_db, cfg), min_angles=3)


def test_geom_pipe_euler_virtual_through_both_packages():
    """The port's chain reads the JAX package's TurntableCalibration (the
    same fileset id; the task itself is held to JAX in
    tests/test_torch_calibration_task.py and test_torch_calibration_ba.py),
    so both carve from the same cameras."""
    import chip_smoke
    from plant3dvision_tpu_torch.synth import SyntheticPlant
    box = {"x": [-26, 26], "y": [-26, 26], "z": [-6, 178]}
    cfg = load_toml(CONFIGS / "geom_pipe_euler_virtual.toml")
    cfg["TurntableCalibration"].update(
        f_init=1400.0 * 320 / 1440, min_matches=50, cem_pop=8, cem_iters=2,
        polish_rounds=1, bounding_box=box)
    cfg["Voxels"]["bounding_box"] = box
    keep = ("TurntableCalibration",)
    with TemporaryDB() as db:
        chip_smoke.write_turntable_scan(
            db, "s", SyntheticPlant(**chip_smoke.NORTHSTAR_PLANT), 16, 320,
            240, dist=300.0, texture_mm=3.0, density=8.0)
        _assert_same(*_both(db, cfg, keep), min_angles=0, keep=keep)


def _rig_scan(db, scan_id, tmp_path, camera_model="OPENCV"):
    """chip_smoke's rig scan (north-star plant, phase 9's ring and lens)
    at 16 views of 320x240, and the stand-in colmap recovering its true
    cameras (COLMAP_EXE, COLMAP_WD set; the caller's monkeypatch restores
    them). Returns the plant."""
    import chip_smoke
    from plant3dvision_tpu_torch.synth import SyntheticPlant
    V, W, H = 16, 320, 240
    F = chip_smoke.FULL_F * W / chip_smoke.FULL_W
    plant = SyntheticPlant(**chip_smoke.NORTHSTAR_PLANT)
    chip_smoke.write_distorted_scan(db, scan_id, plant, V, W, H, F, rig=True)
    camera, images, pts = chip_smoke.full_scan_model(plant, V, W, H, F)
    if camera_model == "OPENCV":
        f, cx, cy, k1 = camera["params"]
        camera = dict(camera, model="OPENCV",
                      params=[f, f, cx, cy, k1, 0.0, 0.0, 0.0])
    return plant, chip_smoke.write_standin_colmap(tmp_path / "bin", camera,
                                                  images, pts)


@pytest.fixture()
def standin_env(monkeypatch, tmp_path):
    monkeypatch.setenv("COLMAP_WD", str(tmp_path / "wd"))
    return monkeypatch


def test_geom_pipe_full_on_a_fresh_scan_fails_as_jax(tmp_path, standin_env):
    """On a fresh scan the runtimes resolve Voxels' masks before its
    cameras: Undistorted copies every image as it is (no camera yet) and
    Masks' files carry none, so Voxels carves an empty volume and
    TriangleMesh fails, in the JAX package and the port alike."""
    import chip_smoke
    from plant3dvision_tpu.runtime.runner import TaskFailure as JaxFailure
    from plant3dvision_tpu_torch.runtime.runner import TaskFailure

    cfg = chip_smoke.full_config()
    out = []
    with TemporaryDB() as db:
        for pkg in ("jax", "port"):
            _, exe = _rig_scan(db, pkg, tmp_path / pkg)
            standin_env.setenv("COLMAP_EXE", str(exe))
            ctx = (JaxRunContext(db, pkg, cfg) if pkg == "jax"
                   else RunContext(db, pkg, cfg, device="cpu"))
            with pytest.raises((JaxFailure, TaskFailure)) as info:
                (jax_run_task if pkg == "jax" else run_task)(
                    ctx, "AnglesAndInternodes", report=False)
            und = ctx.get_task("Undistorted").output().fileset_id
            masks = ctx.get_task("Masks").output().fileset_id
            out.append((str(info.value), repr(info.value.__cause__), und,
                        masks, chip_smoke.undistorted_count(ctx.scan, und),
                        sum(bool(f.get_metadata("colmap_camera")) for f in
                            ctx.scan.get_fileset(masks).get_files()),
                        all(f.get_metadata("colmap_camera") for f in
                            ctx.scan.get_fileset("images").get_files())))
    assert out[1] == out[0]
    assert out[1][0] == "Task TriangleMesh failed after 1 attempt(s)"
    assert out[1][4:] == (0, 0, True)


def _chain_after_colmap(db, cfg, tmp_path, standin_env):
    """The stand-in's scan, Colmap once (the JAX package's), then the chain
    through both packages (_both, which deletes the JAX outputs between
    them)."""
    plant, exe = _rig_scan(db, "s", tmp_path)
    standin_env.setenv("COLMAP_EXE", str(exe))
    jax_run_task(JaxRunContext(db, "s", cfg), "Colmap", report=False)
    return _both(db, cfg)


def test_geom_pipe_full_through_both_packages(tmp_path, standin_env):
    """geom_pipe_full.toml's chain (chip_smoke.full_config: Colmap ->
    Undistorted -> Masks -> Voxels -> PointCloud -> TriangleMesh ->
    CurveSkeleton over the mesh -> RefineSkeleton -> TreeGraph ->
    AnglesAndInternodes) after a first Colmap, with RefineSkeleton's
    tolerance -1: CPD runs its 100 iterations in both packages. At the
    shipped 1e-4 its stop test reads float32 rounding (ROADMAP, Queue C)
    and on this scan the two stop apart, even from equal inputs: refined
    skeletons 0.11-0.28 mm apart and angles up to 139 deg (the same count,
    a fruit in another order); run to the cap they agree within 3e-4 mm."""
    import chip_smoke
    cfg = chip_smoke.full_config()
    cfg["RefineSkeleton"]["tolerance"] = -1.0
    with TemporaryDB() as db:
        _assert_same(*_chain_after_colmap(db, cfg, tmp_path, standin_env),
                     min_angles=10)


def test_test_geom_pipe_real_through_both_packages(tmp_path, standin_env):
    """test_geom_pipe_real.toml's chain (Colmap at distance_threshold 6,
    Undistorted of the "correct" views, 0.5 mm, the graph skeleton on the
    point cloud, no RefineSkeleton) after a first Colmap, its box around
    this plant. Its real-plant settings (3-pixel mask dilation on 1.45 mm
    pixels) give 3 angles on this scan."""
    cfg = load_toml(CONFIGS / "test_geom_pipe_real.toml")
    cfg.pop("AnglesAndInternodesEvaluation")
    cfg["Voxels"]["bounding_box"] = {"x": [-30, 30], "y": [-30, 30],
                                     "z": [-10, 180]}
    with TemporaryDB() as db:
        _assert_same(*_chain_after_colmap(db, cfg, tmp_path, standin_env),
                     min_angles=3)


def test_simple_radial_camera_read_by_its_model():
    """The carve's camera of a SIMPLE_RADIAL colmap_camera [f, cx, cy, k1]
    (what Colmap writes with its default camera_model) is the OPENCV
    [f, f, cx, cy, k1, 0, 0, 0] camera's in the port; the JAX package packs
    the first four parameters, [f, cx, cy, k1], as fx, fy, cx, cy."""
    from plant3dvision_tpu.ops.carving import (
        camera_from_metadata as jax_camera)
    from plant3dvision_tpu_torch.camera import pose_to_extrinsics
    from plant3dvision_tpu_torch.ops.carving import camera_from_metadata

    R, t = pose_to_extrinsics([450.0, 0.0, 120.0], (0, 0, 70.0))
    md = {"rotmat": R.tolist(), "tvec": t.tolist()}
    simple = dict(md, camera_model={"model": "SIMPLE_RADIAL", "params": [
        1400.0, 720.0, 540.0, -0.08]})
    opencv = dict(md, camera_model={"model": "OPENCV", "params": [
        1400.0, 1400.0, 720.0, 540.0, -0.08, 0.0, 0.0, 0.0]})
    np.testing.assert_array_equal(camera_from_metadata(simple),
                                  camera_from_metadata(opencv))
    np.testing.assert_array_equal(camera_from_metadata(opencv),
                                  jax_camera(opencv))
    np.testing.assert_array_equal(
        jax_camera(simple)[:4],
        np.array([1400.0, 720.0, 540.0, -0.08], np.float32))


# -- the evaluation sections -------------------------------------------------

#: test_geom_pipe_virtual's plant, at the virtual_plant fixture's scale,
#: its fruits 4 units long (geom_pipe_virtual's min_fruit_size 2.5 drops
#: every carved 3-unit fruit of this scan)
VIRTUAL_PLANT = dict(n_fruits=8, internode=0.6, stem_radius=0.2,
                     fruit_radius=0.15, fruit_length=4.0, first_node=2.0,
                     stem_height=10.5)


def _outputs(scan, fs_id):
    """{file id: (metadata, payload)} of a fileset: JSON decoded, images
    decoded, other files' bytes."""
    from plant3dvision_tpu.fsdb import io as jio
    out = {}
    for f in scan.get_fileset(fs_id).get_files():
        ext = (f.filename or "").rsplit(".", 1)[-1]
        if ext == "json":
            data = json.loads(f.read_raw())
        elif ext in ("png", "jpg") and not f.id.endswith("_figure"):
            data = jio.read_image(f)
        elif f.id.endswith("_figure") or ext == "zip":
            data = f.path().stat().st_size > 0
        else:
            data = f.read_raw() if f.filename else None
        out[f.id] = (f.get_metadata(), data)
    return out


def _evaluate_both(db, cfg, tasks, port_only=(), both_fail=()):
    """Each of `tasks` in turn through the JAX runtime, then (its output
    deleted) through the port's on the CPU, both reading what is in the DB:
    equal fileset ids and outputs. A task of `port_only` fails in the JAX
    package (pinned) and runs in the port alone; a task of `both_fail`
    fails in both with the same cause. Returns {task: port outputs}."""
    from plant3dvision_tpu.runtime.runner import TaskFailure as JaxFailure
    from plant3dvision_tpu_torch.runtime.runner import TaskFailure
    from tests.test_torch_evaluation import assert_same
    out = {}
    for task in tasks:
        jctx = JaxRunContext(db, "s", cfg)
        ctx = RunContext(db, "s", cfg, device="cpu")
        fs_id = jctx.get_task(task).output().fileset_id
        assert ctx.get_task(task).output().fileset_id == fs_id, task
        if task in port_only or task in both_fail:
            with pytest.raises(JaxFailure) as info:
                jax_run_task(jctx, task, report=False)
            cause = repr(info.value.__cause__)
            if task in both_fail:
                with pytest.raises(TaskFailure) as pinfo:
                    run_task(ctx, task, report=False)
                assert repr(pinfo.value.__cause__) == cause, task
                continue
            assert cause == ("TypeError(\"'FilesetTarget' object is not "
                             "subscriptable\")"), task
            run_task(ctx, task, report=False)
            out[task] = _outputs(ctx.scan, fs_id)
            continue
        assert jax_run_task(jctx, task, report=False)[task]["status"] \
            == "done", task
        want = _outputs(jctx.scan, fs_id)
        jctx.scan.delete_fileset(fs_id)
        assert run_task(ctx, task, report=False)[task]["status"] == "done"
        got = _outputs(ctx.scan, fs_id)
        assert list(got) == list(want), task
        for fid, (md, data) in want.items():
            assert_same(got[fid][0], md)
            if isinstance(data, np.ndarray):
                np.testing.assert_array_equal(got[fid][1], data)
            elif isinstance(data, (dict, list)):
                assert_same(got[fid][1], data)
            else:
                assert got[fid][1] == data, (task, fid)
        out[task] = got
    return out


def _result(outputs, task):
    return outputs[task][task][1]


def _fs_of(db, cfg, task):
    return RunContext(db, "s", cfg, device="cpu").get_task(task) \
        .output().fileset_id


def test_geom_pipe_virtual_evaluation_through_both_packages(temp_db):
    """geom_pipe_virtual.toml: its chain (the JAX runtime), then its
    evaluation sections: PointCloudGroundTruth (the port's), the point
    cloud's evaluation, the angles' DTW against the VirtualPlant metadata
    and Visualization."""
    from plant3dvision_tpu.fsdb import io as jio
    from plant3dvision_tpu.synth import SyntheticPlant, generate_scan
    cfg = load_toml(CONFIGS / "geom_pipe_virtual.toml")
    generate_scan(temp_db, "s", n_views=18, width=256, height=256, f=272.0,
                  plant=SyntheticPlant(**VIRTUAL_PLANT),
                  workspace_margin=1.5, render_step=0.025)
    images = temp_db.get_scan("s").get_fileset("images")
    for f in list(images.get_files()):
        b = images.create_file(f.id.replace("_rgb", "_background"))
        jio.write_image(b, 255 - jio.read_image(f), "png")
        b.set_metadata(dict(f.get_metadata(), channel="background"))
    jax_run_task(JaxRunContext(temp_db, "s", cfg), "AnglesAndInternodes",
                 report=False)
    out = _evaluate_both(
        temp_db, cfg, ["PointCloudGroundTruth", "PointCloudEvaluation",
                       "AnglesAndInternodesEvaluation", "Visualization"],
        port_only=("PointCloudGroundTruth",))
    assert 0 < _result(out, "PointCloudEvaluation")["fitness"] <= 1
    dtw = _result(out, "AnglesAndInternodesEvaluation")
    assert dtw["mean_angle_error"] < 10.0 and len(dtw["pairs"]) >= 3
    vis = out["Visualization"]
    assert sum(k.startswith("thumbnail_") for k in vis) == 18
    assert "PointCloud" in vis and "AnglesAndInternodes" in vis


def test_ml_pipe_virtual_evaluation_through_both_packages(temp_db,
                                                          monkeypatch):
    """ml_pipe_virtual.toml's chain (the JAX runtime; the net's
    probabilities the scan's label masks), then its seven evaluation
    sections, Segmentation2DEvaluation also at dilation 2 (the port's
    dilation of each label's stack in one call)."""
    import chip_smoke
    import plant3dvision_tpu.models.unet as jax_unet
    from plant3dvision_tpu.fsdb import io as jio
    from plant3dvision_tpu.synth import SyntheticPlant, generate_ml_scan
    from tests.test_torch_seg import ML_LABELS, _save_tiny_resunet

    cfg = load_toml(CONFIGS / "ml_pipe_virtual.toml")
    cfg["Segmentation2DGroundTruthFilesetExists"] = {"fileset_id": "gt_masks"}
    plant = SyntheticPlant(**VIRTUAL_PLANT)
    generate_ml_scan(temp_db, "s", n_views=12, width=192, height=192,
                     f=204.0, plant=plant, workspace_margin=1.5)
    _save_tiny_resunet(temp_db)
    scan = temp_db.get_scan("s")
    gt = scan.get_fileset("gt_masks")

    def mask(v, label):
        f = gt.get_file(f"{v:05d}_{label}")
        return (jio.read_image(f) if f is not None
                else np.zeros((192, 192), np.uint8))
    probs = np.stack([np.stack([mask(v, label) for label in ML_LABELS])
                      for v in range(12)]).astype(np.uint8)
    monkeypatch.setattr(jax_unet, "segmentation_inference",
                        lambda model, params, batch, **kw: probs)
    chip_smoke.write_virtual_plant_obj(
        scan, chip_smoke.virtual_plant_organs(plant))
    jax_run_task(JaxRunContext(temp_db, "s", cfg), "AnglesAndInternodes",
                 report=False)
    tasks = ["PointCloudGroundTruth", "PointCloudEvaluation",
             "VoxelsGroundTruth", "VoxelsEvaluation",
             "Segmentation2DEvaluation", "SegmentedPointCloudEvaluation",
             "AnglesAndInternodesEvaluation"]
    out = _evaluate_both(temp_db, cfg, tasks,
                         port_only=("PointCloudGroundTruth",),
                         both_fail=("SegmentedPointCloudEvaluation",))
    seg = _result(out, "Segmentation2DEvaluation")["label-results"]
    assert list(seg) == ["flower", "fruit", "leaf", "pedicel", "stem"]
    assert seg["fruit"]["tp"] > 0 and seg["stem"]["tp"] > 0
    # PointCloudGroundTruth samples the OBJ as it is, in the L-system axes
    # that VoxelsGroundTruth undoes: PointCloudEvaluation compares clouds
    # in different axes (a fault of both packages, ROADMAP Queue C); the
    # same ground truth in the scanner's axes fits
    from plant3dvision_tpu_torch.metrics import (
        point_cloud_registration_fitness)
    pce = _result(out, "PointCloudEvaluation")
    assert pce["fitness"] < 0.2 and pce["chamfer"] > 10.0
    from plant3dvision_tpu_torch.fsdb import io
    pcd = scan.get_fileset(_fs_of(temp_db, cfg, "PointCloud")).get_files()[0]
    gtf = scan.get_fileset(_fs_of(temp_db, cfg, "PointCloudGroundTruth")) \
        .get_files()[0]
    g = io.read_point_cloud(gtf).points[:, [0, 2, 1]] * [1, -1, 1]
    assert point_cloud_registration_fitness(
        g, io.read_point_cloud(pcd).points, 2.0)[0] > 0.9
    vox = _result(out, "VoxelsEvaluation")
    assert set(vox) == {"stem", "pedicel", "fruit"}
    assert vox["fruit"]["tp"] > 0
    cfg["Segmentation2DEvaluation"]["dilation_amount"] = 2
    dil = _result(_evaluate_both(temp_db, cfg, ["Segmentation2DEvaluation"]),
                  "Segmentation2DEvaluation")["label-results"]
    # the predictions are the ground truth's own masks: a dilated ground
    # truth keeps every true positive and adds false negatives
    for label in seg:
        assert dil[label]["tp"] == seg[label]["tp"]
        assert dil[label]["fp"] == seg[label]["fp"] == 0
    assert dil["stem"]["fn"] > seg["stem"]["fn"] == 0


def test_virtual_cylinder_through_both_packages(temp_db):
    """virtual_cylinder.toml on a bare scan: its random radius and height
    from the task's seed, the estimate within 0.1 of the radius."""
    temp_db.get_scan("s", create=True)
    cfg = load_toml(CONFIGS / "virtual_cylinder.toml")
    out = _evaluate_both(temp_db, cfg, ["CylinderRadiusGroundTruth",
                                        "CylinderRadiusEstimation"])
    res = _result(out, "CylinderRadiusEstimation")
    assert abs(res["calculated_radius"] - res["gt_radius"]) < 0.1
