"""Which shipped configs the port runs, and the fully ported chains through
both packages on the CPU.

- Every configs/*.toml with an AnglesAndInternodes section: the task
  classes of its chain (AnglesAndInternodes and everything it requires, as
  the JAX runtime resolves them) that the port's registry lacks must be
  exactly the ones listed in MISSING (none now), so a task that goes
  missing from the port shows here.
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

#: per config, the task classes of its angle chain the port does not have
MISSING = {name: [] for name in (
    "fast_geom_pipe_real.toml", "geom_pipe_euler_virtual.toml",
    "geom_pipe_fast.toml", "geom_pipe_full.toml", "geom_pipe_real.toml",
    "geom_pipe_real_selfcal.toml", "geom_pipe_synth.toml",
    "geom_pipe_virtual.toml", "ml_pipe_full.toml", "ml_pipe_real.toml",
    "ml_pipe_real_hybrid.toml", "ml_pipe_synth.toml", "ml_pipe_virtual.toml",
    "test_geom_pipe_real.toml", "test_geom_pipe_virtual.toml")}


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
    """The angle chain of every config, resolved by the JAX runtime: the
    classes missing from the port's registry are MISSING's, and every
    chain's CurveSkeleton method is one the port runs (graph, fim, mcf)."""
    import plant3dvision_tpu_torch.tasks  # noqa: F401 (registers the tasks)
    found = {}
    with TemporaryDB() as db:
        db.get_scan("s", create=True)
        for path in sorted(CONFIGS.glob("*.toml")):
            cfg = load_toml(path)
            if "AnglesAndInternodes" not in cfg:
                continue
            chain = _chain(JaxRunContext(db, "s", cfg))
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
