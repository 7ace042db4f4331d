"""Colmap (colmap/, tasks/colmap.py), the ChArUco calibration
(calibration.py, tasks/calibration.py) and their helpers in the port,
held to the JAX package on the CPU.

COLMAP itself is an external binary: both packages run the same stand-in
(chip_smoke.write_standin_colmap, which writes its model through the
port's colmap/read_model.py) as COLMAP_EXE, so every difference is the
two packages' own. The ChArUco cases need cv2 with its aruco module
(importorskip); the figures need matplotlib.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)


# -- model I/O -------------------------------------------------------------

def _model(rm):
    """One small model (cameras, images, points) of `rm`'s classes."""
    q = rm.rotmat2qvec(rm.qvec2rotmat(
        np.array([0.9, 0.1, -0.2, 0.4]) / np.linalg.norm([0.9, 0.1, -0.2,
                                                         0.4])))
    cameras = {1: rm.Camera(1, "OPENCV", 640, 480,
                            np.array([500.0, 510.0, 320.0, 240.0, -0.1, 0.01,
                                      0.001, -0.002])),
               2: rm.Camera(2, "SIMPLE_RADIAL", 960, 540,
                            np.array([398.25, 480.0, 270.0, -0.017]))}
    images = {
        3: rm.Image(3, q, np.array([-0.5, 1.25, 7.0]), 1, "00003_rgb.jpg",
                    np.array([[1.5, 2.25], [3.0, 4.125]]),
                    np.array([7, -1], dtype=np.int64)),
        4: rm.Image(4, q, np.zeros(3), 2, "00004_rgb.jpg", np.zeros((0, 2)),
                    np.zeros(0, np.int64)),
    }
    points = {7: rm.Point3D(7, np.array([1.0, -2.5, 3.75]),
                            np.array([10, 20, 30], dtype=np.uint8), 0.5,
                            np.array([3, 4], dtype=np.int32),
                            np.array([0, 1], dtype=np.int32))}
    return cameras, images, points


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_model_round_trip_byte_equal(tmp_path, ext):
    """The port's writers give the JAX package's bytes, binary and text;
    each package reads the other's files to the same model."""
    import plant3dvision_tpu.colmap.read_model as jrm
    from plant3dvision_tpu_torch.colmap import read_model as rm

    kind = "binary" if ext == ".bin" else "text"
    for pkg, mod in (("jax", jrm), ("port", rm)):
        d = tmp_path / pkg
        d.mkdir()
        cams, ims, pts = _model(mod)
        getattr(mod, f"write_cameras_{kind}")(cams, d / f"cameras{ext}")
        getattr(mod, f"write_images_{kind}")(ims, d / f"images{ext}")
        getattr(mod, f"write_points3d_{kind}")(pts, d / f"points3D{ext}")
    for name in ("cameras", "images", "points3D"):
        assert (tmp_path / "jax" / f"{name}{ext}").read_bytes() == \
            (tmp_path / "port" / f"{name}{ext}").read_bytes(), name
    for reader, src in ((rm, "jax"), (jrm, "port")):
        c, i, p = reader.read_model(tmp_path / src)
        assert c[2].model == "SIMPLE_RADIAL"
        np.testing.assert_array_equal(c[1].params, _model(rm)[0][1].params)
        assert i[3].name == "00003_rgb.jpg" and i[4].xys.shape == (0, 2)
        np.testing.assert_array_equal(i[3].point3D_ids, [7, -1])
        np.testing.assert_array_equal(p[7].image_ids, [3, 4])
    jc, ji, jp = jrm.read_model(tmp_path / "jax")
    pc, pi, pp = rm.read_model(tmp_path / "jax")
    assert rm.cameras_to_dict(pc) == jrm.cameras_to_dict(jc)
    assert rm.images_to_dict(pi) == jrm.images_to_dict(ji)
    assert rm.points_to_dict(pp) == jrm.points_to_dict(jp)


def test_quaternions_and_dense_arrays_equal_jax(tmp_path, rng):
    """rotmat2qvec / qvec2rotmat on random rotations, and the dense-map
    codec (read_array / write_array) byte for byte."""
    import plant3dvision_tpu.colmap.read_model as jrm
    from plant3dvision_tpu_torch.colmap import read_model as rm
    from scipy.spatial.transform import Rotation

    for R in Rotation.random(20, random_state=3).as_matrix():
        q = rm.rotmat2qvec(R)
        np.testing.assert_array_equal(q, jrm.rotmat2qvec(R))
        np.testing.assert_array_equal(rm.qvec2rotmat(q), jrm.qvec2rotmat(q))
    for shape in ((3, 5), (4, 6, 3)):
        arr = rng.normal(size=shape).astype(np.float32)
        rm.write_array(arr, tmp_path / "port.bin")
        jrm.write_array(arr, tmp_path / "jax.bin")
        assert (tmp_path / "port.bin").read_bytes() == \
            (tmp_path / "jax.bin").read_bytes()
        np.testing.assert_array_equal(rm.read_array(tmp_path / "jax.bin"),
                                      arr)


@pytest.mark.parametrize("text", [
    "COLMAP 3.8 -- Structure-from-Motion", "COLMAP 3.11.1-dev", "COLMAP 4",
    "COLMAP 3.6 (Commit abc)", "garbage", "", "COLMAP x.y"])
def test_parse_colmap_version_equals_jax(text):
    from plant3dvision_tpu.colmap.runner import parse_colmap_version as jax
    from plant3dvision_tpu_torch.colmap.runner import parse_colmap_version
    assert parse_colmap_version(text) == jax(text)


# -- the runner and the task, with the stand-in colmap ---------------------

def _ring_scan(db, scan_id, n, radius=40.0, bad=()):
    """A scan of `n` fake JPEG images on a ring of CNC poses
    ([x, y, z, pan, tilt] as `approximate_pose`), the views in `bad` logged
    100 mm off."""
    scan = db.create_scan(scan_id)
    images = scan.create_fileset("images")
    for v in range(n):
        f = images.create_file(f"{v:05d}_rgb")
        f.write_raw(b"\xff\xd8fake", "jpg")
        a = 2 * np.pi * v / n
        pose = [radius * np.cos(a) + (100.0 if v in bad else 0.0),
                radius * np.sin(a), 10.0, np.degrees(a), 0]
        f.set_metadata({"channel": "rgb", "approximate_pose": pose})
    return scan


def _standin(env, directory, n, radius=40.0, **kw):
    """The stand-in colmap recovering `n` cameras on the true ring around
    the origin (a SIMPLE_RADIAL 64x64 camera, 50 seeded points); COLMAP_EXE
    names it for the test (`env`, its monkeypatch)."""
    from plant3dvision_tpu_torch.camera import pose_to_extrinsics
    images = {}
    for v in range(n):
        a = 2 * np.pi * v / n
        images[f"{v:05d}_rgb.jpg"] = pose_to_extrinsics(
            [radius * np.cos(a), radius * np.sin(a), 10.0], (0, 0, 0))
    pts = np.random.default_rng(0).uniform(-10, 10, (50, 3))
    exe = chip_smoke.write_standin_colmap(
        directory, {"model": "SIMPLE_RADIAL", "width": 64, "height": 64,
                    "params": [80.0, 32.0, 32.0, 0.0]}, images, pts, **kw)
    env.setenv("COLMAP_EXE", str(exe))
    return exe


@pytest.mark.parametrize("version", ["3.8", "3.9", "3.10"])
def test_runner_aligner_argument_and_version(temp_db, tmp_path, monkeypatch,
                                             version):
    """Both runners read the stand-in's version and spell the aligner's
    threshold for it (COLMAP <= 3.9: robust_alignment_max_error; the
    stand-in refuses the other spelling); their outputs are equal."""
    from plant3dvision_tpu.colmap.runner import ColmapRunner as JaxRunner
    from plant3dvision_tpu_torch.colmap.runner import ColmapRunner

    _ring_scan(temp_db, "s", 4)
    _standin(monkeypatch, tmp_path / "bin", 4, version=version)
    files = temp_db.get_scan("s").get_fileset("images").get_files()
    out = []
    for pkg, cls in (("jax", JaxRunner), ("port", ColmapRunner)):
        runner = cls(files, workdir=tmp_path / f"wd_{pkg}")
        res = runner.run()
        assert runner.version == tuple(int(x) for x in version.split("."))
        out.append(res)
    (jp, ji, jc, js, jd, jb), (pp, pi, pc, ps, pd, pb) = out
    assert (pp, pi, pc, pd, pb) == (jp, ji, jc, jd, jb)
    np.testing.assert_array_equal(ps, js)


def test_runner_rejects_old_colmap(tmp_path, monkeypatch):
    from plant3dvision_tpu_torch.colmap.runner import (ColmapError,
                                                      ColmapRunner)
    _standin(monkeypatch, tmp_path / "bin", 2, version="3.5")
    runner = ColmapRunner([], workdir=tmp_path / "wd")
    with pytest.raises(ColmapError, match="3.6 is required"):
        runner.validate_exe()


def test_runner_picks_the_largest_reconstruction(temp_db, tmp_path,
                                                 monkeypatch):
    """With a second, two-image model beside the mapper's first, both
    runners keep sparse/0 (the larger images.bin) and equal outputs, and
    capture the analyzer's stats."""
    from plant3dvision_tpu.colmap.runner import ColmapRunner as JaxRunner
    from plant3dvision_tpu_torch.colmap.runner import ColmapRunner

    _ring_scan(temp_db, "s", 6)
    _standin(monkeypatch, tmp_path / "bin", 6, extra_model=True)
    files = temp_db.get_scan("s").get_fileset("images").get_files()
    out = []
    for pkg, cls in (("jax", JaxRunner), ("port", ColmapRunner)):
        runner = cls(files, workdir=tmp_path / f"wd_{pkg}")
        res = runner.run()
        assert runner.model_dir.name == "0"
        assert len(res[1]) == 6
        assert "Points: 50" in runner.analyzer_stats
        out.append((res[0], res[1], res[2], res[5]))
    assert out[0] == out[1]


def _colmap_both(db, scan_id, cfg, tmp_path, env, retry_count=None):
    """The Colmap task through the JAX runtime, then the port's (CPU):
    per package its report (or the TaskFailure), fileset id, JSON files,
    sparse points, fileset metadata and every image's colmap_camera,
    pose_estimation and calibrated_pose. Each run's fileset is deleted
    after it is read."""
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.runtime import run_task as jax_run_task
    from plant3dvision_tpu.runtime.runner import TaskFailure as JaxFailure
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.runtime.runner import TaskFailure

    out = []
    for pkg in ("jax", "port"):
        env.setenv("COLMAP_WD", str(tmp_path / f"wd_{pkg}"))
        ctx = (JaxRunContext(db, scan_id, cfg) if pkg == "jax"
               else RunContext(db, scan_id, cfg, device="cpu"))
        if retry_count is not None:
            ctx.get_task("Colmap").retry_count = retry_count
        try:
            rep = (jax_run_task if pkg == "jax" else run_task)(
                ctx, "Colmap", report=False)
            status = rep["Colmap"]["status"]
        except (JaxFailure, TaskFailure) as e:
            status = f"failed: {e.__cause__}"
        fs_id = ctx.get_task("Colmap").output().fileset_id
        fs = ctx.scan.get_fileset(fs_id)
        files = ({f.id: json.loads(f.read_raw()) for f in fs.get_files()
                  if f.id != "sparse"} if fs is not None else {})
        sparse = (io.read_point_cloud(fs.get_file("sparse")).points
                  if fs is not None and fs.get_file("sparse") else None)
        meta = fs.get_metadata("bounding_box") if fs is not None else None
        images = {f.id: (f.get_metadata("colmap_camera"),
                         f.get_metadata("pose_estimation"),
                         f.get_metadata("calibrated_pose"))
                  for f in ctx.scan.get_fileset("images").get_files()}
        out.append((status, fs_id, files, sparse, meta, images))
        if fs is not None:
            ctx.scan.delete_fileset(fs_id)
    return out


def _assert_same(jax_out, port_out):
    for j, p in zip(jax_out[:3], port_out[:3]):
        assert p == j
    np.testing.assert_array_equal(port_out[3], jax_out[3])
    assert port_out[4:] == jax_out[4:]


def test_colmap_task_equals_jax(temp_db, tmp_path, monkeypatch):
    """The task's JSON outputs (points3d, images, cameras,
    euclidean_distances), sparse cloud, bounding box and every image's
    colmap_camera and pose_estimation equal the JAX package's; every view
    within 5 mm of its CNC pose is "correct"."""
    _ring_scan(temp_db, "s", 12)
    _standin(monkeypatch, tmp_path / "bin", 12)
    cfg = {"Colmap": {"distance_threshold": 5.0, "align_pcd": True}}
    jax_out, port_out = _colmap_both(temp_db, "s", cfg, tmp_path, monkeypatch)
    _assert_same(jax_out, port_out)
    status, _, files, _, bbox, images = port_out
    assert status == "done" and bbox is not None
    assert set(files) == {"points3d", "images", "cameras",
                          "euclidean_distances"}
    assert files["cameras"]["1"]["model"] == "SIMPLE_RADIAL"
    assert files["euclidean_distances"]["mean"] < 1e-6
    assert all(pe == "correct" for _, pe, _ in images.values())


def test_colmap_blind_angle_raises_as_jax(temp_db, tmp_path, monkeypatch):
    """Three consecutive views logged 100 mm off (a 90 degree arc): both
    packages flag the same three "incorrect" and fail on the blind angle
    (RetryableTaskError, retried retry_count times)."""
    from plant3dvision_tpu.tasks.colmap import Colmap as JaxColmap
    from plant3dvision_tpu_torch.runtime.task import RetryableTaskError
    from plant3dvision_tpu_torch.tasks.colmap import Colmap, check_blind_angle

    assert Colmap.retry_count == JaxColmap.retry_count == 10
    _ring_scan(temp_db, "s", 12, bad=(0, 1, 2))
    _standin(monkeypatch, tmp_path / "bin", 12)
    cfg = {"Colmap": {"distance_threshold": 5.0, "max_blind_angle": 20.0}}
    jax_out, port_out = _colmap_both(temp_db, "s", cfg, tmp_path,
                                     monkeypatch, retry_count=1)
    _assert_same(jax_out, port_out)
    assert port_out[0].startswith("failed: Blind angle 90.0 deg")
    flags = [pe for _, pe, _ in port_out[5].values()]
    assert flags.count("incorrect") == 3
    with pytest.raises(RetryableTaskError):
        check_blind_angle([True] * 10 + [False] * 2, 59.0, "bad poses")
    check_blind_angle([True] * 10 + [False] * 2, 60.0, "bad poses")


def _capture_cli_args(monkeypatch):
    """Wrap both packages' ColmapRunner to record the cli_args the task
    passes; returns {"jax": {...}, "port": {...}}."""
    import plant3dvision_tpu.colmap.runner as jax_runner
    import plant3dvision_tpu_torch.colmap.runner as runner

    captured = {}
    for pkg, mod in (("jax", jax_runner), ("port", runner)):
        real = mod.ColmapRunner

        def capturing(*args, _real=real, _pkg=pkg, **kwargs):
            captured[_pkg] = json.loads(json.dumps(
                kwargs.get("all_cli_args") or {}))
            return _real(*args, **kwargs)
        monkeypatch.setattr(mod, "ColmapRunner", capturing)
    return captured


def test_colmap_fixed_intrinsics_equal_jax(temp_db, tmp_path, monkeypatch):
    """intrinsic_calibration_scan_id: the calibration scan's parameters for
    the task's model (camera_params_from_intrinsic_calibration, its errors
    too) and a mapper that refines no intrinsics, as the JAX package."""
    from plant3dvision_tpu.tasks.colmap import (
        camera_params_from_intrinsic_calibration as jax_params)
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.tasks.colmap import (
        camera_params_from_intrinsic_calibration)

    calib = temp_db.create_scan("calib_intr")
    io.write_json(calib.create_fileset("IntrinsicCalibration_x_abc123")
                  .get_file("camera_model", create=True), {
        "SIMPLE_RADIAL": {"model": "SIMPLE_RADIAL",
                          "params": [1400.0, 720.0, 540.0, -0.02]},
        "OPENCV": {"model": "OPENCV", "params": [1400.0, 1401.0, 720.0,
                                                 540.0, -0.02, 0.001, 0.0,
                                                 0.0]}})
    for model in ("SIMPLE_RADIAL", "OPENCV"):
        assert camera_params_from_intrinsic_calibration(
            temp_db, "calib_intr", model) == jax_params(
            temp_db, "calib_intr", model)
    for scan_id, model, match in (("calib_intr", "RADIAL", "no 'RADIAL' fit"),
                                  ("nope", "OPENCV", "not found")):
        with pytest.raises(ValueError, match=match):
            camera_params_from_intrinsic_calibration(temp_db, scan_id, model)

    _ring_scan(temp_db, "s", 6)
    _standin(monkeypatch, tmp_path / "bin", 6)
    captured = _capture_cli_args(monkeypatch)
    cfg = {"Colmap": {"intrinsic_calibration_scan_id": "calib_intr",
                      "camera_model": "SIMPLE_RADIAL", "align_pcd": True}}
    jax_out, port_out = _colmap_both(temp_db, "s", cfg, tmp_path, monkeypatch)
    _assert_same(jax_out, port_out)
    assert port_out[0] == "done"
    assert captured["port"] == captured["jax"]
    assert captured["port"]["feature_extractor"][
        "--ImageReader.camera_params"] == "1400.0,720.0,540.0,-0.02"
    assert captured["port"]["mapper"] == {
        "--Mapper.ba_refine_focal_length": "0",
        "--Mapper.ba_refine_principal_point": "0",
        "--Mapper.ba_refine_extra_params": "0"}


def test_colmap_calibrated_pose_injection_equals_jax(temp_db, tmp_path,
                                                     monkeypatch):
    """extrinsic_calibration_scan_id: the scans' ScanPath and COLMAP
    settings checked, the calibration scan's calibrated_pose copied onto
    every image and its camera fixed, as the JAX package; an incompatible
    ScanPath refuses the calibration in both."""
    from plant3dvision_tpu_torch.fsdb import io

    scan_toml = ('[ScanPath]\nclass_name = "Circle"\n'
                 '[ScanPath.kwargs]\nn_points = 6\nradius = 40\n')
    calib = temp_db.create_scan("calib_ext")
    (calib.path() / "scan.toml").write_text(scan_toml)
    (calib.path() / "pipeline.toml").write_text(
        '[ExtrinsicCalibration]\nsingle_camera = true\n'
        'camera_model = "SIMPLE_RADIAL"\n')
    calib_imgs = calib.create_fileset("images")
    calib_poses = []
    for v in range(6):
        f = calib_imgs.create_file(f"{v:05d}_rgb")
        f.write_raw(b"\xff\xd8fake", "jpg")
        a = 2 * np.pi * v / 6
        calib_poses.append([40 * np.cos(a) + 0.1, 40 * np.sin(a) - 0.1, 10.0])
        f.set_metadata("calibrated_pose", calib_poses[-1])
    io.write_json(calib.create_fileset("ExtrinsicCalibration_x_deadbeef")
                  .get_file("cameras", create=True), {
        "1": {"id": 1, "model": "SIMPLE_RADIAL", "width": 1440,
              "height": 1080, "params": [1400.0, 720.0, 540.0, -0.02]}})
    scan = _ring_scan(temp_db, "s", 6)
    (scan.path() / "scan.toml").write_text(scan_toml)
    _standin(monkeypatch, tmp_path / "bin", 6)
    captured = _capture_cli_args(monkeypatch)
    cfg = {"Colmap": {"extrinsic_calibration_scan_id": "calib_ext",
                      "camera_model": "SIMPLE_RADIAL", "align_pcd": True}}
    jax_out, port_out = _colmap_both(temp_db, "s", cfg, tmp_path, monkeypatch)
    _assert_same(jax_out, port_out)
    assert port_out[0] == "done"
    assert captured["port"] == captured["jax"]
    assert captured["port"]["feature_extractor"] == {
        "--ImageReader.camera_model": "SIMPLE_RADIAL",
        "--ImageReader.camera_params": "1400.0,720.0,540.0,-0.02"}
    assert [cp for _, _, cp in port_out[5].values()] == calib_poses

    (scan.path() / "scan.toml").write_text(scan_toml.replace("40", "35"))
    cfg["Colmap"]["cli_args"] = {"marker": {}}      # a new fileset
    jax_out, port_out = _colmap_both(temp_db, "s", cfg, tmp_path, monkeypatch)
    for out in (jax_out, port_out):
        assert out[0].startswith("failed:") and "acquisition" in out[0]


def test_check_scan_parameters_and_colmap_cfg_equal_jax(temp_db):
    """check_scan_parameters (no scan.toml, equal, other kwargs, other
    class) and check_colmap_cfg (no backup, equal, another model) give the
    JAX package's answers and errors."""
    from plant3dvision_tpu.tasks import colmap as jax_colmap
    from plant3dvision_tpu_torch.tasks import colmap

    a = temp_db.create_scan("scan_a")
    b = temp_db.create_scan("scan_b")
    toml_a = ('[ScanPath]\nclass_name = "Circle"\n'
              '[ScanPath.kwargs]\nn_points = 60\nradius = 350\n')
    answers = []
    for text_b in (None, toml_a, toml_a.replace("60", "36"),
                   toml_a.replace("Circle", "Spiral")):
        if text_b is not None:
            (a.path() / "scan.toml").write_text(toml_a)
            (b.path() / "scan.toml").write_text(text_b)
        got = colmap.check_scan_parameters(a, b)
        assert got == jax_colmap.check_scan_parameters(a, b)
        answers.append(got)
    assert answers == [True, True, False, False]

    cur = {"single_camera": True, "camera_model": "OPENCV"}

    def outcome(fn, cfg):
        try:
            fn(cfg, b)
            return "ok"
        except ValueError as e:
            return str(e)
    results = []
    for backup in (None, '[ExtrinsicCalibration]\nsingle_camera = true\n'
                   'camera_model = "OPENCV"\n'):
        if backup is not None:
            (b.path() / "pipeline.toml").write_text(backup)
        for cfg in (cur, dict(cur, camera_model="SIMPLE_RADIAL")):
            got = outcome(colmap.check_colmap_cfg, cfg)
            assert got == outcome(jax_colmap.check_colmap_cfg, cfg)
            results.append(got)
    assert "pipeline.toml" in results[0]
    assert results[2] == "ok" and "camera_model" in results[3]


def test_fit_circle_equals_jax(rng):
    from plant3dvision_tpu.utils import fit_circle as jax_fit
    from plant3dvision_tpu_torch.utils import fit_circle
    a = rng.uniform(0, 2 * np.pi, 30)
    x = 3.0 + 40 * np.cos(a) + rng.normal(0, 0.1, 30)
    y = -2.0 + 40 * np.sin(a) + rng.normal(0, 0.1, 30)
    got, want = fit_circle(x, y), jax_fit(x, y)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert abs(got[2] - 40.0) < 0.1


# -- ChArUco ---------------------------------------------------------------

@pytest.fixture()
def cv2_one_thread():
    """cv2 on one thread: its camera calibration sums in thread order, so
    two calls on several threads differ in the last bits (1e-12)."""
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("cv2.aruco")
    n = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(n)


def _board_views(calib, n=6, width=640, height=480, f=700.0):
    """`n` pinhole views (f, no distortion) of the default ChArUco board
    image, tilted and turned differently, as uint8 RGB."""
    import cv2
    board = calib.create_charuco_image(calib.get_charuco_board(), 1400, 1000)
    src = np.float32([[0, 0], [1400, 0], [1400, 1000], [0, 1000]])
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
    views = []
    for i in range(n):
        rx, ry = np.radians(-20 + 8 * i), np.radians(15 - 6 * i)
        R = (cv2.Rodrigues(np.array([rx, 0.0, 0.0]))[0]
             @ cv2.Rodrigues(np.array([0.0, ry, np.radians(3 * i)]))[0])
        corners = np.array([[-0.7, -0.5, 0], [0.7, -0.5, 0], [0.7, 0.5, 0],
                            [-0.7, 0.5, 0]]) * 0.38
        cam = corners @ R.T + np.array([0.0, 0.0, 1.0])
        dst = (cam[:, :2] / cam[:, 2:] * f + K[:2, 2]).astype(np.float32)
        H = cv2.getPerspectiveTransform(src, dst)
        img = cv2.warpPerspective(board, H, (width, height),
                                  borderValue=255)
        views.append(np.repeat(img[..., None], 3, axis=2))
    return views


def test_charuco_functions_equal_jax(tmp_path, cv2_one_thread):
    """get_charuco_board / create_charuco_image, detect_charuco_corners on
    six rendered views, calibrate_camera (all three models) and
    pose_estimation_figure's statistics equal the JAX package's."""
    import plant3dvision_tpu.calibration as jcal
    from plant3dvision_tpu_torch import calibration as cal

    np.testing.assert_array_equal(cal.create_charuco_image(),
                                  jcal.create_charuco_image())
    views = _board_views(cal)
    det = [cal.detect_charuco_corners(v) for v in views]
    jdet = [jcal.detect_charuco_corners(v) for v in views]
    for (c, i), (jc, ji) in zip(det, jdet):
        assert c is not None and len(c) >= 20
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(i, ji)
    blank = np.full((480, 640, 3), 255, np.uint8)
    assert cal.detect_charuco_corners(blank) == (None, None)
    for model in ("SIMPLE_RADIAL", "RADIAL", "OPENCV"):
        got = cal.calibrate_camera([c for c, _ in det], [i for _, i in det],
                                   (640, 480), model=model)
        assert got == jcal.calibrate_camera(
            [c for c, _ in det], [i for _, i in det], (640, 480),
            model=model)
        assert abs(got["params"][0] - 700.0) < 10.0, got["params"]
    with pytest.raises(ValueError, match="Unsupported"):
        cal.calibrate_camera([c for c, _ in det], [i for _, i in det],
                             (640, 480), model="FOV")
    cnc = {f"{v}": [40.0 * np.cos(v), 40.0 * np.sin(v), 10.0]
           for v in range(8)}
    est = {k: [p[0] + 0.2, p[1] - 0.1, p[2] + 0.05] for k, p in cnc.items()}
    pytest.importorskip("matplotlib")
    stats = cal.pose_estimation_figure(cnc, est, tmp_path / "port.png", "s")
    assert stats == jcal.pose_estimation_figure(cnc, est,
                                                tmp_path / "jax.png", "s")
    assert (tmp_path / "port.png").stat().st_size > 0
    assert cal.pose_estimation_figure({}, est)["n_poses"] == 0


def _task_both(db, scan_id, cfg, task, tmp_path, env):
    """`task` through the JAX runtime, then the port's (CPU): per package
    its report, every output file (JSON as data, images as arrays, the
    figures by file name and whether they hold bytes) and the files'
    metadata. The JAX run's fileset is deleted after it is read (its
    upstream outputs stay, and the port's run reads them)."""
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.runtime import run_task as jax_run_task
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.runtime import RunContext, run_task

    out = []
    for pkg in ("jax", "port"):
        env.setenv("COLMAP_WD", str(tmp_path / f"wd_{pkg}_{task}"))
        ctx = (JaxRunContext(db, scan_id, cfg) if pkg == "jax"
               else RunContext(db, scan_id, cfg, device="cpu"))
        rep = (jax_run_task if pkg == "jax" else run_task)(
            ctx, task, report=False)
        fs = ctx.scan.get_fileset(rep[task]["fileset"])
        files = {}
        for f in fs.get_files():
            if f.filename.endswith(".json"):
                files[f.id] = json.loads(f.read_raw())
            elif f.id in ("poses_figure", "circle_fit"):
                files[f.id] = (f.filename, f.path().stat().st_size > 0)
            else:
                files[f.id] = io.read_image(f)
        out.append((rep, files, {f.id: f.get_metadata() for f in
                                 fs.get_files()}))
        if pkg == "jax":
            ctx.scan.delete_fileset(fs.id)
    return out


def test_charuco_tasks_equal_jax(temp_db, tmp_path, cv2_one_thread,
                                 monkeypatch):
    """CreateCharucoBoard, DetectCharuco (six rendered views and a blank
    one) and IntrinsicCalibration through both runtimes: equal fileset ids,
    board image, detections and camera_model.json; the two *Exists markers
    point at the same filesets."""
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu_torch import calibration as cal
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.runtime import RunContext

    scan = temp_db.create_scan("board")
    images = scan.create_fileset("images")
    for v, img in enumerate(_board_views(cal) + [
            np.full((480, 640, 3), 255, np.uint8)]):
        io.write_image(images.create_file(f"{v:05d}_rgb"), img, "png")
    cfg = {}
    for task in ("CreateCharucoBoard", "DetectCharuco",
                 "IntrinsicCalibration"):
        (jrep, jfiles, jmeta), (rep, files, meta) = _task_both(
            temp_db, "board", cfg, task, tmp_path, monkeypatch)
        assert rep[task]["fileset"] == jrep[task]["fileset"]
        assert set(files) == set(jfiles) and meta == jmeta
        for k in files:
            np.testing.assert_equal(files[k], jfiles[k])
    assert len(files["camera_model"]) == 3
    assert set(jfiles) == {"camera_model"}

    temp_db.create_scan("s2")
    for marker in ("IntrinsicCalibrationExists",
                   "ExtrinsicCalibrationExists"):
        for kw in ({}, {"scan_id": "board"}):
            c = {marker: kw}
            port = RunContext(temp_db, "s2" if kw else "board", c,
                              device="cpu").get_task(marker).output()
            jax = JaxRunContext(temp_db, "s2" if kw else "board",
                                c).get_task(marker).output()
            assert port.fileset_id == jax.fileset_id
            assert port.scan.id == jax.scan.id == "board"
    assert port.fileset_id == "None"            # no ExtrinsicCalibration


def test_extrinsic_calibration_task_equals_jax(temp_db, tmp_path,
                                               monkeypatch):
    """ExtrinsicCalibration with the stand-in colmap through both
    runtimes: equal calibrated_pose and colmap_camera on every image,
    images/cameras JSON and calibration_stats (the circle fit: radius 40,
    no residual), both figures written."""
    pytest.importorskip("matplotlib")
    _ring_scan(temp_db, "cal", 12)
    _standin(monkeypatch, tmp_path / "bin", 12)
    (jrep, jfiles, jmeta), (rep, files, meta) = _task_both(
        temp_db, "cal", {}, "ExtrinsicCalibration", tmp_path, monkeypatch)
    assert rep["ExtrinsicCalibration"]["fileset"] == \
        jrep["ExtrinsicCalibration"]["fileset"]
    assert files == jfiles and meta == jmeta
    stats = files["calibration_stats"]
    assert abs(stats["circle_fit"]["radius"] - 40.0) < 1e-6
    assert stats["circle_fit"]["residual_rms"] < 1e-6
    assert files["poses_figure"] == ("poses_figure.png", True)
    assert files["circle_fit"] == ("circle_fit.png", True)
