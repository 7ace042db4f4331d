"""compare.py and the bin/ tools of the port against the JAX package on the
CPU: every COMPARISON_FUNCTIONS entry on two replicate scans with
fabricated outputs of every compared task (equal results, integers
exactly, floats within 1e-9), and each `python -m
plant3dvision_tpu_torch.tools.<name>` against the JAX bin/ script on the
same inputs: robustness_evaluation's JSON (the replicates run through
each package's runtime, the port's on the CPU), check_measures' report
and exit code, the Voronoi texture for a seed, the ChArUco board,
colmap_poses' statistics, volume_viewer's line, and dash_explorer's
HTML and its --serve exit without dash.
"""

import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from plant3dvision_tpu.fsdb import io as jio
from plant3dvision_tpu.fsdb.geometry import PointCloud as JaxPointCloud
from plant3dvision_tpu.fsdb.geometry import TriangleMesh as JaxTriangleMesh
from plant3dvision_tpu.fsdb.testing import TemporaryDB

from tests.test_torch_evaluation import assert_same

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"


def _bin(name, argv, capsys):
    """bin/<name> of the JAX package in this process: (exit code, stdout,
    stderr)."""
    old = sys.argv
    sys.argv = [str(REPO / "bin" / name)] + [str(a) for a in argv]
    code = 0
    try:
        runpy.run_path(str(REPO / "bin" / name), run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                       else 1)
    finally:
        sys.argv = old
    cap = capsys.readouterr()
    return code, cap.out, cap.err


def _tool(name, argv, capsys):
    """plant3dvision_tpu_torch.tools.<name>.main(argv): (exit code, stdout,
    stderr)."""
    import importlib
    mod = importlib.import_module(f"plant3dvision_tpu_torch.tools.{name}")
    code = 0
    try:
        mod.main([str(a) for a in argv])
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                       else 1)
    cap = capsys.readouterr()
    return code, cap.out, cap.err


# -- compare.py ----------------------------------------------------------------

def _fabricate(db, scan_id, seed):
    """A scan with an output of every task COMPARISON_FUNCTIONS compares,
    seeded: cameras with CNC, calibrated and colmap poses, Colmap's
    cameras, masks, a label volume, point clouds (one labelled), meshes,
    organ clouds, a skeleton and an angle sequence."""
    import chip_smoke
    from plant3dvision_tpu.camera import pose_to_extrinsics
    rng = np.random.default_rng(seed)
    scan = db.get_scan(scan_id, create=True)
    images = scan.get_fileset("images", create=True)
    for v in range(4):
        a = 2 * np.pi * v / 4
        c = np.array([100 * np.cos(a), 100 * np.sin(a), 50.0])
        R, t = pose_to_extrinsics(c + rng.normal(0, 0.5, 3), (0, 0, 40.0))
        f = images.create_file(f"{v:05d}_rgb")
        jio.write_json(f, {})
        cam = {"rotmat": R.tolist(), "tvec": t.tolist()}
        f.set_metadata({"pose": (c + [0.2, 0, 0]).tolist() + [0.0, 0.0],
                        "calibrated_pose": (c - [0, 0.3, 0]).tolist(),
                        "colmap_camera": cam, "camera": cam})
    colmap = scan.get_fileset("Colmap_x", create=True)
    jio.write_json(colmap.create_file("cameras"), {"1": {
        "params": (1400 + rng.normal(0, 5, 4)).tolist()}})
    for task in ("Masks", "Segmentation2D"):
        fs = scan.get_fileset(f"{task}_x", create=True)
        for v in range(3):
            m = ((rng.random((24, 32)) < 0.3) * 255).astype(np.uint8)
            jio.write_image(fs.create_file(f"{v:05d}_rgb"), m, "png")
    jio.write_npz(scan.get_fileset("Voxels_x", create=True).create_file("v"),
                  {"vol": rng.random((6, 7, 8))})
    pts = rng.random((300, 3)) * 20
    jio.write_point_cloud(scan.get_fileset("PointCloud_x", create=True)
                          .create_file("p"), JaxPointCloud(pts))
    f = scan.get_fileset("SegmentedPointCloud_x", create=True).create_file(
        "p")
    jio.write_point_cloud(f, JaxPointCloud(pts))
    f.set_metadata("labels", list(rng.choice(["stem", "fruit"], len(pts))))
    v, t = chip_smoke.tube_mesh([0, 0, 0], rng.random(3) * 10 + [0, 0, 5],
                                1.0 + rng.random())
    jio.write_triangle_mesh(scan.get_fileset("TriangleMesh_x", create=True)
                            .create_file("m"), JaxTriangleMesh(v, t))
    cm = scan.get_fileset("ClusteredMesh_x", create=True)
    org = scan.get_fileset("OrganSegmentation_x", create=True)
    for j, label in enumerate(("stem", "fruit", "fruit")):
        f = cm.create_file(f"{label}_{j}")
        jio.write_triangle_mesh(f, JaxTriangleMesh(v + j, t))
        f.set_metadata("label", label)
        f = org.create_file(f"{label}_{j}")
        jio.write_point_cloud(f, JaxPointCloud(pts[j * 50:(j + 1) * 50 - seed]))
        f.set_metadata("label", label)
    jio.write_json(scan.get_fileset("CurveSkeleton_x", create=True)
                   .create_file("s"), {"points": (pts[:20]).tolist(),
                                       "lines": [[i, i + 1]
                                                 for i in range(19)]})
    jio.write_json(scan.get_fileset("AnglesAndInternodes_x", create=True)
                   .create_file("AnglesAndInternodes"),
                   {"angles": list(137.5 + rng.normal(0, 5, 9)),
                    "internodes": list(6 + rng.normal(0, 1, 9))})
    return scan


@pytest.fixture(scope="module")
def replicates():
    with TemporaryDB() as db:
        yield [_fabricate(db, f"rep{i}", i) for i in range(3)]


def test_comparison_functions_are_the_jax_ones():
    from plant3dvision_tpu.compare import COMPARISON_FUNCTIONS as J
    from plant3dvision_tpu_torch.compare import COMPARISON_FUNCTIONS as P

    def names(fns):
        fns = fns if isinstance(fns, list) else [fns]
        return [(getattr(f, "func", f).__name__,
                 getattr(f, "keywords", None)) for f in fns]
    assert list(P) == list(J)
    assert {k: names(v) for k, v in P.items()} == \
        {k: names(v) for k, v in J.items()}
    shipped = json.loads((REPO / "bin" / "robustness_evaluation.json")
                         .read_text())
    ported = json.loads((REPO / "plant3dvision_tpu_torch" / "tools"
                         / "robustness_evaluation.json").read_text())
    shipped.pop("_comment")
    ported.pop("_comment")
    assert ported == shipped


@pytest.mark.parametrize("task", [
    "IntrinsicCalibration", "Colmap", "TurntableCalibration",
    "ExtrinsicCalibration", "Masks", "Segmentation2D", "Voxels",
    "PointCloud", "SegmentedPointCloud", "TriangleMesh", "ClusteredMesh",
    "OrganSegmentation", "CurveSkeleton", "AnglesAndInternodes"])
def test_comparison_functions_as_jax(replicates, task):
    from plant3dvision_tpu.compare import COMPARISON_FUNCTIONS as J
    from plant3dvision_tpu_torch.compare import COMPARISON_FUNCTIONS as P
    jf = J[task] if isinstance(J[task], list) else [J[task]]
    pf = P[task] if isinstance(P[task], list) else [P[task]]
    for j, p in zip(jf, pf):
        kw = {"device": "cpu"} if "masks" in getattr(
            p, "func", p).__name__ else {}
        want = j(replicates)
        got = p(replicates, **kw)
        assert want, (task, getattr(j, "func", j).__name__)
        assert_same(got, want)


def test_compare_masks_dilated_as_jax(replicates):
    from plant3dvision_tpu import compare as jc
    from plant3dvision_tpu_torch import compare as pc
    assert_same(pc.compare_masks(replicates, dilation=2, device="cpu"),
                jc.compare_masks(replicates, dilation=2))


def test_compare_figures(replicates, tmp_path):
    """The figure writers (matplotlib) write their PNGs."""
    from plant3dvision_tpu_torch import compare as pc
    pw = pc.compare_point_clouds(replicates)
    pc.pairwise_heatmap(pw, "chamfer", tmp_path / "h.png")
    pc.save_data_repartition([v["chamfer"] for v in pw.values()],
                             "chamfer", tmp_path / "r.png")
    assert (tmp_path / "h.png").stat().st_size > 1000
    assert (tmp_path / "r.png").stat().st_size > 1000


# -- tools ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def silhouette_db():
    """Two equal small silhouette scans in two DBs (one for each
    package's robustness run)."""
    from plant3dvision_tpu.synth import SyntheticPlant, generate_scan
    with TemporaryDB() as a, TemporaryDB() as b:
        for db in (a, b):
            generate_scan(db, "rob", n_views=12, width=192, height=192,
                          f=260.0, plant=SyntheticPlant(
                              n_fruits=6, stem_radius=2.5, fruit_radius=1.8,
                              fruit_length=25.0, internode=6.0))
        yield a, b


@pytest.mark.parametrize("task", ["Masks", "AnglesAndInternodes"])
def test_robustness_evaluation_as_jax(silhouette_db, tmp_path, task,
                                      capsys):
    """bin/robustness_evaluation and the port's tool (--device cpu) on
    equal scans, geom_pipe_synth.toml, two replicates: equal JSON."""
    out = []
    for (run, name), db in zip(((_bin, "robustness_evaluation"),
                                (_tool, "robustness_evaluation")),
                               silhouette_db):
        path = tmp_path / f"{name}_{run.__name__}.json"
        argv = [db.path() / "rob", "--task", task, "--config",
                CONFIGS / "geom_pipe_synth.toml", "-n", "2", "--out", path]
        if run is _tool:
            argv += ["--device", "cpu"]
        code, stdout, err = run(name, argv, capsys)
        assert code == 0, (stdout, err[-2000:])
        out.append(json.loads(path.read_text()))
    assert_same(out[1], out[0])
    key = {"Masks": "compare_masks",
           "AnglesAndInternodes": "compare_angles"}[task]
    assert list(out[1][task][key]) == ["rob_rep00-vs-rob_rep01"]


@pytest.mark.parametrize("measures", [
    {"angles": [2.4, 2.3, 2.5], "internodes": [5.0, 6.0, 4.0]},
    {"angles": [137.5, 5.0, 355.0], "internodes": [5.0, -1.0]},
    {"angles": [], "internodes": []}, None])
def test_check_measures_as_jax(tmp_path, capsys, measures):
    scan = tmp_path / "scan"
    scan.mkdir()
    if measures is not None:
        (scan / "measures.json").write_text(json.dumps(measures))
    if measures is not None and not measures["angles"]:
        # the JAX script takes min() of the empty list; so does the port
        with pytest.raises(ValueError):
            _bin("check_measures", [scan], capsys)
        with pytest.raises(ValueError):
            _tool("check_measures", [scan], capsys)
        return
    got = _tool("check_measures", [scan], capsys)
    assert got[:2] == _bin("check_measures", [scan], capsys)[:2]


@pytest.mark.parametrize("args", [[], ["--gray"], ["--count", "2",
                                                   "--cells", "17"]])
def test_voronoi_texture_as_jax(tmp_path, capsys, args):
    import imageio.v2 as iio
    base = ["--width", "96", "--height", "64"] + args
    names = []
    for run, d in ((_bin, "jax"), (_tool, "port")):
        (tmp_path / d).mkdir()
        code, _, _ = run("voronoi_texture_generator",
                           base + ["--out", tmp_path / d / "v"], capsys)
        assert code == 0
        names.append(sorted(p.name for p in (tmp_path / d).iterdir()))
    assert names[0] == names[1] and names[0]
    for n in names[0]:
        got = iio.imread(tmp_path / "port" / n)
        np.testing.assert_array_equal(got, iio.imread(tmp_path / "jax" / n))
        assert got.shape == (64, 96, 3)


def test_create_charuco_board_as_jax(tmp_path, capsys):
    import imageio.v2 as iio
    pytest.importorskip("cv2").aruco
    argv = ["--n_squares_x", "6", "--n_squares_y", "5", "--width", "300",
            "--height", "250"]
    assert _bin("create_charuco_board", argv + ["--out", tmp_path / "j.png"],
                capsys)[0] == 0
    assert _tool("create_charuco_board",
                 argv + ["--out", tmp_path / "p.png"], capsys)[0] == 0
    got = iio.imread(tmp_path / "p.png")
    np.testing.assert_array_equal(got, iio.imread(tmp_path / "j.png"))
    assert got.std() > 50


def test_colmap_poses_and_volume_viewer_as_jax(replicates, tmp_path, capsys):
    """colmap_poses' statistics and volume_viewer's summary line, equal,
    each with its figure written."""
    ds = replicates[1].db.path() / replicates[1].id
    for name, argv in (("colmap_poses", [ds]),
                       ("volume_viewer", [ds, "--axis", "1"])):
        jc, jout, _ = _bin(name, argv + ["--out", tmp_path / "j.png"],
                           capsys)
        pc, pout, _ = _tool(name, argv + ["--out", tmp_path / "p.png"],
                            capsys)
        assert (pc, pout.replace("p.png", "j.png")) == (jc, jout)
        assert (tmp_path / "p.png").stat().st_size > 1000
        (tmp_path / "p.png").unlink()


def test_dash_explorer_as_jax(silhouette_db, tmp_path, capsys):
    """The static explorer page of a scan after the chain (the robustness
    runs above, or this test's own): equal HTML; --serve without dash
    exits 2 with the JAX tool's message."""
    from plant3dvision_tpu.runtime import RunContext, run_task
    from plant3dvision_tpu.runtime.config import load_toml
    db = silhouette_db[0]
    run_task(RunContext(db, "rob", load_toml(
        CONFIGS / "geom_pipe_synth.toml")), "AnglesAndInternodes",
        report=False)
    ds = db.path() / "rob"
    jc = _bin("dash_explorer", [ds, "--out", tmp_path / "j.html"], capsys)[0]
    pc = _tool("dash_explorer", [ds, "--out", tmp_path / "p.html"],
               capsys)[0]
    assert jc == pc == 0
    html = (tmp_path / "p.html").read_text()
    assert html == (tmp_path / "j.html").read_text()
    assert '"points": [[' in html and '"angles": [' in html
    try:
        import dash  # noqa: F401
        import plotly  # noqa: F401
    except ImportError:
        jc, _, jerr = _bin("dash_explorer", [ds, "--serve"], capsys)
        pc, _, perr = _tool("dash_explorer", [ds, "--serve"], capsys)
        assert jc == pc == 2 and perr == jerr
        assert "dash/plotly are not installed" in perr
