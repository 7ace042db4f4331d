"""Visualization, visu.py and visu_plotly.py of the port against the JAX
package on the CPU: the Visualization task's file ids, decoded images,
copies and zip equal (on an RGB scan, images only, and after the
geometric chain, which the JAX runtime runs and both then read); without
matplotlib both tasks raise after writing their images and thumbnails;
visu's figures are written; visu_plotly's trace dicts equal, and its
figure builders raise without plotly as the JAX ones do.
"""

import json
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from plant3dvision_tpu.fsdb import io as jio
from plant3dvision_tpu.runtime import RunContext as JaxRunContext
from plant3dvision_tpu.runtime import run_task as jax_run_task
from plant3dvision_tpu.runtime.config import load_toml

from plant3dvision_tpu_torch.runtime import RunContext, run_task

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _visualize(db, cfg):
    """Visualization through the JAX runtime, then, its output deleted,
    through the port's on the CPU. Returns [(fileset id, {file id:
    (filename, metadata, decoded payload)}, zip names)] for both."""
    out = []
    for pkg in ("jax", "port"):
        ctx = (JaxRunContext(db, "s", cfg) if pkg == "jax"
               else RunContext(db, "s", cfg, device="cpu"))
        rep = (jax_run_task if pkg == "jax" else run_task)(
            ctx, "Visualization", report=False)
        fs = ctx.scan.get_fileset(rep["Visualization"]["fileset"])
        files = {}
        for f in fs.get_files():
            ext = f.filename.rsplit(".", 1)[-1]
            if ext in ("jpg", "png") and not f.id.endswith("_figure"):
                data = jio.read_image(f)
            elif ext == "json":
                data = json.loads(f.read_raw())
            elif ext == "zip":
                with zipfile.ZipFile(f.path()) as z:
                    data = sorted(z.namelist())
            elif f.id.endswith("_figure"):
                data = f.path().stat().st_size > 0
            else:
                data = f.read_raw()
            files[f.id] = (f.filename, f.get_metadata(), data)
        out.append((fs.id, files))
        if pkg == "jax":
            ctx.scan.delete_fileset(fs.id)
    return out


def _assert_equal_visualizations(jax_out, port_out):
    (jid, jfiles), (pid, pfiles) = jax_out, port_out
    assert pid == jid
    assert list(pfiles) == list(jfiles)
    for fid, (name, md, data) in jfiles.items():
        pname, pmd, pdata = pfiles[fid]
        assert (pname, pmd) == (name, md), fid
        if isinstance(data, np.ndarray):
            assert pdata.dtype == data.dtype and pdata.shape == data.shape
            np.testing.assert_array_equal(pdata, data, err_msg=fid)
        else:
            assert pdata == data, fid


def test_visualization_images_only_rgb(temp_db):
    """An RGB scan (the port's synth.generate_ml_scan, which writes what
    the JAX package's does, tests/test_torch_evaluation.py): JPEG images
    shrunk to 100 px (INTER_AREA at a non-integer scale) and 48 px
    thumbnails, equal after decoding; nothing else to bundle."""
    from plant3dvision_tpu_torch.synth import SyntheticPlant, generate_ml_scan
    generate_ml_scan(temp_db, "s", n_views=4, width=176, height=132, f=150.0,
                     plant=SyntheticPlant(n_fruits=3, internode=8.0,
                                          fruit_length=12.0))
    cfg = {"Visualization": {"max_image_size": 100, "thumbnail_size": 48,
                             "query": {"channel": "rgb"}}}
    jax_out, port_out = _visualize(temp_db, cfg)
    ids = list(port_out[1])
    assert sum(i.startswith("image_") for i in ids) == 4
    assert port_out[1]["image_00000_rgb"][0].endswith(".jpg")
    assert port_out[1]["thumbnail_00000_rgb"][2].shape == (36, 48, 3)
    _assert_equal_visualizations(jax_out, port_out)


@pytest.fixture(scope="module")
def pipeline_db():
    """A small silhouette scan through geom_pipe_synth.toml's chain (the
    JAX runtime)."""
    from plant3dvision_tpu.fsdb.testing import TemporaryDB
    from plant3dvision_tpu.synth import SyntheticPlant, generate_scan
    with TemporaryDB() as db:
        plant = SyntheticPlant(n_fruits=6, stem_radius=2.5,
                               fruit_radius=1.8, fruit_length=25.0,
                               internode=6.0)
        generate_scan(db, "s", n_views=12, width=192, height=192, f=200.0,
                      plant=plant)
        cfg = load_toml(CONFIGS / "geom_pipe_synth.toml")
        ctx = JaxRunContext(db, "s", cfg)
        jax_run_task(ctx, "AnglesAndInternodes", report=False)
        yield db


def test_visualization_after_the_chain(pipeline_db):
    """geom_pipe_virtual.toml's section (gray PNG images, their sizes under
    1500, 150 px thumbnails) after the chain: the point cloud, skeleton
    and angles copied, the figures written, the zip's names equal."""
    cfg = {"Visualization": dict(load_toml(
        CONFIGS / "geom_pipe_virtual.toml")["Visualization"])}
    jax_out, port_out = _visualize(pipeline_db, cfg)
    files = port_out[1]
    for fid in ("PointCloud", "CurveSkeleton", "AnglesAndInternodes",
                "pointcloud_figure", "skeleton_figure", "sequences_figure",
                "scan"):
        assert fid in files, fid
    assert len(files["AnglesAndInternodes"][2]["angles"]) >= 3
    assert files["thumbnail_00000_rgb"][2].shape == (150, 150)
    _assert_equal_visualizations(jax_out, port_out)


def test_visualization_without_matplotlib_fails_as_jax(pipeline_db,
                                                       monkeypatch):
    """Without matplotlib (the card's machine has none) both tasks raise
    ImportError at their `visu` import, after writing every image and
    thumbnail."""
    import plant3dvision_tpu
    import plant3dvision_tpu_torch
    from plant3dvision_tpu.tasks.visualization import Visualization as JaxV
    from plant3dvision_tpu_torch.tasks.visualization import Visualization
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for pkg in (plant3dvision_tpu, plant3dvision_tpu_torch):
        monkeypatch.delitem(sys.modules, pkg.__name__ + ".visu",
                            raising=False)
        monkeypatch.delattr(pkg, "visu", raising=False)
    cfg = {"Visualization": {"make_zip": False, "thumbnail_size": 32,
                             "max_image_size": 64}}
    out = []
    for cls, ctx in ((JaxV, JaxRunContext(pipeline_db, "s", cfg)),
                     (Visualization, RunContext(pipeline_db, "s", cfg,
                                                device="cpu"))):
        task = ctx.get_task(cls)
        with pytest.raises(ImportError) as info:
            task.run()
        fs = task.output().get()
        out.append((str(info.value), fs.id, sorted(
            (f.id, jio.read_image(f).shape) for f in fs.get_files())))
        ctx.scan.delete_fileset(fs.id)
    assert out[1] == out[0]
    assert "matplotlib" in out[1][0]
    assert len(out[1][2]) == 2 * 12


def test_visu_figures(tmp_path):
    """Every visu.py figure writes a PNG (matplotlib imports here)."""
    from plant3dvision_tpu_torch import visu
    from plant3dvision_tpu_torch.fsdb.geometry import PointCloud
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3))
    visu.point_cloud_figure(PointCloud(pts, colors=rng.random((300, 3))),
                            tmp_path / "pcd.png", subsample=100)
    visu.skeleton_figure(pts[:4], [[0, 1], [1, 2], [2, 3]],
                         tmp_path / "skel.png")
    visu.sequences_figure([137.0, 140.0], [5.0, 6.0], tmp_path / "seq.png",
                          gt_angles=[137.5, 137.5], gt_internodes=[5.5, 5.5])
    visu.alignment_figure([{"pred_angle": 130.0, "gt_angle": 137.5},
                           {"pred_angle": 141.0, "gt_angle": 137.5}],
                          tmp_path / "align.png")
    visu.volume_slice_figure(rng.random((8, 9, 12)), tmp_path / "vol.png")
    visu.image_carousel_figure([rng.random((8, 8)), rng.random((8, 8, 3))],
                               tmp_path / "car.png", titles=["a", "b"])
    for name in ("pcd", "skel", "seq", "align", "vol", "car"):
        assert (tmp_path / f"{name}.png").stat().st_size > 1000, name


def _tree():
    """A tree graph of an exact synthetic skeleton (both packages' traits
    build the same graph from it: tests/test_torch_host.py)."""
    from plant3dvision_tpu.synth import SyntheticPlant
    from plant3dvision_tpu.traits import compute_tree_graph as jax_tree
    from plant3dvision_tpu_torch.traits import compute_tree_graph
    from tests.unit.test_traits import exact_skeleton
    plant = SyntheticPlant(n_fruits=6)
    pts, lines = exact_skeleton(plant)
    return (jax_tree(pts, lines, stem_axis=2, stem_axis_inverted=True),
            compute_tree_graph(pts, lines, stem_axis=2,
                               stem_axis_inverted=True))


def test_visu_plotly_dicts_equal():
    from plant3dvision_tpu import visu_plotly as jvp
    from plant3dvision_tpu.fsdb.geometry import PointCloud as JP
    from plant3dvision_tpu.fsdb.geometry import TriangleMesh as JM
    from plant3dvision_tpu_torch import visu_plotly as vp
    from plant3dvision_tpu_torch.fsdb.geometry import PointCloud, TriangleMesh
    rng = np.random.default_rng(0)
    pts, cols = rng.normal(size=(500, 3)), rng.random((500, 3))
    for kw in ({"n_pts": 100, "seed": 0}, {"n_pts": "all"},
               {"n_pts": 50, "seed": 3, "marker_kwargs": {"size": 2}}):
        assert vp.plotly_pointcloud_data(PointCloud(pts, colors=cols), **kw) \
            == jvp.plotly_pointcloud_data(JP(pts, colors=cols), **kw)
        assert vp.plotly_pointcloud_data(PointCloud(pts), **kw) \
            == jvp.plotly_pointcloud_data(JP(pts), **kw)
    v = rng.random((6, 3))
    t = np.array([[0, 1, 2], [2, 3, 4], [1, 4, 5]])
    assert vp.plotly_mesh_data(TriangleMesh(v, t), {"opacity": 0.5}) == \
        jvp.plotly_mesh_data(JM(v, t), {"opacity": 0.5})
    skel = {"points": v.tolist(), "lines": [[0, 1], [1, 2], [2, 5]]}
    assert vp.plotly_skeleton_data(skel, {"color": "red"}) == \
        jvp.plotly_skeleton_data(skel, {"color": "red"})
    jtree, tree = _tree()
    got = vp.plotly_treegraph_data(tree)
    assert got == jvp.plotly_treegraph_data(jtree)
    assert sum(t["name"].startswith("fruit ") for t in got) == 6
    assert vp.plotly_direction_data(np.eye(3), v[:3], label="fruit") == \
        jvp.plotly_direction_data(np.eye(3), v[:3], label="fruit")
    seqs = {"angles": [137.0, 140.0], "internodes": [5.0, 6.0]}
    assert vp._sequence_xy_traces(seqs, {"width": 1}) == \
        jvp._sequence_xy_traces(seqs, {"width": 1})


@pytest.mark.parametrize("builder", [
    "plotly_pointcloud", "plotly_mesh", "plotly_skeleton", "plotly_treegraph",
    "plotly_fruit_directions", "plotly_sequences", "plotly_vert_sequences",
    "plotly_volume_slicer", "plotly_image_carousel"])
def test_plotly_figures_raise_without_plotly_as_jax(builder):
    """plotly is on neither machine: every figure builder raises the JAX
    builder's ImportError (the port's names its own visu module)."""
    try:
        import plotly  # noqa: F401
        pytest.skip("plotly is installed")
    except ImportError:
        pass
    from plant3dvision_tpu import visu_plotly as jvp
    from plant3dvision_tpu_torch import visu_plotly as vp
    from plant3dvision_tpu_torch.fsdb.geometry import PointCloud, TriangleMesh
    jtree, tree = _tree()
    args = {"plotly_pointcloud": (PointCloud(np.zeros((4, 3))),),
            "plotly_mesh": (TriangleMesh(np.eye(3), [[0, 1, 2]]),),
            "plotly_skeleton": ({"points": np.eye(3).tolist(),
                                 "lines": [[0, 1]]},),
            "plotly_fruit_directions": (np.eye(3), np.zeros((3, 3))),
            "plotly_sequences": ({"a": [1.0]},),
            "plotly_vert_sequences": ({"a": [1.0]},),
            "plotly_volume_slicer": (np.zeros((2, 2, 2)),),
            "plotly_image_carousel": ([np.zeros((2, 2))],)}
    msgs = []
    for mod, t in ((jvp, jtree), (vp, tree)):
        with pytest.raises(ImportError) as info:
            getattr(mod, builder)(*args.get(builder, (t,)))
        msgs.append(str(info.value))
    assert msgs[1] == msgs[0].replace("plant3dvision_tpu.visu",
                                      "plant3dvision_tpu_torch.visu")
    assert "plotly is required" in msgs[1]
