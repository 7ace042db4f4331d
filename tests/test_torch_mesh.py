"""The meshes of the port (native/, proc3d.pcd2mesh, TriangleMesh,
ClusteredMesh, CurveSkeleton "mcf") held to the JAX package on the CPU.

The port builds its own copy of geometry.cpp with the JAX package's flags;
on one machine both libraries give the same triangles, and the port's
plain version (numpy, geometry.cpp's float32 arithmetic) the same too.
pcd2mesh's signed distance runs K2's plain version here (cap 8), which is
bit-equal to the JAX package's; the IMLS blend and the extraction are the
same host code. Tolerances: meshes equal triangles and vertices within
1e-5, the MCF contraction bit-equal to the JAX source built with the
same flags (2.5e-3 to the committed binary), skeleton points 1e-4 with
equal lines.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _fields():
    """Volumes to mesh: a sphere's signed distance, an ellipsoid's at level
    0.3 and a seeded smooth random field (many small components)."""
    from scipy.ndimage import gaussian_filter
    n = 24
    c = (n - 1) / 2.0
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    sphere = 8.0 - np.sqrt((xx - c) ** 2 + (yy - c) ** 2 + (zz - c) ** 2)
    ell = 1.0 - np.sqrt(((xx - c) / 9) ** 2 + ((yy - c) / 5) ** 2
                        + ((zz - c) / 7) ** 2)
    rnd = gaussian_filter(np.random.default_rng(5).normal(
        size=(20, 18, 22)), 1.5).astype(np.float32)
    return {"sphere": (sphere, 0.0), "ellipsoid": (ell, 0.3),
            "random": (rnd, 0.02)}


@pytest.mark.parametrize("name", ["sphere", "ellipsoid", "random"])
def test_marching_tetrahedra_equals_jax_build_and_plain(name):
    """The port's library (its own build of geometry.cpp) against the JAX
    package's library and the port's plain version: equal vertices and
    triangles."""
    from plant3dvision_tpu.native import mc as jmc
    from plant3dvision_tpu_torch.native import mc

    vol, level = _fields()[name]
    m = mc.marching_cubes(vol, level)
    j = jmc.marching_cubes(vol, level)
    p = mc._marching_tetrahedra_numpy(vol, level)
    assert len(m.triangles) > 100
    for other in (j, p):
        np.testing.assert_array_equal(m.triangles, other.triangles)
        np.testing.assert_array_equal(m.vertices, other.vertices)


def test_port_library_is_its_own_build():
    """In a fresh interpreter, meshing maps the port's library from
    native/_build and never the JAX package's native/libp3dgeom.so."""
    code = r"""
import numpy as np
from plant3dvision_tpu_torch.native import mc
n = 12
g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - 5.5
m = mc.marching_cubes(4.0 - np.sqrt((g ** 2).sum(0)), 0.0)
assert len(m.triangles) > 0
maps = open("/proc/self/maps").read()
so = str(mc.build())
assert "/_build/" in so and so in maps, so
assert "plant3dvision_tpu/native/libp3dgeom.so" not in maps
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("case", ["no_compiler", "bad_source"])
def test_native_build_failure_raises(tmp_path, monkeypatch, case):
    """A build that cannot run or fails raises, for marching_cubes and the
    MCF contraction alike: no numpy or scipy fallback."""
    from plant3dvision_tpu_torch.native import mc, mcf

    monkeypatch.setattr(mc, "_lib", None)
    monkeypatch.setattr(mc, "BUILD_ROOT", tmp_path / "build")
    if case == "no_compiler":
        monkeypatch.setattr(mc, "CXX", str(tmp_path / "no-such-g++"))
    else:
        bad = tmp_path / "geometry.cpp"
        bad.write_text("int p3d_marching_tetrahedra( {\n")
        monkeypatch.setattr(mc, "SOURCE", bad)
    vol = _fields()["sphere"][0]
    with pytest.raises(RuntimeError, match="native geometry build failed"):
        mc.marching_cubes(vol, 0.0)
    with pytest.raises(RuntimeError, match="native geometry build failed"):
        mcf.contract_mesh(np.zeros((3, 3)), np.array([[0, 1, 2]]))
    assert not list((tmp_path / "build").rglob("*.so"))


def _ellipsoid_cloud(n=4000, seed=0, scale=(6.0, 4.0, 9.0), normals=True):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * np.array(scale), (v if normals else None)


def test_imls_field_equals_jax():
    from plant3dvision_tpu.proc3d import _imls_field as jax_imls
    from plant3dvision_tpu_torch.proc3d import _imls_field, pcd2vol

    pts, nrm = _ellipsoid_cloud()
    vol, origin = pcd2vol(pts, 0.7, zero_padding=4)
    F, W = _imls_field(pts, nrm.astype(np.float32), origin, vol.shape, 0.7)
    jF, jW = jax_imls(pts, nrm.astype(np.float32), origin, vol.shape, 0.7)
    assert F.dtype == W.dtype == np.float32 and (W > 0).sum() > 1000
    np.testing.assert_array_equal(F, jF)
    np.testing.assert_array_equal(W, jW)


@pytest.mark.parametrize("normals", [True, False])
@pytest.mark.parametrize("voxel_size", [0.7, 1.0])
def test_pcd2mesh_equals_jax(normals, voxel_size):
    """pcd2mesh on the CPU (K2's plain version at cap 8, bit-equal to the
    JAX package's signed distance on the same padded occupancy grid):
    equal triangles, vertices within 1e-5; with and without normals."""
    from scipy.ndimage import binary_closing, binary_fill_holes

    import jax.numpy as jnp
    from plant3dvision_tpu.fsdb.geometry import PointCloud as JaxPCD
    from plant3dvision_tpu.ops.edt import signed_distance as jax_sd
    from plant3dvision_tpu.proc3d import pcd2mesh as jax_pcd2mesh
    from plant3dvision_tpu.proc3d import pcd2vol as jax_pcd2vol
    from plant3dvision_tpu_torch.fsdb.geometry import PointCloud
    from plant3dvision_tpu_torch.ops.edt import signed_distance
    from plant3dvision_tpu_torch.proc3d import (mesh_occupancy, pcd2mesh,
                                                pcd2vol)

    pts, nrm = _ellipsoid_cloud(normals=normals)
    vol, _ = pcd2vol(pts, voxel_size, zero_padding=4)
    occ, origin = mesh_occupancy(pts, voxel_size)
    jvol, jorigin = jax_pcd2vol(pts, voxel_size, zero_padding=4)
    np.testing.assert_array_equal(vol, jvol)
    np.testing.assert_array_equal(origin, jorigin)
    np.testing.assert_array_equal(occ, binary_fill_holes(
        binary_closing(jvol > 0, iterations=2)).astype(np.float32))
    np.testing.assert_array_equal(
        signed_distance(torch.from_numpy(occ), cap=8).numpy(),
        np.asarray(jax_sd(jnp.asarray(occ), cap=8)))

    m = pcd2mesh(PointCloud(pts, nrm), voxel_size=voxel_size, device="cpu")
    j = jax_pcd2mesh(JaxPCD(pts, nrm), voxel_size=voxel_size)
    assert len(m.triangles) > 1000
    np.testing.assert_array_equal(m.triangles, j.triangles)
    np.testing.assert_allclose(m.vertices, j.vertices, rtol=0, atol=1e-5)


def _mesh():
    """A small closed mesh (pcd2mesh of an ellipsoid's points)."""
    from plant3dvision_tpu_torch.fsdb.geometry import PointCloud
    from plant3dvision_tpu_torch.proc3d import pcd2mesh
    pts, nrm = _ellipsoid_cloud(n=1500, scale=(3.0, 2.5, 8.0))
    return pcd2mesh(PointCloud(pts, nrm), voxel_size=1.0, device="cpu")


def test_mcf_contraction_equals_jax(tmp_path):
    """The native contraction bit-equal to the JAX package's own
    geometry.cpp built by the same compiler with the port's flags
    (native/mc.py:CXX_FLAGS), called through ctypes; within
    COMMITTED_BINARY_ATOL of the JAX package's committed libp3dgeom.so,
    which was compiled once on another machine; the plain version
    (scipy.sparse) equal to the JAX package's scipy mirror of it.

    Six iterations of the float32 CG solve amplify the last bits that two
    compilations round differently: tools/mcf_build_spread.py measured
    the port's build against the committed binary at 1.070e-3 on an
    AVX-512 Xeon with g++ 12.2.0 and at 1.077e-3 on the H100 machine's
    host with g++ 13.3.0, and 0.0 against the same source built with the
    same flags on both."""
    from plant3dvision_tpu.native import mcf as jmcf
    from plant3dvision_tpu_torch.native import mc, mcf

    mesh = _mesh()
    v, t = mesh.vertices, mesh.triangles
    c = mcf.contract_mesh(v, t, iterations=6)
    jax_source = ROOT / "plant3dvision_tpu" / "native" / "geometry.cpp"
    same_flags = mcf.contract_with(
        mc.load(mc.compile_library(jax_source, tmp_path / "libgeom.so")),
        v, t, iterations=6)
    np.testing.assert_array_equal(c, same_flags)
    np.testing.assert_allclose(c, jmcf.contract_mesh(v, t, iterations=6),
                               rtol=0, atol=COMMITTED_BINARY_ATOL)
    assert mc.CXX_FLAGS[:2] == ["-O3", "-march=native"]
    assert np.abs(c - v).max() > 0.5            # it contracted
    p = mcf._contract_scipy(v, t, iterations=3, cg_iters=200)
    np.testing.assert_allclose(
        p, jmcf._contract_scipy(v.astype(np.float64), t, 3, 2.0, 1.0, 200),
        rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="failed"):
        mcf.contract_mesh(np.zeros((0, 3)), np.zeros((0, 3), int))


#: the port's build against the committed libp3dgeom.so (see
#: test_mcf_contraction_equals_jax): 2.3 times the largest difference
#: measured
COMMITTED_BINARY_ATOL = 2.5e-3


@pytest.mark.parametrize("kw", [
    {}, {"bin_size": 1.5, "min_branch": 3.0},
    {"bin_size": 2.0, "stem_axis_inverted": True}])
def test_skeletonize_mesh_equals_jax(kw):
    """skeletonize_mesh (contraction, mesh-geodesic bins, MST, spur
    pruning in the port's networkx orders): points within 1e-4, equal
    lines."""
    from plant3dvision_tpu.native import mcf as jmcf
    from plant3dvision_tpu_torch.native import mcf

    mesh = _mesh()
    pts, lines = mcf.skeletonize_mesh(mesh.vertices, mesh.triangles,
                                      iterations=6, **kw)
    jpts, jlines = jmcf.skeletonize_mesh(mesh.vertices, mesh.triangles,
                                         iterations=6, **kw)
    assert len(pts) > 3
    np.testing.assert_allclose(pts, jpts, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(lines, jlines)


def test_prune_spurs_equals_jax():
    """The spur pruning alone on a star graph with short and long arms
    (the port's graph module in place of networkx)."""
    from plant3dvision_tpu.native.mcf import _prune_spurs as jax_prune
    from plant3dvision_tpu_torch.native.mcf import _prune_spurs

    centers = [[0.0, 0.0, 0.0]]
    lines = []
    for arm, n in enumerate((1, 4, 2, 6)):
        prev = 0
        for k in range(1, n + 1):
            centers.append([np.cos(arm) * k, np.sin(arm) * k, 0.1 * arm])
            lines.append([prev, len(centers) - 1])
            prev = len(centers) - 1
    centers, lines = np.asarray(centers), np.asarray(lines)
    for min_branch in (1.5, 2.5, 5.0):
        got = _prune_spurs(centers, lines, min_branch)
        want = jax_prune(centers, lines, min_branch)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert len(got[0]) < len(centers)


def _synth_scan(db):
    from plant3dvision_tpu.synth import SyntheticPlant, generate_scan
    generate_scan(db, "s", n_views=16, width=256, height=256, f=272.0,
                  plant=SyntheticPlant(n_fruits=6, stem_radius=2.5,
                                       fruit_radius=1.8, fruit_length=30.0,
                                       internode=8.0))


def _run_both(db, cfg, task):
    """`task` through the JAX runtime, then the port's (CPU) on the JAX
    package's upstream outputs (only `task`'s JAX fileset is deleted
    between the runs): both fileset ids and output files, read as meshes
    (.ply) or JSON, with their metadata."""
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.runtime import run_task as jax_run_task
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.runtime import RunContext, run_task

    out = []
    for pkg in ("jax", "port"):
        ctx = (JaxRunContext(db, "s", cfg) if pkg == "jax"
               else RunContext(db, "s", cfg, device="cpu"))
        rep = (jax_run_task if pkg == "jax" else run_task)(
            ctx, task, report=False)
        fs = ctx.scan.get_fileset(rep[task]["fileset"])
        files = {f.id: ((io.read_triangle_mesh(f) if f.filename.endswith(
            ".ply") else json.loads(f.read_raw())), f.get_metadata())
            for f in fs.get_files()}
        out.append((fs.id, files))
        if pkg == "jax":
            ctx.scan.delete_fileset(fs.id)
    return out


def _assert_meshes_equal(jax_files, port_files):
    assert set(port_files) == set(jax_files)
    for k, (mesh, meta) in port_files.items():
        jmesh, jmeta = jax_files[k]
        assert meta == jmeta
        assert len(mesh.triangles) > 0
        np.testing.assert_array_equal(mesh.triangles, jmesh.triangles)
        np.testing.assert_allclose(mesh.vertices, jmesh.vertices, rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("library", ["marching_cubes", "volume_mc"])
def test_triangle_mesh_task_equals_jax(temp_db, library):
    """TriangleMesh on geom_pipe_synth's chain (the JAX package's point
    cloud and volume): equal fileset ids and meshes; one component
    ("most connected triangles")."""
    from plant3dvision_tpu.runtime.config import load_toml
    cfg = load_toml(ROOT / "configs" / "geom_pipe_synth.toml")
    cfg["TriangleMesh"]["library"] = library
    if library == "volume_mc":
        cfg["TriangleMesh"]["level_set_value"] = 0.5
    _synth_scan(temp_db)
    (jid, jfiles), (pid, pfiles) = _run_both(temp_db, cfg, "TriangleMesh")
    assert pid == jid
    _assert_meshes_equal(jfiles, pfiles)
    (mesh, _), = pfiles.values()
    assert len(mesh.connected_components()[1]) == 1


def test_clustered_mesh_task_equals_jax(temp_db):
    """ClusteredMesh on geom_pipe_synth's point cloud, labelled by height
    (the stem below z = 60, "fruit" above): one mesh per label and
    component of at least 10 triangles, equal to the JAX package's."""
    from plant3dvision_tpu.fsdb import io as jio
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.runtime import run_task as jax_run_task
    from plant3dvision_tpu.runtime.config import load_toml
    cfg = load_toml(ROOT / "configs" / "geom_pipe_synth.toml")
    cfg["ClusteredMesh"] = {"upstream_task": "PointCloud"}
    _synth_scan(temp_db)
    rep = jax_run_task(JaxRunContext(temp_db, "s", cfg), "PointCloud",
                       report=False)
    pfile = temp_db.get_scan("s").get_fileset(
        rep["PointCloud"]["fileset"]).get_files()[0]
    z = jio.read_point_cloud(pfile).points[:, 2]
    pfile.set_metadata("labels", np.where(z < 60.0, "stem",
                                          "fruit").tolist())
    (jid, jfiles), (pid, pfiles) = _run_both(temp_db, cfg, "ClusteredMesh")
    assert pid == jid
    assert {k.split("_")[0] for k in pfiles} == {"stem", "fruit"}
    _assert_meshes_equal(jfiles, pfiles)


def test_curve_skeleton_mcf_task_equals_jax(temp_db):
    """CurveSkeleton(method="mcf") over TriangleMesh's mesh (both from the
    JAX package's chain): equal fileset ids, skeleton points within 1e-4,
    equal lines."""
    from plant3dvision_tpu.runtime.config import load_toml
    cfg = load_toml(ROOT / "configs" / "geom_pipe_synth.toml")
    cfg["CurveSkeleton"].update(upstream_task="TriangleMesh", method="mcf",
                                mcf_iterations=6, min_branch=4.0)
    _synth_scan(temp_db)
    (jid, jfiles), (pid, pfiles) = _run_both(temp_db, cfg, "CurveSkeleton")
    assert pid == jid
    (skel, meta), = pfiles.values()
    (jskel, jmeta), = jfiles.values()
    assert meta == jmeta and len(skel["points"]) > 3
    np.testing.assert_allclose(skel["points"], jskel["points"], rtol=0,
                               atol=1e-4)
    assert skel["lines"] == jskel["lines"]
