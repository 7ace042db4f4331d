"""The eikonal skeleton (CurveSkeleton(method="fim")) against the JAX
package, on the CPU (the kernels' plain versions).

Tolerances, and what is exact:
- geodesic_distance: bit-equal distances and the same sweep count on every
  scene (the plain version repeats XLA's CPU float32 operations and fused
  multiply-adds, read off its optimized program; PyTorch's CPU float32
  sqrt is not correctly rounded, so the roots are taken in float64). The
  JAX sweep count is read off JAX runs at max_iters = n - 2, n - 1, n.
  The reference's `mid = a + b + c - lo - hi` cancels to 0 in float32 when
  one neighbour is INF (1e10) and two are finite; both packages give the
  corner-seeded slab's d[39, 0, 0] = 1.0 (the true 39) and d[10, 10, 0] =
  1.0 (14.14): a flaw of the reference, repeated, not fixed.
- gradient_flow: within 1e-6 (equal here: the norm as XLA fuses it).
- trace_geodesics: equal int32 votes.
- The compacted neighbour table (K14's data path): a plain loop over it
  gives the same bits and sweep count.
- The task: on geom_pipe_synth.toml with CurveSkeleton.method = "fim",
  equal fileset ids, equal skeleton nodes and edges, centers within 1e-6
  mm, angles within 0.05 deg.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

from plant3dvision_tpu.ops import eikonal as JE
from plant3dvision_tpu.ops import geodesics as JG

from plant3dvision_tpu_torch.ops import eikonal as PE
from plant3dvision_tpu_torch.ops import geodesics as PG

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _blob(shape, seed, n=12):
    """Spheres of radius 3-8 at seeded places, seeded on their lowest z
    plane."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"),
                 -1).astype(np.float32)
    mask = np.zeros(shape, bool)
    for c in rng.uniform(0, 1, (n, 3)) * np.array(shape):
        r = rng.uniform(3, 8)
        mask |= ((g - c) ** 2).sum(-1) < r * r
    seeds = np.zeros_like(mask)
    z0 = np.nonzero(mask.any((0, 1)))[0].min()
    seeds[:, :, z0] = mask[:, :, z0]
    return mask, seeds


def _scene(name):
    if name == "tube":                      # tests/unit/test_eikonal.py
        mask = np.zeros((8, 8, 40), bool)
        mask[3:5, 3:5, :] = True
        seeds = np.zeros_like(mask)
        seeds[3:5, 3:5, 0] = True
    elif name == "l_bend":
        mask = np.zeros((30, 5, 30), bool)
        mask[:, 2, 2] = True
        mask[27, 2, 2:28] = True
        seeds = np.zeros_like(mask)
        seeds[0, 2, 2] = True
    elif name == "slab":
        mask = np.ones((40, 40, 1), bool)
        seeds = np.zeros_like(mask)
        seeds[0, 0, 0] = True
    elif name == "cube":
        mask = np.ones((30, 30, 30), bool)
        seeds = np.zeros_like(mask)
        seeds[0, 0, 0] = True
    else:
        mask, seeds = _blob((32, 32, 48), int(name[-1]))
    return mask, seeds


def _jax(mask, seeds, speed=None, **kw):
    return np.asarray(JE.geodesic_distance(mask, seeds, speed=speed, **kw))


def _port(mask, seeds, speed=None, **kw):
    u, n = PE.geodesic_distance(
        torch.from_numpy(mask), torch.from_numpy(seeds),
        None if speed is None else torch.from_numpy(speed),
        return_sweeps=True, **kw)
    return u.numpy(), n


def _assert_bits(a, b):
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _delta(old, new):
    """The JAX loop's stop statistic: the largest |du| over the voxels whose
    new value is below 5e9 (float32, as the loop computes it)."""
    return np.float32(np.where(new < 5e9, np.abs(old - new), 0).max())


def _assert_jax_stops_at(n, mask, seeds, speed=None):
    """JAX's sweep count is n: its states after n - 2, n - 1 and n sweeps
    (runs at max_iters = k) have the stop statistic > tol at sweep n - 1
    and <= tol at sweep n (a loop that stopped earlier would repeat a state
    and give 0; one that went on would have had > tol at n)."""
    j = [_jax(mask, seeds, speed, max_iters=k) for k in (n - 2, n - 1, n)]
    assert _delta(j[0], j[1]) > np.float32(1e-3)
    assert _delta(j[1], j[2]) <= np.float32(1e-3)
    return j


@pytest.mark.parametrize("name", ["tube", "l_bend", "slab", "cube", "blob0",
                                  "blob1", "blob2"])
def test_geodesic_distance_matches_jax(name):
    """Bit-equal distances at the same sweep count, also one sweep before
    the end."""
    mask, seeds = _scene(name)
    ref = _jax(mask, seeds)
    got, n = _port(mask, seeds)
    _assert_bits(got, ref)
    j = _assert_jax_stops_at(n, mask, seeds)
    _assert_bits(j[2], ref)
    _assert_bits(_port(mask, seeds, max_iters=n - 1)[0], j[1])
    assert (ref < 1e9).sum() > 20


def _table_loop(mask, seeds, speed=None, max_iters=10000, tol=1e-3):
    """The Jacobi loop as K14 runs it, in plain torch ops over the
    compacted neighbour table (compact_neighbors): values gathered through
    the table, the sentinels' INF and 0 in two extra slots, then scattered
    into the dense field. Returns the distances and the sweep count."""
    m, s = torch.from_numpy(mask), torch.from_numpy(seeds)
    active, table = PE.compact_neighbors(m, s)
    n = len(active)
    idx = table.long()
    idx = torch.where(idx == PE.NB_INF, n, torch.where(idx == PE.NB_ZERO,
                                                         n + 1, idx))
    u = torch.full((n + 2,), PE.INF, dtype=torch.float32)
    u[n + 1] = 0.0
    f = (PE.speed_inverse(torch.from_numpy(speed)).reshape(-1)[active]
         if speed is not None else torch.tensor(1.0))
    tol32, sweeps = np.float32(tol), 0
    while n and sweeps < max_iters:
        nb = u[idx]
        new = PE._godunov_update(u[:n], torch.minimum(nb[:, 0], nb[:, 1]),
                                 torch.minimum(nb[:, 2], nb[:, 3]),
                                 torch.minimum(nb[:, 4], nb[:, 5]), f)
        moved = bool(((new < PE.FINITE) & ((u[:n] - new).abs() > tol32))
                     .any())
        u[:n] = new
        sweeps += 1
        if not moved:
            break
    dense = torch.where(m & s, 0.0, PE.INF).reshape(-1)
    dense[active] = u[:n]
    return dense.reshape(mask.shape).numpy(), sweeps


@pytest.mark.parametrize("name", ["tube", "l_bend", "slab", "cube", "blob0",
                                  "blob1", "blob2"])
def test_compact_neighbor_table_loop_matches_jax(name):
    """K14's data path on the CPU: a plain loop over the compacted
    neighbour table (sentinels for INF and the seeds' 0, the stop test as
    "some finite |du| > tol") gives JAX's distances bit for bit, at the
    sweep count of the port's geodesic_distance."""
    mask, seeds = _scene(name)
    got, n = _table_loop(mask, seeds)
    _assert_bits(got, _jax(mask, seeds))
    assert n == _port(mask, seeds)[1]


def test_compact_neighbor_table_loop_with_speed_matches_jax():
    mask, seeds = _scene("blob1")
    speed = np.random.default_rng(6).uniform(0.3, 2.0, mask.shape).astype(
        np.float32)
    got, n = _table_loop(mask, seeds, speed)
    _assert_bits(got, _jax(mask, seeds, speed))
    assert n == _port(mask, seeds, speed)[1]


def test_compact_neighbors_entries():
    """Each entry of the table against the dense grid: the neighbour's
    compact index when it is active, NB_ZERO on a seed of the mask, NB_INF
    outside the mask or past the edge."""
    rng = np.random.default_rng(3)
    mask = rng.random((7, 6, 9)) > 0.3
    seeds = mask & (rng.random(mask.shape) > 0.8)
    active, table = PE.compact_neighbors(torch.from_numpy(mask),
                                         torch.from_numpy(seeds))
    act = mask & ~seeds
    np.testing.assert_array_equal(active.numpy(), np.flatnonzero(act))
    where = {f: i for i, f in enumerate(active.tolist())}
    steps = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1),
             (0, 0, 1)]
    for row, f in zip(table.numpy(), active.tolist()):
        p = np.array(np.unravel_index(f, mask.shape))
        for entry, step in zip(row, steps):
            q = p + step
            if ((q < 0) | (q >= mask.shape)).any() or not mask[tuple(q)]:
                assert entry == PE.NB_INF
            elif seeds[tuple(q)]:
                assert entry == PE.NB_ZERO
            else:
                assert entry == where[np.ravel_multi_index(q, mask.shape)]


def test_the_reference_mid_cancellation_is_repeated():
    """The corner-seeded 40x40x1 slab: INF along z makes mid = 0 in
    float32, and the two-neighbour solve then gives lo + 1 along the
    diagonal: both packages give d = 1.0 at (39, 0) and (10, 10) (true 39
    and 14.14). One voxel with neighbours a = 5, b = INF, c = 3: mid = 0,
    u1 = 4 > mid, d2 < 0 so u2 = INF <= hi = INF: both give INF (true 4)."""
    mask, seeds = _scene("slab")
    ref = _jax(mask, seeds)
    got, _ = _port(mask, seeds)
    assert ref[39, 0, 0] == got[39, 0, 0] == 1.0
    assert ref[10, 10, 0] == got[10, 10, 0] == 1.0
    u = np.full((3, 3, 3), 1e10, np.float32)
    u[0, 1, 1], u[1, 1, 0] = 5.0, 3.0
    jref = np.asarray(JE._godunov_update(jnp.asarray(u), 1.0,
                                         jnp.ones((3, 3, 3), bool)))
    t = lambda x: torch.tensor([x], dtype=torch.float32)  # noqa: E731
    got = PE._godunov_update(t(1e10), t(5.0), t(1e10), t(3.0), t(1.0))
    assert jref[1, 1, 1] == float(got[0]) == np.float32(1e10)


def test_geodesic_distance_with_speed_matches_jax():
    """A non-uniform speed (0.3-2.0): speed_inv an IEEE division, f*f and
    (2f)f rounded before the solves, as XLA hoists them."""
    mask, seeds = _scene("blob0")
    speed = np.random.default_rng(5).uniform(0.3, 2.0, mask.shape).astype(
        np.float32)
    ref = _jax(mask, seeds, speed)
    got, n = _port(mask, seeds, speed)
    _assert_bits(got, ref)
    _assert_bits(_assert_jax_stops_at(n, mask, seeds, speed)[2], ref)


@pytest.mark.parametrize("max_iters", [0, 1, 7, 25])
def test_geodesic_distance_max_iters_binds(max_iters):
    mask, seeds = _scene("cube")
    got, n = _port(mask, seeds, max_iters=max_iters)
    assert n == max_iters
    _assert_bits(got, _jax(mask, seeds, max_iters=max_iters))


def test_geodesic_distance_checks_its_inputs():
    mask, seeds = _scene("tube")
    m, s = torch.from_numpy(mask), torch.from_numpy(seeds)
    with pytest.raises(ValueError):
        PE.geodesic_distance(m.float(), s)
    with pytest.raises(ValueError):
        PE.geodesic_distance(m, s[:, :, :10])
    with pytest.raises(ValueError):
        PE.geodesic_distance(m, s, speed=torch.ones(3))
    empty, n = PE.geodesic_distance(torch.zeros_like(m), s,
                                    return_sweeps=True)
    assert n == 1 and bool((empty == PE.INF).all())


def test_sqrt_f32_is_correctly_rounded():
    """PyTorch's CPU float32 sqrt is not (sqrt(1.9999664) gave 1.4142016;
    IEEE 1.4142017); sqrt_f32 agrees with numpy's float32 root."""
    x = np.concatenate([np.float32([1.9999663829803467]),
                        np.random.default_rng(0).uniform(
                            0, 1e4, 100_000).astype(np.float32)])
    np.testing.assert_array_equal(PE.sqrt_f32(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


def _leaf_tips(mask, d, rng):
    dn = np.where(mask & (d < 1e9), d, -1)
    tips = np.argwhere((dn == ndi.maximum_filter(dn, size=3)) & (dn > 2))
    return np.concatenate([tips, tips + rng.uniform(-0.4, 0.4, tips.shape)]
                          ).astype(np.float32)


@pytest.mark.parametrize("name", ["tube", "l_bend", "cube", "blob0", "blob2"])
def test_gradient_flow_and_trace_geodesics_match_jax(name):
    """gradient_flow within 1e-6 of JAX's; trace_geodesics from the
    distance's local maxima (the flow's leaves) and jittered copies, on
    JAX's flow: equal votes."""
    mask, seeds = _scene(name)
    d = JE.geodesic_distance(mask, seeds)
    jflow = np.array(JE.gradient_flow(d, jnp.asarray(mask)))
    pflow = PE.gradient_flow(torch.from_numpy(np.array(d)),
                             torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(pflow, jflow, rtol=0, atol=1e-6)
    values = np.array(jnp.where(jnp.asarray(mask), d, 0.0))
    tips = _leaf_tips(mask, np.asarray(d), np.random.default_rng(1))
    if name == "tube":
        tips = np.concatenate([tips, [[2.5, 2.5, 28.0], [6.9, 6.95, 39.5]]]
                              ).astype(np.float32)
    ref = np.asarray(JG.trace_geodesics(jnp.asarray(jflow),
                                        jnp.asarray(values),
                                        jnp.asarray(tips), step=0.5,
                                        n_steps=2000))
    got = PG.trace_geodesics(torch.from_numpy(jflow),
                             torch.from_numpy(values),
                             torch.from_numpy(tips), step=0.5,
                             n_steps=2000).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert ref.sum() > 50


def test_trace_geodesics_votes_along_the_tube():
    """tests/unit/test_eikonal.py's tracing scene through the port alone
    (its own flow): the votes walk the tube and never leave it."""
    mask = np.zeros((6, 6, 30), bool)
    mask[2:4, 2:4, :] = True
    seeds = np.zeros_like(mask)
    seeds[2:4, 2:4, 0] = True
    m = torch.from_numpy(mask)
    d = PE.geodesic_distance(m, torch.from_numpy(seeds))
    flow = PE.gradient_flow(d, m)
    assert float(flow[2, 2, 15, 2]) > 0.9
    votes = PG.trace_geodesics(flow, torch.where(m, d, 0.0),
                               torch.tensor([[2.5, 2.5, 28.0]]), step=0.5,
                               n_steps=200).numpy()
    assert votes.sum() > 20
    assert votes[:, :, 5:25].sum() > 0.6 * votes.sum()
    assert votes[2:4, 2:4].sum() == votes.sum()


class _VoxelsFile:
    """The one file of a Voxels fileset as both packages' `_skeleton_fim`
    read it: a volume in an npz, its origin and voxel size."""

    def __init__(self, folder, volume, origin, voxel_size):
        self._path = folder / "voxels.npz"
        np.savez(self._path, volume=volume.astype(np.float32))
        self._meta = {"origin": list(origin), "voxel_size": voxel_size}
        self.db = SimpleNamespace(path=lambda: folder)
        self.scan = SimpleNamespace(id="scan")
        self.fileset = SimpleNamespace(id="Voxels")
        self.id = "voxels"

    def path(self):
        return self._path

    def get_metadata(self, key):
        return self._meta[key]


def _skeleton_task(vfile, bin_size):
    """What `CurveSkeleton._skeleton_fim` reads of its task: the Voxels
    task's file, the run's device and the skeleton's parameters."""
    fileset = SimpleNamespace(get_files=lambda: [vfile])
    voxels = SimpleNamespace(output=lambda: SimpleNamespace(
        get=lambda create=True: fileset))
    ctx = SimpleNamespace(get_task=lambda name: voxels, device="cpu")
    return SimpleNamespace(ctx=ctx, stem_axis=2, stem_axis_inverted=False,
                           bin_size=bin_size)


@pytest.mark.parametrize("name,bin_size", [("blob0", 2.0), ("blob2", 1.0),
                                           ("cube", 3.0)])
def test_bin_clusters_equal_the_whole_grid_loop(name, bin_size, tmp_path):
    """The port's `_skeleton_fim` (each bin labelled in its bounding box,
    centers from bincount sums, edges from the reached voxels' flat
    indices) gives the JAX package's `_skeleton_fim` (one label of the
    whole grid per bin, one whole-grid comparison per component) on the
    same volume: centers within 1e-9 relative in (bin, label) order and
    the same spanning tree, one for each reached component."""
    from plant3dvision_tpu.tasks.proc3d import CurveSkeleton as JaxSkeleton
    from plant3dvision_tpu_torch.tasks.proc3d import (CurveSkeleton,
                                                      root_plane_seeds)
    mask, _ = _scene(name)
    vfile = _VoxelsFile(tmp_path, mask, (-3.5, 2.25, 10.0), 0.5)
    task = _skeleton_task(vfile, bin_size)
    ref_centers, ref_edges = JaxSkeleton._skeleton_fim(task)
    centers, edges = CurveSkeleton._skeleton_fim(task)
    np.testing.assert_allclose(centers, ref_centers, rtol=1e-9, atol=0)
    np.testing.assert_array_equal(edges, ref_edges)
    assert len(centers) > 5
    seeds = root_plane_seeds(torch.from_numpy(mask), 2, False).numpy()
    reach = mask & (_jax(mask, seeds) < 1e9)
    assert len(edges) == len(centers) - ndi.label(reach)[1]


def _skeleton_and_angles(scan, report):
    sk = json.loads(scan.get_fileset(report["CurveSkeleton"]["fileset"])
                    .get_files()[0].read_raw())
    ang = json.loads(scan.get_fileset(report["AnglesAndInternodes"][
        "fileset"]).get_files()[0].read_raw())
    return sk, ang


def test_curve_skeleton_fim_matches_jax(temp_db):
    """geom_pipe_synth.toml with CurveSkeleton.method = "fim" through both
    packages on a 24-view 320x320 synthetic scan (the port on the CPU):
    equal fileset ids, skeleton nodes and edges, centers within 1e-6 mm,
    angles within 0.05 deg."""
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.runtime import run_task as jax_run_task
    from plant3dvision_tpu.runtime.config import load_toml
    from plant3dvision_tpu.synth import SyntheticPlant, generate_scan
    from plant3dvision_tpu_torch.runtime import RunContext, run_task

    cfg = load_toml(CONFIGS / "geom_pipe_synth.toml")
    cfg["CurveSkeleton"]["method"] = "fim"
    plant = SyntheticPlant(n_fruits=12, stem_radius=2.5, fruit_radius=1.8,
                           fruit_length=30.0, internode=6.0)
    generate_scan(temp_db, "s", n_views=24, width=320, height=320, f=340.0,
                  plant=plant)
    jctx = JaxRunContext(temp_db, "s", cfg)
    jrep = jax_run_task(jctx, "AnglesAndInternodes", report=False)
    jsk, jang = _skeleton_and_angles(jctx.scan, jrep)
    jax_run_task(jctx, "Clean", report=False)
    ctx = RunContext(temp_db, "s", cfg, device="cpu")
    rep = run_task(ctx, "AnglesAndInternodes", report=False)
    sk, ang = _skeleton_and_angles(ctx.scan, rep)
    for t in ("Masks", "Voxels", "PointCloud", "CurveSkeleton",
              "RefineSkeleton", "TreeGraph", "AnglesAndInternodes"):
        assert rep[t]["fileset"] == jrep[t]["fileset"], t
    assert len(sk["points"]) == len(jsk["points"]) > 50
    assert sk["lines"] == jsk["lines"]
    np.testing.assert_allclose(sk["points"], jsk["points"], rtol=0,
                               atol=1e-6)
    assert set(rep["CurveSkeleton"]["stages"]) == {"eikonal", "clusters"}
    assert len(ang["angles"]) == len(jang["angles"]) >= 5
    np.testing.assert_allclose(ang["angles"], jang["angles"], rtol=0,
                               atol=0.05)


def test_curve_skeleton_mcf_still_raises(temp_db):
    """The port runs method "mcf" (tests/test_torch_mesh.py holds it to
    JAX); without its upstream mesh it raises as the JAX task does, no
    longer a NotImplementedError."""
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.tasks.proc3d import CurveSkeleton as JaxSkeleton
    from plant3dvision_tpu_torch.runtime import RunContext
    from plant3dvision_tpu_torch.tasks.proc3d import CurveSkeleton
    temp_db.get_scan("s", create=True)
    cfg = {"CurveSkeleton": {"method": "mcf"}}
    with pytest.raises(FileNotFoundError) as jax_err:
        JaxSkeleton(JaxRunContext(temp_db, "s", cfg)).run()
    with pytest.raises(FileNotFoundError) as err:
        CurveSkeleton(RunContext(temp_db, "s", cfg, device="cpu")).run()
    assert str(err.value) == str(jax_err.value)
