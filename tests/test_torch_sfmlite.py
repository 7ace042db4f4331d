"""Turntable bundle adjustment (ops/sfmlite.py: Harris over K13, torch
descriptors, matching and Gauss-Newton) against the JAX package, on the
CPU (the kernel's plain version).

Tolerances, and what is exact:
- harris_keypoints: the same corners (uv equal, also where lax.top_k
  breaks ties by index: flat regions, padded bands). The scores are the
  Harris response r = sxx syy - sxy^2 - k (sxx + syy)^2, which cancels:
  the port repeats XLA's fused multiply-adds where its program shows them
  (`_box3`, r), which gives JAX's score exactly on ~96 % of corners; on
  the rest XLA's vector code fuses differently and the scores differ by
  1-8 ulp of r (within 2e-6 x the largest score here). None moved a corner.
- patch_descriptors: within 2e-7 (XLA sums the 2x2 pools and the norm in
  another order); match_mutual: equal matches.
- _residuals / _track_residuals: within 2e-3 px; one _gn_step: the step
  within 1e-4 of its size. The BA sums in another order (jacfwd, the track
  sums, the batched 3x3 solves), so over 42 steps refine_turntable agrees within
  2e-4 px in f and 2e-4 deg per view; iterative_refine picks the same focal
  start. Both meet the JAX tests' own criteria.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plant3dvision_tpu.ops import sfmlite as J

from plant3dvision_tpu_torch.ops import sfmlite as P

sys.path.insert(0, str(Path(__file__).resolve().parent / "unit"))
from test_sfmlite import _synthetic_scene  # noqa: E402

torch.set_num_threads(1)


def _texture(rng, V, H, W):
    base = rng.standard_normal((V, H + 8, W)).astype(np.float32)
    for ax in (1, 2):
        base = (base + np.roll(base, 1, ax) + np.roll(base, -1, ax)) / 3.0
    return base.astype(np.float32)


def test_harris_descriptors_matching_on_shifted_texture():
    """test_sfmlite's scene (a 5-pixel vertical shift of smoothed noise):
    the same corners and matches as JAX (scores, descriptors within the
    module's tolerances), and the JAX test's own criteria."""
    rng = np.random.default_rng(0)
    H, W = 120, 160
    base = _texture(rng, 1, H, W)[0]
    gray = np.stack([base[:H], base[5:H + 5]])
    mask = np.ones((2, H, W), bool)
    uvj, sj = J.harris_keypoints(jnp.asarray(gray), jnp.asarray(mask), k=128)
    uv, s = P.harris_keypoints(torch.from_numpy(gray), torch.from_numpy(mask),
                               k=128)
    np.testing.assert_array_equal(uv.numpy(), np.asarray(uvj))
    sj = np.asarray(sj)
    np.testing.assert_allclose(s.numpy(), sj, rtol=0,
                               atol=2e-6 * np.abs(sj).max())
    assert (s.numpy() == sj).mean() > 0.9
    dj = np.asarray(J.patch_descriptors(jnp.asarray(gray), uvj))
    d = P.patch_descriptors(torch.from_numpy(gray), uv)
    np.testing.assert_allclose(d.numpy(), dj, rtol=0, atol=2e-7)
    ij, vj = J.match_mutual(jnp.asarray(dj[0]), jnp.asarray(dj[1]), sj[0],
                            sj[1])
    idx, valid = P.match_mutual(d[0], d[1], s[0], s[1])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(vj))
    ka = np.nonzero(valid.numpy())[0]
    assert (s.numpy() > 0).sum() > 100 and len(ka) > 20
    shift = uv.numpy()[1][idx.numpy()[ka]] - uv.numpy()[0][ka]
    np.testing.assert_allclose(np.median(shift, 0), [0.0, -5.0], atol=0.5)


@pytest.mark.parametrize("k,bands,H", [(100, 6, 100), (600, 1, 96),
                                       (64, 5, 77)])
def test_harris_keypoints_ties_bands_and_borders(k, bands, H):
    """Textures with flat patches (r = 0 ties, which lax.top_k breaks by
    index), masks cut into each view, band counts that do not divide H or
    k (padded bands and slots), more slots than candidates (invalid slots at
    the lowest -inf indices): uv equal to JAX's; patch corners near the
    frame edge clamp as dynamic_slice does."""
    rng = np.random.default_rng(k + H)
    V, W = 3, 112
    gray = _texture(rng, V, H, W)[:, :H]
    gray[:, 30:60, 20:70] = 0.25                        # flat: r == 0 ties
    mask = np.ones((V, H, W), bool)
    mask[1, :, :40] = False
    mask[2, H // 2:] = False
    uvj, sj = J.harris_keypoints(jnp.asarray(gray), jnp.asarray(mask), k=k,
                                 bands=bands)
    uv, s = P.harris_keypoints(torch.from_numpy(gray), torch.from_numpy(mask),
                               k=k, bands=bands)
    np.testing.assert_array_equal(uv.numpy(), np.asarray(uvj))
    np.testing.assert_array_equal(s.numpy() > 0, np.asarray(sj) > 0)
    assert (np.asarray(sj) == 0).any()
    edge = np.array([[[0, 0], [W - 1, H - 1], [3, H - 2], [W - 5, 1]]] * V,
                    np.float32)
    np.testing.assert_allclose(
        P.patch_descriptors(torch.from_numpy(gray),
                            torch.from_numpy(edge)).numpy(),
        np.asarray(J.patch_descriptors(jnp.asarray(gray), jnp.asarray(edge))),
        rtol=0, atol=2e-7)


@pytest.fixture(scope="module")
def ring():
    V, W, H = 12, 320, 240
    poses, matches, theta_true, jit_pan = _synthetic_scene(V, W, H)
    theta0 = np.zeros(9, np.float32)
    theta0[0] = 300.0
    theta0[3] = 0.7
    return V, W, H, poses, matches, theta0, jit_pan


def test_residuals_and_one_gn_step_match_jax(ring):
    """_residuals (pairwise, the pre-gate) and _track_residuals (tracks)
    within 2e-3 px of JAX's at a jittered parameter vector; build_tracks
    equal; one LM step with per-view jitter free moves p by the same step
    within 1e-4 of its size, with the same rms and errors."""
    V, W, H, poses, m, theta0, _ = ring
    rng = np.random.default_rng(1)
    p = np.concatenate([theta0, [0.01], rng.normal(0, 0.1, 3 * V)]).astype(
        np.float32)
    ref = np.asarray(J._residuals(jnp.asarray(p), jnp.asarray(poses),
                                  m["va"], m["vb"], m["ua"], m["ub"],
                                  jnp.float32(W), jnp.float32(H)))
    got = P._residuals(torch.from_numpy(p), torch.from_numpy(poses),
                       torch.from_numpy(m["va"].astype(np.int64)),
                       torch.from_numpy(m["vb"].astype(np.int64)),
                       torch.from_numpy(m["ua"]), torch.from_numpy(m["ub"]),
                       np.float32(W), np.float32(H)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    assert np.abs(ref).max() > 1
    tr, nodes = P.build_tracks(m["va"], m["vb"], m["ka"], m["kb"], V, 300)
    jtr, jnodes = J.build_tracks(m["va"], m["vb"], m["ka"], m["kb"], V, 300)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(nodes, jnodes)
    obs_view = (nodes // 300).astype(np.int32)
    uv = np.zeros((V * 300, 2), np.float32)
    uv[m["va"].astype(np.int64) * 300 + m["ka"]] = m["ua"]
    uv = uv[nodes]
    T = int(tr.max()) + 1
    ref = np.asarray(J._track_residuals(jnp.asarray(p), jnp.asarray(poses),
                                        tr, obs_view, uv, jnp.float32(W),
                                        jnp.float32(H), T))
    args = (torch.from_numpy(poses), torch.from_numpy(tr.astype(np.int64)),
            torch.from_numpy(obs_view.astype(np.int64)), torch.from_numpy(uv))
    got = P._track_residuals(torch.from_numpy(p), *args, np.float32(W),
                             np.float32(H), T).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    free = np.array([0, 3, 4, 5, 6, 7] + list(range(10, 10 + 3 * V)))
    reg = np.array([1e-8] + [1.0] * 5 + [10.0] * (3 * V), np.float32)
    w = np.ones(len(tr), np.float32)
    jp, jrms, jerr = J._gn_step(
        jnp.asarray(p), jnp.asarray(p), jnp.asarray(poses), tr, obs_view, uv,
        w, jnp.float32(W), jnp.float32(H), jnp.asarray(free, np.int32),
        jnp.asarray(reg), jnp.float32(0.1), len(free), n_tracks=T)
    pp, rms, err = P._gn_step(
        torch.from_numpy(p), torch.from_numpy(p), *args,
        torch.from_numpy(w), np.float32(W), np.float32(H),
        torch.from_numpy(free), torch.from_numpy(reg), torch.tensor(0.1),
        len(free), n_tracks=T)
    step, jstep = pp.numpy() - p, np.asarray(jp) - p
    np.testing.assert_allclose(step, jstep, rtol=0,
                               atol=1e-4 * np.abs(jstep).max())
    np.testing.assert_allclose(float(rms), float(jrms), rtol=1e-5)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=0,
                               atol=2e-3)


def test_track_sums_take_the_observation_order(ring):
    """track_slots: per-track sums over its rows, in row order, are the
    CPU index_add_'s sums bit for bit (observation order), with tracks of
    uneven length and observations not grouped by track; no atomics, so
    the card repeats them (tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(3)
    T, M = 40, 500
    tr = rng.integers(0, T, M)
    tr[:T] = np.arange(T)                      # every track observed
    x = torch.from_numpy(rng.standard_normal((M, 12)).astype(np.float32))
    ref = torch.zeros((T, 12)).index_add(0, torch.from_numpy(tr), x)
    slots = P.track_slots(torch.from_numpy(tr), T)
    assert slots.shape == (np.bincount(tr).max(), T)
    rows = torch.cat([x, x.new_zeros((1, 12))])
    got = x.new_zeros((T, 12))
    for r in range(slots.shape[0]):
        got = got + rows[slots[r]]
    assert torch.equal(got, ref)


def test_refine_turntable_matches_jax(ring):
    """test_sfmlite's BA scene (12 views): the port's result within the
    module's tolerances of JAX's (same tracks, observations and inliers)
    and the JAX test's own criteria (f within 1 %, rms < 1 px, per-view
    pan jitter recovered)."""
    V, W, H, poses, m, theta0, jit_pan = ring
    ref = J.refine_turntable(m, poses, theta0, W, H)
    got = P.refine_turntable(m, poses, theta0, W, H, device="cpu")
    for key in ("n_matches", "n_tracks", "n_obs", "n_inliers"):
        assert got[key] == ref[key], key
    np.testing.assert_allclose(got["theta_raw"], ref["theta_raw"], rtol=0,
                               atol=2e-4)
    for key in ("dpan_view", "dtilt_view", "droll_view"):
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=2e-4)
    np.testing.assert_allclose(got["rms_px"], ref["rms_px"], rtol=1e-4)
    assert abs(got["theta"]["f"] - 260.0) / 260.0 < 0.01
    assert got["rms_px"] < 1.0
    rec = got["dpan_view"] - got["dpan_view"].mean()
    tru = jit_pan - jit_pan.mean()
    assert np.corrcoef(rec, tru)[0, 1] > 0.9
    assert np.max(np.abs(rec - tru)) < 0.1


def test_iterative_refine_multistart_matches_jax(ring):
    """test_sfmlite's multi-start case (f 2.4x low, starts x0.05 and x2.4 on
    the cached raw matches): the same winning start, the result within the
    module's tolerances of JAX's, the JAX test's criteria; and None, not an
    exception, when no start has enough matches."""
    V, W, H, poses, m, theta0, _ = ring
    th = theta0.copy()
    th[0] = 110.0
    kw = dict(min_matches=50, f_starts=(0.05, 2.4))
    ref = J.iterative_refine(None, None, th, poses, W, H,
                             _cache={"raw": dict(m)}, **kw)
    got = P.iterative_refine(None, None, th, poses, W, H,
                             _cache={"raw": dict(m)}, device="cpu", **kw)
    assert got["f_start"] == ref["f_start"]
    assert got["n_inliers"] == ref["n_inliers"]
    np.testing.assert_allclose(got["theta_raw"], ref["theta_raw"], rtol=0,
                               atol=2e-4)
    assert abs(got["theta"]["f"] - 260.0) / 260.0 < 0.01
    assert got["rms_px"] < 1.0
    assert P.iterative_refine(None, None, th, poses, W, H,
                              min_matches=10 ** 9, f_starts=(1.0, 2.4),
                              _cache={"raw": dict(m)}, device="cpu") is None
