"""Turntable bundle adjustment ("SfM-lite"): the feature half of the
COLMAP-free calibration.

Port of plant3dvision_tpu/ops/sfmlite.py. The silhouette stage
(ops/selfcal.py) pins the turntable to a few pixels; this module recovers
the focal length and the per-view CNC jitter from image features. Camera
centres are known from the CNC up to the mount offset, so only ~10 global
+ 3-per-view parameters are adjusted.

- Harris corners: the response, 3x3 non-maximum suppression, keypoint mask
  and border in one hand-written kernel, `harris_response` (K13,
  kernels/csrc/harris.cu; `harris_response_plain` is its plain PyTorch
  version, in XLA's CPU arithmetic), then a stable per-band top-k (value
  descending, then index ascending, as `lax.top_k` orders ties);
- descriptors: a gather, an 8x8 mean pool, normalisation (torch ops);
- matching: one batched product per turntable stride (every view pair of
  the stride at once), mutual-best + ratio test;
- bundle adjustment: rays from the fixed centres, least-squares track
  triangulation (per-track sums in observation order, no atomics, so a
  run on the card repeats bit for bit; batched 3x3 solves), Huber-IRLS
  Levenberg-Marquardt with `torch.func.jacfwd`.

Every product here runs with TF32 off (`_full_f32`). The BA works in
float32 as the JAX package does, but sums in another order (jacfwd, the
3x3 solves, the track sums), so its trajectory agrees to a tolerance, not
bit for bit (tests/test_torch_sfmlite.py).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import kernels
from ..runtime.runner import stage
from .carving import fma_f32
from .selfcal import THETA_NAMES, cnc_to_cameras


@contextlib.contextmanager
def _full_f32():
    """Matrix products in full float32 (TF32 off) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ----------------------------------------------------------------------
# keypoints
# ----------------------------------------------------------------------

_RCP9 = float(np.float32(1.0) / np.float32(9.0))

#: output rows a warp of K13 marches down (kernels/csrc/harris.cu)
HARRIS_ROWS = 32


def _box3(a, b):
    """3x3 box filter of the product a*b, batched (V, H, W), as XLA's CPU
    program computes it: per row fma(a, b, q_left) + q_right (q = a*b
    rounded; the centre product fused into the first add), the rows
    (centre + up) + down, times float32(1/9); jnp.roll's wrap-around."""
    q = a * b
    row = fma_f32(a, b, torch.roll(q, 1, -1)) + torch.roll(q, -1, -1)
    s = (row + torch.roll(row, 1, -2)) + torch.roll(row, -1, -2)
    return s * _RCP9


def harris_response(gray, mask, border: int = 16, kappa: float = 0.06):
    """Harris response with 3x3 non-maximum suppression: gray (V, H, W)
    float32, mask (V, H, W) bool, on one device. Returns (V, H, W) float32:
    r where the pixel is a local maximum of r, inside the mask and at least
    `border` from the frame, else -inf. On CUDA K13
    (kernels/csrc/harris.cu), on the CPU `harris_response_plain`."""
    if gray.dtype != torch.float32 or gray.ndim != 3:
        raise ValueError("gray must be (V, H, W) float32")
    if mask.dtype != torch.bool or mask.shape != gray.shape:
        raise ValueError("mask must be a bool tensor of gray's shape")
    if gray.device.type == "cpu":
        return harris_response_plain(gray, mask, border, kappa)
    kernels.require_cuda("harris_response", gray, mask)
    V, H, W = gray.shape
    out = torch.empty_like(gray)
    rc = kernels.lib().p3d_harris(
        gray.data_ptr(), mask.data_ptr(), V, H, W, HARRIS_ROWS, int(border),
        float(np.float32(kappa)), out.data_ptr(),
        kernels.stream_ptr(gray.device))
    kernels.LAUNCHES["harris_response"] += 1
    kernels.check("harris_response", rc)
    return out


def harris_response_plain(gray, mask, border: int = 16, kappa: float = 0.06):
    """Plain PyTorch version of K13 (jnp.roll's wrap-around included, which
    differs from the kernel's clamped edge only within `border`).

    XLA's fused multiply-adds: the box sums as `_box3`, r as
    fma(-(sxx + syy)^2, kappa, fma(sxx, syy, -sxy^2))."""
    V, H, W = gray.shape
    dev = gray.device
    ix = (torch.roll(gray, -1, -1) - torch.roll(gray, 1, -1)) * 0.5
    iy = (torch.roll(gray, -1, -2) - torch.roll(gray, 1, -2)) * 0.5
    sxx, syy, sxy = _box3(ix, ix), _box3(iy, iy), _box3(ix, iy)
    tr = sxx + syy
    k = torch.tensor(np.float32(kappa), device=dev)
    r = fma_f32(-(tr * tr), k, fma_f32(sxx, syy, -(sxy * sxy)))
    rmax = r
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            rmax = torch.maximum(rmax, torch.roll(r, (dy, dx), (-2, -1)))
    y = torch.arange(H, device=dev)[:, None]
    x = torch.arange(W, device=dev)[None, :]
    inside = ((y >= border) & (y < H - border)
              & (x >= border) & (x < W - border))
    ok = (r >= rmax) & mask & inside
    return torch.where(ok, r, -torch.inf)


def harris_keypoints(gray, mask, k: int = 512, border: int = 16,
                     kappa: float = 0.06, bands: int = 6):
    """Top-k Harris corners per view, restricted to `mask`.

    gray (V, H, W) float32, mask (V, H, W) bool tensors. Returns (uv
    (V, k, 2) float32 [x, y], score (V, k)); invalid slots have score 0.
    Selection is stratified over `bands` horizontal bands (k // bands per
    band), each band's top-k sorted by value descending, then index
    ascending (`lax.top_k`'s order, ties included)."""
    V, H, W = gray.shape
    r = harris_response(gray, mask, border, kappa)
    bands = max(1, min(bands, k))
    kb = k // bands
    Hb = -(-H // bands)
    rp = torch.nn.functional.pad(r, (0, 0, 0, bands * Hb - H),
                                 value=-torch.inf)
    rb = rp.reshape(V, bands, Hb * W)
    score_b, lin_b = torch.sort(rb, dim=-1, descending=True, stable=True)
    score_b, lin_b = score_b[..., :kb], lin_b[..., :kb]
    off = (torch.arange(bands, device=r.device) * Hb * W)[None, :, None]
    lin = (lin_b + off).reshape(V, bands * kb)
    score = score_b.reshape(V, bands * kb)
    if bands * kb < k:
        pad = k - bands * kb
        lin = torch.nn.functional.pad(lin, (0, pad))
        score = torch.nn.functional.pad(score, (0, pad), value=-torch.inf)
    uv = torch.stack([(lin % W).to(torch.float32),
                      torch.div(lin, W, rounding_mode="floor").to(
                          torch.float32)], dim=-1)
    return uv, torch.where(torch.isfinite(score), score, 0.0)


def patch_descriptors(gray, uv, size: int = 16):
    """Normalized (size x size -> 8x8-pooled) patch descriptors: gray
    (V, H, W), uv (V, K, 2) -> (V, K, 64) unit-norm float32 (NCC matching
    is then a plain product). Patch corners are clamped into the frame, as
    `dynamic_slice` clamps its start."""
    V, H, W = gray.shape
    half = size // 2
    x0 = (uv[..., 0].to(torch.int64) - half).clamp(0, W - size)
    y0 = (uv[..., 1].to(torch.int64) - half).clamp(0, H - size)
    o = torch.arange(size, device=gray.device)
    lin = ((y0[..., None, None] + o[:, None]) * W
           + (x0[..., None, None] + o[None, :]))            # (V, K, s, s)
    K = uv.shape[1]
    patches = torch.gather(gray.reshape(V, 1, H * W).expand(V, K, H * W), 2,
                           lin.reshape(V, K, size * size)).reshape(
        V, K, size, size)
    p = size // 8
    pooled = patches.reshape(V, K, 8, p, 8, p).mean(dim=(3, 5))
    d = pooled.reshape(V, K, 64)
    d = d - d.mean(dim=-1, keepdim=True)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-6)


def match_mutual(desc_a, desc_b, score_a, score_b, ratio: float = 0.95):
    """Mutual-best NCC matching with a Lowe-style ratio test.

    desc_* (K, 64) unit descriptors, or (P, K, 64) stacks of P view pairs.
    Returns (idx_b, valid), each (K,) or (P, K): for each keypoint of a,
    its match in b."""
    single = desc_a.ndim == 2
    if single:
        desc_a, desc_b = desc_a[None], desc_b[None]
        score_a, score_b = score_a[None], score_b[None]
    with _full_f32():
        sim = torch.bmm(desc_a, desc_b.transpose(1, 2))    # (P, K, K)
    alive = (score_a[:, :, None] > 0) & (score_b[:, None, :] > 0)
    sim = torch.where(alive, sim, -2.0)
    best_ab = sim.argmax(dim=2)
    top2 = torch.topk(sim, 2, dim=2).values
    ratio_ok = top2[..., 0] * ratio > top2[..., 1]
    best_ba = sim.argmax(dim=1)
    K = sim.shape[1]
    mutual = torch.gather(best_ba, 1, best_ab) == torch.arange(
        K, device=sim.device)
    valid = mutual & ratio_ok & (top2[..., 0] > 0.5)
    if single:
        return best_ab[0], valid[0]
    return best_ab, valid


# ----------------------------------------------------------------------
# bundle adjustment
# ----------------------------------------------------------------------

#: BA parameter vector layout:
#: [theta(9), k1, dpan_view(V), dtilt_view(V), droll_view(V)]
K1_IDX = 9
N_GLOBAL = 10
N_JITTER = 3      # per-view delta groups (dpan, dtilt, droll)


def _cameras_from_params(p, poses, width, height):
    """Global theta (9) + k1 + per-view (dpan_v, dtilt_v, droll_v) ->
    packed (V, 16) cameras (k1 is applied in the projection)."""
    V = poses.shape[0]
    theta = p[:9]
    dpan_v = p[N_GLOBAL:N_GLOBAL + V]
    dtilt_v = p[N_GLOBAL + V:N_GLOBAL + 2 * V]
    droll_v = p[N_GLOBAL + 2 * V:N_GLOBAL + 3 * V]
    poses_adj = torch.stack([poses[:, 0], poses[:, 1], poses[:, 2],
                             poses[:, 3] + dpan_v, poses[:, 4] + dtilt_v], 1)
    return cnc_to_cameras(poses_adj, theta, width, height, droll=droll_v)


def _project_points(cams, X, k1=0.0):
    """cams (M, 16) x points (M, 3) -> pixel (M, 2), with SIMPLE_RADIAL
    distortion x_d = x (1 + k1 r^2)."""
    R = cams[:, 4:13].reshape(-1, 3, 3)
    t = cams[:, 13:16]
    q = (R * X[:, None, :]).sum(-1) + t
    z = q[:, 2].clamp(min=1e-6)
    x = q[:, 0] / z
    y = q[:, 1] / z
    d = 1.0 + k1 * (x * x + y * y)
    return torch.stack([x * d * cams[:, 0] + cams[:, 2],
                        y * d * cams[:, 1] + cams[:, 3]], dim=1)


def _rays(cams, uv, k1=0.0):
    """(C, d̂) world rays through pixels uv for packed cams rows (pixels
    undistorted by two fixed-point iterations of the SIMPLE_RADIAL
    inverse)."""
    R = cams[:, 4:13].reshape(-1, 3, 3)
    t = cams[:, 13:16]
    C = -(R * t[:, :, None]).sum(1)
    xd = (uv[:, 0] - cams[:, 2]) / cams[:, 0]
    yd = (uv[:, 1] - cams[:, 3]) / cams[:, 1]
    x, y = xd, yd
    for _ in range(2):
        s = 1.0 + k1 * (x * x + y * y)
        x, y = xd / s, yd / s
    d_cam = torch.stack([x, y, torch.ones_like(x)], dim=1)
    d = (R * d_cam[:, :, None]).sum(1)
    return C, d / torch.linalg.norm(d, dim=1, keepdim=True)


def _residuals(p, poses, va, vb, ua, ub, width, height):
    """Pairwise reprojection residuals (M, 4) via midpoint triangulation
    (the matches' geometric pre-gate)."""
    cams = _cameras_from_params(p, poses, width, height)
    k1 = p[K1_IDX]
    ca, cb = cams[va], cams[vb]
    Ca, da = _rays(ca, ua, k1)
    Cb, db = _rays(cb, ub, k1)
    w = Cb - Ca
    ab = (da * db).sum(1)
    wa = (w * da).sum(1)
    wb = (w * db).sum(1)
    den = 1.0 - ab * ab
    den = torch.where(den.abs() < 1e-9, 1e-9, den)
    s = (wa - wb * ab) / den
    t = (wa * ab - wb) / den
    X = 0.5 * (Ca + s[:, None] * da + Cb + t[:, None] * db)
    ra = _project_points(ca, X, k1) - ua
    rb = _project_points(cb, X, k1) - ub
    return torch.cat([ra, rb], dim=1)


def build_tracks(va, vb, ka, kb, n_views, k):
    """Union-find pairwise keypoint matches into multi-view tracks (numpy,
    the JAX package's). Returns (obs_track (M,), obs_node (M,))."""
    parent = np.arange(n_views * k, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    na = va.astype(np.int64) * k + ka
    nb = vb.astype(np.int64) * k + kb
    for x, y in zip(na, nb):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[rx] = ry

    nodes = np.unique(np.concatenate([na, nb]))
    roots = np.array([find(x) for x in nodes])
    order = np.argsort(roots, kind="stable")
    nodes, roots = nodes[order], roots[order]
    _, track_of, counts = np.unique(roots, return_inverse=True,
                                    return_counts=True)

    views = nodes // k
    ok_track = np.ones(len(counts), bool)
    seen = {}
    for n, t, v in zip(nodes, track_of, views):
        if (t, v) in seen:
            ok_track[t] = False
        seen[(t, v)] = True
    keep = ok_track[track_of] & (counts[track_of] >= 2)
    nodes, track_of = nodes[keep], track_of[keep]
    _, track_of = np.unique(track_of, return_inverse=True)  # re-densify
    return track_of.astype(np.int32), nodes


def track_slots(obs_track, n_tracks: int):
    """The observations of each track in a fixed order: (R, T) int64 on
    obs_track's device, row r holding every track's r-th observation (in
    observation order), or M (a zero row appended to the summands) where
    the track has fewer. Summing the rows in order is the per-track sum in
    observation order, the order of the CPU's `index_add_`, without
    atomics: the CUDA `index_add_` sums in an order that changes from run
    to run, and the BA (jacfwd's tangents included) then does not repeat."""
    tr = obs_track.cpu().numpy().astype(np.int64)
    order = np.argsort(tr, kind="stable")
    start = np.searchsorted(tr[order], np.arange(n_tracks))
    rank = np.arange(len(tr)) - start[tr[order]]
    slots = np.full((rank.max(initial=-1) + 1, n_tracks), len(tr), np.int64)
    slots[rank, tr[order]] = order
    return torch.as_tensor(slots, device=obs_track.device)


def _track_residuals(p, poses, obs_track, obs_view, obs_uv, width, height,
                     n_tracks: int, slots=None):
    """Reprojection residuals (M_obs, 2) of multi-view tracks: each
    track's point is the least-squares intersection of all its rays
    (X = [sum(I - dd^T)]^-1 [sum (I - dd^T) C]; per-track sums in
    observation order over `slots` (`track_slots`, made here if not
    given), one batched 3x3 solve), reprojected into every observing
    view."""
    if slots is None:
        slots = track_slots(obs_track, n_tracks)
    cams = _cameras_from_params(p, poses, width, height)
    k1 = p[K1_IDX]
    co = cams[obs_view]
    C, d = _rays(co, obs_uv, k1)
    eye = torch.eye(3, dtype=torch.float32, device=p.device)
    P = eye[None] - d[:, :, None] * d[:, None, :]         # (M, 3, 3)
    Pb = (P * C[:, None, :]).sum(-1)
    rows = torch.cat([P.reshape(-1, 9), Pb], dim=1)
    rows = torch.cat([rows, rows.new_zeros((1, 12))])
    acc = rows.new_zeros((n_tracks, 12))
    for r in range(slots.shape[0]):
        acc = acc + rows[slots[r]]
    A = acc[:, :9].reshape(-1, 3, 3)
    b = acc[:, 9:]
    A = A + 1e-6 * eye[None]
    X = torch.linalg.solve(A, b[..., None])[..., 0]       # (T, 3)
    return _project_points(co, X[obs_track], k1) - obs_uv


def _gn_step(p, p_prior, poses, obs_track, obs_view, obs_uv, w_obs,
             width, height, free_idx, reg, lam, n_free: int, n_tracks: int,
             slots=None):
    """One Huber-IRLS Levenberg-Marquardt step on the free parameters
    (Marquardt diagonal scaling; `reg` is a Tikhonov prior toward
    `p_prior`). Returns (p, rms, per-observation error)."""
    if slots is None:
        slots = track_slots(obs_track, n_tracks)

    def r_free(pf):
        return _track_residuals(p.index_put((free_idx,), pf), poses,
                                obs_track, obs_view, obs_uv, width, height,
                                n_tracks, slots)

    with _full_f32():
        pf = p[free_idx]
        r = r_free(pf)                                   # (M, 2)
        err = torch.linalg.norm(r, dim=1)
        delta = 2.0                                      # Huber width (px)
        hub = torch.where(err <= delta, 1.0, delta / err.clamp(min=1e-9))
        wgt = (hub * w_obs)[:, None]
        J = torch.func.jacfwd(r_free)(pf)                # (M, 2, n_free)
        Jw = (J * wgt[..., None]).reshape(-1, n_free)
        JTJ = Jw.T @ J.reshape(-1, n_free)
        # IRLS normal equations: J^T W J dp = -J^T W r (Jw already carries
        # one factor of W)
        JTr = Jw.T @ r.reshape(-1)
        JTJ = JTJ + torch.diag(reg)
        JTr = JTr + reg * (pf - p_prior[free_idx])
        diag = torch.diagonal(JTJ).clamp(min=1e-8)
        A = JTJ + torch.diag(lam * diag)
        dp = torch.linalg.solve(A, -JTr)
        rms = torch.sqrt(((r * wgt) ** 2).sum()
                         / (wgt.sum() * 2).clamp(min=1.0))
    return p.index_put((free_idx,), p[free_idx] + dp), rms, err


def refine_turntable(matches, poses, theta0, width, height, *,
                     free=("f", "dpan", "dtilt", "roll", "mx", "my", "k1"),
                     per_view=True, iters=12, jitter_reg=10.0,
                     gate_px=(60.0, 12.0, 4.0), jitter_from_stage=0,
                     min_track_views=3, jitter0=None, k10=0.0,
                     device="cuda"):
    """Bundle-adjust the turntable calibration against feature matches
    (va/vb (M,) views, ua/ub (M, 2) pixels, ka/kb (M,) keypoint slots, as
    build_matches returns them): multi-view tracks of at least
    `min_track_views` views, staged outlier gates, per-view jitter free
    from `jitter_from_stage`, a polish on the last gate's inliers. Returns
    the JAX package's result dict (numpy values)."""
    va, vb = np.asarray(matches["va"]), np.asarray(matches["vb"])
    ua, ub = np.asarray(matches["ua"]), np.asarray(matches["ub"])
    ka, kb = np.asarray(matches["ka"]), np.asarray(matches["kb"])
    poses_t = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    V = poses_t.shape[0]
    K = int(max(ka.max(initial=0), kb.max(initial=0))) + 1

    obs_track, obs_node = build_tracks(va, vb, ka, kb, V, K)
    uv_table = np.zeros((V * K, 2), np.float32)
    uv_table[va.astype(np.int64) * K + ka] = ua
    uv_table[vb.astype(np.int64) * K + kb] = ub
    n_obs = np.bincount(obs_track, minlength=obs_track.max() + 1 if
                        len(obs_track) else 1)
    keep = n_obs[obs_track] >= min_track_views
    if keep.sum() < 100 and len(obs_track):
        keep = n_obs[obs_track] >= 2        # fall back on sparse scenes
    obs_track, obs_node = obs_track[keep], obs_node[keep]
    _, obs_track = np.unique(obs_track, return_inverse=True)
    n_tracks = int(obs_track.max()) + 1 if len(obs_track) else 0
    if n_tracks == 0:
        raise ValueError("no multi-view tracks to bundle-adjust")
    obs_view = (obs_node // K).astype(np.int64)
    obs_uv = uv_table[obs_node]

    obs_track_t = torch.as_tensor(obs_track.astype(np.int64), device=device)
    obs_view_t = torch.as_tensor(obs_view, device=device)
    obs_uv_t = torch.as_tensor(obs_uv, device=device)

    p = torch.as_tensor(np.concatenate([
        np.asarray(theta0, np.float32), np.asarray([k10], np.float32),
        _jitter_vector(jitter0, V)]), device=device)
    p_prior = p
    names = list(THETA_NAMES) + ["k1"]
    glob = [names.index(n) for n in free]
    jit_idx = list(range(N_GLOBAL, N_GLOBAL + N_JITTER * V))
    prior_by_name = {"f": 1e-8, "dcx": 1e-3, "dcy": 1e-3, "dpan": 1.0,
                     "dtilt": 1.0, "roll": 1.0, "mx": 1.0, "my": 1.0,
                     "mz": 1.0, "k1": 1e3}

    def _stage_params(with_jitter):
        free_list = list(glob)
        reg_list = [prior_by_name[names[i]] for i in glob]
        if with_jitter:
            free_list += jit_idx
            reg_list += ([jitter_reg] * (2 * V)
                         + [4.0 * jitter_reg] * V)
        return (torch.as_tensor(free_list, dtype=torch.int64, device=device),
                torch.as_tensor(np.asarray(reg_list, np.float32),
                                device=device), len(free_list))

    w_obs = torch.ones(len(obs_track), dtype=torch.float32, device=device)
    W32, H32 = np.float32(width), np.float32(height)
    with stage("gn"):
        p, rms, w_obs = _lm_stages(
            p, p_prior, poses_t, obs_track_t, obs_view_t, obs_uv_t, w_obs,
            W32, H32, _stage_params, gate_px, iters, per_view,
            jitter_from_stage, n_tracks, device)

    pn = p.cpu().numpy()
    theta = pn[:9]
    return {
        "theta": {**{n: float(theta[i]) for i, n in enumerate(THETA_NAMES)},
                  "k1": float(pn[K1_IDX])},
        "theta_raw": theta,
        "k1": float(pn[K1_IDX]),
        "dpan_view": pn[N_GLOBAL:N_GLOBAL + V],
        "dtilt_view": pn[N_GLOBAL + V:N_GLOBAL + 2 * V],
        "droll_view": pn[N_GLOBAL + 2 * V:N_GLOBAL + 3 * V],
        "rms_px": float(rms),
        "n_matches": int(len(va)),
        "n_tracks": n_tracks,
        "n_obs": int(len(obs_track)),
        "n_inliers": int(w_obs.sum()),
    }


def _lm_stages(p, p_prior, poses, obs_track, obs_view, obs_uv, w_obs, W, H,
               stage_params, gate_px, iters, per_view, jitter_from_stage,
               n_tracks, device):
    """refine_turntable's staged LM loop: per gate, `iters` steps (the last
    gate half as many again, its inlier set fixed after `iters`), then the
    gate's inliers become the next stage's weights."""
    rms = np.inf
    slots = track_slots(obs_track, n_tracks)
    for stage, gate in enumerate(gate_px):
        free_idx, reg, n_free = stage_params(
            per_view and stage >= jitter_from_stage)
        n_iters = iters + (iters // 2 if stage == len(gate_px) - 1 else 0)
        lam = 1e-1
        for it in range(n_iters):
            p, rms, err = _gn_step(p, p_prior, poses, obs_track, obs_view,
                                   obs_uv, w_obs, W, H, free_idx, reg,
                                   torch.tensor(np.float32(lam),
                                                device=device),
                                   n_free, n_tracks=n_tracks, slots=slots)
            lam = max(lam * 0.6, 1e-4)
            if stage == len(gate_px) - 1 and it == iters - 1:
                w_obs = (err <= gate).to(torch.float32)
        w_obs = (err <= gate).to(torch.float32)
    return p, rms, w_obs


def iterative_refine(gray, kp_masks, theta0, poses, width, height, *,
                     rounds=2, k=512, strides=(1, 2, 4, 7, 12),
                     downsample=1, min_matches=50, estimate_k1=False,
                     f_starts=(1.0,),
                     schedule=((80.0, (60.0, 12.0, 4.0)),
                               (15.0, (8.0, 4.0, 2.5))),
                     _cache=None, device="cuda"):
    """Alternate matching and bundle adjustment: round 1 gates the raw
    matches with the silhouette calibration (once per `f_starts` focal
    multiplier; the start keeping the most final-gate inliers wins), each
    later round re-gates the cached raw matches with the refined cameras at
    a tighter gate and re-runs the BA from the previous solution. Returns
    the last refine_turntable result (with "f_start"), or None when no
    start yields enough matches. Pinhole unless `estimate_k1`."""
    if _cache is None:
        _cache = {}
    theta0 = np.asarray(theta0, np.float32)
    free = ("f", "dpan", "dtilt", "roll", "mx", "my")
    if estimate_k1:
        free = free + ("k1",)

    mgate, bgates = schedule[0]
    best = None
    for m in (f_starts or (1.0,)):
        th = theta0.copy()
        th[0] *= float(m)
        matches = build_matches(gray, kp_masks, th, poses, width, height,
                                k=k, strides=strides, gate_px=mgate,
                                downsample=downsample, _cache=_cache,
                                device=device)
        if len(matches["va"]) < min_matches:
            continue
        try:
            cand = refine_turntable(matches, poses, th, width, height,
                                    gate_px=bgates, free=free, device=device)
        except ValueError:          # no multi-view tracks at this gating
            continue
        if not np.isfinite(cand["rms_px"]):
            continue
        # per-start focal trust region (a GN spiralling f -> 0 on
        # near-planar feature sets must not win on inlier count)
        ratio = float(cand["theta_raw"][0]) / max(float(th[0]), 1e-6)
        if not (0.4 <= ratio <= 2.5):
            continue
        if best is None or cand["n_inliers"] > best[1]["n_inliers"]:
            best = (float(m), cand)
    if best is None:
        return None

    m_win, ba = best
    theta = ba["theta_raw"]
    jitter = (ba["dpan_view"], ba["dtilt_view"], ba["droll_view"])
    k1 = ba["k1"]
    for rnd in range(1, min(rounds, len(schedule))):
        mgate, bgates = schedule[rnd]
        matches = build_matches(gray, kp_masks, theta, poses, width, height,
                                k=k, strides=strides, gate_px=mgate,
                                downsample=downsample, jitter0=jitter,
                                k10=k1, _cache=_cache, device=device)
        if len(matches["va"]) < min_matches:
            break
        cand = refine_turntable(matches, poses, theta, width, height,
                                gate_px=bgates, jitter0=jitter, k10=k1,
                                free=free, device=device)
        ratio = float(cand["theta_raw"][0]) / max(float(theta[0]), 1e-6)
        if not np.isfinite(cand["rms_px"]) or not (0.4 <= ratio <= 2.5):
            break                   # keep the previous round's solution
        ba = cand
        theta = ba["theta_raw"]
        jitter = (ba["dpan_view"], ba["dtilt_view"], ba["droll_view"])
        k1 = ba["k1"]
    ba["f_start"] = m_win
    return ba


def _jitter_vector(jitter0, V):
    """Per-view delta groups -> flat (N_JITTER*V,) vector; accepts legacy
    2-tuples (dpan, dtilt) by zero-filling the roll group."""
    if jitter0 is None:
        return np.zeros(N_JITTER * V, np.float32)
    groups = [np.asarray(g, np.float32) for g in jitter0]
    while len(groups) < N_JITTER:
        groups.append(np.zeros(V, np.float32))
    return np.concatenate(groups).astype(np.float32)


def cameras_from_refined(res, poses, width, height):
    """Packed (V, 16) cameras (numpy) from a refine_turntable result."""
    poses_adj = np.asarray(poses, np.float32).copy()
    poses_adj[:, 3] += res["dpan_view"]
    poses_adj[:, 4] += res["dtilt_view"]
    droll = res.get("droll_view")
    return cnc_to_cameras(poses_adj, res["theta_raw"], float(width),
                          float(height), droll=droll).numpy()


# ----------------------------------------------------------------------
# end-to-end feature pipeline
# ----------------------------------------------------------------------

def detect(gray, masks, k=512, chunk=12):
    """Keypoints, scores and descriptors of every view, `chunk` views at a
    time: gray (V, H, W) float32 and masks (V, H, W) bool tensors (on the
    device that runs them). Returns (uv (V, k, 2), score (V, k), desc
    (V, k, 64)) on that device."""
    uv_l, score_l, desc_l = [], [], []
    for c0 in range(0, gray.shape[0], chunk):
        g = gray[c0:c0 + chunk].contiguous()
        m = masks[c0:c0 + chunk].contiguous()
        uv_c, score_c = harris_keypoints(g, m, k=k)
        desc_l.append(patch_descriptors(g, uv_c))
        uv_l.append(uv_c)
        score_l.append(score_c)
    return torch.cat(uv_l), torch.cat(score_l), torch.cat(desc_l)


def match_strides(uv, score, desc, strides, ratio=0.95):
    """Raw match columns (va, vb, ua, ub, ka, kb) over turntable strides:
    for each stride one batched mutual matching of every view a against
    view (a + s) % V, then the columns in (stride, a) order."""
    V = desc.shape[0]
    uv_np = uv.cpu().numpy()
    cols = {n: [] for n in ("va", "vb", "ua", "ub", "ka", "kb")}
    for s in strides:
        a_idx = np.array([a for a in range(V) if (a + s) % V != a])
        if not len(a_idx):
            continue
        b_idx = (a_idx + s) % V
        at = torch.as_tensor(a_idx, device=desc.device)
        bt = torch.as_tensor(b_idx, device=desc.device)
        idx_b, valid = match_mutual(desc[at], desc[bt], score[at], score[bt],
                                    ratio)
        idx_b, valid = idx_b.cpu().numpy(), valid.cpu().numpy()
        for i, (a, b) in enumerate(zip(a_idx, b_idx)):
            if not valid[i].any():
                continue
            ka = np.nonzero(valid[i])[0]
            kb = idx_b[i][ka]
            cols["va"].append(np.full(len(ka), a, np.int32))
            cols["vb"].append(np.full(len(ka), b, np.int32))
            cols["ua"].append(uv_np[a][ka])
            cols["ub"].append(uv_np[b][kb])
            cols["ka"].append(ka.astype(np.int32))
            cols["kb"].append(kb.astype(np.int32))
    if not cols["va"]:
        return {n: (np.zeros((0, 2), np.float32) if n in ("ua", "ub")
                    else np.zeros(0, np.int32)) for n in cols}
    out = {n: np.concatenate(v) for n, v in cols.items()}
    out["ua"] = out["ua"].astype(np.float32)
    out["ub"] = out["ub"].astype(np.float32)
    return out


def build_matches(gray, masks, theta0, poses, width, height, *,
                  k=512, strides=(1, 2, 4, 7), gate_px=80.0,
                  ratio=0.95, chunk=12, downsample=1, jitter0=None,
                  k10=0.0, _cache=None, device="cuda"):
    """Detect, describe and match keypoints across turntable strides.

    gray (V, H, W) float32 at FULL resolution (numpy or a tensor), masks
    restrict keypoints to the plant; detection optionally runs at
    1/`downsample` resolution (match coordinates are full-resolution
    pixels). Matches are pre-gated with the calibration `theta0` (+ per-view
    `jitter0`): midpoint triangulation must reproject within `gate_px`.
    Returns the match columns (va, vb, ua, ub, ka, kb); pass a dict as
    `_cache` to reuse detection and matching across gating rounds."""
    if _cache is not None and "raw" in _cache:
        out = dict(_cache["raw"])
        V = np.asarray(poses).shape[0]
        return _gate_matches(out, theta0, jitter0, poses, V, width, height,
                             gate_px, k10, device)
    gray = torch.as_tensor(gray, dtype=torch.float32, device=device)
    masks = torch.as_tensor(masks, device=device) != 0
    ds = int(downsample)
    if ds > 1:
        V0, H0, W0 = gray.shape
        Hc, Wc = (H0 // ds) * ds, (W0 // ds) * ds
        gray = gray[:, :Hc, :Wc].reshape(V0, Hc // ds, ds, Wc // ds, ds)
        gray = gray.mean(dim=(2, 4))
        masks = masks[:, :Hc, :Wc].reshape(V0, Hc // ds, ds, Wc // ds, ds)
        masks = masks.amax(dim=(2, 4))
    with stage("detect"):
        uv, score, desc = detect(gray, masks, k=k, chunk=chunk)
    if ds > 1:
        uv = (uv + 0.5) * ds - 0.5
    with stage("match"):
        out = match_strides(uv, score, desc, strides, ratio)
    if _cache is not None and len(out["va"]):
        _cache["raw"] = dict(out)
    return _gate_matches(out, theta0, jitter0, poses, gray.shape[0], width,
                         height, gate_px, k10, device)


def _gate_matches(out, theta0, jitter0, poses, V, width, height, gate_px,
                  k10=0.0, device="cuda"):
    """Geometric pre-gate of all matches in one batched call."""
    if not len(out["va"]):
        return out
    with stage("gate"):
        return _gate(out, theta0, jitter0, poses, V, width, height, gate_px,
                     k10, device)


def _gate(out, theta0, jitter0, poses, V, width, height, gate_px, k10,
          device):
    p0 = torch.as_tensor(np.concatenate([
        np.asarray(theta0, np.float32), np.asarray([k10], np.float32),
        _jitter_vector(jitter0, V)]), device=device)
    r = _residuals(
        p0, torch.as_tensor(np.asarray(poses, np.float32), device=device),
        torch.as_tensor(out["va"].astype(np.int64), device=device),
        torch.as_tensor(out["vb"].astype(np.int64), device=device),
        torch.as_tensor(out["ua"], device=device),
        torch.as_tensor(out["ub"], device=device),
        np.float32(width), np.float32(height)).cpu().numpy()
    keep = np.linalg.norm(r, axis=1) <= gate_px
    return {n: v[keep] for n, v in out.items()}
