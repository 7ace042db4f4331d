"""Sequence alignment and the synthetic cylinder (port of
plant3dvision_tpu/evaluation.py: the DTW alignment of angle/internode
sequences and what it calls, the cylinder's point cloud and its PCA
radius; numpy only).

Role of reference plant3dvision/evaluation.py + the `dtw` submodule
(align_sequences with 'merge_split' constraint, mixed angular/linear
distance, free endpoints — reference evaluation.py:107-162).

The merge_split constraint encodes the phenotyping failure modes: a missed
organ in one sequence merges two successive divergence angles (their SUM,
mod 360) and sums the internodes; a spurious organ splits them.
"""

from __future__ import annotations

import numpy as np


def angular_dist_deg(a, b):
    """Circular distance in degrees, in [0, 180]."""
    d = np.abs(np.asarray(a) - np.asarray(b)) % 360.0
    return np.minimum(d, 360.0 - d)


def mixed_dist(x, y, spread=1.0, weights=(0.5, 0.5)):
    """Distance between (angle_deg, internode) pairs
    (reference dtw mixed_dist semantics: normalized angular + normalized
    linear parts, weighted)."""
    a = angular_dist_deg(x[0], y[0]) / 180.0
    i = abs(x[1] - y[1]) / max(spread, 1e-9)
    return weights[0] * a + weights[1] * i


def dtw_merge_split(pred, gt, max_group=3, spread=None, weights=(0.5, 0.5),
                    free_ends=0):
    """DP alignment of two (angle, internode) sequences.

    Steps: 1-1 match, 1-k split (one pred covers k gt entries whose angles
    sum mod 360), k-1 merge. Free endpoints: up to `free_ends` elements may
    be skipped at each end of each sequence for free.

    Returns dict(cost, normalized_cost, path) where path is a list of
    (pred_indices, gt_indices) groups.
    """
    pred = np.asarray(pred, dtype=float)   # (N, 2)
    gt = np.asarray(gt, dtype=float)       # (M, 2)
    N, M = len(pred), len(gt)
    if spread is None:
        allv = np.concatenate([pred[:, 1], gt[:, 1]]) if N + M else np.array([1.0])
        spread = max(float(np.max(allv)), 1e-9)

    def group(seq, i0, i1):
        """Aggregate seq[i0:i1] -> (sum angle mod 360, sum internode)."""
        a = seq[i0:i1, 0].sum() % 360.0
        d = seq[i0:i1, 1].sum()
        return (a, d)

    INF = 1e18
    D = np.full((N + 1, M + 1), INF)
    steps = {}
    D[0, 0] = 0.0
    for i in range(min(free_ends, N) + 1):
        D[i, 0] = 0.0
    for j in range(min(free_ends, M) + 1):
        D[0, j] = 0.0

    for i in range(1, N + 1):
        for j in range(1, M + 1):
            best = D[i - 1, j - 1] + mixed_dist(pred[i - 1], gt[j - 1],
                                                spread, weights)
            bstep = (1, 1)
            for k in range(2, max_group + 1):
                if j - k >= 0:  # split: 1 pred ~ k gt
                    c = D[i - 1, j - k] + mixed_dist(
                        pred[i - 1], group(gt, j - k, j), spread, weights)
                    if c < best:
                        best, bstep = c, (1, k)
                if i - k >= 0:  # merge: k pred ~ 1 gt
                    c = D[i - k, j - 1] + mixed_dist(
                        group(pred, i - k, i), gt[j - 1], spread, weights)
                    if c < best:
                        best, bstep = c, (k, 1)
            D[i, j] = best
            steps[(i, j)] = bstep

    # free end: min over the last free_ends cells of row N / col M
    fe = free_ends
    candidates = [(D[N, M], (N, M))]
    for i in range(max(N - fe, 0), N + 1):
        candidates.append((D[i, M], (i, M)))
    for j in range(max(M - fe, 0), M + 1):
        candidates.append((D[N, j], (N, j)))
    cost, (ei, ej) = min(candidates, key=lambda c: c[0])

    # backtrack
    path = []
    i, j = ei, ej
    while i > 0 and j > 0 and (i, j) in steps and D[i, j] < INF:
        if D[i, j] == 0.0 and (i <= fe or j <= fe):
            break
        ki, kj = steps[(i, j)]
        path.append((list(range(i - ki, i)), list(range(j - kj, j))))
        i, j = i - ki, j - kj
    path.reverse()
    n_steps = max(len(path), 1)
    return {"cost": float(cost), "normalized_cost": float(cost) / n_steps,
            "path": path, "end": (ei, ej)}


def align_sequences(pred_angles, pred_internodes, gt_angles, gt_internodes,
                    free_ends=0.4, free_ends_eps=1e-2, max_group=3):
    """Reference evaluation.py:107-162: DTW with merge_split + brute-force
    free-ends budget (fraction of sequence length).

    Angles in DEGREES. Returns the best alignment dict + per-pair deltas.
    """
    pred = np.stack([np.asarray(pred_angles, float),
                     np.asarray(pred_internodes, float)], axis=1)
    gt = np.stack([np.asarray(gt_angles, float),
                   np.asarray(gt_internodes, float)], axis=1)
    if isinstance(free_ends, (tuple, list)):
        fe_budget = int(max(free_ends))
    else:
        fe_budget = int(np.ceil(float(free_ends) * min(len(pred), len(gt))))

    best = None
    for fe in range(fe_budget + 1):
        res = dtw_merge_split(pred, gt, max_group=max_group, free_ends=fe)
        score = res["normalized_cost"] + free_ends_eps * fe
        if best is None or score < best[0]:
            best = (score, fe, res)
    _, fe, res = best

    pairs = []
    for pi, gi in res["path"]:
        pa = pred[pi, 0].sum() % 360.0
        ga = gt[gi, 0].sum() % 360.0
        pairs.append({
            "pred_idx": pi, "gt_idx": gi,
            "pred_angle": float(pa), "gt_angle": float(ga),
            "angle_error": float(angular_dist_deg(pa, ga)),
            "pred_internode": float(pred[pi, 1].sum()),
            "gt_internode": float(gt[gi, 1].sum()),
        })
    angle_errors = [p["angle_error"] for p in pairs]
    internode_errors = [abs(p["pred_internode"] - p["gt_internode"]) for p in pairs]
    return {
        "free_ends": fe,
        "cost": res["cost"],
        "normalized_cost": res["normalized_cost"],
        "pairs": pairs,
        "mean_angle_error": float(np.mean(angle_errors)) if pairs else None,
        "mean_internode_error": float(np.mean(internode_errors)) if pairs else None,
    }


# -- synthetic cylinder (reference evaluation.py:8-104) --------------------

def make_cylinder_pcd(radius=10.0, height=40.0, n_points=10000, noise=0.0,
                      seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n_points)
    z = rng.uniform(0, height, n_points)
    r = radius + noise * rng.standard_normal(n_points)
    pts = np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1)
    from .fsdb.geometry import PointCloud
    return PointCloud(pts)


def estimate_cylinder_radius(points):
    """PCA + mean radial distance (reference evaluation.py:50-104).

    The circle plane is the eigen-pair with the CLOSEST eigenvalues (the
    two radial directions share the same variance r^2/2) — not the two
    smallest: a squat cylinder (height < radius) has its axis on the
    SMALLEST eigenvalue (reference `_find_two_closest`,
    evaluation.py:95-106)."""
    pts = np.asarray(points.points if hasattr(points, "points") else points)
    c = pts.mean(axis=0)
    x = pts - c
    cov = x.T @ x / len(x)
    w, v = np.linalg.eigh(cov)
    pairs = [(0, 1), (0, 2), (1, 2)]
    i, j = min(pairs, key=lambda p: abs(w[p[0]] - w[p[1]]))
    radial = x @ v[:, [i, j]]
    return float(np.linalg.norm(radial, axis=1).mean())
