"""Angles/internodes from a labelled (segmented) point cloud — the ML
pipeline's trait path (reference arabidopsis.py:379-506: stem skeleton by
sliding centroid, organ oriented-bbox direction, projection onto the plane
orthogonal to the local stem axis). A copy of
plant3dvision_tpu/traits/organs.py."""

from __future__ import annotations

import numpy as np

from ..fsdb.geometry import PointCloud


def stem_skeleton_from_pcd(stem_points, stem_axis=2, stem_axis_inverted=False,
                           node_spacing=2.0):
    """Ordered stem polyline: sliding centroid of points binned along the
    stem axis."""
    pts = np.asarray(stem_points)
    order = np.argsort(pts[:, stem_axis])
    if stem_axis_inverted:
        order = order[::-1]
    pts = pts[order]
    lo, hi = pts[0, stem_axis], pts[-1, stem_axis]
    n_bins = max(int(abs(hi - lo) / node_spacing), 2)
    edges = np.linspace(min(lo, hi), max(lo, hi), n_bins + 1)
    idx = np.clip(np.digitize(pts[:, stem_axis], edges) - 1, 0, n_bins - 1)
    nodes = []
    for b in range(n_bins):
        sel = idx == b
        if sel.sum() > 0:
            nodes.append(pts[sel].mean(axis=0))
    nodes = np.asarray(nodes)
    if stem_axis_inverted:
        nodes = nodes[::-1]
    return nodes


def organ_features(organ_points, stem_skeleton):
    """PCA oriented-box direction + attachment node
    (reference get_organ_features, arabidopsis.py:329-376: direction between
    the middles of the two smallest box faces; node = skeleton point nearest
    the closer face)."""
    pts = np.asarray(organ_points)
    c = pts.mean(axis=0)
    x = pts - c
    cov = x.T @ x / max(len(x), 1)
    w, v = np.linalg.eigh(cov)
    main = v[:, np.argmax(w)]
    proj = x @ main
    lo, hi = proj.min(), proj.max()
    end_a = c + main * lo   # middle of one end face
    end_b = c + main * hi
    length = float(hi - lo)
    widths = np.sqrt(np.sort(w)[::-1]) * 2
    elongation = widths[0] / max(widths[1], 1e-9)

    d_a = np.linalg.norm(stem_skeleton - end_a, axis=1)
    d_b = np.linalg.norm(stem_skeleton - end_b, axis=1)
    if d_a.min() <= d_b.min():
        node_id = int(np.argmin(d_a))
        direction = end_b - end_a
        base = end_a
    else:
        node_id = int(np.argmin(d_b))
        direction = end_a - end_b
        base = end_b
    n = np.linalg.norm(direction)
    return {
        "node_id": node_id,
        "direction": direction / max(n, 1e-12),
        "base": base,
        "length": length,
        "elongation": elongation,
    }


def angles_and_internodes_from_point_cloud(stem_pcd, organ_pcd_list,
                                           characteristic_length=1.0,
                                           stem_axis=2,
                                           stem_axis_inverted=False,
                                           min_elongation_ratio=2.0,
                                           min_fruit_size=6.0):
    """Divergence angles + internodes from stem + organ point clouds."""
    stem_pts = (stem_pcd.points if isinstance(stem_pcd, PointCloud)
                else np.asarray(stem_pcd))
    skel = stem_skeleton_from_pcd(stem_pts, stem_axis, stem_axis_inverted,
                                  node_spacing=2.0 * characteristic_length)

    feats = []
    for organ in organ_pcd_list:
        pts = organ.points if isinstance(organ, PointCloud) else np.asarray(organ)
        if len(pts) < 4:
            continue
        f = organ_features(pts, skel)
        if f["elongation"] < min_elongation_ratio or f["length"] < min_fruit_size:
            continue
        feats.append(f)

    if len(feats) < 2:
        return {"angles": [], "internodes": [], "fruit_points": []}

    feats.sort(key=lambda f: f["node_id"])

    # local stem direction at each node
    def stem_dir_at(i):
        a = max(i - 1, 0)
        b = min(i + 1, len(skel) - 1)
        d = skel[b] - skel[a]
        return d / max(np.linalg.norm(d), 1e-12)

    angles, internodes = [], []
    for prev, cur in zip(feats[:-1], feats[1:]):
        sd = stem_dir_at(cur["node_id"])
        # project organ directions onto the plane orthogonal to the stem
        def perp(d):
            p = d - np.dot(d, sd) * sd
            return p / max(np.linalg.norm(p), 1e-12)
        u, w = perp(prev["direction"]), perp(cur["direction"])
        cosang = np.clip(np.dot(u, w), -1.0, 1.0)
        ang = np.arccos(cosang)
        if np.dot(np.cross(u, w), sd) < 0:
            ang = 2 * np.pi - ang
        angles.append(float(np.degrees(ang)))
        # internode = skeleton path length between the nodes
        i0, i1 = sorted((prev["node_id"], cur["node_id"]))
        seg = skel[i0:i1 + 1]
        internodes.append(float(np.linalg.norm(np.diff(seg, axis=0), axis=1).sum()))

    return {"angles": angles, "internodes": internodes,
            "fruit_points": [f["base"].tolist() for f in feats]}
