"""Visualization builders (port of plant3dvision_tpu/visu.py; role of
reference plant3dvision/visu.py).

Matplotlib-only, imported at the top as in the JAX module (the plotly
builders are in visu_plotly.py); every figure here saves to PNG for QC
artifacts.
"""

from __future__ import annotations

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def image_carousel_figure(images, path, n_cols=6, titles=None):
    """Grid of thumbnails (reference visu.py:16-67)."""
    n = len(images)
    n_rows = -(-n // n_cols)
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(2.2 * n_cols, 2.2 * n_rows))
    axes = np.atleast_1d(axes).ravel()
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            ax.imshow(images[i], cmap="gray" if images[i].ndim == 2 else None)
            if titles:
                ax.set_title(str(titles[i]), fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=90)
    plt.close(fig)


def volume_slice_figure(volume, path, axis=2, n_slices=12):
    """Slice viewer montage (reference visu.py:159-271)."""
    vol = np.asarray(volume)
    idxs = np.linspace(0, vol.shape[axis] - 1, n_slices).astype(int)
    fig, axes = plt.subplots(3, 4, figsize=(12, 9))
    for ax, i in zip(axes.ravel(), idxs):
        sl = np.take(vol, i, axis=axis)
        ax.imshow(sl.T, origin="lower", cmap="viridis")
        ax.set_title(f"slice {i}", fontsize=8)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=90)
    plt.close(fig)


def point_cloud_figure(pcd, path, subsample=50000, elev=20, azim=45):
    """3D scatter (reference visu.py:272-450 plotly pcd trace)."""
    pts = np.asarray(pcd.points if hasattr(pcd, "points") else pcd)
    if len(pts) > subsample:
        sel = np.random.default_rng(0).choice(len(pts), subsample, replace=False)
        pts = pts[sel]
    colors = None
    if hasattr(pcd, "colors") and pcd.colors is not None and len(pcd.colors):
        colors = pcd.colors
        if len(colors) > subsample and len(colors) != len(pts):
            colors = None
        elif len(colors) == len(pcd.points) and len(pts) != len(pcd.points):
            colors = pcd.colors[sel]
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5, c=colors)
    ax.view_init(elev=elev, azim=azim)
    _equal_aspect(ax, pts)
    fig.savefig(path, dpi=90)
    plt.close(fig)


def skeleton_figure(points, lines, path, tree=None):
    """Skeleton polylines in 3D (reference visu.py skeleton traces)."""
    points = np.asarray(points)
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for a, b in np.asarray(lines, dtype=int):
        seg = points[[a, b]]
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "g-", lw=1)
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=3, c="k")
    _equal_aspect(ax, points)
    fig.savefig(path, dpi=90)
    plt.close(fig)


def tree_graph_figure(tree, path):
    """Tree graph colored by organ labels."""
    import networkx as nx
    pts = np.array([tree.nodes[n]["position"] for n in tree.nodes])
    colors = []
    for n in tree.nodes:
        labels = tree.nodes[n]["labels"]
        colors.append("tab:green" if "stem" in labels
                      else "tab:orange" if "fruit" in labels else "tab:gray")
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    idx = {n: i for i, n in enumerate(tree.nodes)}
    for a, b in tree.edges:
        seg = pts[[idx[a], idx[b]]]
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "k-", lw=0.5)
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=6, c=colors)
    _equal_aspect(ax, pts)
    fig.savefig(path, dpi=90)
    plt.close(fig)


def sequences_figure(angles, internodes, path, gt_angles=None, gt_internodes=None):
    """Angle & internode sequences (reference visu.py sequence plots)."""
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 7))
    ax1.plot(angles, "o-", label="predicted")
    if gt_angles is not None:
        ax1.plot(gt_angles, "s--", label="ground truth")
    ax1.axhline(137.5, color="gray", ls=":", lw=0.8)
    ax1.set_ylabel("divergence angle (deg)")
    ax1.legend()
    ax2.plot(internodes, "o-", label="predicted")
    if gt_internodes is not None:
        ax2.plot(gt_internodes, "s--", label="ground truth")
    ax2.set_ylabel("internode (mm)")
    ax2.set_xlabel("organ index")
    ax2.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=90)
    plt.close(fig)


def alignment_figure(pairs, path):
    """DTW alignment visualization (reference tasks/evaluation.py:720-725)."""
    fig, ax = plt.subplots(figsize=(10, 5))
    for k, p in enumerate(pairs):
        ax.plot([k, k], [p["pred_angle"], p["gt_angle"]], "k-", lw=0.5)
    ax.plot([p["pred_angle"] for p in pairs], "o-", label="predicted")
    ax.plot([p["gt_angle"] for p in pairs], "s--", label="ground truth")
    ax.set_xlabel("aligned pair")
    ax.set_ylabel("angle (deg)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=90)
    plt.close(fig)


def _equal_aspect(ax, pts):
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    c = (lo + hi) / 2
    r = (hi - lo).max() / 2 or 1.0
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
