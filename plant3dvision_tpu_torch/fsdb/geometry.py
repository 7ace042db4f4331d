"""Lightweight geometry containers.

The reference passes `open3d.geometry.PointCloud` / `TriangleMesh` objects
between layers (proc3d.py throughout). This framework is open3d-free: these
plain containers hold numpy arrays and are what fsdb.io reads/writes as PLY.
"""

from __future__ import annotations

import numpy as np


class PointCloud:
    def __init__(self, points=None, normals=None, colors=None):
        self.points = np.zeros((0, 3)) if points is None else np.asarray(points, dtype=np.float64)
        self.normals = None if normals is None else np.asarray(normals, dtype=np.float64)
        self.colors = None if colors is None else np.asarray(colors, dtype=np.float64)

    def has_normals(self) -> bool:
        return self.normals is not None and len(self.normals) == len(self.points)

    def has_colors(self) -> bool:
        return self.colors is not None and len(self.colors) == len(self.points)

    def __len__(self):
        return len(self.points)

    def __add__(self, other: "PointCloud") -> "PointCloud":
        points = np.concatenate([self.points, other.points], axis=0)

        def _cat(a, b, n_a, n_b, fill):
            if a is None and b is None:
                return None
            if a is None:
                a = np.full((n_a, 3), fill, dtype=np.float64)
            if b is None:
                b = np.full((n_b, 3), fill, dtype=np.float64)
            return np.concatenate([a, b], axis=0)

        normals = _cat(self.normals, other.normals, len(self), len(other), 0.0)
        colors = _cat(self.colors, other.colors, len(self), len(other), 0.5)
        return PointCloud(points, normals, colors)

    def normalize_normals(self):
        if self.normals is not None and len(self.normals):
            n = np.linalg.norm(self.normals, axis=1, keepdims=True)
            n[n == 0] = 1.0
            self.normals = self.normals / n
        return self

    def get_axis_aligned_bounding_box(self):
        return self.points.min(axis=0), self.points.max(axis=0)

    def transform(self, T: np.ndarray) -> "PointCloud":
        R, t = T[:3, :3], T[:3, 3]
        pts = self.points @ R.T + t
        nrm = None if self.normals is None else self.normals @ R.T
        return PointCloud(pts, nrm, self.colors)


class TriangleMesh:
    def __init__(self, vertices=None, triangles=None, vertex_colors=None):
        self.vertices = np.zeros((0, 3)) if vertices is None else np.asarray(vertices, dtype=np.float64)
        self.triangles = np.zeros((0, 3), dtype=np.int64) if triangles is None else np.asarray(triangles, dtype=np.int64)
        self.vertex_colors = None if vertex_colors is None else np.asarray(vertex_colors, dtype=np.float64)

    def __len__(self):
        return len(self.triangles)

    def surface_area(self) -> float:
        v = self.vertices
        t = self.triangles
        a = v[t[:, 1]] - v[t[:, 0]]
        b = v[t[:, 2]] - v[t[:, 0]]
        return float(0.5 * np.linalg.norm(np.cross(a, b), axis=1).sum())

    def volume(self) -> float:
        """Signed volume (divergence theorem over triangles)."""
        v = self.vertices
        t = self.triangles
        p0, p1, p2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
        return float(np.abs(np.einsum("ij,ij->i", p0, np.cross(p1, p2)).sum() / 6.0))

    def connected_components(self):
        """Label triangles by vertex-connected component.

        Returns (labels[num_triangles], counts) — equivalent role to open3d's
        cluster_connected_triangles used at reference tasks/proc3d.py:317-343.
        """
        import scipy.sparse as sp
        from scipy.sparse.csgraph import connected_components as cc

        nv = len(self.vertices)
        t = self.triangles
        if len(t) == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        rows = np.concatenate([t[:, 0], t[:, 1], t[:, 2]])
        cols = np.concatenate([t[:, 1], t[:, 2], t[:, 0]])
        adj = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(nv, nv))
        _, vlabel = cc(adj, directed=False)
        tlabel = vlabel[t[:, 0]]
        counts = np.bincount(tlabel)
        return tlabel, counts

    def largest_connected_component(self) -> "TriangleMesh":
        tlabel, counts = self.connected_components()
        if len(counts) == 0:
            return self
        keep = tlabel == np.argmax(counts)
        return self.select_triangles(keep)

    def select_triangles(self, mask) -> "TriangleMesh":
        tri = self.triangles[mask]
        used = np.unique(tri)
        remap = -np.ones(len(self.vertices), dtype=np.int64)
        remap[used] = np.arange(len(used))
        return TriangleMesh(
            self.vertices[used],
            remap[tri],
            None if self.vertex_colors is None else self.vertex_colors[used],
        )

    def sample_points_poisson_disk(self, n: int, seed: int = 0) -> PointCloud:
        """Blue-noise-ish surface sampling (role of o3d sample_points_poisson_disk,
        reference tasks/evaluation.py:133-195): oversample uniformly by area,
        then greedy thinning via grid binning."""
        rng = np.random.default_rng(seed)
        v, t = self.vertices, self.triangles
        a = v[t[:, 1]] - v[t[:, 0]]
        b = v[t[:, 2]] - v[t[:, 0]]
        areas = 0.5 * np.linalg.norm(np.cross(a, b), axis=1)
        if areas.sum() == 0 or len(t) == 0:
            return PointCloud()
        m = max(4 * n, 1000)
        idx = rng.choice(len(t), size=m, p=areas / areas.sum())
        r1 = np.sqrt(rng.random(m))[:, None]
        r2 = rng.random(m)[:, None]
        pts = (1 - r1) * v[t[idx, 0]] + r1 * (1 - r2) * v[t[idx, 1]] + r1 * r2 * v[t[idx, 2]]
        # thin to ~n by voxel binning at target density
        bbox = pts.max(0) - pts.min(0)
        cell = (np.prod(bbox[bbox > 0]) / max(n, 1)) ** (1.0 / max((bbox > 0).sum(), 1))
        if cell <= 0 or not np.isfinite(cell):
            sel = rng.choice(m, size=min(n, m), replace=False)
            return PointCloud(pts[sel])
        keys = np.floor((pts - pts.min(0)) / cell).astype(np.int64)
        _, first = np.unique(keys, axis=0, return_index=True)
        out = pts[np.sort(first)]
        if len(out) > n:
            out = out[rng.choice(len(out), size=n, replace=False)]
        return PointCloud(out)
