"""Synthetic ground-truth scan generator.

Role of the reference's VirtualPlant/blender virtual scanner (testdata
virtual_plant scan: exact per-image 'camera' metadata + ground-truth angle
metadata on a VirtualPlant fileset). Generates:

- a procedural arabidopsis-like plant (capsule union): vertical stem +
  fruits at known divergence angles and internode spacings;
- a turntable scan of binary masks rendered by analytic capsule splatting,
  with EXACT camera metadata in the reference's on-disk format — so the
  whole geometric pipeline can run without COLMAP (geom_pipe_virtual mode);
- ground-truth 'angles' (radians) / 'internodes' metadata on a
  VirtualPlant fileset, plus measures.json, for evaluation tasks.

Used by the port's tests and chip_smoke.py. (The photo-domain scans of the
ML path are in synth_photo.py.)
"""

from __future__ import annotations

import numpy as np

from .camera import camera_model_to_metadata, pose_to_extrinsics
from .fsdb.geometry import TriangleMesh


class SyntheticPlant:
    """Capsule-union plant model with known phyllotaxis."""

    def __init__(self, n_fruits=15, divergence_deg=137.5, internode=5.0,
                 stem_height=None, stem_radius=1.5, fruit_length=25.0,
                 fruit_radius=1.0, fruit_elevation_deg=48.0, first_node=20.0,
                 jitter_deg=0.0, seed=0):
        rng = np.random.default_rng(seed)
        if stem_height is None:
            # the stem apex must be geodesically farther from the root than
            # any fruit tip (the tree-graph main-stem rule assumes it)
            stem_height = first_node + (n_fruits - 1) * internode + fruit_length + 15.0
        self.capsules = []  # (A(3,), B(3,), radius)
        self.capsules.append((np.array([0.0, 0, 0]),
                              np.array([0.0, 0, stem_height]), stem_radius))
        angles_deg = divergence_deg + jitter_deg * rng.standard_normal(n_fruits - 1)
        azim = np.concatenate([[0.0], np.cumsum(np.deg2rad(angles_deg))])
        self.gt_angles = np.deg2rad(angles_deg)          # radians, like measures.json
        self.gt_internodes = np.full(n_fruits - 1, internode, dtype=float)
        self.bp_z = first_node + internode * np.arange(n_fruits)
        el = np.deg2rad(fruit_elevation_deg)
        for i in range(n_fruits):
            a = azim[i]
            base = np.array([0.0, 0.0, self.bp_z[i]])
            d = np.array([np.cos(a) * np.cos(el), np.sin(a) * np.cos(el), np.sin(el)])
            self.capsules.append((base, base + fruit_length * d, fruit_radius))

    def surface_samples(self, step=0.5):
        """Dense (point, radius) samples along every capsule axis."""
        pts, rads = [], []
        for a, b, r in self.capsules:
            n = max(int(np.ceil(np.linalg.norm(b - a) / step)) + 1, 2)
            t = np.linspace(0, 1, n)[:, None]
            pts.append(a[None, :] * (1 - t) + b[None, :] * t)
            rads.append(np.full(n, r))
        return np.concatenate(pts), np.concatenate(rads)

    def contains(self, points, margin=0.0):
        """Boolean: inside the capsule union (within radius+margin)."""
        points = np.asarray(points)
        inside = np.zeros(len(points), dtype=bool)
        for a, b, r in self.capsules:
            ab = b - a
            t = np.clip(((points - a) @ ab) / (ab @ ab), 0.0, 1.0)
            closest = a[None, :] + t[:, None] * ab[None, :]
            inside |= np.linalg.norm(points - closest, axis=1) <= r + margin
        return inside

    def to_mesh(self, n_seg=12) -> TriangleMesh:
        """Coarse tube mesh (for VirtualPlant OBJ ground truth)."""
        verts, tris = [], []
        for a, b, r in self.capsules:
            axis = b - a
            L = np.linalg.norm(axis)
            z = axis / L
            x = np.cross(z, [0, 0, 1.0])
            if np.linalg.norm(x) < 1e-6:
                x = np.cross(z, [0, 1.0, 0])
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            base = len(verts)
            for end, center in enumerate((a, b)):
                for s in range(n_seg):
                    th = 2 * np.pi * s / n_seg
                    verts.append(center + r * (np.cos(th) * x + np.sin(th) * y))
            for s in range(n_seg):
                s2 = (s + 1) % n_seg
                tris.append([base + s, base + s2, base + n_seg + s])
                tris.append([base + s2, base + n_seg + s2, base + n_seg + s])
        return TriangleMesh(np.array(verts), np.array(tris))


def render_mask(plant: SyntheticPlant, K, R, t, width, height, step=0.25):
    """Binary silhouette by splatting dense capsule samples as image disks.

    Conservative-approximate silhouette: union of projected sample disks;
    sampling step << radius keeps the boundary error well under a pixel at
    the scales used in tests/bench.
    """
    pts, rads = plant.surface_samples(step=step)
    cam = pts @ np.asarray(R).T + np.asarray(t)[None, :]
    z = cam[:, 2]
    ok = z > 1e-6
    K = np.asarray(K)
    px = cam[ok, 0] / z[ok] * K[0, 0] + K[0, 2]
    py = cam[ok, 1] / z[ok] * K[1, 1] + K[1, 2]
    pr = rads[ok] * K[0, 0] / z[ok]
    mask = np.zeros((height, width), dtype=np.uint8)
    for x, y, r in zip(px, py, pr):
        x0, x1 = int(np.floor(x - r)), int(np.ceil(x + r)) + 1
        y0, y1 = int(np.floor(y - r)), int(np.ceil(y + r)) + 1
        if x1 < 0 or y1 < 0 or x0 >= width or y0 >= height:
            continue
        x0, x1 = max(x0, 0), min(x1, width)
        y0, y1 = max(y0, 0), min(y1, height)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        mask[y0:y1, x0:x1] |= ((xx - x) ** 2 + (yy - y) ** 2 <= r * r)
    return mask * 255


def turntable_cameras(n_views, dist=350.0, z=60.0, target=(0, 0, 45.0),
                      f=1100.0, width=896, height=896):
    """Exact camera ring: returns list of (K, R, t) looking at the plant."""
    K = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1.0]])
    cams = []
    for v in range(n_views):
        a = 2 * np.pi * v / n_views
        c = np.array([dist * np.cos(a), dist * np.sin(a), z])
        R, t = pose_to_extrinsics(c, target)
        cams.append((K, R, t))
    return cams


def generate_scan(db, scan_id="synthetic", n_views=36, width=448, height=448,
                  f=550.0, plant: SyntheticPlant | None = None,
                  workspace_margin=15.0, invert=False, render_step=0.25):
    """Write a full synthetic scan into `db` in the reference's on-disk
    format: images fileset of binary masks with exact 'camera' metadata,
    scan 'bounding_box', VirtualPlant GT fileset, measures.json."""
    from .fsdb import io

    plant = plant or SyntheticPlant()
    scan = db.get_scan(scan_id, create=True)
    images = scan.get_fileset("images", create=True)

    # bounding box around the plant
    pts, rads = plant.surface_samples(step=1.0)
    lo = pts.min(axis=0) - rads.max() - workspace_margin
    hi = pts.max(axis=0) + rads.max() + workspace_margin
    bbox = {"x": [float(lo[0]), float(hi[0])],
            "y": [float(lo[1]), float(hi[1])],
            "z": [float(lo[2]), float(hi[2])]}
    scan.set_metadata("bounding_box", bbox)
    images.set_metadata("bounding_box", bbox)

    # frame the plant: distance ~2.5x its bounding extent
    extent = float(np.max(hi - lo))
    cams = turntable_cameras(n_views, dist=2.5 * extent,
                             z=float(hi[2]) * 0.7,
                             target=(0, 0, float(lo[2] + hi[2]) / 2),
                             f=f, width=width, height=height)
    for v, (K, R, t) in enumerate(cams):
        mask = render_mask(plant, K, R, t, width, height, step=render_step)
        if invert:
            mask = 255 - mask
        fimg = images.create_file(f"{v:05d}_rgb")
        io.write_image(fimg, mask, "png")
        fimg.set_metadata({
            "shot_id": f"{v:06d}",
            "channel": "rgb",
            "camera": {
                "camera_model": camera_model_to_metadata(
                    "OPENCV", [K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0, 0, 0, 0],
                    width, height),
                "rotmat": np.asarray(R).tolist(),
                "tvec": np.asarray(t).tolist(),
            },
        })

    # ground-truth fileset (role of VirtualPlantObj output)
    vp = scan.get_fileset("VirtualPlant_synthetic", create=True)
    obj = vp.create_file("VirtualPlant")
    mesh = plant.to_mesh()
    io.write_triangle_mesh(obj, mesh)
    obj.set_metadata({
        "angles": plant.gt_angles.tolist(),          # radians
        "internodes": plant.gt_internodes.tolist(),
    })

    # measures.json (manual-measure format, radians)
    import json
    with open(scan.path() / "measures.json", "w") as fh:
        json.dump({"angles": plant.gt_angles.tolist(),
                   "internodes": plant.gt_internodes.tolist()}, fh, indent=4)
    return scan
