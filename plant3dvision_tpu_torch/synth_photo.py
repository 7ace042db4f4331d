"""Photo-domain synthetic scan renderer for CNN training.

The reference's ML route runs a ResNet UNet trained on Blender renders of
L-system arabidopsis plants (romiseg role, reference tasks/proc2d.py:328-393;
the shipped virtual_plant fixture is such a render set: flat olive-green
shaded organs on a black background with per-organ visibility channels).
This module reproduces that visual domain WITHOUT Blender so the
segmentation CNN can be trained in-repo:

- surface SAMPLING of labeled geometry (per-material ground-truth OBJ
  meshes and/or procedural plants) into (points, normals, label) sets;
- a vectorized painter's-algorithm SPLAT renderer: project all samples,
  sort far-to-near, splat 2x2 at 2x supersampling, downsample — correct
  occlusion with no Python per-primitive loop (z-buffer rasterization is
  a GPU idiom; depth-sorted scatter is the numpy/TPU-friendly form);
- Lambertian-ish shading with per-render light/color jitter matched to
  the fixture's statistics (r/g 0.85, b/g 0.30, g in [15, 160]);
- `generate_photo_scan`: a full on-disk scan in the reference format
  (rgb + per-organ channels + exact camera metadata + GT angles), i.e.
  a stand-in for the fixture's Blender virtual scanner.

Port of plant3dvision_tpu/synth_photo.py (numpy; a copy over the port's
camera, fsdb and io). Used by the port's ML-path tests and chip_smoke.py.
"""

from __future__ import annotations

import numpy as np

from .camera import camera_model_to_metadata, pose_to_extrinsics

# visual style matched to the virtual_plant fixture renders
STYLE = {
    "g_base": 150.0,          # green level of a fully lit surface
    "rg": 0.85, "bg": 0.30,   # fixture channel ratios
    "ambient": 0.22,
    "noise_sigma": 1.5,
    "label_gain": {"leaf": 1.15, "stem": 0.95, "pedicel": 0.95,
                   "fruit": 0.9, "flower": 1.3},
}

ML_LABELS = ["background", "flower", "fruit", "leaf", "pedicel", "stem"]


# ---------------------------------------------------------------- sampling

def sample_mesh_surface(vertices, triangles, density, rng):
    """Area-weighted random surface samples: (points (N,3), normals (N,3)).

    `density` = samples per squared world unit."""
    v = np.asarray(vertices, float)
    t = np.asarray(triangles, np.int64)
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    cr = np.cross(b - a, c - a)
    area2 = np.linalg.norm(cr, axis=1)
    total = 0.5 * float(area2.sum())
    n = max(int(total * density), len(t))
    probs = area2 / max(area2.sum(), 1e-12)
    pick = rng.choice(len(t), size=n, p=probs)
    u = rng.random(n)
    w = rng.random(n)
    flip = u + w > 1
    u[flip], w[flip] = 1 - u[flip], 1 - w[flip]
    pts = (a[pick] + u[:, None] * (b[pick] - a[pick])
           + w[:, None] * (c[pick] - a[pick]))
    nrm = cr[pick] / np.maximum(area2[pick], 1e-12)[:, None]
    return pts, nrm


def sample_capsule_surface(a, b, r, density, rng):
    """Samples on a capsule's lateral surface + end caps."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    axis = b - a
    L = float(np.linalg.norm(axis))
    z = axis / max(L, 1e-9)
    x = np.cross(z, [0.0, 0.0, 1.0])
    if np.linalg.norm(x) < 1e-6:
        x = np.cross(z, [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    area = 2 * np.pi * r * L + 4 * np.pi * r * r
    n = max(int(area * density), 32)
    n_side = int(n * (2 * np.pi * r * L) / max(area, 1e-9))
    t = rng.random(n_side)
    th = rng.random(n_side) * 2 * np.pi
    radial = np.cos(th)[:, None] * x + np.sin(th)[:, None] * y
    pts = a + t[:, None] * axis + r * radial
    nrm = radial
    # caps: uniform sphere points split to both ends
    n_cap = n - n_side
    d = rng.standard_normal((n_cap, 3))
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    up = d @ z > 0
    cap_pts = np.where(up[:, None], b, a) + r * d
    pts = np.concatenate([pts, cap_pts])
    nrm = np.concatenate([nrm, d])
    return pts, nrm


def leaf_blade_mesh(base, azimuth, length, width, droop=0.35, lift=0.15,
                    n_seg=10):
    """Procedural rosette leaf: elliptic blade along `azimuth`, drooping at
    the tip, as a (vertices, triangles) fan. Mimics the fixture rosette."""
    d = np.array([np.cos(azimuth), np.sin(azimuth), 0.0])
    side = np.array([-np.sin(azimuth), np.cos(azimuth), 0.0])
    ts = np.linspace(0.0, 1.0, n_seg)
    verts = []
    for t in ts:
        half = width * 0.5 * np.sin(np.pi * np.clip(t, 0.03, 0.97)) ** 0.8
        z = lift * length * t - droop * length * t * t
        center = base + d * (length * t) + np.array([0, 0, z])
        verts.append(center - side * half)
        verts.append(center + side * half)
    verts = np.asarray(verts)
    tris = []
    for i in range(n_seg - 1):
        a0, b0, a1, b1 = 2 * i, 2 * i + 1, 2 * i + 2, 2 * i + 3
        tris.append([a0, b0, a1])
        tris.append([b0, b1, a1])
    return verts, np.asarray(tris, np.int64)


class ProceduralArabidopsis:
    """Fixture-morphology procedural plant: wandering thin stem, pedicel +
    silique (fruit) organs at known divergence angles, rosette leaves.

    Exposes labeled surface samples for `render_photo` plus the ground
    truth angles/internodes (radians) used by the evaluation tasks."""

    def __init__(self, n_fruits=30, divergence_deg=137.5, jitter_deg=12.0,
                 internode=2.8, internode_jitter=0.35, first_node=18.0,
                 stem_radius=0.22, pedicel_len=(2.0, 4.5),
                 fruit_len=(3.5, 9.0), fruit_radius=0.3,
                 elevation_deg=(35.0, 65.0), n_leaves=8,
                 leaf_len=(6.0, 14.0), stem_wander=0.35, seed=0):
        rng = np.random.default_rng(seed)
        self.rng = rng
        inter = internode * np.maximum(
            1.0 + internode_jitter * rng.standard_normal(n_fruits - 1), 0.2)
        self.gt_internodes = inter
        ang = np.deg2rad(divergence_deg + jitter_deg * rng.standard_normal(n_fruits - 1))
        self.gt_angles = ang
        azim = np.concatenate([[rng.random() * 2 * np.pi], ang]).cumsum()
        node_z = first_node + np.concatenate([[0.0], np.cumsum(inter)])
        top = node_z[-1] + 8.0

        # wandering stem polyline (the fixture stem is visibly curved)
        zs = np.linspace(0.0, top, 40)
        walk = np.cumsum(rng.standard_normal((40, 2)) * stem_wander, axis=0)
        walk -= zs[:, None] / top * walk[-1] * 0.5     # keep roughly vertical
        self.stem_pts = np.column_stack([walk, zs])
        self.stem_radius = stem_radius

        def stem_at(z):
            i = np.searchsorted(zs, z).clip(1, len(zs) - 1)
            t = (z - zs[i - 1]) / (zs[i] - zs[i - 1])
            return self.stem_pts[i - 1] + t * (self.stem_pts[i] - self.stem_pts[i - 1])

        self.pedicels = []   # (a, b, r)
        self.fruits = []
        self.fruit_bases = []
        for i in range(n_fruits):
            a = azim[i]
            el = np.deg2rad(rng.uniform(*elevation_deg))
            d = np.array([np.cos(a) * np.cos(el), np.sin(a) * np.cos(el),
                          np.sin(el)])
            base = stem_at(node_z[i])
            pl = rng.uniform(*pedicel_len)
            fl = rng.uniform(*fruit_len)
            mid = base + pl * d
            # silique bends slightly up from the pedicel direction
            d2 = d + np.array([0, 0, rng.uniform(0.0, 0.35)])
            d2 /= np.linalg.norm(d2)
            self.pedicels.append((base, mid, stem_radius * 0.6))
            self.fruits.append((mid, mid + fl * d2, fruit_radius))
            self.fruit_bases.append(base)

        self.leaves = []
        for _ in range(n_leaves):
            az = rng.random() * 2 * np.pi
            L = rng.uniform(*leaf_len)
            self.leaves.append(leaf_blade_mesh(
                stem_at(rng.uniform(0, 2.0)), az, L, width=L * rng.uniform(0.3, 0.5),
                droop=rng.uniform(0.2, 0.5), lift=rng.uniform(0.05, 0.3)))

    def labeled_samples(self, density=150.0):
        """{label: (points, normals)} surface samples."""
        rng = self.rng
        out = {}
        stem = []
        for i in range(len(self.stem_pts) - 1):
            stem.append(sample_capsule_surface(
                self.stem_pts[i], self.stem_pts[i + 1], self.stem_radius,
                density, rng))
        out["stem"] = (np.concatenate([s[0] for s in stem]),
                       np.concatenate([s[1] for s in stem]))
        for label, caps in (("pedicel", self.pedicels), ("fruit", self.fruits)):
            ps, ns = [], []
            for a, b, r in caps:
                p, n = sample_capsule_surface(a, b, r, density, rng)
                ps.append(p)
                ns.append(n)
            out[label] = (np.concatenate(ps), np.concatenate(ns))
        if self.leaves:
            ps, ns = [], []
            for verts, tris in self.leaves:
                p, n = sample_mesh_surface(verts, tris, density, rng)
                ps.append(p)
                ns.append(n)
            out["leaf"] = (np.concatenate(ps), np.concatenate(ns))
        return out

    def bounding_box(self, margin=8.0):
        pts = np.concatenate([self.stem_pts]
                             + [np.array([a, b]) for a, b, _ in self.pedicels]
                             + [np.array([a, b]) for a, b, _ in self.fruits]
                             + [v for v, _ in self.leaves])
        lo, hi = pts.min(0) - margin, pts.max(0) + margin
        return {"x": [float(lo[0]), float(hi[0])],
                "y": [float(lo[1]), float(hi[1])],
                "z": [float(lo[2]), float(hi[2])]}


def obj_labeled_samples(obj_path, density=150.0, seed=0, lpy_axes=True):
    """Labeled surface samples from a per-material ground-truth OBJ (the
    virtual_plant fixture's own L-system mesh, materials = organ labels;
    reference tasks/evaluation.py:96-98). `lpy_axes` applies the lpy ->
    scanner frame swap used across the evaluation tasks."""
    from .fsdb.io import read_obj_materials
    rng = np.random.default_rng(seed)
    out = {}
    for mtl, mesh in read_obj_materials(obj_path).items():
        v = mesh.vertices
        if lpy_axes:
            v = v[:, [0, 2, 1]].copy()
            v[:, 1] *= -1
        p, n = sample_mesh_surface(v, mesh.triangles, density, rng)
        out[mtl] = (p, n)
    return out


# ---------------------------------------------------------------- renderer

def render_photo(labeled_samples, K, R, t, width, height, rng=None,
                 style=STYLE, supersample=2, label_names=None,
                 color_jitter=0.0, light=None, blur=False):
    """Shaded render + per-organ visibility masks via depth-sorted splats.

    labeled_samples: {label: (points (N,3), normals (N,3))}.
    Returns (rgb uint8 (H,W,3), {label: uint8 mask}, label_img int8) where
    label_img holds per-pixel visible-organ indices into `label_names`
    (0 = background)."""
    rng = rng or np.random.default_rng(0)
    if label_names is None:
        label_names = ML_LABELS
    K = np.asarray(K, float)
    R = np.asarray(R, float)
    t = np.asarray(t, float)
    ss = supersample
    Ws, Hs = width * ss, height * ss

    pts_all, nrm_all, lab_all, gain_all = [], [], [], []
    for label, (pts, nrm) in labeled_samples.items():
        li = label_names.index(label)
        pts_all.append(pts)
        nrm_all.append(nrm)
        lab_all.append(np.full(len(pts), li, np.int8))
        g = style["label_gain"].get(label, 1.0)
        gain_all.append(np.full(len(pts), g, np.float32))
    pts = np.concatenate(pts_all)
    nrm = np.concatenate(nrm_all)
    lab = np.concatenate(lab_all)
    gain = np.concatenate(gain_all)

    cam = pts @ R.T + t
    z = cam[:, 2]
    ok = z > 1e-6
    cam, z, nrm, lab, gain = cam[ok], z[ok], nrm[ok], lab[ok], gain[ok]
    px = (cam[:, 0] / z * K[0, 0] + K[0, 2]) * ss
    py = (cam[:, 1] / z * K[1, 1] + K[1, 2]) * ss
    inb = (px > -1) & (px < Ws) & (py > -1) & (py < Hs)
    px, py, z, nrm, lab, gain = px[inb], py[inb], z[inb], nrm[inb], lab[inb], gain[inb]

    # shading: two-sided lambertian, light between overhead and camera
    if light is None:
        cam_dir = -R[2]          # camera backward axis in world frame
        light = cam_dir + np.array([0, 0, 1.2]) + 0.3 * rng.standard_normal(3)
    light = np.asarray(light, float)
    light /= np.linalg.norm(light)
    lam = np.abs(nrm @ light)
    shade = style["ambient"] + (1 - style["ambient"]) * lam

    g_base = style["g_base"] * (1.0 + color_jitter * rng.standard_normal())
    rg = style["rg"] * (1.0 + 0.3 * color_jitter * rng.standard_normal())
    bg = style["bg"] * (1.0 + 0.3 * color_jitter * rng.standard_normal())
    gval = g_base * gain * shade
    colors = np.stack([gval * rg, gval, gval * bg], axis=1)

    # painter's algorithm: far -> near, last write wins
    order = np.argsort(-z, kind="stable")
    px, py, lab, colors = px[order], py[order], lab[order], colors[order]

    img = np.zeros((Hs * Ws, 3), np.float32)
    lim = np.zeros(Hs * Ws, np.int8)
    ix = px.astype(np.int64)
    iy = py.astype(np.int64)
    for dy in (0, 1):
        for dx in (0, 1):
            xx = np.clip(ix + dx, 0, Ws - 1)
            yy = np.clip(iy + dy, 0, Hs - 1)
            flat = yy * Ws + xx
            img[flat] = colors
            lim[flat] = lab

    img = img.reshape(Hs, Ws, 3)
    lim = lim.reshape(Hs, Ws)
    if ss > 1:
        img = img.reshape(height, ss, width, ss, 3).mean(axis=(1, 3))
        # per-organ coverage from the supersampled label image
        onehot = lim.reshape(height, ss, width, ss)
    rgb = img + rng.standard_normal(img.shape) * style["noise_sigma"]
    if blur:
        k = np.array([0.25, 0.5, 0.25])
        rgb = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), 0, rgb)
        rgb = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), 1, rgb)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)

    masks = {}
    label_img = np.zeros((height, width), np.int8)
    for li, name in enumerate(label_names):
        if name == "background":
            continue
        if ss > 1:
            cov = (onehot == li).mean(axis=(1, 3))
        else:
            cov = (lim == li).astype(np.float32)
        m = cov >= 0.25
        if m.any():
            masks[name] = (m * 255).astype(np.uint8)
            label_img[m] = li
    # majority wins where organs overlap at boundaries: nearest organ is
    # re-imposed from the center subsample
    if ss > 1:
        center = lim.reshape(height, ss, width, ss)[:, ss // 2, :, ss // 2]
        label_img = np.where(center > 0, center, label_img)
    union = label_img > 0
    masks["background"] = np.where(union, 0, 255).astype(np.uint8)
    return rgb, masks, label_img


def fixture_like_cameras(n_views, radius=75.0, z=65.0, target=(4.6, 5.0, 55.0),
                         f=371.2, width=896, height=896, rng=None,
                         radius_jitter=0.0, z_jitter=0.0, phase=0.0):
    """Camera ring matching the virtual_plant fixture geometry (ring radius
    ~72-77 at z=65, f=371.2 at 896x896, ~8 deg look-down)."""
    rng = rng or np.random.default_rng(0)
    K = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1.0]])
    cams = []
    for v in range(n_views):
        a = 2 * np.pi * v / n_views + phase
        r = radius * (1 + radius_jitter * rng.standard_normal())
        zz = z + z_jitter * rng.standard_normal()
        c = np.array([target[0] + r * np.cos(a), target[1] + r * np.sin(a), zz])
        R, t = pose_to_extrinsics(c, target)
        cams.append((K, R, t))
    return cams


# ---------------------------------------------------------------- scans

def generate_photo_scan(db, scan_id="photo_plant", n_views=20, width=896,
                        height=896, plant=None, seed=0, density=150.0,
                        with_gt_masks=True):
    """Full photo-domain scan in the reference on-disk format: rgb images
    + per-organ GT channels (like the virtual_plant fixture's 7-channel
    layout) + exact camera metadata + VirtualPlant GT angles fileset."""
    from .fsdb import io

    rng = np.random.default_rng(seed)
    plant = plant or ProceduralArabidopsis(seed=seed)
    samples = plant.labeled_samples(density=density)
    scan = db.get_scan(scan_id, create=True)
    images = scan.get_fileset("images", create=True)
    bbox = plant.bounding_box()
    scan.set_metadata("bounding_box", bbox)

    cz = (bbox["z"][0] + bbox["z"][1]) / 2
    cams = fixture_like_cameras(
        n_views, radius=1.55 * (bbox["z"][1] - bbox["z"][0]),
        z=cz + 10.0, target=(0.0, 0.0, cz), width=width, height=height,
        rng=rng)
    for v, (K, R, t) in enumerate(cams):
        rgb, masks, _ = render_photo(samples, K, R, t, width, height,
                                     rng=rng, color_jitter=0.05)
        cam_md = {
            "camera_model": camera_model_to_metadata(
                "OPENCV", [K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0, 0, 0, 0],
                width, height),
            "rotmat": np.asarray(R).tolist(),
            "tvec": np.asarray(t).tolist(),
        }
        fimg = images.create_file(f"{v:05d}_rgb")
        io.write_image(fimg, rgb, "png")
        fimg.set_metadata({"shot_id": f"{v:06d}", "channel": "rgb",
                           "camera": cam_md})
        if with_gt_masks:
            for label in ML_LABELS:
                if label == "flower":
                    continue
                m = masks.get(label)
                if m is None:
                    m = np.zeros((height, width), np.uint8)
                fm = images.create_file(f"{v:05d}_{label}")
                io.write_image(fm, m, "png")
                fm.set_metadata({"shot_id": f"{v:06d}", "channel": label,
                                 "camera": cam_md})

    vp = scan.get_fileset("VirtualPlant_photo", create=True)
    obj = vp.create_file("VirtualPlant")
    # minimal OBJ: fruit-base markers are enough for angle ground truth
    from .fsdb.geometry import TriangleMesh
    io.write_triangle_mesh(obj, TriangleMesh(
        np.asarray(plant.fruit_bases), np.zeros((0, 3), np.int64)))
    obj.set_metadata({"angles": np.asarray(plant.gt_angles).tolist(),
                      "internodes": np.asarray(plant.gt_internodes).tolist()})
    return scan
