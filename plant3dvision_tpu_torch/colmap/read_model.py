"""COLMAP binary model readers/writers (the port's copy of
plant3dvision_tpu/colmap/read_model.py, numpy only).

Implements the public COLMAP sparse-model format (cameras.bin, images.bin,
points3D.bin) — role of reference thirdparty/read_model.py — plus writers
(used by tests and by pose-injection workflows).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
CAMERA_MODEL_NUM_PARAMS = {name: n for _, (name, n) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(qvec):
    """COLMAP (w, x, y, z) quaternion -> 3x3 rotation matrix
    (reference thirdparty/read_model.py:272)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y ** 2 - 2 * z ** 2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x ** 2 - 2 * z ** 2, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x ** 2 - 2 * y ** 2],
    ])


def rotmat2qvec(R):
    """3x3 rotation matrix -> (w, x, y, z) quaternion."""
    R = np.asarray(R, dtype=float)
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    w, V = np.linalg.eigh(K)
    q = V[[3, 0, 1, 2], np.argmax(w)]
    if q[0] < 0:
        q = -q
    return q


def _read(fid, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fid.read(size))


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cameras[cam_id] = Camera(cam_id, name, int(width), int(height), params)
    return cameras


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(24 * n_pts),
                dtype=np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")]))
            images[image_id] = Image(
                image_id, qvec, tvec, camera_id, name.decode(),
                np.stack([data["x"], data["y"]], axis=1) if n_pts else np.zeros((0, 2)),
                data["id"].copy())
    return images


def read_points3d_binary(path):
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<qdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7], dtype=np.uint8)
            error = vals[7]
            (track_len,) = _read(f, "<Q")
            track = np.frombuffer(
                f.read(8 * track_len),
                dtype=np.dtype([("img", "<i4"), ("p2d", "<i4")]))
            points[pid] = Point3D(pid, xyz, rgb, error,
                                  track["img"].copy(), track["p2d"].copy())
    return points


# -- text-model readers (role of reference thirdparty/read_model.py:82-258;
#    COLMAP `model_converter --output_type TXT` and older exports) ----------

def _data_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path):
    """CAMERA_ID MODEL WIDTH HEIGHT PARAMS[] — one camera per line."""
    cameras = {}
    for line in _data_lines(path):
        toks = line.split()
        cam_id, model = int(toks[0]), toks[1]
        width, height = int(toks[2]), int(toks[3])
        params = np.array([float(t) for t in toks[4:]])
        cameras[cam_id] = Camera(cam_id, model, width, height, params)
    return cameras


def read_images_text(path):
    """Two lines per image: `IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME`
    then the 2D observations `X Y POINT3D_ID ...` (-1 = untracked)."""
    images = {}
    lines = _data_lines(path)
    for header in lines:
        toks = header.split()
        image_id = int(toks[0])
        qvec = np.array([float(t) for t in toks[1:5]])
        tvec = np.array([float(t) for t in toks[5:8]])
        camera_id = int(toks[8])
        name = toks[9] if len(toks) > 9 else ""
        obs = next(lines, "").split()
        xys = (np.array(obs, dtype=float).reshape(-1, 3)[:, :2]
               if obs else np.zeros((0, 2)))
        pids = (np.array(obs[2::3], dtype=np.int64)
                if obs else np.zeros(0, np.int64))
        images[image_id] = Image(image_id, qvec, tvec, camera_id, name,
                                 xys, pids)
    return images


def read_points3d_text(path):
    """POINT3D_ID X Y Z R G B ERROR (IMAGE_ID POINT2D_IDX)* per line."""
    points = {}
    for line in _data_lines(path):
        toks = line.split()
        pid = int(toks[0])
        xyz = np.array([float(t) for t in toks[1:4]])
        rgb = np.array([int(t) for t in toks[4:7]], dtype=np.uint8)
        error = float(toks[7])
        track = np.array(toks[8:], dtype=np.int32).reshape(-1, 2)
        points[pid] = Point3D(pid, xyz, rgb, error,
                              track[:, 0].copy(), track[:, 1].copy())
    return points


def write_cameras_text(cameras, path):
    with open(path, "w") as f:
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(images, path):
    with open(path, "w") as f:
        f.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "# POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            pose = " ".join(repr(float(v)) for v in (*im.qvec, *im.tvec))
            f.write(f"{im.id} {pose} {im.camera_id} {im.name}\n")
            obs = " ".join(f"{repr(float(x))} {repr(float(y))} {int(pid)}"
                           for (x, y), pid in zip(im.xys, im.point3D_ids))
            f.write(obs + "\n")


def write_points3d_text(points, path):
    with open(path, "w") as f:
        f.write("# POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pt in points.values():
            xyz = " ".join(repr(float(v)) for v in pt.xyz)
            rgb = " ".join(str(int(v)) for v in pt.rgb)
            track = " ".join(f"{int(i)} {int(p)}"
                             for i, p in zip(pt.image_ids, pt.point2D_idxs))
            f.write(f"{pt.id} {xyz} {rgb} {repr(float(pt.error))} {track}\n")


def read_model(sparse_dir, ext=None):
    """Read a COLMAP sparse model; auto-detects binary vs text when `ext`
    is None (reference thirdparty/read_model.py:260 takes it explicitly)."""
    sparse_dir = Path(sparse_dir)
    if ext is None:
        ext = ".bin" if (sparse_dir / "cameras.bin").exists() else ".txt"
    if ext == ".bin":
        return (read_cameras_binary(sparse_dir / "cameras.bin"),
                read_images_binary(sparse_dir / "images.bin"),
                read_points3d_binary(sparse_dir / "points3D.bin"))
    return (read_cameras_text(sparse_dir / "cameras.txt"),
            read_images_text(sparse_dir / "images.txt"),
            read_points3d_text(sparse_dir / "points3D.txt"))


# -- writers ----------------------------------------------------------------

def write_cameras_binary(cameras, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.point3D_ids)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, pid))


def write_points3d_binary(points, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pt in points.values():
            f.write(struct.pack("<qdddBBBd", pt.id, *pt.xyz, *pt.rgb, pt.error))
            f.write(struct.pack("<Q", len(pt.image_ids)))
            for img, p2d in zip(pt.image_ids, pt.point2D_idxs):
                f.write(struct.pack("<ii", int(img), int(p2d)))


# -- dict exports (reference colmap.py:55-178 formats) -----------------------

def cameras_to_dict(cameras):
    return {str(cid): {"id": cam.id, "model": cam.model, "width": cam.width,
                       "height": cam.height, "params": cam.params.tolist()}
            for cid, cam in cameras.items()}


def images_to_dict(images):
    out = {}
    for iid, im in images.items():
        out[str(iid)] = {
            "id": im.id, "name": im.name, "camera_id": im.camera_id,
            "qvec": im.qvec.tolist(), "tvec": im.tvec.tolist(),
            "rotmat": qvec2rotmat(im.qvec).tolist(),
        }
    return out


def points_to_dict(points):
    return {str(pid): {"xyz": pt.xyz.tolist(), "rgb": pt.rgb.tolist(),
                       "error": float(pt.error)}
            for pid, pt in points.items()}


# -- dense MVS array codec (reference thirdparty/read_dense.py:36-51) --------
#
# COLMAP's patch_match_stereo writes depth/normal maps as
# "<width>&<height>&<channels>&" ASCII header followed by float32 data in
# column-major (Fortran) order.

def read_array(path):
    """Read a COLMAP dense depth/normal map (.photometric.bin /
    .geometric.bin). Returns (H, W) for 1 channel, (H, W, C) otherwise."""
    with open(path, "rb") as f:
        header = b""
        while header.count(b"&") < 3:
            byte = f.read(1)
            if not byte:
                raise ValueError(f"truncated dense-map header in {path}")
            header += byte
        width, height, channels = (int(tok) for tok in
                                   header.split(b"&")[:3])
        data = np.fromfile(f, np.float32, count=width * height * channels)
    if data.size != width * height * channels:
        raise ValueError(f"truncated dense-map payload in {path}")
    arr = data.reshape((width, height, channels), order="F")
    return arr.transpose(1, 0, 2).squeeze()


def write_array(arr, path):
    """Write a float32 array in COLMAP's dense-map format (inverse of
    read_array; the reference ships only the reader)."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    height, width, channels = arr.shape
    with open(path, "wb") as f:
        f.write(f"{width}&{height}&{channels}&".encode())
        arr.transpose(1, 0, 2).ravel(order="F").astype("<f4").tofile(f)
