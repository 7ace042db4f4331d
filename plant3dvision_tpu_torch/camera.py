"""Camera models: COLMAP-convention parameter dicts <-> (K, dist) arrays.

Role of reference plant3dvision/camera.py (417 LoC): converters for the
OPENCV / RADIAL / SIMPLE_RADIAL models (camera.py:14-138), model
simplification (:273-303), COLMAP CLI param strings (:177-219), and
readers for per-image camera metadata (:307-406).

COLMAP parameter layouts:
    SIMPLE_RADIAL: [f, cx, cy, k]
    RADIAL:        [f, cx, cy, k1, k2]
    OPENCV:        [fx, fy, cx, cy, k1, k2, p1, p2]
"""

from __future__ import annotations

import numpy as np

MODELS = ("SIMPLE_RADIAL", "RADIAL", "OPENCV")


def colmap_params_to_k_dist(model: str, params):
    """COLMAP params -> (3x3 K, dist[k1,k2,p1,p2]) arrays."""
    params = list(map(float, params))
    if model == "SIMPLE_RADIAL":
        f, cx, cy, k = params[:4]
        K = _k(f, f, cx, cy)
        dist = np.array([k, 0.0, 0.0, 0.0])
    elif model == "RADIAL":
        f, cx, cy, k1, k2 = params[:5]
        K = _k(f, f, cx, cy)
        dist = np.array([k1, k2, 0.0, 0.0])
    elif model == "OPENCV":
        fx, fy, cx, cy, k1, k2, p1, p2 = params[:8]
        K = _k(fx, fy, cx, cy)
        dist = np.array([k1, k2, p1, p2])
    else:
        raise ValueError(f"Unsupported camera model: {model}")
    return K, dist


def k_dist_to_colmap_params(model: str, K, dist):
    K = np.asarray(K)
    dist = list(np.asarray(dist).ravel()) + [0.0] * 4
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    k1, k2, p1, p2 = dist[:4]
    if model == "SIMPLE_RADIAL":
        return [float((fx + fy) / 2), float(cx), float(cy), float(k1)]
    if model == "RADIAL":
        return [float((fx + fy) / 2), float(cx), float(cy), float(k1), float(k2)]
    if model == "OPENCV":
        return [float(fx), float(fy), float(cx), float(cy),
                float(k1), float(k2), float(p1), float(p2)]
    raise ValueError(f"Unsupported camera model: {model}")


def _k(fx, fy, cx, cy):
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


def simplify_model(model: str, params, tol=1e-12):
    """OPENCV -> RADIAL -> SIMPLE_RADIAL when the extra params are ~zero
    (reference camera.py:273-303)."""
    params = list(map(float, params))
    if model == "OPENCV":
        fx, fy, cx, cy, k1, k2, p1, p2 = params[:8]
        if abs(p1) < tol and abs(p2) < tol and abs(fx - fy) < tol:
            model, params = "RADIAL", [fx, cx, cy, k1, k2]
    if model == "RADIAL":
        f, cx, cy, k1, k2 = params[:5]
        if abs(k2) < tol:
            model, params = "SIMPLE_RADIAL", [f, cx, cy, k1]
    return model, params


def format_camera_params(model: str, params) -> str:
    """COLMAP CLI 'camera_params' comma string (reference camera.py:372-417)."""
    return ",".join(f"{p:.12g}" for p in params)


def camera_model_to_metadata(model: str, params, width: int, height: int) -> dict:
    """The per-image 'camera_model' metadata block (see
    testdata/virtual_plant/metadata/images/*.json)."""
    return {"model": model, "params": list(map(float, params)),
            "width": int(width), "height": int(height)}


def get_camera_kwargs_from_metadata(cam_md: dict):
    """Per-image camera metadata -> dict(K, dist, rotmat, tvec, model, size).

    Accepts the reference's layouts: {'camera_model': {...}, 'rotmat', 'tvec'}
    (exact/virtual or colmap_camera metadata, cl.py:293-296).
    """
    if cam_md is None:
        return None
    cm = cam_md.get("camera_model", cam_md)
    model = cm.get("model", "OPENCV")
    K, dist = colmap_params_to_k_dist(model, cm["params"])
    out = {
        "model": model,
        "K": K,
        "dist": dist,
        "width": cm.get("width"),
        "height": cm.get("height"),
    }
    if "rotmat" in cam_md:
        out["rotmat"] = np.asarray(cam_md["rotmat"], dtype=float)
    if "tvec" in cam_md:
        out["tvec"] = np.asarray(cam_md["tvec"], dtype=float)
    return out


def get_camera_kwargs_from_images_metadata(file):
    """Reads intrinsics from an image File's metadata, trying the keys the
    reference pipeline uses in priority order (camera.py:307-406):
    'colmap_camera' then 'camera'."""
    for key in ("colmap_camera", "camera"):
        cam = file.get_metadata(key)
        if cam:
            return get_camera_kwargs_from_metadata(cam)
    return None


def compute_estimated_pose(rotmat, tvec):
    """Camera center in world coords: -R^T t (reference colmap.py:285-302)."""
    R = np.asarray(rotmat, dtype=float)
    t = np.asarray(tvec, dtype=float)
    return (-R.T @ t).tolist()


def pose_to_extrinsics(camera_center, look_at=None, up=(0, 0, 1)):
    """Build (rotmat, tvec) for a camera at `camera_center` looking at
    `look_at` (world-to-camera, z forward, y down: COLMAP convention)."""
    c = np.asarray(camera_center, dtype=float)
    target = np.zeros(3) if look_at is None else np.asarray(look_at, dtype=float)
    fwd = target - c
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, dtype=float)
    right = np.cross(fwd, upv)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    t = -R @ c
    return R, t


def get_colmap_cameras_from_calib_scan(calibration_scan):
    """COLMAP cameras JSON written by a calibration run on the given scan
    (reference camera.py:393-406): searched in ExtrinsicCalibration, then
    TurntableCalibration, then Colmap filesets."""
    from .fsdb import io

    for task in ("ExtrinsicCalibration", "TurntableCalibration", "Colmap"):
        for fs_id in calibration_scan.list_filesets():
            if task in fs_id:
                f = calibration_scan.get_fileset(fs_id).get_file("cameras")
                if f is not None:
                    return io.read_json(f)
    raise ValueError(
        f"no calibration fileset with a 'cameras' file in scan "
        f"'{calibration_scan.id}' — run ExtrinsicCalibration (or "
        "TurntableCalibration) on it first")
