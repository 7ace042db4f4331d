"""Camera calibration: ChArUco boards + intrinsic calibration + pose QC
figures (port of plant3dvision_tpu/calibration.py; reference
plant3dvision/calibration.py). Host code: cv2 (with its aruco module) and
matplotlib are imported inside the functions that need them, so the
package imports without them.

Board defaults match the reference (calibration.py:13-17): 14x10 squares,
2 cm squares / 1.5 cm markers, DICT_4X4_1000.
"""

from __future__ import annotations

import numpy as np

from .runtime.log import configure_logger

logger = configure_logger(__name__)

BOARD_COLS = 14
BOARD_ROWS = 10
SQUARE_LENGTH = 2.0   # cm
MARKER_LENGTH = 1.5   # cm
ARUCO_DICT = "DICT_4X4_1000"


def get_charuco_board(n_squares_x=BOARD_COLS, n_squares_y=BOARD_ROWS,
                      square_length=SQUARE_LENGTH, marker_length=MARKER_LENGTH,
                      aruco_dict=ARUCO_DICT):
    import cv2.aruco as aruco
    dictionary = aruco.getPredefinedDictionary(getattr(aruco, aruco_dict))
    return aruco.CharucoBoard((n_squares_x, n_squares_y), square_length,
                              marker_length, dictionary)


def create_charuco_image(board=None, width=1400, height=1000, margin=20):
    board = board or get_charuco_board()
    return board.generateImage((width, height), marginSize=margin)


def detect_charuco_corners(image, board=None, min_corners=20):
    """Detect ChArUco corners in a grayscale/RGB image.

    Returns (corners (N,2), ids (N,)) or (None, None) when fewer than
    `min_corners` are found (reference tasks/calibration.py:90-194).
    """
    import cv2
    import cv2.aruco as aruco
    board = board or get_charuco_board()
    img = np.asarray(image)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    detector = aruco.CharucoDetector(board)
    corners, ids, _, _ = detector.detectBoard(img)
    if corners is None or ids is None or len(corners) < min_corners:
        return None, None
    return corners.reshape(-1, 2), ids.reshape(-1)


def calibrate_camera(corners_list, ids_list, image_size, board=None,
                     model="OPENCV"):
    """Fit a camera model from detected ChArUco corners.

    Model-specific flags follow the reference's three calibrate wrappers
    (calibration.py:115-279): OPENCV (k1,k2,p1,p2), RADIAL (k1,k2 only),
    SIMPLE_RADIAL (single k, fixed aspect).

    Returns dict {model, params (COLMAP layout), rms, per_view_errors}.
    """
    import cv2
    board = board or get_charuco_board()

    flags = cv2.CALIB_FIX_K3
    if model == "RADIAL":
        flags |= (cv2.CALIB_ZERO_TANGENT_DIST | cv2.CALIB_FIX_ASPECT_RATIO)
    elif model == "SIMPLE_RADIAL":
        flags |= (cv2.CALIB_ZERO_TANGENT_DIST | cv2.CALIB_FIX_ASPECT_RATIO
                  | cv2.CALIB_FIX_K2)
    elif model != "OPENCV":
        raise ValueError(f"Unsupported calibration model: {model}")

    obj_all, img_all = [], []
    chessboard = board.getChessboardCorners()
    for corners, ids in zip(corners_list, ids_list):
        obj_all.append(chessboard[ids].reshape(-1, 1, 3).astype(np.float32))
        img_all.append(np.asarray(corners).reshape(-1, 1, 2).astype(np.float32))

    rms, K, dist, rvecs, tvecs, _, _, per_view = cv2.calibrateCameraExtended(
        obj_all, img_all, tuple(image_size), None, None, flags=flags)

    from .camera import k_dist_to_colmap_params
    params = k_dist_to_colmap_params(model, K, dist[:4].ravel()[:4])
    return {
        "model": model,
        "params": params,
        "K": K.tolist(),
        "dist": dist.ravel().tolist(),
        "rms": float(rms),
        "per_view_errors": [float(e) for e in np.asarray(per_view).ravel()],
    }


def pose_estimation_figure(cnc_poses, estimated_poses, path=None, scan_id=""):
    """4-panel QC figure: XY scatter, Z profile, error boxplot, stats
    (reference calibration.py:282-573). Returns summary stats dict."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ids = sorted(set(cnc_poses) & set(estimated_poses))
    if not ids:
        logger.warning("pose_estimation_figure: no common poses to compare")
        return {"mean_3d_error": None, "std_3d_error": None,
                "mean_xy_error": None, "mean_z_error": None, "n_poses": 0}
    cnc = np.array([cnc_poses[i][:3] for i in ids], dtype=float)
    est = np.array([estimated_poses[i][:3] for i in ids], dtype=float)
    err3d = np.linalg.norm(cnc - est, axis=1)
    err_xy = np.linalg.norm(cnc[:, :2] - est[:, :2], axis=1)
    err_z = np.abs(cnc[:, 2] - est[:, 2])

    stats = {
        "mean_3d_error": float(err3d.mean()) if len(ids) else None,
        "std_3d_error": float(err3d.std()) if len(ids) else None,
        "mean_xy_error": float(err_xy.mean()) if len(ids) else None,
        "mean_z_error": float(err_z.mean()) if len(ids) else None,
        "n_poses": len(ids),
    }

    if path is not None and len(ids):
        fig, axes = plt.subplots(2, 2, figsize=(12, 10))
        axes[0, 0].scatter(cnc[:, 0], cnc[:, 1], c="tab:blue", label="CNC",
                           s=14)
        axes[0, 0].scatter(est[:, 0], est[:, 1], c="tab:red", marker="x",
                           label="estimated", s=14)
        for a, b in zip(cnc, est):
            axes[0, 0].plot([a[0], b[0]], [a[1], b[1]], "k-", lw=0.4)
        axes[0, 0].set_title(f"XY poses — {scan_id}")
        axes[0, 0].legend()
        axes[0, 0].set_aspect("equal")
        axes[0, 1].plot(err_z, "o-", ms=3)
        axes[0, 1].set_title("Z error per image")
        axes[1, 0].boxplot([err3d, err_xy, err_z],
                           tick_labels=["3D", "XY", "Z"])
        axes[1, 0].set_title("Euclidean error distributions")
        axes[1, 1].axis("off")
        axes[1, 1].text(0.05, 0.6, "\n".join(
            f"{k}: {v:.3f}" if isinstance(v, float) else f"{k}: {v}"
            for k, v in stats.items()), fontsize=11, family="monospace")
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return stats
