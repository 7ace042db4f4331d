"""Calibration tasks (port of plant3dvision_tpu/tasks/calibration.py;
reference tasks/calibration.py). CreateCharucoBoard, DetectCharuco and
IntrinsicCalibration need cv2 with its aruco module; ExtrinsicCalibration
runs COLMAP (colmap/runner.py) and draws its figures with matplotlib; the
two *Exists tasks are markers."""

from __future__ import annotations

import numpy as np

from ..fsdb import io
from ..runtime.log import configure_logger
from ..runtime.task import (FileByFileTask, FilesetExists, FilesetTarget,
                            Parameter, RomiTask)
from .. import calibration as calib

logger = configure_logger(__name__)


class CreateCharucoBoard(RomiTask):
    """Generate the ChArUco board image (reference tasks/calibration.py:25-87)."""

    upstream_task = Parameter(default="ImagesFilesetExists", significant=False)
    n_squares_x = Parameter(default=14)
    n_squares_y = Parameter(default=10)
    square_length = Parameter(default=2.0)
    marker_length = Parameter(default=1.5)
    aruco_pattern = Parameter(default="DICT_4X4_1000")

    def requires(self):
        return []

    def run(self):
        board = calib.get_charuco_board(
            int(self.n_squares_x), int(self.n_squares_y),
            float(self.square_length), float(self.marker_length),
            str(self.aruco_pattern))
        img = calib.create_charuco_image(board)
        outfile = self.output_file("charuco_board")
        io.write_image(outfile, img, "png")
        outfile.set_metadata({
            "n_squares_x": int(self.n_squares_x),
            "n_squares_y": int(self.n_squares_y),
            "square_length": float(self.square_length),
            "marker_length": float(self.marker_length),
            "aruco_pattern": str(self.aruco_pattern),
        })


class DetectCharuco(FileByFileTask):
    """Detect board corners per image (reference tasks/calibration.py:90-194)."""

    upstream_task = Parameter(default="ImagesFilesetExists")
    min_n_corners = Parameter(default=20)
    query = Parameter(default={})

    def f(self, fin, outfs):
        img = io.read_image(fin)
        corners, ids = calib.detect_charuco_corners(
            img, min_corners=int(self.min_n_corners))
        if corners is None:
            logger.warning(f"DetectCharuco: too few corners in {fin.id}")
            return None
        fout = outfs.get_file(fin.id, create=True)
        io.write_json(fout, {"shape": list(img.shape[:2]),
                             "markers": {"corners": corners.tolist(),
                                         "ids": ids.tolist()}})
        return fout


class IntrinsicCalibration(RomiTask):
    """Fit SIMPLE_RADIAL / RADIAL / OPENCV models from detected corners,
    write camera_model.json with per-image RMS outliers flagged
    (reference tasks/calibration.py:197-327)."""

    upstream_task = Parameter(default="DetectCharuco")

    def run(self):
        fs = self.input()[0].get(create=False) if isinstance(
            self.input(), (list, tuple)) else self.input().get(create=False)
        corners_list, ids_list, names = [], [], []
        shape = None
        for f in fs.get_files():
            data = io.read_json(f)
            corners_list.append(np.asarray(data["markers"]["corners"]))
            ids_list.append(np.asarray(data["markers"]["ids"]))
            names.append(f.id)
            shape = data["shape"]
        if not corners_list:
            raise ValueError("No detected ChArUco corners upstream")
        image_size = (shape[1], shape[0])

        results = {}
        for model in ("SIMPLE_RADIAL", "RADIAL", "OPENCV"):
            res = calib.calibrate_camera(corners_list, ids_list, image_size,
                                         model=model)
            errs = np.asarray(res["per_view_errors"])
            outliers = [names[i] for i in np.where(errs > 2 * errs.mean())[0]]
            if outliers:
                logger.warning(f"{model}: outlier images {outliers}")
            res["outliers"] = outliers
            res["width"], res["height"] = image_size
            results[model] = res

        io.write_json(self.output_file("camera_model"), results)


class ExtrinsicCalibration(RomiTask):
    """Full COLMAP run on a calibration scan; writes 'calibrated_pose'
    per image + pose QC figure + circle-path fit diagnostics
    (reference tasks/calibration.py:330-622)."""

    upstream_task = Parameter(default="ImagesFilesetExists")
    matcher = Parameter(default="exhaustive")
    camera_model = Parameter(default="SIMPLE_RADIAL")
    alignment_max_error = Parameter(default=10)
    use_gpu = Parameter(default=False)

    def run(self):
        from ..camera import compute_estimated_pose
        from ..colmap.runner import ColmapRunner
        from ..utils import fit_circle
        from .colmap import get_cnc_poses

        images_fs = self.input()[0].get(create=False) if isinstance(
            self.input(), (list, tuple)) else self.input().get(create=False)
        files = images_fs.get_files()
        runner = ColmapRunner(files, matcher=str(self.matcher),
                              align_pcd=True, use_gpu=bool(self.use_gpu),
                              alignment_max_error=self.alignment_max_error,
                              camera_model=str(self.camera_model))
        points, images, cameras, sparse, _, bbox = runner.run()

        by_name = {im["name"]: im for im in images.values()}
        estimated = {}
        for f in files:
            im = by_name.get(f.filename) or by_name.get(f.id)
            if im is None:
                continue
            pose = compute_estimated_pose(im["rotmat"], im["tvec"])
            f.set_metadata("calibrated_pose", pose)
            cam = cameras[str(im["camera_id"])]
            f.set_metadata("colmap_camera", {
                "camera_model": {"model": cam["model"], "params": cam["params"],
                                 "width": cam["width"], "height": cam["height"]},
                "rotmat": im["rotmat"], "tvec": im["tvec"]})
            estimated[f.id] = pose

        outfs = self.output().get()
        io.write_json(outfs.get_file("images", create=True), images)
        io.write_json(outfs.get_file("cameras", create=True), cameras)

        cnc = get_cnc_poses(self.ctx.scan, images_fs)
        fig_file = outfs.get_file("poses_figure", create=True)
        fig_path = outfs.path() / "poses_figure.png"
        outfs.path().mkdir(parents=True, exist_ok=True)
        stats = calib.pose_estimation_figure(cnc, estimated, fig_path,
                                             self.ctx.scan.id)
        if fig_path.exists():
            fig_file.filename = "poses_figure.png"
            self.ctx.scan.store()

        # circle-path diagnostics (reference :558-620, utils.py:132)
        if len(estimated) >= 3:
            from ..utils import plot_points_circle
            pts = np.array(list(estimated.values()))
            xc, yc, r, residuals = fit_circle(pts[:, 0], pts[:, 1])
            stats["circle_fit"] = {
                "center": [float(xc), float(yc)], "radius": float(r),
                "residual_rms": float(np.sqrt((residuals ** 2).mean())),
            }
            circle_path = outfs.path() / "circle_fit.png"
            try:
                plot_points_circle(pts[:, 0], pts[:, 1], xc, yc, r,
                                   circle_path)
                cf = outfs.get_file("circle_fit", create=True)
                cf.filename = "circle_fit.png"
                self.ctx.scan.store()
            except Exception as e:  # figure is QC sugar, never fatal
                logger.warning(f"circle-fit figure failed: {e}")
        io.write_json(outfs.get_file("calibration_stats", create=True), stats)


class IntrinsicCalibrationExists(FilesetExists):
    """Marker: an IntrinsicCalibration output exists in a (possibly other)
    scan (reference tasks/calibration.py:625-739)."""

    scan_id = Parameter(default="")
    #: the task whose fileset this marker points at
    calibration_task = "IntrinsicCalibration"

    def output(self):
        from ..utils import locate_task_filesets
        scan = self.ctx.scan
        if self.scan_id:
            scan = self.ctx.db.get_scan(self.scan_id) or scan
        fs_id = locate_task_filesets(scan, [self.calibration_task])[
            self.calibration_task]
        return FilesetTarget(scan, fs_id)


class ExtrinsicCalibrationExists(IntrinsicCalibrationExists):
    """Marker: an ExtrinsicCalibration output exists (the pose source of
    configs/fast_geom_pipe_real.toml)."""

    calibration_task = "ExtrinsicCalibration"
