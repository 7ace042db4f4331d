"""Camera recovery tasks (port of plant3dvision_tpu/tasks/colmap.py):
`Colmap`, which runs the external COLMAP binary, and TurntableCalibration,
the COLMAP-free recovery on the run's device.

Colmap (host code around the binary, colmap/runner.py) exports per-image
`colmap_camera` and `pose_estimation` metadata, the model JSONs, the
sparse point cloud and `euclidean_distances` (estimated camera centres
against the CNC poses), and raises RetryableTaskError on a blind angle
(reference tasks/colmap.py:792-834).

TurntableCalibration starts from the CNC `approximate_pose` metadata: a
silhouette-coherence CEM (ops/selfcal.py) recovers the roll quadrant,
pan/tilt zero offsets and mount offsets; a feature bundle adjustment
(ops/sfmlite.py) pins the focal length and per-view CNC jitter; a per-view
silhouette polish re-aligns every view to the robust hull. Its outputs
mirror Colmap's: per-image `colmap_camera` metadata, cameras/images JSON,
the hull's `bounding_box`, per-image `pose_estimation` from the per-view
silhouette coverage, and the blind-angle retry.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fsdb import io
from ..runtime.log import configure_logger
from ..runtime.runner import stage
from ..runtime.task import Parameter, RetryableTaskError, RomiTask

logger = configure_logger(__name__)

COLMAP_SPARSE_ID = "sparse"
COLMAP_POINTS_ID = "points3d"
COLMAP_IMAGES_ID = "images"
COLMAP_CAMERAS_ID = "cameras"
COLMAP_DENSE_ID = "dense"


def check_scan_parameters(scan, calibration_scan):
    """Acquisition compatibility: both scans' `scan.toml` ScanPath sections
    (class_name + kwargs) must match for calibrated poses to transfer
    (reference tasks/colmap.py:315-387). A scan without a `scan.toml`
    (virtual/synthetic datasets) cannot be checked: warn and pass.
    """
    import tomllib
    sections = []
    for s in (scan, calibration_scan):
        p = s.path() / "scan.toml"
        if not p.exists():
            logger.warning(f"{s.id}: no scan.toml acquisition config — "
                           "skipping ScanPath compatibility check")
            return True
        with open(p, "rb") as f:
            sections.append(tomllib.load(f).get("ScanPath", {}))
    cur, calib = sections
    ok = True
    if cur.get("class_name") != calib.get("class_name"):
        logger.critical(
            f"ScanPath.class_name differs: {scan.id} uses "
            f"{cur.get('class_name')!r}, {calibration_scan.id} uses "
            f"{calib.get('class_name')!r}")
        ok = False
    ka, kb = cur.get("kwargs", {}), calib.get("kwargs", {})
    diff = sorted(k for k in set(ka) | set(kb) if ka.get(k) != kb.get(k))
    if diff:
        logger.critical(
            f"ScanPath.kwargs differ between {scan.id} and "
            f"{calibration_scan.id}: "
            + ", ".join(f"{k}: {ka.get(k)!r} vs {kb.get(k)!r}" for k in diff))
        ok = False
    return ok


def check_colmap_cfg(current_cfg, calibration_scan):
    """The current Colmap parameters must match the ExtrinsicCalibration
    section of the calibration scan's `pipeline.toml` config backup
    (written by the CLI; reference tasks/colmap.py:389-427).

    Raises ValueError on a missing backup or any mismatching parameter.
    """
    import tomllib
    p = calibration_scan.path() / "pipeline.toml"
    if not p.exists():
        raise ValueError(
            f"calibration scan '{calibration_scan.id}' has no pipeline.toml "
            "config backup — cannot verify COLMAP compatibility")
    with open(p, "rb") as f:
        calib_cfg = tomllib.load(f).get("ExtrinsicCalibration", {})
    bad = {k: (v, calib_cfg.get(k)) for k, v in current_cfg.items()
           if calib_cfg.get(k) != v}
    if bad:
        detail = ", ".join(f"{k}: current {cur!r} vs calibration {cal!r}"
                           for k, (cur, cal) in sorted(bad.items()))
        raise ValueError(
            f"cannot use calibration scan '{calibration_scan.id}': "
            f"COLMAP parameters differ ({detail})")


def camera_params_from_intrinsic_calibration(db, calibration_scan_id, model):
    """Calibrated camera parameters (COLMAP layout) for `model` from a
    calibration scan's IntrinsicCalibration camera_model.json (reference
    tasks/colmap.py:614-648 `set_camera_params`, 'intrinsic' branch).
    """
    from ..utils import locate_task_filesets

    scan = db.get_scan(calibration_scan_id)
    if scan is None:
        raise ValueError(f"intrinsic calibration scan not found: "
                         f"{calibration_scan_id!r}")
    fs_id = locate_task_filesets(scan, ["IntrinsicCalibration"]
                                 )["IntrinsicCalibration"]
    fs = scan.get_fileset(fs_id) if fs_id != "None" else None
    if fs is None:
        raise ValueError(f"scan '{calibration_scan_id}' has no "
                         "IntrinsicCalibration fileset — run the "
                         "IntrinsicCalibration task on it first")
    results = io.read_json(fs.get_file("camera_model"))
    if model not in results:
        raise ValueError(f"IntrinsicCalibration of '{calibration_scan_id}' "
                         f"has no {model!r} fit (has: {sorted(results)})")
    return [float(p) for p in results[model]["params"]]


def get_cnc_poses(scan, images_fileset=None):
    """Per-image CNC pose [x, y, z] from 'approximate_pose' or 'pose'
    metadata (reference tasks/colmap.py:33-231)."""
    fs = images_fileset or scan.get_fileset("images")
    poses = {}
    for f in fs.get_files():
        p = f.get_metadata("pose") or f.get_metadata("approximate_pose")
        if p is not None:
            poses[f.id] = np.asarray(p[:3], dtype=float)
    return poses


def normalize_cnc_poses(poses):
    """Normalize (V, 5) CNC poses to [X, Y, Z, pan_deg, tilt_deg].

    Two dialects: real rigs log degrees with pan in column 3; the virtual
    scanner logs radians (a Blender Euler pose (rx, rz)) with the
    orbit-tracking angle in column 4. A spread of the angle columns between
    pi/2 and 2.2 pi marks radians; the wider-spread column is pan; the
    Euler rx (90 = level) becomes tilt = rx - 90. Returns a normalized copy
    and the list of applied conversions."""
    poses = np.array(poses, np.float32)
    applied = []
    ang = poses[:, 3:5]
    spread = np.ptp(ang, axis=0).max()
    euler = False
    if 0.5 * np.pi < spread <= 2.2 * np.pi:
        poses[:, 3:5] = np.degrees(ang)
        applied.append("radians->degrees")
        euler = True
    spread = np.ptp(poses[:, 3:5], axis=0)
    if spread[1] > max(spread[0], 90.0):
        poses[:, [3, 4]] = poses[:, [4, 3]]
        applied.append("pan/tilt swapped")
    if euler:
        poses[:, 4] -= 90.0
        applied.append("euler rx->tilt")
    return poses, applied


def check_blind_angle(statuses, max_blind_angle, what):
    """Blind-angle failure detection (reference tasks/colmap.py:810-834):
    the longest run of failed views around the circular scan, as an angle;
    raises RetryableTaskError above `max_blind_angle` degrees."""
    if len(statuses) <= 2:
        return
    run_len = max_run = 0
    for ok in statuses + statuses:  # wrap-around
        run_len = 0 if ok else run_len + 1
        max_run = max(max_run, run_len)
    max_run = min(max_run, len(statuses))
    blind_angle = 360.0 * max_run / len(statuses)
    if blind_angle > float(max_blind_angle):
        raise RetryableTaskError(
            f"Blind angle {blind_angle:.1f} deg exceeds {max_blind_angle} "
            f"deg ({max_run}/{len(statuses)} {what})")


def _rotmat_to_qvec(R):
    """COLMAP (w, x, y, z) quaternion from a world->cam rotation matrix."""
    from scipy.spatial.transform import Rotation
    q = Rotation.from_matrix(np.asarray(R, float)).as_quat()  # x, y, z, w
    return [float(q[3]), float(q[0]), float(q[1]), float(q[2])]


class TurntableCalibration(RomiTask):
    """COLMAP-free camera recovery for turntable scans (the Colmap task's
    role, reference tasks/colmap.py:436-834) from the CNC
    ``approximate_pose`` metadata: silhouette-coherence CEM, feature bundle
    adjustment, per-view hull polish, all on the run's device. Its stages
    (masks, cem, ba with detect / match / gate / gn, polish, coverage) are
    timed with runtime.runner.stage.

    Parameters, defaults and `significant` flags are the JAX package's, so
    fileset ids match."""

    upstream_task = Parameter(default="ImagesFilesetExists")
    query = Parameter(default={"channel": "rgb"})
    mask_type = Parameter(default="excess_green")
    mask_params = Parameter(default=[0.0, 1.0, 0.0])
    mask_threshold = Parameter(default=0.1)
    bounding_box = Parameter(default=None)
    f_init = Parameter(default=1400.0)
    #: CEM focal search bounds (px)
    f_bounds = Parameter(default=[250.0, 4000.0])
    downsample = Parameter(default=8)
    voxel_mm = Parameter(default=4.0)
    cem_pop = Parameter(default=48)
    cem_iters = Parameter(default=10)
    cem_rounds = Parameter(default=2)
    feature_ba = Parameter(default=True)
    #: free the SIMPLE_RADIAL k1 in the bundle adjustment (off: barely
    #: identifiable on turntable scans of a centred plant)
    estimate_k1 = Parameter(default=False)
    #: focal multipliers multi-starting the BA; "auto" = one start at the
    #: silhouette f, a log grid when that f is pinned at its CEM bound
    ba_f_starts = Parameter(default="auto")
    feature_downsample = Parameter(default=1)
    n_keypoints = Parameter(default=512)
    strides = Parameter(default=[1, 2, 4, 7, 12])
    min_matches = Parameter(default=500)
    polish_rounds = Parameter(default=3)
    #: per-view roll search half-span (deg) in the hull polish
    polish_roll_span = Parameter(default=0.0)
    #: multiply all polish search spans by this each round
    polish_shrink = Parameter(default=1.0)
    #: total polish<->BA cycles (1 = BA then polish)
    ba_polish_cycles = Parameter(default=1)
    coverage_threshold = Parameter(default=0.2)
    coverage_rel = Parameter(default=0.5)
    max_blind_angle = Parameter(default=20.0)
    seed = Parameter(default=0)

    retry_count = 10

    def _resolve_bounding_box(self):
        bbox = self.bounding_box
        scan = self.ctx.scan
        if bbox is None:
            bbox = scan.get_metadata("bounding_box")
        if bbox is None:
            images_fs = scan.get_fileset("images")
            if images_fs is not None:
                bbox = (images_fs.get_metadata("bounding_box")
                        or images_fs.get_metadata("workspace"))
        if bbox is None:
            # reference fallback chain (colmap.py:548-570)
            bbox = scan.get_metadata("workspace")
        if bbox is None:
            scanner = scan.get_metadata("scanner")
            if isinstance(scanner, dict):
                bbox = scanner.get("workspace")
        if bbox is None:
            raise ValueError("TurntableCalibration needs a bounding box "
                             "(param, scan metadata, or images workspace)")
        return {k: [float(v[0]), float(v[1])] for k, v in bbox.items()}

    @staticmethod
    def _ba_focal_guard(ba, f_ref, lo=0.5, hi=2.0):
        """Reject a bundle-adjustment result whose focal ran away from the
        silhouette-stage estimate (the focal/depth gauge of thin feature
        sets)."""
        if ba is None:
            return None
        ratio = float(ba["theta_raw"][0]) / max(float(f_ref), 1e-6)
        if not (lo <= ratio <= hi):
            logger.warning(
                "feature BA rejected: focal drifted %.0fx from the "
                "silhouette stage (%.1f -> %.1f); keeping silhouette "
                "cameras", ratio, float(f_ref), float(ba["theta_raw"][0]))
            return None
        return ba

    def _resolve_f_starts(self, res):
        """Focal multipliers for the BA multi-start (see ba_f_starts)."""
        spec = self.ba_f_starts
        if isinstance(spec, (list, tuple)):
            return tuple(float(s) for s in spec)
        if str(spec) != "auto":
            return tuple(float(s) for s in str(spec).split(","))
        bound = res.get("f_at_bound")
        if bound == "lo":      # true f likely above the pinned estimate
            return (1.0, 1.6, 2.6, 4.2)
        if bound == "hi":
            return (1.0, 0.63, 0.38, 0.24)
        return (1.0,)

    def _load(self, files, use_ba):
        """Decode the images on threads; on the run's device the
        calibration masks (the mask kernel, compute_mask_numpy's
        arithmetic), the gray images (mean of the channels / 255, as the
        JAX task's numpy) and the keypoint masks (the dilate kernel, radius
        6). Returns (masks numpy (V, H, W) bool, gray and keypoint-mask
        tensors or None)."""
        import json as _json
        from concurrent.futures import ThreadPoolExecutor

        from ..ops.carving import div_f32
        from ..ops.masks import binary_dilation, mask_filter

        coefs = self.mask_params
        if isinstance(coefs, str):
            coefs = _json.loads(coefs)
        with ThreadPoolExecutor(max_workers=8) as ex:
            imgs = torch.from_numpy(np.stack(list(ex.map(io.read_image,
                                                         files))))
        imgs = imgs.to(self.ctx.device)
        masks = mask_filter(imgs, str(self.mask_type),
                            tuple(map(float, coefs)),
                            float(self.mask_threshold), True)
        gray = kp = None
        if use_ba:
            g = imgs.to(torch.float64)
            if g.ndim == 4:
                g = div_f32(g.sum(-1), float(imgs.shape[-1]))
            gray = div_f32(g.to(torch.float32), 255.0)
            kp = binary_dilation(masks, 6)
        return masks.cpu().numpy(), gray, kp

    def run(self):
        import json as _json

        from ..ops import selfcal, sfmlite

        dev = self.ctx.device
        images_fs = self.input()[0].get(create=False) if isinstance(
            self.input(), (list, tuple)) else self.input().get(create=False)
        files = sorted(images_fs.get_files(query=self.query or None),
                       key=lambda f: f.id)
        if not files:
            raise ValueError("TurntableCalibration: no images matched")

        poses = []
        for f in files:
            p = f.get_metadata("pose") or f.get_metadata("approximate_pose")
            if p is None or len(p) < 5:
                raise ValueError(
                    f"image {f.id}: needs a 5-vector (approximate_)pose "
                    "[X, Y, Z, pan, tilt] for turntable calibration")
            poses.append(p[:5])
        poses, conversions = normalize_cnc_poses(poses)
        if conversions:
            logger.info("TurntableCalibration: pose normalization applied: "
                        f"{', '.join(conversions)}")

        use_ba = bool(self.feature_ba)
        with stage("masks"):
            masks, gray, kp_masks = self._load(files, use_ba)
        V, H, W = masks.shape
        bbox = self._resolve_bounding_box()
        logger.info(f"TurntableCalibration: {V} views at {W}x{H}")

        with stage("cem"):
            res = selfcal.calibrate_turntable(
                masks, poses, bbox, f_init=float(self.f_init),
                f_bounds=tuple(float(b) for b in self.f_bounds),
                downsample=int(self.downsample),
                voxel_mm=float(self.voxel_mm), pop=int(self.cem_pop),
                iters=int(self.cem_iters), rounds=int(self.cem_rounds),
                seed=int(self.seed), device=dev)
        logger.info(f"silhouette stage: coherence {res['coherence']:.3f} "
                    f"theta {res['theta']}")

        ba = None
        if use_ba:
            f_starts = self._resolve_f_starts(res)
            if len(f_starts) > 1:
                logger.info(f"BA focal multi-start (silhouette f "
                            f"{res['theta']['f']:.0f} at bound "
                            f"{res.get('f_at_bound')}): x{f_starts}")
            with stage("ba"):
                ba = sfmlite.iterative_refine(
                    gray, kp_masks, res["theta_raw"], poses, W, H,
                    k=int(self.n_keypoints),
                    strides=tuple(int(s) for s in self.strides),
                    downsample=int(self.feature_downsample),
                    min_matches=int(self.min_matches),
                    estimate_k1=bool(self.estimate_k1),
                    f_starts=f_starts, device=dev)
            if ba is not None:
                logger.info(
                    f"feature BA: rms {ba['rms_px']:.2f} px, "
                    f"{ba['n_inliers']}/{ba['n_obs']} inlier obs over "
                    f"{ba['n_tracks']} tracks (f start x"
                    f"{ba.get('f_start', 1.0):g}), theta {ba['theta']}")
                ba = self._ba_focal_guard(
                    ba, res["theta_raw"][0] * ba.get("f_start", 1.0))
            else:
                logger.warning(
                    "feature BA yielded no acceptable solution (too few "
                    "matches, or every focal start left its trust region); "
                    "keeping silhouette cameras")

        theta_raw = ba["theta_raw"] if ba is not None else res["theta_raw"]
        jitter = ((ba["dpan_view"], ba["dtilt_view"],
                   ba.get("droll_view", np.zeros(len(poses), np.float32)))
                  if ba is not None else None)
        k1 = float(ba["k1"]) if ba is not None else 0.0

        cycles = max(1, int(self.ba_polish_cycles))
        ba_cache = {}
        for cyc in range(cycles):
            if int(self.polish_rounds) > 0:
                with stage("polish"):
                    dpan_v, dtilt_v, droll_v, _ = \
                        selfcal.refine_views_to_hull(
                            masks, poses, theta_raw, jitter, bbox,
                            rounds=int(self.polish_rounds),
                            seed=int(self.seed),
                            roll_span=float(self.polish_roll_span),
                            shrink=float(self.polish_shrink), device=dev)
                jitter = (dpan_v, dtilt_v, droll_v)
            if cyc >= cycles - 1 or not use_ba or ba is None:
                continue
            free = ("f", "dpan", "dtilt", "roll", "mx", "my")
            if bool(self.estimate_k1):
                free = free + ("k1",)
            with stage("ba"):
                matches = sfmlite.build_matches(
                    gray, kp_masks, theta_raw, poses, W, H,
                    k=int(self.n_keypoints),
                    strides=tuple(int(s) for s in self.strides),
                    gate_px=15.0, downsample=int(self.feature_downsample),
                    jitter0=jitter, k10=k1, _cache=ba_cache, device=dev)
                if len(matches["va"]) < int(self.min_matches):
                    logger.warning("polish<->BA cycle %d: too few matches, "
                                   "stopping the iteration", cyc + 1)
                    break
                ba = sfmlite.refine_turntable(
                    matches, poses, theta_raw, W, H,
                    gate_px=(8.0, 4.0, 2.5), jitter0=jitter, k10=k1,
                    free=free, device=dev)
            logger.info(
                f"polish<->BA cycle {cyc + 1}: rms {ba['rms_px']:.2f} px, "
                f"{ba['n_inliers']}/{ba['n_obs']} inliers")
            ba = self._ba_focal_guard(ba, theta_raw[0])
            if ba is None:
                break
            theta_raw = ba["theta_raw"]
            jitter = (ba["dpan_view"], ba["dtilt_view"], ba["droll_view"])
            k1 = float(ba["k1"])

        poses_adj = poses.copy()
        droll = None
        if jitter is not None:
            poses_adj[:, 3] += jitter[0]
            poses_adj[:, 4] += jitter[1]
            droll = np.asarray(jitter[2], np.float32)
        cams = selfcal.cnc_to_cameras(poses_adj, theta_raw, float(W),
                                      float(H), droll=droll).numpy()
        theta = {**{n: float(theta_raw[i]) for i, n in
                    enumerate(selfcal.THETA_NAMES)}, "k1": k1}

        with stage("coverage"):
            per_view, coherence, hull_bbox = selfcal.coverage_for_cameras(
                masks, cams, bbox, seed=int(self.seed), device=dev)

        # ---- export per-image camera metadata (colmap.py:305-372) ----
        images_dict, statuses = {}, []
        for i, f in enumerate(files):
            fx, fy, cx, cy = (float(c) for c in cams[i, :4])
            R = cams[i, 4:13].reshape(3, 3)
            t = cams[i, 13:16]
            f.set_metadata("colmap_camera", {
                "camera_model": {
                    "model": "OPENCV",
                    "params": [fx, fy, cx, cy, k1, 0.0, 0.0, 0.0],
                    "width": W, "height": H,
                },
                "rotmat": R.tolist(),
                "tvec": t.tolist(),
            })
            gate = max(float(self.coverage_threshold),
                       float(self.coverage_rel) * float(np.median(per_view)))
            ok = float(per_view[i]) >= gate
            f.set_metadata("pose_estimation", "correct" if ok else "incorrect")
            statuses.append(ok)
            images_dict[str(i + 1)] = {
                "id": i + 1, "name": f.filename or f.id, "camera_id": 1,
                "qvec": _rotmat_to_qvec(R), "tvec": t.tolist(),
                "rotmat": R.tolist(),
            }

        outfs = self.output().get()
        fx, fy, cx, cy = (float(c) for c in cams[0, :4])
        cameras_dict = {"1": {"id": 1, "model": "OPENCV", "width": W,
                              "height": H,
                              "params": [fx, fy, cx, cy, k1, 0.0, 0.0, 0.0]}}
        io.write_json(outfs.get_file(COLMAP_CAMERAS_ID, create=True),
                      cameras_dict)
        io.write_json(outfs.get_file(COLMAP_IMAGES_ID, create=True),
                      images_dict)
        io.write_json(outfs.get_file("calibration", create=True), {
            "theta": theta,
            "coherence": coherence,
            "per_view_coverage": [float(c) for c in per_view],
            "silhouette_stage": {"theta": res["theta"],
                                 "coherence": res["coherence"]},
            "feature_ba": None if ba is None else {
                "theta": ba["theta"], "rms_px": ba["rms_px"],
                "n_matches": ba["n_matches"], "n_inliers": ba["n_inliers"],
                "n_tracks": ba["n_tracks"]},
            "dpan_view": None if jitter is None else
            np.asarray(jitter[0]).tolist(),
            "dtilt_view": None if jitter is None else
            np.asarray(jitter[1]).tolist(),
            "droll_view": None if jitter is None
            else np.asarray(jitter[2]).tolist(),
        })
        outfs.set_metadata("bounding_box", hull_bbox or bbox)

        check_blind_angle(statuses, self.max_blind_angle,
                          "consecutive low-coverage poses")


class Colmap(RomiTask):
    """Structure from motion by the external COLMAP binary (`COLMAP_EXE`,
    colmap/runner.py): fixed intrinsics from an IntrinsicCalibration scan,
    or calibrated poses and camera from an ExtrinsicCalibration scan; the
    model JSONs, the sparse cloud and the auto bounding box; per-image
    `colmap_camera`; the pose check against the CNC poses
    (`pose_estimation`, `euclidean_distances`, the blind-angle retry).
    Host code only: nothing runs on the card."""

    upstream_task = Parameter(default="ImagesFilesetExists")
    matcher = Parameter(default="exhaustive")
    camera_model = Parameter(default="SIMPLE_RADIAL")
    compute_dense = Parameter(default=False)
    align_pcd = Parameter(default=True)
    use_gpu = Parameter(default=False)
    single_camera = Parameter(default=True)
    alignment_max_error = Parameter(default=10)
    distance_threshold = Parameter(default=5.0)
    max_blind_angle = Parameter(default=20.0)
    cli_args = Parameter(default={})
    bounding_box = Parameter(default=None)
    query = Parameter(default={})
    intrinsic_calibration_scan_id = Parameter(default="")
    extrinsic_calibration_scan_id = Parameter(default="")
    #: with an extrinsic calibration scan, also reuse its COLMAP camera as
    #: fixed intrinsics (reference tasks/colmap.py:538, default True there)
    use_calibration_camera = Parameter(default=True)

    retry_count = 10  # blind-angle retries (reference tasks/colmap.py:529)

    def run(self):
        from ..colmap import runner as colmap_runner
        from ..fsdb.geometry import PointCloud

        images_fs = self.input()[0].get(create=False) if isinstance(
            self.input(), (list, tuple)) else self.input().get(create=False)
        files = images_fs.get_files(query=self.query or None)

        cli_args = dict(self.cli_args or {})
        if self.extrinsic_calibration_scan_id:
            self._inject_calibrated_poses(files)
            if self.use_calibration_camera:
                # reuse the calibration run's COLMAP camera as fixed
                # intrinsics (reference tasks/colmap.py:660-661 +
                # camera.py:393-406)
                from ..camera import get_colmap_cameras_from_calib_scan
                calib_scan = self.ctx.db.get_scan(
                    str(self.extrinsic_calibration_scan_id))
                cam = next(iter(get_colmap_cameras_from_calib_scan(
                    calib_scan).values()))
                fe = cli_args.setdefault("feature_extractor", {})
                fe["--ImageReader.camera_model"] = str(cam["model"])
                fe["--ImageReader.camera_params"] = ",".join(
                    str(float(p)) for p in cam["params"])
                _freeze_intrinsics(cli_args)
                logger.info("fixed camera from calibration scan "
                            f"{calib_scan.id}: {cam['model']} {cam['params']}")
        elif self.intrinsic_calibration_scan_id:
            # the calibrated model's own COLMAP parameter layout, and the
            # mapper's BA kept from refining it (reference
            # tasks/colmap.py:662-664 + set_camera_params :614-648)
            params = camera_params_from_intrinsic_calibration(
                self.ctx.db, str(self.intrinsic_calibration_scan_id),
                str(self.camera_model))
            fe = cli_args.setdefault("feature_extractor", {})
            fe["--ImageReader.camera_params"] = ",".join(
                str(p) for p in params)
            _freeze_intrinsics(cli_args)
            logger.info("fixed intrinsics from calibration scan "
                        f"{self.intrinsic_calibration_scan_id}: {params}")

        runner = colmap_runner.ColmapRunner(
            files, matcher=str(self.matcher),
            compute_dense=bool(self.compute_dense),
            all_cli_args=cli_args, align_pcd=bool(self.align_pcd),
            use_gpu=bool(self.use_gpu), single_camera=bool(self.single_camera),
            alignment_max_error=self.alignment_max_error,
            camera_model=str(self.camera_model))
        points, images, cameras, sparse, dense_path, auto_bbox = runner.run()

        outfs = self.output().get()
        io.write_json(outfs.get_file(COLMAP_POINTS_ID, create=True), points)
        io.write_json(outfs.get_file(COLMAP_IMAGES_ID, create=True), images)
        io.write_json(outfs.get_file(COLMAP_CAMERAS_ID, create=True), cameras)
        io.write_point_cloud(outfs.get_file(COLMAP_SPARSE_ID, create=True),
                             PointCloud(sparse))
        if dense_path is not None:
            from ..fsdb import ply as plyio
            io.write_point_cloud(outfs.get_file(COLMAP_DENSE_ID, create=True),
                                 plyio.read_ply(dense_path))

        bbox = self.bounding_box or auto_bbox
        if bbox is not None:
            outfs.set_metadata("bounding_box", bbox)

        # export per-image camera metadata (reference colmap.py:305-372)
        from ..camera import compute_estimated_pose
        by_name = {im["name"]: im for im in images.values()}
        estimated = {}
        for f in files:
            im = by_name.get(f.filename) or by_name.get(f.id)
            if im is None:
                continue
            cam = cameras[str(im["camera_id"])]
            f.set_metadata("colmap_camera", {
                "camera_model": {
                    "model": cam["model"], "params": cam["params"],
                    "width": cam["width"], "height": cam["height"],
                },
                "rotmat": im["rotmat"],
                "tvec": im["tvec"],
            })
            estimated[f.id] = compute_estimated_pose(im["rotmat"], im["tvec"])

        self._pose_quality_check(files, estimated, outfs)

    def _inject_calibrated_poses(self, files):
        """Copy calibrated_pose metadata from an ExtrinsicCalibration scan
        after verifying the scans are compatible (reference
        tasks/colmap.py:234-312 + 682-707)."""
        calib_scan = self.ctx.db.get_scan(self.extrinsic_calibration_scan_id)
        if calib_scan is None:
            logger.warning("Extrinsic calibration scan not found: "
                           f"{self.extrinsic_calibration_scan_id}")
            return
        if not check_scan_parameters(self.ctx.scan, calib_scan):
            raise ValueError(
                f"scan '{self.ctx.scan.id}' cannot be calibrated by "
                f"'{calib_scan.id}': acquisition (ScanPath) parameters "
                "differ")
        if (calib_scan.path() / "pipeline.toml").exists():
            check_colmap_cfg({"single_camera": bool(self.single_camera),
                              "camera_model": str(self.camera_model)},
                             calib_scan)
        else:
            logger.warning(f"{calib_scan.id}: no pipeline.toml config "
                           "backup — skipping COLMAP parameter check")
        calib_imgs = calib_scan.get_fileset("images")
        if calib_imgs is None:
            return
        calib_files = calib_imgs.get_files()
        n_injected = 0
        for i, f in enumerate(files):
            # id-matched when possible; the reference pairs order-based
            src = calib_imgs.get_file(f.id)
            if src is None and i < len(calib_files):
                src = calib_files[i]
            pose = src.get_metadata("calibrated_pose") if src else None
            if pose is not None:
                f.set_metadata("calibrated_pose", pose)
                n_injected += 1
        if n_injected == 0:
            raise ValueError(
                f"calibration scan '{calib_scan.id}' provided no "
                "calibrated_pose metadata (run ExtrinsicCalibration or "
                "TurntableCalibration on it first)")
        logger.info(f"injected {n_injected}/{len(files)} calibrated poses "
                    f"from {calib_scan.id}")

    def _pose_quality_check(self, files, estimated, outfs):
        """Compare COLMAP camera centres against the CNC poses: a view is
        "correct" within `distance_threshold` (inclusive), or, without a
        CNC pose, when COLMAP registered it; then the blind-angle check
        (reference tasks/colmap.py:773-834)."""
        cnc = get_cnc_poses(self.ctx.scan)
        distances = {}
        statuses = []
        for f in sorted(files, key=lambda f: f.id):
            if f.id in cnc and f.id in estimated:
                d = float(np.linalg.norm(np.asarray(estimated[f.id])
                                         - cnc[f.id]))
                distances[f.id] = d
                ok = d <= float(self.distance_threshold)
            else:
                ok = f.id in estimated
            f.set_metadata("pose_estimation", "correct" if ok else "incorrect")
            statuses.append(ok)

        if distances:
            vals = np.array(list(distances.values()))
            io.write_json(outfs.get_file("euclidean_distances", create=True),
                          {"mean": float(vals.mean()), "std": float(vals.std()),
                           "distances": {k: float(v)
                                         for k, v in distances.items()}})
        check_blind_angle(statuses, self.max_blind_angle,
                          "consecutive bad poses")


def _freeze_intrinsics(cli_args):
    """Keep the mapper's bundle adjustment from refining the camera."""
    mapper = cli_args.setdefault("mapper", {})
    mapper["--Mapper.ba_refine_focal_length"] = "0"
    mapper["--Mapper.ba_refine_principal_point"] = "0"
    mapper["--Mapper.ba_refine_extra_params"] = "0"
