"""Cross-scan repeatability analysis (port of plant3dvision_tpu/compare.py;
role of reference compare.py).

Pairwise comparison of pipeline outputs across replicated scans, used by
`python -m plant3dvision_tpu_torch.tools.robustness_evaluation`:
intrinsics spread, pose variability, masks, point clouds, voxels, meshes,
skeletons, angle sequences. Host code, as in the JAX package; the masks'
dilation runs on `device` (K8 on the card).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np

from .fsdb import io
from .runtime.log import configure_logger
from .utils import locate_task_filesets

logger = configure_logger(__name__)


def _task_fileset(scan, task_name):
    fs_id = locate_task_filesets(scan, [task_name])[task_name]
    return scan.get_fileset(fs_id) if fs_id != "None" else None


def compare_intrinsics(scans):
    """Spread of per-scan camera intrinsics (reference compare.py:257)."""
    rows = {}
    for scan in scans:
        fs = _task_fileset(scan, "Colmap")
        if fs is None:
            continue
        f = fs.get_file("cameras")
        if f is None:
            continue
        cams = io.read_json(f)
        for cid, cam in cams.items():
            rows.setdefault(scan.id, cam["params"])
    if not rows:
        return {}
    arr = np.array(list(rows.values()), dtype=float)
    return {"per_scan": rows,
            "mean": arr.mean(axis=0).tolist(),
            "std": arr.std(axis=0).tolist(),
            "cv_percent": (100 * arr.std(axis=0)
                           / np.maximum(np.abs(arr.mean(axis=0)), 1e-12)).tolist()}


def compare_poses(scans):
    """Per-image estimated camera center variability (compare.py:407)."""
    per_image = {}
    for scan in scans:
        images = scan.get_fileset("images")
        if images is None:
            continue
        for f in images.get_files():
            cam = f.get_metadata("colmap_camera") or f.get_metadata("camera")
            if not cam:
                continue
            from .camera import compute_estimated_pose
            c = compute_estimated_pose(cam["rotmat"], cam["tvec"])
            per_image.setdefault(f.id, []).append(c)
    out = {}
    for fid, centers in per_image.items():
        arr = np.asarray(centers)
        if len(arr) > 1:
            out[fid] = {"mean": arr.mean(axis=0).tolist(),
                        "std": arr.std(axis=0).tolist(),
                        "spread": float(np.linalg.norm(arr.std(axis=0)))}
    return out


def compare_masks(scans, dilation=0, task="Masks", device="cuda"):
    """Pairwise mask precision/recall across replicated scans
    (compare.py:679). `task` selects the output fileset to compare
    (Masks or Segmentation2D); a dilation runs on `device`."""
    from .metrics import CompareMasks
    results = {}
    filesets = [(s, _task_fileset(s, task)) for s in scans]
    filesets = [(s, fs) for s, fs in filesets if fs is not None]
    for (s1, f1), (s2, f2) in itertools.combinations(filesets, 2):
        key = f"{s1.id}-vs-{s2.id}"
        pair = []
        for fa in f1.get_files():
            fb = f2.get_file(fa.id)
            if fb is None:
                continue
            m = CompareMasks(io.read_image(fa), io.read_image(fb), dilation,
                             device=device)
            pair.append(m.as_dict())
        if pair:
            results[key] = {
                "mean_precision": float(np.mean([p["precision"] for p in pair
                                                 if p["precision"] is not None])),
                "mean_recall": float(np.mean([p["recall"] for p in pair
                                              if p["recall"] is not None])),
                "n_pairs": len(pair)}
    return results


def compare_point_clouds(scans, max_distance=2.0):
    """Pairwise chamfer + registration fitness (compare.py:733)."""
    from .metrics import chamfer_distance, point_cloud_registration_fitness
    results = {}
    pcds = []
    for s in scans:
        fs = _task_fileset(s, "PointCloud")
        if fs is not None and fs.get_files():
            pcds.append((s, io.read_point_cloud(fs.get_files()[0])))
    for (s1, p1), (s2, p2) in itertools.combinations(pcds, 2):
        fit, rmse = point_cloud_registration_fitness(p1, p2, max_distance)
        results[f"{s1.id}-vs-{s2.id}"] = {
            "chamfer": chamfer_distance(p1, p2),
            "fitness": fit, "inlier_rmse": rmse}
    return results


def compare_voxels(scans, threshold=0.5):
    """Pairwise voxel IoU (compare.py:792)."""
    results = {}
    vols = []
    for s in scans:
        fs = _task_fileset(s, "Voxels")
        if fs is not None and fs.get_files():
            v = io.read_npz(fs.get_files()[0])
            key = list(v.keys())[0]
            vols.append((s, v[key]))
    for (s1, v1), (s2, v2) in itertools.combinations(vols, 2):
        if v1.shape != v2.shape:
            continue
        a = v1 > threshold
        b = v2 > threshold
        inter = np.sum(a & b)
        union = np.sum(a | b)
        results[f"{s1.id}-vs-{s2.id}"] = {
            "iou": float(inter / union) if union else None}
    return results


def compare_meshes(scans):
    """Pairwise surface/volume ratios (compare.py:952)."""
    from .metrics import surface_ratio, volume_ratio
    results = {}
    meshes = []
    for s in scans:
        fs = _task_fileset(s, "TriangleMesh")
        if fs is not None and fs.get_files():
            meshes.append((s, io.read_triangle_mesh(fs.get_files()[0])))
    for (s1, m1), (s2, m2) in itertools.combinations(meshes, 2):
        results[f"{s1.id}-vs-{s2.id}"] = {
            "surface_ratio": surface_ratio(m1, m2),
            "volume_ratio": volume_ratio(m1, m2)}
    return results


def compare_skeletons(scans):
    """Pairwise chamfer of skeleton nodes (compare.py:1010)."""
    from .metrics import chamfer_distance
    results = {}
    skels = []
    for s in scans:
        fs = _task_fileset(s, "CurveSkeleton")
        if fs is not None and fs.get_files():
            skels.append((s, np.asarray(io.read_json(fs.get_files()[0])["points"])))
    for (s1, p1), (s2, p2) in itertools.combinations(skels, 2):
        results[f"{s1.id}-vs-{s2.id}"] = {"chamfer": chamfer_distance(p1, p2)}
    return results


def compare_angles(scans, free_ends=0.4):
    """Pairwise DTW of angle/internode sequences (compare.py:1059)."""
    from .evaluation import align_sequences
    results = {}
    seqs = []
    for s in scans:
        fs = _task_fileset(s, "AnglesAndInternodes")
        if fs is None:
            continue
        f = fs.get_file("AnglesAndInternodes")
        if f is None:
            continue
        seq = io.read_json(f)
        if seq.get("angles"):
            seqs.append((s, seq))
    for (s1, q1), (s2, q2) in itertools.combinations(seqs, 2):
        res = align_sequences(q1["angles"], q1["internodes"],
                              q2["angles"], q2["internodes"],
                              free_ends=free_ends)
        results[f"{s1.id}-vs-{s2.id}"] = {
            "mean_angle_error": res["mean_angle_error"],
            "mean_internode_error": res["mean_internode_error"],
            "normalized_cost": res["normalized_cost"]}
    return results


def compare_to_cnc_poses(scans):
    """Estimated camera centers vs the CNC hardware poses
    (reference compare.py:492-581): per-image distance to the CNC pose
    and to the cross-replicate mean pose, plus per-replicate and global
    means."""
    from .camera import compute_estimated_pose
    from .tasks.colmap import get_cnc_poses

    cnc = {}
    for scan in scans:
        cnc = get_cnc_poses(scan)
        if cnc:
            break
    if not cnc:
        logger.warning("compare_to_cnc_poses: no CNC poses in any scan")
        return {}

    est = {}  # {scan_id: {img_id: center}}
    for scan in scans:
        images = scan.get_fileset("images")
        if images is None:
            continue
        for f in images.get_files():
            cam = f.get_metadata("colmap_camera")
            if cam:
                est.setdefault(scan.id, {})[f.id] = np.asarray(
                    compute_estimated_pose(cam["rotmat"], cam["tvec"]))

    dist2cnc = {}   # {img_id: [per-replicate distance]}
    by_image = {}
    for sid, poses in est.items():
        for im, c in poses.items():
            if im in cnc:
                dist2cnc.setdefault(im, []).append(
                    float(np.linalg.norm(c - cnc[im])))
                by_image.setdefault(im, []).append(c)
    if not dist2cnc:
        return {}
    mean_pose = {im: np.mean(np.asarray(cs), axis=0)
                 for im, cs in by_image.items()}
    dist2mean = {im: [float(np.linalg.norm(c - mean_pose[im])) for c in cs]
                 for im, cs in by_image.items()}
    per_rep = {}
    for sid, poses in est.items():
        ds = [float(np.linalg.norm(c - cnc[im]))
              for im, c in poses.items() if im in cnc]
        per_rep[sid] = float(np.mean(ds)) if ds else None
    return {
        "global_mean_distance_to_cnc": float(np.mean(
            [d for ds in dist2cnc.values() for d in ds])),
        "replicate_mean_distance_to_cnc": per_rep,
        "mean_distance_to_cnc": {im: float(np.mean(ds))
                                 for im, ds in dist2cnc.items()},
        "global_mean_distance_to_mean": float(np.mean(
            [d for ds in dist2mean.values() for d in ds])),
        "std_distance_to_mean": {im: float(np.std(ds))
                                 for im, ds in dist2mean.items()},
    }


def compare_to_calibrated_poses(scans, calibration_scan=None):
    """Estimated camera centers vs `calibrated_pose` metadata from an
    ExtrinsicCalibration scan (reference compare.py:584-676)."""
    from .camera import compute_estimated_pose

    calib = {}
    sources = ([calibration_scan] if calibration_scan is not None
               else list(scans))
    for scan in sources:
        images = scan.get_fileset("images")
        if images is None:
            continue
        for f in images.get_files():
            p = f.get_metadata("calibrated_pose")
            if p is not None:
                calib[f.id] = np.asarray(p[:3], dtype=float)
        if calib:
            break
    if not calib:
        logger.warning("compare_to_calibrated_poses: no calibrated_pose")
        return {}

    out = {}
    dists_all = []
    for scan in scans:
        images = scan.get_fileset("images")
        if images is None:
            continue
        ds = {}
        for f in images.get_files():
            cam = f.get_metadata("colmap_camera")
            if cam and f.id in calib:
                c = np.asarray(compute_estimated_pose(cam["rotmat"],
                                                      cam["tvec"]))
                ds[f.id] = float(np.linalg.norm(c - calib[f.id]))
        if ds:
            out[scan.id] = {"mean": float(np.mean(list(ds.values()))),
                            "per_image": ds}
            dists_all += list(ds.values())
    if not out:
        return {}
    return {"global_mean_distance_to_calibrated": float(np.mean(dists_all)),
            "per_replicate": out}


def compare_labelled_point_clouds(scans):
    """Pairwise label-transfer metrics on segmented point clouds
    (reference compare.py:862-949, via CompareSegmentedPointClouds)."""
    from .metrics import CompareSegmentedPointClouds
    results = {}
    pcds = []
    for s in scans:
        fs = _task_fileset(s, "SegmentedPointCloud")
        if fs is None or not fs.get_files():
            continue
        f = fs.get_files()[0]
        pcd = io.read_point_cloud(f)
        labels = f.get_metadata("labels")
        if labels:
            pcds.append((s, pcd, labels))
    for (s1, p1, l1), (s2, p2, l2) in itertools.combinations(pcds, 2):
        cmp_ = CompareSegmentedPointClouds(p1, l1, p2, l2)
        results[f"{s1.id}-vs-{s2.id}"] = cmp_.results
    return results


# -- figure writers (reference compare.py:56-174) -------------------------

def pairwise_heatmap(pw_dict, metric, path, title=None):
    """Heatmap PNG of a pairwise comparison dict {'a-vs-b': {metric: v}}
    (reference compare.py:95-174)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ids = sorted({i for k in pw_dict for i in k.split("-vs-")})
    n = len(ids)
    mat = np.full((n, n), np.nan)
    for k, v in pw_dict.items():
        a, b = k.split("-vs-")
        val = v.get(metric)
        if val is None:
            continue
        i, j = ids.index(a), ids.index(b)
        mat[i, j] = mat[j, i] = val
    fig, ax = plt.subplots(figsize=(max(4, 0.6 * n), max(3, 0.5 * n)))
    im = ax.imshow(mat, cmap="viridis")
    ax.set_xticks(range(n), ids, rotation=90, fontsize=7)
    ax.set_yticks(range(n), ids, fontsize=7)
    fig.colorbar(im, ax=ax, label=metric)
    ax.set_title(title or metric)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def save_data_repartition(data, data_type, path):
    """Boxplot + histogram of a metric's distribution
    (reference compare.py:56-92)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.asarray([d for d in np.ravel(list(data)) if d is not None],
                      dtype=float)
    fig, axes = plt.subplots(1, 2, figsize=(8, 3))
    if len(data):
        axes[0].boxplot(data, orientation="vertical")
        axes[1].hist(data, bins=min(20, max(5, len(data) // 3)))
    axes[0].set_title(f"{data_type} boxplot")
    axes[1].set_title(f"{data_type} distribution")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def compare_clustered_meshes(scans):
    """Pairwise per-label chamfer between ClusteredMesh outputs (reference
    compare.py:952-1007): organ meshes are pooled by label, sampled, and
    compared replicate-vs-replicate."""
    from .metrics import chamfer_distance
    per_scan = {}
    for s in scans:
        fs = _task_fileset(s, "ClusteredMesh")
        if fs is None:
            continue
        pools = {}
        for f in fs.get_files():
            label = f.get_metadata("label") or "organ"
            mesh = io.read_triangle_mesh(f)
            pools.setdefault(label, []).append(np.asarray(mesh.vertices))
        per_scan[s.id] = {k: np.concatenate(v) for k, v in pools.items() if v}
    results = {}
    for (i1, p1), (i2, p2) in itertools.combinations(per_scan.items(), 2):
        entry = {}
        for label in sorted(set(p1) & set(p2)):
            from .fsdb.geometry import PointCloud as _P
            entry[f"chamfer_{label}"] = float(
                chamfer_distance(_P(p1[label]), _P(p2[label])))
        results[f"{i1}-vs-{i2}"] = entry
    return results


def compare_organ_segmentation(scans):
    """Pairwise organ-count and per-label point-count spread between
    OrganSegmentation outputs (reference compare.py role for the
    OrganSegmentation row of robustness_evaluation.json)."""
    per_scan = {}
    for s in scans:
        fs = _task_fileset(s, "OrganSegmentation")
        if fs is None:
            continue
        counts = {}
        n_pts = {}
        for f in fs.get_files():
            label = f.get_metadata("label") or "organ"
            counts[label] = counts.get(label, 0) + 1
            n_pts[label] = n_pts.get(label, 0) + len(io.read_point_cloud(f).points)
        per_scan[s.id] = {"organ_counts": counts, "point_counts": n_pts}
    results = {"per_replicate": per_scan}
    for (i1, d1), (i2, d2) in itertools.combinations(per_scan.items(), 2):
        diffs = {}
        for label in sorted(set(d1["organ_counts"]) | set(d2["organ_counts"])):
            diffs[label] = abs(d1["organ_counts"].get(label, 0)
                               - d2["organ_counts"].get(label, 0))
        results[f"{i1}-vs-{i2}"] = {"organ_count_diff": diffs}
    return results


#: Task -> comparison function(s). Values may be a single callable or a
#: LIST of callables (the reference's robustness_evaluation.json uses
#: multi-function lists for the pose tasks, tools/robustness_evaluation.json).
COMPARISON_FUNCTIONS = {
    "IntrinsicCalibration": compare_intrinsics,
    "Colmap": [compare_poses, compare_to_cnc_poses,
               compare_to_calibrated_poses, compare_intrinsics],
    "TurntableCalibration": [compare_to_cnc_poses, compare_poses],
    "ExtrinsicCalibration": [compare_to_cnc_poses, compare_intrinsics],
    "Masks": compare_masks,
    "Segmentation2D": functools.partial(compare_masks, task="Segmentation2D"),
    "Voxels": compare_voxels,
    "PointCloud": compare_point_clouds,
    "SegmentedPointCloud": compare_labelled_point_clouds,
    "TriangleMesh": compare_meshes,
    "ClusteredMesh": compare_clustered_meshes,
    "OrganSegmentation": compare_organ_segmentation,
    "CurveSkeleton": compare_skeletons,
    "AnglesAndInternodes": compare_angles,
}
