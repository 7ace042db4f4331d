"""Quality metrics (port of plant3dvision_tpu/metrics.py; role of reference
plant3dvision/metrics.py).

Point-set metrics are host queries through scipy's cKDTree (where the JAX
package uses scikit-learn's KDTree); equal nearest-neighbour distances go
to the lower index. The mask comparisons count on the host; the ground
truth's dilation is the dilate kernel (`ops/masks.py:binary_dilation`,
K8) on the caller's device, its plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .fsdb.geometry import PointCloud
from .runtime.log import configure_logger

logger = configure_logger(__name__)


def _points(pcd):
    return np.asarray(pcd.points if hasattr(pcd, "points") else pcd)


def nearest(ref, qry):
    """(dist, idx) of each query point's nearest reference point; equal
    distances (up to 4 of them) go to the lower index."""
    from scipy.spatial import cKDTree
    k = min(4, len(ref))
    dist, idx = cKDTree(ref).query(qry, k=k)
    dist = dist.reshape(len(qry), k)
    idx = idx.reshape(len(qry), k)
    first = np.lexsort((idx, dist), axis=1)[:, :1]
    return (np.take_along_axis(dist, first, axis=1)[:, 0],
            np.take_along_axis(idx, first, axis=1)[:, 0])


# -- point cloud metrics (reference metrics.py:16-95) ---------------------

def chamfer_distance(ref_pcd, flo_pcd):
    """Symmetric mean squared nearest-neighbor distance
    (reference metrics.py:16-55)."""
    ref = _points(ref_pcd)
    flo = _points(flo_pcd)
    if len(ref) == 0 or len(flo) == 0:
        return float("nan")
    d1, _ = nearest(ref, flo)
    d2, _ = nearest(flo, ref)
    return float((d1 ** 2).mean() + (d2 ** 2).mean())


def point_cloud_registration_fitness(ref_pcd, flo_pcd, max_distance=2.0):
    """(fitness, inlier_rmse) as in open3d evaluate_registration
    (reference metrics.py:58-95): fitness = |inlier corr| / |flo|,
    rmse over inlier correspondences."""
    ref = _points(ref_pcd)
    flo = _points(flo_pcd)
    if len(ref) == 0 or len(flo) == 0:
        return 0.0, float("nan")
    d, _ = nearest(ref, flo)
    inlier = d <= max_distance
    if inlier.sum() == 0:
        return 0.0, float("nan")
    fitness = float(inlier.mean())
    rmse = float(np.sqrt((d[inlier] ** 2).mean()))
    return fitness, rmse


# -- set metrics (reference metrics.py:105-272) -----------------------------

class SetMetrics:
    """Accumulating tp/fp/tn/fn over mask pairs, with precision/recall/mIoU."""

    def __init__(self, groundtruth=None, prediction=None):
        self.tp = self.fp = self.tn = self.fn = 0
        self._n = 0
        self._miou_sum = 0.0
        if groundtruth is not None and prediction is not None:
            self.add(groundtruth, prediction)

    def add(self, groundtruth, prediction):
        gt = np.asarray(groundtruth) != 0
        pr = np.asarray(prediction) != 0
        tp = int(np.sum(gt & pr))
        fp = int(np.sum(~gt & pr))
        tn = int(np.sum(~gt & ~pr))
        fn = int(np.sum(gt & ~pr))
        self.tp += tp
        self.fp += fp
        self.tn += tn
        self.fn += fn
        union = tp + fp + fn
        self._miou_sum += (tp / union) if union else 1.0
        self._n += 1

    def __add__(self, other: "SetMetrics"):
        out = SetMetrics()
        for k in ("tp", "fp", "tn", "fn"):
            setattr(out, k, getattr(self, k) + getattr(other, k))
        out._n = self._n + other._n
        out._miou_sum = self._miou_sum + other._miou_sum
        return out

    def precision(self):
        d = self.tp + self.fp
        return self.tp / d if d else None

    def recall(self):
        d = self.tp + self.fn
        return self.tp / d if d else None

    def miou(self):
        return self._miou_sum / self._n if self._n else None

    def as_dict(self):
        return {"tp": self.tp, "fp": self.fp, "tn": self.tn, "fn": self.fn,
                "precision": self.precision(), "recall": self.recall(),
                "miou": self.miou()}


def dilate_masks(masks, radius, device="cuda"):
    """(..., H, W) masks != 0, dilated by the exact disk of `radius` on
    `device` (K8 on the card, its plain version on the CPU), as a host
    bool array."""
    from .ops.masks import binary_dilation
    m = torch.from_numpy(np.ascontiguousarray(np.asarray(masks) != 0))
    return binary_dilation(m.to(device), int(radius)).cpu().numpy()


class CompareMasks(SetMetrics):
    """Pair comparison with optional dilation of the ground truth
    (reference metrics.py:207-272), the dilation on `device`."""

    def __init__(self, groundtruth, prediction, dilation_amount=0,
                 device="cuda"):
        super().__init__()
        if dilation_amount > 0:
            groundtruth = dilate_masks(groundtruth, dilation_amount, device)
        self.add(groundtruth, prediction)


class CompareMaskFilesets:
    """Compare two mask filesets matched by (shot_id, channel)
    (reference metrics.py:275-381). Without dilation a pair is read and
    counted at a time. With it, one label's ground-truth masks at a time
    are read and dilated as one stack (one call on `device` for each mask
    shape), and its predictions read and counted one by one. The counts per
    file and per label, and the order they are summed in, are the JAX
    package's."""

    def __init__(self, groundtruth_fileset, prediction_fileset, labels,
                 dilation_amount=0, device="cuda"):
        from .fsdb import io
        self.results = {"evaluation-results": {}}
        index = {}
        for f in groundtruth_fileset.get_files():
            key = (f.get_metadata("shot_id"), f.get_metadata("channel"))
            index[key] = f
        pairs = []          # (prediction file, label, ground-truth file)
        for pf in prediction_fileset.get_files():
            key = (pf.get_metadata("shot_id"), pf.get_metadata("channel"))
            if key[1] in labels and key in index:
                pairs.append((pf, key[1], index[key]))
        counts = [None] * len(pairs)
        if dilation_amount > 0:
            by_label = {}
            for i, (_, label, _) in enumerate(pairs):
                by_label.setdefault(label, []).append(i)
            for sel in by_label.values():
                gts = [io.read_image(pairs[i][2]) for i in sel]
                stacks = {}     # mask shape -> positions in sel
                for j, gt in enumerate(gts):
                    stacks.setdefault(gt.shape, []).append(j)
                for js in stacks.values():
                    stack = dilate_masks(np.stack([gts[j] for j in js]),
                                         dilation_amount, device)
                    for k, j in enumerate(js):
                        gts[j] = stack[k]
                for j, i in enumerate(sel):
                    counts[i] = SetMetrics(gts[j], io.read_image(pairs[i][0]))
        else:
            for i, (pf, _, gf) in enumerate(pairs):
                counts[i] = SetMetrics(io.read_image(gf), io.read_image(pf))
        per_label = {label: SetMetrics() for label in labels}
        for (pf, label, _), m in zip(pairs, counts):
            per_label[label] = per_label[label] + m
            self.results["evaluation-results"][pf.id] = m.as_dict()
        self.results["label-results"] = {
            label: m.as_dict() for label, m in per_label.items()}


class CompareSegmentedPointClouds:
    """Bidirectional NN label transfer between two labelled point clouds
    (reference metrics.py:384-519)."""

    def __init__(self, gt_pcd: PointCloud, gt_labels, pred_pcd: PointCloud,
                 pred_labels):
        gt_pts = np.asarray(gt_pcd.points)
        pr_pts = np.asarray(pred_pcd.points)
        gt_lab = np.asarray(gt_labels)
        pr_lab = np.asarray(pred_labels)
        res = {}
        labels = sorted(set(gt_lab) | set(pr_lab))
        # gt -> pred
        _, i1 = nearest(pr_pts, gt_pts)
        transfer1 = pr_lab[i1]
        # pred -> gt
        _, i2 = nearest(gt_pts, pr_pts)
        transfer2 = gt_lab[i2]
        for label in labels:
            m = SetMetrics()
            m.add(gt_lab == label, transfer1 == label)
            m.add(transfer2 == label, pr_lab == label)
            res[label] = m.as_dict()
        miou = [v["miou"] for v in res.values() if v["miou"] is not None]
        self.results = {"per-label": res,
                        "miou": float(np.mean(miou)) if miou else None}


# -- mesh ratios (reference metrics.py:522-586) ------------------------------

def surface_ratio(pred_mesh, gt_mesh):
    ga = gt_mesh.surface_area()
    return pred_mesh.surface_area() / ga if ga else float("nan")


def volume_ratio(pred_mesh, gt_mesh):
    gv = gt_mesh.volume()
    return pred_mesh.volume() / gv if gv else float("nan")
