"""Point -> mask reprojection scoring: the reproject kernel and its plain
PyTorch version.

Port of plant3dvision_tpu/ops/reproject.py (the reference
SegmentedPointCloud inner loop, tasks/proc3d.py:203-231). Per point and
mask file, in file order, the point is projected into the file's view
(truncating pixel cast, z > 0, border inclusive) and the mask value there
is added to the point's score for the file's label. The masks stay uint8
(the values the PNGs hold); each read is divided by 255 in float32, bit-equal
to the JAX task's `astype(float32) / 255.0` on the host.

`score_points_by_masks` dispatches on the tensors' device: CUDA goes to the
hand-written kernel (kernels/csrc/reproject.cu), CPU to
`score_points_by_masks_plain`.
"""

from __future__ import annotations

import torch

from .. import kernels
from .carving import _dot3_add, div_f32, fma_f32

#: the kernel holds a point's label sums in registers
MAX_LABELS = 8


def _check_args(points, masks, cameras, label_idx, n_labels):
    if points.dtype != torch.float32 or points.ndim != 2 \
            or points.shape[1] != 3:
        raise ValueError("points must be (N, 3) float32")
    if masks.dtype != torch.uint8 or masks.ndim != 3:
        raise ValueError("masks must be (F, H, W) uint8")
    F = masks.shape[0]
    if cameras.dtype != torch.float32 or tuple(cameras.shape) != (F, 16):
        raise ValueError("cameras must be (F, 16) float32")
    if label_idx.dtype != torch.int32 or tuple(label_idx.shape) != (F,):
        raise ValueError("label_idx must be (F,) int32")
    if not 1 <= n_labels <= MAX_LABELS:
        raise ValueError(f"n_labels must be 1..{MAX_LABELS}, got {n_labels}")


def score_points_by_masks(points, masks, cameras, label_idx, n_labels: int):
    """Per-label mask votes of every point: (N, n_labels) float32.

    points (N, 3) float32 world coordinates; masks (F, H, W) uint8 (one
    file per image x label); cameras (F, 16) float32 [fx,fy,cx,cy, R(9),
    t(3)]; label_idx (F,) int32; all on one device."""
    _check_args(points, masks, cameras, label_idx, n_labels)
    if points.device.type == "cpu":
        return score_points_by_masks_plain(points, masks, cameras, label_idx,
                                           n_labels)
    kernels.require_cuda("reproject_scores", points, masks, cameras,
                         label_idx)
    F, H, W = masks.shape
    scores = torch.empty((points.shape[0], n_labels), dtype=torch.float32,
                         device=points.device)
    rc = kernels.lib().p3d_reproject(
        points.data_ptr(), masks.data_ptr(), cameras.data_ptr(),
        label_idx.data_ptr(), points.shape[0], F, H, W, int(n_labels),
        scores.data_ptr(), kernels.stream_ptr(points.device))
    kernels.LAUNCHES["reproject_scores"] += 1
    kernels.check("reproject_scores", rc)
    return scores


def project_points(points, cam, hw):
    """(lin, in_img) of every point in one packed camera row: the flat pixel
    index (clipped into the frame) and whether the pixel is in it, in the
    f32 operations of the JAX program as XLA compiles it on the CPU (the
    carve's fused multiply-adds; see kernels/csrc/reproject.cu)."""
    H, W = hw
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    c = cam
    p0 = _dot3_add(c[4], c[5], c[6], x, y, z, c[13])
    p1 = _dot3_add(c[7], c[8], c[9], x, y, z, c[14])
    p2 = _dot3_add(c[10], c[11], c[12], x, y, z, c[15])
    pz = torch.where(p2 < 1e-9, torch.tensor(1e-9, dtype=torch.float32,
                                              device=p2.device), p2)
    # truncating, saturating casts (the clamp keeps them defined)
    lim = float(2 ** 31 - 128)
    px = fma_f32(p0 / pz, c[0], c[2]).nan_to_num(0.0).clamp(-lim, lim).long()
    py = fma_f32(p1 / pz, c[1], c[3]).nan_to_num(0.0).clamp(-lim, lim).long()
    in_img = (p2 > 0) & (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
    lin = py.clamp(0, H - 1) * W + px.clamp(0, W - 1)
    return lin, in_img


def score_points_by_masks_plain(points, masks, cameras, label_idx,
                                n_labels: int):
    """Plain PyTorch version of the reproject kernel: one file at a time,
    its values added to its label's column in file order."""
    F, H, W = masks.shape
    scores = torch.zeros((points.shape[0], n_labels), dtype=torch.float32,
                         device=points.device)
    flat = masks.reshape(F, H * W)
    for f in range(F):
        lab = int(label_idx[f])
        if not 0 <= lab < n_labels:
            continue
        lin, in_img = project_points(points, cameras[f], (H, W))
        vals = div_f32(flat[f][lin].to(torch.float32), 255.0)
        scores[:, lab] += torch.where(in_img, vals, 0.0)
    return scores
