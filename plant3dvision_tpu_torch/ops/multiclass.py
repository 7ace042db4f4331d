"""Multiclass (per-label) voxel selection for the ML PointCloud task: the
select kernel and its plain PyTorch version.

Port of plant3dvision_tpu/ops/multiclass.py. Per voxel, the label scores of
the multi-label averaging volume are argmaxed with a background prior, then
each label's winning voxels are filtered by contrast and score (reference
tasks/proc3d.py:80-129). Background wins only when strictly greater than
every organ; among organs the first index wins. The per-label bool volumes
stay on the device and feed vol2pcd.

`select_labels` dispatches on the tensor's device: CUDA goes to the
hand-written kernel (kernels/csrc/select.cu), CPU to `select_labels_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels


def select_labels(stack, prior, min_contrast, min_score, bg, contrast_on):
    """stack (L, nx, ny, nz) float32 -> (L, nx, ny, nz) bool: per-label
    selected voxels (the background row, if any, is all False). `bg` is the
    background's row or None."""
    if stack.dtype != torch.float32 or stack.ndim < 2:
        raise ValueError("stack must be an (L, ...) float32 tensor")
    if stack.device.type == "cpu":
        return select_labels_plain(stack, prior, min_contrast, min_score, bg,
                                   contrast_on)
    kernels.require_cuda("multiclass_select", stack)
    L = stack.shape[0]
    if L > 8:
        raise ValueError("the select kernel takes at most 8 labels")
    out = torch.empty(stack.shape, dtype=torch.bool, device=stack.device)
    rc = kernels.lib().p3d_select(
        stack.data_ptr(), out.data_ptr(), L, stack[0].numel(),
        -1 if bg is None else int(bg), float(np.float32(prior)),
        float(np.float32(min_contrast)), float(np.float32(min_score)),
        int(bool(contrast_on)), kernels.stream_ptr(stack.device))
    kernels.LAUNCHES["multiclass_select"] += 1
    kernels.check("multiclass_select", rc)
    return out


def select_labels_plain(stack, prior, min_contrast, min_score, bg,
                        contrast_on):
    """Plain PyTorch version of the select kernel (the JAX program's
    operations, label by label)."""
    f32 = torch.float32
    prior = torch.tensor(np.float32(prior), device=stack.device)
    min_contrast = torch.tensor(np.float32(min_contrast), device=stack.device)
    min_score = torch.tensor(np.float32(min_score), device=stack.device)
    L = stack.shape[0]
    if bg is not None:
        stack = stack.clone()
        stack[bg] = stack[bg] * prior
        org = stack.clone()
        org[bg] = -torch.inf
    else:
        org = stack
    org_max = org.amax(dim=0)
    org_idx = org.argmax(dim=0)              # first max among organs
    if bg is not None:
        bg_wins = stack[bg] > org_max        # ties go to the organ
        res = torch.where(bg_wins, bg, org_idx)
    else:
        res = org_idx
    outs = []
    for i in range(L):
        if bg is not None and i == bg:
            outs.append(torch.zeros(stack.shape[1:], dtype=torch.bool,
                                    device=stack.device))
            continue
        score_i = stack[i]
        pred = torch.where(res == i, score_i, torch.zeros((), dtype=f32,
                                                          device=stack.device))
        if contrast_on:
            others = torch.cat([stack[:i], stack[i + 1:]]).amax(dim=0) \
                if L > 1 else torch.full_like(score_i, -torch.inf)
            pred = pred * (score_i > min_contrast * others).to(f32)
        outs.append(pred > min_score)
    return torch.stack(outs)


def multiclass_select(volumes, labels, background_prior=1.0,
                      min_contrast=10.0, min_score=0.2, device="cuda"):
    """volumes: {label: (nx, ny, nz) array or tensor}. Returns {label: bool
    volume} for every non-background label, on the volumes' device (numpy
    volumes are moved to `device`) — feed them straight to
    proc3d.vol2pcd."""
    from ..runtime.config import resolve_device

    def as_tensor(v):
        if torch.is_tensor(v):
            return v.to(torch.float32)
        return torch.from_numpy(np.asarray(v, np.float32)).to(
            resolve_device(device))

    stack = torch.stack([as_tensor(volumes[l]) for l in labels]).contiguous()
    bg = labels.index("background") if "background" in labels else None
    sel = select_labels(stack, background_prior, min_contrast, min_score, bg,
                        float(min_contrast) > 1.0)
    return {l: sel[i] for i, l in enumerate(labels) if l != "background"}
