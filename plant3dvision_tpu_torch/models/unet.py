"""The segmentation forward program (port of plant3dvision_tpu/models/unet.py:
`SEGMENTATION_LABELS` and `_fwd_program`).

ResUNet, the romiseg-parity architecture, is ported with the separate-task
ML route (Segmentation2D); this slice runs TPUSegNet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SEGMENTATION_LABELS = ["background", "flower", "fruit", "leaf", "pedicel", "stem"]


def forward_probs(model, batch):
    """Softmax label probabilities of a (B, H, W, 3) uint8 image batch, as
    (B, C, H, W) float32 — the JAX package's `_fwd_program` step by step:
    uint8 -> `model.dtype`, then / 255 in `model.dtype`; zero-pad bottom
    and right to a multiple of 32; the model (NCHW logits, float32); softmax
    in float32; crop to (H, W).

    `batch` lies on the device the model runs on (the caller uploads it).
    """
    if batch.dtype != torch.uint8 or batch.ndim != 4 or batch.shape[-1] != 3:
        raise ValueError("batch must be (B, H, W, 3) uint8")
    B, H, W, _ = batch.shape
    x = batch.to(model.dtype) / 255.0   # rounded to the model's dtype
    x = x.permute(0, 3, 1, 2)                          # (B, 3, H, W)
    ph, pw = (-H) % 32, (-W) % 32
    x = F.pad(x, (0, pw, 0, ph))
    with torch.no_grad():
        logits = model(x)
    probs = torch.softmax(logits.to(torch.float32), dim=1)
    return probs[:, :, :H, :W].contiguous()
