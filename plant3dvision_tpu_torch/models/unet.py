"""ResUNet and the segmentation forward program (port of
plant3dvision_tpu/models/unet.py: `ResUNet`, `_fwd_program`,
`segmentation_inference`).

ResUNet, the romiseg-parity architecture and the JAX package's default, is
a torch `nn.Module` in NCHW with the flax model's numbers:
- a 7x7 stride-2 SAME stem (flax pads an even input (2, 3), not PyTorch's
  (3, 3)), ResNet stages (the first block of every stage after the first
  has stride 2; a 1x1 SAME shortcut where the width or stride changes,
  which pads nothing), a bilinear-upsample + skip-concat decoder (resized
  in float32, rounded to the model's dtype, concatenated as [upsampled,
  skip]), a ConvBlock at half the stem width after the final 2x upsample
  to the padded input, and a float32 1x1 head with TF32 off;
- `norm="group"` (flax GroupNorm, models/segnet.py) or `norm="affine"`
  (`ChannelAffine`, the landing slot of folded BatchNorm checkpoints);
- submodules carry flax's auto-names in flax's creation order (Conv_0, the
  stem norm, ResBlock_*, ConvBlock_*, the head Conv_1; inside a block Conv_0,
  norm_0, Conv_1, norm_1, then the shortcut Conv_2), so `named_parameters()`
  enumerates the flax parameter tree in its traversal order
  (models/checkpoint.py relies on that for torch checkpoints).
The building blocks (SAME convolution, flax GroupNorm, float32 head) are
TPUSegNet's (models/segnet.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.carving import div_f32
from .segnet import SEGMENTATION_LABELS, Conv, GroupNorm, _f32_head


class ChannelAffine(nn.Module):
    """Per-channel y = x * scale + bias in float32 (no statistics): the
    inference form of a folded BatchNorm. Parameters named like GroupNorm's
    (`weight` = flax `scale`, `bias`)."""

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        C = x.shape[1]
        return (x.to(torch.float32) * self.weight.float().view(1, C, 1, 1)
                + self.bias.float().view(1, C, 1, 1))


def _make_norm(norm: str, features: int):
    return ChannelAffine(features) if norm == "affine" else GroupNorm(features)


def _norm_name(norm: str) -> str:
    return "ChannelAffine" if norm == "affine" else "GroupNorm"


class ConvBlock(nn.Module):
    def __init__(self, cin, features, norm="group"):
        super().__init__()
        n = _norm_name(norm)
        self.Conv_0 = Conv(cin, features, 3)
        self.add_module(f"{n}_0", _make_norm(norm, features))
        self.Conv_1 = Conv(features, features, 3)
        self.add_module(f"{n}_1", _make_norm(norm, features))
        self._norms = (f"{n}_0", f"{n}_1")

    def forward(self, x, dtype):
        n0, n1 = (getattr(self, n) for n in self._norms)
        h = F.relu(n0(self.Conv_0(x, dtype)))
        return F.relu(n1(self.Conv_1(h, dtype)))


class ResBlock(nn.Module):
    def __init__(self, cin, features, stride=1, norm="group"):
        super().__init__()
        n = _norm_name(norm)
        self.Conv_0 = Conv(cin, features, 3, stride)
        self.add_module(f"{n}_0", _make_norm(norm, features))
        self.Conv_1 = Conv(features, features, 3)
        self.add_module(f"{n}_1", _make_norm(norm, features))
        if cin != features or stride != 1:
            self.Conv_2 = Conv(cin, features, 1, stride)
        self._norms = (f"{n}_0", f"{n}_1")

    def forward(self, x, dtype):
        n0, n1 = (getattr(self, n) for n in self._norms)
        h = F.relu(n0(self.Conv_0(x, dtype)))
        h = n1(self.Conv_1(h, dtype))                    # float32
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x, dtype)
        return F.relu(h + x)                             # promotes to float32


class ResUNet(nn.Module):
    """forward(x: (B, 3, H, W) in [0, 1]) -> (B, n_classes, H, W) float32
    logits; H and W multiples of 32 (2 ** len(widths) for other depths)."""

    def __init__(self, n_classes=len(SEGMENTATION_LABELS),
                 widths=(64, 128, 256, 512), blocks_per_stage=2,
                 norm="group", dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.norm = norm
        self.blocks_per_stage = blocks_per_stage
        self.Conv_0 = Conv(3, widths[0], 7, 2)
        self.add_module(f"{_norm_name(norm)}_0", _make_norm(norm, widths[0]))
        k, cin = 0, widths[0]
        for i, w in enumerate(widths):
            for b in range(blocks_per_stage):
                stride = 2 if (i > 0 and b == 0) else 1
                self.add_module(f"ResBlock_{k}", ResBlock(cin, w, stride, norm))
                k, cin = k + 1, w
        self.n_res = k
        # decoder: one ConvBlock per skip (the stages but the last, then the
        # stem), at the skip's width, then one at half the stem width
        skip_widths = list(reversed([widths[0], *widths[:-1]]))
        h = widths[-1]
        for k, w in enumerate(skip_widths):
            self.add_module(f"ConvBlock_{k}", ConvBlock(h + w, w, norm))
            h = w
        self.add_module(f"ConvBlock_{len(skip_widths)}",
                        ConvBlock(h, widths[0] // 2, norm))
        self.n_dec = len(skip_widths)
        self.Conv_1 = Conv(widths[0] // 2, n_classes, 1)

    def forward(self, x):
        dt = self.dtype
        stem_norm = getattr(self, f"{_norm_name(self.norm)}_0")
        h = F.relu(stem_norm(self.Conv_0(x.to(dt), dt)))
        skips = [h]
        for k in range(self.n_res):
            h = getattr(self, f"ResBlock_{k}")(h, dt)
            if (k + 1) % self.blocks_per_stage == 0:
                skips.append(h)
        h = skips[-1]
        for k, skip in enumerate(reversed(skips[:-1])):
            h = F.interpolate(h.to(torch.float32), size=skip.shape[2:],
                              mode="bilinear", align_corners=False).to(dt)
            h = torch.cat([h, skip.to(dt)], dim=1)
            h = getattr(self, f"ConvBlock_{k}")(h, dt)
        h = F.interpolate(h.to(torch.float32), size=x.shape[2:],
                          mode="bilinear", align_corners=False).to(dt)
        h = getattr(self, f"ConvBlock_{self.n_dec}")(h, dt)
        return _f32_head(self.Conv_1, h).to(torch.float32)


def forward_probs(model, batch, tta=False, dtype=None):
    """Softmax label probabilities of a (B, H, W, 3) uint8 image batch, as
    (B, C, H, W) float32 — the JAX package's `_fwd_program` step by step:
    uint8 -> `dtype` (the model's by default), then / 255 in that dtype;
    zero-pad bottom and right to a multiple of 32; the model (NCHW logits,
    float32); softmax in float32; crop to (H, W). With `tta` the same for
    the horizontally flipped batch, cropped, flipped back, and averaged as
    0.5 * (p + p_flipped).

    `batch` lies on the device the model runs on (the caller uploads it).
    """
    if batch.dtype != torch.uint8 or batch.ndim != 4 or batch.shape[-1] != 3:
        raise ValueError("batch must be (B, H, W, 3) uint8")
    B, H, W, _ = batch.shape
    dt = dtype or model.dtype
    x = div_f32(batch.to(dt), 255.0)    # rounded to dt
    x = x.permute(0, 3, 1, 2)                          # (B, 3, H, W)
    ph, pw = (-H) % 32, (-W) % 32

    def apply(xu):
        with torch.no_grad():
            logits = model(F.pad(xu, (0, pw, 0, ph)))
        # crop before any un-flip: the zero padding is bottom/right
        return torch.softmax(logits.to(torch.float32), dim=1)[:, :, :H, :W]

    probs = apply(x)
    if tta:
        probs = 0.5 * (probs + apply(x.flip(3)).flip(3))
    return probs.contiguous()


def quantize_probs(probs):
    """(probs * 255 + 0.5) truncated to uint8, as `_fwd_program` ships them.
    For probabilities in [0, 1] this equals the fused multiply-add form
    (XLA may contract it): the sum can cross an integer only where the
    rounded product already does."""
    return (probs * 255.0 + 0.5).to(torch.uint8)


def segmentation_inference(model, images, batch_size=8,
                           compute_dtype="bfloat16", output_dtype="uint8",
                           tta=False, data_parallel="auto", conv_mode="bf16",
                           device=None):
    """Batched softmax inference over (N, H, W, 3) uint8 images (numpy) with
    `model` (an `nn.Module` holding its weights); returns the (N, n_classes,
    H, W) probabilities as a tensor on `device` (the model's by default), in
    `output_dtype`: "uint8" (probs * 255, rounded as `_fwd_program` does) or
    "float32".

    Every float parameter is cast to `compute_dtype` first (GroupNorm and
    the head included, as the JAX package casts its parameter tree); each
    layer then computes in its stated dtype. `data_parallel` shards batches
    over devices in the JAX package; the port runs on the one device.
    `conv_mode` "bf16" and "float" run the model as it is; "int8", the
    quantised serving lane, is not ported yet.
    """
    if conv_mode not in ("bf16", "float", "int8"):
        raise ValueError(f"conv_mode must be bf16|float|int8, got {conv_mode!r}")
    if conv_mode == "int8":
        raise NotImplementedError(
            "conv_mode='int8' (the dynamic int8 serving lane, "
            "plant3dvision_tpu/models/quant.py) is not ported yet: ROADMAP "
            "Queue A item 9")
    if output_dtype not in ("uint8", "float32"):
        raise ValueError(f"output_dtype must be uint8|float32, got "
                         f"{output_dtype!r}")
    imgs = np.asarray(images)
    if imgs.dtype != np.uint8 or imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise ValueError("images must be (N, H, W, 3) uint8")
    cdt = getattr(torch, compute_dtype)
    if device is None:
        device = next(model.parameters()).device
    model = model.to(device=device, dtype=cdt).eval()
    N, H, W, _ = imgs.shape
    out = None
    for i in range(0, N, int(batch_size)):
        batch = torch.from_numpy(imgs[i:i + int(batch_size)]).to(device)
        probs = forward_probs(model, batch, tta=tta, dtype=cdt)
        if out is None:
            out = torch.empty((N, probs.shape[1], H, W),
                              dtype=getattr(torch, output_dtype),
                              device=device)
        out[i:i + len(batch)] = (quantize_probs(probs)
                                 if output_dtype == "uint8" else probs)
    return out
