"""TPUSegNet as a torch `nn.Module` (port of
plant3dvision_tpu/models/segnet.py, a flax module).

Same architecture and the same numbers as the flax model, in NCHW:
- a 4x4 space-to-depth input (channel order (ph, pw, c), as the flax
  reshape gives it; `F.pixel_unshuffle` orders (c, ph, pw) and is not used),
  a 3x3 stem to widths[0], ResNet stages (the first block of every stage
  after the first has stride 2), a bilinear-upsample + skip-concat decoder,
  and a 1x1 float32 head that predicts n_classes * patch^2 subpixel logits,
  expanded by depth-to-space;
- flax `padding="SAME"`: a stride-2 3x3 convolution of an even input pads
  (0, 1), bottom and right only (PyTorch's `padding=1` would pad (1, 1) and
  shift the sampling grid), so the padding is computed per convolution and
  applied with `F.pad`;
- convolutions compute in the model's `dtype` (inputs, kernel and bias cast
  to it; the bias is added after the convolution, in that dtype); GroupNorm
  computes in float32 with flax's statistics (E[x^2] - E[x]^2 clipped at 0,
  epsilon 1e-6, num_groups = gcd(features, 32)); the head computes in
  float32, with TF32 off on the card.

Submodules carry flax's auto-names (Conv_0, GroupNorm_0, ResBlock_3, ...),
so a flax parameter path maps one to one onto a state_dict key
(models/checkpoint.py:state_dict_from_flax).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

#: plant3dvision_tpu/models/unet.py:SEGMENTATION_LABELS (models/unet.py
#: exports it too; it lives here so that unet.py can build on this module)
SEGMENTATION_LABELS = ["background", "flower", "fruit", "leaf", "pedicel", "stem"]


def _same_pads(size, k, s):
    """flax/XLA "SAME" padding (lo, hi) of one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def space_to_depth(x, p: int):
    """(B, C, H, W) -> (B, p*p*C, H/p, W/p), channel order (ph, pw, c)."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // p, p, W // p, p)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(B, p * p * C, H // p, W // p)


def depth_to_space(x, p: int):
    """(B, p*p*C, h, w) -> (B, C, h*p, w*p); inverse of space_to_depth."""
    B, Cpp, h, w = x.shape
    C = Cpp // (p * p)
    x = x.reshape(B, p, p, C, h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(B, C, h * p, w * p)


class Conv(nn.Module):
    """flax `nn.Conv` with SAME padding: weight (out, in, k, k), bias (out,)."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, dtype):
        ph = _same_pads(x.shape[2], self.k, self.stride)
        pw = _same_pads(x.shape[3], self.k, self.stride)
        x = x.to(dtype)
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(x, self.weight.to(dtype), stride=self.stride)
        return y + self.bias.to(dtype).view(1, -1, 1, 1)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups=gcd(features, 32), dtype=float32)`."""

    def __init__(self, features, eps=1e-6):
        super().__init__()
        self.groups = math.gcd(features, 32)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x = x.to(torch.float32)
        B, C, H, W = x.shape
        G = self.groups
        xg = x.reshape(B, G, -1)
        mean = xg.mean(-1)
        var = torch.clamp((xg * xg).mean(-1) - mean * mean, min=0.0)
        mean = mean.repeat_interleave(C // G, dim=1).view(B, C, 1, 1)
        var = var.repeat_interleave(C // G, dim=1).view(B, C, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.float().view(1, C, 1, 1)
        return (x - mean) * mul + self.bias.float().view(1, C, 1, 1)


class ResBlock(nn.Module):
    def __init__(self, cin, features, stride=1):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, stride)
        self.GroupNorm_0 = GroupNorm(features)
        self.Conv_1 = Conv(features, features, 3)
        self.GroupNorm_1 = GroupNorm(features)
        if cin != features or stride != 1:
            self.Conv_2 = Conv(cin, features, 1, stride)

    def forward(self, x, dtype):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x, dtype)))
        h = self.GroupNorm_1(self.Conv_1(h, dtype))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x, dtype)
        return F.relu(h + x)


class ConvBlock(nn.Module):
    def __init__(self, cin, features):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3)
        self.GroupNorm_0 = GroupNorm(features)
        self.Conv_1 = Conv(features, features, 3)
        self.GroupNorm_1 = GroupNorm(features)

    def forward(self, x, dtype):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x, dtype)))
        return F.relu(self.GroupNorm_1(self.Conv_1(h, dtype)))


def _f32_head(conv, h):
    """The float32 1x1 head; on the card cuDNN would use TF32 by default."""
    if h.device.type != "cuda":
        return conv(h, torch.float32)
    cud = torch.backends.cudnn
    with cud.flags(enabled=cud.enabled, benchmark=cud.benchmark,
                   deterministic=cud.deterministic, allow_tf32=False):
        return conv(h, torch.float32)


class TPUSegNet(nn.Module):
    """forward(x: (B, 3, H, W) in [0, 1]) -> (B, n_classes, H, W) float32
    logits; H and W multiples of patch * 2^(len(widths) - 1)."""

    def __init__(self, n_classes=len(SEGMENTATION_LABELS),
                 widths=(128, 256, 256), blocks_per_stage=2, patch=4,
                 dtype=torch.bfloat16):
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.Conv_0 = Conv(3 * patch * patch, widths[0], 3)
        self.GroupNorm_0 = GroupNorm(widths[0])
        k, cin = 0, widths[0]
        for i, w in enumerate(widths):
            for b in range(blocks_per_stage):
                stride = 2 if (i > 0 and b == 0) else 1
                self.add_module(f"ResBlock_{k}", ResBlock(cin, w, stride))
                k, cin = k + 1, w
        self.n_res = k
        self.blocks_per_stage = blocks_per_stage
        h = widths[-1]
        for k, w in enumerate(reversed(widths[:-1])):
            self.add_module(f"ConvBlock_{k}", ConvBlock(h + w, w))
            h = w
        self.Conv_1 = Conv(widths[0], n_classes * patch * patch, 1)

    def forward(self, x):
        dt, p = self.dtype, self.patch
        h = space_to_depth(x.to(dt), p)
        h = F.relu(self.GroupNorm_0(self.Conv_0(h, dt)))
        skips = []
        for k in range(self.n_res):
            h = getattr(self, f"ResBlock_{k}")(h, dt)
            if (k + 1) % self.blocks_per_stage == 0:
                skips.append(h)
        h = skips[-1]
        for k, skip in enumerate(reversed(skips[:-1])):
            h = F.interpolate(h.to(torch.float32), size=skip.shape[2:],
                              mode="bilinear", align_corners=False).to(dt)
            h = torch.cat([h, skip], dim=1)        # promotes to float32
            h = getattr(self, f"ConvBlock_{k}")(h, dt)
        h = _f32_head(self.Conv_1, h)
        return depth_to_space(h.to(torch.float32), p)
