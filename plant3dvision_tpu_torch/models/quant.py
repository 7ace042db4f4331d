"""The dynamic int8 serving lane (port of plant3dvision_tpu/models/quant.py:
`int8_conv_general_dilated`, the flax conv hook behind
`segmentation_inference(conv_mode="int8")` and Segmentation2D's conv_mode).

Post-training and dynamic, as in the JAX package: each compute convolution
quantises its weights per output channel (scale absmax / 127 over (kh, kw,
cin)) and its activation per tensor (absmax / 127, taken on the fly), rounds
half to even and clips to +-127, convolves int8 x int8 into int32 sums and
dequantises to float32 before flax's bias add; the parameter tree is the
float lane's. The weights are constants of a call, so `int8_lane`
quantises them once per `segmentation_inference` call, not once per batch:
the result is the same.

XLA's arithmetic, read off its optimized HLO and x86 code on the CPU (the
kernel and the plain version repeat it):
- `/ 127.0` is a product by f32(1/127): sx = max(absmax(x), 1e-8) * f32(1/127),
  sw[k] = max(absmax(w[k]), 1e-12) * f32(1/127);
- x / sx is an IEEE division, then round-half-even and the clip;
- the dequantisation scale sx * sw[k] is reassociated: it is
  max_w[k] * (max_x * f32(1/127^2)), then y = float32(acc) * scale;
- inside the model flax's bias add is contracted with that product into
  one fused multiply-add: y = fma(float32(acc), scale, bias[k]) (with no bias,
  the product alone: the JAX hook's own output).

`int8_conv` is K16 on a CUDA tensor (kernels/csrc/int8conv.cu: the
"int8_absmax" launch takes the activation's absmax, the "int8_conv" launch
quantises the activation as it stages it, convolves on the int8 tensor
cores and dequantises; `quantize_weights`' one "int8_quantize" launch
quantises and packs all of a model's weights into one arena) and
`int8_conv_plain` on a CPU tensor. The plain version runs
the integer convolution exactly: F.conv2d in float64 on the int8 values
(every partial sum is an integer below 2^53; float32 would not be exact,
127^2 * 9 * 512 > 2^24), cuDNN off on the card (its FFT and Winograd
algorithms do not keep integers), then a cast to int32.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..ops.carving import fma_f32

#: f32(1/127) and f32(1/127^2), XLA's constants
INV127 = float(np.float32(1.0 / 127.0))
INV127_SQ = float(np.float32(1.0 / 16129.0))
#: the scales' floors (the activation's, the weights')
X_FLOOR = 1e-8
W_FLOOR = 1e-12

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclass
class QuantizedWeight:
    """A convolution's weight of `shape` (K, Cin, kh, kw) in the lane's
    form: `amax` (K,) float32, each output channel's absmax before its
    1e-12 floor, and the int8 values. The plain version gives them as `q`
    (K, kh, kw, Cp), the input channels zero-padded to Cp (a multiple of
    4); the kernel gives them only in the conv kernel's layout, `packed`
    (`plan`: `conv_plan`, `pack_weight`)."""

    amax: torch.Tensor
    shape: tuple
    q: torch.Tensor | None = None
    plan: ConvPlan | None = None
    packed: torch.Tensor | None = None

    @property
    def cin(self) -> int:
        return int(self.shape[1])


def _cp(c: int) -> int:
    return -(-int(c) // 4) * 4


def _f32(t):
    return t.to(torch.float32)


# -- plain versions --------------------------------------------------------------

def _quantize_plain(x, floor, per_group):
    """x (G, ...) float -> (q as float32 of the int8 values, absmax): the
    absmax over everything (per_group False, a 0-dim tensor) or over each
    x[g] (per_group True, (G,))."""
    xf = _f32(x)
    a = xf.abs()
    amax = a.flatten(1).amax(1) if per_group else a.amax()
    s = torch.clamp(amax, min=floor) * INV127
    s = s.view(-1, *([1] * (xf.ndim - 1))) if per_group else s
    q = torch.round(xf / s).clamp(-127.0, 127.0)
    return q, amax


def quantize_weight_plain(w) -> QuantizedWeight:
    """Plain version of the weight quantisation (w (K, Cin, kh, kw))."""
    q, amax = _quantize_plain(w, W_FLOOR, per_group=True)
    C = w.shape[1]
    q = F.pad(q.permute(0, 2, 3, 1), (0, _cp(C) - C)).to(torch.int8)
    return QuantizedWeight(amax, tuple(int(n) for n in w.shape),
                           q.contiguous())


def int8_conv_plain(x, w, bias, stride, pads):
    """Plain PyTorch version of `int8_conv` (same arguments, same result,
    bit for bit)."""
    qw = w if isinstance(w, QuantizedWeight) else quantize_weight_plain(w)
    if qw.q is None:
        raise ValueError("int8_conv_plain: the weight must carry q "
                         "(quantize_weight_plain)")
    (pt, pb), (pl, pr) = pads
    xq, xmax = _quantize_plain(x, X_FLOOR, per_group=False)
    wq = qw.q[..., :qw.cin].permute(0, 3, 1, 2).to(torch.float64)
    xq = F.pad(xq.to(torch.float64), (pl, pr, pt, pb))
    cud = torch.backends.cudnn
    with cud.flags(enabled=False, benchmark=cud.benchmark,
                   deterministic=cud.deterministic,
                   allow_tf32=cud.allow_tf32):
        acc = F.conv2d(xq, wq, stride=int(stride)).to(torch.int32)
    sx = torch.clamp(xmax, min=X_FLOOR) * INV127_SQ
    scale = (torch.clamp(qw.amax, min=W_FLOOR) * sx).view(1, -1, 1, 1)
    a = acc.to(torch.float32)
    if bias is None:
        return a * scale
    return fma_f32(a, scale, _f32(bias).view(1, -1, 1, 1))


# -- kernels -------------------------------------------------------------------

#: K16's conv tile configurations (int8conv.cu:conv_kernel): output
#: channels a block (NT), one per template instance, cfg 0..4
CONV_NT = (16, 32, 64, 128, 256)


@dataclass(frozen=True)
class ConvPlan:
    """How K16's conv cuts a weight (K, kh, kw, Cp): `cfg` the tile
    configuration (NT output channels a block), the depth in `nch` chunks of
    `cc` input channels x kh*kw taps, each chunk `dc` bytes deep (a multiple
    of 32, the fragment's depth; the depth order within a chunk is tap-major,
    then channel)."""

    cfg: int
    nt: int
    cc: int
    nch: int
    dc: int
    n_blocks: int


@functools.lru_cache(maxsize=None)
def conv_plan(K, kh, kw, cp) -> ConvPlan:
    """The conv kernel's cut of a (K, kh, kw, Cp) weight: a function of the
    weight's shape alone, so a weight is packed once."""
    K, taps, cp = int(K), int(kh) * int(kw), int(cp)
    cfg = next(i for i, nt in enumerate(CONV_NT)
               if nt >= min(K, CONV_NT[-1]))
    nt = CONV_NT[cfg]
    # shared memory for the two weight buffers of a block: 64 KB (96 KB at
    # NT = 256, whose chunks are otherwise too shallow), so that two blocks
    # fit on an SM
    w_smem = (96 if nt == 256 else 64) << 10
    dmax = min(1024, (w_smem // (2 * nt) - 16) // 32 * 32)
    # at most 64 channels a chunk: the staged rows hold them too
    cc_max = min(64, max(4, dmax // taps // 4 * 4))
    nch = -(-cp // cc_max)
    cc = -(-(-(-cp // nch)) // 4) * 4
    dc = -(-taps * cc // 32) * 32
    return ConvPlan(cfg, nt, cc, nch, dc, -(-K // nt))


def pack_weight(q, plan: ConvPlan):
    """q (K, kh, kw, Cp) int8 -> the conv kernel's weight layout
    (n_blocks, nch, NT, DC) int8: block nb's output channels nb*NT ..., chunk
    ch's input channels ch*CC ..., depth d = tap * CC + c within a chunk;
    zeros in every pad (channels past Cp, depth past kh*kw*CC, output
    channels past K)."""
    K, kh, kw, cp = (int(s) for s in q.shape)
    taps = kh * kw
    p = plan
    w = F.pad(q.reshape(K, taps, cp).to(torch.int16),
              (0, p.nch * p.cc - cp))                 # (K, taps, nch*CC)
    w = w.reshape(K, taps, p.nch, p.cc).permute(2, 0, 1, 3)
    w = F.pad(w.reshape(p.nch, K, taps * p.cc),
              (0, p.dc - taps * p.cc, 0, p.n_blocks * p.nt - K))
    w = w.reshape(p.nch, p.n_blocks, p.nt, p.dc).permute(1, 0, 2, 3)
    return w.to(torch.int8).contiguous()


def _dtype_code(name, t):
    if t.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: the CUDA kernel takes float32 or bfloat16, "
                         f"got {t.dtype}")
    return _DTYPE_CODE[t.dtype]


#: the most weights one "int8_quantize" launch takes (int8conv.cu
#: kMaxWeights)
MAX_WEIGHTS = 48


@dataclass(frozen=True)
class WeightSlot:
    """Where `quantize_weights` puts one weight (K, Cin, kh, kw) in its
    arena: byte offsets of `packed` (the conv's layout, `plan`), 16-byte
    aligned, and of `amax` (K,) float32."""

    shape: tuple
    plan: ConvPlan
    p_off: int
    a_off: int


@dataclass(frozen=True)
class WeightArena:
    """`quantize_weights`' arena for one list of weight shapes: a slot
    each, its bytes (each weight's packed layout, then all the amaxes back
    to back from float32 index `amax_at`, `ks` of them a weight), and the
    kernel's descriptor table without the weights' addresses and dtypes."""

    slots: tuple
    size: int
    amax_at: int
    ks: tuple
    table: np.ndarray


@functools.lru_cache(maxsize=64)
def weight_arena(shapes) -> WeightArena:
    """The arena of `quantize_weights` for weights of `shapes` (a tuple of
    (K, Cin, kh, kw))."""
    plans, end = [], 0
    for K, C, kh, kw in shapes:
        p = conv_plan(K, kh, kw, _cp(C))
        plans.append((p, end))
        end += -(-(p.n_blocks * p.nch * p.nt * p.dc) // 16) * 16
    slots = []
    table = np.zeros((len(shapes), 16), np.int64)
    a_off = end
    for i, ((K, C, kh, kw), (p, p_off)) in enumerate(zip(shapes, plans)):
        slots.append(WeightSlot((K, C, kh, kw), p, p_off, a_off))
        table[i, 1:11] = (p_off, a_off, 0, K, C, kh * kw, p.nt, p.cc, p.nch,
                          p.dc)
        a_off += 4 * K
    table.setflags(write=False)
    return WeightArena(tuple(slots), -(-a_off // 16) * 16, end // 4,
                       tuple(K for K, *_ in shapes), table)


def weight_table(ws, arena: WeightArena):
    """The kernel's descriptor table: a row of 16 int64 a weight (w's
    address, the packed and amax offsets, dtype code, K, Cin, kh*kw, NT,
    CC, nch, DC, five zeros)."""
    desc = arena.table.copy()
    desc[:, 0] = [w.data_ptr() for w in ws]
    desc[:, 3] = [_dtype_code("int8_quantize", w) for w in ws]
    return desc


def quantize_weights(ws) -> list:
    """Conv weights (K, Cin, kh, kw) in the lane's form, one
    `QuantizedWeight` each. On CUDA tensors one K16 launch
    ("int8_quantize") quantises up to MAX_WEIGHTS weights and writes each
    one's `packed` and `amax` into one arena (`weight_arena`); on CPU
    tensors `quantize_weight_plain` each."""
    ws = list(ws)
    if any(w.ndim != 4 for w in ws):
        raise ValueError("weight must be (K, Cin, kh, kw)")
    if not ws or all(w.device.type == "cpu" for w in ws):
        return [quantize_weight_plain(w) for w in ws]
    if len(ws) > MAX_WEIGHTS:
        raise ValueError(f"int8_quantize: one launch takes up to "
                         f"{MAX_WEIGHTS} weights, got {len(ws)}")
    ws = [w.contiguous() for w in ws]
    kernels.require_cuda("int8_quantize", *ws)
    lay = weight_arena(tuple(tuple(int(n) for n in w.shape) for w in ws))
    dev = ws[0].device
    arena = torch.empty(lay.size, dtype=torch.int8, device=dev)
    desc = weight_table(ws, lay)
    so, stream = kernels.lib(), kernels.stream_ptr(dev)
    rc = so.p3d_int8_quantize_weights(desc.ctypes.data, len(ws),
                                      arena.data_ptr(), W_FLOOR, stream)
    kernels.LAUNCHES["int8_quantize"] += 1
    kernels.check("int8_quantize", rc)
    amaxes = arena.view(torch.float32).narrow(
        0, lay.amax_at, sum(lay.ks)).split(lay.ks)
    out = []
    for sl, amax in zip(lay.slots, amaxes):
        p = sl.plan
        packed = arena.as_strided(
            (p.n_blocks, p.nch, p.nt, p.dc),
            (p.nch * p.nt * p.dc, p.nt * p.dc, p.dc, 1), sl.p_off)
        out.append(QuantizedWeight(amax, sl.shape, None, p, packed))
    return out


def quantize_weight(w) -> QuantizedWeight:
    """One conv weight (K, Cin, kh, kw) in the lane's form:
    `quantize_weights([w])[0]`."""
    return quantize_weights([w])[0]


def out_size(size, k, stride, lo, hi):
    return (int(size) + lo + hi - k) // int(stride) + 1


def activation_absmax(x):
    """K16's absmax launch ("int8_absmax"): the per-tensor absmax of x (any
    shape, float32 or bfloat16, on the card) as a (1,) float32 tensor."""
    kernels.require_cuda("int8_absmax", x)
    code = _dtype_code("int8_absmax", x)
    amax = torch.empty((1,), dtype=torch.float32, device=x.device)
    rc = kernels.lib().p3d_int8_absmax(x.data_ptr(), code, x.numel(),
                                       amax.data_ptr(),
                                       kernels.stream_ptr(x.device))
    kernels.LAUNCHES["int8_absmax"] += 1
    kernels.check("int8_absmax", rc)
    return amax


def conv_fused(x, xmax, qw, bias, stride, pads):
    """K16's conv launch ("int8_conv"): x (B, Cin, H, W) float32 or
    bfloat16 and its absmax (`activation_absmax`), a `QuantizedWeight`, a
    float32 bias (K,) or None, SAME pads ((top, bottom), (left, right)) ->
    (B, K, OH, OW) float32. The kernel quantises x as it stages it."""
    if qw.packed is None:
        raise ValueError("int8_conv: the weight must be quantised on the card "
                         "(quantize_weight of a CUDA tensor)")
    kernels.require_cuda("int8_conv", x, xmax, qw.amax, qw.packed,
                         *([] if bias is None else [bias]))
    code = _dtype_code("int8_conv", x)
    B, C, H, W = (int(s) for s in x.shape)
    if qw.cin != C:
        raise ValueError(f"int8_conv: weight takes {qw.cin} channels, x has "
                         f"{C}")
    K, _, kh, kw = qw.shape
    (pt, pb), (pl, pr) = pads
    OH, OW = out_size(H, kh, stride, pt, pb), out_size(W, kw, stride, pl, pr)
    p = qw.plan
    out = torch.empty((B, K, OH, OW), dtype=torch.float32, device=x.device)
    rc = kernels.lib().p3d_int8_conv(
        x.data_ptr(), code, qw.packed.data_ptr(), xmax.data_ptr(),
        qw.amax.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), B, C, H, W, K, kh, kw, int(stride), int(pt), int(pl),
        OH, OW, p.cfg, p.cc, p.nch, p.dc, p.n_blocks, X_FLOOR, W_FLOOR,
        kernels.stream_ptr(x.device))
    kernels.LAUNCHES["int8_conv"] += 1
    kernels.check("int8_conv", rc)
    return out


def int8_conv(x, w, bias, stride, pads):
    """The int8 lane's convolution of x (B, Cin, H, W) (float32 or bfloat16)
    with w (K, Cin, kh, kw) (float, or a `QuantizedWeight`), stride `stride`
    and pads ((top, bottom), (left, right)); then + bias (K,) (float; None:
    no bias). Returns (B, K, OH, OW) float32.

    A CUDA tensor goes to K16 (one "int8_absmax" launch and one "int8_conv"
    launch, which quantises x as it reads it), a CPU tensor to
    `int8_conv_plain`."""
    if x.ndim != 4:
        raise ValueError("x must be (B, Cin, H, W)")
    if x.device.type == "cpu":
        return int8_conv_plain(x, w, bias, stride, pads)
    qw = w if isinstance(w, QuantizedWeight) else quantize_weight(w)
    x = x.contiguous()
    b = None if bias is None else _f32(bias).contiguous()
    return conv_fused(x, activation_absmax(x), qw, b, stride, pads)


# -- the lane in a model -------------------------------------------------------

def compute_convs(model):
    """The convolutions the JAX models give `conv_impl`: every `Conv` but
    the model's float32 logits head (`Conv_1`)."""
    from .segnet import Conv
    head = getattr(model, "Conv_1", None)
    return [m for m in model.modules() if isinstance(m, Conv) and m is not head]


@contextlib.contextmanager
def int8_lane(model, on=True):
    """Runs `model`'s compute convolutions in the int8 lane inside the
    block: their weights, cast to the model's dtype as flax promotes them,
    are quantised on entry, all in one `quantize_weights` call, and dropped
    on exit."""
    convs = compute_convs(model) if on else []
    try:
        qws = quantize_weights([c.weight.detach().to(model.dtype)
                                for c in convs])
        for c, qw in zip(convs, qws):
            c.int8 = qw
        yield model
    finally:
        for c in convs:
            c.int8 = None
