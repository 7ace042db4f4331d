"""The training kernels and their plain PyTorch versions.

They replace the jitted training programs of the JAX package
(plant3dvision_tpu/models/train.py:98 `step`, train_synth.py:273
`run_chunk` and :297 `val_metrics`; the CUDA sources are in
kernels/csrc/train.cu):

- K20 `gather_batch`: a step's batch from the device-resident crop set:
  the crops at `idx`, one horizontal flip for the whole batch, colour
  gains, u8 * (gain * f32(1/255)) clipped to [0, 1] (NCHW float32; the
  product order XLA compiles `x / 255 * gains` to), and the
  labels gathered and flipped alike.
- K21 `weighted_cross_entropy`: optax's softmax cross-entropy with integer
  labels times the class weight, the mean, or with an ignored label the
  kept pixels' sum over max(kept, 1); a `torch.autograd.Function`. On the
  card one pass over the logits (`ce_fused`) gives the loss and the
  gradient at incoming gradient 1, as the JAX step's value_and_grad
  computes both; the backward's kernel reads the incoming gradient on the
  card and recomputes only when it is not 1 (`ce_backward`, also the
  general entry point). No host read either way.
- K22 `adamw_update` / `adamw_launcher`: optax's clip_by_global_norm then
  adamw (or adamw alone) over one flat arena of parameters, gradients and
  moments, one launch a step (cooperative with the clip); the per-step
  scalars (learning rate, bias corrections) are computed on the host by
  models/optim.py.
- K23 `iou_counts`: the first-max argmax of logits (or given predictions)
  and per-class intersection, union and label counts with an ignored
  label.

Each wrapper sends CUDA tensors to its kernel and CPU tensors to the plain
version, and raises on anything else; there is no fallback. The kernels
count their launches in `kernels.LAUNCHES` where they launch. Labels are
uint8 throughout (class indices below 255 and the ignored label 255). K21
counts a label >= C that is not ignored as class C - 1, as XLA clamps the
index of the JAX programs' `w[y]` (their cross-entropy gives NaN there);
K23 counts such a label only in its prediction's union.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

#: float32(1/255): XLA turns `x / 255` into a product by it
INV255 = float(np.float32(1.0 / 255.0))

_F32 = torch.float32
_U8 = torch.uint8


def _check(cond, msg):
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------- K20

def gather_batch(data_rgb, data_lab, idx, flip, gains):
    """data_rgb (N, c, c, 3) uint8, data_lab (N, c, c) uint8, idx (B,)
    int64, flip (1,) uint8 (nonzero: flip the whole batch left-right),
    gains (B, 3) float32 -> (x (B, 3, c, c) float32, y (B, c, c) uint8)."""
    _check(data_rgb.dtype == _U8 and data_rgb.ndim == 4
           and data_rgb.shape[-1] == 3 and data_rgb.shape[1] == data_rgb.shape[2],
           "data_rgb must be (N, c, c, 3) uint8")
    _check(data_lab.dtype == _U8 and data_lab.shape == data_rgb.shape[:3],
           "data_lab must be (N, c, c) uint8")
    B = idx.shape[0]
    _check(idx.dtype == torch.int64 and idx.ndim == 1, "idx must be (B,) int64")
    _check(flip.dtype == _U8 and flip.shape == (1,), "flip must be (1,) uint8")
    _check(gains.dtype == _F32 and gains.shape == (B, 3),
           "gains must be (B, 3) float32")
    if data_rgb.device.type == "cpu":
        return gather_batch_plain(data_rgb, data_lab, idx, flip, gains)
    kernels.require_cuda("batch_gather", data_rgb, data_lab, idx, flip, gains)
    c = data_rgb.shape[1]
    x = torch.empty((B, 3, c, c), dtype=_F32, device=data_rgb.device)
    y = torch.empty((B, c, c), dtype=_U8, device=data_rgb.device)
    rc = kernels.lib().p3d_gather_batch(
        data_rgb.data_ptr(), data_lab.data_ptr(), idx.data_ptr(),
        flip.data_ptr(), gains.data_ptr(), x.data_ptr(), y.data_ptr(), B, c,
        INV255, kernels.stream_ptr(data_rgb.device))
    kernels.LAUNCHES["batch_gather"] += 1
    kernels.check("batch_gather", rc)
    return x, y


def gather_batch_plain(data_rgb, data_lab, idx, flip, gains):
    """Plain PyTorch version of K20 (run_chunk's gather and flip, then
    loss_fn's `x.astype(f32) / 255 * gains` and clip)."""
    x = data_rgb[idx]
    y = data_lab[idx]
    f = flip.reshape(()).bool()
    x = torch.where(f, x.flip(2), x)
    y = torch.where(f, y.flip(2), y)
    B = x.shape[0]
    # XLA compiles `x / 255 * gains` as x * (gains * f32(1/255))
    xf = x.to(_F32) * (gains * INV255).view(B, 1, 1, 3)
    xf = torch.clamp(xf, 0.0, 1.0)
    return xf.permute(0, 3, 1, 2).contiguous(), y.contiguous()


# ---------------------------------------------------------------- K21

def _ce_args(logits, labels, weights, ignore_index):
    _check(logits.dtype == _F32 and logits.ndim == 4,
           "logits must be (B, C, H, W) float32")
    B, C = logits.shape[:2]
    _check(2 <= C <= 8, f"the cross-entropy takes 2-8 classes, got {C}")
    _check(labels.dtype == _U8 and labels.shape == (B, *logits.shape[2:]),
           "labels must be (B, H, W) uint8")
    _check(weights.dtype == _F32 and weights.shape == (C,),
           "weights must be (C,) float32")
    _check(ignore_index is None or 0 <= int(ignore_index) <= 255,
           "ignore_index must be None or a uint8 label")
    return -1 if ignore_index is None else int(ignore_index)


#: K21's scratch a device, kept between calls: (n of the last call, the
#: blocks' partial sums (float32, grown as a call needs more), ctl =
#: [ticket, kept count] (int64, zero between calls: the pass's last block
#: resets it)). Each device's training kernels run on one stream; two
#: passes in flight on two streams of one device would share it.
_CE_SCRATCH = {}


def _ce_scratch(dev, n):
    s = _CE_SCRATCH.get(dev)
    if s is None or s[0] != n:
        nb = kernels.lib().p3d_ce_blocks(n)
        part = s[1] if s is not None and s[1].numel() >= nb else \
            torch.empty(nb, dtype=_F32, device=dev)
        ctl = s[2] if s is not None else \
            torch.zeros(2, dtype=torch.int64, device=dev)
        s = _CE_SCRATCH[dev] = (n, part, ctl)
    return s[1], s[2]


def ce_fused(logits, labels, weights, ignore, grad=True):
    """K21's pass on the card: ((2,) float32 [loss, denominator], d loss /
    d logits at incoming gradient 1, or None without `grad`), from one
    read of the logits; one launch, two with an ignored label (`ignore` >=
    0: its kept pixels counted first)."""
    kernels.require_cuda("weighted_ce", logits, labels, weights)
    dev = logits.device
    B, C, H, W = logits.shape
    n = B * H * W
    part, ctl = _ce_scratch(dev, n)
    out = torch.empty(2, dtype=_F32, device=dev)
    d = torch.empty_like(logits) if grad else None
    rc = kernels.lib().p3d_ce(
        logits.data_ptr(), labels.data_ptr(), weights.data_ptr(), C, H * W,
        n, ignore, ctl.data_ptr(), part.data_ptr(), out.data_ptr(),
        d.data_ptr() if grad else None, kernels.stream_ptr(dev))
    kernels.LAUNCHES["weighted_ce"] += 1 if ignore < 0 else 2
    kernels.check("weighted_ce", rc)
    return out, d


def ce_forward(logits, labels, weights, ignore):
    """(2,) float32 [loss, denominator] of K21 (`ignore` -1 for none): the
    pass without its gradient on the card, else the plain version."""
    if logits.device.type == "cpu":
        return ce_forward_plain(logits, labels, weights, ignore)
    return ce_fused(logits, labels, weights, ignore, grad=False)[0]


def ce_forward_plain(logits, labels, weights, ignore):
    """Plain PyTorch version of K21's forward: optax's
    `logsumexp(l) - l[y]` (jax.nn.logsumexp: log(sum exp(l - max)) + max)
    times w[y]; the mean, or with an ignored label the kept pixels' sum
    over max(kept, 1)."""
    B, C = logits.shape[:2]
    lf = logits.reshape(B, C, -1)
    y = labels.reshape(B, 1, -1).long()
    keep = (y != ignore) if ignore >= 0 else None
    ys = torch.where(keep, y, 0) if keep is not None else y
    ys = ys.clamp(max=C - 1)
    m = lf.amax(1, keepdim=True)
    lse = torch.log(torch.exp(lf - m).sum(1, keepdim=True)) + m
    t = (lse - lf.gather(1, ys)) * weights[ys]
    if keep is None:
        denom = torch.tensor(float(t.numel()), dtype=_F32, device=t.device)
    else:
        t = t * keep.to(_F32)
        denom = torch.clamp(keep.sum().to(_F32), min=1.0)
    return torch.stack([t.sum() / denom, denom])


def ce_backward(logits, labels, weights, fwd, grad, ignore, stash=None):
    """d loss / d logits (B, C, H, W) of K21, given the forward's (2,)
    output and the (1,) incoming gradient: the kernel on the card (one
    launch), else the plain version. `stash` (card only) is K21's pass's
    gradient at incoming gradient 1: the kernel reads the incoming
    gradient on the card, leaves `stash` as it is when that is 1 and
    recomputes it in place otherwise; it is returned."""
    if logits.device.type == "cpu":
        return ce_backward_plain(logits, labels, weights, fwd, grad, ignore)
    kernels.require_cuda("weighted_ce_backward", logits, labels, weights,
                         fwd, grad)
    B, C, H, W = logits.shape
    d = torch.empty_like(logits) if stash is None else stash
    rc = kernels.lib().p3d_ce_backward(
        logits.data_ptr(), labels.data_ptr(), weights.data_ptr(),
        fwd.data_ptr(), grad.data_ptr(), C, H * W, B * H * W, ignore,
        int(stash is not None), d.data_ptr(),
        kernels.stream_ptr(logits.device))
    kernels.LAUNCHES["weighted_ce_backward"] += 1
    kernels.check("weighted_ce_backward", rc)
    return d


def ce_backward_plain(logits, labels, weights, fwd, grad, ignore):
    """Plain PyTorch version of K21's backward: with sc = (g / denom) *
    w[y] (0 where the label is ignored), exp(l - max) * (sc / sum) and
    -sc added at the label (the terms of XLA's autodiff of the forward)."""
    B, C = logits.shape[:2]
    lf = logits.reshape(B, C, -1)
    y = labels.reshape(B, 1, -1).long()
    keep = (y != ignore) if ignore >= 0 else None
    ys = torch.where(keep, y, 0) if keep is not None else y
    ys = ys.clamp(max=C - 1)
    sc = (grad.reshape(()) / fwd[1]) * weights[ys]
    if keep is not None:
        sc = torch.where(keep, sc, torch.zeros((), dtype=_F32,
                                               device=sc.device))
    e = torch.exp(lf - lf.amax(1, keepdim=True))
    d = e * (sc / e.sum(1, keepdim=True))
    onehot = torch.arange(C, device=lf.device).view(1, C, 1) == ys
    d = torch.where(onehot, d + (-sc), d)
    return d.reshape(logits.shape)


class _WeightedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, weights, ignore, want_grad):
        if logits.device.type == "cpu":
            out, d = ce_forward_plain(logits, labels, weights, ignore), None
        else:
            out, d = ce_fused(logits, labels, weights, ignore, want_grad)
        ctx.save_for_backward(logits, labels, weights, out)
        ctx.ignore = ignore
        ctx.stash = d
        return out[0]

    @staticmethod
    def backward(ctx, grad):
        logits, labels, weights, out = ctx.saved_tensors
        g = grad.reshape(1).to(_F32).contiguous()
        # the pass's gradient is handed out once: a second backward of the
        # graph (retain_graph) computes its own
        stash, ctx.stash = ctx.stash, None
        return (ce_backward(logits, labels, weights, out, g, ctx.ignore,
                            stash=stash), None, None, None, None)


def weighted_cross_entropy(logits, labels, weights, ignore_index=None):
    """K21: the weighted softmax cross-entropy of (B, C, H, W) float32
    logits against (B, H, W) uint8 labels, a 0-d float32 tensor with a
    backward. On the card one pass gives the loss and, when the logits
    need a gradient, the gradient at incoming gradient 1, which the
    backward hands on (recomputed by its kernel for any other incoming
    gradient). `ignore_index` (a uint8 label, e.g. 255) drops those pixels
    from the loss and its gradient."""
    ignore = _ce_args(logits, labels, weights, ignore_index)
    want_grad = torch.is_grad_enabled() and logits.requires_grad
    return _WeightedCE.apply(logits.contiguous(), labels.contiguous(),
                             weights.contiguous(), ignore, want_grad)


# ---------------------------------------------------------------- K22

#: K22's threads a block and elements a thread sums in order
#: (kernels/csrc/train.cu kThreads, kRun): the norm's chunk of
#: ADAMW_CHUNK elements, one partial sum of g^2 a chunk
_K22_THREADS, _K22_RUN = 256, 16
ADAMW_CHUNK = _K22_THREADS * _K22_RUN


def adamw_launcher(p, g, mu, nu, *, clip, b1, b2, eps, eps_root, wd,
                   max_norm=1.0, tp_sums=None):
    """K22 bound to flat float32 arenas p, g, mu, nu (one element a
    parameter): checks them and rounds the constant scalars to float32
    once, and returns step(bc1, bc2, neg_lr), which updates the arenas in
    place: with `clip`, optax's clip_by_global_norm(max_norm) first (g_norm
    = sqrt(sum g^2) over the whole arena); then adamw's moments, bias
    corrections (`bc1`, `bc2` = 1 - b^count), update, decayed weight (`wd`
    * p) and the step `neg_lr` * u added to p. The kernel on the card (one
    launch in both modes), else the plain version. The step holds the
    arenas and its own scratch.

    `tp_sums` (with `clip`) is the tp lane, for an arena that holds a part
    of the parameters (a rank of a tp group, models/optim.py): it takes
    the arena's chunk sums of g^2 (ADAMW_CHUNK elements a chunk, float32,
    on the arena's device) and returns the whole gradient's chunk sums in
    the norm's order. The step is then two launches, counted under
    "adamw_tp": the chunk sums (a warp a chunk), and after `tp_sums` the
    update with the norm of the sums it returned (a grid of its own), bit
    for bit the cooperative launch's two halves."""
    n = p.numel()
    for t in (p, g, mu, nu):
        _check(t.dtype == _F32 and t.ndim == 1 and t.numel() == n,
               "adamw_update takes flat float32 arenas of one length")
    lane = clip and tp_sums is not None
    if p.device.type == "cpu":
        def plain_step(bc1, bc2, neg_lr):
            gnorm = adamw_norm_plain(tp_sums(adamw_partials_plain(g))) \
                if lane else None
            adamw_update_plain(p, g, mu, nu, clip=clip, b1=b1, b2=b2,
                               bc1=bc1, bc2=bc2, eps=eps, eps_root=eps_root,
                               wd=wd, neg_lr=neg_lr, max_norm=max_norm,
                               gnorm=gnorm)
        return plain_step
    kernels.require_cuda("adamw", p, g, mu, nu)
    dev = p.device
    lib = kernels.lib()
    f = lambda v: float(np.float32(v))          # noqa: E731
    # the norm's chunk sums, owned by the step (clip mode only)
    part = torch.empty(lib.p3d_adamw_partials(n), dtype=_F32,
                       device=dev) if clip else None
    decays = (f(b1), f(b2), f(1 - b1), f(1 - b2))
    rest = (f(eps), f(eps_root), f(wd))
    norm = f(max_norm)
    if lane:
        def tp_step(bc1, bc2, neg_lr):
            st = kernels.stream_ptr(dev)
            rc = lib.p3d_adamw_tp_partials(g.data_ptr(), n, part.data_ptr(),
                                           st)
            kernels.LAUNCHES["adamw_tp"] += 1
            kernels.check("adamw_tp", rc)
            sums = tp_sums(part).contiguous()
            _check(sums.dtype == _F32 and sums.device == dev,
                   "tp_sums must return float32 sums on the arena's device")
            rc = lib.p3d_adamw_tp_update(
                p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), n,
                sums.data_ptr(), sums.numel(), *decays, float(bc1),
                float(bc2), *rest, float(neg_lr), norm,
                kernels.stream_ptr(dev))
            kernels.LAUNCHES["adamw_tp"] += 1
            kernels.check("adamw_tp", rc)
        return tp_step
    fn = lib.p3d_adamw
    mode = int(bool(clip))

    def step(bc1, bc2, neg_lr):
        rc = fn(p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), n,
                part.data_ptr() if clip else None, mode, *decays, float(bc1),
                float(bc2), *rest, float(neg_lr), norm,
                kernels.stream_ptr(dev))
        kernels.LAUNCHES["adamw"] += 1
        kernels.check("adamw", rc)
    return step


def adamw_update(p, g, mu, nu, *, clip, b1, b2, bc1, bc2, eps, eps_root,
                 wd, neg_lr, max_norm=1.0, tp_sums=None):
    """K22 once over the arenas (`adamw_launcher`'s step); scalars are
    float32 values (the caller rounds them)."""
    adamw_launcher(p, g, mu, nu, clip=clip, b1=b1, b2=b2, eps=eps,
                   eps_root=eps_root, wd=wd, max_norm=max_norm,
                   tp_sums=tp_sums)(bc1, bc2, neg_lr)


def _tree_sum(s):
    """K22's block_tree_sum over the last axis (_K22_THREADS values)."""
    w = s.shape[-1] // 2
    while w:
        s = s[..., :w] + s[..., w:2 * w]
        w //= 2
    return s[..., 0]


def adamw_partials_plain(g):
    """Plain version of the tp lane's first launch: the chunk sums of g^2
    in K22's order (a thread's run of _K22_RUN elements _K22_THREADS
    apart, then the block's tree), bit-equal to the kernel's."""
    n = g.numel()
    c = -(-n // ADAMW_CHUNK)
    v = torch.zeros(c * ADAMW_CHUNK, dtype=_F32, device=g.device)
    v[:n] = g
    sq = v.view(c, _K22_RUN, _K22_THREADS)
    sq = sq * sq
    acc = sq[:, 0]
    for r in range(1, _K22_RUN):
        acc = acc + sq[:, r]
    return _tree_sum(acc)


def adamw_norm_plain(sums):
    """sqrt of the sum of chunk sums in K22's order (sum_partials: thread
    t adds sums t, t + _K22_THREADS, ... in order, then the tree), a 0-d
    float32 tensor bit-equal to the kernel's."""
    m = sums.numel()
    k = -(-m // _K22_THREADS)
    v = torch.zeros(k * _K22_THREADS, dtype=_F32, device=sums.device)
    v[:m] = sums
    v = v.view(k, _K22_THREADS)
    acc = v[0]
    for i in range(1, k):
        acc = acc + v[i]
    return torch.sqrt(_tree_sum(acc))


def adamw_update_plain(p, g, mu, nu, *, clip, b1, b2, bc1, bc2, eps,
                       eps_root, wd, neg_lr, max_norm=1.0, gnorm=None):
    """Plain PyTorch version of K22 (optax's operations in their order);
    `gnorm`, with `clip`, is the tp lane's norm (`adamw_norm_plain`), else
    the whole arena's."""
    dev = p.device

    def s(v):
        return torch.tensor(np.float32(v), device=dev)

    if clip:
        if gnorm is None:
            gnorm = torch.sqrt((g * g).sum())
        g = torch.where(gnorm < s(max_norm), g, (g / gnorm) * s(max_norm))
    m = s(1 - b1) * g + s(b1) * mu
    v = s(1 - b2) * (g * g) + s(b2) * nu
    u = (m / s(bc1)) / (torch.sqrt(v / s(bc2) + s(eps_root)) + s(eps))
    u = u + s(wd) * p
    p.add_(s(neg_lr) * u)
    mu.copy_(m)
    nu.copy_(v)


# ---------------------------------------------------------------- K23

def iou_counts(labels, n_cls, logits=None, preds=None, ignore_index=None):
    """K23: (3, n_cls) int64 [intersection, union, label pixels] per class
    of the first-max argmax of (B, C, H, W) float32 `logits` (or of (B, H,
    W) uint8 `preds`) against (B, H, W) uint8 `labels`, pixels labelled
    `ignore_index` left out. On the card a memset of the counts and one
    launch, both on the current stream."""
    _check((logits is None) != (preds is None), "give logits or preds")
    _check(labels.dtype == _U8, "labels must be uint8")
    if logits is not None:
        _check(logits.dtype == _F32 and logits.ndim == 4
               and logits.shape[1] == n_cls
               and labels.shape == (logits.shape[0], *logits.shape[2:]),
               "logits must be (B, n_cls, H, W) float32 over the labels")
    else:
        _check(preds.dtype == _U8 and preds.shape == labels.shape,
               "preds must be uint8 of the labels' shape")
    _check(2 <= n_cls <= 8, f"iou_counts takes 2-8 classes, got {n_cls}")
    ignore = -1 if ignore_index is None else int(ignore_index)
    if labels.device.type == "cpu":
        return iou_counts_plain(labels, n_cls, logits, preds, ignore)
    src = logits if logits is not None else preds
    kernels.require_cuda("iou_counts", labels, src)
    counts = torch.empty((3, n_cls), dtype=torch.int64, device=labels.device)
    HW = labels[0].numel() if labels.ndim > 1 else labels.numel()
    rc = kernels.lib().p3d_iou_counts(
        logits.data_ptr() if logits is not None else None,
        preds.data_ptr() if preds is not None else None,
        labels.data_ptr(), n_cls, HW, labels.numel(), ignore,
        counts.data_ptr(), kernels.stream_ptr(labels.device))
    kernels.LAUNCHES["iou_counts"] += 1
    kernels.check("iou_counts", rc)
    return counts


def iou_counts_plain(labels, n_cls, logits=None, preds=None, ignore=-1):
    """Plain PyTorch version of K23 (val_metrics' per-class sums)."""
    pred = logits.argmax(1) if logits is not None else preds.long()
    lab = labels.long()
    keep = lab != ignore if ignore >= 0 else torch.ones_like(lab,
                                                             dtype=torch.bool)
    rows = []
    for c in range(n_cls):
        sel = (lab == c) & keep
        hit = (pred == c) & keep
        rows.append(torch.stack([(sel & hit).sum(), (sel | hit).sum(),
                                 sel.sum()]))
    return torch.stack(rows, 1).to(torch.int64)


def iou_from_counts(counts):
    """val_metrics' IoU a class from K23's counts (numpy, float32): tp /
    max(union, 1) where the class has pixels, else -1."""
    c = np.asarray(counts.cpu() if torch.is_tensor(counts) else counts)
    tp = c[0].astype(np.float32)
    union = np.maximum(c[1], 1).astype(np.float32)
    return np.where(c[2] > 0, tp / union, np.float32(-1.0)).astype(np.float32)
