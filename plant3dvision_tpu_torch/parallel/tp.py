"""Tensor parallelism of the trainers' convolutions (port of the tp half
of plant3dvision_tpu/parallel/train.py: `_param_spec`, `shard_params`, and
what XLA makes of their annotation).

The JAX package shards every conv kernel's Cout over the mesh's "tp" axis
where Cout is even and divides by tp (`split`), replicates the rest, and
lets XLA split the convolutions. The port does that by hand on each rank
of a tp group (`ColumnParallel`):

- rank t holds rows [t * out / tp, (t + 1) * out / tp) of each split conv
  weight (out, in, k, k) and convolves the whole input with them (cuDNN,
  as the one-device model);
- the output's channel slices are all-gathered over the tp group in rank
  order and the whole, replicated bias is added after the gather
  (`_Gather`; its backward keeps the rank's own slice of the incoming
  gradient, which is equal on every rank of the group, since all that
  follows the gather is replicated);
- the input's gradient (of the input cast to the convolution's dtype) is
  the sum of the ranks' partial gradients, all-gathered and added in rank
  order in float32 (`_ReduceGrad`, the identity forward), so that a run
  is deterministic.

GroupNorm, the activations, the head's pixel shuffle and the loss stay
replicated after the gather, the layout XLA gives the JAX annotation.

`decompose` is the same arithmetic on one device: each split conv holds
its tp slices as separate parameters and runs them one after the other,
concatenates the outputs and adds the inputs' gradients in rank order
(`_Fan`). The tests and chip_smoke.py hold the ranks against it bit for
bit; `regions` and `decomposed_state` lay its optimizer arena out as the
ranks lay theirs (models/optim.py) and export its state as the mesh does.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.segnet import Conv


def split(shape, tp: int) -> bool:
    """The JAX rule (`_param_spec` and `shard_params`' divisibility check)
    on a port parameter's shape: a conv weight (out, in, k, k) whose out is
    even and divides by tp is split over tp; every other leaf, and every
    leaf at tp 1, is replicated."""
    return (tp > 1 and len(shape) == 4 and shape[0] % 2 == 0
            and shape[0] % tp == 0)


def split_convs(model, tp: int):
    """(name, Conv) of the model's convolutions whose weight `split`s, in
    module order."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, Conv) and m.weight is not None
            and split(tuple(m.weight.shape), tp)]


def flax_path(conv_name: str) -> str:
    """The flax path of a conv module's kernel."""
    return "/".join(["params", *conv_name.split("."), "kernel"])


def _all_gather(t, group, size):
    """The tp group's tensors of t's shape, in rank order."""
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return parts


def rank_order_sum(parts):
    """parts[0] + parts[1] + ... in float32, in that order, cast back to
    the parts' dtype."""
    acc = parts[0].to(torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(torch.float32)
    return acc.to(parts[0].dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp = tp
        tp.gathered += y.numel() * y.element_size() * tp.size
        return torch.cat(_all_gather(y, tp.group, tp.size), 1)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        c = g.shape[1] // tp.size
        return g[:, tp.rank * c:(tp.rank + 1) * c].contiguous(), None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        tp.gathered += g.numel() * g.element_size() * tp.size
        return rank_order_sum(_all_gather(g, tp.group, tp.size)), None


class _Fan(torch.autograd.Function):
    """n aliases of x whose gradients add in order (`rank_order_sum`)."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        return rank_order_sum(gs), None


def _same_pad(x, ph, pw):
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1])) if any(ph + pw) else x


class ColumnParallel:
    """A split conv's tp state on rank `rank` of a tp group of `size`
    ranks (`group`, a torch.distributed group); `Conv.forward` hands
    itself over to `conv`. `gathered` counts the bytes of the tensors
    all-gathered into this rank (the outputs forward, the input gradients
    backward): gloo stages each through the host."""

    def __init__(self, rank: int, size: int, group):
        self.rank, self.size, self.group = rank, size, group
        self.gathered = 0

    def conv(self, mod, x, dtype, ph, pw):
        x = x.to(dtype)
        if x.requires_grad:
            x = _ReduceGrad.apply(x, self)
        y = F.conv2d(_same_pad(x, ph, pw), mod.weight.to(dtype),
                     stride=mod.stride)
        y = _Gather.apply(y, self)
        return y + mod.bias.to(dtype).view(1, -1, 1, 1)


class Decomposed(nn.Module):
    """A split conv's tp slices on one device (`decompose`): the weight's
    `size` row blocks as parameters of their own, convolved one after the
    other as the ranks convolve them."""

    def __init__(self, weight, size: int):
        super().__init__()
        self.size = size
        self.slices = nn.ParameterList(
            nn.Parameter(w.detach().clone()) for w in weight.chunk(size, 0))

    def conv(self, mod, x, dtype, ph, pw):
        x = x.to(dtype)
        xs = _Fan.apply(x, self.size) if x.requires_grad else \
            (x,) * self.size
        ys = [F.conv2d(_same_pad(xt, ph, pw), w.to(dtype), stride=mod.stride)
              for xt, w in zip(xs, self.slices)]
        return torch.cat(ys, 1) + mod.bias.to(dtype).view(1, -1, 1, 1)


def shard(model, tp: ColumnParallel):
    """Split `model`'s conv weights in place for rank `tp.rank`: each
    split conv keeps its own row block (a new parameter) and computes
    through `tp`. Returns the split convs' names."""
    names = []
    for name, conv in split_convs(model, tp.size):
        c = conv.weight.shape[0] // tp.size
        rows = conv.weight.detach()[tp.rank * c:(tp.rank + 1) * c].clone()
        conv.weight = nn.Parameter(rows)
        conv.tp = tp
        names.append(name)
    return names


def decompose(model, size: int):
    """A copy of `model` that computes what `size` tp ranks compute,
    on one device (see the module docstring)."""
    model = copy.deepcopy(model)
    for _, conv in split_convs(model, size):
        conv.tp = Decomposed(conv.weight, size)
        conv.register_parameter("weight", None)   # keeps its place
    return model


def regions(model):
    """The parameter regions of K22's arena for a model whose split convs
    are sharded (`shard`: [replicated, own slices]) or decomposed
    (`decompose`: [replicated, slices of rank 0, of rank 1, ...]); each
    region starts on a multiple of K22's chunk (models/optim.py). The
    replicated region is the parameters that are not split, in the order
    of `model.parameters()`; a slice region the split weights in module
    order."""
    convs = [m for m in model.modules()
             if isinstance(m, Conv) and m.tp is not None]
    split_ids = {id(m.weight) for m in convs if m.weight is not None}
    for m in convs:
        if isinstance(m.tp, Decomposed):
            split_ids |= {id(p) for p in m.tp.slices}
    rep = [p for p in model.parameters() if id(p) not in split_ids]
    if convs and isinstance(convs[0].tp, Decomposed):
        size = convs[0].tp.size
        return [rep] + [[m.tp.slices[t] for m in convs] for t in range(size)]
    return [rep, [m.weight for m in convs]]


def _whole(model):
    """(the one-device copy of a decomposed model, for each of its
    parameters the decomposed model's parameters it is made of)."""
    full = copy.deepcopy(model)
    names = set()
    for name, conv in full.named_modules():
        if isinstance(conv, Conv) and isinstance(conv.tp, Decomposed):
            names.add(name)
    for name in names:
        conv = full.get_submodule(name)
        conv.weight = nn.Parameter(torch.cat(
            [w.detach() for w in conv.tp.slices]))
        conv.tp = None
    parts = []
    for pname, _ in full.named_parameters():
        mname, _, leaf = pname.rpartition(".")
        parts.append(list(model.get_submodule(mname).tp.slices)
                     if leaf == "weight" and mname in names
                     else [model.get_parameter(pname)])
    return full, parts


def decomposed_state(model, opt):
    """(flax params, optax leaves) of a decomposed model and its AdamW, in
    the one-device layout (each split weight, and its moments, the
    concatenation of its slices): what `MeshTrainer.state` returns for
    the ranks."""
    from ..models.checkpoint import flax_params
    from ..models.optim import optax_leaves

    full, parts = _whole(model)
    mu = [torch.cat([opt.view(opt.mu, q) for q in ps]) for ps in parts]
    nu = [torch.cat([opt.view(opt.nu, q) for q in ps]) for ps in parts]
    return flax_params(full), optax_leaves(full, opt, mu, nu)


@contextlib.contextmanager
def conv_macs(model):
    """Count the multiply-adds of `model`'s convolutions while the block
    runs, from each call's shapes (the rank's own weight rows on a tp
    rank): yields a dict with "forward" (the convolutions), "input_grad"
    (their input gradients, for inputs that need one) and "weight_grad"
    (their weight gradients, in training)."""
    counts = {"forward": 0, "input_grad": 0, "weight_grad": 0}

    def hook(mod, inputs, out):
        w = mod.weight if mod.weight is not None else mod.tp.slices[0]
        rows = sum(s.shape[0] for s in mod.tp.slices) \
            if isinstance(mod.tp, Decomposed) else w.shape[0]
        macs = int(out.shape[0] * out.shape[2] * out.shape[3] * rows
                   * int(np.prod(w.shape[1:])))
        counts["forward"] += macs
        if inputs[0].requires_grad:
            counts["input_grad"] += macs
        if torch.is_grad_enabled() and w.requires_grad:
            counts["weight_grad"] += macs

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Conv)]
    try:
        yield counts
    finally:
        for h in handles:
            h.remove()
