"""The optimizer of the trainers: the port's copy of the optax arithmetic
that plant3dvision_tpu/models/train.py and train_synth.py use (optax
0.2.6), without optax.

- `cosine_decay_schedule(lr, steps, alpha)`: optax's, in float32:
  lr * ((1 - alpha) * 0.5 * (1 + cos(pi * min(count, steps) / steps)) +
  alpha).
- `AdamW`: `optax.adamw(lr)` (train.train) or `optax.chain(
  clip_by_global_norm(max_norm), optax.adamw(schedule))`
  (train_synth.train_on_crops): b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
  weight decay 1e-4, the decayed weight added to the Adam update, then
  scaled by -lr; `apply_updates` adds the result. The model's float
  parameters are re-seated as views of one flat float32 arena and their
  gradients as views of a second (autograd accumulates into existing
  gradients in place), with the moments in two more; the step is K22
  (ops/training.py:adamw_launcher, bound to the arenas once), one launch
  for the norm and the update (two and a gather of the norm's chunk sums
  on a rank of a tp group, `regions`). The per-step scalars (the learning
  rate at the schedule's count, the bias corrections 1 - b^count) are
  float32 numbers computed here on the host, which knows the counts, so a
  step needs no host read.
- `state_leaves` / `load_state_leaves`: the optimizer state as optax's
  leaves in their order (the Adam count, the first moments, the second
  moments in flax's sorted parameter order, then the schedule's count
  where there is one), in flax layout (HWIO kernels), as the JAX
  package's training states store them (models/checkpoint.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.training import ADAMW_CHUNK, adamw_launcher

_f32 = np.float32


def _cosine(init_value, decay_steps, alpha, count):
    c = np.minimum(_f32(count), _f32(decay_steps))
    cos = 0.5 * (1 + np.cos(_f32(np.pi) * c / _f32(decay_steps)))
    decayed = _f32(1 - alpha) * _f32(cos) + _f32(alpha)
    return _f32(_f32(init_value) * decayed)


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
    """optax.cosine_decay_schedule (exponent 1): count -> float32 lr (a
    partial, so that a mesh's ranks receive it by pickle)."""
    if not decay_steps > 0:
        raise ValueError("cosine_decay_schedule needs decay_steps > 0, got "
                         f"{decay_steps}")
    return functools.partial(_cosine, init_value, decay_steps, alpha)


def _flax_to_port(a, ndim):
    """A flax leaf (HWIO conv kernel, else as it is) in the port's layout."""
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if ndim == 4 else a


def _port_to_flax(t):
    a = t.detach().cpu().numpy()
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a


def flax_leaf_order(model):
    """Indices of the model's parameters in the order jax.tree.leaves
    visits the flax parameter tree (each level's keys sorted)."""
    from .checkpoint import flax_template
    paths = [tuple(k.split("/")) for k in flax_template(model)]
    return sorted(range(len(paths)), key=lambda i: paths[i])


def optax_leaves(model, opt, mu, nu):
    """optax's state leaves of an AdamW `opt` over `model` whose moments
    are `mu` and `nu` (tensors in the order of model.parameters()): the
    Adam count, the first moments, the second moments in flax's sorted
    parameter order, then the schedule's count where there is one (numpy,
    flax layout)."""
    order = flax_leaf_order(model)
    leaves = [np.asarray(opt.count, np.int32)]
    leaves += [_port_to_flax(mu[i]) for i in order]
    leaves += [_port_to_flax(nu[i]) for i in order]
    if callable(opt.lr):
        leaves.append(np.asarray(opt.sched_count, np.int32))
    return leaves


class AdamW:
    """optax.adamw (optionally after clip_by_global_norm) over `model`'s
    parameters, which must already be on their device; `lr` is a float or
    a schedule (count -> float32), `clip` the global-norm threshold or
    None.

    A rank of a tp group (parallel/train.py) gives `regions`, its
    parameters in arena order as lists that each start on a multiple of
    K22's chunk (parallel/tp.py:regions: the replicated parameters, then
    its slices of the split weights), and `gather_sums`, which takes this
    arena's chunk sums of g^2 and returns every tp rank's, in rank order:
    the clip's norm is then the whole model's, the replicated chunks
    counted once (those of rank 0) and the ranks' slices in rank order,
    and the step is K22's tp lane (ops/training.py:adamw_launcher)."""

    def __init__(self, model, lr, clip=None, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, weight_decay=1e-4, regions=None,
                 gather_sums=None):
        self.model = model
        self.params = list(model.parameters())
        self.lr, self.clip = lr, clip
        self.b1, self.b2 = _f32(b1), _f32(b2)
        dev = self.params[0].device
        layout = [self.params] if regions is None else regions
        if {id(p) for r in layout for p in r} != {id(p) for p in self.params}:
            raise ValueError("the regions must hold the model's parameters")
        pad = (lambda k: k) if regions is None else \
            (lambda k: -(-k // ADAMW_CHUNK) * ADAMW_CHUNK)
        self._off, off, bounds = {}, 0, []
        for region in layout:
            off = pad(off)
            bounds.append(off)
            for p in region:
                if p.dtype != torch.float32 or p.device != dev:
                    raise ValueError("AdamW takes float32 parameters on one "
                                     "device")
                self._off[id(p)] = off
                off += p.numel()
        n = pad(off)
        #: chunks of the first region (the replicated one on a tp rank)
        self.rep_chunks = (bounds[1] if len(bounds) > 1 else n) // ADAMW_CHUNK
        self.arena = torch.zeros(n, dtype=torch.float32, device=dev)
        self.grad = torch.zeros(n, dtype=torch.float32, device=dev)
        self.mu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.nu = torch.zeros(n, dtype=torch.float32, device=dev)
        with torch.no_grad():
            for p in self.params:
                off, k = self._off[id(p)], p.numel()
                self.arena[off:off + k].copy_(p.reshape(-1))
                p.data = self.arena[off:off + k].view_as(p)
                p.grad = self.grad[off:off + k].view_as(p)
        #: optax's counts: scale_by_adam's and scale_by_schedule's
        self.count = 0
        self.sched_count = 0
        tp_sums = None
        if gather_sums is not None and clip is not None:
            r = self.rep_chunks

            def tp_sums(part):
                parts = gather_sums(part)
                return torch.cat([parts[0][:r]] + [q[r:] for q in parts])
        self._step = adamw_launcher(
            self.arena, self.grad, self.mu, self.nu, clip=clip is not None,
            b1=b1, b2=b2, eps=eps, eps_root=eps_root, wd=weight_decay,
            max_norm=1.0 if clip is None else clip, tp_sums=tp_sums)

    def view(self, arena, p):
        """Parameter `p`'s elements of one of the arenas (arena, grad, mu,
        nu), in p's shape."""
        off = self._off[id(p)]
        return arena[off:off + p.numel()].view_as(p)

    def zero_grad(self):
        self.grad.zero_()

    def step(self):
        """One optimizer update from the gradients in the arena (K22)."""
        count_inc = self.count + 1
        bc1 = _f32(1) - self.b1 ** _f32(count_inc)
        bc2 = _f32(1) - self.b2 ** _f32(count_inc)
        lr = self.lr(self.sched_count) if callable(self.lr) else _f32(self.lr)
        self._step(bc1, bc2, -_f32(lr))
        self.count = count_inc
        if callable(self.lr):
            self.sched_count += 1

    def state_leaves(self):
        """optax's state leaves in their order (numpy, flax layout)."""
        return optax_leaves(self.model, self,
                            [self.view(self.mu, p) for p in self.params],
                            [self.view(self.nu, p) for p in self.params])

    def load_state_leaves(self, leaves):
        """Restore the state from `state_leaves`' layout (a JAX-written
        state included)."""
        order = flax_leaf_order(self.model)
        want = 1 + 2 * len(order) + (1 if callable(self.lr) else 0)
        if len(leaves) != want:
            raise ValueError(f"optimizer state has {len(leaves)} leaves, "
                             f"this optimizer {want}")
        self.count = int(leaves[0])
        with torch.no_grad():
            for arena, base in ((self.mu, 1), (self.nu, 1 + len(order))):
                for j, i in enumerate(order):
                    p = self.params[i]
                    a = _flax_to_port(leaves[base + j], p.ndim)
                    self.view(arena, p).copy_(torch.from_numpy(
                        np.ascontiguousarray(a, np.float32)).view_as(p))
        if callable(self.lr):
            self.sched_count = int(leaves[-1])
