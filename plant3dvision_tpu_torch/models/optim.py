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
  for the norm and the update. The per-step scalars (the learning rate at
  the schedule's count, the bias corrections 1 - b^count) are float32
  numbers computed here on the host, which knows the counts, so a step
  needs no host read.
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

from ..ops.training import adamw_launcher

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


class AdamW:
    """optax.adamw (optionally after clip_by_global_norm) over `model`'s
    parameters, which must already be on their device; `lr` is a float or
    a schedule (count -> float32), `clip` the global-norm threshold or
    None."""

    def __init__(self, model, lr, clip=None, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, weight_decay=1e-4):
        self.model = model
        self.params = list(model.parameters())
        self.lr, self.clip = lr, clip
        self.b1, self.b2 = _f32(b1), _f32(b2)
        dev = self.params[0].device
        n = sum(p.numel() for p in self.params)
        self.arena = torch.empty(n, dtype=torch.float32, device=dev)
        self.grad = torch.zeros(n, dtype=torch.float32, device=dev)
        self.mu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.nu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.offsets = []
        off = 0
        with torch.no_grad():
            for p in self.params:
                if p.dtype != torch.float32 or p.device != dev:
                    raise ValueError("AdamW takes float32 parameters on one "
                                     "device")
                k = p.numel()
                self.arena[off:off + k].copy_(p.reshape(-1))
                p.data = self.arena[off:off + k].view_as(p)
                p.grad = self.grad[off:off + k].view_as(p)
                self.offsets.append(off)
                off += k
        #: optax's counts: scale_by_adam's and scale_by_schedule's
        self.count = 0
        self.sched_count = 0
        self._step = adamw_launcher(
            self.arena, self.grad, self.mu, self.nu, clip=clip is not None,
            b1=b1, b2=b2, eps=eps, eps_root=eps_root, wd=weight_decay,
            max_norm=1.0 if clip is None else clip)

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

    def _moment_leaves(self, arena):
        out = []
        for i in flax_leaf_order(self.model):
            p, off = self.params[i], self.offsets[i]
            out.append(_port_to_flax(arena[off:off + p.numel()].view_as(p)))
        return out

    def state_leaves(self):
        """optax's state leaves in their order (numpy, flax layout)."""
        leaves = [np.asarray(self.count, np.int32)]
        leaves += self._moment_leaves(self.mu)
        leaves += self._moment_leaves(self.nu)
        if callable(self.lr):
            leaves.append(np.asarray(self.sched_count, np.int32))
        return leaves

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
                    p, off = self.params[i], self.offsets[i]
                    a = _flax_to_port(leaves[base + j], p.ndim)
                    arena[off:off + p.numel()].copy_(
                        torch.from_numpy(np.ascontiguousarray(
                            a, np.float32)).reshape(-1))
        if callable(self.lr):
            self.sched_count = int(leaves[-1])
