"""dp training over a mesh (port of plant3dvision_tpu/parallel/train.py:
`shard_params`, `make_train_step`; the policy that models/train.py and
models/train_synth.py run under `use_mesh`).

The JAX package annotates shardings and lets XLA insert the collectives;
here each rank of a mesh keeps a `_RankTrainer` resident (the model, the
optimizer state, and for the trainers the crop set) and one step is, on
every rank:

1. dp: the rank's part of the batch through the model, K21's mean
   cross-entropy and its backward.
2. The gradient is all-gathered over dp and summed in rank order, each
   part weighted by its share of the loss' denominator (pixels, or kept
   pixels with an ignored label): a run at a given world size is
   deterministic and resumes bit for bit.
3. The one-device optimizer step (`models/optim.AdamW`, one K22 launch
   over the whole parameter arena, the clip by the whole gradient's norm)
   on every rank, so the replicas stay equal.

A "tp" axis of the mesh is accepted for the JAX package's layouts, and its
ranks are replicas: the ranks of a tp group take the same dp part and
compute the same step. The JAX package shards conv weights' Cout over tp
and lets XLA split the convolutions; the port splits no convolution, so
slicing the weights would save nothing, and its own lanes lay every rank
on dp.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .launch import shared

_ids = itertools.count()


class _RankTrainer:
    """One rank's resident training state (see the module docstring)."""

    def __init__(self, rt, layout, coords, dp_axis, model, opt_kw, weights,
                 ignore_index):
        from ..models.optim import AdamW

        dev = rt.device
        self.rt, self.layout, self.dp_axis = rt, layout, dp_axis
        self.dp = dict(zip(*layout)).get(dp_axis, 1)
        self.i_dp = coords.get(dp_axis, 0)
        self.model = model.to(dev)
        self.opt = AdamW(self.model, **opt_kw)
        self.G = self.opt.grad
        self.w = weights.to(dev)
        self.ignore = ignore_index

    def step(self, x, y):
        """One training step on this rank's part (x (b, 3, H, W) float32, y
        (b, H, W) uint8, on its device) of the global batch; returns the
        global loss (a 0-d tensor, equal on every rank)."""
        import torch.distributed as dist

        from ..models.train_synth import deterministic_backward
        from ..ops.training import weighted_cross_entropy

        self.opt.zero_grad()
        with deterministic_backward():
            loss = weighted_cross_entropy(self.model(x), y, self.w,
                                          self.ignore)
            loss.backward()
        if self.ignore is None:
            d = torch.tensor(float(y.numel()), device=y.device)
        else:
            d = (y != self.ignore).sum().to(torch.float32)
        stat = torch.stack([loss.detach(), d])
        group = self.rt.group(self.layout, self.dp_axis) if self.dp > 1 \
            else None
        if self.dp > 1:
            stats = [torch.empty_like(stat) for _ in range(self.dp)]
            dist.all_gather(stats, stat, group=group)
            stats = torch.stack(stats)
        else:
            stats = stat[None]
        if self.ignore is None:
            share = stats[:, 1] / stats[:, 1].sum()
        else:
            share = (torch.clamp(stats[:, 1], min=1.0)
                     / torch.clamp(stats[:, 1].sum(), min=1.0))
        if self.dp > 1:
            self.G.mul_(share[self.i_dp])
            parts = [torch.empty_like(self.G) for _ in range(self.dp)]
            dist.all_gather(parts, self.G, group=group)
            self.G.copy_(parts[0])
            for g in parts[1:]:
                self.G.add_(g)
        self.opt.step()
        total = stats[0, 0] * share[0]
        for r in range(1, self.dp):
            total = total + stats[r, 0] * share[r]
        return total

    def full_state(self):
        """(flax params, optimizer leaves), as the one-device AdamW exports
        them."""
        from ..models.checkpoint import flax_params

        return flax_params(self.model), self.opt.state_leaves()

    def load_full_state(self, params, leaves):
        from ..models.checkpoint import state_dict_from_flax

        with torch.no_grad():
            for k, v in state_dict_from_flax(params).items():
                self.model.get_parameter(k).copy_(v.to(self.rt.device))
        self.opt.load_state_leaves(leaves)


# ------------------------------------------------------ rank functions

def _r_init(rt, key, layout, coords, dp_axis, model, opt_kw, weights,
            ignore_index):
    rt.store[key] = _RankTrainer(rt, layout, coords, dp_axis, model, opt_kw,
                                 weights, ignore_index)


def _r_step(rt, key, x, y, keep):
    tr = rt.store[key]
    dev = rt.device
    loss = tr.step(x.to(dev), y.to(dev))
    return loss.cpu() if keep else None


def _r_data(rt, key, rgb, lab, vrgb, vlab):
    tr = rt.store[key]
    dev = rt.device
    tr.data = tuple(t.to(dev) for t in (rgb, lab, vrgb, vlab))


def _r_chunk(rt, key, chunk, steps, seed, batch_size, draw, keep):
    """`steps` steps of train_synth's loop: each rank draws the whole
    batch from the step's seeded generator (as one device draws it),
    gathers its dp part with K20 and steps."""
    from ..models.train_synth import _step_seed
    from ..ops.training import gather_batch

    tr = rt.store[key]
    d_rgb, d_lab = tr.data[:2]
    dev = rt.device
    b = batch_size // tr.dp
    part = slice(tr.i_dp * b, (tr.i_dp + 1) * b)
    gen = tr.__dict__.setdefault("gen", torch.Generator(device=dev))
    losses = []
    for s in range(steps):
        gen.manual_seed(_step_seed(seed, chunk * steps + s))
        idx, flip, gains = draw(gen, d_rgb.shape[0], batch_size)
        x, y = gather_batch(d_rgb, d_lab, idx[part].to(dev).contiguous(),
                            flip.to(dev),
                            gains[part].to(dev, torch.float32).contiguous())
        losses.append(tr.step(x, y).detach())
    return torch.stack(losses).cpu() if keep else None


def _r_val(rt, key, n_cls, ignore_index, keep):
    from ..models.train_synth import _val_counts

    if not keep:
        return None
    tr = rt.store[key]
    return _val_counts(tr.model, tr.data[2], tr.data[3], n_cls,
                       ignore_index).cpu()


def _r_state(rt, key, keep):
    st = rt.store[key].full_state()
    return st if keep else None


def _r_load(rt, key, params, leaves):
    rt.store[key].load_full_state(params, leaves)


def _r_drop(rt, key):
    rt.store.pop(key, None)


class MeshTrainer:
    """The controller's handle on rank-resident training state over a
    mesh: the batch is split over `dp_axis` (1 where the mesh lacks it);
    the ranks along any other axis are replicas.

    `model` is copied to every rank (its own device there); `optimizer`
    is `models.optim.AdamW`'s keyword arguments (a dict);
    `weights` the class weights of K21 (None: ones, the plain mean)."""

    def __init__(self, mesh, model, optimizer, weights=None,
                 ignore_index=None, dp_axis="dp"):
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.dp = mesh.shape.get(dp_axis, 1)
        self.key = f"trainer{next(_ids)}"
        n_cls = list(model.parameters())[-1].shape[0]
        w = (torch.ones(n_cls) if weights is None
             else torch.as_tensor(weights, dtype=torch.float32).cpu())
        self.coords = [mesh.coords(i) for i in range(mesh.size)]
        replica = _cpu_copy(model)
        opt_kw = dict(optimizer)
        mesh.run(_r_init, [(self.key, mesh.layout, c, dp_axis, replica,
                            opt_kw, w, ignore_index)
                           for c in self.coords])

    def _first(self):
        """keep flags: the rank at index 0 of every axis answers."""
        return [all(v == 0 for v in c.values()) for c in self.coords]

    def step(self, images, labels) -> float:
        """One step on a global batch: images (B, 3, H, W) float32, labels
        (B, H, W) uint8 (tensors or arrays), split over dp in contiguous
        parts (B >= dp). Returns the loss."""
        x = shared(images if torch.is_tensor(images)
                   else torch.from_numpy(np.ascontiguousarray(images)))
        y = shared(labels if torch.is_tensor(labels)
                   else torch.from_numpy(np.ascontiguousarray(labels)))
        B = x.shape[0]
        if B < self.dp:
            raise ValueError(f"a batch of {B} over dp = {self.dp}")
        bounds = np.linspace(0, B, self.dp + 1).round().astype(int)
        args = []
        for c, keep in zip(self.coords, self._first()):
            i = c.get(self.dp_axis, 0)
            part = slice(bounds[i], bounds[i + 1])
            args.append((self.key, x[part], y[part], keep))
        out = [o for o in self.mesh.run(_r_step, args) if o is not None]
        return float(out[0])

    def load_data(self, rgb, lab, vrgb, vlab):
        """The crop set (uint8 tensors) made resident on every rank."""
        data = tuple(shared(t) for t in (rgb, lab, vrgb, vlab))
        self.mesh.run(_r_data, (self.key, *data))

    def run_chunk(self, chunk, steps, seed, batch_size, draw):
        """`steps` steps of train_synth's loop on the resident crops; the
        losses (steps,) float32 tensor."""
        if batch_size % self.dp:
            raise ValueError(f"batch_size {batch_size} is not a multiple of "
                             f"dp = {self.dp}")
        out = self.mesh.run(_r_chunk, [(self.key, chunk, steps, seed,
                                        batch_size, draw, keep)
                                       for keep in self._first()])
        return next(o for o in out if o is not None)

    def val_counts(self, n_cls, ignore_index):
        out = self.mesh.run(_r_val, [(self.key, n_cls, ignore_index, keep)
                                     for keep in self._first()])
        return next(o for o in out if o is not None)

    def state(self):
        """(flax params, optimizer leaves) of the whole model."""
        out = self.mesh.run(_r_state, [(self.key, keep)
                                       for keep in self._first()])
        return next(o for o in out if o is not None)

    def load_state(self, params, leaves):
        self.mesh.run(_r_load, (self.key, params, leaves))

    def params_into(self, model):
        """Copy the trained parameters into the controller's `model`."""
        from ..models.checkpoint import state_dict_from_flax

        params, _ = self.state()
        with torch.no_grad():
            for k, v in state_dict_from_flax(params).items():
                p = model.get_parameter(k)
                p.copy_(v.to(p.device))
        return model

    def close(self):
        if not self.mesh.pool.closed:
            self.mesh.run(_r_drop, (self.key,))


def _cpu_copy(model):
    import copy
    return copy.deepcopy(model).cpu()


class ShardedParams:
    """`shard_params`' result: the model whose parameters every rank of the
    mesh holds, resident once `make_train_step`'s step has run; `trainer`
    is the rank-resident state behind it."""

    def __init__(self, model, mesh):
        self.model, self.mesh = model, mesh
        self.trainer = None


def shard_params(model, mesh, tp_axis="tp"):
    """Place `model`'s parameters on the mesh, replicated on every rank
    (the counterpart of JAX's `shard_params`, which slices conv weights
    over `tp_axis`; see the module docstring); the ranks receive them at
    the first step."""
    return ShardedParams(model, mesh)


def make_train_step(model, optimizer, mesh, dp_axis="dp", tp_axis="tp"):
    """Returns (train_step, shard_batch), as the JAX package's.
    train_step(params, opt_state, images, labels) -> (params, opt_state,
    loss): `params` from `shard_params`, `opt_state` None at the first
    step (the ranks then build `optimizer`, AdamW's keyword arguments,
    over their parameters) and the returned state after; the loss is the
    mean softmax cross-entropy (K21 with unit weights). `tp_axis` is
    taken for the JAX package's signature: the ranks along it are
    replicas (the module docstring).
    shard_batch(images (B, H, W, 3) float, labels (B, H, W) int) -> the
    batch in the port's layout (NCHW float32, uint8 labels), split over
    dp by the step."""

    def shard_batch(images, labels):
        x = torch.as_tensor(np.ascontiguousarray(images), dtype=torch.float32)
        y = torch.as_tensor(np.asarray(labels).astype(np.uint8))
        return shared(x.permute(0, 3, 1, 2)), shared(y)

    def train_step(params, opt_state, images, labels):
        if opt_state is None:
            opt_state = MeshTrainer(mesh, params.model, optimizer,
                                    dp_axis=dp_axis)
            params.trainer = opt_state
        loss = opt_state.step(images, labels)
        return params, opt_state, loss

    return train_step, shard_batch
