"""dp x tp training over a mesh (port of plant3dvision_tpu/parallel/train.py:
`shard_params`, `make_train_step`; the policy that models/train.py and
models/train_synth.py run under `use_mesh`).

The JAX package annotates shardings and lets XLA insert the collectives;
here each rank of a mesh keeps a `_RankTrainer` resident (its share of
the model, the optimizer state, and for the trainers the crop set) and
one step is, on every rank:

1. tp: the conv weights that the JAX rule shards (parallel/tp.py:split,
   Cout even and divisible by tp) hold the rank's block of Cout rows; each
   such convolution computes the rank's output channels, all-gathers them
   over the tp group and sums the input's gradient over it in rank order
   (parallel/tp.py:ColumnParallel). Everything else is replicated over
   tp.
2. dp: the rank's part of the batch (the same part on every rank of a tp
   group) through the model, K21's mean cross-entropy and its backward.
3. The gradient is all-gathered over the dp group of the rank's tp index
   and summed in rank order, each part weighted by its share of the
   loss' denominator (pixels, or kept pixels with an ignored label): a
   run at a given layout is deterministic and resumes bit for bit.
4. The optimizer step (`models/optim.AdamW`) over the rank's arena, the
   replicated parameters then its slices: one K22 launch at tp 1; at tp >
   1 with the clip, K22's tp lane, whose norm is the whole gradient's
   (the replicated chunks once, then each rank's slices in rank order).

The state leaves the mesh in the one-device layout (`MeshTrainer.state`
gathers the tp slices), so a state resumes at any layout.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .launch import shared

_ids = itertools.count()


class _RankTrainer:
    """One rank's resident training state (see the module docstring): the
    model, placed and split at construction; the optimizer, built by
    `init_opt`."""

    def __init__(self, rt, layout, coords, tp_axis, model):
        from . import tp as tpm

        dev = rt.device
        self.rt, self.layout, self.coords = rt, layout, coords
        self.tp = dict(zip(*layout)).get(tp_axis, 1)
        self.i_tp = coords.get(tp_axis, 0)
        self.split, self.cp = [], None
        if self.tp > 1:
            self.tp_group = rt.group(layout, tp_axis)
            self.cp = tpm.ColumnParallel(self.i_tp, self.tp, self.tp_group)
            self.split = tpm.shard(model, self.cp)
        self.model = model.to(dev)
        self.opt = None

    def init_opt(self, dp_axis, opt_kw, weights, ignore_index):
        from ..models.optim import AdamW
        from . import tp as tpm

        self.dp_axis = dp_axis
        self.dp = dict(zip(*self.layout)).get(dp_axis, 1)
        self.i_dp = self.coords.get(dp_axis, 0)
        kw = {}
        if self.tp > 1:
            kw = dict(regions=tpm.regions(self.model),
                      gather_sums=self._gather_sums)
        self.opt = AdamW(self.model, **opt_kw, **kw)
        self.G = self.opt.grad
        self.w = weights.to(self.rt.device)
        self.ignore = ignore_index

    def _gather_sums(self, part):
        from .tp import _all_gather
        return _all_gather(part, self.tp_group, self.tp)

    def held(self):
        """(parameters this rank holds, its arena's length)."""
        n = sum(p.numel() for p in self.model.parameters())
        return n, (self.opt.arena.numel() if self.opt is not None else n)

    def step(self, x, y):
        """One training step on this rank's part (x (b, 3, H, W) float32, y
        (b, H, W) uint8, on its device) of the global batch; returns the
        global loss (a 0-d tensor, equal on every rank)."""
        import torch.distributed as dist

        from ..models.train_synth import deterministic_backward
        from ..ops.training import weighted_cross_entropy
        from .tp import conv_macs

        self.opt.zero_grad()
        if self.cp is not None:
            self.cp.gathered = 0
        with deterministic_backward(), conv_macs(self.model) as macs:
            loss = weighted_cross_entropy(self.model(x), y, self.w,
                                          self.ignore)
            loss.backward()
        self.macs = macs
        # the bytes all-gathered into this rank: the convolutions' over
        # tp, the gradient's over dp
        self.gathered = {
            "tp": self.cp.gathered if self.cp is not None else 0,
            "dp": self.dp * self.G.numel() * 4 if self.dp > 1 else 0}
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
        """(flax params, optimizer leaves, the flax paths of the split
        kernels) of this rank's share of the model."""
        from ..models.checkpoint import flax_params
        from .tp import flax_path

        return (flax_params(self.model), self.opt.state_leaves(),
                [flax_path(n) for n in self.split])

    def load_full_state(self, params, leaves):
        """Load the one-device state, keeping this rank's rows of the
        split kernels and of their moments."""
        from ..models.checkpoint import flax_template, state_dict_from_flax
        from ..models.optim import flax_leaf_order
        from .tp import flax_path

        t, T = self.i_tp, self.tp
        split = {flax_path(n) for n in self.split}
        rows = {n + ".weight" for n in self.split}
        with torch.no_grad():
            for k, v in state_dict_from_flax(params).items():
                p = self.model.get_parameter(k)
                if k in rows:
                    c = v.shape[0] // T
                    v = v[t * c:(t + 1) * c]
                p.copy_(v.to(self.rt.device))
        paths = list(flax_template(self.model))
        order = flax_leaf_order(self.model)
        K = len(order)
        leaves = list(leaves)
        for j, i in enumerate(order):
            if paths[i] in split:
                for base in (1, 1 + K):
                    a = np.asarray(leaves[base + j])
                    c = a.shape[-1] // T
                    leaves[base + j] = a[..., t * c:(t + 1) * c]
        self.opt.load_state_leaves(leaves)


def _merge_tp(states):
    """The tp ranks' `full_state`s, in rank order -> the one-device (flax
    params, optimizer leaves): each split kernel, and its moments,
    concatenated along flax's Cout (last) axis."""
    from ..models.checkpoint import _flatten, _unflatten

    split = set(states[0][2])
    if len(states) == 1 or not split:
        return states[0][0], states[0][1]
    flats = [_flatten(s[0]) for s in states]
    params = {k: (np.concatenate([f[k] for f in flats], -1) if k in split
                  else v) for k, v in flats[0].items()}
    paths = sorted(flats[0], key=lambda k: tuple(k.split("/")))
    K = len(paths)
    leaves = list(states[0][1])
    for j, k in enumerate(paths):
        if k in split:
            for base in (1, 1 + K):
                leaves[base + j] = np.concatenate(
                    [np.asarray(s[1][base + j]) for s in states], -1)
    return _unflatten(params), leaves


# ------------------------------------------------------ rank functions

def _r_place(rt, key, layout, coords, tp_axis, model):
    rt.store[key] = _RankTrainer(rt, layout, coords, tp_axis, model)


def _r_init(rt, key, dp_axis, opt_kw, weights, ignore_index):
    rt.store[key].init_opt(dp_axis, opt_kw, weights, ignore_index)


def _r_held(rt, key):
    return rt.store[key].held()


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
    """The held-out counts, computed by the tp group of dp index 0 (its
    convolutions need every rank of the group)."""
    from ..models.train_synth import _val_counts

    tr = rt.store[key]
    if tr.i_dp != 0:
        return None
    c = _val_counts(tr.model, tr.data[2], tr.data[3], n_cls, ignore_index)
    return c.cpu() if keep else None


def _r_state(rt, key):
    tr = rt.store[key]
    return tr.full_state() if tr.i_dp == 0 else None


def _r_load(rt, key, params, leaves):
    rt.store[key].load_full_state(params, leaves)


def _r_stats(rt, key):
    """This rank's parameters, arena length, and the last step's conv
    multiply-adds and bytes all-gathered into the rank."""
    tr = rt.store[key]
    held, arena = tr.held()
    return {"params": held, "arena": arena, "conv_macs": dict(tr.macs),
            "gathered_bytes": dict(tr.gathered)}


def _r_drop(rt, key):
    rt.store.pop(key, None)


def _place(mesh, model, tp_axis):
    """Place a copy of `model` on every rank of the mesh, split over
    `tp_axis` (the rank functions' key, the ranks' coordinates)."""
    key = f"trainer{next(_ids)}"
    coords = [mesh.coords(i) for i in range(mesh.size)]
    replica = _cpu_copy(model)
    mesh.run(_r_place, [(key, mesh.layout, c, tp_axis, replica)
                        for c in coords])
    return key, coords


class MeshTrainer:
    """The controller's handle on rank-resident training state over a
    mesh: the batch is split over `dp_axis` (1 where the mesh lacks it),
    the convolutions over `tp_axis` (parallel/tp.py); the ranks along any
    other axis are replicas.

    `model` is copied to every rank (its own device there) and split
    there, unless `placed` (`shard_params`' result) already put it on the
    ranks; `optimizer` is `models.optim.AdamW`'s keyword arguments (a
    dict); `weights` the class weights of K21 (None: ones, the plain
    mean)."""

    def __init__(self, mesh, model, optimizer, weights=None,
                 ignore_index=None, dp_axis="dp", tp_axis="tp",
                 placed=None):
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.dp = mesh.shape.get(dp_axis, 1)
        self.tp = mesh.shape.get(tp_axis, 1)
        n_cls = list(model.parameters())[-1].shape[0]
        w = (torch.ones(n_cls) if weights is None
             else torch.as_tensor(weights, dtype=torch.float32).cpu())
        if placed is None:
            self.key, self.coords = _place(mesh, model, tp_axis)
        else:
            self.key, self.coords = placed.key, placed.coords
        mesh.run(_r_init, (self.key, dp_axis, dict(optimizer), w,
                           ignore_index))

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
        """(flax params, optimizer leaves) of the whole model, the tp
        slices gathered (the one-device layout)."""
        out = self.mesh.run(_r_state, (self.key,))
        return _merge_tp([o for o in out if o is not None])

    def load_state(self, params, leaves):
        self.mesh.run(_r_load, (self.key, params, leaves))

    def rank_stats(self):
        """Each rank's parameters, arena length, and conv multiply-adds
        and gathered bytes of the last step (`_r_stats`), in rank
        order."""
        return self.mesh.run(_r_stats, (self.key,))

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
    """`shard_params`' result: `model`'s parameters placed on the ranks of
    `mesh`, each split conv weight's Cout rows over the tp axis
    (`held()`: what each rank holds); `trainer` is the rank-resident
    state that `make_train_step`'s first step builds over them."""

    def __init__(self, model, mesh, tp_axis):
        self.model, self.mesh, self.tp_axis = model, mesh, tp_axis
        self.key, self.coords = _place(mesh, model, tp_axis)
        self.trainer = None

    def held(self):
        """The number of parameters each rank holds, in rank order."""
        return [h for h, _ in self.mesh.run(_r_held, (self.key,))]

    def split(self):
        """The flax paths of the kernels split over tp."""
        from .tp import flax_path, split_convs
        return sorted(flax_path(n) for n, _ in split_convs(
            self.model, self.mesh.shape.get(self.tp_axis, 1)))

    def close(self):
        """Drop the placed parameters (and the trainer built over them)
        from the ranks."""
        if not self.mesh.pool.closed:
            self.mesh.run(_r_drop, (self.key,))


def shard_params(model, mesh, tp_axis="tp"):
    """Place `model`'s parameters on the mesh's ranks (the counterpart of
    JAX's `shard_params`): every conv weight (out, in, k, k) with out even
    and divisible by the `tp_axis` size is split into its Cout row blocks,
    rank t of a tp group holding block t; the rest is replicated."""
    return ShardedParams(model, mesh, tp_axis)


def make_train_step(model, optimizer, mesh, dp_axis="dp", tp_axis="tp"):
    """Returns (train_step, shard_batch), as the JAX package's.
    train_step(params, opt_state, images, labels) -> (params, opt_state,
    loss): `params` from `shard_params`, `opt_state` None at the first
    step (the ranks then build `optimizer`, AdamW's keyword arguments,
    over the parameters they hold) and the returned state after; the loss
    is the mean softmax cross-entropy (K21 with unit weights), the batch
    split over `dp_axis` and the convolutions over `tp_axis`.
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
                                    dp_axis=dp_axis, tp_axis=tp_axis,
                                    placed=params)
            params.trainer = opt_state
        loss = opt_state.step(images, labels)
        return params, opt_state, loss

    return train_step, shard_batch
