"""Meshes of ranks (port of plant3dvision_tpu/parallel/mesh.py).

A `Mesh` names the axes of a row-major grid of ranks, as the JAX package's
`Mesh` names a grid of devices (`np.asarray(devices).reshape(shape)`): the
rank at grid index (i, j, ...) is the pool's rank `i * shape[1] * ... + j
...`. Each rank holds a `torch.distributed` sub-group for each axis (the
ranks that differ only in that axis' index). A mesh lives until it is
closed, so that a task's many calls do not pay for a spawn each; `view`
lays another axis layout over the first ranks of the same pool (a pool
builds the sub-groups of a layout once).
"""

from __future__ import annotations

import numpy as np
import torch

from .launch import Pool


def default_ranks(device) -> int:
    """The rank count a run gets unless it names one: one a card on the
    card, one on the CPU (the counterpart of `len(jax.devices())`)."""
    device = torch.device(device)
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _make_groups(rt, layout, members):
    """Build the per-axis sub-groups of `layout` (names, shape) over the
    pool ranks `members` (row-major). Every rank of the pool calls
    `new_group` for every sub-group, in one order; a member keeps its own."""
    import torch.distributed as dist

    names, shape = layout
    grid = np.asarray(members, dtype=np.int64).reshape(shape)
    mine = {}
    for a, name in enumerate(names):
        rows = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        for row in rows:
            ranks = [int(r) for r in row]
            g = dist.new_group(ranks)
            if rt.rank in ranks:
                mine[name] = g
    rt.groups[layout] = mine


class Mesh:
    """Axes over ranks of a `Pool`: `shape` maps axis name to size (as
    `jax.sharding.Mesh.shape`), `ranks` are the pool ranks in row-major
    order, `device` is where results land in the controller."""

    def __init__(self, pool: Pool, axis_shapes: dict, owner: bool):
        names = tuple(axis_shapes)
        sizes = tuple(int(v) for v in axis_shapes.values())
        n = int(np.prod(sizes))
        if n < 1 or n > pool.world:
            raise ValueError(f"a mesh of {n} ranks over a pool of "
                             f"{pool.world}")
        self.pool = pool
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.layout = (names, sizes)
        self.ranks = tuple(range(n))
        self.size = n
        self.device = pool.device
        self._owner = owner
        if self.layout not in pool.layouts:
            pool.run(_make_groups, (self.layout, self.ranks))
            pool.layouts.add(self.layout)

    def coords(self, i: int) -> dict:
        """Axis name -> index of the mesh's i-th rank."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(
                            i, self.layout[1]))))

    def run(self, fn, args):
        """`Pool.run` over the mesh's ranks."""
        return self.pool.run(fn, args, ranks=self.ranks)

    def view(self, axis_shapes: dict) -> "Mesh":
        """Another layout over the first ranks of the same pool (closing a
        view leaves the pool running)."""
        return Mesh(self.pool, axis_shapes, owner=False)

    def close(self):
        if self._owner:
            self.pool.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return (f"Mesh({self.shape}, backend={self.pool.backend!r}, "
                f"device={str(self.device)!r})")


def make_mesh(axis_shapes: dict | None = None, ranks: int | None = None,
              device="cuda", backend: str | None = None,
              timeout_s: float = 900) -> Mesh:
    """Start a pool of ranks and lay `axis_shapes` ({'axis': size}; default
    all ranks on 'dp') over them. `ranks` is the pool's size (default: the
    mesh's, or `default_ranks(device)` without `axis_shapes`); a larger
    pool leaves its last ranks for `Mesh.view`. `backend` defaults to
    "nccl" on the card and "gloo" on the CPU; ranks that share a card need
    "gloo", named by the caller."""
    dev = torch.device(device)
    if axis_shapes is None:
        axis_shapes = {"dp": int(ranks) if ranks is not None
                       else default_ranks(dev)}
    n = int(np.prod(list(axis_shapes.values())))
    world = n if ranks is None else int(ranks)
    if world < n:
        raise ValueError(f"the mesh {axis_shapes} needs {n} ranks, the pool "
                         f"has {world}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    return Mesh(Pool(world, backend, dev, timeout_s=timeout_s),
                dict(axis_shapes), owner=True)


def best_dp_tp(n_devices: int) -> dict[str, int]:
    """Split devices into a (dp, tp) mesh: tp gets the largest power-of-two
    factor <= 4 (channel sharding has limited win for conv nets)."""
    tp = 1
    for cand in (4, 2):
        if n_devices % cand == 0:
            tp = cand
            break
    return {"dp": n_devices // tp, "tp": tp}
