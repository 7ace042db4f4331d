"""Multi-rank space carving and averaging (port of
plant3dvision_tpu/parallel/carving.py).

Three shardings of the carve, each bit-equal to the one-device carve:
- view-sharded (`carve_sharded`): every rank carves the whole grid over its
  contiguous shard of the views with K1; one `all_reduce(MAX)` over the
  axis joins an int8 code (killed 2, seen 1, else 0), mapped back to
  -1 / 1 / 0. A kill in any shard wins over any sighting, and a shard's
  volume is -1 exactly where one of its views kills, so the join is exact.
- grid-sharded (`carve_grid_sharded`): each rank carves an x-slab over all
  the views (K1 with the slab's global `x_start`); no collective touches
  the volume, the controller gathers the slabs in rank order.
- 2-D (`carve_2d_sharded`): views over one axis, slabs over the other; the
  only join is over the view axis.
`average_grid_sharded` sums K5-avg's bilinear samples for an x-slab a rank
(`x_off`, the views in the one-device order): bit-equal to the port's
one-device `average`, no collective.

Masks are (V, H, W) (nonzero: inside), or bit-packed rows (V,
ceil(HW/8)) uint8 with `hw=(H, W)`; numpy arrays or tensors. Each function
returns the global volume as a tensor on the mesh's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .launch import shared


def _packed_masks(masks, hw):
    """(bit-packed (V, B) uint8 tensor, (H, W)) of `masks` (see the module
    docstring)."""
    from ..ops.carving import pack_masks

    if hw is not None:
        packed = masks if torch.is_tensor(masks) else torch.from_numpy(
            np.ascontiguousarray(masks))
        return packed.to(torch.uint8), tuple(int(v) for v in hw)
    m = masks.cpu().numpy() if torch.is_tensor(masks) else np.asarray(masks)
    return torch.from_numpy(pack_masks(m)), tuple(m.shape[1:])


def _float32(x):
    return (x.to(torch.float32) if torch.is_tensor(x)
            else torch.from_numpy(np.ascontiguousarray(x, np.float32)))


def _bools(x):
    return (x.to(torch.bool) if torch.is_tensor(x)
            else torch.from_numpy(np.asarray(x, bool)))


def _carve_block(rt, layout, join_axis, packed, cams, valid, origin, vs,
                 shape, hw, x_start, keep):
    """One rank's carve: its views over its slab (K1 on its device), the
    views' join over `join_axis` when given. Returns the CPU volume where
    `keep`, else None."""
    import torch.distributed as dist

    from ..ops.carving import carve

    dev = rt.device
    vol = carve(packed.to(dev), cams.to(dev), valid.to(dev), origin, vs,
                shape, hw, x_start=x_start)
    if join_axis is not None:
        code = torch.where(vol == -1, 2, vol).to(torch.int8)
        dist.all_reduce(code, op=dist.ReduceOp.MAX,
                        group=rt.group(layout, join_axis))
        vol = torch.where(code == 2, -1, code).to(torch.int8)
    return vol.cpu() if keep else None


def _blocks(mesh, masks, cameras, valid, origin, voxel_size, shape, hw,
            view_axis, grid_axis):
    """Carve over the mesh: views sharded over `view_axis`, x-slabs over
    `grid_axis` (either may be None); the slabs in order of their index."""
    packed, hw = _packed_masks(masks, hw)
    V = packed.shape[0]
    nx, ny, nz = (int(s) for s in shape)
    nv = mesh.shape[view_axis] if view_axis else 1
    ng = mesh.shape[grid_axis] if grid_axis else 1
    if V % nv:
        raise ValueError(f"pad views to a multiple of {nv} (valid=False)")
    if nx % ng:
        raise ValueError(f"pad the grid's x axis to a multiple of {ng}")
    packed, cams, ok = (shared(t) for t in (packed, _float32(cameras),
                                            _bools(valid)))
    if tuple(cams.shape) != (V, 16) or tuple(ok.shape) != (V,):
        raise ValueError("cameras must be (V, 16) and valid (V,)")
    origin = np.asarray(origin, np.float32)
    per_v, per_x = V // nv, nx // ng
    args, where = [], []
    for i in range(mesh.size):
        c = mesh.coords(i)
        iv = c[view_axis] if view_axis else 0
        ig = c[grid_axis] if grid_axis else 0
        rest = all(v == 0 for a, v in c.items()
                   if a not in (view_axis, grid_axis))
        views = slice(iv * per_v, (iv + 1) * per_v)
        args.append((mesh.layout, view_axis, packed[views], cams[views],
                     ok[views], origin, float(voxel_size), (per_x, ny, nz),
                     hw, ig * per_x, rest and iv == 0))
        where.append(ig)
    slabs = {}
    for ig, vol in zip(where, mesh.run(_carve_block, args)):
        if vol is not None:
            slabs[ig] = vol
    return torch.cat([slabs[g] for g in range(ng)]).to(mesh.device)


def carve_sharded(masks, cameras, valid, origin, voxel_size, shape, mesh,
                  axis: str = "dp", hw=None):
    """View-sharded carve: the views in contiguous shards over `axis` (V
    divisible by its size: pad with valid=False), one MAX join. Returns
    the int8 volume, -1 killed / 1 seen / 0 unobserved."""
    return _blocks(mesh, masks, cameras, valid, origin, voxel_size, shape,
                   hw, axis, None)


def carve_grid_sharded(masks, cameras, valid, origin, voxel_size, shape,
                       mesh, axis: str = "dp", hw=None):
    """x-slab-sharded carve: the grid's x axis over `axis` (shape[0]
    divisible by its size: pad the box), every view on every rank; no
    collective on the volume."""
    return _blocks(mesh, masks, cameras, valid, origin, voxel_size, shape,
                   hw, None, axis)


def carve_2d_sharded(masks, cameras, valid, origin, voxel_size, shape, mesh,
                     view_axis: str = "vp", grid_axis: str = "gp", hw=None):
    """2-D carve: views over `view_axis` and x-slabs over `grid_axis`
    (V divisible by the first, shape[0] by the second); the only join is
    over the view axis."""
    return _blocks(mesh, masks, cameras, valid, origin, voxel_size, shape,
                   hw, view_axis, grid_axis)


def _average_slab(rt, masks, cams, valid, origin, vs, shape, x_off, keep):
    from ..ops.carving import average

    dev = rt.device
    vol = average(masks.to(dev), cams.to(dev), valid.to(dev), origin, vs,
                  shape, x_off=x_off)
    return vol.cpu() if keep else None


def average_grid_sharded(masks, cameras, valid, origin, voxel_size, shape,
                         mesh, axis: str = "dp"):
    """x-slab-sharded averaging volume (the ML route's Voxels(type=
    "averaging")): masks (V, H, W) float32, already scaled (and log'd) by
    the caller; each rank sums K5-avg's samples for its slab over all the
    views in order, its voxels indexed globally (`x_off`). shape[0]
    divisible by the axis size (pad the box). Returns the float32
    volume."""
    n = mesh.shape[axis]
    nx, ny, nz = (int(s) for s in shape)
    if nx % n:
        raise ValueError(f"pad the grid's x axis to a multiple of {n}")
    fm, cams, ok = (shared(t) for t in (_float32(masks), _float32(cameras),
                                        _bools(valid)))
    origin = np.asarray(origin, np.float32)
    sx = nx // n
    args, where = [], []
    for i in range(mesh.size):
        c = mesh.coords(i)
        rest = all(v == 0 for a, v in c.items() if a != axis)
        args.append((fm, cams, ok, origin, float(voxel_size), (sx, ny, nz),
                     c[axis] * sx, rest))
        where.append(c[axis])
    slabs = {}
    for g, vol in zip(where, mesh.run(_average_slab, args)):
        if vol is not None:
            slabs[g] = vol
    return torch.cat([slabs[g] for g in range(n)]).to(mesh.device)
