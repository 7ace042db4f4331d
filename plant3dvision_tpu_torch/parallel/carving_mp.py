"""The multi-rank carve that the tasks call (port of
plant3dvision_tpu/parallel/carving_mp.py: `make_sharded_carver`,
`carve_sharded_hierarchical`).

The JAX package carves each view shard through a level hierarchy (cell
pyramids, per-level caps, a tile row-gather fine level) because a dense
carve is gather-bound on a TPU; its result is the dense carve's, bit for
bit. On the card every carve is K1 (the single-device engines route to it
too), so these keep the JAX names and signatures (`cap=`, `caps=`,
`fine_tiles=`, `packed=` / `hw=` included) and compute `carve_sharded`'s
function. There are no levels to overflow: the counts they return are
zeros, one a level, as the JAX counts of a carve within its caps.
"""

from __future__ import annotations

import numpy as np
import torch

from .carving import _packed_masks, carve_sharded


def make_sharded_carver(mesh, axis, H: int, W: int, V_total: int, shape,
                        start_level: int = 3, pyramid_levels: int = 8,
                        cap: int = 8192, caps=None, fine_tiles=False):
    """Returns fn(packed (V_total, ceil(HW/8)) uint8, cams (V_total, 16),
    valid (V_total,), origin (3,), voxel_size) -> (int8 volume of `shape`
    on the mesh's device, int64 counts: one a refinement level, then the
    tile-window overflow with `fine_tiles`, all zero)."""
    n_shards = mesh.shape[axis]
    if V_total % n_shards:
        raise ValueError("pad views to a multiple of the mesh axis")
    if caps is None:
        caps = (cap, cap)
    n_counts = len(caps) + (1 if fine_tiles else 0)
    shape = tuple(int(s) for s in shape)

    def fn(packed, cams, valid, origin, voxel_size):
        if packed.shape[0] != V_total:
            raise ValueError(f"the carver takes {V_total} views, got "
                             f"{packed.shape[0]}")
        vol = carve_sharded(packed, cams, valid, origin, voxel_size, shape,
                            mesh, axis, hw=(H, W))
        return vol, np.zeros(n_counts, np.int64)

    return fn


def carve_sharded_hierarchical(masks, cameras, valid, origin, voxel_size,
                               shape, mesh, axis: str = "dp",
                               cap: int = 8192, fine_tiles=True,
                               packed=None, hw=None):
    """Pad the views to a multiple of the axis (valid=False), pack them
    (or take bit-packed `packed` with `hw`=(H, W), a tensor on any device
    or an array), carve over the mesh. Returns the int8 volume on the
    mesh's device."""
    if packed is not None:
        packed, (H, W) = _packed_masks(packed, hw)
    else:
        packed, (H, W) = _packed_masks(masks, None)
    cams = (cameras.to(torch.float32).cpu() if torch.is_tensor(cameras)
            else torch.from_numpy(np.ascontiguousarray(cameras, np.float32)))
    ok = (valid.to(torch.bool).cpu() if torch.is_tensor(valid)
          else torch.from_numpy(np.asarray(valid, bool)))
    V = packed.shape[0]
    pad = (-V) % mesh.shape[axis]
    if pad:
        packed = torch.cat([packed.cpu(), packed.new_zeros(
            (pad, packed.shape[1])).cpu()])
        cams = torch.cat([cams, cams[-1:].expand(pad, 16)])
        ok = torch.cat([ok, torch.zeros(pad, dtype=torch.bool)])
    fn = make_sharded_carver(mesh, axis, H, W, V + pad, shape, cap=cap,
                             fine_tiles=fine_tiles)
    vol, _ = fn(packed, cams, ok, origin, voxel_size)
    return vol
