"""Space carving (volume back-projection): the carve kernel and its plain
PyTorch version.

Port of plant3dvision_tpu/ops/carving.py:carve and of the engine that
FusedCarving ships there (parallel/carving_mp.py:carve_fused), which gives
the same output. Semantics (reference kernels/backprojection.c): a voxel is
killed if ANY view projects it in-frustum onto a zero mask pixel (nearest
sampling, truncating int cast, z>0 test, border inclusive 0..W-1/0..H-1);
it is 'seen' if any in-frustum view hits a nonzero pixel. Output int8:
-1 killed / 1 seen / 0 never observed.

Masks arrive bit-packed, (V, ceil(HW/8)) uint8 rows of `np.packbits`
(MSB first), as FusedCarving builds them. `carve` dispatches on the
tensors' device: CUDA goes to the hand-written kernel
(kernels/csrc/carve.cu), CPU to `carve_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

EPS = 1e-9


def pack_camera(intrinsics, rot, tvec) -> np.ndarray:
    """[fx,fy,cx,cy] + 3x3 rotmat + tvec -> (16,) float32 row."""
    out = np.zeros(16, dtype=np.float32)
    out[0:4] = np.asarray(intrinsics, dtype=np.float32)[:4]
    out[4:13] = np.asarray(rot, dtype=np.float32).reshape(9)
    out[13:16] = np.asarray(tvec, dtype=np.float32).reshape(3)
    return out


def camera_from_metadata(cam_md: dict) -> np.ndarray:
    """Reference per-image camera metadata (cl.py:293-296):
    {'camera_model': {'params': [fx,fy,cx,cy,...]}, 'rotmat': 3x3, 'tvec': 3}."""
    return pack_camera(cam_md["camera_model"]["params"][0:4],
                       cam_md["rotmat"], cam_md["tvec"])


def pack_masks(masks) -> np.ndarray:
    """Binary masks (V, H, W) (or one (H, W) mask) -> flat row-major
    MSB-first bit rows (V, ceil(HW/8)) uint8 (one row for one mask)."""
    m = np.asarray(masks)
    if m.ndim == 2:
        return np.packbits(m.reshape(-1) != 0)
    return np.packbits(m.reshape(len(m), -1) != 0, axis=1)


def _check_args(packed, cameras, valid, shape, hw):
    H, W = hw
    V = packed.shape[0]
    if packed.dtype != torch.uint8 or packed.ndim != 2:
        raise ValueError("packed masks must be (V, ceil(HW/8)) uint8")
    if packed.shape[1] < (H * W + 7) // 8:
        raise ValueError(f"packed rows hold {packed.shape[1] * 8} bits, "
                         f"need {H * W}")
    if cameras.dtype != torch.float32 or tuple(cameras.shape) != (V, 16):
        raise ValueError("cameras must be (V, 16) float32")
    if valid.dtype != torch.bool or tuple(valid.shape) != (V,):
        raise ValueError("valid must be (V,) bool")
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"bad grid shape {shape}")


def carve(packed, cameras, valid, origin, voxel_size, shape, hw):
    """Carve a voxel grid from bit-packed binary masks.

    packed (V, ceil(HW/8)) uint8, cameras (V, 16) float32
    [fx,fy,cx,cy, rotmat(9) row-major, tvec(3)], valid (V,) bool, all on one
    device; origin (3,), voxel_size float, shape (nx, ny, nz), hw (H, W).
    Returns the int8 (nx, ny, nz) volume on that device.
    """
    _check_args(packed, cameras, valid, shape, hw)
    if packed.device.type == "cpu":
        return carve_plain(packed, cameras, valid, origin, voxel_size, shape,
                           hw)
    kernels.require_cuda("carve", packed, cameras, valid)
    H, W = hw
    nx, ny, nz = (int(s) for s in shape)
    o = np.asarray(origin, np.float32)
    out = torch.empty((nx, ny, nz), dtype=torch.int8, device=packed.device)
    valid_u8 = valid.to(torch.uint8)
    so = kernels.lib()
    rc = so.p3d_carve(packed.data_ptr(), packed.shape[1], cameras.data_ptr(),
                      valid_u8.data_ptr(), packed.shape[0], H, W,
                      float(o[0]), float(o[1]), float(o[2]),
                      float(np.float32(voxel_size)), nx, ny, nz,
                      out.data_ptr(), kernels.stream_ptr(packed.device))
    kernels.LAUNCHES["carve"] += 1
    kernels.check("carve", rc)
    return out


def fma_f32(a, b, c):
    """Correctly rounded float32 fused multiply-add a*b + c, elementwise.

    a*b is exact in float64; the float64 sum is made round-to-odd (its
    exact error from TwoSum decides the last bit), and a round-to-odd
    float64 rounds to the correctly rounded float32.
    """
    a, b, c = torch.broadcast_tensors(a.double(), b.double(), c.double())
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, torch.where(err > 0, torch.inf,
                                                   -torch.inf).to(s)), s)
    return s.float()


def _dot3_add(a, b, c, x, y, z, t):
    """((a*x + b*y) + c*z) + t as XLA compiles it (see carve.cu)."""
    return fma_f32(c, z, fma_f32(b, y, a * x)) + t


def carve_plain(packed, cameras, valid, origin, voxel_size, shape, hw,
                count_work=False):
    """Plain PyTorch version of the carve kernel (the same f32 operations,
    fused multiply-adds at the same places; one view at a time over the
    whole grid).

    count_work=True returns (volume, tests, mask_bytes): the work that a
    kernel which stops at a voxel's first kill has to do on these inputs,
    as the number of voxel-view tests it makes and the number of distinct
    packed-mask bytes those tests read.
    """
    H, W = hw
    nx, ny, nz = (int(s) for s in shape)
    dev = packed.device
    f32 = torch.float32
    o = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    vs = torch.tensor(voxel_size, dtype=f32, device=dev)
    x = (o[0] + vs * torch.arange(nx, dtype=f32, device=dev)).view(nx, 1, 1)
    y = (o[1] + vs * torch.arange(ny, dtype=f32, device=dev)).view(1, ny, 1)
    z = (o[2] + vs * torch.arange(nz, dtype=f32, device=dev)).view(1, 1, nz)
    killed = torch.zeros((nx, ny, nz), dtype=torch.bool, device=dev)
    seen = torch.zeros_like(killed)
    tests = mask_bytes = 0
    for v in range(packed.shape[0]):
        if not bool(valid[v]):
            continue
        c = cameras[v]
        pz = _dot3_add(c[10], c[11], c[12], x, y, z, c[15])
        numx = _dot3_add(c[4], c[5], c[6], x, y, z, c[13])
        numy = _dot3_add(c[7], c[8], c[9], x, y, z, c[14])
        px = fma_f32(numx / pz, c[0], c[2])
        py = fma_f32(numy / pz, c[1], c[3])
        # trunc(p) in [0, W-1]  <=>  -1 < p < W  (for non-NaN p); the clamp
        # keeps the int cast defined outside the frame
        in_img = (pz > 0) & (px > -1) & (px < W) & (py > -1) & (py < H)
        pxi = px.clamp(0, W - 1).to(torch.int64)
        pyi = py.clamp(0, H - 1).to(torch.int64)
        lin = pyi * W + pxi
        byte = packed[v][lin >> 3].to(torch.int64)
        hit = ((byte >> (7 - (lin & 7))) & 1) == 1
        if count_work:
            tests += int((~killed).sum())
            mask_bytes += int(torch.unique(
                (lin >> 3)[in_img & ~killed]).numel())
        killed |= in_img & ~hit
        seen |= in_img & hit
    vol = torch.where(killed, -1, torch.where(seen, 1, 0)).to(torch.int8)
    return (vol, tests, mask_bytes) if count_work else vol


#: averaging volumes with more voxel-labels than this go through the grid-slab
#: lane (FusedSegmentationCarving); the JAX package's default and variable
#: (plant3dvision_tpu/ops/carving.py:_avg_chunk_voxels). The port's kernel
#: holds no per-view temporaries, so on the card the slabs bound only the
#: plain version's memory. Override with P3D_AVG_CHUNK_VOXELS.
def _avg_chunk_voxels() -> int:
    import os
    return int(os.environ.get("P3D_AVG_CHUNK_VOXELS", str(24 << 20)))
