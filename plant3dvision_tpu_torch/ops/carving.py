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

`count_kills` / `carve_tolerant` (the vote carve of ops/carving.py:176-239:
per voxel the number of in-frame views that miss it, int16, and whether any
hits it; killed when the count exceeds a tolerance) read the same packed
masks: on CUDA the kills kernel of kernels/csrc/carve.cu (K11), on the CPU
`count_kills_plain` / `carve_tolerant_plain`.

`average` (and its grid-slab lane `average_chunked`) accumulates one
label's bilinearly sampled mask values over the in-frustum views: on CUDA
the accumulate kernel's `avg` mode at C = 1 (K5-avg,
kernels/csrc/accumulate.cu), on the CPU `average_plain`. `Backprojection`
is the reference's cl.Backprojection surface over both (Voxels).
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


def div_f32(x, d: float):
    """x / d, correctly rounded on every device: PyTorch's CUDA division by
    a Python scalar multiplies by the scalar's reciprocal (another rounding),
    so the divisor goes in as a tensor on x's device."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _dot3_add(a, b, c, x, y, z, t):
    """((a*x + b*y) + c*z) + t as XLA compiles it (see carve.cu)."""
    return fma_f32(c, z, fma_f32(b, y, a * x)) + t


def project(cam, origin, voxel_size, x_start, shape, hw, grid_fma=True):
    """(px, py, in_img) of the voxel centres of the x rows [x_start,
    x_start + shape[0]) of a grid, for one packed camera row, in the f32
    operations of the JAX programs as XLA compiles them on the CPU: the
    grid coordinate is fma(vs, i, origin) in ml_fused's accumulate
    (`grid_fma`) and origin + vs*i in `average` (see
    kernels/csrc/accumulate.cu); the dot products and pixels as carve.cu."""
    H, W = hw
    dev = cam.device
    f32 = torch.float32
    o = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    vs = torch.tensor(np.float32(voxel_size), device=dev)
    ax = []
    for a, (n, off) in enumerate(zip(shape, (x_start, 0, 0))):
        i = torch.arange(off, off + n, dtype=f32, device=dev)
        g = fma_f32(vs, i, o[a]) if grid_fma else o[a] + vs * i
        ax.append(g.view([-1 if b == a else 1 for b in range(3)]))
    x, y, z = ax
    c = cam
    pz = _dot3_add(c[10], c[11], c[12], x, y, z, c[15])
    px = fma_f32(_dot3_add(c[4], c[5], c[6], x, y, z, c[13]) / pz, c[0], c[2])
    py = fma_f32(_dot3_add(c[7], c[8], c[9], x, y, z, c[14]) / pz, c[1], c[3])
    # trunc(p) in [0, W-1]  <=>  -1 < p < W  (for non-NaN p)
    in_img = (pz > 0) & (px > -1) & (px < W) & (py > -1) & (py < H)
    return px, py, in_img


def _view_tests(packed, cameras, valid, origin, voxel_size, shape, hw):
    """(in_img, hit, lin) of every valid view over the whole grid, in the
    carve kernel's f32 operations (fused multiply-adds at the same places)."""
    H, W = hw
    nx, ny, nz = (int(s) for s in shape)
    dev = packed.device
    f32 = torch.float32
    o = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    vs = torch.tensor(voxel_size, dtype=f32, device=dev)
    x = (o[0] + vs * torch.arange(nx, dtype=f32, device=dev)).view(nx, 1, 1)
    y = (o[1] + vs * torch.arange(ny, dtype=f32, device=dev)).view(1, ny, 1)
    z = (o[2] + vs * torch.arange(nz, dtype=f32, device=dev)).view(1, 1, nz)
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
        yield in_img, hit, lin


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
    shape = tuple(int(s) for s in shape)
    killed = torch.zeros(shape, dtype=torch.bool, device=packed.device)
    seen = torch.zeros_like(killed)
    tests = mask_bytes = 0
    for in_img, hit, lin in _view_tests(packed, cameras, valid, origin,
                                           voxel_size, shape, hw):
        if count_work:
            tests += int((~killed).sum())
            mask_bytes += int(torch.unique(
                (lin >> 3)[in_img & ~killed]).numel())
        killed |= in_img & ~hit
        seen |= in_img & hit
    vol = torch.where(killed, -1, torch.where(seen, 1, 0)).to(torch.int8)
    return (vol, tests, mask_bytes) if count_work else vol


def _check_kills_args(packed, cameras, valid, shape, hw):
    _check_args(packed, cameras, valid, shape, hw)
    if packed.shape[0] > 32767:
        raise ValueError("the int16 kill counts take at most 32767 views")


def count_kills(packed, cameras, valid, origin, voxel_size, shape, hw):
    """Per-voxel dissenting-view count (int16) and seen flag (bool) of the
    valid views (plant3dvision_tpu/ops/carving.py:count_kills): the
    arguments as `carve`'s; both on the tensors' device."""
    _check_kills_args(packed, cameras, valid, shape, hw)
    if packed.device.type == "cpu":
        return count_kills_plain(packed, cameras, valid, origin, voxel_size,
                                 shape, hw)
    shape = tuple(int(s) for s in shape)
    kills = torch.empty(shape, dtype=torch.int16, device=packed.device)
    seen = torch.empty(shape, dtype=torch.bool, device=packed.device)
    _launch_kills(packed, cameras, valid, origin, voxel_size, shape, hw, -1,
                  kills.data_ptr(), seen.data_ptr(), None)
    return kills, seen


def carve_tolerant(packed, cameras, valid, origin, voxel_size, shape, hw,
                   max_kills):
    """Vote carve (plant3dvision_tpu/ops/carving.py:carve_tolerant): int8
    -1 where more than `max_kills` in-frame views miss the voxel, else 1 if
    one hits it, else 0; the arguments as `carve`'s."""
    _check_kills_args(packed, cameras, valid, shape, hw)
    if int(max_kills) < 0:
        raise ValueError("max_kills must be >= 0")
    if packed.device.type == "cpu":
        return carve_tolerant_plain(packed, cameras, valid, origin,
                                    voxel_size, shape, hw, max_kills)
    shape = tuple(int(s) for s in shape)
    vol = torch.empty(shape, dtype=torch.int8, device=packed.device)
    _launch_kills(packed, cameras, valid, origin, voxel_size, shape, hw,
                  min(int(max_kills), 32767), None, None, vol.data_ptr())
    return vol


def _launch_kills(packed, cameras, valid, origin, voxel_size, shape, hw,
                  max_kills, kills_ptr, seen_ptr, vol_ptr):
    kernels.require_cuda("count_kills", packed, cameras, valid)
    H, W = hw
    nx, ny, nz = shape
    o = np.asarray(origin, np.float32)
    valid_u8 = valid.to(torch.uint8)
    rc = kernels.lib().p3d_count_kills(
        packed.data_ptr(), packed.shape[1], cameras.data_ptr(),
        valid_u8.data_ptr(), packed.shape[0], H, W, float(o[0]), float(o[1]),
        float(o[2]), float(np.float32(voxel_size)), nx, ny, nz, max_kills,
        kills_ptr, seen_ptr, vol_ptr, kernels.stream_ptr(packed.device))
    kernels.LAUNCHES["count_kills"] += 1
    kernels.check("count_kills", rc)


def count_kills_plain(packed, cameras, valid, origin, voxel_size, shape, hw,
                      count_work=False):
    """Plain PyTorch version of the kills kernel's count mode (one view at
    a time). count_work=True also returns the number of distinct packed-mask
    bytes that its in-frame tests read."""
    shape = tuple(int(s) for s in shape)
    kills = torch.zeros(shape, dtype=torch.int16, device=packed.device)
    seen = torch.zeros(shape, dtype=torch.bool, device=packed.device)
    mask_bytes = 0
    for in_img, hit, lin in _view_tests(packed, cameras, valid, origin,
                                           voxel_size, shape, hw):
        kills += (in_img & ~hit).to(torch.int16)
        seen |= in_img & hit
        if count_work:
            mask_bytes += int(torch.unique((lin >> 3)[in_img]).numel())
    return (kills, seen, mask_bytes) if count_work else (kills, seen)


def tolerance_verdict(kills, seen, max_kills):
    """int8 -1 / 1 / 0 of (merged) int16 kill counts and seen flags."""
    return torch.where(kills > min(int(max_kills), 32767), -1,
                       torch.where(seen, 1, 0)).to(torch.int8)


def carve_tolerant_plain(packed, cameras, valid, origin, voxel_size, shape,
                         hw, max_kills):
    """Plain PyTorch version of the kills kernel's verdict mode."""
    kills, seen = count_kills_plain(packed, cameras, valid, origin,
                                    voxel_size, shape, hw)
    return tolerance_verdict(kills, seen, max_kills)


#: averaging volumes with more voxel-labels than this go through the grid-slab
#: lane (FusedSegmentationCarving); the JAX package's default and variable
#: (plant3dvision_tpu/ops/carving.py:_avg_chunk_voxels). The port's kernel
#: holds no per-view temporaries, so on the card the slabs bound only the
#: plain version's memory. Override with P3D_AVG_CHUNK_VOXELS.
def _avg_chunk_voxels() -> int:
    import os
    return int(os.environ.get("P3D_AVG_CHUNK_VOXELS", str(24 << 20)))


def _check_average_args(masks, cameras, valid, shape):
    if masks.dtype != torch.float32 or masks.ndim != 3:
        raise ValueError("masks must be (V, H, W) float32")
    V, H, W = masks.shape
    if H < 2 or W < 2:
        raise ValueError(f"masks must be at least 2x2, got {H}x{W}")
    if cameras.dtype != torch.float32 or tuple(cameras.shape) != (V, 16):
        raise ValueError("cameras must be (V, 16) float32")
    if valid.dtype != torch.bool or tuple(valid.shape) != (V,):
        raise ValueError("valid must be (V,) bool")
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"bad grid shape {shape}")


def average(masks, cameras, valid, origin, voxel_size, shape, x_off=0):
    """Accumulate bilinearly sampled mask values over all in-frustum views
    (plant3dvision_tpu/ops/carving.py:average).

    masks (V, H, W) float32 (already scaled, and log-transformed by the
    caller in the reference's 'log' mode), cameras (V, 16) float32, valid
    (V,) bool, all on one device; origin (3,), voxel_size float, shape
    (nx, ny, nz). `x_off` shifts the x index by a global voxel index (a
    slab of a larger grid, `average_chunked`). Returns the float32 `shape`
    volume on that device."""
    shape = tuple(int(s) for s in shape)
    _check_average_args(masks, cameras, valid, shape)
    if masks.device.type == "cpu":
        return average_plain(masks, cameras, valid, origin, voxel_size,
                             shape, x_off)
    kernels.require_cuda("average", masks, cameras, valid)
    V, H, W = masks.shape
    nx, ny, nz = shape
    o = np.asarray(origin, np.float32)
    vol = torch.zeros(shape, dtype=torch.float32, device=masks.device)
    valid_u8 = valid.to(torch.uint8)
    rc = kernels.lib().p3d_accumulate(
        vol.data_ptr(), masks.data_ptr(), cameras.data_ptr(),
        valid_u8.data_ptr(), V, 1, H, W, float(o[0]), float(o[1]),
        float(o[2]), float(np.float32(voxel_size)), nx, ny, nz, int(x_off),
        nx, 0, 0, 1, int(x_off), kernels.stream_ptr(masks.device))
    kernels.LAUNCHES["average"] += 1
    kernels.check("average", rc)
    return vol


def average_plain(masks, cameras, valid, origin, voxel_size, shape, x_off=0):
    """Plain PyTorch version of K5-avg: `average`'s f32 operations in its
    order (the value g00*(1-fx)*(1-fy) + g01*fx*(1-fy) + g10*(1-fx)*fy +
    g11*fx*fy with XLA's fused multiply-adds, accumulate.cu), one view at a
    time over the grid."""
    V, H, W = masks.shape
    acc = torch.zeros(shape, dtype=torch.float32, device=masks.device)
    flat = masks.reshape(V, H * W)
    for v in range(V):
        if not bool(valid[v]):
            continue
        px, py, in_img = project(cameras[v], origin, voxel_size, x_off, shape,
                                 (H, W), grid_fma=False)
        fx0 = torch.nan_to_num(torch.floor(px).clamp(0, W - 2))
        fy0 = torch.nan_to_num(torch.floor(py).clamp(0, H - 2))
        fx = (px - fx0).clamp(0.0, 1.0)
        fy = (py - fy0).clamp(0.0, 1.0)
        gx, gy = 1 - fx, 1 - fy
        i00 = fy0.long() * W + fx0.long()

        def g(i):
            return flat[v][i.reshape(-1)].reshape(i.shape)

        val = fma_f32(g(i00 + W + 1) * fx, fy,
                      fma_f32(g(i00 + W) * gx, fy,
                              fma_f32(g(i00 + 1) * fx, gy,
                                      (g(i00) * gx) * gy)))
        acc += torch.where(in_img, val, 0.0)
    return acc


def average_chunked(masks, cameras, valid, origin, voxel_size, shape,
                    max_slab_voxels=16 << 20):
    """Grid-slab `average` (plant3dvision_tpu/ops/carving.py:
    average_chunked): the x axis in equal slabs of at most
    `max_slab_voxels` voxels, each projected with its global x offset and
    cropped into the `shape` volume. On the card the kernel holds no
    per-view temporaries, so the slabs bound only the plain version's
    memory; the rule is the JAX package's."""
    nx, ny, nz = (int(s) for s in shape)
    per_x = ny * nz
    sx = max(1, max(int(max_slab_voxels), per_x) // per_x)
    sx = min(sx, nx)
    out = torch.empty((nx, ny, nz), dtype=torch.float32, device=masks.device)
    for xs in range(0, nx, sx):
        vol = average(masks, cameras, valid, origin, voxel_size,
                      (sx, ny, nz), x_off=xs)
        take = min(sx, nx - xs)
        out[xs:xs + take] = vol[:take]
    return out


class Backprojection:
    """The reference's cl.Backprojection surface (cl.py:118) over the
    port's kernels (port of plant3dvision_tpu/ops/carving.py:
    Backprojection): `type="carving"` carves every flush with K1 and merges
    flushes (killed in any, else seen in any), or with `kill_tolerance > 0`
    counts each flush's kills with K11 and merges the counts and seen flags
    across flushes, the tolerance applied to the merged counts (never per
    flush); `type="averaging"` sums the
    views' sampled mask values (uint8 masks / 255, log(EPS + m) in `log`
    mode, in numpy float32 as the JAX package) with K5-avg, through the
    grid-slab lane above `_avg_chunk_voxels()` voxels. The JAX package
    sends two-valued masks to its tile engine (ops/averaging_tiled.py),
    which computes the same function; here they take the same call.

    `engine` ("auto" or "sharded", the JAX package's multi-chip lane) runs
    on the one device. Values are tensors on `device`."""

    def __init__(self, shape, origin, voxel_size, type="carving",
                 default_value=0, labels=None, log=False,
                 kill_tolerance=0, engine="auto", device="cpu"):
        self.shape = tuple(int(s) for s in shape)
        self.origin = np.asarray(origin, dtype=np.float32)
        self.voxel_size = float(voxel_size)
        self.type = type
        self.default_value = default_value
        self.labels = labels
        self.log = log
        self.kill_tolerance = int(kill_tolerance)
        self.device = torch.device(device)
        if type not in ("carving", "averaging"):
            raise ValueError(
                f"Unknown kernel type {type}, valid values are 'averaging' or 'carving'!")
        self.dtype = torch.int32 if type == "carving" else torch.float32
        self._pending_masks = []
        self._pending_cams = []
        self._values = None
        self._kills = None
        self._seen = None

    def process_view(self, intrinsics, rot, tvec, mask):
        self._pending_masks.append(np.asarray(mask))
        self._pending_cams.append(pack_camera(intrinsics, rot, tvec))

    def _flush(self):
        if not self._pending_masks:
            if self._values is None:
                self._values = torch.full(self.shape, self.default_value,
                                          dtype=self.dtype, device=self.device)
            return
        masks = np.stack(self._pending_masks)
        dev = self.device
        cams = torch.from_numpy(np.stack(self._pending_cams)).to(dev)
        valid = torch.ones(len(masks), dtype=torch.bool, device=dev)
        if self.type == "carving":
            packed = torch.from_numpy(pack_masks(masks)).to(dev)
            args = (packed, cams, valid, self.origin, self.voxel_size,
                    self.shape, masks.shape[1:])
            if self.kill_tolerance > 0:
                kills, seen = count_kills(*args)
                if self._kills is not None:
                    kills += self._kills
                    seen |= self._seen
                self._kills, self._seen = kills, seen
                vol = tolerance_verdict(kills, seen, self.kill_tolerance).to(
                    torch.int32)
            else:
                vol = carve(*args).to(torch.int32)
            if self._values is not None and self.kill_tolerance <= 0:
                prev = self._values
                killed = (prev == -1) | (vol == -1)
                seen = (prev == 1) | (vol == 1)
                vol = torch.where(killed, -1, torch.where(seen, 1, 0)).to(
                    torch.int32)
        else:
            fmasks = masks.astype(np.float32)
            if masks.dtype == np.uint8:
                fmasks = fmasks / 255.0
            if self.log:
                fmasks = np.log(EPS + fmasks)
            fm = torch.from_numpy(fmasks).to(dev)
            if int(np.prod(self.shape)) > _avg_chunk_voxels():
                vol = average_chunked(fm, cams, valid, self.origin,
                                      self.voxel_size, self.shape)
            else:
                vol = average(fm, cams, valid, self.origin, self.voxel_size,
                              self.shape)
            if self._values is not None:
                vol = self._values + vol
        self._values = vol
        self._pending_masks = []
        self._pending_cams = []

    def get_values(self):
        self._flush()
        return self._values.reshape(self.shape)

    def clear(self):
        self._pending_masks = []
        self._pending_cams = []
        self._values = None
        self._kills = None
        self._seen = None

    def process_fileset(self, fs, camera_metadata, invert=False):
        """One volume ((L, *shape) float32 with `labels`: one label's masks
        each, selected by their 'channel' metadata)."""
        files = fs.get_files() if hasattr(fs, "get_files") else list(fs)
        if self.labels is not None:
            result = torch.zeros((len(self.labels), *self.shape),
                                 dtype=torch.float32, device=self.device)
            for i, label in enumerate(self.labels):
                self.clear()
                result[i] = self.process_label(files, camera_metadata, label,
                                               invert)
            return result
        return self.process_label(files, camera_metadata, None, invert=invert)

    def process_label(self, files, camera_metadata, label=None, invert=False):
        from concurrent.futures import ThreadPoolExecutor
        from ..fsdb import io

        selected = []
        for fi in files:
            if label is not None and fi.get_metadata("channel") != label:
                continue
            cam = fi.get_metadata(camera_metadata, default=None)
            if cam is None:
                continue
            selected.append((fi, cam))

        def _load(item):
            fi, cam = item
            mask = io.read_image(fi)
            if invert:
                mask = np.invert(mask)
            return camera_from_metadata(cam), mask

        # PNG decode dominates mask ingestion: load in parallel
        with ThreadPoolExecutor(max_workers=8) as ex:
            for c, mask in ex.map(_load, selected):
                self.process_view(c[0:4], c[4:13], c[13:16], mask)
        return self.get_values()
