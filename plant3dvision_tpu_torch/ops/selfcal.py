"""Turntable self-calibration: silhouette-coherence CEM over the CNC poses.

Port of plant3dvision_tpu/ops/selfcal.py (Hernandez, Schmitt & Cipolla,
"Silhouette Coherence for Camera Calibration under Circular Motion", PAMI
2007): carve the visual hull of a candidate calibration from all
silhouettes, then measure how completely it re-projects onto each
silhouette. The host logic (seeds, CEM updates, hull crops, the numpy
random stream) is the JAX package's, step for step; the device work is two
hand-written kernels:

- the per-candidate hull, `carve_candidates` (K11b, ops/carving.py): the
  whole CEM population in one launch, instead of the JAX package's
  8-candidate dispatches and `lax.map` chunks, which only bounded TPU
  program length and memory (candidates are independent, so the scores are
  the same);
- the silhouette ray coverage, `ray_coverage_counts` (K12,
  kernels/csrc/coverage.cu): one call per population, per polish round
  (every view x search delta) and per `coverage_for_cameras`, each two
  launches (the alive voxels' box, then the walk).

`ray_coverage_counts_plain` is K12's plain PyTorch version (the CPU path and
its oracle on the card). The arithmetic is that of XLA's CPU program for
`_ray_coverage` (fused multiply-adds included, see coverage.cu), so on the
same cameras and hull the coverage equals the JAX package's. The cameras
themselves (`cnc_to_cameras`) go through torch's sin and cos, which differ
from XLA's by an ulp on some inputs.

Functions that take numpy masks take a `device`; the CUDA kernels run
there, the plain versions on the CPU.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import kernels
from .carving import carve_candidates, fma_f32, pack_masks

#: theta layout (full-resolution pixels / degrees / millimetres)
THETA_NAMES = ("f", "dcx", "dcy", "dpan", "dtilt", "roll", "mx", "my", "mz")

#: default CEM search widths per parameter; frozen parameters get 0.
DEFAULT_STD = {"f": 0.25, "dcx": 20.0, "dcy": 20.0, "dpan": 3.0,
               "dtilt": 4.0, "roll": 1.5, "mx": 10.0, "my": 20.0, "mz": 15.0}

DEFAULT_FREE = ("f", "dpan", "dtilt", "roll", "mx", "my")

#: voxels x candidates of one K11b launch (bounds the alive volumes' memory)
_CANDIDATE_VOXELS = 1 << 30


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
        x, torch.Tensor) else x, dtype=torch.float32, device=device)


def cnc_to_cameras(poses, theta, width, height, scale=1.0, droll=None,
                   device=None):
    """Packed cameras [fx,fy,cx,cy,R(9),t(3)] from CNC poses.

    poses (V, 5) [X, Y, Z, pan_deg, tilt_deg]; theta (9,) -> (V, 16), or a
    (B, 9) batch of candidates -> (B, V, 16); droll (V,) per-view roll
    deltas (degrees). The camera sits at (X, Y, Z), looks along
    R_z(pan + 90 deg)·x̂, tilt > 0 looks up; mount offsets (mx, my, mz) move
    the optical centre along the camera's right/down/forward axes; `scale`
    rescales the intrinsics. float32 torch on `device` (default: theta's,
    else poses', else the CPU); differentiable in theta and droll."""
    if device is None:
        device = next((x.device for x in (theta, poses)
                       if isinstance(x, torch.Tensor)), "cpu")
    poses = _f32(poses, device)
    theta = _f32(theta, device)
    f, dcx, dcy, dpan, dtilt, roll, mx, my, mz = (
        theta[..., i, None] for i in range(9))
    phi = torch.deg2rad(poses[:, 3] + 90.0 + dpan)
    tau = torch.deg2rad(poses[:, 4] + dtilt)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    ctau, stau = torch.cos(tau), torch.sin(tau)
    zeros = torch.zeros_like(phi)
    fwd = (cphi * ctau, sphi * ctau, stau)
    right0 = (sphi, -cphi, zeros)
    down0 = (fwd[1] * right0[2] - fwd[2] * right0[1],
             fwd[2] * right0[0] - fwd[0] * right0[2],
             fwd[0] * right0[1] - fwd[1] * right0[0])
    rho = torch.deg2rad(roll).expand(phi.shape)
    if droll is not None:
        rho = rho + torch.deg2rad(_f32(droll, device))
    cr, sr = torch.cos(rho), torch.sin(rho)
    right = tuple(cr * a + sr * b for a, b in zip(right0, down0))
    down = tuple(-sr * a + cr * b for a, b in zip(right0, down0))
    C = tuple(poses[:, i] + mx * right[i] + my * down[i] + mz * fwd[i]
              for i in range(3))
    rows = (right, down, fwd)
    t = tuple(-(r[0] * C[0] + r[1] * C[1] + r[2] * C[2]) for r in rows)
    s = torch.tensor(np.float32(scale), device=device)
    fx = (f * s).expand(phi.shape)
    cx = ((float(width) / 2.0 + dcx) * s).expand(phi.shape)
    cy = ((float(height) / 2.0 + dcy) * s).expand(phi.shape)
    return torch.stack([fx, fx, cx, cy, *(v for r in rows for v in r), *t],
                       dim=-1)


# -- K12: silhouette ray coverage ---------------------------------------------

def _box(origin, voxel_size, shape):
    """The grid box's min and max corners as XLA computes them in
    _ray_coverage: origin + vs*n per axis, the product fused into the add,
    except on a cube (XLA's compiler then forms one product vs*n for the
    three axes and does not fuse it)."""
    o, hi = _box_of(tuple(np.asarray(origin, np.float32).tolist()),
                    float(np.float32(voxel_size)), tuple(shape))
    return o.copy(), hi.copy()


@functools.lru_cache(maxsize=64)
def _box_of(origin, voxel_size, shape):
    """`_box` of hashable arguments, cached: its emulated fused
    multiply-adds take a fraction of a millisecond of host time, more than
    a coverage launch's kernel, and a calibration asks for the same few
    grids again and again."""
    o = np.asarray(origin, np.float32)
    vs = np.float32(voxel_size)
    hi = np.empty(3, np.float32)
    cube = len(set(shape)) == 1
    for a, n in enumerate(shape):
        if not cube:
            hi[a] = fma_f32(torch.tensor(vs), torch.tensor(np.float32(n)),
                            torch.tensor(o[a])).item()
        else:
            hi[a] = o[a] + vs * np.float32(n)
    return o, hi


def _check_coverage_args(cams, vol_of, view_of, alive, sil_uv, sil_valid,
                         shape):
    G = cams.shape[0]
    if cams.dtype != torch.float32 or tuple(cams.shape) != (G, 16):
        raise ValueError("cams must be (G, 16) float32")
    for name, x in (("vol_of", vol_of), ("view_of", view_of)):
        if x.dtype != torch.int32 or tuple(x.shape) != (G,):
            raise ValueError(f"{name} must be (G,) int32")
    if alive.dtype != torch.bool or alive.ndim != 4 \
            or tuple(alive.shape[1:]) != tuple(shape):
        raise ValueError("alive must be (NB, nx, ny, nz) bool")
    V, N = sil_valid.shape
    if sil_uv.dtype != torch.float32 or tuple(sil_uv.shape) != (V, N, 2):
        raise ValueError("sil_uv must be (V, N, 2) float32")
    if sil_valid.dtype != torch.bool:
        raise ValueError("sil_valid must be (V, N) bool")


def ray_coverage_counts(cams, vol_of, view_of, alive, sil_uv, sil_valid,
                        origin, voxel_size, shape, n_steps):
    """Silhouette ray coverage of G ray groups (the core of
    plant3dvision_tpu/ops/selfcal.py:_ray_coverage).

    Group g casts the rays of view `view_of[g]`'s samples (sil_uv (V, N, 2)
    low-res pixel (u, v), sil_valid (V, N)) through camera cams[g] into the
    alive volume alive[vol_of[g]] ((NB, nx, ny, nz) bool). Returns int32
    (covered, valid) counts per group: valid samples, and those whose ray
    meets the grid box and lands, at one of `n_steps` midpoint samples, in
    an alive voxel. On CUDA K12 (kernels/csrc/coverage.cu: two launches,
    counted as two), on the CPU `ray_coverage_counts_plain`."""
    shape = tuple(int(s) for s in shape)
    _check_coverage_args(cams, vol_of, view_of, alive, sil_uv, sil_valid,
                         shape)
    if cams.device.type == "cpu":
        return ray_coverage_counts_plain(cams, vol_of, view_of, alive,
                                         sil_uv, sil_valid, origin,
                                         voxel_size, shape, n_steps)
    kernels.require_cuda("ray_coverage", cams, vol_of, view_of, alive,
                         sil_uv, sil_valid)
    G = cams.shape[0]
    N = sil_valid.shape[1]
    nx, ny, nz = shape
    if nx * ny * nz >= 2 ** 31:
        raise ValueError("ray_coverage takes grids of < 2^31 voxels")
    o, hi = _box(origin, voxel_size, shape)
    covered = torch.empty(G, dtype=torch.int32, device=cams.device)
    valid = torch.empty(G, dtype=torch.int32, device=cams.device)
    if G == 0:
        return covered, valid
    vs = np.float32(voxel_size)
    box = torch.empty((alive.shape[0], 6), dtype=torch.int32,
                      device=cams.device)
    rc = kernels.lib().p3d_ray_coverage(
        cams.data_ptr(), vol_of.data_ptr(), view_of.data_ptr(),
        alive.data_ptr(), alive.shape[0], box.data_ptr(),
        sil_uv.data_ptr(), sil_valid.data_ptr(), G, N, float(o[0]),
        float(o[1]), float(o[2]), float(hi[0]), float(hi[1]), float(hi[2]),
        float(vs), _exact_reciprocal(vs), nx, ny, nz, int(n_steps),
        float(np.float32(1.0) / np.float32(n_steps)), covered.data_ptr(),
        valid.data_ptr(), kernels.stream_ptr(cams.device))
    kernels.LAUNCHES["ray_coverage"] += 2        # the alive boxes, the walk
    kernels.check("ray_coverage", rc)
    return covered, valid


def _exact_reciprocal(vs):
    """1 / vs when vs is a power of two, whose float32 reciprocal is exact
    (x * (1 / vs) then rounds the same real number as x / vs), else 0.0."""
    inv = np.float32(1.0) / vs
    exact = (math.frexp(float(vs))[0] == 0.5 and np.isfinite(inv)
             and inv * vs == 1.0)
    return float(inv) if exact else 0.0


def ray_coverage_counts_plain(cams, vol_of, view_of, alive, sil_uv,
                              sil_valid, origin, voxel_size, shape, n_steps,
                              max_samples=1 << 24, count_work=False):
    """Plain PyTorch version of K12: every step of every ray (no early
    exit), the same f32 operations (fused multiply-adds emulated exactly
    by `fma_f32`), in chunks of groups of at most `max_samples` steps.
    count_work=True also returns the steps the kernel walks on these inputs
    (each valid ray that meets the box, up to its first hit)."""
    dev = cams.device
    shape = tuple(int(s) for s in shape)
    o, hi = _box(origin, voxel_size, shape)
    o = torch.from_numpy(o).to(dev)
    hi = torch.from_numpy(hi).to(dev)
    vs = torch.tensor(np.float32(voxel_size), device=dev)
    n3 = torch.tensor(shape, device=dev)
    G = cams.shape[0]
    V, N = sil_valid.shape
    S = int(n_steps)
    rcp = torch.tensor(np.float32(1.0) / np.float32(S), device=dev)
    steps = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) * rcp
    flat = alive.reshape(alive.shape[0], -1)
    strides = torch.tensor([shape[1] * shape[2], shape[2], 1], device=dev)
    covered = torch.zeros(G, dtype=torch.int32, device=dev)
    valid = torch.zeros(G, dtype=torch.int32, device=dev)
    work = 0
    chunk = max(1, int(max_samples) // max(1, N * S))
    tiny = torch.tensor(np.float32(1e-12), device=dev)
    for g0 in range(0, G, chunk):
        c = cams[g0:g0 + chunk]
        vo = vol_of[g0:g0 + chunk].long()
        so = view_of[g0:g0 + chunk].long()
        R = c[:, 4:13].reshape(-1, 3, 3)
        tv = c[:, 13:16]
        cein = fma_f32(R[:, 2], tv[:, 2:3], fma_f32(R[:, 1], tv[:, 1:2],
                                                    R[:, 0] * tv[:, 0:1]))
        uv = sil_uv[so]                                    # (g, N, 2)
        dc0 = (uv[..., 0] - c[:, 2:3]) / c[:, 0:1]
        dc1 = (uv[..., 1] - c[:, 3:4]) / c[:, 1:2]
        d = torch.where(                                         # (g,N,3)
            _vector_lanes(N, dev)[:, None],
            (R[:, None, 0] * dc0[..., None] + R[:, None, 1] * dc1[..., None])
            + R[:, None, 2],
            R[:, None, 2] + fma_f32(R[:, None, 1], dc1[..., None],
                                    R[:, None, 0] * dc0[..., None]))
        inv = 1.0 / torch.where(d.abs() < tiny, tiny, d)
        ta = (o + cein)[:, None] * inv
        tb = (hi + cein)[:, None] * inv
        t0 = torch.minimum(ta, tb).amax(-1).clamp(min=0.0)
        t1 = torch.maximum(ta, tb).amin(-1)
        seg_ok = t1 > t0
        ts = fma_f32((t1 - t0)[..., None], steps, t0[..., None])  # (g,N,S)
        pos = fma_f32(d[:, :, None, :], ts[..., None],
                      -cein[:, None, None, :])                  # (g,N,S,3)
        q = torch.floor((pos - o) / vs)
        inb = ((q >= 0) & (q < n3)).all(-1)
        idx = torch.where(inb[..., None], q, 0).long()
        lin = (idx * strides).sum(-1)
        hit = flat[vo[:, None, None], lin] & inb
        cov = hit.any(-1) & seg_ok
        ok = sil_valid[so]
        covered[g0:g0 + chunk] = (cov & ok).sum(1, dtype=torch.int32)
        valid[g0:g0 + chunk] = ok.sum(1, dtype=torch.int32)
        if count_work:
            first = torch.where(hit.any(-1), hit.int().argmax(-1) + 1, S)
            work += int(first[seg_ok & ok].sum())
    return (covered, valid, work) if count_work else (covered, valid)


def _vector_lanes(N, device):
    """(N,) bool: the samples whose direction XLA's CPU dot computes in its
    8-wide vector loop, unfused ((R0i dc0 + R1i dc1) + R2i): the first
    8 * (N // 8) when N >= 16; the rest (its scalar tail, and every sample
    when N < 16) are fused, R2i + fma(R1i, dc1, R0i dc0)."""
    n = torch.arange(N, device=device)
    return (n < (N // 8) * 8) & (N >= 16)


def _fraction(covered, valid):
    """float32 covered / max(valid, 1), as JAX divides its 0/1 sums."""
    return covered.to(torch.float32) / valid.clamp(min=1).to(torch.float32)


def _ray_coverage(cams, alive, sil_uv, sil_valid, origin, voxel_size, shape,
                  n_steps):
    """Fraction of silhouette pixels whose viewing ray hits the hull:
    cams (V, 16), alive (nx, ny, nz) bool, sil_uv (V, N, 2), sil_valid
    (V, N). Returns (per_view (V,) float32 tensor, mean float)."""
    V = cams.shape[0]
    dev = cams.device
    ar = torch.arange(V, dtype=torch.int32, device=dev)
    cov, val = ray_coverage_counts(cams, torch.zeros_like(ar), ar,
                                   alive[None], sil_uv, sil_valid, origin,
                                   voxel_size, shape, n_steps)
    return _fraction(cov, val), float(_fraction(cov.sum(), val.sum()))


# -- the CEM's objective ------------------------------------------------------

def _alive_volume(cams, packed, origin, voxel_size, shape, H, W,
                  tol_kills=0):
    """Vote carve -> bool hull volumes: cams (V, 16) -> (nx, ny, nz), or a
    (B, V, 16) batch -> (B, nx, ny, nz) (alive = seen by >= 1 view,
    carved by at most `tol_kills`; the strict carve's alive set at 0)."""
    if cams.ndim == 2:
        return carve_candidates(packed, cams[None].contiguous(), origin,
                                voxel_size, shape, (H, W), tol_kills)[0]
    return carve_candidates(packed, cams.contiguous(), origin, voxel_size,
                            shape, (H, W), tol_kills)


def _robust_alive(cams, packed, origin, voxel_size, shape, H, W, tol_kills):
    """Vote-based hull (kill-tolerant for a few misaligned views)."""
    return _alive_volume(cams, packed, origin, voxel_size, shape, H, W,
                         tol_kills)


def _score_batch(thetas, poses, packed, sil_uv, sil_valid, origin,
                 voxel_size, width, height, scale, shape, Hl, Wl, n_steps):
    """Coherence score (silhouette-ray recall) of a (B, 9) batch of
    candidates: one K11b launch for the B hulls and one K12 call for the
    B x V ray groups. Returns a (B,) float32 tensor."""
    cams = cnc_to_cameras(poses, thetas, width, height, scale)   # (B, V, 16)
    B, V = cams.shape[:2]
    alive = _alive_volume(cams, packed, origin, voxel_size, shape, Hl, Wl)
    dev = cams.device
    cand = torch.arange(B, dtype=torch.int32, device=dev)
    view = torch.arange(V, dtype=torch.int32, device=dev)
    cov, val = ray_coverage_counts(
        cams.reshape(B * V, 16), cand.repeat_interleave(V), view.repeat(B),
        alive, sil_uv, sil_valid, origin, voxel_size, shape, n_steps)
    return _fraction(cov.view(B, V).sum(1), val.view(B, V).sum(1))


def _score_many(thetas, args, shape, Hl, Wl, n_steps):
    """Score a candidate population: the whole population per call pair,
    split only where its hulls would exceed `_CANDIDATE_VOXELS`."""
    thetas = np.asarray(thetas, np.float32)
    n_vox = int(np.prod(shape))
    chunk = max(1, _CANDIDATE_VOXELS // max(1, n_vox))
    dev = args[1].device
    out = []
    for s in range(0, len(thetas), chunk):
        out.append(_score_batch(torch.from_numpy(thetas[s:s + chunk]).to(dev),
                                *args, shape=shape, Hl=Hl, Wl=Wl,
                                n_steps=n_steps))
    return torch.cat(out).cpu().numpy()


def _diagnose(theta, poses, packed, sil_uv, sil_valid, origin, voxel_size,
              width, height, scale, shape, Hl, Wl, n_steps):
    """Per-view coverage, mean and hull for one calibration (QC output)."""
    cams = cnc_to_cameras(poses, theta, width, height, scale,
                          device=packed.device)
    return _diagnose_cams(cams, packed, sil_uv, sil_valid, origin,
                          voxel_size, shape, Hl, Wl, n_steps)


def _diagnose_cams(cams_lo, packed, sil_uv, sil_valid, origin, voxel_size,
                   shape, Hl, Wl, n_steps):
    alive = _alive_volume(cams_lo, packed, origin, voxel_size, shape, Hl, Wl)
    per_view, mean = _ray_coverage(cams_lo, alive, sil_uv, sil_valid, origin,
                                   voxel_size, shape, n_steps)
    return per_view, mean, alive


def _hull_bbox(alive, origin_np, vs):
    """The alive voxels' extent + 5 % (the reference's auto-bbox rule)."""
    idx = np.argwhere(alive.cpu().numpy())
    if not len(idx):
        return None
    lo = origin_np + idx.min(axis=0) * vs
    hi = origin_np + (idx.max(axis=0) + 1) * vs
    margin = 0.05 * (hi - lo)
    lo, hi = lo - margin, hi + margin
    return {"x": [float(lo[0]), float(hi[0])],
            "y": [float(lo[1]), float(hi[1])],
            "z": [float(lo[2]), float(hi[2])]}


def _grid(bbox, vs):
    x0, x1 = bbox["x"]; y0, y1 = bbox["y"]; z0, z1 = bbox["z"]
    return (np.array([x0, y0, z0], np.float32),
            (int((x1 - x0) / vs) + 1, int((y1 - y0) / vs) + 1,
             int((z1 - z0) / vs) + 1))


def _device_masks(masks_lo, sil_uv, sil_valid, device):
    return (torch.from_numpy(pack_masks(masks_lo)).to(device),
            torch.from_numpy(sil_uv).to(device),
            torch.from_numpy(sil_valid).to(device))


def coverage_for_cameras(masks, cams, bbox, *, downsample=4, voxel_mm=2.0,
                         n_sil=256, seed=0, device="cuda"):
    """Silhouette-coherence diagnostics for EXPLICIT packed cameras
    (V, 16) (e.g. after per-view BA jitter, where no single theta exists).

    Returns (per_view_coverage (V,) numpy, mean_coverage,
    hull_bbox_or_None), the per-view QC signal TurntableCalibration turns
    into `pose_estimation` metadata."""
    masks = np.asarray(masks) != 0
    rng = np.random.default_rng(seed)
    k = int(downsample)
    vs = float(voxel_mm)
    origin_np, shape = _grid(bbox, vs)
    masks_lo = _dilate1(_maxpool2d(masks, k))
    Hl, Wl = masks_lo.shape[1:]
    steps = int(np.ceil(np.linalg.norm(shape) * 0.75))
    sil_uv, sil_valid = _sample_sil(_maxpool2d(masks, k), n_sil, rng)
    cams_lo = np.asarray(cams, np.float32).copy()
    cams_lo[:, :4] /= k
    packed, uv, ok = _device_masks(masks_lo, sil_uv, sil_valid, device)
    per_view, mean, alive = _diagnose_cams(
        torch.from_numpy(cams_lo).to(device), packed, uv, ok, origin_np, vs,
        shape, Hl, Wl, steps)
    return per_view.cpu().numpy(), float(mean), _hull_bbox(alive, origin_np,
                                                           vs)


# -- the per-view polish ------------------------------------------------------

def _variant_cameras(poses, theta, jitter, deltas, width, height, scale):
    """Cameras of every view x delta variant: (V, G, 16) from poses (V, 5),
    jitter (V, 3) [dpan, dtilt, droll] and deltas (G, 3), each pose's pan
    and tilt plus (jitter + delta), its roll delta jitter + delta, as
    _view_delta_coverage builds them."""
    V, G = poses.shape[0], deltas.shape[0]
    step = jitter[:, None, :] + deltas[None, :, :]                # (V, G, 3)
    pv = poses[:, None, :].expand(V, G, 5).clone()
    pv[..., 3] = pv[..., 3] + step[..., 0]
    pv[..., 4] = pv[..., 4] + step[..., 1]
    cams = cnc_to_cameras(pv.reshape(V * G, 5), theta, width, height, scale,
                          droll=step[..., 2].reshape(V * G))
    return cams.view(V, G, 16)


def _polish_coverage(poses, theta, jitter, deltas, alive, sil_uv, sil_valid,
                     origin, voxel_size, width, height, scale, shape,
                     n_steps):
    """(V, G) coverages of every view's rays for every search delta against
    one fixed hull: one K12 call for all V x G camera variants."""
    cams = _variant_cameras(poses, theta, jitter, deltas, width, height,
                            scale)
    V, G = cams.shape[:2]
    dev = cams.device
    view = torch.arange(V, dtype=torch.int32, device=dev).repeat_interleave(G)
    cov, val = ray_coverage_counts(
        cams.reshape(V * G, 16), torch.zeros_like(view), view, alive[None],
        sil_uv, sil_valid, origin, voxel_size, shape, n_steps)
    return _fraction(cov, val).view(V, G)


def _view_delta_coverage(pose_v, theta, jit_v, deltas, alive, sil_uv_v,
                         sil_valid_v, origin, voxel_size, width, height,
                         scale, shape, n_steps):
    """Coverage of ONE view's silhouette rays against a fixed hull for a
    (G, 3) grid of (dpan, dtilt, droll) adjustments on top of the view's
    jitter jit_v = [dpan, dtilt, droll]. Returns (G,) coverages."""
    dev = alive.device
    return _polish_coverage(
        _f32(pose_v, dev)[None], _f32(theta, dev), _f32(jit_v, dev)[None],
        _f32(deltas, dev), alive, sil_uv_v[None], sil_valid_v[None], origin,
        voxel_size, width, height, scale, shape, n_steps)[0]


def refine_views_to_hull(masks, poses, theta, jitter, bbox, *,
                         rounds=2, span=(1.5, 1.0), grid=(11, 7),
                         roll_span=0.0, roll_grid=5, shrink=1.0,
                         tol_kills=2, downsample=4, voxel_mm=2.0,
                         n_sil=256, seed=0, device="cuda"):
    """Per-view silhouette polish: align every view's pan/tilt (and roll,
    with `roll_span > 0`) to the ROBUST visual hull (kill-tolerant vote
    carve), re-carving the hull each round. Returns (dpan_view,
    dtilt_view, droll_view, per_view_cov) numpy arrays.

    Within a round the hull is fixed and a view's coverage depends only on
    its own delta, so all V x G variants go through one K12 call; the
    argmax and the updates then run in view order, as the JAX package's
    per-view loop does. `shrink < 1` scales all spans each round."""
    masks = np.asarray(masks) != 0
    V = masks.shape[0]
    poses = np.asarray(poses, np.float32)
    theta_t = _f32(theta, device)
    dpan_v = np.array(jitter[0], np.float32) if jitter is not None \
        else np.zeros(V, np.float32)
    dtilt_v = np.array(jitter[1], np.float32) if jitter is not None \
        else np.zeros(V, np.float32)
    droll_v = (np.array(jitter[2], np.float32)
               if jitter is not None and len(jitter) > 2
               else np.zeros(V, np.float32))
    rng = np.random.default_rng(seed)

    k = int(downsample)
    vs = float(voxel_mm)
    origin_np, shape = _grid(bbox, vs)
    masks_lo = _dilate1(_maxpool2d(masks, k))
    Hl, Wl = masks_lo.shape[1:]
    steps = int(np.ceil(np.linalg.norm(shape) * 0.9))
    sil_uv, sil_valid = _sample_sil(_maxpool2d(masks, k), n_sil, rng)
    packed, uv, ok = _device_masks(masks_lo, sil_uv, sil_valid, device)
    W_full = np.float32(masks.shape[2])
    H_full = np.float32(masks.shape[1])
    scale = np.float32(1.0 / k)
    poses_t = torch.from_numpy(poses).to(device)

    gp, gt = grid
    gr = int(roll_grid) if roll_span > 0.0 else 1
    spans = [float(span[0]), float(span[1]), float(roll_span)]

    def _deltas(sp, st, sr):
        dp = np.linspace(-sp, sp, gp, dtype=np.float32)
        dt = np.linspace(-st, st, gt, dtype=np.float32)
        dr = (np.linspace(-sr, sr, gr, dtype=np.float32)
              if gr > 1 else np.zeros(1, np.float32))
        return np.stack(np.meshgrid(dp, dt, dr, indexing="ij"),
                        axis=-1).reshape(-1, 3)

    per_view = np.zeros(V, np.float32)
    for _ in range(rounds):
        deltas = _deltas(*spans)
        poses_adj = poses.copy()
        poses_adj[:, 3] += dpan_v
        poses_adj[:, 4] += dtilt_v
        cams = cnc_to_cameras(poses_adj, theta_t, W_full, H_full, scale,
                              droll=droll_v, device=device)
        alive = _robust_alive(cams, packed, origin_np, vs, shape, Hl, Wl,
                              int(tol_kills))
        jit = torch.from_numpy(np.stack([dpan_v, dtilt_v, droll_v], 1)).to(
            device)
        cov = _polish_coverage(
            poses_t, theta_t, jit, torch.from_numpy(deltas).to(device),
            alive, uv, ok, origin_np, vs, W_full, H_full, scale, shape,
            steps).cpu().numpy()
        for v in range(V):
            b = int(np.argmax(cov[v]))
            d = deltas[b]
            dpan_v[v] += float(d[0])
            dtilt_v[v] += float(d[1])
            droll_v[v] += float(d[2])
            per_view[v] = float(cov[v, b])
        if shrink != 1.0:
            spans = [s * float(shrink) for s in spans]
    return dpan_v, dtilt_v, droll_v, per_view


# -- host helpers (numpy, the JAX package's) ---------------------------------

def _maxpool2d(m, k):
    V, H, W = m.shape
    Hp, Wp = -(-H // k) * k, -(-W // k) * k
    out = np.zeros((V, Hp, Wp), bool)
    out[:, :H, :W] = m
    return out.reshape(V, Hp // k, k, Wp // k, k).max(axis=(2, 4))


def _dilate1(m):
    out = m.copy()
    out[:, 1:] |= m[:, :-1]; out[:, :-1] |= m[:, 1:]
    out[:, :, 1:] |= m[:, :, :-1]; out[:, :, :-1] |= m[:, :, 1:]
    return out


def _silhouette_row_mean(masks):
    """Mean over the non-empty silhouettes of their mean row, or None."""
    rows = []
    for m in np.asarray(masks) != 0:
        ys, _ = np.nonzero(m)
        if len(ys):
            rows.append(ys.mean())
    return float(np.mean(rows)) if rows else None


def estimate_tilt_offset(masks, poses, bbox, f, height, z_frac=0.5,
                         v_bar=None):
    """Closed-form vertical-basin initializer for the CEM seeds: returns
    (elev_dtilt_deg, image_offset_deg), the dtilt that maps the mean
    silhouette-centroid row onto the working volume's centre (elevation of
    the point at `z_frac` of the volume's height, plus atan((v_bar -
    cy)/f) for roll 0). `v_bar` (the masks' `_silhouette_row_mean`) may be
    passed in when the caller evaluates several (f, z_frac)."""
    if v_bar is None:
        v_bar = _silhouette_row_mean(masks)
    if v_bar is None:
        import warnings
        warnings.warn("estimate_tilt_offset: all silhouettes are empty; "
                      "check the calibration mask type/threshold")
        return 0.0, 0.0
    poses = np.asarray(poses, float)
    cx_w = 0.5 * (bbox["x"][0] + bbox["x"][1])
    cy_w = 0.5 * (bbox["y"][0] + bbox["y"][1])
    cz_w = bbox["z"][0] + z_frac * (bbox["z"][1] - bbox["z"][0])
    d = float(np.mean(np.hypot(poses[:, 0] - cx_w, poses[:, 1] - cy_w)))
    elev = np.arctan2(cz_w - float(np.mean(poses[:, 2])), d)
    off = np.arctan((v_bar - height / 2.0) / f)
    return (float(np.degrees(elev) - np.mean(poses[:, 4])),
            float(np.degrees(off)))


def _sample_sil(masks_lo, n_sil, rng):
    """(V, N, 2) float low-res (u, v) silhouette samples + validity."""
    V = masks_lo.shape[0]
    uv = np.zeros((V, n_sil, 2), np.float32)
    valid = np.zeros((V, n_sil), bool)
    for v in range(V):
        ys, xs = np.nonzero(masks_lo[v])
        if len(ys) == 0:
            continue
        take = min(n_sil, len(ys))
        sel = rng.choice(len(ys), size=take, replace=False)
        uv[v, :take, 0] = xs[sel] + 0.5
        uv[v, :take, 1] = ys[sel] + 0.5
        valid[v, :take] = True
    return uv, valid


# -- the calibration ----------------------------------------------------------

def calibrate_turntable(masks, poses, bbox, *, f_init=1400.0,
                        f_bounds=(400.0, 4000.0), free=DEFAULT_FREE,
                        downsample=8, voxel_mm=4.0, n_sil=192, n_steps=None,
                        pop=48, elites=8, iters=12, rounds=2, seed=0,
                        std_scale=1.0, progress=None, device="cuda"):
    """Recover the global turntable calibration from binary silhouettes.

    masks (V, H, W) full-resolution silhouettes; poses (V, 5) CNC [X, Y,
    Z, pan_deg, tilt_deg]; bbox {"x": [lo, hi], "y": ..., "z": ...} (mm);
    `free` names the theta components to optimize. Each of `rounds` halves
    `downsample` and `voxel_mm`, crops the scoring volume to the previous
    round's hull, and restarts the CEM around the previous optimum. Returns
    a dict with theta (named + raw), coherence, per-view coverage, hull
    bbox, f_at_bound and history, as the JAX package's."""
    masks = np.asarray(masks) != 0
    V, H, W = masks.shape
    poses = np.asarray(poses, np.float32)
    poses_t = torch.from_numpy(poses).to(device)
    rng = np.random.default_rng(seed)

    x0, x1 = bbox["x"]; y0, y1 = bbox["y"]; z0, z1 = bbox["z"]
    wx0, wx1, wy0, wy1, wz0, wz1 = x0, x1, y0, y1, z0, z1  # workspace

    mean = np.zeros(9, np.float32)
    mean[0] = f_init
    std = np.zeros(9, np.float32)
    for i, name in enumerate(THETA_NAMES):
        if name in free:
            base = DEFAULT_STD[name]
            std[i] = base * f_init if name == "f" else base
            std[i] *= std_scale
    free_mask = (std > 0).astype(np.float32)
    floor = np.maximum(std * 0.01, 1e-4)

    best_theta, best_score = mean.copy(), -1.0
    history = []
    v_bar = _silhouette_row_mean(masks)

    for rnd in range(rounds):
        k = max(1, downsample >> rnd)
        vs = voxel_mm / (2 ** rnd)
        masks_lo = _dilate1(_maxpool2d(masks, k))
        Hl, Wl = masks_lo.shape[1:]
        origin_np = np.array([x0, y0, z0], np.float32)
        shape = (int((x1 - x0) / vs) + 1, int((y1 - y0) / vs) + 1,
                 int((z1 - z0) / vs) + 1)
        steps = n_steps or int(np.ceil(np.linalg.norm(shape) * 0.75))
        sil_uv, sil_valid = _sample_sil(_maxpool2d(masks, k), n_sil, rng)
        packed, uv, ok = _device_masks(masks_lo, sil_uv, sil_valid, device)
        args = (poses_t, packed, uv, ok, origin_np, np.float32(vs),
                np.float32(W), np.float32(H), np.float32(1.0 / k))

        if rnd == 0:
            # seeds: roll quadrant x focal spread x plant elevation
            zspan = (z1 - z0) / max(1e-6, min(x1 - x0, y1 - y0))
            z_fracs = (0.2, 0.5, 0.8) if zspan > 1.2 else (0.5,)
            seeds = []
            for roll0 in (0.0, 90.0, 180.0, 270.0):
                for fs in (0.7, 1.0, 1.4):
                    for zf in z_fracs:
                        th = mean.copy()
                        th[0] = f_init * fs
                        elev_dt, img_off = estimate_tilt_offset(
                            masks, poses, bbox, th[0], H, z_frac=zf,
                            v_bar=v_bar)
                        sign = {0.0: 1.0, 180.0: -1.0}.get(roll0, 0.0)
                        th[4] = elev_dt + sign * img_off
                        th[5] = roll0
                        seeds.append(th)
            scores = _score_many(np.stack(seeds), args,
                                 shape=shape, Hl=Hl, Wl=Wl, n_steps=steps)
            b = int(np.argmax(scores))
            mean = seeds[b].copy()
            history.append({"round": rnd, "stage": "roll-seed",
                            "score": float(scores[b]),
                            "roll": float(mean[5]), "f": float(mean[0])})

        for it in range(iters):
            cand = mean[None, :] + std[None, :] * rng.standard_normal(
                (pop, 9)).astype(np.float32)
            cand[0] = mean  # keep the incumbent
            cand[:, 0] = np.clip(cand[:, 0], *f_bounds)
            scores = _score_many(cand, args,
                                 shape=shape, Hl=Hl, Wl=Wl, n_steps=steps)
            order = np.argsort(scores)[::-1]
            elite = cand[order[:elites]]
            mean = elite.mean(axis=0)
            std = np.maximum(0.5 * std + 0.5 * elite.std(axis=0),
                             floor) * free_mask
            if scores[order[0]] > best_score:
                best_score = float(scores[order[0]])
                best_theta = cand[order[0]].copy()
            history.append({"round": rnd, "iter": it,
                            "best": float(scores[order[0]]),
                            "mean_f": float(mean[0])})
            if progress:
                progress(rnd, it, float(scores[order[0]]), mean)

        mean = best_theta.copy()
        std = np.maximum(std * 0.5, floor) * free_mask

        per_view, coh, alive = _diagnose(
            best_theta, *args, shape=shape, Hl=Hl, Wl=Wl, n_steps=steps)

        if rnd < rounds - 1:
            # crop the next round's volume to this round's KILL-TOLERANT
            # hull plus a pad, its shape quantized to multiples of 16
            # voxels (the JAX package's rule, kept because it sets the grid)
            cams_best = cnc_to_cameras(poses_t, best_theta, np.float32(W),
                                       np.float32(H), np.float32(1.0 / k))
            alive_tol = _robust_alive(cams_best, packed, origin_np,
                                      np.float32(vs), shape, Hl, Wl, 2)
            idx = np.argwhere(alive_tol.cpu().numpy())
            if len(idx):
                lo = origin_np + idx.min(axis=0) * vs
                hi = origin_np + (idx.max(axis=0) + 1) * vs
                pad = np.maximum(0.2 * (hi - lo), 8.0 * vs)
                lo = np.maximum(lo - pad, [wx0, wy0, wz0])
                hi = np.minimum(hi + pad, [wx1, wy1, wz1])
                vs_next = voxel_mm / (2 ** (rnd + 1))
                n = np.floor((hi - lo) / vs_next).astype(int) + 1
                n16 = np.ceil(n / 16).astype(int) * 16
                span = (n16 - 0.5) * vs_next
                wlo = np.array([wx0, wy0, wz0])
                whi = np.array([wx1, wy1, wz1])
                fits = span <= (whi - wlo)
                hi = np.where(fits, lo + span, hi)
                over = np.maximum(hi - whi, 0.0)
                lo, hi = lo - over, hi - over
                lo = np.where(fits, lo, wlo)
                hi = np.where(fits, hi, whi)
                x0, y0, z0 = (float(v) for v in lo)
                x1, y1, z1 = (float(v) for v in hi)
                history.append({
                    "round": rnd, "stage": "hull-crop",
                    "bbox": [[x0, x1], [y0, y1], [z0, z1]]})

    hull_bbox = _hull_bbox(alive, origin_np, vs)
    # f pinned at a search bound flags the circular-motion focal gauge
    f_best = float(best_theta[0])
    f_at_bound = ("lo" if f_best <= f_bounds[0] * 1.02 else
                  "hi" if f_best >= f_bounds[1] * 0.98 else None)

    return {
        "theta": {n: float(best_theta[i]) for i, n in enumerate(THETA_NAMES)},
        "theta_raw": best_theta,
        "coherence": float(coh),
        "per_view_coverage": per_view.cpu().numpy().tolist(),
        "hull_bounding_box": hull_bbox,
        "f_at_bound": f_at_bound,
        "history": history,
    }


def theta_to_camera_metadata(theta, poses, width, height):
    """Per-image `colmap_camera`-layout metadata dicts from a calibration."""
    cams = cnc_to_cameras(poses, theta, float(width), float(height)).numpy()
    out = []
    for v in range(cams.shape[0]):
        fx, fy, cx, cy = (float(c) for c in cams[v, :4])
        out.append({
            "camera_model": {
                "model": "OPENCV",
                "params": [fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0],
                "width": int(width), "height": int(height),
            },
            "rotmat": cams[v, 4:13].reshape(3, 3).tolist(),
            "tvec": cams[v, 13:16].tolist(),
        })
    return out
