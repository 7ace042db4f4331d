"""K9's tiles (kernels/csrc/undistort.cu), written in numpy, against the
plain version and the JAX package, on the CPU.

The kernel has no CPU mode, so its design is modelled here: the stack is a
flat byte buffer (optionally starting at an odd address, as a view of a
larger buffer can); a block's tile of `TILE_ROWS` output rows and
`tile_width` columns takes the bounding box of its inside pixels' taps
(`tile_windows`), and for each image copies the window's rows into a
shared-memory array in whole 16-byte chunks aligned down to 16 bytes,
each row at its address's phase, or, for a window over the budget, reads
the taps from the buffer itself (the global-load lane). Every tap is then
read from the staged bytes at the kernel's offsets, and a tap that no copy
brought in fails the test. The values come from the plain f32 arithmetic
and leave through the kernel's byte conversions, which are checked on
their own over every input byte and a dense sweep of float32 values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plant3dvision_tpu.ops import undistort as J

from plant3dvision_tpu_torch.ops import undistort as P
from plant3dvision_tpu_torch.ops.undistort import (TILE_ROWS, tile_width,
                                                   tile_windows,
                                                   window_budget)
from plant3dvision_tpu_torch.synth import turntable_cameras

torch.set_num_threads(1)

#: phase 10's camera (chip_smoke.py: f 1400 on 1440x1080, k1 = -0.08)
PHASE10_K = turntable_cameras(1, f=1400.0, width=1440, height=1080)[0][0]
STRONG = (-0.21, 0.07, 0.011, -0.007, 0.013)
#: a wide-angle lens whose map stretches the corners' windows past the
#: budget: some tiles take the global-load lane
FOLDING = (0.5, 0.2, 0.01, -0.01, 0.05)


def _f32(x):
    return np.asarray(x, np.float32)


def byte_to_float(b):
    """__uint_as_float(0x4B000000 | b) - 2^23, in float32."""
    bits = np.uint32(0x4B000000) | np.asarray(b, np.uint32)
    return bits.view(np.float32) - np.float32(8388608.0)


def float_to_byte(v):
    """__float_as_uint(fminf(fmaxf(v, 0), 255) + 1.5 * 2^23) & 0xFF."""
    c = np.fmin(np.fmax(_f32(v), np.float32(0)), np.float32(255))
    return ((c + np.float32(12582912.0)).view(np.uint32) & 0xFF).astype(
        np.uint32)


def test_byte_to_float_is_exact_for_every_uint8_and_uint16():
    b = np.arange(65536, dtype=np.uint32)
    np.testing.assert_array_equal(byte_to_float(b), b.astype(np.float32))


def test_float_to_byte_rounds_like_rintf_then_clamp():
    """The kernel's v -> byte equals fminf(fmaxf(rintf(v), 0), 255) cast to
    a byte for every k/1024 in [-4, 300], every half-integer there, +-0,
    +-inf, NaN, subnormals and the float32 neighbours of each
    half-integer."""
    k = np.arange(-4 * 1024, 300 * 1024 + 1, dtype=np.float64) / 1024
    half = np.arange(-8, 601, dtype=np.float64) / 2
    tiny = np.float32(1e-45) * np.arange(1, 200, dtype=np.float32)
    v = np.concatenate([
        _f32(k), _f32(half), np.nextafter(_f32(half), np.float32(-np.inf)),
        np.nextafter(_f32(half), np.float32(np.inf)), tiny, -tiny,
        _f32([0.0, -0.0, np.inf, -np.inf, np.nan, 255.49998, 255.5, 256.0,
              1e30, -1e30, 0.49999997, 0.5, 1.5, 2.5])])
    # the first design's store: fminf(fmaxf(rintf(v), 0), 255), fmaxf
    # mapping a NaN to its other operand
    with np.errstate(invalid="ignore"):
        want = np.fmin(np.fmax(np.rint(v), np.float32(0)), np.float32(255))
    np.testing.assert_array_equal(float_to_byte(v), want.astype(np.uint32))


def _stack(rng, dtype, N, H, W, channels):
    shape = (N, H, W) + (() if channels is None else (channels,))
    if dtype == np.float32:
        return rng.random(shape).astype(dtype)
    return rng.integers(0, 256 if dtype == np.uint8 else 65536,
                        shape).astype(dtype)


def kernel_model(images, K, dist, offset=0, width=None, budget=None):
    """K9's tiles over a numpy (N, H, W[, C]) stack held at byte `offset`
    of a flat buffer. Returns the output stack and the tiles that took the
    staged, global-load and empty lanes."""
    N, H, W = images.shape[:3]
    C = 1 if images.ndim == 3 else images.shape[3]
    es = images.dtype.itemsize
    pb = C * es
    tw = width or tile_width(pb)
    budget = window_budget(pb) if budget is None else budget
    tiles = tile_windows((H, W), K, dist, pb, width=tw, budget=budget)
    buf = np.zeros(offset + images.nbytes + 64, np.uint8)
    buf[offset:offset + images.nbytes] = images.reshape(-1).view(np.uint8)
    rowbytes, imgbytes = W * pb, H * W * pb

    px, py = P.source_map((H, W), K, dist)
    inside = ((px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)).numpy()
    x0 = torch.nan_to_num(torch.floor(px).clamp(0, W - 2))
    y0 = torch.nan_to_num(torch.floor(py).clamp(0, H - 2))
    gx = (px - x0).clamp(0.0, 1.0)
    gy = (py - y0).clamp(0.0, 1.0)
    x0, y0 = x0.long().numpy(), y0.long().numpy()
    out = np.zeros_like(images, dtype=images.dtype)
    lanes = {"staged": 0, "global": 0, "empty": 0}
    tys, txs = tiles["any"].shape
    for ty in range(tys):
        for tx in range(txs):
            v0, u0 = ty * TILE_ROWS, tx * tw
            vs = slice(v0, min(H, v0 + TILE_ROWS))
            us = slice(u0, min(W, u0 + tw))
            ins = inside[vs, us]
            if not bool(tiles["any"][ty, tx]):
                lanes["empty"] += 1
                assert not ins.any()
                continue
            staged = bool(tiles["staged"][ty, tx])
            lanes["staged" if staged else "global"] += 1
            xlo, xhi = int(tiles["x0"][ty, tx]), int(tiles["x1"][ty, tx])
            ylo, yhi = int(tiles["y0"][ty, tx]), int(tiles["y1"][ty, tx])
            wrows, wb = yhi - ylo + 1, (xhi - xlo + 1) * pb
            pitch = (15 + wb + 15) // 16 * 16
            assert wrows * pitch <= int(tiles["bytes"][ty, tx])
            tx0, ty0 = x0[vs, us], y0[vs, us]
            for n in range(N):
                base = offset + n * imgbytes
                if staged:
                    smem = np.zeros(wrows * pitch, np.uint8)
                    have = np.zeros(wrows * pitch, bool)
                    g0 = base + (ylo * W + xlo) * pb
                    for r in range(wrows):
                        g = g0 + r * rowbytes
                        ph = g % 16
                        nch = (ph + wb + 15) // 16
                        smem[r * pitch:r * pitch + 16 * nch] = \
                            buf[g - ph:g - ph + 16 * nch]
                        have[r * pitch:r * pitch + 16 * nch] = True
                    ry = ty0 - ylo
                    iph0 = g0 % 16
                    col = (tx0 - xlo) * pb
                    a0 = ry * pitch + (iph0 + ry * rowbytes) % 16 + col
                    a1 = (ry + 1) * pitch + (iph0 + (ry + 1) * rowbytes) \
                        % 16 + col
                    src, adr = smem, (a0, a0 + pb, a1, a1 + pb)
                    for a in adr:
                        idx = a[ins][:, None] + np.arange(pb)
                        assert have[idx].all(), "a tap the window lost"
                else:
                    t0 = base + (ty0 * W + tx0) * pb
                    src, adr = buf, (t0, t0 + pb, t0 + rowbytes,
                                     t0 + rowbytes + pb)
                # (the taps of outside pixels are not read: their value is 0)
                adr = [np.where(ins, a, 0) for a in adr]
                vals = [src[a[..., None] + np.arange(pb)].view(
                    images.dtype).reshape(*a.shape, C) for a in adr]
                val = _sample(vals, gx[vs, us], gy[vs, us], ins, C == 1,
                              images.dtype)
                out[n, vs, us] = val[..., 0] if images.ndim == 3 else val
    return out, lanes


def _sample(vals, gx, gy, ins, one, dtype):
    """The kernel's lerps of the four taps (plain arithmetic; one channel
    takes a 2-D image's row lerps) and its store: the magic conversions
    for integer types."""
    if dtype == np.float32:
        f = [torch.from_numpy(v.astype(np.float32)) for v in vals]
    else:
        f = [torch.from_numpy(byte_to_float(v.astype(np.uint32)))
             for v in vals]
    gx, gy = gx[..., None], gy[..., None]
    top = P._lerp(f[0], f[1], gx, one)
    bot = P._lerp(f[2], f[3], gx, one)
    val = torch.where(torch.from_numpy(ins)[..., None], P._lerp(top, bot, gy),
                      0.0).numpy()
    if dtype != np.float32:
        val = float_to_byte(val).astype(dtype)
    return val


def _check(images, K, dist, offset=0, **kw):
    got, lanes = kernel_model(images, K, dist, offset, **kw)
    plain = P.undistort_plain(torch.from_numpy(images), K, dist).numpy()
    np.testing.assert_array_equal(got, plain)
    ref = np.asarray(J.undistort_batch(jnp.asarray(images), jnp.asarray(K),
                                       jnp.asarray(dist)))
    np.testing.assert_array_equal(got, ref)
    return lanes


@pytest.mark.parametrize("dist", [(-0.08, 0.0, 0.0, 0.0), STRONG])
def test_phase10_tiles_lose_no_tap(dist):
    """Two RGB uint8 images of phase 10's 1080x1440 frame through its
    camera (k1 = -0.08) and a strong distortion: every tile staged (the
    windows fit the budget), bit-equal to the plain version and to JAX."""
    rng = np.random.default_rng(0)
    img = _stack(rng, np.uint8, 2, 1080, 1440, 3)
    K = _f32(PHASE10_K)
    lanes = _check(img, K, _f32(dist))
    assert lanes["global"] == 0 and lanes["staged"] > 1000


@pytest.mark.parametrize("channels", [None, 1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_folding_lens_takes_both_lanes(channels, dtype):
    """A wide-angle lens that stretches the corner tiles' windows past the
    budget: those tiles read their taps from global memory, the others
    stage; 203 rows and 304 columns divide into neither tile side. Gray
    (2-D), 1, 3 and 4 channels of each type, bit-equal to the plain
    version and to JAX (a one-channel stack takes a 2-D image's row
    lerps, as XLA fuses them)."""
    rng = np.random.default_rng(1)
    H, W = 203, 304
    img = _stack(rng, dtype, 2, H, W, channels)
    K = _f32([[150.0, 0, W / 2 - 0.7], [0, 153.0, H / 2 + 0.4], [0, 0, 1]])
    lanes = _check(img, K, _f32(FOLDING))
    assert lanes["global"] > 0 and lanes["staged"] > 0


@pytest.mark.parametrize("offset", [1, 7, 13])
def test_unaligned_stack_and_row_phases(offset):
    """A stack starting at an odd address, whose rows (77 RGB pixels, 231
    bytes) fall at every 16-byte phase: the chunks aligned down to 16 bytes
    still hold every tap; a frame smaller than a tile."""
    rng = np.random.default_rng(offset)
    H, W = 5, 77
    img = _stack(rng, np.uint8, 3, H, W, 3)
    K = _f32([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]])
    lanes = _check(img, K, _f32(STRONG), offset=offset)
    assert lanes["staged"] == 1


def test_window_over_a_forced_budget_reads_global():
    """With the budget set below every window, each tile takes the
    global-load lane, and the result is the same."""
    rng = np.random.default_rng(3)
    img = _stack(rng, np.uint8, 2, 40, 136, 3)
    K = _f32([[120.0, 0, 68], [0, 120.0, 20], [0, 0, 1]])
    lanes = _check(img, K, _f32(STRONG), budget=16)
    assert lanes["staged"] == 0 and lanes["global"] > 0


def test_tile_windows_hold_the_taps_of_every_inside_pixel():
    """`tile_windows`' boxes cover x0 .. x0 + 1 and y0 .. y0 + 1 of every
    inside pixel, and no wider: on phase 10's camera at full size."""
    H, W, pb = 1080, 1440, 3
    K, d = _f32(PHASE10_K), _f32((-0.08, 0, 0, 0))
    t = tile_windows((H, W), K, d, pb)
    px, py = P.source_map((H, W), K, d)
    inside = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
    x0 = torch.floor(px).clamp(0, W - 2).long()
    y0 = torch.floor(py).clamp(0, H - 2).long()
    tw = tile_width(pb)
    ty = torch.arange(H)[:, None].expand(H, W) // TILE_ROWS
    tx = torch.arange(W)[None, :].expand(H, W) // tw
    for key, v, hi in (("x0", x0, False), ("x1", x0 + 1, True),
                       ("y0", y0, False), ("y1", y0 + 1, True)):
        lim = t[key][ty, tx]
        ok = (v <= lim) if hi else (v >= lim)
        assert bool(ok[inside].all()), key
    # tight: some inside pixel touches each side of every box
    assert bool(t["any"].all())
    hit = torch.zeros_like(t["x0"])
    hit.index_put_((ty[inside], tx[inside]),
                   (x0[inside] == t["x0"][ty, tx][inside]).long(),
                   accumulate=True)
    assert bool((hit > 0).all())
    assert int(t["bytes"].max()) <= window_budget(pb)
