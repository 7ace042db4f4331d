"""K2's design on the CPU: the signed distance as kernels/csrc/edt.cu
computes it, written here in torch (the x march with its chunks and halos,
both channels in one word of either lane, the y+z tile with its clipped
halos, the ring of kR outputs a thread), held bit for bit to the plain
versions `signed_distance_plain` / `squared_edt_plain` and, at small sizes,
to the JAX package. The 16-bit lane's DPX step (`__viaddmin_s16x2`,
min(a + b, c) a halfword) is emulated with the halfwords' wrap-around, and
every sum is asserted to fit in int16: the lane's range argument."""

import numpy as np
import pytest
import torch

from plant3dvision_tpu.ops import edt as jax_edt

from plant3dvision_tpu_torch.ops import edt
from plant3dvision_tpu_torch.ops.edt import (SENTINEL16, _minplus_pass,
                                             axis_caps, lane16)

X_CHUNK = 192       # edt.cu kXChunk
SMEM = 232448       # edt.cu kMaxSmem
FAR = 1 << 30       # edt.cu kFar
BEFORE = 0x7FFF     # edt.cu kBefore
INF = torch.tensor(1e12, dtype=torch.float32)


class Lane16:
    """Both channels as the int16 halves of a 32-bit word (a low, b high),
    INF as SENTINEL16; words held in int64 tensors."""

    wsz = 4
    R = 16

    @staticmethod
    def sent(like):
        return torch.full(like.shape, SENTINEL16 * 0x10001, dtype=torch.int64)

    @staticmethod
    def first(inside, d, c):
        v = torch.where(d <= c, d * d, torch.full_like(d, SENTINEL16))
        return torch.where(inside, v, v << 16)

    @staticmethod
    def step(t):
        return (t * t) * 0x10001

    @staticmethod
    def addmin(w, sq, acc):
        """__viaddmin_s16x2: per signed halfword min(w + sq, acc), the sum
        wrapped to 16 bits; asserts that it never wraps."""
        def halves(x):
            return torch.as_tensor(x).to(torch.int32).view(
                torch.int16).to(torch.int32)
        s = halves(w) + halves(torch.as_tensor([sq]).expand(w.shape))
        assert int(s.max()) <= 32767 and int(s.min()) >= -32768
        m = torch.minimum(s, halves(acc)).to(torch.int16)
        return m.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    @staticmethod
    def decode(h):
        return torch.where(h == SENTINEL16, INF, h.to(torch.float32))

    @classmethod
    def a(cls, w):
        return cls.decode(w & 0xFFFF)

    @classmethod
    def b(cls, w):
        return cls.decode(w >> 16)


class Lane32:
    """The float32 pair (..., 2) and the plain version's arithmetic."""

    wsz = 8
    R = 8

    @staticmethod
    def sent(like):
        return torch.full(like.shape, 1e12, dtype=torch.float32)

    @staticmethod
    def first(inside, d, c):
        v = torch.where(d <= c, (d * d).to(torch.float32), INF)
        z = torch.zeros_like(v)
        return torch.stack([torch.where(inside, v, z),
                            torch.where(inside, z, v)], -1)

    @staticmethod
    def step(t):
        return torch.tensor(float(t * t), dtype=torch.float32)

    @staticmethod
    def addmin(w, sq, acc):
        return torch.minimum(acc, w + sq)

    @staticmethod
    def a(w):
        return w[..., 0]

    @staticmethod
    def b(w):
        return w[..., 1]


def x_march(inside, c0, lane, chunk=X_CHUNK):
    """edt_x_kernel on (nx, ny, nz) bool `inside`, every column at once: per
    chunk the forward march (each voxel's left distance when the other
    state was last seen inside the chunk, else BEFORE, and its state in the
    top bit of the 16-bit entry the kernel keeps in shared memory; the last
    voxel of each state carried from chunk to chunk, its distance back from
    the chunk capped at c0 + 1), the look ahead past the chunk (at most c0,
    until both states are seen), then backward (the right distance), and
    the lane's word."""
    top = 0x8000
    nx = inside.shape[0]
    cols = inside.shape[1:]
    out = [None] * nx
    last_in = torch.full(cols, -FAR, dtype=torch.int64)
    last_out = last_in.clone()
    for x0 in range(0, nx, chunk):
        x1 = min(nx, x0 + chunk)
        back_in = torch.clamp(x0 - last_in, max=c0 + 1)
        back_out = torch.clamp(x0 - last_out, max=c0 + 1)
        entry = {}
        for i in range(x0, x1):
            ins = inside[i]
            other = torch.where(ins, last_out, last_in)
            left = torch.where(other >= x0, i - other, BEFORE)
            assert int(left.max()) <= BEFORE
            entry[i] = left | ins.to(torch.int64) * top
            last_in = torch.where(ins, i, last_in)
            last_out = torch.where(ins, last_out, i)
        next_in = torch.full(cols, FAR, dtype=torch.int64)
        next_out = next_in.clone()
        ahead = inside[x1:min(nx, x1 + c0)]
        if len(ahead):
            for state, nxt in ((ahead, next_in), (~ahead, next_out)):
                first = x1 + state.to(torch.int8).argmax(0)
                nxt.copy_(torch.where(state.any(0), first, nxt))
        for i in range(x1 - 1, x0 - 1, -1):
            ins = (entry[i] & top) != 0
            left = entry[i] & BEFORE
            left = torch.where(left != BEFORE, left,
                               i - x0 + torch.where(ins, back_out, back_in))
            d = torch.minimum(left, torch.where(ins, next_out, next_in) - i)
            out[i] = lane.first(ins, torch.clamp(d, max=c0 + 1), c0)
            next_in = torch.where(ins, i, next_in)
            next_out = torch.where(ins, next_out, i)
    return torch.stack(out)


def window(lane, load, c):
    """edt.cu:window: R consecutive outputs, output r = min over |t| <= c of
    in[r + t] + t^2 with load(k) = in[k - c], through the ring of R inputs
    (slot (j + r) % R for output r at step t = s + j), one load a step; the
    full groups of R steps, then the last (peeled) group."""
    R = lane.R
    ring = [load(r) for r in range(R)]
    acc = [lane.sent(ring[0]) for _ in range(R)]
    s = -c
    while s + R - 1 < c:
        for j in range(R):
            sq = lane.step(s + j)
            for r in range(R):
                acc[r] = lane.addmin(ring[(j + r) % R], sq, acc[r])
            ring[j] = load(s + j + c + R)
        s += R
    for j in range(R):
        t = s + j
        if t <= c:
            sq = lane.step(t)
            for r in range(R):
                acc[r] = lane.addmin(ring[(j + r) % R], sq, acc[r])
            if t < c:
                ring[j] = load(t + c + R)
    return acc


def epilogue(lane, w, mode):
    if mode == 1:
        return lane.a(w)
    dist = torch.sqrt(torch.minimum(lane.a(w), INF))
    mdist = torch.sqrt(torch.minimum(lane.b(w), INF))
    return torch.where(dist > 0.5, dist - 0.5, -mdist + 0.5)


def yz_pass(words, lane, c1, c2, mode, ty, spill=False):
    """edt_yz_kernel, a block of ty rows and whole z rows at a time (every
    x-plane at once): the y pass reads its rows (sentinel outside the grid)
    into G, the z pass reads G (sentinel outside the grid), and the
    epilogue into the output tile, or (`spill`: G in a global buffer)
    straight into the output."""
    R = lane.R
    nx, ny, nz = words.shape[:3]
    tz = -(-nz // R) * R
    out = torch.empty((nx, ny, nz), dtype=torch.float32)
    sent_row = lane.sent(words[:, 0])
    for y0 in range(0, ny, ty):
        G = [None] * ty
        for yf in range(y0, y0 + ty, R):
            def load_w(k, yf=yf):
                row = yf - c1 + k
                return words[:, row] if 0 <= row < ny else sent_row
            for r, acc in enumerate(window(lane, load_w, c1)):
                if yf - y0 + r < ty:
                    G[yf - y0 + r] = acc
        G = torch.stack(G, 1)                         # (nx, ty, nz[, 2])
        O = torch.empty((nx, ty, tz), dtype=torch.float32)
        for zf in range(0, tz, R):
            def load_g(k, zf=zf):
                z = zf - c2 + k
                return G[:, :, z] if 0 <= z < nz else lane.sent(G[:, :, 0])
            for r, acc in enumerate(window(lane, load_g, c2)):
                if not spill:
                    O[:, :, zf + r] = epilogue(lane, acc, mode)
                elif zf + r < nz:
                    out[:, y0:y0 + ty, zf + r] = epilogue(
                        lane, acc, mode)[:, :ny - y0]
        if not spill:
            out[:, y0:y0 + ty] = O[:, :ny - y0, :nz]
    return out


def yz_rows(nz, lane):
    """edt.cu:launch_yz's block rows and whether G spills: (R, False), or
    fewer rows where G and the output tile of a z row do not fit in shared
    memory, or (R, True) where not even one row fits."""
    tz = -(-nz // lane.R) * lane.R
    ty = lane.R
    while ty >= 1:
        if ((ty * (nz | 1) * lane.wsz + 15) & ~15) + ty * (tz + 1) * 4 <= SMEM:
            return ty, False
        ty //= 2
    return lane.R, True


def kernel_design(vol, cap, mode, lane=None, chunk=X_CHUNK, ty=None,
                  spill=None):
    """The two launches, by default with the lane, rows and G the kernel
    picks; mode 0 the signed distance of vol > 0.5, 1 the squared EDT of
    vol != 0."""
    caps = axis_caps(vol.shape, cap)
    lane = lane or (Lane16 if lane16(caps) else Lane32)
    inside = vol != 0 if mode == 1 else vol > 0.5
    words = x_march(inside, caps[0], lane, chunk)
    rows, spills = yz_rows(vol.shape[2], lane)
    return yz_pass(words, lane, caps[1], caps[2], mode, ty or rows,
                   spills if spill is None else spill)


def _blobs(shape, seed, p=0.5):
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    x = gaussian_filter(rng.random(shape), 1.5)
    return torch.from_numpy(
        (x > np.quantile(x, 1 - p)).astype(np.float32) * 2 - 1)


def _check(vol, cap, **kw):
    sd = kernel_design(vol, cap, 0, **kw)
    assert torch.equal(sd, edt.signed_distance_plain(vol, cap))
    sq = kernel_design((vol > 0).float(), cap, 1, **kw)
    assert torch.equal(sq, edt.squared_edt_plain(vol > 0, cap))
    return sd, sq


@pytest.mark.parametrize("cap", [1, 3, 20])
def test_x_march_is_the_first_min_plus_pass(cap):
    """On the binary input the first pass's windowed min-plus is d^2 (d the
    distance to the other state along x, when <= c0), else INF: both
    channels, in chunks of 4, 7 and the kernel's with their c0 halos."""
    vol = _blobs((41, 6, 7), 0)
    inside = vol > 0.5
    c0 = axis_caps(vol.shape, cap)[0]
    want_a = _minplus_pass(torch.where(inside, INF, 0.0), 0, c0)
    want_b = _minplus_pass(torch.where(inside, 0.0, INF), 0, c0)
    for chunk in (4, 7, X_CHUNK):
        for lane in (Lane16, Lane32):
            w = x_march(inside, c0, lane, chunk)
            assert torch.equal(lane.a(w), want_a), (chunk, lane)
            assert torch.equal(lane.b(w), want_b), (chunk, lane)


@pytest.mark.parametrize("shape", [(9, 21, 70), (5, 64, 3), (2, 9, 5),
                                   (1, 1, 1), (17, 33, 19)])
@pytest.mark.parametrize("cap", [1, 3, 20, None])
def test_kernel_design_matches_plain(shape, cap):
    """The kernel's own lane and tile, axes shorter than the cap and grids
    smaller than one tile: bit for bit."""
    _check(_blobs(shape, 1), cap)


@pytest.mark.parametrize("lane", [Lane16, Lane32])
def test_small_blocks_and_their_halos(lane):
    """Blocks of R rows and of fewer (3 and 1: the kernel's rows where a z
    row is long), several a plane, the c1 halo clipped at both edges; x
    chunks of 5."""
    vol = _blobs((11, 19, 37), 2)
    for ty in (lane.R, 3, 1):
        _check(vol, 3, lane=lane, ty=ty, chunk=5)
        _check(vol, 6, lane=lane, ty=ty, chunk=5)


@pytest.mark.parametrize("value", [1.0, -1.0])
def test_all_inside_and_all_outside(value):
    """One state only: the other channel is INF everywhere, the sentinel
    in the 16-bit lane, and the plain version's 1e12 after decoding."""
    vol = torch.full((6, 10, 13), value)
    for cap in (3, None):
        sd, sq = _check(vol, cap)
        assert torch.equal(sq, torch.full_like(sq, 1e12) if value > 0
                           else torch.zeros_like(sq))


def test_lane_boundary():
    """c0^2 + c1^2 + c2^2 = 16382 (caps 125, 26, 9: the largest such sum
    below 16384, since 16383 is no sum of three squares) takes the 16-bit
    lane and reaches its largest finite value at the far corner; 16384
    (caps 128, 0, 0) takes the 32-bit lane, 16129 (127, 0, 0) the 16-bit."""
    assert lane16([125, 26, 9]) and 125 ** 2 + 26 ** 2 + 9 ** 2 == 16382
    assert not lane16([128, 0, 0]) and lane16([127, 0, 0])
    assert lane16([73, 73, 73]) and not lane16([74, 74, 74])
    vol = torch.ones((126, 27, 10))
    vol[0, 0, 0] = -1.0
    sd, sq = _check(vol, None)
    assert float(sq[-1, -1, -1]) == 16382.0
    for n in (128, 129):
        vol = torch.ones((n, 1, 1))
        vol[0] = -1.0
        sd, sq = _check(vol, None)
        assert float(sq[-1, 0, 0]) == (n - 1) ** 2


@pytest.mark.parametrize("cap", [3, None])
def test_the_32_bit_lane_is_exact_too(cap):
    """A grid of the 16-bit lane through the 32-bit one: the same bits."""
    vol = _blobs((7, 30, 40), 3)
    _check(vol, cap, lane=Lane32)
    _check(vol, cap, lane=Lane32, ty=4)


@pytest.mark.parametrize("cap", [2, 20, None])
def test_kernel_design_matches_jax(cap):
    vol = _blobs((12, 15, 18), 4).numpy()
    ref_sd = np.asarray(jax_edt.signed_distance(vol, cap))
    ref_sq = np.asarray(jax_edt.squared_edt(vol > 0, cap))
    t = torch.from_numpy(vol)
    np.testing.assert_array_equal(kernel_design(t, cap, 0).numpy(), ref_sd)
    np.testing.assert_array_equal(
        kernel_design((t > 0).float(), cap, 1).numpy(), ref_sq)


def test_block_rows():
    """launch_yz's rows: R at the passes' grids (the ML grid's z rows of
    504 in the 16-bit lane, ~65 KB of shared memory; in the 32-bit lane at
    cap None, ~49 KB), fewer for long z rows, and R rows with G in the
    spill buffer past ~29000 voxels in the 16-bit lane and ~19000 in the
    32-bit; no shape is refused."""
    assert yz_rows(504, Lane16) == (16, False)
    assert yz_rows(504, Lane32) == (8, False)
    assert yz_rows(199, Lane16) == yz_rows(561, Lane16) == (16, False)
    assert yz_rows(2000, Lane16) == yz_rows(1300, Lane32) == (8, False)
    assert yz_rows(15000, Lane32) == (1, False)
    assert yz_rows(20000, Lane32) == (8, True)
    assert yz_rows(29000, Lane16) == (1, False)
    assert yz_rows(30000, Lane16) == (16, True)
    # no first-axis limit: a window of 39999 gets to the device check
    vol = torch.empty((40000, 1, 1), device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        edt._edt_cuda(vol, None, True)


@pytest.mark.parametrize("lane", [Lane16, Lane32])
def test_spilled_rows(lane):
    """G in the spill buffer (the kernel's path for z rows too long for
    shared memory): outputs stored straight from the z pass, rows past ny
    skipped, bit for bit."""
    vol = _blobs((5, 21, 45), 5)
    for cap in (3, 6):
        _check(vol, cap, lane=lane, spill=True)
        _check(vol, cap, lane=lane, spill=True, ty=4)


def test_x_march_past_a_16_bit_window():
    """A first-axis window past 32767 (cap None on 32770 x-positions): left
    and right distances of 32769 along x, exact in both channels through
    the chunks' carried state and look ahead."""
    nx = 32770
    inside = torch.ones((nx, 1, 2), dtype=torch.bool)
    inside[0, 0, 0] = False             # 32769 to its left at the far end
    inside[nx - 1, 0, 1] = False        # and to its right at x = 0
    c0 = axis_caps(inside.shape, None)[0]
    assert c0 == nx - 1 > BEFORE and not lane16([c0, 0, 0])
    w = x_march(inside, c0, Lane32)
    want_a = _minplus_pass(torch.where(inside, INF, 0.0), 0, c0)
    assert torch.equal(Lane32.a(w), want_a)
    assert float(want_a[nx - 1, 0, 0]) == float(np.float32((nx - 1) ** 2))
    assert float(want_a[0, 0, 1]) == float(np.float32((nx - 1) ** 2))
    want_b = _minplus_pass(torch.where(inside, 0.0, INF), 0, c0)
    assert torch.equal(Lane32.b(w), want_b)
