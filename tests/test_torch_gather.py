"""The gather probes' plain versions (plant3dvision_tpu_torch/tools/
gather_probe.py) against the Pallas probes of exp_pallas_gather.py run in
interpret mode on the CPU. Integer sums: equal, no tolerance.

exp_pallas_gather.py stays as it is: the test swaps its module-level `pl`
for a namespace whose `pallas_call` interprets, and its `timed` for one
that keeps the kernel's output; numpy's global state is seeded before each
probe, so both packages draw the same inputs.
"""

import functools
import types

import numpy as np
import pytest
import torch

from jax.experimental import pallas as pl

import exp_pallas_gather as egp

from plant3dvision_tpu_torch.tools import gather_probe

torch.set_num_threads(1)


@pytest.fixture()
def interpret(monkeypatch):
    """Run the JAX probes in interpret mode; returns the list their
    outputs are appended to."""
    outs = []
    ns = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)

    def keep(fn, *args, n=5):
        outs.append(np.asarray(fn(*args)))
        return 1.0

    monkeypatch.setattr(egp, "pl", ns)
    monkeypatch.setattr(egp, "timed", keep)
    return outs


def _both(interpret, jax_probe, port_probe, *args, seed):
    np.random.seed(seed)
    jax_probe(*args)
    np.random.seed(seed)
    got = port_probe(*args, device="cpu").numpy()
    return got, interpret[-1]


@pytest.mark.parametrize("L,N,reps", [(64, 256, 4), (40, 96, 7)])
def test_axis1_plain_equals_pallas(interpret, L, N, reps):
    got, ref = _both(interpret, egp.probe_axis1, gather_probe.probe_axis1,
                     L, N, reps, seed=L)
    assert got.shape == ref.shape == (8, N) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("R,P,reps", [(64, 128, 4), (48, 64, 9)])
def test_axis0_rows_plain_equals_pallas(interpret, R, P, reps):
    got, ref = _both(interpret, egp.probe_axis0_rows,
                     gather_probe.probe_axis0_rows, R, P, reps, seed=R)
    assert got.shape == ref.shape == (P, 32) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("P,reps", [(256, 4), (128, 40)])
def test_select32_plain_equals_pallas(interpret, P, reps):
    got, ref = _both(interpret, egp.probe_select32,
                     gather_probe.probe_select32, P, reps, seed=P)
    assert got.shape == ref.shape == (P, 1) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_sums_wrap_like_int32():
    """Sums past 2^31 wrap as the Pallas kernels' int32 adds do."""
    big = torch.full((2, 32), 2 ** 30, dtype=torch.int32)
    dy = torch.zeros(2, dtype=torch.int32)
    np.testing.assert_array_equal(gather_probe.select32_plain(big, dy, 3),
                                  np.int32(3 * 2 ** 30 - 2 ** 32))
    tab = torch.full((1, 5), 2 ** 30, dtype=torch.int32)
    idx = torch.zeros((1, 2), dtype=torch.int32)
    np.testing.assert_array_equal(gather_probe.axis1_gather(tab, idx, 4),
                                  0)
    np.testing.assert_array_equal(
        gather_probe.rows_gather(torch.full((3, 32), -2 ** 31,
                                            dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32), 2), 0)


def test_wrappers_refuse_what_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="int32"):
        gather_probe.axis1_gather(torch.zeros((8, 4)), torch.zeros(
            (8, 2), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="32"):
        gather_probe.rows_gather(torch.zeros((4, 16), dtype=torch.int32),
                                 torch.zeros(3, dtype=torch.int32), 1)


# -- K17's warp reads, modelled -------------------------------------------------

#: kernels/csrc/gather.cu: the longest row staged in shared memory and the
#: warps a block of each lane
STAGE_MAX_L, WARPS_STAGED, WARPS_DIRECT = 16384, 16, 8


def _transpose_sum(v):
    """The kernel's transpose reduction over a warp: v (32 lanes, 32
    columns) uint32 -> lane l's result, the sum of column l."""
    v = v.copy()
    lanes = np.arange(32)
    off = 16
    while off >= 1:
        upper = (lanes & off) != 0
        for i in range(off):
            send = np.where(upper, v[:, i], v[:, i + off])
            keep = np.where(upper, v[:, i + off], v[:, i])
            v[:, i] = keep + send[lanes ^ off]
        off >>= 1
    return v[:, 0]


def axis1_kernel_model(tab, idx, reps, sms=132):
    """K17 as the kernel runs it: the launcher's lane and grid, each warp's
    groups of 32 columns, each load's 32 lookups at (kw + lane) with one
    compare and subtract, a lane's window start shuffled to the warp a
    column at a time (a modulo when L < 32), asserting every index in
    [0, L) and every column written once; the partial sums in uint32, the
    transpose reduction. Returns the output, the lane (True: staged) and
    the blocks a row."""
    tab = tab.numpy().astype(np.uint32)
    idx = idx.numpy()
    R, L = tab.shape
    N = idx.shape[1]
    groups = -(-N // 32)
    staged = L <= STAGE_MAX_L
    warps = WARPS_STAGED if staged else WARPS_DIRECT
    per_row = max(1, min(sms // R, -(-groups // warps))) if staged \
        else -(-groups // warps)
    full, rem = reps >> 5, reps & 31
    lanes = np.arange(32)
    out = np.zeros((R, N), np.uint32)
    written = np.zeros((R, N), int)
    for r in range(R):
        for b in range(per_row):
            for w in range(warps):
                n0 = (b * warps + w) * 32
                while n0 < N:
                    n = n0 + lanes
                    mine = np.where(n < N, idx[r, np.minimum(n, N - 1)], 0)
                    acc = np.zeros((32, 32), np.uint32)
                    if L >= 32:
                        kw = mine.copy()     # lane l: its column's start
                        for q in range(full + (rem > 0)):
                            on = lanes < (32 if q < full else rem)
                            for c in range(32):
                                k = kw[c] + lanes
                                k = np.where(k >= L, k - L, k)
                                assert ((k >= 0) & (k < L)).all()
                                acc[:, c] += np.where(on, tab[r, k], 0) \
                                    .astype(np.uint32)
                            kw = kw + 32
                            kw = np.where(kw >= L, kw - L, kw)
                    else:
                        for i0 in range(0, reps, 32):
                            i = i0 + lanes
                            for c in range(32):
                                k = (mine[c] + i) % L
                                acc[:, c] += np.where(i < reps, tab[r, k], 0) \
                                    .astype(np.uint32)
                    s = _transpose_sum(acc)
                    ok = n < N
                    out[r, n[ok]] = s[ok]
                    written[r, n[ok]] += 1
                    n0 += per_row * warps * 32
    assert (written == 1).all()
    return torch.from_numpy(out.view(np.int32)), staged, per_row


@pytest.mark.parametrize("L,N,reps", [
    (64, 1000, 5),          # N not a multiple of 32 or of a block
    (40, 96, 200),          # reps > L: the window wraps 5 times
    (33, 77, 64),           # a load that wraps, L just above a warp
    (32, 64, 33),           # rem = 1
    (1, 40, 7),             # L = 1: a modulo a lookup
    (31, 50, 70),           # L < 32, reps > L
    (300, 33, 0),           # reps = 0: zeros
    (STAGE_MAX_L + 1, 40, 64),   # the L1/L2 lane
])
def test_axis1_kernel_model_equals_plain(L, N, reps):
    np.random.seed(L + N + reps)
    tab, idx = gather_probe.axis1_inputs(L, N, device="cpu")
    tab = tab * 1000003 + 2 ** 30                       # sums that wrap
    got, staged, _ = axis1_kernel_model(tab, idx, reps)
    assert staged == (L <= STAGE_MAX_L)
    torch.testing.assert_close(got, gather_probe.axis1_gather_plain(
        tab, idx, reps), rtol=0, atol=0)
    if reps == 0:
        assert not got.any()


def test_axis1_kernel_model_at_the_probe_size():
    """The probe's (8, 8192) table and (8, 8192) indices, 64 reps, on a
    card of 132 SMs: one block an SM, 16 blocks a row of 512 columns each,
    every column once."""
    np.random.seed(0)
    tab, idx = gather_probe.axis1_inputs(8192, 8192, device="cpu")
    got, staged, per_row = axis1_kernel_model(tab, idx, 64)
    assert staged and per_row == 16
    torch.testing.assert_close(got, gather_probe.axis1_gather_plain(
        tab, idx, 64), rtol=0, atol=0)


# -- K18's windows and K19's split lookups, modelled ------------------------------

#: kernels/csrc/gather.cu: K18's warps a block and loads a lane in flight,
#: K19's warps a block
ROWS_WARPS, ROWS_UNROLL, SELECT_WARPS = 8, 8, 8


def test_models_take_the_sources_constants():
    """The models below and K17's above use gather.cu's own constants."""
    import re
    from plant3dvision_tpu_torch import kernels
    src = (kernels.CSRC / "gather.cu").read_text()
    want = {"kStageMaxL": STAGE_MAX_L, "kWarpsStaged": WARPS_STAGED,
            "kWarpsDirect": WARPS_DIRECT, "kRowsWarps": ROWS_WARPS,
            "kRowsUnroll": ROWS_UNROLL, "kSelectWarps": SELECT_WARPS}
    for name, value in want.items():
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name


def _xor_levels(v, offs):
    """Xor-shuffle levels over a warp's lanes (axis 1): each lane adds its
    partner's value, in uint32."""
    lanes = np.arange(32)
    for off in offs:
        v = v + v[:, lanes ^ off]
    return v


def rows_kernel_model(tab, rows, reps, aligned=True):
    """K18 as the kernel runs it, vectorised over the launch's warps: the
    launcher's lane (16-byte loads where the table is aligned, else four
    4-byte loads; a modulo a load where R < 4) and grid of ROWS_WARPS
    warps a block; lane l's row of the window, 4 q + l / 8 past the
    start, advanced 4 a load with one compare and subtract, asserting
    every row index in [0, R); ROWS_UNROLL loads a chunk, each on where
    4 u + l / 8 < the lookups left; four uint32 partial sums a lane, the
    xor levels 8 and 16, lanes 0-7 writing columns 4 (l % 8) .. + 3.
    Returns the output, the load instructions a warp issues and the
    lookups each (p, l) served."""
    tab = tab.numpy().astype(np.uint32)
    R, P = tab.shape[0], rows.shape[0]
    mod = R < 4
    blocks = -(-P // ROWS_WARPS)
    p = np.arange(blocks * ROWS_WARPS)
    p = p[p < P]                               # warps past P leave
    lanes = np.arange(32)
    sub, g = lanes >> 3, lanes & 7
    base = rows.numpy().astype(np.int64)[p] % R        # floor modulo
    k = base[:, None] + sub[None, :]
    k = k % R if mod else np.where(k >= R, k - R, k)
    acc = np.zeros((len(p), 32, 4), np.uint32)
    served = np.zeros((len(p), 32), np.int64)
    loads = 0
    cols = 4 * g[:, None] + np.arange(4)               # (lane, 4)
    left = reps
    while left > 0:
        for u in range(ROWS_UNROLL):
            assert ((k >= 0) & (k < R)).all()
            on = 4 * u + sub < left                    # (lane,)
            got = tab[k[:, :, None], cols[None]]        # (p, lane, 4)
            acc += np.where(on[None, :, None], got, 0).astype(np.uint32)
            served += on[None, :]
            loads += 1 if aligned else 4
            k = k + 4
            k = k % R if mod else np.where(k >= R, k - R, k)
        left -= 4 * ROWS_UNROLL
    acc = _xor_levels(acc, (8, 16))
    out = np.zeros((P, 32), np.uint32)
    written = np.zeros((P, 8), int)
    for lane in lanes[sub == 0]:
        out[p, 4 * lane:4 * lane + 4] = acc[:, lane]
        written[p, lane] += 1
    assert (written == 1).all()
    return torch.from_numpy(out.view(np.int32)), loads, served


@pytest.mark.parametrize("R,P,reps", [
    (48, 100, 9),           # reps off 4, P off the warp's 32 and the block
    (5, 37, 23),            # reps > R: the window wraps four times
    (48, 64, 200),          # wraps 4 times, several chunks
    (1, 10, 7), (3, 50, 13), (2, 9, 5),   # R < 4: a modulo a load
    (4, 40, 6), (5, 40, 64),              # R = 4, 5: compare and subtract
    (300, 33, 0), (300, 8, 1), (300, 17, 3), (300, 16, 5),
    (64, 8, 32 * ROWS_UNROLL + 1),        # one load past a whole chunk
])
@pytest.mark.parametrize("aligned", [True, False])
def test_rows_kernel_model_equals_plain(R, P, reps, aligned):
    np.random.seed(R + P + reps)
    tab, rows = gather_probe.rows_inputs(R, P, device="cpu")
    tab = tab * 1000003 + 2 ** 30                       # sums that wrap
    got, loads, served = rows_kernel_model(tab, rows, reps, aligned)
    torch.testing.assert_close(got, gather_probe.rows_gather_plain(
        tab, rows, reps), rtol=0, atol=0)
    # every lookup once: the 8 lanes of a column group serve reps rows
    assert (served.reshape(-1, 4, 8).sum(1) == reps).all()
    assert loads >= (reps / 4 if aligned else reps)
    if reps == 0:
        assert not got.any()


def test_rows_kernel_model_takes_rows_outside_the_table():
    """Row starts past R or negative start where the plain version's
    modulo puts them."""
    np.random.seed(7)
    tab, _ = gather_probe.rows_inputs(11, 1, device="cpu")
    rows = torch.tensor([-1, -12, 11, 25, 2 ** 31 - 1, -2 ** 31],
                        dtype=torch.int32)
    got, _, _ = rows_kernel_model(tab, rows, 30)
    torch.testing.assert_close(got, gather_probe.rows_gather_plain(
        tab, rows, 30), rtol=0, atol=0)


@pytest.mark.parametrize("R", [4096, 32768])
def test_rows_kernel_model_at_the_probe_sizes(R):
    """The probe's (R, 32) tables at R = 4K and 32K, 4096 rows p, 64 reps:
    512 blocks of 8 warps, 16 16-byte loads a lane."""
    np.random.seed(3 if R == 4096 else 4)
    tab, rows = gather_probe.rows_inputs(R, 4096, device="cpu")
    got, loads, _ = rows_kernel_model(tab, rows, 64)
    assert loads == 16
    torch.testing.assert_close(got, gather_probe.rows_gather_plain(
        tab, rows, 64), rtol=0, atol=0)


def select32_kernel_model(T, dy, reps):
    """K19 as the kernel runs it, vectorised over the launch's warps: lane
    c holds T[p, c]; in round m every lane shuffles, lane l for lookup
    i = 32 m + (l + m) % 32 the column (dy + i) & 31 (asserted in [0,
    32)), kept where i < reps; five xor levels, lane 0 writing. Returns
    the output, the rounds (lookup shuffles a warp) and how often each
    lookup i of each p was served."""
    T = T.numpy().astype(np.uint32)
    P = T.shape[0]
    blocks = -(-P // SELECT_WARPS)
    p = np.arange(blocks * SELECT_WARPS)
    p = p[p < P]
    lanes = np.arange(32)
    d = dy.numpy().astype(np.uint32)[p]
    acc = np.zeros((len(p), 32), np.uint32)
    served = np.zeros((len(p), reps), np.int64)
    rounds, left = 0, reps
    while left > 0:
        j = (lanes + rounds) & 31                      # i = 32 m + j
        src = (d[:, None] + j) & 31
        assert ((src >= 0) & (src < 32)).all()
        got = T[p[:, None], src]                        # (p, lane)
        on = j < left
        acc += np.where(on[None], got, 0).astype(np.uint32)
        served[:, 32 * rounds + j[on]] += 1
        rounds += 1
        left -= 32
    acc = _xor_levels(acc, (16, 8, 4, 2, 1))
    out = np.zeros(P, np.uint32)
    written = np.zeros(P, int)
    out[p] = acc[:, 0]
    written[p] += 1
    assert (written == 1).all()
    return torch.from_numpy(out.view(np.int32)), rounds, served


@pytest.mark.parametrize("P,reps", [
    (256, 0), (256, 1), (100, 31), (100, 33), (37, 200), (1, 64),
    (4096, 64),                                   # the probe's size
])
def test_select32_kernel_model_equals_plain(P, reps):
    np.random.seed(P + reps)
    T, dy = gather_probe.select32_inputs(P, device="cpu")
    T = T * 1000003 + 2 ** 30                          # sums that wrap
    got, rounds, served = select32_kernel_model(T, dy, reps)
    torch.testing.assert_close(got, gather_probe.select32_plain(
        T, dy, reps), rtol=0, atol=0)
    assert rounds == -(-reps // 32)
    assert (served == 1).all()                # each lookup i < reps once
