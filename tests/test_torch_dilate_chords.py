"""K8's design on the CPU: the disk as chords, and the row-then-column
dilation over 32-bit words that kernels/csrc/dilate.cu runs, written here
in torch (its tiles, halos and level steps as the kernel cuts them), held
to the plain version `binary_dilation_plain`."""

import ctypes
import gc

import numpy as np
import pytest
import torch

from plant3dvision_tpu_torch import kernels
from plant3dvision_tpu_torch.ops import masks
from plant3dvision_tpu_torch.ops.masks import (MAX_DILATION_RADIUS,
                                               _disk_offsets,
                                               binary_dilation,
                                               binary_dilation_plain,
                                               disk_chords)

ROWS = 32           # dilate.cu kRows
STRIP = 64          # dilate.cu kMaxStrip
SMEM = 48 << 10     # dilate.cu kStaticSmem
ONES = 0xFFFFFFFF


def test_chords_give_the_disk():
    """{(dy, dx): |dx| <= w(dy)} is `_disk_offsets(r)` as a set, r 0-64."""
    for r in range(65):
        w = disk_chords(r)
        assert w.dtype == np.int32 and w.shape == (2 * r + 1,)
        chords = {(dy, dx) for dy in range(-r, r + 1)
                  for dx in range(-int(w[dy + r]), int(w[dy + r]) + 1)}
        disk = {(int(dy), int(dx)) for dy, dx in _disk_offsets(r)}
        assert chords == disk, r


def _pack(mask, nwords):
    """(M, H, W) bool -> (M, H, nwords) int64 words of 32 pixels, bit b of
    word j = pixel 32 j + b, bits past W zero."""
    M, H, W = mask.shape
    m = torch.zeros((M, H, nwords * 32), dtype=torch.int64)
    m[..., :W] = mask.to(torch.int64)
    weights = torch.tensor([1 << b for b in range(32)], dtype=torch.int64)
    return (m.reshape(M, H, nwords, 32) * weights).sum(-1)


def _unpack(words, W):
    bits = (words[..., None] >> torch.arange(32)) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :W].bool()


def _strip(nwords, r, max_strip):
    """The kernel's strip width in words (its host-side choice)."""
    hw = -(-r // 32)
    S = min(nwords, max_strip)
    while S > 1 and 4 * (2 * (ROWS + 2 * r) * (S + 2 * hw) + ROWS * S) > SMEM:
        S = (S + 1) // 2
    nstrips = -(-nwords // S)
    return -(-nwords // nstrips), nstrips, hw


def chord_dilation(mask, r, max_strip=STRIP):
    """dilate.cu's algorithm on (M, H, W) bool: per (band, strip) tile, the
    packed rows with r halo rows and ceil(r/32) halo words, H_w grown a
    pixel a level (0 beyond the tile), the chords ORed walking |dy| from r
    to 0, the strip's words unpacked."""
    M, H, W = mask.shape
    nwords = -(-W // 32)
    S, nstrips, hw = _strip(nwords, r, max_strip)
    packed = _pack(mask, nwords)
    w = disk_chords(r)
    out = torch.zeros((M, H, nwords), dtype=torch.int64)
    for y0 in range(0, H, ROWS):
        for w0 in range(0, nstrips * S, S):
            R, P = ROWS + 2 * r, S + 2 * hw
            cur = torch.zeros((M, R, P), dtype=torch.int64)
            for i in range(R):
                y = y0 - r + i
                if 0 <= y < H:
                    for j in range(P):
                        gw = w0 - hw + j
                        if 0 <= gw < nwords:
                            cur[:, i, j] = packed[:, y, gw]
            acc = torch.zeros((M, ROWS, S), dtype=torch.int64)
            level = 0
            for a in range(r, -1, -1):
                while level < w[a + r]:
                    lo = torch.nn.functional.pad(cur[..., :-1], (1, 0))
                    hi = torch.nn.functional.pad(cur[..., 1:], (0, 1))
                    cur = (cur | ((cur << 1) & ONES) | (lo >> 31)
                           | (cur >> 1) | ((hi << 31) & ONES))
                    level += 1
                acc |= cur[:, r - a:r - a + ROWS, hw:hw + S]
                acc |= cur[:, r + a:r + a + ROWS, hw:hw + S]
            rows = min(ROWS, H - y0)
            cols = min(S, nwords - w0)
            out[:, y0:y0 + rows, w0:w0 + cols] = acc[:, :rows, :cols]
    return _unpack(out, W)


@pytest.mark.parametrize("radius", range(9))
def test_chord_dilation_matches_plain(radius):
    """Random masks of widths 1-70 (one to three words; strips of 64
    words and of 1, so that halo words border every strip), heights
    that leave a band ragged: equal to binary_dilation_plain."""
    rng = np.random.default_rng(radius)
    for W in range(1, 71):
        H = int(rng.integers(1, 2 * radius + 3)) if W % 2 else 37
        m = torch.from_numpy(rng.random((2, H, W)) > 0.93)
        m[1, :, -1] = True
        want = m if radius == 0 else binary_dilation_plain(m, radius)
        for strip in (STRIP, 1):
            got = chord_dilation(m, radius, strip)
            assert torch.equal(got, want), (W, H, strip)


def test_chord_dilation_at_the_radius_limit():
    """Two halo words a side (r = 36 > 32): a mask wider than one strip of
    the kernel's shared memory budget, equal to the plain version."""
    rng = np.random.default_rng(7)
    m = torch.from_numpy(rng.random((1, 40, 2100)) > 0.999)
    m[0, 0, 0] = m[0, -1, -1] = True
    r = MAX_DILATION_RADIUS
    assert _strip(-(-2100 // 32), r, STRIP)[1] == 3
    assert torch.equal(chord_dilation(m, r), binary_dilation_plain(m, r))


def test_binary_dilation_cpu_takes_any_radius():
    """On the CPU the wrapper is the plain version, past the kernel's
    radius limit too."""
    m = torch.zeros((1, 5, 90), dtype=torch.bool)
    m[0, 2, 45] = True
    r = MAX_DILATION_RADIUS + 5
    out = binary_dilation(m, r)
    assert torch.equal(out, binary_dilation_plain(m, r))
    w = disk_chords(r)
    assert out.sum() == sum(2 * int(w[dy + r]) + 1 for dy in range(-2, 3))


@pytest.mark.parametrize("radius", [1, 6, MAX_DILATION_RADIUS])
def test_wrapper_keeps_the_chord_table_alive(monkeypatch, radius):
    """The kernel's call reads the chord table through its address with
    the GIL released: the table must outlive the call. A stand-in for the
    kernel (a meta tensor passes the device checks) collects garbage and
    fills fresh arrays of the table's size with junk before it reads the
    table at that address."""
    seen = []

    class Lib:
        @staticmethod
        def p3d_dilate(src, dst, M, H, W, chords, r, stream):
            gc.collect()
            junk = [np.full(2 * r + 1, -7, np.int32) for _ in range(64)]
            seen.append(np.ctypeslib.as_array(
                (ctypes.c_int32 * (2 * r + 1)).from_address(chords)).copy())
            del junk
            return 0

    monkeypatch.setattr(kernels, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(kernels, "lib", lambda: Lib)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setitem(kernels.LAUNCHES, "dilate_disk", 0)
    masks._chord_table.cache_clear()
    m = torch.zeros((2, 9, 40), dtype=torch.bool, device="meta")
    for _ in range(2):
        masks.binary_dilation(m, radius)
    assert len(seen) == 2 and kernels.LAUNCHES["dilate_disk"] == 2
    for w in seen:
        assert np.array_equal(w, disk_chords(radius))
    assert not masks._chord_table(radius).flags.writeable
