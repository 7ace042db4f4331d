"""Gather probes: how fast a kernel looks up a table it holds on chip (port
of exp_pallas_gather.py, three Pallas probes of in-VMEM gathers on the TPU):

    python -m plant3dvision_tpu_torch.tools.gather_probe

prints the card and, for each probe at the JAX script's sizes, its rate in
M lookups/s (each lookup: one index computed, one value read and summed):

- `probe_axis1(L, N, reps)`: out[r, n] = sum_{i<reps} tab[r, (idx[r, n] +
  i) % L] over an (8, L) int32 table (K17, the pyramid-tap candidate);
- `probe_axis0_rows(R, P, reps)`: out[p, :] = sum_i tab[(rows[p] + i) % R,
  :] over an (R, 32) int32 table (K18, the tile-fetch candidate; a lookup
  is one 32-wide row);
- `probe_select32(P, reps)`: out[p] = sum_i T[p, (dy[p] + i) % 32] from a
  (P, 32) table (K19; the JAX form is a 5-level select tree).

Each probe draws its inputs from numpy's global random state in the JAX
script's order (seed it for repeatable inputs) and returns its output
tensor. The kernels are kernels/csrc/gather.cu; on a CPU tensor each
wrapper runs its plain version. Sums are int32 with wraparound. Indices are
taken as the probes make them: idx in [0, L), rows in [0, R), dy in
[0, 32).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels


def _wrap32(s):
    """int64 sums -> int32 with two's-complement wraparound."""
    return (((s + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def _check(name, *tensors):
    for t in tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: int32 tensors only, got {t.dtype}")


# -- K17 -----------------------------------------------------------------------

def axis1_gather_plain(tab, idx, reps):
    """Plain version of `axis1_gather`."""
    R, L = tab.shape
    i = torch.arange(reps, device=idx.device, dtype=torch.int64)
    k = (idx.to(torch.int64)[..., None] + i) % L            # (R, N, reps)
    got = torch.gather(tab.to(torch.int64), 1, k.reshape(R, -1))
    return _wrap32(got.view(k.shape).sum(-1))


def axis1_gather(tab, idx, reps):
    """out[r, n] = sum_{i<reps} tab[r, (idx[r, n] + i) % L]: tab (R, L),
    idx (R, N) int32 -> (R, N) int32. K17 on the card."""
    _check("gather_axis1", tab, idx)
    if tab.ndim != 2 or idx.ndim != 2 or idx.shape[0] != tab.shape[0]:
        raise ValueError("tab must be (R, L) and idx (R, N)")
    if tab.device.type == "cpu":
        return axis1_gather_plain(tab, idx, reps)
    kernels.require_cuda("gather_axis1", tab, idx)
    R, L = (int(s) for s in tab.shape)
    N = int(idx.shape[1])
    out = torch.empty((R, N), dtype=torch.int32, device=tab.device)
    rc = kernels.lib().p3d_gather_axis1(tab.data_ptr(), idx.data_ptr(),
                                        out.data_ptr(), R, L, N, int(reps),
                                        kernels.stream_ptr(tab.device))
    kernels.LAUNCHES["gather_axis1"] += 1
    kernels.check("gather_axis1", rc)
    return out


def axis1_staged(L: int) -> bool:
    """Whether K17 stages a table row of length L in shared memory (else
    it reads the row through L1/L2)."""
    return bool(kernels.lib().p3d_gather_axis1_staged(int(L)))


# -- K18 -----------------------------------------------------------------------

def rows_gather_plain(tab, rows, reps):
    """Plain version of `rows_gather`."""
    R = tab.shape[0]
    i = torch.arange(reps, device=rows.device, dtype=torch.int64)
    k = (rows.to(torch.int64)[:, None] + i) % R             # (P, reps)
    return _wrap32(tab.to(torch.int64)[k].sum(1))


def rows_gather(tab, rows, reps):
    """out[p, c] = sum_{i<reps} tab[(rows[p] + i) % R, c]: tab (R, 32),
    rows (P,) int32 -> (P, 32) int32. K18 on the card."""
    _check("gather_rows", tab, rows)
    if tab.ndim != 2 or tab.shape[1] != 32 or rows.ndim != 1:
        raise ValueError("tab must be (R, 32) and rows (P,)")
    if tab.device.type == "cpu":
        return rows_gather_plain(tab, rows, reps)
    kernels.require_cuda("gather_rows", tab, rows)
    R, P = int(tab.shape[0]), int(rows.shape[0])
    out = torch.empty((P, 32), dtype=torch.int32, device=tab.device)
    rc = kernels.lib().p3d_gather_rows(tab.data_ptr(), rows.data_ptr(),
                                       out.data_ptr(), R, P, int(reps),
                                       kernels.stream_ptr(tab.device))
    kernels.LAUNCHES["gather_rows"] += 1
    kernels.check("gather_rows", rc)
    return out


# -- K19 -----------------------------------------------------------------------

def select32_plain(T, dy, reps):
    """Plain version of `select32`."""
    i = torch.arange(reps, device=dy.device, dtype=torch.int64)
    k = (dy.to(torch.int64)[:, None] + i) % 32               # (P, reps)
    return _wrap32(torch.gather(T.to(torch.int64), 1, k).sum(1))


def select32(T, dy, reps):
    """out[p] = sum_{i<reps} T[p, (dy[p] + i) % 32]: T (P, 32), dy (P,)
    int32 -> (P,) int32. K19 on the card."""
    _check("gather_select32", T, dy)
    if T.ndim != 2 or T.shape[1] != 32 or dy.shape != T.shape[:1]:
        raise ValueError("T must be (P, 32) and dy (P,)")
    if T.device.type == "cpu":
        return select32_plain(T, dy, reps)
    kernels.require_cuda("gather_select32", T, dy)
    P = int(T.shape[0])
    out = torch.empty((P,), dtype=torch.int32, device=T.device)
    rc = kernels.lib().p3d_gather_select32(T.data_ptr(), dy.data_ptr(),
                                           out.data_ptr(), P, int(reps),
                                           kernels.stream_ptr(T.device))
    kernels.LAUNCHES["gather_select32"] += 1
    kernels.check("gather_select32", rc)
    return out


# -- the probes --------------------------------------------------------------------

def axis1_inputs(L, N=8 * 1024, device="cuda"):
    tab = np.random.randint(0, 3, (8, L)).astype(np.int32)
    idx = np.random.randint(0, L, (8, N)).astype(np.int32)
    return torch.from_numpy(tab).to(device), torch.from_numpy(idx).to(device)


def rows_inputs(R, P=4096, device="cuda"):
    tab = np.random.randint(0, 1 << 20, (R, 32)).astype(np.int32)
    rows = np.random.randint(0, R, (P, 1)).astype(np.int32)
    return (torch.from_numpy(tab).to(device),
            torch.from_numpy(rows[:, 0].copy()).to(device))


def select32_inputs(P=4096, device="cuda"):
    tab = np.random.randint(0, 1 << 20, (P, 32)).astype(np.int32)
    dy = np.random.randint(0, 32, (P, 1)).astype(np.int32)
    return (torch.from_numpy(tab).to(device),
            torch.from_numpy(dy[:, 0].copy()).to(device))


def probe_axis1(L, N=8 * 1024, reps=64, device="cuda"):
    """K17 on fresh inputs: the (8, N) int32 output."""
    return axis1_gather(*axis1_inputs(L, N, device), reps)


def probe_axis0_rows(R, P=4096, reps=64, device="cuda"):
    """K18 on fresh inputs: the (P, 32) int32 output."""
    return rows_gather(*rows_inputs(R, P, device), reps)


def probe_select32(P=4096, reps=64, device="cuda"):
    """K19 on fresh inputs: the (P, 1) int32 output (the JAX probe's
    shape)."""
    return select32(*select32_inputs(P, device), reps)[:, None]


#: (name, input maker, wrapper, size, lookups a call) at the JAX sizes
PROBES = [
    ("axis1 L=8K", axis1_inputs, axis1_gather, 8 * 1024, 8 * 8192 * 64),
    ("axis1 L=32K", axis1_inputs, axis1_gather, 32 * 1024, 8 * 8192 * 64),
    ("axis1 L=128K", axis1_inputs, axis1_gather, 128 * 1024, 8 * 8192 * 64),
    ("axis0 rows R=4K", rows_inputs, rows_gather, 4096, 4096 * 64),
    ("axis0 rows R=32K", rows_inputs, rows_gather, 32768, 4096 * 64),
    ("select32", select32_inputs, select32, 4096, 4096 * 64),
]


def timed(fn, n=20):
    """Seconds of one fn() on the card: n calls captured in one CUDA graph,
    the least of 5 replays between two CUDA events, over n. A probe's
    launch is shorter than the host's time to issue it, which events
    around one call would measure instead."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / 1e3 / n)
    return best


def main():
    if not torch.cuda.is_available():
        raise SystemExit("gather_probe measures the card: no CUDA device")
    print(f"device: {torch.cuda.get_device_name(0)}")
    for name, make, fn, size, lookups in PROBES:
        args = make(size)
        dt = timed(lambda: fn(*args, 64))
        print(f"{name}: {lookups / dt / 1e6:.1f} M lookups/s")


if __name__ == "__main__":
    main()
