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
