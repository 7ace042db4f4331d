"""K3's fused route on the CPU: `smoothed_gradient` (vol2pcd's three
Gaussian-smoothed gradients) against the port's plain composition (bit for
bit) and the JAX package's (atol 1e-5: XLA's convolution sums the taps in
another order); the reflect table the fused kernel reads; and the fused
kernel's scheme written here in torch (every position outside the grid
read at its reflected in-grid position in all three axes at once, the
gradient there the one-sided difference at the edge, the taps summed from
0 in order with separately rounded products), which must equal the plain
composition bit for bit."""

import numpy as np
import pytest
import torch

from plant3dvision_tpu.ops import filters as jax_filters

from plant3dvision_tpu_torch.ops import filters

torch.set_num_threads(1)

SHAPES = [(26, 22, 30), (3, 17, 2), (2, 2, 2)]


def _volume(shape, seed=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32) * 5


@pytest.mark.parametrize("shape", SHAPES)
def test_smoothed_gradient_cpu_matches_the_compositions(shape):
    x = _volume(shape)
    got = filters.smoothed_gradient(torch.from_numpy(x), 1.0)
    plain = [filters.gaussian_filter_plain(g, 1.0)
             for g in filters.gradient_plain(torch.from_numpy(x))]
    ref = [np.asarray(jax_filters.gaussian_filter(g, 1.0))
           for g in jax_filters.gradient(x)]
    assert len(got) == 3
    for g, p, r in zip(got, plain, ref):
        assert g.dtype == torch.float32 and g.shape == shape
        assert torch.equal(g, p)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5, rtol=0)


@pytest.mark.parametrize("r", range(17))
def test_reflect_table_is_numpy_symmetric_pad(r):
    """`_symmetric_index`, the table the fused kernel reads (as int32, n +
    2r entries an axis), is numpy's symmetric pad, several periods deep
    where r > n."""
    for n in range(1, 41):
        want = np.pad(np.arange(n), r, mode="symmetric")
        np.testing.assert_array_equal(
            filters._symmetric_index(n, r, "cpu").numpy(), want)
    tabs = filters._reflect_tables((3, 1, 40), r, torch.device("cpu"))
    assert tabs.dtype == torch.int32
    np.testing.assert_array_equal(tabs.numpy(), np.concatenate(
        [np.pad(np.arange(n), r, mode="symmetric") for n in (3, 1, 40)]))


def _fused_scheme(d, sigma=1.0):
    """filters.cu:smoothed_gradient_kernel's arithmetic on the whole grid:
    the gradient at every position of the r-extended grid from the
    reflected source voxel, then the x, y and z passes over it."""
    taps = filters.gaussian_kernel1d(sigma).astype(np.float32)
    r = len(taps) // 2
    nx, ny, nz = d.shape
    src = [filters._symmetric_index(n, r, "cpu") for n in (nx, ny, nz)]

    def stencil(s, n):
        lo = torch.where(s > 0, s - 1, s)
        hi = torch.where(s < n - 1, s + 1, s)
        return lo, hi, (s > 0) & (s < n - 1)

    sx, sy, sz = torch.meshgrid(*src, indexing="ij")
    g = []
    for axis, (s, n) in enumerate(zip((sx, sy, sz), d.shape)):
        lo, hi, half = stencil(s, n)
        a = [sx, sy, sz]
        b = [sx, sy, sz]
        a[axis], b[axis] = lo, hi
        v = d[b[0], b[1], b[2]] - d[a[0], a[1], a[2]]
        g.append(torch.where(half, v * 0.5, v))

    def dot(x, axis, n):
        acc = torch.zeros_like(x.narrow(axis, 0, n))
        for t, w in enumerate(taps):
            acc = acc + torch.tensor(w) * x.narrow(axis, t, n)
        return acc

    return [dot(dot(dot(c, 0, nx), 1, ny), 2, nz) for c in g]


@pytest.mark.parametrize("shape", [(30, 26, 41), (2, 9, 5), (3, 17, 2),
                                   (2, 2, 2), (5, 5, 5), (33, 17, 65)])
def test_fused_scheme_equals_the_plain_composition(shape):
    d = torch.from_numpy(_volume(shape, seed=sum(shape)))
    plain = [filters.gaussian_filter_plain(g, 1.0)
             for g in filters.gradient_plain(d)]
    for got, want in zip(_fused_scheme(d), plain):
        assert torch.equal(got, want)


def test_smoothed_gradient_never_falls_back():
    """A tensor off the CPU goes to the kernel or raises, never to the
    plain composition: a meta tensor is refused by the wrapper's checks
    before any launch."""
    with pytest.raises(ValueError, match="CUDA device"):
        filters.smoothed_gradient(torch.zeros((4, 4, 4), device="meta"))
    with pytest.raises(ValueError, match="3-D float32"):
        filters.smoothed_gradient(
            torch.zeros((4, 4, 4), dtype=torch.float64, device="meta"))
