"""K13's strip march (kernels/csrc/harris.cu), written in torch, against the
plain version and the JAX package, on the CPU.

The kernel has no CPU mode, so its design is modelled here row by row: a
strip of `tw` output columns holds the image columns [x0 - pad, x0 + tw +
pad) (clamped to the frame; values beyond the strip's own columns, which
the kernel's edge lanes fill with whatever their neighbour is not, are
NaN here, so any kept output that reads them shows), and marches down a band
of `th` output rows. Each step takes one image row, the gradients of the
row above it from the last three image rows, the products and row sums of
that row, the box sums and response of the row above that from the last
three row sums, and the suppression of the row above that from the last
three responses: each pixel's quantities once, in the kernel's f32
operations and order. The model must equal `harris_response_plain` at every
pixel (-inf within the border, where the plain version's wrap-around and
the kernel's clamped edge differ, for border >= 3), and through
`harris_keypoints`' band selection give the JAX package's corners.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plant3dvision_tpu.ops import sfmlite as J

from plant3dvision_tpu_torch.ops import sfmlite as P
from plant3dvision_tpu_torch.ops.carving import fma_f32

torch.set_num_threads(1)

#: the kernel's strip: 32 lanes of 4 columns, lanes 1-30 written
KERNEL_TW, KERNEL_PAD = 120, 4


def _shift(v, d):
    """v[c + d] along the strip; NaN where c + d leaves it."""
    out = torch.full_like(v, float("nan"))
    if d > 0:
        out[:-d] = v[d:]
    else:
        out[-d:] = v[:d]
    return out


def march(gray, mask, border=16, kappa=0.06, tw=KERNEL_TW, th=P.HARRIS_ROWS,
          pad=KERNEL_PAD):
    """K13's response by strips of `tw` columns and bands of `th` rows."""
    V, H, W = gray.shape
    out = torch.full_like(gray, -torch.inf)
    k = torch.tensor(np.float32(kappa))
    rcp9 = torch.tensor(np.float32(1.0) / np.float32(9.0))
    half = torch.tensor(np.float32(0.5))
    for v in range(V):
        for x0 in range(0, W, tw):
            xs = torch.arange(x0 - pad, x0 + tw + pad)
            cols = xs.clamp(0, W - 1)
            keep = torch.arange(pad, pad + min(tw, W - x0))   # written
            xk = xs[keep]
            for y0 in range(0, H, th):
                yend = min(y0 + th, H)

                def row(y):
                    return gray[v, min(max(y, 0), H - 1)][cols]

                gm, g0 = row(y0 - 3), row(y0 - 2)
                a = b = ra = rb = None
                for j in range(y0 - 2, yend + 2):
                    gp = row(j + 1)
                    ix = (_shift(g0, 1) - _shift(g0, -1)) * half
                    iy = (gp - gm) * half
                    c = []
                    for u, w in ((ix, ix), (iy, iy), (ix, iy)):
                        q = u * w
                        c.append(fma_f32(u, w, _shift(q, -1)) + _shift(q, 1))
                    rc = None
                    if j >= y0:          # box sums and response of row j - 1
                        sxx, syy, sxy = [((bb + aa) + cc) * rcp9
                                         for aa, bb, cc in zip(a, b, c)]
                        tr = sxx + syy
                        rc = fma_f32(-(tr * tr), k,
                                     fma_f32(sxx, syy, -(sxy * sxy)))
                    yo = j - 2
                    if yo >= y0:         # suppression of row j - 2
                        cm = torch.maximum(torch.maximum(ra, rb), rc)
                        rmax = torch.maximum(torch.maximum(_shift(cm, -1), cm),
                                             _shift(cm, 1))
                        ok = ((rb >= rmax) & mask[v, yo][cols]
                              & (yo >= border) & (yo < H - border)
                              & (xs >= border) & (xs < W - border))
                        out[v, yo, xk] = torch.where(ok, rb, -torch.inf)[keep]
                    gm, g0 = g0, gp
                    a, b = b, c
                    ra, rb = rb, rc
    return out


def _texture(rng, V, H, W):
    g = rng.standard_normal((V, H, W)).astype(np.float32)
    for ax in (1, 2):
        g = (g + np.roll(g, 1, ax) + np.roll(g, -1, ax)) / 3
    return torch.from_numpy(g.astype(np.float32))


@pytest.mark.parametrize("th", [1, 3, 7, 32])
@pytest.mark.parametrize("tw,shape", [(KERNEL_TW, (1, 41, 251)),
                                      (13, (1, 37, 50)), (64, (2, 23, 131))])
def test_march_equals_plain(th, tw, shape):
    """Strips and bands that do not divide W and H (a last strip of 11, 12
    and 3 columns, a last band of 41 % th, ... rows), one and two views: the
    march bit-equal to harris_response_plain at every pixel."""
    rng = np.random.default_rng(th * 100 + tw)
    gray = _texture(rng, *shape)
    mask = torch.from_numpy(rng.random(shape) > 0.2)
    want = P.harris_response_plain(gray, mask, 5, 0.06)
    got = march(gray, mask, 5, 0.06, tw=tw, th=th)
    assert int(torch.isfinite(want).sum()) > 10
    assert torch.equal(got, want)


@pytest.mark.parametrize("border", [3, 4, 16])
def test_march_border_and_frame_edge(border):
    """The kernel's clamped edge equals the plain version's wrap-around for
    every border that reaches 3 pixels in (the stencil's reach): -inf in the
    border either way, the same response inside."""
    rng = np.random.default_rng(border)
    gray = _texture(rng, 1, 2 * border + 9, 2 * border + 11)
    mask = torch.ones(gray.shape, dtype=torch.bool)
    got = march(gray, mask, border, tw=16, th=5)
    assert torch.equal(got, P.harris_response_plain(gray, mask, border))
    assert torch.isfinite(got).any()


@pytest.mark.parametrize("pad,equal", [(KERNEL_PAD, True), (3, True),
                                       (2, False)])
def test_march_column_halo_is_three(pad, equal):
    """A strip needs 3 image columns either side of its outputs (gradient,
    row sum, suppression): with 3 or the kernel's 4 it equals the plain
    version; with 2 the NaN beyond the strip reaches kept outputs, so the
    model does see the halo."""
    rng = np.random.default_rng(7)
    gray = _texture(rng, 1, 30, 64)
    mask = torch.ones(gray.shape, dtype=torch.bool)
    got = march(gray, mask, 3, tw=10, th=4, pad=pad)
    assert torch.equal(got, P.harris_response_plain(gray, mask, 3)) == equal


@pytest.mark.parametrize("case", ["constant", "no_mask", "ties"])
def test_march_flat_images_and_empty_masks(case):
    """A constant image (r = 0 everywhere: every pixel ties its neighbours
    and is kept), an all-false mask (nothing kept), flat patches in a
    texture (r = 0 ties beside corners): equal to the plain version."""
    rng = np.random.default_rng(11)
    shape = (2, 45, 70)
    gray = _texture(rng, *shape)
    mask = torch.from_numpy(rng.random(shape) > 0.1)
    if case == "constant":
        gray = torch.full(shape, 0.375)
    elif case == "no_mask":
        mask = torch.zeros(shape, dtype=torch.bool)
    else:
        gray[:, 10:30, 12:50] = 0.25
    want = P.harris_response_plain(gray, mask, 4)
    got = march(gray, mask, 4, tw=24, th=7)
    assert torch.equal(got, want)
    if case == "constant":
        assert bool((got[mask & torch.isfinite(want)] == 0).all())
        assert int(torch.isfinite(got).sum()) > 1000
    if case == "no_mask":
        assert not torch.isfinite(got).any()


@pytest.mark.parametrize("k,bands,th", [(128, 6, 32), (100, 5, 3),
                                        (64, 1, 7)])
def test_march_through_band_selection_matches_jax(monkeypatch, k, bands, th):
    """harris_keypoints with the march as its response (the kernel's strip,
    bands of th rows): the JAX package's corners, uv equal (ties broken by
    index as lax.top_k), scores within test_torch_sfmlite's tolerance
    (XLA's vector code fuses 1-8 ulp differently on a few corners)."""
    rng = np.random.default_rng(k + th)
    V, H, W = 2, 96, 130
    gray = _texture(rng, V, H, W)
    gray[1, 40:60, 20:70] = 0.25
    mask = torch.from_numpy(rng.random((V, H, W)) > 0.1)
    monkeypatch.setattr(P, "harris_response",
                        lambda g, m, b, kap: march(g, m, b, kap, th=th))
    uv, s = P.harris_keypoints(gray, mask, k=k, bands=bands)
    uvj, sj = J.harris_keypoints(jnp.asarray(gray.numpy()),
                                 jnp.asarray(mask.numpy()), k=k, bands=bands)
    np.testing.assert_array_equal(uv.numpy(), np.asarray(uvj))
    sj = np.asarray(sj)
    np.testing.assert_allclose(s.numpy(), sj, rtol=0,
                               atol=2e-6 * np.abs(sj).max())
    assert (s.numpy() == sj).mean() > 0.9 and (sj > 0).sum() > k // 2
