"""K7's decomposition (kernels/csrc/reproject.cu) against the JAX package,
on the CPU.

The kernel orders each block's points by their pixel in file 0, projects a
point once for each camera run of a chunk of files (`camera_runs`:
consecutive files whose camera rows are equal bit for bit, cut at the
chunk's start), reads the byte of every file of the run at that pixel into
a table (phase 1), then adds each label's files in file order (phase 2),
its sums carried across chunks, v / 255 by three f32 operations. The
kernel has no CPU mode, so the two phases are modelled here in numpy over
the port's projection (`project_points`, XLA's f32 operations) and must
give JAX's `score_points_by_masks` on masks / 255 bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plant3dvision_tpu.camera import pose_to_extrinsics
from plant3dvision_tpu.ops.carving import pack_camera
from plant3dvision_tpu.ops.reproject import score_points_by_masks as jsp

from plant3dvision_tpu_torch.ops.carving import fma_f32
from plant3dvision_tpu_torch.ops.reproject import (FILE_CHUNK, camera_runs,
                                                   project_points,
                                                   score_points_by_masks)

torch.set_num_threads(1)

#: the kernel's points a block
BLOCK_POINTS = 256

#: float32(1/255), the kernel's reciprocal
RCP255 = np.float32(1.0) / np.float32(255.0)


def _camera(rng, H, W):
    a = rng.uniform(0, 2 * np.pi)
    c = np.array([30 * np.cos(a), 30 * np.sin(a), rng.uniform(-10, 10)])
    R, t = pose_to_extrinsics(c, rng.uniform(-1, 1, 3))
    f = (rng.uniform(40, 60), rng.uniform(40, 60), W / 2 + rng.uniform(-3, 3),
         H / 2 + rng.uniform(-3, 3))
    return np.asarray(pack_camera(f, R, t), np.float32)


def _runs(cams, chunk=FILE_CHUNK):
    return camera_runs(torch.from_numpy(np.ascontiguousarray(cams)),
                       chunk).tolist()


def _views(rng, n, H=31, W=43):
    return np.stack([_camera(rng, H, W) for _ in range(n)])


# -- run detection ----------------------------------------------------------

def test_runs_of_distinct_and_equal_cameras():
    rng = np.random.default_rng(0)
    cams = _views(rng, 9)
    assert _runs(cams) == list(range(9))
    same = np.repeat(cams[:1], 300, axis=0)
    assert _runs(same, None) == [0]
    assert _runs(same) == list(range(0, 300, FILE_CHUNK))
    assert _runs(same, 7) == list(range(0, 300, 7))
    assert _runs(same[:0]) == []


@pytest.mark.parametrize("L", [1, 5, 8])
def test_runs_of_image_major_and_label_major_files(L):
    """Segmentation2D's order (each image's L label files one after
    another, each with the image's camera): a run a view, cut at chunk
    starts; the same files label-major: every file its own run."""
    rng = np.random.default_rng(L)
    V = 41
    views = _views(rng, V)
    image_major = np.repeat(views, L, axis=0)
    starts = list(range(0, V * L, L))
    assert _runs(image_major, None) == starts
    assert _runs(image_major) == sorted(
        set(starts) | set(range(0, V * L, FILE_CHUNK)))
    label_major = np.tile(views, (L, 1))
    assert _runs(label_major, None) == list(range(V * L))


def test_runs_of_a_camera_that_repeats_apart_and_of_signed_zeros():
    """A camera that comes back after another one starts a second run; rows
    that differ only in the sign of a zero differ bit for bit (two runs;
    their projections agree, so either way is exact)."""
    rng = np.random.default_rng(3)
    a, b = _views(rng, 2)
    assert _runs(np.stack([a, a, b, a, a])) == [0, 2, 3]
    z = a.copy()
    z[13] = 0.0
    nz = z.copy()
    nz[13] = -0.0
    assert _runs(np.stack([z, nz, nz])) == [0, 1]


# -- the two phases ---------------------------------------------------------

def div255(v):
    """The kernel's v / 255: the product with float32(1/255) and one fused
    correction, in float32."""
    x = torch.as_tensor(v, dtype=torch.float32)
    r = torch.tensor(RCP255)
    m = x * r
    return fma_f32(fma_f32(-m, torch.tensor(np.float32(255.0)), x), r, m)


def test_div255_is_the_correctly_rounded_quotient():
    """For every byte v the kernel's three f32 operations give float32(v) /
    255 as numpy rounds it (the JAX task's masks / 255.0); the product with
    the reciprocal alone misses on 126 of them."""
    v = np.arange(256)
    want = v.astype(np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(div255(v).numpy(), want)
    assert ((v.astype(np.float32) * RCP255) != want).sum() == 126


def block_order(points, cam, H, W, block):
    """The kernel's point order: each block's points sorted by their pixel
    in `cam` (row-major; behind the camera or out of frame last; ties by
    index)."""
    lin, inside = project_points(torch.from_numpy(points),
                                 torch.from_numpy(cam), (H, W))
    key = torch.where(inside, lin, H * W).numpy()
    return np.concatenate([b0 + np.argsort(key[b0:b0 + block], kind="stable")
                           for b0 in range(0, len(points), block)])


def two_phases(points, masks, cams, lab, L, block=BLOCK_POINTS,
               chunk=FILE_CHUNK):
    """K7 by blocks of `block` points (in pixel order of file 0) and chunks
    of `chunk` files: phase 1 a projection a camera run into a byte table,
    phase 2 each label's files in file order, sums carried across chunks
    (float32 adds)."""
    N, (F, H, W) = points.shape[0], masks.shape
    div = div255(np.arange(256)).numpy()
    flat = masks.reshape(F, H * W)
    scores = np.zeros((N, L), np.float32)
    order = block_order(points, cams[0], H, W, block) if F else np.arange(N)
    for b0 in range(0, N, block):
        idx = order[b0:b0 + block]
        pts = torch.from_numpy(points[idx])
        acc = np.zeros((pts.shape[0], L), np.float32)
        for f0 in range(0, F, chunk):
            nf = min(chunk, F - f0)
            starts = _runs(cams[f0:f0 + nf], None) + [nf]
            tab = np.zeros((nf, pts.shape[0]), np.uint8)
            for fa, fb in zip(starts[:-1], starts[1:]):
                lin, inside = project_points(
                    pts, torch.from_numpy(cams[f0 + fa]), (H, W))
                lin, inside = lin.numpy(), inside.numpy()
                for f in range(fa, fb):
                    tab[f] = np.where(inside, flat[f0 + f][lin], 0)
            for l in range(L):
                for f in range(nf):
                    if lab[f0 + f] == l:
                        acc[:, l] = acc[:, l] + div[tab[f]]
        scores[idx] = acc
    return scores


def _scene(seed, V, L, order, H=31, W=43, n=700):
    """V views, L label files a view in `order`, points in and out of the
    frames and behind some cameras; the last view's camera also sees points
    that land exactly in the last pixel column and row."""
    rng = np.random.default_rng(seed)
    views = _views(rng, V, H, W)
    cams = (np.repeat(views, L, axis=0) if order == "image_major"
            else np.tile(views, (L, 1)))
    lab = (np.tile(np.arange(L), V) if order == "image_major"
           else np.repeat(np.arange(L), V)).astype(np.int32)
    pts = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    pts[:60] *= 6                                      # behind some cameras
    fx, fy, cx, cy = views[-1][:4]
    R, t = views[-1][4:13].reshape(3, 3), views[-1][13:16]
    u = np.array([W - 0.5, W - 0.999, W + 0.001, 5.5, 5.5, 3.25])
    v = np.array([H - 0.5, 5.5, 7.5, H - 0.999, H + 0.001, H - 0.25])
    d = rng.uniform(25, 35, u.size)
    pc = np.stack([(u - cx) / fx * d, (v - cy) / fy * d, d], 1)
    pts[100:100 + u.size] = ((pc - t) @ R).astype(np.float32)
    masks = rng.integers(0, 256, (V * L, H, W), dtype=np.uint8)
    return pts, masks, cams, lab


@pytest.mark.parametrize("order", ["image_major", "label_major"])
@pytest.mark.parametrize("chunk", [FILE_CHUNK, 16, 7])
def test_two_phases_equal_jax(order, chunk):
    """The chunked two phases bit-equal to JAX's scan: runs of L = 5 files
    that cross chunk edges (chunks of 16 and 7), F = 105 not a multiple of
    the chunk, a file whose label is L and one whose label is -1 (nothing
    added), 700 points (not a multiple of the block), some behind the
    cameras, some on the last pixel row and column."""
    L = 5
    pts, masks, cams, lab = _scene(1, 21, L, order)
    lab[7] = L
    lab[40] = -1
    want = np.asarray(jsp(jnp.asarray(pts),
                          jnp.asarray(masks.astype(np.float32) / 255.0),
                          jnp.asarray(cams), jnp.asarray(lab), L))
    got = two_phases(pts, masks, cams, lab, L, chunk=chunk)
    np.testing.assert_array_equal(got, want)
    assert (want > 0).any(axis=1).mean() > 0.3 and (want == 0).any()
    # the points on the last pixel column and row were scored by that view
    lin, inside = project_points(torch.from_numpy(pts[100:106]),
                                 torch.from_numpy(cams[-1]), masks.shape[1:])
    H, W = masks.shape[1:]
    assert inside.tolist() == [True, True, False, True, False, True]
    assert (lin[inside] % W == W - 1).sum() == 2
    assert (lin[inside] // W == H - 1).sum() == 3
    # and the plain version agrees
    np.testing.assert_array_equal(score_points_by_masks(
        *(torch.from_numpy(a) for a in (pts, masks, cams, lab)), L).numpy(),
        want)


@pytest.mark.parametrize("L", [1, 8])
def test_two_phases_one_and_eight_labels(L):
    """The label counts the kernel takes at its ends: L = 1 (one label
    group of phase 2 idle) and L = 8, image-major, chunks of 16."""
    pts, masks, cams, lab = _scene(2, 9, L, "image_major", n=150)
    want = np.asarray(jsp(jnp.asarray(pts),
                          jnp.asarray(masks.astype(np.float32) / 255.0),
                          jnp.asarray(cams), jnp.asarray(lab), L))
    np.testing.assert_array_equal(
        two_phases(pts, masks, cams, lab, L, chunk=16), want)
