"""The port's multi-rank programs (plant3dvision_tpu_torch/parallel/) on CPU
ranks over gloo, against the JAX package's on the 8 virtual CPU devices of
tests/conftest.py.

One pool of 8 ranks serves the whole module (`mesh8`); the tests lay the
layouts they need over its first ranks (`Mesh.view`). The carves are held
bit for bit, the averaging volume to the JAX test's tolerance (and bit for
bit to the port's one-device `average`), dp serving element for element,
the trainers' loss curves to rtol 1e-3, atol 1e-4 (the JAX package's own
bar for its mesh against one device) with a bit-identical resume at a
fixed rank count, and the sharded task lanes' filesets to the JAX lanes'.

This module imports no JAX at its top: the ranks import it to unpickle
`_Replay` and `_boom`.
"""

import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from plant3dvision_tpu_torch.ops.carving import average, carve, pack_masks
from plant3dvision_tpu_torch.parallel.carving import (average_grid_sharded,
                                                      carve_2d_sharded,
                                                      carve_grid_sharded,
                                                      carve_sharded)
from plant3dvision_tpu_torch.parallel.carving_mp import (
    carve_sharded_hierarchical, make_sharded_carver)
from plant3dvision_tpu_torch.parallel.launch import RankError
from plant3dvision_tpu_torch.parallel.mesh import best_dp_tp, make_mesh

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def mesh8():
    mesh = make_mesh({"dp": 8}, device="cpu", timeout_s=300)
    yield mesh
    mesh.close()


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _views(n_views, H, W, radius, dist_cam):
    from tests.unit.test_ops import _synthetic_views
    return _synthetic_views(n_views=n_views, H=H, W=W, radius=radius,
                            dist_cam=dist_cam)


def _jax_dense(masks, cams, valid, origin, vs, shape):
    import jax.numpy as jnp
    from plant3dvision_tpu.ops.carving import carve as jcarve
    return np.asarray(jcarve(jnp.asarray(masks), jnp.asarray(cams),
                             jnp.asarray(valid), origin, vs, shape))


def _port_dense(masks, cams, valid, origin, vs, shape):
    H, W = masks.shape[1:]
    return carve(torch.from_numpy(pack_masks(masks)), torch.from_numpy(cams),
                 torch.from_numpy(valid), origin, vs, shape, (H, W))


# ------------------------------------------------------------- the carves

def test_carve_sharded_and_hierarchical_match_jax_at_4_ranks(mesh8):
    """12 views of 128x128 into 40^3 (tests/unit/test_parallel_carve.py):
    the view-sharded carve and carve_sharded_hierarchical at 4 ranks equal
    the JAX package's dense and sharded hierarchical carves bit for bit."""
    from plant3dvision_tpu.parallel.carving_mp import \
        carve_sharded_hierarchical as jhier
    from plant3dvision_tpu.parallel.mesh import make_mesh as jmesh
    masks, cams = _views(12, 128, 128, 8.0, 50.0)
    valid = np.ones(12, bool)
    origin = np.array([-20.0, -20.0, -20.0], np.float32)
    shape = (40, 40, 40)
    d = _jax_dense(masks, cams, valid, origin, 1.0, shape)
    j = jhier(masks, cams, valid, origin, 1.0, shape, jmesh({"dp": 4}))
    m4 = mesh8.view({"dp": 4})
    v = carve_sharded(masks, cams, valid, origin, 1.0, shape, m4)
    h = carve_sharded_hierarchical(masks, cams, valid, origin, 1.0, shape, m4)
    np.testing.assert_array_equal(v.numpy(), d)
    np.testing.assert_array_equal(h.numpy(), j)
    assert (d == 1).any() and (d == -1).any()


def test_carve_sharded_hierarchical_pads_views_at_8_ranks(mesh8):
    """10 views over 8 ranks (padded with valid=False, as
    test_parallel_carve.py:106): equal to the JAX package's sharded carve
    and to the one-device carve; the packed entry point and
    make_sharded_carver give the same volume and zero level counts."""
    from plant3dvision_tpu.parallel.carving_mp import \
        carve_sharded_hierarchical as jhier
    from plant3dvision_tpu.parallel.mesh import make_mesh as jmesh
    masks, cams = _views(10, 96, 160, 5.0, 30.0)
    valid = np.ones(10, bool)
    origin = np.array([-9.0, -7.0, -25.0], np.float32)
    shape = (37, 29, 53)
    j = jhier(masks, cams, valid, origin, 0.5, shape, jmesh({"dp": 8}))
    h = carve_sharded_hierarchical(masks, cams, valid, origin, 0.5, shape,
                                   mesh8)
    np.testing.assert_array_equal(h.numpy(), j)
    np.testing.assert_array_equal(
        _port_dense(masks, cams, valid, origin, 0.5, shape).numpy(), j)
    p = carve_sharded_hierarchical(None, cams, valid, origin, 0.5, shape,
                                   mesh8, packed=pack_masks(masks),
                                   hw=(96, 160))
    assert torch.equal(p, h)
    fn = make_sharded_carver(mesh8.view({"dp": 2}), "dp", 96, 160, 10, shape,
                             fine_tiles=True)
    vol, counts = fn(pack_masks(masks), cams, valid, origin, 0.5)
    assert torch.equal(vol, h) and counts.tolist() == [0, 0, 0]


def test_carve_grid_sharded_matches_jax(mesh8):
    """x-slabs over 8 ranks (K1's plain version with each slab's x_start)
    equal the JAX package's grid-sharded and dense carves."""
    from plant3dvision_tpu.parallel.carving import \
        carve_grid_sharded as jgrid
    from plant3dvision_tpu.parallel.mesh import make_mesh as jmesh
    masks, cams = _views(12, 128, 128, 8.0, 50.0)
    valid = np.ones(12, bool)
    valid[4] = False
    origin = np.array([-20.0, -20.0, -20.0], np.float32)
    shape = (40, 40, 40)
    d = _jax_dense(masks, cams, valid, origin, 1.0, shape)
    j = np.asarray(jgrid(masks, cams, valid, origin, 1.0, shape,
                         jmesh({"dp": 8})))
    g = carve_grid_sharded(masks, cams, valid, origin, 1.0, shape, mesh8)
    np.testing.assert_array_equal(j, d)
    np.testing.assert_array_equal(g.numpy(), d)


@pytest.mark.parametrize("vp,gp", [(2, 4), (4, 2)])
def test_carve_2d_sharded_matches_jax(mesh8, vp, gp):
    """views x slabs on 2x4 and 4x2 with one invalid view
    (test_parallel_carve.py:59): equal to the JAX 2-D carve and the dense
    carve."""
    from plant3dvision_tpu.parallel.carving import carve_2d_sharded as j2d
    from plant3dvision_tpu.parallel.mesh import make_mesh as jmesh
    masks, cams = _views(12, 128, 128, 8.0, 50.0)
    valid = np.ones(12, bool)
    valid[3] = False
    origin = np.array([-20.0, -20.0, -20.0], np.float32)
    shape = (40, 40, 40)
    d = _jax_dense(masks, cams, valid, origin, 1.0, shape)
    j = np.asarray(j2d(masks, cams, valid, origin, 1.0, shape,
                       jmesh({"vp": vp, "gp": gp})))
    s = carve_2d_sharded(masks, cams, valid, origin, 1.0, shape,
                         mesh8.view({"vp": vp, "gp": gp}))
    np.testing.assert_array_equal(j, d)
    np.testing.assert_array_equal(s.numpy(), d)


@pytest.mark.parametrize("x_start,nx", [(0, 9), (13, 11), (31, 9)])
def test_plain_carve_of_a_slab_equals_the_grid_rows(x_start, nx):
    """The plain carve of rows [x_start, x_start + nx) (K1's x_start, as
    the grid-sharded carve runs it) equals those rows of the whole grid's
    carve, bit for bit."""
    masks, cams = _views(12, 128, 128, 8.0, 50.0)
    valid = np.ones(12, bool)
    origin = np.array([-20.0, -20.0, -20.0], np.float32)
    shape = (40, 40, 40)
    whole = _port_dense(masks, cams, valid, origin, 1.0, shape)
    slab = carve(torch.from_numpy(pack_masks(masks)), torch.from_numpy(cams),
                 torch.from_numpy(valid), origin, 1.0, (nx, 40, 40),
                 (128, 128), x_start=x_start)
    assert torch.equal(slab, whole[x_start:x_start + nx])


def test_average_grid_sharded_matches_jax_at_8_ranks(mesh8):
    """The x-slab averaging volume at 8 ranks with the last view invalid
    (test_parallel_carve.py:34): within rtol 3e-6, atol 1e-5 of the JAX
    package's sharded and dense volumes, and bit-equal to the port's
    one-device `average` (the same plain version, the same view order)."""
    import jax.numpy as jnp
    from plant3dvision_tpu.ops.carving import average as javerage
    from plant3dvision_tpu.parallel.carving import \
        average_grid_sharded as javg
    from plant3dvision_tpu.parallel.mesh import make_mesh as jmesh
    masks, cams = _views(10, 128, 128, 8.0, 50.0)
    soft = masks.astype(np.float32) / 255.0 * 0.9 + 0.05
    valid = np.ones(10, bool)
    valid[-1] = False
    origin = np.array([-20.0, -20.0, -20.0], np.float32)
    shape = (40, 40, 40)
    jd = np.asarray(javerage(jnp.asarray(soft), jnp.asarray(cams),
                             jnp.asarray(valid), origin, 1.0, shape))
    js = np.asarray(javg(soft, cams, valid, origin, 1.0, shape,
                         jmesh({"dp": 8})))
    s = average_grid_sharded(soft, cams, valid, origin, 1.0, shape, mesh8)
    one = average(torch.from_numpy(soft), torch.from_numpy(cams),
                  torch.from_numpy(valid), origin, 1.0, shape)
    assert torch.equal(s, one)
    np.testing.assert_allclose(s.numpy(), js, rtol=3e-6, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), jd, rtol=3e-6, atol=1e-5)


# ------------------------------------------------------------- the mesh

def _boom(rt, at):
    if rt.rank == at:
        raise ValueError("rank failed on purpose")
    return rt.rank


def test_a_failing_rank_raises_in_the_controller():
    """No fallback: a rank that raises makes the call raise RankError with
    its traceback, and the pool is closed."""
    with make_mesh({"dp": 2}, device="cpu", timeout_s=60) as mesh:
        assert mesh.run(_boom, (-1,)) == [0, 1]
        with pytest.raises(RankError, match="on purpose"):
            mesh.run(_boom, (1,))
        assert mesh.pool.closed
        with pytest.raises(RankError, match="closed"):
            mesh.run(_boom, (-1,))


def test_backends_are_named_not_guessed():
    """The backend is the caller's: nccl is refused on the CPU, an unknown
    backend anywhere; best_dp_tp is the JAX package's."""
    from plant3dvision_tpu.parallel.mesh import best_dp_tp as jbest
    with pytest.raises(ValueError, match="gloo"):
        make_mesh({"dp": 2}, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        make_mesh({"dp": 2}, device="cpu", backend="mpi")
    for n in (1, 2, 3, 4, 6, 8, 12):
        assert best_dp_tp(n) == jbest(n)
    assert best_dp_tp(8) == {"dp": 2, "tp": 4}


def test_mesh_layout_is_row_major(mesh8):
    m = mesh8.view({"a": 2, "b": 4})
    assert [m.coords(i) for i in (0, 1, 4, 7)] == [
        {"a": 0, "b": 0}, {"a": 0, "b": 1}, {"a": 1, "b": 0},
        {"a": 1, "b": 3}]


def test_mesh_view_builds_a_layout_once(mesh8):
    """A layout's sub-groups are built once a pool: viewing it again (as
    the trainers do at every call) starts no new process groups."""
    from plant3dvision_tpu_torch.parallel.mesh import _make_groups
    pool, calls = mesh8.pool, []
    real = pool.run
    pool.run = lambda fn, *a, **k: (calls.append(fn is _make_groups)
                                    or real(fn, *a, **k))
    try:
        a = mesh8.view({"x": 2, "y": 2})
        b = mesh8.view({"x": 2, "y": 2})
    finally:
        del pool.run
    assert a.layout == b.layout and sum(calls) <= 1
    assert a.layout in pool.layouts


# ------------------------------------------------------------- dp serving

def test_segmentation_inference_data_parallel_at_8_ranks(mesh8):
    """11 images, batch 4 rounded up to 8 over 8 ranks
    (test_models.py:88): equal to the one-device output, element for
    element, in uint8 and float32."""
    from plant3dvision_tpu_torch.models.checkpoint import model_from_config
    from plant3dvision_tpu_torch.models.unet import segmentation_inference
    torch.manual_seed(2)
    model = model_from_config({"arch": "resunet", "widths": [8, 16],
                               "blocks_per_stage": 1,
                               "label_names": ["a", "b", "c", "d"]})
    imgs = (np.random.default_rng(0).random((11, 32, 40, 3)) * 255).astype(
        np.uint8)
    refs = {}
    for out in ("uint8", "float32"):
        ref = refs[out] = segmentation_inference(
            model, imgs, batch_size=4, data_parallel=False, device="cpu",
            output_dtype=out)
        dp = segmentation_inference(model, imgs, batch_size=4,
                                    data_parallel=True, device="cpu",
                                    mesh=mesh8, output_dtype=out)
        assert dp.shape == ref.shape == (11, 4, 32, 40)
        assert torch.equal(dp, ref)

    def no_mesh():
        raise AssertionError("'auto' asked for a mesh on the CPU")
    # "auto" stays on one device on the CPU
    auto = segmentation_inference(model, imgs, batch_size=4, device="cpu",
                                  mesh=no_mesh)
    assert torch.equal(auto, refs["uint8"])


def test_segmentation_inference_without_a_mesh_runs_on_one_device(
        monkeypatch):
    """data_parallel=True with no mesh starts no ranks: the call runs on
    its one device."""
    from plant3dvision_tpu_torch.models.checkpoint import model_from_config
    from plant3dvision_tpu_torch.models.unet import segmentation_inference
    from plant3dvision_tpu_torch.parallel import launch

    def no_pool(*a, **k):
        raise AssertionError("a pool was started without a mesh")
    monkeypatch.setattr(launch.Pool, "__init__", no_pool)
    torch.manual_seed(3)
    model = model_from_config({"arch": "resunet", "widths": [4, 8],
                               "blocks_per_stage": 1,
                               "label_names": ["a", "b"]})
    imgs = (np.random.default_rng(1).random((3, 16, 16, 3)) * 255).astype(
        np.uint8)
    ref = segmentation_inference(model, imgs, batch_size=2,
                                 data_parallel=False, device="cpu")
    got = segmentation_inference(model, imgs, batch_size=2,
                                 data_parallel=True, device="cpu")
    assert torch.equal(got, ref)


# ------------------------------------------------------------- training

def _jax_unet_f32(seed, n_classes, widths=(8, 16)):
    import jax
    import jax.numpy as jnp
    from plant3dvision_tpu.models.unet import ResUNet
    m = ResUNet(n_classes=n_classes, widths=tuple(widths),
                blocks_per_stage=1, dtype=jnp.float32)
    return m, m.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))


def _port_from_flax(params, n_classes, widths=(8, 16), dtype=torch.float32):
    import jax
    from plant3dvision_tpu_torch.models.checkpoint import (
        model_from_config, state_dict_from_flax)
    m = model_from_config({"arch": "resunet", "widths": list(widths),
                           "blocks_per_stage": 1,
                           "label_names": [str(i) for i in range(n_classes)]})
    m.dtype = dtype
    m.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    return m


@pytest.mark.parametrize("axes", [{"dp": 2}, {"dp": 2, "tp": 2},
                                  {"dp": 1, "tp": 4}, {"dp": 2, "tp": 4}])
def test_make_train_step_matches_jax(mesh8, axes):
    """The dp and dp x tp train step (adam at lr 1e-2, the mean
    cross-entropy; the port's tp ranks each convolve with their Cout rows
    of the split kernels, parallel/tp.py) from the same converted weights
    (models/checkpoint.py),
    float32 in both packages, 8 steps on one batch: the losses within
    rtol 2e-3 (the float32 bar of the one-device trainers against JAX,
    tests/test_torch_train.py), and the loss falls."""
    import optax
    from plant3dvision_tpu.parallel import make_mesh as jmesh
    from plant3dvision_tpu.parallel import make_train_step as jstep
    from plant3dvision_tpu.parallel.train import shard_params as jshard
    from plant3dvision_tpu_torch.parallel import make_train_step
    from plant3dvision_tpu_torch.parallel.train import shard_params
    model, params = _jax_unet_f32(0, 2)
    # the JAX step donates its parameters: convert them first
    port = _port_from_flax(params, 2)
    rng = np.random.default_rng(0)
    imgs = rng.random((4, 32, 32, 3)).astype(np.float32)
    labels = (imgs[..., 0] > 0.5).astype(np.int32)
    jm = jmesh(axes)
    opt = optax.adam(1e-2)
    with jm:
        jp = jshard(params, jm)
        jo = opt.init(jp)
        step, shard = jstep(model, opt, jm)
        x, y = shard(imgs, labels)
        jl = []
        for _ in range(8):
            jp, jo, loss = step(jp, jo, x, y)
            jl.append(float(loss))
    m = mesh8.view(axes)
    pp = shard_params(port, m)
    pstep, pshard = make_train_step(port, {"lr": 1e-2, "weight_decay": 0.0},
                                    m)
    px, py = pshard(imgs, labels)
    state, pl = None, []
    for _ in range(8):
        pp, state, loss = pstep(pp, state, px, py)
        pl.append(loss)
    state.close()
    np.testing.assert_allclose(pl, jl, rtol=2e-3)
    assert pl[-1] < pl[0] * 0.9


class _Replay:
    """The JAX package's draws of train_on_crops, by step (recovered from
    the step's seeded generator, train_synth._step_seed), for the port's
    `_draw_batch` on the ranks."""

    def __init__(self, draws, seed):
        self.draws, self.seed = draws, seed

    def __call__(self, gen, n, batch_size):
        step = gen.initial_seed() - (self.seed + 1) * 1_000_003
        idx, flip, gains = self.draws[step]
        return (torch.from_numpy(idx.astype(np.int64)),
                torch.tensor([int(flip)], dtype=torch.uint8),
                torch.from_numpy(gains.reshape(batch_size, 3).copy()))


def _jax_draws(seed, n_chunks, batch_size, n_train, S):
    import jax

    @jax.jit
    def chunk(sub):
        def one(k):
            k_idx, k_flip, k_gain = jax.random.split(k, 3)
            idx = jax.random.randint(k_idx, (batch_size,), 0, n_train)
            flip = jax.random.bernoulli(k_flip, 0.5)
            gains = 1.0 + 0.15 * jax.random.normal(
                k_gain, (batch_size, 1, 1, 3))
            return idx, flip, gains
        return jax.vmap(one)(jax.random.split(sub, S))

    key = jax.random.PRNGKey(seed + 1)
    draws = []
    for _ in range(n_chunks):
        key, sub = jax.random.split(key)
        idx, flip, gains = (np.asarray(a) for a in chunk(sub))
        draws += [(idx[s], flip[s], gains[s]) for s in range(S)]
    return draws


def _crops():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 255, (8, 32, 32, 3), dtype=np.uint8)
    lab = rng.integers(0, 2, (8, 32, 32)).astype(np.uint8)
    return rgb, lab, dict(widths=(4, 8), blocks_per_stage=1, steps=50,
                          batch_size=8, labels=["background", "plant"],
                          val_fraction=0.25)


def test_train_on_crops_mesh_matches_one_device(mesh8):
    """train_on_crops(use_mesh=True) at 8 ranks (dp 8), bfloat16 as
    it trains, against use_mesh=False (test_distill.py:144's setting):
    the loss curve within rtol 1e-3, atol 1e-4; the parameter tree's
    shapes equal."""
    from plant3dvision_tpu_torch.models import train_synth as S
    rgb, lab, kw = _crops()
    m1, c1, h1 = S.train_on_crops(rgb, lab, use_mesh=False, device="cpu",
                                  **kw)
    m8, c8, h8 = S.train_on_crops(rgb, lab, use_mesh=True, mesh=mesh8,
                                  device="cpu", **kw)
    np.testing.assert_allclose([h["loss"] for h in h8],
                               [h["loss"] for h in h1], rtol=1e-3, atol=1e-4)
    assert [p.shape for p in m8.parameters()] == \
        [p.shape for p in m1.parameters()]
    assert c8["val_iou"].keys() == c1["val_iou"].keys()


def test_train_on_crops_mesh_matches_jax_mesh(mesh8, monkeypatch):
    """The same run, float32 in both packages, from JAX's init with JAX's
    draws replayed into every rank: the port at 8 ranks against the JAX
    trainer's use_mesh=True on 8 devices, the loss curve within rtol
    1e-3, atol 1e-4."""
    import jax
    import jax.numpy as jnp
    from plant3dvision_tpu.models import train_synth as jsynth
    from plant3dvision_tpu.models.unet import ResUNet
    from plant3dvision_tpu_torch.models import train_synth as S
    rgb, lab, kw = _crops()

    def make_f32(arch, key, crop, widths, bps, n_classes=None):
        m = ResUNet(n_classes=n_classes, widths=tuple(widths),
                    blocks_per_stage=bps, dtype=jnp.float32)
        return m, m.init(key, jnp.zeros((1, crop, crop, 3)))
    with monkeypatch.context() as mp:
        mp.setattr(jsynth, "_make_model", make_f32)
        _, _, jh = jsynth.train_on_crops(rgb, lab, use_mesh=True, **kw)
    _, init = make_f32("resunet", jax.random.PRNGKey(0), 32, (4, 8), 1, 2)
    monkeypatch.setattr(S, "_make_model", lambda *a, **k: _port_from_flax(
        init, 2, widths=(4, 8)))
    n_train = len(rgb) - max(int(len(rgb) * 0.25), 2)
    monkeypatch.setattr(S, "_draw_batch", _Replay(
        _jax_draws(0, 2, 8, n_train, S.STEPS_PER_CALL), 0))
    _, _, ph = S.train_on_crops(rgb, lab, use_mesh=True, mesh=mesh8,
                                device="cpu", dtype=torch.float32, **kw)
    assert [h["step"] for h in ph] == [h["step"] for h in jh] == [25, 50]
    np.testing.assert_allclose([h["loss"] for h in ph],
                               [h["loss"] for h in jh], rtol=1e-3, atol=1e-4)


def test_train_on_crops_mesh_resume_is_bit_identical(mesh8):
    """At 8 ranks: a run checkpointed after chunk 0 and resumed from that
    state equals the uninterrupted run bit for bit (history and
    parameters); the state is the one-device layout (optax's leaves)."""
    from plant3dvision_tpu_torch.models import train_synth as S
    from plant3dvision_tpu_torch.models.checkpoint import \
        training_state_from_npz_bytes
    rgb, lab, kw = _crops()
    kw["steps"] = 75
    states = {}
    full, _, fh = S.train_on_crops(
        rgb, lab, use_mesh=True, mesh=mesh8, device="cpu",
        checkpoint_every_chunks=1,
        on_checkpoint=lambda b, ch: states.setdefault(ch, b), **kw)
    res, _, rh = S.train_on_crops(rgb, lab, use_mesh=True, mesh=mesh8,
                                  device="cpu", resume_state=states[0], **kw)
    assert [(h["step"], h["loss"]) for h in rh] == \
        [(h["step"], h["loss"]) for h in fh]
    for a, b in zip(full.parameters(), res.parameters()):
        assert torch.equal(a, b)
    _, leaves, meta = training_state_from_npz_bytes(states[1])
    assert len(leaves) == 2 * len(list(full.parameters())) + 2
    assert int(leaves[0]) == int(leaves[-1]) == 50


def test_train_mesh_resume_and_one_device(mesh8):
    """models/train.py's train(use_mesh=True) over a mesh of 4 ranks
    (batch 2: a dp 2 view of its first ranks): the per-epoch losses
    within rtol 1e-3 of one device (float32), a resume after epoch 1
    bit-identical."""
    from plant3dvision_tpu_torch.models.train import train
    rng = np.random.default_rng(1)
    images = rng.random((6, 16, 16, 3)).astype(np.float32)
    labels = (rng.random((6, 16, 16)) > 0.8).astype(np.int32)
    names = ["background", "plant"]
    kw = dict(widths=(8, 16), epochs=3, batch_size=2, device="cpu",
              dtype=torch.float32, log_every=100)
    m4 = mesh8.view({"dp": 4})
    _, _, h1 = train(images, labels, names, use_mesh=False, **kw)
    states = {}
    full, _, h4 = train(images, labels, names, mesh=m4, checkpoint_every=1,
                        on_checkpoint=lambda b, e: states.setdefault(e, b),
                        **kw)
    np.testing.assert_allclose(h4, h1, rtol=1e-3, atol=1e-4)
    res, _, hr = train(images, labels, names, mesh=m4,
                       resume_state=states[0], **kw)
    assert hr == h4
    for a, b in zip(full.parameters(), res.parameters()):
        assert torch.equal(a, b)


# ------------------------------------------------------------- the tasks

def _geom_scan(db):
    from plant3dvision_tpu.synth import SyntheticPlant, generate_scan
    plant = SyntheticPlant(n_fruits=6, stem_radius=2.5, fruit_radius=1.8,
                           fruit_length=20.0, internode=7.0)
    generate_scan(db, "s", n_views=14, width=160, height=160, f=200.0,
                  plant=plant)


def _geom_config(**voxels):
    from plant3dvision_tpu.runtime.config import load_toml
    cfg = load_toml(ROOT / "configs" / "geom_pipe_synth.toml")
    cfg["Voxels"].update(voxel_size=2.0, engine="sharded", **voxels)
    return cfg


def _volumes(scan, report, task):
    fs = scan.get_fileset(report[task]["fileset"])
    z = np.load(io.BytesIO(fs.get_files()[0].read_raw()))
    return fs.id, {k: z[k] for k in z.files}, fs.get_files()[0].get_metadata()


@pytest.mark.parametrize("kind", ["carving", "averaging"])
def test_voxels_sharded_matches_the_jax_lane(mesh8, kind):
    """Voxels(engine="sharded") on a geom_pipe_synth scan through a
    RunContext of 4 ranks against the JAX package's sharded lane on 8
    devices: the fileset id and metadata equal; the carve volume bit for
    bit, the averaging volume within the JAX test's rtol 3e-6, atol
    1e-5."""
    from plant3dvision_tpu.fsdb.testing import TemporaryDB
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.runtime import run_task as jax_run_task
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    # log=false: the JAX lane's label-less log'd averaging volume is
    # read-only where Voxels exponentiates it in place (ROADMAP Queue C)
    cfg = _geom_config(type=kind, log=False)
    with TemporaryDB() as db:
        _geom_scan(db)
        jctx = JaxRunContext(db, "s", cfg)
        jid, jv, jmeta = _volumes(jctx.scan, jax_run_task(
            jctx, "Voxels", report=False), "Voxels")
        jctx.scan.delete_fileset(jid)
        ctx = RunContext(db, "s", cfg, device="cpu",
                         mesh=mesh8.view({"dp": 4}))
        assert ctx.ranks == 4
        pid, pv, pmeta = _volumes(ctx.scan, run_task(
            ctx, "Voxels", report=False), "Voxels")
    assert pid == jid and pmeta == jmeta and pv.keys() == jv.keys()
    for k in jv:
        if kind == "carving":
            np.testing.assert_array_equal(pv[k], jv[k])
            assert (jv[k] == 1).any() and (jv[k] == -1).any()
        else:
            np.testing.assert_allclose(pv[k], jv[k], rtol=3e-6, atol=1e-5)


def test_fused_carving_sharded_matches_the_jax_lane(mesh8):
    """FusedCarving(engine="sharded") through a RunContext of 4 ranks
    against the JAX lane on 8 devices: the same fileset and volume, bit
    for bit."""
    from plant3dvision_tpu.fsdb.testing import TemporaryDB
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.runtime import run_task as jax_run_task
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    cfg = {"FusedCarving": {"upstream_task": "ImagesFilesetExists",
                            "camera_metadata": "camera", "voxel_size": 1.5,
                            "type": "linear", "parameters": [1.0, 0.0, 0.0],
                            "threshold": 0.3, "dilation": 0,
                            "engine": "sharded"}}
    with TemporaryDB() as db:
        _geom_scan(db)
        jctx = JaxRunContext(db, "s", cfg)
        jid, jv, jmeta = _volumes(jctx.scan, jax_run_task(
            jctx, "FusedCarving", report=False), "FusedCarving")
        jctx.scan.delete_fileset(jid)
        ctx = RunContext(db, "s", cfg, device="cpu",
                         mesh=mesh8.view({"dp": 4}))
        pid, pv, pmeta = _volumes(ctx.scan, run_task(
            ctx, "FusedCarving", report=False), "FusedCarving")
    assert pid == jid and pmeta == jmeta
    np.testing.assert_array_equal(pv["volume"], jv["volume"])
    assert (jv["volume"] == 1).sum() > 50


# ------------------------------------------------------------- evaluate_model

def _fake_probs(batch):
    b = np.asarray(batch).astype(np.int64)
    return np.stack([(b[..., c % 3] * (c + 3) + 17 * c) % 256
                     for c in range(6)], 1).astype(np.uint8)


def test_evaluate_model_writes_the_jax_json(tmp_path, monkeypatch):
    """tools/evaluate_model against the repo's evaluate_model.py on a DB of
    two generate_photo_scan scans with ground-truth masks (one scan
    without them, skipped by both): given the same probabilities (the
    CNNs' own agreement is tests/test_torch_seg.py's), the same JSON."""
    import sys

    import plant3dvision_tpu.models.unet as jax_unet
    from plant3dvision_tpu_torch.fsdb import FSDB
    from plant3dvision_tpu_torch.models import unet
    from plant3dvision_tpu_torch.models.checkpoint import (flax_params,
                                                           model_from_config,
                                                           save_model)
    from plant3dvision_tpu_torch.runtime.config import dump_toml
    from plant3dvision_tpu_torch.synth_photo import (ProceduralArabidopsis,
                                                     generate_photo_scan)
    from plant3dvision_tpu_torch.tools.evaluate_model import main

    labels = ["background", "flower", "fruit", "leaf", "pedicel", "stem"]
    dbp = tmp_path / "db"
    dbp.mkdir()
    (dbp / "romidb").touch()
    db = FSDB(dbp)
    db.connect(unsafe=True)
    for i, sid in enumerate(("a", "b")):
        generate_photo_scan(db, sid, n_views=2, width=96, height=80,
                            plant=ProceduralArabidopsis(n_fruits=4, seed=i),
                            gt_fileset="gt")
    generate_photo_scan(db, "c", n_views=1, width=96, height=80,
                        plant=ProceduralArabidopsis(n_fruits=3, seed=5),
                        with_gt_masks=False)
    model = model_from_config({"arch": "resunet", "widths": [8, 16],
                               "blocks_per_stage": 1, "label_names": labels})
    save_model(db.get_scan("models", create=True).get_fileset(
        "models", create=True).get_file("tiny", create=True),
        flax_params(model), {"label_names": labels, "widths": [8, 16],
                             "blocks_per_stage": 1})
    db.disconnect()
    cfg = tmp_path / "cfg.toml"
    cfg.write_text(dump_toml({
        "ModelFilesetExists": {"scan_id": "models"},
        "Segmentation2D": {"upstream_task": "ImagesFilesetExists",
                           "query": {"channel": "rgb"}, "Sx": 96, "Sy": 80,
                           "binarize": True, "threshold": 0.5,
                           "batch_size": 2}}))
    monkeypatch.setattr(jax_unet, "segmentation_inference",
                        lambda model, params, batch, **kw: _fake_probs(batch))
    monkeypatch.setattr(unet, "segmentation_inference",
                        lambda model, batch, device=None, **kw:
                        torch.from_numpy(_fake_probs(batch)).to(device))
    args = [str(dbp), "--config", str(cfg), "--gt-fileset", "gt"]
    monkeypatch.syspath_prepend(str(ROOT))
    import evaluate_model as jax_script
    monkeypatch.setattr(sys, "argv", ["evaluate_model.py", *args, "--out",
                                      str(tmp_path / "jax.json")])
    jax_script.main()
    # the JAX run left its Segmentation2D filesets: the port's run redoes
    # them from a clean scan
    db = FSDB(dbp)
    db.connect(unsafe=True)
    for sid in ("a", "b"):
        scan = db.get_scan(sid)
        for fs in list(scan.list_filesets()):
            if fs.startswith("Segmentation2D"):
                scan.delete_fileset(fs)
    db.disconnect()
    res = main([*args, "--out", str(tmp_path / "port.json"), "--device",
                "cpu"])
    port = json.loads((tmp_path / "port.json").read_text())
    jax_json = json.loads((tmp_path / "jax.json").read_text())
    assert port == jax_json
    assert sorted(port) == ["a", "b"] and sorted(res) == ["a", "b"]
    assert set(port["a"]) == set(labels) - {"background"}
