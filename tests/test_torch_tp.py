"""Tensor parallelism of the port's trainers (parallel/tp.py,
parallel/train.py, models/optim.py's tp arena, the plain version of K22's
tp lane) on CPU ranks over gloo: against the JAX package's dp x tp layout
on the 8 virtual CPU devices of tests/conftest.py, and bit for bit
against one device computing the ranks' decomposition
(parallel/tp.py:decompose).

One pool of 8 ranks serves the module (`mesh8`); the tests lay the
layouts they need over its first ranks. The ranks compute on one thread
each, and so does this process (oneDNN's convolution gradients sum in an
order that depends on the thread count). The loss curves against JAX are
held to the JAX package's own bar for its mesh against one device (rtol
1e-3, atol 1e-4).

This module imports no JAX at its top: the ranks import it to unpickle
its rank functions and `_Replay`.
"""

import numpy as np
import pytest
import torch

from plant3dvision_tpu_torch.models import train_synth as S
from plant3dvision_tpu_torch.models.checkpoint import _flatten, flax_params
from plant3dvision_tpu_torch.models.optim import AdamW
from plant3dvision_tpu_torch.models.segnet import Conv
from plant3dvision_tpu_torch.ops import training as T
from plant3dvision_tpu_torch.parallel import tp as tpm
from plant3dvision_tpu_torch.parallel.mesh import best_dp_tp, make_mesh
from plant3dvision_tpu_torch.parallel.train import MeshTrainer, shard_params


@pytest.fixture(scope="module")
def mesh8():
    mesh = make_mesh({"dp": 8}, device="cpu", timeout_s=300)
    yield mesh
    mesh.close()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch="resunet", n_classes=6, dtype=torch.float32):
    return S._make_model(arch, 0, (8, 16), 1, n_classes=n_classes,
                         dtype=dtype)


def _r_rows(rt, key):
    """The conv weights' Cout rows that this rank holds."""
    return {n: int(m.weight.shape[0])
            for n, m in rt.store[key].model.named_modules()
            if isinstance(m, Conv)}


# ------------------------------------------------------------ the layout

@pytest.mark.parametrize("arch,tp", [("resunet", 2), ("resunet", 4),
                                     ("tpusegnet", 2), ("tpusegnet", 4)])
def test_shard_params_splits_the_leaves_jax_splits(mesh8, arch, tp):
    """The port's rule splits exactly the leaves that the JAX package's
    `shard_params` shards over tp, on the same flax tree (the ResUNet's
    6-class logits conv splits at tp 2, not at tp 4); each rank holds
    out / tp rows of a split conv weight and the whole of the rest."""
    from plant3dvision_tpu.parallel.mesh import make_mesh as jmesh
    from plant3dvision_tpu.parallel.train import shard_params as jshard
    model = _model(arch)
    jm = jmesh({"dp": 8 // tp, "tp": tp})
    with jm:
        placed = _flatten(jshard(flax_params(model), jm))
    want = sorted(k for k, v in placed.items()
                  if "tp" in tuple(v.sharding.spec))
    sp = shard_params(model, mesh8.view({"dp": 8 // tp, "tp": tp}))
    try:
        assert sp.split() == want and want
        if arch == "resunet":
            assert ("params/Conv_1/kernel" in want) == (tp == 2)
        full = {n: m.weight.shape[0] for n, m in model.named_modules()
                if isinstance(m, Conv)}
        split = {k.rsplit("/", 1)[0][len("params/"):].replace("/", ".")
                 for k in want}
        for rows in sp.mesh.run(_r_rows, (sp.key,)):
            assert rows == {n: c // tp if n in split else c
                            for n, c in full.items()}
        n_split = sum(model.get_submodule(n).weight.numel() for n in split)
        n_all = sum(p.numel() for p in model.parameters())
        assert sp.held() == [n_all - n_split + n_split // tp] * 8
    finally:
        sp.close()


# ------------------------------------------------- the column-parallel conv

def _r_conv(rt, layout, w, b, x, g, stride):
    """A tp rank's conv (out, in, k, k) of x, and its backward from g:
    (y, dx, the rank's dw rows, db)."""
    conv = Conv(w.shape[1], w.shape[0], w.shape[2], stride)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(b)
    t = dict(zip(*layout))["tp"]
    tpm.shard(conv, tpm.ColumnParallel(rt.rank, t, rt.group(layout, "tp")))
    x = x.clone().requires_grad_(True)
    y = conv(x, torch.float32)
    y.backward(g)
    return y.detach(), x.grad, conv.weight.grad, conv.bias.grad


def test_column_parallel_conv_equals_the_decomposition(mesh8):
    """A stride-2 SAME 3x3 conv split over 4 ranks: the gathered output,
    the input's gradient (the ranks' partial gradients summed in rank
    order), each rank's weight-gradient rows and the bias gradient equal
    one device's decomposition bit for bit, and the unsplit conv within
    float32 rounding."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((8, 6, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 6, 9, 10)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 8, 5, 5)).astype(np.float32))
    m4 = mesh8.view({"tp": 4})
    out = m4.run(_r_conv, (m4.layout, w, b, x, g, 2))
    one = Conv(6, 8, 3, 2)
    with torch.no_grad():
        one.weight.copy_(w)
        one.bias.copy_(b)
    dec = tpm.decompose(one, 4)
    xd = x.clone().requires_grad_(True)
    yd = dec(xd, torch.float32)
    yd.backward(g)
    for y, dx, dw, db in out:
        assert torch.equal(y, yd) and torch.equal(dx, xd.grad)
        assert torch.equal(db, dec.bias.grad)
    for t, (_, _, dw, _) in enumerate(out):
        assert dw.shape == (2, 6, 3, 3)
        assert torch.equal(dw, dec.tp.slices[t].grad)
    xo = x.clone().requires_grad_(True)
    yo = one(xo, torch.float32)
    yo.backward(g)
    torch.testing.assert_close(yd, yo, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xd.grad, xo.grad, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- the trainer's steps

def _decomposed_steps(make, layout, spec, batches, w):
    """The clipped steps of `layout`'s ranks on one device: each dp
    part's backward through the decomposed model, x its share of the
    pixels, summed in rank order; then AdamW over the ranks' arena layout
    with K22's tp lane (its chunk sums in the ranks' order). Returns the
    losses, (flax params, leaves) and the model."""
    dp, tp = layout.get("dp", 1), layout.get("tp", 1)
    one = tpm.decompose(make(), tp)
    kw = dict(regions=tpm.regions(one), gather_sums=lambda p: [p]) \
        if tp > 1 else {}
    opt = AdamW(one, **spec, **kw)
    losses = []
    for x, y in batches:
        per = x.shape[0] // dp
        parts, total = [], None
        for r in range(dp):
            h = slice(r * per, (r + 1) * per)
            opt.zero_grad()
            lh = T.weighted_cross_entropy(one(x[h]), y[h], w)
            lh.backward()
            share = torch.tensor(1.0 / dp)
            parts.append(opt.grad * share)
            t = lh.detach() * share
            total = t if total is None else total + t
        opt.grad.copy_(parts[0])
        for gp in parts[1:]:
            opt.grad.add_(gp)
        opt.step()
        losses.append(float(total))
    return losses, tpm.decomposed_state(one, opt), one


def _batches(n, B, size=32, n_cls=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.random((B, 3, size, size), np.float32)),
             torch.from_numpy(rng.integers(0, n_cls, (B, size, size))
                              .astype(np.uint8))) for _ in range(n)]


@pytest.mark.parametrize("layout", [{"dp": 1, "tp": 4}, {"dp": 2, "tp": 2},
                                    {"dp": 2, "tp": 4}])
def test_trainer_steps_equal_the_decomposition(mesh8, layout):
    """3 clipped float32 steps (the clip below the gradient's norm, so
    that every step takes K22's tp lane's clipped branch) of a
    MeshTrainer over dp x tp: the losses, the gathered parameters and
    both moments equal one device's decomposition bit for bit; each rank
    holds and computes its share (parameters, arena, conv multiply-adds
    from its calls' shapes) and receives the bytes that its all-gathers
    should move."""
    spec = {"lr": 1e-3, "clip": 0.05, "weight_decay": 1e-4}
    batches = _batches(3, 4)
    w = torch.ones(6)
    want_loss, (want_p, want_l), one = _decomposed_steps(
        _model, layout, spec, batches, w)
    tr = MeshTrainer(mesh8.view(layout), _model(), spec, weights=w)
    try:
        got_loss = [tr.step(x, y) for x, y in batches]
        got_p, got_l = tr.state()
        stats = tr.rank_stats()
    finally:
        tr.close()
    assert got_loss == want_loss
    gp, wp = _flatten(got_p), _flatten(want_p)
    assert list(gp) == list(wp)
    assert all(np.array_equal(gp[k], wp[k]) for k in gp)
    assert len(got_l) == len(want_l) and all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(got_l, want_l))
    # the share of each rank, against the one-device model's
    tp = layout["tp"]
    full = _model()
    split = {n for n, _ in tpm.split_convs(full, tp)}
    per_conv, moved = {}, {}

    def hook(name):
        def f(mod, inputs, out):
            per_conv[name] = (out.shape[0] * out.shape[2] * out.shape[3]
                              * mod.weight[0].numel() * mod.weight.shape[0])
            # the output, gathered; the input's gradient, one a rank
            moved[name] = 4 * (out.numel() + tp * (
                inputs[0].numel() if inputs[0].requires_grad else 0))
        return f
    for n, m in full.named_modules():
        if isinstance(m, Conv):
            m.register_forward_hook(hook(n))
    full(batches[0][0][:4 // layout["dp"]])
    rank_fwd = sum(v // tp if n in split else v for n, v in per_conv.items())
    n_split = sum(full.get_submodule(n).weight.numel() for n in split)
    n_all = sum(p.numel() for p in full.parameters())
    chunk = T.ADAMW_CHUNK
    pad = lambda k: -(-k // chunk) * chunk          # noqa: E731
    for st in stats:
        assert st["params"] == n_all - n_split + n_split // tp
        assert st["arena"] == pad(n_all - n_split) + pad(n_split // tp)
        assert st["conv_macs"]["forward"] == rank_fwd
        assert st["conv_macs"]["weight_grad"] == rank_fwd
        assert st["gathered_bytes"] == {
            "tp": sum(moved[n] for n in split),
            "dp": layout["dp"] * st["arena"] * 4 if layout["dp"] > 1 else 0}
    assert rank_fwd < sum(per_conv.values())


def test_tp_1_keeps_the_one_device_step(mesh8):
    """A {"dp": 2, "tp": 1} trainer is the dp trainer: the same arena (no
    regions) and the one-arena K22 step, bit for bit."""
    spec = {"lr": 1e-3, "clip": 0.05, "weight_decay": 1e-4}
    batches = _batches(2, 4, seed=1)
    out = []
    for layout in ({"dp": 2}, {"dp": 2, "tp": 1}):
        tr = MeshTrainer(mesh8.view(layout), _model(), spec)
        try:
            out.append(([tr.step(x, y) for x, y in batches], tr.state(),
                        tr.rank_stats()[0]["arena"]))
        finally:
            tr.close()
    (l1, (p1, s1), a1), (l2, (p2, s2), a2) = out
    assert l1 == l2 and a1 == a2 == sum(p.numel()
                                        for p in _model().parameters())
    f1, f2 = _flatten(p1), _flatten(p2)
    assert all(np.array_equal(f1[k], f2[k]) for k in f1)
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(s1, s2))


# ------------------------------------------------- K22's tp lane

def test_k22_tp_lane_plain_equals_the_decomposition():
    """K22's tp lane (plain version) over 3 ranks' arenas (a replicated
    region of 5,000 elements and slices of 8,269, each padded to K22's
    chunk) equals the lane over the decomposed arena (the regions laid end
    to end) bit for bit, clipped and not; its norm is the whole
    gradient's within float32 summation; at tp 1 the lane is not taken
    and the step is the one-arena update, bit for bit."""
    rng = np.random.default_rng(2)
    C = T.ADAMW_CHUNK
    R, Sl, tp = 5000, 8269, 3
    pad = lambda k: -(-k // C) * C              # noqa: E731
    rep = [rng.standard_normal(R).astype(np.float32) for _ in range(4)]
    sl = [[rng.standard_normal(Sl).astype(np.float32) for _ in range(4)]
          for _ in range(tp)]

    def arena(regions):
        out = np.zeros(sum(pad(len(r)) for r in regions), np.float32)
        off = 0
        for r in regions:
            out[off:off + len(r)] = r
            off += pad(len(r))
        return torch.from_numpy(out)

    def state(regions_of):
        p, g, mu, nu = (arena(regions_of(i)) for i in range(4))
        return p, g, torch.abs(mu) * 1e-3, torch.abs(nu) * 1e-6

    kw = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, wd=1e-4)
    scal = dict(bc1=np.float32(0.19), bc2=np.float32(0.001999),
                neg_lr=np.float32(-1e-3))
    for max_norm in (1.0, 1e3):
        ranks = [state(lambda i, t=t: [rep[i], sl[t][i]]) for t in range(tp)]
        dec = state(lambda i: [rep[i]] + [sl[t][i] for t in range(tp)])
        sums = [T.adamw_partials_plain(r[1]) for r in ranks]
        rc = pad(R) // C
        gathered = torch.cat([sums[0][:rc]] + [s[rc:] for s in sums])
        for r in ranks:
            T.adamw_update(*r, clip=True, max_norm=max_norm, **kw, **scal,
                           tp_sums=lambda part: gathered)
        T.adamw_update(*dec, clip=True, max_norm=max_norm, **kw, **scal,
                       tp_sums=lambda part: part)
        norm = float(T.adamw_norm_plain(gathered))
        whole = np.sqrt(sum(float(np.sum(a.astype(np.float64) ** 2))
                            for a in [rep[1]] + [s[1] for s in sl]))
        assert abs(norm - whole) <= 1e-6 * whole
        assert (norm > max_norm) == (max_norm == 1.0)
        off = pad(R)
        for t, r in enumerate(ranks):
            for a, b in zip(r, dec):
                assert torch.equal(a[:off], b[:off])
                assert torch.equal(a[off:], b[off + t * pad(Sl):
                                              off + (t + 1) * pad(Sl)])
    one = list(state(lambda i: [rep[i]]))
    two = [a.clone() for a in one]
    T.adamw_launcher(*one, clip=True, max_norm=1.0, **kw)(**scal)
    T.adamw_update_plain(*two, clip=True, max_norm=1.0, **kw, **scal)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


# ------------------------------------------------- the lanes

class _Replay:
    """The JAX package's draws of train_on_crops by step, for the port's
    `_draw_batch` on the ranks (tests/test_torch_parallel.py's)."""

    def __init__(self, draws, seed):
        self.draws, self.seed = draws, seed

    def __call__(self, gen, n, batch_size):
        step = gen.initial_seed() - (self.seed + 1) * 1_000_003
        idx, flip, gains = self.draws[step]
        return (torch.from_numpy(idx.astype(np.int64)),
                torch.tensor([int(flip)], dtype=torch.uint8),
                torch.from_numpy(gains.reshape(batch_size, 3).copy()))


def _crops():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 255, (8, 32, 32, 3), dtype=np.uint8)
    lab = rng.integers(0, 2, (8, 32, 32)).astype(np.uint8)
    return rgb, lab, dict(widths=(4, 8), blocks_per_stage=1, steps=50,
                          batch_size=8, labels=["background", "plant"],
                          val_fraction=0.25)


def _no_mesh_lays_best_dp_tp(monkeypatch, mesh8):
    """use_mesh without a mesh on a machine of 8 ranks: the pool's view of
    the layout the trainer asks for, recorded."""
    from plant3dvision_tpu_torch.parallel import mesh as pm
    asked = []

    def make(axis_shapes, **kw):
        asked.append(dict(axis_shapes))
        return mesh8.view(axis_shapes)
    monkeypatch.setattr(pm, "default_ranks", lambda device: 8)
    monkeypatch.setattr(pm, "make_mesh", make)
    return asked


def test_train_on_crops_use_mesh_lays_best_dp_tp_and_matches_jax(
        mesh8, monkeypatch):
    """train_on_crops(use_mesh=True) without a mesh on 8 ranks lays the
    JAX package's best_dp_tp(8) = dp 2 x tp 4, and its float32 run from
    JAX's init with JAX's draws replayed matches the JAX trainer's
    use_mesh=True run on its 8 devices (the same layout): the loss curve
    within rtol 1e-3, atol 1e-4."""
    import jax
    import jax.numpy as jnp
    from plant3dvision_tpu.models import train_synth as jsynth
    from plant3dvision_tpu.models.unet import ResUNet
    from tests.test_torch_parallel import _jax_draws, _port_from_flax
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
    asked = _no_mesh_lays_best_dp_tp(monkeypatch, mesh8)
    _, _, ph = S.train_on_crops(rgb, lab, use_mesh=True, device="cpu",
                                dtype=torch.float32, **kw)
    assert asked == [best_dp_tp(8)] == [{"dp": 2, "tp": 4}]
    assert [h["step"] for h in ph] == [h["step"] for h in jh] == [25, 50]
    np.testing.assert_allclose([h["loss"] for h in ph],
                               [h["loss"] for h in jh], rtol=1e-3, atol=1e-4)


def test_train_on_crops_tp_resume_is_bit_identical(mesh8):
    """At dp 2 x tp 4, bfloat16 as it trains: a run checkpointed after
    chunk 0 and resumed from that state equals the uninterrupted run bit
    for bit (history and parameters); the state is the one-device
    layout (every kernel whole)."""
    from plant3dvision_tpu_torch.models.checkpoint import \
        training_state_from_npz_bytes
    rgb, lab, kw = _crops()
    kw["steps"] = 75
    m = mesh8.view(best_dp_tp(8))
    states = {}
    full, _, fh = S.train_on_crops(
        rgb, lab, use_mesh=True, mesh=m, device="cpu",
        checkpoint_every_chunks=1,
        on_checkpoint=lambda b, ch: states.setdefault(ch, b), **kw)
    res, _, rh = S.train_on_crops(rgb, lab, use_mesh=True, mesh=m,
                                  device="cpu", resume_state=states[0], **kw)
    assert [(h["step"], h["loss"]) for h in rh] == \
        [(h["step"], h["loss"]) for h in fh]
    for a, b in zip(full.parameters(), res.parameters()):
        assert torch.equal(a, b)
    params, leaves, _ = training_state_from_npz_bytes(states[1])
    want = {k: v.shape for k, v in _flatten(flax_params(full)).items()}
    assert {k: v.shape for k, v in _flatten(params).items()} == want


def test_train_use_mesh_lays_best_dp_tp(mesh8, monkeypatch):
    """models/train.py's train(use_mesh=True) without a mesh on 8 ranks
    lays best_dp_tp(8) with dp cut to the batch (dp 2 x tp 4 at batch 2),
    its per-epoch losses within rtol 1e-3 of one device (float32)."""
    from plant3dvision_tpu_torch.models.train import train
    rng = np.random.default_rng(1)
    images = rng.random((6, 16, 16, 3)).astype(np.float32)
    labels = (rng.random((6, 16, 16)) > 0.8).astype(np.int32)
    names = ["background", "plant"]
    kw = dict(widths=(8, 16), epochs=2, batch_size=2, device="cpu",
              dtype=torch.float32, log_every=100)
    _, _, h1 = train(images, labels, names, use_mesh=False, **kw)
    asked = _no_mesh_lays_best_dp_tp(monkeypatch, mesh8)
    _, _, h8 = train(images, labels, names, use_mesh=True, **kw)
    assert asked == [{"dp": 2, "tp": 4}]
    np.testing.assert_allclose(h8, h1, rtol=1e-3, atol=1e-4)
