"""Training in the port (models/optim.py, models/train.py,
models/train_synth.py, ops/training.py K20-K23) held to the JAX package on
the CPU, at a small size (ResUNet widths (8, 16), crops of 32).

The kernels' plain versions against optax and jax.grad: K21's loss and
gradient within 2e-6 relative (exp and log of XLA's and PyTorch's CPU
libraries; the same order of operations), K22 within 1e-6 of the
parameters' scale over several steps (the global norm sums in another
order; the schedule's cos and the bias corrections' pow within 1 ulp),
K20 and K23 equal. One float32 step from the JAX init carried across:
loss within 1e-5 relative, parameters within 1e-5. The two-chunk
train_on_crops run with JAX's stream replayed in float32: losses,
parameters and held-out IoU within the measured bars stated there. Whole
runs in bfloat16 (the convolutions round at other places in the two
frameworks): the losses and the parameter vector's norm within the bars
stated at each test. Every test runs on two CPU threads. The port's own resume
is bit-exact; training states and checkpoints cross between the packages
both ways.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from plant3dvision_tpu_torch.models import train as ptrain
from plant3dvision_tpu_torch.models import train_synth as psynth
from plant3dvision_tpu_torch.models.checkpoint import (
    flax_params, flax_template, state_dict_from_flax,
    training_state_from_npz_bytes)
from plant3dvision_tpu_torch.models.optim import AdamW, cosine_decay_schedule
from plant3dvision_tpu_torch.ops import training as T

WIDTHS = (8, 16)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two CPU threads for every test of this file, whatever other test
    modules set at import."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(params, widths=WIDTHS, bps=1, n_cls=3, dtype=torch.bfloat16,
                arch="resunet"):
    from plant3dvision_tpu_torch.models.checkpoint import model_from_config
    m = model_from_config({"arch": arch, "widths": list(widths),
                           "blocks_per_stage": bps,
                           "label_names": [str(i) for i in range(n_cls)]})
    m.dtype = dtype
    m.load_state_dict(state_dict_from_flax(_np(params)))
    return m


def _flat(params):
    from flax.traverse_util import flatten_dict
    return {k: np.asarray(v) for k, v in
            flatten_dict(_np(params), sep="/").items()}


def _assert_params_close(port_model, jparams, rel=None, atol=None):
    """The whole parameter vector within `rel` of the JAX one's norm (L2),
    and every parameter within `atol` where one is given."""
    pf = _flat(flax_params(port_model))
    jf = _flat(jparams)
    assert pf.keys() == jf.keys()
    d = np.sqrt(sum(((pf[k] - jf[k]) ** 2).sum() for k in pf))
    r = d / np.sqrt(sum((jf[k] ** 2).sum() for k in pf))
    if rel is not None:
        assert r <= rel, r
    if atol is not None:
        worst = max(np.abs(pf[k] - jf[k]).max() for k in pf)
        assert worst <= atol, worst


# ------------------------------------------------------------- K21

@pytest.mark.parametrize("ignore", [None, 255])
def test_cross_entropy_plain_equals_optax(ignore):
    """K21's plain forward and backward against optax's loss and
    jax.grad, on seeded logits (B, C, H, W) = (3, 6, 17, 13)."""
    rng = np.random.default_rng(3)
    B, C, H, W = 3, 6, 17, 13
    logits = (rng.standard_normal((B, C, H, W)) * 3).astype(np.float32)
    y = rng.integers(0, C, (B, H, W)).astype(np.uint8)
    if ignore is not None:
        y[rng.random((B, H, W)) < 0.3] = ignore
    w = (rng.random(C) + 0.2).astype(np.float32)

    def jloss(lg):
        lg = jnp.transpose(lg, (0, 2, 3, 1))
        yy = jnp.asarray(y, jnp.int32)
        if ignore is None:
            ce = optax.softmax_cross_entropy_with_integer_labels(lg, yy)
            return (ce * jnp.asarray(w)[yy]).mean()
        keep = (yy != ignore).astype(jnp.float32)
        ys = jnp.where(yy == ignore, 0, yy)
        ce = optax.softmax_cross_entropy_with_integer_labels(lg, ys)
        return (ce * jnp.asarray(w)[ys] * keep).sum() / jnp.maximum(
            keep.sum(), 1.0)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    loss = T.weighted_cross_entropy(lt, torch.from_numpy(y),
                                    torch.from_numpy(w), ignore)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-6)
    g = lt.grad.numpy()
    np.testing.assert_allclose(g, np.asarray(jg), rtol=0,
                               atol=2e-6 * np.abs(np.asarray(jg)).max())
    if ignore is not None:
        assert np.all(g.transpose(1, 0, 2, 3)[:, y == ignore] == 0)


@pytest.mark.parametrize("ignore", [None, 255])
def test_cross_entropy_label_past_classes_counts_as_last(ignore):
    """K21 counts a label >= C that is not ignored as class C - 1 (XLA
    clamps the JAX programs' `w[y]`): the loss and gradient equal those of
    the same labels with C - 1 in its place."""
    rng = np.random.default_rng(4)
    B, C, H, W = 2, 3, 9, 7
    logits = torch.from_numpy(rng.standard_normal((B, C, H, W))
                              .astype(np.float32))
    y = rng.integers(0, C + 4, (B, H, W)).astype(np.uint8)
    if ignore is not None:
        y[rng.random((B, H, W)) < 0.2] = ignore
    assert ((y >= C) & (y != 255)).any()
    w = torch.from_numpy((rng.random(C) + 0.2).astype(np.float32))
    clamped = np.where((y >= C) & (y != 255), C - 1, y).astype(np.uint8)
    out = []
    for lab in (y, clamped):
        lt = logits.clone().requires_grad_()
        loss = T.weighted_cross_entropy(lt, torch.from_numpy(lab), w, ignore)
        loss.backward()
        out.append((loss.detach(), lt.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def _ce_case(seed, ignore, ignored_share=0.3, shape=(3, 6, 17, 13)):
    """Seeded logits, labels (a share ignored) and class weights, and the
    JAX loss of train_synth's loss_fn over them as a function of the
    logits (NCHW)."""
    rng = np.random.default_rng(seed)
    B, C, H, W = shape
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    y = rng.integers(0, C, (B, H, W)).astype(np.uint8)
    if ignore is not None:
        y[rng.random((B, H, W)) < ignored_share] = ignore
    w = (rng.random(C) + 0.2).astype(np.float32)

    def jloss(lg):
        lg = jnp.transpose(lg, (0, 2, 3, 1))
        yy = jnp.asarray(y, jnp.int32)
        if ignore is None:
            ce = optax.softmax_cross_entropy_with_integer_labels(lg, yy)
            return (ce * jnp.asarray(w)[yy]).mean()
        keep = (yy != ignore).astype(jnp.float32)
        ys = jnp.where(yy == ignore, 0, yy)
        ce = optax.softmax_cross_entropy_with_integer_labels(lg, ys)
        return (ce * jnp.asarray(w)[ys] * keep).sum() / jnp.maximum(
            keep.sum(), 1.0)
    return logits, y, w, jloss


@pytest.mark.parametrize("ignore", [None, 255])
@pytest.mark.parametrize("outer", ["one", "0.7", "twice"])
def test_cross_entropy_gradient_at_any_incoming_gradient(outer, ignore):
    """The gradient through weighted_cross_entropy at incoming gradient
    1.0 (`loss.backward()`, the pass's own gradient on the card), 0.7
    (`loss.backward(0.7)`) and inside a sum (`(2 * loss).backward()`)
    against jax.grad of the same outer function: within 2e-6 of the
    largest gradient (XLA's and PyTorch's CPU exp and log; the same order
    of operations); ignored pixels' gradients zero."""
    logits, y, w, jloss = _ce_case(5, ignore)
    scale = {"one": 1.0, "0.7": 0.7, "twice": 2.0}[outer]
    jg = np.asarray(jax.jit(jax.grad(
        lambda lg: scale * jloss(lg)))(jnp.asarray(logits)))
    lt = torch.from_numpy(logits).requires_grad_()
    loss = T.weighted_cross_entropy(lt, torch.from_numpy(y),
                                    torch.from_numpy(w), ignore)
    if outer == "0.7":
        loss.backward(torch.tensor(0.7))
    elif outer == "twice":
        (2 * loss).backward()
    else:
        loss.backward()
    g = lt.grad.numpy()
    np.testing.assert_allclose(g, jg, rtol=0, atol=2e-6 * np.abs(jg).max())
    if ignore is not None:
        assert np.all(g.transpose(1, 0, 2, 3)[:, y == ignore] == 0)


def test_cross_entropy_every_pixel_ignored():
    """A batch whose every pixel is ignored: the denominator max(0, 1) =
    1, the loss 0 as JAX's, and a zero gradient."""
    logits, y, w, jloss = _ce_case(6, 255, ignored_share=1.1)
    assert np.all(y == 255)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    out = T.ce_forward(lt.detach(), torch.from_numpy(y),
                       torch.from_numpy(w), 255)
    assert float(out[1]) == 1.0 and float(out[0]) == 0.0 == float(jl)
    loss = T.weighted_cross_entropy(lt, torch.from_numpy(y),
                                    torch.from_numpy(w), 255)
    loss.backward()
    assert float(loss) == 0.0
    assert not lt.grad.any() and not np.asarray(jg).any()


@pytest.mark.parametrize("ignore", [None, 255])
def test_cross_entropy_under_no_grad(ignore):
    """Under torch.no_grad the loss equals the one with a gradient (and
    JAX's within 2e-6 relative), and no graph or gradient is kept."""
    logits, y, w, jloss = _ce_case(7, ignore)
    lt = torch.from_numpy(logits).requires_grad_()
    args = (torch.from_numpy(y), torch.from_numpy(w), ignore)
    with torch.no_grad():
        quiet = T.weighted_cross_entropy(lt, *args)
    assert quiet.grad_fn is None and not quiet.requires_grad
    loss = T.weighted_cross_entropy(lt, *args)
    assert loss.grad_fn is not None
    assert torch.equal(quiet, loss.detach())
    np.testing.assert_allclose(float(quiet),
                               float(jax.jit(jloss)(jnp.asarray(logits))),
                               rtol=2e-6)
    assert lt.grad is None


# ------------------------------------------------------------- K22

def _params_and_grads(rng, scale):
    from plant3dvision_tpu.models.unet import ResUNet
    m = ResUNet(n_classes=3, widths=WIDTHS, blocks_per_stage=1)
    params = _np(m.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                         .astype(np.float32), params)
    return params, grads


@pytest.mark.parametrize("mode", ["chain", "adamw"])
def test_adamw_plain_equals_optax(mode):
    """K22's plain version, driven by models/optim.AdamW, against
    optax.chain(clip_by_global_norm(1), adamw(cosine)) and against
    optax.adamw(lr) over 6 steps, gradients alternately above and below
    the clip threshold; the state leaves in optax's order."""
    rng = np.random.default_rng(1)
    params, _ = _params_and_grads(rng, 1.0)
    port = _port_model(params, dtype=torch.float32)
    if mode == "chain":
        sched = optax.cosine_decay_schedule(3e-3, 10, alpha=0.02)
        opt = optax.chain(optax.clip_by_global_norm(1.0),
                          optax.adamw(sched, weight_decay=1e-4))
        popt = AdamW(port, cosine_decay_schedule(3e-3, 10, alpha=0.02),
                     clip=1.0)
    else:
        opt = optax.adamw(3e-3)
        popt = AdamW(port, 3e-3)
    state = opt.init(params)
    scale = 0.0
    for step in range(6):
        # global norm ~ 13 (clipped) on even steps, ~ 0.01 on odd ones
        scale = 0.05 if step % 2 == 0 else 4e-5
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                             .astype(np.float32), params)
        updates, state = jax.jit(opt.update)(grads, state, params)
        params = _np(optax.apply_updates(params, updates))
        sd = state_dict_from_flax(grads)
        popt.zero_grad()
        for name, p in port.named_parameters():
            p.grad.copy_(sd[name])
        popt.step()
        _assert_params_close(port, params, atol=1e-6)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]
    mine = popt.state_leaves()
    assert len(leaves) == len(mine)
    assert [a.shape for a in leaves] == [a.shape for a in mine]
    assert leaves[0].dtype == mine[0].dtype == np.int32
    assert int(leaves[0]) == int(mine[0]) == 6
    for a, b in zip(leaves, mine):
        np.testing.assert_allclose(b, a, rtol=1e-5,
                                   atol=1e-6 * np.abs(a).max())


def test_cosine_schedule_equals_optax():
    """The learning-rate schedule at many counts, float32: within 4e-10
    absolute, 1.3e-7 of the initial rate (measured 2.3e-10: numpy's
    float32 cos against XLA's differ by an ulp, which 1 + cos amplifies
    near the end of the decay)."""
    js = optax.cosine_decay_schedule(3e-3, 3000, alpha=0.02)
    ps = cosine_decay_schedule(3e-3, 3000, alpha=0.02)
    counts = np.arange(0, 3200, 7)
    j = np.asarray(jax.vmap(js)(jnp.asarray(counts, jnp.int32)))
    p = np.asarray([ps(int(c)) for c in counts], np.float32)
    assert p.dtype == j.dtype == np.float32
    np.testing.assert_allclose(p, j, rtol=0, atol=4e-10)
    assert p[-1] == p[-2] == np.float32(3e-3 * 0.02)


# ------------------------------------------------------------- K20

def test_gather_batch_plain_equals_jax():
    """K20's plain version against run_chunk's gather/flip and loss_fn's
    `x / 255 * gains` and clip under jax.jit, both flips, gains that
    clip."""
    rng = np.random.default_rng(2)
    N, c, B = 7, 24, 5
    rgb = rng.integers(0, 256, (N, c, c, 3)).astype(np.uint8)
    lab = rng.integers(0, 6, (N, c, c)).astype(np.uint8)
    idx = rng.integers(0, N, B)
    gains = (1 + 0.6 * rng.standard_normal((B, 1, 1, 3))).astype(np.float32)

    @jax.jit
    def jgather(d_rgb, d_lab, idx, flip, gains):
        x = d_rgb[idx]
        y = d_lab[idx]
        x = jnp.where(flip, x[:, :, ::-1], x)
        y = jnp.where(flip, y[:, :, ::-1], y)
        xf = x.astype(jnp.float32) / 255.0 * gains
        return jnp.clip(xf, 0.0, 1.0), y

    for flip in (False, True):
        jx, jy = jgather(rgb, lab.astype(np.int32), idx, flip, gains)
        x, y = T.gather_batch(torch.from_numpy(rgb), torch.from_numpy(lab),
                              torch.from_numpy(idx),
                              torch.tensor([int(flip)], dtype=torch.uint8),
                              torch.from_numpy(gains.reshape(B, 3)))
        np.testing.assert_array_equal(x.numpy(),
                                      np.asarray(jx).transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


# ------------------------------------------------------------- K23

@pytest.mark.parametrize("ignore", [None, 255])
def test_iou_counts_plain_equals_val_metrics(ignore):
    """K23's plain version and iou_from_counts against val_metrics'
    formula on JAX logits (ties included; a class absent from the labels
    gives -1), and the prediction mode against the logits mode."""
    rng = np.random.default_rng(4)
    n, C, c = 3, 5, 16
    logits = np.round(rng.standard_normal((n, c, c, C)), 1).astype(np.float32)
    vlab = rng.integers(0, C - 1, (n, c, c)).astype(np.uint8)  # no class 4
    if ignore is not None:
        vlab[rng.random((n, c, c)) < 0.25] = ignore

    @jax.jit
    def val_metrics(logits, vlab):
        pred = jnp.argmax(logits, -1)
        keep = (vlab != ignore) if ignore is not None else \
            jnp.ones_like(vlab, bool)
        accs = []
        for li in range(C):
            sel = (vlab == li) & keep
            hit = (pred == li) & keep
            tp = jnp.sum(sel & hit)
            accs.append(jnp.where(sel.sum() > 0, tp / jnp.maximum(
                jnp.sum(sel | hit), 1), -1.0))
        return jnp.stack(accs)

    jiou = np.asarray(val_metrics(logits, vlab.astype(np.int32)))
    lt = torch.from_numpy(logits.transpose(0, 3, 1, 2).copy())
    counts = T.iou_counts(torch.from_numpy(vlab), C, logits=lt,
                          ignore_index=ignore)
    iou = T.iou_from_counts(counts)
    np.testing.assert_array_equal(iou, jiou)
    assert iou[C - 1] == -1.0
    pred = lt.argmax(1).to(torch.uint8)
    np.testing.assert_array_equal(
        T.iou_counts(torch.from_numpy(vlab), C, preds=pred,
                     ignore_index=ignore).numpy(), counts.numpy())


# ------------------------------------------------------------- one step

def test_one_step_equals_jax(monkeypatch):
    """One train.train step (a 4-image batch of 32x32, one epoch) from the
    JAX init carried across, in float32, against train.py's `step`
    (optax.adamw(3e-3)): the loss within 1e-5 relative, the gradients
    within 1e-5 of the largest, the parameters within 1e-5 where
    the gradient is clear of noise (Adam's first step is +-lr whatever the
    gradient's size) and within 2 lr elsewhere."""
    from plant3dvision_tpu.models.unet import ResUNet
    rng = np.random.default_rng(5)
    n, H, C = 4, 32, 3
    images = rng.random((n, H, H, 3)).astype(np.float32)
    labels = rng.integers(0, C, (n, H, H)).astype(np.int32)
    jm = ResUNet(n_classes=C, widths=WIDTHS, blocks_per_stage=1,
                 dtype=jnp.float32)
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, H, 3))))
    freq = np.bincount(labels.ravel(), minlength=C).astype(float)
    w = freq.sum() / np.maximum(freq, 1.0)
    w = jnp.asarray(w / w.sum() * C, jnp.float32)
    opt = optax.adamw(3e-3)

    @jax.jit
    def step(params, opt_state, x, y):
        def loss_fn(p):
            ce = optax.softmax_cross_entropy_with_integer_labels(
                jm.apply(p, x), y)
            return (ce * w[y]).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    order = np.random.default_rng(0).permutation(n)
    jp, _, jl = step(params, opt.init(params), images[order], labels[order])
    jgrads = jax.grad(lambda p: (optax.softmax_cross_entropy_with_integer_labels(
        jm.apply(p, images[order]), labels[order]) * w[labels[order]]).mean())(
            params)

    monkeypatch.setattr(ptrain, "_create_unet", lambda *a: _port_model(
        params, dtype=torch.float32, n_cls=C))
    model, _, hist = ptrain.train(images, labels, ["a", "b", "c"],
                                  widths=WIDTHS, epochs=1, batch_size=n,
                                  device="cpu", dtype=torch.float32)
    np.testing.assert_allclose(hist[0], float(jl), rtol=1e-5)
    # the gradients (left in the optimizer's arena) and the step
    grads = {}
    for (path, _), p in zip(flax_template(model).items(),
                            model.parameters()):
        g = p.grad.numpy()
        grads[path] = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
    jg, jpf, pf = _flat(jgrads), _flat(jp), _flat(flax_params(model))
    scale = max(np.abs(g).max() for g in jg.values())
    for k in jg:
        np.testing.assert_allclose(grads[k], jg[k], rtol=0, atol=1e-5 * scale)
        # Adam's first step moves a parameter by lr * g / |g|: where the
        # gradient is noise (a bias before a GroupNorm has none), either
        # sign is right
        clear = np.abs(jg[k]) > 1e-4 * scale
        np.testing.assert_allclose(pf[k][clear], jpf[k][clear], rtol=0,
                                   atol=1e-5)
        assert np.abs(pf[k] - jpf[k]).max() <= 2 * 3e-3 * (1 + 1e-3)


# ------------------------------------------------------------- whole runs

def _seg_set(n=6, H=32, C=3, seed=6):
    rng = np.random.default_rng(seed)
    labels = np.zeros((n, H, H), np.int32)
    images = np.full((n, H, H, 3), 0.2, np.float32)
    for i in range(n):
        r0, c0 = rng.integers(4, 20, 2)
        labels[i, r0:r0 + 8, c0:c0 + 4] = 1
        labels[i, r0 + 8:r0 + 12, c0:c0 + 10] = 2
    images[labels == 1] = (0.1, 0.7, 0.1)
    images[labels == 2] = (0.8, 0.2, 0.3)
    images += rng.normal(0, 0.03, images.shape).astype(np.float32)
    return np.clip(images, 0, 1), labels, ["background", "stem", "fruit"]


def test_train_two_epochs_equals_jax(monkeypatch):
    """train.train for 2 epochs of 6 images (batch 4: the numpy batch
    order, one padded batch an epoch) from JAX's init, in bfloat16,
    against the JAX package's train.train: the epoch losses within 2e-2
    relative and the parameter vector within 1.5e-2 of its norm
    (measured 5.6e-3 of the norm: the convolutions round to bf16 at other places in the two frameworks, and
    Adam turns a gradient that is only rounding noise, such as a bias's
    before a GroupNorm, into a step of +-lr either way)."""
    from plant3dvision_tpu.models import create_unet
    from plant3dvision_tpu.models.train import train as jtrain
    images, labels, names = _seg_set()
    jp, _, jh = jtrain(images, labels, names, widths=WIDTHS, epochs=2,
                       batch_size=4, use_mesh=False)
    _, init = create_unet(jax.random.PRNGKey(0), input_shape=(1, 32, 32, 3),
                          widths=WIDTHS, blocks_per_stage=1, n_classes=3)
    monkeypatch.setattr(ptrain, "_create_unet",
                        lambda *a: _port_model(init, n_cls=3))
    model, cfg, ph = ptrain.train(images, labels, names, widths=WIDTHS,
                                  epochs=2, batch_size=4, device="cpu")
    assert cfg == {"label_names": names, "widths": list(WIDTHS),
                   "blocks_per_stage": 1}
    np.testing.assert_allclose(ph, jh, rtol=2e-2)
    _assert_params_close(model, jp, rel=1.5e-2)


def _crop_set(n=12, c=32, seed=7, ignore=False):
    rng = np.random.default_rng(seed)
    lab = np.zeros((n, c, c), np.int8)
    for i in range(n):
        r0, c0 = rng.integers(2, c - 12, 2)
        lab[i, r0:r0 + 10, c0:c0 + 3] = 5
        lab[i, r0:r0 + 4, c0 + 3:c0 + 9] = 2
    rgb = np.full((n, c, c, 3), 40, np.uint8)
    rgb[lab == 5] = (60, 160, 50)
    rgb[lab == 2] = (190, 170, 60)
    rgb = np.clip(rgb + rng.integers(-10, 10, rgb.shape), 0, 255).astype(
        np.uint8)
    if ignore:
        lab = np.where(lab == 5, 1, np.where(lab == 2, 2, 0)).astype(np.uint8)
        lab[:, :2] = 255
    return rgb, lab


class JaxStream:
    """JAX's draws of train_on_crops (PRNGKey(seed + 1), split a chunk,
    split a step into idx/flip/gain keys, computed under jax.jit), replayed
    into the port's `_draw_batch` from chunk `start`."""

    def __init__(self, seed, n_chunks, batch_size, n_train, start=0):
        S = psynth.STEPS_PER_CALL

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
        self.draws = []
        for ch in range(n_chunks):
            key, sub = jax.random.split(key)
            idx, flip, gains = (np.asarray(a) for a in chunk(sub))
            if ch >= start:
                self.draws += [(idx[s], flip[s], gains[s]) for s in range(S)]
        self.i = 0

    def __call__(self, gen, n, batch_size):
        idx, flip, gains = self.draws[self.i]
        self.i += 1
        return (torch.from_numpy(idx.astype(np.int64)),
                torch.tensor([int(flip)], dtype=torch.uint8),
                torch.from_numpy(gains.reshape(batch_size, 3).copy()))


def _jax_init_for_crops(arch, seed, c, widths, bps, n_cls):
    from plant3dvision_tpu.models.train_synth import _make_model
    _, params = _make_model(arch, jax.random.PRNGKey(seed), c, widths, bps,
                            n_classes=n_cls)
    return _np(params)


def _replayed_runs(monkeypatch, ignore, dtype):
    """train_on_crops for 2 chunks (50 steps, batch 4) from JAX's init
    with JAX's random stream replayed, the convolutions in `dtype` in
    both packages, with or without ignored pixels (distillation's loss):
    ((port config, history, model), (JAX params, config, history))."""
    from plant3dvision_tpu.models import train_synth as jsynth
    from plant3dvision_tpu.models.unet import ResUNet
    rgb, lab = _crop_set(ignore=ignore)
    labels = ["background", "stem", "fruit"] if ignore else None
    kw = dict(widths=WIDTHS, blocks_per_stage=1, steps=50, batch_size=4,
              labels=labels, ignore_index=255 if ignore else None)
    if dtype == torch.float32:
        def make_f32(arch, key, crop, widths, bps, n_classes=None):
            m = ResUNet(n_classes=n_classes, widths=tuple(widths),
                        blocks_per_stage=bps, dtype=jnp.float32)
            return m, m.init(key, jnp.zeros((1, crop, crop, 3)))
        with monkeypatch.context() as m:
            m.setattr(jsynth, "_make_model", make_f32)
            jp, jcfg, jh = jsynth.train_on_crops(rgb, lab, use_mesh=False,
                                                 **kw)
    else:
        jp, jcfg, jh = jsynth.train_on_crops(rgb, lab, use_mesh=False, **kw)
    n_cls = 3 if ignore else 6
    init = _jax_init_for_crops("resunet", 0, 32, WIDTHS, 1, n_cls)
    monkeypatch.setattr(psynth, "_make_model", lambda *a, **k: _port_model(
        init, n_cls=n_cls, dtype=dtype))
    monkeypatch.setattr(psynth, "_draw_batch",
                        JaxStream(0, 2, 4, len(rgb) - 2))
    model, cfg, ph = psynth.train_on_crops(rgb, lab, device="cpu",
                                           dtype=dtype, **kw)
    assert [h["step"] for h in ph] == [h["step"] for h in jh] == [25, 50]
    assert cfg["val_iou"].keys() == jcfg["val_iou"].keys()
    assert {k: v for k, v in cfg.items() if k not in ("val_iou", "train")} \
        == {k: v for k, v in jcfg.items() if k not in ("val_iou", "train")}
    return (cfg, ph, model), (jp, jcfg, jh)


@pytest.mark.parametrize("ignore", [False, True])
def test_train_on_crops_replayed_equals_jax(monkeypatch, ignore):
    """The replayed two-chunk run (`_replayed_runs`) in bfloat16, as both
    packages train: the chunk losses within 3e-2 relative and the
    parameter vector within 0.1 of its norm (measured 1.1e-2 and 5.5e-2:
    the convolutions round to bf16 at other places in the two frameworks,
    and 50 Adam steps at lr 3e-3 grow that; the float32 test below holds
    the same runs tightly)."""
    (cfg, ph, model), (jp, jcfg, jh) = _replayed_runs(
        monkeypatch, ignore, torch.bfloat16)
    np.testing.assert_allclose([h["loss"] for h in ph],
                               [h["loss"] for h in jh], rtol=3e-2)
    _assert_params_close(model, jp, rel=0.1)


@pytest.mark.parametrize("ignore", [False, True])
def test_train_on_crops_replayed_float32_equals_jax(monkeypatch, ignore):
    """The replayed two-chunk run (`_replayed_runs`) in float32 in both
    packages: the chunk losses within 2e-3 relative, the parameter vector
    within 1e-2 of its norm, every parameter within 4e-2 (a parameter
    moves by up to 0.15 in 50 steps) and the held-out IoU within 3e-2
    (measured 5.4e-4, 3.4e-3, 1.3e-2 and 1.2e-2: summation orders differ
    in the convolutions' backward and Adam turns a gradient that is only
    rounding noise into a step of +-lr either way)."""
    (cfg, ph, model), (jp, jcfg, jh) = _replayed_runs(
        monkeypatch, ignore, torch.float32)
    np.testing.assert_allclose([h["loss"] for h in ph],
                               [h["loss"] for h in jh], rtol=2e-3)
    _assert_params_close(model, jp, rel=1e-2, atol=4e-2)
    for k in cfg["val_iou"]:
        assert abs(cfg["val_iou"][k] - jcfg["val_iou"][k]) <= 3e-2


def test_train_on_crops_resume_bit_exact():
    """The port's own stream: a run checkpointed after chunk 0 and resumed
    from that state equals the uninterrupted run bit for bit (parameters,
    optimizer state, history); the state's leaves are optax's layout."""
    rgb, lab = _crop_set()
    kw = dict(widths=WIDTHS, blocks_per_stage=1, steps=75, batch_size=4,
              device="cpu")
    states = {}
    full, _, fh = psynth.train_on_crops(
        rgb, lab, checkpoint_every_chunks=1,
        on_checkpoint=lambda b, ch: states.setdefault(ch, b), **kw)
    assert sorted(states) == [0, 1]
    res, _, rh = psynth.train_on_crops(rgb, lab, resume_state=states[0],
                                       **kw)
    assert [(h["step"], h["loss"]) for h in rh] == \
        [(h["step"], h["loss"]) for h in fh]
    for a, b in zip(full.parameters(), res.parameters()):
        assert torch.equal(a, b)
    _, leaves, meta = training_state_from_npz_bytes(states[1])
    assert meta["chunk"] == 1 and len(meta["prng_key"]) == 2
    # optax's chain(clip, adamw(cosine)): adam count, mu, nu, schedule count
    n_par = len(list(full.parameters()))
    assert len(leaves) == 2 * n_par + 2
    assert int(leaves[0]) == int(leaves[-1]) == 50


def test_train_resume_bit_exact_and_jax_state(monkeypatch):
    """train.train checkpointed every epoch: the port's resumed run equals
    its uninterrupted one bit for bit; a state written by the JAX
    package's train.train after epoch 0 resumes in the port (same batch
    order, numpy's), within the bf16 bars of the two-epoch test of the
    JAX package's own uninterrupted run."""
    from plant3dvision_tpu.models import create_unet
    from plant3dvision_tpu.models.train import train as jtrain
    images, labels, names = _seg_set()
    kw = dict(widths=WIDTHS, epochs=3, batch_size=4)
    states = {}
    full, _, fh = ptrain.train(images, labels, names, device="cpu",
                               checkpoint_every=1,
                               on_checkpoint=lambda b, e: states.setdefault(
                                   e, b), **kw)
    res, _, rh = ptrain.train(images, labels, names, device="cpu",
                              resume_state=states[1], **kw)
    assert rh == fh and len(fh) == 3
    for a, b in zip(full.parameters(), res.parameters()):
        assert torch.equal(a, b)

    jstates = {}
    jp, _, jh = jtrain(images, labels, names, use_mesh=False,
                       checkpoint_every=1,
                       on_checkpoint=lambda b, e: jstates.setdefault(e, b),
                       **kw)
    _, init = create_unet(jax.random.PRNGKey(0), input_shape=(1, 32, 32, 3),
                          widths=WIDTHS, blocks_per_stage=1, n_classes=3)
    monkeypatch.setattr(ptrain, "_create_unet",
                        lambda *a: _port_model(init, n_cls=3))
    model, _, ph = ptrain.train(images, labels, names, device="cpu",
                                resume_state=jstates[0], **kw)
    assert ph[0] == jh[0]                   # carried in the state's history
    np.testing.assert_allclose(ph, jh, rtol=2e-2)
    _assert_params_close(model, jp, rel=1.5e-2)


def test_jax_crop_state_resumes_in_port(monkeypatch):
    """A training state that the JAX package's train_on_crops wrote after
    chunk 0 resumes in the port with JAX's stream replayed from chunk 1:
    the result within the bf16 bars of the replayed two-chunk test."""
    from plant3dvision_tpu.models.train_synth import \
        train_on_crops as jtrain
    rgb, lab = _crop_set()
    kw = dict(widths=WIDTHS, blocks_per_stage=1, steps=50, batch_size=4)
    jstates = {}
    jp, _, jh = jtrain(rgb, lab, use_mesh=False, checkpoint_every_chunks=1,
                       on_checkpoint=lambda b, c: jstates.setdefault(c, b),
                       **kw)
    monkeypatch.setattr(psynth, "_draw_batch",
                        JaxStream(0, 2, 4, len(rgb) - 2, start=1))
    model, _, ph = psynth.train_on_crops(rgb, lab, device="cpu",
                                         resume_state=jstates[0], **kw)
    assert ph[0] == jh[0]
    np.testing.assert_allclose(ph[1]["loss"], jh[1]["loss"], rtol=3e-2)
    _assert_params_close(model, jp, rel=0.1)


@pytest.mark.parametrize("arch", ["resunet", "tpusegnet"])
def test_checkpoints_cross_both_ways(tmp_path, arch):
    """The port's NPZ (float16, as train_synth.main writes it) loaded by
    the JAX package's load_model gives JAX's forward the port's weights
    exactly; a JAX-written NPZ loaded by the port's load_model gives back
    the same weights."""
    from plant3dvision_tpu.fsdb import FSDB as JFSDB
    from plant3dvision_tpu.models.checkpoint import load_model as jload
    from plant3dvision_tpu.models.checkpoint import \
        params_to_npz_bytes as jbytes
    from plant3dvision_tpu_torch.fsdb import FSDB
    from plant3dvision_tpu_torch.models.checkpoint import (
        load_model, params_to_npz_bytes, save_model)

    widths = WIDTHS if arch == "resunet" else (16, 32)
    model = psynth._make_model(arch, 3, widths, 1, n_classes=6)
    cfg = {"label_names": psynth.LABELS, "widths": list(widths),
           "arch": arch, "blocks_per_stage": 1}
    (tmp_path / "romidb").touch()
    db = FSDB(tmp_path)
    db.connect(unsafe=True)
    fs = db.get_scan("models", create=True).get_fileset("models",
                                                        create=True)
    save_model(fs.get_file("port", create=True),
               psynth._half(flax_params(model)), cfg)
    f = fs.get_file("jax", create=True)
    jtree = _np(flax_params(model))
    f.write_raw(jbytes(jtree, cfg), "npz")
    f.set_metadata("model_config", cfg)
    db.disconnect()

    jdb = JFSDB(tmp_path)
    jdb.connect(unsafe=True)
    _, jparams, jcfg = jload(jdb.get_scan("models").get_fileset("models")
                             .get_file("port"))
    jdb.disconnect()
    assert jcfg == cfg
    want = _flat(psynth._half(flax_params(model)))
    got = _flat(jparams)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].astype(np.float32))

    db.connect(unsafe=True)
    pm, pcfg = load_model(db.get_scan("models").get_fileset("models")
                          .get_file("jax"))
    db.disconnect()
    assert pcfg == cfg
    for a, b in zip(pm.parameters(), model.parameters()):
        assert torch.equal(a, b)
    assert json.loads(json.dumps(pcfg)) == cfg
    assert params_to_npz_bytes(flax_params(model), cfg)


def test_resolve_training_config_equals_jax():
    """resolve_training_config: defaults, configs/training_seg.toml's
    [Training] section (learning_rate -> lr) and CLI overrides."""
    from pathlib import Path

    from plant3dvision_tpu.models.train import \
        resolve_training_config as jres
    cfg = str(Path(__file__).resolve().parent.parent / "configs"
              / "training_seg.toml")
    for path, cli in [(None, {}), (cfg, {}),
                      (cfg, {"epochs": 3, "lr": None, "widths": "8,16"})]:
        assert ptrain.resolve_training_config(path, cli) == jres(path, cli)


def test_init_like_flax_statistics():
    """The port's flax-like init: kernels truncated at 2 standard
    deviations with flax's fan-in scale, zero biases, unit scales; the
    same seed gives the same weights."""
    m = psynth._make_model("resunet", 0, (24, 48), 2, n_classes=6)
    m2 = psynth._make_model("resunet", 0, (24, 48), 2, n_classes=6)
    for (name, p), p2 in zip(m.named_parameters(), m2.parameters()):
        assert torch.equal(p, p2)
        if name.endswith("bias"):
            assert not p.any()
        elif p.ndim == 4:
            std = np.sqrt(1.0 / (p.shape[1] * p.shape[2] * p.shape[3])) \
                / 0.87962566103423978
            assert p.abs().max() <= 2 * std * (1 + 1e-6)
            if p.numel() > 5000:
                assert abs(float(p.std()) / std - 0.8796) < 0.05
        else:
            assert torch.all(p == 1)
