"""The port's int8 serving lane (models/quant.py; Segmentation2D's
conv_mode="int8") against the JAX package's (plant3dvision_tpu/models/
quant.py), on the CPU.

Tolerances:
- one convolution: `int8_conv_plain` is bit-equal to the jitted JAX hook
  `int8_conv_general_dilated` (the int32 sums are exact; the scales,
  rounding and dequantisation repeat XLA's arithmetic, module docstring of
  models/quant.py). The hook run eagerly, op by op, forms sx * sw[k]
  without XLA's reassociation and differs by an ulp on most outputs: the
  reference is the program the model compiles.
- a convolution with its bias (flax `nn.Conv` with the hook, jitted):
  bit-equal (XLA contracts the bias add into an fma; so does the port).
- the whole net (`segmentation_inference(conv_mode="int8")`, the JAX
  test's 192x192 noise image, tests/unit/test_models.py:136): the dynamic
  per-tensor scale turns each ulp the two frameworks' GroupNorm and
  resize sums differ by into a quantisation step for every value near a
  rounding edge, and the steps compound over the net's ~30 convolutions
  (layer by layer: the stem bit-equal, the next conv within 1.6e-3 of its
  largest output, the logits within 0.19). Measured on the committed
  checkpoints, port against JAX, argmax agreement / mean |dp|:
  unet_seg 0.9786 / 0.0073 (bfloat16 parameters), 0.9899 / 0.0034
  (compute_dtype float32); tpusegnet_seg 0.9991 / 0.00037 and
  0.9983 / 0.00066. Held to argmax >= 0.97 and mean < 0.01 (unet_seg),
  >= 0.995 and < 0.002 (tpusegnet_seg): tighter than the JAX test's own
  bar (> 0.95, < 0.02), which the port's int8 lane against its own bf16
  lane meets as the JAX package's does (unet_seg 0.9832 / 0.0056 in both).
- Segmentation2D(conv_mode="int8") with the committed ResUNet on a 3-view
  photo scan: the same fileset, PNG ids and metadata; the PNG levels
  (probability x 255) held to unet_seg's bars (measured in the test's
  docstring).
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from plant3dvision_tpu.models.quant import int8_conv_general_dilated

from plant3dvision_tpu_torch.models import checkpoint, quant
from plant3dvision_tpu_torch.models.segnet import Conv, _same_pads
from plant3dvision_tpu_torch.models.unet import segmentation_inference
from plant3dvision_tpu_torch.models.zoo import (DEFAULT_CHECKPOINT,
                                                TPUSEGNET_CHECKPOINT)

torch.set_num_threads(1)

DN = ("NHWC", "HWIO", "NHWC")


def _jax_conv(x, w, stride):
    """The JAX hook as flax calls it inside a jitted model (SAME pads)."""
    f = jax.jit(lambda a, b: int8_conv_general_dilated(
        a, b, (stride, stride), "SAME", dimension_numbers=DN))
    return np.asarray(f(x, w)).transpose(0, 3, 1, 2)


def _both(x, w, dtype):
    """numpy NHWC x and HWIO w -> (JAX arrays, port NCHW/OIHW tensors) in
    `dtype` ("float32" or "bfloat16")."""
    xj, wj = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)
    wt = torch.from_numpy(np.ascontiguousarray(w)).permute(3, 2, 0, 1)
    return xj, wj, xt.to(tdt), wt.to(tdt)


def _port_conv(xt, w, stride, k, bias=None):
    pads = (_same_pads(xt.shape[2], k, stride), _same_pads(xt.shape[3], k,
                                                           stride))
    return quant.int8_conv_plain(xt, w, bias, stride, pads)


#: the nets' convolution kinds: (kernel, stride, cin, cout)
KINDS = [(7, 2, 3, 24), (3, 1, 24, 24), (3, 2, 24, 48), (1, 2, 24, 48)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hw", [(17, 15), (16, 18)])
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: "k%ds%dc%d" % k[:3])
def test_int8_conv_plain_is_bit_equal_to_jax(kind, hw, dtype):
    k, s, cin, cout = kind
    rng = np.random.default_rng(k * 100 + s * 10 + hw[0])
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
    xj, wj, xt, wt = _both(x, w, dtype)
    ref = _jax_conv(xj, wj, s)
    got = _port_conv(xt, wt, s, k).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    # the wrapper on a CPU tensor is the plain version
    pads = (_same_pads(hw[0], k, s), _same_pads(hw[1], k, s))
    np.testing.assert_array_equal(quant.int8_conv(xt, wt, None, s, pads),
                                  got)


def test_int8_conv_rounds_half_to_even():
    """max |x| = 127 makes sx = max * f32(1/127) exactly 1, so x/sx lands on
    k + 0.5: round half to even (2.5 -> 2, -3.5 -> -4, 0.5 -> 0), as JAX."""
    x = np.zeros((1, 3, 4, 4), np.float32)
    x[0, 0, 0] = [127.0, 2.5, -3.5, 0.5]
    x[0, 1, 1] = [1.5, -0.5, 126.5, -126.5]
    w = np.zeros((1, 1, 4, 4), np.float32)
    np.fill_diagonal(w[0, 0], 1.0)                # a 1x1 identity
    xj, wj, xt, wt = _both(x, w, "float32")
    got = _port_conv(xt, wt, 1, 1).numpy()
    np.testing.assert_array_equal(got, _jax_conv(xj, wj, 1))
    q, amax = quant._quantize_plain(xt, quant.X_FLOOR, per_group=False)
    assert float(amax) == 127.0
    np.testing.assert_array_equal(q[0, :, 0, 0], [127, 2, -4, 0])
    np.testing.assert_array_equal(q[0, :, 1, 1], [2, -0, 126, -126])


def test_int8_conv_floors_its_scales():
    """An all-zero activation (the 1e-8 floor) and a weight with an all-zero
    output channel (the 1e-12 floor): zeros where JAX gives zeros."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 5, 4)).astype(np.float32)
    w[..., 2] = 0.0
    x = np.zeros((1, 9, 8, 5), np.float32)
    xj, wj, xt, wt = _both(x, w, "bfloat16")
    got = _port_conv(xt, wt, 1, 3).numpy()
    np.testing.assert_array_equal(got, _jax_conv(xj, wj, 1))
    assert not got.any()
    x = rng.standard_normal((1, 9, 8, 5)).astype(np.float32)
    xj, wj, xt, wt = _both(x, w, "bfloat16")
    got = _port_conv(xt, wt, 1, 3).numpy()
    np.testing.assert_array_equal(got, _jax_conv(xj, wj, 1))
    assert not got[:, 2].any() and got[:, [0, 1, 3]].any()
    qw = quant.quantize_weight(wt)
    assert float(qw.amax[2]) == 0.0 and not qw.q[2].any()
    assert qw.q.shape == (4, 3, 3, 8) and not qw.q[..., 5:].any()


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: "k%ds%dc%d" % k[:3])
def test_int8_conv_with_bias_is_bit_equal_to_flax_conv(kind):
    """flax `nn.Conv(dtype=bfloat16, conv_general_dilated=hook)` with
    bfloat16 parameters, jitted, against the port's Conv in the int8 lane:
    the bias add fused into the dequantisation (an fma) in both."""
    k, s, cin, cout = kind
    rng = np.random.default_rng(k + s)
    x = rng.standard_normal((2, 16, 13, cin)).astype(np.float32)
    layer = nn.Conv(cout, (k, k), strides=(s, s), padding="SAME",
                    dtype=jnp.bfloat16,
                    conv_general_dilated=int8_conv_general_dilated)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: (a + 0.05).astype(jnp.bfloat16), params)
    ref = np.asarray(jax.jit(layer.apply)(params, jnp.asarray(x)))
    conv = Conv(cin, cout, k, s)
    p = params["params"]
    conv.weight.data = torch.from_numpy(
        np.array(p["kernel"].astype(jnp.float32))).permute(3, 2, 0, 1)
    conv.bias.data = torch.from_numpy(np.array(p["bias"].astype(
        jnp.float32)))
    conv = conv.to(torch.bfloat16)
    conv.int8 = quant.quantize_weight(conv.weight.detach())
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


# -- the whole net ----------------------------------------------------------------

NOISE = (np.random.RandomState(0).rand(192, 192, 3) * 255).astype(np.uint8)
#: (argmax agreement >=, mean |dp| <) of the port against JAX (docstring)
NET_BARS = {"unet_seg": (0.97, 0.01), "tpusegnet_seg": (0.995, 0.002)}


@pytest.fixture(scope="module", params=[DEFAULT_CHECKPOINT,
                                        TPUSEGNET_CHECKPOINT],
                ids=["unet_seg", "tpusegnet_seg"])
def net(request):
    """(name, JAX model, JAX params, port model) of a committed checkpoint,
    each upcast to float32 by its own loader."""
    from plant3dvision_tpu.models.checkpoint import (_upcast_f16,
                                                     model_from_config,
                                                     params_from_npz_bytes)
    data = request.param.read_bytes()
    jparams, config = params_from_npz_bytes(data)
    pparams, _ = checkpoint.params_from_npz_bytes(data)
    pm = checkpoint.model_from_config(config)
    pm.load_state_dict(checkpoint.state_dict_from_flax(
        checkpoint._upcast_f16(pparams)))
    return (request.param.stem, model_from_config(config),
            _upcast_f16(jparams), pm)


def _agreement(a, b):
    return float((a.argmax(1) == b.argmax(1)).mean()), float(
        np.abs(a - b).mean())


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_segmentation_inference_int8_matches_jax(net, compute_dtype):
    from plant3dvision_tpu.models.unet import segmentation_inference as jsi
    name, jmodel, jparams, pmodel = net
    kw = dict(batch_size=1, output_dtype="float32",
              compute_dtype=compute_dtype)
    ref = jsi(jmodel, jparams, NOISE[None], conv_mode="int8",
              data_parallel=False, **kw)
    got = segmentation_inference(pmodel, NOISE[None], conv_mode="int8",
                                 device="cpu", **kw).numpy()
    assert got.shape == ref.shape == (1, 6, 192, 192)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-4)
    agree, mean = _agreement(got, ref)
    bar_agree, bar_mean = NET_BARS[name]
    assert agree >= bar_agree and mean < bar_mean, (agree, mean)
    # the lane leaves the model as it found it
    assert all(c.int8 is None for c in quant.compute_convs(pmodel))


def test_int8_lane_against_the_bf16_lane(net):
    """The JAX package's own guard (tests/unit/test_models.py:136), on the
    port alone: int8 against bf16 on out-of-domain noise."""
    name, _, _, pmodel = net
    kw = dict(batch_size=1, output_dtype="float32", device="cpu")
    pf = segmentation_inference(pmodel, NOISE[None], conv_mode="bf16",
                                **kw).numpy()
    pi = segmentation_inference(pmodel, NOISE[None], conv_mode="int8",
                                **kw).numpy()
    agree, mean = _agreement(pi, pf)
    assert agree > 0.95, f"int8 argmax agreement {agree:.4f}"
    assert mean < 0.02
    assert not np.array_equal(pi, pf)            # the lane really ran


def test_int8_lane_quantises_every_conv_but_the_head(net):
    _, _, _, pmodel = net
    convs = quant.compute_convs(pmodel)
    assert pmodel.Conv_1 not in convs
    assert len(convs) == sum(isinstance(m, Conv) for m in pmodel.modules()) - 1
    with quant.int8_lane(pmodel):
        assert all(isinstance(c.int8, quant.QuantizedWeight) for c in convs)
        assert pmodel.Conv_1.int8 is None
    assert all(c.int8 is None for c in convs)


# -- Segmentation2D ----------------------------------------------------------------

SEG_CFG = {
    "ModelFilesetExists": {"scan_id": "models"},
    "Segmentation2D": {"upstream_task": "ImagesFilesetExists",
                       "query": {"channel": "rgb"}, "Sx": 96, "Sy": 96,
                       "binarize": False, "dilation": 0, "batch_size": 2,
                       "conv_mode": "int8"},
}


def _seg_outputs(scan, report):
    from plant3dvision_tpu.fsdb import io as jio
    fs = scan.get_fileset(report["Segmentation2D"]["fileset"])
    return fs.id, [(f.id, jio.read_image(f), f.get_metadata())
                   for f in fs.get_files()]


def test_segmentation2d_int8_matches_jax(temp_db):
    """Segmentation2D(conv_mode="int8") with the committed ResUNet on a
    3-view 120x110 photo scan cropped to 96x96, through both packages: the
    same fileset, PNG ids and metadata; the per-label probability PNGs
    agree as the net's probabilities do (argmax over the labels >= 0.97,
    mean |level| / 255 < 0.01; measured 0.9986 / 0.00041: the photos are
    in the nets' domain, the noise image is not)."""
    from plant3dvision_tpu.models.zoo import install_checkpoint as jinstall
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.runtime import run_task as jax_run_task
    from plant3dvision_tpu.synth_photo import (ProceduralArabidopsis,
                                               generate_photo_scan)
    from plant3dvision_tpu_torch.runtime import RunContext, run_task

    generate_photo_scan(temp_db, "s", n_views=3, width=120, height=110,
                        plant=ProceduralArabidopsis(n_fruits=4, seed=2),
                        with_gt_masks=False)
    jinstall(temp_db)
    jctx = JaxRunContext(temp_db, "s", SEG_CFG)
    jid, jout = _seg_outputs(jctx.scan, jax_run_task(jctx, "Segmentation2D",
                                                     report=False))
    jctx.scan.delete_fileset(jid)
    ctx = RunContext(temp_db, "s", SEG_CFG, device="cpu")
    pid, out = _seg_outputs(ctx.scan, run_task(ctx, "Segmentation2D",
                                               report=False))
    assert pid == jid
    assert [o[0] for o in out] == [o[0] for o in jout]
    assert len(out) == 3 * 6
    for (fid, _, md), (_, _, jmd) in zip(out, jout):
        assert md == jmd, fid
    got = np.stack([o[1] for o in out]).astype(np.float32).reshape(
        3, 6, 96, 96) / 255
    ref = np.stack([o[1] for o in jout]).astype(np.float32).reshape(
        3, 6, 96, 96) / 255
    agree, mean = _agreement(got, ref)
    assert agree >= 0.97 and mean < 0.01, (agree, mean)


# -- K16's conv plan: the packed weights and the kernel's depth order ----------

#: the conv kernel's output pixels a block for each tile configuration
#: (int8conv.cu: TM = (4 / WN) * MF * 16 of launch_conv<MF, NF, WN>)
CONV_TM = (256, 128, 128, 64, 64)


def _pixel_tile(tm, oh):
    """int8conv.cu:launch_conv's TR x TC pixel tile of TM pixels."""
    tr = 4 if tm >= 128 else tm // 32
    if tr > oh:
        tr = 1 if oh < 2 else (2 if oh < 4 else tr)
    return tr, tm // tr


def _staged_pixel_stride(cc, stride):
    """int8conv.cu:launch_conv's CS: CC, or a little more so that the 8
    pixels of a fragment's rows spread over the banks."""
    for cs in range(cc, cc + 16, 4):
        w = stride * (cs // 4)
        if w % 2 == 1 or w % 8 == 4:
            return cs
    return cc


def _emulate_k16(xt, qw, stride, pads):
    """K16's conv as the kernel computes it, in numpy: tiles of TR x TC
    output pixels, the activation quantised per staged chunk of CC channels
    into (SR, TW, CS) rows with its pads as zeros, each A word read at the
    pixel's offset (row * stride * TW + column * stride) * CS plus the depth
    word's (tap row, tap column, channel) offset, the products against
    `pack_weight`'s (n_blocks, nch, NT, DC) slices summed over the chunks,
    then the kernel's epilogue (no bias). Returns (B, K, OH, OW) float32."""
    K, kh, kw, cp = qw.q.shape
    plan = quant.conv_plan(K, kh, kw, cp)
    packed = quant.pack_weight(qw.q, plan).numpy().astype(np.int64)
    assert packed.shape == (plan.n_blocks, plan.nch, plan.nt, plan.dc)
    xq, xmax = quant._quantize_plain(xt, quant.X_FLOOR, per_group=False)
    xq = xq.numpy().astype(np.int64)
    B, C, H, W = xq.shape
    (pt, pb), (pl, pr) = pads
    OH = quant.out_size(H, kh, stride, pt, pb)
    OW = quant.out_size(W, kw, stride, pl, pr)
    TM, CC, taps = CONV_TM[plan.cfg], plan.cc, kh * kw
    TR, TC = _pixel_tile(TM, OH)
    SR, TW = (TR - 1) * stride + kh, (TC - 1) * stride + kw
    CS = _staged_pixel_stride(CC, stride)
    d = np.arange(plan.dc)
    tap, c = d // CC, d % CC
    doff = np.where(tap < taps, ((tap // kw) * TW + tap % kw) * CS + c, d % 4)
    m = np.arange(TM)
    base = ((m // TC) * stride * TW + (m % TC) * stride) * CS
    rows = base[:, None] + doff[None]                           # (TM, DC)
    acc = np.zeros((B, plan.n_blocks * plan.nt, OH + TR, OW + TC), np.int64)
    for b in range(B):
        for oy0 in range(0, OH, TR):
            for ox0 in range(0, OW, TC):
                for ch in range(plan.nch):
                    tile = np.zeros((SR, TW, CS), np.int64)
                    for sy in range(SR):
                        y = oy0 * stride - pt + sy
                        if not 0 <= y < H:
                            continue
                        xs = ox0 * stride - pl + np.arange(TW)
                        ok = (xs >= 0) & (xs < W)
                        cs = ch * CC + np.arange(CC)
                        okc = cs < C
                        sub = xq[b][cs[okc]][:, y, xs[ok]]
                        tile[sy, np.nonzero(ok)[0][:, None],
                             np.nonzero(okc)[0][None]] = sub.T
                    A = tile.reshape(-1)[rows]                  # (TM, DC)
                    for nb in range(plan.n_blocks):
                        part = A @ packed[nb, ch].T             # (TM, NT)
                        sl = slice(nb * plan.nt, (nb + 1) * plan.nt)
                        acc[b, sl, oy0:oy0 + TR, ox0:ox0 + TC] += \
                            part.T.reshape(-1, TR, TC)
    acc = acc[:, :, :OH, :OW]
    acc = torch.from_numpy(acc[:, :K].astype(np.int32))
    sx = torch.clamp(xmax, min=quant.X_FLOOR) * quant.INV127_SQ
    scale = (torch.clamp(qw.amax, min=quant.W_FLOOR) * sx).view(1, -1, 1, 1)
    return acc.to(torch.float32) * scale


#: (kernel, stride, cin, cout, hw): the stem from 3 channels, 1x1 stride
#: 2, Cout 12, a Cin that takes two chunks, 512 channels (32 chunks at NT
#: 256), Cout above 256 (two blocks of output channels), ragged tiles
K16_PLANS = [(7, 2, 3, 24, (19, 23)), (1, 2, 24, 48, (9, 14)),
             (3, 1, 12, 12, (7, 9)), (3, 2, 48, 96, (8, 11)),
             (3, 1, 144, 20, (5, 6)), (3, 1, 512, 256, (4, 5)),
             (1, 1, 72, 300, (3, 7))]


@pytest.mark.parametrize("kind", K16_PLANS,
                         ids=lambda k: "k%ds%dc%dk%d" % k[:4])
def test_k16_packed_weights_hold_the_jax_conv(kind):
    """`pack_weight`'s layout and the kernel's depth order (chunks of CC
    channels x kh*kw taps, pixel offsets into the staged rows), emulated in
    numpy, give the JAX hook's output bit for bit: the plan loses, repeats
    and misplaces no product."""
    k, s, cin, cout, hw = kind
    rng = np.random.default_rng(cin + cout)
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
    xj, wj, xt, wt = _both(x, w, "bfloat16")
    pads = (_same_pads(hw[0], k, s), _same_pads(hw[1], k, s))
    qw = quant.quantize_weight_plain(wt)
    got = _emulate_k16(xt, qw, s, pads).numpy()
    np.testing.assert_array_equal(got, _jax_conv(xj, wj, s))


def test_k16_plan_fits_the_kernel():
    """Every compute conv of the committed nets and the on-card tests'
    kinds: the chunks cover Cp, each chunk's depth is a multiple of 32 that
    holds kh*kw*CC, and the weight buffers stay within the budget."""
    kinds = {(k, cin, cout) for k, _, cin, cout, _ in K16_PLANS}
    for path in (DEFAULT_CHECKPOINT, TPUSEGNET_CHECKPOINT):
        params, config = checkpoint.params_from_npz_bytes(path.read_bytes())
        m = checkpoint.model_from_config(config)
        kinds |= {(c.k, c.weight.shape[1], c.weight.shape[0])
                  for c in quant.compute_convs(m)}
    kinds |= {(3, 1024, 16), (3, 512, 20)}
    for k, cin, cout in sorted(kinds):
        cp = quant._cp(cin)
        p = quant.conv_plan(cout, k, k, cp)
        assert p.nt >= min(cout, 256) and p.n_blocks * p.nt >= cout
        assert p.cc % 4 == 0 and p.nch * p.cc >= cp
        assert (p.nch - 1) * p.cc < cp                   # no empty chunk
        assert p.dc % 32 == 0 and k * k * p.cc <= p.dc < k * k * p.cc + 32
        assert 2 * p.nt * (p.dc + 16) <= 96 << 10 or p.dc == -(-k * k * 4
                                                             // 32) * 32


def _quantize_r(v, s):
    """int8conv.cu:quantize_r in float32 (fma_f32 is a correctly rounded
    fused multiply-add): q0 = x * RN(1/s), the residual's correction, then
    + 1.5 * 2^23 rounds half to even."""
    from plant3dvision_tpu_torch.ops.carving import fma_f32
    r = torch.tensor(1.0, dtype=torch.float32) / s
    q0 = v * r
    q1 = fma_f32(fma_f32(-q0, s.expand_as(q0), v), r.expand_as(q0), q0)
    magic = torch.tensor(12582912.0, dtype=torch.float32)
    return ((q1 + magic) - magic).clamp(-127, 127)


def test_k16_staging_quantises_exactly_without_a_division():
    """The conv's staging quantises x as round(x / s) clipped to +-127
    without dividing (int8conv.cu:quantize_r): equal to the division for
    every finite bf16 value within each of 300 random absmaxes and 6 edge
    ones (127, 1, the 1e-8 floor, bf16's largest, ...), and for float32
    values within a few ulps of each (k + 1/2) * s, where the double
    rounding would show."""
    rng = np.random.default_rng(0)
    bf = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).float()
    bf = bf[torch.isfinite(bf)]
    amaxes = [np.float32(rng.uniform(1, 2) * 2.0 ** rng.integers(-30, 30))
              for _ in range(300)]
    amaxes += [np.float32(a) for a in (127.0, 1.0, 1e-8, 3.3895314e38, 0.5,
                                       2.0 ** -100)]
    for i, amax in enumerate(amaxes):
        amax = torch.tensor(amax)
        s = torch.clamp(amax, min=quant.X_FLOOR) * quant.INV127
        v = bf[bf.abs() <= amax]
        if i % 10 == 0:
            k = torch.from_numpy(rng.integers(-127, 127, 20000)).float()
            near = ((k + 0.5) * s.double()).float().view(torch.int32)
            near += torch.from_numpy(rng.integers(-3, 4, 20000)).int()
            near = near.view(torch.float32)
            v = torch.cat([v, near[near.abs() <= amax]])
        want = torch.round(v / s).clamp(-127, 127)
        assert torch.equal(_quantize_r(v, s), want), float(amax)


# -- K16's weight quantise: a model's weights in one launch -------------------------

POISON = 0x5A


def _emulate_quantize_weights(ws, desc, size):
    """int8conv.cu:quantize_weights_kernel in numpy, from the descriptor
    table the wrapper hands it: a block a row (weight, output channel k;
    the packed layout's rows past K are blocks of their own), the row's
    absmax, then its packed words (4 depth bytes of a chunk) at the
    kernel's offsets. Bytes no block writes keep POISON."""
    arena = np.full(size, POISON, np.uint8)
    for w, d in zip(ws, desc):
        (_, p_off, a_off, _, K, C, taps, NT, CC, nch,
         DC) = (int(v) for v in d[:11])
        wf = w.float().numpy().reshape(K, C, taps)
        m = np.abs(wf).max(axis=(1, 2))
        s = (np.maximum(m, np.float32(quant.W_FLOOR))
             * np.float32(quant.INV127)).astype(np.float32)
        q = np.clip(np.rint(wf / s[:, None, None]), -127, 127)
        qpad = np.zeros((K, taps, nch * CC), np.int8)   # (k, tap, channel)
        qpad[:, :, :C] = q.transpose(0, 2, 1)
        arena[a_off:a_off + 4 * K] = m.astype(np.float32).view(np.uint8)
        # packed: row k (past K: zeros), word e = (ch, d4 / 4)
        dq = DC // 4
        k, e, j = np.meshgrid(np.arange(-(-K // NT) * NT),
                              np.arange(nch * dq), np.arange(4),
                              indexing="ij")
        ch, d4 = e // dq, 4 * (e % dq)
        real = (k < K) & (d4 < taps * CC)
        t = np.where(real, d4 // CC, 0)
        c = np.where(real, ch * CC + d4 - t * CC + j, 0)
        val = np.where(real, qpad[np.minimum(k, K - 1), t, c], 0)
        nb = k // NT
        arena[p_off + 4 * (((nb * nch + ch) * NT + k - nb * NT) * dq
                           + d4 // 4) + j] = val.astype(np.int8).view(
                               np.uint8)
    return arena


def _compute_weights():
    ws = []
    for path in (DEFAULT_CHECKPOINT, TPUSEGNET_CHECKPOINT):
        params, config = checkpoint.params_from_npz_bytes(path.read_bytes())
        m = checkpoint.model_from_config(config)
        m.load_state_dict(checkpoint.state_dict_from_flax(
            checkpoint._upcast_f16(params)))
        ws.append([c.weight.detach().to(torch.bfloat16)
                   for c in quant.compute_convs(m)])
    return ws


@pytest.mark.parametrize("net", [0, 1], ids=["unet_seg", "tpusegnet_seg"])
def test_one_launch_weight_quantise_layout(net):
    """Every compute conv of the net (bf16, as `int8_lane` casts it): the
    arena that `quantize_weights` describes, filled as the kernel fills it,
    holds `quantize_weight_plain`'s amax and `pack_weight` of its q bit
    for bit, zeros in every pad (channels past Cin, depth past kh*kw*CC,
    rows past K), in one table (one launch) of disjoint regions (packed
    16-byte aligned, the amaxes back to back); the gaps between them
    untouched."""
    ws = _compute_weights()[net]
    assert len(ws) == (30, 19)[net] <= quant.MAX_WEIGHTS
    lay = quant.weight_arena(tuple(tuple(w.shape) for w in ws))
    desc = quant.weight_table(ws, lay)
    arena = _emulate_quantize_weights(ws, desc, lay.size)
    written = np.zeros(lay.size, bool)
    for w, sl in zip(ws, lay.slots):
        K, C, kh, kw = sl.shape
        p = sl.plan
        assert sl.p_off % 16 == sl.a_off % 4 == 0
        pw = quant.quantize_weight_plain(w)
        assert p == quant.conv_plan(*pw.q.shape)
        spans = ((sl.p_off, p.n_blocks * p.nch * p.nt * p.dc),
                 (sl.a_off, 4 * K))
        for off, n in spans:
            assert off + n <= lay.size and not written[off:off + n].any()
            written[off:off + n] = True
        packed = arena[sl.p_off:sl.p_off + spans[0][1]].view(np.int8)
        np.testing.assert_array_equal(
            packed.reshape(p.n_blocks, p.nch, p.nt, p.dc),
            quant.pack_weight(pw.q, p).numpy())
        amax = arena[sl.a_off:sl.a_off + 4 * K].view(np.float32)
        np.testing.assert_array_equal(amax, pw.amax.numpy())
        rows = packed.reshape(p.n_blocks, p.nch, p.nt, p.dc).transpose(
            0, 2, 1, 3).reshape(p.n_blocks * p.nt, p.nch, p.dc)
        assert not rows[K:].any()                          # rows past K
        assert not rows[:, :, kh * kw * p.cc:].any()       # depth past taps
        by_channel = rows[:K, :, :kh * kw * p.cc].reshape(
            K, p.nch, kh * kw, p.cc).transpose(0, 2, 1, 3).reshape(
                K, kh * kw, p.nch * p.cc)
        assert not by_channel[:, :, C:].any()              # channels past Cin
    assert (arena[~written] == POISON).all()


def test_quantize_weights_on_the_cpu_is_the_plain_version():
    """On CPU tensors `quantize_weights` is `quantize_weight_plain` each, in
    order, however many; off the CPU one launch takes at most MAX_WEIGHTS
    and more are refused before any launch."""
    ws = _compute_weights()[0][:5]
    for got, w in zip(quant.quantize_weights(ws), ws):
        want = quant.quantize_weight_plain(w)
        assert torch.equal(got.q, want.q) and torch.equal(got.amax,
                                                          want.amax)
    assert quant.quantize_weights([]) == []
    assert quant.quantize_weight(ws[0]).cin == ws[0].shape[1]
    with pytest.raises(ValueError, match="weight must be"):
        quant.quantize_weights([ws[0][0]])
    many = [ws[0]] * (quant.MAX_WEIGHTS + 1)
    assert len(quant.quantize_weights(many)) == quant.MAX_WEIGHTS + 1
    with pytest.raises(ValueError, match="up to 48 weights, got 49"):
        quant.quantize_weights([w.to("meta") for w in many])
    with pytest.raises(ValueError, match="must carry q"):
        quant.int8_conv_plain(torch.zeros((1, 3, 4, 4)), quant.QuantizedWeight(
            torch.ones(2), (2, 3, 1, 1)), None, 1, ((0, 0), (0, 0)))
