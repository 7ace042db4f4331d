"""The separate-task ML route of the port against the JAX package, on the CPU:
ResUNet (models/unet.py), the inference program, the torch `.pt` loader
(models/checkpoint.py), Segmentation2D, and the route end to end
(Segmentation2D -> Voxels -> PointCloud -> SegmentedPointCloud ->
OrganSegmentation -> AnglesAndInternodes).

Tolerances:
- float32 ResUNet (`model.clone(dtype=jnp.float32)` against the port with
  dtype float32): logits within 1e-4 absolute + 1e-5 relative (XLA and
  PyTorch sum convolutions and statistics in other orders); in
  norm="affine", whose activations nothing normalizes, plus 1e-6 of the
  largest logit.
- bfloat16 program (every parameter rounded to bfloat16, convolutions in
  bfloat16, as Segmentation2D runs it): probabilities within 0.05, argmax
  equal on >= 99 % of the pixels (the two frameworks round convolution
  outputs to bfloat16 at slightly different places; measured on the
  committed ResUNet's test input: max 0.046, argmax 99.4 %).
- uint8 output: (p * 255 + 0.5) truncated, the same number whether or not
  XLA fuses the multiply-add (the sum can cross an integer only where the
  rounded product does). With float32 models the two packages' uint8
  probabilities are equal but for pixels one level apart, where the
  probabilities straddle a level by their float32 rounding (measured on the
  crops below: 4 to 33 pixel-labels of 38,016-63,000, at most 5.2 in 10^4;
  with the bfloat16 program up to 10 levels apart, 0.4 on average).
- `.pt` loader: the same parameters, exactly; logits within 1e-4.
- Segmentation2D's write step, given the same probabilities: PNGs and
  metadata equal. The whole task (bfloat16 model): PNG levels within 13
  (0.05 * 255).
- Voxels from the same masks: 1e-5 relative + 2e-5 absolute (K5-avg).
- Downstream from the same volumes and masks: selections and point labels
  equal, the same organ files, angles and internodes within 0.05.
"""

import json
import pickle
from io import BytesIO

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from plant3dvision_tpu.models.checkpoint import load_model as jax_load_model
from plant3dvision_tpu.models.checkpoint import save_model
from plant3dvision_tpu.models.unet import ResUNet as JaxResUNet
from plant3dvision_tpu.models.unet import _fwd_program

from plant3dvision_tpu_torch.models import checkpoint, unet
from plant3dvision_tpu_torch.models.zoo import (DEFAULT_CHECKPOINT,
                                                install_checkpoint)

torch.set_num_threads(1)

ML_LABELS = ["background", "flower", "fruit", "leaf", "pedicel", "stem"]


def _np(tree, fn=np.asarray):
    """fn over the leaves of a nested dict, keeping its order (jax.tree.map
    would sort the keys: flax's init order is what the torch converter
    matches against)."""
    return {k: _np(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _tiny(norm="group", n_classes=4, seed=0):
    """A (8, 16)-wide, 1-block flax ResUNet; in `norm="affine"` its norm
    scales and biases are perturbed so the affines do something."""
    model = JaxResUNet(n_classes=n_classes, widths=(8, 16),
                       blocks_per_stage=1, norm=norm)
    params = _np(model.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 64, 64, 3))))
    if norm == "affine":
        rng = np.random.default_rng(seed)
        params = _np(params, lambda a: (a + 0.3 * rng.standard_normal(
            a.shape)).astype(np.float32))
    return model, params


def _config(norm="group", n_classes=4):
    return {"widths": [8, 16], "blocks_per_stage": 1, "norm": norm,
            "label_names": ML_LABELS[:n_classes]}


def _port(params, config, dtype=torch.float32):
    m = checkpoint.model_from_config(config)
    m.load_state_dict(checkpoint.state_dict_from_flax(params))
    m.dtype = dtype
    return m if dtype == torch.float32 else m.to(dtype)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _logits(model, x):
    with torch.no_grad():
        return model(_nchw(x)).permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def committed():
    """checkpoints/unet_seg.npz: (jax model, jax params, port params,
    config), both upcast to float32 by their own loaders."""
    from plant3dvision_tpu.models.checkpoint import (_upcast_f16,
                                                     model_from_config,
                                                     params_from_npz_bytes)
    data = DEFAULT_CHECKPOINT.read_bytes()
    jparams, config = params_from_npz_bytes(data)
    pparams, pconfig = checkpoint.params_from_npz_bytes(data)
    assert pconfig == config
    return (model_from_config(config), _upcast_f16(jparams),
            checkpoint._upcast_f16(pparams), config)


# -- ResUNet ------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["group", "affine"])
def test_flax_template_is_flax_traversal_order(norm):
    """The port's module enumerates flax's parameter tree: the same paths
    and shapes, in the order of flax's eagerly built init tree (which the
    torch converter matches against)."""
    _, params = _tiny(norm)
    want = [(k, v.shape) for k, v in flatten_dict(params, sep="/").items()]
    got = checkpoint.flax_template(
        checkpoint.model_from_config(_config(norm)))
    assert [(k, v.shape) for k, v in got.items()] == want


@pytest.mark.parametrize("norm", ["group", "affine"])
def test_tiny_resunet_float32_matches_flax(norm):
    model, params = _tiny(norm)
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(model.clone(dtype=jnp.float32).apply(params, x))
    got = _logits(_port(params, _config(norm)), x)
    assert got.shape == ref.shape == (2, 64, 64, 4)
    # in "affine" nothing normalizes the activations (logits ~500 here): the
    # absolute tolerance grows by 1e-6 of the largest logit
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-4 + 1e-6 * np.abs(ref).max())


def test_committed_resunet_float32_matches_flax(committed):
    """The committed 2.03 M-parameter ResUNet (widths 24-192) on one 64x64
    image: the 7x7 stride-2 stem pads (2, 3), the stem-level skip's resize
    is an identity, the last resize goes to the padded input."""
    jmodel, jparams, pparams, config = committed
    x = np.random.default_rng(1).integers(0, 256, (1, 64, 64, 3)).astype(
        np.float32) / 255
    ref = np.asarray(jmodel.clone(dtype=jnp.float32).apply(jparams, x))
    port = _port(pparams, config)
    assert sum(p.numel() for p in port.parameters()) == pytest.approx(
        2.03e6, rel=0.01)
    np.testing.assert_allclose(_logits(port, x), ref, atol=1e-4, rtol=1e-5)


def test_resunet_bfloat16_program_matches_fwd_program(committed):
    """The program Segmentation2D runs: parameters rounded to bfloat16,
    convolutions in bfloat16 (tolerance in the module docstring)."""
    jmodel, jparams, pparams, config = committed
    H, W = 50, 70
    img = np.random.default_rng(3).integers(0, 256, (2, H, W, 3),
                                            dtype=np.uint8)
    fwd = _fwd_program(jmodel, H, W, "bfloat16", True, False)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
    ref = np.asarray(fwd(jp, jnp.asarray(img)))
    got = unet.forward_probs(_port(pparams, config, torch.bfloat16),
                             torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, ref, atol=0.05, rtol=0)
    assert (got.argmax(1) == ref.argmax(1)).mean() >= 0.99


@pytest.mark.parametrize("tta", [False, True])
def test_segmentation_inference_uint8_matches_jax(committed, tta):
    """segmentation_inference's uint8 output with float32 models, on 50x70
    and 33x64 crops (padded to multiples of 32), batches of 2 (the last one
    short), with and without the flip TTA: equal but for pixels one level
    apart (module docstring)."""
    from plant3dvision_tpu.models.unet import segmentation_inference as jsi
    jmodel, jparams, pparams, config = committed
    for H, W in ((50, 70), (33, 64)):
        img = np.random.default_rng(H).integers(0, 256, (3, H, W, 3),
                                                dtype=np.uint8)
        ref = jsi(jmodel.clone(dtype=jnp.float32), jparams, img,
                  batch_size=2, compute_dtype="float32", tta=tta)
        got = unet.segmentation_inference(
            _port(pparams, config), img, batch_size=2,
            compute_dtype="float32", tta=tta, device="cpu").numpy()
        assert got.dtype == ref.dtype == np.uint8
        assert got.shape == ref.shape == (3, 6, H, W)
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert diff.max() <= 1
        assert (diff == 1).mean() < 1e-3, (diff == 1).sum()


def test_segmentation_inference_refuses_int8(committed):
    _, _, pparams, config = committed
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        unet.segmentation_inference(_port(pparams, config),
                                    np.zeros((1, 32, 32, 3), np.uint8),
                                    conv_mode="int8", device="cpu")


def test_model_from_config_builds_both_architectures():
    """No 'arch' (or 'resunet') builds ResUNet with the config's widths,
    blocks and norm; 'tpusegnet' builds TPUSegNet."""
    from plant3dvision_tpu_torch.models.segnet import TPUSegNet
    m = checkpoint.model_from_config({"label_names": ["a", "b"]})
    assert isinstance(m, unet.ResUNet) and m.Conv_1.weight.shape[0] == 2
    assert m.Conv_0.weight.shape == (64, 3, 7, 7)
    m = checkpoint.model_from_config(_config("affine"))
    assert isinstance(m.ResBlock_0.ChannelAffine_1, unet.ChannelAffine)
    assert isinstance(checkpoint.model_from_config({"arch": "tpusegnet"}),
                      TPUSegNet)


def test_install_checkpoint_default_is_the_resunet(temp_db):
    """install_checkpoint's defaults are the JAX package's: unet_seg.npz as
    'unet_seg'."""
    from plant3dvision_tpu.models.zoo import DEFAULT_CHECKPOINT as JAX_CKPT
    from plant3dvision_tpu.models.zoo import install_checkpoint as jax_install
    assert JAX_CKPT == DEFAULT_CHECKPOINT
    f = install_checkpoint(temp_db, scan_id="a")
    g = jax_install(temp_db, scan_id="b")
    assert f.id == g.id == "unet_seg"
    for key in ("label_names", "model_config"):
        assert f.get_metadata(key) == g.get_metadata(key)
    model, config = checkpoint.load_model(f)
    assert isinstance(model, unet.ResUNet) and config["widths"] == [
        24, 48, 96, 192]


# -- the torch .pt loader -------------------------------------------------------

def _bn_state_dict(seed=9):
    """A seeded torch state_dict of an affine (8, 16) ResUNet with
    BatchNorm quadruples in the norm slots (tests/integration/
    test_ml_pipeline.py:280-316)."""
    model = JaxResUNet(n_classes=len(ML_LABELS), widths=(8, 16),
                       blocks_per_stage=1, norm="affine")
    template = model.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(seed)
    sd = {}
    for i, (k, v) in enumerate(flatten_dict(template, sep="/").items()):
        v = np.asarray(v)
        leaf = k.rsplit("/", 1)[-1]
        if "ChannelAffine" in k and leaf == "bias":
            continue
        if "ChannelAffine" in k:
            C = v.shape[0]
            sd[f"m{i}.weight"] = rng.random(C).astype(np.float32) + 0.5
            sd[f"m{i}.bias"] = rng.standard_normal(C).astype(np.float32)
            sd[f"m{i}.running_mean"] = rng.standard_normal(C).astype(
                np.float32)
            sd[f"m{i}.running_var"] = rng.random(C).astype(np.float32) + 0.3
            sd[f"m{i}.num_batches_tracked"] = np.int64(3)
        elif v.ndim == 4:
            sd[f"m{i}.weight"] = np.transpose(
                rng.standard_normal(v.shape).astype(np.float32) * 0.1,
                (3, 2, 0, 1))
        else:
            key = f"m{i}.bias" if leaf == "bias" else f"m{i}.weight"
            sd[key] = rng.standard_normal(v.shape).astype(np.float32) * 0.1
    return sd


def _pt_bytes(obj):
    buf = BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _pt_file(db, name, sd):
    f = db.get_scan("models", create=True).get_fileset(
        "models", create=True).get_file(name, create=True)
    f.write_raw(_pt_bytes({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}), "pt")
    f.set_metadata("label_names", ML_LABELS)
    f.set_metadata("model_config", {"label_names": ML_LABELS,
                                    "widths": [8, 16],
                                    "blocks_per_stage": 1})
    return f


def test_pt_batchnorm_checkpoint_loads_like_jax(temp_db):
    """The BatchNorm .pt through both loaders: the folded affine ResUNet
    with exactly the JAX loader's parameters, and its logits."""
    f = _pt_file(temp_db, "torch_bn", _bn_state_dict())
    jmodel, jparams, jcfg = jax_load_model(f)
    pmodel, pcfg = checkpoint.load_model(f)
    assert pcfg == jcfg and pcfg["norm"] == "affine"
    assert isinstance(pmodel, unet.ResUNet) and pmodel.norm == "affine"
    want = checkpoint.state_dict_from_flax(_np(jparams))
    got = pmodel.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    x = np.random.default_rng(2).random((1, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jmodel.clone(dtype=jnp.float32).apply(jparams, x))
    pmodel.dtype = torch.float32
    np.testing.assert_allclose(_logits(pmodel, x), ref, atol=1e-4, rtol=1e-5)


def test_pt_groupnorm_checkpoint_loads_like_jax(temp_db):
    """A plain (no BatchNorm) .pt of a GroupNorm ResUNet, keyed as torch
    would name it: the same parameters as the JAX loader's."""
    _, params = _tiny("group", n_classes=len(ML_LABELS), seed=3)
    sd = {}
    for k, v in flatten_dict(params, sep="/").items():
        mod, leaf = k.rsplit("/", 1)
        key = mod.replace("/", ".") + (".bias" if leaf == "bias"
                                       else ".weight")
        sd[key] = (np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v)
    f = _pt_file(temp_db, "torch_gn", sd)
    _, jparams, jcfg = jax_load_model(f)
    pmodel, pcfg = checkpoint.load_model(f)
    assert pcfg == jcfg and pmodel.norm == "group"
    want = checkpoint.state_dict_from_flax(_np(jparams))
    for k, v in pmodel.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_torch_converter_contract_violations():
    """tests/unit/test_models.py:212 on the port's converter: square linear
    weights transposed, BatchNorm statistics refused in strict mode (warned
    about otherwise), step counters dropped, the kind gate."""
    rng = np.random.default_rng(2)
    template = {"head": {"kernel": np.zeros((8, 8), np.float32),
                         "bias": np.zeros((8,), np.float32)}}
    w = rng.random((8, 8)).astype(np.float32)
    sd = {"head.weight": w, "head.bias": np.zeros(8, np.float32),
          "head.num_batches_tracked": np.array(7)}
    conv = checkpoint.convert_torch_state_dict(sd, template)
    np.testing.assert_array_equal(conv["head"]["kernel"], w.T)
    sd_bn = dict(sd)
    sd_bn["bn.running_mean"] = np.zeros(8, np.float32)
    sd_bn["bn.running_var"] = np.ones(8, np.float32)
    with pytest.raises(ValueError, match="running"):
        checkpoint.convert_torch_state_dict(sd_bn, template)
    with pytest.warns(UserWarning, match="dropped"):
        checkpoint.convert_torch_state_dict(sd_bn, template, strict=False)
    template2 = {"norm": {"scale": np.zeros((8,), np.float32),
                          "bias": np.zeros((8,), np.float32)}}
    with pytest.raises(ValueError, match="norm/bias"):
        checkpoint.convert_torch_state_dict(
            {"norm.weight": np.ones(8, np.float32)}, template2)


@pytest.fixture()
def load_calls(monkeypatch):
    """Counts torch.load calls and the weights_only each was given."""
    calls = []
    real = torch.load

    def counting(*a, **kw):
        calls.append(kw.get("weights_only"))
        return real(*a, **kw)

    monkeypatch.setattr(torch, "load", counting)
    return calls


def test_corrupt_pt_raises_without_retry(load_calls):
    data = _pt_bytes({"w": torch.zeros(4)})
    with pytest.raises(RuntimeError):
        checkpoint._torch_bytes_to_state_dict(data[:len(data) // 2], "bad.pt")
    assert load_calls == [True]


def test_pickled_module_pt_is_retried_with_a_warning(load_calls):
    """A pickled module is refused by the weights-only load with
    pickle.UnpicklingError: then, and only then, it is loaded again with a
    warning that names the file."""
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    with pytest.warns(UserWarning, match="net.pt"):
        sd = checkpoint._torch_bytes_to_state_dict(_pt_bytes(net), "net.pt")
    assert load_calls == [True, False]
    assert list(sd) == ["0.weight", "0.bias", "1.weight", "1.bias",
                        "1.running_mean", "1.running_var",
                        "1.num_batches_tracked"]
    np.testing.assert_array_equal(sd["0.weight"],
                                  net[0].weight.detach().numpy())
    assert issubclass(pickle.UnpicklingError, Exception)


# -- Segmentation2D -------------------------------------------------------------

def _fake_probs(batch):
    """Deterministic uint8 'probabilities' of a (N, H, W, 3) crop batch, 6
    channels spread over every level (many near the 0.01 threshold)."""
    b = batch.astype(np.int64)
    return np.stack([(b[..., c % 3] * (c + 3) + 17 * c) % 256
                     for c in range(6)], 1).astype(np.uint8)


def _save_tiny_resunet(db):
    _, params = _tiny("group", n_classes=len(ML_LABELS))
    f = db.get_scan("models", create=True).get_fileset(
        "models", create=True).get_file("tiny", create=True)
    save_model(f, params, {"label_names": ML_LABELS, "widths": [8, 16],
                           "blocks_per_stage": 1})
    return f


SEG_CFG = {
    "ModelFilesetExists": {"scan_id": "models"},
    "Segmentation2D": {"upstream_task": "ImagesFilesetExists",
                       "query": {"channel": "rgb"}, "Sx": 96, "Sy": 80,
                       "binarize": True, "threshold": 0.01, "dilation": 1,
                       "batch_size": 2},
}


def _seg_outputs(scan, report):
    from plant3dvision_tpu.fsdb import io as jio
    fs = scan.get_fileset(report["Segmentation2D"]["fileset"])
    return fs.id, fs.get_metadata("label_names"), [
        (f.id, jio.read_image(f), f.get_metadata()) for f in fs.get_files()]


def test_segmentation2d_binarized_matches_jax(temp_db, monkeypatch):
    """binarize=true, threshold 0.01, dilation 1 (the reference's settings)
    on 120x100 images centre-cropped to 96x80, given the same probabilities
    in both packages: the same fileset, file order, PNGs (background
    inverted, thresholded, dilated, re-inverted) and metadata (principal
    point shifted by the crop origin)."""
    import plant3dvision_tpu.models.unet as jax_unet
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.runtime import run_task as jax_run_task
    from plant3dvision_tpu.synth_photo import (ProceduralArabidopsis,
                                               generate_photo_scan)
    from plant3dvision_tpu_torch.runtime import RunContext, run_task

    generate_photo_scan(temp_db, "s", n_views=3, width=120, height=100,
                        plant=ProceduralArabidopsis(n_fruits=4, seed=2),
                        with_gt_masks=False)
    _save_tiny_resunet(temp_db)
    monkeypatch.setattr(jax_unet, "segmentation_inference",
                        lambda model, params, batch, **kw: _fake_probs(batch))
    monkeypatch.setattr(unet, "segmentation_inference",
                        lambda model, batch, device=None, **kw:
                        torch.from_numpy(_fake_probs(batch)).to(device))
    jctx = JaxRunContext(temp_db, "s", SEG_CFG)
    jout = _seg_outputs(jctx.scan, jax_run_task(jctx, "Segmentation2D",
                                                report=False))
    jctx.scan.delete_fileset(jout[0])
    ctx = RunContext(temp_db, "s", SEG_CFG, device="cpu")
    out = _seg_outputs(ctx.scan, run_task(ctx, "Segmentation2D",
                                          report=False))
    assert out[0] == jout[0] and out[1] == jout[1] == ML_LABELS
    assert [o[0] for o in out[2]] == [o[0] for o in jout[2]]
    assert len(out[2]) == 3 * 6
    for (fid, png, md), (_, jpng, jmd) in zip(out[2], jout[2]):
        np.testing.assert_array_equal(png, jpng, err_msg=fid)
        assert md == jmd, fid
    cam = out[2][0][2]["camera"]["camera_model"]["params"]
    raw = ctx.scan.get_fileset("images").get_file("00000_rgb").get_metadata(
        "camera")["camera_model"]["params"]
    assert (raw[2] - cam[2], raw[3] - cam[3]) == (12, 10)
    pngs = np.stack([o[1] for o in out[2]])
    assert set(np.unique(pngs)) == {0, 255}


def test_segmentation2d_refuses_resize(temp_db):
    from plant3dvision_tpu_torch.runtime import RunContext
    from plant3dvision_tpu_torch.tasks.proc2d import Segmentation2D
    ctx = RunContext(temp_db, "s", {"Segmentation2D": {"resize": True}},
                     device="cpu")
    with pytest.raises(NotImplementedError, match="hybrid"):
        Segmentation2D(ctx).run()


# -- the route end to end -----------------------------------------------------

ROUTE_CFG = {
    "ModelFilesetExists": {"scan_id": "models"},
    "Segmentation2D": {"upstream_task": "ImagesFilesetExists",
                       "model_fileset": "ModelFilesetExists", "model_id": "",
                       "query": {"channel": "rgb"}, "Sx": 128, "Sy": 128,
                       "binarize": False, "dilation": 0, "threshold": 0.01,
                       "batch_size": 3},
    "Voxels": {"upstream_mask": "Segmentation2D",
               "upstream_colmap": "DummyTask", "camera_metadata": "camera",
               "voxel_size": 1.0, "type": "averaging", "log": False,
               "invert": False,
               "labels": ["background", "fruit", "leaf", "pedicel", "stem"]},
    "PointCloud": {"upstream_task": "Voxels", "level_set_value": 0.2,
                   "background_prior": 1.0, "min_contrast": 1.0,
                   "min_score": 0.01},
    "SegmentedPointCloud": {"upstream_task": "PointCloud",
                            "upstream_segmentation": "Segmentation2D",
                            "use_colmap_poses": False},
    "OrganSegmentation": {"upstream_task": "SegmentedPointCloud",
                          "eps": 1.2, "min_points": 5},
    "AnglesAndInternodes": {"upstream_task": "OrganSegmentation",
                            "organ_type": "fruit", "min_fruit_size": 2.0,
                            "min_elongation_ratio": 1.0,
                            "characteristic_length": 1.0, "stem_axis": 2,
                            "stem_axis_inverted": False},
}
DOWNSTREAM = ("PointCloud", "SegmentedPointCloud", "OrganSegmentation",
              "AnglesAndInternodes")


def _run(pkg, db, task):
    from plant3dvision_tpu.fsdb import handoff as jax_handoff
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.runtime import run_task as jax_run_task
    from plant3dvision_tpu_torch.fsdb import handoff
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    jax_handoff.reset()
    handoff.reset()
    if pkg == "jax":
        ctx = JaxRunContext(db, "s", ROUTE_CFG)
        return ctx.scan, jax_run_task(ctx, task, report=False)
    ctx = RunContext(db, "s", ROUTE_CFG, device="cpu")
    return ctx.scan, run_task(ctx, task, report=False)


def _pngs(fs):
    from plant3dvision_tpu.fsdb import io as jio
    return {f.id: (jio.read_image(f), f.get_metadata())
            for f in fs.get_files()}


def test_separate_route_matches_jax(temp_db):
    """An 8-view 128x128 photo scan and a tiny ResUNet saved by the JAX
    package, through both packages: Segmentation2D (bfloat16 CNN), then
    Voxels on the same (JAX) masks, then the downstream tasks on the same
    label volumes (the plant's own, voxelized) and the same masks (the
    scan's ground truth)."""
    from plant3dvision_tpu.fsdb import io as jio
    from plant3dvision_tpu.synth_photo import (ProceduralArabidopsis,
                                               generate_photo_scan)
    from tests.test_torch_ml import _downstream, _label_volumes

    db = temp_db
    plant = ProceduralArabidopsis(n_fruits=8, seed=1)
    generate_photo_scan(db, "s", n_views=8, width=128, height=128,
                        plant=plant, with_gt_masks=True)
    _save_tiny_resunet(db)

    # Segmentation2D: fileset ids, files and metadata equal; PNG levels
    # within the bfloat16 tolerance
    scan, jrep = _run("jax", db, "Segmentation2D")
    seg_id = jrep["Segmentation2D"]["fileset"]
    jseg = _pngs(scan.get_fileset(seg_id))
    scan.delete_fileset(seg_id)
    scan, rep = _run("port", db, "Segmentation2D")
    assert rep["Segmentation2D"]["fileset"] == seg_id
    fs = scan.get_fileset(seg_id)
    pseg = _pngs(fs)
    assert list(pseg) == list(jseg) and len(pseg) == 8 * 6
    for k, (png, md) in pseg.items():
        assert md == jseg[k][1], k
        assert np.abs(png.astype(int) - jseg[k][0].astype(int)).max() <= 13
    assert fs.get_metadata("label_names") == ML_LABELS
    # from here on both packages read the JAX masks
    for f in fs.get_files():
        jio.write_image(f, jseg[f.id][0], "png")

    # Voxels from the same masks
    vols = []
    for pkg in ("jax", "port"):
        scan, r = _run(pkg, db, "Voxels")
        vfs = scan.get_fileset(r["Voxels"]["fileset"])
        vf = vfs.get_files()[0]
        vols.append((r["Voxels"]["fileset"], dict(np.load(vf.path())),
                     vf.get_metadata()))
        if pkg == "jax":
            scan.delete_fileset(vfs.id)
    (jid, jv, jmd), (pid, pv, pmd) = vols
    assert pid == jid and pmd == jmd
    assert list(pv) == list(jv) == ROUTE_CFG["Voxels"]["labels"]
    for l in pv:
        np.testing.assert_allclose(pv[l], jv[l], rtol=1e-5, atol=2e-5)
    assert (jv["stem"] > 0).mean() > 0.5

    # the same volumes (the plant's, at 0.5 mm) and the same masks (the
    # scan's ground truth) into both packages' downstream tasks
    vf = scan.get_fileset(pid).get_files()[0]
    gt, origin = _label_volumes(plant, scan.get_metadata("bounding_box"),
                                0.5)
    np.savez_compressed(vf.path(), **gt)
    vf.set_metadata({"voxel_size": 0.5, "origin": origin.tolist()})
    images = scan.get_fileset("images")
    for f in fs.get_files():
        shot, label = f.id.split("_rgb_")
        if label == "flower":
            m = np.zeros((128, 128), np.uint8)
        else:
            m = jio.read_image(images.get_file(f"{shot}_{label}"))
        jio.write_image(f, m, "png")
    outs = []
    for pkg in ("jax", "port"):
        scan, r = _run(pkg, db, "AnglesAndInternodes")
        assert r["Segmentation2D"]["status"] == r["Voxels"]["status"] == \
            "skipped"
        seg = scan.get_fileset(r["SegmentedPointCloud"]["fileset"])
        sf = seg.get_files()[0]
        outs.append((r, _downstream(scan, r), sf.get_metadata("labels"),
                     jio.read_point_cloud(sf).points))
        for t in DOWNSTREAM:
            scan.delete_fileset(r[t]["fileset"])
    (jr, (jpcd, jlab, jorg, jang), jseglab, jsegpts), \
        (pr, (ppcd, plab, porg, pang), pseglab, psegpts) = outs
    for t in DOWNSTREAM:
        assert pr[t]["fileset"] == jr[t]["fileset"], t
    assert plab == jlab
    np.testing.assert_allclose(ppcd.points, jpcd.points, atol=1e-4, rtol=0)
    assert pseglab == jseglab
    np.testing.assert_allclose(psegpts, jsegpts, atol=1e-4, rtol=0)
    assert porg == jorg
    assert sum(o.startswith("fruit_") for o in porg) >= 5
    assert len(pang["angles"]) == len(jang["angles"]) >= 4
    np.testing.assert_allclose(pang["angles"], jang["angles"], atol=0.05,
                               rtol=0)
    np.testing.assert_allclose(pang["internodes"], jang["internodes"],
                               atol=0.05, rtol=0)
    assert json.dumps(pseglab).count("fruit") > 100
