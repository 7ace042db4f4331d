"""The port's TPUSegNet (models/segnet.py), forward program (models/unet.py)
and NPZ checkpoint loader (models/checkpoint.py, models/zoo.py) against the
JAX package's flax model, on the CPU.

Tolerances:
- float32 model (`model.clone(dtype=jnp.float32)` against the port with
  dtype float32): logits within 1e-4 absolute + 1e-5 relative. Both compute
  every layer in float32; XLA and PyTorch sum the convolutions and the
  GroupNorm statistics in other orders (measured: 1.2e-5 on the tiny model,
  1.3e-4 on the committed checkpoint's logits of magnitude ~24).
- bfloat16 forward program (the parameters rounded to bfloat16, convolutions
  in bfloat16, as FusedSegmentationCarving runs it): probabilities within
  0.05, with >= 99 % of the pixels' argmax equal. One bfloat16 rounding of a
  convolution output is 0.4 %, and the two frameworks round at slightly
  different places (measured on these inputs: max 0.014, argmax 99.9 %).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plant3dvision_tpu.models import create_segnet
from plant3dvision_tpu.models.checkpoint import load_model as jax_load_model
from plant3dvision_tpu.models.checkpoint import save_model
from plant3dvision_tpu.models.segnet import space_to_depth as jax_s2d
from plant3dvision_tpu.models.unet import _fwd_program

from plant3dvision_tpu_torch.models import checkpoint, segnet
from plant3dvision_tpu_torch.models.unet import forward_probs
from plant3dvision_tpu_torch.models.zoo import (TPUSEGNET_CHECKPOINT,
                                                install_checkpoint)

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tiny(n_classes=4, widths=(16, 32)):
    model, params = create_segnet(jax.random.PRNGKey(0),
                                  input_shape=(1, 64, 64, 3), widths=widths,
                                  blocks_per_stage=1, n_classes=n_classes)
    return model, _np(params)


def _port(params, config, dtype=torch.float32):
    m = checkpoint.model_from_config(config)
    m.load_state_dict(checkpoint.state_dict_from_flax(params))
    m.dtype = dtype
    return m.to(dtype) if dtype != torch.float32 else m


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def committed():
    """The committed checkpoint: (jax model, jax params, port params,
    config), both upcast to float32 by their own loaders."""
    from plant3dvision_tpu.models.checkpoint import (_upcast_f16,
                                                     model_from_config,
                                                     params_from_npz_bytes)
    data = TPUSEGNET_CHECKPOINT.read_bytes()
    jparams, config = params_from_npz_bytes(data)
    pparams, pconfig = checkpoint.params_from_npz_bytes(data)
    assert pconfig == config
    return (model_from_config(config), _upcast_f16(jparams),
            checkpoint._upcast_f16(pparams), config)


def test_space_to_depth_channel_order():
    """(ph, pw, c) channel order, as flax; depth_to_space inverts it."""
    x = np.arange(2 * 8 * 12 * 3, dtype=np.float32).reshape(2, 8, 12, 3)
    ref = np.asarray(jax_s2d(jnp.asarray(x), 4))
    got = segnet.space_to_depth(_nchw(x), 4).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        segnet.depth_to_space(segnet.space_to_depth(_nchw(x), 4), 4),
        _nchw(x))


@pytest.mark.parametrize("size,stride", [(8, 2), (7, 2), (9, 1), (6, 3)])
def test_same_padding_matches_xla(size, stride):
    """The port's SAME padding of a 3x3 conv equals flax's (a stride-2 conv
    of an even input pads only bottom/right)."""
    import flax.linen as nn
    rng = np.random.default_rng(size)
    x = rng.standard_normal((1, size, size, 2)).astype(np.float32)
    conv = nn.Conv(3, (3, 3), strides=(stride, stride), padding="SAME")
    params = _np(conv.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    ref = np.asarray(conv.apply(params, jnp.asarray(x)))
    c = segnet.Conv(2, 3, 3, stride)
    c.load_state_dict(checkpoint.state_dict_from_flax(params))
    got = c(_nchw(x), torch.float32).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_tiny_segnet_float32_matches_flax():
    model, params = _tiny()
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(model.clone(dtype=jnp.float32).apply(params, x))
    port = _port(params, {"arch": "tpusegnet", "widths": [16, 32],
                          "blocks_per_stage": 1, "label_names": list("abcd")})
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_committed_segnet_float32_matches_flax(committed):
    jmodel, jparams, pparams, config = committed
    img = np.random.default_rng(1).integers(0, 256, (1, 64, 64, 3),
                                            dtype=np.uint8)
    x = img.astype(np.float32) / 255
    ref = np.asarray(jmodel.clone(dtype=jnp.float32).apply(jparams, x))
    with torch.no_grad():
        got = _port(pparams, config)(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert ref.shape == (1, 64, 64, 6)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("hw", [(50, 70), (33, 64)])
def test_forward_program_float32_matches_fwd_program(committed, hw):
    """uint8 batches whose crops are not multiples of 32: padding, softmax,
    crop and layout of `_fwd_program`, with a float32 model on both sides."""
    jmodel, jparams, pparams, config = committed
    H, W = hw
    img = np.random.default_rng(2).integers(0, 256, (2, H, W, 3),
                                            dtype=np.uint8)
    fwd = _fwd_program(jmodel.clone(dtype=jnp.float32), H, W, "float32",
                       True, False)
    ref = np.asarray(fwd(jparams, jnp.asarray(img)))
    got = forward_probs(_port(pparams, config),
                        torch.from_numpy(img)).numpy()
    assert got.shape == ref.shape == (2, 6, H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_forward_program_bfloat16_matches_fwd_program(committed):
    """The program FusedSegmentationCarving runs: every float parameter
    rounded to bfloat16, convolutions in bfloat16 (tolerance in the module
    docstring)."""
    jmodel, jparams, pparams, config = committed
    H, W = 50, 70
    img = np.random.default_rng(3).integers(0, 256, (2, H, W, 3),
                                            dtype=np.uint8)
    fwd = _fwd_program(jmodel, H, W, "bfloat16", True, False)
    jp_bf16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
    ref = np.asarray(fwd(jp_bf16, jnp.asarray(img)))
    got = forward_probs(_port(pparams, config, torch.bfloat16),
                        torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, ref, atol=0.05, rtol=0)
    assert (got.argmax(1) == ref.argmax(1)).mean() >= 0.99
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)


def test_state_dict_from_flax_round_trip(committed):
    """Every flax array lands in the module exactly once, transposed
    HWIO -> OIHW; the module's state_dict gives back the same tensors."""
    _, _, pparams, config = committed
    sd = checkpoint.state_dict_from_flax(pparams)
    model = checkpoint.model_from_config(config)
    model.load_state_dict(sd, strict=True)
    back = model.state_dict()
    assert set(back) == set(sd) and len(sd) == 74
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    k = pparams["params"]["ResBlock_2"]["Conv_0"]["kernel"]      # (3,3,128,256)
    np.testing.assert_array_equal(
        back["ResBlock_2.Conv_0.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        back["GroupNorm_0.weight"].numpy(),
        pparams["params"]["GroupNorm_0"]["scale"])
    assert sum(v.numel() for v in sd.values()) == pytest.approx(7.55e6,
                                                                rel=0.01)


def test_load_model_from_a_jax_saved_checkpoint(temp_db):
    """A checkpoint written by the JAX package's save_model loads into the
    port and computes what the JAX loader's model computes."""
    model, params = _tiny(n_classes=3, widths=(16, 32))
    f = temp_db.create_scan("models").create_fileset("models").create_file(
        "tiny")
    cfg = {"label_names": ["a", "b", "c"], "arch": "tpusegnet",
           "widths": [16, 32], "blocks_per_stage": 1, "patch": 4}
    save_model(f, params, cfg)
    jmodel, jparams, _ = jax_load_model(f)
    pmodel, pcfg = checkpoint.load_model(f)
    assert isinstance(pmodel, segnet.TPUSegNet) and pcfg == cfg
    pmodel.dtype = torch.float32
    x = np.linspace(0, 1, 64 * 64 * 3, dtype=np.float32).reshape(1, 64, 64, 3)
    ref = np.asarray(jmodel.clone(dtype=jnp.float32).apply(jparams, x))
    with torch.no_grad():
        got = pmodel(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_install_checkpoint_metadata_matches_jax(temp_db):
    from plant3dvision_tpu.models.zoo import (
        install_checkpoint as jax_install)
    from plant3dvision_tpu.models.zoo import TPUSEGNET_CHECKPOINT as JAX_CKPT
    assert JAX_CKPT == TPUSEGNET_CHECKPOINT
    f = install_checkpoint(temp_db, path=TPUSEGNET_CHECKPOINT, model_id="a")
    g = jax_install(temp_db, path=JAX_CKPT, model_id="b")
    for key in ("label_names", "model_config"):
        assert f.get_metadata(key) == g.get_metadata(key)
    assert f.get_metadata("label_names") == [
        "background", "flower", "fruit", "leaf", "pedicel", "stem"]
