"""Segmentation2D(resize=True): the port's cv2-free resamplers
(ops/resize.py) against cv2 on the CPU, and the task's PNGs through both
packages.

- INTER_AREA shrink of uint8 images (1, 3 and 4 channels; integer scales,
  the 2x2 one included, and non-integer ones): equal to cv2.
- INTER_LINEAR growth of float32 probabilities: equal to cv2 (its lerp
  fma(S1 - S0, w, S0) in float32).
- The task on a small photo scan whose images are not the net's size,
  given the same probabilities in both packages (the CNN's bfloat16
  rounding is covered by tests/test_torch_seg.py): the same fileset, file
  order, PNGs and metadata (the camera as it was), binarised or not.
"""

import cv2
import numpy as np
import pytest
import torch

from plant3dvision_tpu_torch.ops.resize import (resize_area_u8,
                                                resize_linear_f32)

torch.set_num_threads(1)


@pytest.mark.parametrize("src,dst,cn", [
    ((120, 160), (60, 80), 3),        # 2x2 (rounds (sum + 2) >> 2)
    ((90, 90), (30, 30), 3),          # 3x3
    ((120, 160), (40, 40), 3),        # 3x4
    ((50, 60), (25, 30), 1),
    ((1080, 1440), (528, 704), 3),    # ml_pipe_real_hybrid.toml's 704x528
    ((100, 130), (37, 53), 3),
    ((97, 101), (96, 100), 1),
    ((91, 77), (13, 11), 4),
    ((64, 64), (64, 32), 3),
])
def test_inter_area_shrink_matches_cv2(src, dst, cn):
    rng = np.random.default_rng(sum(src) + cn)
    img = rng.integers(0, 256, src + ((cn,) if cn > 1 else ())).astype(
        np.uint8)
    size = (dst[1], dst[0])
    np.testing.assert_array_equal(
        resize_area_u8(img, size),
        cv2.resize(img, size, interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("src,dst", [
    ((60, 80), (120, 160)),           # integer scale
    ((528, 704), (1080, 1440)),
    ((37, 53), (100, 130)),
    ((13, 11), (91, 77)),
    ((96, 100), (97, 101)),
    ((32, 64), (64, 64)),
])
def test_inter_linear_growth_matches_cv2(src, dst):
    x = np.random.default_rng(sum(src)).random((3,) + src).astype(np.float32)
    size = (dst[1], dst[0])
    got = resize_linear_f32(torch.from_numpy(x), size).numpy()
    for i in range(len(x)):
        np.testing.assert_array_equal(
            got[i], cv2.resize(x[i], size, interpolation=cv2.INTER_LINEAR))


def test_resamplers_refuse_what_the_task_does_not_use():
    with pytest.raises(ValueError):
        resize_area_u8(np.zeros((8, 8), np.uint16), (4, 4))
    with pytest.raises(ValueError):
        resize_area_u8(np.zeros((8, 8), np.uint8), (16, 4))
    with pytest.raises(ValueError):
        resize_linear_f32(torch.zeros((4, 4), dtype=torch.float64), (8, 8))


@pytest.mark.parametrize("binarize", [False, True])
def test_segmentation2d_resize_matches_jax(temp_db, monkeypatch, binarize):
    """A 3-view 150x110 photo scan through Segmentation2D with resize=True
    at Sx, Sy = 96, 80 (a non-integer shrink of each axis), the net's
    probabilities replaced in both packages by the same function of the
    shrunk batch."""
    import plant3dvision_tpu.models.unet as jax_unet
    from plant3dvision_tpu.runtime import RunContext as JaxRunContext
    from plant3dvision_tpu.runtime import run_task as jax_run_task
    from plant3dvision_tpu.synth_photo import (ProceduralArabidopsis,
                                               generate_photo_scan)
    from plant3dvision_tpu_torch.models import unet
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from tests.test_torch_seg import (ML_LABELS, SEG_CFG, _fake_probs,
                                      _save_tiny_resunet, _seg_outputs)

    generate_photo_scan(temp_db, "s", n_views=3, width=150, height=110,
                        plant=ProceduralArabidopsis(n_fruits=4, seed=2),
                        with_gt_masks=False)
    _save_tiny_resunet(temp_db)
    monkeypatch.setattr(jax_unet, "segmentation_inference",
                        lambda model, params, batch, **kw: _fake_probs(batch))
    monkeypatch.setattr(unet, "segmentation_inference",
                        lambda model, batch, device=None, **kw:
                        torch.from_numpy(_fake_probs(batch)).to(device))
    cfg = {k: dict(v) for k, v in SEG_CFG.items()}
    cfg["Segmentation2D"].update(resize=True, binarize=binarize)
    jctx = JaxRunContext(temp_db, "s", cfg)
    jout = _seg_outputs(jctx.scan, jax_run_task(jctx, "Segmentation2D",
                                                report=False))
    jctx.scan.delete_fileset(jout[0])
    ctx = RunContext(temp_db, "s", cfg, device="cpu")
    out = _seg_outputs(ctx.scan, run_task(ctx, "Segmentation2D",
                                          report=False))
    assert out[0] == jout[0] and out[1] == jout[1] == ML_LABELS
    assert [o[0] for o in out[2]] == [o[0] for o in jout[2]]
    assert len(out[2]) == 3 * 6
    for (fid, png, md), (_, jpng, jmd) in zip(out[2], jout[2]):
        assert png.shape == (110, 150)
        np.testing.assert_array_equal(png, jpng, err_msg=fid)
        assert md == jmd, fid
    raw = ctx.scan.get_fileset("images").get_file("00000_rgb").get_metadata(
        "camera")
    assert out[2][0][2]["camera"] == raw
    levels = np.unique(np.stack([o[1] for o in out[2]]))
    assert len(levels) == 2 if binarize else len(levels) > 100
