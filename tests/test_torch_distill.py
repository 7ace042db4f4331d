"""The port's distillation and training data paths (models/distill.py,
models/train_synth.py's training set, models/train.py's load_dataset and
CLI) held to the JAX package on the CPU, at a small size.

The host functions (labelling, pseudo-label rendering, crops, the
rendered training set, the dataset loader) are numpy in both packages and
equal; the held-out IoU (the tiled argmax and K23's counts) equal for the
same weights in float32; a tiny distill_scan and the training CLI run end
to end through the port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plant3dvision_tpu.models import distill as jdistill
from plant3dvision_tpu_torch.models import distill as pdistill



@pytest.fixture(autouse=True)
def _two_threads():
    """Two CPU threads for every test of this file, whatever other test
    modules set at import."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tree(rng, n=30):
    import networkx as nx
    from plant3dvision_tpu_torch.traits.graph import Graph
    pos = rng.normal(0, 10, (n, 3))
    labels = [["fruit"] if rng.random() < 0.4 else
              (["node"] if rng.random() < 0.5 else ["stem"])
              for _ in range(n)]
    jt, pt = nx.Graph(), Graph()
    for i in range(n):
        jt.add_node(i, position=pos[i].tolist(), labels=labels[i])
        pt.add_node(i, position=pos[i].tolist(), labels=labels[i])
    return jt, pt


def test_label_points_from_tree_equals_jax():
    rng = np.random.default_rng(0)
    jt, pt = _tree(rng)
    pts = rng.normal(0, 12, (5000, 3)).astype(np.float32)
    a = pdistill.label_points_from_tree(pts, pt)
    assert a.dtype == np.uint8 and set(np.unique(a)) == {1, 2}
    np.testing.assert_array_equal(a, jdistill.label_points_from_tree(pts, jt))


def _cams(V, W, H, f=120.0):
    from plant3dvision_tpu_torch.camera import pose_to_extrinsics
    from plant3dvision_tpu_torch.ops.carving import pack_camera
    cams = []
    for v in range(V):
        a = 2 * np.pi * v / V
        R, t = pose_to_extrinsics(np.array([60 * np.cos(a), 60 * np.sin(a),
                                            10.0]), (0, 0, 0))
        cams.append(pack_camera([f, f, W / 2, H / 2], R, t))
    return np.stack(cams)


@pytest.mark.parametrize("dilate", [0, 2])
def test_render_pseudo_labels_equals_jax(dilate):
    rng = np.random.default_rng(1)
    V, H, W = 4, 48, 64
    pts = rng.normal(0, 6, (3000, 3)).astype(np.float32)
    plab = rng.integers(1, 3, 3000).astype(np.uint8)
    masks = rng.random((V, H, W)) < 0.5
    cams = _cams(V, W, H)
    a = pdistill.render_pseudo_labels(pts, plab, cams, masks, dilate=dilate)
    b = jdistill.render_pseudo_labels(pts, plab, cams, masks, dilate=dilate)
    assert set(np.unique(a)) == {0, 1, 2, 255}
    np.testing.assert_array_equal(a, b)


def test_build_crops_equals_jax():
    rng = np.random.default_rng(2)
    V, H, W = 3, 96, 128
    imgs = rng.integers(0, 256, (V, H, W, 3)).astype(np.uint8)
    lm = rng.choice([0, 1, 2, 255], (V, H, W), p=[0.7, 0.1, 0.1, 0.1]) \
        .astype(np.uint8)
    for kw in ({"crop": 32, "per_view": 4}, {"crop": 64, "per_view": 2,
                                             "bg_per_view": 1, "seed": 3}):
        a = pdistill.build_crops(imgs, lm, **kw)
        b = jdistill.build_crops(imgs, lm, **kw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_build_training_set_equals_jax():
    """One procedural plant, two views, crops of 64 (the renders at the
    JAX package's 896): equal crops, labels and sources."""
    from plant3dvision_tpu.models.train_synth import \
        build_training_set as jbuild
    from plant3dvision_tpu_torch.models.train_synth import build_training_set
    kw = dict(n_procedural=1, views_per_plant=2, crop=64, crops_per_view=2,
              density=20.0, seed=1, include_fixture_obj=False)
    rgb, lab, meta = build_training_set(**kw)
    jrgb, jlab, jmeta = jbuild(**kw)
    assert rgb.shape == (4, 64, 64, 3) and lab.dtype == np.int8
    np.testing.assert_array_equal(rgb, jrgb)
    np.testing.assert_array_equal(lab, jlab)
    assert {k: v for k, v in meta.items() if k != "build_seconds"} == \
        {k: v for k, v in jmeta.items() if k != "build_seconds"}
    assert (lab > 0).any()


def _photo_db(tmp_path, n_views=3, size=128):
    from plant3dvision_tpu_torch.fsdb import FSDB
    from plant3dvision_tpu_torch.synth_photo import (ML_LABELS,
                                                     generate_photo_scan)
    (tmp_path / "romidb").touch()
    db = FSDB(tmp_path)
    db.connect(unsafe=True)
    generate_photo_scan(db, "s", n_views=n_views, width=size, height=size,
                        density=20.0, gt_fileset="gt_masks")
    db.get_scan("s").get_fileset("gt_masks").set_metadata(
        "label_names", list(ML_LABELS))
    db.disconnect()
    return tmp_path


def test_load_dataset_equals_jax(tmp_path):
    """load_dataset on a photo scan with per-organ GT masks (labels from
    the fileset's label_names): equal images (numpy's true division by
    255), labels and names."""
    from plant3dvision_tpu.fsdb import FSDB as JFSDB
    from plant3dvision_tpu.models.train import load_dataset as jload
    from plant3dvision_tpu_torch.fsdb import FSDB
    from plant3dvision_tpu_torch.models.train import load_dataset
    path = _photo_db(tmp_path)
    db = FSDB(path)
    db.connect(unsafe=True)
    imgs, labs, names = load_dataset(db.get_scan("s"), "gt_masks",
                                     max_images=2)
    db.disconnect()
    jdb = JFSDB(path)
    jdb.connect(unsafe=True)
    jimgs, jlabs, jnames = jload(jdb.get_scan("s"), "gt_masks", max_images=2)
    jdb.disconnect()
    assert imgs.shape == (2, 128, 128, 3) and imgs.dtype == np.float32
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labs, jlabs)
    assert names == jnames and (labs > 0).any()


def test_train_cli_writes_model_both_packages_load(tmp_path):
    """`python -m plant3dvision_tpu_torch.models.train` (main) on the
    photo scan with a [Training] config: trains on the CPU, writes the
    model into the scan's models fileset with its label_names, removes the
    training state, and the JAX package's load_model reads the result."""
    from plant3dvision_tpu.fsdb import FSDB as JFSDB
    from plant3dvision_tpu.models.checkpoint import load_model as jload
    from plant3dvision_tpu_torch.models import train as ptrain
    path = _photo_db(tmp_path, n_views=4)
    cfg = tmp_path / "train.toml"
    cfg.write_text('[Training]\ngt_fileset = "gt_masks"\nepochs = 2\n'
                   'batch_size = 2\nlearning_rate = 1e-3\nwidths = "8,16"\n'
                   'model_id = "tiny_seg"\ncheckpoint_every = 1\n')
    assert ptrain.main([str(path / "s"), "--config", str(cfg),
                        "--device", "cpu"]) == 0
    jdb = JFSDB(path)
    jdb.connect(unsafe=True)
    fs = jdb.get_scan("s").get_fileset("models")
    assert fs.get_file("tiny_seg_trainstate") is None
    f = fs.get_file("tiny_seg")
    model, params, config = jload(f)
    assert config["widths"] == [8, 16] and len(config["label_names"]) == 6
    assert f.get_metadata("label_names") == config["label_names"]
    out = model.apply(params, jnp.zeros((1, 32, 32, 3)))
    assert out.shape == (1, 32, 32, 6) and np.isfinite(np.asarray(out)).all()
    jdb.disconnect()


def test_heldout_iou_equals_jax():
    """_heldout_iou for the same float32 weights: the port's tiled argmax
    on the device and K23's counts (its plain version here) against the
    JAX package's, on views of 96x160 (tiles of 448 cover a view) with
    ignored pixels."""
    from plant3dvision_tpu.models.unet import ResUNet
    from plant3dvision_tpu_torch.models.checkpoint import state_dict_from_flax
    from plant3dvision_tpu_torch.models.unet import ResUNet as PResUNet
    rng = np.random.default_rng(4)
    jm = ResUNet(n_classes=3, widths=(8, 16), blocks_per_stage=1,
                 dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1),
                                              jnp.zeros((1, 32, 32, 3))))
    pm = PResUNet(n_classes=3, widths=(8, 16), blocks_per_stage=1,
                  dtype=torch.float32)
    pm.load_state_dict(state_dict_from_flax(params))
    imgs = rng.integers(0, 256, (2, 96, 160, 3)).astype(np.uint8)
    lm = rng.choice([0, 1, 2, 255], (2, 96, 160)).astype(np.uint8)
    cfg = {"label_names": pdistill.LABELS_REAL, "widths": [8, 16],
           "blocks_per_stage": 1}

    import plant3dvision_tpu.models.checkpoint as jck
    orig = jck.model_from_config
    jck.model_from_config = lambda c: jm
    try:
        want = jdistill._heldout_iou(params, cfg, imgs, lm)
    finally:
        jck.model_from_config = orig
    got = pdistill._heldout_iou(pm, imgs, lm)
    assert got == want and len(got) == 3


def test_distill_scan_runs_tiny(tmp_path):
    """distill_scan on a 28-view 640x480 front-end scan (phase 9's path at
    1 mm), with 25 training steps of a tiny ResUNet on 64-pixel crops, on
    the CPU: pseudo-labels with both organs, a finite loss, a held-out
    IoU for the labels that occur, the config and report of the JAX
    package's layout."""
    import chip_smoke
    from plant3dvision_tpu_torch.fsdb.testing import TemporaryDB
    from plant3dvision_tpu_torch.runtime.config import RunContext
    from plant3dvision_tpu_torch.synth import SyntheticPlant
    cfg = chip_smoke.frontend_config(1.0)
    cfg["Voxels"]["bounding_box"] = {"x": [-40, 40], "y": [-40, 40],
                                     "z": [-5, 175]}
    with TemporaryDB() as db:
        chip_smoke.write_distorted_scan(
            db, "s", SyntheticPlant(**chip_smoke.NORTHSTAR_PLANT), 28, 640,
            480, 1400.0 * 640 / 1440, incorrect=(3,))
        ctx = RunContext(db, "s", cfg, device="cpu")
        model, config, report = pdistill.distill_scan(
            ctx, crop=64, per_view=2, steps=25, batch_size=4,
            widths=(8, 16), blocks_per_stage=1)
    st = report["stats"]
    assert st["views"] > 20 and 0 < st["fruit_point_fraction"] < 1
    assert st["labeled_plant_px_per_view"] > 0
    assert np.isfinite(report["history"][0]["loss"])
    assert report["heldout_iou"] and all(0 <= v <= 1 for v in
                                         report["heldout_iou"].values())
    assert config["label_names"] == pdistill.LABELS_REAL
    assert config["distill"]["heldout_iou"] == report["heldout_iou"]
    json.dumps(config)
