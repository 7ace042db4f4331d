"""Live carving in the port (ops/streaming.py, the live_carve entry point,
runtime/watch.py) against the JAX package, on the CPU.

Tolerances: none. Previews and volumes are carves (integer volumes) and
must be equal; the live tool's NPZ and JSON must be those of bin/live_carve.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from plant3dvision_tpu.ops.streaming import StreamingCarver as JaxCarver
from plant3dvision_tpu.ops.streaming import _bucket as jax_bucket

from plant3dvision_tpu_torch.ops.carving import carve_plain, pack_masks
from plant3dvision_tpu_torch.ops.streaming import (StreamingCarver,
                                                   _bucket, pack_mask_row)

from tests.unit.test_ops import _synthetic_views

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ORIGIN = np.array([-20.0, -20.0, -20.0], np.float32)
SHAPE = (40, 40, 40)


def _views(n=12, seed=0):
    """tests/unit/test_streaming.py's views, each disk speckled with a few
    background pixels so that views kill voxels inside the silhouette."""
    masks, cams = _synthetic_views(n_views=n, H=128, W=128, radius=8.0,
                                   dist_cam=50.0)
    rng = np.random.default_rng(seed)
    masks = (masks != 0) & (rng.random(masks.shape) > 0.01)
    return masks, cams


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("out", ["alive", "int8"])
def test_previews_equal_jax_at_views_1_5_12(out):
    masks, cams = _views()
    jsc = JaxCarver(SHAPE, ORIGIN, 1.0, hw=(128, 128), bucket_min=4)
    sc = StreamingCarver(SHAPE, ORIGIN, 1.0, hw=(128, 128), bucket_min=4,
                         device="cpu")
    seen = []
    for k in range(12):
        jsc.add_view(masks[k], cams[k])
        sc.add_view(masks[k], cams[k])
        if k + 1 in (1, 5, 12):
            ref = _np(jsc.preview(out=out))
            got = sc.preview(out=out)
            assert got.dtype == (torch.bool if out == "alive" else torch.int8)
            np.testing.assert_array_equal(_np(got), ref)
            seen.append(int((got == 1).sum()))
    assert sc.n_views == jsc.n_views == 12
    assert seen[0] > seen[1] > seen[2] > 0        # previews narrow the hull
    # the last preview is the batch carve
    want = carve_plain(torch.from_numpy(pack_masks(masks)),
                       torch.from_numpy(cams), torch.ones(12, dtype=torch.bool),
                       ORIGIN, 1.0, SHAPE, (128, 128))
    np.testing.assert_array_equal(_np(sc.preview(out="int8")), _np(want))


def test_packed_rows_tensors_and_buffer_growth():
    """Pre-packed rows (FusedCarving's ingest format), numpy masks and
    tensor masks give the JAX previews; 40 views grow the buffers past
    their first 16 rows twice."""
    masks, cams = _synthetic_views(n_views=40, H=64, W=96, radius=6.0,
                                   dist_cam=50.0)
    shape = (30, 30, 30)
    origin = np.full(3, -15.0, np.float32)
    jsc = JaxCarver(shape, origin, 1.0, hw=(64, 96), bucket_min=4)
    scs = [StreamingCarver(shape, origin, 1.0, hw=(64, 96), device="cpu")
           for _ in range(3)]
    for k in range(40):
        row = np.packbits((masks[k] != 0).reshape(-1))
        jsc.add_view(row, cams[k])
        scs[0].add_view(row, cams[k])
        scs[1].add_view(masks[k], cams[k])
        scs[2].add_view(torch.from_numpy(masks[k] != 0), cams[k])
    ref = _np(jsc.preview(out="int8"))
    for sc in scs:
        np.testing.assert_array_equal(_np(sc.preview(out="int8")), ref)
        assert sc.n_views == 40 and len(sc._packed) == 64
    np.testing.assert_array_equal(
        pack_mask_row(torch.from_numpy(masks[3] != 0)).numpy(),
        np.packbits((masks[3] != 0).reshape(-1)))


def test_camera_metadata_dicts_are_accepted():
    masks, cams = _views(n=3)
    md = [{"camera_model": {"params": [float(v) for v in c[:4]]},
           "rotmat": c[4:13].reshape(3, 3).tolist(),
           "tvec": c[13:16].tolist()} for c in cams]
    a = StreamingCarver(SHAPE, ORIGIN, 1.0, hw=(128, 128), device="cpu")
    b = StreamingCarver(SHAPE, ORIGIN, 1.0, hw=(128, 128), device="cpu")
    for k in range(3):
        a.add_view(masks[k], md[k])
        b.add_view(masks[k], cams[k])
    assert torch.equal(a.preview(), b.preview())


@pytest.mark.parametrize("case", ["empty", "mask_shape", "mask_kind",
                                  "camera"])
def test_same_value_errors_as_jax(case):
    masks, cams = _views(n=1)

    def call(sc):
        if case == "empty":
            sc.preview()
        elif case == "mask_shape":
            sc.add_view(masks[0][:100], cams[0])
        elif case == "mask_kind":
            sc.add_view(masks[0][None], cams[0])
        else:
            sc.add_view(masks[0], cams[0][:12])

    for sc in (JaxCarver(SHAPE, ORIGIN, 1.0, hw=(128, 128)),
               StreamingCarver(SHAPE, ORIGIN, 1.0, hw=(128, 128),
                               device="cpu")):
        with pytest.raises(ValueError) as err:
            call(sc)
        msg = str(err.value)
        if isinstance(sc, JaxCarver):
            want = msg
        else:
            assert msg == want


def test_a_packed_row_of_another_length_is_refused():
    sc = StreamingCarver(SHAPE, ORIGIN, 1.0, hw=(128, 128), device="cpu")
    with pytest.raises(ValueError, match="need 2048"):
        sc.add_view(np.zeros(2047, np.uint8), np.zeros(16, np.float32))


def test_bucket():
    ns = (1, 3, 4, 5, 8, 9, 33)
    assert [_bucket(n, 4) for n in ns] == [jax_bucket(n, 4) for n in ns] == \
        [4, 4, 4, 8, 8, 16, 64]
    assert _bucket(5, 0) == jax_bucket(5, 0) == 8


# -- the live_carve tool ---------------------------------------------------------

@pytest.fixture()
def synth_scan(tmp_path):
    """tests/integration/test_live_carve.py's scan (12 views, 160x160)."""
    from plant3dvision_tpu.fsdb import FSDB
    from plant3dvision_tpu.synth import SyntheticPlant, generate_scan

    (tmp_path / "romidb").touch()
    db = FSDB(tmp_path)
    db.connect(unsafe=True)
    plant = SyntheticPlant(n_fruits=6, stem_radius=2.5, fruit_radius=1.8,
                           fruit_length=20.0, internode=6.0)
    generate_scan(db, "live", n_views=12, width=160, height=160, f=210.0,
                  plant=plant)
    bbox = db.get_scan("live").get_metadata("bounding_box")
    db.disconnect()
    return tmp_path / "live", bbox


def _live(cmd, scan_dir, bbox, out, extra=()):
    bbox_arg = ",".join(str(v) for ax in ("x", "y", "z") for v in bbox[ax])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [*cmd, str(scan_dir), f"--bbox={bbox_arg}", "--voxel-size", "1.0",
         "--filter", "linear", "--threshold", "0.3", "--every", "5",
         "--idle-stop", "2", "--poll", "0.2", "--out", str(out), *extra],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_live_carve_matches_bin_live_carve(synth_scan, tmp_path):
    scan_dir, bbox = synth_scan
    jout, pout = tmp_path / "jax.npz", tmp_path / "port.npz"
    report = tmp_path / "report.json"
    _live([sys.executable, str(REPO / "bin" / "live_carve")], scan_dir,
          bbox, jout)
    text = _live([sys.executable, "-m", "plant3dvision_tpu_torch.live_carve"],
                 scan_dir, bbox, pout,
                 ("--device", "cpu", "--report", str(report)))
    assert json.loads(pout.with_suffix(".json").read_text()) == json.loads(
        jout.with_suffix(".json").read_text())
    meta = json.loads(pout.with_suffix(".json").read_text())
    assert meta["n_views"] == 12 and meta["state"] == "final"
    live, ref = np.load(pout)["volume"], np.load(jout)["volume"]
    assert live.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(live, ref)
    assert live.sum() > 100                      # a plant carved out
    assert "final volume at 12 views" in text
    rep = json.loads(report.read_text())
    assert rep["n_views"] == 12 and rep["previews"][-1]["state"] == "final"
    assert rep["previews"][0]["n_views"] >= 5


def test_read_rgb_reads_like_cv2_imread(tmp_path):
    """Gray, RGB and RGBA PNGs: the port's codec gives cv2.imread's three
    colour channels (gray replicated, alpha dropped)."""
    cv2 = pytest.importorskip("cv2")
    from plant3dvision_tpu_torch.live_carve import read_rgb
    rng = np.random.default_rng(1)
    for shape in ((20, 30), (20, 30, 3), (20, 30, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = tmp_path / f"im{len(shape)}_{shape[-1]}.png"
        cv2.imwrite(str(path), img)
        want = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(read_rgb(path), want)


# -- the watcher ---------------------------------------------------------------

def test_watcher():
    """tests/unit/test_runtime.py:174's scenario on the port's fsdb."""
    import time

    from plant3dvision_tpu_torch.fsdb.testing import TemporaryDB
    from plant3dvision_tpu_torch.runtime.watch import FSDBWatcher
    with TemporaryDB() as db:
        seen = []
        w = FSDBWatcher(db, seen.append, poll_interval=0.05)
        w.start()
        db.create_scan("newscan")
        deadline = time.time() + 3
        while not seen and time.time() < deadline:
            time.sleep(0.05)
        w.stop()
        assert seen == ["newscan"]
