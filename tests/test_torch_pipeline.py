"""The geometric main path (configs/geom_pipe_fast.toml) through both
packages' task runtimes on one small synthetic scan (24 views at 320x320),
the port on the CPU (its kernels' plain versions).

- FusedCarving volume: bit-equal (exact carve, exact group merge).
- Fileset ids: equal for every task (same names, parameters, significance).
- AnglesAndInternodes: equal angle count, angles within 0.05 deg. The
  point clouds agree to ~1e-5 (gradient rounding), and CPD carries that
  into the refined skeleton; on this scan the result stays well inside
  0.05 deg. (ROADMAP.md Queue C records a scan where CPD's stop test, which
  reads float32 rounding, ends an iteration apart and the angles differ by
  about a degree.)
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from plant3dvision_tpu.fsdb.testing import TemporaryDB
from plant3dvision_tpu.runtime import RunContext as JaxRunContext
from plant3dvision_tpu.runtime import run_task as jax_run_task
from plant3dvision_tpu.runtime.config import load_toml
from plant3dvision_tpu.synth import SyntheticPlant, generate_scan

from plant3dvision_tpu_torch.runtime import RunContext, run_task

torch.set_num_threads(1)

CONFIG = Path(__file__).resolve().parent.parent / "configs" / \
    "geom_pipe_fast.toml"
TASKS = ("FusedCarving", "PointCloud", "CurveSkeleton", "RefineSkeleton",
         "TreeGraph", "AnglesAndInternodes")


def _outputs(scan, report):
    fs = scan.get_fileset(report["FusedCarving"]["fileset"])
    vol = np.load(fs.get_files()[0].path())["volume"]
    meta = fs.get_files()[0].get_metadata()
    angles = json.loads(scan.get_fileset(
        report["AnglesAndInternodes"]["fileset"]).get_file(
        "AnglesAndInternodes").read_raw())
    return vol, meta, angles


def test_geom_pipe_fast_matches_jax():
    cfg = load_toml(CONFIG)
    cfg["Clean"] = {"no_confirm": True}
    plant = SyntheticPlant(n_fruits=12, stem_radius=2.5, fruit_radius=1.8,
                           fruit_length=30.0, internode=6.0)
    with TemporaryDB() as db:
        generate_scan(db, "s", n_views=24, width=320, height=320, f=340.0,
                      plant=plant)
        jctx = JaxRunContext(db, "s", cfg)
        jrep = jax_run_task(jctx, "AnglesAndInternodes", report=False)
        jvol, jmeta, jang = _outputs(jctx.scan, jrep)
        jax_run_task(jctx, "Clean", report=False)
        assert not [f for f in jctx.scan.list_filesets()
                    if f.startswith(TASKS)]

        ctx = RunContext(db, "s", cfg, device="cpu")
        rep = run_task(ctx, "AnglesAndInternodes", report=False)
        vol, meta, ang = _outputs(ctx.scan, rep)

    for t in TASKS:
        assert rep[t]["status"] == "done"
        assert rep[t]["fileset"] == jrep[t]["fileset"], t
    assert vol.dtype == jvol.dtype == np.int32
    np.testing.assert_array_equal(vol, jvol)
    assert meta == jmeta
    assert len(ang["angles"]) == len(jang["angles"]) > 5
    np.testing.assert_allclose(ang["angles"], jang["angles"], atol=0.05,
                               rtol=0)
    np.testing.assert_allclose(ang["internodes"], jang["internodes"],
                               atol=0.05, rtol=0)


def test_fused_carving_groups_merge_exactly():
    """3 overlapped view groups (7+7+6 views) give the single-pass volume
    (the merge of tasks/fused.py), as in the JAX package."""
    base = {"upstream_task": "ImagesFilesetExists",
            "camera_metadata": "camera", "voxel_size": 1.0, "type": "linear",
            "parameters": [1.0, 0.0, 0.0], "threshold": 0.3, "dilation": 0}
    plant = SyntheticPlant(n_fruits=6, stem_radius=2.5, fruit_radius=1.8,
                           fruit_length=20.0, internode=7.0)
    vols = []
    with TemporaryDB() as db:
        generate_scan(db, "s", n_views=20, width=160, height=160, f=200.0,
                      plant=plant)
        for groups, chunk in ((1, 32), (3, 4)):
            cfg = {"FusedCarving": dict(base, overlap_groups=groups,
                                        chunk_views=chunk)}
            ctx = RunContext(db, "s", cfg, device="cpu")
            ctx.scan.delete_fileset(ctx.get_task("FusedCarving").task_id())
            run_task(ctx, "FusedCarving", report=False)
            f = ctx.scan.get_fileset(
                ctx.get_task("FusedCarving").task_id()).get_files()[0]
            vols.append(np.load(f.path())["volume"])
    np.testing.assert_array_equal(vols[0], vols[1])
    assert (vols[0] == 1).sum() > 100 and (vols[0] == -1).sum() > 100


def test_run_context_defaults_to_cuda():
    """No device given means the card; without one it raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_cuda.py "
                    "covers the default there")
    with TemporaryDB() as db:
        with pytest.raises(RuntimeError, match="cuda"):
            RunContext(db, "s")
        assert RunContext(db, "s", device="cpu").device.type == "cpu"


def test_cli_runs_a_task_on_the_cpu(tmp_path):
    from plant3dvision_tpu_torch.fsdb import FSDB
    from plant3dvision_tpu_torch.runtime.cli import main
    from plant3dvision_tpu_torch.synth import SyntheticPlant as PortPlant
    from plant3dvision_tpu_torch.synth import generate_scan as port_scan

    (tmp_path / "romidb").touch()
    db = FSDB(tmp_path)
    db.connect(unsafe=True)
    port_scan(db, "s", n_views=8, width=96, height=96, f=120.0,
              plant=PortPlant(n_fruits=3, fruit_length=12.0))
    db.disconnect()
    cfg = tmp_path / "cfg.toml"
    cfg.write_text('[FusedCarving]\nupstream_task = "ImagesFilesetExists"\n'
                   'voxel_size = 2.0\nparameters = "[1.0, 0.0, 0.0]"\n')
    assert main(["FusedCarving", str(tmp_path / "s"), "--config", str(cfg),
                 "--device", "cpu"]) == 0
    assert [p.name for p in (tmp_path / "s").iterdir()
            if p.name.startswith("FusedCarving_")]
