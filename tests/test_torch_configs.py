"""Which shipped configs the port runs, and the fully ported chains through
both packages on the CPU.

- Every configs/*.toml with an AnglesAndInternodes section: the task
  classes of its chain (AnglesAndInternodes and everything it requires, as
  the JAX runtime resolves them) that the port's registry lacks must be
  exactly the ones listed in MISSING, so a task that goes missing from
  the port, or one that gets ported, shows here.
- geom_pipe_synth, test_geom_pipe_virtual, ml_pipe_synth and
  geom_pipe_euler_virtual (every task of their chains is ported) through
  both packages on small synthetic scans, the port on the CPU: equal
  fileset ids for every task of the chain, the same number of angles and
  the angles within 0.05 deg (the path tests' parity). Their cuts:
  small scans; ml_pipe_synth's net replaced in both packages by the same
  probabilities (the plant's organ masks; the CNN's bfloat16 rounding
  is held to JAX in tests/test_torch_seg.py); geom_pipe_euler_virtual's
  CEM population, iterations and polish rounds cut as in
  tests/test_torch_calibration_task.py, with a box around the plant, and
  its calibration (the JAX package's) read by both. geom_pipe_synth's
  angles are held to 0.1 deg (its test says why).
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

from plant3dvision_tpu_torch.runtime import RunContext, TaskRegistry
from plant3dvision_tpu_torch.runtime import run_task

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"

#: per config, the task classes of its angle chain the port does not have
MISSING = {
    "fast_geom_pipe_real.toml": ["ExtrinsicCalibrationExists"],
    "geom_pipe_euler_virtual.toml": [],
    "geom_pipe_fast.toml": [],
    "geom_pipe_full.toml": ["Colmap", "TriangleMesh"],
    "geom_pipe_real.toml": ["Colmap"],
    "geom_pipe_real_selfcal.toml": [],
    "geom_pipe_synth.toml": [],
    "geom_pipe_virtual.toml": [],
    "ml_pipe_full.toml": ["Colmap"],
    "ml_pipe_real.toml": ["Colmap"],
    "ml_pipe_real_hybrid.toml": [],
    "ml_pipe_synth.toml": [],
    "ml_pipe_virtual.toml": [],
    "test_geom_pipe_real.toml": ["Colmap"],
    "test_geom_pipe_virtual.toml": [],
}


def _chain(ctx, name="AnglesAndInternodes"):
    """The task classes of `name` and everything it requires."""
    seen, todo = {}, [ctx.get_task(name)]
    while todo:
        t = todo.pop()
        if type(t).__name__ in seen:
            continue
        seen[type(t).__name__] = t
        req = t.requires()
        req = (list(req.values()) if isinstance(req, dict)
               else list(req) if isinstance(req, (list, tuple)) else [req])
        todo += [r for r in req if r is not None]
    return seen


def test_every_config_chain_is_ported_or_listed():
    """The angle chain of every config, resolved by the JAX runtime: the
    classes missing from the port's registry are MISSING's, and no chain
    asks CurveSkeleton for a method the port refuses ("mcf")."""
    import plant3dvision_tpu_torch.tasks  # noqa: F401 (registers the tasks)
    found = {}
    with TemporaryDB() as db:
        db.get_scan("s", create=True)
        for path in sorted(CONFIGS.glob("*.toml")):
            cfg = load_toml(path)
            if "AnglesAndInternodes" not in cfg:
                continue
            chain = _chain(JaxRunContext(db, "s", cfg))
            found[path.name] = sorted(
                n for n in chain if n not in TaskRegistry._registry)
            skel = chain.get("CurveSkeleton")
            if skel is not None:
                assert str(skel.method) in ("graph", "fim"), path.name
    assert found == MISSING


def _angles(scan, report):
    return json.loads(scan.get_fileset(report["AnglesAndInternodes"][
        "fileset"]).get_file("AnglesAndInternodes").read_raw())


def _both(db, cfg, keep=()):
    """The chain through the JAX runtime, then through the port's (on the
    CPU) after deleting the JAX outputs of every task but those in `keep`
    (which the port then reads as they are). Returns both reports and
    angle outputs."""
    out = []
    for pkg in ("jax", "port"):
        ctx = (JaxRunContext(db, "s", cfg) if pkg == "jax"
               else RunContext(db, "s", cfg, device="cpu"))
        rep = (jax_run_task if pkg == "jax" else run_task)(
            ctx, "AnglesAndInternodes", report=False)
        out.append((rep, _angles(ctx.scan, rep)))
        if pkg == "jax":
            for t, r in rep.items():
                if r["status"] == "done" and t not in keep:
                    ctx.scan.delete_fileset(r["fileset"])
    return out


def _assert_same(jax_out, port_out, min_angles, atol=0.05, keep=()):
    (jrep, jang), (rep, ang) = jax_out, port_out
    for t, r in jrep.items():
        assert rep[t]["fileset"] == r["fileset"], t
        assert rep[t]["status"] == ("skipped" if t in keep
                                    else r["status"]), t
    assert len(ang["angles"]) == len(jang["angles"]) >= min_angles
    np.testing.assert_allclose(ang["angles"], jang["angles"], rtol=0,
                               atol=atol)


def test_geom_pipe_synth_through_both_packages(temp_db):
    """Angles within 0.1 deg: the graph skeleton bins the point cloud by
    geodesic level, and the two packages' points (1e-5 apart, gradient
    rounding) put a few points in other bins (nodes 0.06 mm apart on this
    scan), which CPD carries into the refined skeleton (0.3 mm)."""
    from plant3dvision_tpu.synth import SyntheticPlant, generate_scan
    cfg = load_toml(CONFIGS / "geom_pipe_synth.toml")
    generate_scan(temp_db, "s", n_views=24, width=320, height=320, f=340.0,
                  plant=SyntheticPlant(n_fruits=12, stem_radius=2.5,
                                       fruit_radius=1.8, fruit_length=30.0,
                                       internode=6.0))
    _assert_same(*_both(temp_db, cfg), min_angles=5, atol=0.1)


def test_test_geom_pipe_virtual_through_both_packages(temp_db):
    """The config's 0.1-unit voxels, 0.6-unit bins and 0.7-unit fruits are
    a virtual plant's scale: the synthetic plant at a tenth of the
    north-star's size."""
    from plant3dvision_tpu.synth import SyntheticPlant, generate_scan
    cfg = load_toml(CONFIGS / "test_geom_pipe_virtual.toml")
    plant = SyntheticPlant(n_fruits=8, internode=0.6, stem_radius=0.2,
                           fruit_radius=0.15, fruit_length=3.0,
                           first_node=2.0, stem_height=10.5)
    generate_scan(temp_db, "s", n_views=18, width=256, height=256, f=272.0,
                  plant=plant, workspace_margin=1.5, render_step=0.025)
    _assert_same(*_both(temp_db, cfg), min_angles=3)


def test_ml_pipe_synth_through_both_packages(temp_db, monkeypatch):
    """synth.generate_ml_scan's colour-coded scan (the config's input), the
    net's probabilities replaced by the scan's own label masks."""
    import plant3dvision_tpu.models.unet as jax_unet
    from plant3dvision_tpu.fsdb import io as jio
    from plant3dvision_tpu.synth import SyntheticPlant, generate_ml_scan
    from plant3dvision_tpu_torch.models import unet
    from tests.test_torch_seg import ML_LABELS, _save_tiny_resunet

    cfg = load_toml(CONFIGS / "ml_pipe_synth.toml")
    cfg["ModelFilesetExists"] = {"scan_id": "models"}
    generate_ml_scan(temp_db, "s", n_views=12, width=256, height=256,
                     f=300.0, plant=SyntheticPlant(
                         n_fruits=8, stem_radius=2.5, fruit_radius=1.8,
                         fruit_length=30.0, internode=6.0))
    _save_tiny_resunet(temp_db)
    gt = temp_db.get_scan("s").get_fileset("gt_masks")

    def mask(v, label):
        f = gt.get_file(f"{v:05d}_{label}")
        return (jio.read_image(f) if f is not None
                else np.zeros((256, 256), np.uint8))
    probs = np.stack([np.stack([mask(v, label) for label in ML_LABELS])
                      for v in range(12)]).astype(np.uint8)
    monkeypatch.setattr(jax_unet, "segmentation_inference",
                        lambda model, params, batch, **kw: probs)
    monkeypatch.setattr(unet, "segmentation_inference",
                        lambda model, batch, device=None, **kw:
                        torch.from_numpy(probs).to(device))
    _assert_same(*_both(temp_db, cfg), min_angles=3)


def test_geom_pipe_euler_virtual_through_both_packages():
    """The port's chain reads the JAX package's TurntableCalibration (the
    same fileset id; the task itself is held to JAX in
    tests/test_torch_calibration_task.py and test_torch_calibration_ba.py),
    so both carve from the same cameras."""
    import chip_smoke
    from plant3dvision_tpu_torch.synth import SyntheticPlant
    box = {"x": [-26, 26], "y": [-26, 26], "z": [-6, 178]}
    cfg = load_toml(CONFIGS / "geom_pipe_euler_virtual.toml")
    cfg["TurntableCalibration"].update(
        f_init=1400.0 * 320 / 1440, min_matches=50, cem_pop=8, cem_iters=2,
        polish_rounds=1, bounding_box=box)
    cfg["Voxels"]["bounding_box"] = box
    keep = ("TurntableCalibration",)
    with TemporaryDB() as db:
        chip_smoke.write_turntable_scan(
            db, "s", SyntheticPlant(**chip_smoke.NORTHSTAR_PLANT), 16, 320,
            240, dist=300.0, texture_mm=3.0, density=8.0)
        _assert_same(*_both(db, cfg, keep), min_angles=0, keep=keep)
