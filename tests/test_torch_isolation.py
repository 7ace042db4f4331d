"""The port stands alone: it imports neither jax nor anything of
plant3dvision_tpu (whose package __init__ sets up the JAX compile cache),
so it runs where JAX is not installed.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "plant3dvision_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "sklearn",
                   "plant3dvision_tpu")


def test_no_jax_or_jax_package_imports_in_the_port():
    """AST scan of every module of the port (models/, synth_photo.py,
    evaluation.py, the separate-task ML route's, the real-scan front end's,
    the calibration's, the eikonal skeleton's, Colmap's, the ChArUco
    calibration's, the meshes' and the evaluation layer's modules and the
    bin/ tools' ports included), of chip_smoke.py and
    the stand-in colmap it writes (STANDIN_COLMAP), and of
    tools/frontend_angles.py and the A/B tools (dilate_filters_ab.py,
    edt_quant_ab.py, harris_reproject_ab.py, harris_reproject_variants.py,
    undistort_carve_ab.py, trace_gather_ab.py):
    no import statement and no importlib string names jax, flax,
    scikit-learn or plant3dvision_tpu."""
    offenders = []
    paths = sorted(PORT.rglob("*.py"))
    for name in ("models/segnet.py", "synth_photo.py", "evaluation.py",
                 "ops/ml_fused.py", "tasks/fused_ml.py", "models/unet.py",
                 "models/checkpoint.py", "ops/reproject.py", "ops/masks.py",
                 "tasks/proc2d.py", "tasks/cl.py", "ops/undistort.py",
                 "ops/carving.py", "utils.py", "ops/selfcal.py",
                 "ops/sfmlite.py", "tasks/colmap.py", "ops/eikonal.py",
                 "ops/geodesics.py", "tasks/proc3d.py",
                 "colmap/read_model.py", "colmap/runner.py",
                 "calibration.py", "tasks/calibration.py", "native/mc.py",
                 "native/mcf.py", "proc3d.py", "metrics.py", "compare.py",
                 "visu.py", "visu_plotly.py", "synth.py",
                 "tasks/evaluation.py", "tasks/visualization.py",
                 "tools/robustness_evaluation.py", "tools/check_measures.py",
                 "tools/colmap_poses.py", "tools/create_charuco_board.py",
                 "tools/volume_viewer.py",
                 "tools/voronoi_texture_generator.py",
                 "tools/dash_explorer.py"):
        assert PORT / name in paths
    smoke = ast.parse((ROOT / "chip_smoke.py").read_text())
    standin, = [node.value.value for node in smoke.body
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "STANDIN_COLMAP"]
    sources = [(ROOT / "chip_smoke.py:STANDIN_COLMAP", standin)]
    for path in paths + [ROOT / "chip_smoke.py",
                         ROOT / "tools" / "frontend_angles.py",
                         ROOT / "tools" / "dilate_filters_ab.py",
                         ROOT / "tools" / "edt_quant_ab.py",
                         ROOT / "tools" / "harris_reproject_ab.py",
                         ROOT / "tools" / "harris_reproject_variants.py",
                         ROOT / "tools" / "undistort_carve_ab.py",
                         ROOT / "tools" / "trace_gather_ab.py"]:
        sources.append((path, path.read_text()))
    for path, text in sources:
        tree = ast.parse(text, filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", None) == "import_module"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_port_runs_without_loading_jax():
    """In a fresh interpreter (tests/conftest.py imports jax, so not in this
    one): import every module of the port, run a tiny CPU carve and the
    task registry, and check that no jax or plant3dvision_tpu module got
    loaded."""
    code = r"""
import pkgutil, sys
import numpy as np, torch
import plant3dvision_tpu_torch as P
for m in pkgutil.walk_packages(P.__path__, "plant3dvision_tpu_torch."):
    __import__(m.name)
from plant3dvision_tpu_torch.ops.carving import carve, pack_camera, pack_masks
from plant3dvision_tpu_torch.camera import pose_to_extrinsics
from plant3dvision_tpu_torch.runtime.task import TaskRegistry
R, t = pose_to_extrinsics([30.0, 0, 0], (0, 0, 0))
cams = torch.from_numpy(pack_camera([40.0, 40.0, 16, 16], R, t)[None])
yy, xx = np.mgrid[0:32, 0:32]
packed = torch.from_numpy(pack_masks(((xx - 16) ** 2 + (yy - 16) ** 2 < 36)[None]))
vol = carve(packed, cams, torch.ones(1, dtype=torch.bool), [-4, -4, -4], 0.5,
            (16, 16, 16), (32, 32))
assert (vol == 1).any() and (vol == -1).any()
assert TaskRegistry.get("AnglesAndInternodes").__module__.startswith(
    "plant3dvision_tpu_torch.")
assert TaskRegistry.get("TurntableCalibration").__module__ == \
    "plant3dvision_tpu_torch.tasks.colmap"
assert TaskRegistry.get("VoxelsEvaluation").__module__ == \
    "plant3dvision_tpu_torch.tasks.evaluation"
assert len(TaskRegistry._registry) == 47     # the JAX package's 47 tasks
from plant3dvision_tpu_torch.ops import selfcal, sfmlite
assert selfcal.cnc_to_cameras(np.zeros((2, 5), np.float32),
                              np.ones(9, np.float32), 64, 48).shape == (2, 16)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sklearn",
                                    "plant3dvision_tpu"))
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


RANKS_SCRIPT = r"""
import sys


def loaded(rt):
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "sklearn",
                                         "plant3dvision_tpu"))


if __name__ == "__main__":
    import numpy as np
    from plant3dvision_tpu_torch.parallel import carve_sharded, make_mesh
    from plant3dvision_tpu_torch.parallel.carving import average_grid_sharded
    with make_mesh({"dp": 2}, device="cpu", timeout_s=120) as mesh:
        masks = np.zeros((2, 8, 8), np.uint8)
        cams = np.zeros((2, 16), np.float32)
        cams[:, 15] = 10.0
        cams[:, 4] = cams[:, 8] = cams[:, 12] = 1.0
        carve_sharded(masks, cams, np.ones(2, bool), [0, 0, 0], 1.0,
                      (2, 2, 2), mesh)
        average_grid_sharded(masks.astype(np.float32), cams, np.ones(2, bool),
                             [0, 0, 0], 1.0, (2, 2, 2), mesh)
        assert mesh.run(loaded, ()) == [[], []], mesh.run(loaded, ())
    assert loaded(None) == [], loaded(None)
    print("ok")
"""


def test_spawned_ranks_load_no_jax(tmp_path):
    """A mesh's ranks (spawned processes, parallel/launch.py) run the
    sharded carve and averaging without loading jax or anything of
    plant3dvision_tpu, and neither does their controller."""
    script = tmp_path / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    out = subprocess.run([sys.executable, str(script)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_registries_are_separate():
    """Port tasks do not overwrite the JAX package's in one process."""
    from plant3dvision_tpu.runtime.task import TaskRegistry as JaxRegistry
    from plant3dvision_tpu_torch.runtime.task import TaskRegistry
    port = TaskRegistry.get("FusedCarving")
    jax_cls = JaxRegistry.get("FusedCarving")
    assert port.__module__ == "plant3dvision_tpu_torch.tasks.fused"
    assert jax_cls.__module__ == "plant3dvision_tpu.tasks.fused"
    assert JaxRegistry.get("FusedCarving") is jax_cls
