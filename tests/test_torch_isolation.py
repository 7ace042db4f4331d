"""The port stands alone: it imports neither jax nor anything of
plant3dvision_tpu (whose package __init__ sets up the JAX compile cache),
so it runs where JAX is not installed.
"""

import ast
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
    evaluation.py, the separate-task ML route's and the real-scan front
    end's modules included), of chip_smoke.py and of tools/frontend_angles.py:
    no import statement and no importlib string names jax, flax,
    scikit-learn or plant3dvision_tpu."""
    offenders = []
    paths = sorted(PORT.rglob("*.py"))
    for name in ("models/segnet.py", "synth_photo.py", "evaluation.py",
                 "ops/ml_fused.py", "tasks/fused_ml.py", "models/unet.py",
                 "models/checkpoint.py", "ops/reproject.py", "ops/masks.py",
                 "tasks/proc2d.py", "tasks/cl.py", "ops/undistort.py",
                 "ops/carving.py", "utils.py"):
        assert PORT / name in paths
    for path in paths + [ROOT / "chip_smoke.py",
                         ROOT / "tools" / "frontend_angles.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
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


def test_registries_are_separate():
    """Port tasks do not overwrite the JAX package's in one process."""
    from plant3dvision_tpu.runtime.task import TaskRegistry as JaxRegistry
    from plant3dvision_tpu_torch.runtime.task import TaskRegistry
    port = TaskRegistry.get("FusedCarving")
    jax_cls = JaxRegistry.get("FusedCarving")
    assert port.__module__ == "plant3dvision_tpu_torch.tasks.fused"
    assert jax_cls.__module__ == "plant3dvision_tpu.tasks.fused"
    assert JaxRegistry.get("FusedCarving") is jax_cls
