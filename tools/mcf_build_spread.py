"""How far the MCF contraction moves between two builds of geometry.cpp.

The port builds native/geometry.cpp at first use with `g++ -O3
-march=native`; the JAX package ships a library that was compiled once, on
another machine (plant3dvision_tpu/native/libp3dgeom.so). The float32
conjugate-gradient solve of the contraction amplifies the last bits that
the two compilations round differently. This script contracts the mesh of
tests/test_torch_mesh.py (pcd2mesh of a seeded 1500-point ellipsoid,
3 x 2.5 x 8, voxel 1.0; 6 iterations) with:

- the port's own build (native/mc.py:lib),
- the JAX package's geometry.cpp built here with the port's flags,
- the committed libp3dgeom.so, loaded with ctypes,

and prints one JSON line: the largest absolute differences between them
and the compiler and CPU they ran on. It imports nothing of JAX and runs
on any host with g++ (about 10 s).

    python tools/mcf_build_spread.py
"""

from __future__ import annotations

import json
import platform
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

JAX_SOURCE = ROOT / "plant3dvision_tpu" / "native" / "geometry.cpp"
JAX_BINARY = ROOT / "plant3dvision_tpu" / "native" / "libp3dgeom.so"


def test_mesh():
    """tests/test_torch_mesh.py:_mesh()."""
    from plant3dvision_tpu_torch.fsdb.geometry import PointCloud
    from plant3dvision_tpu_torch.proc3d import pcd2mesh
    rng = np.random.default_rng(0)
    d = rng.standard_normal((1500, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = d * np.array((3.0, 2.5, 8.0))
    return pcd2mesh(PointCloud(pts, d), voxel_size=1.0, device="cpu")


def main():
    from plant3dvision_tpu_torch.native import mc
    from plant3dvision_tpu_torch.native.mcf import contract_with
    mesh = test_mesh()
    v, t = mesh.vertices, mesh.triangles
    port = contract_with(mc.lib(), v, t, iterations=6)
    with tempfile.TemporaryDirectory() as d:
        same_flags = contract_with(mc.load(mc.compile_library(
            JAX_SOURCE, Path(d) / "libgeom.so")), v, t, iterations=6)
    committed = contract_with(mc.load(JAX_BINARY), v, t, iterations=6)
    cxx = subprocess.run([mc.CXX, "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    cpu = ""
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                cpu = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    print(json.dumps({
        "vertices": int(len(v)), "triangles": int(len(t)),
        "port_vs_jax_source_same_flags": float(np.abs(port - same_flags).max()),
        "port_vs_committed_binary": float(np.abs(port - committed).max()),
        "contracted_by": float(np.abs(port - v).max()),
        "cxx": cxx, "flags": " ".join(mc.CXX_FLAGS), "cpu": cpu,
        "machine": platform.machine()}))


if __name__ == "__main__":
    main()
