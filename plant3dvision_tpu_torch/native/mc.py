"""The native geometry module: build, load, and marching tetrahedra.

The port's own copy of plant3dvision_tpu/native (mc.py): `geometry.cpp`
beside this file is built at first use by `g++` with the JAX package's
flags into `native/_build/<hash>/libp3dgeom.so` (gitignored; the hash
covers the source, the flags and what `-march=native` means on this
machine, so an edit or another CPU rebuilds) and loaded with ctypes. A
failed build raises: the main path has no numpy fallback.
`_marching_tetrahedra_numpy` is the plain version of the extraction (the
same algorithm and float32 arithmetic in numpy), which the tests hold the
library to. Host code: nothing here runs on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..fsdb.geometry import TriangleMesh

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "geometry.cpp"
BUILD_ROOT = _HERE / "_build"
#: the compiler and the JAX package's flags (plant3dvision_tpu/native/mc.py)
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _build_dir() -> Path:
    target = subprocess.run([CXX, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True)
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(target.stdout.encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Build the library if it is not built yet; returns the path of the
    .so. Raises RuntimeError with the compiler's output if the build
    fails (or the compiler is missing)."""
    try:
        out_dir = _build_dir()
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"native geometry build failed: cannot run "
                           f"{CXX} ({e})") from e
    so = out_dir / "libp3dgeom.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        compile_library(SOURCE, tmp)
        os.replace(tmp, so)
    return so


def compile_library(source, so_path) -> Path:
    """`source` compiled by CXX with CXX_FLAGS into `so_path`; raises
    RuntimeError with the compiler's output if the build fails."""
    proc = subprocess.run([CXX, *CXX_FLAGS, str(source), "-o", str(so_path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("native geometry build failed:\n"
                           + proc.stdout + proc.stderr)
    return Path(so_path)


def load(so_path) -> ctypes.CDLL:
    """The library at `so_path` (this module's build, or another build
    of the same source), its entry points' argtypes set."""
    so = ctypes.CDLL(str(so_path))
    so.p3d_marching_tetrahedra.restype = ctypes.c_int
    so.p3d_marching_tetrahedra.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    so.p3d_mcf_contract.restype = ctypes.c_int
    so.p3d_mcf_contract.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int), ctypes.c_longlong,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    so.p3d_free.restype = None
    so.p3d_free.argtypes = [ctypes.c_void_p]
    return so


def lib() -> ctypes.CDLL:
    """The loaded library (built first if needed)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def marching_cubes(volume, level: float = 0.0) -> TriangleMesh:
    """Isosurface of `volume` at `level` (inside = values > level) by the
    native marching tetrahedra, vertices in index coordinates (i, j, k);
    callers map them to world with proc3d.index2point."""
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    native = lib()
    nx, ny, nz = vol.shape
    pv = ctypes.POINTER(ctypes.c_float)()
    pt = ctypes.POINTER(ctypes.c_int)()
    nv = ctypes.c_longlong()
    nt = ctypes.c_longlong()
    rc = native.p3d_marching_tetrahedra(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, nz, ctypes.c_float(level),
        ctypes.byref(pv), ctypes.byref(nv), ctypes.byref(pt), ctypes.byref(nt))
    if rc != 0:
        raise MemoryError("p3d_marching_tetrahedra failed")
    verts = np.ctypeslib.as_array(pv, shape=(nv.value * 3,)).reshape(-1, 3).copy()
    tris = np.ctypeslib.as_array(pt, shape=(nt.value * 3,)).reshape(-1, 3).copy()
    native.p3d_free(pv)
    native.p3d_free(pt)
    return TriangleMesh(verts.astype(np.float64), tris.astype(np.int64))


# -- the plain version: the same algorithm in numpy, in geometry.cpp's
#    float32 arithmetic and cell order, so it gives the same vertices and
#    triangles ---------------------------------------------------------------

_TETS = np.array([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
                  [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]])
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]])


def _marching_tetrahedra_numpy(vol, level):
    vol = np.asarray(vol, np.float32)
    nx, ny, nz = vol.shape
    # global ids of cube corners for every cell
    gx, gy, gz = np.mgrid[0:nx - 1, 0:ny - 1, 0:nz - 1]
    cells = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    strides = np.array([ny * nz, nz, 1])
    corner_gids = (cells[:, None, :] + _CORNERS[None, :, :]) @ strides  # (C, 8)
    vals = vol.reshape(-1)[corner_gids]
    mixed = (vals > level).any(axis=1) & (vals <= level).any(axis=1)
    corner_gids = corner_gids[mixed]

    flat = vol.reshape(-1)
    verts_map: dict[tuple, int] = {}
    verts: list = []
    tris: list = []

    def pos(g):     # float32 lattice position, as geometry.cpp's V3
        return np.array([g // (ny * nz), (g // nz) % ny, g % nz],
                        dtype=np.float32)

    def edge_point(a, b):
        if a > b:
            a, b = b, a
        key = (a, b)
        if key in verts_map:
            return verts_map[key]
        va, vb = flat[a], flat[b]
        t = np.clip((np.float32(level) - va) / (vb - va), np.float32(0.0),
                    np.float32(1.0))
        verts.append(pos(a) + t * (pos(b) - pos(a)))
        verts_map[key] = len(verts) - 1
        return verts_map[key]

    def orient(a, b, c, d):
        pa, pb, pc, pd = pos(a), pos(b), pos(c), pos(d)
        return np.linalg.det(np.stack([pb - pa, pc - pa, pd - pa]))

    for g8 in corner_gids:
        for tet in _TETS:
            p = g8[tet]
            inside = flat[p] > level
            n_in = int(inside.sum())
            if n_in in (0, 4):
                continue
            ins = p[inside]
            outs = p[~inside]
            if n_in == 1:
                e = [edge_point(ins[0], o) for o in outs]
                if orient(ins[0], *outs) > 0:
                    tris.append(e)
                else:
                    tris.append([e[0], e[2], e[1]])
            elif n_in == 3:
                e = [edge_point(outs[0], i) for i in ins]
                if orient(outs[0], *ins) > 0:
                    tris.append([e[0], e[2], e[1]])
                else:
                    tris.append(e)
            else:
                a = edge_point(ins[0], outs[0])
                b = edge_point(ins[0], outs[1])
                c = edge_point(ins[1], outs[1])
                d = edge_point(ins[1], outs[0])
                if orient(ins[0], ins[1], outs[0], outs[1]) > 0:
                    tris.append([a, b, c])
                    tris.append([a, c, d])
                else:
                    tris.append([a, c, b])
                    tris.append([a, d, c])

    v = np.array(verts, np.float64) if verts else np.zeros((0, 3))
    t = (np.array(tris, dtype=np.int64) if tris
         else np.zeros((0, 3), dtype=np.int64))
    return TriangleMesh(v, t)
