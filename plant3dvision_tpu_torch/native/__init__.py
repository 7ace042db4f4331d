"""The port's native geometry module (its own copy of
plant3dvision_tpu/native): marching tetrahedra (`mc.marching_cubes`) and
the MCF mesh contraction (`mcf.contract_mesh`), C++ built by g++ at first
use and loaded with ctypes. Host code; nothing is built at import."""

from .mc import marching_cubes

__all__ = ["marching_cubes"]
