"""plant3dvision_tpu_torch — the PyTorch + CUDA port of plant3dvision_tpu.

Same task names, parameters, TOML configs and FSDB filesets as the JAX
package (which stays the reference); the compute runs in PyTorch on one
NVIDIA H100, with the hot kernels hand-written in CUDA C++ for Hopper
(`kernels/csrc/`). Every kernel keeps a plain PyTorch version beside its
wrapper: a CPU tensor goes to the plain version, a CUDA tensor to the
kernel.

This package imports torch, numpy, scipy and the standard library only —
never jax, and nothing of `plant3dvision_tpu`.
"""

__version__ = "0.1.0"
