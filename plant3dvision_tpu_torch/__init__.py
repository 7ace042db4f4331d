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

import torch as _torch

# MKL's vector math library (torch's CPU sqrt, exp, log, ... of a float
# tensor) sets up its dispatch at its first call. When that first call
# comes from the threads of one parallel region at once, a thread can
# compute its share of the tensor with a coarse kernel: sqrt(1.0) gave
# 0.99975586 on one thread's eighth of a tensor in 4 to 8 of 20-25 fresh
# processes on a loaded 8-core machine, and the signed distance, the
# point cloud and the angles after it moved with it. One call from this
# thread on a tensor too small to split sets the dispatch up first, so
# that the plain versions give the same bits in every process.
for _dt in (_torch.float32, _torch.float64):
    _torch.sqrt(_torch.ones(8, dtype=_dt))
del _dt
