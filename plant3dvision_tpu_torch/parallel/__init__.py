"""Multi-rank programs of the port (port of plant3dvision_tpu/parallel/).

The JAX package shards over a `jax.sharding.Mesh` from one controlling
process; the port keeps that model over `torch.distributed`: a `Mesh` is a
pool of rank processes driven by the controller (launch.py, mesh.py), and
- the carve is sharded over views, over x-slabs of the grid, or both, and
  the averaging volume over x-slabs (carving.py, carving_mp.py);
- the CNN trainers run dp over the batch and tp over convolution output
  channels (train.py); dp serving is models/unet.segmentation_inference's.
"""

from .carving import carve_sharded
from .mesh import make_mesh
from .train import make_train_step

__all__ = ["make_mesh", "carve_sharded", "make_train_step"]
