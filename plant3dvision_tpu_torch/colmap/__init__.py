"""COLMAP SfM integration (port of plant3dvision_tpu/colmap).

COLMAP stays a host-side external engine, as in the JAX package: the model
file readers and writers (`read_model`) and the subprocess runner
(`runner.ColmapRunner`). The poses it recovers feed the carve on the card
as read-only inputs.
"""

from . import read_model  # the submodule (read_model.read_model reads a dir)
from .read_model import (
    Camera,
    Image,
    Point3D,
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
    write_cameras_binary,
    write_images_binary,
    write_points3d_binary,
    qvec2rotmat,
    rotmat2qvec,
)
from .runner import ColmapRunner

__all__ = [
    "Camera", "Image", "Point3D", "read_cameras_binary", "read_images_binary",
    "read_points3d_binary", "read_model", "write_cameras_binary",
    "write_images_binary", "write_points3d_binary", "qvec2rotmat",
    "rotmat2qvec", "ColmapRunner",
]
