"""Pipeline tasks of the port. Importing this package registers every task
with the port's TaskRegistry — the CLI relies on that.

This slice ports the geometric main path (configs/geom_pipe_fast.toml):
ImagesFilesetExists -> FusedCarving -> PointCloud -> CurveSkeleton ->
RefineSkeleton -> TreeGraph -> AnglesAndInternodes (+ Clean).
"""

# Base/marker/utility tasks come with the runtime:
from ..runtime.task import (  # noqa: F401
    Clean,
    DatasetExists,
    DummyTask,
    FilesetExists,
    ImagesFilesetExists,
    ModelFilesetExists,
    NamedFilesetExists,
    VirtualPlantObj,
)
from .fused import FusedCarving  # noqa: F401
from .proc3d import PointCloud, CurveSkeleton, RefineSkeleton  # noqa: F401
from .arabidopsis import TreeGraph, AnglesAndInternodes  # noqa: F401
