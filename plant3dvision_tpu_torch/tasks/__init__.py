"""Pipeline tasks of the port. Importing this package registers every task
with the port's TaskRegistry — the CLI relies on that.

Ported so far: the geometric main path (configs/geom_pipe_fast.toml),
ImagesFilesetExists -> FusedCarving -> PointCloud -> CurveSkeleton ->
RefineSkeleton -> TreeGraph -> AnglesAndInternodes (+ Clean); and the fused
ML path, ImagesFilesetExists + ModelFilesetExists ->
FusedSegmentationCarving -> PointCloud (multiclass) -> OrganSegmentation ->
AnglesAndInternodes; and the separate-task ML route
(configs/ml_pipe_virtual.toml), Segmentation2D -> Voxels (averaging) ->
PointCloud (multiclass) -> SegmentedPointCloud -> OrganSegmentation ->
AnglesAndInternodes (+ Masks, and Voxels in carving mode); and the
real-scan front end (configs/geom_pipe_real_selfcal.toml after its
TurntableCalibration), Undistorted -> Masks -> Voxels (vote carving) ->
PointCloud -> CurveSkeleton -> RefineSkeleton -> TreeGraph ->
AnglesAndInternodes.
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
from .cl import Voxels  # noqa: F401
from .fused import FusedCarving  # noqa: F401
from .fused_ml import FusedSegmentationCarving  # noqa: F401
from .proc2d import Masks, Segmentation2D, Undistorted  # noqa: F401
from .proc3d import (  # noqa: F401
    CurveSkeleton,
    OrganSegmentation,
    PointCloud,
    RefineSkeleton,
    SegmentedPointCloud,
)
from .arabidopsis import TreeGraph, AnglesAndInternodes  # noqa: F401
