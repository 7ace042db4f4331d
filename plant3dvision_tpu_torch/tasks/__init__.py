"""Pipeline tasks of the port. Importing this package registers every task
with the port's TaskRegistry — the CLI relies on that.

Every task class of the JAX package is ported: the geometric main path
(configs/geom_pipe_fast.toml), ImagesFilesetExists -> FusedCarving ->
PointCloud -> CurveSkeleton -> RefineSkeleton -> TreeGraph ->
AnglesAndInternodes (+ Clean); and the fused
ML path, ImagesFilesetExists + ModelFilesetExists ->
FusedSegmentationCarving -> PointCloud (multiclass) -> OrganSegmentation ->
AnglesAndInternodes; and the separate-task ML route
(configs/ml_pipe_virtual.toml), Segmentation2D -> Voxels (averaging) ->
PointCloud (multiclass) -> SegmentedPointCloud -> OrganSegmentation ->
AnglesAndInternodes (+ Masks, and Voxels in carving mode); and the
real-scan front end (configs/geom_pipe_real_selfcal.toml after its
TurntableCalibration), Undistorted -> Masks -> Voxels (vote carving) ->
PointCloud -> CurveSkeleton -> RefineSkeleton -> TreeGraph ->
AnglesAndInternodes; and its TurntableCalibration (the self-calibrated
cameras that the front end starts from); and Colmap (the external binary)
with the ChArUco calibration tasks, and the meshes (TriangleMesh,
ClusteredMesh, CurveSkeleton "mcf"), so every shipped angle chain runs
(configs/geom_pipe_full.toml: Colmap -> Undistorted -> Masks -> Voxels ->
PointCloud -> TriangleMesh -> CurveSkeleton -> RefineSkeleton -> TreeGraph
-> AnglesAndInternodes); and the evaluation and ground-truth tasks,
Visualization and VoxelsWithPrior, so every task of every shipped config
runs.
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
    Segmentation2DGroundTruthFilesetExists,
    VirtualPlantObj,
)
from .cl import Voxels, VoxelsWithPrior  # noqa: F401
from .colmap import Colmap, TurntableCalibration  # noqa: F401
from .fused import FusedCarving  # noqa: F401
from .fused_ml import FusedSegmentationCarving  # noqa: F401
from .proc2d import Masks, Segmentation2D, Undistorted  # noqa: F401
from .proc3d import (  # noqa: F401
    ClusteredMesh,
    CurveSkeleton,
    OrganSegmentation,
    PointCloud,
    RefineSkeleton,
    SegmentedPointCloud,
    TriangleMesh,
)
from .arabidopsis import TreeGraph, AnglesAndInternodes  # noqa: F401
from .calibration import (  # noqa: F401
    CreateCharucoBoard,
    DetectCharuco,
    ExtrinsicCalibration,
    ExtrinsicCalibrationExists,
    IntrinsicCalibration,
    IntrinsicCalibrationExists,
)
from .evaluation import (  # noqa: F401
    AnglesAndInternodesEvaluation,
    ClusteredMeshGroundTruth,
    CylinderRadiusEstimation,
    CylinderRadiusGroundTruth,
    PointCloudEvaluation,
    PointCloudGroundTruth,
    Segmentation2DEvaluation,
    SegmentedPointCloudEvaluation,
    VoxelsEvaluation,
    VoxelsGroundTruth,
)
from .visualization import Visualization  # noqa: F401
