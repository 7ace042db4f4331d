"""3D tasks of the geometric main path: PointCloud (single-class),
CurveSkeleton (method "graph"), RefineSkeleton
(port of plant3dvision_tpu/tasks/proc3d.py; reference tasks/proc3d.py)."""

from __future__ import annotations

import numpy as np

from ..fsdb import io
from ..runtime.log import configure_logger
from ..runtime.task import Parameter, RomiTask
from .. import proc3d

logger = configure_logger(__name__)


class PointCloud(RomiTask):
    """Volume -> point cloud with normals (reference tasks/proc3d.py:66-136).

    The multiclass (ML) path of the JAX task is ported with the ML slice;
    its parameters are kept so fileset ids match the JAX package's.
    """

    upstream_task = Parameter(default="Voxels")
    level_set_value = Parameter(default=1.0)
    background_prior = Parameter(default=1.0)
    min_contrast = Parameter(default=10.0)
    min_score = Parameter(default=0.2)

    def run(self):
        from ..fsdb import handoff
        ifile = self.input_file()
        # the producer task may have left the volume on the device
        # (fsdb.handoff) — then the NPZ inflate + upload are skipped
        # (bit-identical: the cache holds exactly the arrays the NPZ was
        # written from)
        voxels = handoff.cache_get(ifile)
        if voxels is None:
            voxels = io.read_npz(ifile)
        if len(voxels.keys()) != 1:
            raise NotImplementedError(
                "multiclass PointCloud (the ML path) is not ported yet: it "
                "comes with the port's ML slice")
        voxels = voxels[list(voxels.keys())[0]]

        origin = np.array(ifile.get_metadata("origin"))
        voxel_size = float(ifile.get_metadata("voxel_size"))
        pcd = proc3d.vol2pcd(voxels, origin, voxel_size,
                             float(self.level_set_value),
                             device=self.ctx.device)
        outfile = self.output_file()
        io.write_point_cloud(outfile, pcd)
        outfile.set_metadata({"voxel_size": voxel_size})


class CurveSkeleton(RomiTask):
    """Point cloud -> curve skeleton {points, lines} JSON, by the Xu
    distance-to-root-clusters method (method="graph": geodesic level sets
    over the point cloud, host Dijkstra; reference proc3d.py:392-426).

    The JAX package's other methods ("fim" eikonal, "mcf" mesh
    contraction) are ported in a later slice; their parameters are kept so
    fileset ids match.
    """

    upstream_task = Parameter(default="PointCloud")
    method = Parameter(default="graph")
    bin_size = Parameter(default=4.0)
    k = Parameter(default=10)
    stem_axis = Parameter(default=2)
    stem_axis_inverted = Parameter(default=False)
    #: mcf-only knobs: contraction rounds / spur-prune length (defaults
    #: to bin_size, the node-spacing analogue of the graph method)
    mcf_iterations = Parameter(default=12)
    min_branch = Parameter(default=0.0)

    def run(self):
        if str(self.method) != "graph":
            raise NotImplementedError(
                f"CurveSkeleton method {self.method!r} is not ported yet "
                "(only 'graph'); 'fim' and 'mcf' come with a later slice")
        obj = io.read_point_cloud(self.input_file())
        points = obj.points if hasattr(obj, "points") else obj.vertices
        if bool(self.stem_axis_inverted):
            root_index = int(np.argmax(points[:, int(self.stem_axis)]))
        else:
            root_index = int(np.argmin(points[:, int(self.stem_axis)]))
        centers, lines = proc3d.skeleton_from_distance_to_root_clusters(
            points, root_index, float(self.bin_size), int(self.k))
        outfile = self.output_file()
        io.write_json(outfile, {"points": centers.tolist(),
                                "lines": lines.tolist()})


class RefineSkeleton(RomiTask):
    """Deformable registration of the skeleton onto the point cloud
    (reference tasks/proc3d.py:561-639, skeleton_refinement submodule:
    CPD-style EM), in ops.registration."""

    upstream_task = Parameter(default="CurveSkeleton")
    upstream_pcd = Parameter(default="PointCloud")
    alpha = Parameter(default=5.0)
    beta = Parameter(default=5.0)
    max_iterations = Parameter(default=100)
    tolerance = Parameter(default=1e-4)
    knn_mst = Parameter(default=True)

    def requires(self):
        return {"skeleton": self._upstream(), "pcd": self.ctx.get_task(self.upstream_pcd)}

    def run(self):
        from ..ops.registration import cpd_nonrigid

        skel = io.read_json(self.input()["skeleton"].get(create=False).get_files()[0])
        pcd = io.read_point_cloud(self.input()["pcd"].get(create=False).get_files()[0])
        pts = np.asarray(skel["points"], dtype=float)
        lines = np.asarray(skel["lines"], dtype=int)

        refined = cpd_nonrigid(pcd.points, pts, alpha=float(self.alpha),
                               beta=float(self.beta),
                               max_iterations=int(self.max_iterations),
                               tolerance=float(self.tolerance),
                               device=self.ctx.device)
        if bool(self.knn_mst):
            import scipy.sparse as sp
            from scipy.sparse.csgraph import minimum_spanning_tree
            from ..proc3d import knn_graph_csr
            g = knn_graph_csr(refined, min(5, len(refined)))
            mst = sp.coo_matrix(minimum_spanning_tree(g))
            lines = np.stack([mst.row, mst.col], axis=1)

        outfile = self.output_file()
        io.write_json(outfile, {"points": refined.tolist(),
                                "lines": lines.tolist()})
