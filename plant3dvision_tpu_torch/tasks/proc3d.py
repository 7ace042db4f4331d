"""3D tasks: PointCloud (single-class and multiclass), CurveSkeleton
(method "graph"), SegmentedPointCloud, OrganSegmentation, RefineSkeleton
(port of plant3dvision_tpu/tasks/proc3d.py; reference tasks/proc3d.py)."""

from __future__ import annotations

import numpy as np

from ..fsdb import io
from ..runtime.log import configure_logger
from ..runtime.task import Parameter, RomiTask
from .. import proc3d

logger = configure_logger(__name__)

# default label colors (role of reference config.PointCloudColorConfig)
LABEL_COLORS = {
    "stem": [0.2, 0.7, 0.2],
    "fruit": [0.9, 0.4, 0.1],
    "leaf": [0.1, 0.9, 0.1],
    "pedicel": [0.6, 0.6, 0.1],
    "flower": [0.9, 0.1, 0.6],
    "background": [0.3, 0.3, 0.3],
}


class PointCloud(RomiTask):
    """Volume -> point cloud with normals (reference tasks/proc3d.py:66-136).

    Multiclass NPZ: per-label argmax with background prior / contrast /
    score filters (ops/multiclass.py, the select kernel on the card), one
    vol2pcd per non-background label while its selection is still on the
    device, per-label colors, 'labels' metadata.
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
        origin = np.array(ifile.get_metadata("origin"))
        voxel_size = float(ifile.get_metadata("voxel_size"))
        level = float(self.level_set_value)
        dev = self.ctx.device

        if len(voxels.keys()) == 1:
            pcd = proc3d.vol2pcd(voxels[list(voxels.keys())[0]], origin,
                                 voxel_size, level, device=dev)
            outfile = self.output_file()
            io.write_point_cloud(outfile, pcd)
            outfile.set_metadata({"voxel_size": voxel_size})
            return

        from ..fsdb.geometry import PointCloud as PCD
        from ..ops.multiclass import multiclass_select

        labels = list(voxels.keys())
        selected = multiclass_select(
            voxels, labels,
            background_prior=float(self.background_prior),
            min_contrast=float(self.min_contrast),
            min_score=float(self.min_score), device=dev)
        pcd = PCD()
        point_labels = []
        for l in labels:
            if l == "background":
                continue
            out = proc3d.vol2pcd(selected[l], origin, voxel_size, level,
                                 device=dev)
            if len(out) == 0:
                continue
            color = LABEL_COLORS.get(l, np.random.rand(3).tolist())
            out.colors = np.tile(np.asarray(color), (len(out), 1))
            pcd = pcd + out
            point_labels += [l] * len(out)

        outfile = self.output_file()
        io.write_point_cloud(outfile, pcd)
        outfile.set_metadata({"labels": point_labels,
                              "voxel_size": voxel_size})


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


class SegmentedPointCloud(RomiTask):
    """Label an existing point cloud by reprojecting it into the 2D label
    masks (reference tasks/proc3d.py:185-253): per point, the sum over mask
    files of the mask value at its projection, per label (ops/reproject.py,
    the reproject kernel on the card), then the first label of maximum
    score."""

    upstream_task = Parameter(default="PointCloud")
    upstream_segmentation = Parameter(default="Segmentation2D")
    use_colmap_poses = Parameter(default=True)

    def requires(self):
        return {"pcd": self._upstream(),
                "masks": self.ctx.get_task(self.upstream_segmentation)}

    def run(self):
        from concurrent.futures import ThreadPoolExecutor

        import torch

        from ..ops.carving import camera_from_metadata
        from ..ops.reproject import score_points_by_masks
        from ..runtime.task import paused_gc

        dev = self.ctx.device
        pcd_fs = self.input()["pcd"].get(create=False)
        pcd = io.read_point_cloud(pcd_fs.get_files()[0])
        masks_fs = self.input()["masks"].get(create=False)
        labels = masks_fs.get_metadata("label_names")
        labels = [l for l in labels if l != "background"]

        cam_key = "colmap_camera" if bool(self.use_colmap_poses) else "camera"
        selected = []          # (file, camera, label index), fileset order
        for f in masks_fs.get_files():
            ch = f.get_metadata("channel")
            if ch not in labels:
                continue
            cam = f.get_metadata(cam_key) or f.get_metadata("camera")
            if cam is None:
                continue
            selected.append((f, camera_from_metadata(cam), labels.index(ch)))
        if not selected:
            raise ValueError("No labelled masks with camera metadata found")

        with paused_gc(), ThreadPoolExecutor(max_workers=8) as ex:
            masks = np.stack(list(ex.map(lambda s: io.read_image(s[0]),
                                         selected)))
        scores = score_points_by_masks(
            torch.from_numpy(np.asarray(pcd.points, np.float32)).to(dev),
            torch.from_numpy(masks).to(dev),
            torch.from_numpy(np.stack([s[1] for s in selected])).to(dev),
            torch.tensor([s[2] for s in selected], dtype=torch.int32,
                         device=dev),
            len(labels)).cpu().numpy()
        winner = np.argmax(scores, axis=1)
        point_labels = [labels[i] for i in winner]

        colors = np.zeros((len(pcd), 3))
        for i, l in enumerate(labels):
            colors[winner == i] = LABEL_COLORS.get(l, [0.5, 0.5, 0.5])
        pcd.colors = colors
        outfile = self.output_file()
        io.write_point_cloud(outfile, pcd)
        outfile.set_metadata({"labels": point_labels})
        vs = pcd_fs.get_files()[0].get_metadata("voxel_size")
        if vs is not None:
            outfile.set_metadata("voxel_size", vs)


class OrganSegmentation(RomiTask):
    """Split each label's points into organ instances with DBSCAN
    (reference tasks/proc3d.py:419-521: eps=2.0, min_points=5, stem kept
    whole); proc3d.dbscan gives scikit-learn's labels."""

    upstream_task = Parameter(default="SegmentedPointCloud")
    eps = Parameter(default=2.0)
    min_points = Parameter(default=5)

    def run(self):
        from ..fsdb.geometry import PointCloud as PCD

        infile = self.input_file()
        pcd = io.read_point_cloud(infile)
        labels = np.asarray(infile.get_metadata("labels"))
        outfs = self.output().get()
        for label in sorted(set(labels.tolist())):
            pts = pcd.points[labels == label]
            if len(pts) == 0:
                continue
            if label == "stem":
                f = outfs.get_file("stem_000", create=True)
                io.write_point_cloud(f, PCD(pts))
                f.set_metadata("label", "stem")
                continue
            clu = proc3d.dbscan(pts, float(self.eps), int(self.min_points))
            for organ_id in sorted(set(clu.tolist())):
                if organ_id < 0:
                    continue
                f = outfs.get_file(f"{label}_{organ_id:03d}", create=True)
                io.write_point_cloud(f, PCD(pts[clu == organ_id]))
                f.set_metadata("label", label)


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
