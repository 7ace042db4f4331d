"""3D tasks: PointCloud (single-class and multiclass), TriangleMesh,
CurveSkeleton (methods "graph", "fim" and "mcf"), SegmentedPointCloud,
ClusteredMesh, OrganSegmentation, RefineSkeleton (port of
plant3dvision_tpu/tasks/proc3d.py; reference tasks/proc3d.py)."""

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


class TriangleMesh(RomiTask):
    """Point cloud / volume -> surface mesh (the reference's open3d/CGAL
    Poisson role, tasks/proc3d.py:299-345).

    - library="marching_cubes" (default): `proc3d.pcd2mesh`, the normal
      weighted IMLS field over the oriented PointCloud blended into its
      occupancy's signed distance (K2, cap 8), extracted by the native
      marching tetrahedra.
    - library="volume_mc": the `Voxels` volume's signed distance (K2, cap
      8) extracted at level -level_set_value (no normals: thin organs grow
      by about a voxel a side).

    filtering="most connected triangles" keeps the largest connected
    component.
    """

    upstream_task = Parameter(default="PointCloud")
    library = Parameter(default="marching_cubes")
    filtering = Parameter(default="most connected triangles")
    level_set_value = Parameter(default=0.0)
    #: extract the implicit surface `shrink` world units inside the point
    #: cloud — compensates acquisition dilation (any-coverage binary
    #: silhouettes widen every thin organ by ~half a mask pixel per side)
    shrink = Parameter(default=0.0)

    def requires(self):
        return [self._upstream(), self.ctx.get_task("Voxels")]

    def run(self):
        vfile = self.ctx.get_task("Voxels").output().get(
            create=False).get_files()[0]
        voxel_size = float(vfile.get_metadata("voxel_size"))

        if str(self.library) == "volume_mc":
            import torch

            from ..fsdb import handoff
            from ..native import marching_cubes
            from ..ops.edt import signed_distance
            vols = handoff.cache_get(vfile)
            if vols is None:
                vols = io.read_npz(vfile)
            vol = torch.as_tensor(vols[list(vols.keys())[0]]).to(
                self.ctx.device)
            origin = np.array(vfile.get_metadata("origin"))
            sd = signed_distance(vol, cap=8).cpu().numpy()
            mesh = marching_cubes(sd, level=-float(self.level_set_value))
            mesh.vertices = proc3d.index2point(mesh.vertices, origin,
                                               voxel_size)
        else:
            pcd = io.read_point_cloud(
                self.input()[0].get(create=False).get_files()[0])
            mesh = proc3d.pcd2mesh(pcd, voxel_size=voxel_size,
                                   shrink=float(self.shrink),
                                   device=self.ctx.device)

        if str(self.filtering) == "most connected triangles":
            mesh = mesh.largest_connected_component()

        outfile = self.output_file()
        io.write_triangle_mesh(outfile, mesh)


class CurveSkeleton(RomiTask):
    """Point cloud / carved volume -> curve skeleton {points, lines} JSON.

    - method="graph" (default, and any name but the two below, as in the
      JAX package): the Xu distance-to-root-clusters method (geodesic
      level sets over the point cloud, host Dijkstra; reference
      proc3d.py:392-426).
    - method="fim": the eikonal skeleton on the `Voxels` volume: geodesic
      distance from the root plane through the occupied voxels
      (ops/eikonal.py, K14 on the card), one cluster per connected
      component of each distance bin, 6-adjacency edges between clusters,
      their minimum spanning tree.
    - method="mcf": mean-curvature-flow contraction of the mesh (the
      reference's primary method, CGAL's; native/mcf.py, host C++ and
      scipy) from a mesh producer upstream (TriangleMesh).
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
        if str(self.method) == "fim":
            centers, lines = self._skeleton_fim()
        elif str(self.method) == "mcf":
            from ..native.mcf import skeletonize_mesh
            mesh = io.read_triangle_mesh(self.input_file())
            centers, lines = skeletonize_mesh(
                mesh.vertices, mesh.triangles,
                iterations=int(self.mcf_iterations),
                bin_size=float(self.bin_size),
                stem_axis=int(self.stem_axis),
                stem_axis_inverted=bool(self.stem_axis_inverted),
                min_branch=float(self.min_branch))
        else:       # "graph", as the JAX task takes any other name
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


    def _skeleton_fim(self):
        """Eikonal skeleton on the carved volume: seeds on the root plane,
        the geodesic distance on the run's device, then host clustering
        (`distance_bin_clusters`) and the clusters' spanning tree."""
        import torch

        from ..fsdb import handoff
        from ..ops.eikonal import geodesic_distance
        from ..runtime.runner import stage

        vfile = self.ctx.get_task("Voxels").output().get(
            create=False).get_files()[0]
        vols = handoff.cache_get(vfile)
        if vols is None:
            vols = io.read_npz(vfile)
        vol = vols[list(vols.keys())[0]]
        origin = np.asarray(vfile.get_metadata("origin"))
        vs = float(vfile.get_metadata("voxel_size"))
        dev = self.ctx.device

        with stage("eikonal"):
            mask = torch.as_tensor(vol).to(dev) > 0.5
            seeds = root_plane_seeds(mask, int(self.stem_axis),
                                     bool(self.stem_axis_inverted))
            dist = geodesic_distance(mask, seeds).cpu().numpy()
            mask = mask.cpu().numpy()
        with stage("clusters"):
            centers, edges = distance_bin_clusters(mask, dist,
                                                   float(self.bin_size))
        return proc3d.index2point(centers, origin, vs), edges


def root_plane_seeds(mask, axis: int, inverted: bool):
    """The eikonal solve's seeds: the occupied voxels of the lowest (or,
    inverted, the highest) occupied plane across `axis` of a bool volume
    tensor."""
    import torch
    planes = torch.nonzero(mask.any(dim=[a for a in range(3) if a != axis]))
    root = int(planes.max() if inverted else planes.min())
    seeds = torch.zeros_like(mask)
    sl = [slice(None)] * 3
    sl[axis] = root
    seeds[tuple(sl)] = mask[tuple(sl)]
    return seeds


def distance_bin_clusters(mask, dist, bin_size: float):
    """The eikonal skeleton's graph (JAX `_skeleton_fim`'s host part): the
    reached voxels binned by floor(d / bin_size), one cluster per connected
    component (6-adjacency, scipy's label order) of each bin, numbered by
    (bin, label); centers the mean voxel index (float64); the sorted set of
    6-adjacent cluster pairs, reduced to their minimum spanning tree by
    center distance. Returns (centers (C, 3), edges (E, 2)).

    The JAX code labels the whole grid once per bin, compares it with
    every label and shifts whole-grid copies for the edges; here each bin
    is labelled in its own bounding box (the same components in the same
    raster order), the centers are bincount sums of integer indices (exact
    in float64) and the edges come from the reached voxels' flat indices,
    so the result is the same at a cost of the reached voxels, not the
    grid's."""
    import scipy.ndimage as ndi
    import scipy.sparse as sp
    from scipy.sparse.csgraph import minimum_spanning_tree

    reach = mask & (dist < 1e9)
    idx = np.argwhere(reach)
    d = dist[reach]
    bins = np.floor(d / bin_size).astype(np.int64)
    cluster = np.empty(len(idx), np.int64)
    centers = []
    next_id = 0
    order = np.argsort(bins, kind="stable")
    starts = np.searchsorted(bins[order], np.arange(bins.max(initial=-1) + 2))
    for b in range(len(starts) - 1):
        rows = order[starts[b]:starts[b + 1]]
        if len(rows) == 0:
            continue
        pts = idx[rows]
        lo = pts.min(axis=0)
        crop = np.zeros(tuple(pts.max(axis=0) - lo + 1), bool)
        local = pts - lo
        crop[tuple(local.T)] = True
        comp, n = ndi.label(crop)
        lab = comp[tuple(local.T)] - 1
        counts = np.bincount(lab, minlength=n)
        sums = np.stack([np.bincount(lab, weights=pts[:, k], minlength=n)
                         for k in range(3)], axis=1)
        centers.append(sums / counts[:, None])
        cluster[rows] = next_id + lab
        next_id += n
    centers = (np.concatenate(centers) if centers
               else np.zeros((0, 3), np.float64))

    # 6-adjacent pairs of reached voxels in different clusters: each
    # voxel's +1 neighbour along each axis, found among the reached
    # voxels' sorted flat indices
    lin = np.ravel_multi_index(tuple(idx.T), mask.shape)
    pairs = []
    for axis in range(3):
        stride = int(np.prod(mask.shape[axis + 1:]))
        inside = idx[:, axis] < mask.shape[axis] - 1
        nb = lin[inside] + stride
        pos = np.minimum(np.searchsorted(lin, nb), len(lin) - 1)
        hit = lin[pos] == nb
        a, b = cluster[inside][hit], cluster[pos[hit]]
        ok = a != b
        pairs.append(np.stack([np.minimum(a[ok], b[ok]),
                               np.maximum(a[ok], b[ok])], axis=1))
    edges = np.unique(np.concatenate(pairs), axis=0).astype(np.int64)
    if len(edges):
        w = np.linalg.norm(centers[edges[:, 0]] - centers[edges[:, 1]],
                           axis=1)
        g = sp.coo_matrix((w, (edges[:, 0], edges[:, 1])),
                          shape=(len(centers), len(centers)))
        mst = sp.coo_matrix(minimum_spanning_tree(g.maximum(g.T)))
        edges = np.stack([mst.row, mst.col], axis=1)
    return centers, edges


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


class ClusteredMesh(RomiTask):
    """One mesh per label x connected component from a labelled point cloud
    (reference tasks/proc3d.py:348-416): `proc3d.pcd2mesh` over each
    label's points (with their normals when the cloud has them) on the
    run's device, its components of at least 10 triangles."""

    upstream_task = Parameter(default="SegmentedPointCloud")
    min_vol = Parameter(default=1.0)
    min_length = Parameter(default=10.0)
    #: meshing resolution; empty = the upstream point cloud's own
    #: voxel_size metadata
    voxel_size = Parameter(default="")

    def run(self):
        from ..fsdb.geometry import PointCloud as PCD

        infile = self.input_file()
        pcd = io.read_point_cloud(infile)
        labels = np.asarray(infile.get_metadata("labels"))
        vs = (float(self.voxel_size) if str(self.voxel_size)
              else float(infile.get_metadata("voxel_size") or 1.0))
        has_normals = (getattr(pcd, "normals", None) is not None
                       and len(pcd.normals) == len(pcd.points))
        outfs = self.output().get()
        for label in sorted(set(labels.tolist())):
            sel = labels == label
            pts = pcd.points[sel]
            if len(pts) < 20:
                continue
            organ = PCD(pts, pcd.normals[sel]) if has_normals else PCD(pts)
            mesh = proc3d.pcd2mesh(organ, voxel_size=vs,
                                   device=self.ctx.device)
            if len(mesh.triangles) == 0:
                continue
            tlabel, counts = mesh.connected_components()
            for cc_id in range(len(counts)):
                if counts[cc_id] < 10:
                    continue
                sub = mesh.select_triangles(tlabel == cc_id)
                f = outfs.get_file(f"{label}_{cc_id:03d}", create=True)
                io.write_triangle_mesh(f, sub)
                f.set_metadata("label", label)


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
