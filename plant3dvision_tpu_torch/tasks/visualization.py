"""Visualization task (port of plant3dvision_tpu/tasks/visualization.py;
reference tasks/visualization.py): bundles downsized images, thumbnails,
point cloud/mesh/skeleton/angle copies and a scan zip for the external
plant-3d-explorer web app. Host code, as in the JAX package: the images
shrink by ops/resize.py's INTER_AREA (cv2's arithmetic), and the figures
import matplotlib (visu.py) after the images and thumbnails are written,
so without matplotlib the task raises there, as the JAX one does."""

from __future__ import annotations

import zipfile

import numpy as np

from ..fsdb import io
from ..runtime.log import configure_logger
from ..runtime.task import Parameter, RomiTask
from ..utils import locate_task_filesets

logger = configure_logger(__name__)


class Visualization(RomiTask):
    upstream_task = Parameter(default="ImagesFilesetExists", significant=False)
    upstream_images = Parameter(default="ImagesFilesetExists")
    upstream_point_cloud = Parameter(default="PointCloud")
    upstream_mesh = Parameter(default="TriangleMesh")
    upstream_skeleton = Parameter(default="CurveSkeleton")
    upstream_angles = Parameter(default="AnglesAndInternodes")
    max_image_size = Parameter(default=1500)
    max_point_cloud_size = Parameter(default=10000000)
    thumbnail_size = Parameter(default=150)
    query = Parameter(default={})
    make_zip = Parameter(default=True)

    def requires(self):
        return []

    def complete(self):
        return self.output().exists()

    def run(self):
        scan = self.ctx.scan
        outfs = self.output().get()
        located = locate_task_filesets(scan, [
            "PointCloud", "TriangleMesh", "CurveSkeleton",
            "AnglesAndInternodes", "TreeGraph", "Colmap"])

        # -- images: downsized + thumbnails ----------------------------
        images_fs = scan.get_fileset("images")
        for f in images_fs.get_files(query=self.query or None):
            img = io.read_image(f)
            for prefix, size in (("image", int(self.max_image_size)),
                                 ("thumbnail", int(self.thumbnail_size))):
                out = _resize_max(img, size)
                fo = outfs.get_file(f"{prefix}_{f.id}", create=True)
                io.write_image(fo, out, "jpg" if out.ndim == 3 else "png")
                fo.set_metadata("image_id", f.id)

        # -- copies of 3D artifacts -------------------------------------
        from .. import visu
        pcd = None
        if located["PointCloud"] != "None":
            src = scan.get_fileset(located["PointCloud"]).get_files()[0]
            pcd = io.read_point_cloud(src)
            if len(pcd) > int(self.max_point_cloud_size):
                sel = np.random.default_rng(0).choice(
                    len(pcd), int(self.max_point_cloud_size), replace=False)
                from ..fsdb.geometry import PointCloud as PCD
                pcd = PCD(pcd.points[sel],
                          None if pcd.normals is None else pcd.normals[sel],
                          None if pcd.colors is None else pcd.colors[sel])
            io.write_point_cloud(outfs.get_file("PointCloud", create=True), pcd)
            visu.point_cloud_figure(pcd, outfs.path() / "pointcloud.png")
            _register(outfs, scan, "pointcloud_figure", "pointcloud.png")

        if located["TriangleMesh"] != "None":
            src = scan.get_fileset(located["TriangleMesh"]).get_files()[0]
            io.write_triangle_mesh(outfs.get_file("TriangleMesh", create=True),
                                   io.read_triangle_mesh(src))

        if located["CurveSkeleton"] != "None":
            src = scan.get_fileset(located["CurveSkeleton"]).get_files()[0]
            skel = io.read_json(src)
            io.write_json(outfs.get_file("CurveSkeleton", create=True), skel)
            visu.skeleton_figure(skel["points"], skel["lines"],
                                 outfs.path() / "skeleton.png")
            _register(outfs, scan, "skeleton_figure", "skeleton.png")

        if located["AnglesAndInternodes"] != "None":
            src_fs = scan.get_fileset(located["AnglesAndInternodes"])
            src = src_fs.get_file("AnglesAndInternodes")
            if src is not None:
                seq = io.read_json(src)
                io.write_json(outfs.get_file("AnglesAndInternodes", create=True), seq)
                if seq.get("angles"):
                    visu.sequences_figure(seq["angles"], seq["internodes"],
                                          outfs.path() / "sequences.png")
                    _register(outfs, scan, "sequences_figure", "sequences.png")

        if located["Colmap"] != "None":
            src_fs = scan.get_fileset(located["Colmap"])
            for fid in ("points3d", "images", "cameras"):
                f = src_fs.get_file(fid)
                if f is not None:
                    io.write_json(outfs.get_file(f"colmap_{fid}", create=True),
                                  io.read_json(f))

        # -- scan zip (for the explorer app) ----------------------------
        if bool(self.make_zip):
            zip_file = outfs.get_file("scan", create=True)
            zip_path = outfs.path() / "scan.zip"
            with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
                for f in outfs.get_files():
                    if f.filename and (outfs.path() / f.filename).exists() \
                            and f.filename != "scan.zip":
                        z.write(outfs.path() / f.filename,
                                arcname=f"{scan.id}/{f.filename}")
            zip_file.filename = "scan.zip"
            scan.store()


def _register(outfs, scan, file_id, filename):
    f = outfs.get_file(file_id, create=True)
    f.filename = filename
    scan.store()


def _resize_max(img, max_size):
    """cv2.resize(img, ..., INTER_AREA) to at most `max_size` a side, as the
    JAX task calls it, through ops/resize.py (the images decode to uint8)."""
    from ..ops.resize import resize_area_u8
    h, w = img.shape[:2]
    scale = max_size / max(h, w)
    if scale >= 1.0:
        return img
    return resize_area_u8(img, (int(w * scale), int(h * scale)))
