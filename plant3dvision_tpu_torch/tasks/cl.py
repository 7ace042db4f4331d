"""Voxels task: space carving / multi-label averaging on the run's device,
and VoxelsWithPrior, the detector-prior correction of its label volumes
(port of plant3dvision_tpu/tasks/cl.py; reference tasks/cl.py — the
bounding-box resolution order, displacement offsets, grid shape rule
n = (max-min)/voxel_size + 1, label handling and log/exp averaging are the
reference's)."""

from __future__ import annotations

import numpy as np
import torch

from ..fsdb import io
from ..runtime.log import configure_logger
from ..runtime.task import Parameter, RomiTask

logger = configure_logger(__name__)


class Voxels(RomiTask):
    upstream_mask = Parameter(default="Masks")
    upstream_colmap = Parameter(default="Colmap")
    query = Parameter(default={})
    camera_metadata = Parameter(default="colmap_camera")
    voxel_size = Parameter(default=1.0)
    type = Parameter(default="carving")
    log = Parameter(default=True)
    invert = Parameter(default=False)
    labels = Parameter(default=[])
    bounding_box = Parameter(default=None)
    #: carve vote tolerance (views allowed to dissent per voxel); > 0
    #: counts each voxel's kills (K11, ops/carving.py:Backprojection)
    kill_tolerance = Parameter(default=0)
    #: "auto" = the run's one device; "sharded" = shard over the run's
    #: ranks when there is more than one (RunContext.ranks; the view-
    #: sharded carve, the x-slab averaging volume: ops/carving.py:
    #: Backprojection)
    engine = Parameter(default="auto", significant=False)

    # RomiTask glue: upstream_task unused, requirements are mask (+ colmap)
    upstream_task = Parameter(default="ImagesFilesetExists", significant=False)

    def requires(self):
        req = {"masks": self.ctx.get_task(self.upstream_mask)}
        # any camera-producing upstream (Colmap, TurntableCalibration, ...)
        # is a real dependency; DummyTask/marker upstreams are not
        if self.upstream_colmap not in (None, "", "DummyTask",
                                        "ImagesFilesetExists"):
            req["colmap"] = self.ctx.get_task(self.upstream_colmap)
        return req

    def _resolve_bounding_box(self, masks_fileset):
        bbox = self.bounding_box
        scan = self.ctx.scan
        if bbox is None:
            bbox = scan.get_metadata("bounding_box")
        if bbox is None and "colmap" in (self.input() or {}):
            colmap_fs = self.input()["colmap"].get(create=False)
            if colmap_fs is not None:
                bbox = colmap_fs.get_metadata("bounding_box")
        if bbox is None:
            images_fs = scan.get_fileset("images")
            if images_fs is not None:
                bbox = images_fs.get_metadata("bounding_box")
                if bbox is None:
                    bbox = images_fs.get_metadata("workspace")
        if bbox is None:
            # reference fallback chain (colmap.py:548-570)
            bbox = scan.get_metadata("workspace")
        if bbox is None:
            scanner = scan.get_metadata("scanner")
            if isinstance(scanner, dict):
                bbox = scanner.get("workspace")
        if bbox is None:
            raise ValueError("Could not obtain a valid bounding-box")
        return bbox

    def run(self):
        from ..fsdb import handoff
        from ..ops.carving import Backprojection

        masks_fileset = self.input()["masks"].get(create=False)
        masks_files = masks_fileset.get_files(query=self.query or None)
        logger.info(f"Voxels: {len(masks_files)} mask files")

        bbox = self._resolve_bounding_box(masks_fileset)
        x_min, x_max = bbox["x"]
        y_min, y_max = bbox["y"]
        z_min, z_max = bbox["z"]

        displacement = self.ctx.scan.get_metadata("displacement")
        if displacement:
            x_min += displacement["dx"]; x_max += displacement["dx"]
            y_min += displacement["dy"]; y_max += displacement["dy"]
            z_min += displacement["dz"]; z_max += displacement["dz"]

        vs = float(self.voxel_size)
        nx = int((x_max - x_min) / vs) + 1
        ny = int((y_max - y_min) / vs) + 1
        nz = int((z_max - z_min) / vs) + 1
        origin = np.array([x_min, y_min, z_min])
        logger.info(f"Voxels: grid {nx}x{ny}x{nz} at {vs} mm")

        labels = list(self.labels) if self.labels else None
        if labels is None:
            labels = masks_fileset.get_metadata("label_names", default=None)

        bp = Backprojection(
            shape=[nx, ny, nz], origin=[x_min, y_min, z_min], voxel_size=vs,
            type=str(self.type), labels=labels, log=bool(self.log),
            kill_tolerance=int(self.kill_tolerance),
            engine=str(self.engine), device=self.ctx.device,
            ranks=self.ctx.ranks, mesh=self.ctx.mesh)
        vol = bp.process_fileset(masks_files, str(self.camera_metadata),
                                 bool(self.invert))

        if bool(self.log) and str(self.type) == "averaging":
            torch.exp(vol, out=vol)   # in place: the label stack is GB-scale
            vol.clamp_(max=1.0)
        if vol.device.type == "cuda":
            torch.cuda.synchronize(vol.device)

        outfile = self.output_file()
        if labels is not None:
            # PointCloud gets the volumes in memory, on the device; the NPZ
            # (pull + deflate) rides the artifact-writer thread
            handoff.cache_put(outfile, {label: vol[i]
                                        for i, label in enumerate(labels)})
            io.write_npz_async(
                outfile, lambda: {label: arr for label, arr in
                                  zip(labels, vol.cpu().numpy())})
        else:
            io.write_volume(outfile, vol.cpu().numpy())
        outfile.set_metadata({"voxel_size": vs, "origin": origin.tolist()})


class VoxelsWithPrior(RomiTask):
    """Correct a multi-label averaged volume with per-label detector priors
    (recall/specificity), reference tasks/proc3d.py:642-694: each label's
    log-score gets the likelihood-ratio correction

        score = n_views_hit * log(recall / (1 - specificity))
              + (n_views - n_views_hit) * log((1 - recall) / specificity)

    approximated here from the averaged volume (fraction of hitting views);
    host numpy, as in the JAX package.
    """

    upstream_task = Parameter(default="Voxels")
    recall = Parameter(default={})
    specificity = Parameter(default={})
    n_views = Parameter(default=0)

    def run(self):
        ifile = self.input_file()
        vols = io.read_npz(ifile)
        n_views = int(self.n_views)
        if n_views <= 0:
            images = self.ctx.scan.get_fileset("images")
            n_views = len(images.get_files()) if images else 1

        out = {}
        for label, vol in vols.items():
            rec = float(dict(self.recall).get(label, 0.9))
            spe = float(dict(self.specificity).get(label, 0.9))
            frac = np.clip(np.asarray(vol, dtype=np.float64), 0.0, 1.0)
            hits = frac * n_views
            lr_pos = np.log(max(rec, 1e-9) / max(1 - spe, 1e-9))
            lr_neg = np.log(max(1 - rec, 1e-9) / max(spe, 1e-9))
            out[label] = hits * lr_pos + (n_views - hits) * lr_neg

        outfile = self.output_file()
        io.write_npz(outfile, out)
        outfile.set_metadata({
            "voxel_size": ifile.get_metadata("voxel_size"),
            "origin": ifile.get_metadata("origin"),
        })
