"""FusedSegmentationCarving: images -> CNN -> multi-label volume in one
device-resident pipeline (port of plant3dvision_tpu/tasks/fused_ml.py).

Covers Segmentation2D + Voxels(type="averaging") of the reference's ML
route (tasks/proc2d.py:328-393 + tasks/cl.py:99-186) as one task: each
batch of centre-cropped images runs the segmentation CNN on the run's
device and its per-label probabilities are accumulated straight into the
C-label averaging volume (ops/ml_fused.py; the accumulate kernel on the
card). The output is the Voxels task's NPZ (one array per label +
voxel_size/origin metadata), so PointCloud consumes it unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fsdb import io
from ..runtime.log import configure_logger
from ..runtime.task import Parameter, RomiTask

logger = configure_logger(__name__)


class FusedSegmentationCarving(RomiTask):
    upstream_task = Parameter(default="ImagesFilesetExists")
    model_fileset = Parameter(default="ModelFilesetExists", significant=False)
    model_id = Parameter(default="")
    query = Parameter(default={})
    camera_metadata = Parameter(default="camera")
    voxel_size = Parameter(default=1.0)
    bounding_box = Parameter(default=None)
    Sx = Parameter(default=896)
    Sy = Parameter(default=896)
    #: probability sampling at the projection: "bilinear" (continuous) or
    #: "box" (the reference's LINEAR-at-integer-coords half-texel box
    #: filter: a 2x2 prefilter, then one tap)
    sample = Parameter(default="bilinear")
    batch_size = Parameter(default=8)
    log = Parameter(default=True)

    def requires(self):
        return {"images": self._upstream(),
                "model": self.ctx.get_task(self.model_fileset)}

    def _resolve_bounding_box(self):
        bbox = self.bounding_box
        scan = self.ctx.scan
        if bbox is None:
            bbox = scan.get_metadata("bounding_box")
        if bbox is None:
            images_fs = scan.get_fileset("images")
            if images_fs is not None:
                bbox = (images_fs.get_metadata("bounding_box")
                        or images_fs.get_metadata("workspace"))
        if bbox is None:
            raise ValueError("Could not obtain a valid bounding-box")
        return bbox

    def run(self):
        from concurrent.futures import ThreadPoolExecutor

        from ..models.checkpoint import load_model
        from ..models.unet import forward_probs
        from ..ops.carving import _avg_chunk_voxels, camera_from_metadata
        from ..ops.ml_fused import (accumulate_label_views,
                                    accumulate_label_views_slab)

        dev = self.ctx.device
        model_fs = self.input()["model"].get(create=False)
        mfile = (model_fs.get_file(self.model_id) if self.model_id
                 else model_fs.get_files()[0])
        model, config = load_model(mfile)
        labels = config.get("label_names") or mfile.get_metadata("label_names")
        C = len(labels)
        # every float parameter rounded to bfloat16, as the JAX task casts
        # its parameter tree; each layer then computes in its stated dtype
        model = model.to(device=dev, dtype=torch.bfloat16).eval()

        images_fs = self.input()["images"].get(create=False)
        files = images_fs.get_files(query=self.query or None)
        cam_key = str(self.camera_metadata)
        selected = [(f, f.get_metadata(cam_key)) for f in files]
        selected = [(f, c) for f, c in selected if c is not None]
        if not selected:
            raise ValueError(f"No images with '{cam_key}' camera metadata")

        Sx, Sy = int(self.Sx), int(self.Sy)
        bbox = self._resolve_bounding_box()
        vs = float(self.voxel_size)
        x0, x1 = bbox["x"]; y0, y1 = bbox["y"]; z0, z1 = bbox["z"]
        shape = (int((x1 - x0) / vs) + 1, int((y1 - y0) / vs) + 1,
                 int((z1 - z0) / vs) + 1)
        origin = np.array([x0, y0, z0])
        logger.info(f"FusedSegmentationCarving: {len(selected)} views, "
                    f"labels {labels}, grid {shape} at {vs} mm")

        B = int(self.batch_size)
        # the JAX package slabs the x axis above this many voxel-labels;
        # the port keeps the lane and its x offsets for the plain version's
        # memory on the CPU: the card's kernel holds no per-view
        # temporaries and takes the whole grid in one launch a batch
        budget = _avg_chunk_voxels()
        if dev.type != "cuda" and C * int(np.prod(shape)) > budget:
            slab_nx = max(1, budget // (C * shape[1] * shape[2]))
            slab_nx = min(slab_nx, shape[0])
            nx_pad = -(-shape[0] // slab_nx) * slab_nx
            n_slabs = nx_pad // slab_nx
            logger.info(f"FusedSegmentationCarving: slabbing x into "
                        f"{n_slabs} chunks of {slab_nx} rows")
        else:
            slab_nx, nx_pad, n_slabs = shape[0], shape[0], 1
        vol = torch.zeros((C, nx_pad, shape[1], shape[2]),
                          dtype=torch.float32, device=dev)
        log_mode = bool(self.log)
        sample = str(self.sample)

        def load(item):
            """Decode, centre-crop, and move cx, cy into crop coordinates."""
            f, cam_md = item
            img = io.read_image(f)
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=-1)
            H, W = img.shape[:2]
            yc = max((H - Sy) // 2, 0)
            xc = max((W - Sx) // 2, 0)
            crop = img[yc: yc + Sy, xc: xc + Sx, :3]
            cam = camera_from_metadata(cam_md).copy()
            cam[2] -= xc
            cam[3] -= yc
            return crop, cam

        def flush(batch):
            # the cameras go up first: a pageable copy waits for the stream
            cams = torch.from_numpy(np.stack([b[1] for b in batch])).to(dev)
            imgs = torch.from_numpy(np.stack([b[0] for b in batch]))
            if dev.type == "cuda":
                imgs = imgs.pin_memory().to(dev, non_blocking=True)
            probs = forward_probs(model, imgs)
            # no static batch to pad to: every view of the batch is valid
            valid = torch.ones(len(batch), dtype=torch.bool, device=dev)
            if n_slabs == 1:
                accumulate_label_views(vol, probs, cams, valid, origin, vs,
                                       (nx_pad, *shape[1:]), log_mode,
                                       sample=sample)
            else:
                for si in range(n_slabs):
                    accumulate_label_views_slab(
                        vol, probs, cams, valid, origin, vs, si * slab_nx,
                        slab_nx, log_mode, sample=sample)

        # decode batch i+1 on the host while the card runs batch i
        from ..runtime.task import paused_gc
        with paused_gc(), ThreadPoolExecutor(max_workers=8) as ex:
            for i in range(0, len(selected), B):
                flush(list(ex.map(load, selected[i:i + B])))

        vol = vol[:, :shape[0]]                   # crop the slab x-padding
        if log_mode:
            vol = torch.clamp(torch.exp(vol), max=1.0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        outfile = self.output_file()
        # PointCloud gets the volumes in memory, on the device; the NPZ
        # (pull + deflate) rides the artifact-writer thread (fsdb.handoff)
        from ..fsdb import handoff
        handoff.cache_put(outfile, {label: vol[i]
                                    for i, label in enumerate(labels)})
        io.write_npz_async(
            outfile, lambda: {label: arr for label, arr in
                              zip(labels, vol.cpu().numpy())})
        outfile.set_metadata({"voxel_size": vs, "origin": origin.tolist(),
                              "label_names": list(labels)})
        self.output().get().set_metadata("label_names", list(labels))
