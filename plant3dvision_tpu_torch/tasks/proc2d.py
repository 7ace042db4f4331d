"""2D tasks: Masks, Segmentation2D (port of plant3dvision_tpu/tasks/proc2d.py;
reference tasks/proc2d.py).

Segmentation2D runs the segmentation CNN on the run's device
(models/unet.py:segmentation_inference) and derives the written masks from
its uint8 probabilities there, for the whole stack at once (each step of
the JAX task's per-file host code is one IEEE operation, so the result is
the same); the disk dilation is the dilate kernel (ops/masks.py). The
PNGs are encoded and written by a pool of threads. `Undistorted` and
`resize=True` wait for the image front-end slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fsdb import io
from ..runtime.log import configure_logger
from ..runtime.task import FileByFileTask, Parameter

logger = configure_logger(__name__)


class Masks(FileByFileTask):
    """Binary plant masks from color filters
    (reference tasks/proc2d.py:207-249), on the host."""

    upstream_task = Parameter(default="Undistorted")
    type = Parameter(default="linear")
    parameters = Parameter(default=[0.0, 1.0, 0.0])
    dilation = Parameter(default=0)
    binarize = Parameter(default=True)
    threshold = Parameter(default=0.3)

    def f(self, fin, outfs):
        from ..ops.masks import compute_mask_numpy
        img = io.read_image(fin)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        coefs = self.parameters
        if isinstance(coefs, str):
            import json
            coefs = json.loads(coefs)
        out = compute_mask_numpy(
            img, filter_type=str(self.type), coefs=tuple(map(float, coefs)),
            threshold=float(self.threshold),
            dilation_radius=int(self.dilation),
            binarize=bool(self.binarize))
        fout = outfs.get_file(fin.id, create=True)
        io.write_image(fout, (out * 255).astype(np.uint8), "png")
        return fout


class Segmentation2D(Masks):
    """CNN organ segmentation: one grayscale PNG per image x label with
    'channel' metadata (reference tasks/proc2d.py:302-393, romiseg boundary).

    The model comes from the 'models' fileset (ModelFilesetExists): an NPZ
    checkpoint of the JAX package's format, or a torch `.pt`
    (models/checkpoint.py).
    """

    upstream_task = Parameter(default="Undistorted")
    model_fileset = Parameter(default="ModelFilesetExists", significant=False)
    model_id = Parameter(default="")
    query = Parameter(default={})
    Sx = Parameter(default=896)
    Sy = Parameter(default=896)
    #: False (reference behavior, tasks/proc2d.py:351): center-crop the
    #: input to (Sy, Sx) and shift the written camera principal point.
    #: True (resize to the net and back) is not ported yet.
    resize = Parameter(default=False)
    single_label = Parameter(default="")
    inverted_labels = Parameter(default=["background"])
    binarize = Parameter(default=True)
    threshold = Parameter(default=0.01)
    dilation = Parameter(default=1)
    #: flip-averaged test-time augmentation (models/unet.py:forward_probs)
    tta = Parameter(default=False)
    batch_size = Parameter(default=8, significant=False)
    #: "bf16" or "float"; "int8" is not ported yet
    conv_mode = Parameter(default="bf16", significant=False)
    #: the JAX package's multi-device sharding switch; the port runs on
    #: the run's one device whatever it says
    data_parallel = Parameter(default="auto", significant=False)

    def requires(self):
        return {"images": self._upstream(),
                "model": self.ctx.get_task(self.model_fileset)}

    def run(self):
        from concurrent.futures import ThreadPoolExecutor

        from ..models.checkpoint import load_model
        from ..models.unet import segmentation_inference
        from ..runtime.task import paused_gc

        if bool(self.resize):
            raise NotImplementedError(
                "Segmentation2D resize=True (cv2 INTER_AREA / INTER_LINEAR "
                "resampling) is not ported yet: it comes with the "
                "hybrid/calibration slice")
        model_fs = self.input()["model"].get(create=False)
        if model_fs is None:
            raise FileNotFoundError("No 'models' fileset found")
        mfile = (model_fs.get_file(self.model_id) if self.model_id
                 else model_fs.get_files()[0])
        model, config = load_model(mfile)
        labels = config.get("label_names") or mfile.get_metadata("label_names")

        images_fs = self.input()["images"].get(create=False)
        files = images_fs.get_files(query=self.query or None)
        logger.info(f"Segmentation2D: {len(files)} images, labels={labels}")
        Sx, Sy = int(self.Sx), int(self.Sy)

        def _load(fin):
            img = io.read_image(fin)
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=-1)
            H, W = img.shape[:2]
            # center crop to (Sy, Sx) as the reference does (:351)
            y0 = max((H - Sy) // 2, 0)
            x0 = max((W - Sx) // 2, 0)
            return img[y0: y0 + Sy, x0: x0 + Sx, :3], (x0, y0)

        with paused_gc(), ThreadPoolExecutor(max_workers=8) as ex:
            loaded = list(ex.map(_load, files))
        batch = np.stack([im for im, _ in loaded])
        offsets = [off for _, off in loaded]

        probs = segmentation_inference(model, batch,
                                       batch_size=int(self.batch_size),
                                       tta=bool(self.tta),
                                       conv_mode=str(self.conv_mode),
                                       data_parallel=self.data_parallel,
                                       device=self.ctx.device)  # uint8 NCHW
        outfs = self.output().get()
        with paused_gc():
            self._write_channels(outfs, list(files), labels, probs, offsets)

    @staticmethod
    def _shift_principal_point(md, offset):
        """The written masks are center-cropped, so any per-image camera
        metadata must have its principal point shifted by the crop
        origin or downstream carving misprojects by (x0, y0) px. The
        reference copies the metadata verbatim (tasks/proc2d.py:383-388)
        — a latent bug for scans larger than (Sx, Sy)."""
        x0, y0 = offset
        if not (x0 or y0):
            return md
        for key in ("camera", "colmap_camera", "calibrated_camera"):
            cam = md.get(key)
            if not isinstance(cam, dict):
                continue
            model = cam.get("camera_model")
            if isinstance(model, dict) and "params" in model:
                params = list(model["params"])
                if len(params) >= 4:
                    params[2] = params[2] - x0
                    params[3] = params[3] - y0
                    model = dict(model, params=params)
                    md[key] = dict(cam, camera_model=model)
        return md

    def channel_masks(self, labels, probs):
        """The written masks of the (N, C, H, W) uint8 probabilities, as
        (N, C', H, W) uint8 on their device (C' = the labels written): the
        JAX task's per-file steps, operation for operation, on the stack:
        / 255 in float32; `1 - p` for an inverted label; `> threshold` in
        float32 and the disk dilation (binarize); `1 - p` again for an
        inverted label (1 - (1 - p) is not p in float32); `p * 255`
        truncated to uint8."""
        from ..ops.carving import div_f32
        from ..ops.masks import binary_dilation

        keep = [c for c, l in enumerate(labels)
                if not self.single_label or l == self.single_label]
        N, _, H, W = probs.shape
        dev = probs.device
        inv = torch.tensor([labels[c] in list(self.inverted_labels)
                            for c in keep], device=dev).view(1, -1, 1, 1)
        pred = div_f32(probs[:, keep].to(torch.float32), 255.0)
        pred = torch.where(inv, 1.0 - pred, pred)
        if bool(self.binarize):
            m = pred > float(np.float32(self.threshold))
            if int(self.dilation) > 0:
                m = binary_dilation(m.reshape(-1, H, W), int(self.dilation))
            pred = m.reshape(N, len(keep), H, W).to(torch.float32)
        pred = torch.where(inv, 1.0 - pred, pred)
        return (pred * 255).to(torch.uint8), [labels[c] for c in keep]

    def _write_channels(self, outfs, metas, labels, probs, offsets):
        from concurrent.futures import ThreadPoolExecutor

        out, names = self.channel_masks(labels, probs)
        out = out.cpu().numpy()
        # the files are created in the JAX task's order (image, then label):
        # downstream tasks read them in fileset order
        jobs = [(outfs.get_file(f"{fin.id}_{label}", create=True), fin, i, c)
                for i, fin in enumerate(metas)
                for c, label in enumerate(names)]

        def _write(job):
            fout, fin, i, c = job
            io.write_image(fout, out[i, c], "png")
            md = self._shift_principal_point(fin.get_metadata(), offsets[i])
            md["channel"] = names[c]
            fout.set_metadata(md)

        with self.ctx.scan.deferred_store(), \
                ThreadPoolExecutor(max_workers=8) as ex:
            list(ex.map(_write, jobs))
        outfs.set_metadata("label_names", list(labels))
