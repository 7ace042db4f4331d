"""2D tasks: Undistorted, Masks, Segmentation2D (port of
plant3dvision_tpu/tasks/proc2d.py; reference tasks/proc2d.py).

Each runs its pixel work on the run's device, a stack of images at a time,
with the PNG decodes and encodes on a pool of threads:
- Undistorted groups the images by camera and undistorts each group with
  the undistort kernel (ops/undistort.py), in chunks bounded by the free
  device memory.
- Masks stacks the images by shape and runs the mask kernel (filter +
  threshold) and, when `dilation > 0`, the dilate kernel on each stack
  (ops/masks.py); the JAX task runs the same function on the host, one
  file at a time (`compute_mask_numpy`), and the PNGs are equal.
- Segmentation2D runs the segmentation CNN (models/unet.py:
  segmentation_inference) and derives the written masks from its uint8
  probabilities there, for the whole stack at once (each step of the JAX
  task's per-file host code is one IEEE operation, so the result is the
  same); the disk dilation is the dilate kernel. `resize=True` shrinks
  the inputs and grows the probabilities back as cv2 does
  (ops/resize.py: INTER_AREA on the host, INTER_LINEAR on the device).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import camera as cameralib
from ..fsdb import io
from ..runtime.log import configure_logger
from ..runtime.task import FileByFileTask, Parameter

logger = configure_logger(__name__)


class Undistorted(FileByFileTask):
    """Undistort images using their camera intrinsics.

    Camera source (reference tasks/proc2d.py:62-88): per-image
    'colmap_camera'/'camera' metadata (default), or an
    IntrinsicCalibration output fileset (camera_model_source =
    "IntrinsicCalibration" [+ calibration_scan_id] with a chosen model).
    """

    upstream_task = Parameter(default="ImagesFilesetExists")
    camera_model_source = Parameter(default="metadata")
    calibration_scan_id = Parameter(default="")
    calibration_model = Parameter(default="OPENCV")

    def _calibrated_camera(self):
        """K/dist from an IntrinsicCalibration camera_model.json."""
        from ..utils import locate_task_filesets
        scan = self.ctx.scan
        if self.calibration_scan_id:
            scan = self.ctx.db.get_scan(self.calibration_scan_id) or scan
        fs_id = locate_task_filesets(scan, ["IntrinsicCalibration"])[
            "IntrinsicCalibration"]
        if fs_id == "None":
            raise FileNotFoundError("No IntrinsicCalibration fileset found")
        data = io.read_json(scan.get_fileset(fs_id).get_file("camera_model"))
        res = data[str(self.calibration_model)]
        K, dist = cameralib.colmap_params_to_k_dist(res["model"], res["params"])
        return {"K": K, "dist": dist}

    def _camera_for(self, fin):
        if str(self.camera_model_source) == "IntrinsicCalibration":
            return self._calibrated_camera()
        return cameralib.get_camera_kwargs_from_images_metadata(fin)

    @staticmethod
    def _out_ext(fin):
        """Undistorted output is written losslessly: re-encoding a
        resampled frame as JPEG shifts mask edges (the JAX package measured
        ~5 deg of divergence-angle accuracy on the real_plant fixture).
        Lossless inputs keep their extension; lossy ones are promoted to
        png."""
        ext = (fin.filename or "x.png").rsplit(".", 1)[-1].lower()
        return ext if ext in ("png", "tif", "tiff", "bmp") else "png"

    def f(self, fin, outfs):
        """One file on its own (a chunk of mixed image sizes)."""
        from ..ops.undistort import undistort
        cam = self._camera_for(fin)
        img = io.read_image(fin)
        if cam is None:
            logger.warning(f"Undistorted: no camera metadata for {fin.id}, "
                           "copying as-is")
        else:
            img = undistort(torch.from_numpy(img).to(self.ctx.device),
                            cam["K"], cam["dist"]).cpu().numpy()
        fout = outfs.get_file(fin.id, create=True)
        io.write_image(fout, img, self._out_ext(fin))
        return fout

    def _chunk(self, image):
        """Images of `image`'s size per launch: on the card as many as a
        quarter of the free memory holds (input and output), else 16."""
        if self.ctx.device.type != "cuda":
            return 16
        free, _ = torch.cuda.mem_get_info(self.ctx.device)
        return max(1, int(free // 4 // (2 * image.nbytes)))

    def run(self):
        """Group the files by camera; undistort each group in chunks of
        one launch each, the codecs on threads. The written metadata is the
        input file's (`set_metadata`, as the JAX task)."""
        from concurrent.futures import ThreadPoolExecutor

        from ..ops.undistort import undistort_batch
        from ..runtime.task import paused_gc

        inp = self.input()
        if isinstance(inp, (list, tuple)):
            inp = inp[0]
        infs = inp.get(create=False)
        outfs = self.output().get()
        files = infs.get_files(query=self.query or None)
        logger.info(f"Undistorted: {len(files)} files")

        groups: dict[tuple, list] = {}
        no_cam = []
        for fin in files:
            cam = self._camera_for(fin)
            if cam is None:
                no_cam.append(fin)
                continue
            key = (tuple(np.asarray(cam["K"]).ravel()),
                   tuple(np.asarray(cam["dist"]).ravel()))
            groups.setdefault(key, []).append(fin)

        def _write(fin, img):
            fout = outfs.get_file(fin.id, create=True)
            io.write_image(fout, img, self._out_ext(fin))
            fout.set_metadata(fin.get_metadata())

        dev = self.ctx.device
        with self.ctx.scan.deferred_store(), paused_gc(), \
                ThreadPoolExecutor(8) as ex:
            list(ex.map(lambda fin: _write(fin, io.read_image(fin)), no_cam))
            for (k_flat, d_flat), members in groups.items():
                K = np.asarray(k_flat, np.float32).reshape(3, 3)
                dist = np.asarray(d_flat, np.float32)
                imgs = list(ex.map(io.read_image, members))
                chunk = self._chunk(imgs[0])
                for i in range(0, len(members), chunk):
                    part, stack = members[i:i + chunk], imgs[i:i + chunk]
                    if len({im.shape for im in stack}) != 1:
                        for fin in part:   # mixed sizes: one file at a time
                            self.f(fin, outfs).set_metadata(
                                fin.get_metadata())
                        continue
                    out = undistort_batch(torch.from_numpy(np.stack(stack))
                                          .to(dev), K, dist).cpu().numpy()
                    list(ex.map(_write, part, out))


class Masks(FileByFileTask):
    """Binary plant masks from color filters
    (reference tasks/proc2d.py:207-249), on the run's device."""

    upstream_task = Parameter(default="Undistorted")
    type = Parameter(default="linear")
    parameters = Parameter(default=[0.0, 1.0, 0.0])
    dilation = Parameter(default=0)
    binarize = Parameter(default=True)
    threshold = Parameter(default=0.3)

    def run(self):
        """Decode on threads, stack the images by shape, one mask kernel
        launch (and one dilate launch) per stack, `(mask * 255)` as uint8
        PNGs written on threads, each with its input's metadata merged as
        FileByFileTask does."""
        from concurrent.futures import ThreadPoolExecutor

        from ..ops.masks import binary_dilation, mask_filter
        from ..runtime.task import paused_gc

        inp = self.input()
        if isinstance(inp, (list, tuple)):
            inp = inp[0]
        infs = inp.get(create=False)
        outfs = self.output().get()
        files = infs.get_files(query=self.query or None)
        logger.info(f"Masks: processing {len(files)} files")
        coefs = self.parameters
        if isinstance(coefs, str):
            import json
            coefs = json.loads(coefs)
        coefs = tuple(map(float, coefs))

        def _load(fin):
            img = io.read_image(fin)
            return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 \
                else img

        def _write(fin, fout, mask):
            io.write_image(fout, mask, "png")
            md = fin.get_metadata()
            md.update(fout.get_metadata())
            fout.set_metadata(md)

        n = max(int(self.n_io_threads), 1)
        with self.ctx.scan.deferred_store(), paused_gc(), \
                ThreadPoolExecutor(n) as ex:
            imgs = list(ex.map(_load, files))
            stacks: dict[tuple, list] = {}
            for i, im in enumerate(imgs):
                stacks.setdefault((im.shape, im.dtype.str), []).append(i)
            fouts = [outfs.get_file(fin.id, create=True) for fin in files]
            for idx in stacks.values():
                batch = torch.from_numpy(np.stack([imgs[i] for i in idx]))
                m = mask_filter(batch.to(self.ctx.device), str(self.type),
                                coefs, float(self.threshold),
                                bool(self.binarize))
                if bool(self.binarize) and int(self.dilation) > 0:
                    m = binary_dilation(m, int(self.dilation))
                out = (m.to(torch.float32) * 255).to(torch.uint8).cpu()
                list(ex.map(_write, [files[i] for i in idx],
                            [fouts[i] for i in idx], out.numpy()))


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
    #: True: shrink the input to (Sx, Sy) as cv2 INTER_AREA does and grow
    #: the probabilities back as cv2 INTER_LINEAR does (ops/resize.py);
    #: the camera metadata stays as it is.
    resize = Parameter(default=False)
    single_label = Parameter(default="")
    inverted_labels = Parameter(default=["background"])
    binarize = Parameter(default=True)
    threshold = Parameter(default=0.01)
    dilation = Parameter(default=1)
    #: flip-averaged test-time augmentation (models/unet.py:forward_probs)
    tta = Parameter(default=False)
    batch_size = Parameter(default=8, significant=False)
    #: "bf16", "float", or "int8": the dynamic int8 serving lane
    #: (models/quant.py; K16 on the card)
    conv_mode = Parameter(default="bf16", significant=False)
    #: dp serving over the run's ranks (models/unet.py:
    #: segmentation_inference): "auto" only with more than one card, true
    #: with more than one rank (RunContext.ranks)
    data_parallel = Parameter(default="auto", significant=False)

    def requires(self):
        return {"images": self._upstream(),
                "model": self.ctx.get_task(self.model_fileset)}

    def run(self):
        from concurrent.futures import ThreadPoolExecutor

        from ..models.checkpoint import load_model
        from ..models.unet import segmentation_inference
        from ..ops.carving import div_f32
        from ..ops.resize import resize_area_u8, resize_linear_f32
        from ..runtime.task import paused_gc

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
        resize = bool(self.resize)

        def _load(fin):
            img = io.read_image(fin)
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=-1)
            H, W = img.shape[:2]
            if resize:
                if (W, H) != (Sx, Sy):
                    img = resize_area_u8(img[..., :3], (Sx, Sy))
                # the original size, to grow the probabilities back to
                return img[..., :3], (W, H)
            # center crop to (Sy, Sx) as the reference does (:351)
            y0 = max((H - Sy) // 2, 0)
            x0 = max((W - Sx) // 2, 0)
            return img[y0: y0 + Sy, x0: x0 + Sx, :3], (x0, y0)

        with paused_gc(), ThreadPoolExecutor(max_workers=8) as ex:
            loaded = list(ex.map(_load, files))
        batch = np.stack([im for im, _ in loaded])

        dp = self.data_parallel
        if not isinstance(dp, bool):
            dp = {"auto": "auto", "true": True, "false": False}[
                str(dp).lower()]
        probs = segmentation_inference(
            model, batch, batch_size=int(self.batch_size),
            tta=bool(self.tta), conv_mode=str(self.conv_mode),
            data_parallel=dp, device=self.ctx.device,
            mesh=self.ctx.mesh if self.ctx.ranks > 1 else None)  # u8 NCHW
        pred = div_f32(probs.to(torch.float32), 255.0)
        if resize:
            # each image's probabilities back to its own size; its
            # camera metadata verbatim
            masks = []
            for i, (_, size) in enumerate(loaded):
                p = (pred[i] if size == (Sx, Sy)
                     else resize_linear_f32(pred[i], size))
                out, names = self.channel_masks(labels, p[None])
                masks.append(out[0].cpu().numpy())
            offsets = [(0, 0)] * len(loaded)
        else:
            out, names = self.channel_masks(labels, pred)
            masks = out.cpu().numpy()
            offsets = [off for _, off in loaded]
        outfs = self.output().get()
        with paused_gc():
            self._write_channels(outfs, list(files), labels, names, masks,
                                 offsets)

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

    def channel_masks(self, labels, pred):
        """The written masks of the (N, C, H, W) float32 probabilities (the
        net's uint8 output / 255), as (N, C', H, W) uint8 on their device
        (C' = the labels written) and the written labels: the JAX task's
        per-file steps, operation for operation, on the stack: `1 - p` for
        an inverted label; `> threshold` in float32 and the disk dilation
        (binarize); `1 - p` again for an inverted label (1 - (1 - p) is
        not p in float32); `p * 255` truncated to uint8."""
        from ..ops.masks import binary_dilation

        keep = [c for c, l in enumerate(labels)
                if not self.single_label or l == self.single_label]
        N, _, H, W = pred.shape
        dev = pred.device
        inv = torch.tensor([labels[c] in list(self.inverted_labels)
                            for c in keep], device=dev).view(1, -1, 1, 1)
        pred = torch.where(inv, 1.0 - pred[:, keep], pred[:, keep])
        if bool(self.binarize):
            m = pred > float(np.float32(self.threshold))
            if int(self.dilation) > 0:
                m = binary_dilation(m.reshape(-1, H, W), int(self.dilation))
            pred = m.reshape(N, len(keep), H, W).to(torch.float32)
        pred = torch.where(inv, 1.0 - pred, pred)
        return (pred * 255).to(torch.uint8), [labels[c] for c in keep]

    def _write_channels(self, outfs, metas, labels, names, out, offsets):
        from concurrent.futures import ThreadPoolExecutor

        # the files are created in the JAX task's order (image, then label):
        # downstream tasks read them in fileset order
        jobs = [(outfs.get_file(f"{fin.id}_{label}", create=True), fin, i, c)
                for i, fin in enumerate(metas)
                for c, label in enumerate(names)]

        def _write(job):
            fout, fin, i, c = job
            io.write_image(fout, out[i][c], "png")
            md = self._shift_principal_point(fin.get_metadata(), offsets[i])
            md["channel"] = names[c]
            fout.set_metadata(md)

        with self.ctx.scan.deferred_store(), \
                ThreadPoolExecutor(max_workers=8) as ex:
            list(ex.map(_write, jobs))
        outfs.set_metadata("label_names", list(labels))
