"""FusedCarving: images -> carved volume in one pass.

The compatible task DAG (Masks -> Voxels) materializes 300 mask PNGs per
scan — two full codec round trips the reference also pays. This task fuses
mask computation into carving setup: images are decoded, filtered and
BIT-PACKED per-thread, so nothing but 1-bit masks ever exists, then the
carve kernel runs (ops/carving.carve). Output is Voxels-format (npz volume +
voxel_size/origin metadata), so PointCloud etc. consume it via
upstream_task = "FusedCarving".
"""

from __future__ import annotations

import numpy as np
import torch

from ..fsdb import io
from ..runtime.log import configure_logger
from ..runtime.task import Parameter, RomiTask

logger = configure_logger(__name__)


class FusedCarving(RomiTask):
    upstream_task = Parameter(default="ImagesFilesetExists")
    query = Parameter(default={})
    camera_metadata = Parameter(default="camera")
    voxel_size = Parameter(default=1.0)
    bounding_box = Parameter(default=None)
    # mask parameters (same semantics as the Masks task)
    type = Parameter(default="linear")
    parameters = Parameter(default=[0.0, 1.0, 0.0])
    threshold = Parameter(default=0.3)
    dilation = Parameter(default=0)
    invert = Parameter(default=False)

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

    #: carve engine of the JAX package ("fused", "pv", "vb", "fp",
    #: "sharded" — all bit-exact with one another). The port has one carve
    #: kernel, which every engine name runs on the run's device; "sharded"
    #: with more than one rank (RunContext.ranks) carves each group
    #: view-sharded over the run's mesh (parallel/carving_mp.py:
    #: carve_sharded_hierarchical, the same volume). Not significant, so
    #: fileset ids are the same for every engine.
    engine = Parameter(default="fused", significant=False)
    #: decode/upload chunk: the decode+threshold+pack of chunk i+1 overlaps
    #: the (asynchronous, pinned-memory) upload of chunk i
    chunk_views = Parameter(default=32, significant=False)
    #: split the views into this many equal groups. Carve launches are
    #: asynchronous, so the card carves group g WHILE the host decodes
    #: group g+1. Carving is a pure per-view intersection (kill/seen sets
    #: OR over views), so the per-group label volumes merge exactly:
    #: -1 if any group killed, else 1 if any group saw, else 0 — the
    #: merged volume is bit-identical to the single-pass carve.
    #: 0 = auto (3 groups when the scan has >= 150 views, where decode
    #: dominates; else single-pass); 1 = off.
    overlap_groups = Parameter(default=0, significant=False)

    def _decode_group(self, items, ex, load):
        """Decode+threshold+bit-pack `items`, upload in chunks.

        Returns (packed (n, ceil(HW/8)) uint8, cams (n, 16) float32,
        valid (n,) bool), all on the run's device.
        """
        dev = self.ctx.device
        chunk = max(int(self.chunk_views), 1)
        parts, cams_l = [], []
        for i in range(0, len(items), chunk):
            batch = list(ex.map(load, items[i:i + chunk]))
            host = torch.from_numpy(np.stack([b[0] for b in batch]))
            if dev.type == "cuda":
                # pinned staging buffer: the copy runs asynchronously on
                # the current stream while the host decodes the next chunk
                parts.append(host.pin_memory().to(dev, non_blocking=True))
            else:
                parts.append(host)
            cams_l += [b[1] for b in batch]
        packed = parts[0] if len(parts) == 1 else torch.cat(parts)
        cams = torch.from_numpy(np.stack(cams_l)).to(dev)
        valid = torch.ones(len(items), dtype=torch.bool, device=dev)
        return packed, cams, valid

    def _carve_group(self, packed, cams, valid, origin, vs, shape, hw):
        from ..ops.carving import carve

        if str(self.engine) == "sharded" and self.ctx.ranks > 1:
            from ..parallel.carving_mp import carve_sharded_hierarchical
            return carve_sharded_hierarchical(
                None, cams, valid, origin, vs, shape, self.ctx.mesh(),
                packed=packed, hw=hw).to(packed.device)
        return carve(packed, cams, valid, origin, vs, shape, hw)

    def run(self):
        from concurrent.futures import ThreadPoolExecutor

        from ..ops.carving import camera_from_metadata, pack_masks
        from ..ops.masks import compute_mask_numpy

        images_fs = self.input()[0].get(create=False) if isinstance(
            self.input(), (list, tuple)) else self.input().get(create=False)
        files = images_fs.get_files(query=self.query or None)
        cam_key = str(self.camera_metadata)

        coefs = self.parameters
        if isinstance(coefs, str):
            import json
            coefs = json.loads(coefs)

        selected = []
        for f in files:
            cam = f.get_metadata(cam_key)
            if cam is not None:
                selected.append((f, cam))
        if not selected:
            raise ValueError(f"No images with '{cam_key}' camera metadata")

        shape_hw = {}

        def _load_pack(item):
            f, cam = item
            img = io.read_image(f)
            m = compute_mask_numpy(
                img, filter_type=str(self.type),
                coefs=tuple(map(float, coefs)),
                threshold=float(self.threshold),
                dilation_radius=int(self.dilation), binarize=True,
                as_bool=True)
            if bool(self.invert):
                m = ~m
            shape_hw["hw"] = m.shape
            return pack_masks(m), camera_from_metadata(cam)

        bbox = self._resolve_bounding_box()
        vs = float(self.voxel_size)
        x_min, x_max = bbox["x"]; y_min, y_max = bbox["y"]; z_min, z_max = bbox["z"]
        shape = (int((x_max - x_min) / vs) + 1, int((y_max - y_min) / vs) + 1,
                 int((z_max - z_min) / vs) + 1)
        origin = np.array([x_min, y_min, z_min])  # float64 for metadata parity
        logger.info(f"FusedCarving: grid {shape} at {vs} mm")

        n = len(selected)
        groups = int(self.overlap_groups)
        if groups == 0:
            groups = 3 if n >= 150 else 1
        groups = min(max(groups, 1), n)
        gsize = -(-n // groups)
        groups = -(-n // gsize)   # drop groups the ceil split left empty
        #                           (e.g. 4 views / 3 groups -> 2+2)

        # paused_gc: gen-2 collections otherwise stall the decode threads
        from ..runtime.task import paused_gc
        vol = None
        with paused_gc(), ThreadPoolExecutor(max_workers=8) as ex:
            for g in range(groups):
                items = selected[g * gsize:(g + 1) * gsize]
                packed, cams, valid = self._decode_group(items, ex,
                                                         _load_pack)
                H, W = shape_hw["hw"]
                if g == 0:
                    logger.info(f"FusedCarving: {n} views at {W}x{H}"
                                + (f" in {groups} overlapped groups"
                                   if groups > 1 else ""))
                v = self._carve_group(packed, cams, valid, origin, vs,
                                      shape, (H, W))
                if vol is None:
                    vol = v
                else:
                    # -1 (killed) dominates, else 1 (seen) over 0
                    vol = torch.where(torch.minimum(vol, v) == -1,
                                      torch.tensor(-1, dtype=torch.int8,
                                                   device=v.device),
                                      torch.maximum(vol, v))

        outfile = self.output_file()
        out_vol = vol.to(torch.int32)
        # PointCloud gets the volume in memory, on the device; the NPZ
        # (pull + deflate) rides the artifact-writer thread under the
        # downstream tasks (fsdb.handoff)
        from ..fsdb import handoff
        handoff.cache_put(outfile, {"volume": out_vol})
        io.write_npz_async(outfile, lambda: {"volume": out_vol.cpu().numpy()})
        outfile.set_metadata({"voxel_size": vs, "origin": origin.tolist()})
