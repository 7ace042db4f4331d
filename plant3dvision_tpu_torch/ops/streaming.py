"""Streaming space carving: live previews during acquisition (port of
plant3dvision_tpu/ops/streaming.py, `StreamingCarver`).

The ROMI plant imager acquires a turntable scan over minutes; the batch
pipeline carves once the scan is complete. `StreamingCarver` takes views
as they arrive and carves every view received so far at any point
("preview"), so the operator sees the reconstruction form and the final
volume is ready the moment the last image lands. Carving is a per-view
intersection, so a preview after k views is exact for those k views, and
the last one is the batch carve of the whole scan.

On the card: each view's bit-packed mask row and camera go into device
buffers that grow by doubling (no concatenation at each preview), and a
preview is one K1 launch (ops/carving.py:carve) over the n views received,
with no padding. The JAX package pads the view axis to a power-of-two
bucket for XLA's compile cache (`_bucket`, kept here for its tests);
PyTorch compiles nothing per shape, so `bucket_min` and `caps` (the bucket
floor and the fused engine's static caps) are accepted and ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.log import configure_logger
from .carving import camera_from_metadata, carve

logger = configure_logger(__name__)

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _bucket(n: int, lo: int) -> int:
    b = max(lo, 1)
    while b < n:
        b *= 2
    return b


def pack_mask_row(mask) -> torch.Tensor:
    """An (H, W) mask tensor (bool, or nonzero = plant) -> its flat
    row-major MSB-first bit row (ceil(HW/8),) uint8 on the mask's device:
    `np.packbits(mask.reshape(-1) != 0)`."""
    bits = (mask.reshape(-1) != 0).to(torch.uint8)
    bits = torch.nn.functional.pad(bits, (0, (-bits.numel()) % 8))
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=bits.device)
    return (bits.view(-1, 8) * w).sum(1, dtype=torch.uint8)


class StreamingCarver:
    """Incremental carving session over a fixed voxel grid.

    Parameters mirror ops.carving.Backprojection (shape/origin/
    voxel_size); `hw` is the mask resolution (H, W), fixed for the scan.
    `bucket_min` and `caps` are the JAX package's compile-cache settings,
    accepted and ignored (module docstring). `device` holds the buffers
    and runs the carve (the card by default; "cpu" runs the plain
    version).

    Usage::

        sc = StreamingCarver(shape, origin, voxel_size, hw=(1080, 1440))
        for img, cam in acquisition:          # as images arrive
            sc.add_view(mask_of(img), cam)
            vol = sc.preview()                # optional, any time
        alive = sc.preview()                  # final == batch carve
    """

    def __init__(self, shape, origin, voxel_size, hw, bucket_min=16,
                 caps=(8192, 32768), device="cuda"):
        self.shape = tuple(int(s) for s in shape)
        self.origin = np.asarray(origin, np.float32)
        self.voxel_size = float(voxel_size)
        self.hw = (int(hw[0]), int(hw[1]))
        self.device = torch.device(device)
        self.row_bytes = (self.hw[0] * self.hw[1] + 7) // 8
        self._packed = torch.empty((16, self.row_bytes), dtype=torch.uint8,
                                   device=self.device)
        self._cams = torch.empty((16, 16), dtype=torch.float32,
                                 device=self.device)
        self._n = 0
        self._n_previews = 0

    @property
    def n_views(self) -> int:
        return self._n

    def _row(self, mask):
        """One view's packed row (row_bytes,) uint8 on the device."""
        H, W = self.hw
        if not isinstance(mask, torch.Tensor):
            mask = torch.from_numpy(np.ascontiguousarray(mask))
        if mask.ndim == 2:
            if tuple(mask.shape) != (H, W):
                raise ValueError(f"mask shape {tuple(mask.shape)} != hw "
                                 f"{(H, W)}")
            return pack_mask_row(mask.to(self.device))
        if mask.ndim != 1 or mask.dtype != torch.uint8:
            raise ValueError("mask must be (H, W) binary or packed uint8")
        if mask.numel() != self.row_bytes:
            raise ValueError(f"packed row holds {mask.numel()} bytes, the "
                             f"{H}x{W} masks need {self.row_bytes}")
        return mask.to(self.device)

    def _grow(self):
        """Double both buffers when they are full (one copy each)."""
        if self._n < len(self._packed):
            return
        cap = 2 * len(self._packed)
        packed = torch.empty((cap, self.row_bytes), dtype=torch.uint8,
                             device=self.device)
        cams = torch.empty((cap, 16), dtype=torch.float32, device=self.device)
        packed[:self._n] = self._packed[:self._n]
        cams[:self._n] = self._cams[:self._n]
        self._packed, self._cams = packed, cams

    def add_view(self, mask, camera) -> None:
        """Register one view: `mask` is (H, W) bool/0-1 (plant=1), a numpy
        array or a tensor, or an already bit-packed flat row (ceil(H*W/8),)
        uint8; `camera` is a reference camera-metadata dict (cl.py:293-296)
        or a packed (16,) vector. The packed row and the camera go to the
        device buffers right away."""
        row = self._row(mask)
        cam = (camera_from_metadata(camera) if isinstance(camera, dict)
               else np.asarray(camera, np.float32))
        if cam.shape != (16,):
            raise ValueError(f"camera vector shape {cam.shape} != (16,)")
        self._grow()
        self._packed[self._n] = row
        self._cams[self._n] = torch.from_numpy(cam)
        self._n += 1

    def preview(self, out: str = "alive"):
        """Carve every view received so far; returns the volume on the
        device.

        out="alive": (shape) bool — alive voxels (seen and never killed),
        the PointCloud input plane. out="int8": the raw -1/0/1 volume
        (killed/unobserved/seen). The final preview is bit-identical to
        the batch carve over the full mask set.
        """
        n = self._n
        if n == 0:
            raise ValueError("no views added yet")
        valid = torch.ones(n, dtype=torch.bool, device=self.device)
        self._n_previews += 1
        logger.debug(f"StreamingCarver: preview #{self._n_previews} at "
                     f"{n} views")
        vol = carve(self._packed[:n], self._cams[:n], valid, self.origin,
                    self.voxel_size, self.shape, self.hw)
        return vol == 1 if out == "alive" else vol
