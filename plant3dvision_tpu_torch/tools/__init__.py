"""Command-line tools of the port (`python -m
plant3dvision_tpu_torch.tools.<name>`): the gather probes, and the JAX
package's bin/ scripts with their arguments and outputs
(robustness_evaluation, check_measures, colmap_poses, create_charuco_board,
volume_viewer, voronoi_texture_generator, dash_explorer), plus `--device`
where a tool runs tasks."""

from __future__ import annotations

import numpy as np


def write_image(path, image) -> None:
    """Write a uint8 RGB or gray image to `path` by its extension: PNG by the
    port's own codec, other formats through cv2 (which must import)."""
    image = np.asarray(image)
    if str(path).lower().endswith(".png"):
        from ..fsdb.io import png_encode
        with open(path, "wb") as fh:
            fh.write(png_encode(image))
        return
    import cv2
    if image.ndim == 3 and image.shape[2] == 3:
        image = cv2.cvtColor(image, cv2.COLOR_RGB2BGR)
    if not cv2.imwrite(str(path), image):
        raise OSError(f"could not write {path}")
