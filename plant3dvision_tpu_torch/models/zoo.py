"""Committed model checkpoints (port of plant3dvision_tpu/models/zoo.py;
role of the reference's get_model.sh, which downloads a checkpoint into a
'models' scan — tasks/proc2d.py:336-339). The files are the repo's own,
under checkpoints/."""

from __future__ import annotations

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

#: The default organ-segmentation checkpoint: the 2.03M-parameter ResUNet
#: (models/unet.py; widths 24, 48, 96, 192, 2 blocks per stage, stored as
#: float16; labels background, flower, fruit, leaf, pedicel, stem).
DEFAULT_CHECKPOINT = REPO / "checkpoints" / "unet_seg.npz"

#: The TPU-shaped segmentation CNN (models/segnet.py, 7.55M parameters,
#: stored as float16; the same six labels).
TPUSEGNET_CHECKPOINT = REPO / "checkpoints" / "tpusegnet_seg.npz"

#: The real-scan ResUNet checkpoint (labels background, stem, fruit),
#: self-distilled by the JAX package from the geometric route's organ labels
#: on the reference real_plant scan.
SEGNET_REAL_CHECKPOINT = REPO / "checkpoints" / "segnet_real.npz"


def install_checkpoint(db, scan_id="models", model_id="unet_seg",
                       path=None):
    """Copy a committed checkpoint (DEFAULT_CHECKPOINT unless `path` names
    another) into a DB 'models' scan fileset, the layout Segmentation2D and
    FusedSegmentationCarving expect (ModelFilesetExists with scan_id), with
    its label_names and config as metadata.

    Returns the created File, or None if the checkpoint is missing."""
    from .checkpoint import params_from_npz_bytes

    path = Path(path or DEFAULT_CHECKPOINT)
    if not path.exists():
        return None
    data = path.read_bytes()
    scan = db.get_scan(scan_id, create=True)
    fs = scan.get_fileset("models", create=True)
    f = fs.get_file(model_id, create=True)
    f.write_raw(data, "npz")
    _, config = params_from_npz_bytes(data)
    f.set_metadata("label_names", config.get("label_names"))
    f.set_metadata("model_config", json.loads(json.dumps(config)))
    return f
