"""Committed model checkpoints (port of plant3dvision_tpu/models/zoo.py;
role of the reference's get_model.sh, which downloads a checkpoint into a
'models' scan — tasks/proc2d.py:336-339). The files are the repo's own,
under checkpoints/."""

from __future__ import annotations

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

#: The TPU-shaped segmentation CNN (models/segnet.py, 7.55M parameters,
#: stored as float16; labels background, flower, fruit, leaf, pedicel,
#: stem). The only architecture the port runs so far.
TPUSEGNET_CHECKPOINT = REPO / "checkpoints" / "tpusegnet_seg.npz"


def install_checkpoint(db, scan_id="models", model_id="tpusegnet_seg",
                       path=None):
    """Copy a committed checkpoint into a DB 'models' scan fileset, the
    layout FusedSegmentationCarving expects (ModelFilesetExists with
    scan_id), with its label_names and config as metadata.

    Returns the created File, or None if the checkpoint is missing."""
    from .checkpoint import params_from_npz_bytes

    path = Path(path or TPUSEGNET_CHECKPOINT)
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
