"""Slice-montage viewer for a Voxels output (port of bin/volume_viewer; role
of reference bin/volume_viewer — headless: writes a PNG montage instead of
a GUI; needs matplotlib):

    python -m plant3dvision_tpu_torch.tools.volume_viewer <db>/<scan> \\
        [--axis 2] [--out volume.png]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from ..fsdb import FSDB, io
    from ..runtime.cli import parse_dataset
    from ..utils import locate_task_filesets
    from ..visu import volume_slice_figure

    ap = argparse.ArgumentParser(prog="volume_viewer")
    ap.add_argument("dataset")
    ap.add_argument("--axis", type=int, default=2)
    ap.add_argument("--out", default="volume.png")
    args = ap.parse_args(argv)

    db_path, scan_id = parse_dataset(args.dataset)
    db = FSDB(db_path)
    db.connect(unsafe=True)
    scan = db.get_scan(scan_id)
    fs_id = locate_task_filesets(scan, ["Voxels"])["Voxels"]
    if fs_id == "None":
        sys.exit("No Voxels fileset found")
    vols = io.read_npz(scan.get_fileset(fs_id).get_files()[0])
    key = list(vols.keys())[0]
    volume_slice_figure(vols[key], args.out, axis=args.axis)
    print(f"wrote {args.out} (label '{key}', shape {vols[key].shape})")
    db.disconnect()


if __name__ == "__main__":
    main()
