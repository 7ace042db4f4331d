"""Re-plot the CNC-vs-COLMAP pose QC figure from a processed scan (port of
bin/colmap_poses; role of reference bin/colmap_poses):

    python -m plant3dvision_tpu_torch.tools.colmap_poses <db>/<scan> \\
        [--out poses.png]

Prints the pose statistics and writes the figure (needs matplotlib).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from ..calibration import pose_estimation_figure
    from ..camera import compute_estimated_pose
    from ..fsdb import FSDB
    from ..runtime.cli import parse_dataset
    from ..tasks.colmap import get_cnc_poses

    ap = argparse.ArgumentParser(prog="colmap_poses")
    ap.add_argument("dataset")
    ap.add_argument("--out", default="poses.png")
    args = ap.parse_args(argv)

    db_path, scan_id = parse_dataset(args.dataset)
    db = FSDB(db_path)
    db.connect(unsafe=True)
    scan = db.get_scan(scan_id)
    cnc = get_cnc_poses(scan)
    estimated = {}
    for f in scan.get_fileset("images").get_files():
        cam = f.get_metadata("colmap_camera") or f.get_metadata("camera")
        if cam:
            estimated[f.id] = compute_estimated_pose(cam["rotmat"], cam["tvec"])
    stats = pose_estimation_figure(cnc, estimated, args.out, scan_id)
    print(stats)
    print(f"wrote {args.out}")
    db.disconnect()


if __name__ == "__main__":
    main()
