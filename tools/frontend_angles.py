#!/usr/bin/env python3
"""Angle error of the real-scan front end (chip_smoke.py phase 9's path) on
a distorted photo scan at a reduced size, on the CPU or the card.

Writes chip_smoke.write_distorted_scan's scan of the north-star plant into
a temporary DB, runs chip_smoke.frontend_config through the port's runtime
to the angles, and
prints one JSON line: the task seconds, alive voxels, points, angles and the
mean angle error (positional and DTW-aligned) against the plant's ground
truth.

    python tools/frontend_angles.py --views 60 --width 720 --voxel 1.0 \
        --device cpu [--strict]

`--strict` takes chip_smoke.frontend_config(strict=True), phase 9's
control (strict carving, undilated masks, geom_pipe_fast.toml's skeleton
and angle settings).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

def run(views, width, voxel, device, strict=False):
    import numpy as np
    import chip_smoke as cs
    from plant3dvision_tpu_torch.evaluation import align_sequences
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.fsdb.testing import TemporaryDB
    from plant3dvision_tpu_torch.runtime import RunContext, run_task
    from plant3dvision_tpu_torch.synth import SyntheticPlant

    p = SyntheticPlant(**cs.NORTHSTAR_PLANT)
    cfg = cs.frontend_config(voxel, strict)
    height = width * 3 // 4
    with TemporaryDB() as db:
        cs.write_distorted_scan(db, "s", p, views, width, height,
                                1400.0 * width / 1440)
        ctx = RunContext(db, "s", cfg, device=device)
        t0 = time.perf_counter()
        rep = run_task(ctx, "AnglesAndInternodes", report=False)
        wall = time.perf_counter() - t0
        out = json.loads(ctx.scan.get_fileset(rep["AnglesAndInternodes"][
            "fileset"]).get_file("AnglesAndInternodes").read_raw())
        vol = np.load(ctx.scan.get_fileset(rep["Voxels"]["fileset"])
                      .get_files()[0].path())["volume"]
        pcd = io.read_point_cloud(ctx.scan.get_fileset(
            rep["PointCloud"]["fileset"]).get_files()[0])
    angles = np.asarray(out["angles"], float)
    gt = np.degrees(p.gt_angles)
    n = min(len(angles), len(gt))
    dtw = align_sequences(angles.tolist(), out["internodes"], gt.tolist(),
                          np.asarray(p.gt_internodes, float).tolist())
    return {"views": views, "image": [width, height], "voxel_mm": voxel,
            "device": device, "strict": strict, "wall_s": wall,
            "task_s": {k: v["seconds"] for k, v in rep.items()},
            "alive_voxels": int((vol == 1).sum()), "points": len(pcd.points),
            "n_angles": int(len(angles)), "n_gt": int(len(gt)),
            "angles": angles.round(3).tolist(),
            "positional_mean_error_deg":
                float(np.abs(angles[:n] - gt[:n]).mean()) if n else None,
            "mean_angle_error_deg": dtw["mean_angle_error"],
            "dtw_normalized_cost": dtw["normalized_cost"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--voxel", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--strict", action="store_true")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.views, a.width, a.voxel, a.device, a.strict)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
