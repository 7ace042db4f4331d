"""Batch CNN model evaluation over a test database (port of the repo's
evaluate_model.py; role of the reference's evaluate_model.py): run
Segmentation2D on every scan that holds a ground-truth mask fileset,
compare its masks with the ground truth (metrics.CompareMaskFilesets) and
write the per-class precision / recall of every scan as JSON.

    python -m plant3dvision_tpu_torch.tools.evaluate_model <db_root> \
        --config configs/ml_pipe_synth.toml [--gt-fileset gt_masks] \
        [--out model_eval.json] [--device cuda|cpu]

`main` returns the results ({scan: {label: {...}}}), as written.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="evaluate_model")
    ap.add_argument("db_root")
    ap.add_argument("--config", required=True)
    ap.add_argument("--gt-fileset", default="gt_masks")
    ap.add_argument("--out", default="model_eval.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    from ..fsdb import FSDB
    from ..metrics import CompareMaskFilesets
    from ..runtime import RunContext, run_task
    from ..runtime.config import load_toml
    from ..utils import jsonify, locate_task_filesets

    db = FSDB(args.db_root)
    db.connect(unsafe=True)
    config = load_toml(args.config)

    all_results = {}
    try:
        for scan_id in db.list_scans():
            scan = db.get_scan(scan_id)
            if scan.get_fileset(args.gt_fileset) is None:
                continue
            print(f"=== {scan_id}")
            t0 = time.perf_counter()
            ctx = RunContext(db, scan_id, config, device=args.device)
            try:
                run_task(ctx, "Segmentation2D", report=False)
            finally:
                ctx.close()
            seg_id = locate_task_filesets(scan, ["Segmentation2D"])[
                "Segmentation2D"]
            seg_fs = scan.get_fileset(seg_id)
            labels = [lb for lb in (seg_fs.get_metadata("label_names") or [])
                      if lb != "background"]
            cmp = CompareMaskFilesets(scan.get_fileset(args.gt_fileset),
                                      seg_fs, labels)
            all_results[scan_id] = cmp.results["label-results"]
            for label, r in cmp.results["label-results"].items():
                print(f"  {label:10s} precision={r['precision']} "
                      f"recall={r['recall']}")
            print(f"  ({time.perf_counter() - t0:.2f} s)")
        with open(args.out, "w") as f:
            json.dump(jsonify(all_results), f, indent=2)
        print(f"wrote {args.out}")
    finally:
        db.disconnect()
    return all_results


if __name__ == "__main__":
    main()
