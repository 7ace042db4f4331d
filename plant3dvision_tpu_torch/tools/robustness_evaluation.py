"""Replicate a scan N times, run a task on each replicate, and compare the
outputs pairwise (port of bin/robustness_evaluation; role of reference
bin/robustness_evaluation):

    python -m plant3dvision_tpu_torch.tools.robustness_evaluation \\
        <db>/<scan> --task PointCloud --config cfg.toml -n 5 \\
        [--workers 1] [--out robustness_results.json] [--device cuda]

Copies the scan to `<scan>_rep00`, `<scan>_rep01`, ... (a replicate that
exists is reused), runs the task on each through the port's runtime on
`--device` (the card by default; "cpu" runs the plain versions), and
writes {task: {comparison function: result}} to `--out`, the functions
being `compare.COMPARISON_FUNCTIONS[task]` (robustness_evaluation.json
beside this module lists them as the reference's file does).
"""

from __future__ import annotations

import argparse
import inspect
import json
import shutil
import sys


def main(argv=None):
    from ..compare import COMPARISON_FUNCTIONS
    from ..fsdb import FSDB
    from ..runtime import RunContext, run_task
    from ..runtime.cli import parse_dataset
    from ..runtime.config import load_toml
    from ..utils import jsonify

    ap = argparse.ArgumentParser(
        prog="robustness_evaluation",
        description="Run a task on N copies of a scan and compare them.")
    ap.add_argument("dataset")
    ap.add_argument("--task", default="PointCloud")
    ap.add_argument("--config", required=True)
    ap.add_argument("-n", "--replicates", type=int, default=5)
    ap.add_argument("--workers", type=int, default=1,
                    help="replicate scans processed concurrently "
                         "(they are independent copies)")
    ap.add_argument("--out", default="robustness_results.json")
    ap.add_argument("--device", default="cuda",
                    help="where the tasks run: cuda (default) or cpu")
    args = ap.parse_args(argv)

    db_path, scan_id = parse_dataset(args.dataset)
    db = FSDB(db_path)
    db.connect(unsafe=True)
    config = load_toml(args.config)

    base = db.get_scan(scan_id)
    replicate_ids = []
    for i in range(args.replicates):
        rid = f"{scan_id}_rep{i:02d}"
        if db.get_scan(rid) is None:
            shutil.copytree(base.path(), db.path() / rid)
            db._load_scans()
        replicate_ids.append(rid)

    def _run_replicate(rid):
        print(f"=== running {args.task} on {rid}")
        ctx = RunContext(db, rid, config, device=args.device)
        run_task(ctx, args.task, report=False)

    if args.workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=args.workers) as ex:
            list(ex.map(_run_replicate, replicate_ids))
    else:
        for rid in replicate_ids:
            _run_replicate(rid)

    scans = [db.get_scan(r) for r in replicate_ids]
    results = {}
    fn = COMPARISON_FUNCTIONS.get(args.task)
    if fn is None:
        print(f"No comparison function for task {args.task}; "
              f"known: {sorted(COMPARISON_FUNCTIONS)}")
        sys.exit(1)
    # a task row may carry a LIST of comparison functions (pose tasks)
    fns = fn if isinstance(fn, (list, tuple)) else [fn]
    results[args.task] = {}
    for f_ in fns:
        name = getattr(f_, "func", f_).__name__
        kw = ({"device": args.device}
              if "device" in inspect.signature(f_).parameters else {})
        results[args.task][name] = f_(scans, **kw)
    with open(args.out, "w") as f:
        json.dump(jsonify(results), f, indent=2)
    print(f"wrote {args.out}")
    db.disconnect()


if __name__ == "__main__":
    main()
