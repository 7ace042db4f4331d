"""`romi_run_task`-compatible CLI (reference README.md:287-288):

    romi_run_task <TaskName> <dataset_path> --config <config.toml>

The dataset path is <db_root>/<scan_id>; the db root must contain the
`romidb` marker file.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from .config import RunContext
from .log import configure_logger
from .runner import run_task

logger = configure_logger("romi_run_task")


def parse_dataset(dataset: str):
    """Split <db>/<scan> — also honors ROMI_DB env (reference README.md:225)."""
    p = Path(dataset).expanduser()
    if (p.parent / "romidb").exists():
        return p.parent, p.name
    romi_db = os.environ.get("ROMI_DB")
    if romi_db and (Path(romi_db) / "romidb").exists():
        return Path(romi_db), str(dataset)
    raise SystemExit(f"Cannot locate a DB (romidb marker) for dataset: {dataset}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="romi_run_task",
        description="Run a plant3dvision_tpu_torch pipeline task on a dataset.")
    ap.add_argument("task", help="Task name (e.g. AnglesAndInternodes)")
    ap.add_argument("dataset", help="Path to the dataset: <db>/<scan_id>")
    ap.add_argument("--config", default=None, help="TOML pipeline config")
    ap.add_argument("--param", action="append", default=[],
                    metavar="Task.key=value",
                    help="Override a single task parameter on top of the "
                         "config (repeatable), e.g. Voxels.voxel_size=0.5")
    ap.add_argument("--workers", type=int, default=1,
                    help="Run independent tasks of the DAG concurrently "
                         "(role of luigi --workers in the reference stack)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the tasks compute on (default: cuda; "
                         "'cpu' runs the kernels' plain PyTorch versions)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the multi-device lanes (engine="
                         "'sharded', data_parallel); default one a card "
                         "on cuda, 1 on cpu")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="their process group's backend (default nccl on "
                         "cuda, gloo on cpu; ranks sharing a card: gloo)")
    ap.add_argument("--log-level", default="INFO")
    args = ap.parse_args(argv)

    # Importing tasks registers them all.
    from .. import tasks  # noqa: F401

    db_path, scan_id = parse_dataset(args.dataset)
    from .task import TaskRegistry
    try:
        TaskRegistry.get(args.task)
    except KeyError:
        raise SystemExit(
            f"Unknown task '{args.task}'. Known tasks:\n  "
            + "\n  ".join(TaskRegistry.known()))
    ctx = RunContext.from_paths(db_path, scan_id, args.config,
                                device=args.device, ranks=args.ranks,
                                backend=args.backend)
    for override in args.param:
        try:
            key, value = override.split("=", 1)
            task_name, param = key.split(".", 1)
        except ValueError:
            raise SystemExit(f"Bad --param (want Task.key=value): {override}")
        lowered = value.strip().lower()
        if lowered in ("true", "false"):        # Python-style bools too
            value = lowered == "true"
        elif lowered in ("none", "null"):
            value = None
        else:
            try:
                import json as _json
                value = _json.loads(value)
            except ValueError:
                pass  # keep the raw string
        ctx.config.setdefault(task_name, {})[param] = value
    # Back up the effective config into the scan dir (the reference's
    # romitask CLI writes this `pipeline.toml`; tasks/colmap.py:389-427
    # reads it back for calibration-scan compatibility checks).
    if ctx.config:
        try:
            from .config import dump_toml
            (ctx.scan.path() / "pipeline.toml").write_text(
                dump_toml(ctx.config))
        except Exception as e:
            logger.warning(f"could not back up pipeline.toml: {e}")
    try:
        run_task(ctx, args.task, workers=max(1, args.workers))
    finally:
        ctx.close()
        ctx.db.disconnect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
