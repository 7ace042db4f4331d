"""DAG runner: topological execution with retry + per-task wall-time report.

Replaces luigi.build (reference README.md:287-288). Observability: every run
produces a per-task timing table (aux subsystem called out in SURVEY.md §5 as
missing from the reference — added here as a first-class feature).
"""

from __future__ import annotations

import threading
import time

from .log import configure_logger
from .task import BaseTask, RetryableTaskError

logger = configure_logger(__name__)


class TaskFailure(Exception):
    pass


def _requires_list(task) -> list:
    """Normalize task.requires() (dict | list/tuple | single | None)
    to a flat dependency list — the ONE place the accepted shapes are
    defined (shared by DAG collection and the parallel scheduler)."""
    req = task.requires()
    deps = list(req.values()) if isinstance(req, dict) else (
        list(req) if isinstance(req, (list, tuple)) else [req])
    return [d for d in deps if d is not None]


def _collect(task: BaseTask, order: list, seen: set):
    key = task.get_task_family()
    if key in seen:
        return
    seen.add(key)
    for dep in _requires_list(task):
        _collect(dep, order, seen)
    order.append(task)


def _destroy_output(task):
    """A failed run() must not leave a partially-written fileset behind —
    completeness is fileset-existence, so partial outputs would corrupt
    resume semantics."""
    try:
        out = task.output()
        fs_id = getattr(out, "fileset_id", None)
        if fs_id is not None and task.ctx is not None:
            task.ctx.scan.delete_fileset(fs_id)
    except Exception:
        pass


class DBRunner:
    """Batch runner: execute a task list over one or every scan of a DB
    (role of romitask.runner.DBRunner, reference tests/unit/test_runner.py:3-16;
    this is also what FSDBWatcher drives on newly appearing scans).

    ``tasks`` is a list of task names/classes run in order per scan;
    ``config`` is the TOML-style {TaskName: {param: value}} dict shared
    by every scan's RunContext.
    """

    def __init__(self, db, tasks, config=None, workers=1):
        self.db = db
        self.tasks = list(tasks)
        self.config = config or {}
        #: scans processed concurrently by run() (luigi --workers role);
        #: scans are independent directories, so this is safe parallelism
        self.workers = int(workers)

    def run_scan(self, scan_id: str) -> dict:
        """Run the task list on one scan; returns {task: report} merged."""
        from .config import RunContext

        ctx = RunContext(self.db, scan_id, self.config)
        report: dict = {}
        for t in self.tasks:
            report.update(run_task(ctx, t, report=False))
        return report

    def run(self) -> dict:
        """Run the task list on every scan in the DB: {scan_id: report}."""
        scan_ids = sorted(self.db.list_scans())
        if self.workers > 1 and len(scan_ids) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=self.workers,
                                    thread_name_prefix="scan-worker") as ex:
                futs = {sid: ex.submit(self.run_scan, sid)
                        for sid in scan_ids}
                return {sid: fut.result() for sid, fut in futs.items()}
        reports = {}
        for scan_id in scan_ids:
            logger.info(f"DBRunner: scan {scan_id}")
            reports[scan_id] = self.run_scan(scan_id)
        return reports


def run_task(ctx, task_name_or_cls, report=True, workers=1) -> dict:
    """Resolve and run the dependency closure of a task bottom-up.

    ``workers`` > 1 executes independent tasks of the DAG concurrently in
    a thread pool (role of luigi's ``--workers``, which the reference
    inherits via romitask — README.md:287-288). Dependency order, retry,
    partial-output destruction and report semantics are identical to the
    serial path; a failure stops new submissions, lets in-flight tasks
    finish, then raises. Threads suit this workload: tasks are IO-bound
    (codec threads release the GIL) or dispatch device programs.

    Returns a report dict: {task_name: {"status", "seconds", "fileset"}}.
    """
    root = ctx.get_task(task_name_or_cls)
    order: list[BaseTask] = []
    _collect(root, order, set())

    results = {}
    try:
        if int(workers) > 1:
            _run_order_parallel(order, results, int(workers))
        else:
            _run_order(order, results)
    except BaseException:
        # the pipeline failed mid-way: still land any async artifact
        # writes of the tasks that DID succeed (best effort — the
        # original error stays the one raised)
        try:
            _flush_artifacts(results)
        except Exception:
            pass
        raise
    # async artifact writes ride under downstream task compute; whatever
    # is still in flight must land before this invocation returns
    _flush_artifacts(results)

    if report:
        width = max((len(k) for k in results), default=10)
        logger.info("--- task timing report ---")
        for k, v in results.items():
            logger.info(f"{k:<{width}}  {v['status']:<8} {v['seconds']:>8.2f}s")
    # observability: persist the last run report on the scan
    try:
        import datetime
        ctx.scan.set_metadata("last_run_report", {
            "timestamp": datetime.datetime.now().isoformat(timespec="seconds"),
            "tasks": results,
        })
    except Exception:
        pass
    return results


def _flush_artifacts(results) -> None:
    from ..fsdb import handoff
    if handoff.pending_count() == 0:
        return
    t0 = time.monotonic()
    handoff.flush()
    results["ArtifactFlush"] = {
        "status": "done", "seconds": round(time.monotonic() - t0, 3),
        "fileset": None,
    }
    logger.info(f"ArtifactFlush: {results['ArtifactFlush']['seconds']:.2f}s")


def _device_mem_mb():
    """Live CUDA memory footprint in MB, or None.

    Only consults an ALREADY-INITIALIZED CUDA context: task runs that
    never touch the card must not pay (or trigger) its initialization."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return round(torch.cuda.memory_allocated() / 1e6, 1)


#: one active torch.profiler trace at a time; under workers>1 a task that
#: overlaps an active trace skips profiling rather than nesting traces.
_profile_lock = threading.Lock()


def _maybe_profile(task_name: str):
    """Per-task profiler hook: when P3D_PROFILE=<dir> is set, each task's
    run() executes under torch.profiler (CPU, plus CUDA when a card is
    present) and writes <dir>/<TaskName>.json, a Chrome trace with the
    host timeline and the device kernels. Off (a no-op context) unless the
    env var is set, so the hot path never imports the profiler. With
    workers>1, tasks that overlap an active trace skip profiling (logged)."""
    import contextlib
    import os

    prof_dir = os.environ.get("P3D_PROFILE", "")
    if not prof_dir:
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def _traced():
        if not _profile_lock.acquire(blocking=False):
            logger.warning(f"{task_name}: another task's profiler trace "
                           "is active — skipping trace for this task")
            yield
            return
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(prof_dir, exist_ok=True)
            with profile(activities=acts) as prof:
                yield
            prof.export_chrome_trace(
                os.path.join(prof_dir, f"{task_name}.json"))
        finally:
            _profile_lock.release()

    return _traced()


#: number of tasks currently inside _execute_one — device_mem_mb is a
#: process-global sample, so it is only attributed to a task when no
#: other task ran concurrently with it (else a neighbour's buffers
#: would be booked on whoever happens to finish first).
_inflight = 0
_inflight_lock = threading.Lock()


def _execute_one(task):
    """Run one task with the retry/partial-output protocol.

    Returns (report_entry, n_tried, err) — err is None on success/skip;
    raising is left to the caller so the parallel scheduler can drain
    in-flight tasks before propagating."""
    global _inflight
    name = task.get_task_family()
    if task.complete():
        logger.info(f"{name}: already complete, skipping")
        return ({"status": "skipped", "seconds": 0.0,
                 "fileset": getattr(task.output(), "fileset_id", None)},
                0, None)
    # a stale (crashed-run) partial output would shadow this run's
    # writes — clear it before starting
    out = task.output()
    if getattr(out, "fileset_id", None) is not None and out.exists():
        logger.warning(f"{name}: clearing unfinalized partial output "
                       f"{out.fileset_id}")
        _destroy_output(task)
    t0 = time.monotonic()
    attempts = 1 + getattr(task, "retry_count", 0)
    last_err = None
    status = "failed"
    n_tried = 0
    with _inflight_lock:
        _inflight += 1
        ran_alone = _inflight == 1
    try:
        for attempt in range(attempts):
            n_tried = attempt + 1
            try:
                if attempt:
                    logger.warning(f"{name}: retry {attempt}/{attempts - 1}")
                with _maybe_profile(name):
                    task.run()
                if hasattr(task, "finalize"):
                    task.finalize()
                status = "done"
                last_err = None
                break
            except RetryableTaskError as e:
                last_err = e
                _destroy_output(task)
                continue
            except Exception as e:
                last_err = e
                _destroy_output(task)
                break
        dt = time.monotonic() - t0
        mem = _device_mem_mb() if ran_alone and _inflight == 1 else None
    finally:
        with _inflight_lock:
            _inflight -= 1
    out = task.output()
    entry = {
        "status": status,
        "seconds": round(dt, 3),
        "fileset": getattr(out, "fileset_id", None),
    }
    if mem is not None:
        entry["device_mem_mb"] = mem
    if status == "done":
        logger.info(f"{name}: done in {dt:.2f}s")
    return entry, n_tried, last_err


def _run_order(order, results) -> None:
    for task in order:
        name = task.get_task_family()
        entry, n_tried, err = _execute_one(task)
        results[name] = entry
        if err is not None:
            raise TaskFailure(
                f"Task {name} failed after {n_tried} attempt(s)") from err
        if entry["status"] not in ("done", "skipped"):
            raise TaskFailure(f"Task {name} failed")


def _task_deps(task) -> set:
    return {d.get_task_family() for d in _requires_list(task)}


def _run_order_parallel(order, results, workers: int) -> None:
    """Ready-set scheduler: submit every task whose dependencies are done,
    up to `workers` threads. Exactly the serial semantics otherwise."""
    from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

    tasks = {t.get_task_family(): t for t in order}
    deps = {n: _task_deps(t) & tasks.keys() for n, t in tasks.items()}
    pending = set(tasks)
    done: set = set()
    failure = None  # (name, n_tried, err)

    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="task-worker") as ex:
        futures = {}
        while pending or futures:
            if failure is None:
                for n in [n for n in sorted(pending) if deps[n] <= done]:
                    pending.discard(n)
                    futures[ex.submit(_execute_one, tasks[n])] = n
            if not futures:
                break  # failure drained, or nothing can become ready
            finished, _ = wait(list(futures), return_when=FIRST_COMPLETED)
            for fut in finished:
                n = futures.pop(fut)
                entry, n_tried, err = fut.result()
                results[n] = entry
                if err is not None or entry["status"] not in ("done",
                                                              "skipped"):
                    if failure is None:
                        failure = (n, n_tried, err)
                else:
                    done.add(n)

    if failure is not None:
        n, n_tried, err = failure
        if err is not None:
            raise TaskFailure(
                f"Task {n} failed after {n_tried} attempt(s)") from err
        raise TaskFailure(f"Task {n} failed")
    if pending:
        raise TaskFailure(
            "Dependency cycle or unreachable tasks: " + ", ".join(
                sorted(pending)))
