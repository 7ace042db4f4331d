"""Task base classes.

Semantics mirror the reference's romitask/luigi runtime (SURVEY.md L1):

- a task's output is a Fileset named ``{TaskName}_{slug}_{hash}`` where the
  hash is a deterministic digest of the task's significant parameters
  (observed reference naming, e.g. ``TreeGraph__False_CurveSkeleton_c304a2cc71``);
- a task is *complete* iff its target fileset exists and is non-empty;
- the DAG is config-defined: ``upstream_task`` (and friends) are themselves
  parameters holding task names;
- ``Clean`` wipes derived filesets; marker tasks assert existing inputs.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import re
import threading

from .log import configure_logger

logger = configure_logger(__name__)


class RetryableTaskError(Exception):
    """Raised by a task run() to request a retry (reference: the Colmap task's
    'blind angle' pose-failure check, tasks/colmap.py:810-834)."""


class Parameter:
    """Class-level declaration of a configurable task parameter."""

    _counter = 0

    def __init__(self, default=None, significant=True):
        self.default = default
        self.significant = significant
        self.name = None
        Parameter._counter += 1
        self.order = Parameter._counter

    def __set_name__(self, owner, name):
        self.name = name


class TaskRegistry:
    """The port's own registry (the JAX package's is a separate dict, so
    both task libraries can live in one process)."""

    _registry: dict[str, type] = {}

    @classmethod
    def register(cls, task_cls):
        cls._registry[task_cls.__name__] = task_cls

    @classmethod
    def get(cls, name: str) -> type:
        if name not in cls._registry:
            # lazily pull in the task library (registers all pipeline tasks)
            import importlib
            importlib.import_module("plant3dvision_tpu_torch.tasks")
        if name not in cls._registry:
            raise KeyError(f"Unknown task: {name!r}. Known: {sorted(cls._registry)}")
        return cls._registry[name]

    @classmethod
    def known(cls):
        return sorted(cls._registry)


class _TaskMeta(type):
    def __new__(mcs, name, bases, ns):
        cls = super().__new__(mcs, name, bases, ns)
        params = {}
        for base in reversed(cls.__mro__):
            for k, v in vars(base).items():
                if isinstance(v, Parameter):
                    params[k] = v
        cls._params = params
        if name not in ("BaseTask",):
            TaskRegistry.register(cls)
        return cls


class BaseTask(metaclass=_TaskMeta):
    retry_count = 0

    def __init__(self, ctx, **kwargs):
        self.ctx = ctx
        cfg = ctx.task_config(type(self).__name__) if ctx is not None else {}
        for pname, param in self._params.items():
            if pname in kwargs:
                val = kwargs[pname]
            elif pname in cfg:
                val = cfg[pname]
            else:
                val = param.default
            setattr(self, pname, val)

    # -- identity ------------------------------------------------------
    def get_task_family(self) -> str:
        return type(self).__name__

    def significant_params(self) -> dict:
        out = {}
        for pname, param in sorted(self._params.items()):
            if param.significant:
                out[pname] = getattr(self, pname)
        return out

    def task_id(self) -> str:
        """``{TaskName}_{slug}_{hash10}``.

        Same naming scheme as luigi task ids (which name the reference's
        output filesets), but the hash additionally covers the ids of all
        required tasks — so changing an upstream task's parameters changes
        every downstream fileset id too (luigi/romitask silently reuse
        stale downstream outputs in that case).
        """
        if getattr(self, "_task_id_cache", None) is not None:
            return self._task_id_cache
        name = self.get_task_family()
        params = self.significant_params()
        blob = repr(sorted((k, repr(v)) for k, v in params.items()))
        req = self.requires()
        deps = (list(req.values()) if isinstance(req, dict)
                else list(req) if isinstance(req, (list, tuple)) else [req])
        dep_ids = sorted(
            d.task_id() if hasattr(d, "task_id") else d.get_task_family()
            for d in deps if d is not None and d.output() is not None)
        digest = hashlib.md5((name + blob + repr(dep_ids)).encode()).hexdigest()[:10]
        ordered = sorted(self._params.items(), key=lambda kv: kv[1].order)
        parts = []
        for pname, param in ordered:
            if not param.significant or len(parts) >= 3:
                continue
            parts.append(re.sub(r"[^A-Za-z0-9_]", "_", str(getattr(self, pname)))[:16])
        slug = "_".join(parts)
        self._task_id_cache = (f"{name}_{slug}_{digest}" if slug
                               else f"{name}_{digest}")
        return self._task_id_cache

    # -- DAG -----------------------------------------------------------
    def requires(self):
        return []

    def input(self):
        req = self.requires()
        if isinstance(req, dict):
            return {k: t.output() for k, t in req.items()}
        if isinstance(req, (list, tuple)):
            outs = [t.output() for t in req]
            return outs[0] if len(outs) == 1 else outs
        return req.output()

    def output(self):
        raise NotImplementedError

    def complete(self) -> bool:
        out = self.output()
        if out is None:
            return True
        return out.exists()

    def run(self):
        raise NotImplementedError

    def _upstream(self, name_attr="upstream_task"):
        return self.ctx.get_task(getattr(self, name_attr))


class FilesetTarget:
    """Completeness target: fileset exists and is non-empty
    (reference semantics: tests/unit/test_task.py:50-58)."""

    def __init__(self, scan, fileset_id: str):
        self.scan = scan
        self.fileset_id = fileset_id

    def get(self, create=True):
        fs = self.scan.get_fileset(self.fileset_id, create=create)
        return fs

    def exists(self) -> bool:
        fs = self.scan.get_fileset(self.fileset_id)
        return fs is not None and len(fs.get_files()) > 0


class RomiTask(BaseTask):
    """A pipeline task whose output is a param-hashed fileset."""

    upstream_task = Parameter(default="ImagesFilesetExists")
    scan_id = Parameter(default="", significant=False)

    def requires(self):
        return [self._upstream()]

    def complete(self) -> bool:
        """Crash-safe completeness: the output fileset must exist, be
        non-empty AND carry the 'task_params' metadata that finalize()
        writes only after run() succeeded. A run killed mid-write leaves
        files but no marker, so the next run recomputes instead of
        silently consuming a half-written fileset (plain existence — the
        reference's rule — cannot tell the two apart)."""
        out = self.output()
        if out is None:
            return True
        if not out.exists():
            return False
        if not isinstance(out, FilesetTarget):
            return True
        fs = self.ctx.scan.get_fileset(out.fileset_id)
        return fs is not None and fs.get_metadata("task_params") is not None

    def output(self) -> FilesetTarget:
        return FilesetTarget(self.ctx.scan, self.task_id())

    def input_file(self, file_id=None):
        """Single input file of the upstream output fileset."""
        inp = self.input()
        if isinstance(inp, (list, tuple)):
            inp = inp[0]
        fs = inp.get(create=False)
        if fs is None:
            raise FileNotFoundError(f"Upstream fileset missing for {self.get_task_family()}")
        if file_id is not None:
            return fs.get_file(file_id)
        files = fs.get_files()
        if len(files) != 1:
            # Prefer the conventional single-output id (task family of upstream)
            for f in files:
                if f.id == fs.id.split("_")[0] or f.id == "out":
                    return f
            if not files:
                raise FileNotFoundError(f"No file in upstream fileset {fs.id}")
        return files[0]

    def output_file(self, file_id=None, create=True):
        if file_id is None:
            file_id = self.get_task_family()
        fs = self.output().get()
        return fs.get_file(file_id, create=create)

    def finalize(self):
        """Record task params on the output fileset (reference writes
        'task_params' metadata on outputs)."""
        out = self.output()
        if out is not None and isinstance(out, FilesetTarget):
            fs = self.ctx.scan.get_fileset(out.fileset_id)
            if fs is not None:
                params = {k: _jsonable(v) for k, v in self.significant_params().items()}
                fs.set_metadata("task_params", params)


def _jsonable(v):
    import numpy as np
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


_gc_pause_lock = threading.Lock()
_gc_pause_depth = 0
_gc_was_enabled = True


@contextlib.contextmanager
def paused_gc():
    """Disable the cycle collector for a bulk decode/encode loop.

    A pipeline process accumulates many live objects (fileset metadata,
    jit caches); once it does, gen-2 collections triggered by the
    allocation churn of image codecs hold the GIL and stall every IO
    thread — measured 2-3x slowdown of the 300-image FusedCarving
    decode phase inside a full-pipeline process vs a fresh one. Codec
    garbage is acyclic (plain arrays), so refcounting reclaims it; the
    collector just needs to stay out of the loop.

    Process-wide refcounted (gc state is process-global): with
    ``run_task(workers=N)`` two tasks' pause windows can overlap, and a
    saved-bool restore would re-enable the collector under the task
    still decoding. The last context out restores the original state.
    """
    global _gc_pause_depth, _gc_was_enabled
    with _gc_pause_lock:
        if _gc_pause_depth == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_pause_depth += 1
    try:
        yield
    finally:
        with _gc_pause_lock:
            _gc_pause_depth -= 1
            if _gc_pause_depth == 0 and _gc_was_enabled:
                gc.enable()


class FileByFileTask(RomiTask):
    """Maps ``f(input_file, output_fileset)`` over each upstream file
    matching `query`, copying file metadata to outputs
    (reference: Undistorted/Masks, tasks/proc2d.py)."""

    query = Parameter(default={})
    n_io_threads = Parameter(default=8, significant=False)
    #: optional extra dependency that must run first because it WRITES
    #: metadata onto the upstream files this task copies through (e.g.
    #: Colmap/TurntableCalibration exporting per-image 'colmap_camera' —
    #: the reference gets this ordering implicitly from luigi's DAG)
    upstream_pose = Parameter(default="")

    def requires(self):
        req = [self._upstream()]
        if self.upstream_pose:
            req.append(self.ctx.get_task(str(self.upstream_pose)))
        return req

    def f(self, fin, outfs):
        """Process one input File; return the output File (or None to skip)."""
        raise NotImplementedError

    def run(self):
        from concurrent.futures import ThreadPoolExecutor

        inp = self.input()
        if isinstance(inp, (list, tuple)):
            inp = inp[0]
        infs = inp.get(create=False)
        outfs = self.output().get()
        files = infs.get_files(query=self.query or None)
        logger.info(f"{self.get_task_family()}: processing {len(files)} files")

        def _one(fin):
            fout = self.f(fin, outfs)
            if fout is not None:
                md = fin.get_metadata()
                md.update(fout.get_metadata())  # keep anything f() set
                fout.set_metadata(md)

        # image decode/encode dominates; threads hide the codec latency
        # (device compute serializes on the accelerator regardless)
        with self.ctx.scan.deferred_store(), paused_gc():
            n = max(int(self.n_io_threads), 1)
            if n == 1 or len(files) < 4:
                for fin in files:
                    _one(fin)
            else:
                with ThreadPoolExecutor(max_workers=n) as ex:
                    list(ex.map(_one, files))


# -- marker / utility tasks ---------------------------------------------

class FilesetExists(BaseTask):
    """Asserts a fileset already exists (no run)."""

    fileset_id = None

    def output(self):
        return FilesetTarget(self.ctx.scan, self.fileset_id)

    def run(self):
        if not self.output().exists():
            raise FileNotFoundError(
                f"Required fileset '{self.fileset_id}' missing in scan "
                f"'{self.ctx.scan.id}'")

    def complete(self):
        return self.output().exists()


class ImagesFilesetExists(FilesetExists):
    fileset_id = "images"


class ModelFilesetExists(FilesetExists):
    """CNN model fileset; may live in a different scan (reference:
    tasks/proc2d.py:336 reads the model from a 'models' scan)."""

    fileset_id = "models"
    scan_id = Parameter(default="", significant=False)

    def output(self):
        scan = self.ctx.scan
        if self.scan_id:
            scan = self.ctx.db.get_scan(self.scan_id) or scan
        return FilesetTarget(scan, self.fileset_id)


class NamedFilesetExists(FilesetExists):
    """Marker for an arbitrary pre-existing fileset named by config
    (e.g. ground-truth mask filesets in evaluation pipelines)."""

    fileset_id = Parameter(default="images")

    def output(self):
        return FilesetTarget(self.ctx.scan, self.fileset_id)


class Segmentation2DGroundTruthFilesetExists(NamedFilesetExists):
    """Named marker for a pre-existing ground-truth segmentation fileset
    (reference romitask.task import at tasks/evaluation.py:34; default GT
    for Segmentation2DEvaluation, reference tasks/evaluation.py:382).
    The romitask submodule is empty upstream, so the default fileset id
    follows the task-name convention of the ground-truth tasks."""

    fileset_id = Parameter(default="Segmentation2DGroundTruth")


class DatasetExists(BaseTask):
    scan_id = Parameter(default="")

    def output(self):
        return None

    def complete(self):
        return self.ctx.db.get_scan(self.scan_id or self.ctx.scan.id) is not None

    def run(self):
        if not self.complete():
            raise FileNotFoundError(f"Dataset not found: {self.scan_id}")


class VirtualPlantObj(FilesetExists):
    """Located by prefix: virtual scans ship a 'VirtualPlant*' fileset with
    the ground-truth OBJ + angle metadata (reference testdata/virtual_plant)."""

    fileset_id = "VirtualPlant"

    def output(self):
        for fs_id in self.ctx.scan.list_filesets():
            if fs_id.startswith(self.fileset_id):
                return FilesetTarget(self.ctx.scan, fs_id)
        return FilesetTarget(self.ctx.scan, self.fileset_id)


class DummyTask(BaseTask):
    """Placeholder upstream (e.g. upstream_colmap='DummyTask' in
    geom_pipe_virtual.toml when poses come from exact metadata)."""

    def output(self):
        return None

    def complete(self):
        return True

    def run(self):
        pass


_PROTECTED_FILESETS = ("images", "models", "calibration")


class Clean(BaseTask):
    """Removes derived (task-output) filesets from the scan, keeping raw
    inputs (reference: Clean task, configs/geom_pipe_real.toml:77-78)."""

    no_confirm = Parameter(default=False)
    keep = Parameter(default=list(_PROTECTED_FILESETS))

    def output(self):
        return None

    def complete(self):
        return False

    def run(self):
        scan = self.ctx.scan
        victims = [fs_id for fs_id in scan.list_filesets()
                   if fs_id not in self.keep
                   and not fs_id.startswith("VirtualPlant")]
        if not victims:
            return
        if not self.no_confirm:
            from ..utils import yes_no_choice
            if not yes_no_choice(f"Delete filesets {victims} from scan '{scan.id}'?"):
                return
        for fs_id in victims:
            logger.info(f"Clean: deleting fileset {fs_id}")
            scan.delete_fileset(fs_id)
