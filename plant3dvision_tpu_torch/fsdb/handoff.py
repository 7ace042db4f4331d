"""Device-resident task handoff and asynchronous artifact writes.

Two cooperating mechanisms that remove the biggest serial costs of the
multi-task pipelines (a multi-hundred-MB volume NPZ costs seconds to
pull + deflate + inflate + re-upload between two adjacent tasks):

1. **Device cache** (`cache_put`/`cache_get`): a producer task that has
   its output resident on the accelerator registers the device arrays
   under its output *File*; the in-process consumer task gets them back
   and skips the disk read + host->device upload entirely. The cache
   holds exactly what the consumer would have read from the artifact
   (same dtypes/values), so hit and miss paths are bit-identical.

2. **Async artifact writes** (`submit_write`/`flush`): the expensive
   bytes production (device->host pull, compression) runs on a
   background thread while downstream tasks compute; the actual fsdb
   mutation (``File.write_raw``) happens on the MAIN thread at flush
   time, so the single-threaded fsdb manifest stays race-free. The
   runner flushes all pending writes before a pipeline invocation
   returns, and every fsdb read path waits on a pending write for the
   file it is about to read (see ``wait_for``), so on-disk artifacts
   are never observed half-written.

Crash-safety is unchanged: an unflushed file has ``filename None`` and
is therefore absent from the scan manifest — a process killed before
flush leaves the producer's fileset empty-on-reload, which the runner's
completeness rule (fileset non-empty AND finalize marker) already
treats as "recompute".

Deleting a fileset (Clean, failure cleanup) cancels its pending writes
and drops its cache entries, so a canceled task cannot resurrect files
into a deleted fileset.

Disable everything with ``P3D_HANDOFF=off`` (both helpers then act as
no-ops and producers fall back to synchronous writes).

The reference has no equivalent (each task round-trips through disk,
reference plantdb.io + tasks/proc3d.py:66-136); this subsystem is what
makes the fused ML route's volume handoff effectively free.
"""

from __future__ import annotations

import logging
import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

logger = logging.getLogger(__name__)

_LOCK = threading.RLock()
_CACHE: OrderedDict = OrderedDict()      # key -> payload (opaque)
_PENDING: dict = {}                      # key -> (File, Future[(bytes, ext)])
_WRITING: dict = {}                      # key -> Event (write in progress)
_EXECUTOR: ThreadPoolExecutor | None = None
_MAX_CACHE_ENTRIES = 4


def enabled() -> bool:
    return os.environ.get("P3D_HANDOFF", "on").lower() not in ("off", "0", "false")


def _key(file) -> tuple:
    return (str(file.db.path()), file.scan.id, file.fileset.id, file.id)


def _executor() -> ThreadPoolExecutor:
    global _EXECUTOR
    if _EXECUTOR is None:
        _EXECUTOR = ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix="p3d-artifact")
    return _EXECUTOR


# -- device cache ---------------------------------------------------------

def cache_put(file, payload) -> None:
    """Register `payload` (e.g. {label: device array}) as the in-memory
    equivalent of `file`'s artifact. LRU-bounded."""
    if not enabled():
        return
    with _LOCK:
        k = _key(file)
        _CACHE.pop(k, None)
        _CACHE[k] = payload
        while len(_CACHE) > _MAX_CACHE_ENTRIES:
            _CACHE.popitem(last=False)


def cache_get(file):
    """Return the cached payload for `file`, or None."""
    if not enabled():
        return None
    with _LOCK:
        k = _key(file)
        payload = _CACHE.get(k)
        if payload is not None:
            _CACHE.move_to_end(k)
        return payload


# -- async writes ---------------------------------------------------------

def submit_write(file, producer) -> None:
    """Schedule `producer() -> (bytes, ext)` on the writer thread; the
    resulting bytes are written to `file` (main thread) at flush time.
    With handoff disabled, runs synchronously."""
    if not enabled():
        data, ext = producer()
        file.write_raw(data, ext)
        return
    if file.filename is not None:
        # overwriting an existing payload asynchronously would let readers
        # observe the stale bytes (File.path() only waits while filename is
        # unset) — keep that case synchronous
        data, ext = producer()
        file.write_raw(data, ext)
        return
    with _LOCK:
        k = _key(file)
        if k in _PENDING:
            raise RuntimeError(f"write already pending for {k}")
        fut = _executor().submit(producer)
        _PENDING[k] = (file, fut)


def wait_for(file) -> None:
    """If `file` has a pending write, complete it now. Called by the fsdb
    read paths so readers never see a missing or half-written artifact;
    a concurrent second reader blocks until the first finishes the write."""
    k = _key(file)
    with _LOCK:
        entry = _PENDING.pop(k, None)
        if entry is None:
            ev = _WRITING.get(k)
        else:
            ev = _WRITING[k] = threading.Event()
    if entry is None:
        if ev is not None:
            ev.wait()
        return
    f, fut = entry
    try:
        data, ext = fut.result()
        f.write_raw(data, ext)
    finally:
        ev.set()
        with _LOCK:
            _WRITING.pop(k, None)


def flush() -> int:
    """Complete every pending write (main thread). Returns the number of
    files written. Raises the first producer error after attempting all."""
    with _LOCK:
        entries = list(_PENDING.items())
        _PENDING.clear()
    first_err = None
    n = 0
    for _, (f, fut) in entries:
        try:
            data, ext = fut.result()
            f.write_raw(data, ext)
            n += 1
        except Exception as e:       # keep flushing the rest
            logger.error(f"async artifact write failed for {f.id}: {e}")
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err
    return n


def pending_count() -> int:
    with _LOCK:
        return len(_PENDING)


# -- invalidation (wired into fsdb.db fileset/scan deletion) ---------------

def invalidate(db_path, scan_id, fileset_id=None) -> None:
    """Drop cache entries and cancel pending writes for a fileset (or a
    whole scan when fileset_id is None)."""
    db_path = str(db_path)

    def _match(k):
        return (k[0] == db_path and k[1] == scan_id
                and (fileset_id is None or k[2] == fileset_id))

    with _LOCK:
        for k in [k for k in _CACHE if _match(k)]:
            del _CACHE[k]
        for k in [k for k in _PENDING if _match(k)]:
            _, fut = _PENDING.pop(k)
            fut.cancel()   # no-op if already running; result is discarded


def reset() -> None:
    """Drop all state (tests)."""
    with _LOCK:
        _CACHE.clear()
        for _, fut in _PENDING.values():
            fut.cancel()
        _PENDING.clear()
