"""Filesystem database objects: FSDB -> Scan -> Fileset -> File.

Behavioral contract follows the reference's `plantdb.fsdb` as used throughout
the reference plant3dvision (e.g. tasks/colmap.py:24-28, cl.py:93-98):
`FSDB(path)`, `connect()/disconnect()`, `get_scan/create_scan`,
`Scan.get_fileset/create_fileset/get_metadata/set_metadata`,
`Fileset.get_file/create_file/get_files(query)/...`,
`File.filename/get_metadata/set_metadata`.

All payload IO goes through :mod:`plant3dvision_tpu_torch.fsdb.io`.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

MARKER_FILE = "romidb"
LOCK_FILE = "lock"


class DBError(Exception):
    pass


def _read_json(path: Path, default=None):
    if not Path(path).exists():
        return default
    with open(path) as f:
        return json.load(f)


def _write_json(path: Path, data) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        json.dump(data, f, indent=4, sort_keys=True, default=_json_default)
    os.replace(tmp, path)


def _json_default(o):
    try:
        import numpy as np
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, np.generic):
            return o.item()
    except ImportError:
        pass
    raise TypeError(f"Object of type {type(o)} is not JSON serializable")


class FSDB:
    """A database rooted at a directory containing a ``romidb`` marker file."""

    def __init__(self, path):
        self.path_ = Path(path)
        self.scans: dict[str, Scan] = {}
        self.connected = False

    def path(self) -> Path:
        return self.path_

    @property
    def basedir(self):
        return str(self.path_)

    def connect(self, login_data=None, unsafe=False):
        if not self.path_.is_dir():
            raise DBError(f"Not a directory: {self.path_}")
        if not (self.path_ / MARKER_FILE).exists():
            raise DBError(f"Not a DB (missing '{MARKER_FILE}' marker): {self.path_}")
        lock = self.path_ / LOCK_FILE
        if not unsafe:
            if lock.exists():
                raise DBError(f"DB is locked by another process: {lock}")
            lock.write_text(str(os.getpid()))
        self.connected = True
        self._load_scans()

    def disconnect(self):
        lock = self.path_ / LOCK_FILE
        if lock.exists():
            try:
                lock.unlink()
            except OSError:
                pass
        self.connected = False
        self.scans = {}

    def _load_scans(self):
        self.scans = {}
        for entry in sorted(self.path_.iterdir()):
            if entry.is_dir() and (entry / "files.json").exists():
                self.scans[entry.name] = Scan(self, entry.name)
            elif entry.is_dir() and entry.name not in (MARKER_FILE,):
                # Directory without manifest still counts as a scan slot if it
                # has an images dir (lazy import of foreign data).
                if (entry / "images").is_dir():
                    self.scans[entry.name] = Scan(self, entry.name)

    def refresh(self):
        """Re-scan the database directory (picks up scans copied in
        after connect, e.g. by fixtures.load_reference_scan)."""
        self._load_scans()

    def list_scans(self):
        return sorted(self.scans.keys())

    def get_scans(self):
        return [self.scans[k] for k in self.list_scans()]

    def get_scan(self, scan_id, create=False):
        if scan_id in self.scans:
            return self.scans[scan_id]
        if create:
            return self.create_scan(scan_id)
        return None

    def create_scan(self, scan_id):
        if scan_id in self.scans:
            raise DBError(f"Scan already exists: {scan_id}")
        path = self.path_ / scan_id
        path.mkdir(parents=True, exist_ok=True)
        scan = Scan(self, scan_id)
        scan.store()
        self.scans[scan_id] = scan
        return scan

    def delete_scan(self, scan_id):
        scan = self.scans.pop(scan_id, None)
        if scan is not None:
            from . import handoff
            handoff.invalidate(self.path(), scan_id)
            shutil.rmtree(scan.path(), ignore_errors=True)


class Scan:
    """One scan (dataset): a directory of filesets + metadata sidecars."""

    def __init__(self, db: FSDB, scan_id: str):
        self.db = db
        self.id = scan_id
        self.filesets: dict[str, Fileset] = {}
        # guards manifest/metadata read-modify-writes and fileset-dict
        # mutation vs store() iteration — parallel task workers
        # (runtime.runner run_task(workers=N)) share one Scan object
        self._lock = threading.RLock()
        self._defer_depth = 0
        self._load()

    def path(self) -> Path:
        return self.db.path() / self.id

    def _manifest_path(self) -> Path:
        return self.path() / "files.json"

    def _metadata_path(self) -> Path:
        return self.path() / "metadata" / "metadata.json"

    def _load(self):
        manifest = _read_json(self._manifest_path(), {"filesets": []})
        for fs_entry in manifest.get("filesets", []):
            fs = Fileset(self, fs_entry.get("id"))
            for f_entry in fs_entry.get("files", []):
                fs.files[f_entry["id"]] = File(fs, f_entry["id"], f_entry.get("file"))
            self.filesets[fs.id] = fs

    def deferred_store(self):
        """Context manager batching manifest writes: inside the block,
        store() is a no-op; one store happens on exit. Makes concurrent
        File.write_raw calls safe (used by FileByFileTask's thread pool).
        Reentrant — concurrent tasks (parallel workers) may each open a
        deferral; the store lands when the last one exits."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            with self._lock:
                self._defer_depth += 1
            try:
                yield self
            finally:
                with self._lock:
                    self._defer_depth -= 1
                self.store()

        return _ctx()

    def store(self):
        with self._lock:
            if self._defer_depth > 0:
                return
            manifest = {
                "filesets": [
                    {
                        "id": fs.id,
                        "files": [
                            {"id": f.id, "file": f.filename}
                            for f in fs.files.values()
                            if f.filename is not None
                        ],
                    }
                    for fs in self.filesets.values()
                ]
            }
            _write_json(self._manifest_path(), manifest)

    # -- metadata ------------------------------------------------------
    def get_metadata(self, key=None, default=None):
        md = _read_json(self._metadata_path(), {})
        if key is None:
            return md
        return md.get(key, default)

    def set_metadata(self, key, value=None):
        with self._lock:
            md = _read_json(self._metadata_path(), {})
            if isinstance(key, dict) and value is None:
                md.update(key)
            else:
                md[key] = value
            _write_json(self._metadata_path(), md)

    def get_measures(self, key=None):
        """Manual measurements shipped with the scan (measures.json) —
        plantdb API parity (reference tasks/evaluation.py:660-662)."""
        md = _read_json(self.path() / "measures.json", {})
        if key is None:
            return md
        return md.get(key, [])

    # -- filesets ------------------------------------------------------
    def list_filesets(self):
        return sorted(self.filesets.keys())

    def get_filesets(self):
        return [self.filesets[k] for k in self.list_filesets()]

    def get_fileset(self, fs_id, create=False):
        if fs_id in self.filesets:
            return self.filesets[fs_id]
        if create:
            return self.create_fileset(fs_id)
        return None

    def create_fileset(self, fs_id):
        with self._lock:
            if fs_id in self.filesets:
                raise DBError(f"Fileset already exists: {fs_id}")
            fs = Fileset(self, fs_id)
            fs.path().mkdir(parents=True, exist_ok=True)
            self.filesets[fs_id] = fs
            self.store()
            return fs

    def delete_fileset(self, fs_id):
        with self._lock:
            fs = self.filesets.pop(fs_id, None)
        if fs is None:
            return
        # cancel in-flight async artifact writes + drop device-cache entries
        # (a canceled task must not resurrect files into a deleted fileset)
        from . import handoff
        handoff.invalidate(self.db.path(), self.id, fs_id)
        shutil.rmtree(fs.path(), ignore_errors=True)
        md = fs._metadata_path()
        if md.exists():
            md.unlink()
        md_dir = self.path() / "metadata" / fs_id
        shutil.rmtree(md_dir, ignore_errors=True)
        self.store()


class Fileset:
    """A named set of files inside a scan."""

    def __init__(self, scan: Scan, fs_id: str):
        self.scan = scan
        self.id = fs_id
        self.files: dict[str, File] = {}

    @property
    def db(self):
        return self.scan.db

    def path(self) -> Path:
        return self.scan.path() / self.id

    def _metadata_path(self) -> Path:
        return self.scan.path() / "metadata" / f"{self.id}.json"

    # -- metadata ------------------------------------------------------
    def get_metadata(self, key=None, default=None):
        md = _read_json(self._metadata_path(), {})
        if key is None:
            return md
        return md.get(key, default)

    def set_metadata(self, key, value=None):
        with self.scan._lock:
            md = _read_json(self._metadata_path(), {})
            if isinstance(key, dict) and value is None:
                md.update(key)
            else:
                md[key] = value
            _write_json(self._metadata_path(), md)

    # -- files ---------------------------------------------------------
    def list_files(self):
        return sorted(self.files.keys())

    def get_files(self, query=None):
        files = [self.files[k] for k in self.list_files()]
        if query:
            files = [f for f in files if _match_query(f, query)]
        return files

    def get_file(self, file_id, create=False):
        if file_id in self.files:
            return self.files[file_id]
        if create:
            return self.create_file(file_id)
        return None

    def create_file(self, file_id):
        with self.scan._lock:
            f = File(self, file_id, None)
            self.files[file_id] = f
            return f

    def delete_file(self, file_id):
        with self.scan._lock:
            f = self.files.pop(file_id, None)
        if f is None:
            return
        if f.filename and (self.path() / f.filename).exists():
            (self.path() / f.filename).unlink()
        md = f._metadata_path()
        if md.exists():
            md.unlink()
        self.scan.store()


def _match_query(f: File, query: dict) -> bool:
    md = f.get_metadata()
    for k, v in query.items():
        if md.get(k) != v:
            return False
    return True


class File:
    """A single file with metadata sidecar. Payload IO lives in fsdb.io."""

    def __init__(self, fileset: Fileset, file_id: str, filename: str | None):
        self.fileset = fileset
        self.id = file_id
        self.filename = filename

    @property
    def scan(self):
        return self.fileset.scan

    @property
    def db(self):
        return self.fileset.scan.db

    def path(self) -> Path:
        if self.filename is None:
            # an async artifact write may still be in flight — completing
            # it sets self.filename (fsdb.handoff.wait_for -> write_raw)
            from . import handoff
            handoff.wait_for(self)
        if self.filename is None:
            raise DBError(f"File {self.id} has no data yet")
        return self.fileset.path() / self.filename

    def _metadata_path(self) -> Path:
        return self.scan.path() / "metadata" / self.fileset.id / f"{self.id}.json"

    # -- metadata ------------------------------------------------------
    def get_metadata(self, key=None, default=None):
        md = _read_json(self._metadata_path(), {})
        if key is None:
            return md
        return md.get(key, default)

    def set_metadata(self, key, value=None):
        with self.scan._lock:
            md = _read_json(self._metadata_path(), {})
            if isinstance(key, dict) and value is None:
                md.update(key)
            else:
                md[key] = value
            _write_json(self._metadata_path(), md)

    # -- payload -------------------------------------------------------
    def write_raw(self, data: bytes, ext: str):
        self.filename = f"{self.id}.{ext.lstrip('.')}"
        self.fileset.path().mkdir(parents=True, exist_ok=True)
        with open(self.path(), "wb") as f:
            f.write(data)
        self.scan.store()

    def read_raw(self) -> bytes:
        with open(self.path(), "rb") as f:
            return f.read()

    def import_file(self, src_path):
        """Copy an external file in as this file's payload (plantdb to_file inverse)."""
        src_path = Path(src_path)
        ext = src_path.suffix.lstrip(".")
        self.filename = f"{self.id}.{ext}" if ext else self.id
        self.fileset.path().mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src_path, self.path())
        self.scan.store()
