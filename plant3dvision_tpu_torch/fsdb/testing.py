"""Test fixtures for FSDB-based tests.

Role of the reference's `plantdb.testing.DBTestCase` (used at
the reference's tests/unit/test_task.py:7): hand tests a temporary,
disposable database, optionally cloned from template data.
"""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path

from .db import FSDB, MARKER_FILE


def make_temp_db(template: Path | None = None) -> FSDB:
    """Create a connected FSDB in a fresh temp dir (caller owns cleanup)."""
    tmp = Path(tempfile.mkdtemp(prefix="p3dtpu_db_"))
    if template is not None:
        shutil.rmtree(tmp)
        shutil.copytree(template, tmp)
    (tmp / MARKER_FILE).touch()
    db = FSDB(tmp)
    db.connect(unsafe=True)
    return db


def destroy_temp_db(db: FSDB):
    from . import handoff
    for scan_id in list(getattr(db, "scans", {})):
        handoff.invalidate(db.path(), scan_id)
    db.disconnect()
    shutil.rmtree(db.path(), ignore_errors=True)


class TemporaryDB:
    """Context manager wrapping make_temp_db/destroy_temp_db."""

    def __init__(self, template=None):
        self.template = template
        self.db = None

    def __enter__(self) -> FSDB:
        self.db = make_temp_db(self.template)
        return self.db

    def __exit__(self, *exc):
        destroy_temp_db(self.db)
        return False
