"""Filesystem DB watcher (port of plant3dvision_tpu/runtime/watch.py, the
role of romitask.watch.FSDBWatcher, reference tests/unit/test_watch.py):
polls a DB for new scans and triggers a callback on each. Host only."""

from __future__ import annotations

import threading

from .log import configure_logger

logger = configure_logger(__name__)


class FSDBWatcher:
    def __init__(self, db, callback, poll_interval: float = 1.0):
        """callback(scan_id) is invoked once per newly appearing scan."""
        self.db = db
        self.callback = callback
        self.poll_interval = poll_interval
        self._seen = set(db.list_scans())
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            self.db._load_scans()
            current = set(self.db.list_scans())
            for new in sorted(current - self._seen):
                logger.info(f"FSDBWatcher: new scan {new}")
                try:
                    self.callback(new)
                except Exception as e:
                    logger.error(f"FSDBWatcher callback failed for {new}: {e}")
            self._seen = current
            self._stop.wait(self.poll_interval)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
