"""Seeded violation: blocking I/O while holding the publish lock."""

import json
import threading


class SharedProfileState:
    def __init__(self):
        self._lock = threading.Lock()
        self._status = {}

    def update(self, status, path):
        with self._lock:
            self._status = status
            with open(path, "w") as f:  # SEEDED: file I/O under the lock
                json.dump(status, f)  # SEEDED: serialization under the lock
