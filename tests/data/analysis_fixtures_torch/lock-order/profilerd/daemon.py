"""Seeded violation: two threads acquire the same pair of locks in
opposite orders — a textbook deadlock the pass must flag statically."""

import threading


class Daemon:
    def __init__(self, agg):
        self._lock = threading.Lock()
        self.agg = agg

    def publish(self):
        with self._lock:  # Daemon._lock -> agg._lock
            with self.agg._lock:
                return dict(self.agg.rows)

    def push(self):
        with self.agg._lock:  # SEEDED: agg._lock -> Daemon._lock (inverted)
            with self._lock:
                return list(self.agg.rows)
