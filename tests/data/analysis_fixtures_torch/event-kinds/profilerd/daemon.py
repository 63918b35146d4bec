"""Seeded violation: emits an event kind the canonical table never heard of."""

import time


class Daemon:
    def __init__(self):
        self.events = []

    def publish(self):
        self.events.append({"kind": "KNOWN_KIND", "wall_time": time.time()})
        self.events.append(
            {"kind": "ROGUE_EVENT", "wall_time": time.time()}  # SEEDED: unregistered
        )
