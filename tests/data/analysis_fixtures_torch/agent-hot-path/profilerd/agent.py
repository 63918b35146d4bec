"""Seeded violation: blocking + serializing calls inside Agent.tick."""

import json
import time


class Agent:
    def tick(self):
        frames = self._raw_stack()
        time.sleep(0.001)  # SEEDED: blocking call in the per-sample path
        return json.dumps(frames)  # SEEDED: per-sample serialization

    def _raw_stack(self):
        return []
