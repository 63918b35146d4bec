"""Seeded violation: module-scope numpy import in a numpy-optional module."""

import numpy as np  # SEEDED: must be behind the lazy _numpy() probe


def decode(buf):
    return np.frombuffer(buf, dtype="<u8")
