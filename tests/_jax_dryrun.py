"""The JAX package's dry-run module for the port's tests, imported safely:
``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices on its first
line, so it is imported once the backend is up (the device count no longer
moves) and the environment is put back after."""

from __future__ import annotations

import functools
import os


@functools.cache
def jax_dryrun():
    import jax

    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod
