"""Shared helpers for the port's benchmark harness (the counterpart of the
JAX package's ``benchmarks/common.py``). Imports no torch: the host-only
benchmarks use ``row`` too."""

from __future__ import annotations

import sys
import time
from collections.abc import Callable


def _sync() -> None:
    """Wait for the card where this process has used it (the counterpart of
    ``jax.block_until_ready``)."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn: Callable, *, warmup: int = 1, iters: int = 5) -> float:
    """Median wall time per call in microseconds, each call synchronised."""
    for _ in range(warmup):
        fn()
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


def row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"
