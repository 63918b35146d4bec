"""Named ranges for the device plane: the counterpart of ``jax.named_scope``.

The JAX package tags every module body with ``jax.named_scope``; XLA keeps
the tag in each HLO instruction's ``op_name``, and ``core/hlo_tree.py`` costs
the compiled step by that path. The port tags the same sites with the same
names through :func:`scope`, a ``torch.profiler.record_function`` range that
``core/device_tree.py`` reads back from a profile of one real step.

A range costs ~9 us an entry even with no profiler running, and the decode
paths make thousands of module calls a step, so :func:`scope` enters one only
while a profiler records (``torch.autograd.profiler._is_profiler_enabled``,
a module-level flag the profiler sets for every thread, the autograd
engine's device threads included). Otherwise it is a shared no-op context.

:func:`kernel_launch` marks one launch of a hand-written kernel: a ctypes or
Triton launch is no aten op, so the profiler sees no shapes and counts no
work for it. The range's name carries the launch counter's key and the work
the kernel does (the counts ``chip_smoke.py`` bounds it by); ``build_device_tree``
turns it into a leaf node ``kernel:<key>`` with those ``flops`` and
``bytes``, and the kernels the launch made as its device time.
"""

from __future__ import annotations

import re
from collections.abc import Callable
from contextlib import nullcontext

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

_NULL = nullcontext()


def recording() -> bool:
    """Whether a profiler records now (in any thread)."""
    return _autograd_profiler._is_profiler_enabled

KERNEL_PREFIX = "kernel:"
_KERNEL_RE = re.compile(r"^kernel:(?P<key>[\w.]+)\[flops=(?P<flops>[^,\]]+),bytes=(?P<bytes>[^\]]+)\]$")


def scope(name: str):
    """A ``record_function(name)`` range while a profiler records, else a no-op context."""
    return record_function(name) if recording() else _NULL


def kernel_launch(key: str, work: Callable[[], tuple[float, float]]):
    """Around one launch of the hand-written kernel counted as ``key`` in
    ``ops.launch_counts()``: while a profiler records, a range named for the
    key and ``work() -> (flops, bytes)``; else a no-op context (``work`` is
    not called)."""
    if not recording():
        return _NULL
    flops, nbytes = work()
    return record_function(f"{KERNEL_PREFIX}{key}[flops={float(flops)!r},bytes={float(nbytes)!r}]")


def parse_kernel_launch(name: str) -> tuple[str, float, float] | None:
    """A :func:`kernel_launch` range's name -> (key, flops, bytes); None for any other name."""
    m = _KERNEL_RE.match(name)
    if m is None:
        return None
    return m.group("key"), float(m.group("flops")), float(m.group("bytes"))
