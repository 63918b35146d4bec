"""Sampling profiler backends (a copy of ``repro.core.sampler``): the host
plane the trainer and the server run for the whole job. Two backends,
selected by :attr:`SamplerConfig.backend` and built by :func:`make_sampler`:

* ``"thread"`` — :class:`StackSampler`, a dedicated in-process helper thread
  that every ``period`` seconds snapshots **every** Python thread's stack via
  ``sys._current_frames()``, resolves "symbols" from code objects, classifies
  each frame by origin (``repro``/``torch``/``numpy``/``py``; the port's own
  frames count as ``repro``, as the JAX package's do), merges each sample
  into a :class:`~repro_torch.core.calltree.CallTree` on the fly, records a
  ``(t, depth)`` timeline, and optionally samples ``/proc/self`` cpu/rss.

* ``"daemon"`` — :class:`repro_torch.profilerd.agent.DaemonBackend`: the
  target only publishes **raw, unresolved** frame records into an mmap ring
  spool; a separate process (``python -m repro_torch.profilerd``), which
  imports no torch, resolves, classifies, merges, runs the detectors and
  publishes status and reports.

Symbol resolution and origin-collapse (:func:`frame_symbol`,
:func:`collapse_stack`) are shared by both backends, so they produce
identical trees from identical frames.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass
from collections.abc import Sequence
from typing import Protocol, runtime_checkable

from .calltree import CallTree

# Default matches the paper (§V-E): 0.5 s balances detail vs overhead.
DEFAULT_PERIOD_S = 0.5

# Ceiling on the interned-ingest cache (one CallNode chain per unique
# (thread, stack)); pathological stack diversity degrades to the uncached
# path instead of growing target memory without bound.
PATH_CACHE_CAP = 1 << 16

# Environment seam (the JAX package's names, so one launcher drives either
# package): when set, jobs built through make_sampler publish to this spool
# for an external `python -m repro_torch.profilerd` to drain.
ENV_SPOOL = "REPRO_PROFILERD_SPOOL"
ENV_PERIOD = "REPRO_PROFILERD_PERIOD"
# Where the external daemon publishes this target's artifacts.
ENV_OUT = "REPRO_PROFILERD_OUT"


def classify_frame(filename: str) -> str:
    """Coarse symbol "origin" classification (paper: gem5 vs pybind vs libc)."""
    if "/repro/" in filename or "/repro_torch/" in filename or filename.endswith("repro"):
        return "repro"
    if "/torch/" in filename:
        return "torch"
    if "/numpy/" in filename:
        return "numpy"
    return "py"


def frame_symbol(frame) -> str:
    code = frame.f_code
    origin = classify_frame(code.co_filename)
    return f"{origin}::{code.co_name}"


# Threads whose names carry this prefix are profiler infrastructure (helper,
# watchdog, agent) and are excluded from every backend's capture. The prefix
# is deliberately narrower than the ``repro-`` convention: workload threads
# like ``repro-data-prefetch`` and ``repro-ckpt-writer`` are part of the
# program under observation and must stay visible in profiles.
PROFILER_THREAD_PREFIX = "repro-prof"


def is_profiler_thread(name: str) -> bool:
    return name.startswith(PROFILER_THREAD_PREFIX)


def open_psutil_process():
    """The optional /proc rusage handle both backends sample, or None."""
    try:
        import psutil

        return psutil.Process(os.getpid())
    except Exception:  # pragma: no cover - psutil is optional
        return None


def collapse_stack(symbols: Sequence[str], collapse_origins: Sequence[str]) -> list[str]:
    """Fold runs of frames from ``collapse_origins`` into one ``origin::*`` node
    (the paper's answer to "20 pybind frames bury the interesting ones")."""
    if not collapse_origins:
        return list(symbols)
    collapsed: list[str] = []
    for sym in symbols:
        origin = sym.split("::", 1)[0]
        if origin in collapse_origins:
            star = f"{origin}::*"
            if collapsed and collapsed[-1] == star:
                continue
            collapsed.append(star)
        else:
            collapsed.append(sym)
    return collapsed


@dataclass
class SamplerConfig:
    period_s: float = DEFAULT_PERIOD_S
    max_depth: int = 256
    # Collapse consecutive frames from these origins into one node.
    collapse_origins: tuple[str, ...] = ()
    record_timeline: bool = True
    record_rusage: bool = True
    # -- backend seam ------------------------------------------------------
    # "thread": in-process helper thread (StackSampler).
    # "daemon": raw-frame publisher + out-of-process repro_torch.profilerd.
    backend: str = "thread"
    # Daemon backend: spool file the agent publishes to (default: a temp path).
    spool_path: str | None = None
    spool_bytes: int = 4 << 20
    # Daemon backend: wire protocol the agent emits (2 = stack-interned
    # STACKDEF/SAMPLE2 records, 1 = per-frame SAMPLE records).
    wire_version: int = 2
    # Daemon backend: where the daemon publishes status/tree/report files
    # (default: "<spool_path>.d").
    daemon_out: str | None = None
    # None -> auto: spawn `python -m repro_torch.profilerd` iff no explicit
    # spool path was given (an explicit spool means an external daemon
    # attaches).
    spawn_daemon: bool | None = None
    # Daemon backend: regional aggregator URL — the spawned daemon pushes
    # every sealed epoch there (`attach --push`); node name defaults to the
    # short hostname.  Ignored when an external daemon drains the spool
    # (configure --push on that daemon instead).
    push_url: str | None = None
    push_node: str | None = None


@runtime_checkable
class SamplerBackend(Protocol):
    """What the train and serve loops and the watchdog require of a backend."""

    def start(self) -> "SamplerBackend": ...

    def stop(self) -> CallTree: ...

    def snapshot(self) -> CallTree: ...

    def sample_now(self) -> None: ...

    def depth_trace(self) -> list[tuple[float, int]]: ...


def make_sampler(config: SamplerConfig | None = None) -> SamplerBackend:
    """Construct the backend selected by ``config.backend``.

    The ``REPRO_PROFILERD_SPOOL`` environment variable overrides the choice to
    the daemon backend with an externally-managed daemon: a supervisor
    attaches one profilerd per process without the job's own config knowing.
    """
    config = config or SamplerConfig()
    env_spool = os.environ.pop(ENV_SPOOL, None)
    if env_spool:
        from dataclasses import replace

        # The override is consumed (popped), not just read: a spool belongs to
        # exactly one publisher, and grandchild processes inheriting the
        # variable would recreate the file out from under the daemon's mmap.
        # REPRO_PROFILERD_OUT is popped too, as the JAX package does, so a
        # trainer that reads it later finds it gone (ROADMAP Queue 3).
        period = config.period_s
        env_period = os.environ.pop(ENV_PERIOD, None)
        if env_period:
            try:
                period = float(env_period)
            except ValueError:
                pass
        env_out = os.environ.pop(ENV_OUT, None)
        config = replace(
            config, backend="daemon", spool_path=env_spool, spawn_daemon=False,
            period_s=period, daemon_out=env_out or config.daemon_out,
        )
    if config.backend == "thread":
        return StackSampler(config)
    if config.backend == "daemon":
        from repro_torch.profilerd.agent import DaemonBackend

        return DaemonBackend(config)
    raise ValueError(f"unknown sampler backend {config.backend!r} (expected 'thread' or 'daemon')")


@dataclass
class TimelinePoint:
    t: float
    depth: int
    thread: str


@dataclass
class RusagePoint:
    t: float
    cpu_s: float
    rss_bytes: int


class StackSampler:
    """The ``thread`` backend: sampling helper thread inside the target."""

    def __init__(self, config: SamplerConfig | None = None):
        self.config = config or SamplerConfig()
        self.tree = CallTree()
        # Interned-ingest cache: (thread_name, *stack) -> prebuilt CallNode
        # chain. A repeated stack costs one tuple hash plus an O(depth)
        # float-add loop instead of per-frame dict bumps in add_stack.
        self._path_cache: dict[tuple, list] = {}
        self.timeline: list[TimelinePoint] = []
        self.rusage: list[RusagePoint] = []
        self.n_samples = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0 = time.monotonic()
        self._psutil_proc = open_psutil_process() if self.config.record_rusage else None

    # -- capture -----------------------------------------------------------------

    def _stack_of(self, frame) -> list[str]:
        rev: list[str] = []
        depth = 0
        while frame is not None and depth < self.config.max_depth:
            rev.append(frame_symbol(frame))
            frame = frame.f_back
            depth += 1
        rev.reverse()  # root -> leaf
        return collapse_stack(rev, self.config.collapse_origins)

    def _capture(self) -> None:
        helper = self._thread.ident if self._thread is not None else None
        names = {t.ident: t.name for t in threading.enumerate()}
        now = time.monotonic() - self._t0
        frames = sys._current_frames()
        try:
            with self._lock:
                for ident, frame in frames.items():
                    # Profiler infrastructure lives "outside the cgroup": neither
                    # the helper itself nor watchdog/report threads are profiled.
                    # (A synchronous sample_now() caller *is* profiled — it is
                    # target code asking for a sample of itself.)
                    if ident == helper or is_profiler_thread(names.get(ident, "")):
                        continue
                    stack = self._stack_of(frame)
                    tname = names.get(ident, f"tid{ident}")
                    key = (tname, *stack)
                    chain = self._path_cache.get(key)
                    if chain is None:
                        chain = self.tree.path_nodes([f"thread::{tname}"] + stack)
                        if len(self._path_cache) < PATH_CACHE_CAP:
                            self._path_cache[key] = chain
                    CallTree.add_stack_nodes(chain)
                    if self.config.record_timeline:
                        self.timeline.append(TimelinePoint(now, len(stack), tname))
                self.n_samples += 1
                if self._psutil_proc is not None:
                    try:
                        cpu = self._psutil_proc.cpu_times()
                        rss = self._psutil_proc.memory_info().rss
                        self.rusage.append(RusagePoint(now, cpu.user + cpu.system, rss))
                    except Exception:
                        pass
        finally:
            # The snapshot holds this thread's own frame, whose locals hold the
            # snapshot: a cycle that would keep every sampled frame, and the
            # tensors in its locals, alive until the garbage collector runs
            # (device memory on the card).
            frames = frame = None

    def _run(self) -> None:
        while not self._stop.wait(self.config.period_s):
            try:
                self._capture()
            except Exception:
                # The profiler must never take down the run it observes.
                pass

    # -- lifecycle ------------------------------------------------------------------

    def start(self) -> "StackSampler":
        if self._thread is not None:
            raise RuntimeError("sampler already started")
        self._t0 = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="repro-prof-helper", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> CallTree:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._thread = None
        return self.snapshot()

    def __enter__(self) -> "StackSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- access -----------------------------------------------------------------------

    def snapshot(self) -> CallTree:
        """Thread-safe copy of the merged tree (detector windows use this)."""
        with self._lock:
            return self.tree.copy()

    def sample_now(self) -> None:
        """Force one synchronous sample (used by tests and the detector loop)."""
        self._capture()

    def depth_trace(self) -> list[tuple[float, int]]:
        with self._lock:
            return [(p.t, p.depth) for p in self.timeline]
