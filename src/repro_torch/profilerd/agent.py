"""Target-side shim: the only profilerd code that runs inside the target.

:class:`Agent` is a minimal publisher — on each tick it snapshots
``sys._current_frames()`` and writes *raw, unresolved* frame records
(filename, function, lineno, thread) into the spool.  No symbol resolution,
no origin classification, no tree merging: everything else happens in the
daemon process (:mod:`repro_torch.profilerd.daemon`), which is the paper's
non-intrusiveness contract — the target pays only for frame capture.

:class:`DaemonBackend` adapts the agent to the
:class:`~repro_torch.core.sampler.SamplerBackend` protocol so the train/serve
loops can swap it in for :class:`~repro_torch.core.sampler.StackSampler` via
``SamplerConfig(backend="daemon")``.  It optionally spawns the daemon as a
subprocess; with an explicit spool path it assumes an external
``python -m repro_torch.profilerd attach`` drains the spool instead.

A copy of ``repro.profilerd.agent``. On the card, the agent ticks from a
thread: a main thread that holds the GIL in one long C++ call (the profiler's
event processing, say) keeps it silent: past ``stall_timeout_s`` the daemon
reports ``TARGET_STALLED``, and ``TARGET_RESUMED`` when it ticks again. Autograd's device thread is unknown
to ``threading``, so its stacks are published under ``tid<ident>``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

from repro_torch.core.calltree import CallNode, CallTree
from repro_torch.core.sampler import SamplerConfig, is_profiler_thread, open_psutil_process

from .spool import SpoolWriter
from .wire import WIRE_VERSION, Encoder, RawFrame, RawSample, Rusage


class Agent:
    """Raw-frame publisher: ``sys._current_frames()`` -> codec -> spool.

    ``wire_version=2`` (the default) interns whole stacks: steady-state ticks
    cost a fixed-size ``SAMPLE2`` record per thread instead of 12 bytes per
    frame.  ``wire_version=1`` keeps the per-frame encoding for old
    consumers; either way the daemon's decoder handles both.
    """

    def __init__(
        self,
        spool_path: str,
        period_s: float = 0.5,
        max_depth: int = 256,
        spool_bytes: int = 4 << 20,
        record_rusage: bool = False,
        wire_version: int = WIRE_VERSION,
    ):
        self.spool_path = spool_path
        self.period_s = period_s
        self.max_depth = max_depth
        self.record_rusage = record_rusage
        self._writer = SpoolWriter(spool_path, spool_bytes)
        self._enc = Encoder(version=wire_version)
        # Encoder + SpoolWriter are single-writer; sample_now() may race the
        # helper thread's own tick, so ticks are serialized.
        self._tick_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0 = time.monotonic()
        self.n_ticks = 0
        self.n_stacks = 0  # stacks offered to the spool (dropped ones included)
        self.n_dropped_batches = 0
        self._psutil_proc = open_psutil_process() if record_rusage else None
        self._writer.write(self._enc.encode_hello(os.getpid(), period_s))

    # -- capture -----------------------------------------------------------

    def _raw_stack(self, frame) -> list[RawFrame]:
        rev: list[RawFrame] = []
        depth = 0
        while frame is not None and depth < self.max_depth:
            code = frame.f_code
            # f_lineno can be None when snapshotting a thread suspended
            # mid-bytecode (3.11+); the codec packs it as u32.
            rev.append(RawFrame(code.co_filename, code.co_name, frame.f_lineno or 0))
            frame = frame.f_back
            depth += 1
        rev.reverse()  # root -> leaf
        return rev

    def tick(self) -> int:
        """Capture one snapshot of every thread and publish it. Returns the
        number of stacks in the batch (0 if the batch was dropped)."""
        helper = self._thread.ident if self._thread is not None else None
        names = {t.ident: t.name for t in threading.enumerate()}
        now = time.monotonic() - self._t0
        frames = sys._current_frames()
        samples = []
        for ident, frame in frames.items():
            # Same exclusion rule as the thread backend: profiler
            # infrastructure (this publisher, watchdog threads) is invisible.
            if ident == helper or is_profiler_thread(names.get(ident, "")):
                continue
            samples.append(
                RawSample(now, ident, names.get(ident, f"tid{ident}"), self._raw_stack(frame))
            )
        # The snapshot holds this thread's own frame, whose locals hold the
        # snapshot: a cycle that would keep every sampled frame, and the
        # tensors in its locals, alive until the garbage collector runs.
        frames = frame = None
        rusage = None
        if self._psutil_proc is not None:
            try:
                cpu = self._psutil_proc.cpu_times()
                rusage = Rusage(now, cpu.user + cpu.system, self._psutil_proc.memory_info().rss)
            except Exception:
                rusage = None
        with self._tick_lock:
            payload, fresh = self._enc.encode_tick(samples, rusage)
            self.n_ticks += 1
            self.n_stacks += len(samples)
            if not self._writer.write(payload):
                self._enc.rollback(fresh)
                self.n_dropped_batches += 1
                return 0
        return len(samples)

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.tick()
            except Exception:
                # Never take down the target.
                pass

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Agent":
        if self._thread is not None:
            raise RuntimeError("agent already started")
        self._t0 = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="repro-profilerd-agent", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._tick_lock:
            self._writer.write_bye(self._enc.encode_bye(self.n_ticks))
            self._writer.close()


class DaemonBackend:
    """``SamplerBackend`` adapter: agent in-process, aggregation out-of-process.

    ``snapshot()``/``depth_trace()`` read the daemon's published artifacts
    (``tree.json`` / ``status.json`` under the out dir, written atomically),
    so the in-process watchdog keeps working unchanged — it just observes a
    tree that was built in another process.
    """

    def __init__(self, config: SamplerConfig | None = None):
        self.config = config or SamplerConfig(backend="daemon")
        explicit_spool = self.config.spool_path is not None
        if explicit_spool:
            self.spool_path = self.config.spool_path
        else:
            d = tempfile.mkdtemp(prefix="repro-profilerd-")
            self.spool_path = os.path.join(d, "target.spool")
        self.out_dir = self.config.daemon_out or f"{self.spool_path}.d"
        spawn = self.config.spawn_daemon
        self.spawn_daemon = (not explicit_spool) if spawn is None else spawn
        self.agent: Agent | None = None
        self._proc: subprocess.Popen | None = None
        self._stopped_tree: CallTree | None = None
        # The spawned daemon's exit code once stop() reaped it (None: still
        # running, or an external daemon).
        self.daemon_exit: int | None = None

    # -- published-artifact readers -----------------------------------------

    def _read_json(self, name: str):
        try:
            with open(os.path.join(self.out_dir, name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- SamplerBackend protocol --------------------------------------------

    def start(self) -> "DaemonBackend":
        if self.agent is not None:
            raise RuntimeError("sampler already started")
        self.agent = Agent(
            self.spool_path,
            period_s=self.config.period_s,
            max_depth=self.config.max_depth,
            spool_bytes=self.config.spool_bytes,
            record_rusage=self.config.record_rusage,
            wire_version=self.config.wire_version,
        )
        self.agent.start()
        if self.spawn_daemon:
            from .daemon import spawn_attached_daemon

            self._proc = spawn_attached_daemon(
                self.spool_path,
                self.out_dir,
                interval_s=max(self.config.period_s, 0.2),
                collapse_origins=self.config.collapse_origins,
                push=self.config.push_url,
                push_node=self.config.push_node,
            )
        return self

    def stop(self) -> CallTree:
        if self._stopped_tree is not None:
            return self._stopped_tree
        was_running = self.agent is not None
        if self.agent is not None:
            self.agent.stop()  # writes BYE: the daemon drains, publishes, exits
            self.agent = None
        if self._proc is not None:
            try:
                self.daemon_exit = self._proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self.daemon_exit = self._proc.wait()
            self._proc = None
        elif was_running and self._read_json("status.json") is not None:
            # An external daemon attached: wait (bounded) for it to see BYE
            # and publish its final tree, otherwise we would snapshot a stale
            # window.  No status.json means nobody ever attached — don't wait.
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                status = self._read_json("status.json")
                if status is None or status.get("done"):
                    break
                time.sleep(0.1)
        self._stopped_tree = self.snapshot()
        return self._stopped_tree

    def snapshot(self) -> CallTree:
        d = self._read_json("tree.json")
        if d is None:
            return CallTree()
        return CallTree(CallNode.from_dict(d))

    def sample_now(self) -> None:
        if self.agent is not None:
            self.agent.tick()

    def wait_ready(self, timeout_s: float = 15.0) -> bool:
        """Block until the daemon has published once (benchmarks use this to
        keep daemon start-up cost out of steady-state overhead numbers)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._read_json("status.json") is not None:
                return True
            time.sleep(0.05)
        return False

    def summary(self) -> dict:
        """What a CLI's run summary reports of the daemon, so that a daemon
        that failed to start or never finished shows there: its out dir, the
        spawned daemon's exit code (None for an external one), and what its
        last ``status.json`` reads (``published`` False when none appeared)."""
        status = self._read_json("status.json") or {}
        return {
            "out_dir": self.out_dir,
            "spawned": self.spawn_daemon,
            "exit_code": self.daemon_exit,
            "published": bool(status),
            "done": bool(status.get("done")),
            "n_stacks": int(status.get("n_stacks", 0)),
            "dropped_batches": int(status.get("dropped_batches", 0)),
        }

    def depth_trace(self) -> list[tuple[float, int]]:
        status = self._read_json("status.json") or {}
        return [(float(t), int(d)) for t, d in status.get("depth_timeline", [])]

    @property
    def n_samples(self) -> int:
        """Publisher ticks (mirrors StackSampler.n_samples for benchmarks)."""
        if self.agent is not None:
            return self.agent.n_ticks
        status = self._read_json("status.json") or {}
        return int(status.get("n_ticks", 0))

    def __enter__(self) -> "DaemonBackend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
