"""Multi-source ingest plane: one daemon draining a fleet of spools.

The paper's design point is a *single* external profiler observing the whole
simulated system; this module is the fan-in that makes one daemon process
scale to N targets.  Two pieces:

* :class:`SpoolSource` — everything one attached target owns: an
  :class:`~repro_torch.profilerd.pipeline.IngestPipeline` (reader -> decoder ->
  ingestor -> sealer, vectorized when numpy is available, so dispatch
  between sources happens per *chunk*, never per sample), per-target
  dominance/trend detectors, an optional per-target timeline ring, stall
  bookkeeping, and crash-and-restart re-attach (a restarted writer recreates
  the spool file; the old mmap is drained dry, then the reader/decoder and
  every ``stack_id``-keyed cache are rebuilt against the new incarnation).
* :class:`SpoolSet`  — attach/discovery plus fair draining: explicit paths
  attach as they appear, a ``--watch`` directory is rescanned every drain
  pass so spools created *after* the daemon started are picked up within one
  drain interval, and :meth:`SpoolSet.drain_all` cycles the sources
  round-robin in bounded (1 MiB) chunks so one backlogged target cannot
  starve the others.

The daemon (:mod:`repro_torch.profilerd.daemon`) composes these into per-target
trees plus a continuously merged fleet tree, publishes both to the query
plane, and epoch-seals per-target rings merged at seal time.
"""

from __future__ import annotations

import fnmatch
import os
import random
import time
from collections import deque
from collections.abc import Callable, Sequence

from repro_torch.core.calltree import CallTree
from repro_torch.core.detector import DominanceDetector, Rule, TrendDetector, TrendRule
from repro_torch.core.snapshot import EpochMeta, TimelineWriter

from .pipeline import IngestPipeline
from .spool import SpoolError, SpoolReader
from .wire import Bye, Hello, Rusage

STALLED = "TARGET_STALLED"
RESUMED = "TARGET_RESUMED"


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def source_name_for(path: str) -> str:
    """Default target name: the spool's basename minus its extension."""
    base = os.path.basename(path)
    if base.endswith(".spool"):
        base = base[: -len(".spool")]
    return base or "target"


class SpoolSource:
    """One attached target: reader -> decoder -> resolver -> ingestor -> tree."""

    def __init__(
        self,
        name: str,
        path: str,
        *,
        reader: SpoolReader | None = None,
        collapse_origins: Sequence[str] = (),
        rules: Sequence[Rule] | None = None,
        trend_rule: TrendRule | None = None,
        timeline_dir: str | None = None,
        epochs_per_segment: int = 16,
        max_segments: int = 64,
        timeline_cap: int = 2048,
    ):
        self.name = name
        self.path = path
        self.detector = DominanceDetector(list(rules) if rules else [Rule()])
        self.timeline_writer: TimelineWriter | None = None
        self.trend: TrendDetector | None = None
        if timeline_dir is not None:
            self.timeline_writer = TimelineWriter(
                timeline_dir,
                epochs_per_segment=epochs_per_segment,
                max_segments=max_segments,
            )
            self.trend = TrendDetector(trend_rule)
        # The whole decode -> accumulate -> seal path lives in the pipeline;
        # the source owns target policy (stall/re-attach/detectors/status).
        self.pipeline = IngestPipeline(
            reader if reader is not None else SpoolReader(path),
            collapse_origins=collapse_origins,
            timeline_writer=self.timeline_writer,
            depth_timeline=deque(maxlen=timeline_cap),  # (t, depth)
        )
        self.tree = self.pipeline.tree
        self.rusage: deque = deque(maxlen=timeline_cap)
        self.target_pid = self.reader.writer_pid
        self.period_s = 0.0
        self.wire_version = 0  # from HELLO; 0 until the target announced
        self.n_stacks = 0
        self.n_ticks_reported = 0
        self.bye_seen = False
        self.stalled = False
        self.resumed_pending = False  # stalled->live edge awaiting an event
        self.restarts = 0
        self.drained_bytes = 0
        self.backlog_bytes = 0
        self.samples_since_publish = 0
        # The last published immutable tree copy (query-plane handoff).
        self.last_snapshot: CallTree | None = None
        self.attached_wall = time.monotonic()
        self._last_sample_wall: float | None = None
        # Re-attach carries this across reader incarnations (decoder loss
        # counters carry inside the pipeline).
        self._dropped_base = 0

    # -- pipeline views ------------------------------------------------------

    @property
    def reader(self) -> SpoolReader | None:
        return self.pipeline.reader

    @reader.setter
    def reader(self, value: SpoolReader | None) -> None:
        self.pipeline.reader = value

    @property
    def decoder(self):
        return self.pipeline.decoder

    @property
    def resolver(self):
        return self.pipeline.resolver

    @property
    def ingestor(self):
        return self.pipeline.ingestor

    @property
    def sealer(self):
        return self.pipeline.sealer

    @property
    def timeline(self) -> deque:
        return self.pipeline.depth_timeline

    # -- aggregate counters --------------------------------------------------

    @property
    def alive(self) -> bool:
        return _pid_alive(self.target_pid)

    @property
    def dropped_batches(self) -> int:
        if self.reader is None:  # closed: the base holds the final count
            return self._dropped_base
        return self._dropped_base + self.reader.dropped

    @property
    def unknown_stack_refs(self) -> int:
        return self.pipeline.unknown_stack_refs

    @property
    def degraded_stackdefs(self) -> int:
        return self.pipeline.degraded_stackdefs

    # -- ingest --------------------------------------------------------------

    def _apply(self, ev) -> None:
        """Target policy for the pipeline's non-sample events."""
        if isinstance(ev, Hello):
            self.target_pid = ev.pid
            self.period_s = ev.period_s
            self.wire_version = ev.version
        elif isinstance(ev, Rusage):
            self.rusage.append((ev.t, ev.cpu_s, ev.rss_bytes))
        elif isinstance(ev, Bye):
            self.bye_seen = True
            self.n_ticks_reported += ev.n_ticks

    def drain_chunk(self) -> int:
        """One bounded read (1 MiB cap) decoded and ingested; returns bytes.

        The cap is the fairness unit: :meth:`SpoolSet.drain_all` interleaves
        chunks across sources, so a minutes-deep backlog on one target
        streams through without starving the rest.
        """
        before = self.pipeline.samples
        nbytes, events = self.pipeline.drain_chunk()
        fresh = self.pipeline.samples - before
        if fresh:
            self.n_stacks += fresh
            self.samples_since_publish += fresh
            self._last_sample_wall = time.monotonic()
            if self.stalled:
                self.resumed_pending = True  # recovery is an event, not silence
            self.stalled = False
        for ev in events:
            self._apply(ev)
        if nbytes:
            self.drained_bytes += nbytes
        self.backlog_bytes = self.reader.backlog
        # The writer sets the header flag even when the BYE *record* was
        # dropped on a full spool; honor it so a cleanly stopped target is
        # never mistaken for a stalled one.
        if self.reader.bye_seen:
            self.bye_seen = True
        return nbytes

    def maybe_reattach(self) -> bool:
        """Re-attach to a recreated spool (writer crash-and-restart).

        The old incarnation's mmap outlives the rename, so it is drained dry
        first — nothing the dead writer committed is lost.  Then the reader
        and decoder are rebuilt and every ``stack_id``-keyed cache is reset
        (a restarted writer re-assigns ids from 0 for different stacks), the
        pid/stall/bye state flips back to live, and counters carry over.  A
        half-created replacement (``SpoolError``) is retried next pass.
        """
        if not self.reader.replaced():
            return False
        try:
            fresh = SpoolReader(self.path)
        except SpoolError:
            return False
        while self.drain_chunk():
            pass
        self._dropped_base += self.reader.dropped
        self.reader.close()
        self.reader = fresh
        self.pipeline.reset_stream()
        self.target_pid = fresh.writer_pid
        self.period_s = 0.0  # until the new HELLO arrives
        self.bye_seen = False  # a stale bye=1 belongs to the dead incarnation
        self.stalled = False
        self.backlog_bytes = fresh.backlog
        self._last_sample_wall = time.monotonic()
        self.restarts += 1
        return True

    # -- analysis ------------------------------------------------------------

    def check_stall(self, stall_timeout_s: float) -> dict | None:
        """Silence from a live target beyond the timeout -> a STALLED event."""
        if self.bye_seen or self.stalled:
            return None
        ref = self._last_sample_wall
        if ref is None:
            ref = self.attached_wall  # attached but never saw a sample
        silent = time.monotonic() - ref
        # A slow-ticking but healthy target must not look stalled: silence is
        # only suspicious once it clearly exceeds the publisher's own period.
        timeout = max(stall_timeout_s, 3.0 * self.period_s)
        if silent >= timeout and _pid_alive(self.target_pid):
            self.stalled = True
            return {
                "kind": STALLED,
                "detector": "stall",
                "target": self.name,
                "path": [],
                "share": 1.0,
                "silent_s": round(silent, 3),
                "pid": self.target_pid,
                "wall_time": time.time(),
            }
        return None

    def publish_window(self) -> CallTree | None:
        """Snapshot + run the dominance detector if samples arrived; returns
        the new immutable tree copy (None on a quiet window)."""
        if not self.samples_since_publish:
            return None
        snap = self.tree.copy()
        self.last_snapshot = snap
        self.detector.observe(snap)
        self.samples_since_publish = 0
        return snap

    def seal_epoch(self, wall_time: float) -> tuple[EpochMeta | None, list]:
        """Seal this target's epoch into its ring; returns (meta, verdicts)."""
        meta, entries = self.pipeline.seal_epoch(wall_time)
        if meta is None:
            return None, []
        verdicts: list = []
        if self.trend is not None:
            # The trend window: rebuilt from the epoch's (chain, count) pairs —
            # untracked mutations (v1 samples) are invisible here, which only
            # softens detection for legacy spools, never ring correctness.
            window = CallTree()
            for e in entries:
                if e[3] > 0:
                    window.add_stack([n.name for n in e[0][1:]], {"samples": float(e[3])})
            verdicts = self.trend.observe_epoch(
                window, progress=meta.progress, epoch=meta.epoch, wall_time=meta.wall_time
            )
        return meta, verdicts

    def status_row(self) -> dict:
        return {
            "path": self.path,
            "pid": self.target_pid,
            "alive": self.alive,
            "stalled": self.stalled,
            "done": self.bye_seen,
            "period_s": self.period_s,
            "wire_version": self.wire_version,
            "n_stacks": self.n_stacks,
            "n_ticks": self.n_ticks_reported,
            "dropped_batches": self.dropped_batches,
            "backlog_bytes": self.backlog_bytes,
            "drained_bytes": self.drained_bytes,
            "restarts": self.restarts,
            "unknown_stack_refs": self.unknown_stack_refs,
            "degraded_stackdefs": self.degraded_stackdefs,
            "ingest": self.ingest_stats(),
        }

    def ingest_stats(self) -> dict:
        """The unified ``ingest_stats`` dict for this target (schema in
        :mod:`repro_torch.profilerd.pipeline`)."""
        return self.pipeline.ingest_stats()

    def close(self) -> None:
        if self.timeline_writer is not None:
            self.timeline_writer.close()
        if self.reader is not None:
            # Fold the reader-backed counters into the source so status()
            # keeps working after the mmap is gone.
            self._dropped_base += self.reader.dropped
            if self.reader.bye_seen:
                self.bye_seen = True
            self.reader.close()
            self.reader = None


class SpoolSet:
    """Attach and drain N spools: explicit paths plus ``--watch`` discovery.

    ``make_source(name, path)`` is the daemon's factory — it builds the
    :class:`SpoolSource` (per-target timeline dir, detector wiring, events)
    and returns None on a transient attach failure, which keeps the path
    pending for the next pass.
    """

    def __init__(
        self,
        *,
        paths: Sequence[str] = (),
        watch_dir: str | None = None,
        watch_glob: str = "*.spool",
        make_source: Callable[[str, str], SpoolSource | None],
        attach_retry_base_s: float = 0.5,
        attach_retry_cap_s: float = 30.0,
        attach_max_attempts: int = 8,
    ):
        self.sources: dict[str, SpoolSource] = {}  # insertion order = rotation
        self.watch_dir = watch_dir
        self.watch_glob = watch_glob
        self._make = make_source
        self._pending: dict[str, None] = dict.fromkeys(paths)
        self._attached_paths: set[str] = set()
        # Attach failures back off exponentially (with jitter, so a fleet of
        # daemons never stampedes a shared filesystem in lockstep) instead of
        # retrying every drain pass; after the budget the path is parked as
        # given-up — visible, terminal, and only revived if the file changes.
        self.attach_retry_base_s = attach_retry_base_s
        self.attach_retry_cap_s = attach_retry_cap_s
        self.attach_max_attempts = attach_max_attempts
        # path -> {"attempts": int, "next_t": monotonic, "fingerprint": (sz, mtime_ns)}
        self._backoff: dict[str, dict] = {}
        self._given_up: dict[str, dict] = {}
        self.gave_up_now: list[str] = []  # drained by the daemon per pass

    @staticmethod
    def _fingerprint(path: str) -> tuple[int, int] | None:
        try:
            st = os.stat(path)
        except OSError:
            return None
        return (st.st_size, st.st_mtime_ns)

    def _note_attach_failure(self, path: str) -> None:
        state = self._backoff.setdefault(
            path, {"attempts": 0, "next_t": 0.0, "fingerprint": None}
        )
        state["attempts"] += 1
        state["fingerprint"] = self._fingerprint(path)
        if state["attempts"] >= self.attach_max_attempts:
            self._given_up[path] = self._backoff.pop(path)
            self.gave_up_now.append(path)
            return
        delay = min(
            self.attach_retry_cap_s,
            self.attach_retry_base_s * (2.0 ** (state["attempts"] - 1)),
        )
        state["next_t"] = time.monotonic() + delay * random.uniform(0.8, 1.2)

    def _attach_allowed(self, path: str) -> bool:
        gave = self._given_up.get(path)
        if gave is not None:
            # A rewritten file is a new incarnation: one fresh budget.
            if self._fingerprint(path) != gave["fingerprint"]:
                del self._given_up[path]
                self._backoff.pop(path, None)
                return True
            return False
        state = self._backoff.get(path)
        return state is None or time.monotonic() >= state["next_t"]

    def attach_failure_rows(self) -> list[dict]:
        """Backoff/give-up state for status(), ``/targets`` and ``top``."""
        now = time.monotonic()
        rows = []
        for path, state in self._backoff.items():
            rows.append(
                {
                    "path": path,
                    "attempts": state["attempts"],
                    "gave_up": False,
                    "retry_in_s": round(max(0.0, state["next_t"] - now), 3),
                }
            )
        for path, state in self._given_up.items():
            rows.append({"path": path, "attempts": state["attempts"], "gave_up": True})
        return rows

    def name_for(self, path: str) -> str:
        name = source_name_for(path)
        if name in self.sources:
            i = 2
            while f"{name}-{i}" in self.sources:
                i += 1
            name = f"{name}-{i}"
        return name

    def adopt(self, source: SpoolSource) -> SpoolSource:
        """Register an externally-constructed source (solo blocking attach)."""
        self.sources[source.name] = source
        self._attached_paths.add(source.path)
        self._pending.pop(source.path, None)
        return source

    @property
    def all_explicit_attached(self) -> bool:
        return not self._pending

    def abandon_pending(self) -> list[str]:
        """Give up on explicit paths that never attached; returns them.

        The daemon calls this once the attach window closes, so a typo'd or
        never-created ``--targets`` path cannot keep the run from exiting
        after every real target finished."""
        gone = list(self._pending)
        self._pending.clear()
        return gone

    def discover(self) -> list[SpoolSource]:
        """One attach pass: pending explicit paths + new watch-dir spools."""
        candidates = list(self._pending)
        if self.watch_dir is not None:
            try:
                entries = sorted(os.listdir(self.watch_dir))
            except OSError:
                entries = []
            for e in entries:
                if fnmatch.fnmatch(e, self.watch_glob):
                    p = os.path.join(self.watch_dir, e)
                    if p not in self._attached_paths and p not in self._pending:
                        candidates.append(p)
        fresh: list[SpoolSource] = []
        for p in candidates:
            if p in self._attached_paths or not os.path.exists(p):
                continue
            if not self._attach_allowed(p):
                continue  # backing off, or given up on this incarnation
            src = self._make(self.name_for(p), p)
            if src is None:
                self._note_attach_failure(p)
                continue  # half-created / unreadable; retried with backoff
            self._backoff.pop(p, None)
            self._given_up.pop(p, None)
            fresh.append(self.adopt(src))
        return fresh

    def drain_all(self) -> int:
        """Drain every source dry, round-robin in bounded chunks.

        Each rotation reads at most one capped chunk per source; sources that
        returned bytes stay in the rotation, so all backlogs shrink together
        instead of head-of-line blocking on the deepest one.
        """
        total = 0
        busy = list(self.sources.values())
        while busy:
            still = []
            for s in busy:
                n = s.drain_chunk()
                total += n
                if n:
                    still.append(s)
            busy = still
        return total
