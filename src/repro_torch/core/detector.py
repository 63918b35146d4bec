"""Dominance-threshold anomaly detection (paper §V-D, Fig. 13): a copy of
``repro.core.detector``.

The paper's key insight: when a coherence protocol dead/livelocks, gem5 keeps
executing the *same* protocol actions, so the runtime breakdown degenerates —
one action's share exceeds a threshold (90 %) — and the profiler can flag it,
**checkpoint the simulation**, and warn, with no a-priori instrumentation.

The distributed-training analogues detected here with the same mechanism:

* **hang / collective deadlock** — a stuck all-reduce (dead peer) pins the
  host in one dispatch/wait frame for entire windows;
* **livelock / spin** — a retry loop (data pipeline refill, lock spin)
  dominates the window tree exactly like the paper's recycled mandatory-queue
  load (its ``load_hit`` signature);
* **straggler** — one host's window tree diverges from the fleet's merged
  tree (share-distance metric), the multi-pod extension of the mechanism;
* **input starvation** — the ``data::`` subtree share exceeds its budget.

Detection operates on *windowed deltas* (``CallTree.diff``) so long-running
jobs cannot dilute a fresh anomaly, and fires ordered callbacks: warn →
checkpoint → (optionally) abort/restart, mirroring the paper's
warn+checkpoint flow while integrating with the launcher's restart policy.
"""

from __future__ import annotations

import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from collections.abc import Callable, Mapping, Sequence

from .calltree import SAMPLES, CallTree


@dataclass
class Rule:
    """One dominance rule: if a node matching ``pattern`` holds more than
    ``threshold`` of the window's samples for ``consecutive`` windows, fire."""

    pattern: str = ""  # substring of the call-site path ("" matches any node)
    threshold: float = 0.90  # the paper's default
    consecutive: int = 1
    metric: str = SAMPLES
    self_only: bool = True
    kind: str = "LIVELOCK_SUSPECT"
    min_window_total: float = 4.0  # don't fire on nearly-empty windows


@dataclass
class AnomalyEvent:
    kind: str
    path: tuple[str, ...]
    share: float
    rule: Rule
    window_index: int
    wall_time: float = field(default_factory=time.time)

    def describe(self) -> str:
        return (
            f"[{self.kind}] {'/'.join(self.path)} holds {self.share:.1%} of window "
            f"{self.window_index} (threshold {self.rule.threshold:.0%})"
        )


class DominanceDetector:
    """Sliding-window dominance detector over sampled call-trees."""

    def __init__(
        self,
        rules: Sequence[Rule] | None = None,
        on_anomaly: Sequence[Callable[[AnomalyEvent], None]] | None = None,
    ):
        self.rules = list(rules) if rules else [Rule()]
        self.callbacks: list[Callable[[AnomalyEvent], None]] = list(on_anomaly or [])
        self.events: list[AnomalyEvent] = []
        # A verdict callback (warn/checkpoint/abort action) that raises must
        # not take down the observer loop feeding it — the detector is exactly
        # the component that has to survive a sick process.  Failures land
        # here and, when set, in ``on_callback_error(event, traceback_str)``.
        self.callback_failures: deque = deque(maxlen=32)
        self.on_callback_error: Callable[[AnomalyEvent, str], None] | None = None
        self._prev: CallTree | None = None
        self._streaks: dict[int, int] = {}
        self._window = 0

    def add_callback(self, fn: Callable[[AnomalyEvent], None]) -> None:
        self.callbacks.append(fn)

    def observe(self, snapshot: CallTree) -> list[AnomalyEvent]:
        """Feed one snapshot (cumulative tree); detector diffs internally."""
        window = snapshot.diff(self._prev) if self._prev is not None else snapshot.copy()
        self._prev = snapshot
        self._window += 1
        fired: list[AnomalyEvent] = []
        for i, rule in enumerate(self.rules):
            total = window.total(rule.metric)
            if total < rule.min_window_total:
                self._streaks[i] = 0
                continue
            shares = window.shares(rule.metric, self_only=rule.self_only)
            hit: tuple[tuple[str, ...], float] | None = None
            for path, share in shares.items():
                if share >= rule.threshold and (not rule.pattern or any(rule.pattern in p for p in path)):
                    if hit is None or share > hit[1]:
                        hit = (path, share)
            if hit is None:
                self._streaks[i] = 0
                continue
            self._streaks[i] = self._streaks.get(i, 0) + 1
            if self._streaks[i] >= rule.consecutive:
                ev = AnomalyEvent(rule.kind, hit[0], hit[1], rule, self._window)
                fired.append(ev)
                self.events.append(ev)
                for cb in self.callbacks:
                    try:
                        cb(ev)
                    except Exception:
                        tb = traceback.format_exc()
                        self.callback_failures.append((ev, tb))
                        if self.on_callback_error is not None:
                            try:
                                self.on_callback_error(ev, tb)
                            except Exception:
                                pass  # the error sink must never recurse
        return fired


LIVELOCK = "LIVELOCK"
DOMINANT = "DOMINANT"
SHARE_DRIFT = "SHARE_DRIFT"
LIVELOCK_CLEARED = "LIVELOCK_CLEARED"


def share_distance(a: Mapping[str, float], b: Mapping[str, float]) -> float:
    """Total-variation distance between two (already normalized) share vectors."""
    keys = set(a) | set(b)
    return 0.5 * sum(abs(a.get(k, 0.0) - b.get(k, 0.0)) for k in keys)


def flat_shares(tree: CallTree, metric: str = SAMPLES) -> dict[str, float]:
    """Flattened per-name share vector (sums over call-sites, normalized)."""
    from .report import name_shares  # lazy: report imports from this module too

    return name_shares(tree, metric, self_only=False)


def segment_phases(vectors: Sequence[Mapping[str, float]], boundary: float = 0.25) -> list[tuple[int, int]]:
    """Segment an epoch sequence into phases (paper: "pinpoint when it occurs").

    Consecutive epochs whose share vectors stay within ``boundary`` TV
    distance belong to one phase; a jump starts a new one.  Returns inclusive
    ``(start_epoch_index, end_epoch_index)`` pairs over the input sequence.
    """
    if not vectors:
        return []
    phases: list[tuple[int, int]] = []
    start = 0
    for i in range(1, len(vectors)):
        if share_distance(vectors[i], vectors[i - 1]) > boundary:
            phases.append((start, i - 1))
            start = i
    phases.append((start, len(vectors) - 1))
    return phases


@dataclass
class TrendRule:
    """Epoch-trend thresholds for :class:`TrendDetector`.

    The paper's dominance threshold alone cannot tell a livelock from a
    legitimately hot steady-state loop; the disambiguator is *progress*: a
    livelocked target repeats the identical actions, so its progress counter
    (by default the number of distinct call-sites ever sealed — a spinning
    target mints no new stacks) stops growing while the dominance holds.
    """

    threshold: float = 0.90  # dominance share (the paper's default)
    epochs: int = 3  # sustained dominant+stalled epochs before LIVELOCK
    progress_epsilon: float = 0.0  # growth <= eps counts as "no progress"
    drift_threshold: float = 0.35  # TV distance vs the trailing baseline
    baseline_window: int = 8  # trailing epochs forming the drift baseline
    min_baseline_epochs: int = 3
    metric: str = SAMPLES
    self_only: bool = True
    min_epoch_total: float = 4.0  # ignore nearly-empty epochs


@dataclass
class TrendVerdict:
    """One epoch-trend finding, stamped with the epoch where it began."""

    kind: str  # LIVELOCK | DOMINANT | SHARE_DRIFT | LIVELOCK_CLEARED
    path: tuple[str, ...]
    share: float  # dominant share, or TV distance for SHARE_DRIFT
    epoch: int
    began_epoch: int
    wall_time: float = field(default_factory=time.time)

    @property
    def latency_epochs(self) -> int:
        """Epochs between the condition's onset and this verdict firing —
        the detection latency the fault scoreboard grades."""
        return max(0, self.epoch - self.began_epoch)

    def describe(self) -> str:
        what = "/".join(self.path) if self.path else "<distribution>"
        return (
            f"[{self.kind}] {what} share={self.share:.1%} at epoch {self.epoch} "
            f"(began epoch {self.began_epoch})"
        )


class TrendDetector:
    """Trend analysis over sealed epoch windows (timeline-aware detection).

    Consumes one *window* tree (the epoch's activity delta, not the
    cumulative tree) plus a progress counter per epoch and reports:

    * ``DOMINANT``   — one call-site holds >= ``threshold`` of the window
      while progress still grows (a hot loop, not an anomaly by itself);
    * ``LIVELOCK``   — the same dominance **with zero progress growth** for
      ``epochs`` consecutive epochs, stamped with the epoch where the
      stalled-dominance run began;
    * ``SHARE_DRIFT``— the window's share distribution moved more than
      ``drift_threshold`` (TV distance) away from the trailing
      ``baseline_window``-epoch mean, stamped with the first drifting epoch.
    * ``LIVELOCK_CLEARED`` — a previously-reported LIVELOCK whose dominance
      broke or whose progress resumed; without this transition a cleared
      fault reads as permanently wedged, so recovery is first-class.

    Each distinct ``(kind, path, began_epoch)`` is reported once.
    """

    def __init__(self, rule: TrendRule | None = None):
        self.rule = rule if rule is not None else TrendRule()
        self.events: list[TrendVerdict] = []
        self._epoch = -1
        self._last_progress: float | None = None
        self._dom_path: tuple[str, ...] | None = None
        self._dom_began = 0
        self._stall_began: int | None = None
        self._drift_began: int | None = None
        self._livelock_active: tuple[tuple[str, ...], int] | None = None
        self._baseline: deque = deque(maxlen=max(1, self.rule.baseline_window))
        self._emitted: set[tuple[str, tuple[str, ...], int]] = set()

    # -- scoreboard accessors ------------------------------------------------

    @property
    def livelock_active(self) -> bool:
        return self._livelock_active is not None

    def detections(self, kind: str | None = None) -> list[TrendVerdict]:
        if kind is None:
            return list(self.events)
        return [v for v in self.events if v.kind == kind]

    def first_detection(self, kind: str) -> TrendVerdict | None:
        for v in self.events:
            if v.kind == kind:
                return v
        return None

    def detection_latency(self, kind: str) -> int | None:
        """Epochs from onset to first verdict of ``kind`` (None if never)."""
        v = self.first_detection(kind)
        return None if v is None else v.latency_epochs

    def _emit(self, out: list[TrendVerdict], kind: str, path: tuple[str, ...], share: float, began: int, wall_time: float) -> None:
        key = (kind, path, began)
        if key in self._emitted:
            return
        self._emitted.add(key)
        v = TrendVerdict(kind, path, share, self._epoch, began, wall_time)
        self.events.append(v)
        out.append(v)

    def observe_epoch(
        self,
        window: CallTree,
        progress: float = 0.0,
        epoch: int | None = None,
        wall_time: float | None = None,
    ) -> list[TrendVerdict]:
        rule = self.rule
        self._epoch = epoch if epoch is not None else self._epoch + 1
        wall = wall_time if wall_time is not None else time.time()
        out: list[TrendVerdict] = []

        # Progress stall tracking runs every epoch so a stall that predates
        # the dominance onset is stamped where it actually began.
        if self._last_progress is None or progress - self._last_progress > rule.progress_epsilon:
            self._stall_began = None
        elif self._stall_began is None:
            self._stall_began = self._epoch
        self._last_progress = progress

        total = window.total(rule.metric)
        if total < rule.min_epoch_total:
            self._dom_path = None
            return out

        # -- dominance / livelock -------------------------------------------
        shares = window.shares(rule.metric, self_only=rule.self_only)
        top: tuple[tuple[str, ...], float] | None = None
        for path, share in shares.items():
            if share >= rule.threshold and (top is None or share > top[1]):
                top = (path, share)
        # Recovery first: an active LIVELOCK clears the moment its dominance
        # breaks or progress resumes — stamped with the original onset epoch
        # so time-wedged = cleared.epoch - cleared.began_epoch.
        if self._livelock_active is not None:
            lpath, lbegan = self._livelock_active
            if self._stall_began is None or top is None or top[0] != lpath:
                self._emit(out, LIVELOCK_CLEARED, lpath, shares.get(lpath, 0.0), lbegan, wall)
                self._livelock_active = None
        if top is None:
            self._dom_path = None
        else:
            path, share = top
            if self._dom_path != path:
                self._dom_path = path
                self._dom_began = self._epoch
            if self._stall_began is not None:
                began = max(self._dom_began, self._stall_began)
                if self._epoch - began + 1 >= rule.epochs:
                    self._emit(out, LIVELOCK, path, share, began, wall)
                    self._livelock_active = (path, began)
                else:
                    self._emit(out, DOMINANT, path, share, self._dom_began, wall)
            else:
                self._emit(out, DOMINANT, path, share, self._dom_began, wall)

        # -- distribution drift vs trailing baseline ------------------------
        cur = flat_shares(window, rule.metric)
        if len(self._baseline) >= rule.min_baseline_epochs:
            base: dict[str, float] = {}
            for vec in self._baseline:
                for k, v in vec.items():
                    base[k] = base.get(k, 0.0) + v
            n = len(self._baseline)
            base = {k: v / n for k, v in base.items()}
            tv = share_distance(cur, base)
            if tv >= rule.drift_threshold:
                if self._drift_began is None:
                    self._drift_began = self._epoch
                self._emit(out, SHARE_DRIFT, (), tv, self._drift_began, wall)
            else:
                self._drift_began = None
        self._baseline.append(cur)
        return out


class StragglerDetector:
    """Multi-host extension: flag hosts whose window tree diverges from the
    fleet. Distance = total-variation distance between *self*-share vectors
    (flattened by frame name); a straggler burns its samples in a different
    place (e.g. a collective-wait frame) than its peers.

    Self shares, not inclusive: real stacks share a deep common prefix
    (interpreter bootstrap, the train loop), and inclusive counters would let
    that shared mass dilute any leaf-level divergence below threshold."""

    def __init__(self, threshold: float = 0.5, metric: str = SAMPLES):
        self.threshold = threshold
        self.metric = metric

    def _shares(self, tree: CallTree) -> dict[str, float]:
        flat: dict[str, float] = {}
        for _path, node in tree.root.walk():
            if node is tree.root:
                continue
            v = node.self_metrics.get(self.metric, 0.0)
            if v:
                flat[node.name] = flat.get(node.name, 0.0) + v
        total = sum(flat.values()) or 1.0
        return {k: v / total for k, v in flat.items()}

    def observe(self, host_trees: dict[str, CallTree]) -> list[tuple[str, float]]:
        if len(host_trees) < 2:
            return []
        merged = CallTree()
        for t in host_trees.values():
            merged.merge(t.copy())
        ref = self._shares(merged)
        out = []
        for host, tree in host_trees.items():
            mine = self._shares(tree)
            keys = set(ref) | set(mine)
            tv = 0.5 * sum(abs(mine.get(k, 0.0) - ref.get(k, 0.0)) for k in keys)
            if tv >= self.threshold:
                out.append((host, tv))
        return sorted(out, key=lambda kv: -kv[1])


class WatchdogLoop:
    """Glue: sampler -> detector at a fixed cadence, on its own thread.

    ``actions`` receive every event; a typical production wiring is
    ``[checkpoint_manager.save_emergency, launcher.report]`` — i.e. the
    paper's warn+checkpoint flow.
    """

    def __init__(self, sampler, detector: DominanceDetector, interval_s: float = 2.0):
        self.sampler = sampler
        self.detector = detector
        self.interval_s = interval_s
        # Observe-pass failures (sampler or detector internals) are recorded,
        # never fatal: the watchdog's one job is to keep observing a process
        # that is already misbehaving.  Callback failures are handled one
        # level down by :class:`DominanceDetector` itself.
        self.errors: deque = deque(maxlen=32)
        import threading

        self._stop = threading.Event()
        self._thread: object | None = None
        self._threading = threading

    def start(self) -> "WatchdogLoop":
        t = self._threading.Thread(target=self._run, name="repro-prof-watchdog", daemon=True)
        self._thread = t
        t.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.detector.observe(self.sampler.snapshot())
            except Exception:
                self.errors.append(traceback.format_exc())

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
