"""Dominance-threshold anomaly detection (a copy of the parts of
``repro.core.detector`` the trainer uses: ``Rule``, ``AnomalyEvent``,
``DominanceDetector``, ``WatchdogLoop``).

When a job hangs, livelocks or starves, the host keeps executing the *same*
frames, so the runtime breakdown degenerates: one call-site's share exceeds a
threshold (the paper's 90 %), and the watchdog flags it, checkpoints and
warns, with no instrumentation of the step. Detection operates on windowed
deltas (``CallTree.diff``), so a long run cannot dilute a fresh anomaly.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from collections.abc import Callable, Sequence

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
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "WatchdogLoop":
        t = threading.Thread(target=self._run, name="repro-prof-watchdog", daemon=True)
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
