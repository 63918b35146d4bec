"""The profiling daemon: live streaming aggregation in a separate process.

One daemon drains a *fleet* of spools (explicit ``--targets`` paths and/or a
``--watch`` directory whose new spools attach within one drain interval),
routes each source through its own decoder/resolver/``TreeIngestor`` into a
source-tagged forest — per-target trees plus a continuously merged fleet
tree — and publishes:

* ``status.json`` — fleet hot paths, per-target status rows (drop/stall/bye/
  backlog/restart state), detector verdicts naming the offending target,
  drop/ingest counters (atomically replaced every publish interval);
* ``tree.json``   — the merged fleet tree (the backends' ``snapshot()`` reads
  this, so the in-process watchdog works unchanged with the daemon backend);
* ``targets/<name>/`` — per-target ``tree.json`` + ``timeline/`` ring
  (multi-target mode); the fleet ring under ``<out>/timeline`` is merged at
  seal time;
* ``events.jsonl``— append-only anomaly log, each event tagged ``target``;
* ``report.html`` / final ``tree.json`` — on-demand / at shutdown.

Because the daemon is a separate process it also detects the one failure an
in-process helper thread cannot: a target whose interpreter is fully wedged
(GIL held in native code, SIGSTOP, hard livelock).  The agent goes silent,
the spool stops advancing, and after ``stall_timeout_s`` the daemon emits a
``TARGET_STALLED`` verdict naming the target (the JAX package's
``examples/hang_detection.py`` shows it).  A target that crashes and restarts
recreates its spool; the daemon re-attaches to the new incarnation (old
bytes drained dry first) instead of reporting a phantom stall.

This is a copy of ``repro.profilerd.daemon`` that imports no torch: the
daemon maps neither torch nor CUDA into its process. The device tree is read
with ``repro_torch.core.device_tree.load_device_tree`` and the fleet epochs
are annotated by ``repro_torch.core.planes.annotate_tree`` against the H100.
The live HTTP query plane (``serve_port``, :meth:`ProfilerDaemon.enable_serving`)
and the push plane (``push_url``) are the JAX package's, and so is the
static call-graph plane: a ``static_tree.json`` dropped into the out dir
(``python -m repro_torch.analysis extract --out <out>``), read by
``repro_torch.analysis.static_tree``, which imports no torch either.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from dataclasses import dataclass
from collections.abc import Sequence

from repro_torch.core.calltree import CallTree
from repro_torch.core.detector import Rule, TrendRule
from repro_torch.core.snapshot import EpochMeta, TimelineWriter

from .pipeline import merge_ingest_stats
from .profiles import DEVICE_TREE_FILENAME, STATIC_TREE_FILENAME, TARGETS_DIRNAME, TIMELINE_DIRNAME
from .sources import RESUMED, STALLED, SpoolSet, SpoolSource, _pid_alive, source_name_for
from .spool import SpoolError, SpoolReader, _ShortHeader

__all__ = [
    "STALLED",
    "RESUMED",
    "DaemonConfig",
    "ProfilerDaemon",
    "rule_from_spec",
    "rule_to_spec",
    "spawn_attached_daemon",
]

FAULT_MARKERS_FILENAME = "fault_markers.jsonl"


def rule_to_spec(rule: Rule) -> str:
    """Serialize a dominance rule for the ``attach --rule`` flag."""
    return (
        f"pattern={rule.pattern},threshold={rule.threshold},"
        f"consecutive={rule.consecutive},kind={rule.kind},"
        f"self_only={int(rule.self_only)},min_window={rule.min_window_total}"
    )


def rule_from_spec(spec: str) -> Rule:
    """Parse ``key=value[,key=value...]`` into a :class:`Rule`.

    Keys: pattern, threshold, consecutive, kind, self_only (0/1),
    min_window.  Unknown keys raise — a typo'd rule must fail loudly, not
    silently detect nothing.
    """
    rule = Rule()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, value = part.partition("=")
        if not sep:
            raise ValueError(f"bad --rule field {part!r} (want key=value)")
        key = key.strip()
        value = value.strip()
        if key == "pattern":
            rule.pattern = value
        elif key == "threshold":
            rule.threshold = float(value)
        elif key == "consecutive":
            rule.consecutive = int(value)
        elif key == "kind":
            rule.kind = value
        elif key == "self_only":
            rule.self_only = bool(int(value))
        elif key == "min_window":
            rule.min_window_total = float(value)
        else:
            raise ValueError(f"unknown --rule key {key!r}")
    return rule


def spawn_attached_daemon(
    spool_path: str | None = None,
    out_dir: str | None = None,
    *,
    targets: Sequence[str] = (),
    watch_dir: str | None = None,
    interval_s: float = 1.0,
    collapse_origins: Sequence[str] = (),
    stall_timeout_s: float | None = None,
    epoch_s: float | None = None,
    serve_port: int | None = None,
    exit_with_pid: int | None = None,
    device_tree: str | None = None,
    rules: Sequence[Rule] = (),
    trend_rule: TrendRule | None = None,
    threshold: float | None = None,
    consecutive: int | None = None,
    cwd: str | None = None,
    push: str | None = None,
    push_node: str | None = None,
):
    """Spawn ``python -m repro_torch.profilerd attach`` as a detached subprocess.

    The one place that knows the spawn recipe (absolute source root on
    PYTHONPATH so a relative one still resolves from any cwd, flag spelling),
    used by :class:`~repro_torch.profilerd.agent.DaemonBackend`.  The
    environment is the target's as it stands: the daemon imports no torch,
    so no variable is needed to keep it off the card.  Returns the
    ``subprocess.Popen``; send it SIGTERM for a clean final drain + publish.
    """
    import subprocess
    import sys

    src_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.profilerd", "attach"]
    if spool_path is not None:
        cmd += ["--spool", spool_path]
    if targets:
        cmd += ["--targets", ",".join(targets)]
    if watch_dir is not None:
        cmd += ["--watch", watch_dir]
    default_out = f"{spool_path}.d" if spool_path else None
    if out_dir or default_out:
        cmd += ["--out", out_dir or default_out]
    cmd += ["--interval", str(interval_s)]
    if collapse_origins:
        cmd += ["--collapse", ",".join(collapse_origins)]
    if stall_timeout_s is not None:
        cmd += ["--stall-timeout", str(stall_timeout_s)]
    if epoch_s is not None:
        cmd += ["--epoch", str(epoch_s)]
    if serve_port is not None:
        cmd += ["--serve", str(serve_port)]
    if exit_with_pid is not None:
        cmd += ["--exit-with", str(exit_with_pid)]
    if device_tree is not None:
        cmd += ["--device-tree", device_tree]
    if push is not None:
        cmd += ["--push", push]
    if push_node is not None:
        cmd += ["--push-node", push_node]
    if threshold is not None:
        cmd += ["--threshold", str(threshold)]
    if consecutive is not None:
        cmd += ["--consecutive", str(consecutive)]
    for rule in rules:
        cmd += ["--rule", rule_to_spec(rule)]
    if trend_rule is not None:
        cmd += [
            "--trend-threshold", str(trend_rule.threshold),
            "--trend-epochs", str(trend_rule.epochs),
            "--trend-drift", str(trend_rule.drift_threshold),
        ]
    return subprocess.Popen(
        cmd, cwd=cwd, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL
    )


@dataclass
class DaemonConfig:
    # One of spool_path / spool_paths / watch_dir must be set.  A single
    # spool_path with neither of the others runs in "solo" mode — exactly the
    # classic one-target layout (flat out dir, CountSealer ring).
    spool_path: str | None = None
    spool_paths: tuple[str, ...] = ()  # explicit multi-target attach
    watch_dir: str | None = None  # attach spools created after daemon start
    watch_glob: str = "*.spool"
    out_dir: str | None = None  # default: "<spool_path>.d" / "<watch>/fleet.d"
    publish_interval_s: float = 1.0
    drain_interval_s: float = 0.05
    collapse_origins: tuple[str, ...] = ()
    rules: Sequence[Rule] | None = None
    # No fresh samples for this long while the target is alive => stalled.
    stall_timeout_s: float = 5.0
    attach_timeout_s: float = 30.0
    # Attach-failure retry policy (SpoolSet backoff): exponential with jitter
    # from base to cap, then a terminal SOURCE_GAVE_UP after max attempts.
    attach_retry_base_s: float = 0.5
    attach_retry_cap_s: float = 30.0
    attach_max_attempts: int = 8
    # Multi-target straggler detection: a host whose publish-window share
    # vector diverges from the merged fleet by >= threshold (TV distance)
    # for `consecutive` windows earns a STRAGGLER event.
    straggler_threshold: float = 0.5
    straggler_consecutive: int = 2
    straggler_min_window: float = 8.0
    max_seconds: float | None = None  # bound the run (tests/benchmarks)
    hot_k: int = 10
    timeline_cap: int = 2048
    window_ring: int = 32
    # Timeline ring: every epoch_s the current window is sealed into an
    # on-disk segment under <out>/timeline (0 disables; a final epoch is
    # always sealed at shutdown so short runs still leave a timeline).
    epoch_s: float = 5.0
    epochs_per_segment: int = 16
    max_segments: int = 64
    trend_rule: TrendRule | None = None
    # Live HTTP query plane (repro_torch.profilerd.server): serve /status
    # /targets /tree /timeline /diff while attached.  None disables; 0 binds
    # an ephemeral port.  Handlers read the published snapshot under a lock —
    # the ingest path is never touched by a request.
    serve_port: int | None = None
    serve_host: str = "127.0.0.1"
    # Stop (clean final drain+publish) when this pid dies.  A --watch daemon
    # has no BYE-based exit, so a supervisor that crashes before sending
    # SIGTERM would otherwise leak it forever; the launcher passes its own
    # pid here.
    exit_with_pid: int | None = None
    # Device-plane artifact (core/device_tree.save_device_tree: the trainer's
    # profiled step).  Explicit path, or None to lazily discover a
    # ``device_tree.json`` dropped into the out dir / a target dir — targets
    # profile a step *after* the daemon starts, so discovery must be
    # late-bound.  An explicit path that does not exist yet is probed every
    # publish window.  When present the fleet timeline seals
    # roofline-annotated epochs (solo mode switches from the CountSealer fast
    # path to the generic fleet ring to carry them) and the live server
    # gains plane=device|merged.
    device_tree: str | None = None
    # Fleet push plane: POST each sealed epoch (snapshot-codec framing, see
    # repro_torch.profilerd.push) to a regional aggregator.  None disables.
    # Push rides the epoch cadence, so it needs epoch_s > 0.
    push_url: str | None = None
    push_node: str | None = None  # default: the hostname
    push_keyframe_every: int = 16
    push_max_spill_bytes: int = 16 << 20
    push_timeout_s: float = 5.0

    def resolved_out_dir(self) -> str:
        if self.out_dir:
            return self.out_dir
        if self.spool_path:
            return f"{self.spool_path}.d"
        if self.watch_dir:
            return os.path.join(self.watch_dir, "fleet.d")
        if self.spool_paths:
            return f"{self.spool_paths[0]}.d"
        raise ValueError("DaemonConfig needs spool_path, spool_paths or watch_dir")

    def resolved_timeline_dir(self) -> str:
        return os.path.join(self.resolved_out_dir(), TIMELINE_DIRNAME)

    def all_spool_paths(self) -> tuple[str, ...]:
        paths = (self.spool_path,) if self.spool_path else ()
        return paths + tuple(p for p in self.spool_paths if p != self.spool_path)


def _atomic_write(path: str, text: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


class ProfilerDaemon:
    """Streaming aggregator over a fleet of target spools."""

    def __init__(self, cfg: DaemonConfig):
        self.cfg = cfg
        if not (cfg.spool_path or cfg.spool_paths or cfg.watch_dir):
            raise ValueError("DaemonConfig needs spool_path, spool_paths or watch_dir")
        self.out_dir = cfg.resolved_out_dir()
        os.makedirs(self.out_dir, exist_ok=True)
        # Solo mode = the classic single-target daemon: flat artifact layout,
        # the source's tree IS the fleet tree, its CountSealer ring IS the
        # fleet ring (O(touched chains) per epoch, no merge work at all).
        self.solo = bool(cfg.spool_path) and not cfg.spool_paths and not cfg.watch_dir
        self.spools = SpoolSet(
            paths=cfg.all_spool_paths(),
            watch_dir=cfg.watch_dir,
            watch_glob=cfg.watch_glob,
            make_source=self._make_source,
            attach_retry_base_s=cfg.attach_retry_base_s,
            attach_retry_cap_s=cfg.attach_retry_cap_s,
            attach_max_attempts=cfg.attach_max_attempts,
        )
        # Device plane: loaded from cfg.device_tree or discovered beside the
        # out dir once a target drops its artifact (see _refresh_device_tree).
        self._device_tree: CallTree | None = None
        self._device_tree_mtime = -1.0
        self._device_tree_error: str | None = None
        # Static call-graph plane: discovered beside the out dir, same
        # lazy-artifact lifecycle as the device plane (_refresh_static_tree).
        self._static_tree: CallTree | None = None
        self._static_tree_mtime = -1.0
        self._static_tree_error: str | None = None
        # Fleet timeline ring (multi mode): per-target rings are sealed by
        # each source's CountSealer; the fleet ring is merged at seal time.
        # Solo mode with an explicit device tree also takes this path — the
        # CountSealer fast lane is samples-only and cannot carry roofline
        # annotations, so annotated epochs go through the generic codec.
        self.fleet_writer: TimelineWriter | None = None
        if cfg.epoch_s > 0 and (not self.solo or cfg.device_tree):
            self.fleet_writer = TimelineWriter(
                cfg.resolved_timeline_dir(),
                epochs_per_segment=cfg.epochs_per_segment,
                max_segments=cfg.max_segments,
            )
        self._fleet_prev: CallTree | None = None
        self._fleet_epoch = 0
        self._fleet_tree = CallTree()  # latest published merge (multi mode)
        self._fleet_n = 0  # source count at the last fleet merge
        self._target_rows: dict[str, str] = {}  # last written status row per target
        self.events: list[dict] = []
        # Logged once per daemon: the vectorized ingest lane being absent
        # (no numpy) is an environment property, not a per-target one.
        self._scalar_fallback_logged = False
        # Ring of windowed fleet snapshots: (wall_time, cumulative-tree copy)
        # serving retrospective "what changed in the last N windows" queries.
        self.windows: deque = deque(maxlen=cfg.window_ring)
        # Live query plane (see enable_serving): the publisher hands each
        # window's status + tree copies to `shared`; HTTP threads read those.
        self.shared = None
        self.server = None
        self._stop_requested = False
        self._attach_errors: dict[str, str] = {}
        self._last_attach_error: SpoolError | None = None
        # Fault-window markers: a harness (the JAX package's repro.faults)
        # appends inject/clear lines to <out>/fault_markers.jsonl; the daemon
        # tails the file and
        # threads each marker into the event log stamped with the current
        # epoch counters, so scoring can align verdicts to injections.
        self._fault_marker_offset = 0
        self._fault_marker_buf = b""
        # Multi-target straggler detection over publish-window deltas.
        from repro_torch.core.detector import StragglerDetector

        self._straggler = StragglerDetector(threshold=cfg.straggler_threshold)
        self._straggler_prev: dict[str, CallTree] = {}
        self._straggler_streaks: dict[str, int] = {}
        # Fleet push plane: ship each sealed epoch to a regional aggregator.
        # Outages spill locally (bounded) and resync via keyframe, so a dead
        # aggregator never blocks ingest or loses epoch mass.
        self._push = None
        self._push_done = False
        if cfg.push_url:
            import socket

            from .push import PushClient

            self._push = PushClient(
                cfg.push_url,
                cfg.push_node or socket.gethostname().split(".")[0] or "node",
                interval_hint_s=cfg.epoch_s if cfg.epoch_s > 0 else cfg.publish_interval_s,
                keyframe_every=cfg.push_keyframe_every,
                max_spill_bytes=cfg.push_max_spill_bytes,
                timeout_s=cfg.push_timeout_s,
                retry_base_s=cfg.attach_retry_base_s,
                retry_cap_s=cfg.attach_retry_cap_s,
                on_event=self._record_event,
            )
        self._t_start = time.monotonic()

    # -- compatibility surface (classic single-target attributes) ------------

    def _solo_source(self) -> SpoolSource | None:
        if len(self.spools.sources) == 1:
            return next(iter(self.spools.sources.values()))
        return None

    @property
    def sources(self) -> list[SpoolSource]:
        return list(self.spools.sources.values())

    @property
    def tree(self) -> CallTree:
        """The fleet tree: the lone source's live tree, or the latest merge."""
        src = self._solo_source()
        if src is not None:
            return src.tree
        return self._fleet_tree

    @property
    def target_pid(self) -> int:
        src = self._solo_source()
        return src.target_pid if src is not None else 0

    @property
    def wire_version(self) -> int:
        return max((s.wire_version for s in self.sources), default=0)

    @property
    def n_stacks(self) -> int:
        return sum(s.n_stacks for s in self.sources)

    @property
    def n_ticks_reported(self) -> int:
        return sum(s.n_ticks_reported for s in self.sources)

    @property
    def dropped_batches(self) -> int:
        return sum(s.dropped_batches for s in self.sources)

    @property
    def bye_seen(self) -> bool:
        srcs = self.sources
        return bool(srcs) and all(s.bye_seen for s in srcs)

    # -- event plumbing ------------------------------------------------------

    def _on_anomaly(self, ev, target: str) -> None:
        self._record_event(
            {
                "kind": ev.kind,
                "detector": "dominance",
                "target": target,
                "path": list(ev.path),
                "share": ev.share,
                "rule_pattern": ev.rule.pattern,
                "window": ev.window_index,
                "wall_time": ev.wall_time,
            }
        )

    def _on_callback_failed(self, ev, tb: str, target: str) -> None:
        # A poisoned verdict action (warn/checkpoint hook) is recorded and
        # survived — the drain loop must keep sampling a sick process.
        self._record_event(
            {
                "kind": "CALLBACK_FAILED",
                "detector": "daemon",
                "target": target,
                "path": list(ev.path),
                "share": ev.share,
                "event_kind": ev.kind,
                "error": tb.strip().splitlines()[-1] if tb.strip() else "",
                "traceback": tb,
                "wall_time": time.time(),
            }
        )

    def _record_event(self, ev: dict) -> None:
        self.events.append(ev)
        try:
            with open(os.path.join(self.out_dir, "events.jsonl"), "a") as f:
                f.write(json.dumps(ev) + "\n")
        except OSError:
            pass

    # -- attach / ingest -----------------------------------------------------

    def _target_dir(self, name: str) -> str:
        return os.path.join(self.out_dir, TARGETS_DIRNAME, name)

    def _make_source(self, name: str, path: str, reader: SpoolReader | None = None):
        try:
            tdir = None
            if self.cfg.epoch_s > 0:
                if self.solo:
                    # The fleet writer owns the solo ring when annotating
                    # (device-tree mode); the source must not also seal there.
                    tdir = None if self.fleet_writer is not None else self.cfg.resolved_timeline_dir()
                else:
                    tdir = os.path.join(self._target_dir(name), TIMELINE_DIRNAME)
            src = SpoolSource(
                name,
                path,
                reader=reader,
                collapse_origins=self.cfg.collapse_origins,
                rules=self.cfg.rules,
                trend_rule=self.cfg.trend_rule,
                timeline_dir=tdir,
                epochs_per_segment=self.cfg.epochs_per_segment,
                max_segments=self.cfg.max_segments,
                timeline_cap=self.cfg.timeline_cap,
            )
        except (SpoolError, OSError, ValueError) as e:
            # OSError covers per-target TimelineWriter/dir creation failures
            # (unwritable out dir): one bad attach must not crash the daemon
            # for every healthy target.
            if isinstance(e, SpoolError):
                self._last_attach_error = e
            # Log each distinct failure once: a half-created file under
            # --watch is retried every drain pass and must not spam the log.
            if self._attach_errors.get(path) != str(e):
                self._attach_errors[path] = str(e)
                self._record_event(
                    {"kind": "SOURCE_ATTACH_FAILED", "target": name, "path": path,
                     "error": str(e), "wall_time": time.time()}
                )
            return None
        self._attach_errors.pop(path, None)
        self._last_attach_error = None
        if not src.pipeline.vectorized and not self._scalar_fallback_logged:
            # Per-sample decode still works — this only flags the missing
            # throughput headroom (numpy absent), visibly but exactly once.
            self._scalar_fallback_logged = True
            self._record_event(
                {"kind": "INGEST_SCALAR_FALLBACK", "detector": "ingest", "target": name,
                 "path": [], "share": 0.0,
                 "reason": "numpy unavailable: vectorized batch ingest disabled",
                 "wall_time": time.time()}
            )
        src.detector.add_callback(lambda ev, _n=name: self._on_anomaly(ev, _n))
        src.detector.on_callback_error = (
            lambda ev, tb, _n=name: self._on_callback_failed(ev, tb, _n)
        )
        if not self.solo:
            os.makedirs(self._target_dir(name), exist_ok=True)
            self._record_event(
                {"kind": "TARGET_ATTACHED", "target": name, "path": path,
                 "pid": src.target_pid, "wall_time": time.time()}
            )
        return src

    def attach(self) -> "ProfilerDaemon":
        """Block until at least one source is attached (``attach_timeout_s``).

        Solo mode waits for the one configured spool, exactly as before.
        Multi mode attaches whatever is already there and returns as soon as
        one source exists; remaining explicit paths and watch discoveries
        attach inside the run loop as they appear.
        """
        deadline = time.monotonic() + self.cfg.attach_timeout_s
        while True:
            self.spools.discover()
            self._drain_gave_up()
            if self.spools.sources:
                break
            # A present-but-garbage spool should fail fast, not time out —
            # but only when no watch dir could still produce a valid one, and
            # never on a short header (the file may still be materializing).
            if (
                self._last_attach_error is not None
                and not isinstance(self._last_attach_error, _ShortHeader)
                and self.cfg.watch_dir is None
                and all(os.path.exists(p) for p in self.cfg.all_spool_paths())
            ):
                raise self._last_attach_error
            if time.monotonic() >= deadline:
                what = ", ".join(self.cfg.all_spool_paths()) or f"watch:{self.cfg.watch_dir}"
                raise SpoolError(
                    f"spool {what} did not appear within {self.cfg.attach_timeout_s:.0f}s"
                )
            if self._stop_requested:
                raise SpoolError("stopped before any spool appeared")
            time.sleep(0.05)
        # Silence (stall detection) and max_seconds count from the moment the
        # first target's spool appeared — a target launched long after the
        # daemon must not start life looking stalled.
        self._t_start = time.monotonic()
        return self

    def drain(self) -> int:
        """One full pass: discovery, re-attach checks, then drain every
        source dry (round-robin bounded chunks).  Returns stacks ingested."""
        before = self.n_stacks
        self.spools.discover()
        self._drain_gave_up()
        self._poll_fault_markers()
        for s in self.sources:
            if s.maybe_reattach():
                self._record_event(
                    {"kind": "TARGET_RESTARTED", "target": s.name, "path": s.path,
                     "pid": s.target_pid, "restarts": s.restarts,
                     "wall_time": time.time()}
                )
        self.spools.drain_all()
        return self.n_stacks - before

    def _drain_gave_up(self) -> None:
        """Terminal SOURCE_GAVE_UP events for paths past the retry budget."""
        for p in self.spools.gave_up_now:
            self._record_event(
                {"kind": "SOURCE_GAVE_UP", "target": source_name_for(p), "path": p,
                 "attempts": self.cfg.attach_max_attempts,
                 "error": self._attach_errors.get(p, ""), "wall_time": time.time()}
            )
        self.spools.gave_up_now.clear()

    def request_stop(self) -> None:
        """Ask the run loop to finalize (final drain + seal + publish) and
        return.  Safe from signal handlers and other threads."""
        self._stop_requested = True

    # -- analysis / publication ---------------------------------------------

    def _device_tree_candidates(self) -> list[str]:
        if self.cfg.device_tree:
            return [self.cfg.device_tree]
        cands = [os.path.join(self.out_dir, DEVICE_TREE_FILENAME)]
        tdir = os.path.join(self.out_dir, TARGETS_DIRNAME)
        if os.path.isdir(tdir):
            for name in sorted(os.listdir(tdir)):
                cands.append(os.path.join(tdir, name, DEVICE_TREE_FILENAME))
        return cands

    def _refresh_device_tree(self) -> None:
        """Pick up the device-plane artifact, possibly dropped mid-run.

        Targets profile a step *after* attaching, so the artifact usually lands
        after the daemon started; one existence/mtime probe per publish window
        keeps discovery off the ingest path.  A loaded tree is copied to the
        out dir (making it self-contained for later offline serving) and
        handed to the live query plane.
        """
        path = next((p for p in self._device_tree_candidates() if os.path.exists(p)), None)
        if path is None:
            return
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return
        if self._device_tree is not None and mtime <= self._device_tree_mtime:
            return
        from repro_torch.core.device_tree import load_device_tree

        try:
            tree = load_device_tree(path)
        except (OSError, ValueError, KeyError) as e:
            if self._device_tree_error != str(e):  # log each distinct failure once
                self._device_tree_error = str(e)
                self._record_event(
                    {"kind": "DEVICE_TREE_UNREADABLE", "path": path,
                     "error": str(e), "wall_time": time.time()}
                )
            return
        self._device_tree = tree
        self._device_tree_mtime = mtime
        self._device_tree_error = None
        fleet_copy = os.path.join(self.out_dir, DEVICE_TREE_FILENAME)
        if os.path.abspath(path) != os.path.abspath(fleet_copy):
            try:
                with open(path) as f:
                    _atomic_write(fleet_copy, f.read())
            except OSError:
                pass  # serving still works from the in-memory tree
        if self.shared is not None:
            self.shared.set_device_tree(tree)
        self._record_event(
            {"kind": "DEVICE_TREE_LOADED", "path": path,
             "call_sites": tree.node_count(), "wall_time": time.time()}
        )

    def _refresh_static_tree(self) -> None:
        """Pick up the static call-graph artifact, possibly dropped mid-run.

        ``python -m repro_torch.analysis extract --out <out_dir>/static_tree.json``
        (an operator, or CI) drops the artifact at any point; one
        existence/mtime probe per publish window hands it to the live query
        plane so ``/tree?plane=static`` works without a daemon restart.
        """
        path = os.path.join(self.out_dir, STATIC_TREE_FILENAME)
        if not os.path.exists(path):
            return
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return
        if self._static_tree is not None and mtime <= self._static_tree_mtime:
            return
        from repro_torch.analysis.static_tree import load_static_tree

        try:
            tree = load_static_tree(path)
        except (OSError, ValueError, KeyError) as e:
            if self._static_tree_error != str(e):  # log each distinct failure once
                self._static_tree_error = str(e)
                self._record_event(
                    {"kind": "STATIC_TREE_UNREADABLE", "path": path,
                     "error": str(e), "wall_time": time.time()}
                )
            return
        self._static_tree = tree
        self._static_tree_mtime = mtime
        self._static_tree_error = None
        if self.shared is not None:
            self.shared.set_static_tree(tree)
        self._record_event(
            {"kind": "STATIC_TREE_LOADED", "path": path,
             "call_sites": tree.node_count(), "wall_time": time.time()}
        )

    def seal_epoch(self) -> None:
        """Seal the current window into the timeline ring(s) + trend rules.

        Each source's ingestor hands over the chains it touched this epoch,
        so per-target sealing costs O(touched paths); the fleet ring (multi
        mode) then merges the per-target trees at seal time — one O(forest)
        merge per epoch, never per sample.
        """
        if self.cfg.epoch_s <= 0:
            return
        # A short run can seal its only epoch before the first publish window
        # ever fires — the artifact must still be picked up here.
        self._refresh_device_tree()
        self._refresh_static_tree()
        wall = time.time()
        for s in self.sources:
            try:
                meta, verdicts = s.seal_epoch(wall)
            except OSError as e:
                self._record_event(
                    {"kind": "TIMELINE_WRITE_FAILED", "target": s.name, "path": [],
                     "share": 0.0, "error": str(e), "wall_time": wall}
                )
                continue
            if meta is None:
                continue
            for v in verdicts:
                self._record_event(
                    {
                        "kind": v.kind,
                        "detector": "trend",
                        "target": s.name,
                        "path": list(v.path),
                        "share": round(v.share, 4),
                        "epoch": v.epoch,
                        "began_epoch": v.began_epoch,
                        "latency_epochs": v.latency_epochs,
                        "wall_time": v.wall_time,
                    }
                )
        fleet: CallTree | None = None
        if (self.fleet_writer is not None or self._push is not None) and self.sources:
            solo_src = self._solo_source()
            if self.solo and solo_src is not None and self.fleet_writer is None:
                # Solo push without a fleet ring: the lone source's live tree
                # IS the fleet — no merge copy needed (push only reads it).
                fleet = solo_src.tree
            else:
                fleet = CallTree()
                for s in self.sources:
                    fleet.merge(s.tree)
                if self._device_tree is not None:
                    # Annotations are ordinary metric keys, so the sealed
                    # epochs carry the device plane through the unchanged
                    # codec — and cross-run diff/check can gate on roofline
                    # regressions.
                    from repro_torch.core.planes import annotate_tree

                    # The fleet tree was built fresh above, so annotate in
                    # place: the device plane's marginal cost is one
                    # attribution walk.
                    fleet = annotate_tree(fleet, self._device_tree, copy=False)
        progress = float(
            sum(s.sealer.node_count for s in self.sources if s.sealer)
            or (fleet.node_count() if fleet is not None else 0)
        )
        if self.fleet_writer is not None and fleet is not None:
            meta = EpochMeta(self._fleet_epoch, wall, progress)
            try:
                if self._fleet_prev is None or self.fleet_writer.needs_keyframe():
                    self.fleet_writer.append_full(fleet, meta)
                else:
                    self.fleet_writer.append_delta(fleet.diff(self._fleet_prev), meta)
                self._fleet_prev = fleet
                self._fleet_epoch += 1
            except OSError as e:
                self._record_event(
                    {"kind": "TIMELINE_WRITE_FAILED", "target": "<fleet>", "path": [],
                     "share": 0.0, "error": str(e), "wall_time": wall}
                )
        if self._push is not None and fleet is not None:
            # Ship this epoch to the regional aggregator.  The client keeps
            # its own cumulative shadow (decoupled from the local ring's
            # keyframe cadence), spills through outages, and resyncs with a
            # K_FULL — a dead aggregator costs bounded memory, zero mass.
            self._push.push_epoch(
                fleet,
                wall_time=wall,
                progress=progress,
                targets=[s.name for s in self.sources],
                done=self._push_done,
            )

    def _check_stalls(self) -> None:
        for s in self.sources:
            if s.resumed_pending:
                s.resumed_pending = False
                self._record_event(
                    {"kind": RESUMED, "detector": "stall", "target": s.name,
                     "path": [], "share": 0.0, "pid": s.target_pid,
                     "wall_time": time.time()}
                )
            ev = s.check_stall(self.cfg.stall_timeout_s)
            if ev is not None:
                self._record_event(ev)

    def _check_stragglers(self, changed: list) -> None:
        """Flag hosts whose publish-window activity diverges from the fleet.

        Windows are per-source deltas since this check last saw the source;
        the detector needs at least two busy hosts to define "the fleet".
        A host fires once per divergence streak (at `straggler_consecutive`),
        re-arming when it rejoins the fleet's profile.
        """
        if self.solo:
            return
        windows: dict[str, CallTree] = {}
        for s, snap in changed:
            prev = self._straggler_prev.get(s.name)
            win = snap.diff(prev) if prev is not None else snap
            self._straggler_prev[s.name] = snap
            if win.total() >= self.cfg.straggler_min_window:
                windows[s.name] = win
        if len(windows) < 2:
            return
        flagged = dict(self._straggler.observe(windows))
        for name in windows:
            if name not in flagged:
                self._straggler_streaks.pop(name, None)
        for name, tv in flagged.items():
            streak = self._straggler_streaks.get(name, 0) + 1
            self._straggler_streaks[name] = streak
            if streak == self.cfg.straggler_consecutive:
                self._record_event(
                    {"kind": "STRAGGLER", "detector": "straggler", "target": name,
                     "path": [], "share": round(tv, 4), "peers": len(windows),
                     "wall_time": time.time()}
                )

    def _poll_fault_markers(self) -> None:
        """Tail <out>/fault_markers.jsonl into FAULT_* timeline events.

        Each marker line ({"op": "inject"|"clear", "scenario": ..., ...}) is
        stamped with the daemon's *current* epoch counters at ingest time —
        the ground-truth alignment the fault scoreboard scores against.
        """
        path = os.path.join(self.out_dir, FAULT_MARKERS_FILENAME)
        try:
            with open(path, "rb") as f:
                f.seek(self._fault_marker_offset)
                data = f.read()
        except OSError:
            return
        if not data:
            return
        self._fault_marker_offset += len(data)
        self._fault_marker_buf += data
        *lines, self._fault_marker_buf = self._fault_marker_buf.split(b"\n")
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                marker = json.loads(line)
                op = marker["op"]
            except (ValueError, TypeError, KeyError):
                self._record_event(
                    {"kind": "FAULT_MARKER_INVALID", "detector": "daemon",
                     "line": line.decode("utf-8", "replace")[:200],
                     "wall_time": time.time()}
                )
                continue
            solo_src = self._solo_source()
            self._record_event(
                {
                    "kind": "FAULT_INJECT" if op == "inject" else "FAULT_CLEAR",
                    "detector": "harness",
                    "scenario": marker.get("scenario", ""),
                    "op": op,
                    "epoch": (
                        solo_src.sealer.epoch
                        if self.solo and solo_src is not None and solo_src.sealer is not None
                        else self._fleet_epoch
                    ),
                    "target_epochs": {
                        s.name: s.sealer.epoch for s in self.sources if s.sealer is not None
                    },
                    "marker_wall_time": marker.get("wall_time"),
                    "wall_time": time.time(),
                }
            )

    def enable_serving(self, port: int | None = None, host: str | None = None):
        """Start the HTTP query plane over this daemon's published state.

        Returns the started :class:`~repro_torch.profilerd.server.ProfileServer`.
        Reads are decoupled from ingest: every publish window hands a status
        dict plus immutable fleet/per-target tree copies to
        :class:`SharedProfileState`, and request handlers only ever touch
        those.
        """
        from .server import LiveSource, ProfileServer, SharedProfileState

        if self.server is not None:
            return self.server
        self.shared = SharedProfileState()
        if self._device_tree is not None:
            self.shared.set_device_tree(self._device_tree)
        if self._static_tree is not None:
            self.shared.set_static_tree(self._static_tree)
        tdir = self.cfg.resolved_timeline_dir() if self.cfg.epoch_s > 0 else None
        label = f"pid={self.target_pid or '?'}" if self.solo else f"fleet:{self.out_dir}"
        source = LiveSource(
            self.shared,
            timeline_dir=tdir,
            label=label,
            target_timeline_dir_fn=None if self.solo else self._target_timeline_dir,
        )
        self.server = ProfileServer(
            source,
            host=host if host is not None else self.cfg.serve_host,
            port=port if port is not None else (self.cfg.serve_port or 0),
        ).start()
        self._record_event(
            {"kind": "SERVING", "path": [], "share": 0.0, "url": self.server.url,
             "wall_time": time.time()}
        )
        return self.server

    def _target_timeline_dir(self, name: str) -> str | None:
        if self.cfg.epoch_s <= 0 or name not in self.spools.sources:
            return None
        return os.path.join(self._target_dir(name), TIMELINE_DIRNAME)

    def publish(self) -> None:
        """One analysis window: detector verdicts + status/tree artifacts."""
        self._refresh_device_tree()
        self._refresh_static_tree()
        changed = []
        for s in self.sources:
            snap = s.publish_window()
            if snap is not None:
                changed.append((s, snap))
        solo_src = self._solo_source()
        fleet_snap: CallTree | None = None
        if solo_src is not None:
            # The lone source's snapshot is the fleet snapshot — no merge.
            fleet_snap = changed[0][1] if changed else None
        elif changed or len(self.sources) != self._fleet_n:
            # Re-merge on new samples, and also when the source set changed —
            # `tree` switches from the lone source's live tree to the merged
            # fleet the moment a second target attaches, and the merge must
            # not lag behind that switch.
            fleet_snap = CallTree()
            for s in self.sources:
                if s.last_snapshot is not None:
                    fleet_snap.merge(s.last_snapshot)
            self._fleet_tree = fleet_snap
            self._fleet_n = len(self.sources)
        if fleet_snap is not None:
            self.windows.append((time.time(), fleet_snap))
        self._check_stalls()
        self._check_stragglers(changed)
        status = self.status()
        if self.shared is not None:
            # Snapshots are never mutated after this point; handlers may read
            # them concurrently.  Quiet windows keep the previous trees.
            self.shared.update(
                status,
                fleet_snap,
                targets={s.name: s.last_snapshot for s in self.sources
                         if s.last_snapshot is not None},
            )
        _atomic_write(os.path.join(self.out_dir, "tree.json"), self.tree.to_json())
        if not self.solo:
            fresh = {id(s): snap for s, snap in changed}
            for s in self.sources:
                # Per-target status: the same artifact contract a solo daemon
                # gives its target, so a DaemonBackend pointed here via
                # REPRO_PROFILERD_OUT (the launcher's shared daemon) keeps its
                # snapshot()/depth_trace()/wait-for-done working unchanged.
                # Quiet, unchanged targets are skipped — a long-lived watch
                # daemon must not rewrite N done targets' files every window.
                row = s.status_row()
                row_key = json.dumps(row, sort_keys=True)
                snap = fresh.get(id(s))
                if snap is None and self._target_rows.get(s.name) == row_key:
                    continue
                tdir = self._target_dir(s.name)
                os.makedirs(tdir, exist_ok=True)
                if snap is not None:
                    _atomic_write(os.path.join(tdir, "tree.json"), snap.to_json())
                row["depth_timeline"] = [[round(t, 4), d] for t, d in s.timeline]
                row["updated"] = status["updated"]
                _atomic_write(os.path.join(tdir, "status.json"), json.dumps(row))
                self._target_rows[s.name] = row_key
        _atomic_write(os.path.join(self.out_dir, "status.json"), json.dumps(status))

    def status(self) -> dict:
        srcs = self.sources
        solo_src = self._solo_source()
        tree = self.tree
        if solo_src is not None:
            depth_timeline = [[round(t, 4), d] for t, d in solo_src.timeline]
        else:
            merged = sorted(
                (t, d) for s in srcs for t, d in s.timeline
            )[-self.cfg.timeline_cap :]
            depth_timeline = [[round(t, 4), d] for t, d in merged]
        if self.cfg.epoch_s > 0:
            if self.solo and solo_src is not None and solo_src.sealer is not None:
                timeline_block = {
                    "dir": self.cfg.resolved_timeline_dir(),
                    "epochs": solo_src.sealer.epoch,
                    "call_sites": solo_src.sealer.node_count,
                    "epoch_s": self.cfg.epoch_s,
                }
            else:
                timeline_block = {
                    "dir": self.cfg.resolved_timeline_dir(),
                    "epochs": self._fleet_epoch,
                    "call_sites": sum(s.sealer.node_count for s in srcs if s.sealer),
                    "epoch_s": self.cfg.epoch_s,
                }
        else:
            timeline_block = None
        return {
            "pid": solo_src.target_pid if solo_src is not None else 0,
            "alive": any(s.alive for s in srcs),
            "stalled": any(s.stalled for s in srcs),
            "done": self.bye_seen,
            "period_s": solo_src.period_s if solo_src is not None
            else max((s.period_s for s in srcs), default=0.0),
            "wire_version": self.wire_version,
            "n_stacks": self.n_stacks,
            "n_ticks": self.n_ticks_reported,
            "dropped_batches": self.dropped_batches,
            "resolver": {
                "hits": sum(s.resolver.hits for s in srcs),
                "misses": sum(s.resolver.misses for s in srcs),
            },
            # The unified ingest_stats schema (repro_torch.profilerd.pipeline),
            # summed across sources; per-target rows carry the same dict.
            "ingest": merge_ingest_stats([s.ingest_stats() for s in srcs]),
            # Degraded-mode accounting for re-attaching mid-stream (a
            # previous reader consumed the STRDEF/STACKDEF definitions):
            # such samples ingest as "?" placeholder stacks, never silently.
            "unknown_stack_refs": sum(s.unknown_stack_refs for s in srcs),
            "degraded_stackdefs": sum(s.degraded_stackdefs for s in srcs),
            "n_targets": len(srcs),
            "watch": self.cfg.watch_dir,
            "attach_failures": [
                dict(row, error=self._attach_errors.get(row["path"], ""))
                for row in self.spools.attach_failure_rows()
            ],
            "device_plane": self._device_tree is not None,
            "static_plane": self._static_tree is not None,
            "node": self._push.node if self._push is not None else None,
            "push": self._push.stats() if self._push is not None else None,
            "targets": {s.name: s.status_row() for s in srcs},
            "hot_paths": [
                {"path": list(p), "share": round(s, 4)}
                for p, s in tree.hot_paths(k=self.cfg.hot_k)
            ],
            "depth_timeline": depth_timeline,
            "events": self.events[-20:],
            "windows": len(self.windows),
            "timeline": timeline_block,
            "updated": time.time(),
        }

    def write_report(self, name: str = "report") -> str:
        from repro_torch.core.report import render_html

        title = (
            f"profilerd pid={self.target_pid}"
            if self.solo
            else f"profilerd fleet ({len(self.sources)} targets)"
        )
        path = os.path.join(self.out_dir, f"{name}.html")
        _atomic_write(path, render_html(self.tree, title=title))
        return path

    # -- main loop -----------------------------------------------------------

    def _all_done(self) -> bool:
        srcs = self.sources
        if not srcs or not self.spools.all_explicit_attached:
            return False
        return all(s.bye_seen or not s.alive for s in srcs)

    def run(self, on_publish=None) -> CallTree:
        """Attach, stream until every target says BYE / dies (explicit
        targets), a stop is requested (``--watch`` mode, SIGTERM), or
        ``max_seconds`` — then final-publish and write the HTML report.
        Returns the merged fleet tree."""
        if not self.spools.sources:
            self.attach()
        if self.cfg.serve_port is not None and self.server is None:
            try:
                self.enable_serving()
            except OSError as e:
                # A busy/privileged port must not cost the profiling run.
                self._record_event(
                    {"kind": "SERVE_FAILED", "path": [], "share": 0.0,
                     "error": str(e), "wall_time": time.time()}
                )
        next_publish = time.monotonic() + self.cfg.publish_interval_s
        next_epoch = (
            time.monotonic() + self.cfg.epoch_s if self.cfg.epoch_s > 0 else None
        )
        while True:
            self.drain()
            now = time.monotonic()
            # An explicit target whose spool never appeared must not pin the
            # run open forever: after the attach window it is abandoned with
            # a loud event, and _all_done() can then see the real targets.
            if (
                not self.spools.all_explicit_attached
                and now - self._t_start >= self.cfg.attach_timeout_s
            ):
                for p in self.spools.abandon_pending():
                    self._record_event(
                        {"kind": "TARGET_NEVER_APPEARED", "target": source_name_for(p),
                         "path": p, "timeout_s": self.cfg.attach_timeout_s,
                         "wall_time": time.time()}
                    )
            if now >= next_publish:
                self.publish()
                if on_publish is not None:
                    on_publish(self)
                next_publish = now + self.cfg.publish_interval_s
            if next_epoch is not None and now >= next_epoch:
                self.seal_epoch()
                next_epoch = now + self.cfg.epoch_s
            if self.cfg.exit_with_pid is not None and not _pid_alive(self.cfg.exit_with_pid):
                self._record_event(
                    {"kind": "SUPERVISOR_GONE", "pid": self.cfg.exit_with_pid,
                     "wall_time": time.time()}
                )
                self.request_stop()
            if self._stop_requested:
                break
            # drain() above already emptied every spool.  A --watch daemon
            # outlives done targets: new spools may appear at any time, so it
            # only exits on request_stop()/SIGTERM or max_seconds.
            if self.cfg.watch_dir is None and self._all_done():
                break
            if self.cfg.max_seconds is not None and now - self._t_start >= self.cfg.max_seconds:
                break
            time.sleep(self.cfg.drain_interval_s)
        self.drain()  # salvage whatever dead/late targets left behind
        self._push_done = True  # the final push announces a clean shutdown
        self.seal_epoch()  # final epoch: short runs still leave a timeline
        self.publish()
        if on_publish is not None:
            on_publish(self)
        self.write_report()
        if self.server is not None:
            self.server.stop()
            self.server = None
        if self.fleet_writer is not None:
            self.fleet_writer.close()
        for s in self.sources:
            s.close()
        return self.tree
