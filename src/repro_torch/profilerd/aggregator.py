"""Regional aggregator: merge pushed per-node epochs into a fleet profile.

One ``profilerd aggregate`` process is the next tier above the per-node
daemon: node daemons POST sealed epoch deltas (``repro_torch.profilerd.push`` wire
format — snapshot-codec segments over HTTP) and the aggregator replays them
into

* per-node timeline rings under ``targets/<node>/timeline`` (so every
  existing offline surface — ``serve``, ``timeline``, ``diff``, ``check``,
  ``export`` — works on a node's history via ``--target <node>``);
* a continuously merged **fleet tree**, sealed into two rings: ``timeline/``
  holds recent epochs exact (bounded segment ring), ``timeline_coarse/``
  holds one keyframe every ``coarse_every`` fleet epochs over a much longer
  horizon — recent history exact, old history at coarser grain, retention in
  both enforced by dropping whole segments;
* the standard daemon artifact shape (``status.json``, ``tree.json``,
  ``events.jsonl``, ``region.json``) in its out dir, so ``check --baseline``
  and ``profilerd top`` gate/observe the *regional* profile with zero
  special cases.

Replay is idempotent and loss-bounded: every node tracks a contiguous
applied-epoch floor plus a sparse applied set, so a client retry after a
lost response never double-counts; deltas commute, so out-of-order arrival
within a keyframe era is harmless; and a ``K_FULL`` keyframe is applied by
*replacement*, resynchronizing the node's cumulative exactly (this is what
makes the client's spill-overflow resync lossless in mass).

Node churn is first-class: a new ``X-Repro-Boot`` id folds the previous
incarnation's cumulative into a retained base (``base.json``), so a
crash-looping node keeps contributing everything it ever reported.  Nodes
that stop pushing earn ``NODE_STALLED`` (and ``NODE_RECOVERED`` on
resumption); a clean daemon shutdown marks the node ``done`` instead.

Restart is crash-safe: state is rebuilt from the per-node rings + sidecars
(``node.json``) and both fleet rings are *continued* (monotonic epoch
numbering, ``TimelineWriter(preserve=True)``), so an aggregator crash costs
at most the epochs the clients still hold in their spill queues — which they
re-deliver.

A copy of ``repro.profilerd.aggregator``: it takes pushes from daemons of
either package and writes the JAX package's artifacts (``region.json``,
``targets/<node>/``, both rings).
"""

from __future__ import annotations

import json
import os
import re
import signal
import threading
import time
from dataclasses import dataclass, field
from collections.abc import Mapping

from repro_torch.core.calltree import CallTree
from repro_torch.core.snapshot import (
    K_FULL,
    EpochMeta,
    SnapshotError,
    TimelineReader,
    TimelineWriter,
)

from .profiles import REGION_FILENAME, TARGETS_DIRNAME, TIMELINE_DIRNAME
from .push import H_BOOT, H_DONE, H_EPOCH, H_INTERVAL, H_NODE, H_TARGETS, decode_push_body

__all__ = [
    "Aggregator",
    "AggregatorConfig",
    "AggregatorSource",
    "COARSE_TIMELINE_DIRNAME",
    "NODE_STALLED",
    "NODE_RECOVERED",
]

COARSE_TIMELINE_DIRNAME = "timeline_coarse"
NODE_SIDECAR = "node.json"
NODE_BASE = "base.json"

NODE_STALLED = "NODE_STALLED"
NODE_RECOVERED = "NODE_RECOVERED"

_NODE_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def _atomic_write(path: str, text: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


@dataclass
class AggregatorConfig:
    out_dir: str
    region: str = "region"
    host: str = "127.0.0.1"
    port: int = 0
    # Fleet seal + publish cadence.  Node pushes apply immediately (and seal
    # the per-node ring synchronously, before the 200 — that is the
    # crash-safety contract); the merged fleet epoch is sealed on this clock.
    epoch_s: float = 2.0
    epochs_per_segment: int = 16
    max_segments: int = 64
    # Long-horizon ring: one keyframe every `coarse_every` fleet epochs,
    # one keyframe per segment, up to `coarse_segments` segments.
    coarse_every: int = 8
    coarse_segments: int = 256
    # A node is stalled after stall_factor * its announced push interval
    # without a push (floored so sub-second test intervals don't flap).
    stall_factor: float = 1.5
    stall_floor_s: float = 0.25
    default_interval_s: float = 5.0
    max_body_bytes: int = 8 << 20
    hot_k: int = 10
    max_seconds: float | None = None
    fsync: bool = False

    def timeline_dir(self) -> str:
        return os.path.join(self.out_dir, TIMELINE_DIRNAME)

    def coarse_dir(self) -> str:
        return os.path.join(self.out_dir, COARSE_TIMELINE_DIRNAME)


@dataclass
class _NodeState:
    name: str
    boot: str | None = None
    # `base` holds dead incarnations' final cumulatives; `cum` is the live
    # incarnation.  The node's contribution to the fleet is base + cum.
    base: CallTree | None = None
    cum: CallTree = field(default_factory=CallTree)
    # Dedup state: every epoch <= floor is applied; `applied` holds the
    # sparse out-of-order epochs above it.
    floor: int = -1
    applied: set = field(default_factory=set)
    ring_epoch: int = 0  # monotonic across incarnations *and* restarts
    incarnations: int = 0
    targets: list = field(default_factory=list)
    interval_s: float = 5.0
    done: bool = False
    stalled: bool = False
    last_push_mono: float = 0.0
    last_push_wall: float = 0.0
    writer: TimelineWriter | None = None
    epochs_applied: int = 0
    duplicates: int = 0
    stale: int = 0
    bytes_received: int = 0

    def effective(self) -> CallTree:
        """This node's full contribution (do not mutate the result)."""
        if self.base is None:
            return self.cum
        out = self.base.copy()
        out.merge(self.cum)
        return out

    def is_applied(self, epoch: int) -> bool:
        return epoch <= self.floor or epoch in self.applied

    def mark_applied(self, epoch: int) -> None:
        self.applied.add(epoch)
        while self.floor + 1 in self.applied:
            self.floor += 1
            self.applied.discard(self.floor)


class Aggregator:
    """Ingest pushed epochs, maintain per-node + fleet state, publish."""

    def __init__(self, cfg: AggregatorConfig):
        self.cfg = cfg
        self.out_dir = cfg.out_dir
        os.makedirs(self.out_dir, exist_ok=True)
        self._lock = threading.RLock()
        self.nodes: dict[str, _NodeState] = {}
        self.events: list[dict] = []
        self._fleet_tree = CallTree()
        self._fleet_prev: CallTree | None = None
        self._fleet_epoch = 0
        self._dirty = False
        self._stop_requested = False
        self._t_start = time.monotonic()
        self.server = None
        self._recent = TimelineWriter(
            cfg.timeline_dir(),
            epochs_per_segment=cfg.epochs_per_segment,
            max_segments=cfg.max_segments,
            fsync=cfg.fsync,
            preserve=True,
        )
        self._coarse = TimelineWriter(
            cfg.coarse_dir(),
            epochs_per_segment=1,
            max_segments=cfg.coarse_segments,
            fsync=cfg.fsync,
            preserve=True,
        )
        self._restore()

    # -- events --------------------------------------------------------------

    def _record_event(self, ev: dict) -> None:
        self.events.append(ev)
        try:
            with open(os.path.join(self.out_dir, "events.jsonl"), "a") as f:
                f.write(json.dumps(ev) + "\n")
        except OSError:
            pass

    # -- restart recovery ----------------------------------------------------

    def _node_dir(self, name: str) -> str:
        return os.path.join(self.out_dir, TARGETS_DIRNAME, name)

    def _restore(self) -> None:
        """Rebuild per-node + fleet state from our own rings and sidecars.

        Runs before any writer appends (``TimelineWriter`` defers its purge
        to the first write, and these writers preserve anyway), so a crashed
        aggregator resumes with every node's cumulative, dedup floor and
        monotonic epoch numbering intact.
        """
        tdir = os.path.join(self.out_dir, TARGETS_DIRNAME)
        restored = 0
        if os.path.isdir(tdir):
            for name in sorted(os.listdir(tdir)):
                ring = os.path.join(self._node_dir(name), TIMELINE_DIRNAME)
                try:
                    last = TimelineReader(ring).last()
                except SnapshotError:
                    last = None
                if last is None:
                    continue
                meta, tree = last
                node = _NodeState(name=name, interval_s=self.cfg.default_interval_s)
                node.ring_epoch = meta.epoch + 1
                sidecar = None
                try:
                    with open(os.path.join(self._node_dir(name), NODE_SIDECAR)) as f:
                        sidecar = json.load(f)
                except (OSError, ValueError):
                    pass
                base = None
                try:
                    with open(os.path.join(self._node_dir(name), NODE_BASE)) as f:
                        base = CallTree.from_json(f.read())
                except (OSError, ValueError, KeyError):
                    pass
                if sidecar is not None:
                    # The ring seals the *effective* tree; the sidecar's boot
                    # + floor let the live incarnation's share be split back
                    # out (cum = effective - base), so a same-boot client can
                    # keep pushing deltas/keyframes without double-counting.
                    node.boot = sidecar.get("boot")
                    node.floor = int(sidecar.get("floor", -1))
                    node.incarnations = int(sidecar.get("incarnations", 0))
                    node.targets = list(sidecar.get("targets", []))
                    node.interval_s = float(
                        sidecar.get("interval_s", self.cfg.default_interval_s)
                    )
                    node.done = bool(sidecar.get("done", False))
                    node.base = base
                    node.cum = tree.diff(base) if base is not None else tree
                else:
                    # No sidecar: the live incarnation cannot be identified,
                    # so everything restored is treated as a dead base — the
                    # next push from any boot folds in on top.
                    node.base = tree
                    node.cum = CallTree()
                    node.floor = -1
                node.last_push_mono = time.monotonic()
                node.last_push_wall = time.time()
                self.nodes[name] = node
                restored += 1
        try:
            last = TimelineReader(self.cfg.timeline_dir()).last()
        except SnapshotError:
            last = None
        if last is not None:
            meta, tree = last
            self._fleet_prev = tree
            self._fleet_tree = tree
            self._fleet_epoch = meta.epoch + 1
        if restored:
            self._record_event(
                {"kind": "AGGREGATOR_RESTORED", "nodes": restored,
                 "fleet_epoch": self._fleet_epoch, "wall_time": time.time()}
            )

    # -- push ingest ---------------------------------------------------------

    def handle_push(self, headers: Mapping[str, str], body: bytes) -> tuple[int, dict]:
        """Apply one pushed epoch; called from HTTP handler threads.

        Returns ``(http_status, response_json_dict)``.  Anything wrong with
        the request itself — missing node, torn/corrupt frame, oversized
        body — is a clean 4xx; the 200 is sent only after the epoch is
        applied *and* sealed into the node's ring (crash-safety: an epoch
        the client saw acknowledged survives an aggregator restart).
        """
        if len(body) > self.cfg.max_body_bytes:
            return 413, {"error": f"body of {len(body)} bytes exceeds "
                                  f"{self.cfg.max_body_bytes}"}
        name = (headers.get(H_NODE) or "").strip()
        if not _NODE_NAME_RE.match(name):
            return 400, {"error": f"missing or invalid {H_NODE} header: {name!r}"}
        try:
            meta, tree = decode_push_body(body)
        except SnapshotError as e:
            return 400, {"error": f"bad push body: {e}"}
        boot = (headers.get(H_BOOT) or "").strip() or None
        done = headers.get(H_DONE) == "1"
        try:
            interval_s = float(headers.get(H_INTERVAL) or 0) or self.cfg.default_interval_s
        except ValueError:
            interval_s = self.cfg.default_interval_s
        targets = [t for t in (headers.get(H_TARGETS) or "").split(",") if t]
        with self._lock:
            return self._apply(name, boot, meta, tree, len(body),
                               interval_s=interval_s, targets=targets, done=done)

    def _apply(
        self,
        name: str,
        boot: str | None,
        meta: EpochMeta,
        tree: CallTree,
        n_bytes: int,
        *,
        interval_s: float,
        targets: list,
        done: bool,
    ) -> tuple[int, dict]:
        node = self.nodes.get(name)
        if node is None:
            node = self.nodes[name] = _NodeState(name=name)
            os.makedirs(self._node_dir(name), exist_ok=True)
            self._record_event(
                {"kind": "NODE_ATTACHED", "target": name, "boot": boot,
                 "wall_time": time.time()}
            )
        if boot is not None and node.boot is not None and boot != node.boot:
            self._fold_incarnation(node, boot)
        elif node.boot is None and boot is not None:
            if node.cum.total() or node.base is not None:
                # Restored without a sidecar: the old mass is already in
                # base; a known-boot client starting now is a new incarnation.
                self._fold_incarnation(node, boot)
            node.boot = boot
        now = time.monotonic()
        was_stalled = node.stalled
        node.last_push_mono = now
        node.last_push_wall = time.time()
        node.interval_s = interval_s
        if targets:
            node.targets = targets
        node.done = done
        node.bytes_received += n_bytes
        if was_stalled:
            node.stalled = False
            self._record_event(
                {"kind": NODE_RECOVERED, "detector": "liveness", "target": name,
                 "path": [], "share": 0.0, "wall_time": node.last_push_wall}
            )
        applied = False
        if node.is_applied(meta.epoch):
            node.duplicates += 1
        elif meta.kind == K_FULL:
            if meta.epoch >= max(node.applied, default=node.floor):
                # Replacement resync: the keyframe is the client's exact
                # cumulative, superseding every earlier epoch (including any
                # the client spilled and dropped).
                node.cum = tree
                node.floor = meta.epoch
                node.applied = {e for e in node.applied if e > node.floor}
                applied = True
            else:
                # A keyframe arriving after later deltas were applied cannot
                # replace (it would erase their mass); the client's next
                # keyframe resyncs exactly.
                node.stale += 1
        else:
            # Deltas are additive windows: they commute, so out-of-order
            # arrival within a keyframe era merges to the same cumulative.
            node.cum.merge(tree)
            node.mark_applied(meta.epoch)
            applied = True
        if applied:
            node.epochs_applied += 1
            self._dirty = True
            try:
                self._seal_node(node, meta, tree)
            except OSError as e:
                self._record_event(
                    {"kind": "TIMELINE_WRITE_FAILED", "target": name, "path": [],
                     "share": 0.0, "error": str(e), "wall_time": time.time()}
                )
        return 200, {
            "applied": applied,
            "duplicate": not applied and node.duplicates > 0,
            "epoch": meta.epoch,
            "node": name,
            "fleet_epoch": self._fleet_epoch,
        }

    def _fold_incarnation(self, node: _NodeState, new_boot: str) -> None:
        """A restarted node: retain the dead incarnation's mass in `base`."""
        if node.base is None:
            node.base = node.cum
        else:
            node.base.merge(node.cum)
        try:
            _atomic_write(
                os.path.join(self._node_dir(node.name), NODE_BASE),
                node.base.to_json(),
            )
        except OSError:
            pass
        node.cum = CallTree()
        node.applied = set()
        node.floor = -1
        node.incarnations += 1
        node.boot = new_boot
        node.done = False
        self._record_event(
            {"kind": "NODE_REBOOTED", "target": node.name,
             "incarnations": node.incarnations, "wall_time": time.time()}
        )

    def _seal_node(self, node: _NodeState, meta: EpochMeta, window: CallTree) -> None:
        """Seal one applied epoch into the node's ring + sidecar.

        Ring epoch numbering is the aggregator's own monotonic counter (the
        client's restarts at 0 per incarnation); ``progress`` carries the
        client's epoch so replay tooling can still see it.
        """
        if node.writer is None:
            node.writer = TimelineWriter(
                os.path.join(self._node_dir(node.name), TIMELINE_DIRNAME),
                epochs_per_segment=self.cfg.epochs_per_segment,
                max_segments=self.cfg.max_segments,
                fsync=self.cfg.fsync,
                preserve=True,
            )
        ring_meta = EpochMeta(node.ring_epoch, meta.wall_time, float(meta.epoch))
        if meta.kind == K_FULL or node.writer.needs_keyframe():
            node.writer.append_full(node.effective(), ring_meta)
        else:
            node.writer.append_delta(window, ring_meta)
        node.ring_epoch += 1
        try:
            _atomic_write(
                os.path.join(self._node_dir(node.name), NODE_SIDECAR),
                json.dumps(
                    {
                        "node": node.name,
                        "boot": node.boot,
                        "floor": node.floor,
                        "incarnations": node.incarnations,
                        "targets": node.targets,
                        "interval_s": node.interval_s,
                        "done": node.done,
                        "epochs_applied": node.epochs_applied,
                    }
                ),
            )
        except OSError:
            pass

    # -- liveness ------------------------------------------------------------

    def check_liveness(self) -> None:
        now = time.monotonic()
        with self._lock:
            for node in self.nodes.values():
                if node.done or node.stalled or node.last_push_mono == 0.0:
                    continue
                timeout = max(
                    self.cfg.stall_floor_s, self.cfg.stall_factor * node.interval_s
                )
                silent = now - node.last_push_mono
                if silent > timeout:
                    node.stalled = True
                    self._record_event(
                        {"kind": NODE_STALLED, "detector": "liveness",
                         "target": node.name, "path": [], "share": 0.0,
                         "silent_s": round(silent, 3),
                         "timeout_s": round(timeout, 3),
                         "wall_time": time.time()}
                    )

    # -- fleet sealing + publication -----------------------------------------

    def fleet_tree(self) -> CallTree:
        with self._lock:
            return self._fleet_tree

    def seal_fleet_epoch(self, force: bool = False) -> bool:
        """Merge every node's contribution and seal one fleet epoch."""
        with self._lock:
            if not self._dirty and not force:
                return False
            fleet = CallTree()
            for node in self.nodes.values():
                fleet.merge(node.effective())
            wall = time.time()
            progress = float(sum(n.epochs_applied for n in self.nodes.values()))
            meta = EpochMeta(self._fleet_epoch, wall, progress)
            try:
                if self._fleet_prev is None or self._recent.needs_keyframe():
                    self._recent.append_full(fleet, meta)
                else:
                    self._recent.append_delta(fleet.diff(self._fleet_prev), meta)
                if self._fleet_epoch % self.cfg.coarse_every == 0:
                    self._coarse.append_full(
                        fleet, EpochMeta(self._fleet_epoch, wall, progress)
                    )
            except OSError as e:
                self._record_event(
                    {"kind": "TIMELINE_WRITE_FAILED", "target": "<fleet>",
                     "path": [], "share": 0.0, "error": str(e), "wall_time": wall}
                )
                return False
            self._fleet_prev = fleet
            self._fleet_tree = fleet
            self._fleet_epoch += 1
            self._dirty = False
            return True

    def node_row(self, node: _NodeState) -> dict:
        state = (
            "done" if node.done
            else "STALLED" if node.stalled
            else "live"
        )
        return {
            "node": node.name,
            "state": state,
            "done": node.done,
            "stalled": node.stalled,
            "alive": not node.done and not node.stalled,
            "boot": node.boot,
            "incarnations": node.incarnations,
            "epochs_applied": node.epochs_applied,
            "duplicates": node.duplicates,
            "stale": node.stale,
            "bytes": node.bytes_received,
            "mass": node.effective().total(),
            "interval_s": node.interval_s,
            "last_push_age_s": round(
                max(0.0, time.monotonic() - node.last_push_mono), 3
            ) if node.last_push_mono else None,
            "targets": list(node.targets),
        }

    def status(self) -> dict:
        with self._lock:
            nodes = {name: self.node_row(n) for name, n in sorted(self.nodes.items())}
            fleet = self._fleet_tree
            return {
                "aggregator": True,
                "region": self.cfg.region,
                "alive": True,
                "done": bool(nodes) and all(r["done"] for r in nodes.values()),
                "stalled": any(r["stalled"] for r in nodes.values()),
                "n_nodes": len(nodes),
                "n_targets": sum(len(r["targets"]) for r in nodes.values()),
                "nodes": nodes,
                "fleet": {
                    "epochs": self._fleet_epoch,
                    "mass": fleet.total(),
                    "call_sites": fleet.node_count(),
                    "epochs_applied": sum(r["epochs_applied"] for r in nodes.values()),
                    "duplicates": sum(r["duplicates"] for r in nodes.values()),
                    "bytes": sum(r["bytes"] for r in nodes.values()),
                },
                "timeline": {
                    "dir": self.cfg.timeline_dir(),
                    "coarse_dir": self.cfg.coarse_dir(),
                    "epochs": self._fleet_epoch,
                    "epoch_s": self.cfg.epoch_s,
                    "coarse_every": self.cfg.coarse_every,
                },
                "hot_paths": [
                    {"path": list(p), "share": round(s, 4)}
                    for p, s in fleet.hot_paths(k=self.cfg.hot_k)
                ],
                "events": self.events[-20:],
                "updated": time.time(),
            }

    def hierarchy(self) -> dict:
        """The region -> node -> target tree behind hierarchical /targets."""
        with self._lock:
            nodes = []
            for name, node in sorted(self.nodes.items()):
                row = self.node_row(node)
                row["name"] = name
                row["targets"] = [{"name": t} for t in node.targets]
                nodes.append(row)
            return {"region": self.cfg.region, "nodes": nodes}

    def publish(self) -> None:
        status = self.status()
        _atomic_write(
            os.path.join(self.out_dir, "tree.json"), self.fleet_tree().to_json()
        )
        _atomic_write(os.path.join(self.out_dir, "status.json"), json.dumps(status))
        _atomic_write(
            os.path.join(self.out_dir, REGION_FILENAME), json.dumps(self.hierarchy())
        )
        with self._lock:
            for name, node in self.nodes.items():
                tdir = self._node_dir(name)
                try:
                    os.makedirs(tdir, exist_ok=True)
                    _atomic_write(
                        os.path.join(tdir, "tree.json"), node.effective().to_json()
                    )
                except OSError:
                    pass

    # -- serving + main loop -------------------------------------------------

    def enable_serving(self, port: int | None = None, host: str | None = None):
        from .server import ProfileServer

        if self.server is not None:
            return self.server
        self.server = ProfileServer(
            AggregatorSource(self),
            host=host if host is not None else self.cfg.host,
            port=port if port is not None else self.cfg.port,
            push_sink=self.handle_push,
            push_max_bytes=self.cfg.max_body_bytes,
        ).start()
        self._record_event(
            {"kind": "SERVING", "path": [], "share": 0.0, "url": self.server.url,
             "wall_time": time.time()}
        )
        return self.server

    def request_stop(self) -> None:
        self._stop_requested = True

    def run(self) -> CallTree:
        """Serve + seal/publish until SIGTERM-style stop or ``max_seconds``."""
        self.enable_serving()
        next_epoch = time.monotonic() + self.cfg.epoch_s
        self.publish()  # the artifact shape exists from second zero
        while not self._stop_requested:
            now = time.monotonic()
            if now >= next_epoch:
                self.check_liveness()
                self.seal_fleet_epoch()
                self.publish()
                next_epoch = now + self.cfg.epoch_s
            if (
                self.cfg.max_seconds is not None
                and now - self._t_start >= self.cfg.max_seconds
            ):
                break
            time.sleep(min(0.1, self.cfg.epoch_s / 4))
        self.check_liveness()
        self.seal_fleet_epoch(force=self._dirty)
        self.publish()
        self.close()
        return self.fleet_tree()

    def install_signal_handlers(self) -> None:
        def _stop(signum, frame):
            self.request_stop()

        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)

    def close(self) -> None:
        if self.server is not None:
            self.server.stop()
            self.server = None
        with self._lock:
            self._recent.close()
            self._coarse.close()
            for node in self.nodes.values():
                if node.writer is not None:
                    node.writer.close()


class AggregatorSource:
    """Serve a live aggregator through the standard query plane.

    The duck type matches ``LiveSource``/``OfflineSource``: ``/tree`` without
    a target is the merged fleet tree, ``?target=<node>`` is that node's
    contribution, ``/timeline`` serves the fleet ring (per-node rings via
    ``?target=``), and ``/targets`` goes hierarchical.
    """

    def __init__(self, agg: Aggregator):
        self.agg = agg
        self.label = f"region:{agg.cfg.region}"

    def status(self) -> dict:
        return self.agg.status()

    def tree(self, target: str | None = None) -> CallTree:
        if target is None:
            return self.agg.fleet_tree()
        with self.agg._lock:
            node = self.agg.nodes.get(target)
            if node is None:
                from .profiles import ProfileLoadError

                known = ", ".join(sorted(self.agg.nodes)) or "<none yet>"
                raise ProfileLoadError(f"unknown node {target!r} (nodes: {known})")
            return node.effective().copy()

    def targets(self) -> list[dict]:
        out = []
        for row in self.agg.hierarchy()["nodes"]:
            flat = dict(row)
            flat["targets"] = [t["name"] for t in row["targets"]]
            out.append(flat)
        return out

    def targets_hierarchy(self) -> dict:
        h = self.agg.hierarchy()
        return {"region": h["region"], "targets": self.targets(), "nodes": h["nodes"]}

    def device_tree(self, target: str | None = None):
        return None

    def timeline_dir(self, target: str | None = None) -> str | None:
        if target is None:
            return self.agg.cfg.timeline_dir()
        return os.path.join(self.agg._node_dir(target), TIMELINE_DIRNAME)
