"""Live profile query plane: a stdlib HTTP API over any profile source.

The paper's point is observing the system *while it runs*; this module is the
read side of that.  A :class:`ProfileServer` (plain ``http.server``, zero
dependencies) exposes:

* ``GET /status``   — the daemon's live status JSON (offline: a synthesized
  summary of the loaded profile);
* ``GET /tree``     — the merged call tree through the universal exporter:
  ``?fmt=csv|folded|speedscope|html|json``, ``?view=<library view>`` or
  ad-hoc ``?root=&level=&metric=&min_share=``;
* ``GET /timeline`` — epoch table + phase segmentation over the timeline
  ring (``?fmt=text|json``);
* ``GET /diff``     — this profile vs ``?baseline=<profile path>`` (or the
  server's ``--baseline``): text share deltas, or ``fmt=html`` for the
  share-delta flamegraph.

Two sources feed it:

* :class:`LiveSource` — a :class:`SharedProfileState` handle the daemon
  updates **once per publish interval** under a lock with an already-copied
  tree.  Request handling never touches daemon internals, so serving adds
  zero work to the ingest path (the lock is held for an attribute swap).
* :class:`OfflineSource` — any profile artifact on disk (daemon out dir,
  timeline ring, ``tree.json``, ``.snap``), cached and re-read only when its
  mtime moves — so pointing it at a dir a daemon is *currently* writing
  also works.

Responses are bounded (``max_bytes``, HTTP 413 beyond it) so a runaway tree
cannot OOM a dashboard poller.  ``render_top`` turns ``/status`` JSON into
the refreshing terminal view behind ``profilerd top``.

A copy of ``repro.profilerd.server`` with the same endpoints, parameters,
status codes and bodies.  ``plane=device|merged`` read the port's device
tree (``device_tree.json``, the trainer's profiled step) and annotate
against the H100; ``plane=static`` reads ``static_tree.json``
(``python -m repro_torch.analysis extract``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from repro_torch.core.calltree import CallTree
from repro_torch.core.export import (
    CONTENT_TYPES,
    EXPORT_FORMATS,
    diff_flamegraph_html,
    export_tree,
    prepare_view,
)
from repro_torch.core.planes import (
    OCCUPANCY,
    PLANES,
    PlaneError,
    default_metric,
    dominant_term,
    select_plane,
)
from repro_torch.core.report import ViewConfig, render_diff

from .profiles import (
    ProfileLoadError,
    device_tree_path,
    list_profile_targets,
    load_device_plane,
    load_profile,
    load_region,
    load_static_plane,
    profile_mtime,
    static_tree_path,
    target_profile_dir,
    timeline_dir_of,
)
from .sources import source_name_for

DEFAULT_MAX_BYTES = 16 << 20  # bound any single response body
MAX_TIMELINE_EPOCHS = 512  # newest epochs served; older ones need the ring

ENDPOINTS = ("/status", "/targets", "/tree", "/timeline", "/diff")


class SharedProfileState:
    """Daemon -> server hand-off: the latest published status + tree copies.

    The daemon calls :meth:`update` once per publish window with tree copies
    it will never mutate again (the merged fleet tree plus one per target);
    handlers read the same objects concurrently without copying.  The lock
    only ever guards attribute swaps.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._status: dict = {}
        self._tree: CallTree | None = None
        self._targets: dict[str, CallTree] = {}
        self._device_tree: CallTree | None = None
        self._static_tree: CallTree | None = None

    def update(
        self,
        status: dict,
        tree: CallTree | None = None,
        targets: dict | None = None,
    ) -> None:
        with self._lock:
            self._status = status
            if tree is not None:
                self._tree = tree
            if targets is not None:
                self._targets = dict(targets)

    def set_device_tree(self, tree: CallTree | None) -> None:
        """The daemon's device-plane artifact (one per fleet: co-located
        targets run the same compiled program).  Set once at startup; the
        tree is never mutated afterwards, so readers share it lock-free
        after the swap."""
        with self._lock:
            self._device_tree = tree

    def device_tree(self) -> CallTree | None:
        with self._lock:
            return self._device_tree

    def set_static_tree(self, tree: CallTree | None) -> None:
        """The static call-graph artifact (one per fleet: every target runs
        the same source tree).  Same swap discipline as the device plane."""
        with self._lock:
            self._static_tree = tree

    def static_tree(self) -> CallTree | None:
        with self._lock:
            return self._static_tree

    def snapshot(self) -> tuple[dict, CallTree]:
        with self._lock:
            return self._status, (self._tree if self._tree is not None else CallTree())

    def target_tree(self, name: str) -> CallTree | None:
        with self._lock:
            return self._targets.get(name)

    def target_names(self) -> list[str]:
        with self._lock:
            return sorted(self._targets)


class LiveSource:
    """Serve a running daemon through its :class:`SharedProfileState`."""

    def __init__(
        self,
        shared: SharedProfileState,
        timeline_dir: str | None = None,
        label: str = "live",
        target_timeline_dir_fn=None,
    ):
        self.shared = shared
        self._timeline_dir = timeline_dir
        self._target_timeline_dir_fn = target_timeline_dir_fn
        self.label = label

    def status(self) -> dict:
        status, _ = self.shared.snapshot()
        return status or {"live": True, "note": "daemon has not published yet"}

    def tree(self, target: str | None = None) -> CallTree:
        if target is None:
            return self.shared.snapshot()[1]
        t = self.shared.target_tree(target)
        if t is not None:
            return t
        status, _ = self.shared.snapshot()
        if target in (status.get("targets") or {}):
            # Attached but no published sample window yet: an empty tree is
            # the honest answer — /targets lists this name, so a 404 here
            # would contradict the same server one request earlier.
            return CallTree()
        known = ", ".join(self.shared.target_names()) or "<none yet>"
        raise ProfileLoadError(f"unknown target {target!r} (targets: {known})")

    def targets(self) -> list[dict]:
        status, _ = self.shared.snapshot()
        rows = status.get("targets") or {}
        out = [{"name": name, **row} for name, row in sorted(rows.items())]
        # Spools the daemon could not attach (backing off / gave up) are part
        # of the fleet's honest state — a permanently-garbage path must be
        # visible here, not silently absent.
        for row in status.get("attach_failures") or []:
            out.append(
                {
                    "name": source_name_for(row["path"]),
                    "path": row["path"],
                    "attach_failed": True,
                    "gave_up": bool(row.get("gave_up")),
                    "attempts": row.get("attempts", 0),
                    "retry_in_s": row.get("retry_in_s"),
                    "error": row.get("error", ""),
                }
            )
        return out

    def targets_hierarchy(self) -> dict:
        """Region -> node -> target.  A node daemon is one node deep: its
        own targets under the node name it pushes (or would push) as."""
        status, _ = self.shared.snapshot()
        rows = self.targets()
        node = status.get("node") or "local"
        return {
            "region": status.get("region"),
            "targets": rows,
            "nodes": [{"name": node, "targets": rows}],
        }

    def device_tree(self, target: str | None = None) -> CallTree | None:
        # One device artifact per fleet: every co-located target runs the
        # same compiled program, so the per-target plane is the fleet plane.
        return self.shared.device_tree()

    def static_tree(self, target: str | None = None) -> CallTree | None:
        # One static artifact per fleet: every target runs the same source.
        return self.shared.static_tree()

    def timeline_dir(self, target: str | None = None) -> str | None:
        if target is None:
            return self._timeline_dir
        if self._target_timeline_dir_fn is None:
            return None
        return self._target_timeline_dir_fn(target)


class OfflineSource:
    """Serve a profile artifact from disk (mtime-cached).

    A multi-target daemon out dir also exposes its per-target profiles
    (``targets/<name>/``) through ``tree(target=...)``/``targets()``, each
    behind its own mtime cache.
    """

    def __init__(self, profile_path: str, label: str | None = None):
        self.path = profile_path
        self.label = label or profile_path
        self._cached: CallTree | None = None
        self._cached_mtime = -1.0
        self._device_cache: dict[str, tuple[float, CallTree]] = {}
        self._static_cache: dict[str, tuple[float, CallTree]] = {}
        self._target_sources: dict[str, "OfflineSource"] = {}
        self._lock = threading.Lock()

    def _target_source(self, target: str) -> "OfflineSource":
        with self._lock:
            sub = self._target_sources.get(target)
        if sub is None:
            p = target_profile_dir(self.path, target)
            if p is None:
                known = ", ".join(list_profile_targets(self.path)) or "<none>"
                raise ProfileLoadError(
                    f"{self.path}: no target {target!r} (targets: {known})"
                )
            sub = OfflineSource(p, label=f"{self.label}[{target}]")
            with self._lock:
                sub = self._target_sources.setdefault(target, sub)
        return sub

    def tree(self, target: str | None = None) -> CallTree:
        if target is not None:
            return self._target_source(target).tree()
        with self._lock:
            mtime = profile_mtime(self.path)
            if self._cached is None or mtime > self._cached_mtime:
                self._cached = load_profile(self.path)
                self._cached_mtime = mtime
            return self._cached

    def device_tree(self, target: str | None = None) -> CallTree | None:
        """The ``device_tree.json`` beside the profile, mtime-cached per
        resolved path (a per-target dir falls back to the fleet artifact)."""
        p = device_tree_path(self.path, target)
        if p is None:
            return None
        try:
            mtime = os.path.getmtime(p)
        except OSError:
            return None
        with self._lock:
            cached = self._device_cache.get(p)
            if cached is not None and cached[0] >= mtime:
                return cached[1]
        tree = load_device_plane(self.path, target)
        if tree is not None:
            with self._lock:
                self._device_cache[p] = (mtime, tree)
        return tree

    def static_tree(self, target: str | None = None) -> CallTree | None:
        """The ``static_tree.json`` beside the profile, mtime-cached per
        resolved path (a per-target dir falls back to the fleet artifact)."""
        p = static_tree_path(self.path, target)
        if p is None:
            return None
        try:
            mtime = os.path.getmtime(p)
        except OSError:
            return None
        with self._lock:
            cached = self._static_cache.get(p)
            if cached is not None and cached[0] >= mtime:
                return cached[1]
        tree = load_static_plane(self.path, target)
        if tree is not None:
            with self._lock:
                self._static_cache[p] = (mtime, tree)
        return tree

    def targets(self) -> list[dict]:
        rows = []
        for name in list_profile_targets(self.path):
            try:
                t = self.tree(name)
            except ProfileLoadError:
                continue
            rows.append(
                {
                    "name": name,
                    "n_stacks": t.total(),
                    "call_sites": t.node_count(),
                    "depth": t.depth(),
                }
            )
        return rows

    def targets_hierarchy(self) -> dict:
        """An aggregator out dir serves its ``region.json`` map; any other
        profile is a single implicit node holding its own targets."""
        rows = self.targets()
        region = load_region(self.path)
        if region is not None:
            nodes = []
            by_name = {r["name"]: r for r in rows}
            for node in region.get("nodes") or []:
                row = dict(node)
                row["targets"] = [
                    t if isinstance(t, dict) else {"name": t}
                    for t in node.get("targets") or []
                ]
                stats = by_name.get(node.get("name"))
                if stats is not None:
                    row.setdefault("n_stacks", stats["n_stacks"])
                nodes.append(row)
            return {"region": region.get("region"), "targets": rows, "nodes": nodes}
        name = os.path.basename(self.path.rstrip(os.sep)) or self.path
        return {"region": None, "targets": rows, "nodes": [{"name": name, "targets": rows}]}

    def status(self) -> dict:
        tree = self.tree()
        targets = list_profile_targets(self.path)
        return {
            "offline": True,
            "profile": self.path,
            "n_stacks": tree.total(),
            "call_sites": tree.node_count(),
            "depth": tree.depth(),
            "timeline_dir": self.timeline_dir(),
            "n_targets": len(targets),
            "target_names": targets,
            "hot_paths": [
                {"path": list(p), "share": round(s, 4)} for p, s in tree.hot_paths(k=10)
            ],
            "updated": profile_mtime(self.path),
        }

    def timeline_dir(self, target: str | None = None) -> str | None:
        if target is not None:
            return self._target_source(target).timeline_dir()
        return timeline_dir_of(self.path)


class _HTTPError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _one(q: dict, key: str, default: str | None = None) -> str | None:
    vals = q.get(key)
    return vals[0] if vals else default


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-profilerd"
    protocol_version = "HTTP/1.1"

    # self.server is the _Server below (source/baseline/max_bytes/verbose).

    def log_message(self, fmt, *args):  # noqa: A003 - BaseHTTPRequestHandler API
        if self.server.verbose:
            super().log_message(fmt, *args)

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        url = urlsplit(self.path)
        q = parse_qs(url.query)
        try:
            if url.path in ("/", "/help"):
                body, ctype = self._help(), "text/plain; charset=utf-8"
            elif url.path == "/status":
                body, ctype = json.dumps(self.server.source.status(), indent=1), "application/json"
            elif url.path == "/targets":
                body, ctype = self._targets(), "application/json"
            elif url.path == "/tree":
                body, ctype = self._tree(q)
            elif url.path == "/timeline":
                body, ctype = self._timeline(q)
            elif url.path == "/diff":
                body, ctype = self._diff(q)
            else:
                raise _HTTPError(404, f"unknown endpoint {url.path}; try {', '.join(ENDPOINTS)}")
        except _HTTPError as e:
            return self._send(e.code, str(e) + "\n", "text/plain; charset=utf-8")
        except ProfileLoadError as e:
            return self._send(404, f"profile unreadable: {e}\n", "text/plain; charset=utf-8")
        except Exception as e:  # a broken query must not kill the server thread
            return self._send(500, f"internal error: {e!r}\n", "text/plain; charset=utf-8")
        self._send(200, body, ctype)

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
        """Push-plane ingest (``POST /push``), live only when the server was
        started with a ``push_sink`` (the regional aggregator).  Anything
        malformed is a clean 4xx; the sink decides applied/duplicate."""
        url = urlsplit(self.path)
        sink = getattr(self.server, "push_sink", None)
        if sink is None:
            return self._send(405, "this server does not accept pushes\n",
                              "text/plain; charset=utf-8")
        if url.path != "/push":
            return self._send(404, f"unknown POST endpoint {url.path}; try /push\n",
                              "text/plain; charset=utf-8")
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        if length <= 0:
            return self._send(411, "need a Content-Length'd push body\n",
                              "text/plain; charset=utf-8")
        cap = getattr(self.server, "push_max_bytes", DEFAULT_MAX_BYTES)
        if length > cap:
            # Drain (bounded) so the client sees the 413 instead of a reset
            # connection, then refuse.
            remaining = min(length, 4 * cap)
            while remaining > 0:
                chunk = self.rfile.read(min(65536, remaining))
                if not chunk:
                    break
                remaining -= len(chunk)
            self.close_connection = True
            return self._send(413, f"push body of {length} bytes exceeds {cap}\n",
                              "text/plain; charset=utf-8")
        body = self.rfile.read(length)
        if len(body) != length:
            return self._send(400, "truncated push body\n", "text/plain; charset=utf-8")
        try:
            code, payload = sink(self.headers, body)
        except Exception as e:  # the ingest plane must not kill the thread
            return self._send(500, f"internal error: {e!r}\n", "text/plain; charset=utf-8")
        self._send(code, json.dumps(payload) + "\n", "application/json")

    def _send(self, code: int, body: str, ctype: str) -> None:
        payload = body.encode("utf-8", errors="replace")
        if len(payload) > self.server.max_bytes:
            code = 413
            payload = (
                f"response of {len(payload)} bytes exceeds the server cap "
                f"({self.server.max_bytes}); narrow the query (view=, level=, min_share=)\n"
            ).encode()
            ctype = "text/plain; charset=utf-8"
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-response; routine for curls/pollers

    # -- endpoints -----------------------------------------------------------

    def _help(self) -> str:
        return (
            "repro profilerd serve — endpoints:\n"
            "  /status                         live daemon status (or offline summary)\n"
            "  /targets                        per-target status rows (multi-target daemon)\n"
            "  /tree?fmt=csv|folded|speedscope|html|json&view=NAME&target=NAME\n"
            "       &plane=host|device|merged|static&metric=samples&root=SUBSTR&level=N&min_share=F\n"
            "  /timeline?fmt=text|json&metric=samples&target=NAME\n"
            "  /diff?baseline=PATH&fmt=text|html&plane=host|device|merged|static&metric=samples\n"
        )

    def _targets(self) -> str:
        source = self.server.source
        if hasattr(source, "targets_hierarchy"):
            # Hierarchical shape: flat `targets` rows stay for existing
            # consumers, `region`/`nodes` carry the fleet structure.
            return json.dumps(source.targets_hierarchy(), indent=1)
        rows = source.targets() if hasattr(source, "targets") else []
        return json.dumps({"targets": rows, "region": None, "nodes": []}, indent=1)

    def _baseline_source(self, path: str) -> "OfflineSource":
        """Baseline profiles get the same mtime cache as the served profile —
        a 2s /diff poller must not re-decode a timeline ring every tick."""
        cache = self.server._baseline_sources
        src = cache.get(path)
        if src is None:
            if len(cache) >= 16:  # a loopback operator can name many paths
                cache.clear()
            src = cache[path] = OfflineSource(path)
        return src

    def _loopback(self) -> bool:
        host = self.server.server_address[0]
        return host.startswith("127.") or host in ("::1", "localhost")

    def _view_from_query(self, q: dict) -> ViewConfig | None:
        name = _one(q, "view")
        root = _one(q, "root")
        level = _one(q, "level")
        min_share = _one(q, "min_share")
        base = None
        if name is not None:
            from repro_torch.core.views_library import VIEWS

            if name not in VIEWS:
                raise _HTTPError(404, f"unknown view {name!r}; see views_library.list_views()")
            base = VIEWS[name]
        elif root is None and level is None and min_share is None:
            return None
        try:
            from dataclasses import replace

            # Ad-hoc params refine the named view (they are the advertised
            # way out of a 413), or stand alone when no view= is given.
            overrides = {}
            if root is not None:
                overrides["root"] = root
            if level is not None:
                overrides["level"] = int(level)
            if min_share is not None:
                overrides["min_share"] = float(min_share)
            if base is None:
                return ViewConfig(name=root or "adhoc", **overrides)
            return replace(base, **overrides) if overrides else base
        except ValueError as e:
            raise _HTTPError(400, f"bad view parameters: {e}") from None

    def _plane_of(self, q: dict) -> str:
        plane = _one(q, "plane", "host") or "host"
        if plane not in PLANES:
            raise _HTTPError(400, f"unknown plane {plane!r}; choose from {', '.join(PLANES)}")
        return plane

    def _plane_tree(self, tree: CallTree, plane: str, target: str | None) -> CallTree:
        """Resolve the requested plane over a host tree from our source.

        A missing device artifact is a 404 with the remedy hint (the plane
        exists, this profile just lacks the artifact); a source that predates
        device planes entirely behaves the same as one without the artifact.
        """
        if plane == "host":
            return tree
        source = self.server.source
        device = static = None
        if plane == "static":
            getter = getattr(source, "static_tree", None)
            static = getter(target) if getter is not None else None
        else:
            getter = getattr(source, "device_tree", None)
            device = getter(target) if getter is not None else None
        try:
            return select_plane(
                tree, device, plane, profile=getattr(source, "path", None), static=static
            )
        except PlaneError as e:
            raise _HTTPError(404, str(e)) from None

    def _tree(self, q: dict) -> tuple[str, str]:
        fmt = _one(q, "fmt", "csv")
        if fmt not in EXPORT_FORMATS:
            raise _HTTPError(400, f"unknown fmt {fmt!r}; choose from {', '.join(EXPORT_FORMATS)}")
        plane = self._plane_of(q)
        view = self._view_from_query(q)
        target = _one(q, "target")
        tree = self.server.source.tree(target) if target else self.server.source.tree()
        tree = self._plane_tree(tree, plane, target)
        metric = default_metric(plane, _one(q, "metric"))
        roofline = plane == "merged" and fmt == "html"
        label = self.server.source.label
        if target:
            label = f"{label} [{target}]"
        if plane != "host":
            label = f"{label} [{plane} plane]"
        if fmt == "csv":
            # The CSV body carries its own marker rows; serve it as-is.
            return export_tree(tree, "csv", view=view, metric=metric, title=label), CONTENT_TYPES["csv"]
        # The stack-shaped formats would ship a silent empty payload — fail
        # loudly instead (the no-vacuous-empty-artifact contract, HTTP
        # edition).  prepare_view applies zoom/filters/level/min_share once
        # and owns every emptiness verdict, including fmt stacklessness.
        applied, metric, marker = prepare_view(tree, view, metric, fmt=fmt)
        if marker is not None:
            raise _HTTPError(404, marker.lstrip("# "))
        if view is not None:
            label = f"{label} [{view.name}]"
        body = export_tree(applied, fmt, metric=metric, title=label, roofline=roofline)
        return body, CONTENT_TYPES[fmt]

    def _read_timeline(self, tdir: str) -> list:
        """Decode the ring's newest epochs, cached on the segment mtimes.

        Decoding up to ``max_segments`` of keyframes+deltas per request would
        make a 2-second dashboard poller pay the full ring every tick; the
        segments only change when the daemon seals an epoch, so key the cache
        on their (path, mtime) set.  Decoded trees are read-only (their fast
        lane is empty), so concurrent handlers may share the cached windows.
        """
        from repro_torch.core.snapshot import SnapshotError, TimelineReader, list_segments

        def seg_key():
            out = []
            for p in list_segments(tdir):
                try:
                    out.append((p, os.path.getmtime(p)))
                except OSError:
                    pass
            return tuple(out)

        key = seg_key()
        cached = self.server._timeline_cache.get(tdir)
        if cached is not None and cached[0] == key:
            return cached[1]
        epochs = []
        try:
            for meta, window, _cum in TimelineReader(tdir).epochs():
                epochs.append((meta, window, None))
                if len(epochs) > MAX_TIMELINE_EPOCHS:
                    epochs.pop(0)
        except SnapshotError as e:
            raise _HTTPError(500, f"timeline unreadable: {e}") from None
        if len(self.server._timeline_cache) >= 32:  # one entry per ring dir
            self.server._timeline_cache.clear()
        self.server._timeline_cache[tdir] = (key, epochs)
        return epochs

    def _timeline(self, q: dict) -> tuple[str, str]:
        target = _one(q, "target")
        tdir = self.server.source.timeline_dir(target) if target else self.server.source.timeline_dir()
        if tdir is None:
            raise _HTTPError(
                404,
                "this profile has no timeline ring (daemon --epoch 0?)"
                + (f" for target {target!r}" if target else ""),
            )
        from repro_torch.core.views_library import phase_table, timeline_table

        metric = _one(q, "metric", "samples")
        fmt = _one(q, "fmt", "text")
        if fmt not in ("text", "json"):
            raise _HTTPError(400, f"unknown timeline fmt {fmt!r}; choose text or json")
        epochs = self._read_timeline(tdir)
        if not epochs:
            raise _HTTPError(404, f"{tdir}: timeline ring holds no decodable epochs")
        if fmt == "json":
            body = json.dumps(
                [
                    {
                        "epoch": meta.epoch,
                        "wall_time": meta.wall_time,
                        "progress": meta.progress,
                        "window_total": window.total(metric),
                        "top": [
                            {"path": list(p), "share": round(s, 4)}
                            for p, s in window.hot_paths(metric, k=3)
                        ],
                    }
                    for meta, window, _ in epochs
                ]
            )
            return body, "application/json"
        body = phase_table(epochs, metric=metric) + "\n\n" + timeline_table(epochs, metric=metric)
        return body, "text/plain; charset=utf-8"

    def _diff(self, q: dict) -> tuple[str, str]:
        baseline_path = _one(q, "baseline", self.server.baseline)
        if not baseline_path:
            raise _HTTPError(400, "need ?baseline=<profile path> (or start the server with --baseline)")
        # A query-supplied baseline is a server-side filesystem read.  On the
        # loopback default that is the operator diffing their own files; on
        # any other bind it would let remote clients probe/read arbitrary
        # paths, so only the operator-configured --baseline is honored there.
        if baseline_path != self.server.baseline and not self._loopback():
            raise _HTTPError(
                403,
                "?baseline= paths are only honored on a loopback bind; "
                "start the server with --baseline to diff on this host",
            )
        plane = self._plane_of(q)
        baseline_src = self._baseline_source(baseline_path)
        baseline = baseline_src.tree()
        current = self.server.source.tree()
        if plane != "host":
            # Each side resolves the plane through its *own* device artifact;
            # a device-plane diff with either side missing must fail loudly,
            # not silently degrade to a host-only comparison.
            try:
                baseline = select_plane(
                    baseline,
                    baseline_src.device_tree() if plane != "static" else None,
                    plane,
                    profile=baseline_path,
                    static=baseline_src.static_tree() if plane == "static" else None,
                )
            except PlaneError as e:
                raise _HTTPError(404, f"baseline: {e}") from None
            current = self._plane_tree(current, plane, None)
        metric = default_metric(plane, _one(q, "metric")) or "samples"
        fmt = _one(q, "fmt", "text")
        if fmt == "html":
            title = f"{os.path.basename(baseline_path.rstrip(os.sep)) or baseline_path} vs {self.server.source.label}"
            return diff_flamegraph_html(baseline, current, metric, title=title), CONTENT_TYPES["html"]
        if fmt != "text":
            raise _HTTPError(400, f"unknown diff fmt {fmt!r}; choose text or html")
        body = render_diff(
            baseline,
            current,
            metric=metric,
            label_a=os.path.basename(baseline_path.rstrip(os.sep)) or baseline_path,
            label_b=self.server.source.label,
        )
        return body, "text/plain; charset=utf-8"


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class ProfileServer:
    """Bind, serve in a background thread, stop on demand.

    ``port=0`` binds an ephemeral port (tests); ``.port``/``.url`` report the
    actual binding.  The server thread is a daemon thread: an exiting process
    never hangs on it.
    """

    def __init__(
        self,
        source,
        host: str = "127.0.0.1",
        port: int = 0,
        baseline: str | None = None,
        max_bytes: int = DEFAULT_MAX_BYTES,
        verbose: bool = False,
        push_sink=None,
        push_max_bytes: int = 8 << 20,
    ):
        self.source = source
        self._httpd = _Server((host, port), _Handler)
        self._httpd.source = source
        self._httpd.baseline = baseline
        self._httpd.max_bytes = max_bytes
        self._httpd.verbose = verbose
        # push_sink(headers, body) -> (status, json_dict): the aggregator's
        # ingest hook.  None (the default) keeps this a read-only plane.
        self._httpd.push_sink = push_sink
        self._httpd.push_max_bytes = push_max_bytes
        self._httpd._timeline_cache = {}
        self._httpd._baseline_sources = {}
        self._thread: threading.Thread | None = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ProfileServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="profilerd-serve", daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Blocking variant for the ``profilerd serve`` CLI."""
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# -- terminal `top` ----------------------------------------------------------


def fetch_status(base_url: str, timeout: float = 5.0) -> dict:
    import urllib.request  # ~200ms of ssl/email machinery only `top` needs

    with urllib.request.urlopen(base_url.rstrip("/") + "/status", timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def fetch_plane_tree(base_url: str, plane: str, timeout: float = 5.0) -> tuple[int, str]:
    """``(http_code, body)`` for ``/tree?fmt=json&plane=...`` — the 404 body
    is the server's remedy hint and is worth showing verbatim."""
    import urllib.error
    import urllib.request

    url = base_url.rstrip("/") + f"/tree?fmt=json&plane={plane}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return 200, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8", errors="replace")


def render_plane_rows(tree: CallTree, plane: str, k: int = 10) -> str:
    """The `top --plane` table: hottest paths with their roofline columns.

    The device plane ranks by flops (it has no samples); merged ranks by
    samples like the host view, with each path's annotated occupancy and
    dominant roofline term alongside.
    """
    metric = default_metric(plane, None) or "samples"
    lines = [f"{'SHARE':>8} {'ROOF-OCC':>9} {'BOUND':<11} HOTTEST PATHS [{plane} plane, {metric}]"]
    for path, share in tree.hot_paths(metric, k=k):
        node = tree.root
        for name in path:
            node = node.children.get(name)
            if node is None:
                break
        occ = node.metrics.get(OCCUPANCY) if node is not None else None
        term = dominant_term(node.metrics) if node is not None else None
        occ_s = f"{occ:9.2%}" if occ is not None else f"{'--':>9}"
        lines.append(f"{share:8.2%} {occ_s} {term or '--':<11} {'/'.join(path)}")
    if len(lines) == 1:
        lines.append(f"      --        --  (no {metric} in this plane yet)")
    return "\n".join(lines)


def render_fleet_rollup(status: dict) -> str:
    """The aggregator's node table for ``profilerd top`` — one row per node
    in the region, plus the fleet totals line."""
    fleet = status.get("fleet") or {}
    lines = [
        f"region={status.get('region', '?')} nodes={status.get('n_nodes', 0)} "
        f"targets={status.get('n_targets', 0)} fleet_epochs={fleet.get('epochs', 0)} "
        f"mass={fleet.get('mass', 0):.6g} applied={fleet.get('epochs_applied', 0)} "
        f"dup={fleet.get('duplicates', 0)} bytes={fleet.get('bytes', 0)}",
        "",
        f"{'NODE':<18} {'STATE':<8} {'EPOCHS':>7} {'DUP':>4} {'MASS':>10} "
        f"{'AGE(s)':>7} {'INC':>4}  TARGETS",
    ]
    for name, row in sorted((status.get("nodes") or {}).items()):
        age = row.get("last_push_age_s")
        lines.append(
            f"{name:<18.18} {row.get('state', '?'):<8} "
            f"{row.get('epochs_applied', 0):>7} {row.get('duplicates', 0):>4} "
            f"{row.get('mass', 0):>10.6g} "
            f"{age if age is not None else '--':>7} "
            f"{row.get('incarnations', 0):>4}  {','.join(row.get('targets') or []) or '--'}"
        )
    if not status.get("nodes"):
        lines.append("  (no nodes have pushed yet)")
    return "\n".join(lines)


def render_top(status: dict, base_url: str = "", k: int = 10) -> str:
    """One refresh of the hottest paths + verdicts, `top(1)`-style."""
    if status.get("aggregator"):
        state = "STALLED" if status.get("stalled") else ("done" if status.get("done") else "live")
        head = (
            f"profilerd top — {base_url}  [aggregator region={status.get('region', '?')}] "
            f"[{state}]\n" + render_fleet_rollup(status)
        )
        lines = [head, "", f"{'SHARE':>8}  HOTTEST PATHS (fleet)"]
        for hp in status.get("hot_paths", [])[:k]:
            lines.append(f"{hp['share']:8.2%}  {'/'.join(hp['path'])}")
        if not status.get("hot_paths"):
            lines.append("      --  (no samples yet)")
        events = status.get("events", [])
        if events:
            lines += ["", "FLEET EVENTS (newest last)"]
            for ev in events[-5:]:
                lines.append(
                    f"  {ev.get('kind', '?'):<18} node={ev.get('target', '-')}"
                )
        return "\n".join(lines)
    if status.get("offline"):
        head = (
            f"profilerd top — {base_url}  [offline profile {status.get('profile', '?')}]\n"
            f"samples={status.get('n_stacks', 0):.6g} call_sites={status.get('call_sites', 0)} "
            f"depth={status.get('depth', 0)}"
        )
    else:
        state = "STALLED" if status.get("stalled") else ("done" if status.get("done") else "live")
        tl = status.get("timeline") or {}
        who = (
            f"targets={status.get('n_targets', 1)}"
            if status.get("n_targets", 1) > 1 or status.get("watch")
            else f"pid={status.get('pid', '?')}"
        )
        head = (
            f"profilerd top — {base_url}  {who} [{state}] "
            f"wire=v{status.get('wire_version', '?')}\n"
            f"stacks={status.get('n_stacks', 0)} dropped={status.get('dropped_batches', 0)} "
            f"epochs={tl.get('epochs', 0)} call_sites={tl.get('call_sites', 0)} "
            f"windows={status.get('windows', 0)}"
        )
        if status.get("ingest"):
            from .pipeline import format_ingest_stats

            head += "\n" + format_ingest_stats(status["ingest"])
    lines = [head]
    targets = status.get("targets") or {}
    if len(targets) > 1 or status.get("watch"):
        lines += ["", f"{'TARGET':<18} {'STATE':<8} {'STACKS':>8} {'DROP':>5} "
                      f"{'BACKLOG':>8} {'RESTARTS':>8}  PID"]
        for name, row in sorted(targets.items()):
            tstate = (
                "STALLED" if row.get("stalled")
                else "done" if row.get("done")
                else "live" if row.get("alive")
                else "dead"
            )
            lines.append(
                f"{name:<18.18} {tstate:<8} {row.get('n_stacks', 0):>8} "
                f"{row.get('dropped_batches', 0):>5} {row.get('backlog_bytes', 0):>8} "
                f"{row.get('restarts', 0):>8}  {row.get('pid', '?')}"
            )
    for row in status.get("attach_failures") or []:
        if row.get("gave_up"):
            state = f"GAVE UP after {row.get('attempts', '?')} attempts"
        else:
            state = f"attach retry in {row.get('retry_in_s', '?')}s (attempt {row.get('attempts', '?')})"
        lines.append(f"  !! {row.get('path', '?')}: {state} — {row.get('error', '')}")
    lines += ["", f"{'SHARE':>8}  HOTTEST PATHS"]
    for hp in status.get("hot_paths", [])[:k]:
        lines.append(f"{hp['share']:8.2%}  {'/'.join(hp['path'])}")
    if not status.get("hot_paths"):
        lines.append("      --  (no samples yet)")
    events = status.get("events", [])
    if events:
        lines += ["", "DETECTOR VERDICTS (newest last)"]
        for ev in events[-5:]:
            where = "/".join(ev.get("path", [])) or "-"
            lines.append(f"  {ev.get('kind', '?'):<18} share={ev.get('share', 0):.2f}  {where}")
    return "\n".join(lines)


def top_loop(
    base_url: str,
    interval_s: float = 2.0,
    k: int = 10,
    once: bool = False,
    plane: str = "host",
) -> int:
    """Poll ``/status`` and redraw; returns an exit code (1 = unreachable,
    4 = the requested plane has no device artifact behind this server)."""
    while True:
        try:
            status = fetch_status(base_url)
        except OSError as e:
            print(f"[profilerd top] {base_url} unreachable: {e}")
            return 1
        frame = render_top(status, base_url, k=k)
        if plane != "host":
            code, body = fetch_plane_tree(base_url, plane)
            if code == 404:
                print(frame)
                print(f"\n[profilerd top] {body.strip()}")
                return 4
            if code != 200:
                print(f"[profilerd top] /tree?plane={plane} -> HTTP {code}: {body.strip()}")
                return 1
            frame += "\n\n" + render_plane_rows(CallTree.from_json(body), plane, k=k)
        if once:
            print(frame)
            return 0
        print("\x1b[2J\x1b[H" + frame + f"\n\n(refreshing every {interval_s:g}s — Ctrl-C to quit)")
        if status.get("done"):
            return 0
        time.sleep(interval_s)
