"""Network push plane: ship sealed epoch deltas to a regional aggregator.

The wire format *is* the snapshot codec (``repro_torch.core.snapshot``): every POST
body is a self-contained one-record segment — the ``RTL1`` header followed by
one CRC-framed ``K_FULL``/``K_DELTA`` payload with a fresh per-body string
table.  The aggregator decodes with the same torn-tail-tolerant
``_parse_segment`` the timeline ring uses, so a truncated or bit-flipped body
is detected by CRC, never half-applied.  Node identity and epoch metadata
ride in HTTP headers (``X-Repro-Node``/``-Boot``/``-Epoch``/...), keeping the
binary payload byte-identical to what a local ring would have stored.

:class:`PushClient` is the daemon-side producer.  Its contract is that a dead
or slow aggregator never blocks ingest and never loses epoch *mass*:

* each sealed epoch is encoded once and enqueued in a bounded in-memory
  spill queue; delivery attempts happen at enqueue time only when the
  backoff window allows one, so an unreachable aggregator costs at most one
  connect timeout per backoff interval, not per epoch;
* backoff is bounded exponential with jitter (the same policy as the spool
  attach retries in ``sources.SpoolSet``), re-armed by the next success;
* if the spill queue overflows, oldest bodies are dropped and the client
  *resyncs*: the next push is a ``K_FULL`` cumulative keyframe, which the
  aggregator applies by replacement — dropped deltas are subsumed, so the
  fleet totals converge to the truth as soon as connectivity returns;
* outage edges surface as ``PUSH_FAILED`` / ``PUSH_RECOVERED`` events
  through the daemon's event log.

A copy of ``repro.profilerd.push``: the same headers and body bytes, so a
daemon of either package pushes to an aggregator of either.
"""

from __future__ import annotations

import random
import time
import uuid
from collections.abc import Callable, Mapping, Sequence

from repro_torch.core.calltree import CallTree
from repro_torch.core.snapshot import (
    FORMAT_VERSION,
    K_DELTA,
    K_FULL,
    MAGIC,
    _HDR,
    EpochMeta,
    SnapshotCorrupt,
    _encode_payload,
    _frame,
    _parse_segment,
    _StringTable,
)

__all__ = [
    "PUSH_PATH",
    "H_NODE",
    "H_BOOT",
    "H_EPOCH",
    "H_INTERVAL",
    "H_TARGETS",
    "H_DONE",
    "PushClient",
    "decode_push_body",
    "encode_push_body",
    "push_url_for",
]

PUSH_PATH = "/push"

# Node identity + epoch metadata headers.  The binary body stays exactly the
# snapshot codec; everything the aggregator needs *about* the sender is here.
H_NODE = "X-Repro-Node"
H_BOOT = "X-Repro-Boot"  # fresh per client instance: detects node restarts
H_EPOCH = "X-Repro-Epoch"
H_INTERVAL = "X-Repro-Interval"  # expected push cadence (liveness timeout base)
H_TARGETS = "X-Repro-Targets"  # member target names (the node->target hierarchy)
H_DONE = "X-Repro-Done"  # final push of a clean shutdown


def push_url_for(url: str) -> str:
    """Normalize an aggregator URL to its ingest endpoint.

    Accepts ``host:port``, ``http://host:port`` or a full ``.../push``.
    """
    url = url.strip().rstrip("/")
    if "://" not in url:
        url = f"http://{url}"
    if not url.endswith(PUSH_PATH):
        url += PUSH_PATH
    return url


def encode_push_body(kind: int, meta: EpochMeta, tree: CallTree) -> bytes:
    """One self-contained single-record segment: header + framed payload."""
    meta.kind = kind
    payload = _encode_payload(kind, meta, tree, _StringTable())
    return _HDR.pack(MAGIC, FORMAT_VERSION, 0) + _frame(payload)


def decode_push_body(body: bytes) -> tuple[EpochMeta, CallTree]:
    """Decode a push body; raises :class:`SnapshotCorrupt` on anything torn.

    The ring parser tolerates a torn tail (crash-safe append contract); over
    HTTP a torn body means the POST itself is bad, so ``clean`` must hold and
    exactly one record must be present.
    """
    records, clean = _parse_segment(body, "<push body>")
    if not clean:
        raise SnapshotCorrupt("torn or corrupt push body")
    if len(records) != 1:
        raise SnapshotCorrupt(f"push body holds {len(records)} records, want 1")
    meta, tree = records[0]
    if meta.kind not in (K_FULL, K_DELTA):
        raise SnapshotCorrupt(f"push record kind {meta.kind} not pushable")
    return meta, tree


def _default_post(url: str, body: bytes, headers: Mapping[str, str], timeout_s: float) -> int:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=body, headers=dict(headers), method="POST"
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            resp.read()
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


class PushClient:
    """POST sealed epochs to an aggregator; spill + resync through outages."""

    def __init__(
        self,
        url: str,
        node: str,
        *,
        interval_hint_s: float = 5.0,
        keyframe_every: int = 16,
        max_spill_bytes: int = 16 << 20,
        timeout_s: float = 5.0,
        retry_base_s: float = 0.5,
        retry_cap_s: float = 30.0,
        on_event: Callable[[dict], None] | None = None,
        post: Callable[..., int] | None = None,
    ):
        if keyframe_every < 1:
            raise ValueError("keyframe_every must be >= 1")
        self.url = push_url_for(url)
        self.node = node
        self.boot = uuid.uuid4().hex
        self.interval_hint_s = interval_hint_s
        self.keyframe_every = keyframe_every
        self.max_spill_bytes = max_spill_bytes
        self.timeout_s = timeout_s
        self.retry_base_s = retry_base_s
        self.retry_cap_s = retry_cap_s
        self.on_event = on_event
        self._post = post or _default_post
        self.epoch = 0
        self._prev: CallTree | None = None
        self._need_keyframe = True
        # Spill queue: (epoch, headers, body), oldest first.  Bodies are
        # already encoded — an outage costs memory bounded by
        # max_spill_bytes, never re-encoding work.
        self._queue: list[tuple[int, dict, bytes]] = []
        self._queue_bytes = 0
        self._failing_since: float | None = None
        self._attempts = 0
        self._next_attempt = 0.0
        self._last_error = ""
        self.counters = {
            "pushed_epochs": 0,
            "pushed_bytes": 0,
            "spilled": 0,
            "dropped": 0,
            "rejected": 0,
            "failures": 0,
            "recoveries": 0,
        }

    # -- events --------------------------------------------------------------

    def _emit(self, ev: dict) -> None:
        if self.on_event is not None:
            self.on_event(ev)

    # -- encode + enqueue ----------------------------------------------------

    def _headers(self, meta: EpochMeta, targets: Sequence[str], done: bool) -> dict:
        h = {
            "Content-Type": "application/octet-stream",
            H_NODE: self.node,
            H_BOOT: self.boot,
            H_EPOCH: str(meta.epoch),
            H_INTERVAL: f"{self.interval_hint_s:g}",
        }
        if targets:
            h[H_TARGETS] = ",".join(targets)
        if done:
            h[H_DONE] = "1"
        return h

    def push_epoch(
        self,
        tree: CallTree,
        *,
        wall_time: float = 0.0,
        progress: float = 0.0,
        targets: Sequence[str] = (),
        done: bool = False,
    ) -> None:
        """Encode the fleet tree's current epoch and try to deliver it.

        ``tree`` is the node's *cumulative* fleet tree; the client keeps its
        own shadow copy and ships either the delta against it or (on the
        keyframe cadence / after a resync) the full cumulative.  Never raises
        on delivery failure — that is the spill queue's job.
        """
        keyframe = (
            self._need_keyframe
            or self._prev is None
            or self.epoch % self.keyframe_every == 0
        )
        meta = EpochMeta(self.epoch, wall_time, progress)
        if keyframe:
            body = encode_push_body(K_FULL, meta, tree)
        else:
            body = encode_push_body(K_DELTA, meta, tree.diff(self._prev))
        self._prev = tree.copy()
        self._need_keyframe = False
        self._enqueue(meta.epoch, self._headers(meta, targets, done), body)
        self.epoch += 1
        self.flush(force=done)

    def _enqueue(self, epoch: int, headers: dict, body: bytes) -> None:
        self._queue.append((epoch, headers, body))
        self._queue_bytes += len(body)
        while self._queue_bytes > self.max_spill_bytes and len(self._queue) > 1:
            _, _, dropped = self._queue.pop(0)
            self._queue_bytes -= len(dropped)
            self.counters["dropped"] += 1
            # Dropped deltas are unrecoverable individually, but the next
            # keyframe's cumulative subsumes them — force one.
            self._need_keyframe = True

    # -- delivery ------------------------------------------------------------

    def _backoff(self, now: float) -> None:
        self._attempts += 1
        delay = min(self.retry_cap_s, self.retry_base_s * (2 ** (self._attempts - 1)))
        self._next_attempt = now + delay * random.uniform(0.8, 1.2)

    def flush(self, force: bool = False) -> bool:
        """Drain the spill queue in order while the aggregator accepts.

        Returns True when the queue emptied.  ``force`` ignores the backoff
        window (one extra attempt) — used for the final ``done`` push so a
        clean shutdown gets its last epoch out even mid-outage.
        """
        now = time.monotonic()
        if self._queue and not force and now < self._next_attempt:
            self.counters["spilled"] = len(self._queue)
            return False
        while self._queue:
            epoch, headers, body = self._queue[0]
            try:
                code = self._post(self.url, body, headers, self.timeout_s)
            except OSError as e:
                self._delivery_failed(str(e))
                return False
            if code == 200:
                self._queue.pop(0)
                self._queue_bytes -= len(body)
                self.counters["pushed_epochs"] += 1
                self.counters["pushed_bytes"] += len(body)
                if self._failing_since is not None:
                    self._recovered()
                continue
            if 400 <= code < 500:
                # The aggregator understood us and said no (corrupt frame,
                # body too large): retrying the same bytes cannot succeed.
                # Drop it, resync via keyframe, and keep draining.
                self._queue.pop(0)
                self._queue_bytes -= len(body)
                self.counters["rejected"] += 1
                self._need_keyframe = True
                self._emit(
                    {"kind": "PUSH_REJECTED", "url": self.url, "epoch": epoch,
                     "http_status": code, "wall_time": time.time()}
                )
                continue
            self._delivery_failed(f"HTTP {code}")
            return False
        self.counters["spilled"] = 0
        return True

    def _delivery_failed(self, error: str) -> None:
        now = time.monotonic()
        self.counters["failures"] += 1
        self.counters["spilled"] = len(self._queue)
        self._last_error = error
        self._backoff(now)
        if self._failing_since is None:
            self._failing_since = now
            self._emit(
                {"kind": "PUSH_FAILED", "url": self.url, "error": error,
                 "spilled": len(self._queue), "wall_time": time.time()}
            )

    def _recovered(self) -> None:
        outage_s = time.monotonic() - (self._failing_since or time.monotonic())
        self._failing_since = None
        self._attempts = 0
        self._next_attempt = 0.0
        self.counters["recoveries"] += 1
        self._emit(
            {"kind": "PUSH_RECOVERED", "url": self.url,
             "outage_s": round(outage_s, 3), "wall_time": time.time()}
        )

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        return {
            "url": self.url,
            "node": self.node,
            "boot": self.boot,
            "epoch": self.epoch,
            "failing": self._failing_since is not None,
            "last_error": self._last_error,
            "queue_epochs": len(self._queue),
            "queue_bytes": self._queue_bytes,
            **self.counters,
        }
