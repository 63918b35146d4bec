"""IngestPipeline — one object for the decode -> accumulate -> seal path.

Before this module the per-record ``drain -> Decoder.feed -> ingest(sample)``
loop was written out by every consumer of a spool byte stream (the daemon's
:class:`~repro_torch.profilerd.sources.SpoolSource`, the throughput benchmarks,
half the test suite).  :class:`IngestPipeline` owns that composition — reader
+ decoder + ingestor + sealer + stats — behind four calls:

* :meth:`IngestPipeline.feed`        — bytes in, non-sample events out
  (samples are ingested internally, batched when possible);
* :meth:`IngestPipeline.drain_chunk` — one bounded reader chunk through
  :meth:`feed`;
* :meth:`IngestPipeline.seal_epoch`  — drain the ingestor's epoch dirty list
  into the timeline ring;
* :meth:`IngestPipeline.reset_stream`— writer re-attach: fresh decoder, every
  ``stack_id``-keyed cache dropped, loss counters carried over.

Batch vs per-sample is selected at construction: when numpy is importable
(and ``vectorized`` was not forced off) the pipeline routes chunks through
``Decoder.feed_batch`` + ``TreeIngestor.ingest_batch``; otherwise it runs
the scalar path — the documented fallback for v1 records, unknown stack ids
and numpy-free installs (v1/unknown records take the scalar core *inside*
the batch path too; the construction-time switch only disables the
vectorized fast lane).  The choice is surfaced as ``ingest_stats.vectorized``
and the daemon logs one ``INGEST_SCALAR_FALLBACK`` event on attach when the
fast lane is unavailable.

The unified ``ingest_stats`` schema
-----------------------------------

Every surface that reports ingest progress — ``TreeIngestor.stats()``,
``SpoolSource.status_row()["ingest"]``, daemon ``status.json``, ``/status``
and ``top`` — now renders this one dict:

=================== =========================================================
key                 meaning
=================== =========================================================
vectorized          True when this pipeline runs the numpy batch fast lane
samples             samples ingested (scalar + batch)
fast_hits           samples served by the cached-chain fast path
slow_ingests        samples that resolved symbols / built a chain
batch_samples       samples that arrived inside a ``SampleBatch``
batch_chunks        ``SampleBatch`` objects ingested
cached_paths        live ``(thread, stack_id) -> chain`` cache entries
unknown_stack_refs  samples whose interned stack was never seen (re-attach)
degraded_stackdefs  STACKDEFs dropped for lack of delta context (re-attach)
=================== =========================================================

``merge_ingest_stats`` sums rows across sources for fleet-level views and
``format_ingest_stats`` renders one human line for ``top``.
"""

from __future__ import annotations

from collections import deque
from collections.abc import Sequence

from repro_torch.core.snapshot import CountSealer, EpochMeta, TimelineWriter

from .ingest import TreeIngestor
from .resolver import SymbolResolver
from .wire import Decoder, Event, RawSample, SampleBatch, numpy_available

INGEST_STATS_KEYS = (
    "vectorized",
    "samples",
    "fast_hits",
    "slow_ingests",
    "batch_samples",
    "batch_chunks",
    "cached_paths",
    "unknown_stack_refs",
    "degraded_stackdefs",
)


class IngestPipeline:
    """Reader + decoder + ingestor + sealer + stats, one object.

    Every component is injectable (tests swap trees and sealers freely); the
    defaults compose the production path.  ``reader`` is optional — a
    pipeline can be fed bytes directly via :meth:`feed` (benchmarks, tests,
    socket transports).
    """

    def __init__(
        self,
        reader=None,
        *,
        decoder: Decoder | None = None,
        ingestor: TreeIngestor | None = None,
        resolver: SymbolResolver | None = None,
        collapse_origins: Sequence[str] = (),
        timeline_writer: TimelineWriter | None = None,
        metric: str = "samples",
        vectorized: bool | None = None,
        depth_timeline: deque | None = None,
    ):
        self.reader = reader
        self.decoder = decoder if decoder is not None else Decoder()
        self.ingestor = (
            ingestor
            if ingestor is not None
            else TreeIngestor(resolver=resolver, collapse_origins=collapse_origins)
        )
        self.tree = self.ingestor.tree
        self.resolver = self.ingestor.resolver
        self.sealer: CountSealer | None = None
        if timeline_writer is not None:
            self.sealer = CountSealer(self.tree, timeline_writer, metric)
        # Batch vs per-sample is decided once, here: auto-detect on None,
        # and an explicit True still degrades gracefully when numpy is
        # missing (the flag reports what actually runs, never the wish).
        avail = numpy_available()
        self.vectorized = avail if vectorized is None else bool(vectorized) and avail
        # (t, depth) pairs for status depth sparklines; callers may pass
        # their own bounded deque to share it across surfaces.
        self.depth_timeline: deque = depth_timeline if depth_timeline is not None else deque(maxlen=2048)
        self.samples = 0
        # Loss counters carried across decoder incarnations (re-attach).
        self._unknown_refs_base = 0
        self._degraded_defs_base = 0

    # -- ingest ------------------------------------------------------------

    def feed(self, data: bytes) -> list[Event]:
        """Decode + ingest one chunk of stream bytes.

        Samples (batched or scalar) are merged into the tree and the depth
        timeline here; everything the caller owns policy for — ``Hello``,
        ``Rusage``, ``Bye`` — is returned, in stream order.
        """
        events: list[Event] = []
        ing = self.ingestor
        tl = self.depth_timeline
        cap = tl.maxlen
        if self.vectorized:
            for item in self.decoder.feed_batch(data):
                if type(item) is SampleBatch:
                    depths = ing.ingest_batch(item)
                    self.samples += len(item)
                    ts = item.t
                    if cap is not None and len(ts) > cap:
                        ts = ts[-cap:]
                        depths = depths[-cap:]
                    tl.extend(zip(ts.tolist(), depths.tolist(), strict=True))
                elif type(item) is RawSample:
                    tl.append((item.t, ing.ingest(item)))
                    self.samples += 1
                else:
                    events.append(item)
        else:
            for ev in self.decoder.feed(data):
                if type(ev) is RawSample:
                    tl.append((ev.t, ing.ingest(ev)))
                    self.samples += 1
                else:
                    events.append(ev)
        return events

    def drain_chunk(self) -> tuple[int, list[Event]]:
        """One bounded reader chunk through :meth:`feed`; returns
        ``(bytes_drained, events)``."""
        chunk = self.reader.read()
        if not chunk:
            return 0, []
        return len(chunk), self.feed(chunk)

    # -- lifecycle ---------------------------------------------------------

    def reset_stream(self, decoder: Decoder | None = None) -> None:
        """Writer re-attach: the restarted target re-assigns ids from 0, so
        the decoder and every ``stack_id``-keyed cache must die together.
        Loss counters fold into the pipeline so totals survive."""
        self._unknown_refs_base += self.decoder.unknown_stack_refs
        self._degraded_defs_base += self.decoder.degraded_stackdefs
        self.decoder = decoder if decoder is not None else Decoder()
        self.resolver.reset_interned()
        self.ingestor.reset_chain_cache()

    def seal_epoch(self, wall_time: float = 0.0) -> tuple[EpochMeta | None, list]:
        """Drain the epoch dirty list into the ring; returns
        ``(meta, entries)`` (entries for trend windows etc.), or
        ``(None, [])`` when no sealer is configured."""
        if self.sealer is None:
            return None, []
        entries, untracked = self.ingestor.drain_epoch()
        meta = self.sealer.seal(entries, wall_time=wall_time, untracked=untracked)
        return meta, entries

    # -- stats -------------------------------------------------------------

    @property
    def unknown_stack_refs(self) -> int:
        return self._unknown_refs_base + self.decoder.unknown_stack_refs

    @property
    def degraded_stackdefs(self) -> int:
        return self._degraded_defs_base + self.decoder.degraded_stackdefs

    def ingest_stats(self) -> dict:
        """The unified ``ingest_stats`` dict (schema in the module doc)."""
        stats = self.ingestor.stats()
        stats["vectorized"] = self.vectorized
        stats["samples"] = self.samples
        stats["unknown_stack_refs"] = self.unknown_stack_refs
        stats["degraded_stackdefs"] = self.degraded_stackdefs
        return stats


def merge_ingest_stats(rows: Sequence[dict]) -> dict:
    """Sum ``ingest_stats`` rows across sources (fleet ``status.json``).

    ``vectorized`` is AND-ed: it answers "is the whole fleet on the fast
    lane" — with no sources yet it reports plain availability."""
    merged = dict.fromkeys(INGEST_STATS_KEYS, 0)
    merged["vectorized"] = all(r.get("vectorized", False) for r in rows) if rows else numpy_available()
    for r in rows:
        for k in INGEST_STATS_KEYS:
            if k != "vectorized":
                merged[k] += r.get(k, 0)
    return merged


def format_ingest_stats(stats: dict) -> str:
    """One ``top``-style line for an ``ingest_stats`` dict."""
    lane = "vectorized" if stats.get("vectorized") else "scalar"
    line = (
        f"ingest[{lane}]: samples={stats.get('samples', 0)} "
        f"fast={stats.get('fast_hits', 0)} slow={stats.get('slow_ingests', 0)} "
        f"batched={stats.get('batch_samples', 0)}/{stats.get('batch_chunks', 0)} "
        f"cached={stats.get('cached_paths', 0)}"
    )
    lost = stats.get("unknown_stack_refs", 0)
    degraded = stats.get("degraded_stackdefs", 0)
    if lost or degraded:
        line += f" unknown={lost} degraded_defs={degraded}"
    return line
