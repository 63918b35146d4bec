"""Compact binary snapshots + on-disk timeline ring for :class:`CallTree`: a
copy of ``repro.core.snapshot``, byte for byte the same format.

The daemon's live tree answers "where is time going *now*", but the paper's
headline case studies (coherence livelock forensics, CPU-model comparisons)
need the *time evolution* of the tree and *differences* across runs.  This
module provides the storage layer for both:

* **Snapshot codec** — a versioned, CRC-framed binary encoding of a
  ``CallTree``.  Strings (frame names *and* metric keys) are interned per
  segment, integers are LEB128 varints, and an epoch record encodes only the
  **delta against the previous epoch** (changed nodes, changed metric keys),
  so steady-state epochs cost bytes proportional to the window's activity,
  not to the accumulated tree.

* **Timeline ring** (:class:`TimelineWriter` / :class:`TimelineReader`) — a
  directory of segment files, each opening with a *keyframe* (a full
  snapshot) followed by delta epochs.  Retention is bounded by dropping whole
  segments (oldest first); because every segment is self-contained
  (keyframe + per-segment string table), dropped history never breaks decode.
  Appends are crash-safe: every record carries a length + CRC32 header, a
  torn tail is detected and ignored on read, and the next segment's keyframe
  resynchronizes the cumulative state.

* **Epoch sealer** (:class:`EpochSealer`) — the daemon-side producer.  It
  keeps a per-node "last sealed" shadow value and, fed the set of node chains
  the ingestor touched during the epoch (see
  :meth:`repro_torch.profilerd.ingest.TreeIngestor.drain_epoch`), builds the delta
  in O(touched paths) — the live tree is never walked in full on the epoch
  cadence, which is what keeps sealing under the <5 % ingest-overhead budget
  (the JAX package's ``benchmarks/timeline_overhead.py``).

Single snapshots (CI baselines, ``profilerd check``) use the same format via
:func:`save_snapshot` / :func:`load_snapshot` — one keyframe record in a file.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from collections.abc import Iterator, Sequence

from .calltree import CallNode, CallTree

MAGIC = b"RTL1"
FORMAT_VERSION = 1

K_FULL = 1  # absolute snapshot (keyframe)
K_DELTA = 2  # generic tree delta vs the previous epoch record
K_COUNTS = 3  # samples-plane delta: (interned root->leaf path, count) pairs

_HDR = struct.Struct("<4sHH")  # magic, format version, reserved
_REC = struct.Struct("<II")  # payload length, crc32(payload)
_F64 = struct.Struct("<d")

SEGMENT_SUFFIX = ".tl"
SNAPSHOT_SUFFIX = ".snap"


class SnapshotError(RuntimeError):
    pass


class SnapshotCorrupt(SnapshotError):
    """Bad magic, CRC mismatch, or a payload that does not parse."""


class SnapshotVersionError(SnapshotError):
    """The file announces a format version newer than this reader."""


@dataclass
class EpochMeta:
    """Per-epoch header: when it was sealed and how far the target had got.

    ``progress`` is a monotonically non-decreasing counter whose *stall*
    distinguishes a livelock from plain dominance (the daemon uses the number
    of distinct call-sites ever sealed; see ``core.detector.TrendDetector``).
    """

    epoch: int
    wall_time: float = 0.0
    progress: float = 0.0
    kind: int = K_DELTA


# -- varints ----------------------------------------------------------------


def _wv(out: bytearray, v: int) -> None:
    """Append one unsigned LEB128 varint (fast path: single byte)."""
    if v < 0x80:
        out.append(v)
        return
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return


def _rv(buf: bytes, off: int) -> tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = buf[off]
        off += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, off
        shift += 7


class _StringTable:
    """Encoder-side intern table; fresh strings ride in the record payload."""

    def __init__(self) -> None:
        self._ids: dict[str, int] = {}
        self._fresh: list[str] = []

    def id(self, s: str) -> int:
        sid = self._ids.get(s)
        if sid is None:
            sid = len(self._ids)
            self._ids[s] = sid
            self._fresh.append(s)
        return sid

    def drain_fresh(self) -> list[str]:
        fresh, self._fresh = self._fresh, []
        return fresh


# -- payload codec ----------------------------------------------------------


def _enc_node(node: CallNode, tab: _StringTable, out: bytearray) -> None:
    # Keyframe hot path: one call per tree node, so the string-table lookup
    # and the (almost always single-byte) varints are inlined — a 15k-node
    # keyframe has ~90k of each, and call overhead would dominate otherwise.
    ids = tab._ids
    fresh = tab._fresh
    pack = _F64.pack
    append = out.append

    def enc(node: CallNode) -> None:
        v = ids.get(node.name)
        if v is None:
            v = len(ids)
            ids[node.name] = v
            fresh.append(node.name)
        if v < 0x80:
            append(v)
        else:
            _wv(out, v)
        for metrics in (node.metrics, node.self_metrics):
            n = len(metrics)
            if n < 0x80:
                append(n)
            else:
                _wv(out, n)
            for k, val in metrics.items():
                kid = ids.get(k)
                if kid is None:
                    kid = len(ids)
                    ids[k] = kid
                    fresh.append(k)
                if kid < 0x80:
                    append(kid)
                else:
                    _wv(out, kid)
                out.extend(pack(val))
        kids = node.children
        n = len(kids)
        if n < 0x80:
            append(n)
        else:
            _wv(out, n)
        for c in kids.values():
            enc(c)

    enc(node)


def _payload_head(kind: int, meta: EpochMeta, tab: _StringTable, body: bytes) -> bytes:
    """Assemble kind + meta + the string defs the body freshly interned."""
    head = bytearray()
    head.append(kind)
    _wv(head, meta.epoch)
    head += _F64.pack(meta.wall_time)
    head += _F64.pack(meta.progress)
    fresh = tab.drain_fresh()
    _wv(head, len(fresh))
    for s in fresh:
        raw = s.encode()
        _wv(head, len(raw))
        head += raw
    return bytes(head) + body


def _encode_payload(kind: int, meta: EpochMeta, tree: CallTree, tab: _StringTable) -> bytes:
    nodes = bytearray()
    _enc_node(tree.root, tab, nodes)  # interns names/metric keys, may add fresh
    return _payload_head(kind, meta, tab, bytes(nodes))


def _encode_counts_payload(
    meta: EpochMeta,
    items,  # iterable of (chain, count); chain = [root, ...nodes] CallNode refs
    tab: _StringTable,
    path_tab: dict[int, int],
    metric: str,
) -> bytes:
    """Encode one samples-plane epoch as interned path counts.

    This is the daemon's sealing fast path: one table lookup and two varints
    per *touched chain* (not per node), so a dense steady-state epoch seals in
    O(chains).  A chain's root->leaf name path crosses the wire once per
    segment (``path_tab`` maps ``id(chain)`` -> path id); the caller must keep
    the chain objects alive for the lifetime of the table (the ingestor's
    chain cache does).
    """
    defs = bytearray()
    counts = bytearray()
    n_defs = 0
    n_counts = 0
    ids = tab._ids
    fresh = tab._fresh
    dappend = defs.append
    for chain, count in items:
        if count <= 0:
            continue
        pid = path_tab.get(id(chain))
        if pid is None:
            pid = len(path_tab)
            path_tab[id(chain)] = pid
            _wv(defs, len(chain) - 1)
            for node in chain[1:]:
                nid = ids.get(node.name)
                if nid is None:
                    nid = len(ids)
                    ids[node.name] = nid
                    fresh.append(node.name)
                if nid < 0x80:
                    dappend(nid)
                else:
                    _wv(defs, nid)
            n_defs += 1
        _wv(counts, pid)
        _wv(counts, int(count))
        n_counts += 1
    body = bytearray()
    _wv(body, tab.id(metric))
    _wv(body, n_defs)
    body += defs
    _wv(body, n_counts)
    body += counts
    return _payload_head(K_COUNTS, meta, tab, bytes(body))


def _apply_node(buf: bytes, off: int, strings: list[str], parent: CallNode | None, tree: CallTree) -> int:
    nid, off = _rv(buf, off)
    if parent is None:
        node = tree.root  # the encoded root name is canonical; keep ours
    else:
        node = parent.child(strings[nid])
    nm, off = _rv(buf, off)
    m = node.metrics
    for _ in range(nm):
        kid, off = _rv(buf, off)
        (v,) = _F64.unpack_from(buf, off)
        off += _F64.size
        k = strings[kid]
        m[k] = m.get(k, 0.0) + v
    ns, off = _rv(buf, off)
    s = node.self_metrics
    for _ in range(ns):
        kid, off = _rv(buf, off)
        (v,) = _F64.unpack_from(buf, off)
        off += _F64.size
        k = strings[kid]
        s[k] = s.get(k, 0.0) + v
    nc, off = _rv(buf, off)
    for _ in range(nc):
        off = _apply_node(buf, off, strings, node, tree)
    return off


def _decode_payload(
    payload: bytes, strings: list[str], paths: list[list[str]] | None = None
) -> tuple[EpochMeta, CallTree]:
    if paths is None:
        paths = []
    try:
        kind = payload[0]
        if kind not in (K_FULL, K_DELTA, K_COUNTS):
            raise SnapshotCorrupt(f"unknown record kind {kind}")
        epoch, off = _rv(payload, 1)
        (wall_time,) = _F64.unpack_from(payload, off)
        off += _F64.size
        (progress,) = _F64.unpack_from(payload, off)
        off += _F64.size
        n_fresh, off = _rv(payload, off)
        for _ in range(n_fresh):
            ln, off = _rv(payload, off)
            strings.append(payload[off : off + ln].decode("utf-8", "replace"))
            off += ln
        tree = CallTree()
        if kind == K_COUNTS:
            mid, off = _rv(payload, off)
            metric = strings[mid]
            n_defs, off = _rv(payload, off)
            for _ in range(n_defs):
                n_names, off = _rv(payload, off)
                path = []
                for _ in range(n_names):
                    nid, off = _rv(payload, off)
                    path.append(strings[nid])
                paths.append(path)
            n_counts, off = _rv(payload, off)
            for _ in range(n_counts):
                pid, off = _rv(payload, off)
                count, off = _rv(payload, off)
                tree.add_stack(paths[pid], {metric: float(count)})
        else:
            off = _apply_node(payload, off, strings, None, tree)
        if off != len(payload):
            raise SnapshotCorrupt(f"{len(payload) - off} trailing bytes in record")
    except (IndexError, struct.error) as e:
        raise SnapshotCorrupt(f"truncated record payload: {e}") from None
    return EpochMeta(epoch, wall_time, progress, kind), tree


def _frame(payload: bytes) -> bytes:
    return _REC.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


def _check_header(data: bytes, path: str) -> None:
    if len(data) < _HDR.size:
        raise SnapshotCorrupt(f"{path}: truncated header")
    magic, version, _ = _HDR.unpack_from(data, 0)
    if magic != MAGIC:
        raise SnapshotCorrupt(f"{path}: bad magic {magic!r}")
    if version > FORMAT_VERSION:
        raise SnapshotVersionError(
            f"{path}: format version {version} > supported {FORMAT_VERSION}"
        )


def _parse_segment(data: bytes, path: str) -> tuple[list[tuple[EpochMeta, CallTree]], bool]:
    """Decode a segment's records; ``clean`` is False at a torn/corrupt tail.

    Corruption never raises here (crash-safe append contract): a torn or
    bad header yields no records, and decoding stops at the first bad record
    — everything after it is untrusted — with the next segment's keyframe
    resynchronizing the cumulative state.  Version skew still raises: a
    newer-format segment is not corruption and must refuse loudly.
    """
    try:
        _check_header(data, path)
    except SnapshotVersionError:
        raise
    except SnapshotCorrupt:
        return [], False  # e.g. crash between segment open() and header write
    strings: list[str] = []
    paths: list[list[str]] = []
    out: list[tuple[EpochMeta, CallTree]] = []
    off = _HDR.size
    while off < len(data):
        if len(data) - off < _REC.size:
            return out, False  # torn length header: crash mid-append
        n, crc = _REC.unpack_from(data, off)
        start = off + _REC.size
        if start + n > len(data):
            return out, False  # torn payload
        payload = data[start : start + n]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return out, False
        try:
            out.append(_decode_payload(payload, strings, paths))
        except SnapshotCorrupt:
            return out, False
        off = start + n
    return out, True


# -- single-snapshot files --------------------------------------------------


def save_snapshot(tree: CallTree, path: str, meta: EpochMeta | None = None) -> str:
    """Write one full snapshot (CI baselines, ``profilerd check`` refs).

    Defaults are deterministic (no wall clock) so a committed baseline file is
    byte-reproducible from the same tree.
    """
    meta = meta or EpochMeta(0)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    payload = _encode_payload(K_FULL, meta, tree, _StringTable())
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_HDR.pack(MAGIC, FORMAT_VERSION, 0))
        f.write(_frame(payload))
    os.replace(tmp, path)
    return path


def load_snapshot(path: str) -> tuple[EpochMeta, CallTree]:
    with open(path, "rb") as f:
        data = f.read()
    _check_header(data, path)
    if len(data) < _HDR.size + _REC.size:
        raise SnapshotCorrupt(f"{path}: no record")
    n, crc = _REC.unpack_from(data, _HDR.size)
    start = _HDR.size + _REC.size
    payload = data[start : start + n]
    if len(payload) < n or zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise SnapshotCorrupt(f"{path}: record CRC mismatch")
    meta, tree = _decode_payload(payload, [])
    return meta, tree


# -- timeline ring ----------------------------------------------------------


class TimelineWriter:
    """Append epochs into a bounded ring of self-contained segment files.

    Every segment starts with a keyframe (full snapshot) and a fresh string
    table, so retention can unlink whole old segments without breaking the
    survivors.  A write failure poisons only the current segment: the next
    append opens a new one with a keyframe.

    A writer owns its directory for one run: any segments left by a previous
    run are removed before the first segment is written (epoch numbering
    restarts, so stale segments would otherwise shadow or extend the new
    ring and a reader could silently reconstruct the *old* run's tree).
    The purge is deferred to the first write so that merely constructing a
    writer — e.g. a daemon whose attach then times out — cannot destroy the
    previous run's history.

    ``preserve=True`` opts out of the purge for writers that *continue* a
    ring across process restarts (the regional aggregator recovers its state
    from the ring and keeps epoch numbering monotonic, so the old segments
    stay valid history); retention still unlinks the oldest segments past
    ``max_segments``.
    """

    def __init__(
        self,
        dir_path: str,
        epochs_per_segment: int = 16,
        max_segments: int = 64,
        fsync: bool = False,
        preserve: bool = False,
    ):
        if epochs_per_segment < 1 or max_segments < 1:
            raise ValueError("epochs_per_segment and max_segments must be >= 1")
        self.dir = dir_path
        self.epochs_per_segment = epochs_per_segment
        self.max_segments = max_segments
        self.fsync = fsync
        os.makedirs(dir_path, exist_ok=True)
        self._purged = preserve
        self._f = None
        self._tab = _StringTable()
        self._path_tab: dict[int, int] = {}  # id(chain) -> per-segment path id
        self._records = 0
        self.epochs_written = 0

    def needs_keyframe(self) -> bool:
        return self._f is None or self._records >= self.epochs_per_segment

    def append_full(self, tree: CallTree, meta: EpochMeta) -> None:
        """Rotate to a new segment and write ``tree`` as its keyframe."""
        self._rotate(meta.epoch)
        self._write(_encode_payload(K_FULL, meta, tree, self._tab))

    def append_delta(self, delta: CallTree, meta: EpochMeta) -> None:
        """Append one delta epoch to the open segment (keyframe must exist)."""
        if self._f is None:
            raise SnapshotError("no open segment: write a keyframe first")
        self._write(_encode_payload(K_DELTA, meta, delta, self._tab))

    def append_counts(self, items, meta: EpochMeta, metric: str = "samples") -> None:
        """Append one epoch of ``(chain, count)`` pairs (the sealing fast path).

        Chains must stay alive while the segment is open (path ids key on
        ``id(chain)``); the ingestor's chain cache guarantees that.
        """
        if self._f is None:
            raise SnapshotError("no open segment: write a keyframe first")
        self._write(_encode_counts_payload(meta, items, self._tab, self._path_tab, metric))

    def _rotate(self, epoch: int) -> None:
        self.close()
        if not self._purged:
            for stale in list_segments(self.dir):
                try:
                    os.unlink(stale)
                except OSError:
                    pass
            self._purged = True
        path = os.path.join(self.dir, f"seg-{epoch:010d}{SEGMENT_SUFFIX}")
        self._f = open(path, "wb")
        self._f.write(_HDR.pack(MAGIC, FORMAT_VERSION, 0))
        self._f.flush()
        self._tab = _StringTable()
        self._path_tab = {}
        self._records = 0
        segs = list_segments(self.dir)
        for old in segs[: max(0, len(segs) - self.max_segments)]:
            try:
                os.unlink(old)
            except OSError:
                pass

    def _write(self, payload: bytes) -> None:
        try:
            self._f.write(_frame(payload))
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
        except OSError:
            # Poisoned segment: drop it from the writer; the next append
            # keyframes into a fresh file and the reader's CRC check skips
            # whatever half-record landed here.
            self.close()
            raise
        self._records += 1
        self.epochs_written += 1

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            finally:
                self._f = None


def list_segments(dir_path: str) -> list[str]:
    try:
        names = os.listdir(dir_path)
    except OSError:
        return []
    return [
        os.path.join(dir_path, n)
        for n in sorted(names)
        if n.startswith("seg-") and n.endswith(SEGMENT_SUFFIX)
    ]


def is_timeline_dir(path: str) -> bool:
    return os.path.isdir(path) and bool(list_segments(path))


class TimelineReader:
    """Replay a timeline ring: per-epoch windows plus the running cumulative.

    ``epochs()`` yields ``(meta, window, cumulative)``; ``cumulative`` is the
    reader's live accumulator (copy it to retain across iterations).  A torn
    or corrupt record ends its segment (``truncated`` is set); the next
    segment's keyframe resynchronizes the cumulative state.
    """

    def __init__(self, dir_path: str):
        self.dir = dir_path
        self.truncated = False

    def epochs(self) -> Iterator[tuple[EpochMeta, CallTree, CallTree]]:
        cum = CallTree()
        seen_any = False
        for seg in list_segments(self.dir):
            try:
                with open(seg, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            records, clean = _parse_segment(data, seg)
            if not clean:
                self.truncated = True
            for meta, tree in records:
                if meta.kind == K_FULL:
                    window = tree.diff(cum) if seen_any else tree.copy()
                    cum = tree
                else:
                    window = tree
                    cum.merge(tree)
                seen_any = True
                yield meta, window, cum

    def last(self) -> tuple[EpochMeta, CallTree] | None:
        """Final ``(meta, cumulative)`` without replaying the whole ring.

        Every segment opens with a keyframe, so the final cumulative depends
        only on the newest segment holding decodable records — scan segments
        from the end instead of decoding up to ``max_segments`` of history.
        """
        for seg in reversed(list_segments(self.dir)):
            try:
                with open(seg, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            records, clean = _parse_segment(data, seg)
            if not clean:
                self.truncated = True
            if not records:
                continue
            if records[0][0].kind != K_FULL:
                break  # non-keyframe segment start: fall back to a full replay
            cum: CallTree | None = None
            for meta, tree in records:
                if meta.kind == K_FULL:
                    cum = tree
                else:
                    cum.merge(tree)
            return records[-1][0], cum
        out = None
        for meta, _window, cum in self.epochs():
            out = (meta, cum)
        return out  # cum is final: safe to hand out without a copy


def read_epochs(dir_path: str, copy_cumulative: bool = False) -> list[tuple[EpochMeta, CallTree, CallTree]]:
    """Materialize a timeline (small histories; prefer the iterator for big ones)."""
    reader = TimelineReader(dir_path)
    out = []
    for meta, window, cum in reader.epochs():
        out.append((meta, window, cum.copy() if copy_cumulative else cum))
    return out


# -- epoch sealing ----------------------------------------------------------


class EpochSealer:
    """Seal the live tree's epoch windows into a :class:`TimelineWriter`.

    Keeps a per-node shadow of the last sealed metric values; the delta for
    an epoch is computed only over the node chains the ingestor touched
    (O(touched paths), not O(tree)).  Keyframes (segment rotation) and the
    untracked fallback (legacy v1 samples mutate the tree outside the chain
    cache) do a full-tree resync.
    """

    def __init__(self, tree: CallTree, writer: TimelineWriter | None = None):
        self.tree = tree
        self.writer = writer
        self.epoch = 0
        # id(node) -> (node ref, sealed metrics, sealed self-metrics).  The
        # node ref pins the object so ids can never be recycled under us.
        self._sealed: dict[int, tuple[CallNode, dict, dict]] = {}

    @property
    def node_count(self) -> int:
        """Distinct call-sites ever sealed — the default progress metric."""
        return len(self._sealed)

    def _delta_vs_sealed(self, real: CallNode) -> tuple[dict, dict]:
        cur_m = dict(real.metrics)
        cur_s = dict(real.self_metrics)
        ent = self._sealed.get(id(real))
        self._sealed[id(real)] = (real, cur_m, cur_s)
        if ent is None:
            return dict(cur_m), dict(cur_s)
        _, pm, ps = ent
        dm = {k: v - pm.get(k, 0.0) for k, v in cur_m.items() if v != pm.get(k, 0.0)}
        ds = {k: v - ps.get(k, 0.0) for k, v in cur_s.items() if v != ps.get(k, 0.0)}
        return dm, ds

    def _delta_from_chains(self, chains: Sequence[Sequence[CallNode]]) -> CallTree:
        root_real = self.tree.root
        mirror_root = CallNode(root_real.name)
        mirrors: dict[int, CallNode] = {id(root_real): mirror_root}
        order: list[CallNode] = [root_real]
        for chain in chains:
            parent = mirror_root
            for node in chain[1:]:
                m = mirrors.get(id(node))
                if m is None:
                    m = CallNode(node.name)
                    parent.children[node.name] = m
                    mirrors[id(node)] = m
                    order.append(node)
                parent = m
        for real in order:
            dm, ds = self._delta_vs_sealed(real)
            mirror = mirrors[id(real)]
            mirror.metrics = dm
            mirror.self_metrics = ds
        return CallTree(mirror_root)

    def _delta_full_walk(self) -> CallTree:
        def rec(real: CallNode) -> CallNode | None:
            dm, ds = self._delta_vs_sealed(real)
            kids = {}
            for name, c in real.children.items():
                mc = rec(c)
                if mc is not None:
                    kids[name] = mc
            if not dm and not ds and not kids:
                return None
            node = CallNode(real.name, dm, ds)
            node.children = kids
            return node

        node = rec(self.tree.root)
        return CallTree(node if node is not None else CallNode(CallTree.ROOT))

    def _resync_all(self) -> None:
        for _path, node in self.tree.root.walk():
            self._sealed[id(node)] = (node, dict(node.metrics), dict(node.self_metrics))

    def seal(
        self,
        chains: Sequence[Sequence[CallNode]] | None = None,
        *,
        wall_time: float = 0.0,
        progress: float | None = None,
        full_walk: bool = False,
    ) -> tuple[EpochMeta, CallTree]:
        """Seal one epoch; returns ``(meta, window_delta_tree)``.

        ``chains`` is the ingestor's dirty set for the epoch; ``full_walk``
        forces the O(tree) diff (required whenever mutations bypassed the
        chain cache).  The window delta is returned even when the record
        written is a keyframe, so detectors always see per-epoch activity.
        """
        if chains is None or full_walk:
            delta = self._delta_full_walk()
        else:
            delta = self._delta_from_chains(chains)
        meta = EpochMeta(
            self.epoch,
            wall_time,
            float(len(self._sealed)) if progress is None else progress,
        )
        if self.writer is not None:
            if self.writer.needs_keyframe():
                meta.kind = K_FULL
                self.writer.append_full(self.tree, meta)
                self._resync_all()
            else:
                self.writer.append_delta(delta, meta)
        self.epoch += 1
        return meta, delta


class CountSealer:
    """Samples-plane epoch sealer: O(touched chains) per epoch, no tree walk.

    The generic :class:`EpochSealer` diffs *nodes*, which a dense steady-state
    epoch turns into an O(tree) walk with per-node dict copies — two orders of
    magnitude over the <5 % ingest-overhead budget.  The daemon's host plane
    only ever bumps whole-sample counts along cached chains, so its epoch
    delta is fully described by ``(chain, hit count)`` pairs, which the
    ingestor already maintains — one integer add per sample on the scalar
    path, one *aggregated* add per ``(thread, stack)`` group on the
    vectorized batch path (``TreeIngestor.ingest_batch``): either way the
    entries arrive here pre-summed, there is no per-hit work at seal time.
    Sealing then writes a :data:`K_COUNTS` record: two varints per touched
    chain, with counts coerced through ``int()`` so numpy integers from the
    batch lane encode identically to Python ints.

    Keyframes (segment rotation) still write a full snapshot; mutations that
    bypass the chain cache (legacy v1 samples, cache overflow) force an early
    keyframe, because a counts record could not describe them.
    """

    def __init__(self, tree: CallTree, writer: TimelineWriter, metric: str = "samples"):
        self.tree = tree
        self.writer = writer
        self.metric = metric
        self.epoch = 0
        # Every chain ever sealed, pinned so path-table ids(chain) stay valid
        # and to serve as the progress counter (distinct stacks ever seen —
        # a livelocked target stops minting new ones).
        self._seen: dict[int, object] = {}

    @property
    def node_count(self) -> int:
        """Distinct stacks ever sealed — the default progress metric."""
        return len(self._seen)

    def seal(
        self,
        entries,  # ingestor epoch entries: [chain, depth, stamp, count]
        *,
        wall_time: float = 0.0,
        progress: float | None = None,
        untracked: bool = False,
    ) -> EpochMeta:
        seen = self._seen
        for e in entries:
            chain = e[0]
            if id(chain) not in seen:
                seen[id(chain)] = chain
        meta = EpochMeta(
            self.epoch,
            wall_time,
            float(len(seen)) if progress is None else progress,
        )
        if untracked or self.writer.needs_keyframe():
            # The keyframe snapshots the live tree, which already contains
            # every count drained into ``entries`` — they must not be
            # re-applied, so they are consumed here.
            meta.kind = K_FULL
            self.writer.append_full(self.tree, meta)
        else:
            self.writer.append_counts(((e[0], e[3]) for e in entries), meta, self.metric)
        self.epoch += 1
        return meta
