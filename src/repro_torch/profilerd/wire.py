"""Binary codec for raw frame records (target -> daemon): a copy of
``repro.profilerd.wire``, byte for byte the same stream.

Design constraints (paper §III):

* the target side must do **no symbol resolution** — records carry raw
  ``(filename, func, lineno)`` triples; the daemon resolves and classifies;
* strings are interned: each unique string crosses the wire once as a
  ``STRDEF`` record and is referenced by id afterwards;
* **stacks are interned** (wire v2): each unique stack crosses the wire once
  as a ``STACKDEF`` record (string-id triples, prefix-delta encoded against
  the previously defined stack), after which a steady-state sample is a
  fixed-size ``SAMPLE2`` record (``t, tid, name_id, stack_id``) instead of
  12 bytes *per frame* — the dominance pattern the paper exploits (steady
  simulator stacks repeat almost verbatim tick after tick) makes the
  amortized cost per sample independent of stack depth;
* records are self-delimiting (``u32`` length prefix), so the same byte
  stream works over the mmap ring spool *or* length-prefixed frames on a
  Unix-domain socket — the transport can swap without touching the codec;
* a dropped batch must not poison the stream: the encoder interns strings
  *and stacks* transactionally (``encode_tick`` returns the newly-defined
  keys; the caller rolls them back if the transport rejected the batch), and
  the decoder maps unknown string ids to ``"?"`` and unknown stack ids to a
  counted ``"?"`` placeholder frame instead of failing.

Record layout (little-endian):

====== ========== ===========================================================
kind   name       payload
====== ========== ===========================================================
1      HELLO      u32 version, u32 pid, f64 period_s
2      STRDEF     u32 id, u16 len, utf-8 bytes (truncated on a codepoint
                  boundary at 0xFFFF bytes)
3      SAMPLE     (wire v1) f64 t, u64 tid, u32 thread_name_id, u16 nframes,
                  nframes * (u32 file_id, u32 func_id, u32 lineno);
                  frames ordered root -> leaf
4      RUSAGE     f64 t, f64 cpu_s, u64 rss_bytes
5      BYE        u64 n_ticks (publisher ticks over the whole session)
6      STACKDEF   (wire v2) u32 stack_id, u16 n_prefix, u16 n_new,
                  n_new * (u32 file_id, u32 func_id, u32 lineno).
                  The full stack is the first ``n_prefix`` frames of the
                  *previously defined* stack followed by the ``n_new``
                  frames, root -> leaf (prefix-delta encoding: consecutive
                  definitions usually share a long root prefix).  Stacks are
                  interned on their ``(filename, func)`` frame sequence —
                  symbol resolution is line-agnostic, so line numbers (which
                  jitter on an actively-executing leaf frame) never split a
                  stack; the encoded linenos are the first occurrence's.
7      SAMPLE2    (wire v2) f64 t, u64 tid, u32 thread_name_id, u32 stack_id
====== ========== ===========================================================

Version negotiation rides on ``HELLO``: a v2 agent announces ``version=2``
and emits ``STACKDEF``/``SAMPLE2``; the decoder dispatches on record kind, so
it decodes v1 and v2 streams (and old v1 spool files) with no mode switch.
``Encoder(version=1)`` keeps producing pure-v1 streams for old consumers.

Batch decode (vectorized ingest)
--------------------------------

``SAMPLE2`` records are a fixed 29 bytes on the wire precisely so a run of
them can be decoded as *one* ``np.frombuffer`` structured-dtype view instead
of a per-record ``struct.unpack`` loop.  :meth:`Decoder.feed_batch` does
that: contiguous ``SAMPLE2`` runs come out as columnar :class:`SampleBatch`
objects (``t``/``tid``/``name_id``/``stack_id`` arrays), while every other
record kind — and a torn tail straddling the chunk boundary — goes through
the exact same scalar parse core as :meth:`Decoder.feed`.  numpy is an
optional dependency here: it is imported lazily on first use (the in-target
agent, which only encodes, never pays the import), and when it is absent
``feed_batch`` simply degrades to the scalar path.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from collections.abc import Iterable, Iterator, Sequence

WIRE_VERSION = 2

K_HELLO = 1
K_STRDEF = 2
K_SAMPLE = 3
K_RUSAGE = 4
K_BYE = 5
K_STACKDEF = 6
K_SAMPLE2 = 7

_LEN = struct.Struct("<I")
_KIND = struct.Struct("<B")
_HELLO = struct.Struct("<IId")
_STRDEF_HDR = struct.Struct("<IH")
_SAMPLE_HDR = struct.Struct("<dQIH")
_FRAME = struct.Struct("<III")
_RUSAGE = struct.Struct("<ddQ")
_BYE = struct.Struct("<Q")
_STACKDEF_HDR = struct.Struct("<IHH")
_SAMPLE2 = struct.Struct("<dQII")

# Whole-record size of a SAMPLE2 on the wire: u32 len + u8 kind + payload.
_S2_RECORD = _LEN.size + 1 + _SAMPLE2.size

UNKNOWN = "?"

# numpy is optional (vectorized batch decode only) and imported lazily: the
# attach path's import budget must not pay ~100 ms for a dependency the
# scalar fallback never touches.  The sentinel distinguishes "not probed yet"
# from "probed, absent".
_np_probed = False
_np = None
_sample2_dtype = None

# Predicate cost per vectorized probe is bounded to this many records, so a
# stream of non-SAMPLE2 records (cold-start STRDEF/STACKDEF bursts) costs
# O(records) total instead of O(records^2) per chunk, while genuine runs
# amortize the probe over thousands of samples.
_PROBE_MAX = 4096


def _numpy():
    """The numpy module, or None when unavailable (scalar fallback)."""
    global _np_probed, _np, _sample2_dtype
    if not _np_probed:
        _np_probed = True
        try:
            import numpy
        except ImportError:  # pragma: no cover - exercised via monkeypatch
            numpy = None
        _np = numpy
        if numpy is not None:
            # One structured view per SAMPLE2 run: field offsets address the
            # raw record bytes in place (len prefix and kind byte included,
            # so the same view validates framing and extracts columns).
            _sample2_dtype = numpy.dtype(
                {
                    "names": ["len", "kind", "t", "tid", "name_id", "stack_id"],
                    "formats": ["<u4", "u1", "<f8", "<u8", "<u4", "<u4"],
                    "offsets": [0, 4, 5, 13, 21, 25],
                    "itemsize": _S2_RECORD,
                }
            )
    return _np


def numpy_available() -> bool:
    return _numpy() is not None

_MAX_STR_BYTES = 0xFFFF  # STRDEF length field is u16

# Safety valve for pathological stack diversity (deep recursion sampled at
# varying depths, exec'd code minting unique filenames): once the encoder's
# stack table is full, *new* stacks fall back to v1 per-frame SAMPLE records
# — the decoder dispatches per record kind, so mixed streams are legal — and
# the table (hence agent memory inside the target) stays bounded.
DEFAULT_MAX_STACKS = 1 << 16

# Every Nth STACKDEF is a full (n_prefix=0) definition even when a shorter
# delta exists — a keyframe.  A decoder that attached mid-stream (its delta
# context degraded) recovers delta decoding within N *new* definitions
# instead of never: real stacks share root frames, so organic n_prefix==0
# definitions effectively don't occur after warm-up.  Stacks interned before
# the attach are not re-emitted — their samples stay counted placeholders
# (``unknown_stack_refs``), same as v1's "?" symbols for consumed STRDEFs.
FULL_DEF_INTERVAL = 16


@dataclass(frozen=True, slots=True)
class RawFrame:
    """One unresolved frame, exactly what the target can read for free."""

    filename: str
    func: str
    lineno: int


@dataclass(slots=True)
class RawSample:
    """One thread's stack at one tick, root -> leaf.

    ``stack_id`` is set when the sample arrived as a v2 ``SAMPLE2`` record:
    it identifies the interned stack, and consumers may key a resolution
    cache on it (see :class:`repro_torch.profilerd.ingest.TreeIngestor`).  For a
    cache hit the ``frames`` list need not be touched at all — the decoder
    shares one list object between every sample of the same stack, so the
    fast path allocates nothing per frame.
    """

    t: float
    tid: int
    thread_name: str
    frames: list[RawFrame] = field(default_factory=list)
    stack_id: int | None = None


@dataclass(slots=True)
class Hello:
    version: int
    pid: int
    period_s: float


@dataclass(slots=True)
class Rusage:
    t: float
    cpu_s: float
    rss_bytes: int


@dataclass(slots=True)
class Bye:
    n_ticks: int


class SampleBatch:
    """A columnar run of ``SAMPLE2`` records, in stream order.

    Produced by :meth:`Decoder.feed_batch`: ``t`` (f8), ``tid`` (u8),
    ``name_id`` (u4) and ``stack_id`` (u4) are equal-length numpy arrays —
    field views of one packed structured copy (the decoder's receive buffer
    is trimmed after the batch is emitted, so the columns must not alias
    it).  The ``decoder`` reference
    resolves the id columns against the live intern tables —
    :meth:`Decoder.thread_name` and :meth:`Decoder.batch_stack` — which is
    safe because ids are append-only and the batch is consumed before any
    later chunk can redefine the tables (only a re-attach replaces them, and
    that replaces the whole decoder).
    """

    __slots__ = ("t", "tid", "name_id", "stack_id", "decoder")

    def __init__(self, t, tid, name_id, stack_id, decoder: "Decoder"):
        self.t = t
        self.tid = tid
        self.name_id = name_id
        self.stack_id = stack_id
        self.decoder = decoder

    def __len__(self) -> int:
        return len(self.t)


Event = Hello | RawSample | Rusage | Bye

# Keys handed back by encode_tick for transactional rollback: interned
# strings are ``str``; interned stacks are tuples of (filename, func) pairs
# (line numbers are deliberately not part of a stack's identity — see
# Encoder._intern_stack).
InternKey = str | tuple


def _record(kind: int, payload: bytes) -> bytes:
    body = _KIND.pack(kind) + payload
    return _LEN.pack(len(body)) + body


def _truncate_utf8(s: str) -> bytes:
    """Encode with a 0xFFFF-byte cap, never splitting a multi-byte sequence."""
    raw = s.encode("utf-8", "replace")
    if len(raw) <= _MAX_STR_BYTES:
        return raw
    cut = _MAX_STR_BYTES
    # Back off past UTF-8 continuation bytes (0b10xxxxxx) so the cut lands
    # on a codepoint boundary; at most 3 steps.
    while cut > 0 and (raw[cut] & 0xC0) == 0x80:
        cut -= 1
    return raw[:cut]


class Encoder:
    """Target-side encoder with transactional string + stack intern tables."""

    def __init__(self, version: int = WIRE_VERSION, max_stacks: int = DEFAULT_MAX_STACKS) -> None:
        if version not in (1, 2):
            raise ValueError(f"unsupported wire version {version}")
        self.version = version
        self.max_stacks = max_stacks
        self._ids: dict[str, int] = {}
        self._next_id = 0
        self._stack_ids: dict[tuple, int] = {}
        self._next_stack_id = 0
        # Id-triples of the last committed STACKDEF — the prefix-delta
        # context.  Reset on rollback: the decoder never saw the dropped
        # definition, so the next STACKDEF must not delta against it.
        self._def_tail: tuple[tuple[int, int, int], ...] = ()
        self._defs_until_full = 0  # 0 -> next STACKDEF is a keyframe

    def _intern(self, s: str, out: list[bytes], fresh: list[InternKey]) -> int:
        sid = self._ids.get(s)
        if sid is None:
            sid = self._next_id
            self._next_id += 1
            self._ids[s] = sid
            raw = _truncate_utf8(s)
            out.append(_record(K_STRDEF, _STRDEF_HDR.pack(sid, len(raw)) + raw))
            fresh.append(s)
        return sid

    def _intern_stack(
        self, frames: Sequence[RawFrame], out: list[bytes], fresh: list[InternKey]
    ) -> int | None:
        """Intern one stack; returns its id, or None when the table is full
        (the caller then encodes a v1 per-frame SAMPLE for this sample)."""
        # Keyed on the (filename, func) sequence only: symbol resolution is
        # line-agnostic, and a busy thread's *leaf* line number changes nearly
        # every tick — including it would mint a new STACKDEF per sample and
        # grow the intern tables without bound.  The STACKDEF carries the
        # first-seen line numbers as representative values.
        key = tuple((f.filename, f.func) for f in frames)
        sid = self._stack_ids.get(key)
        if sid is None:
            if len(self._stack_ids) >= self.max_stacks:
                return None
            triples = tuple(
                (
                    self._intern(f.filename, out, fresh),
                    self._intern(f.func, out, fresh),
                    f.lineno,
                )
                for f in frames
            )
            sid = self._next_stack_id
            self._next_stack_id += 1
            self._stack_ids[key] = sid
            fresh.append(key)
            n_prefix = 0
            if self._defs_until_full == 0:
                self._defs_until_full = FULL_DEF_INTERVAL - 1  # keyframe
            else:
                self._defs_until_full -= 1
                for a, b in zip(self._def_tail, triples, strict=False):
                    if a != b:
                        break
                    n_prefix += 1
            body = [_STACKDEF_HDR.pack(sid, n_prefix, len(triples) - n_prefix)]
            for t in triples[n_prefix:]:
                body.append(_FRAME.pack(*t))
            out.append(_record(K_STACKDEF, b"".join(body)))
            self._def_tail = triples
        return sid

    def rollback(self, fresh: Iterable[InternKey]) -> None:
        """Forget strings/stacks interned by a batch the transport rejected.

        Ids are never reused (the counters keep growing), so a later
        re-definition of the same string or stack cannot collide with the
        dropped one.  The prefix-delta context is reset whenever a STACKDEF
        was dropped: the next definition encodes from scratch.
        """
        dropped_stack = False
        for k in fresh:
            if isinstance(k, tuple):
                self._stack_ids.pop(k, None)
                dropped_stack = True
            else:
                self._ids.pop(k, None)
        if dropped_stack:
            self._def_tail = ()

    def encode_hello(self, pid: int, period_s: float) -> bytes:
        return _record(K_HELLO, _HELLO.pack(self.version, pid, period_s))

    def encode_tick(
        self, samples: Sequence[RawSample], rusage: Rusage | None = None
    ) -> tuple[bytes, list[InternKey]]:
        """Encode one tick's samples as a single batch.

        Returns ``(payload, fresh_keys)``; the caller must either commit
        the whole payload to the transport or call :meth:`rollback` with
        ``fresh_keys``.
        """
        out: list[bytes] = []
        fresh: list[InternKey] = []
        v2 = self.version >= 2
        for s in samples:
            name_id = self._intern(s.thread_name, out, fresh)
            sid = self._intern_stack(s.frames, out, fresh) if v2 else None
            if sid is not None:
                out.append(_record(K_SAMPLE2, _SAMPLE2.pack(s.t, s.tid, name_id, sid)))
            else:
                body = [_SAMPLE_HDR.pack(s.t, s.tid, name_id, len(s.frames))]
                for f in s.frames:
                    body.append(
                        _FRAME.pack(
                            self._intern(f.filename, out, fresh),
                            self._intern(f.func, out, fresh),
                            f.lineno,
                        )
                    )
                out.append(_record(K_SAMPLE, b"".join(body)))
        if rusage is not None:
            out.append(_record(K_RUSAGE, _RUSAGE.pack(rusage.t, rusage.cpu_s, rusage.rss_bytes)))
        return b"".join(out), fresh

    def encode_bye(self, n_ticks: int) -> bytes:
        return _record(K_BYE, _BYE.pack(n_ticks))


class Decoder:
    """Streaming decoder: feed arbitrary byte chunks, get events out.

    Dispatches on record kind, so v1 (``SAMPLE``) and v2
    (``STACKDEF``/``SAMPLE2``) streams — and mixed ones — decode without a
    mode switch.  Samples of the same interned stack share one frames list
    object (never mutated), which is what makes the daemon's cached-path
    ingestion allocation-free per repeated sample.
    """

    def __init__(self) -> None:
        self._buf = bytearray()
        self._strings: dict[int, str] = {}
        self._stacks: dict[int, list[RawFrame]] = {}
        self._def_tail: list[RawFrame] = []
        # A SAMPLE2 whose STACKDEF this decoder never saw (e.g. re-attaching
        # to a live spool after a previous reader consumed the definitions)
        # degrades to one "?" placeholder frame — like v1's unknown-string
        # "?" symbols — and is counted so the loss is visible upstream.
        self._unknown_stack = [RawFrame(UNKNOWN, UNKNOWN, 0)]
        self.unknown_stack_refs = 0
        # A STACKDEF whose prefix-delta references a context we never saw
        # (same re-attach scenario) would silently mis-root the stack if
        # applied; it degrades to the placeholder instead, and the context
        # stays distrusted until a full (n_prefix == 0) definition arrives.
        self._def_valid = True
        self.degraded_stackdefs = 0

    def _string(self, sid: int) -> str:
        return self._strings.get(sid, UNKNOWN)

    def feed(self, data: bytes) -> Iterator[Event]:
        self._buf.extend(data)
        # Walk an offset and trim once at the end: draining a multi-MiB spool
        # backlog arrives as one chunk, and a per-record front-trim would make
        # that O(n^2) in buffer size.  Records are parsed in place with
        # unpack_from (no per-record body copy) — at steady state a sample is
        # one struct unpack, one dict hit, and one RawSample.
        buf = self._buf
        off = 0
        try:
            while True:
                if len(buf) - off < _LEN.size:
                    return
                (n,) = _LEN.unpack_from(buf, off)
                if len(buf) - off < _LEN.size + n:
                    return
                start = off + _LEN.size
                off = start + n
                ev = self._decode(buf[start], buf, start + 1, off)
                if ev is not None:
                    yield ev
        finally:
            del buf[:off]

    def feed_batch(self, data: bytes) -> Iterator[Event | SampleBatch]:
        """Like :meth:`feed`, but contiguous ``SAMPLE2`` runs come out as
        columnar :class:`SampleBatch` objects instead of per-record
        :class:`RawSample` events.

        A run is detected with one ``np.frombuffer`` structured view over the
        buffered bytes: from a known record boundary, every 29-byte stride
        whose ``len``/``kind`` fields read ``(25, SAMPLE2)`` is — by framing
        induction — a genuine record, and the first stride that does not ends
        the run.  Everything else (defs, hello/rusage/bye, v1 samples,
        corrupt records, a torn tail) goes through the scalar parse core,
        byte-for-byte identical to :meth:`feed`.  Runs are coalesced across
        non-yielding records (``STRDEF``/``STACKDEF``/unknown kinds): moving
        a definition ahead of the samples *preceding* it is safe because ids
        are append-only and a sample can only reference an id defined before
        it.  The pending batch is flushed before any yielded event, so the
        consumer observes samples and events in stream order.

        Without numpy this degrades to the scalar path (same yields as
        :meth:`feed`).
        """
        np = _numpy()
        if np is None:
            yield from self.feed(data)
            return
        self._buf.extend(data)
        buf = self._buf
        off = 0
        pending: list = []  # structured-run copies awaiting one flush

        def flush() -> SampleBatch | None:
            if not pending:
                return None
            arr = pending[0] if len(pending) == 1 else np.concatenate(pending)
            pending.clear()
            # Field views of one packed structured array: zero extra copies
            # per flush, and consumers (`bincount` grouping, `tolist` for the
            # timeline) take strided views as-is.
            return SampleBatch(arr["t"], arr["tid"], arr["name_id"], arr["stack_id"], self)

        try:
            while True:
                remaining = len(buf) - off
                if remaining < _LEN.size:
                    break
                (n,) = _LEN.unpack_from(buf, off)
                if n == _SAMPLE2.size + 1 and remaining >= _S2_RECORD and buf[off + _LEN.size] == K_SAMPLE2:
                    # Front record is a SAMPLE2: probe the run vectorized.
                    kmax = min(remaining // _S2_RECORD, _PROBE_MAX)
                    arr = np.frombuffer(buf, dtype=_sample2_dtype, count=kmax, offset=off)
                    ok = (arr["len"] == _SAMPLE2.size + 1) & (arr["kind"] == K_SAMPLE2)
                    end_at = np.flatnonzero(~ok)
                    k = int(end_at[0]) if end_at.size else kmax
                    # One structured copy materializes the run; every view
                    # into the bytearray is dropped before the finally-trim
                    # (a live export would make `del buf[:off]` raise
                    # BufferError).
                    pending.append(arr[:k].copy())
                    arr = ok = end_at = None  # noqa: F841
                    off += k * _S2_RECORD
                    continue
                if remaining < _LEN.size + n:
                    break
                start = off + _LEN.size
                off = start + n
                ev = self._decode(buf[start], buf, start + 1, off)
                if ev is not None:
                    batch = flush()
                    if batch is not None:
                        yield batch
                    yield ev
        finally:
            del buf[:off]
        batch = flush()
        if batch is not None:
            yield batch

    def thread_name(self, name_id: int) -> str:
        """Resolve a ``SampleBatch.name_id`` against the string table."""
        return self._strings.get(name_id, UNKNOWN)

    def batch_stack(self, stack_id: int, n: int = 1) -> list[RawFrame]:
        """Frames for a ``SampleBatch.stack_id`` covering ``n`` samples.

        Mirrors the scalar SAMPLE2 decode's degraded-mode accounting: an
        unknown or degraded stack id resolves to the shared ``"?"``
        placeholder and bumps ``unknown_stack_refs`` once per *sample*, so
        batch and scalar ingestion report identical loss counters.
        """
        frames = self._stacks.get(stack_id)
        if frames is None:
            self.unknown_stack_refs += n
            return self._unknown_stack
        if frames is self._unknown_stack:
            self.unknown_stack_refs += n
        return frames

    def _decode(self, kind: int, buf: bytearray, off: int, end: int) -> Event | None:
        """Decode one record whose payload spans ``buf[off:end]``.

        Parsing is in place, so every variable-length count and every
        fixed-size payload is validated against ``end`` — a corrupt record
        (torn write, declared count exceeding its length prefix) raises
        instead of silently consuming the following records' bytes.
        """
        if kind == K_SAMPLE2:
            if end - off != _SAMPLE2.size:
                raise ValueError(f"corrupt SAMPLE2 record: {end - off} byte payload")
            t, tid, name_id, sid = _SAMPLE2.unpack_from(buf, off)
            frames = self._stacks.get(sid)
            if frames is None:
                frames = self._unknown_stack
                self.unknown_stack_refs += 1
            elif frames is self._unknown_stack:
                # Reference to a degraded STACKDEF (delta against an unseen
                # context): count every affected sample, not just the def.
                self.unknown_stack_refs += 1
            return RawSample(t, tid, self._strings.get(name_id, UNKNOWN), frames, sid)
        if kind == K_STACKDEF:
            sid, n_prefix, n_new = _STACKDEF_HDR.unpack_from(buf, off)
            if end - off != _STACKDEF_HDR.size + n_new * _FRAME.size:
                raise ValueError(f"corrupt STACKDEF record: n_new={n_new}")
            if n_prefix == 0:
                self._def_valid = True
            elif not self._def_valid or n_prefix > len(self._def_tail):
                self.degraded_stackdefs += 1
                self._def_valid = False
                self._stacks[sid] = self._unknown_stack
                return None
            off += _STACKDEF_HDR.size
            frames = self._def_tail[:n_prefix]
            for _ in range(n_new):
                fid, qid, lineno = _FRAME.unpack_from(buf, off)
                off += _FRAME.size
                frames.append(RawFrame(self._string(fid), self._string(qid), lineno))
            self._stacks[sid] = frames
            self._def_tail = frames
            return None
        if kind == K_STRDEF:
            sid, n = _STRDEF_HDR.unpack_from(buf, off)
            off += _STRDEF_HDR.size
            if off + n > end:
                raise ValueError(f"corrupt STRDEF record: len={n}")
            self._strings[sid] = buf[off : off + n].decode("utf-8", "replace")
            return None
        if kind == K_SAMPLE:
            t, tid, name_id, nframes = _SAMPLE_HDR.unpack_from(buf, off)
            off += _SAMPLE_HDR.size
            if off + nframes * _FRAME.size > end:
                raise ValueError(f"corrupt SAMPLE record: nframes={nframes}")
            frames = []
            for _ in range(nframes):
                fid, qid, lineno = _FRAME.unpack_from(buf, off)
                off += _FRAME.size
                frames.append(RawFrame(self._string(fid), self._string(qid), lineno))
            return RawSample(t, tid, self._string(name_id), frames)
        if kind == K_HELLO:
            if end - off != _HELLO.size:
                raise ValueError("corrupt HELLO record")
            version, pid, period_s = _HELLO.unpack_from(buf, off)
            return Hello(version, pid, period_s)
        if kind == K_RUSAGE:
            if end - off != _RUSAGE.size:
                raise ValueError("corrupt RUSAGE record")
            t, cpu_s, rss = _RUSAGE.unpack_from(buf, off)
            return Rusage(t, cpu_s, rss)
        if kind == K_BYE:
            if end - off != _BYE.size:
                raise ValueError("corrupt BYE record")
            (n_ticks,) = _BYE.unpack_from(buf, off)
            return Bye(n_ticks)
        return None  # unknown kinds are skipped, forward-compatibly
