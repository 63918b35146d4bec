"""The port's profiling daemon (``repro_torch.profilerd``) on the CPU: the
tests of ``tests/test_profilerd.py`` pointed at the port (the aggregator's
and push's are in ``tests/test_torch_aggregator.py``), then the port held to
the JAX package's daemon.

The copied invariants:

* codec roundtrip — raw frames -> codec -> resolver yields symbols identical
  to the in-process backend's ``frame_symbol``/``collapse_stack`` path;
* spool — SPSC ring with wraparound, and a full spool drops whole batches
  with exact accounting (nothing is half-written, nothing is lost silently);
* daemon lifecycle — attach -> sample -> drain -> stop; every stack the agent
  committed to the spool reaches the daemon's tree;
* parity — thread and daemon backends build equivalent trees for the same
  deterministic workload (a worker parked in a stable deep stack);
* out-of-process — ``python -m repro_torch.profilerd attach`` drains a live
  target from a separate process, and a silent-but-alive target is flagged
  ``TARGET_STALLED``.

Cross-package, exact (pure Python and integer counts, so the tolerance is
equality): the port's ``Encoder`` emits the JAX package's bytes, v1 and v2;
each package's ``Decoder`` and ``SpoolReader`` read the other's stream; one
spool the port's ``Agent`` writes is drained by both packages' daemons to
equal worker subtrees and ``status.json`` key sets; the resolvers give the
same symbols but for the stated origin labels. Then the CLIs: the
``Trainer`` and the serve CLI on the daemon backend, the event registry,
the query and push planes a daemon starts, and the static plane's loader,
which reads the extractor's artifact and raises on a garbage one.

The multi-target class (``TestMultiTargetDaemon``) is the JAX package's
serve and fleet tests pointed at the port: live and offline servers over a
two-target daemon, ``--watch`` discovery, and the supervisor's exit hook.
"""

import ast
import dataclasses
import json
import os
import pathlib
import shutil
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # keep property tests running where hypothesis is absent
    from _hypothesis_fallback import given, settings
    from _hypothesis_fallback import strategies as st

import repro.core.sampler as jax_sampler
import repro.profilerd.daemon as jax_daemon
import repro.profilerd.events as jax_events
import repro.profilerd.resolver as jax_resolver
import repro.profilerd.spool as jax_spool
import repro.profilerd.wire as jax_wire
from repro_torch.core import CallTree, SamplerConfig, StackSampler, make_sampler
from repro_torch.profilerd import events
from repro_torch.profilerd.agent import Agent, DaemonBackend
from repro_torch.profilerd.daemon import STALLED, DaemonConfig, ProfilerDaemon
from repro_torch.profilerd.ingest import TreeIngestor
from repro_torch.profilerd.resolver import SymbolResolver
from repro_torch.profilerd.spool import HEADER_SIZE, SpoolError, SpoolReader, SpoolWriter
from repro_torch.profilerd.wire import (
    WIRE_VERSION,
    Bye,
    Decoder,
    Encoder,
    Hello,
    RawFrame,
    RawSample,
    numpy_available,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC_ROOT = os.path.join(os.path.dirname(__file__), "..", "src")
def wait_until(pred, timeout_s=10.0, interval_s=0.01, desc="condition"):
    """Deadline-poll ``pred`` instead of sleeping a guessed duration.

    The CI matrix runs on noisy shared runners where a fixed sleep is either
    wastefully long or flakily short; every lifecycle test waits on the
    actual state transition and fails with a description on timeout.
    """
    deadline = time.monotonic() + timeout_s
    while True:
        value = pred()
        if value:
            return value
        if time.monotonic() >= deadline:
            raise AssertionError(f"timed out after {timeout_s:g}s waiting for {desc}")
        time.sleep(interval_s)


def _http_get(url: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _thread_stack_funcs(thread) -> list:
    frame = sys._current_frames().get(thread.ident)
    out = []
    while frame is not None:
        out.append(frame.f_code.co_name)
        frame = frame.f_back
    return out



class FakeTarget:
    """Deterministic spool publisher with full control over bye/crash/restart.

    Unlike :class:`Agent` (which samples this test process's real threads),
    every stack is chosen by the test, so two fake targets are genuinely
    distinct and re-attach/fleet-merge assertions can be exact.
    """

    def __init__(self, path, leaf: str, pid: int = 0, capacity: int = 1 << 20):
        self.path = str(path)
        self.leaf = leaf
        self.writer = SpoolWriter(self.path, capacity=capacity)
        self.enc = Encoder()
        self.n = 0
        self.writer.write(self.enc.encode_hello(pid or os.getpid(), 0.01))

    def emit(self, k: int = 1, leaf=None):
        frames = [
            RawFrame("/fake/app.py", "main", 1),
            RawFrame("/fake/app.py", leaf or self.leaf, 2),
        ]
        for _ in range(k):
            payload, fresh = self.enc.encode_tick(
                [RawSample(self.n * 0.01, 1, "w", frames)]
            )
            if self.writer.write(payload):
                self.n += 1
            else:
                self.enc.rollback(fresh)
        return self

    def bye(self):
        self.writer.write_bye(self.enc.encode_bye(self.n))
        self.writer.close()

    def crash(self):
        """Disappear without a BYE (the writer process died)."""
        self.writer.close()


def parked_worker(depth_a_evt):
    """Park a thread in a recognizable, stable 3-deep stack."""

    def parked_level_one():
        parked_level_two()

    def parked_level_two():
        parked_level_three()

    def parked_level_three():
        depth_a_evt.wait()

    parked_level_one()


@pytest.fixture
def parked():
    evt = threading.Event()
    t = threading.Thread(target=parked_worker, args=(evt,), name="parked-worker", daemon=True)
    t.start()
    wait_until(
        lambda: "parked_level_three" in _thread_stack_funcs(t),
        desc="parked worker reaching its wait()",
    )
    yield t
    evt.set()
    t.join(timeout=5)


class TestWireCodec:
    def frames(self):
        return [
            RawFrame("/usr/lib/python3/threading.py", "run", 10),
            RawFrame("/site-packages/jax/api.py", "jit", 20),
            RawFrame("/srv/app/src/repro/models/model.py", "forward", 30),
        ]

    def test_roundtrip_single_tick(self):
        enc, dec = Encoder(), Decoder()
        samples = [RawSample(1.5, 42, "MainThread", self.frames())]
        payload, fresh = enc.encode_tick(samples)
        assert fresh  # first tick defines new strings
        events = list(dec.feed(payload))
        assert len(events) == 1
        got = events[0]
        assert isinstance(got, RawSample)
        assert got.t == 1.5 and got.tid == 42 and got.thread_name == "MainThread"
        assert got.frames == self.frames()

    def test_string_interning_across_ticks(self):
        enc, dec = Encoder(), Decoder()
        p1, _ = enc.encode_tick([RawSample(0.0, 1, "t", self.frames())])
        p2, fresh2 = enc.encode_tick([RawSample(0.1, 1, "t", self.frames())])
        assert fresh2 == []  # steady state: no new strings
        assert len(p2) < len(p1) / 2
        evs = list(dec.feed(p1 + p2))
        assert [e.frames for e in evs] == [self.frames(), self.frames()]

    def test_chunked_feed_reassembles_partial_records(self):
        enc, dec = Encoder(), Decoder()
        payload, _ = enc.encode_tick([RawSample(0.0, 1, "t", self.frames())])
        events = []
        for i in range(0, len(payload), 3):  # drip-feed 3 bytes at a time
            events.extend(dec.feed(payload[i : i + 3]))
        assert len(events) == 1 and events[0].frames == self.frames()

    def test_rollback_keeps_stream_decodable(self):
        """A dropped batch must not leave dangling string ids."""
        enc, dec = Encoder(), Decoder()
        dropped, fresh = enc.encode_tick([RawSample(0.0, 1, "t", self.frames())])
        enc.rollback(fresh)  # transport rejected the batch; it is never fed
        kept, _ = enc.encode_tick([RawSample(0.1, 1, "t", self.frames())])
        evs = list(dec.feed(kept))
        assert len(evs) == 1 and evs[0].frames == self.frames()

    def test_hello_bye_roundtrip(self):
        enc, dec = Encoder(), Decoder()
        evs = list(dec.feed(enc.encode_hello(1234, 0.5) + enc.encode_bye(77)))
        assert isinstance(evs[0], Hello) and evs[0].pid == 1234 and evs[0].period_s == 0.5
        assert isinstance(evs[1], Bye) and evs[1].n_ticks == 77

    def test_resolver_matches_thread_backend_symbols(self, parked):
        """Raw capture -> codec -> resolver == frame_symbol on the same frame."""
        frame = sys._current_frames()[parked.ident]
        # thread-backend path
        expected = StackSampler(SamplerConfig(period_s=10))._stack_of(frame)
        # daemon path: raw walk (as the agent does) -> encode -> decode -> resolve
        raw, f = [], frame
        while f is not None:
            raw.append(RawFrame(f.f_code.co_filename, f.f_code.co_name, f.f_lineno))
            f = f.f_back
        raw.reverse()
        payload, _ = Encoder().encode_tick([RawSample(0.0, parked.ident, "w", raw)])
        (sample,) = list(Decoder().feed(payload))
        assert SymbolResolver().resolve_stack(sample.frames) == expected

    def test_resolver_collapse_matches_thread_backend(self, parked):
        frame = sys._current_frames()[parked.ident]
        expected = StackSampler(
            SamplerConfig(period_s=10, collapse_origins=("py",))
        )._stack_of(frame)
        raw, f = [], frame
        while f is not None:
            raw.append(RawFrame(f.f_code.co_filename, f.f_code.co_name, f.f_lineno))
            f = f.f_back
        raw.reverse()
        got = SymbolResolver(("py",)).resolve_stack(raw)
        assert got == expected
        assert "py::*" in got


class TestWireV2:
    """Stack interning (STACKDEF/SAMPLE2): the perf core of wire v2."""

    def frames(self, leaf="leaf_fn"):
        return [
            RawFrame("/usr/lib/python3/threading.py", "run", 10),
            RawFrame("/site-packages/jax/api.py", "jit", 20),
            RawFrame("/srv/app/src/repro/models/model.py", leaf, 30),
        ]

    def test_steady_state_sample_is_fixed_size(self):
        enc, dec = Encoder(), Decoder()
        p1, fresh1 = enc.encode_tick([RawSample(0.0, 1, "t", self.frames())])
        p2, fresh2 = enc.encode_tick([RawSample(0.1, 1, "t", self.frames())])
        assert fresh2 == []  # no new strings *and* no new stacks
        # SAMPLE2 record: 5-byte framing + 24-byte payload.
        assert len(p2) == 29
        evs = list(dec.feed(p1 + p2))
        assert [e.frames for e in evs] == [self.frames(), self.frames()]
        assert evs[0].stack_id == evs[1].stack_id == 0
        # the decoder shares one frames list per interned stack (fast lane)
        assert evs[0].frames is evs[1].frames

    def test_prefix_delta_against_previous_stackdef(self):
        """Two stacks sharing a root prefix: the second STACKDEF encodes only
        the divergent tail (prefix-delta), and both decode to full stacks."""
        enc, dec = Encoder(), Decoder()
        a = self.frames("leaf_a")
        b = self.frames("leaf_b")  # same first two frames, new leaf
        pa, _ = enc.encode_tick([RawSample(0.0, 1, "t", a)])
        pb, _ = enc.encode_tick([RawSample(0.1, 1, "t", b)])
        # delta STACKDEF: only the leaf frame + its one new string crosses
        assert len(pb) < len(pa) / 2
        evs = list(dec.feed(pa + pb))
        assert evs[0].frames == a and evs[1].frames == b
        assert evs[0].stack_id != evs[1].stack_id

    def test_stackdef_rollback_keeps_stream_decodable(self):
        """A dropped batch with a fresh STACKDEF must not poison later ticks:
        ids are never reused and the delta context resets."""
        enc, dec = Encoder(), Decoder()
        committed, _ = enc.encode_tick([RawSample(0.0, 1, "t", self.frames("leaf_a"))])
        dropped, fresh = enc.encode_tick([RawSample(0.1, 1, "t", self.frames("leaf_b"))])
        enc.rollback(fresh)  # transport rejected; decoder never sees `dropped`
        retry, _ = enc.encode_tick([RawSample(0.2, 1, "t", self.frames("leaf_b"))])
        evs = list(dec.feed(committed + retry))
        assert [e.frames for e in evs] == [self.frames("leaf_a"), self.frames("leaf_b")]
        assert len({e.stack_id for e in evs}) == 2

    def test_hello_announces_negotiated_version(self):
        for version in (1, 2):
            (hello,) = Decoder().feed(Encoder(version=version).encode_hello(1, 0.5))
            assert isinstance(hello, Hello) and hello.version == version
        assert WIRE_VERSION == 2

    def test_v1_encoder_still_produces_v1_stream(self):
        """Backward compat: Encoder(version=1) emits per-frame SAMPLE records
        (stack_id is None) and old spools keep decoding."""
        enc, dec = Encoder(version=1), Decoder()
        p, _ = enc.encode_tick([RawSample(0.0, 1, "t", self.frames())])
        (ev,) = list(dec.feed(p))
        assert ev.frames == self.frames() and ev.stack_id is None

    def test_utf8_truncation_lands_on_codepoint_boundary(self):
        """A >64 KiB multi-byte name truncates on a codepoint boundary, never
        leaving a mangled trailing sequence (the old byte-slice bug)."""
        enc, dec = Encoder(), Decoder()
        long_name = "é" * 40_000  # 80,000 UTF-8 bytes > 0xFFFF
        p, _ = enc.encode_tick([RawSample(0.0, 1, "t", [RawFrame("/f.py", long_name, 1)])])
        (ev,) = list(dec.feed(p))
        got = ev.frames[0].func
        assert "�" not in got  # no replacement char from a split sequence
        assert got == "é" * (0xFFFF // 2)

    def test_same_stack_different_threads_shares_stackdef(self):
        enc, dec = Encoder(), Decoder()
        p, _ = enc.encode_tick(
            [RawSample(0.0, 1, "a", self.frames()), RawSample(0.0, 2, "b", self.frames())]
        )
        evs = list(dec.feed(p))
        assert evs[0].stack_id == evs[1].stack_id
        assert {e.thread_name for e in evs} == {"a", "b"}

    def test_leaf_lineno_jitter_does_not_defeat_interning(self):
        """An actively-executing leaf frame changes f_lineno nearly every
        tick; resolution is line-agnostic, so those must intern as ONE stack
        (else a busy thread would mint a STACKDEF per sample and grow the
        intern tables without bound)."""
        enc, dec = Encoder(), Decoder()
        first, _ = enc.encode_tick(
            [RawSample(0.0, 1, "t", self.frames()[:-1] + [RawFrame("/w.py", "busy", 100)])]
        )
        for i in range(1, 6):
            jittered = self.frames()[:-1] + [RawFrame("/w.py", "busy", 100 + i)]
            p, fresh = enc.encode_tick([RawSample(i * 0.1, 1, "t", jittered)])
            assert fresh == []  # no new STACKDEF despite the moving lineno
            assert len(p) == 29  # steady-state fixed-size SAMPLE2
            first += p
        evs = list(dec.feed(first))
        assert len({e.stack_id for e in evs}) == 1
        # decoded linenos are the first occurrence's representative values
        assert all(e.frames[-1].lineno == 100 for e in evs)

    def test_unknown_stack_id_degrades_to_counted_placeholder(self):
        """Re-attaching after a previous reader consumed the STACKDEFs must
        not silently drop stack structure: samples decode to a "?" frame
        (v1-style degradation) and the loss is counted."""
        enc = Encoder()
        p1, _ = enc.encode_tick([RawSample(0.0, 1, "t", self.frames())])
        p2, _ = enc.encode_tick([RawSample(0.1, 1, "t", self.frames())])
        dec = Decoder()  # fresh decoder: never saw p1's STRDEF/STACKDEF
        (ev,) = list(dec.feed(p2))
        assert ev.frames == [RawFrame("?", "?", 0)]
        assert ev.thread_name == "?"  # name STRDEF was consumed too
        assert dec.unknown_stack_refs == 1
        ing = TreeIngestor()
        ing.ingest(ev)
        assert ing.tree.total() == 1  # counted, visible as thread::?/py::?

    def test_delta_stackdef_against_unseen_context_degrades_not_misroots(self):
        """A mid-stream attach may first see a STACKDEF that delta-encodes
        against a definition the dead reader consumed.  Applying it would
        silently mis-root the stack; it must degrade to the counted
        placeholder, and stay degraded until a full (n_prefix=0) definition
        restores the context."""
        enc = Encoder()
        p1, _ = enc.encode_tick([RawSample(0.0, 1, "t", self.frames("leaf_a"))])
        p2, _ = enc.encode_tick([RawSample(0.1, 1, "t", self.frames("leaf_b"))])
        # leaf_b's STACKDEF shares a 2-frame prefix with leaf_a's -> delta
        dec = Decoder()
        evs = list(dec.feed(p2))  # p1 was consumed by a previous reader
        assert dec.degraded_stackdefs == 1
        assert [e.frames for e in evs] == [[RawFrame("?", "?", 0)]]
        # every sample referencing the degraded def is counted, not just the def
        assert dec.unknown_stack_refs == 1
        # a later definition with a fresh root (n_prefix=0) recovers fully
        fresh_stack = [RawFrame("/other/root.py", "main", 1), RawFrame("/w.py", "busy", 2)]
        p3, _ = enc.encode_tick([RawSample(0.2, 1, "t", fresh_stack)])
        (ev3,) = list(dec.feed(p3))
        assert [(f.filename, f.func) for f in ev3.frames] == [
            ("/other/root.py", "main"), ("/w.py", "busy")
        ]
        assert dec.degraded_stackdefs == 1  # no further degradation

    def test_stack_table_cap_falls_back_to_v1_records(self):
        """A full stack-intern table must not grow target memory: new stacks
        encode as v1 per-frame SAMPLE records in the same stream."""
        enc, dec = Encoder(max_stacks=1), Decoder()
        interned = self.frames("leaf_a")
        overflow = [RawFrame("/x.py", "other_root", 1)]
        p, _ = enc.encode_tick(
            [RawSample(0.0, 1, "t", interned), RawSample(0.0, 2, "t", overflow)]
        )
        evs = list(dec.feed(p))
        assert evs[0].stack_id == 0 and evs[0].frames == interned
        assert evs[1].stack_id is None and evs[1].frames == overflow  # v1 fallback
        # the interned stack keeps its fixed-size fast path
        p2, fresh = enc.encode_tick([RawSample(0.1, 1, "t", interned)])
        assert fresh == [] and len(p2) == 29

    def test_keyframe_defs_bound_degraded_window_after_reattach(self):
        """Real stacks always share root frames, so organic n_prefix=0 defs
        never happen after warm-up; periodic keyframe definitions must bound
        how long a mid-stream attacher stays degraded."""
        from repro_torch.profilerd.wire import FULL_DEF_INTERVAL

        enc = Encoder()
        base = self.frames()[:-1]
        consumed, _ = enc.encode_tick([RawSample(0.0, 1, "t", base + [RawFrame("/w.py", "f0", 1)])])
        dec = Decoder()  # attaches after `consumed` is gone
        recovered_at = None
        for i in range(1, FULL_DEF_INTERVAL + 2):
            stack = base + [RawFrame("/w.py", f"f{i}", 1)]  # shares the root prefix
            p, _ = enc.encode_tick([RawSample(i * 0.1, 1, "t", stack)])
            (ev,) = list(dec.feed(p))
            if ev.frames != [RawFrame("?", "?", 0)]:
                recovered_at = i
                break
        assert recovered_at is not None and recovered_at <= FULL_DEF_INTERVAL
        assert dec.degraded_stackdefs == recovered_at - 1
        # Once recovered, subsequent deltas decode with full structure again.
        # Strings defined before the attach stay "?" (v1-parity degradation);
        # strings defined after decode normally.
        p, _ = enc.encode_tick([RawSample(9.9, 1, "t", base + [RawFrame("/w.py", "tail", 2)])])
        (ev,) = list(dec.feed(p))
        assert [f.func for f in ev.frames] == ["?"] * len(base) + ["tail"]

    def test_corrupt_record_raises_instead_of_desyncing(self):
        """A declared frame count exceeding the record's length prefix must
        raise loudly, never silently read the next record's bytes."""
        import struct

        enc = Encoder(version=1)
        good, _ = enc.encode_tick([RawSample(0.0, 1, "t", self.frames())])
        # Find the SAMPLE record and inflate its nframes field without
        # growing the payload: length prefix u32, kind u8, then the header
        # <dQIH> whose final u16 is nframes.
        buf = bytearray(good)
        off = 0
        while True:
            (n,) = struct.unpack_from("<I", buf, off)
            kind = buf[off + 4]
            if kind == 3:  # K_SAMPLE
                hdr_off = off + 5
                struct.pack_into("<H", buf, hdr_off + 8 + 8 + 4, 999)
                break
            off += 4 + n
        with pytest.raises(ValueError):
            list(Decoder().feed(bytes(buf)))


_WIRE_FILES = ["/a/repro/x.py", "/b/torch/y.py", "/c/numpy/z.py", "/d/app.py"]
_WIRE_FUNCS = ["fa", "fb", "fc", "fd", "fe"]
_frame_st = st.sampled_from(
    [RawFrame(f, q, ln) for f in _WIRE_FILES for q in _WIRE_FUNCS for ln in (1, 7)]
)
_stack_st = st.lists(_frame_st, min_size=0, max_size=8)
_stacks_st = st.lists(_stack_st, min_size=1, max_size=24)


@settings(max_examples=60, deadline=None)
@given(_stacks_st)
def test_prop_v1_v2_decode_parity(stacks):
    """The same samples encoded with v1 and v2 decode to the same symbol
    sequences and build identical trees through the ingestor.

    v1 round-trips frames exactly; v2 interns stacks on the (filename, func)
    sequence, so decoded linenos are the first occurrence's — everything
    symbol resolution consumes is preserved bit-for-bit.
    """
    samples = [RawSample(i * 0.1, 100 + (i % 3), f"w{i % 3}", s) for i, s in enumerate(stacks)]
    trees = {}
    for version in (1, 2):
        enc, dec = Encoder(version=version), Decoder()
        payload = b"".join(enc.encode_tick(samples[i : i + 4])[0] for i in range(0, len(samples), 4))
        ing = TreeIngestor()
        decoded = []
        for ev in dec.feed(payload):
            decoded.append(ev.frames)
            ing.ingest(ev)
        if version == 1:
            assert decoded == [s.frames for s in samples]
        assert [[(f.filename, f.func) for f in fs] for fs in decoded] == [
            [(f.filename, f.func) for f in s.frames] for s in samples
        ]
        trees[version] = ing.tree
    assert trees[1].to_json() == trees[2].to_json()


@settings(max_examples=40, deadline=None)
@given(_stacks_st)
def test_prop_v2_steady_state_bytes_are_depth_independent(stacks):
    """Once stacks are interned, a repeated tick costs exactly 29 bytes per
    v2 sample regardless of depth, while v1 re-pays 12 bytes per frame."""
    samples = [RawSample(i * 0.1, 7, "w", s) for i, s in enumerate(stacks)]
    steady = {}
    for version in (1, 2):
        enc = Encoder(version=version)
        enc.encode_tick(samples)  # warm the intern tables
        steady[version], fresh = enc.encode_tick(samples)
        assert fresh == []
    assert len(steady[1]) == sum(27 + 12 * len(s.frames) for s in samples)
    assert len(steady[2]) == 29 * len(samples)


class TestIngestFastPath:
    def _mixed_samples(self):
        stack_a = [RawFrame("/d/app.py", "main", 1), RawFrame("/a/repro/x.py", "step", 2)]
        stack_b = [RawFrame("/d/app.py", "main", 1), RawFrame("/b/torch/y.py", "jit", 3)]
        return [
            RawSample(0.0, 1, "w", stack_a),
            RawSample(0.1, 1, "w", stack_a),
            RawSample(0.2, 1, "w", stack_b),
            RawSample(0.3, 1, "w", stack_a),
        ]

    def test_repeated_samples_hit_cached_chain(self):
        enc, dec, ing = Encoder(), Decoder(), TreeIngestor()
        for s in self._mixed_samples():
            payload, _ = enc.encode_tick([s])
            for ev in dec.feed(payload):
                ing.ingest(ev)
        assert ing.fast_hits == 2  # both stack_a repeats
        assert ing.slow_ingests == 2  # first sight of stack_a and stack_b
        assert ing.tree.total() == 4
        flat = ing.tree.flatten()
        assert flat["repro::step"] == 3 and flat["torch::jit"] == 1

    def test_fast_path_tree_equals_generic_add_stack(self):
        """Cached-chain ingestion and the generic per-frame path must agree."""
        enc, dec, ing = Encoder(), Decoder(), TreeIngestor()
        reference = CallTree()
        ref_resolver = SymbolResolver()
        for s in self._mixed_samples():
            reference.add_stack([f"thread::{s.thread_name}"] + ref_resolver.resolve_stack(s.frames))
            payload, _ = enc.encode_tick([s])
            for ev in dec.feed(payload):
                ing.ingest(ev)
        assert ing.tree.to_json() == reference.to_json()

    def test_daemon_reports_v2_and_fast_hits(self, tmp_path, parked):
        spool = str(tmp_path / "t.spool")
        agent = Agent(spool, period_s=10)
        for _ in range(20):
            agent.tick()
        agent.stop()
        daemon = ProfilerDaemon(
            DaemonConfig(spool_path=spool, out_dir=str(tmp_path / "out"), max_seconds=10)
        )
        daemon.run()
        status = daemon.status()
        assert status["wire_version"] == 2
        # The parked worker repeats the same stack: the fast lane dominates.
        assert status["ingest"]["fast_hits"] > status["ingest"]["slow_ingests"]
        assert status["ingest"]["cached_paths"] >= 1

    def test_v1_agent_spool_still_ingests(self, tmp_path, parked):
        """Old spools (v1 agents) decode and build the same tree as v2."""
        trees = {}
        for version in (1, 2):
            spool = str(tmp_path / f"v{version}.spool")
            agent = Agent(spool, period_s=10, wire_version=version)
            for _ in range(8):
                agent.tick()
            agent.stop()
            daemon = ProfilerDaemon(
                DaemonConfig(
                    spool_path=spool, out_dir=str(tmp_path / f"out{version}"), max_seconds=10
                )
            )
            daemon.run()
            assert daemon.wire_version == version
            sub = daemon.tree.root.children.get("thread::parked-worker")
            assert sub is not None
            trees[version] = json.dumps(sub.to_dict())
        assert trees[1] == trees[2]


class TestSpool:
    def test_write_read_roundtrip(self, tmp_path):
        p = str(tmp_path / "s.spool")
        w = SpoolWriter(p, capacity=1024)
        r = SpoolReader(p)
        assert w.write(b"hello") and w.write(b"world")
        assert r.read() == b"helloworld"
        assert r.read() == b""

    def test_wraparound(self, tmp_path):
        p = str(tmp_path / "s.spool")
        w = SpoolWriter(p, capacity=64)
        r = SpoolReader(p)
        blob = bytes(range(48))
        for _ in range(10):  # 480 bytes through a 64-byte ring
            assert w.write(blob)
            assert r.read() == blob
        assert w.dropped == 0

    def test_full_spool_drops_whole_batches_with_accounting(self, tmp_path):
        p = str(tmp_path / "s.spool")
        w = SpoolWriter(p, capacity=100)
        committed = []
        for i in range(10):
            payload = bytes([i]) * 40
            if w.write(payload):
                committed.append(payload)
        assert len(committed) == 2  # 2*40 fit, the rest dropped
        assert w.dropped == 8
        r = SpoolReader(p)
        assert r.dropped == 8
        assert r.read() == b"".join(committed)  # no partial writes

    def test_reader_waits_for_writer(self, tmp_path):
        p = str(tmp_path / "late.spool")
        created = threading.Event()

        def create_late():
            created.wait()
            SpoolWriter(p, capacity=256).write(b"x")

        threading.Thread(target=create_late, daemon=True).start()
        created.set()
        r = SpoolReader.wait_for(p, timeout_s=5)
        assert wait_until(r.read, desc="late writer's bytes") == b"x"


class TestSpoolAttachHardening:
    """Every corrupt-attach mode must raise SpoolError with a clean message,
    never a raw struct.error/ValueError/OSError (multi-target --watch races
    half-created and foreign files as a matter of course)."""

    def _header(self, magic=b"RPSP", version=1, capacity=64):
        hdr = bytearray(HEADER_SIZE)
        hdr[0:4] = magic
        struct.pack_into("<I", hdr, 4, version)
        struct.pack_into("<Q", hdr, 8, capacity)
        return bytes(hdr)

    def _attach(self, path):
        return SpoolReader(str(path), header_retry_s=0.01)

    def test_zero_length_file(self, tmp_path):
        p = tmp_path / "z.spool"
        p.write_bytes(b"")
        with pytest.raises(SpoolError, match="truncated spool header"):
            self._attach(p)

    def test_truncated_header(self, tmp_path):
        p = tmp_path / "t.spool"
        p.write_bytes(b"RPSP\x01")
        with pytest.raises(SpoolError, match="truncated spool header"):
            self._attach(p)

    def test_garbage_file(self, tmp_path):
        p = tmp_path / "g.spool"
        p.write_bytes(b"\xde\xad\xbe\xef" * 64)
        with pytest.raises(SpoolError, match="bad spool magic"):
            self._attach(p)

    def test_version_skew(self, tmp_path):
        p = tmp_path / "v.spool"
        p.write_bytes(self._header(version=99) + b"\x00" * 64)
        with pytest.raises(SpoolError, match="version 99"):
            self._attach(p)

    def test_capacity_beyond_file_size(self, tmp_path):
        """A spool truncated mid-copy declares more capacity than it holds."""
        p = tmp_path / "c.spool"
        p.write_bytes(self._header(capacity=1 << 20) + b"\x00" * 16)
        with pytest.raises(SpoolError, match="smaller than declared capacity"):
            self._attach(p)

    def test_zero_capacity(self, tmp_path):
        """capacity=0 used to survive the header checks and die later with a
        ZeroDivisionError in read(); it must be rejected at attach."""
        p = tmp_path / "0.spool"
        p.write_bytes(self._header(capacity=0))
        with pytest.raises(SpoolError, match="capacity 0 is not positive"):
            self._attach(p)

    def test_short_header_retries_once_and_wins(self, tmp_path):
        """The --watch race: a short file that becomes a real spool between
        the first and second open attaches cleanly."""
        p = tmp_path / "race.spool"
        p.write_bytes(b"RP")  # half-created
        grown = threading.Event()

        def grow():
            w = SpoolWriter(str(p), capacity=128)  # temp+rename over the stub
            w.write(b"ok")
            w.close()
            grown.set()

        threading.Thread(target=grow, daemon=True).start()
        grown.wait(timeout=5)
        r = SpoolReader(str(p), header_retry_s=0.5)
        assert r.read() == b"ok"

    def test_replaced_detects_new_incarnation(self, tmp_path):
        p = tmp_path / "r.spool"
        w1 = SpoolWriter(str(p), capacity=128)
        w1.write(b"first")
        r = SpoolReader(str(p))
        assert not r.replaced()
        w1.close()
        w2 = SpoolWriter(str(p), capacity=128)  # restart: temp+rename
        w2.write(b"second")
        assert r.replaced()
        assert r.read() == b"first"  # the unlinked mmap drains dry
        r2 = SpoolReader(str(p))
        assert r2.read() == b"second"
        w2.close()


class TestDaemonLifecycle:
    def test_attach_sample_drain_stop_no_loss(self, tmp_path, parked):
        """Every stack the agent committed reaches the daemon's tree."""
        spool = str(tmp_path / "t.spool")
        agent = Agent(spool, period_s=10, spool_bytes=1 << 20)
        committed = 0
        for _ in range(25):
            committed += agent.tick()
        agent.stop()
        assert agent.n_dropped_batches == 0

        daemon = ProfilerDaemon(
            DaemonConfig(spool_path=spool, out_dir=str(tmp_path / "out"), max_seconds=10)
        )
        tree = daemon.run()
        assert daemon.bye_seen
        assert daemon.n_ticks_reported == 25
        assert daemon.n_stacks == committed
        assert tree.total() == committed
        # the parked worker's stable stack must be a hot path
        flat = tree.flatten()
        assert any("parked_level_three" in k for k in flat)

    def test_full_spool_loses_batches_but_not_correctness(self, tmp_path, parked):
        """Tiny spool, no reader: batches drop; the ingested count matches
        exactly what was committed (drop accounting, no corruption)."""
        spool = str(tmp_path / "t.spool")
        agent = Agent(spool, period_s=10, spool_bytes=4096)
        committed = 0
        for _ in range(400):
            committed += agent.tick()
        agent.stop()
        assert agent.n_dropped_batches > 0  # the spool did fill

        daemon = ProfilerDaemon(
            DaemonConfig(spool_path=spool, out_dir=str(tmp_path / "out"), max_seconds=10)
        )
        tree = daemon.run()
        assert tree.total() == committed > 0
        # With no reader draining, the BYE *record* may itself have been
        # dropped (one extra drop beyond the agent's tick-drop count), but the
        # spool-header flag still marks the shutdown as clean.
        assert daemon.bye_seen
        assert daemon.dropped_batches in (
            agent.n_dropped_batches,
            agent.n_dropped_batches + 1,
        )

    def test_stall_verdict_for_silent_live_target(self, tmp_path):
        """Agent goes quiet without BYE while its pid is alive -> TARGET_STALLED.

        The declared period matters: silence only counts as a stall once it
        clearly exceeds the publisher's own cadence (3x), so a slow-ticking
        healthy target is never flagged."""
        spool = str(tmp_path / "t.spool")
        agent = Agent(spool, period_s=0.02)
        agent.tick()
        # no agent.stop(): the 'target' (this test process) wedges silently
        daemon = ProfilerDaemon(
            DaemonConfig(
                spool_path=spool,
                out_dir=str(tmp_path / "out"),
                publish_interval_s=0.05,
                stall_timeout_s=0.2,
                max_seconds=3.0,
            )
        )
        daemon.run()
        kinds = [e["kind"] for e in daemon.events]
        assert STALLED in kinds

    def test_artifacts_published(self, tmp_path, parked):
        spool = str(tmp_path / "t.spool")
        agent = Agent(spool, period_s=10)
        for _ in range(5):
            agent.tick()
        agent.stop()
        out = str(tmp_path / "out")
        ProfilerDaemon(DaemonConfig(spool_path=spool, out_dir=out, max_seconds=10)).run()
        expected = ["report.html", "status.json", "timeline", "tree.json"]
        if not numpy_available():
            # Scalar fallback logs one INGEST_SCALAR_FALLBACK event on attach.
            expected = ["events.jsonl"] + expected
        assert sorted(os.listdir(out)) == expected
        status = json.load(open(os.path.join(out, "status.json")))
        assert status["done"] and status["n_stacks"] > 0 and status["hot_paths"]
        tree = CallTree.from_json(open(os.path.join(out, "tree.json")).read())
        assert tree.total() == status["n_stacks"]
        # The sealed timeline reconstructs the exact merged tree.
        from repro_torch.core.snapshot import TimelineReader

        last = TimelineReader(os.path.join(out, "timeline")).last()
        assert last is not None and last[1].root == tree.root
        assert status["timeline"]["epochs"] >= 1


class TestBackendParity:
    def _worker_subtree(self, tree, name="thread::parked-worker"):
        node = tree.root.children.get(name)
        assert node is not None, f"{name} missing; saw {list(tree.root.children)}"
        return node.to_dict()

    def test_thread_and_daemon_trees_equivalent(self, tmp_path, parked):
        """Same parked stack sampled N times by both backends -> identical
        subtrees (structure and counts)."""
        n = 12
        cfg = SamplerConfig(period_s=10, collapse_origins=("py",))

        thread_backend = StackSampler(cfg)
        for _ in range(n):
            thread_backend.sample_now()
        thread_tree = thread_backend.snapshot()

        spool = str(tmp_path / "t.spool")
        agent = Agent(spool, period_s=10)
        for _ in range(n):
            agent.tick()
        agent.stop()
        daemon = ProfilerDaemon(
            DaemonConfig(
                spool_path=spool,
                out_dir=str(tmp_path / "out"),
                collapse_origins=cfg.collapse_origins,
                max_seconds=10,
            )
        )
        daemon_tree = daemon.run()

        assert self._worker_subtree(thread_tree) == self._worker_subtree(daemon_tree)

    def test_make_sampler_backend_selection(self):
        assert isinstance(make_sampler(SamplerConfig(backend="thread")), StackSampler)
        s = make_sampler(SamplerConfig(backend="daemon", spool_path="/tmp/x.spool"))
        assert isinstance(s, DaemonBackend)
        assert s.spawn_daemon is False  # explicit spool => external daemon
        with pytest.raises(ValueError):
            make_sampler(SamplerConfig(backend="perf"))

    def test_env_override_routes_to_external_daemon(self, tmp_path, monkeypatch):
        spool = str(tmp_path / "env.spool")
        monkeypatch.setenv("REPRO_PROFILERD_SPOOL", spool)
        monkeypatch.setenv("REPRO_PROFILERD_PERIOD", "0.123")
        s = make_sampler(SamplerConfig(backend="thread"))
        assert isinstance(s, DaemonBackend)
        assert s.spool_path == spool and s.spawn_daemon is False
        assert s.config.period_s == 0.123


class TestIngestorOverflowSealing:
    """The chain-cache overflow fallback mutates the tree outside the cache,
    so it must flip the `untracked` epoch flag exactly like the v1 path —
    otherwise sealed K_COUNTS records silently drop that mass from the
    timeline."""

    def _feed(self, enc, dec, ing, frames):
        payload, _ = enc.encode_tick([RawSample(0.0, 1, "t", frames)])
        for ev in dec.feed(payload):
            ing.ingest(ev)

    def test_overflow_mid_epoch_forces_sealer_keyframe(self, tmp_path):
        from repro_torch.core.snapshot import K_FULL, CountSealer, TimelineReader, TimelineWriter

        enc, dec = Encoder(), Decoder()
        ing = TreeIngestor(max_paths=1)
        writer = TimelineWriter(str(tmp_path / "tl"))
        sealer = CountSealer(ing.tree, writer)
        stack_a = [RawFrame("/a.py", "root", 1), RawFrame("/a.py", "hot", 2)]
        stack_b = [RawFrame("/a.py", "root", 1), RawFrame("/b.py", "cold", 3)]

        # Epoch 0: one stack, fits the 1-entry cache; normal counts path.
        self._feed(enc, dec, ing, stack_a)
        entries, untracked = ing.drain_epoch()
        assert not untracked
        sealer.seal(entries, wall_time=0.0, untracked=untracked)

        # Epoch 1: repeats ride the cache, then a second unique stack
        # overflows it mid-epoch -> the epoch must be untracked and the
        # sealer must keyframe (a counts record cannot carry stack_b).
        self._feed(enc, dec, ing, stack_a)
        self._feed(enc, dec, ing, stack_b)
        self._feed(enc, dec, ing, stack_b)
        entries, untracked = ing.drain_epoch()
        assert untracked, "cache overflow must mark the epoch untracked"
        meta = sealer.seal(entries, wall_time=1.0, untracked=untracked)
        assert meta.kind == K_FULL

        # Overflowed stacks can never be counted, so later epochs that touch
        # them keyframe too — the mass keeps reaching the ring.
        self._feed(enc, dec, ing, stack_b)
        entries, untracked = ing.drain_epoch()
        assert untracked
        sealer.seal(entries, wall_time=2.0, untracked=untracked)
        writer.close()

        last = TimelineReader(str(tmp_path / "tl")).last()
        assert last is not None
        assert last[1].root == ing.tree.root  # nothing silently dropped
        assert last[1].total() == 5.0


class TestWriterRestartReattach:
    """A crashed-and-restarted target recreates its spool
    (same path, new inode, fresh stack-id space, possibly stale bye=1 or a
    reused pid).  The daemon must re-attach instead of reporting a phantom
    TARGET_STALLED, and both incarnations' samples must land in the tree."""

    def _daemon(self, tmp_path, **kw):
        kw.setdefault("out_dir", str(tmp_path / "out"))
        kw.setdefault("publish_interval_s", 0.05)
        kw.setdefault("drain_interval_s", 0.01)
        kw.setdefault("epoch_s", 0.2)
        kw.setdefault("stall_timeout_s", 60.0)  # a restart must beat a stall
        kw.setdefault("max_seconds", 30.0)
        return ProfilerDaemon(DaemonConfig(**kw))

    def test_kill_and_respawn_reattaches_without_phantom_stall(self, tmp_path):
        spool = tmp_path / "job.spool"
        # Incarnation 1 crashes: samples, no BYE, and the recorded pid (this
        # test process) stays alive — the pid-reuse shape that used to read
        # as a stall.
        FakeTarget(spool, "first_incarnation").emit(4).crash()
        daemon = self._daemon(tmp_path, spool_paths=(str(spool),))
        th = threading.Thread(target=daemon.run, daemon=True)
        th.start()
        wait_until(lambda: daemon.n_stacks >= 4, desc="first incarnation drained")
        # Respawn under the same path; clean BYE ends the run.
        FakeTarget(spool, "second_incarnation").emit(3).bye()
        th.join(timeout=20)
        assert not th.is_alive()
        assert daemon.n_stacks == 7
        (src,) = daemon.sources
        assert src.restarts == 1
        kinds = [e["kind"] for e in daemon.events]
        assert "TARGET_RESTARTED" in kinds
        assert STALLED not in kinds, "restart must not read as a stall"
        flat = daemon.tree.flatten()
        assert any("first_incarnation" in k for k in flat)
        assert any("second_incarnation" in k for k in flat)

    def test_stale_bye_clears_on_restart(self, tmp_path):
        """A cleanly-stopped target (bye=1) that restarts must flip back to
        live: the stale header flag belongs to the dead incarnation."""
        watch = tmp_path / "spools"
        watch.mkdir()
        FakeTarget(watch / "job.spool", "gen_one").emit(2).bye()
        daemon = self._daemon(tmp_path, watch_dir=str(watch))
        th = threading.Thread(target=daemon.run, daemon=True)
        th.start()
        wait_until(
            lambda: daemon.sources and daemon.sources[0].bye_seen,
            desc="first incarnation drained to BYE",
        )
        FakeTarget(watch / "job.spool", "gen_two").emit(5)  # restart, no bye
        wait_until(lambda: daemon.n_stacks == 7, desc="second incarnation drained")
        (src,) = daemon.sources
        assert src.bye_seen is False and src.restarts == 1
        daemon.request_stop()
        th.join(timeout=20)
        assert not th.is_alive()
        assert STALLED not in [e["kind"] for e in daemon.events]
        assert daemon.tree.total() == 7


_TARGET = """
import sys, time
sys.path.insert(0, {src!r})
from repro_torch.core import SamplerConfig, make_sampler
s = make_sampler(SamplerConfig(backend="daemon", spool_path={spool!r},
                               spawn_daemon=False, period_s=0.02))
s.start()
def busy_loop_for_profilerd():
    t0 = time.monotonic(); x = 0
    while time.monotonic() - t0 < 1.5:
        x += 1
busy_loop_for_profilerd()
s.stop()
"""


class TestEndToEndCLI:
    def test_attach_streams_live_target(self, tmp_path):
        """`python -m repro_torch.profilerd attach` in a separate process drains a
        live publisher and emits a tree whose hot path is the busy loop."""
        spool = str(tmp_path / "e2e.spool")
        out = str(tmp_path / "e2e.out")
        env = dict(os.environ)
        env["PYTHONPATH"] = SRC_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        target = subprocess.Popen(
            [sys.executable, "-c", _TARGET.format(src=SRC_ROOT, spool=spool)], env=env
        )
        daemon = subprocess.run(
            [
                sys.executable, "-m", "repro_torch.profilerd", "attach",
                "--spool", spool, "--out", out,
                "--interval", "0.2", "--max-seconds", "30",
            ],
            env=env, capture_output=True, text=True, timeout=60,
        )
        assert target.wait(timeout=30) == 0
        assert daemon.returncode == 0, daemon.stderr
        tree = CallTree.from_json(open(os.path.join(out, "tree.json")).read())
        assert tree.total() > 0
        assert any("busy_loop_for_profilerd" in k for k in tree.flatten())
        assert os.path.exists(os.path.join(out, "report.html"))


# -- the port held to the JAX package's daemon, exactly ----------------------

_X_FILES = ["/a/repro/x.py", "/b/jax/y.py", "/c/numpy/z.py", "/d/app.py", "/e/torch/nn.py",
            "/f/src/repro_torch/m.py"]
_x_frame_st = st.sampled_from(
    [RawFrame(f, q, ln) for f in _X_FILES for q in ("fa", "fb", "é" * 3) for ln in (1, 7)]
)
_x_stacks_st = st.lists(st.lists(_x_frame_st, min_size=0, max_size=8), min_size=1, max_size=24)


class TestMultiTargetDaemon:
    """The tentpole: one daemon, N spools -> per-target trees + merged fleet."""

    def _cfg(self, tmp_path, **kw):
        kw.setdefault("out_dir", str(tmp_path / "fleet.out"))
        kw.setdefault("publish_interval_s", 0.05)
        kw.setdefault("drain_interval_s", 0.01)
        kw.setdefault("epoch_s", 0.2)
        kw.setdefault("max_seconds", 30.0)
        return DaemonConfig(**kw)

    def test_two_live_targets_served_and_merged(self, tmp_path):
        """Acceptance: one daemon over >= 2 concurrently-running targets
        serves distinct /tree?target= views plus a fleet tree whose inclusive
        mass equals the sum of the per-target trees."""
        alpha = FakeTarget(tmp_path / "alpha.spool", "alpha_leaf").emit(6)
        beta = FakeTarget(tmp_path / "beta.spool", "beta_leaf").emit(4)
        cfg = self._cfg(
            tmp_path,
            spool_paths=(str(tmp_path / "alpha.spool"), str(tmp_path / "beta.spool")),
            serve_port=0,
        )
        daemon = ProfilerDaemon(cfg)
        th = threading.Thread(target=daemon.run, daemon=True)
        th.start()
        try:
            wait_until(lambda: daemon.server is not None, desc="query plane up")
            url = daemon.server.url

            def targets_published():
                _code, body = _http_get(url + "/targets")
                rows = {r["name"]: r for r in json.loads(body)["targets"]}
                return rows if {"alpha", "beta"} <= set(rows) else None

            rows = wait_until(targets_published, desc="both targets published")
            assert rows["alpha"]["n_stacks"] == 6 and rows["beta"]["n_stacks"] == 4
            assert rows["alpha"]["done"] is False and rows["alpha"]["alive"] is True

            from repro_torch.core.export import from_folded

            _c, alpha_folded = _http_get(url + "/tree?target=alpha&fmt=folded")
            assert "alpha_leaf" in alpha_folded and "beta_leaf" not in alpha_folded
            _c, beta_folded = _http_get(url + "/tree?target=beta&fmt=folded")
            assert "beta_leaf" in beta_folded and "alpha_leaf" not in beta_folded
            _c, fleet_folded = _http_get(url + "/tree?fmt=folded")
            fleet = from_folded(fleet_folded)
            per_target_sum = from_folded(alpha_folded).total() + from_folded(beta_folded).total()
            assert fleet.total() == pytest.approx(per_target_sum) == pytest.approx(10.0)
            code, body = _http_get(url + "/tree?target=nope&fmt=folded")
            assert code == 404 and "unknown target" in body
        finally:
            alpha.bye()
            beta.bye()
            th.join(timeout=20)
        assert not th.is_alive()
        assert daemon.bye_seen

        # On-disk layout: fleet tree + per-target artifacts + sealed rings.
        from repro_torch.core.snapshot import TimelineReader
        from repro_torch.profilerd.profiles import list_profile_targets, load_profile

        out = cfg.resolved_out_dir()
        assert load_profile(out).total() == 10.0
        assert list_profile_targets(out) == ["alpha", "beta"]
        assert load_profile(os.path.join(out, "targets", "alpha")).total() == 6.0
        fleet_last = TimelineReader(os.path.join(out, "timeline")).last()
        assert fleet_last is not None and fleet_last[1].total() == 10.0
        alpha_last = TimelineReader(
            os.path.join(out, "targets", "alpha", "timeline")
        ).last()
        assert alpha_last is not None and alpha_last[1].total() == 6.0
        status = json.load(open(os.path.join(out, "status.json")))
        assert status["n_targets"] == 2 and set(status["targets"]) == {"alpha", "beta"}

    def test_offline_fleet_dir_serves_targets(self, tmp_path):
        from repro_torch.profilerd.server import OfflineSource, ProfileServer

        FakeTarget(tmp_path / "alpha.spool", "alpha_leaf").emit(6).bye()
        FakeTarget(tmp_path / "beta.spool", "beta_leaf").emit(4).bye()
        cfg = self._cfg(
            tmp_path,
            spool_paths=(str(tmp_path / "alpha.spool"), str(tmp_path / "beta.spool")),
        )
        ProfilerDaemon(cfg).run()  # both targets already said BYE: returns fast
        src = OfflineSource(cfg.resolved_out_dir())
        assert {r["name"] for r in src.targets()} == {"alpha", "beta"}
        assert src.tree("alpha").total() == 6.0
        assert src.tree().total() == 10.0
        server = ProfileServer(src).start()
        try:
            _c, body = _http_get(server.url + "/targets")
            assert {r["name"] for r in json.loads(body)["targets"]} == {"alpha", "beta"}
            _c, folded = _http_get(server.url + "/tree?target=beta&fmt=folded")
            assert "beta_leaf" in folded and "alpha_leaf" not in folded
            code, _b = _http_get(server.url + "/tree?target=missing")
            assert code == 404
            _c, status_body = _http_get(server.url + "/status")
            assert json.loads(status_body)["n_targets"] == 2
        finally:
            server.stop()

    def test_watch_discovers_spool_created_after_start(self, tmp_path):
        """Acceptance: --watch picks up a spool created after daemon start
        within one drain interval."""
        watch = tmp_path / "spools"
        watch.mkdir()
        cfg = self._cfg(tmp_path, watch_dir=str(watch), attach_timeout_s=10.0)
        daemon = ProfilerDaemon(cfg)
        th = threading.Thread(target=daemon.run, daemon=True)
        th.start()
        early = FakeTarget(watch / "early.spool", "early_leaf").emit(3)
        wait_until(lambda: daemon.n_stacks == 3, desc="first spool attached+drained")
        t0 = time.monotonic()
        late = FakeTarget(watch / "late.spool", "late_leaf").emit(2)
        wait_until(lambda: daemon.n_stacks == 5, desc="late spool discovered")
        # "within one drain interval" (0.01s) plus scheduler noise; 2s is the
        # generous CI bound that still proves discovery is loop-driven.
        assert time.monotonic() - t0 < 2.0
        assert set(daemon.spools.sources) == {"early", "late"}
        early.bye()
        late.bye()
        # A --watch daemon outlives done targets (new ones may appear): it
        # exits on request_stop (the launcher sends SIGTERM).
        wait_until(lambda: daemon.bye_seen, desc="both targets drained to BYE")
        assert th.is_alive()
        daemon.request_stop()
        th.join(timeout=20)
        assert not th.is_alive()
        kinds = [e["kind"] for e in daemon.events]
        assert kinds.count("TARGET_ATTACHED") == 2
        assert daemon.tree.total() == 5.0

    def test_watch_skips_garbage_spool_with_one_event(self, tmp_path):
        watch = tmp_path / "spools"
        watch.mkdir()
        (watch / "junk.spool").write_bytes(b"\xde\xad\xbe\xef" * 64)
        FakeTarget(watch / "good.spool", "good_leaf").emit(3).bye()
        cfg = self._cfg(tmp_path, watch_dir=str(watch))
        daemon = ProfilerDaemon(cfg)
        th = threading.Thread(target=daemon.run, daemon=True)
        th.start()
        wait_until(lambda: daemon.n_stacks == 3, desc="good spool drained")
        daemon.request_stop()
        th.join(timeout=20)
        assert not th.is_alive()
        fails = [e for e in daemon.events if e["kind"] == "SOURCE_ATTACH_FAILED"]
        assert len(fails) == 1  # logged once, not once per drain pass
        assert "junk" in fails[0]["path"] and "magic" in fails[0]["error"]
        assert list(daemon.spools.sources) == ["good"]

    def test_config_requires_a_source(self):
        with pytest.raises(ValueError):
            ProfilerDaemon(DaemonConfig())

    def test_live_quiet_target_serves_empty_tree_not_404(self):
        """A target that attached but has no published window yet is listed
        by /targets, so /tree?target= must answer with an empty tree, not
        contradict the listing with a 404."""
        from repro_torch.profilerd.profiles import ProfileLoadError
        from repro_torch.profilerd.server import LiveSource, SharedProfileState

        shared = SharedProfileState()
        shared.update({"targets": {"quiet": {"n_stacks": 0}}}, None, targets={})
        src = LiveSource(shared)
        assert src.tree("quiet").total() == 0.0
        with pytest.raises(ProfileLoadError, match="unknown target"):
            src.tree("missing")

    def test_never_appearing_explicit_target_is_abandoned(self, tmp_path):
        """A typo'd --targets path must not pin the run open forever: after
        the attach window it is abandoned with a loud event and the daemon
        exits once the real targets finish."""
        FakeTarget(tmp_path / "real.spool", "real_leaf").emit(3).bye()
        daemon = ProfilerDaemon(
            self._cfg(
                tmp_path,
                spool_paths=(str(tmp_path / "real.spool"), str(tmp_path / "typo.spool")),
                attach_timeout_s=0.3,
            )
        )
        th = threading.Thread(target=daemon.run, daemon=True)
        th.start()
        th.join(timeout=20)
        assert not th.is_alive(), "daemon hung on the never-appearing target"
        never = [e for e in daemon.events if e["kind"] == "TARGET_NEVER_APPEARED"]
        assert len(never) == 1 and never[0]["target"] == "typo"
        assert daemon.tree.total() == 3.0

    def test_exit_with_dead_pid_stops_watch_daemon(self, tmp_path):
        """--exit-with: a watch daemon whose supervisor died finishes cleanly
        instead of leaking forever."""
        watch = tmp_path / "spools"
        watch.mkdir()
        FakeTarget(watch / "job.spool", "leaf").emit(2).bye()
        dead_pid = 2**22 + 12345  # beyond any live pid on this box
        daemon = ProfilerDaemon(
            self._cfg(tmp_path, watch_dir=str(watch), exit_with_pid=dead_pid)
        )
        th = threading.Thread(target=daemon.run, daemon=True)
        th.start()
        th.join(timeout=20)
        assert not th.is_alive()
        assert "SUPERVISOR_GONE" in [e["kind"] for e in daemon.events]
        assert daemon.tree.total() == 2.0


def _jax_samples(samples):
    return [jax_wire.RawSample(s.t, s.tid, s.thread_name, [jax_wire.RawFrame(*dataclasses.astuple(f))
                                                           for f in s.frames]) for s in samples]


def _stream(wire, samples, version: int, *, drop_every: int = 0) -> bytes:
    """hello, ticks of 4 samples (every ``drop_every``-th rolled back, as a
    full spool does), then bye, from ``wire``'s Encoder."""
    enc = wire.Encoder(version=version)
    out = [enc.encode_hello(1234, 0.25)]
    for n, i in enumerate(range(0, len(samples), 4)):
        payload, fresh = enc.encode_tick(samples[i : i + 4], wire.Rusage(i * 0.1, 1.5, 1 << 20))
        if drop_every and n % drop_every == drop_every - 1:
            enc.rollback(fresh)
        else:
            out.append(payload)
    out.append(enc.encode_bye(len(samples)))
    return b"".join(out)


def _events(wire, stream: bytes) -> list:
    return [(type(ev).__name__, dataclasses.astuple(ev)) for ev in wire.Decoder().feed(stream)]


@settings(max_examples=40, deadline=None)
@given(_x_stacks_st)
def test_prop_encoder_bytes_equal_the_jax_packages(stacks):
    """The same ticks encode to the same bytes in both packages, v1 and v2,
    with rolled-back batches between them."""
    samples = [RawSample(i * 0.1, 100 + (i % 3), f"w{i % 3}", s) for i, s in enumerate(stacks)]
    for version in (1, 2):
        for drop_every in (0, 3):
            port = _stream(sys.modules[Encoder.__module__], samples, version, drop_every=drop_every)
            ref = _stream(jax_wire, _jax_samples(samples), version, drop_every=drop_every)
            assert port == ref


@settings(max_examples=30, deadline=None)
@given(_x_stacks_st)
def test_prop_each_decoder_reads_the_others_stream(stacks):
    samples = [RawSample(i * 0.1, 7, "w", s) for i, s in enumerate(stacks)]
    port_wire = sys.modules[Encoder.__module__]
    for version in (1, 2):
        port_stream = _stream(port_wire, samples, version)
        jax_stream = _stream(jax_wire, _jax_samples(samples), version)
        want = _events(port_wire, port_stream)
        assert _events(jax_wire, port_stream) == want
        assert _events(port_wire, jax_stream) == want


@pytest.mark.parametrize("writer_mod,reader_mod", [("port", "jax"), ("jax", "port")])
def test_each_spool_reader_reads_the_others_spool(tmp_path, writer_mod, reader_mod):
    mods = {"port": sys.modules[SpoolWriter.__module__], "jax": jax_spool}
    p = str(tmp_path / "x.spool")
    w = mods[writer_mod].SpoolWriter(p, capacity=64)
    r = mods[reader_mod].SpoolReader(p)
    got = b""
    for i in range(12):  # through the ring's wrap
        assert w.write(bytes([i]) * 40)
        got += r.read()
    assert got == b"".join(bytes([i]) * 40 for i in range(12))
    assert not w.write(b"x" * 65) and r.dropped == 1
    w.write_bye(b"bye")
    assert r.bye_seen and r.read() == b"bye" and r.writer_pid == os.getpid()


def test_one_agent_spool_drains_to_equal_trees_in_both_daemons(tmp_path, parked):
    """A spool the port's agent wrote (the parked worker among its threads),
    copied and drained by the JAX package's daemon and by the port's: the
    worker's subtree and the status.json key sets are equal."""
    spool = str(tmp_path / "t.spool")
    agent = Agent(spool, period_s=10)
    for _ in range(10):
        agent.tick()
    agent.stop()
    shutil.copy(spool, tmp_path / "j.spool")
    runs = {}
    for name, mod, path in (("port", sys.modules[ProfilerDaemon.__module__], spool),
                            ("jax", jax_daemon, str(tmp_path / "j.spool"))):
        out = str(tmp_path / f"out_{name}")
        tree = mod.ProfilerDaemon(mod.DaemonConfig(spool_path=path, out_dir=out, max_seconds=10)).run()
        with open(os.path.join(out, "status.json")) as f:
            runs[name] = (tree.root.children["thread::parked-worker"].to_dict(), json.load(f))
    assert runs["port"][0] == runs["jax"][0]
    assert runs["port"][0]["metrics"]["samples"] == 10
    (_, port_status), (_, jax_status) = runs["port"], runs["jax"]
    assert set(port_status) == set(jax_status)
    assert set(port_status["ingest"]) == set(jax_status["ingest"])
    assert port_status["n_stacks"] == jax_status["n_stacks"] and port_status["done"] and jax_status["done"]


def test_resolver_symbols_equal_the_jax_packages_but_the_origin_labels():
    """Same (filename, func) -> same symbol, but for the port's origin labels:
    ``torch`` where the JAX package reads ``py`` (``/torch/``), ``repro`` where
    it reads ``py`` (``/repro_torch/``), and ``py`` where it reads ``jax``."""
    relabel = {"/e/torch/nn.py": ("torch", "py"), "/f/src/repro_torch/m.py": ("repro", "py"),
               "/b/jax/y.py": ("py", "jax")}
    port, ref = SymbolResolver(), jax_resolver.SymbolResolver()
    for f in _X_FILES:
        got, want = port.symbol(f, "fn"), ref.symbol(f, "fn")
        port_origin, jax_origin = relabel.get(f, (want.split("::")[0],) * 2)
        assert (got, want) == (f"{port_origin}::fn", f"{jax_origin}::fn")
        assert jax_sampler.classify_frame(f) == jax_origin
    frames = [RawFrame(f, "fn", 1) for f in _X_FILES]
    jax_frames = [jax_wire.RawFrame(f, "fn", 1) for f in _X_FILES]
    for collapse in ((), ("numpy",)):  # the relabelled origins are folded by neither
        got = SymbolResolver(collapse).resolve_stack(frames)
        want = jax_resolver.SymbolResolver(collapse).resolve_stack(jax_frames)
        assert len(got) == len(want) == len(_X_FILES)
        for f, g, w in zip(_X_FILES, got, want):
            assert (g, w) == (tuple(f"{o}::fn" for o in relabel[f]) if f in relabel else (w, w))


# -- the train and serve CLIs on the daemon backend--------------------------------------


def test_trainer_on_the_daemon_backend(tmp_path):
    """A smoke Trainer with ``profile_backend="daemon"`` on the CPU: its
    daemon (spawned) exits 0 and done, tree.json's total is status.json's
    ``n_stacks``, the host report is written from the daemon's tree, and the
    summary reports the daemon."""
    from repro_torch.launch.train import Trainer, TrainJobConfig

    job = TrainJobConfig(arch="qwen3-4b", device="cpu", steps=3, global_batch=2, seq_len=16, profile=True,
                         profile_backend="daemon", sample_period_s=0.02, out_dir=str(tmp_path / "run"))
    summary = Trainer(job).run()
    daemon = summary["profile_daemon"]
    assert daemon["spawned"] and daemon["exit_code"] == 0 and daemon["done"] and daemon["published"]
    with open(os.path.join(daemon["out_dir"], "status.json")) as f:
        status = json.load(f)
    with open(os.path.join(daemon["out_dir"], "tree.json")) as f:
        tree = CallTree.from_json(f.read())
    assert status["done"] and status["n_stacks"] > 0 and tree.total() == status["n_stacks"]
    assert daemon["n_stacks"] == status["n_stacks"]
    assert os.path.exists(tmp_path / "run" / "host_profile.html")
    assert summary["kernel_launches"] == dict.fromkeys(summary["kernel_launches"], 0)  # the CPU: plain versions


def test_serve_cli_on_the_daemon_backend():
    """``python -m repro_torch.launch.serve --device cpu --profile --backend
    daemon`` exits 0 with samples read back from its daemon."""
    env = {**os.environ, "PYTHONPATH": SRC_ROOT}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--profile", "--backend", "daemon",
         "--requests", "4"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    stats = json.loads(proc.stdout[proc.stdout.rfind("\n{\n") + 1:])
    assert stats["profile_samples"] > 0 and stats["requests_done"] == 4
    assert stats["profile_daemon"]["exit_code"] == 0 and stats["profile_daemon"]["done"]


def test_a_daemon_that_fails_is_reported_not_replaced(tmp_path, monkeypatch):
    """A spawned daemon that dies at start leaves the backend a daemon
    backend: stop() returns an empty tree and ``summary()`` shows the exit
    code and that nothing was published."""
    import repro_torch.profilerd.daemon as port_daemon

    real = port_daemon.spawn_attached_daemon

    def broken(spool_path, out_dir, **kw):
        return subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"])

    monkeypatch.setattr(port_daemon, "spawn_attached_daemon", broken)
    backend = make_sampler(SamplerConfig(backend="daemon", period_s=0.01, spawn_daemon=True,
                                         spool_path=str(tmp_path / "s.spool")))
    assert isinstance(backend, DaemonBackend)
    backend.start()
    tree = backend.stop()
    assert tree.total() == 0
    summary = backend.summary()
    assert summary["exit_code"] == 3 and not summary["published"] and not summary["done"]
    assert real is not broken


def test_an_agent_that_cannot_create_its_spool_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    backend = DaemonBackend(SamplerConfig(backend="daemon", spool_path=str(blocker / "x.spool")))
    with pytest.raises(OSError):
        backend.start()


@pytest.mark.parametrize("field,value", [("serve_port", 0), ("push_url", "http://127.0.0.1:9/")])
def test_the_planes_not_ported_yet_raise(tmp_path, field, value):
    """The query and push planes are ported: a daemon configured with either
    builds, runs to its target's BYE, and reports the plane (the server's
    SERVING event and URL; the push client's node and its failed pushes,
    counted in status.json, to an address where nothing listens)."""
    FakeTarget(tmp_path / "s.spool", "leaf").emit(3).bye()
    cfg = DaemonConfig(spool_path=str(tmp_path / "s.spool"), publish_interval_s=0.05, drain_interval_s=0.01,
                       epoch_s=0.05, max_seconds=20.0, push_timeout_s=0.5, **{field: value})
    daemon = ProfilerDaemon(cfg)
    assert daemon.run().total() == 3.0
    status = json.loads((tmp_path / "s.spool.d" / "status.json").read_text())
    if field == "serve_port":
        (serving,) = [e for e in daemon.events if e["kind"] == "SERVING"]
        assert serving["url"].startswith("http://127.0.0.1:") and daemon.server is None  # stopped at the end
        assert status["push"] is None
    else:
        assert status["node"] and status["push"]["failures"] > 0
        assert any(e["kind"] == "PUSH_FAILED" for e in daemon.events)


def test_attach_serve_exits_2_naming_the_roadmap_item(tmp_path):
    """``attach --serve`` serves while attached: the CLI returns 0 once its
    target said BYE, and events.jsonl holds the SERVING event."""
    from repro_torch.profilerd.__main__ import main

    FakeTarget(tmp_path / "s.spool", "leaf").emit(2).bye()
    assert main(["attach", "--spool", str(tmp_path / "s.spool"), "--serve", "0", "--max-seconds", "20"]) == 0
    events = [json.loads(x) for x in (tmp_path / "s.spool.d" / "events.jsonl").read_text().splitlines()]
    assert any(e["kind"] == "SERVING" for e in events)


def test_static_tree_loader_raises_where_an_artifact_exists(tmp_path):
    """No artifact: None. The extractor's artifact loads; a garbage one
    (``{}``, no root) raises ``ProfileLoadError``, never an empty tree."""
    from repro_torch.analysis.extract import extract_to_file
    from repro_torch.profilerd.profiles import ProfileLoadError, load_static_plane

    assert load_static_plane(str(tmp_path)) is None
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text("def f():\n    return g()\n\n\ndef g():\n    return 0\n")
    extract_to_file(str(tmp_path / "static_tree.json"), root=str(pkg), package="pkg")
    tree = load_static_plane(str(tmp_path))
    assert tree.flatten("defs") == {"mod::pkg.mod": 2.0, "repro::f": 1.0, "repro::g": 1.0}
    (tmp_path / "static_tree.json").write_text("{}")
    with pytest.raises(ProfileLoadError, match="unreadable static tree"):
        load_static_plane(str(tmp_path))


def test_daemon_loads_a_device_tree_that_appears_late_and_annotates_epochs(tmp_path):
    """``--device-tree`` names a file the trainer writes after the daemon
    started: the daemon loads it when it appears (DEVICE_TREE_LOADED), copies
    it beside its artifacts, and seals roofline-annotated epochs whose samples
    equal tree.json's."""
    from repro_torch.core.device_tree import save_device_tree
    from repro_torch.core.snapshot import TimelineReader
    from repro_torch.profilerd.profiles import load_device_plane

    spool = tmp_path / "job.spool"
    target = FakeTarget(spool, "step").emit(3)
    dt_path = tmp_path / "run" / "device_tree.json"
    out = tmp_path / "out"
    daemon = ProfilerDaemon(DaemonConfig(spool_path=str(spool), out_dir=str(out), device_tree=str(dt_path),
                                         publish_interval_s=0.05, drain_interval_s=0.01, epoch_s=0.1,
                                         max_seconds=30))
    th = threading.Thread(target=daemon.run, daemon=True)
    th.start()
    wait_until(lambda: daemon.n_stacks >= 3, desc="first samples")
    device = CallTree()
    device.add_stack(["train_step", "step"], {"flops": 1e12, "bytes": 1e9, "ops": 2.0})
    dt_path.parent.mkdir()
    save_device_tree(device, str(dt_path))
    wait_until(lambda: any(e["kind"] == "DEVICE_TREE_LOADED" for e in daemon.events), desc="device tree loaded")
    target.emit(2).bye()
    th.join(timeout=20)
    assert not th.is_alive()
    tree = CallTree.from_json((out / "tree.json").read_text())
    meta, sealed = TimelineReader(str(out / "timeline")).last()
    samples = lambda t: {p: n.metrics["samples"] for p, n in t.root.walk() if n.metrics.get("samples")}  # noqa: E731
    assert samples(sealed) == samples(tree) and tree.total() == 5
    assert any(k.startswith("hlo_") for _, n in sealed.root.walk() for k in n.metrics)
    assert load_device_plane(str(out)).to_json() == device.to_json()  # the copy beside the artifacts
    assert json.loads((out / "status.json").read_text())["device_plane"] is True


def _emitted_kinds(path: pathlib.Path) -> set[str]:
    """Every event kind a module emits: the string values of ``"kind"`` keys
    in its dict literals, and its upper-case string constants (the detectors'
    and the liveness kinds)."""
    kinds = set()
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "kind" and isinstance(v, ast.Constant):
                    kinds.add(v.value)
                if isinstance(k, ast.Constant) and k.value == "kind" and isinstance(v, ast.IfExp):
                    kinds |= {x.value for x in (v.body, v.orelse) if isinstance(x, ast.Constant)}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant) and isinstance(node.value.value, str):
            if node.value.value.isupper() and node.value.value.replace("_", "").isalpha() and len(node.value.value) > 3:
                kinds.add(node.value.value)
    return kinds


def test_every_event_kind_the_daemon_emits_is_registered():
    pkg = ROOT / "src" / "repro_torch"
    emitted = set()
    for name in ("daemon.py", "sources.py", "agent.py", "pipeline.py", "server.py", "push.py", "aggregator.py"):
        emitted |= _emitted_kinds(pkg / "profilerd" / name)
    emitted |= _emitted_kinds(pkg / "core" / "detector.py")
    emitted |= _emitted_kinds(pkg / "launch" / "launcher.py")
    assert {"DEVICE_TREE_LOADED", "TARGET_STALLED", "TARGET_RESUMED", "LIVELOCK", "STRAGGLER"} <= emitted
    assert {"SERVING", "SERVE_FAILED", "PUSH_FAILED", "PUSH_RECOVERED", "PUSH_REJECTED", "AGGREGATOR_RESTORED",
            "NODE_ATTACHED", "NODE_REBOOTED", "NODE_STALLED", "NODE_RECOVERED"} <= emitted
    assert emitted <= events.EVENT_KINDS, sorted(emitted - events.EVENT_KINDS)
    assert events.EVENT_KINDS == jax_events.EVENT_KINDS


def test_make_sampler_pops_the_out_dir_so_the_trainer_never_writes_there(tmp_path, monkeypatch):
    """Both packages' ``make_sampler`` consume ``REPRO_PROFILERD_OUT`` with
    the spool override, and both trainers read that variable later to drop
    ``device_tree.json`` into the daemon's directory: a job attached through
    the environment therefore finds it gone (a reference behaviour the port
    reproduces; the daemon's ``--device-tree`` hands the path over instead)."""
    from repro.launch.train import Trainer as JaxTrainer
    from repro.launch.train import TrainJobConfig as JaxJob
    from repro_torch.launch.train import Trainer, TrainJobConfig

    for trainer_cls, job_cls, name in ((JaxTrainer, JaxJob, "jax"), (Trainer, TrainJobConfig, "port")):
        monkeypatch.setenv("REPRO_PROFILERD_SPOOL", str(tmp_path / f"{name}.spool"))
        monkeypatch.setenv("REPRO_PROFILERD_OUT", str(tmp_path / f"{name}.d"))
        kw = {"device": "cpu"} if name == "port" else {}
        trainer = trainer_cls(job_cls(out_dir=str(tmp_path / name), **kw))
        try:
            assert trainer.sampler.out_dir == str(tmp_path / f"{name}.d")
            assert "REPRO_PROFILERD_OUT" not in os.environ and "REPRO_PROFILERD_SPOOL" not in os.environ
        finally:
            trainer.data.close()
