"""The port's IngestPipeline (``repro_torch.profilerd.pipeline``): a copy of
``tests/test_pipeline.py`` pointed at the port, then one byte stream through
the port's pipeline and the JAX package's, held equal exactly.

Batch/scalar parity and the unified ingest_stats schema: the vectorized lane
is only allowed to be faster, never different. Every parity test runs the
same byte stream through a scalar pipeline and a vectorized one and asserts
identical trees, identical depth timelines, identical stats, and — where a
sealer is attached — byte-identical sealed timeline segments. The
adversarial stream shapes are all covered: mixed v1/v2 records, torn chunk
boundaries mid-record, unknown stack ids, chain-cache overflow, and writer
re-attach mid-stream.

Everything degrades to the scalar path without numpy, so the parity tests
that *need* the vectorized lane skip when it is unavailable; the fallback
tests run everywhere (they monkeypatch numpy away).
"""

import dataclasses
import json
import os
import random

import pytest

import repro_torch.profilerd.wire as wire
from repro_torch.core.snapshot import TimelineWriter
from repro_torch.profilerd.daemon import DaemonConfig, ProfilerDaemon
from repro_torch.profilerd.ingest import TreeIngestor
from repro_torch.profilerd.pipeline import (
    INGEST_STATS_KEYS,
    IngestPipeline,
    format_ingest_stats,
    merge_ingest_stats,
)
from repro_torch.profilerd.spool import SpoolWriter
from repro_torch.profilerd.wire import (
    Encoder,
    RawFrame,
    RawSample,
    Rusage,
    numpy_available,
)

needs_numpy = pytest.mark.skipif(
    not numpy_available(), reason="vectorized lane requires numpy"
)

TICK = 4


def make_samples(n=240, n_stacks=10, depth=6, threads=3, seed=7):
    """Steady-state-shaped samples: shared root prefix, jittered leaf lines."""
    rng = random.Random(seed)
    shared = [RawFrame("/site-packages/jax/core.py", f"bind_{i}", i + 1) for i in range(depth // 2)]
    stacks = [
        shared
        + [
            RawFrame(f"/srv/app/src/repro/m{u % 3}.py", f"fn{u}_{j}", j + 1)
            for j in range(depth - len(shared))
        ]
        for u in range(n_stacks)
    ]
    out = []
    for i in range(n):
        u = rng.randrange(n_stacks)
        frames = stacks[u]
        leaf = frames[-1]
        frames = frames[:-1] + [RawFrame(leaf.filename, leaf.func, rng.randrange(1, 99))]
        out.append(RawSample(i * 0.01, 100 + u % threads, f"w{u % threads}", frames))
    return out


def encode_stream(samples, version=2, max_stacks=1 << 16, rusage_every=0):
    """hello + ticks (+ periodic rusage) + bye, as one byte string."""
    enc = Encoder(version=version, max_stacks=max_stacks)
    parts = [enc.encode_hello(77, 0.01)]
    for tick_i, i in enumerate(range(0, len(samples), TICK)):
        ru = Rusage(i * 0.01, i * 0.001, 1 << 20) if rusage_every and tick_i % rusage_every == 0 else None
        payload, _ = enc.encode_tick(samples[i : i + TICK], rusage=ru)
        parts.append(payload)
    parts.append(enc.encode_bye(len(samples)))
    return b"".join(parts)


def run_lane(payload, vectorized, tmp_path=None, *, chunk=997, seal_every=0,
             max_paths=1 << 18, reset_at=None):
    """Feed ``payload`` in ``chunk``-byte pieces; returns (pipeline, events, dir)."""
    tl_dir = None
    writer = None
    if tmp_path is not None:
        tl_dir = str(tmp_path / f"tl_{'vec' if vectorized else 'scalar'}")
        writer = TimelineWriter(tl_dir, epochs_per_segment=4)
    pipe = IngestPipeline(
        ingestor=TreeIngestor(max_paths=max_paths),
        timeline_writer=writer,
        vectorized=vectorized,
    )
    events = []
    chunks = [payload[i : i + chunk] for i in range(0, len(payload), chunk)]
    for ci, c in enumerate(chunks):
        if reset_at is not None and ci == reset_at:
            pipe.reset_stream()
        events.extend(pipe.feed(c))
        if seal_every and (ci + 1) % seal_every == 0:
            pipe.seal_epoch(wall_time=float(ci))
    if seal_every:
        pipe.seal_epoch(wall_time=1e6)
    return pipe, events, tl_dir


def _dir_bytes(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def assert_lane_parity(payload, tmp_path, **kw):
    """The workhorse: scalar vs vectorized on the same bytes, everything equal."""
    scalar, s_events, s_dir = run_lane(payload, False, tmp_path, **kw)
    vec, v_events, v_dir = run_lane(payload, True, tmp_path, **kw)
    assert vec.vectorized, "vectorized lane did not engage"
    assert vec.tree.to_json() == scalar.tree.to_json()
    assert list(vec.depth_timeline) == list(scalar.depth_timeline)
    assert vec.samples == scalar.samples
    assert vec.unknown_stack_refs == scalar.unknown_stack_refs
    assert vec.degraded_stackdefs == scalar.degraded_stackdefs
    # Non-sample events come out in stream order in both lanes.
    assert [type(e).__name__ for e in v_events] == [type(e).__name__ for e in s_events]
    s_stats, v_stats = scalar.ingest_stats(), vec.ingest_stats()
    for k in ("samples", "fast_hits", "slow_ingests", "cached_paths",
              "unknown_stack_refs", "degraded_stackdefs"):
        assert v_stats[k] == s_stats[k], k
    if s_dir is not None:
        assert _dir_bytes(v_dir) == _dir_bytes(s_dir), "sealed segments differ"
    return scalar, vec


@needs_numpy
class TestBatchScalarParity:
    def test_tree_timeline_and_stats_parity(self, tmp_path):
        payload = encode_stream(make_samples(), rusage_every=5)
        scalar, vec = assert_lane_parity(payload, tmp_path, seal_every=3)
        assert vec.samples == 240
        assert vec.ingest_stats()["batch_samples"] > 0  # the fast lane ran
        assert scalar.ingest_stats()["batch_samples"] == 0

    def test_single_byte_chunks_torn_mid_record(self, tmp_path):
        """Every record torn across chunk boundaries: the probe must never
        fire on a partial record and the tail buffering must match feed()."""
        payload = encode_stream(make_samples(n=60))
        assert_lane_parity(payload, tmp_path, chunk=3, seal_every=40)

    def test_mixed_v1_v2_stream(self, tmp_path):
        """Encoder stack-table overflow interleaves v1 SAMPLE records with
        SAMPLE2 runs; v1 records take the scalar core inside the batch lane
        and force keyframes (untracked) identically in both lanes."""
        payload = encode_stream(make_samples(n_stacks=12), max_stacks=3)
        scalar, _vec = assert_lane_parity(payload, tmp_path, seal_every=3)
        assert scalar.ingestor.stats()["slow_ingests"] > 12  # v1 fall-through

    def test_pure_v1_stream(self, tmp_path):
        payload = encode_stream(make_samples(n=80), version=1)
        scalar, vec = assert_lane_parity(payload, tmp_path, seal_every=3)
        assert vec.ingest_stats()["batch_samples"] == 0  # nothing to batch

    def test_unknown_stack_ids_count_as_placeholders(self, tmp_path):
        """A reader that missed the STACKDEFs (late re-attach): every sample
        degrades to the counted '?' placeholder, identically per lane."""
        samples = make_samples(n=100)
        enc = Encoder(version=2)
        for i in range(0, len(samples), TICK):  # defs consumed elsewhere
            enc.encode_tick(samples[i : i + TICK])
        parts = [enc.encode_hello(77, 0.01)]
        for i in range(0, len(samples), TICK):  # pure SAMPLE2, ids unseen
            parts.append(enc.encode_tick(samples[i : i + TICK])[0])
        payload = b"".join(parts)
        scalar, vec = assert_lane_parity(payload, tmp_path, seal_every=3)
        assert vec.unknown_stack_refs == 100
        flat = vec.tree.flatten()
        assert flat.get("py::?") == 100 and flat.get("thread::?") == 100

    def test_chain_cache_overflow_forces_keyframes(self, tmp_path):
        scalar, vec = assert_lane_parity(
            encode_stream(make_samples()), tmp_path, seal_every=2, max_paths=1
        )
        assert scalar.ingestor.stats()["cached_paths"] == 1

    def test_reset_stream_mid_batch(self, tmp_path):
        """Writer re-attach mid-stream (at a record boundary, as the real
        reader re-attach does): stack_id caches die, loss counters fold into
        the pipeline, and both lanes agree on all of it."""
        samples = make_samples()
        enc = Encoder(version=2)
        parts = [enc.encode_hello(77, 0.01)]
        for i in range(0, len(samples), TICK):
            parts.append(enc.encode_tick(samples[i : i + TICK])[0])
        half = len(parts) // 2
        pre, post = b"".join(parts[:half]), b"".join(parts[half:])
        lanes = {}
        for vec in (False, True):
            d = str(tmp_path / f"tl_{'vec' if vec else 'scalar'}")
            pipe = IngestPipeline(
                timeline_writer=TimelineWriter(d, epochs_per_segment=4), vectorized=vec
            )
            for i in range(0, len(pre), 997):
                pipe.feed(pre[i : i + 997])
            pipe.seal_epoch(1.0)
            pipe.reset_stream()
            for i in range(0, len(post), 997):
                pipe.feed(post[i : i + 997])
            pipe.seal_epoch(2.0)
            lanes[vec] = (pipe, d)
        scalar, s_dir = lanes[False]
        vec_pipe, v_dir = lanes[True]
        assert vec_pipe.tree.to_json() == scalar.tree.to_json()
        # Post-reset SAMPLE2 ids were defined pre-reset: the fresh decoder
        # counts every reference as unknown, identically per lane.
        assert vec_pipe.unknown_stack_refs == scalar.unknown_stack_refs > 0
        assert vec_pipe.degraded_stackdefs == scalar.degraded_stackdefs
        assert _dir_bytes(v_dir) == _dir_bytes(s_dir)

    def test_one_shot_vs_chunked_batch(self, tmp_path):
        """Chunking must not change anything: one giant feed vs tiny feeds."""
        payload = encode_stream(make_samples())
        one, _, _ = run_lane(payload, True, chunk=len(payload))
        many, _, _ = run_lane(payload, True, chunk=311)
        assert one.tree.to_json() == many.tree.to_json()
        assert list(one.depth_timeline) == list(many.depth_timeline)
        assert one.ingest_stats()["fast_hits"] == many.ingest_stats()["fast_hits"]


class TestScalarFallback:
    def _no_numpy(self, monkeypatch):
        monkeypatch.setattr(wire, "_np_probed", True)
        monkeypatch.setattr(wire, "_np", None)
        monkeypatch.setattr(wire, "_sample2_dtype", None)

    def test_pipeline_selects_scalar_without_numpy(self, monkeypatch, tmp_path):
        payload = encode_stream(make_samples(n=60))
        with_numpy = numpy_available()
        ref, _, _ = run_lane(payload, with_numpy)
        self._no_numpy(monkeypatch)
        assert not numpy_available()
        pipe = IngestPipeline()  # auto-detect: must pick scalar, not crash
        assert pipe.vectorized is False
        forced = IngestPipeline(vectorized=True)  # the flag reports reality
        assert forced.vectorized is False
        for i in range(0, len(payload), 101):
            pipe.feed(payload[i : i + 101])
        assert pipe.tree.to_json() == ref.tree.to_json()
        assert pipe.ingest_stats()["vectorized"] is False

    def test_feed_batch_degrades_to_scalar_without_numpy(self, monkeypatch):
        self._no_numpy(monkeypatch)
        dec = wire.Decoder()
        events = list(dec.feed_batch(encode_stream(make_samples(n=20))))
        kinds = {type(e).__name__ for e in events}
        assert "SampleBatch" not in kinds
        assert sum(1 for e in events if type(e) is RawSample) == 20

    def test_daemon_logs_scalar_fallback_once(self, monkeypatch, tmp_path):
        self._no_numpy(monkeypatch)
        spool = str(tmp_path / "t.spool")
        w = SpoolWriter(spool, capacity=1 << 20)
        enc = Encoder()
        w.write(enc.encode_hello(os.getpid(), 0.01))
        for s in make_samples(n=40):
            w.write(enc.encode_tick([s])[0])
        w.write_bye(enc.encode_bye(40))
        daemon = ProfilerDaemon(
            DaemonConfig(spool_path=spool, out_dir=str(tmp_path / "out"), max_seconds=10)
        )
        daemon.run()
        falls = [e for e in daemon.events if e["kind"] == "INGEST_SCALAR_FALLBACK"]
        assert len(falls) == 1
        assert "numpy" in falls[0]["reason"]
        assert daemon.status()["ingest"]["vectorized"] is False

    @needs_numpy
    def test_daemon_does_not_log_fallback_with_numpy(self, tmp_path):
        spool = str(tmp_path / "t.spool")
        w = SpoolWriter(spool, capacity=1 << 20)
        enc = Encoder()
        w.write(enc.encode_hello(os.getpid(), 0.01))
        for s in make_samples(n=40):
            w.write(enc.encode_tick([s])[0])
        w.write_bye(enc.encode_bye(40))
        daemon = ProfilerDaemon(
            DaemonConfig(spool_path=spool, out_dir=str(tmp_path / "out"), max_seconds=10)
        )
        daemon.run()
        assert not [e for e in daemon.events if e["kind"] == "INGEST_SCALAR_FALLBACK"]
        status = daemon.status()
        assert status["ingest"]["vectorized"] is True
        assert status["ingest"]["batch_samples"] == 40


class TestIngestStatsSchema:
    def test_pipeline_emits_full_schema(self):
        pipe, _, _ = run_lane(encode_stream(make_samples(n=40)), numpy_available())
        stats = pipe.ingest_stats()
        assert set(stats) == set(INGEST_STATS_KEYS)
        assert stats["samples"] == 40

    def test_daemon_status_merges_schema(self, tmp_path):
        spool = str(tmp_path / "t.spool")
        w = SpoolWriter(spool, capacity=1 << 20)
        enc = Encoder()
        w.write(enc.encode_hello(os.getpid(), 0.01))
        for s in make_samples(n=24):
            w.write(enc.encode_tick([s])[0])
        w.write_bye(enc.encode_bye(24))
        daemon = ProfilerDaemon(
            DaemonConfig(spool_path=spool, out_dir=str(tmp_path / "out"), max_seconds=10)
        )
        daemon.run()
        status = daemon.status()
        assert set(status["ingest"]) == set(INGEST_STATS_KEYS)
        assert status["ingest"]["samples"] == 24
        # the per-source row carries the same schema
        row_stats = json.load(open(os.path.join(str(tmp_path / "out"), "status.json")))
        assert set(row_stats["ingest"]) == set(INGEST_STATS_KEYS)

    def test_merge_sums_and_ands(self):
        a = dict.fromkeys(INGEST_STATS_KEYS, 3)
        a["vectorized"] = True
        b = dict.fromkeys(INGEST_STATS_KEYS, 4)
        b["vectorized"] = False
        merged = merge_ingest_stats([a, b])
        assert merged["samples"] == 7 and merged["fast_hits"] == 7
        assert merged["vectorized"] is False  # one scalar source degrades the fleet
        assert merge_ingest_stats([a, a])["vectorized"] is True
        assert merge_ingest_stats([])["vectorized"] == numpy_available()

    def test_format_renders_lane_and_losses(self):
        stats = dict.fromkeys(INGEST_STATS_KEYS, 0)
        stats.update(vectorized=True, samples=10, fast_hits=8)
        line = format_ingest_stats(stats)
        assert "ingest[vectorized]" in line and "samples=10" in line
        assert "unknown=" not in line  # loss counters only shown when nonzero
        stats.update(vectorized=False, unknown_stack_refs=2)
        line = format_ingest_stats(stats)
        assert "ingest[scalar]" in line and "unknown=2" in line


@pytest.mark.parametrize("vectorized", [False, True])
@pytest.mark.parametrize("version", [1, 2])
def test_pipeline_equals_the_jax_packages(tmp_path, vectorized, version):
    """One stream (rusage, torn chunks, a sealer every 4 chunks) through the
    port's pipeline and the JAX package's: the same tree, depth timeline,
    stats and sealed segment bytes."""
    import repro.core.snapshot as jax_snapshot
    import repro.profilerd.pipeline as jax_pipeline

    if vectorized and not numpy_available():
        pytest.skip("numpy absent: no vectorized lane")
    # files that both packages label alike (py, repro): not /jax/, /torch/ or /repro_torch/
    samples = [dataclasses.replace(x, frames=[dataclasses.replace(f, filename=f.filename.replace("/jax/", "/lib/"))
                                              for f in x.frames]) for x in make_samples(seed=version)]
    payload = encode_stream(samples, version=version, rusage_every=5)
    runs = []
    for name, pipeline_cls, writer_cls in (("port", IngestPipeline, TimelineWriter),
                                           ("jax", jax_pipeline.IngestPipeline, jax_snapshot.TimelineWriter)):
        d = str(tmp_path / name)
        pipe = pipeline_cls(timeline_writer=writer_cls(d, epochs_per_segment=4), vectorized=vectorized)
        kinds = []
        for ci, i in enumerate(range(0, len(payload), 997)):
            kinds += [type(e).__name__ for e in pipe.feed(payload[i : i + 997])]
            if ci % 4 == 3:
                pipe.seal_epoch(wall_time=float(ci))
        pipe.seal_epoch(wall_time=1e6)
        runs.append((pipe.tree.to_json(), list(pipe.depth_timeline), pipe.ingest_stats(), kinds, _dir_bytes(d)))
    assert runs[0] == runs[1]
