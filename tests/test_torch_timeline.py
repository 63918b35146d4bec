"""The port's timeline subsystem (``repro_torch.core.snapshot``) and trend
detection (``repro_torch.core.detector``): the tests of
``tests/test_timeline.py`` whose code the port has, pointed at the port,
then the port held to the JAX package exactly.

Copied invariants:

* snapshot codec — full/delta/counts roundtrips reconstruct trees exactly;
  corruption is detected (CRC), version skew refuses loudly, a torn ring
  tail is tolerated (crash-safe append);
* timeline ring — retention stays bounded in segments, and reconstruction
  through keyframes survives dropped history;
* sealers — chain-tracked (EpochSealer) and counts (CountSealer) sealing
  both reconstruct the live tree exactly, including the untracked fallback;
* trend detection — livelock (dominance + zero progress) is distinguished
  from plain dominance, both stamped with the epoch where they began; drift
  fires against a trailing baseline; phase segmentation splits on jumps.

* differential — share regressions count only increases, the text diff
  signs its deltas;
* CLI — ``check`` exit codes (0 pass / 2 regression / 3 unreadable),
  ``diff`` share deltas, ``timeline`` phase output, on the profiles
  ``tests/data/gen_workload.py`` writes with the JAX package (so the port's
  CLI reads the JAX package's rings and dumps).

The launcher's timeline merge is in ``tests/test_torch_launcher.py``.

Cross-package, exact: ``save_snapshot`` writes the JAX package's bytes for
the same tree, each ``TimelineReader`` reads the other's ring, and the trend
and straggler detectors give the JAX package's verdicts on the same window
sequences.
"""

import dataclasses
import os
import random
import sys

import pytest

import repro.core.calltree as jax_calltree
import repro.core.detector as jax_detector
import repro.core.snapshot as jax_snapshot
from repro_torch.core.calltree import CallTree
from repro_torch.core.detector import (
    DOMINANT,
    LIVELOCK,
    SHARE_DRIFT,
    StragglerDetector,
    TrendDetector,
    TrendRule,
    segment_phases,
)
from repro_torch.core.snapshot import (
    CountSealer,
    EpochMeta,
    EpochSealer,
    SnapshotCorrupt,
    SnapshotVersionError,
    TimelineReader,
    TimelineWriter,
    list_segments,
    load_snapshot,
    read_epochs,
    save_snapshot,
)
from repro_torch.core.report import render_diff, share_regressions
from repro_torch.profilerd.__main__ import main as profilerd_main
from repro_torch.profilerd.ingest import TreeIngestor
from repro_torch.profilerd.wire import RawFrame, RawSample

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "data"))
import gen_workload  # noqa: E402  (writes its profiles with the JAX package)


def sample_tree() -> CallTree:
    t = CallTree()
    for i in range(40):
        t.add_stack(["thread::main", f"f{i % 4}", f"g{i % 3}"])
    t.add_stack(["thread::main", "device"], {"flops": 2.5, "bytes": 100.0})
    return t


class TestSnapshotCodec:
    def test_roundtrip_full(self, tmp_path):
        t = sample_tree()
        p = str(tmp_path / "t.snap")
        save_snapshot(t, p, EpochMeta(7, wall_time=3.5, progress=12.0))
        meta, t2 = load_snapshot(p)
        assert t2.root == t.root
        assert (meta.epoch, meta.wall_time, meta.progress) == (7, 3.5, 12.0)

    def test_snapshot_is_deterministic(self, tmp_path):
        a, b = str(tmp_path / "a.snap"), str(tmp_path / "b.snap")
        save_snapshot(sample_tree(), a)
        save_snapshot(sample_tree(), b)
        assert open(a, "rb").read() == open(b, "rb").read()

    def test_corruption_detected(self, tmp_path):
        p = str(tmp_path / "t.snap")
        save_snapshot(sample_tree(), p)
        raw = bytearray(open(p, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(p, "wb").write(bytes(raw))
        with pytest.raises(SnapshotCorrupt):
            load_snapshot(p)

    def test_version_skew_refused(self, tmp_path):
        p = str(tmp_path / "t.snap")
        save_snapshot(sample_tree(), p)
        with open(p, "r+b") as f:
            f.seek(4)
            f.write((99).to_bytes(2, "little"))
        with pytest.raises(SnapshotVersionError):
            load_snapshot(p)

    def test_bad_magic_refused(self, tmp_path):
        p = str(tmp_path / "t.snap")
        with open(p, "wb") as f:
            f.write(b"NOPE" + b"\0" * 32)
        with pytest.raises(SnapshotCorrupt):
            load_snapshot(p)


def drive_sealer(tmp_path, epochs, stacks_per_epoch, **writer_kw):
    """Seal `epochs` epochs of chain-tracked activity; returns (dir, tree)."""
    d = str(tmp_path / "tl")
    tree = CallTree()
    w = TimelineWriter(d, **writer_kw)
    s = EpochSealer(tree, w)
    for e in range(epochs):
        chains = []
        for stack, count in stacks_per_epoch(e):
            ch = tree.path_nodes(stack)
            CallTree.add_stack_nodes(ch, float(count))
            chains.append(ch)
        s.seal(chains, wall_time=float(e))
    w.close()
    return d, tree


class TestTimelineRing:
    def steady(self, e):
        return [(["thread::m", "serve", "model"], 6), (["thread::m", "data"], 2)]

    def test_reconstruction_exact(self, tmp_path):
        d, tree = drive_sealer(tmp_path, 10, self.steady, epochs_per_segment=3)
        r = TimelineReader(d)
        last = r.last()
        assert last is not None and last[1].root == tree.root
        assert not r.truncated
        eps = read_epochs(d)
        assert [m.epoch for m, _, _ in eps] == list(range(10))
        # every window carries exactly one epoch's activity
        assert all(w.total() == 8.0 for _, w, _ in eps)

    def test_retention_bounded_and_decodable(self, tmp_path):
        d, tree = drive_sealer(
            tmp_path, 20, self.steady, epochs_per_segment=2, max_segments=3
        )
        assert len(list_segments(d)) <= 3
        eps = read_epochs(d)
        # oldest epochs dropped, newest survive, cumulative still exact
        # (each segment keyframe carries the absolute tree).
        assert eps and eps[-1][0].epoch == 19
        assert eps[-1][2].root == tree.root

    def test_torn_tail_tolerated(self, tmp_path):
        d, tree = drive_sealer(tmp_path, 4, self.steady, epochs_per_segment=100)
        seg = list_segments(d)[0]
        raw = open(seg, "rb").read()
        open(seg, "wb").write(raw[: len(raw) - 7])  # tear mid-record
        r = TimelineReader(d)
        eps = [(m.epoch) for m, _, _ in r.epochs()]
        assert eps == [0, 1, 2]  # last record lost, earlier ones fine
        assert r.truncated

    def test_reused_dir_drops_previous_runs_segments(self, tmp_path):
        # Run 1 seals more epochs (more segments) than run 2; a reader on the
        # shared dir must see ONLY run 2 — stale keyframes from run 1 would
        # otherwise resurrect the old run's tree.
        drive_sealer(tmp_path, 9, self.steady, epochs_per_segment=2)
        d, tree2 = drive_sealer(tmp_path, 3, lambda e: [(["thread::m", "run2"], 1)],
                                epochs_per_segment=2)
        eps = read_epochs(d)
        assert [m.epoch for m, _, _ in eps] == [0, 1, 2]
        assert eps[-1][2].root == tree2.root

    def test_writer_construction_alone_keeps_previous_ring(self, tmp_path):
        # A daemon whose attach times out constructs a TimelineWriter but
        # never seals; the previous run's ring must survive (the stale purge
        # is deferred to the first write).
        d, tree = drive_sealer(tmp_path, 3, self.steady)
        w = TimelineWriter(d)
        w.close()
        eps = read_epochs(d)
        assert len(eps) == 3 and eps[-1][2].root == tree.root

    def test_headerless_segment_skipped_not_fatal(self, tmp_path):
        # Crash between segment open() and header write leaves a 0-byte file;
        # readers must skip it, and check-style consumers must not crash.
        d, tree = drive_sealer(tmp_path, 3, self.steady)
        open(os.path.join(d, "seg-9999999999.tl"), "wb").close()
        r = TimelineReader(d)
        eps = [(m, w, c) for m, w, c in r.epochs()]
        assert len(eps) == 3 and r.truncated
        assert eps[-1][2].root == tree.root

    def test_corrupt_mid_segment_resyncs_at_next_keyframe(self, tmp_path):
        d, tree = drive_sealer(tmp_path, 8, self.steady, epochs_per_segment=2)
        segs = list_segments(d)
        assert len(segs) == 4
        raw = bytearray(open(segs[1], "rb").read())
        raw[-10] ^= 0xFF  # corrupt the 2nd segment's delta record
        open(segs[1], "wb").write(bytes(raw))
        r = TimelineReader(d)
        eps = [(m, w, c.copy()) for m, w, c in r.epochs()]
        assert r.truncated
        # epoch 3 (the corrupt delta) is gone; the next keyframe resyncs,
        # so the final cumulative is still exact.
        assert [m.epoch for m, _, _ in eps] == [0, 1, 2, 4, 5, 6, 7]
        assert eps[-1][2].root == tree.root


class TestSealers:
    def v2_samples(self, spec):
        """spec: list of (leaf_tag, count) -> RawSamples sharing a root."""
        out = []
        sid = 0
        for tag, count in spec:
            frames = [
                RawFrame("/srv/app/src/repro/serve.py", "serve_step", 10),
                RawFrame("/srv/app/src/repro/model.py", tag, 20),
            ]
            for _ in range(count):
                out.append(RawSample(0.0, 1, "MainThread", frames, None))
            sid += 1
        return out

    def test_count_sealer_exact_and_keyframes(self, tmp_path):
        d = str(tmp_path / "tl")
        ing = TreeIngestor()
        w = TimelineWriter(d, epochs_per_segment=3)
        s = CountSealer(ing.tree, w)
        enc_sid = 0
        for epoch in range(8):
            for tag, count in [("attention", 5), ("mlp", 3)]:
                frames = [
                    RawFrame("/r/serve.py", "serve_step", 1),
                    RawFrame("/r/model.py", tag, 2),
                ]
                for _ in range(count):
                    ing.ingest(RawSample(0.0, 1, "MainThread", frames, enc_sid))
                enc_sid += 1
            entries, untracked = ing.drain_epoch()
            assert not untracked
            s.seal(entries, wall_time=float(epoch))
        w.close()
        r = TimelineReader(d)
        last = r.last()
        assert last is not None and last[1].root == ing.tree.root
        eps = read_epochs(d)
        assert len(eps) == 8 and all(w.total() == 8.0 for _, w, _ in eps)

    def test_count_sealer_untracked_forces_keyframe(self, tmp_path):
        d = str(tmp_path / "tl")
        ing = TreeIngestor()
        w = TimelineWriter(d, epochs_per_segment=100)
        s = CountSealer(ing.tree, w)
        # epoch 0: interned (v2) samples
        frames = [RawFrame("/r/a.py", "f", 1)]
        ing.ingest(RawSample(0.0, 1, "T", frames, 0))
        entries, untracked = ing.drain_epoch()
        s.seal(entries, wall_time=0.0, untracked=untracked)
        # epoch 1: a legacy v1 sample (stack_id None) -> untracked
        ing.ingest(RawSample(0.1, 1, "T", [RawFrame("/r/b.py", "g", 2)], None))
        entries, untracked = ing.drain_epoch()
        assert untracked
        s.seal(entries, wall_time=1.0, untracked=untracked)
        w.close()
        last = TimelineReader(d).last()
        assert last is not None and last[1].root == ing.tree.root

    def test_epoch_sealer_full_walk_matches_chain_tracking(self, tmp_path):
        da, db = str(tmp_path / "a"), str(tmp_path / "b")
        ta, tb = CallTree(), CallTree()
        sa = EpochSealer(ta, TimelineWriter(da))
        sb = EpochSealer(tb, TimelineWriter(db))
        for e in range(5):
            chains = []
            for t, chains_out in ((ta, chains), (tb, None)):
                for stack in (["m", "x"], ["m", "y", "z"]):
                    ch = t.path_nodes(stack)
                    CallTree.add_stack_nodes(ch)
                    if chains_out is not None:
                        chains_out.append(ch)
            sa.seal(chains, wall_time=float(e))
            sb.seal(None, wall_time=float(e), full_walk=True)
        assert TimelineReader(da).last()[1].root == ta.root
        assert TimelineReader(db).last()[1].root == tb.root
        assert ta.root == tb.root


def window(spec, extra=()) -> CallTree:
    t = CallTree()
    for stack, count in list(spec) + list(extra):
        t.add_stack(stack, {"samples": float(count)})
    return t


class TestTrendDetector:
    SPIN = (("t", "spin", "lock_wait"), 95.0)
    WORK = [ (("t", "serve", "model"), 3.0), (("t", "data"), 2.0) ]

    def test_livelock_needs_zero_progress(self):
        det = TrendDetector(TrendRule(epochs=3, min_baseline_epochs=99))
        # dominant every epoch but progress grows -> DOMINANT only
        kinds = set()
        for e in range(6):
            for v in det.observe_epoch(window([self.SPIN], self.WORK), progress=float(e)):
                kinds.add(v.kind)
        assert DOMINANT in kinds and LIVELOCK not in kinds

    def test_livelock_stamped_at_onset_epoch(self):
        det = TrendDetector(TrendRule(epochs=3, min_baseline_epochs=99))
        verdicts = []
        # progress grows for epochs 0-2, freezes from epoch 3 on
        for e in range(8):
            progress = float(min(e, 3))
            verdicts += det.observe_epoch(window([self.SPIN], self.WORK), progress=progress)
        livelocks = [v for v in verdicts if v.kind == LIVELOCK]
        assert livelocks, [v.kind for v in verdicts]
        # progress last grew at epoch 3; the stalled-dominance run began at 4
        assert livelocks[0].began_epoch == 4
        assert livelocks[0].epoch == 6  # 3 stalled epochs: 4, 5, 6
        assert livelocks[0].path == ("t", "spin", "lock_wait")

    def test_plain_dominance_not_livelock_on_short_stall(self):
        det = TrendDetector(TrendRule(epochs=3, min_baseline_epochs=99))
        verdicts = []
        # progress stalls for only 2 epochs, then grows again
        for _e, p in enumerate([0.0, 1.0, 2.0, 2.0, 2.0, 3.0, 4.0]):
            verdicts += det.observe_epoch(window([self.SPIN], self.WORK), progress=p)
        assert all(v.kind != LIVELOCK for v in verdicts)

    def test_drift_vs_trailing_baseline(self):
        det = TrendDetector(TrendRule(drift_threshold=0.3, min_baseline_epochs=3))
        steady = [(("t", "serve", "model"), 6.0), (("t", "data"), 4.0)]
        shifted = [(("t", "serve", "model"), 1.0), (("t", "compile", "xla"), 9.0)]
        verdicts = []
        for e in range(5):
            verdicts += det.observe_epoch(window(steady), progress=float(e))
        assert all(v.kind != SHARE_DRIFT for v in verdicts)
        drift = det.observe_epoch(window(shifted), progress=6.0)
        kinds = [v.kind for v in drift]
        assert SHARE_DRIFT in kinds
        v = next(v for v in drift if v.kind == SHARE_DRIFT)
        assert v.began_epoch == 5 and v.share >= 0.3

    def test_segment_phases(self):
        a = {"x": 0.8, "y": 0.2}
        b = {"x": 0.1, "z": 0.9}
        assert segment_phases([a, a, a, b, b]) == [(0, 2), (3, 4)]
        assert segment_phases([a]) == [(0, 0)]
        assert segment_phases([]) == []




class TestDifferential:
    def test_share_regressions_only_increases(self):
        base = window([(("t", "model"), 8.0), (("t", "data"), 2.0)])
        cur = window([(("t", "model"), 4.0), (("t", "data"), 1.0), (("t", "spin"), 5.0)])
        regs = share_regressions(base, cur, tolerance=0.05)
        names = [r[0] for r in regs]
        assert names == ["spin"]  # data/model *lost* share: not regressions
        assert regs[0][3] == pytest.approx(0.5)

    def test_render_diff_shows_signed_deltas(self):
        a = window([(("t", "model"), 8.0), (("t", "data"), 2.0)])
        b = window([(("t", "model"), 2.0), (("t", "data"), 8.0)])
        out = render_diff(a, b, label_a="base", label_b="cand")
        assert "t/model" in out and "t/data" in out
        assert "+60.00%" in out and "-60.00%" in out


class TestCheckCLI:
    @pytest.fixture
    def gate(self, tmp_path):
        base_snap = str(tmp_path / "base.snap")
        good = str(tmp_path / "good")
        bad = str(tmp_path / "bad")
        tree = CallTree.from_json(gen_workload.build(good).to_json())  # the JAX package writes the profiles
        save_snapshot(tree, base_snap)
        gen_workload.build(bad, inject_hot_loop=True)
        return base_snap, good, bad

    def test_check_pass(self, gate, capsys):
        base, good, _ = gate
        rc = profilerd_main(["check", good, "--baseline", base, "--tolerance", "0.02"])
        assert rc == 0
        assert "PASS" in capsys.readouterr().out

    def test_check_regression(self, gate, capsys):
        base, _, bad = gate
        rc = profilerd_main(["check", bad, "--baseline", base, "--tolerance", "0.02"])
        assert rc == 2
        out = capsys.readouterr().out
        assert "REGRESSION" in out and "spin_retry_loop" in out

    def test_check_missing_baseline(self, gate, tmp_path):
        _, good, _ = gate
        rc = profilerd_main(
            ["check", good, "--baseline", str(tmp_path / "nope.snap")]
        )
        assert rc == 3

    def test_check_missing_profile(self, gate, tmp_path):
        base, _, _ = gate
        rc = profilerd_main(["check", str(tmp_path / "nope"), "--baseline", base])
        assert rc == 3

    def test_check_accepts_tree_json_and_snap(self, gate, tmp_path):
        base, good, _ = gate
        rc = profilerd_main(
            ["check", os.path.join(good, "tree.json"), "--baseline", base]
        )
        assert rc == 0

    def test_committed_ci_baseline_matches_workload(self):
        """The committed baseline gates the deterministic workload (the CI
        profile-gate contract); regenerate with gen_workload.py --snapshot
        if the workload ever changes deliberately."""
        committed = os.path.join(os.path.dirname(__file__), "data", "ci_baseline.snap")
        _meta, tree = load_snapshot(committed)
        assert tree.root == CallTree.from_json(gen_workload.build(None).to_json()).root

    def test_diff_cli(self, gate, capsys):
        base, good, bad = gate
        rc = profilerd_main(["diff", good, bad, "--self-only"])
        assert rc == 0
        assert "spin_retry_loop" in capsys.readouterr().out

    def test_timeline_cli(self, gate, capsys):
        _, good, _ = gate
        rc = profilerd_main(["timeline", "--store", good])
        assert rc == 0
        out = capsys.readouterr().out
        assert "phase epochs 0..7" in out and "scores" in out

    def test_timeline_cli_missing(self, tmp_path):
        assert profilerd_main(["timeline", "--store", str(tmp_path / "none")]) == 3

    def test_check_empty_profile_is_unreadable_not_pass(self, gate, tmp_path):
        # A profile with zero samples must not pass vacuously: the gate
        # would otherwise go green exactly when profiling broke.
        base, _, _ = gate
        empty = tmp_path / "empty.json"
        empty.write_text(CallTree().to_json())
        rc = profilerd_main(["check", str(empty), "--baseline", base])
        assert rc == 3

    def test_check_falls_back_to_tree_json_when_ring_undecodable(self, gate, tmp_path):
        # Daemon killed mid-keyframe: ring has a header-only segment, but a
        # valid tree.json sits beside it — check must use it, not exit 3.
        base, good, _ = gate
        out = tmp_path / "out"
        out.mkdir()
        (out / "tree.json").write_text(gen_workload.build(None).to_json())
        ring = out / "timeline"
        ring.mkdir()
        seg = ring / "seg-0000000000.tl"
        seg.write_bytes(b"")  # crash before the header landed
        rc = profilerd_main(["check", str(out), "--baseline", base])
        assert rc == 0


class TestDaemonStatusJson:
    def test_tree_json_profile_roundtrip(self, tmp_path):
        # load_profile on a daemon-style out dir without a timeline falls
        # back to tree.json
        from repro_torch.profilerd.profiles import load_profile

        out = tmp_path / "out"
        out.mkdir()
        t = sample_tree()
        (out / "tree.json").write_text(t.to_json())
        assert load_profile(str(out)).root == t.root



# -- the port held to the JAX package, exactly ------------------------------------


def _both(stacks) -> tuple:
    """The same (stack, metrics) list as a port tree and a JAX package tree."""
    port, ref = CallTree(), jax_calltree.CallTree()
    for stack, metrics in stacks:
        port.add_stack(stack, metrics)
        ref.add_stack(stack, metrics)
    return port, ref


def _random_stacks(seed: int, n: int = 60) -> list:
    rng = random.Random(seed)
    names = ["thread::main", "thread::w", "serve", "model", "attention", "mlp", "data", "é"]
    out = []
    for _ in range(n):
        stack = ["thread::main" if rng.random() < 0.7 else "thread::w"] + rng.sample(names[2:], rng.randint(0, 4))
        metrics = {"samples": float(rng.randint(1, 5))}
        if rng.random() < 0.2:
            metrics["flops"] = rng.random() * 1e9
        out.append((stack, metrics))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_save_snapshot_writes_the_jax_packages_bytes(tmp_path, seed):
    port, ref = _both(_random_stacks(seed))
    save_snapshot(port, str(tmp_path / "p.snap"), EpochMeta(seed, wall_time=1.5, progress=3.0))
    jax_snapshot.save_snapshot(ref, str(tmp_path / "j.snap"), jax_snapshot.EpochMeta(seed, wall_time=1.5, progress=3.0))
    assert (tmp_path / "p.snap").read_bytes() == (tmp_path / "j.snap").read_bytes()
    meta, back = jax_snapshot.load_snapshot(str(tmp_path / "p.snap"))
    assert back.to_json() == port.to_json() and meta.epoch == seed


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_timeline_reader_reads_the_others_ring(tmp_path, writer):
    """A ring of keyframes, deltas and dropped segments written by one
    package reads back epoch by epoch, tree by tree, in the other's reader."""
    mods = {"port": (CallTree, TimelineWriter, EpochSealer), "jax": (jax_calltree.CallTree, jax_snapshot.TimelineWriter,
                                                                      jax_snapshot.EpochSealer)}
    tree_cls, writer_cls, sealer_cls = mods[writer]
    d = str(tmp_path / "tl")
    tree = tree_cls()
    w = writer_cls(d, epochs_per_segment=3, max_segments=3)
    s = sealer_cls(tree, w)
    rng = random.Random(0)
    for e in range(14):
        chains = []
        for stack, metrics in _random_stacks(e, n=rng.randint(1, 12)):
            ch = tree.path_nodes(stack)
            tree_cls.add_stack_nodes(ch, metrics["samples"])
            chains.append(ch)
        s.seal(chains, wall_time=float(e), progress=float(e // 2))
    w.close()
    port_epochs = read_epochs(d, copy_cumulative=True)
    jax_epochs = jax_snapshot.read_epochs(d, copy_cumulative=True)
    assert [m.epoch for m, _, _ in port_epochs] == [m.epoch for m, _, _ in jax_epochs] == list(range(6, 14))
    for (pm, pw, pc), (jm, jw, jc) in zip(port_epochs, jax_epochs):
        assert dataclasses.astuple(pm) == dataclasses.astuple(jm)
        assert pw.to_json() == jw.to_json() and pc.to_json() == jc.to_json()
    assert TimelineReader(d).last()[1].to_json() == tree.to_json()


def _windows(seed: int, n: int = 24) -> list:
    """A sequence of epoch windows: a stable mix, then a spin that takes over
    with progress stalled, then a drift to another mix."""
    rng = random.Random(seed)
    work = [(("t", "serve", "model"), 3.0), (("t", "data"), 2.0), (("t", "serve", "attention"), 1.0)]
    out = []
    for e in range(n):
        spec = [(p, c * rng.uniform(0.5, 1.5)) for p, c in work]
        if n // 3 <= e < 2 * n // 3:
            spec.append((("t", "spin", "lock_wait"), 95.0))
        elif e >= 2 * n // 3:
            spec = [(("t", "ckpt", "write"), 40.0 * rng.uniform(0.8, 1.2))] + spec
        progress = float(min(e, n // 3)) if e < 2 * n // 3 else float(e)
        out.append((spec, progress))
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("rule_kw", [{}, dict(epochs=2, min_baseline_epochs=2), dict(threshold=0.6, drift_threshold=0.2)])
def test_trend_verdicts_equal_the_jax_packages(seed, rule_kw):
    port, ref = TrendDetector(TrendRule(**rule_kw)), jax_detector.TrendDetector(jax_detector.TrendRule(**rule_kw))
    got, want = [], []
    for e, (spec, progress) in enumerate(_windows(seed)):
        p, r = _both([(list(s), {"samples": c}) for s, c in spec])
        got += [dataclasses.astuple(v) for v in port.observe_epoch(p, progress=progress, epoch=e, wall_time=float(e))]
        want += [dataclasses.astuple(v) for v in ref.observe_epoch(r, progress=progress, epoch=e, wall_time=float(e))]
    assert got == want
    assert {v[0] for v in got} & {DOMINANT, LIVELOCK, SHARE_DRIFT}


@pytest.mark.parametrize("seed", range(3))
def test_straggler_verdicts_equal_the_jax_packages(seed):
    rng = random.Random(seed)
    port, ref = StragglerDetector(threshold=0.3), jax_detector.StragglerDetector(threshold=0.3)
    flagged = 0
    for _ in range(8):
        hosts = {}
        for h in range(4):
            leaf = "stuck" if h == seed and rng.random() < 0.7 else "step"
            hosts[f"h{h}"] = _both([(["t", "train", leaf], {"samples": rng.uniform(5, 20)}),
                                    (["t", "data"], {"samples": rng.uniform(1, 4)})])
        got = port.observe({k: v[0] for k, v in hosts.items()})
        want = ref.observe({k: v[1] for k, v in hosts.items()})
        assert got == want
        flagged += len(got)
    assert flagged > 0


def test_segment_phases_and_share_distance_equal_the_jax_packages():
    from repro_torch.core.detector import flat_shares, share_distance

    vectors = []
    for spec, _ in _windows(0):
        p, r = _both([(list(s), {"samples": c}) for s, c in spec])
        vectors.append((flat_shares(p), jax_detector.flat_shares(r)))
    assert segment_phases([v[0] for v in vectors]) == jax_detector.segment_phases([v[1] for v in vectors])
    for (a, ja), (b, jb) in zip(vectors, vectors[1:]):
        assert share_distance(a, b) == jax_detector.share_distance(ja, jb)
