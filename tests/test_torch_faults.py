"""The port's fault corpus (``repro_torch.faults``) on the CPU, against the
JAX package's ``repro.faults``, and the port's daemon plumbing the corpus
rests on, against ``repro.profilerd.daemon`` and ``repro.core.detector``.

Each test feeds both packages the same inputs and holds their outputs equal
(pure Python and integer counts, so the tolerance is equality, except the
MoE driver's dropped fraction: 1e-6):

* the registry — every scenario's description, rules, expected kinds, host
  count, harness side and stall timeout, ``SMOKE_SCENARIOS`` and the
  harness's defaults;
* the scoreboard — ``detector_of``, ``score_runs``, ``build_bench``,
  ``floor_report`` and ``diff_bench`` on the event lists of
  ``tests/test_faults.py`` and on seeded random ones;
* ``bench`` — the CLIs' documents from the same canned runs, equal apart
  from the port's ``config["device"]``;
* the drivers — the clean phase's compute call for call, the MoE driver's
  dropped fractions on the same parameters and tokens, the serving driver's
  tokens on the same weights; the rule patterns the port's resolver must
  produce; no torch in ``list``; a driver placed on a card that is not there
  raises;
* the daemon plumbing — ``tests/test_faults.py``'s fault markers, attach
  backoff, rule specs, callback hardening, trend recovery and the
  phase/straggler edges, pointed at the port and held to the JAX package.

The end-to-end runs through child processes are in
``tests/test_torch_faults_e2e.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import repro.core.detector as jdet
import repro.faults as jfaults
import repro.faults.__main__ as jcli
import repro.faults.scoreboard as jscore
import repro.profilerd.daemon as jdaemon
import repro.profilerd.sources as jsources
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.profilerd.resolver import SymbolResolver as JaxResolver
from repro_torch import faults
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.calltree import CallTree
from repro_torch.core.detector import (
    LIVELOCK,
    LIVELOCK_CLEARED,
    DominanceDetector,
    Rule,
    StragglerDetector,
    TrendDetector,
    TrendRule,
    WatchdogLoop,
    segment_phases,
)
from repro_torch.data.pipeline import Pipeline
from repro_torch.faults import __main__ as cli
from repro_torch.faults import scoreboard
from repro_torch.faults.base import ScenarioContext
from repro_torch.profilerd import daemon as tdaemon
from repro_torch.profilerd import sources as tsources
from repro_torch.profilerd.resolver import SymbolResolver
from repro_torch.profilerd.spool import SpoolWriter
from repro_torch.profilerd.wire import Encoder, RawFrame, RawSample

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
DROPPED_ATOL = 1e-6


def wait_until(pred, timeout_s=10.0, interval_s=0.01, desc="condition"):
    deadline = time.monotonic() + timeout_s
    while True:
        value = pred()
        if value:
            return value
        if time.monotonic() >= deadline:
            raise AssertionError(f"timed out after {timeout_s:g}s waiting for {desc}")
        time.sleep(interval_s)


# ---------------------------------------------------------------------------
# the registry


def _rule(r) -> tuple:
    return (r.pattern, r.threshold, r.consecutive, r.kind, r.self_only, r.min_window_total)


@pytest.mark.parametrize("name", sorted(jfaults.SCENARIOS))
def test_scenario_equals_the_jax_packages(name):
    s, j = faults.SCENARIOS[name], jfaults.SCENARIOS[name]
    assert (s.name, s.description, s.expected_kinds, s.n_hosts, s.harness_side, s.stall_timeout_s,
            s.extra_child_env) == (j.name, j.description, j.expected_kinds, j.n_hosts, j.harness_side,
                                   j.stall_timeout_s, j.extra_child_env)
    assert [_rule(r) for r in s.rules] == [_rule(r) for r in j.rules]
    # the model drivers need torch where the JAX package's need jax
    assert s.requires == tuple("torch" if m == "jax" else m for m in j.requires)
    assert s.make_driver.__name__ == j.make_driver.__name__


def test_registry_and_harness_defaults_equal_the_jax_packages():
    assert list(faults.SCENARIOS) == list(jfaults.SCENARIOS)
    assert faults.SMOKE_SCENARIOS == jfaults.SMOKE_SCENARIOS
    assert [s for s in faults.SCENARIOS.values() if s.requires] == [
        faults.SCENARIOS["moe_imbalance"], faults.SCENARIOS["serve_convoy"]]
    port = dataclasses.asdict(faults.HarnessConfig())
    assert (port.pop("device"), port.pop("smoke")) == ("cuda", False)
    assert port == dataclasses.asdict(jfaults.HarnessConfig())
    assert faults.__all__ == jfaults.__all__
    with pytest.raises(KeyError, match="unknown scenario"):
        faults.get_scenario("nope")


# ---------------------------------------------------------------------------
# the scoreboard


def _ev(kind, detector=None, wall=100.0, **extra):
    ev = {"kind": kind, "wall_time": wall}
    if detector is not None:
        ev["detector"] = detector
    ev.update(extra)
    return ev


# the events tests/test_faults.py classifies and scores
REFERENCE_EVENTS = [
    _ev("LIVELOCK_SUSPECT", "dominance"), _ev("LIVELOCK", "trend"), _ev("SHARE_DRIFT", "trend"),
    _ev("TARGET_STALLED", "stall"), _ev("STRAGGLER", "straggler"), _ev("DOMINANT", "trend"),
    *[_ev(k) for k in ("TARGET_ATTACHED", "FAULT_INJECT", "FAULT_CLEAR", "CALLBACK_FAILED", "SOURCE_GAVE_UP",
                       "FAULT_MARKER_INVALID")],
    _ev("LIVELOCK_CLEARED", "trend"), _ev("TARGET_RESUMED", "stall"),
    _ev("LIVELOCK_SUSPECT", "dominance", wall=101.0), _ev("LIVELOCK_SUSPECT", "dominance", wall=99.0),
    _ev("SHARE_DRIFT", "trend", wall=104.9), _ev("SHARE_DRIFT", "trend", wall=105.1),
    _ev("LIVELOCK", "trend", wall=101.0), _ev("LIVELOCK_CLEARED", "trend", wall=104.5),
    _ev("TARGET_RESUMED", "stall", wall=104.5),
]
KINDS = sorted(scoreboard.UNSCORED_KINDS | scoreboard.RECOVERY_KINDS | {
    "LIVELOCK_SUSPECT", "LIVELOCK", "SHARE_DRIFT", "TARGET_STALLED", "STRAGGLER", "DOMINANT", "MOE_IMBALANCE",
    "LOCK_CONVOY", "INPUT_STARVED", "CKPT_WEDGE", "COLLECTIVE_STALL"})
DETECTORS = [None, "dominance", "trend", "stall", "straggler", "harness", "daemon"]


def _random_events(rng: random.Random, n: int) -> list[dict]:
    return [_ev(rng.choice(KINDS), rng.choice(DETECTORS), wall=rng.uniform(95.0, 112.0)) for _ in range(n)]


def _score(pkg, fault, control, **kw):
    cells = pkg.score_runs(fault, control, t_inject=100.0, t_clear=104.0, epoch_s=0.5, **kw)
    return cells, {col: cell.to_json() for col, cell in cells.items()}


def test_scoreboard_constants_equal_the_jax_packages():
    assert scoreboard.DETECTOR_COLUMNS == jscore.DETECTOR_COLUMNS
    assert scoreboard.UNSCORED_KINDS == jscore.UNSCORED_KINDS
    assert scoreboard.RECOVERY_KINDS == jscore.RECOVERY_KINDS
    assert [scoreboard.detector_of(e) for e in REFERENCE_EVENTS] == [jscore.detector_of(e) for e in REFERENCE_EVENTS]


def test_reference_events_score_as_the_jax_package_scores_them():
    for kw in ({}, {"grace_epochs": 2}):
        _, got = _score(scoreboard, REFERENCE_EVENTS, REFERENCE_EVENTS[:6], **kw)
        _, want = _score(jscore, REFERENCE_EVENTS, REFERENCE_EVENTS[:6], **kw)
        assert got == want
    assert got["dominance"]["detected"] and got["dominance"]["fault_run_fps"] >= 1
    assert got["trend_livelock"]["recovery_observed"] and got["stall"]["recovery_observed"]


@pytest.mark.parametrize("seed", range(6))
def test_random_runs_score_bench_floor_and_diff_as_the_jax_package(seed):
    rng = random.Random(seed)
    port_cells, jax_cells = {}, {}
    for scen in ("a", "b", "c"):
        fault, control = _random_events(rng, rng.randint(0, 30)), _random_events(rng, rng.randint(0, 3))
        assert [scoreboard.detector_of(e) for e in fault] == [jscore.detector_of(e) for e in fault]
        g = rng.randint(0, 4)
        port_cells[scen], got = _score(scoreboard, fault, control, grace_epochs=g)
        jax_cells[scen], want = _score(jscore, fault, control, grace_epochs=g)
        assert got == want
    floor = rng.choice([2.0, 5.0, 10.0])
    got = scoreboard.build_bench(port_cells, config={"seed": seed}, skipped={"d": "why"}, ttd_floor_epochs=floor)
    want = jscore.build_bench(jax_cells, config={"seed": seed}, skipped={"d": "why"}, ttd_floor_epochs=floor)
    assert got == want
    assert scoreboard.floor_report(port_cells, ttd_floor_epochs=floor) == jscore.floor_report(
        jax_cells, ttd_floor_epochs=floor)
    other = scoreboard.build_bench({"a": port_cells["b"], "b": port_cells["a"]}, config={})
    assert scoreboard.diff_bench(got, other) == jscore.diff_bench(want, other)
    assert scoreboard.diff_bench(other, got) == jscore.diff_bench(other, want)


def test_diff_against_the_committed_cpu_bench_equals_the_jax_packages():
    with open(os.path.join(ROOT, "BENCH_detect.json")) as f:
        base = json.load(f)
    rng = random.Random(7)
    cells = {name: scoreboard.score_runs(_random_events(rng, 20), [], t_inject=100.0, t_clear=104.0, epoch_s=0.4)
             for name in list(base["matrix"])[:4]}
    new = scoreboard.build_bench(cells, config={}, skipped={"hard_wedge": "not selected"})
    assert scoreboard.diff_bench(base, new) == jscore.diff_bench(base, new)
    assert scoreboard.diff_bench(base, base) == [] == jscore.diff_bench(base, base)


# ---------------------------------------------------------------------------
# bench: the CLIs' documents from the same canned runs


def _canned_events(name: str, control: bool) -> list[dict]:
    rng = random.Random(f"{name}/{control}")
    events = [_ev("TARGET_ATTACHED", wall=100.2)]
    if not control:
        events += [_ev("FAULT_INJECT", "harness", wall=101.0), _ev("FAULT_CLEAR", "harness", wall=105.2)]
        events += _random_events(rng, 12)
    elif rng.random() < 0.3:
        events.append(_ev("SHARE_DRIFT", "trend", wall=103.0))
    return events


def _fake_run(result_cls):
    def run(scenario, cfg=None, *, control=False):
        return result_cls(scenario=scenario.name, control=control, events=_canned_events(scenario.name, control),
                          status={}, t_start=100.0, t_inject=None if control else 101.0,
                          t_clear=None if control else 105.2, epoch_s=cfg.epoch_s)
    return run


@pytest.mark.parametrize("extra", [[], ["--smoke"], ["--scenarios", "moe_imbalance,serve_convoy", "--check"],
                                   ["--check", "--baseline", os.path.join(ROOT, "BENCH_detect.json")]],
                         ids=["all", "smoke", "models-check", "baseline-check"])
def test_bench_document_equals_the_jax_packages(extra, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cli, "run_scenario", _fake_run(faults.RunResult))
    monkeypatch.setattr(jcli, "run_scenario", _fake_run(jfaults.RunResult))
    # the JAX package skips its model scenarios where jax is missing; both have it here
    rc = cli.main(["bench", "--device", "cpu", "--out", str(tmp_path / "port.json"), *extra])
    jrc = jcli.main(["bench", "--out", str(tmp_path / "jax.json"), *extra])
    assert rc == jrc
    got, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert got["config"].pop("device") == "cpu"
    assert got == want
    assert (tmp_path / "port.json").read_bytes().count(b"\n") > 10


# ---------------------------------------------------------------------------
# the drivers


def _fresh_mix(pkg: str) -> list[str]:
    code = (f"from {pkg}.faults.base import mix_compute\n"
            "print(repr([mix_compute(i) for i in range(16)]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_clean_phase_compute_equals_the_jax_packages_call_for_call():
    got = _fresh_mix("repro_torch")
    assert got == _fresh_mix("repro")
    assert len(eval(got)) == 16  # noqa: S307 -- our own repr of 16 floats


def _ctx(tmp_path, device="cpu"):
    return ScenarioContext(0, 1, str(tmp_path), device=device, smoke=True)


def test_moe_driver_drops_as_the_jax_driver_on_the_same_tokens(tmp_path):
    """deepseek-moe-16b smoke on the CPU, the JAX driver's ``moe_spec``
    parameters carried across: the dropped fraction of 4 clean and 4
    collapsed batches from ``default_rng(11)`` equal within 1e-6; clean under
    0.5, collapsed over it. Then the port driver's own steps record both."""
    jax = pytest.importorskip("jax")
    import torch

    from repro.faults.scenarios import MoEImbalanceDriver as JaxMoE
    from repro_torch.faults.scenarios import (
        MoEImbalanceDriver,
        collapsed_router_tokens,
        make_router_tokens,
    )
    from repro_torch.models.modules import tree_map_with_path

    jd, td = JaxMoE(ScenarioContext(0, 1, str(tmp_path))), MoEImbalanceDriver(_ctx(tmp_path))
    jd.warmup()
    td.warmup()
    jparams = jax.tree.map(np.asarray, jd.params)

    def carried(path, leaf):
        a = jparams
        for k in path:
            a = a[k]
        assert a.shape == tuple(leaf.shape) and leaf.dtype == torch.float32
        return torch.from_numpy(np.array(a, np.float32))

    td.params = tree_map_with_path(carried, td.params)
    rng = np.random.default_rng(11)
    B, S, D = td.BATCH, td.SEQ, td.cfg.d_model
    v = 3.0 * rng.standard_normal(D).astype(np.float32)
    xs = [make_router_tokens(rng, B, S, D) for _ in range(4)]
    xs += [collapsed_router_tokens(rng, B, S, D, v) for _ in range(4)]
    got = [float(td._step_fn(td.params, x)[1]["dropped_frac"]) for x in xs]
    want = [float(jd._step_fn(jd.params, x)[1]["dropped_frac"]) for x in xs]
    np.testing.assert_allclose(got, want, rtol=0, atol=DROPPED_ATOL)
    assert max(got[:4]) < 0.5 < min(got[4:])
    assert td.capacity == 48 and got[4] == pytest.approx(1 - 2 * 48 / (B * S * 2))  # 2 experts x 48 slots kept

    td.step()  # clean
    td.inject()
    td.stop_event = threading.Event()
    td.stop_event.set()  # shutting down: the retry loop bails at once
    td.step()
    summary = td.summary()
    assert summary["dropped_frac"]["clean"]["n"] == 1 and summary["dropped_frac"]["clean"]["max"] < 0.5
    assert summary["dropped_frac"]["collapsed"]["min"] > 0.5 and summary["tokens"] == 128


def test_serve_driver_round_gives_the_jax_drivers_tokens(tmp_path):
    """gemma-2b smoke on the CPU, the JAX driver's server weights carried
    across: one round of the port's driver (two 4-token prompts of
    ``default_rng(3)``, 6 new tokens, a fresh decode state) gives the JAX
    driver's tokens."""
    jax = pytest.importorskip("jax")

    from repro.faults.scenarios import ServeConvoyDriver as JaxServe
    from repro_torch.faults.scenarios import ServeConvoyDriver
    from repro_torch.params import params_from_numpy

    jd, td = JaxServe(ScenarioContext(0, 1, str(tmp_path))), ServeConvoyDriver(_ctx(tmp_path))
    try:
        jd.warmup()
        td.warmup()
        td.server.params = params_from_numpy(jax.tree.map(np.asarray, jd.server.params), td.model.cfg, "cpu")
        jreqs = []
        run = jd.server.run
        jd.server.run = lambda reqs: (jreqs.extend(reqs), run(reqs))[1]
        for _ in range(2):
            reqs = td._run_round()
            jd._run_round()
            want = [r.out for r in jreqs[-2:]]
            assert [r.out for r in reqs] == want
            assert all(len(o) == 6 for o in want)
            assert [list(r.prompt) for r in reqs] == [list(r.prompt) for r in jreqs[-2:]]
        assert td._scraper.name == "serve-metrics-scraper" and td._scraper.is_alive()
        assert td.server.metrics.snapshot()["steps"] == td.server.steps
    finally:
        jd.close()
        td.close()


@pytest.mark.parametrize("name", ["moe_imbalance", "serve_convoy"])
def test_a_model_driver_placed_on_a_missing_card_raises(name, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    driver = faults.SCENARIOS[name].make_driver(_ctx(tmp_path, device="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.warmup()


def test_resolver_gives_the_rule_patterns_for_the_ports_seams():
    """``data_starvation`` and ``ckpt_wedge`` key on ``repro::__next__`` and
    ``repro::wait``: the port's resolver must give its own ``Pipeline`` and
    ``CheckpointManager`` frames those symbols (a mismatch would be silent:
    the rule would never fire), as the JAX package's gives its own."""
    rules = {s.name: s.rules[0].pattern for s in faults.SCENARIOS.values() if s.rules}
    for fn, scen in ((Pipeline.__next__, "data_starvation"), (CheckpointManager.wait, "ckpt_wedge")):
        code = fn.__code__
        assert "/repro_torch/" in code.co_filename
        assert SymbolResolver().symbol(code.co_filename, code.co_name) == rules[scen]
    jcode = JaxPipeline.__next__.__code__
    assert JaxResolver().symbol(jcode.co_filename, jcode.co_name) == rules["data_starvation"]
    # the scenario's own rule fires on a window the port's symbols dominate
    det = DominanceDetector(list(faults.SCENARIOS["data_starvation"].rules))
    cum, fired = CallTree(), []
    for _ in range(3):
        for i in range(40):
            leaf = ["repro::__next__", "queue::get"] if i % 4 else ["repro::mix_compute"]
            cum.add_stack(["thread::MainThread", "repro::step", *leaf])
        fired += det.observe(cum.copy())
    assert [e.kind for e in fired] and {e.kind for e in fired} == {"INPUT_STARVED"}


def test_list_loads_no_torch():
    code = ("import runpy, sys\nsys.argv = ['faults', 'list']\n"
            "try: runpy.run_module('repro_torch.faults', run_name='__main__')\n"
            "except SystemExit as e: assert not e.code, e.code\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]"
    assert sum(1 for line in lines if line.split()[0] in faults.SCENARIOS) == 7


def test_bench_device_label():
    assert cli.device_label("cpu") == "cpu"


# ---------------------------------------------------------------------------
# daemon plumbing (tests/test_faults.py's classes, pointed at the port)


class FakeTarget:
    """Deterministic spool publisher (tests/test_faults.py's)."""

    def __init__(self, path, leaf: str = "leaf_fn", pid: int = 0):
        self.path = str(path)
        self.leaf = leaf
        self.writer = SpoolWriter(self.path, capacity=1 << 20)
        self.enc = Encoder()
        self.n = 0
        self.writer.write(self.enc.encode_hello(pid or os.getpid(), 0.01))

    def emit(self, k: int = 1, leaf=None):
        frames = [RawFrame("/fake/app.py", "main", 1), RawFrame("/fake/app.py", leaf or self.leaf, 2)]
        for _ in range(k):
            payload, fresh = self.enc.encode_tick([RawSample(self.n * 0.01, 1, "w", frames)])
            if self.writer.write(payload):
                self.n += 1
            else:
                self.enc.rollback(fresh)
        return self

    def bye(self):
        self.writer.write_bye(self.enc.encode_bye(self.n))
        self.writer.close()


PKGS = {"port": (tdaemon, tsources), "jax": (jdaemon, jsources)}


def _marker_daemon(dmod, tmp_path, **cfg_kw):
    spool = str(tmp_path / "t.spool")
    target = FakeTarget(spool, leaf="work_fn")
    target.emit(5)
    cfg_kw.setdefault("epoch_s", 0.05)
    daemon = dmod.ProfilerDaemon(dmod.DaemonConfig(spool_paths=(spool,), out_dir=str(tmp_path / "out"), **cfg_kw))
    daemon.attach()
    daemon.drain()
    return daemon, target


def _write_marker(daemon, line: str):
    with open(os.path.join(daemon.out_dir, tdaemon.FAULT_MARKERS_FILENAME), "a") as f:
        f.write(line)


def _marker(op, scenario="spin", wall=123.0) -> str:
    return json.dumps({"op": op, "scenario": scenario, "wall_time": wall}) + "\n"


class TestFaultMarkerIngestion:
    def test_markers_become_events_with_epoch_stamp(self, tmp_path):
        daemon, target = _marker_daemon(tdaemon, tmp_path)
        _write_marker(daemon, _marker("inject"))
        daemon.drain()
        _write_marker(daemon, _marker("clear", wall=125.0))
        daemon.drain()
        kinds = [e["kind"] for e in daemon.events]
        assert "FAULT_INJECT" in kinds and "FAULT_CLEAR" in kinds
        inject = next(e for e in daemon.events if e["kind"] == "FAULT_INJECT")
        assert inject["scenario"] == "spin" and inject["detector"] == "harness"
        assert inject["marker_wall_time"] == 123.0
        assert "epoch" in inject and "target_epochs" in inject
        target.bye()

    def test_partial_marker_line_buffers_until_complete(self, tmp_path):
        daemon, target = _marker_daemon(tdaemon, tmp_path)
        full = _marker("inject", wall=1.0)
        _write_marker(daemon, full[:10])
        daemon.drain()
        assert not [e for e in daemon.events if e["kind"].startswith("FAULT_")]
        _write_marker(daemon, full[10:])
        daemon.drain()
        assert [e for e in daemon.events if e["kind"] == "FAULT_INJECT"]
        target.bye()

    def test_invalid_marker_line_is_loud_not_fatal(self, tmp_path):
        daemon, target = _marker_daemon(tdaemon, tmp_path)
        _write_marker(daemon, "not json at all\n")
        daemon.drain()
        assert [e for e in daemon.events if e["kind"] == "FAULT_MARKER_INVALID"]
        _write_marker(daemon, _marker("inject", scenario="s", wall=1.0))
        daemon.drain()
        assert [e for e in daemon.events if e["kind"] == "FAULT_INJECT"]
        target.bye()

    @pytest.mark.parametrize("chunks", [
        [_marker("inject"), _marker("clear", wall=125.0)],
        [_marker("inject")[:10], _marker("inject")[10:] + _marker("clear")[:5], _marker("clear")[5:]],
        ["not json at all\n", '{"scenario": "no op"}\n', "[1, 2]\n", _marker("inject", scenario="s"), "\n  \n"],
    ], ids=["whole", "partial", "invalid"])
    def test_both_daemons_publish_the_same_marker_events(self, tmp_path, chunks):
        """The same marker file, written in the same chunks, drained by both
        packages' daemons (epochs too long to seal, so both stamp epoch 0):
        equal events but for the wall time of ingestion."""
        out = {}
        for name, (dmod, _) in PKGS.items():
            (tmp_path / name).mkdir()
            daemon, target = _marker_daemon(dmod, tmp_path / name, epoch_s=60.0)
            for chunk in chunks:
                _write_marker(daemon, chunk)
                daemon.drain()
            out[name] = [{k: v for k, v in e.items() if k != "wall_time"} for e in daemon.events
                         if e["kind"].startswith("FAULT_")]
            target.bye()
        assert out["port"] == out["jax"] and out["port"]


def _gave_up(dmod, tmp_path):
    good, bad = str(tmp_path / "good.spool"), str(tmp_path / "bad.spool")
    target = FakeTarget(good, leaf="work_fn")
    target.emit(3)
    with open(bad, "wb") as f:
        f.write(b"this is not a spool file at all, padded " * 4)
    daemon = dmod.ProfilerDaemon(dmod.DaemonConfig(
        spool_paths=(good, bad), out_dir=str(tmp_path / "out"), attach_retry_base_s=0.01,
        attach_retry_cap_s=0.02, attach_max_attempts=3))
    daemon.attach()

    def gave_up():
        daemon.drain()
        return [e for e in daemon.events if e["kind"] == "SOURCE_GAVE_UP"]

    events = wait_until(gave_up, desc="SOURCE_GAVE_UP after retry budget")
    target.bye()
    return daemon, events, bad


class TestAttachBackoff:
    def test_garbage_target_gives_up_after_budget(self, tmp_path):
        daemon, events, bad = _gave_up(tdaemon, tmp_path)
        assert events[0]["path"] == bad and events[0]["attempts"] == 3 and events[0]["error"]
        rows = daemon.status()["attach_failures"]
        assert [r for r in rows if r["path"] == bad and r["gave_up"]]
        assert [e for e in daemon.events if e["kind"] == "SOURCE_ATTACH_FAILED"]

    def test_give_up_events_and_rows_equal_the_jax_daemons(self, tmp_path):
        out = {}
        for name, (dmod, _) in PKGS.items():
            (tmp_path / name).mkdir()
            daemon, _, bad = _gave_up(dmod, tmp_path / name)
            here = str(tmp_path / name)

            def norm(d):  # the run's own paths and times aside
                return {k: v.replace(here, "<dir>") if isinstance(v, str) else v for k, v in d.items()
                        if k not in ("wall_time", "retry_in_s")}

            out[name] = ([norm(e) for e in daemon.events if e["kind"].startswith("SOURCE_")],
                         [norm(r) for r in daemon.status()["attach_failures"]])
        assert out["port"] == out["jax"]

    @pytest.mark.parametrize("pkg", list(PKGS))
    def test_rewritten_file_gets_fresh_budget(self, tmp_path, pkg):
        calls = []

        def make_source(name, path):
            calls.append(path)
            return None

        bad = str(tmp_path / "bad.spool")
        with open(bad, "wb") as f:
            f.write(b"garbage-v1")
        ss = PKGS[pkg][1].SpoolSet(paths=(bad,), make_source=make_source, attach_retry_base_s=0.001,
                                    attach_retry_cap_s=0.002, attach_max_attempts=2)
        wait_until(lambda: (ss.discover(), bad in ss._given_up)[1], desc="give-up on garbage path")
        n_before = len(calls)
        ss.discover()
        assert len(calls) == n_before  # parked: no further attach attempts
        time.sleep(0.005)
        with open(bad, "wb") as f:
            f.write(b"garbage-v2-different-length")
        wait_until(lambda: (ss.discover(), len(calls) > n_before)[1], desc="revival after rewrite")

    def test_backoff_rows_expose_retry_countdown(self, tmp_path):
        rows = {}
        for name, (_, smod) in PKGS.items():
            bad = str(tmp_path / f"{name}.spool")
            with open(bad, "wb") as f:
                f.write(b"junk")
            ss = smod.SpoolSet(paths=(bad,), make_source=lambda name, path: None, attach_retry_base_s=5.0,
                               attach_max_attempts=4)
            ss.discover()
            rows[name] = ss.attach_failure_rows()
        assert rows["port"][0]["attempts"] == 1 and not rows["port"][0]["gave_up"]
        assert rows["port"][0]["retry_in_s"] > 0
        assert sorted(rows["port"][0]) == sorted(rows["jax"][0])
        assert [(r["attempts"], r["gave_up"]) for r in rows["port"]] == [(r["attempts"], r["gave_up"])
                                                                          for r in rows["jax"]]


RULES = [Rule(pattern="allreduce", threshold=0.6, consecutive=3, kind="COLLECTIVE_STALL", self_only=False,
              min_window_total=8.0),
         *[r for s in faults.SCENARIOS.values() for r in s.rules], Rule()]


class TestRuleSpecRoundtrip:
    @pytest.mark.parametrize("i", range(len(RULES)))
    def test_roundtrip_equals_the_jax_packages(self, i):
        rule = RULES[i]
        spec = tdaemon.rule_to_spec(rule)
        jrule = jdet.Rule(pattern=rule.pattern, threshold=rule.threshold, consecutive=rule.consecutive,
                          kind=rule.kind, self_only=rule.self_only, min_window_total=rule.min_window_total)
        assert spec == jdaemon.rule_to_spec(jrule)
        assert _rule(tdaemon.rule_from_spec(spec)) == _rule(rule) == _rule(jdaemon.rule_from_spec(spec))

    @pytest.mark.parametrize("spec", ["pattern=x,bogus=1", "pattern", "threshold=abc"])
    def test_bad_spec_rejected_by_both(self, spec):
        with pytest.raises(ValueError):
            tdaemon.rule_from_spec(spec)
        with pytest.raises(ValueError):
            jdaemon.rule_from_spec(spec)


# ---------------------------------------------------------------------------
# callback hardening, trend recovery, phase and straggler edges


def _window(leaf: str, n: int = 50, tree=CallTree) -> CallTree:
    t = tree()
    for _ in range(n):
        t.add_stack(["main", "loop", leaf])
    return t


def _diverse_window(n: int = 50, tree=CallTree) -> CallTree:
    t = tree()
    for i in range(n):
        t.add_stack(["main", "loop", f"op{i % 5}"])
    return t


class TestCallbackHardening:
    def _firing_detector(self, *callbacks, det_mod=None):
        if det_mod is None:
            det = DominanceDetector([Rule(threshold=0.5, consecutive=1, min_window_total=1)])
        else:
            det = det_mod.DominanceDetector([det_mod.Rule(threshold=0.5, consecutive=1, min_window_total=1)])
        for cb in callbacks:
            det.add_callback(cb)
        return det

    def test_poison_callback_does_not_break_later_callbacks(self):
        seen = []
        det = self._firing_detector(lambda ev: (_ for _ in ()).throw(RuntimeError("poison")), seen.append)
        fired = det.observe(_window("hot"))
        assert fired and seen == fired
        assert len(det.callback_failures) == 1
        ev, tb = det.callback_failures[0]
        assert ev is fired[0] and "poison" in tb

    def test_on_callback_error_hook_receives_traceback(self):
        hook_calls = []
        det = self._firing_detector(lambda ev: 1 / 0)
        det.on_callback_error = lambda ev, tb: hook_calls.append((ev, tb))
        det.observe(_window("hot"))
        assert len(hook_calls) == 1 and "ZeroDivisionError" in hook_calls[0][1]

    def test_failing_error_hook_is_swallowed(self):
        det = self._firing_detector(lambda ev: 1 / 0)
        det.on_callback_error = lambda ev, tb: (_ for _ in ()).throw(ValueError("sink"))
        assert det.observe(_window("hot"))

    def test_detector_keeps_firing_after_poison_as_the_jax_detector(self):
        from repro.core.calltree import CallTree as JaxTree

        out = {}
        for name, det_mod, tree in (("port", None, CallTree), ("jax", jdet, JaxTree)):
            det = self._firing_detector(lambda ev: 1 / 0, det_mod=det_mod)
            cum = _window("hot", tree=tree)
            fired = [det.observe(cum.copy())]
            for _ in range(50):
                cum.add_stack(["main", "loop", "hot"])
            fired.append(det.observe(cum.copy()))
            assert fired[-1] and len(det.callback_failures) == 2
            out[name] = [[(e.kind, tuple(e.path), e.share, e.window_index, e.describe()) for e in f] for f in fired]
        assert out["port"] == out["jax"]

    def test_watchdog_records_observe_errors_and_keeps_running(self):
        class BrokenSampler:
            def snapshot(self):
                raise RuntimeError("sampler exploded")

        wd = WatchdogLoop(BrokenSampler(), DominanceDetector([Rule()]), interval_s=0.01)
        wd.start()
        try:
            wait_until(lambda: len(wd.errors) >= 2, desc="watchdog surviving errors")
            assert wd._thread.name == "repro-prof-watchdog"
        finally:
            wd.stop()
        assert any("sampler exploded" in tb for tb in wd.errors)


def _trend_runs(windows_progress, rule_kw):
    """The same epochs through both packages' TrendDetector -> verdict tuples."""
    from repro.core.calltree import CallTree as JaxTree

    out = {}
    for name, mod, tree in (("port", None, CallTree), ("jax", jdet, JaxTree)):
        det = TrendDetector(TrendRule(**rule_kw)) if mod is None else mod.TrendDetector(mod.TrendRule(**rule_kw))
        out[name] = [[dataclasses.astuple(v) for v in det.observe_epoch(make(tree), progress=p, epoch=e,
                                                                        wall_time=float(e))]
                     for e, (make, p) in enumerate(windows_progress)]
    return out


SPIN = lambda tree: _window("spin", tree=tree)  # noqa: E731
DIVERSE = lambda tree: _diverse_window(tree=tree)  # noqa: E731


class TestTrendRecovery:
    RULE = dict(epochs=2, min_baseline_epochs=99)

    def test_livelock_clears_when_dominance_breaks(self):
        det = TrendDetector(TrendRule(**self.RULE))
        det.observe_epoch(_diverse_window(), progress=10)
        for _ in range(3):
            det.observe_epoch(_window("spin"), progress=10)
        assert det.livelock_active
        assert det.detection_latency(LIVELOCK) == 1
        cleared = [v for v in det.observe_epoch(_diverse_window(), progress=11) if v.kind == LIVELOCK_CLEARED]
        assert len(cleared) == 1 and not det.livelock_active
        assert cleared[0].began_epoch == det.first_detection(LIVELOCK).began_epoch
        assert cleared[0].epoch > cleared[0].began_epoch

    def test_livelock_clears_when_progress_resumes(self):
        det = TrendDetector(TrendRule(**self.RULE))
        for _ in range(3):
            det.observe_epoch(_window("spin"), progress=5)
        assert det.livelock_active
        assert [v.kind for v in det.observe_epoch(_window("spin"), progress=6)] == [LIVELOCK_CLEARED]
        assert not det.livelock_active

    def test_cleared_emitted_once_per_onset(self):
        det = TrendDetector(TrendRule(**self.RULE))
        for _ in range(3):
            det.observe_epoch(_window("spin"), progress=5)
        det.observe_epoch(_diverse_window(), progress=6)
        assert [v.kind for v in det.observe_epoch(_diverse_window(), progress=7)] == []

    @pytest.mark.parametrize("epochs", [
        [(DIVERSE, 10)] + [(SPIN, 10)] * 3 + [(DIVERSE, 11)],
        [(SPIN, 5)] * 3 + [(SPIN, 6)],
        [(SPIN, 5)] * 3 + [(DIVERSE, 6), (DIVERSE, 7)],
        [(SPIN, 1)] * 3 + [(DIVERSE, 2)] + [(SPIN, 2)] * 4 + [(SPIN, 3)],
    ], ids=["dominance-breaks", "progress-resumes", "once-per-onset", "two-onsets"])
    def test_recovery_verdicts_equal_the_jax_packages(self, epochs):
        out = _trend_runs(epochs, self.RULE)
        assert out["port"] == out["jax"]
        assert any(v[0] == LIVELOCK_CLEARED for vs in out["port"] for v in vs)


@pytest.mark.parametrize("vecs", [
    [], [{"a": 1.0}], [{"a": 0.5, "b": 0.5}] * 6, [{}, {}, {}], [{"a": 1.0}] * 3 + [{"b": 1.0}] * 2,
], ids=["empty", "single", "identical", "empty-vectors", "jump"])
def test_segment_phases_edges_equal_the_jax_packages(vecs):
    want = {"empty": [], "single": [(0, 0)], "identical": [(0, 5)], "empty-vectors": [(0, 2)],
            "jump": [(0, 2), (3, 4)]}
    got = segment_phases(vecs)
    assert got == jdet.segment_phases(vecs)
    assert got in want.values()


def _hosts(kind: str, tree):
    deep = ["bootstrap", "runtime", "main", "train", "step"]
    if kind == "empty":
        return {}
    if kind == "single":
        return {"h0": _window("x", tree=tree)}
    if kind == "identical":
        return {f"h{i}": _diverse_window(tree=tree) for i in range(4)}
    if kind == "empty-tree":
        return {"h0": tree(), "h1": _diverse_window(tree=tree), "h2": _diverse_window(tree=tree)}
    healthy, parked = tree(), tree()
    for i in range(100):
        healthy.add_stack(deep + [f"op{i % 5}"])
        parked.add_stack(deep + ["collective_wait"])
    return {"h0": healthy.copy(), "h1": healthy.copy(), "h2": parked}


@pytest.mark.parametrize("kind,threshold", [("empty", 0.3), ("single", 0.3), ("identical", 0.2),
                                            ("empty-tree", 0.4), ("deep-prefix", 0.5)])
def test_straggler_edges_equal_the_jax_packages(kind, threshold):
    from repro.core.calltree import CallTree as JaxTree

    got = StragglerDetector(threshold=threshold).observe(_hosts(kind, CallTree))
    assert got == jdet.StragglerDetector(threshold=threshold).observe(_hosts(kind, JaxTree))
    flagged = [h for h, _ in got]
    if kind == "deep-prefix":
        assert flagged == ["h2"]
    elif kind == "empty-tree":
        assert "h1" not in flagged and "h2" not in flagged
    else:
        assert flagged == []
