"""The port's fault corpus end to end on the CPU: child processes under the
port's agent, the port's daemon attached from outside, the harness's
ground-truth markers and the scoreboard, each run with the shortened windows
of ``tests/test_faults.py``'s ``TestHarnessEndToEnd`` (1.6 / 2.4 / 1.2 s):

* ``injected_spin``, asserted as the JAX package's end-to-end test asserts it;
* ``moe_imbalance`` at smoke size on the CPU (the port's MoE layer in the
  child), detected inside the fault window by its own rule;
* ``data_starvation``: the port's ``Pipeline.__next__`` seam, detected inside
  the fault window by its own rule (``repro::__next__``);
* the clean control run of ``injected_spin``: no scored verdict. The
  control is ``injected_spin``'s, not ``data_starvation``'s: the latter's
  clean producer is only ~1.6 times as fast as its consumer, so under host
  contention (six harness runs at once on an 8-core CPU, or the whole suite
  under six workers) its consumer waits in ``__next__`` and the clean run
  fires INPUT_STARVED, in the JAX package's corpus as in the port's
  (``PERF.md``, the fault corpus's findings);
* ``repro_torch.benchmarks.fig13_detect`` (``injected_spin``, then an
  emergency checkpoint tagged with the first scored verdict).

The registry, scoreboard and drivers against the JAX package are in
``tests/test_torch_faults.py``.
"""

from __future__ import annotations

import pytest

from repro_torch.faults import SCENARIOS, HarnessConfig, run_scenario, score_runs
from repro_torch.faults.scoreboard import detector_of


@pytest.fixture
def cfg():
    return HarnessConfig(clean_s=1.6, fault_s=2.4, recovery_s=1.2, device="cpu", smoke=True)


def _cells(res, cfg):
    return score_runs(res.events, [], t_inject=res.t_inject, t_clear=res.t_clear, epoch_s=cfg.epoch_s,
                      grace_epochs=cfg.grace_epochs)


def test_injected_spin_detected_with_ground_truth(cfg):
    res = run_scenario(SCENARIOS["injected_spin"], cfg, control=False)
    kinds = {e["kind"] for e in res.events}
    assert "FAULT_INJECT" in kinds and "FAULT_CLEAR" in kinds
    dom = _cells(res, cfg)["dominance"]
    assert dom.detected, f"no dominance verdict; kinds={sorted(kinds)}"
    assert dom.ttd_epochs is not None and dom.ttd_epochs <= 10
    assert dom.fault_run_fps == 0
    # a host-only child imports no torch, so it prints no exit report
    assert res.child_reports == {} and res.ready_s is not None and res.ready_s > 0
    assert res.n_stacks_at["clear"] > res.n_stacks_at["inject"]


def test_moe_imbalance_detected_at_smoke_size_on_the_cpu(cfg, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the child's torch: two threads beside the test workers
    res = run_scenario(SCENARIOS["moe_imbalance"], cfg, control=False)
    kinds = {e["kind"] for e in res.events}
    assert "FAULT_INJECT" in kinds and "FAULT_CLEAR" in kinds
    cells = _cells(res, cfg)
    dom = cells["dominance"]
    assert dom.detected and "MOE_IMBALANCE" in dom.kinds, f"kinds={sorted(kinds)}"
    assert dom.ttd_epochs is not None and dom.ttd_epochs <= 10
    assert sum(c.control_fps for c in cells.values()) == 0
    report = res.child_reports["host0"]
    assert report["device"] == "cpu" and report["arch"] == "deepseek-moe-16b-smoke"
    dropped = report["dropped_frac"]
    assert dropped["clean"]["n"] > 0 and dropped["clean"]["max"] < 0.5
    assert dropped["collapsed"]["min"] > 0.5 and report["retry_passes"] > 0
    ticks = report["agent_ticks"]
    assert ticks["at_clear"] > ticks["at_inject"] > 0


def test_data_starvation_detected_through_the_ports_pipeline(cfg):
    res = run_scenario(SCENARIOS["data_starvation"], cfg, control=False)
    dom = _cells(res, cfg)["dominance"]
    assert dom.detected and "INPUT_STARVED" in dom.kinds, sorted({e["kind"] for e in res.events})
    assert dom.ttd_epochs is not None and dom.ttd_epochs <= 10
    starved = [e for e in res.events if e["kind"] == "INPUT_STARVED"]
    assert all("repro::__next__" in e["path"] for e in starved)


def test_injected_spin_control_run_is_silent(cfg):
    res = run_scenario(SCENARIOS["injected_spin"], cfg, control=True)
    scored = [e for e in res.events if detector_of(e) is not None]
    assert scored == []
    assert res.t_inject is None and not [e for e in res.events if e["kind"].startswith("FAULT_")]
    assert any(e["kind"] == "TARGET_ATTACHED" for e in res.events)


def test_fig13_detects_and_checkpoints(cfg):
    from repro_torch.benchmarks import fig13_detect

    (row,) = fig13_detect.main(cfg)
    name, us, derived = row.split(",")
    fields = dict(kv.split("=") for kv in derived.split(";"))
    assert name == "fig13_livelock_detect" and float(us) > 0
    assert fields["detected"] == "True" and float(fields["ttd_epochs"]) <= 10
    assert fields["ckpt_tagged"] == "True"
