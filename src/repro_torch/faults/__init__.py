"""Fault-injection corpus + scored detector harness.

Measure the detectors the way the paper measures gem5: reproduce a known
failure on demand, profile it from outside, and grade every detector on
precision, recall, and time-to-detect against the injection's ground truth.

A copy of ``repro.faults`` for the port. Import surface stays lazy where it
matters: the scenario registry, scoreboard, harness and CLI import no torch;
the model drivers (the port's MoE layer and batched server) load torch only
inside the child process that runs them, on the card unless asked for the CPU.

  PYTHONPATH=src python -m repro_torch.faults list
  PYTHONPATH=src python -m repro_torch.faults run --scenario injected_spin --device cpu
  PYTHONPATH=src python -m repro_torch.faults bench --check --out BENCH_detect_torch.json
"""

from .base import Driver, FaultScenario, ScenarioContext
from .harness import HarnessConfig, HarnessError, RunResult, run_scenario
from .scenarios import SCENARIOS, SMOKE_SCENARIOS
from .scoreboard import (
    DETECTOR_COLUMNS,
    CellScore,
    build_bench,
    detector_of,
    diff_bench,
    floor_report,
    score_runs,
)


def get_scenario(name: str) -> FaultScenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; have: {', '.join(sorted(SCENARIOS))}"
        ) from None


__all__ = [
    "Driver",
    "FaultScenario",
    "ScenarioContext",
    "HarnessConfig",
    "HarnessError",
    "RunResult",
    "run_scenario",
    "SCENARIOS",
    "SMOKE_SCENARIOS",
    "DETECTOR_COLUMNS",
    "CellScore",
    "build_bench",
    "detector_of",
    "diff_bench",
    "floor_report",
    "score_runs",
    "get_scenario",
]
