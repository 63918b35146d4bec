"""Scoreboard: grade each (detector, scenario) cell on the harness's runs.

The paper grades its gem5 profiler by whether a known Ruby livelock is
surfaced, and how much of the run's wall time the dominant-stack rule took to
flag it.  This module does the same bookkeeping for the fault corpus:

* every *scored* event from a fault run is a true positive iff its wall time
  falls inside ``[t_inject, t_clear + grace]``, else a false positive;
* every scored event from the matching control run is a false positive;
* time-to-detect is the gap from injection to the detector's first in-window
  verdict, expressed in daemon epochs (the profiler's own clock).

Scored detector columns (event ``detector`` provenance + kind):

=================  ========================================================
``dominance``      windowed dominance rules (global + per-scenario pattern)
``trend_livelock`` epoch-trend LIVELOCK (dominance + progress stall)
``trend_drift``    epoch-trend SHARE_DRIFT (TV distance vs. baseline)
``stall``          liveness: TARGET_STALLED (spool silent, pid alive)
``straggler``      fleet skew: per-epoch cross-target share divergence
=================  ========================================================

``DOMINANT`` trend verdicts are deliberately *unscored*: a legitimately hot
clean loop is dominant without being anomalous, and a detector graded on
precision must not be penalized for reporting it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

DETECTOR_COLUMNS = ("dominance", "trend_livelock", "trend_drift", "stall", "straggler")

# Lifecycle / plumbing events: never scored, never counted as FPs.
UNSCORED_KINDS = {
    "TARGET_ATTACHED",
    "TARGET_RESTARTED",
    "TARGET_NEVER_APPEARED",
    "TARGET_EXITED",
    "SOURCE_ATTACH_FAILED",
    "SOURCE_GAVE_UP",
    "DEVICE_TREE_LOADED",
    "DEVICE_TREE_UNREADABLE",
    "SERVING",
    "SERVE_FAILED",
    "SUPERVISOR_GONE",
    "TIMELINE_WRITE_FAILED",
    "CALLBACK_FAILED",
    "FAULT_INJECT",
    "FAULT_CLEAR",
    "FAULT_MARKER_INVALID",
}

# Recovery confirmations: not detections and not FPs, but the scoreboard
# records whether the pipeline observed the fault *clearing*.
RECOVERY_KINDS = {"LIVELOCK_CLEARED", "TARGET_RESUMED"}


def detector_of(event: dict) -> str | None:
    """Map one daemon event to its scored detector column (None = unscored)."""
    kind = event.get("kind", "")
    if kind in UNSCORED_KINDS or kind in RECOVERY_KINDS:
        return None
    det = event.get("detector")
    if det == "dominance":
        return "dominance"
    if det == "trend":
        if kind == "LIVELOCK":
            return "trend_livelock"
        if kind == "SHARE_DRIFT":
            return "trend_drift"
        return None  # DOMINANT et al.: informational
    if kind == "TARGET_STALLED":
        return "stall"
    if kind == "STRAGGLER":
        return "straggler"
    return None


@dataclass
class CellScore:
    """One (scenario, detector) cell."""

    detected: bool = False
    ttd_epochs: float | None = None  # injection -> first in-window verdict
    ttd_s: float | None = None
    true_positives: int = 0
    fault_run_fps: int = 0    # scored events outside the fault window
    control_fps: int = 0      # scored events on the clean control run
    recovery_observed: bool = False
    kinds: list[str] = field(default_factory=list)  # distinct TP kinds seen

    def to_json(self) -> dict:
        return {
            "detected": self.detected,
            "ttd_epochs": None if self.ttd_epochs is None else round(self.ttd_epochs, 2),
            "ttd_s": None if self.ttd_s is None else round(self.ttd_s, 3),
            "true_positives": self.true_positives,
            "fault_run_fps": self.fault_run_fps,
            "control_fps": self.control_fps,
            "recovery_observed": self.recovery_observed,
            "kinds": sorted(set(self.kinds)),
        }


def score_runs(
    fault_events: list[dict],
    control_events: list[dict],
    *,
    t_inject: float,
    t_clear: float,
    epoch_s: float,
    grace_epochs: int = 3,
) -> dict[str, CellScore]:
    window_end = t_clear + grace_epochs * epoch_s
    cells = {col: CellScore() for col in DETECTOR_COLUMNS}

    for ev in fault_events:
        kind = ev.get("kind", "")
        wall = float(ev.get("wall_time", 0.0))
        if kind in RECOVERY_KINDS and wall >= t_clear:
            col = "trend_livelock" if kind == "LIVELOCK_CLEARED" else "stall"
            cells[col].recovery_observed = True
            continue
        col = detector_of(ev)
        if col is None:
            continue
        cell = cells[col]
        if t_inject <= wall <= window_end:
            cell.true_positives += 1
            cell.kinds.append(kind)
            if not cell.detected:
                cell.detected = True
                cell.ttd_s = wall - t_inject
                cell.ttd_epochs = cell.ttd_s / epoch_s
        else:
            cell.fault_run_fps += 1

    for ev in control_events:
        col = detector_of(ev)
        if col is not None:
            cells[col].control_fps += 1

    return cells


# ---------------------------------------------------------------------------
# bench document


def build_bench(
    scenario_cells: dict[str, dict[str, CellScore]],
    *,
    config: dict,
    skipped: dict[str, str] | None = None,
    ttd_floor_epochs: float = 10.0,
) -> dict:
    matrix = {
        scen: {col: cell.to_json() for col, cell in cells.items()}
        for scen, cells in sorted(scenario_cells.items())
    }

    summary = {}
    n_scen = max(len(scenario_cells), 1)
    for col in DETECTOR_COLUMNS:
        det_cells = [cells[col] for cells in scenario_cells.values()]
        tp = sum(c.true_positives for c in det_cells)
        fp = sum(c.fault_run_fps + c.control_fps for c in det_cells)
        detected = sum(1 for c in det_cells if c.detected)
        ttds = [c.ttd_epochs for c in det_cells if c.ttd_epochs is not None]
        summary[col] = {
            "scenarios_detected": detected,
            "recall": round(detected / n_scen, 3),
            "precision": None if tp + fp == 0 else round(tp / (tp + fp), 3),
            "mean_ttd_epochs": None if not ttds else round(sum(ttds) / len(ttds), 2),
        }

    floors = floor_report(scenario_cells, ttd_floor_epochs=ttd_floor_epochs)
    return {
        "schema": 1,
        "bench": "fault-injection detector matrix",
        "config": config,
        "detectors": list(DETECTOR_COLUMNS),
        "skipped": dict(sorted((skipped or {}).items())),
        "matrix": matrix,
        "summary": summary,
        "floors": floors,
    }


def floor_report(
    scenario_cells: dict[str, dict[str, CellScore]],
    *,
    ttd_floor_epochs: float = 10.0,
) -> dict:
    """The committed floors: every scenario caught fast, clean runs silent."""
    per_scenario = {}
    problems = []
    for scen, cells in sorted(scenario_cells.items()):
        ttds = [c.ttd_epochs for c in cells.values() if c.ttd_epochs is not None]
        best = min(ttds) if ttds else None
        detected = any(c.detected for c in cells.values())
        per_scenario[scen] = {
            "detected": detected,
            "best_ttd_epochs": None if best is None else round(best, 2),
        }
        if not detected:
            problems.append(f"{scen}: no detector fired inside the fault window")
        elif best is not None and best > ttd_floor_epochs:
            problems.append(
                f"{scen}: best time-to-detect {best:.1f} epochs > floor {ttd_floor_epochs}"
            )
        cfps = sum(c.control_fps for c in cells.values())
        if cfps:
            problems.append(f"{scen}: {cfps} false positive(s) on the clean control run")
    return {
        "ttd_floor_epochs": ttd_floor_epochs,
        "per_scenario": per_scenario,
        "pass": not problems,
        "problems": problems,
    }


def diff_bench(baseline: dict, new: dict) -> list[str]:
    """Regressions of ``new`` vs. the committed ``baseline``.

    Gated: a (scenario, detector) cell that flips detected -> missed, or a
    clean control run that starts producing false positives.  Latency changes
    are informational only (CI boxes jitter).
    """
    problems: list[str] = []
    base_m = baseline.get("matrix", {})
    new_m = new.get("matrix", {})
    for scen, base_cells in base_m.items():
        new_cells = new_m.get(scen)
        if new_cells is None:
            if scen in new.get("skipped", {}):
                continue  # environment lacks a dep: skip, don't fail
            problems.append(f"{scen}: present in baseline but missing from new run")
            continue
        for col, base_cell in base_cells.items():
            new_cell = new_cells.get(col, {})
            if base_cell.get("detected") and not new_cell.get("detected"):
                problems.append(f"{scen}/{col}: regressed detected -> missed")
            if not base_cell.get("control_fps") and new_cell.get("control_fps"):
                problems.append(
                    f"{scen}/{col}: new false positive(s) on the clean control run "
                    f"({new_cell.get('control_fps')})"
                )
    return problems
