"""CLI for the fault corpus: list scenarios, run one, or score the matrix.

  PYTHONPATH=src python -m repro_torch.faults list
  PYTHONPATH=src python -m repro_torch.faults run --scenario injected_spin --device cpu
  PYTHONPATH=src python -m repro_torch.faults bench --device cpu --out /tmp/detect.json
  PYTHONPATH=src python -m repro_torch.faults bench --check --out BENCH_detect_torch.json   # on the card
  PYTHONPATH=src python -m repro_torch.faults bench --smoke --check \\
      --baseline BENCH_detect_torch.json

``bench`` runs every requested scenario twice (fault + clean control),
scores each (detector, scenario) cell, and writes the bench JSON.  With
``--check`` it additionally enforces the floors and — when a baseline is
given — fails on detected->missed or new-control-FP regressions.

A copy of ``repro.faults.__main__`` for the port. ``--device`` places the two
model scenarios: ``cuda`` (the default) runs them at their configs' full
width on the card, ``cpu`` at smoke size. The bench document is the JAX
package's, with ``config["device"]`` added: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, or ``"cpu"``. This module imports no torch.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from .harness import HarnessConfig, HarnessError, run_scenario
from .scenarios import SCENARIOS, SMOKE_SCENARIOS
from .scoreboard import build_bench, diff_bench, score_runs


def _select(args) -> list[str]:
    if getattr(args, "scenarios", None):
        names = [s.strip() for s in args.scenarios.split(",") if s.strip()]
        unknown = [n for n in names if n not in SCENARIOS]
        if unknown:
            raise SystemExit(f"unknown scenario(s): {', '.join(unknown)}")
        return names
    if getattr(args, "smoke", False):
        return list(SMOKE_SCENARIOS)
    return sorted(SCENARIOS)


def _mk_config(args) -> HarnessConfig:
    # full width on the card; the CPU takes the smoke configs
    return HarnessConfig(keep_artifacts=getattr(args, "keep", False), device=args.device,
                         smoke=args.device == "cpu")


def device_label(device: str) -> str:
    """``"cpu"``, or the card's ``nvidia-smi`` name and power limit."""
    if device == "cpu":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise HarnessError(f"nvidia-smi failed: {e}") from None
    if out.returncode != 0 or not out.stdout.strip():
        raise HarnessError(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cmd_list(args) -> int:
    for name in sorted(SCENARIOS):
        s = SCENARIOS[name]
        ok, why = s.available()
        tag = "" if ok else f"  [unavailable: {why}]"
        hosts = f" x{s.n_hosts}" if s.n_hosts > 1 else ""
        print(f"{name:18s}{hosts:4s} {s.description}{tag}")
    return 0


def cmd_run(args) -> int:
    scenario = SCENARIOS[args.scenario]
    cfg = _mk_config(args)
    res = run_scenario(scenario, cfg, control=args.control)
    kinds: dict[str, int] = {}
    for ev in res.events:
        kinds[ev.get("kind", "?")] = kinds.get(ev.get("kind", "?"), 0) + 1
    print(json.dumps({
        "scenario": res.scenario,
        "control": res.control,
        "n_events": len(res.events),
        "kinds": dict(sorted(kinds.items())),
        "t_inject": res.t_inject,
        "t_clear": res.t_clear,
        "out_dir": res.out_dir,
        "ready_s": res.ready_s,
        "n_stacks_at": res.n_stacks_at,
        "child_reports": res.child_reports,
    }, indent=1))
    return 0


def cmd_bench(args) -> int:
    cfg = _mk_config(args)
    device = device_label(args.device)
    names = _select(args)
    cells_by_scenario = {}
    # Scenarios outside the requested subset are recorded as skipped, not
    # silently absent — the baseline diff tolerates skips but flags vanished
    # scenarios, so a --smoke run must not read as seven regressions.
    skipped: dict[str, str] = {
        name: "not selected (subset run)" for name in sorted(SCENARIOS) if name not in names
    }
    for name in names:
        scenario = SCENARIOS[name]
        ok, why = scenario.available()
        if not ok:
            skipped[name] = why
            print(f"[bench] SKIP {name}: {why}", file=sys.stderr)
            continue
        print(f"[bench] {name}: fault run ...", file=sys.stderr)
        fault = run_scenario(scenario, cfg, control=False)
        print(f"[bench] {name}: control run ...", file=sys.stderr)
        control = run_scenario(scenario, cfg, control=True)
        cells_by_scenario[name] = score_runs(
            fault.events,
            control.events,
            t_inject=fault.t_inject,
            t_clear=fault.t_clear,
            epoch_s=cfg.epoch_s,
            grace_epochs=cfg.grace_epochs,
        )
        got = sorted(
            {c for c, cell in cells_by_scenario[name].items() if cell.detected}
        )
        print(f"[bench] {name}: detected by {got or 'NOTHING'}", file=sys.stderr)

    bench = build_bench(
        cells_by_scenario,
        config={
            "epoch_s": cfg.epoch_s,
            "publish_s": cfg.publish_s,
            "agent_period_s": cfg.agent_period_s,
            "clean_s": cfg.clean_s,
            "fault_s": cfg.fault_s,
            "recovery_s": cfg.recovery_s,
            "grace_epochs": cfg.grace_epochs,
            "global_threshold": cfg.global_threshold,
            "global_consecutive": cfg.global_consecutive,
            "device": device,
        },
        skipped=skipped,
    )
    out = args.out
    if out:
        with open(out, "w") as f:
            json.dump(bench, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"[bench] wrote {out}", file=sys.stderr)
    else:
        print(json.dumps(bench, indent=1, sort_keys=True))

    rc = 0
    if args.check:
        problems = list(bench["floors"]["problems"])
        if args.baseline:
            try:
                with open(args.baseline) as f:
                    baseline = json.load(f)
                problems += diff_bench(baseline, bench)
            except OSError as e:
                problems.append(f"baseline unreadable: {e}")
        for p in problems:
            print(f"[bench] FAIL {p}", file=sys.stderr)
        rc = 1 if problems else 0
        if rc == 0:
            print("[bench] floors pass", file=sys.stderr)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.faults")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list the scenario corpus")

    rn = sub.add_parser("run", help="run one scenario and dump its verdicts")
    rn.add_argument("--scenario", required=True, choices=sorted(SCENARIOS))
    rn.add_argument("--control", action="store_true", help="clean run (no fault)")
    rn.add_argument("--keep", action="store_true", help="keep run artifacts on disk")
    rn.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the model scenarios' device (cuda: full width; cpu: smoke size)")

    bn = sub.add_parser("bench", help="score the full detector x scenario matrix")
    bn.add_argument("--smoke", action="store_true",
                    help=f"host-only fast subset: {', '.join(SMOKE_SCENARIOS)}")
    bn.add_argument("--scenarios", default=None, help="comma-separated subset")
    bn.add_argument("--out", default=None, help="write bench JSON here")
    bn.add_argument("--check", action="store_true",
                    help="enforce floors (and baseline diff when given)")
    bn.add_argument("--baseline", default=None,
                    help="committed BENCH_detect.json to diff against")
    bn.add_argument("--keep", action="store_true", help="keep run artifacts on disk")
    bn.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the model scenarios' device (cuda: full width; cpu: smoke size)")

    args = ap.parse_args(argv)
    try:
        return {"list": cmd_list, "run": cmd_run, "bench": cmd_bench}[args.cmd](args)
    except HarnessError as e:
        print(f"[faults] error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
