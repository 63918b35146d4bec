"""Fig. 13 analogue for the port: injected livelock -> threshold detection ->
checkpoint (the counterpart of the JAX package's ``benchmarks/fig13_detect.py``).

The paper injects a recycled mandatory-queue load into SLICC and shows the L1
breakdown degenerate to >90% load_hit, which the profiler flags and
checkpoints.  This benchmark runs the port's *production* detection path —
the fault corpus's ``injected_spin`` scenario under the port's out-of-process
daemon (child target, mmap spool, daemon-side rules) — so the measured
latency is the latency the deployed pipeline has:

  child spin -> agent spool -> daemon ingest -> dominance/trend verdict
  -> events.jsonl -> scoreboard ground-truth alignment -> ttd

The paper's warn+checkpoint flow is kept: the first scored verdict triggers
an emergency checkpoint tagged with the anomaly, through the port's
``CheckpointManager.save_emergency``. Host-only: the scenario's child and
the daemon load no torch, and nothing touches a card.

  PYTHONPATH=src python -m repro_torch.benchmarks.fig13_detect

Prints one row, ``name,us_per_call,derived`` as the JAX package's
``benchmarks/common.row`` writes it: the dominance verdict's time-to-detect
in microseconds, then ``detected``, both detectors' time-to-detect in
epochs and whether the checkpoint came back tagged.
"""

from __future__ import annotations

import tempfile
from types import SimpleNamespace

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.faults import SCENARIOS, HarnessConfig, run_scenario, score_runs
from repro_torch.faults.scoreboard import detector_of


def _epochs(cell) -> float | None:
    return None if cell.ttd_epochs is None else round(cell.ttd_epochs, 2)


def main(cfg: HarnessConfig | None = None) -> list[str]:
    cfg = cfg or HarnessConfig()
    res = run_scenario(SCENARIOS["injected_spin"], cfg, control=False)
    cells = score_runs(
        res.events,
        [],
        t_inject=res.t_inject,
        t_clear=res.t_clear,
        epoch_s=cfg.epoch_s,
        grace_epochs=cfg.grace_epochs,
    )
    dom = cells["dominance"]
    livelock = cells["trend_livelock"]

    # Paper §V-D: threshold violation -> emergency checkpoint tagged with the
    # anomaly.  Feed the first scored verdict into the real checkpoint path.
    scored = sorted(
        (ev for ev in res.events if detector_of(ev) is not None),
        key=lambda ev: ev.get("wall_time", 0.0),
    )
    ckpt_tagged = False
    if scored:
        first = scored[0]
        with tempfile.TemporaryDirectory() as d:
            ckpt = CheckpointManager(d)
            ckpt.save_emergency(
                lambda: (0, {"state": np.zeros(4)}),
                SimpleNamespace(
                    kind=first.get("kind", "?"),
                    path=tuple(first.get("path", ())),
                    share=float(first.get("share", 0.0)),
                ),
            )
            _, manifest = ckpt.restore(0)
            ckpt_tagged = manifest.get("tag") == "emergency"

    derived = (
        f"detected={dom.detected};ttd_epochs={_epochs(dom)}"
        f";livelock_ttd_epochs={_epochs(livelock)};ckpt_tagged={ckpt_tagged}"
    )
    row = f"fig13_livelock_detect,{(dom.ttd_s or 0.0) * 1e6:.1f},{derived}"
    print(row, flush=True)
    return [row]


if __name__ == "__main__":
    main()
