"""Roofline table (the counterpart of the JAX package's ``benchmarks/roofline.py``):
reads the per-cell dry-run JSONs and emits the roofline CSV.

One row per ok cell (arch x shape x mesh): the three terms in seconds, the
dominant bottleneck, MODEL_FLOPS, the useful-FLOPs ratio, the step-time
bound and the MFU at that bound, then a summary row. The cells are the
port's dry-run's (``python -m repro_torch.launch.dryrun --all --mesh both``,
into ``results/torch_dryrun``): planned on the meta device with the H100's
data-sheet rates, not measured on a mesh. Usage:

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline [--dir DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from .common import row

# the dry-run's default --out (``launch.dryrun.DEFAULT_OUT``); this module
# imports no torch, as the other host-side benchmarks
RESULT_DIRS = [os.path.join("results", "torch_dryrun")]


def load_cells(dirs: list[str] | None = None) -> list[dict]:
    for d in dirs or RESULT_DIRS:
        files = sorted(glob.glob(os.path.join(d, "*.json")))
        if files:
            cells = []
            for f in files:
                with open(f) as fh:
                    cells.append(json.load(fh))
            return cells
    return []


def main(argv: list[str] | None = None) -> list[str]:
    """-> the CSV rows; ``argv`` as the command line's (none from the harness)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", action="append", default=None, help="a dry-run output dir (default: the port's)")
    args = ap.parse_args(argv or [])
    cells = load_cells(args.dir)
    out = []
    n_ok = n_skip = n_fail = 0
    worst = None
    for c in cells:
        if c["status"] == "skip":
            n_skip += 1
            continue
        if c["status"] != "ok":
            n_fail += 1
            continue
        n_ok += 1
        r = c["roofline"]
        mfu = r["mfu_bound"]
        if worst is None or mfu < worst[0]:
            worst = (mfu, c)
        out.append(
            row(
                f"roofline_{c['arch']}_{c['shape']}_{c['mesh']}",
                r["t_step_s"] * 1e6,
                f"dominant={r['dominant']};t_comp={r['t_compute_s']:.3g};t_mem={r['t_memory_s']:.3g};"
                f"t_coll={r['t_collective_s']:.3g};mfu_bound={mfu:.3f};"
                f"useful_flops={r['useful_flops_ratio']:.2f};fits_hbm={r['fits_hbm']}",
            )
        )
    out.append(row("roofline_summary", 0.0, f"ok={n_ok};skip_by_rule={n_skip};fail={n_fail}"))
    return out


if __name__ == "__main__":
    for r in main(sys.argv[1:]):
        print(r)
