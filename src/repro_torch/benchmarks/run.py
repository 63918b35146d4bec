"""The port's benchmark harness: one entry per paper table/figure (the
counterpart of the JAX package's ``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV rows on stdout (see each module's
docstring for the mapping to the paper's figures); what a benchmark prints
of its own goes to stderr. The benchmarks that run a model run on the card
unless ``--device cpu`` is given (the smoke configs); ``roofline`` reads the
dry-run's files (``python -m repro_torch.launch.dryrun``). Usage:

  PYTHONPATH=src python -m repro_torch.benchmarks.run                   # all, on the card
  PYTHONPATH=src python -m repro_torch.benchmarks.run fig13             # substring filter
  PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu      # all, smoke size on the CPU
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import sys
import traceback

# (name, module, whether it takes --device)
BENCHES = [
    ("fig01_engines", "repro_torch.benchmarks.fig01_engines", True),
    ("fig02_stack_depth", "repro_torch.benchmarks.fig02_stack_depth", True),
    ("fig08_11_breakdown", "repro_torch.benchmarks.fig08_11_breakdown", True),
    ("fig10_12_zoom", "repro_torch.benchmarks.fig10_12_zoom", True),
    ("fig13_detect", "repro_torch.benchmarks.fig13_detect", False),
    ("overhead", "repro_torch.benchmarks.overhead", False),
    ("roofline", "repro_torch.benchmarks.roofline", False),
]


def _release() -> None:
    """Hand the card's memory of the benchmark that ended to the next one:
    the train setups of fig08_11 and fig10_12 need ~78 GB of the 80."""
    gc.collect()
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("filter", nargs="?", default="", help="run the benchmarks whose name contains this")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (smoke configs)")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    failures = 0
    for name, modname, takes_device in BENCHES:
        if args.filter and args.filter not in name:
            continue
        try:
            mod = importlib.import_module(modname)
            with contextlib.redirect_stdout(sys.stderr):
                rows = mod.main(["--device", args.device]) if takes_device else mod.main()
            for line in rows:
                print(line, flush=True)
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"{name},0,ERROR:{type(e).__name__}:{e}", flush=True)
            traceback.print_exc(file=sys.stderr)
        _release()
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
