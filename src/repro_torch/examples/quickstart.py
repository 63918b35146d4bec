"""Quickstart: train a tiny model with the profiling toolchain always on (the
counterpart of the JAX package's ``examples/quickstart.py``).

Runs a few steps of a reduced qwen3-4b, on the card unless ``--device cpu``
is given, with:
  * the external host-plane sampler (the paper's perf_event analogue),
  * the device-plane component tree of one train step: the port profiles the
    first step it runs (``core/device_tree.tree_from_profile``, its update
    kept) where the JAX package costs the compiled step without running it
    (``tree_from_compiled``),
  * the dominance watchdog armed.

Prints both breakdowns and writes the interactive HTML report.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--out DIR]
"""

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    DominanceDetector,
    Rule,
    SamplerConfig,
    StackSampler,
    WatchdogLoop,
    breakdown,
    tree_from_profile,
    write_report,
)
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "repro_torch_quickstart"))
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    steps = args.steps

    cfg = get_config("qwen3-4b", smoke=True)
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0), train=True)
    opt = adamw_init(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4))
    step = make_train_step(model, cosine_schedule(3e-3, warmup_steps=2, total_steps=steps), AdamWConfig())

    def batch(i):
        return {k: torch.from_numpy(v).to(model.device) for k, v in data.batch(i).items()}

    # --- profiling plane: external sampler + watchdog (zero instrumentation) ---
    sampler = StackSampler(SamplerConfig(period_s=0.05))
    detector = DominanceDetector([Rule(threshold=0.97, consecutive=3, min_window_total=8)])
    watchdog = WatchdogLoop(sampler, detector, interval_s=0.5)
    sampler.start()
    watchdog.start()

    # --- device plane: the call tree of the first train step, profiled ------
    (params, opt, metrics), device_tree = tree_from_profile(lambda: step(params, opt, batch(0)), device=model.device)
    print("\n=== device-plane FLOPs breakdown (one profiled train step) ===")
    for name, share in breakdown(device_tree, level=6, metric="flops", min_share=0.03):
        print(f"  {share:6.1%}  {name.split('/')[-1]}")

    print(f"step 0: loss={float(metrics['loss']):.4f}")
    for i in range(1, steps):
        params, opt, metrics = step(params, opt, batch(i))
        print(f"step {i}: loss={float(metrics['loss']):.4f}")

    watchdog.stop()
    host_tree = sampler.stop()
    print("\n=== host-plane sample breakdown (external sampler) ===")
    for name, share in breakdown(host_tree, level=3, min_share=0.05):
        print(f"  {share:6.1%}  {name.split('/')[-1]}")
    paths = write_report(host_tree, args.out, "host_profile")
    write_report(device_tree, args.out, "device_profile", metric="flops")
    print(f"\ninteractive reports: {paths['html']} and {args.out}/device_profile.html")
    print(f"anomalies: {[e.describe() for e in detector.events] or 'none'}")


if __name__ == "__main__":
    main()
