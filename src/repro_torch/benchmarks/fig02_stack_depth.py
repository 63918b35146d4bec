"""Fig. 2 analogue for the port: sampled call-stack depth of the host runtime
over a short train run — the paper's observation that stack depth fluctuates
heavily as the runtime moves between dispatch, compute wait, and bookkeeping
(the counterpart of the JAX package's ``benchmarks/fig02_stack_depth.py``).

gemma-2b, 6 steps of ``make_train_step`` (B 4 x S 64) under the port's
thread sampler at 0.01 s: the smoke config with ``--device cpu``, full width
and depth on the card (the default; 40 GB of f32 training state).

  PYTHONPATH=src python -m repro_torch.benchmarks.fig02_stack_depth [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import SamplerConfig, StackSampler
from repro_torch.core.engines import block_until_ready
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule

from .common import row


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default: gemma-2b at full size) or cpu (smoke)")
    args = ap.parse_args(argv)
    cfg = get_config("gemma-2b", smoke=torch.device(args.device).type == "cpu")
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0), train=True)
    opt = adamw_init(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4))
    step = make_train_step(model, cosine_schedule(1e-3), AdamWConfig())
    sampler = StackSampler(SamplerConfig(period_s=0.01)).start()
    for i in range(6):
        batch = {k: torch.from_numpy(v).to(model.device) for k, v in data.batch(i).items()}
        params, opt, _ = step(params, opt, batch)
    block_until_ready(params)
    sampler.stop()
    trace = sampler.depth_trace()
    depths = [d for _, d in trace]
    if not depths:
        return [row("fig02_stack_depth", 0.0, "no-samples")]
    return [
        row(
            "fig02_stack_depth",
            float(len(trace)),
            f"min={min(depths)};max={max(depths)};mean={sum(depths)/len(depths):.1f};swing={max(depths)-min(depths)}",
        )
    ]


if __name__ == "__main__":
    for r in main():
        print(r)
