"""Batched serving example: continuous-batching decode with the profiler on
(the counterpart of the JAX package's ``examples/serve_batched.py``), on the
card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched --requests 12 --batch 4 [--device cpu]
"""

import argparse
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import SamplerConfig, StackSampler, breakdown
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import Model


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    model = Model(cfg, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(3, 9))).astype(np.int32),
                max_new=args.max_new)
        for i in range(args.requests)
    ]
    sampler = StackSampler(SamplerConfig(period_s=0.05)).start()
    server = BatchedServer(model, batch=args.batch, max_len=128)
    stats = server.run(reqs)
    tree = sampler.stop()
    print(json.dumps(stats, indent=1))
    print("host-plane breakdown of the serving loop:")
    for name, share in breakdown(tree, level=3, min_share=0.05):
        print(f"  {share:6.1%}  {name.split('/')[-1]}")
    assert stats["requests_done"] == args.requests


if __name__ == "__main__":
    main()
