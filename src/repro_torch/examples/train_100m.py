"""End-to-end training driver: xlstm-125m (~125M params) on the port's
Trainer (fault tolerance, checkpoints, watchdog, resumable data), the
counterpart of the JAX package's ``examples/train_100m.py``.

On the card (the default) ``--full`` trains the whole model; the default
invocation, and ``--device cpu``, runs a short smoke segment.

  PYTHONPATH=src python -m repro_torch.examples.train_100m --device cpu        # CPU demo
  PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300 --full --batch 32 --seq 1024
"""

import argparse
import json
import os
import tempfile

from repro_torch.launch.train import Trainer, TrainJobConfig


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--full", action="store_true", help="full 125M config (default: reduced)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_100m"))
    args = ap.parse_args(argv)

    job = TrainJobConfig(
        arch="xlstm-125m",
        smoke=not args.full,
        device=args.device,
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        lr=1e-3,
        out_dir=args.out,
        ckpt_every=max(args.steps // 3, 1),
    )
    summary = Trainer(job).run()
    print(json.dumps(summary, indent=1))
    assert summary["final_loss"] < summary["first_loss"], "loss did not improve"


if __name__ == "__main__":
    main()
