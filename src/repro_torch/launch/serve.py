"""Batched serving loop: prefill-as-decode with continuous batching (lite).

A fixed-size decode batch is kept full from a request queue: finished
sequences are replaced by queued prompts, whose prefill runs as decode steps
of the shared batch. All slots decode at one shared position ``pos``, and a
freed slot's KV rows are reused without a reset, as in the JAX package's
server (ROADMAP Queue 3). With ``--profile`` the host-plane sampler and a
dominance watchdog run beside the loop, as in the JAX package's server: a
stuck decode loop trips the watchdog's hang rule.

CLI (the smoke config unless ``--full``; the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.serve [--arch gemma-2b] [--full] [--device cuda] [--profile]
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import DominanceDetector, Rule, SamplerConfig, WatchdogLoop, make_sampler
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import Model


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int = 16
    out: list[int] = field(default_factory=list)
    done: bool = False


class ServeMetrics:
    """Serving counters shared between the decode loop and scrapers.

    One lock guards the counters: the decode loop takes it once per step
    (`record_step`), dashboards/scrapers take it to read (`snapshot`). That
    makes this the serving loop's lock-convoy seam: a scraper that holds the
    lock too long parks the decode thread in ``record_step``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.steps = 0
        self.requests_done = 0
        self.step_wall_s = 0.0

    def record_step(self, *, done_now: int, wall_s: float) -> None:
        with self._lock:
            self.steps += 1
            self.requests_done += done_now
            self.step_wall_s += wall_s

    def snapshot(self) -> dict:
        with self._lock:
            mean = self.step_wall_s / self.steps if self.steps else 0.0
            return {"steps": self.steps, "requests_done": self.requests_done, "mean_step_s": mean}


class BatchedServer:
    """Serves on ``model.device`` with random weights drawn from ``seed``."""

    def __init__(self, model: Model, *, batch: int = 4, max_len: int = 128, seed: int = 0):
        self.model = model
        self.device = model.device
        self.batch = batch
        self.max_len = max_len
        self.params = model.init(torch.Generator(device=self.device).manual_seed(seed))
        self.state = model.init_decode_state(batch, max_len)
        self.step_fn = make_serve_step(model)
        self.slots: list[Request | None] = [None] * batch
        # per-slot progress: how many prompt tokens already consumed
        self.consumed = [0] * batch
        self.pos = 0
        self.steps = 0
        self.metrics = ServeMetrics()

    def _admit(self, queue: list[Request]) -> None:
        for i in range(self.batch):
            if self.slots[i] is None and queue:
                self.slots[i] = queue.pop(0)
                self.consumed[i] = 0

    @torch.inference_mode()
    def run(self, requests: list[Request]) -> dict:
        queue = list(requests)
        t0 = time.time()
        self._admit(queue)
        vocab = self.model.cfg.vocab
        while any(s is not None for s in self.slots) or queue:
            t_step = time.time()
            tokens = np.zeros((self.batch, 1), np.int32)
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                if self.consumed[i] < len(req.prompt):
                    tokens[i, 0] = req.prompt[self.consumed[i]]  # prefill-as-decode
                else:
                    tokens[i, 0] = req.out[-1] if req.out else req.prompt[-1]
            next_tok, self.state = self.step_fn(
                self.params, {"tokens": torch.from_numpy(tokens).to(self.device)}, self.state, self.pos
            )
            next_tok = next_tok.cpu().numpy()  # waits for the step to finish on the device
            self.pos += 1
            self.steps += 1
            done_before = sum(1 for r in requests if r.done)
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                if self.consumed[i] < len(req.prompt):
                    self.consumed[i] += 1
                    continue
                req.out.append(int(next_tok[i]) % vocab)
                if len(req.out) >= req.max_new:
                    req.done = True
                    self.slots[i] = None
                    self._admit(queue)
            self.metrics.record_step(
                done_now=sum(1 for r in requests if r.done) - done_before,
                wall_s=time.time() - t_step,
            )
            if self.pos >= self.max_len - 1:
                break  # context exhausted for this demo server
        wall = time.time() - t0
        done = [r for r in requests if r.done]
        return {
            "requests_done": len(done),
            "decode_steps": self.steps,
            "wall_s": wall,
            "steps_per_s": self.steps / max(wall, 1e-9),
            "batch": self.batch,
            "device": str(self.device),
            "metrics": self.metrics.snapshot(),
        }


def make_requests(vocab: int, n: int, max_new: int, seed: int = 0) -> list[Request]:
    """The CLI's traffic: ``n`` prompts of 3-9 random tokens."""
    rng = np.random.default_rng(seed)
    return [
        Request(rid=i, prompt=rng.integers(0, vocab, rng.integers(3, 10)).astype(np.int32), max_new=max_new)
        for i in range(n)
    ]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true", help="run the host-plane sampler and the watchdog")
    ap.add_argument("--backend", default="thread", choices=("thread", "daemon"),
                    help="profiler backend (daemon: not ported yet)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=not args.full)
    model = Model(cfg, device=args.device)
    reqs = make_requests(cfg.vocab, args.requests, args.max_new)
    sampler = make_sampler(SamplerConfig(period_s=0.1, backend=args.backend)) if args.profile else None
    if sampler:
        watchdog = WatchdogLoop(sampler, DominanceDetector([Rule(threshold=0.95, consecutive=3, min_window_total=8)]),
                                interval_s=1.0)
        sampler.start()
        watchdog.start()
    server = BatchedServer(model, batch=args.batch, max_len=128)
    stats = server.run(reqs)
    if sampler:
        watchdog.stop()
        stats["profile_samples"] = sampler.stop().total()
        stats["anomalies"] = [e.describe() for e in watchdog.detector.events]
    print(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
