"""Training driver: profiling-first train loop with fault tolerance (the
counterpart of ``repro.launch.train``).

Wires every subsystem together the way a production job would:

* data pipeline (prefetch thread) -> train step (``launch/steps.py``: the
  loss, autograd through the hand-written backward kernels, in-place AdamW);
* **host-plane sampler** running for the whole job (zero instrumentation of
  the step function);
* **watchdog**: dominance detector over sampler windows; an anomaly triggers
  warn -> emergency checkpoint, taken at once on the watchdog's thread when
  the training thread is between steps (waiting for data, say), else by the
  training thread at the end of the step that is running (the step updates
  parameters and optimizer state in place, so a copy taken during it would
  mix two steps);
* periodic async checkpoints + exact resume (parameters, optimizer state,
  data position, step);
* heartbeat file per step, the launcher's process-level hang detector.

* **device plane**: with ``profile`` on, one step of the run, the second
  (the first warm one), runs under ``torch.profiler`` and its call tree
  (``core/device_tree.py``) lands as ``device_tree.json`` beside the host
  profile. The JAX trainer costs the compiled step without running it; the
  port profiles a step the job runs anyway, so no step is added and the
  step's result is kept.

The JAX trainer's daemon sampler backend has no counterpart yet (ROADMAP
Queue 1 item 7).

CLI (smoke scale by default; the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.train [--arch xlstm-125m] --steps 30 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import tempfile
import threading
import time
from contextlib import ExitStack
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import DominanceDetector, Rule, SamplerConfig, WatchdogLoop, make_sampler, write_report
from repro_torch.core.device_tree import build_device_tree, profiling, save_device_tree
from repro_torch.data import DataConfig, Pipeline, SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule


@dataclass
class TrainJobConfig:
    arch: str = "xlstm-125m"
    smoke: bool = True
    device: str = "cuda"
    steps: int = 30
    global_batch: int = 8
    seq_len: int = 64
    lr: float = 3e-3
    warmup: int = 10
    grad_accum: int = 1
    seed: int = 0
    out_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_train")
    ckpt_every: int = 20
    profile: bool = True
    # "thread" = in-process StackSampler, the only backend ported
    profile_backend: str = "thread"
    sample_period_s: float = 0.2
    watchdog_threshold: float = 0.95
    # Extra detector rules appended to the defaults (e.g. a pattern-scoped
    # rule for a known livelock signature).
    extra_rules: list | None = None
    heartbeat_timeout_s: float = 600.0
    resume: bool = True


class Trainer:
    def __init__(self, job: TrainJobConfig):
        self.job = job
        self.cfg = get_config(job.arch, smoke=job.smoke)
        self.model = Model(self.cfg, device=job.device)
        self.device = self.model.device
        os.makedirs(job.out_dir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(job.out_dir, "ckpt"))
        self.data = Pipeline(
            SyntheticLM(
                DataConfig(vocab=self.cfg.vocab, seq_len=job.seq_len, global_batch=job.global_batch, seed=job.seed)
            )
        )
        self.metrics_log: list[dict] = []
        self.step = 0
        self.params = None
        self.opt_state = None
        self._heartbeat_path = os.path.join(job.out_dir, "heartbeat")

        lr_fn = cosine_schedule(job.lr, warmup_steps=job.warmup, total_steps=max(job.steps, 2))
        self._train_step = make_train_step(self.model, lr_fn, AdamWConfig(), grad_accum=job.grad_accum)

        # -- profiling plane (always on) ---------------------------------------
        self.sampler = (
            make_sampler(SamplerConfig(period_s=job.sample_period_s, backend=job.profile_backend))
            if job.profile
            else None
        )
        self.detector = DominanceDetector(
            [
                # generic livelock/hang rule (the paper's 90%-class threshold)
                Rule(threshold=job.watchdog_threshold, consecutive=2, min_window_total=8),
                # input starvation: the prefetch worker should never dominate
                Rule(pattern="_prefetch_worker", threshold=0.6, consecutive=2,
                     min_window_total=8, self_only=False, kind="INPUT_STARVATION"),
            ]
            + list(job.extra_rules or []),
        )
        self.detector.add_callback(self._on_anomaly)
        self.watchdog = WatchdogLoop(self.sampler, self.detector, interval_s=1.0) if self.sampler else None
        self.anomalies: list = []
        self._emergency: queue.SimpleQueue = queue.SimpleQueue()  # events whose checkpoint is still to take
        # Held to read or flip _in_step and to take an emergency checkpoint:
        # _in_step is True from the moment a step's batch is in hand until
        # the step is counted and its periodic checkpoint taken.
        self._step_lock = threading.Lock()
        self._in_step = False
        self._data_pos = 0  # batches consumed by the steps counted in self.step
        self._emergency_step: int | None = None  # the last step given an emergency checkpoint
        self._device_tree_dumped = False

    # -- fault-tolerance hooks ---------------------------------------------------

    def _on_anomaly(self, event) -> None:
        """Detector callback, on the watchdog thread: between steps the
        emergency checkpoint is taken now; during a step it waits for the
        step's end (``_take_emergency_checkpoints``)."""
        self.anomalies.append(event)
        with self._step_lock:
            if self._in_step:
                print(f"[watchdog] {event.describe()} -> emergency checkpoint after this step")
                self._emergency.put(event)
                return
            self._save_emergency(event)

    def _take_emergency_checkpoints(self) -> None:
        """On the training thread, between steps, holding ``_step_lock``: one
        emergency checkpoint of the step just finished, tagged with the latest
        anomaly deferred during it."""
        event = None
        while not self._emergency.empty():
            event = self._emergency.get()
        if event is not None:
            self._save_emergency(event)

    def _save_emergency(self, event) -> None:
        """Holding ``_step_lock``, between steps: an emergency checkpoint of the
        last counted step, unless it already has one. A stall fires the
        detector about once a window, and the state has not moved since."""
        if self._emergency_step == self.step:
            print(f"[watchdog] {event.describe()} -> step {self.step} already has an emergency checkpoint")
            return
        print(f"[watchdog] {event.describe()} -> emergency checkpoint of step {self.step}")
        self.ckpt.save_emergency(lambda: (self.step, self._state_tree()), event)
        self._emergency_step = self.step

    def _touch_heartbeat(self) -> None:
        with open(self._heartbeat_path, "w") as f:
            f.write(f"{self.step} {time.time()}")

    def _step_with_device_tree(self, batch: dict):
        """One train step under ``torch.profiler``, its device tree written
        beside the host profile (``_dump_device_tree``). The step itself is
        the one the loop runs; a profiler that cannot start costs nothing but
        the tree."""
        self._device_tree_dumped = True
        with ExitStack() as stack:
            try:
                prof = stack.enter_context(profiling(self.device))
            except Exception as e:  # noqa: BLE001 - the device plane must never cost the run
                print(f"[train] device-tree dump skipped: {e}")
                prof = None
            out = self._train_step(self.params, self.opt_state, batch)
        if prof is not None:
            self._dump_device_tree(prof)
        return out

    def _dump_device_tree(self, prof) -> None:
        """Drop the device-plane artifact beside the host profile: the call
        tree of the profiled step, by the JAX package's scope paths
        (``device_tree.json``, its schema), in ``out_dir`` and, where set, in
        ``$REPRO_PROFILERD_OUT``, the directory a profiling daemon reads.
        Best-effort: the device plane must never cost the training run."""
        try:
            tree = build_device_tree(prof)
            dests = [os.path.join(self.job.out_dir, "device_tree.json")]
            env_out = os.environ.get("REPRO_PROFILERD_OUT")
            if env_out:
                dests.append(os.path.join(env_out, "device_tree.json"))
            for p in dests:
                os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
                save_device_tree(tree, p, meta={"arch": self.cfg.name, "source": "train"})
            print(f"[train] device plane: {dests[0]} ({tree.node_count()} call sites)")
        except Exception as e:  # noqa: BLE001 - any failure here is non-fatal
            print(f"[train] device-tree dump skipped: {e}")

    def _state_tree(self) -> dict:
        return {
            "params": self.params,
            "opt": self.opt_state,
            "data": {"next_step": np.asarray(self._data_pos)},
        }

    # -- init / resume -------------------------------------------------------------

    def _to_device(self, tree):
        if isinstance(tree, dict):
            return {k: self._to_device(v) for k, v in tree.items()}
        return tree.to(self.device)

    def initialize(self) -> None:
        restored = self.ckpt.restore_latest() if self.job.resume else None
        if restored is not None:
            step, tree, manifest = restored
            self.step = step
            self.params = self._to_device(tree["params"])
            self.opt_state = self._to_device(tree["opt"])
            self.data.load_state_dict({"next_step": int(tree["data"]["next_step"])})
            print(f"[train] resumed from step {step} (tag={manifest['tag']})")
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.job.seed)
            self.params = self.model.init(gen, train=True)
            self.opt_state = adamw_init(self.params)
        self._data_pos = self.data.next_step

    # -- loop --------------------------------------------------------------------------

    def run(self) -> dict:
        self.initialize()
        if self.sampler:
            self.sampler.start()
        if self.watchdog:
            self.watchdog.start()
        t0 = time.time()
        first = self.step
        try:
            while self.step < self.job.steps:
                host_batch = next(self.data)  # a stall here is between steps
                with self._step_lock:
                    self._in_step = True
                batch = {k: torch.from_numpy(v).to(self.device) for k, v in host_batch.items()}
                # the device plane profiles the run's second step, the first
                # warm one, or its only step
                if self.job.profile and not self._device_tree_dumped and (
                        self.step == first + 1 or self.step + 1 == self.job.steps):
                    self.params, self.opt_state, metrics = self._step_with_device_tree(batch)
                else:
                    self.params, self.opt_state, metrics = self._train_step(self.params, self.opt_state, batch)
                self.step += 1
                self._data_pos = self.data.next_step
                self._touch_heartbeat()
                if self.step % self.job.ckpt_every == 0 or self.step == self.job.steps:
                    self.ckpt.save(self.step, self._state_tree())
                with self._step_lock:
                    self._in_step = False
                    self._take_emergency_checkpoints()
                m = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
                m["step"] = self.step
                self.metrics_log.append(m)
                if self.step % 5 == 0 or self.step == 1:
                    print(f"[train] step {self.step}: loss={m['loss']:.4f} lr={m['lr']:.2e}")
        finally:
            if self.watchdog:
                self.watchdog.stop()
            host_tree = self.sampler.stop() if self.sampler else None
            self.ckpt.wait()
            self.data.close()
        wall = time.time() - t0
        tokens = self.step * self.job.global_batch * self.job.seq_len
        summary = {
            "arch": self.cfg.name,
            "device": str(self.device),
            "steps": self.step,
            "wall_s": wall,
            "tokens_per_s": tokens / max(wall, 1e-9),
            "final_loss": self.metrics_log[-1]["loss"] if self.metrics_log else None,
            "first_loss": self.metrics_log[0]["loss"] if self.metrics_log else None,
            "anomalies": [e.describe() for e in self.anomalies],
        }
        with open(os.path.join(self.job.out_dir, "metrics.json"), "w") as f:
            json.dump({"summary": summary, "steps": self.metrics_log}, f, indent=1)
        if host_tree is not None and host_tree.total() > 0:
            write_report(host_tree, self.job.out_dir, "host_profile")
            summary["host_profile"] = os.path.join(self.job.out_dir, "host_profile.html")
        return summary


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--full", action="store_true", help="full config (default: smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--out", default=TrainJobConfig.out_dir)
    ap.add_argument("--no-resume", action="store_true")
    args = ap.parse_args(argv)
    job = TrainJobConfig(
        arch=args.arch,
        smoke=not args.full,
        device=args.device,
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        lr=args.lr,
        grad_accum=args.grad_accum,
        out_dir=args.out,
        resume=not args.no_resume,
    )
    summary = Trainer(job).run()
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
