"""Deterministic, sharded, resumable synthetic LM data pipeline.

Counter-based determinism: batch ``step`` is a pure function of
``(seed, step, host_id)`` — no incremental RNG state — so

* **resume** after restart is exact (checkpoint stores only ``next_step``);
* **sharding** is by construction (host h draws rows [h*B/H, (h+1)*B/H));
* **elastic re-sharding** works: a restart with a different host count
  re-partitions the same global batch.

The token stream has learnable structure (a noisy affine bigram process over
the vocab) so example runs show a genuinely decreasing loss, plus a fixed
"syntax" token every 8 positions that models latch onto quickly.

``Pipeline`` adds a background prefetch thread (bounded queue). Its frames
appear in the host-plane profile under ``repro::_prefetch_worker`` — input
starvation shows up exactly like the paper's Ruby busy-wait.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from collections.abc import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    noise: float = 0.1  # fraction of uniform-random tokens

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Stateless batch generator: batch(step) is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id, 0xDA7A])
        )
        B, S, V = cfg.host_batch, cfg.seq_len, cfg.vocab
        x = np.empty((B, S + 1), np.int64)
        x[:, 0] = rng.integers(0, V, B)
        mult = 31 if V > 31 else 3
        noise = rng.random((B, S)) < cfg.noise
        rand_tok = rng.integers(0, V, (B, S))
        for t in range(1, S + 1):
            nxt = (x[:, t - 1] * mult + 7) % V
            x[:, t] = np.where(noise[:, t - 1], rand_tok[:, t - 1], nxt)
        x[:, ::8] = 1 % V  # periodic "syntax" anchor token
        tokens = x[:, :-1].astype(np.int32)
        labels = x[:, 1:].astype(np.int32)
        return {
            "tokens": tokens,
            "labels": labels,
            "loss_mask": np.ones((B, S), np.float32),
        }


class Pipeline:
    """Prefetching iterator with checkpointable position."""

    def __init__(self, dataset: SyntheticLM, *, prefetch: int = 2, start_step: int = 0):
        self.dataset = dataset
        self.next_step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._produce_step = start_step
        self._thread = threading.Thread(target=self._prefetch_worker, name="repro-data-prefetch", daemon=True)
        self._thread.start()

    def _prefetch_worker(self) -> None:
        while not self._stop.is_set():
            batch = self.dataset.batch(self._produce_step)
            item = (self._produce_step, batch)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            self._produce_step += 1

    def __next__(self) -> dict[str, np.ndarray]:
        step, batch = self._q.get()
        # A restart may have rewound next_step; regenerate if out of sync.
        if step != self.next_step:
            batch = self.dataset.batch(self.next_step)
        self.next_step += 1
        return batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    # -- checkpoint interface ---------------------------------------------------

    def state_dict(self) -> dict:
        return {"next_step": self.next_step}

    def load_state_dict(self, state: dict) -> None:
        self.next_step = int(state["next_step"])

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
