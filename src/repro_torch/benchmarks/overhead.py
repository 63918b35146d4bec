"""§V-E overhead claim for the port: profiler overhead vs sampling period,
per backend (the counterpart of the JAX package's ``benchmarks/overhead.py``).

The paper claims 0.5 s sampling is 'negligible overhead' *because* profiling
runs out-of-process — the target pays only for frame capture.  We run the
JAX benchmark's fixed CPU workload unprofiled, then under both of the port's
backends at 0.5s / 0.1s / 0.02s and report the slowdown side by side:

* ``thread`` — in-process helper thread: capture + symbol resolution +
  classification + tree merging all burn target cycles;
* ``daemon`` — in-process raw-frame publisher only; resolution/merging/
  detection run in a separate ``repro_torch.profilerd`` process.

Host-only: it loads no torch (the workload is pure Python; what the agent
costs a job on the card is ``chip_smoke.py``'s ``engines`` phase).

  PYTHONPATH=src python -m repro_torch.benchmarks.overhead
"""

from __future__ import annotations

import os
import tempfile
import time

from repro_torch.core import SamplerConfig, make_sampler

from .common import row

PERIODS = (0.5, 0.1, 0.02)


def workload(seconds=1.2):
    t0 = time.perf_counter()
    x = 0.0
    i = 0
    while time.perf_counter() - t0 < seconds:
        x += (i % 7) * 0.5
        i += 1
    return i


def _measure(backend: str, period: float, base: float) -> tuple[float, float, int]:
    cfg = SamplerConfig(period_s=period, backend=backend)
    if backend == "daemon":
        d = tempfile.mkdtemp(prefix="repro-overhead-")
        cfg = SamplerConfig(
            period_s=period, backend=backend, spool_path=os.path.join(d, "bench.spool"),
            spawn_daemon=True,
        )
    s = make_sampler(cfg)
    s.start()
    if hasattr(s, "wait_ready"):
        s.wait_ready()  # keep daemon start-up out of the steady-state number
    n = workload()
    s.stop()
    overhead = (base - n) / base
    return n / base, max(overhead, 0.0), s.n_samples


def main() -> list[str]:
    out = []
    base = workload()
    for period in PERIODS:
        t_rel, t_ovh, t_n = _measure("thread", period, base)
        d_rel, d_ovh, d_n = _measure("daemon", period, base)
        out.append(
            row(
                f"overhead_period_{period}",
                period * 1e6,
                f"thread_overhead={t_ovh:.4f};daemon_overhead={d_ovh:.4f};"
                f"thread_iters_rel={t_rel:.4f};daemon_iters_rel={d_rel:.4f};"
                f"thread_samples={t_n};daemon_samples={d_n}",
            )
        )
    return out


if __name__ == "__main__":
    for r in main():
        print(r)
