"""Fault-scenario plumbing: the corpus's scenario spec + driver protocol.

A :class:`FaultScenario` is a deterministic, injectable failure: a workload
driver (run in a *child* process so the harness's own threads never pollute
the sampled profile), ``inject()``/``clear()`` hooks flipped mid-run by the
harness, the dominance rules the daemon should watch it with, and the verdict
kinds that count as detecting it.  This mirrors how the paper validates the
gem5 profiler: a known failure (Ruby deadlock/livelock) is reproduced on
demand and the detector is graded on whether — and how fast — it fires.

A copy of ``repro.faults.base`` for the port. The module stays import-light
(no torch): scenario *construction* is lazy via ``make_driver``, and the two
model drivers import torch only in their ``warmup()``, inside the child, so
listing the corpus or running the host-only subset never loads torch.
:class:`ScenarioContext` carries the placement explicitly: ``device`` is the
torch device a model driver runs on (the card unless ``"cpu"`` is asked
for) and ``smoke`` selects the config's smoke size.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from importlib.util import find_spec
from collections.abc import Callable

import numpy as np

from repro_torch.core.detector import Rule


@dataclass
class ScenarioContext:
    """What a driver knows about its placement: which host it is, how many
    peers exist, the run's shared scratch directory (file barriers,
    checkpoint dirs), the torch device a model driver runs on and whether it
    takes the config's smoke size. A model driver uses exactly ``device``: on
    ``"cuda"`` with no card it raises, it never falls back to the CPU."""

    host_index: int
    n_hosts: int
    workdir: str
    device: str = "cuda"
    smoke: bool = False


class Driver:
    """One scenario's workload, run on the child process's main thread.

    ``step()`` is one iteration of the deterministic workload loop; the child
    calls it until told to stop.  ``inject()``/``clear()`` are called from the
    child's control-poller thread, so implementations must flip thread-safe
    flags (events) that ``step()`` observes, never mutate shared state
    non-atomically.
    """

    def warmup(self) -> None:  # compile/allocate before the agent starts
        pass

    def step(self) -> None:
        raise NotImplementedError

    def inject(self) -> None:
        pass

    def clear(self) -> None:
        pass

    def close(self) -> None:
        pass

    def summary(self) -> dict:
        """What the run measured (a model driver's numbers), for the child's
        exit report; nothing by default."""
        return {}


@dataclass
class FaultScenario:
    name: str
    description: str
    make_driver: Callable[[ScenarioContext], Driver]
    # Daemon-side dominance rules for this workload (the paper's
    # protocol-scoped rule, e.g. its SLICC-action threshold): each scenario
    # names the failure signature it should be watched for.
    rules: tuple[Rule, ...] = ()
    # Verdict kinds that count as detecting this fault (scoreboard ground
    # truth); any other scored verdict inside the fault window still counts
    # as a detection by its own detector column.
    expected_kinds: tuple[str, ...] = ()
    n_hosts: int = 1
    # Modules the driver needs importable in the child (e.g. "torch"); the
    # harness skips — loudly — scenarios whose deps are missing.
    requires: tuple[str, ...] = ()
    # True: inject/clear are applied by the harness to the child *process*
    # (SIGSTOP/SIGCONT) — the fully-wedged-interpreter case only an
    # out-of-process observer can see.
    harness_side: bool = False
    # Daemon stall-timeout override (the hard-wedge scenario needs it shorter
    # than the fault window so TARGET_STALLED can fire inside it).
    stall_timeout_s: float | None = None
    extra_child_env: dict = field(default_factory=dict)

    def available(self) -> tuple[bool, str]:
        for mod in self.requires:
            if find_spec(mod) is None:
                return False, f"missing dependency: {mod}"
        return True, ""


# ---------------------------------------------------------------------------
# Deterministic clean-phase compute: a rotating mixture of distinct named
# frames, so healthy windows have a diverse share vector (no single frame
# dominates) and a steady baseline for SHARE_DRIFT.  Each phase is a real
# numpy workload — the profiles under test are genuine, not synthetic trees.

_RNG = np.random.default_rng(0xFA017)


def phase_matmul(reps: int = 3) -> float:
    a = _RNG.standard_normal((48, 48))
    s = 0.0
    for _ in range(reps):
        s += float((a @ a.T).trace())
    return s


def phase_sort(reps: int = 3) -> float:
    v = _RNG.standard_normal(12_000)
    s = 0.0
    for _ in range(reps):
        s += float(np.sort(v)[0])
    return s


def phase_fft(reps: int = 2) -> float:
    v = _RNG.standard_normal(8_192)
    s = 0.0
    for _ in range(reps):
        s += float(np.abs(np.fft.rfft(v)).sum())
    return s


def phase_reduce(reps: int = 4) -> float:
    m = _RNG.standard_normal((64, 256))
    s = 0.0
    for _ in range(reps):
        s += float(np.log1p(np.abs(m)).sum())
    return s


_PHASES = (phase_matmul, phase_sort, phase_fft, phase_reduce)


def mix_compute(step: int, scale: int = 1) -> float:
    """One slice of rotating compute (~a few ms): ``step`` picks the phase."""
    s = 0.0
    for k in range(scale):
        s += _PHASES[(step + k) % len(_PHASES)]()
    return s


def park_while(flag, poll_s: float = 0.005) -> None:
    """Busy-park until ``flag`` (threading.Event) clears — the generic
    "thread pinned in one wait frame" shape every scenario's fault needs.
    Callers wrap this in a *named* function so the profile shows the fault's
    own signature frame, not this helper."""
    while flag.is_set():
        time.sleep(poll_s)
