"""The fault corpus: deterministic injectable failures across the model zoo.

Each scenario reproduces one production failure shape the paper's mechanism
should catch (its showcase is Ruby coherence livelock — "the simulation
either appears to run normally or terminates abruptly"):

* ``injected_spin``     — classic hot livelock loop (the Fig. 13 analogue);
* ``data_starvation``   — throttled pipeline refill parks the consumer in
                          ``Pipeline.__next__``;
* ``collective_stall``  — one of three hosts parks mid-step, the others pin
                          in the allreduce barrier (straggler + stall);
* ``hard_wedge``        — the whole interpreter is SIGSTOPed (harness-side):
                          only an out-of-process observer can see this one;
* ``moe_imbalance``     — a biased router gate drops >80 % of tokens and the
                          rebalance-retry loop livelocks (torch);
* ``ckpt_wedge``        — a blocking fsync wedges the checkpoint writer and
                          then the train loop in ``CheckpointManager.wait``;
* ``serve_convoy``      — a metrics scraper holds the serving loop's lock,
                          parking decode in ``ServeMetrics.record_step`` (torch).

Fault frames are *named functions* on purpose: the profile signature — not
any instrumentation — is what the daemon's rules key on, exactly like the
paper's per-protocol-action dominance rule.

A copy of ``repro.faults.scenarios`` for the port: every rule, expected
kind, host count and stall timeout is the JAX package's. The host-only
drivers patch the port's seams (``repro_torch.data.Pipeline``,
``repro_torch.checkpoint.manager._sync_path``) and import no torch. The two
model drivers (``requires=("torch",)``) run the port's MoE layer and batched
server on ``ctx.device`` at the config's full width unless ``ctx.smoke``; they
import torch in ``warmup()``, in the child. The rule patterns
``repro::__next__`` and ``repro::wait`` hold for the port because its
resolver labels ``/repro_torch/`` frames ``repro``.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from repro_torch.core.detector import Rule

from .base import Driver, FaultScenario, ScenarioContext, mix_compute, park_while

# ---------------------------------------------------------------------------
# injected_spin — single-thread hot livelock (the paper's Fig. 13 shape)


def injected_livelock_spin(driver) -> float:
    """The fault signature frame: a pure spin that mints no new stacks.

    The loop condition is a plain attribute load (not ``Event.is_set``, a
    Python-level call) so every sample's leaf is *this* frame — the clean
    single-dominant-self-frame shape the trend detector's LIVELOCK rule and
    the paper's dominant-stack rule both key on.
    """
    x = 1.0
    while driver.fault_on:
        x = x * 1.0000001 + 1e-9
    return x


class SpinDriver(Driver):
    def __init__(self, ctx: ScenarioContext):
        self.fault_on = False
        self._i = 0

    def step(self) -> None:
        mix_compute(self._i)
        self._i += 1
        if self.fault_on:
            injected_livelock_spin(self)

    def inject(self) -> None:
        self.fault_on = True

    def clear(self) -> None:
        self.fault_on = False


# ---------------------------------------------------------------------------
# data_starvation — throttled refill: producer parks in the (shimmed)
# dataset, consumer parks in Pipeline.__next__ on the empty queue.


def starved_refill_wait(flag) -> None:
    park_while(flag)


class StarvationDriver(Driver):
    def __init__(self, ctx: ScenarioContext):
        self._fault = threading.Event()
        self._i = 0
        self.pipe = None

    def warmup(self) -> None:
        from repro_torch.data.pipeline import DataConfig, Pipeline, SyntheticLM

        ds = SyntheticLM(DataConfig(vocab=256, seq_len=48, global_batch=8, seed=7))
        inner = ds.batch

        def throttled_batch(step: int):
            starved_refill_wait(self._fault)
            return inner(step)

        ds.batch = throttled_batch  # the injection seam: refill can be parked
        self.pipe = Pipeline(ds, prefetch=2)
        next(self.pipe)  # prime the queue before the agent starts

    def step(self) -> None:
        batch = next(self.pipe)
        # Consumer-side work deliberately slower than batch generation, so a
        # healthy queue is never empty and __next__ returns immediately.
        mix_compute(self._i, scale=2)
        self._i += int(batch["tokens"][0, 0]) % 2 + 1

    def inject(self) -> None:
        self._fault.set()

    def clear(self) -> None:
        self._fault.clear()

    def close(self) -> None:
        self._fault.clear()  # never leave the producer parked
        if self.pipe is not None:
            self.pipe.close()


# ---------------------------------------------------------------------------
# collective_stall — 3 hosts step through a file barrier; host 0 parks
# mid-step during the fault, pinning its peers in the barrier wait.


def parked_worker_wait(flag) -> None:
    park_while(flag)


def allreduce_barrier_wait(ctx: ScenarioContext, step: int, stop_event=None) -> None:
    bdir = os.path.join(ctx.workdir, "barrier")
    os.makedirs(bdir, exist_ok=True)
    mine = os.path.join(bdir, f"h{ctx.host_index}_s{step}")
    with open(mine, "w") as f:
        f.write("1")
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline:
        if all(
            os.path.exists(os.path.join(bdir, f"h{h}_s{step}"))
            for h in range(ctx.n_hosts)
        ):
            return
        if stop_event is not None and stop_event.is_set():
            return  # a peer already shut down; don't wedge teardown
        time.sleep(0.002)


class CollectiveDriver(Driver):
    def __init__(self, ctx: ScenarioContext):
        self.ctx = ctx
        self._fault = threading.Event()
        self._step_no = 0
        self.stop_event = None  # set by the child before the run loop

    BARRIER_EVERY = 4  # amortize the barrier so healthy waits stay small

    def step(self) -> None:
        if self._fault.is_set() and self.ctx.host_index == 0:
            parked_worker_wait(self._fault)
        # Identical compute on every host: clean arrival times align, so the
        # barrier share stays far below the COLLECTIVE_STALL threshold.
        mix_compute(self._step_no, scale=3)
        self._step_no += 1
        if self._step_no % self.BARRIER_EVERY == 0:
            allreduce_barrier_wait(
                self.ctx, self._step_no // self.BARRIER_EVERY, self.stop_event
            )

    def inject(self) -> None:
        self._fault.set()

    def clear(self) -> None:
        self._fault.clear()


# ---------------------------------------------------------------------------
# hard_wedge — SIGSTOP from the harness: the agent itself goes silent, which
# only the out-of-process daemon can notice (TARGET_STALLED).


class BusyDriver(Driver):
    def __init__(self, ctx: ScenarioContext):
        self._i = 0

    def step(self) -> None:
        mix_compute(self._i)
        self._i += 1


# ---------------------------------------------------------------------------
# moe_imbalance — collapsed token distribution (an upstream data bug: every
# token near-identical) routes the whole batch to one top-k pair; capacity
# drops >60 % of assignments and the rebalance-retry loop livelocks.


def router_imbalance_retry(driver, x) -> float:
    """Retry frame: re-dispatch until the drop rate recovers (livelock while
    the token distribution stays collapsed)."""
    dropped = 1.0
    while dropped > 0.5 and not driver._fault_cleared():
        _, aux = driver._step_fn(driver.params, x)
        dropped = float(aux["dropped_frac"])
        driver.retry_passes += 1
    return dropped


def make_router_tokens(rng, batch: int, seq: int, d_model: int):
    return rng.standard_normal((batch, seq, d_model)).astype(np.float32)


def collapsed_router_tokens(rng, batch: int, seq: int, d_model: int, v):
    """Degenerate inputs: one direction + a whisper of noise, so every
    token's top-k lands on the same expert pair and capacity drops the rest."""
    noise = rng.standard_normal((batch, seq, d_model)).astype(np.float32)
    return v[None, None, :] + 0.05 * noise


def torch_device(ctx: ScenarioContext):
    """The torch device ``ctx`` names. ``cuda`` with no card raises: a model
    scenario never falls back to the CPU."""
    import torch

    dev = torch.device(ctx.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"scenario placed on {ctx.device!r}, but torch sees no CUDA device")
    return dev


def _stats(values: list[float]) -> dict:
    if not values:
        return {"n": 0}
    return {"n": len(values), "mean": sum(values) / len(values), "min": min(values), "max": max(values)}


class MoEImbalanceDriver(Driver):
    """One deepseek-moe-16b MoE layer (the port's ``models.moe``), its
    parameters from ``init_params`` on a generator seeded 0 on ``ctx.device``
    (f32, as the JAX driver's ``init_params``), fed f32 tokens from numpy as
    the JAX driver feeds its jitted ``moe``. At full width a batch of 2 x 64
    tokens gives each of the 64 experts 16 slots; collapsed inputs send every
    token to the same 6 experts, so 96 of 768 assignments are kept (0.875
    dropped)."""

    BATCH, SEQ = 2, 64

    def __init__(self, ctx: ScenarioContext):
        self.ctx = ctx
        self._fault = threading.Event()
        self._i = 0
        self._rng = np.random.default_rng(11)
        self.retry_passes = 0
        self.dropped: dict[str, list[float]] = {"clean": [], "collapsed": []}

    def _fault_cleared(self) -> bool:
        if not self._fault.is_set():
            return True
        stop = getattr(self, "stop_event", None)
        return stop is not None and stop.is_set()

    def warmup(self) -> None:
        import torch

        from repro_torch.configs import get_config
        from repro_torch.models.modules import init_params
        from repro_torch.models.moe import _capacity, moe, moe_spec

        dev = torch_device(self.ctx)
        cfg = get_config("deepseek-moe-16b", smoke=self.ctx.smoke)
        self.cfg = cfg
        self.capacity = _capacity(self.BATCH * self.SEQ, cfg)
        self.params = init_params(moe_spec(cfg), torch.Generator(device=dev).manual_seed(0))

        @torch.inference_mode()
        def step_fn(p, x):
            return moe(p, torch.from_numpy(x).to(dev), cfg)

        self._step_fn = step_fn
        self._collapse_v = (
            3.0 * self._rng.standard_normal(cfg.d_model).astype(np.float32)
        )
        x = make_router_tokens(self._rng, self.BATCH, self.SEQ, cfg.d_model)
        self._step_fn(self.params, x)  # allocate before the agent starts

    def step(self) -> None:
        collapsed = self._fault.is_set()
        if collapsed:
            x = collapsed_router_tokens(
                self._rng, self.BATCH, self.SEQ, self.cfg.d_model, self._collapse_v
            )
        else:
            x = make_router_tokens(self._rng, self.BATCH, self.SEQ, self.cfg.d_model)
        mix_compute(self._i)
        self._i += 1
        _, aux = self._step_fn(self.params, x)
        dropped = float(aux["dropped_frac"])
        self.dropped["collapsed" if collapsed else "clean"].append(dropped)
        if dropped > 0.5:
            router_imbalance_retry(self, x)

    def inject(self) -> None:
        self._fault.set()

    def clear(self) -> None:
        self._fault.clear()

    def summary(self) -> dict:
        return {
            "arch": self.cfg.name,
            "tokens": self.BATCH * self.SEQ,
            "capacity": self.capacity,
            "dropped_frac": {k: _stats(v) for k, v in self.dropped.items()},
            "retry_passes": self.retry_passes,
        }


# ---------------------------------------------------------------------------
# ckpt_wedge — blocking fsync: the writer thread parks in the shimmed
# _sync_path, then the train loop parks in CheckpointManager.wait.


def wedged_fsync_wait(flag) -> None:
    park_while(flag)


class CkptWedgeDriver(Driver):
    def __init__(self, ctx: ScenarioContext):
        self.ctx = ctx
        self._fault = threading.Event()
        self._i = 0

    def warmup(self) -> None:
        from repro_torch.checkpoint import manager as manager_mod

        self._mod = manager_mod
        self._orig_sync = manager_mod._sync_path
        self.mgr = manager_mod.CheckpointManager(
            os.path.join(self.ctx.workdir, "ckpt"), keep=2, fsync=True
        )
        self.state = {
            "w": np.zeros(16_384, np.float32),
            "opt": {"m": np.zeros(16_384, np.float32)},
        }
        self.mgr.save(0, self.state, blocking=True)

    def _wedged_sync(self, path: str) -> None:
        wedged_fsync_wait(self._fault)
        self._orig_sync(path)

    def step(self) -> None:
        mix_compute(self._i)
        self._i += 1
        # Sparse enough that the previous async writer has long finished:
        # a healthy loop's wait() in save is near-instant, so the clean
        # "repro::wait" share stays far under the CKPT_WEDGE threshold.
        if self._i % 8 == 0:
            self.mgr.save(self._i, self.state)

    def inject(self) -> None:
        self._fault.set()
        self._mod._sync_path = self._wedged_sync

    def clear(self) -> None:
        self._fault.clear()
        self._mod._sync_path = self._orig_sync

    def close(self) -> None:
        self.clear()
        self.mgr.wait()


# ---------------------------------------------------------------------------
# serve_convoy — a scraper holds ServeMetrics' lock; decode parks in
# record_step (lock convoy in the serving loop).


def hold_metrics_lock(metrics, flag) -> None:
    with metrics._lock:
        park_while(flag)


class ServeConvoyDriver(Driver):
    """The port's ``BatchedServer`` over gemma-2b (full width unless
    ``ctx.smoke``) on ``ctx.device``: each round serves two 4-token prompts
    of 6 new tokens at batch 2 from a fresh decode state, as the JAX driver
    does; every decode step launches the RMSNorm kernel on the card."""

    def __init__(self, ctx: ScenarioContext):
        self.ctx = ctx
        self._fault = threading.Event()
        self._scraper_stop = threading.Event()
        self._round = 0
        self._t0: float | None = None
        self._t_inject: float | None = None
        self._t_clear: float | None = None
        self._round_ends: list[float] = []

    def warmup(self) -> None:
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import BatchedServer, Request
        from repro_torch.models import Model

        self._Request = Request
        cfg = get_config("gemma-2b", smoke=self.ctx.smoke)
        self.model = Model(cfg, device=torch_device(self.ctx))
        self.vocab = cfg.vocab
        self.server = BatchedServer(self.model, batch=2, max_len=64)
        self._req_rng = np.random.default_rng(3)
        self._run_round(max_new=2)  # Triton compiles before the agent starts

        def scrape():
            while not self._scraper_stop.is_set():
                if self._fault.is_set():
                    hold_metrics_lock(self.server.metrics, self._fault)
                else:
                    self.server.metrics.snapshot()
                    time.sleep(0.02)

        self._scraper = threading.Thread(
            target=scrape, name="serve-metrics-scraper", daemon=True
        )
        self._scraper.start()

    def _run_round(self, max_new: int = 6) -> list:
        rng = self._req_rng
        reqs = [
            self._Request(
                rid=self._round * 10 + i,
                prompt=rng.integers(0, self.vocab, 4).astype(np.int32),
                max_new=max_new,
            )
            for i in range(2)
        ]
        # Fresh decode state per round: the demo server's context is finite.
        self.server.state = self.model.init_decode_state(self.server.batch, self.server.max_len)
        self.server.pos = 0
        self.server.slots = [None] * self.server.batch
        self.server.consumed = [0] * self.server.batch
        self.server.run(reqs)
        self._round += 1
        return reqs

    def step(self) -> None:
        if self._t0 is None:
            self._t0 = time.monotonic()
        self._run_round()
        self._round_ends.append(time.monotonic())

    def inject(self) -> None:
        self._t_inject = time.monotonic()
        self._fault.set()

    def clear(self) -> None:
        self._t_clear = time.monotonic()
        self._fault.clear()

    def close(self) -> None:
        self._fault.clear()
        self._scraper_stop.set()

    def summary(self) -> dict:
        """Rounds completed a second before the injection and inside the
        fault window (by the child's clock)."""
        ends = self._round_ends
        t_end = ends[-1] if ends else time.monotonic()
        t0 = self._t0 if self._t0 is not None else t_end
        t_inject = self._t_inject if self._t_inject is not None else t_end
        clean = sum(1 for t in ends if t < t_inject)
        rate = {"clean": clean / (t_inject - t0) if t_inject > t0 else None, "faulted": None}
        if self._t_inject is not None and self._t_clear is not None:
            faulted = sum(1 for t in ends if self._t_inject <= t < self._t_clear)
            rate["faulted"] = faulted / (self._t_clear - self._t_inject)
        return {
            "arch": self.model.cfg.name,
            "rounds": len(ends),
            "decode_steps": self.server.steps,
            "rounds_per_s": rate,
        }


# ---------------------------------------------------------------------------
# registry


SCENARIOS: dict[str, FaultScenario] = {
    s.name: s
    for s in (
        FaultScenario(
            name="injected_spin",
            description="hot livelock loop on the main thread (Fig. 13 analogue)",
            make_driver=SpinDriver,
            rules=(
                Rule(pattern="injected_livelock_spin", threshold=0.5,
                     consecutive=2, kind="LIVELOCK_SUSPECT", self_only=False),
            ),
            expected_kinds=("LIVELOCK_SUSPECT", "LIVELOCK"),
        ),
        FaultScenario(
            name="data_starvation",
            description="throttled pipeline refill starves the training consumer",
            make_driver=StarvationDriver,
            rules=(
                Rule(pattern="repro::__next__", threshold=0.35,
                     consecutive=2, kind="INPUT_STARVED", self_only=False),
            ),
            expected_kinds=("INPUT_STARVED",),
        ),
        FaultScenario(
            name="collective_stall",
            description="one of three hosts parks mid-step; peers pin in the allreduce barrier",
            make_driver=CollectiveDriver,
            rules=(
                Rule(pattern="allreduce_barrier_wait", threshold=0.6,
                     consecutive=3, kind="COLLECTIVE_STALL", self_only=False),
            ),
            expected_kinds=("COLLECTIVE_STALL", "STRAGGLER", "LIVELOCK"),
            n_hosts=3,
        ),
        FaultScenario(
            name="hard_wedge",
            description="SIGSTOPed interpreter: the agent goes silent, only the daemon can tell",
            make_driver=BusyDriver,
            expected_kinds=("TARGET_STALLED",),
            harness_side=True,
            stall_timeout_s=1.5,
        ),
        FaultScenario(
            name="moe_imbalance",
            description="collapsed router inputs swamp one expert pair: >60% tokens dropped, rebalance retry livelocks",
            make_driver=MoEImbalanceDriver,
            rules=(
                Rule(pattern="router_imbalance_retry", threshold=0.5,
                     consecutive=2, kind="MOE_IMBALANCE", self_only=False),
            ),
            expected_kinds=("MOE_IMBALANCE", "LIVELOCK", "SHARE_DRIFT"),
            requires=("torch",),
        ),
        FaultScenario(
            name="ckpt_wedge",
            description="blocking fsync wedges the checkpoint writer, then the train loop",
            make_driver=CkptWedgeDriver,
            rules=(
                Rule(pattern="repro::wait", threshold=0.3,
                     consecutive=2, kind="CKPT_WEDGE", self_only=False),
            ),
            expected_kinds=("CKPT_WEDGE",),
        ),
        FaultScenario(
            name="serve_convoy",
            description="metrics scraper holds the serving lock; decode parks in record_step",
            make_driver=ServeConvoyDriver,
            rules=(
                Rule(pattern="record_step", threshold=0.35,
                     consecutive=2, kind="LOCK_CONVOY", self_only=False),
            ),
            expected_kinds=("LOCK_CONVOY", "SHARE_DRIFT"),
            requires=("torch",),
        ),
    )
}

SMOKE_SCENARIOS = ("injected_spin", "data_starvation")
