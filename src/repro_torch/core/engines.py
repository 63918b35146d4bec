"""Execution engines — the AS-CPU / TS-CPU / O3-CPU analogue (paper Fig. 1),
the counterpart of ``repro.core.engines``.

The paper compares three simulator fidelities for the *same* workload and
finds the cost ordering counter-intuitive (the "simple" TS-CPU is often no
faster than the detailed O3). The port exposes the same experiment for the
*same model*. PyTorch removes per-op dispatch with a CUDA graph and with
nothing else, so a graph is what tells the three engines apart:

* ``EagerEngine``     — op-by-op dispatch, PyTorch's own (the counterpart of
                        ``jax.disable_jit``): every op is dispatched from
                        Python, the host's bookkeeping frames dominate;
* ``BlockwiseEngine`` — one CUDA graph per stage, a Python loop between them
                        and a ``torch.cuda.synchronize`` at every boundary
                        (JAX's ``jit`` per stage and ``block_until_ready``):
                        the busy-wait analogue of TS-CPU's lockup cache;
* ``CompiledEngine``  — the whole function in one CUDA graph (JAX's single
                        ``jit`` with donation): the most work before the first
                        step, the least per step, as O3 often is.

**The graph protocol.** A graph engine takes its first call's arguments as
its static input buffers: a copy of each tensor, or the tensor itself where
its argument is named in ``donate_argnums`` (the caller hands the buffer
over, as JAX's donation does). It warms the function up once on a side
stream (lazy initialisation, the Triton compile, the kernel libraries'
loads) and captures it into a ``torch.cuda.CUDAGraph``, which runs nothing:
the first call's result is the warm-up's, copied into the graph's static
outputs, so the first call runs the function once, as every later call does
(a function that updates its arguments in place, as the train step's AdamW
does, takes one step). Each later call copies its tensor arguments into the
static buffers and replays;
an argument that already is its static buffer is not copied, and a donated
argument must be it (the graph reads no other memory). The outputs are the
graph's static outputs, so **the next call overwrites them**: copy what must
outlive it. A call whose arguments differ from the first call's in tree
structure, shape, dtype, device, or any value that is no tensor raises; an
engine never captures again and never falls back to eager. On a CUDA device a
capture that fails raises.

On the CPU there is no graph (``captured`` stays False): the two engines run
the same protocol, the static buffers, the copy-in, the errors and the
aliasing of outputs, by calling the function on the static buffers and
copying its result into the first call's outputs.

**Launch counts.** ``kernels.ops`` counts a launch where Python launches a
kernel, and a replay runs no Python. An engine reads the counters' delta over
the capture (which ran no kernel), takes it back off and adds it once per
replay (``ops.add_launches``), so every engine counts the launches that ran:
the warm-up's on the first call and each replay's after it.

Do not capture under ``torch.profiler``: ``core/scope.py``'s ranges are
entered only while a profiler records. Benchmarked in
``repro_torch.benchmarks.fig01_engines``.
"""

from __future__ import annotations

import time
from collections.abc import Callable, Sequence
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import ops


@dataclass
class EngineResult:
    name: str
    outputs: Any
    wall_s: float
    steps: int

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.wall_s if self.wall_s > 0 else float("inf")


def block_until_ready(tree):
    """Wait for the devices of ``tree``'s CUDA tensors (the counterpart of
    ``jax.block_until_ready``); returns ``tree``."""
    for dev in {t.device for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


class Engine:
    name = "engine"
    captured = False  # whether the engine runs a CUDA graph

    def run_step(self, *args, **kw):  # pragma: no cover - interface
        raise NotImplementedError

    def run(self, n_steps: int, make_args: Callable[[int], tuple]) -> EngineResult:
        out = None
        t0 = time.perf_counter()
        for i in range(n_steps):
            out = self.run_step(*make_args(i))
        out = block_until_ready(out)
        return EngineResult(self.name, out, time.perf_counter() - t0, n_steps)


class EagerEngine(Engine):
    """Op-by-op dispatch: every op is dispatched individually."""

    name = "eager"

    def __init__(self, fn: Callable):
        self.fn = fn

    def run_step(self, *args, **kw):
        return self.fn(*args, **kw)


def _uses_graph(device: torch.device) -> bool:
    return device.type == "cuda"


# One warm-up stream a device for every graph: cuBLAS keeps a workspace for
# each stream it has run on for the life of the process (~1 GB over a
# blockwise engine's 38 stages, one stream each).
_WARM_UP_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


class _CUDAGraph:
    """One function's CUDA graph on ``device``: warm-up, capture, replay."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()

    def warm_up(self, fn: Callable, args: tuple):
        """``fn(*args)`` on the side stream; -> its outputs, which the
        current stream may read (it waits for the side stream, and the next
        warm-up's side stream waits for it before reusing their memory)."""
        if self.device not in _WARM_UP_STREAMS:
            _WARM_UP_STREAMS[self.device] = torch.cuda.Stream(self.device)
        side = _WARM_UP_STREAMS[self.device]
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            out = fn(*args)
        torch.cuda.current_stream(self.device).wait_stream(side)
        return out

    def capture(self, fn: Callable, args: tuple):
        with torch.cuda.device(self.device), torch.cuda.graph(self.graph):
            return fn(*args)

    def replay(self) -> None:
        self.graph.replay()


class _Static:
    """The static buffers of one graph engine's calls: the first call's
    arguments (copies, or the donated tensors themselves), their signature,
    and the copy-in of a later call's arguments."""

    def __init__(self, args: tuple, donate_argnums: Sequence[int]):
        self.donated = frozenset(donate_argnums)
        leaves, self.spec = pytree.tree_flatten(list(args))
        self.owner = self._owners(args)
        self.leaves = [self._adopt(x, self.owner[i] in self.donated) for i, x in enumerate(leaves)]
        self.signature = [self._sig(x) for x in leaves]
        devices = {x.device for x in self.leaves if isinstance(x, torch.Tensor)}
        if len(devices) > 1:
            raise ValueError(f"arguments lie on several devices: {sorted(map(str, devices))}")
        self.device = devices.pop() if devices else torch.device("cpu")
        self.args = tuple(pytree.tree_unflatten(self.leaves, self.spec))

    @staticmethod
    def _owners(args: tuple) -> list[int]:
        """The argument index of each flattened leaf."""
        return [i for i, a in enumerate(args) for _ in pytree.tree_leaves(a)]

    @staticmethod
    def _adopt(x, donated: bool):
        return x.detach().clone() if isinstance(x, torch.Tensor) and not donated else x

    @staticmethod
    def _sig(x):
        return ("tensor", tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor) else ("value", x)

    def copy_in(self, args: tuple) -> None:
        leaves, spec = pytree.tree_flatten(list(args))
        if spec != self.spec:
            raise ValueError(f"the call's arguments have another tree structure than the first call's: {spec} "
                             f"against {self.spec}")
        for i, (x, static, sig) in enumerate(zip(leaves, self.leaves, self.signature)):
            if self._sig(x) != sig:
                raise ValueError(f"argument {self.owner[i]}, leaf {i}: {self._sig(x)[1:]} where the first call had "
                                 f"{sig[1:]}; the engine does not capture again")
            if not isinstance(x, torch.Tensor) or x is static:
                continue
            if self.owner[i] in self.donated:
                raise ValueError(f"argument {self.owner[i]} is donated: pass the tensor the first call handed over")
            static.copy_(x)


def _copy_out(static_out, out):
    """``out``'s tensors copied into the static outputs (the CPU's replay,
    and the first call on the card, whose values are the warm-up's)."""
    for s, o in zip(pytree.tree_leaves(static_out), pytree.tree_leaves(out)):
        if isinstance(s, torch.Tensor) and s is not o:
            s.copy_(o)
    return static_out


class _Graphed:
    """One function run through the graph protocol (see the module docstring)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graph = None
        self.launches: dict[str, int] = {}  # counted by the wrappers during the capture
        self.out = None

    def first(self, args: tuple, device: torch.device):
        if not _uses_graph(device):
            self.out = self.fn(*args)
            return self.out
        self.graph = _CUDAGraph(device)
        warm = self.graph.warm_up(self.fn, args)
        before = ops.launch_counts()
        self.out = self.graph.capture(self.fn, args)
        after = ops.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        ops.add_launches({k: -n for k, n in self.launches.items()})
        # the capture ran nothing: the warm-up's result is this call's, and a
        # replay now would run the function a second time
        return _copy_out(self.out, warm)

    def again(self, args: tuple):
        if self.graph is None:
            return _copy_out(self.out, self.fn(*args))
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.out


class BlockwiseEngine(Engine):
    """One CUDA graph per stage, a Python loop across stages, a host sync at
    each boundary (with ``sync_between``). Stage i's static input is stage
    i - 1's static output; the first stage's is the call's arguments
    ``(carry, *extra)``, and every stage also reads ``extra``'s static
    buffers. ``donate_argnums`` hands those arguments' tensors to the engine
    as its static buffers."""

    name = "blockwise"

    def __init__(self, stages: Sequence[Callable], sync_between: bool = True, donate_argnums: Sequence[int] = ()):
        self.stages = [_Graphed(s) for s in stages]
        self.sync_between = sync_between
        self.donate_argnums = tuple(donate_argnums)
        self.static: _Static | None = None

    def run_step(self, carry, *extra):
        if self.static is None:
            self.static = _Static((carry, *extra), self.donate_argnums)
            self.captured = _uses_graph(self.static.device)
            carry, *extra = self.static.args
            for stage in self.stages:
                carry = stage.first((carry, *extra), self.static.device)
                self._sync()
            return carry
        self.static.copy_in((carry, *extra))
        carry, *extra = self.static.args
        for stage in self.stages:
            carry = stage.again((carry, *extra))
            self._sync()
        return carry

    def _sync(self) -> None:
        if self.sync_between and self.captured:
            torch.cuda.synchronize(self.static.device)


class CompiledEngine(Engine):
    """The whole function in one CUDA graph; ``donate_argnums`` hands those
    arguments' tensors to the engine as its static buffers. The outputs are
    the graph's: the next call overwrites them."""

    name = "compiled"

    def __init__(self, fn: Callable, donate_argnums: Sequence[int] = ()):
        self.graphed = _Graphed(fn)
        self.donate_argnums = tuple(donate_argnums)
        self.static: _Static | None = None

    def run_step(self, *args):
        if self.static is None:
            self.static = _Static(args, self.donate_argnums)
            self.captured = _uses_graph(self.static.device)
            return self.graphed.first(self.static.args, self.static.device)
        self.static.copy_in(args)
        return self.graphed.again(self.static.args)


def compare_engines(
    engines: Sequence[Engine],
    n_steps: int,
    make_args: Callable[[int], tuple],
    sampler_factory: Callable[[], Any] | None = None,
) -> list[dict]:
    """Run each engine for ``n_steps`` under (optionally) a fresh sampler.

    Returns per-engine dicts with throughput, whether the engine ran a CUDA
    graph, and top host-plane frames — the data behind the Fig. 1 analogue.
    """
    rows = []
    for eng in engines:
        sampler = sampler_factory() if sampler_factory else None
        if sampler:
            sampler.start()
        res = eng.run(n_steps, make_args)
        tree = sampler.stop() if sampler else None
        row = {
            "engine": eng.name,
            "steps": res.steps,
            "wall_s": res.wall_s,
            "steps_per_s": res.steps_per_s,
            "captured": eng.captured,
        }
        if tree is not None and tree.total() > 0:
            flat = tree.flatten()
            total = tree.total()
            torch_frames = sum(v for k, v in flat.items() if k.startswith("torch::"))
            repro_frames = sum(v for k, v in flat.items() if k.startswith("repro::"))
            row["torch_frame_share"] = torch_frames / max(total, 1)
            row["repro_frame_share"] = repro_frames / max(total, 1)
            row["mean_depth"] = (
                sum(d for _, d in sampler.depth_trace()) / max(len(sampler.depth_trace()), 1)
            )
        rows.append(row)
    return rows
