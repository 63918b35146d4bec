"""Shape-only cost of one step on the meta device: the port's stand-in for
XLA's ``cost_analysis`` and ``memory_analysis``.

The JAX dry-run compiles a step and reads the compiler's cost and memory
plan. The port has no compiler: :class:`MetaTrace` is a
``TorchDispatchMode`` under which the step runs once on meta tensors (shapes
and dtypes, no data, no memory), and it counts what the same step would do on
the card:

* a :class:`~repro_torch.core.calltree.CallTree` with the device tree's
  counters (``core/device_tree.py``), keyed by the names ``core/scope.py``
  enters (the forward under ``fwd_bwd`` renamed ``jvp(...)``, the backward
  under ``transpose(jvp(...))`` and the autograd node that runs it), each op
  a leaf by its aten name:

  - ``flops``: 2·M·N·K for ``aten::mm`` and ``addmm`` (2·B·M·N·K for
    ``bmm`` and ``baddbmm``), as the profiler counts them, plus each
    hand-written kernel's work (``ops.flash_work``; its leaf is
    ``kernel:<key>``, as in the device tree);
  - ``bytes``: operand plus result bytes of each op that launches a kernel
    (an op that writes in place writes its first operand; a result is
    written where the op allocated it); views, allocations and metadata ops
    move nothing;
  - ``ops``: the ops that launch a kernel, and the kernels' calls;
  - ``kernels``: the hand-written kernels' calls (the meta path of
    ``kernels/ops.py``, which reports them here);
  - ``coll_bytes`` and ``coll_bytes::<kind>``: the bytes a rank sends in a
    collective whose meta path reports them (``record_collective``: the
    expert-parallel MoE's all-to-all, ``models/moe_shard_map.py``); its
    leaf is the collective's kind.

* the peak of live device bytes: each storage counts from the op that
  allocated it until its last reference drops (a finalizer on the storage,
  whose Python object lives as long as the C++ storage), so the trace follows
  the Python and autograd lifetimes of the eager step on the card. Tensors
  that exist before the trace (the state) are adopted as its baseline.

The dispatch mode sees the ops that reach a backend, after the composite ops
(``matmul``, ``linear``, ``reshape``) decomposed; the device tree costs the
outermost op as the profiler records it. The two agree on the flops, and on
the bytes up to the copies a composite op makes inside (a ``reshape`` that
copies counts its copy here).
"""

from __future__ import annotations

import weakref
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import scope as _scope_mod
from .calltree import CallTree
from .device_tree import _WRITE_ONLY, FWD_BWD
from .scope import KERNEL_PREFIX

# aten ops that launch no kernel (allocations, metadata) beside the views
_NO_KERNEL = frozenset({
    "aten::empty", "aten::empty_strided", "aten::new_empty", "aten::new_empty_strided", "aten::empty_like",
    "aten::detach", "aten::lift_fresh", "aten::alias", "aten::_unsafe_view", "aten::set_", "aten::resize_",
    "aten::_local_scalar_dense", "aten::sym_size", "aten::sym_stride", "aten::sym_numel", "aten::_reshape_alias",
})
_MM = frozenset({"aten::mm", "aten::addmm"})
_BMM = frozenset({"aten::bmm", "aten::baddbmm"})


_VIEWS: dict = {}


def _is_view(func) -> bool:
    """Whether the op returns a view of an input (an alias it does not write)."""
    v = _VIEWS.get(func)
    if v is None:
        v = _VIEWS[func] = any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)
    return v


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out: list | None = None) -> list[torch.Tensor]:
    """The tensors of nested tuples, lists and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _flops(name: str, args: tuple) -> float:
    if name in _MM:
        a, b = (args[0], args[1]) if name == "aten::mm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in _BMM:
        a, b = (args[0], args[1]) if name == "aten::bmm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 0.0


@dataclass
class MetaCost:
    """What one traced step costs: the tree, the hand-written kernels' calls,
    and the device bytes live before the step (``baseline_bytes``) and at its
    peak (``peak_bytes``)."""

    tree: CallTree = field(default_factory=CallTree)
    kernel_calls: Counter = field(default_factory=Counter)
    baseline_bytes: int = 0
    peak_bytes: int = 0

    @property
    def temp_bytes(self) -> int:
        """The step's transient bytes at its peak, over the baseline."""
        return self.peak_bytes - self.baseline_bytes


class MetaTrace(TorchDispatchMode):
    """Within: the meta device's ops are costed into :attr:`cost` (see the
    module docstring). ``adopt(tree)`` counts tensors made before the trace
    in the baseline."""

    def __init__(self):
        super().__init__()
        self.cost = MetaCost()
        self._paths: dict = {}  # (scope stack, autograd node, forward head) -> the ops' path
        self._acc: dict = {}  # path -> metrics, moved into the tree by finish()
        self._live: dict[int, int] = {}  # storage -> bytes, while the storage lives
        self._bytes = 0
        self._stack: list[str] = []
        self._head = "loss"  # the scope the forward enters under fwd_bwd

    # -- memory -------------------------------------------------------------------

    def _free(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self._bytes -= nbytes

    def _hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage if it is new -> the bytes it added."""
        if t.device.type != "meta":
            return 0
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        nbytes = st.nbytes()
        self._live[key] = nbytes
        weakref.finalize(st, self._free, key, nbytes)
        self._bytes += nbytes
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._bytes)
        return nbytes

    def adopt(self, tree) -> None:
        """Count the tensors of ``tree`` (made before the trace) as live: the baseline."""
        for t in _tensors(tree):
            self._hold(t)
        self.cost.baseline_bytes = self._bytes

    # -- paths ----------------------------------------------------------------------

    @contextmanager
    def scope(self, name: str):
        if self._stack and self._stack[-1] == FWD_BWD and torch._C._current_autograd_node() is None:
            self._head = name
        self._stack.append(name)
        try:
            yield
        finally:
            self._stack.pop()

    def _path(self) -> tuple[str, ...]:
        node = torch._C._current_autograd_node()
        key = (tuple(self._stack), None if node is None else node.name(), self._head)
        path = self._paths.get(key)
        if path is None:
            stack, name, head = key
            if FWD_BWD not in stack:
                path = stack
            else:
                i = stack.index(FWD_BWD)
                rest = stack[i + 1:]
                if name is None:
                    path = stack[: i + 1] + ((f"jvp({rest[0]})", *rest[1:]) if rest else ())
                else:
                    path = stack[: i + 1] + (f"transpose(jvp({head}))", *rest, name)
            self._paths[key] = path
        return path

    def _add(self, path: tuple[str, ...], metrics: dict[str, float]) -> None:
        acc = self._acc.get(path)
        if acc is None:
            self._acc[path] = dict(metrics)
        else:
            for k, v in metrics.items():
                acc[k] = acc.get(k, 0.0) + v

    def finish(self) -> MetaCost:
        """Move the counted ops into the cost's tree -> the cost."""
        for path, metrics in self._acc.items():
            self.cost.tree.add_stack(list(path), metrics)
        self._acc.clear()
        return self.cost

    # -- ops ------------------------------------------------------------------------------

    def kernel(self, key: str, flops: float, nbytes: float) -> None:
        """One call of a hand-written kernel (from ``kernels/ops.py``'s meta path)."""
        self.cost.kernel_calls[key] += 1
        m = {"ops": 1.0, "kernels": 1.0, **({"flops": flops} if flops else {}), **({"bytes": nbytes} if nbytes else {})}
        self._add(self._path() + (KERNEL_PREFIX + key,), m)

    def collective(self, kind: str, nbytes: float) -> None:
        """One collective's bytes a rank sends (from a collective's meta path)."""
        self._add(self._path() + (kind,), {"coll_bytes": nbytes, f"coll_bytes::{kind}": nbytes})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        view = _is_view(func)
        out = func(*args, **kwargs)
        name = func._schema.name
        outs = _tensors(out)
        allocated = sum(self._hold(t) for t in outs)  # the storages this op made
        if view or name in _NO_KERNEL or not any(t.device.type == "meta" for t in ins + outs):
            return out
        in_bytes = [_nbytes(t) for t in ins]
        if name.endswith("_"):
            first = in_bytes[0] if in_bytes else 0
            written, read = first, sum(in_bytes) - (first if name in _WRITE_ONLY else 0)
        else:
            written, read = allocated, sum(in_bytes)
        m = {"ops": 1.0, "bytes": float(read + written)}
        flops = _flops(name, args)
        if flops:
            m["flops"] = flops
        self._add(self._path() + (name,), m)
        return out


def record_kernel(key: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's call on the meta device: counted by the tracer
    that traces now in this thread, if any."""
    active = _scope_mod.tracers()
    if active:
        active[-1].kernel(key, flops, nbytes)


def record_collective(kind: str, nbytes: float) -> None:
    """A collective on the meta device (``all-to-all``, ...): its bytes
    counted by the tracer that traces now in this thread, if any."""
    active = _scope_mod.tracers()
    if active:
        active[-1].collective(kind, nbytes)


@contextmanager
def tracing(state=None):
    """Within: one :class:`MetaTrace` costs the meta ops and the scope names
    (``core/scope.py``) key them. ``state``: the tensors that exist before the
    step (parameters, optimizer state, gradients, batch), its baseline.
    Yields the :class:`MetaCost`, complete when the block ends."""
    mode = MetaTrace()
    if state is not None:
        mode.adopt(state)
    _scope_mod.tracers().append(mode)
    try:
        with mode:
            yield mode.cost
    finally:
        _scope_mod.tracers().remove(mode)
        mode.finish()


__all__ = ["MetaCost", "MetaTrace", "record_collective", "record_kernel", "tracing"]
