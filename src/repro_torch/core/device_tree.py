"""Device-plane call tree of one profiled step (the counterpart of
``repro.core.hlo_tree``).

The JAX package costs the compiled HLO of a step by each instruction's
``op_name``, the path of ``jax.named_scope`` tags it was traced under. The
port has no compiled program to read; it runs one real step under
``torch.profiler`` (``record_shapes``, ``with_flops``, ``profile_memory``,
and CUDA activity on the card) and builds the same
:class:`~repro_torch.core.calltree.CallTree` from the profile, keyed by the
ranges that ``core/scope.py`` enters at the JAX package's scope sites, with
the JAX package's counter names, so ``core/planes.py`` and every view read
either tree:

* ``flops``  — matmul/conv FLOPs, the profiler's count for ``aten::mm``,
               ``addmm``, ``bmm``, ``baddbmm`` and the convolutions (the JAX
               tree's rule: dots and convolutions only);
* ``bytes``  — operand plus result bytes of every op that launches a kernel.
               The profiler records the inputs' shapes and dtypes; the result
               bytes are the memory the op allocated (``profile_memory``), or,
               for an op that writes in place (``add_``, ``copy_``), its first
               operand. An op is one aten call as the model code makes it
               (``aten::matmul``, ``aten::softmax``), counted once with what
               it calls inside; views (``view``, ``t``, ``transpose``,
               ``expand``, ``reshape`` without a copy) move nothing;
* ``coll_bytes`` — 0 on one card, not written;
* ``ops``    — the ops that launch a kernel, and the hand-written kernels'
               launches.

On the card each node also carries ``device_ms`` and ``kernels``: the device
time and number of the kernels (and copies) that the ops under the path
launched, each kernel counted once, where it was launched (a range's
``device_time_total`` already holds its children's kernels, so summing
ranges would count them twice). A kernel is placed at the runtime call that
launched it (``cudaLaunchKernel``, ``cuLaunchKernelEx``: the profiler records
it as a host event on the launching thread, with the kernel's correlation
id), else at the op the profiler linked it to, each device event once (the
profiler lists a kernel at every host event that shares its op's
correlation id). The profiler links a kernel only to ops, never to
``record_function`` ranges, so without the runtime call a hand-written
kernel's launch (no op) lands on the enclosing autograd node. Kernels
placed nowhere go to ``<unattributed>``, so the root holds every kernel of
the step. On the CPU these two keys are
absent.

**Paths.** A forward op's path is its chain of named ranges, root first; the
op's name is the leaf. Under ``fwd_bwd`` the differentiated scope is renamed
as the JAX tree names it: ``jvp(loss)`` for the forward.

**The backward.** The autograd engine runs the backward outside the forward's
ranges (on the card, on its own thread). Each backward node's
``autograd::engine::evaluate_function`` event carries the ``sequence_nr`` of
the forward op that made the node and ``fwd_thread``, its thread; the node's
ops take that forward op's path with the differentiated scope renamed
``transpose(jvp(loss))``, as the JAX tree's transposed ops sit under their
forward component. A node without a forward op (``AccumulateGrad``) takes
the path of the node evaluated before it on its thread: the gradient it
accumulates came from there. Ranges entered inside a node (a kernel
wrapper's backward, a checkpoint's recompute) continue that path where their
first range already stands in it. A checkpoint's recompute (ops that record
autograd inside a backward node) goes under ``checkpoint/rematted_computation``,
as the JAX tree's remat does, and the forward drops the ``checkpoint`` level,
as JAX's does: so the recompute counts in the backward branch, not the
forward. A checkpoint stops its recompute early, inside the op that saves
its last tensor: the profiler records that op, which never ran, and the tree
leaves it out (``_stopped``).

**Hand-written kernels.** A kernel wrapper marks each launch with
``scope.kernel_launch``: the range becomes the leaf ``kernel:<key>`` with the
kernel's own count of flops and bytes (``ops.flash_work`` and its siblings).
On the CPU the wrappers run their plain versions, whose aten ops are counted
as any others.

**Imports.** torch is imported inside the functions that build a tree, so
that :func:`load_device_tree` and :func:`save_device_tree` cost none: the
profiling daemon loads this artifact in a process that must map neither
torch nor CUDA.
"""

from __future__ import annotations

import json
import os
from collections import Counter, defaultdict
from collections.abc import Callable, Iterator
from contextlib import contextmanager
from typing import Any

from .calltree import CallNode, CallTree

DEVICE_TREE_SCHEMA = "repro-device-tree/v1"

FWD_BWD = "fwd_bwd"
CHECKPOINT = "checkpoint"
REMATTED = "rematted_computation"
UNATTRIBUTED = "<unattributed>"
_EVALUATE = "autograd::engine::evaluate_function:"

# Ops whose profiler FLOPs count: dots and convolutions, the JAX tree's rule.
_FLOP_OPS = frozenset({
    "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
    "aten::conv1d", "aten::conv2d", "aten::conv3d", "aten::convolution", "aten::_convolution",
})

# Ops that launch no kernel themselves: views, allocations, metadata, and
# composites that only dispatch to other ops (an op launches iff something
# in its subtree is not in this set).
_NO_KERNEL = frozenset("aten::" + n for n in (
    "view", "_unsafe_view", "as_strided", "t", "transpose", "permute", "expand", "expand_as", "reshape",
    "_reshape_alias", "view_as", "unsqueeze", "squeeze", "select", "slice", "narrow", "split",
    "split_with_sizes", "chunk", "unbind", "detach", "alias", "diagonal", "unflatten", "flatten", "movedim",
    "moveaxis", "swapaxes", "unfold", "resolve_conj", "resolve_neg", "lift_fresh", "real", "_neg_view",
    "_conj", "numpy_T", "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "to",
    "type_as", "contiguous", "result_type", "matmul", "linear", "einsum", "size", "stride", "dim",
    "is_nonzero", "_has_compatible_shallow_copy_type", "set_", "_to_copy_alias",
))

# In-place ops that write their first operand without reading it.
_WRITE_ONLY = frozenset({"aten::copy_", "aten::fill_", "aten::zero_", "aten::normal_", "aten::uniform_"})

_DTYPE_BYTES = {
    "float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2, "long int": 8, "int": 4, "short int": 2,
    "signed char": 1, "unsigned char": 1, "bool": 1, "c10::complex<float>": 8, "c10::complex<double>": 16,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
}


def _is_range(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False))


def _is_aten(e) -> bool:
    return e.name.startswith("aten::")


def _children(e) -> list:
    return sorted(e.cpu_children, key=lambda c: c.time_range.start)


def _subtree(e):
    yield e
    for c in e.cpu_children:
        yield from _subtree(c)


def _tensor_bytes(shape, dtype: str) -> float:
    size = _DTYPE_BYTES.get(dtype)
    if size is None or not isinstance(shape, (list, tuple)):
        return 0.0
    n = 1
    for d in shape:
        if not isinstance(d, int):
            return 0.0
        n *= d
    return float(n * size)


def _input_dtypes(prof, cpu: list) -> dict[int, list]:
    """id(event) -> the dtypes of its inputs: ``FunctionEvent.input_dtypes``
    where the torch has it, else the profiler's raw events' (matched by
    correlation id)."""
    if cpu and getattr(cpu[0], "input_dtypes", None) is not None:
        return {id(e): list(e.input_dtypes or []) for e in cpu}
    raw = {}
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    for k in (results.events() if results is not None else ()):
        raw[k.correlation_id()] = list(k.dtypes())
    return {id(e): raw.get(e.id, []) for e in cpu}


def _op_bytes(e, dtypes: list) -> float:
    """Operand bytes read plus result bytes written by the outermost op ``e``."""
    shapes = list(e.input_shapes or [])
    inputs = [_tensor_bytes(s, d) for s, d in zip(shapes, dtypes)]
    allocated = max(float(e.cpu_memory_usage or 0) + float(e.device_memory_usage or 0), 0.0)
    first = next((b for b in inputs if b), 0.0)
    if e.name.endswith("_"):
        written = first
        read = sum(inputs) - (first if e.name in _WRITE_ONLY else 0.0)
    else:
        written, read = allocated, sum(inputs)
    if "TensorList" in dtypes and not read:  # cat / stack: the list's bytes are not recorded; read what is written
        read = written
    return read + written


def _op_flops(e) -> float:
    if e.name in _FLOP_OPS and e.flops:
        return float(e.flops)
    return sum(_op_flops(c) for c in e.cpu_children)


def _stopped(e) -> bool:
    """Whether a recomputed op was stopped before it ran: a checkpoint's
    recompute stops early, raising in the autograd kernel of the op that
    saves its last tensor, after the profiler opened the op's event (with the
    flops its shapes give) and before the op computed. It launched nothing
    and, though it writes no operand in place, allocated no result."""
    return not e.name.endswith("_") and not ((e.cpu_memory_usage or 0) + (e.device_memory_usage or 0))


def _launches(e) -> bool:
    return any(_is_aten(x) and x.name not in _NO_KERNEL for x in _subtree(e))


def _duration(e) -> float:
    """A device event's us, as the profiler reckons a kernel linked to an op."""
    return e.time_range.end - e.time_range.start


def _is_runtime_call(e) -> bool:
    """A CUDA API call (``cudaLaunchKernel``, ``cuLaunchKernelEx``)."""
    return e.name.startswith("cu") and not _is_range(e)


class _Kernels:
    """The device events of a profile, each counted once, at the host event
    that launched it (see the module docstring). Device-side spans of ranges
    share their range's name and are left out."""

    def __init__(self, events: list, cpu: list, range_names: set[str]):
        from torch.autograd import DeviceType

        from .scope import KERNEL_PREFIX

        device = [e for e in events if e.device_type == DeviceType.CUDA and not _is_range(e)
                  and e.name not in range_names and not e.name.startswith(KERNEL_PREFIX)]
        self.total_us = sum(_duration(e) for e in device)
        self.total_n = len(device)
        self.seen_us = 0.0
        self.seen_n = 0
        self.on = bool(device)
        # kernels placed at their runtime call; the rest are left for the op-linked lists
        by_id = defaultdict(list)
        for k in device:
            by_id[k.id].append(k)
        self.placed: dict[int, list] = {}
        for e in cpu:
            if _is_runtime_call(e) and e.id in by_id:
                self.placed[id(e)] = by_id.pop(e.id)
        self.free = Counter((k.name, _duration(k)) for ks in by_id.values() for k in ks)

    def own(self, e) -> tuple[float, int]:
        """(us, count) of the kernels ``e`` itself launched."""
        placed = self.placed.pop(id(e), ())
        us, n = float(sum(_duration(k) for k in placed)), len(placed)
        for k in getattr(e, "kernels", ()):
            key = (k.name, k.duration)
            if self.free[key] > 0:  # else a range's span, a kernel placed elsewhere, or one listed twice
                self.free[key] -= 1
                us += k.duration
                n += 1
        self.seen_us += us
        self.seen_n += n
        return us, n

    def under(self, e) -> tuple[float, int]:
        us, n = 0.0, 0
        for x in _subtree(e):
            a, b = self.own(x)
            us += a
            n += b
        return us, n


def _rename(path: list[str], head: Callable[[str], str], *, drop_checkpoint: bool) -> list[str]:
    names = [n for n in path if not (drop_checkpoint and n == CHECKPOINT)]
    if FWD_BWD in names:
        i = len(names) - 1 - names[::-1].index(FWD_BWD)
        if i + 1 < len(names):
            names[i + 1] = head(names[i + 1])
    elif not drop_checkpoint and names:
        names[0] = head(names[0])
    return names


def _forward_path(chain: list[str]) -> list[str]:
    return _rename(chain, lambda s: f"jvp({s})", drop_checkpoint=True)


def _backward_path(anchor: list[str] | None, rel: list[str], recompute: bool) -> list[str]:
    if anchor is None:
        return [UNATTRIBUTED, *([REMATTED] if recompute else []), *rel]
    base = list(anchor)
    if rel:
        if recompute and CHECKPOINT in base:
            base = base[: len(base) - base[::-1].index(CHECKPOINT)]
        elif rel[0] in base:
            base = base[: len(base) - 1 - base[::-1].index(rel[0])]
    base = _rename(base, lambda s: f"transpose(jvp({s}))", drop_checkpoint=False)
    return base + ([REMATTED] if recompute else []) + rel


def _records_autograd(e) -> bool:
    return any(_is_aten(x) and x.sequence_nr >= 0 for x in _subtree(e))


def build_device_tree(prof) -> CallTree:
    """The device-plane tree of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    from .scope import KERNEL_PREFIX, parse_kernel_launch

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    range_names = {e.name for e in cpu if _is_range(e)}
    kernels = _Kernels(events, cpu, range_names)
    dtypes = _input_dtypes(prof, cpu)
    roots = sorted((e for e in cpu if e.cpu_parent is None), key=lambda e: e.time_range.start)

    # Pass 1: each forward op's chain of ranges, by (thread, sequence_nr);
    # where several events share a number, the last is the one that made the node.
    anchors: dict[tuple[int, int], list[str]] = {}

    def index(e, chain: list[str], in_bwd: bool) -> None:
        if e.name.startswith(_EVALUATE):
            in_bwd = True
        elif _is_range(e):
            chain = chain + [e.name]
        elif not in_bwd and e.sequence_nr >= 0:
            anchors[(e.thread, e.sequence_nr)] = chain
        for c in _children(e):
            index(c, chain, in_bwd)

    for r in roots:
        index(r, [], False)

    tree = CallTree()
    last_anchor: dict[int, list[str]] = {}

    def add(path: list[str], metrics: dict[str, float]) -> None:
        if metrics:
            tree.add_stack(path, metrics)

    def device_metrics(us: float, n: int) -> dict[str, float]:
        return {"device_ms": us / 1e3, "kernels": float(n)} if n else {}

    def visit(e, chain: list[str], bwd: tuple | None) -> None:
        here = _forward_path(chain) if bwd is None else _backward_path(*bwd)
        if _is_range(e):
            launch = parse_kernel_launch(e.name)
            if launch is not None:
                key, flops, nbytes = launch
                m = {"ops": 1.0, **({"flops": flops} if flops else {}), **({"bytes": nbytes} if nbytes else {})}
                add(here + [KERNEL_PREFIX + key], {**m, **device_metrics(*kernels.under(e))})
                return
            if bwd is None:
                chain = chain + [e.name]
            else:
                anchor, rel, recompute = bwd
                bwd = (anchor, rel + [e.name], recompute or (not rel and _records_autograd(e)))
            here = _forward_path(chain) if bwd is None else _backward_path(*bwd)
            add(here, device_metrics(*kernels.own(e)))
        elif e.name.startswith(_EVALUATE):
            anchor = anchors.get((e.fwd_thread, e.sequence_nr)) if e.sequence_nr >= 0 else None
            if anchor is None:
                anchor = last_anchor.get(e.thread)
            else:
                last_anchor[e.thread] = anchor
            bwd = (anchor, [], False)
            add(_backward_path(*bwd) + [e.name.removeprefix(_EVALUATE).strip()], device_metrics(*kernels.own(e)))
        elif _is_aten(e):
            if "TensorList" in dtypes.get(id(e), ()) and any(_is_aten(c) for c in e.cpu_children):
                for c in _children(e):  # a foreach op: its per-tensor ops carry the shapes
                    visit(c, chain, bwd)
                add(here + [e.name], device_metrics(*kernels.own(e)))
                return
            us, n = kernels.under(e)
            if not (n or _launches(e)) or (bwd is not None and bwd[2] and not n and _stopped(e)):
                return
            flops, nbytes = _op_flops(e), _op_bytes(e, dtypes.get(id(e), []))
            m = {"ops": 1.0, **({"flops": flops} if flops else {}), **({"bytes": nbytes} if nbytes else {})}
            add(here + [e.name], {**m, **device_metrics(us, n)})
            return
        else:
            add(here + [e.name], device_metrics(*kernels.own(e)))
        for c in _children(e):
            visit(c, chain, bwd)

    for r in roots:
        visit(r, [], None)
    if kernels.on and kernels.total_us - kernels.seen_us > 1e-6:
        add([UNATTRIBUTED], device_metrics(kernels.total_us - kernels.seen_us, max(kernels.total_n - kernels.seen_n, 1)))
    return tree


@contextmanager
def profiling(device: str | torch.device) -> Iterator:
    """Within: ``torch.profiler`` records what :func:`build_device_tree`
    reads (shapes, flops, memory; on a CUDA device the card's kernels, the
    block entered and left synchronised). Yields the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities, record_shapes=True, with_flops=True, profile_memory=True) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


def tree_from_profile(fn: Callable[[], Any], *, device: str | torch.device) -> tuple[Any, CallTree]:
    """Run ``fn()`` once under :func:`profiling` -> (its result, the device
    tree of that run): the counterpart of the JAX package's
    ``tree_from_compiled``, which costs the step without running it."""
    with profiling(device) as prof:
        out = fn()
    return out, build_device_tree(prof)


def save_device_tree(tree: CallTree, path: str, *, meta: dict | None = None) -> None:
    """Persist a device-plane tree as a versioned ``device_tree.json``, in the
    JAX package's schema, so one reader takes both packages' files. The
    write is atomic (tmp + rename): readers discover the file lazily beside
    a profile that is still being written."""
    doc: dict = {"schema": DEVICE_TREE_SCHEMA, "root": tree.root.to_dict()}
    if meta:
        doc["meta"] = dict(meta)
    tmp = f"{path}.tmp.{id(doc)}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def load_device_tree(path: str) -> CallTree:
    """Load a ``device_tree.json`` (versioned envelope or legacy bare root)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a device tree artifact")
    if "schema" in doc:
        if doc["schema"] != DEVICE_TREE_SCHEMA:
            raise ValueError(f"{path}: unsupported device tree schema {doc['schema']!r}")
        root = doc.get("root")
    else:  # legacy: a bare CallTree.to_json() dump
        root = doc
    if not isinstance(root, dict) or "name" not in root:
        raise ValueError(f"{path}: device tree artifact has no root node")
    return CallTree(CallNode.from_dict(root))
