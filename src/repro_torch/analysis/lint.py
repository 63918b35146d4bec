"""repro-lint: pluggable AST passes encoding the repo's hard-won invariants;
a copy of ``repro.analysis.lint`` for the port's tree.

Each pass checks one contract that an earlier PR established by measurement
and that ordinary tests cannot cheaply guard (the violation compiles, runs,
and only shows up as a regression in a benchmark or a subtly wrong
profile).  The passes are pure ``ast`` — no imports of the checked code, no
third-party linters — so CI runs them on a bare stdlib interpreter.

Passes (id — contract):

* ``agent-hot-path`` — the target-side per-sample path (``Agent.tick`` /
  ``Agent._raw_stack``) stays free of blocking/hashing/serialization calls;
  the target pays only for frame capture (the non-intrusiveness budget).
* ``wire-slots`` — every ``@dataclass`` wire record carries ``slots``
  (decoder allocates one per record at MHz rates; a ``__dict__`` per record
  once regressed ingest).
* ``numpy-module-scope`` — ``wire``/``ingest``/``pipeline``/``agent``
  import without touching numpy (the lazy ``_numpy()`` contract keeps
  ``profilerd attach`` at milliseconds).
* ``lock-io`` — no blocking I/O while holding the ``SharedProfileState``
  lock (it guards attribute swaps only; a handler stalled under it would
  stall the daemon's publish path).
* ``lock-order`` — nested lock acquisitions across the daemon/server/
  aggregator threads must agree on one global order (static inversion
  detection over ``with <lock>`` nesting).
* ``event-kinds`` — every literally-emitted event ``kind`` is registered in
  the canonical table (:mod:`repro_torch.profilerd.events`); an unregistered
  kind is invisible to the scoreboard's detector mapping.
* ``scope-coverage`` — every hand-written kernel counted by
  ``kernel_launch("<key>", ...)`` in ``kernels/ops.py`` has a public wrapper
  of that name that opens a ``scope(...)`` range, and model forwards that
  accept a ``scope`` parameter open one (``scope``/``_scope``) or forward
  ``scope=scope``; a missing range silently breaks the device plane's
  (``core/device_tree.py``) host<->device name matching.

The first six passes are the JAX package's, unchanged: their paths and
invariants hold in the port as written.  ``scope-coverage`` keeps its
invariant but reads the port's idiom: ``repro_torch.core.scope.scope``
(a ``record_function`` range) in place of ``jax.named_scope``, and the kernel
wrappers picked by what they launch, not by being public (``ops.py`` also
exports helpers that launch nothing).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from collections.abc import Callable, Iterator


@dataclass(frozen=True)
class Finding:
    """One invariant violation at one site."""

    pass_id: str
    path: str  # index-relative, "/"-separated
    line: int
    symbol: str  # the def/class/kind the finding is about
    message: str

    def key(self) -> str:
        """Baseline identity: stable across line-number churn."""
        return f"{self.pass_id}:{self.path}:{self.symbol}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_id}] {self.symbol}: {self.message}"


@dataclass
class LintPass:
    id: str
    description: str
    run: Callable[["RepoIndex"], list[Finding]]


class RepoIndex:
    """Parsed ASTs of every ``.py`` under a root, keyed by relative path."""

    def __init__(self, root: str, files: dict[str, ast.Module]):
        self.root = root
        self.files = files

    @classmethod
    def load(cls, root: str) -> "RepoIndex":
        files: dict[str, ast.Module] = {}
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__" and not d.startswith("."))
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root).replace(os.sep, "/")
                with open(full, encoding="utf-8") as f:
                    src = f.read()
                try:
                    files[rel] = ast.parse(src)
                except SyntaxError as exc:
                    raise SyntaxError(f"{full}: {exc}") from exc
        return cls(root, files)

    def matching(self, suffix: str) -> list[tuple[str, ast.Module]]:
        return [(p, t) for p, t in sorted(self.files.items()) if p.endswith(suffix)]


# -- shared AST helpers ------------------------------------------------------


def call_name(node: ast.Call) -> str | None:
    """Bare callee name or last attribute segment (``self.x.f()`` -> ``f``)."""
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def iter_calls(node: ast.AST, *, into_defs: bool = True) -> Iterator[ast.Call]:
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if not into_defs and isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


def _top_level_functions(tree: ast.Module) -> Iterator[ast.FunctionDef]:
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _classes(tree: ast.Module) -> Iterator[ast.ClassDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            yield node


def _methods(cls: ast.ClassDef) -> dict[str, ast.FunctionDef]:
    return {
        n.name: n for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


# -- pass: agent-hot-path ----------------------------------------------------

# Call names that allocate, hash, serialize, or block.  The per-sample path
# is allowed exactly: frame walking, list append/reverse, monotonic clocks,
# the wire encoder, and the (non-blocking) spool write.
HOT_PATH_BANNED = frozenset(
    {
        # blocking / syscalls
        "open", "print", "connect", "recv", "send", "sendall", "accept",
        "select", "sleep", "join", "fsync", "urlopen", "wait_for",
        # hashing
        "md5", "sha1", "sha256", "sha512", "blake2b", "blake2s", "crc32",
        # (de)serialization — per-sample JSON/pickle is the classic regression
        "dumps", "loads", "dump", "load", "deepcopy",
        # filesystem
        "makedirs", "listdir", "stat", "remove", "unlink", "replace",
    }
)

HOT_PATH_FUNCTIONS = ("tick", "_raw_stack")


def _run_agent_hot_path(index: RepoIndex) -> list[Finding]:
    out: list[Finding] = []
    for path, tree in index.matching("profilerd/agent.py"):
        for cls in _classes(tree):
            if cls.name != "Agent":
                continue
            methods = _methods(cls)
            for name in HOT_PATH_FUNCTIONS:
                fn = methods.get(name)
                if fn is None:
                    continue
                for call in iter_calls(fn):
                    cn = call_name(call)
                    if cn in HOT_PATH_BANNED:
                        out.append(
                            Finding(
                                "agent-hot-path", path, call.lineno, f"Agent.{name}:{cn}",
                                f"banned call {cn}() in the per-sample path — the target pays "
                                "for every tick; keep capture allocation/hash/block free",
                            )
                        )
    return out


# -- pass: wire-slots --------------------------------------------------------


def _dataclass_decorator(cls: ast.ClassDef) -> ast.expr | None:
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = target.attr if isinstance(target, ast.Attribute) else getattr(target, "id", None)
        if name == "dataclass":
            return dec
    return None


def _has_slots(cls: ast.ClassDef, dec: ast.expr) -> bool:
    if isinstance(dec, ast.Call):
        for kw in dec.keywords:
            if kw.arg == "slots" and isinstance(kw.value, ast.Constant) and kw.value.value is True:
                return True
    for node in cls.body:
        targets = node.targets if isinstance(node, ast.Assign) else []
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "__slots__":
                return True
    return False


def _run_wire_slots(index: RepoIndex) -> list[Finding]:
    out: list[Finding] = []
    for path, tree in index.matching("profilerd/wire.py"):
        for cls in _classes(tree):
            dec = _dataclass_decorator(cls)
            if dec is None:
                continue
            if not _has_slots(cls, dec):
                out.append(
                    Finding(
                        "wire-slots", path, cls.lineno, cls.name,
                        "wire record dataclass without slots=True — decoder allocates one per "
                        "record; __dict__ per record regresses batch ingest",
                    )
                )
    return out


# -- pass: numpy-module-scope ------------------------------------------------

NUMPY_OPTIONAL_MODULES = (
    "profilerd/wire.py",
    "profilerd/ingest.py",
    "profilerd/pipeline.py",
    "profilerd/agent.py",
)


def _module_scope_nodes(tree: ast.Module) -> Iterator[ast.stmt]:
    """Statements executed at import time: module body, descending into
    module-level If/Try/With — but not into function or class bodies, and
    not into ``if TYPE_CHECKING:`` blocks (those never execute)."""
    stack: list[ast.stmt] = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(node, ast.If):
            test = node.test
            tname = test.attr if isinstance(test, ast.Attribute) else getattr(test, "id", None)
            if tname == "TYPE_CHECKING":
                stack.extend(node.orelse)
                continue
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                stack.append(child)


def _run_numpy_module_scope(index: RepoIndex) -> list[Finding]:
    out: list[Finding] = []
    for suffix in NUMPY_OPTIONAL_MODULES:
        for path, tree in index.matching(suffix):
            for node in _module_scope_nodes(tree):
                bad = None
                if isinstance(node, ast.Import):
                    bad = next((a.name for a in node.names if a.name.split(".")[0] == "numpy"), None)
                elif isinstance(node, ast.ImportFrom):
                    if node.module and node.module.split(".")[0] == "numpy":
                        bad = node.module
                if bad:
                    out.append(
                        Finding(
                            "numpy-module-scope", path, node.lineno, bad,
                            "module-scope numpy import in a numpy-optional module — use the "
                            "lazy _numpy() probe; attach must import in milliseconds without numpy",
                        )
                    )
    return out


# -- pass: lock-io -----------------------------------------------------------

LOCK_IO_BANNED = frozenset(
    {
        "open", "read", "write", "recv", "send", "sendall", "sleep", "urlopen",
        "dump", "dumps", "load", "loads", "fsync", "flush", "connect",
        "makedirs", "listdir", "stat", "remove", "unlink", "replace", "wait",
    }
)


def _lock_withs(fn: ast.AST) -> Iterator[tuple[str, ast.With]]:
    """Yield (lock attribute name, with-node) for each ``with <..lock..>:``."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call):
                expr = expr.func
            name = expr.attr if isinstance(expr, ast.Attribute) else getattr(expr, "id", None)
            if name and "lock" in name.lower():
                yield name, node


def _run_lock_io(index: RepoIndex) -> list[Finding]:
    out: list[Finding] = []
    for path, tree in index.matching("profilerd/server.py"):
        for cls in _classes(tree):
            if cls.name != "SharedProfileState":
                continue
            for fn in _methods(cls).values():
                for _lock, w in _lock_withs(fn):
                    for stmt in w.body:
                        for call in iter_calls(stmt):
                            cn = call_name(call)
                            if cn in LOCK_IO_BANNED:
                                out.append(
                                    Finding(
                                        "lock-io", path, call.lineno,
                                        f"SharedProfileState.{fn.name}:{cn}",
                                        f"blocking call {cn}() while holding the publish lock — "
                                        "it guards attribute swaps only",
                                    )
                                )
    return out


# -- pass: lock-order --------------------------------------------------------

LOCK_ORDER_MODULES = (
    "profilerd/daemon.py",
    "profilerd/server.py",
    "profilerd/aggregator.py",
    "profilerd/sources.py",
)


def _nested_lock_pairs(tree: ast.Module, path: str) -> Iterator[tuple[str, str, int]]:
    """Yield (outer, inner, line) for every lexically nested acquisition.

    Lock identity is ``<Class>.<attr>`` (or ``<module>.<name>`` at module
    scope) so two classes' unrelated ``self._lock`` attributes don't alias.
    """
    mod = os.path.basename(path)[: -len(".py")]

    def visit(node: ast.AST, owner: str, held: tuple[str, ...]) -> Iterator[tuple[str, str, int]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from visit(child, child.name, held)
                continue
            now = held
            if isinstance(child, ast.With):
                acquired = []
                for item in child.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call):
                        expr = expr.func
                    if isinstance(expr, ast.Attribute) and "lock" in expr.attr.lower():
                        base = expr.value
                        scope = owner
                        # self.agg._lock names the *other* object's lock
                        if isinstance(base, ast.Attribute):
                            scope = base.attr
                        acquired.append(f"{scope}.{expr.attr}")
                    elif isinstance(expr, ast.Name) and "lock" in expr.id.lower():
                        acquired.append(f"{mod}.{expr.id}")
                for name in acquired:
                    for outer in now:
                        if outer != name:
                            yield outer, name, child.lineno
                    now = now + (name,)
            yield from visit(child, owner, now)

    yield from visit(tree, mod, ())


def _run_lock_order(index: RepoIndex) -> list[Finding]:
    pairs: dict[tuple[str, str], tuple[str, int]] = {}
    for suffix in LOCK_ORDER_MODULES:
        for path, tree in index.matching(suffix):
            for outer, inner, line in _nested_lock_pairs(tree, path):
                pairs.setdefault((outer, inner), (path, line))
    out: list[Finding] = []
    for (a, b), (path, line) in sorted(pairs.items()):
        if a < b and (b, a) in pairs:
            other_path, other_line = pairs[(b, a)]
            out.append(
                Finding(
                    "lock-order", path, line, f"{a}<->{b}",
                    f"lock order inversion: {a} -> {b} here but {b} -> {a} at "
                    f"{other_path}:{other_line} — pick one global order or deadlock",
                )
            )
    return out


# -- pass: event-kinds -------------------------------------------------------

EVENT_SCAN_PREFIXES = ("profilerd/", "faults/", "launch/")
EVENT_SCAN_SUFFIXES = ("core/detector.py",)
EVENTS_TABLE = "profilerd/events.py"


def _emitted_kinds(tree: ast.Module) -> Iterator[tuple[str, int]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values, strict=True):
                if (
                    isinstance(k, ast.Constant) and k.value == "kind"
                    and isinstance(v, ast.Constant) and isinstance(v.value, str)
                ):
                    yield v.value, v.lineno
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "kind" and isinstance(kw.value, ast.Constant) and isinstance(kw.value.value, str):
                    yield kw.value.value, kw.value.lineno
        elif isinstance(node, ast.AnnAssign):
            if (
                isinstance(node.target, ast.Name) and node.target.id == "kind"
                and isinstance(node.value, ast.Constant) and isinstance(node.value.value, str)
            ):
                yield node.value.value, node.lineno


def _registered_kinds(index: RepoIndex) -> frozenset[str] | None:
    tables = index.matching(EVENTS_TABLE)
    if not tables:
        return None
    kinds: set[str] = set()
    for _path, tree in tables:
        for node in tree.body:
            if isinstance(node, ast.Assign):
                value = node.value
                if isinstance(value, ast.Constant) and isinstance(value.value, str):
                    kinds.add(value.value)
                elif isinstance(value, (ast.Tuple, ast.List, ast.Set)):
                    for elt in value.elts:
                        if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                            kinds.add(elt.value)
                elif isinstance(value, ast.Call):
                    for arg in value.args:
                        if isinstance(arg, (ast.Tuple, ast.List, ast.Set)):
                            for elt in arg.elts:
                                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                                    kinds.add(elt.value)
    return frozenset(kinds)


def _run_event_kinds(index: RepoIndex) -> list[Finding]:
    registered = _registered_kinds(index)
    out: list[Finding] = []
    for path, tree in sorted(index.files.items()):
        if path.endswith(EVENTS_TABLE):
            continue
        if not (path.startswith(EVENT_SCAN_PREFIXES) or path.endswith(EVENT_SCAN_SUFFIXES)):
            continue
        seen: set[str] = set()
        for kind, line in _emitted_kinds(tree):
            if kind in seen:
                continue
            seen.add(kind)
            if registered is None:
                out.append(
                    Finding(
                        "event-kinds", path, line, kind,
                        "event kind emitted but no canonical table (profilerd/events.py) exists",
                    )
                )
            elif kind not in registered:
                out.append(
                    Finding(
                        "event-kinds", path, line, kind,
                        f"event kind {kind!r} not registered in repro_torch.profilerd.events — "
                        "unregistered kinds are invisible to the scoreboard mapping",
                    )
                )
    return out


# -- pass: scope-coverage ----------------------------------------------------

# The port's range openers: ``repro_torch.core.scope.scope``, imported as
# ``_scope`` where a forward's parameter is named ``scope``.
SCOPE_CALLS = frozenset({"scope", "_scope"})


def _opens_scope(fn: ast.AST) -> bool:
    return any(call_name(call) in SCOPE_CALLS for call in iter_calls(fn))


def _forwards_scope(fn: ast.AST) -> bool:
    """A pure delegation like ``slstm_step`` forwarding ``scope=scope`` to a
    covered callee counts as coverage — the callee opens the range."""
    for call in iter_calls(fn):
        if call_name(call) in SCOPE_CALLS:
            continue
        for kw in call.keywords:
            if kw.arg == "scope" and isinstance(kw.value, ast.Name) and kw.value.id == "scope":
                return True
    return False


def _launched_keys(tree: ast.Module) -> dict[str, int]:
    """key -> first line, for every ``kernel_launch("<key>", ...)``."""
    keys: dict[str, int] = {}
    for call in iter_calls(tree):
        if call_name(call) != "kernel_launch" or not call.args:
            continue
        arg = call.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            keys[arg.value] = min(call.lineno, keys.get(arg.value, call.lineno))
    return keys


def _run_scope_coverage(index: RepoIndex) -> list[Finding]:
    out: list[Finding] = []
    for path, tree in index.matching("kernels/ops.py"):
        wrappers = {fn.name: fn for fn in _top_level_functions(tree) if not fn.name.startswith("_")}
        for key, line in sorted(_launched_keys(tree).items()):
            fn = wrappers.get(key)
            if fn is None:
                out.append(
                    Finding(
                        "scope-coverage", path, line, key,
                        f"kernel {key!r} is launched but ops.py has no public wrapper of that name — "
                        "no record_function range names its call site for core/device_tree.py",
                    )
                )
            elif not _opens_scope(fn):
                out.append(
                    Finding(
                        "scope-coverage", path, fn.lineno, key,
                        "kernel wrapper without a scope(...) range — the device plane "
                        "(core/device_tree.py) loses this op's call path and name-matching goes dark",
                    )
                )
    for path, tree in sorted(index.files.items()):
        if "models/" not in path or path.endswith("__init__.py"):
            continue
        for fn in _top_level_functions(tree):
            params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
            if "scope" not in params:
                continue
            if not _opens_scope(fn) and not _forwards_scope(fn):
                out.append(
                    Finding(
                        "scope-coverage", path, fn.lineno, fn.name,
                        "forward accepts scope= but never opens _scope(scope) — the profiled "
                        "step loses the record_function range core/device_tree.py matches on",
                    )
                )
    return out


# -- registry ----------------------------------------------------------------

PASSES: tuple[LintPass, ...] = (
    LintPass("agent-hot-path", "per-sample path free of alloc/hash/blocking calls", _run_agent_hot_path),
    LintPass("wire-slots", "wire record dataclasses carry __slots__", _run_wire_slots),
    LintPass("numpy-module-scope", "numpy-optional modules never import numpy at module scope", _run_numpy_module_scope),
    LintPass("lock-io", "no blocking I/O under the SharedProfileState lock", _run_lock_io),
    LintPass("lock-order", "one global lock-acquisition order across daemon threads", _run_lock_order),
    LintPass("event-kinds", "every emitted event kind registered in the canonical table", _run_event_kinds),
    LintPass("scope-coverage", "kernel wrappers and scoped forwards open a scope(...) range", _run_scope_coverage),
)

PASS_IDS = tuple(p.id for p in PASSES)


def run_passes(
    index: RepoIndex, *, only: str | None = None
) -> list[Finding]:
    """Run all (or one) passes; findings sorted for stable baselines."""
    if only is not None and only not in PASS_IDS:
        raise ValueError(f"unknown pass {only!r} (expected one of {', '.join(PASS_IDS)})")
    out: list[Finding] = []
    for p in PASSES:
        if only is not None and p.id != only:
            continue
        out.extend(p.run(index))
    return sorted(out, key=lambda f: (f.pass_id, f.path, f.line, f.symbol))


__all__ = [
    "Finding",
    "HOT_PATH_BANNED",
    "LOCK_IO_BANNED",
    "LintPass",
    "NUMPY_OPTIONAL_MODULES",
    "PASSES",
    "PASS_IDS",
    "RepoIndex",
    "run_passes",
]
