"""AST-based static call-graph extractor — the profile's static dual; a
copy of ``repro.analysis.extract`` that extracts ``repro_torch`` by default.

The sampled planes answer "where did time go"; this module answers "what
code exists to go to".  It parses every module under a package root (no
imports, pure ``ast``) and folds the result into an ordinary
:class:`~repro_torch.core.calltree.CallTree` so the whole existing toolchain —
snapshot codec, exports, ``/tree`` query plane, ``top`` — works on the
static plane with zero special cases.

Tree shape (root -> leaf)::

    <root>
      mod::repro_torch.profilerd.agent  defs = #defs in module
        cls::Agent
          repro::tick                   defs = 1, self defs = 1
            repro::_raw_stack           calls = #call sites tick -> _raw_stack

* ``mod::`` / ``cls::`` frames carry the containment hierarchy (they are
  origin-prefixed so plane name-matching strips them like ``thread::``).
* Function defs are named ``repro::<name>`` — exactly the symbol the
  resolver mints for a sampled frame in the port's code
  (``repro_torch.core.sampler.classify_frame``) — so a flatten-view
  cross-join against a dynamic profile lines up name-for-name
  (:mod:`repro_torch.analysis.coverage`).
* A call edge resolved to a repo def appears as a child of the caller with
  the ``calls`` metric; unresolved (external/stdlib) call sites are counted
  on the caller via ``ext_calls``.

Resolution is deliberately coarse (last-attribute-segment, repo-wide name
set): it is a reachability map for coverage analysis, not a type-checked
call graph, and it must stay pure stdlib so CI can run it without torch.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from collections.abc import Iterator

from repro_torch.core.calltree import CallTree

from .static_tree import STATIC_TREE_SCHEMA, save_static_tree

# Metric keys on the static plane.  "samples" mirrors defs/calls so the
# default flamegraph/export pipelines render without a --metric override.
DEFS = "defs"
CALLS = "calls"
EXT_CALLS = "ext_calls"

# Synthetic code-object names the interpreter mints (module bodies, lambdas,
# comprehensions).  They appear in *dynamic* profiles of repo code but are
# not defs, so coverage's drift check must never flag them.
SYNTHETIC_NAMES = frozenset(
    {"<module>", "<lambda>", "<listcomp>", "<setcomp>", "<dictcomp>", "<genexpr>", "<string>"}
)


def iter_py_files(root: str) -> Iterator[str]:
    """Yield repo-relative paths of every ``.py`` under ``root``, sorted so
    extraction (and therefore the serialized artifact) is deterministic."""
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__" and not d.startswith("."))
        for fn in filenames:
            if fn.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, fn), root))
    return iter(sorted(out))


def module_name(relpath: str, package: str) -> str:
    parts = relpath[: -len(".py")].replace(os.sep, "/").split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([package] + parts) if parts else package


@dataclass
class DefSite:
    """One function/method definition found by the extractor."""

    qualname: str  # repro_torch.profilerd.agent.Agent.tick
    name: str  # tick (== the sampled frame's co_name)
    relpath: str
    line: int
    frames: list[str] = field(default_factory=list)  # tree path, root -> leaf


@dataclass
class StaticGraph:
    """Extractor output: the plane tree plus the coverage cross-join inputs."""

    tree: CallTree
    defs: list[DefSite]
    n_modules: int
    n_edges: int
    root: str

    @property
    def def_names(self) -> frozenset[str]:
        """Every defined ``co_name`` — the resolver's symbolization universe."""
        return frozenset(d.name for d in self.defs)

    def meta(self) -> dict:
        return {
            "generator": "repro_torch.analysis.extract",
            "root": os.path.basename(os.path.abspath(self.root)),
            "modules": self.n_modules,
            "defs": len(self.defs),
            "edges": self.n_edges,
        }


def _call_targets(body: list[ast.stmt]) -> dict[str, int]:
    """Count call targets in ``body`` without descending into nested defs
    (those own their call sites).  Target = bare name or last attribute
    segment (``self._raw_stack()`` -> ``_raw_stack``)."""
    counts: dict[str, int] = {}
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(node, ast.Call):
            fn = node.func
            name = None
            if isinstance(fn, ast.Name):
                name = fn.id
            elif isinstance(fn, ast.Attribute):
                name = fn.attr
            if name:
                counts[name] = counts.get(name, 0) + 1
        stack.extend(ast.iter_child_nodes(node))
    return counts


def _walk_defs(
    module_ast: ast.Module, modname: str, relpath: str
) -> Iterator[tuple[DefSite, dict[str, int]]]:
    """Yield every def in the module with its call-target counts, in source
    order, carrying the containment frames the tree uses."""

    def visit(body: list[ast.stmt], frames: list[str], qual: list[str]) -> Iterator:
        for node in body:
            if isinstance(node, ast.ClassDef):
                yield from visit(node.body, frames + [f"cls::{node.name}"], qual + [node.name])
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                site = DefSite(
                    qualname=".".join([modname] + qual + [node.name]),
                    name=node.name,
                    relpath=relpath,
                    line=node.lineno,
                    frames=frames + [f"repro::{node.name}"],
                )
                yield site, _call_targets(node.body)
                yield from visit(node.body, site.frames, qual + [node.name])

    yield from visit(module_ast.body, [f"mod::{modname}"], [])


def extract_static_graph(root: str, *, package: str = "repro_torch") -> StaticGraph:
    """Parse every module under ``root`` into the static call-graph plane.

    Raises ``SyntaxError`` (annotated with the file) if a module does not
    parse — an unparsable tree is "unreadable", never a silently smaller one.
    """
    per_module: list[tuple[str, str, list[tuple[DefSite, dict[str, int]]]]] = []
    for relpath in iter_py_files(root):
        with open(os.path.join(root, relpath), encoding="utf-8") as f:
            src = f.read()
        try:
            mod = ast.parse(src)
        except SyntaxError as exc:
            raise SyntaxError(f"{os.path.join(root, relpath)}: {exc}") from exc
        modname = module_name(relpath, package)
        per_module.append((modname, relpath, list(_walk_defs(mod, modname, relpath))))

    all_names = frozenset(site.name for _, _, pairs in per_module for site, _ in pairs)
    tree = CallTree()
    defs: list[DefSite] = []
    n_edges = 0
    for _modname, _relpath, pairs in per_module:
        for site, targets in pairs:
            defs.append(site)
            tree.add_stack(site.frames, {DEFS: 1.0, "samples": 1.0})
            ext = 0
            for callee in sorted(targets):
                n = targets[callee]
                if callee in all_names and callee != site.name:
                    tree.add_stack(site.frames + [f"repro::{callee}"], {CALLS: float(n), "samples": float(n)})
                    n_edges += 1
                else:
                    ext += n
            if ext:
                tree.add_stack(site.frames, {EXT_CALLS: float(ext)})
    return StaticGraph(tree=tree, defs=defs, n_modules=len(per_module), n_edges=n_edges, root=root)


def default_package_root() -> str:
    """The installed ``repro_torch`` package directory (what CI extracts)."""
    import repro_torch

    paths = list(getattr(repro_torch, "__path__", []))
    if paths:  # namespace package: no __init__.py, no __file__
        return os.path.abspath(paths[0])
    return os.path.dirname(os.path.abspath(repro_torch.__file__))


def extract_to_file(out_path: str, *, root: str | None = None, package: str = "repro_torch") -> StaticGraph:
    """Extract and save the versioned artifact; returns the graph."""
    root = root or default_package_root()
    graph = extract_static_graph(root, package=package)
    save_static_tree(graph.tree, out_path, meta=graph.meta())
    return graph


__all__ = [
    "CALLS",
    "DEFS",
    "EXT_CALLS",
    "STATIC_TREE_SCHEMA",
    "SYNTHETIC_NAMES",
    "DefSite",
    "StaticGraph",
    "default_package_root",
    "extract_static_graph",
    "extract_to_file",
    "iter_py_files",
    "module_name",
]
