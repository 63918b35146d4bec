"""Hierarchical call-tree: the paper's central data structure (Fig. 7); a
copy of ``repro.core.calltree``.

Samples (stacks, root->leaf) sharing a common prefix merge into one path and
their counters accumulate on every shared node; after the first divergence the
paths split, and the *same* callee reached from *different* callers is kept as
a distinct call-site with its own counters.

Counters are generalized to a metrics dict so the same structure serves both
profiling planes:

* host plane  — ``{"samples": 1.0}`` per sampled stack (the paper's counters);
* device plane — ``{"flops": ..., "bytes": ..., "ops": ...}`` (and, on the
  card, ``device_ms`` and ``kernels``) per profiled op, keyed by its path of
  named ranges (``core/device_tree.py``).

Views (paper §III-D):

* ``flatten()``     — all nodes with an identical name merged, counters summed;
* ``levels(n)``     — tree truncated at depth ``n``; deeper nodes aggregate into
                      their level-``n`` ancestor (``n=-1`` expands to the leaves);
* ``zoom(root)``    — re-root at every node matching ``root`` (name or predicate),
                      merging the matching subtrees;
* ``filtered(...)`` — whitelist / blacklist by node name.

Trees support ``merge`` (cross-host aggregation) and ``diff`` (windowed deltas
for the anomaly detector).

Hot-counter fast lane
---------------------

The host plane bumps exactly one metric (``samples``) on every node of every
ingested stack, thousands of times per second, while the device plane needs
the open-ended metrics schema.  ``CallNode`` therefore carries a dedicated
``samples``/``self_samples`` float pair beside the generalized dicts: the
cached-path ingestion fast lane (:meth:`CallTree.path_nodes` +
:meth:`CallTree.add_stack_nodes`, used by the thread sampler) bumps only
those floats — no hashing, no dict churn.  Reading the
``metrics``/``self_metrics`` properties folds any pending fast-lane counts
into the dicts first, so every consumer (views, reports, JSON, detector)
sees one coherent metrics mapping and never needs to know the fast lane
exists.
"""

from __future__ import annotations

import json
from collections.abc import Callable, Iterable, Iterator, Mapping, Sequence

Metrics = dict[str, float]
FramePredicate = Callable[[str], bool]

SAMPLES = "samples"


def _as_predicate(sel: str | FramePredicate) -> FramePredicate:
    if callable(sel):
        return sel
    return lambda name: name == sel


class CallNode:
    """One call-site: a function name reached through a unique caller chain."""

    __slots__ = ("name", "samples", "self_samples", "_metrics", "_self_metrics", "children")

    def __init__(
        self,
        name: str,
        metrics: Metrics | None = None,
        self_metrics: Metrics | None = None,
        children: dict[str, "CallNode"] | None = None,
    ):
        self.name = name
        # Fast-lane pending counts, folded into the dicts on read.
        self.samples = 0.0
        self.self_samples = 0.0
        self._metrics: Metrics = metrics if metrics is not None else {}
        self._self_metrics: Metrics = self_metrics if self_metrics is not None else {}
        self.children: dict[str, "CallNode"] = children if children is not None else {}

    # -- fast-lane / dict coherence -----------------------------------------

    @property
    def metrics(self) -> Metrics:
        """Inclusive metrics: this node and everything below it."""
        if self.samples:
            m = self._metrics
            m[SAMPLES] = m.get(SAMPLES, 0.0) + self.samples
            self.samples = 0.0
        return self._metrics

    @metrics.setter
    def metrics(self, value: Metrics) -> None:
        self.samples = 0.0
        self._metrics = value

    @property
    def self_metrics(self) -> Metrics:
        """Exclusive ("self") metrics: samples whose stack *ended* here."""
        if self.self_samples:
            m = self._self_metrics
            m[SAMPLES] = m.get(SAMPLES, 0.0) + self.self_samples
            self.self_samples = 0.0
        return self._self_metrics

    @self_metrics.setter
    def self_metrics(self, value: Metrics) -> None:
        self.self_samples = 0.0
        self._self_metrics = value

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"CallNode({self.name!r}, {self.metrics!r}, {self.self_metrics!r}, "
            f"children={list(self.children)!r})"
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, CallNode):
            return NotImplemented
        return (
            self.name == other.name
            and self.metrics == other.metrics
            and self.self_metrics == other.self_metrics
            and self.children == other.children
        )

    __hash__ = object.__hash__  # identity hash: nodes are mutable accumulators

    # -- counter plumbing ---------------------------------------------------

    def _bump(self, into: Metrics, delta: Mapping[str, float]) -> None:
        for k, v in delta.items():
            into[k] = into.get(k, 0.0) + v

    def add(self, delta: Mapping[str, float], *, leaf: bool) -> None:
        self._bump(self.metrics, delta)
        if leaf:
            self._bump(self.self_metrics, delta)

    def child(self, name: str) -> "CallNode":
        node = self.children.get(name)
        if node is None:
            node = CallNode(name)
            self.children[name] = node
        return node

    # -- traversal ----------------------------------------------------------

    def walk(self, path: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], "CallNode"]]:
        here = path + (self.name,)
        yield here, self
        for c in self.children.values():
            yield from c.walk(here)

    def total(self, metric: str = SAMPLES) -> float:
        return self.metrics.get(metric, 0.0)

    def depth(self) -> int:
        if not self.children:
            return 1
        return 1 + max(c.depth() for c in self.children.values())

    def copy(self) -> "CallNode":
        return CallNode(
            self.name,
            dict(self.metrics),
            dict(self.self_metrics),
            {k: v.copy() for k, v in self.children.items()},
        )

    def merge_from(self, other: "CallNode") -> None:
        """Accumulate ``other`` (same name) into this node — Fig. 7 semantics."""
        self._bump(self.metrics, other.metrics)
        self._bump(self.self_metrics, other.self_metrics)
        for name, oc in other.children.items():
            self.child(name).merge_from(oc)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "metrics": self.metrics,
            "self": self.self_metrics,
            "children": [c.to_dict() for c in self.children.values()],
        }

    @staticmethod
    def from_dict(d: dict) -> "CallNode":
        node = CallNode(d["name"], dict(d.get("metrics", {})), dict(d.get("self", {})))
        for cd in d.get("children", []):
            c = CallNode.from_dict(cd)
            node.children[c.name] = c
        return node


class CallTree:
    """A merged collection of stack samples with the paper's view controls."""

    ROOT = "<root>"

    def __init__(self, root: CallNode | None = None):
        self.root = root if root is not None else CallNode(self.ROOT)

    # -- ingestion ------------------------------------------------------------

    def add_stack(self, frames: Sequence[str], metrics: Mapping[str, float] | None = None) -> None:
        """Merge one sample. ``frames`` are ordered root -> leaf."""
        if metrics is None:
            # Host-plane default ({samples: 1}): take the float fast lane.
            node = self.root
            node.samples += 1.0
            for frame in frames:
                node = node.child(frame)
                node.samples += 1.0
            node.self_samples += 1.0
            return
        node = self.root
        node.add(metrics, leaf=not frames)
        for i, frame in enumerate(frames):
            node = node.child(frame)
            node.add(metrics, leaf=(i == len(frames) - 1))

    def path_nodes(self, frames: Sequence[str]) -> list[CallNode]:
        """Materialize (without bumping) the node chain for a root->leaf path.

        Returns ``[root, node(frames[0]), ..., node(frames[-1])]``.  Callers
        cache the chain keyed on the interned stack and replay it through
        :meth:`add_stack_nodes`, turning repeated-sample ingestion into an
        O(depth) float-add loop with zero hashing and zero allocation.
        """
        node = self.root
        chain = [node]
        for frame in frames:
            node = node.child(frame)
            chain.append(node)
        return chain

    @staticmethod
    def add_stack_nodes(chain: Sequence[CallNode], count: float = 1.0) -> None:
        """Bump one sample along a prebuilt chain (the ingestion fast lane)."""
        for node in chain:
            node.samples += count
        chain[-1].self_samples += count

    def merge(self, other: "CallTree") -> "CallTree":
        """Merge another tree into this one (e.g. per-host trees at rendezvous)."""
        self.root.merge_from(other.root)
        return self

    def copy(self) -> "CallTree":
        return CallTree(self.root.copy())

    def diff(self, earlier: "CallTree") -> "CallTree":
        """Windowed delta: metrics now minus metrics at an earlier snapshot.

        Nodes whose metrics are unchanged and that have no changed descendants
        are dropped, so detector windows only see recent activity.
        """

        def sub(now: CallNode, before: CallNode | None) -> CallNode | None:
            bm = before.metrics if before else {}
            bs = before.self_metrics if before else {}
            out = CallNode(now.name)
            for k, v in now.metrics.items():
                d = v - bm.get(k, 0.0)
                if d:
                    out.metrics[k] = d
            for k, v in now.self_metrics.items():
                d = v - bs.get(k, 0.0)
                if d:
                    out.self_metrics[k] = d
            for name, c in now.children.items():
                cb = before.children.get(name) if before else None
                sc = sub(c, cb)
                if sc is not None:
                    out.children[name] = sc
            if not out.metrics and not out.self_metrics and not out.children:
                return None
            return out

        delta = sub(self.root, earlier.root)
        return CallTree(delta if delta is not None else CallNode(self.ROOT))

    # -- views (paper §III-D / Fig. 7) -----------------------------------------

    def flatten(self, metric: str = SAMPLES) -> dict[str, float]:
        """Flattened view: counters for identical function names merged.

        Inclusive counters are *not* simply summable across a path (a frame may
        appear once per call chain), so the flattened view sums each name's
        inclusive metric over all call-sites where it appears, matching the
        paper's flattened view of Fig. 7 (a=a1+a2, b=b1+b2, e=e1+e2 ...).
        """
        out: dict[str, float] = {}
        for _path, node in self.root.walk():
            if node is self.root:
                continue
            out[node.name] = out.get(node.name, 0.0) + node.metrics.get(metric, 0.0)
        return out

    def levels(self, n: int) -> "CallTree":
        """N-level view: keep ``n`` levels below the root; deeper nodes fold
        into their last kept ancestor (their metrics are already inclusive, so
        folding == dropping children). ``n = -1`` returns a full copy.
        """
        if n < 0:
            return self.copy()

        def trunc(node: CallNode, level: int) -> CallNode:
            out = CallNode(node.name, dict(node.metrics), dict(node.self_metrics))
            if level < n:
                for name, c in node.children.items():
                    out.children[name] = trunc(c, level + 1)
            else:
                # Fold all descendants into this node's self metrics.
                out.self_metrics = dict(out.metrics)
            return out

        return CallTree(trunc(self.root, 0))

    def zoom(self, selector: str | FramePredicate) -> "CallTree":
        """Re-root at every node matching ``selector``; matching subtrees merge.

        This implements the paper's root-of-interest control (e.g. "all
        functions related to the IEW stage"), here e.g. zoom("attention").
        """
        pred = _as_predicate(selector)
        out = CallTree()
        found: list[CallNode] = []

        def visit(node: CallNode) -> None:
            if node is not self.root and pred(node.name):
                found.append(node)
                return  # do not descend: the whole subtree belongs to the match
            for c in node.children.values():
                visit(c)

        visit(self.root)
        for node in found:
            out.root.merge_from(CallNode(out.ROOT, dict(node.metrics), dict(node.self_metrics), {node.name: node.copy()}))
        return out

    def filtered(
        self,
        whitelist: Iterable[str] | None = None,
        blacklist: Iterable[str] | None = None,
        substring: bool = True,
    ) -> "CallTree":
        """White/blacklist view. A blacklisted node is removed with its subtree
        (excluded from breakdown totals, like the artifact's parser cfg); with a
        whitelist, only paths touching a whitelisted name survive.
        """
        wl = list(whitelist) if whitelist else None
        bl = list(blacklist) if blacklist else []

        def match(name: str, pats: Iterable[str]) -> bool:
            return any((p in name) if substring else (p == name) for p in pats)

        def keep(node: CallNode) -> CallNode | None:
            if match(node.name, bl):
                return None
            kept_children = {}
            for name, c in node.children.items():
                kc = keep(c)
                if kc is not None:
                    kept_children[name] = kc
            if wl is not None and not match(node.name, wl) and not kept_children:
                return None
            out = CallNode(node.name, dict(node.metrics), dict(node.self_metrics))
            out.children = kept_children
            return out

        kept = {}
        for name, c in self.root.children.items():
            kc = keep(c)
            if kc is not None:
                kept[name] = kc
        root = CallNode(self.ROOT, dict(self.root.metrics), dict(self.root.self_metrics))
        root.children = kept
        return CallTree(root)

    # -- analysis helpers -------------------------------------------------------

    def total(self, metric: str = SAMPLES) -> float:
        return self.root.total(metric)

    def shares(self, metric: str = SAMPLES, *, self_only: bool = False) -> dict[tuple[str, ...], float]:
        """Per-call-site share of the root total (detector input)."""
        total = self.total(metric)
        if total <= 0:
            return {}
        out = {}
        for path, node in self.root.walk():
            if node is self.root:
                continue
            src = node.self_metrics if self_only else node.metrics
            v = src.get(metric, 0.0)
            if v:
                out[path[1:]] = v / total
        return out

    def hot_paths(self, metric: str = SAMPLES, k: int = 10, self_only: bool = True) -> list[tuple[tuple[str, ...], float]]:
        sh = self.shares(metric, self_only=self_only)
        return sorted(sh.items(), key=lambda kv: -kv[1])[:k]

    def depth(self) -> int:
        return self.root.depth() - 1

    def node_count(self) -> int:
        """Distinct call-sites in the tree (excluding the synthetic root)."""
        return sum(1 for _ in self.root.walk()) - 1

    # -- serialization ------------------------------------------------------------

    def to_json(self, **kw) -> str:
        return json.dumps(self.root.to_dict(), **kw)

    @staticmethod
    def from_json(s: str) -> "CallTree":
        return CallTree(CallNode.from_dict(json.loads(s)))

    def render(self, metric: str = SAMPLES, max_depth: int = -1, min_share: float = 0.0) -> str:
        """ASCII rendering used in reports/benchmark CSVs."""
        total = max(self.total(metric), 1e-12)
        lines: list[str] = []

        def rec(node: CallNode, indent: int) -> None:
            if max_depth >= 0 and indent > max_depth:
                return
            share = node.metrics.get(metric, 0.0) / total
            if node is not self.root and share < min_share:
                return
            if node is not self.root:
                lines.append(f"{'  ' * indent}{node.name}  {metric}={node.metrics.get(metric, 0.0):.6g}  ({share:6.2%})")
            for c in sorted(node.children.values(), key=lambda c: -c.metrics.get(metric, 0.0)):
                rec(c, indent + (0 if node is self.root else 1))

        rec(self.root, 0)
        return "\n".join(lines)
