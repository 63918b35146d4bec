"""Hierarchical call-tree (a copy of ``repro.core.calltree``, the parts the
trainer's host plane uses).

Samples (stacks, root->leaf) sharing a common prefix merge into one path and
their counters accumulate on every shared node; after the first divergence the
paths split, and the *same* callee reached from *different* callers is kept as
a distinct call-site with its own counters. Counters are a metrics dict
(``{"samples": 1.0}`` per sampled stack on the host plane).

Trees support ``diff`` (windowed deltas for the anomaly detector). The
sampler bumps one metric (``samples``) on every node of every ingested stack,
so ``CallNode`` carries a dedicated ``samples``/``self_samples`` float pair
beside the dicts: the cached-path fast lane
(:meth:`CallTree.path_nodes` + :meth:`CallTree.add_stack_nodes`) bumps only
those floats, and reading ``metrics``/``self_metrics`` folds them into the
dicts first.

The JAX package's views (``flatten``, ``levels``, ``zoom``, ``filtered``,
``render``), ``merge`` and the JSON reader are not copied: nothing in the port
reads them yet.
"""

from __future__ import annotations

import json
from collections.abc import Iterator, Sequence

Metrics = dict[str, float]
SAMPLES = "samples"


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

    @property
    def self_metrics(self) -> Metrics:
        """Exclusive ("self") metrics: samples whose stack *ended* here."""
        if self.self_samples:
            m = self._self_metrics
            m[SAMPLES] = m.get(SAMPLES, 0.0) + self.self_samples
            self.self_samples = 0.0
        return self._self_metrics

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

    def copy(self) -> "CallNode":
        return CallNode(
            self.name,
            dict(self.metrics),
            dict(self.self_metrics),
            {k: v.copy() for k, v in self.children.items()},
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "metrics": self.metrics,
            "self": self.self_metrics,
            "children": [c.to_dict() for c in self.children.values()],
        }

class CallTree:
    """A merged collection of stack samples."""

    ROOT = "<root>"

    def __init__(self, root: CallNode | None = None):
        self.root = root if root is not None else CallNode(self.ROOT)

    # -- ingestion ------------------------------------------------------------

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

    # -- serialization ------------------------------------------------------------

    def to_json(self, **kw) -> str:
        return json.dumps(self.root.to_dict(), **kw)
