"""Interactive HTML/JSON report export (paper §III-D "call-stack analyzer").

The paper exports the merged call tree as an interactive HTML/JSON report with
expand/collapse navigation. We emit a dependency-free standalone HTML page
(nested ``<details>`` elements + share bars) plus the raw JSON tree, and a
parser-config mechanism mirroring the artifact's 125 exploration configs:
each :class:`ViewConfig` selects a root, a fold level, white/blacklists and a
metric, and renders either HTML or CSV.

A copy of ``repro.core.report``: the same bytes for the same tree (the page's
default title included), so a report or view from either package reads the
same.
"""

from __future__ import annotations

import html
import json
import os
from dataclasses import dataclass

from .calltree import SAMPLES, CallNode, CallTree

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: ui-monospace, monospace; background:#111; color:#ddd; margin:1.5em; }}
 details {{ margin-left: 1.2em; border-left: 1px solid #333; padding-left: .4em; }}
 summary {{ cursor: pointer; white-space: nowrap; }}
 .bar {{ display:inline-block; height:.7em; background:#4a8; margin-right:.5em; vertical-align:middle; }}
 .pct {{ color:#8cf; }} .self {{ color:#fa6; }} .name {{ color:#eee; }}
 .controls {{ margin-bottom:1em; }}
 button {{ background:#222; color:#ddd; border:1px solid #444; padding:.3em .8em; cursor:pointer; }}
</style></head>
<body>
<h2>{title}</h2>
<div class="controls">
 <button onclick="document.querySelectorAll('details').forEach(d=>d.open=true)">expand all</button>
 <button onclick="document.querySelectorAll('details').forEach(d=>d.open=false)">collapse all</button>
 metric: <b>{metric}</b> &nbsp; total: <b>{total:.6g}</b>
</div>
{body}
<script type="application/json" id="calltree-json">{json_blob}</script>
</body></html>
"""


def _node_html(node: CallNode, total: float, metric: str, depth: int, max_depth: int) -> str:
    val = node.metrics.get(metric, 0.0)
    share = val / total if total else 0.0
    selfv = node.self_metrics.get(metric, 0.0)
    bar = f'<span class="bar" style="width:{max(1, int(share * 240))}px"></span>'
    label = (
        f'{bar}<span class="pct">{share:6.2%}</span> '
        f'<span class="name">{html.escape(node.name)}</span> '
        f'<span class="self">(self {selfv:.4g})</span>'
    )
    kids = sorted(node.children.values(), key=lambda c: -c.metrics.get(metric, 0.0))
    if not kids or (max_depth >= 0 and depth >= max_depth):
        return f"<div>&nbsp;&nbsp;{label}</div>\n"
    inner = "".join(_node_html(c, total, metric, depth + 1, max_depth) for c in kids)
    return f"<details{' open' if depth < 2 else ''}><summary>{label}</summary>\n{inner}</details>\n"


def render_html(tree: CallTree, title: str = "repro call-tree", metric: str = SAMPLES, max_depth: int = -1) -> str:
    total = max(tree.total(metric), 1e-12)
    body = "".join(
        _node_html(c, total, metric, 0, max_depth)
        for c in sorted(tree.root.children.values(), key=lambda c: -c.metrics.get(metric, 0.0))
    )
    # The JSON blob lives inside a <script> element: a frame named
    # "</script>" (or anything containing "</") would terminate the element
    # early and spill the rest of the tree into the page as markup — where
    # the browser swallows anything tag-shaped (e.g. "<module>").  "<\/" is
    # the identical JSON string, and can never close the script element.
    return _PAGE.format(
        title=html.escape(title),
        metric=html.escape(metric),
        total=tree.total(metric),
        body=body,
        json_blob=tree.to_json().replace("</", "<\\/"),
    )


def write_report(tree: CallTree, out_dir: str, name: str, metric: str = SAMPLES) -> dict[str, str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "html": os.path.join(out_dir, f"{name}.html"),
        "json": os.path.join(out_dir, f"{name}.json"),
    }
    with open(paths["html"], "w") as f:
        f.write(render_html(tree, title=name, metric=metric))
    with open(paths["json"], "w") as f:
        f.write(tree.to_json(indent=1))
    return paths


# -- cross-run differential analysis ----------------------------------------


def name_shares(tree: CallTree, metric: str = SAMPLES, self_only: bool = True) -> dict[str, float]:
    """Per-function-name share vector, normalized to sum to 1.

    ``self_only=True`` (default for regression checks) attributes each sample
    to the function it *ended* in, which is the sharp signal: an injected hot
    loop shows up as its own self-share, not smeared over its whole ancestry.
    """
    out: dict[str, float] = {}
    for _path, node in tree.root.walk():
        if node is tree.root:
            continue
        src = node.self_metrics if self_only else node.metrics
        v = src.get(metric, 0.0)
        if v:
            out[node.name] = out.get(node.name, 0.0) + v
    total = sum(out.values())
    if total <= 0:
        return {}
    return {k: v / total for k, v in out.items()}


def diff_rows(
    a: CallTree,
    b: CallTree,
    metric: str = SAMPLES,
    self_only: bool = False,
) -> list[tuple[tuple[str, ...], float, float, float]]:
    """Per-call-site share deltas between two trees (the cross-run diff).

    Returns ``(path, share_a, share_b, share_b - share_a)`` over the union of
    call-site paths, sorted by descending ``|delta|`` — "did this change make
    the hot path slower" answered per node.
    """
    sa = a.shares(metric, self_only=self_only)
    sb = b.shares(metric, self_only=self_only)
    rows = []
    for path in set(sa) | set(sb):
        va, vb = sa.get(path, 0.0), sb.get(path, 0.0)
        rows.append((path, va, vb, vb - va))
    rows.sort(key=lambda r: (-abs(r[3]), r[0]))
    return rows


def render_diff(
    a: CallTree,
    b: CallTree,
    metric: str = SAMPLES,
    *,
    label_a: str = "a",
    label_b: str = "b",
    min_delta: float = 0.002,
    max_rows: int = 40,
    self_only: bool = False,
) -> str:
    """Text rendering of a cross-run tree diff (per-node share deltas)."""
    from .detector import share_distance

    rows = diff_rows(a, b, metric, self_only=self_only)
    dist = share_distance(name_shares(a, metric), name_shares(b, metric))
    lines = [
        f"# diff metric={metric} {label_a}: total={a.total(metric):.6g} "
        f"{label_b}: total={b.total(metric):.6g} share_distance={dist:.4f}",
        f"{'delta':>8}  {label_a:>7}  {label_b:>7}  path",
    ]
    shown = 0
    for path, va, vb, d in rows:
        if abs(d) < min_delta:
            continue
        lines.append(f"{d:+8.2%}  {va:7.2%}  {vb:7.2%}  {'/'.join(path)}")
        shown += 1
        if shown >= max_rows:
            lines.append(f"# ... {sum(1 for r in rows if abs(r[3]) >= min_delta) - shown} more rows")
            break
    if shown == 0:
        lines.append("# trees are share-identical at this resolution")
    return "\n".join(lines)


def share_regressions(
    baseline: CallTree,
    current: CallTree,
    metric: str = SAMPLES,
    tolerance: float = 0.05,
    self_only: bool = True,
) -> list[tuple[str, float, float, float]]:
    """Functions whose share *grew* beyond ``tolerance`` vs the baseline.

    The ``profilerd check`` gate: only increases count (a function losing
    share is someone else's increase), compared on the per-name share vector
    so run length cancels out.  Returns ``(name, base, cur, delta)`` sorted
    by descending delta.
    """
    base = name_shares(baseline, metric, self_only=self_only)
    cur = name_shares(current, metric, self_only=self_only)
    out = []
    for name in set(base) | set(cur):
        d = cur.get(name, 0.0) - base.get(name, 0.0)
        if d > tolerance:
            out.append((name, base.get(name, 0.0), cur.get(name, 0.0), d))
    out.sort(key=lambda r: -r[3])
    return out


#: Row prepended to a view CSV whose ``root=`` matched no node.
NO_MATCH_MARKER = "# no match for root="

#: Row prepended to a view CSV whose filters/whitelist removed every row
#: (the root *did* match — distinct from :data:`NO_MATCH_MARKER`).
EMPTY_VIEW_MARKER = "# empty view: filters removed every row"


def min_share_marker(min_share: float) -> str:
    """Marker row for a ``min_share`` threshold that pruned every row —
    shared by :meth:`ViewConfig.to_csv` and ``repro_torch.core.export.prepare_view``
    so the CSV body and the CLI/server verdicts can never drift apart."""
    return f"# empty view: min_share={min_share:g} pruned every row"


@dataclass
class ViewConfig:
    """One exploration config (artifact §G): root, fold level, filters."""

    name: str = "view"
    root: str | None = None  # zoom selector (substring of a node name)
    level: int = -1  # -1 expands to leaves, n truncates (artifact semantics)
    metric: str = SAMPLES
    whitelist: list[str] | None = None
    blacklist: list[str] | None = None
    min_share: float = 0.0

    def apply(self, tree: CallTree) -> CallTree:
        t = tree
        if self.root:
            t = t.zoom(lambda n, r=self.root: r in n)
        if self.whitelist or self.blacklist:
            t = t.filtered(self.whitelist, self.blacklist)
        if self.level >= 0:
            t = t.levels(self.level)
        return t

    def matches(self, tree: CallTree) -> bool:
        """False when ``root=`` selected nothing — the view is vacuously empty.

        An empty zoom is indistinguishable from "this run genuinely spent
        nothing there" in the output rows, so consumers (the ``profilerd
        export`` CLI, CI scripts) must be able to tell the difference and
        fail loudly instead of shipping an empty CSV.
        """
        if not self.root:
            return True
        return bool(tree.zoom(lambda n, r=self.root: r in n).root.children)

    def empty_marker(self, tree: CallTree) -> str | None:
        """The marker row this view's emptiness deserves, or ``None``.

        One source of truth for :meth:`to_csv` and the ``profilerd export``
        exit code: "root selected nothing" and "root matched but the
        white/blacklist removed every row" are different operator errors and
        get different markers.  (level=0 folding everything into the root is
        not empty for CSV — the header total says it all — and an empty
        input tree is the caller's business.)
        """
        if self.root and not self.matches(tree):
            return f"{NO_MATCH_MARKER}{self.root}"
        if (self.whitelist or self.blacklist) and tree.root.children:
            # Judge the filters *before* the level fold: level=0 collapsing a
            # perfectly matching view into the root is not "filters removed
            # every row".
            t = tree
            if self.root:
                t = t.zoom(lambda n, r=self.root: r in n)
            if not t.filtered(self.whitelist, self.blacklist).root.children:
                return EMPTY_VIEW_MARKER
        return None

    def to_csv(self, tree: CallTree) -> str:
        t = self.apply(tree)
        total = max(t.total(self.metric), 1e-12)
        rows = [f"# view={self.name} metric={self.metric} total={total:.6g}", "path,value,share"]
        if not t.root.children:
            marker = self.empty_marker(tree)
            if marker is not None:
                rows.append(marker)
                return "\n".join(rows)
        shown = 0
        for path, node in t.root.walk():
            if node is t.root:
                continue
            v = node.metrics.get(self.metric, 0.0)
            if v / total >= self.min_share:
                rows.append(f"{'/'.join(path[1:])},{v:.6g},{v / total:.4f}")
                shown += 1
        if shown == 0 and self.min_share > 0 and t.root.children:
            # Same contract as the no-match markers: a threshold that prunes
            # every row must say so, not ship a header-only table.
            rows.append(min_share_marker(self.min_share))
        return "\n".join(rows)


def breakdown(tree: CallTree, level: int = 1, metric: str = SAMPLES, min_share: float = 0.005) -> list[tuple[str, float]]:
    """Top-level share table — what the paper's stacked-bar figures plot."""
    t = tree.levels(level)
    total = max(t.total(metric), 1e-12)
    out = []

    def rec(node: CallNode, prefix: str) -> None:
        for c in sorted(node.children.values(), key=lambda c: -c.metrics.get(metric, 0.0)):
            share = c.metrics.get(metric, 0.0) / total
            if share >= min_share:
                out.append((f"{prefix}{c.name}", share))
                rec(c, f"{prefix}{c.name}/")

    rec(t.root, "")
    return out


_VIEW_EXT = {"csv": "csv", "folded": "folded", "speedscope": "speedscope.json", "html": "html", "json": "json"}


def save_views(
    tree: CallTree,
    configs: list[ViewConfig],
    out_dir: str,
    formats: tuple[str, ...] = ("csv",),
) -> list[str]:
    """Write every view in every requested format (default: CSV, as before).

    Non-CSV formats route through :func:`repro_torch.core.export.export_tree`, so
    ``formats=("csv", "folded", "html")`` turns the whole view library into
    flamegraph-ready artifacts in one call.  A view that comes out empty
    (no-match root, filters, min_share) writes its marker row as the
    artifact body instead of a vacuously empty file — same contract as the
    CSV markers and the ``profilerd export`` exit code.
    """
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for cfg in configs:
        for fmt in formats:
            p = os.path.join(out_dir, f"{cfg.name}.{_VIEW_EXT.get(fmt, fmt)}")
            if fmt == "csv":
                payload = cfg.to_csv(tree)
            else:
                from .export import export_tree, prepare_view

                applied, metric, marker = prepare_view(tree, cfg, fmt=fmt)
                if marker is not None:
                    payload = marker + "\n"
                else:
                    payload = export_tree(applied, fmt, metric=metric, title=cfg.name)
            with open(p, "w") as f:
                f.write(payload)
            written.append(p)
    return written
