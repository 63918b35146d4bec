"""Universal call-tree exporters: folded stacks, speedscope, flamegraph HTML.

Every profile artifact in this repo is a :class:`~repro_torch.core.calltree.CallTree`
— the live daemon tree, sealed epoch windows, cross-run diffs, the launcher's
fleet merge — so one exporter layer makes all of them consumable by standard
tooling:

* **folded** (:func:`to_folded`) — Brendan Gregg collapsed-stack lines
  (``a;b;c 42``), the interchange format every flamegraph tool reads.  Values
  are *residual self* values (a node's inclusive metric minus its children's),
  so :func:`from_folded` re-ingests a folded dump into a tree with identical
  inclusive metrics at every node — the exporter round-trips.
* **speedscope** (:func:`to_speedscope`) — the `speedscope file-format schema
  <speedscope.app>`-shaped JSON (``shared.frames`` + one ``sampled`` profile),
  loadable by drag-and-drop.
* **flamegraph HTML** (:func:`flamegraph_html`) — a single self-contained
  page (no CDN, no external URL): rect layout, click-to-zoom, hover details.
  Diff trees built by :func:`build_diff_tree` render with share-delta
  coloring — red where the candidate gained share over the baseline, blue
  where it lost — the visual form of ``profilerd diff``.

:func:`export_tree` routes any ``(tree, format)`` pair through an optional
:class:`~repro_torch.core.report.ViewConfig`, so all the library views in
:mod:`repro_torch.core.views_library` export uniformly; the ``profilerd`` HTTP
server and the ``export`` subcommand are thin wrappers over it.

A copy of ``repro.core.export``: the same bytes for the same tree in every
format (the speedscope file names its exporter ``repro.core.export``, as the
JAX package's does), so either package's readers take the other's output.
"""

from __future__ import annotations

import html as _html
import json
from collections.abc import Iterator

from .calltree import SAMPLES, CallNode, CallTree

EXPORT_FORMATS = ("csv", "folded", "speedscope", "html", "json")

#: metric keys a diff tree carries beside the compared metric
DIFF_BASELINE = "baseline"
DIFF_SHARE_DELTA = "share_delta"

CONTENT_TYPES = {
    "csv": "text/csv; charset=utf-8",
    "folded": "text/plain; charset=utf-8",
    "speedscope": "application/json",
    "json": "application/json",
    "html": "text/html; charset=utf-8",
}


# -- folded (collapsed) stacks ----------------------------------------------


def iter_folded(tree: CallTree, metric: str = SAMPLES) -> Iterator[tuple[tuple[str, ...], float]]:
    """Yield ``(path, residual)`` per node, children sorted by name.

    ``residual`` is the node's inclusive value minus its children's inclusive
    sum — the value attributable to *exactly* this stack.  For trees built
    from stack samples it equals the self value; defining it structurally
    makes the fold → re-ingest roundtrip exact for any tree (including
    device-plane metrics and windowed deltas, where negatives can appear).
    A nonzero residual on the synthetic root (samples ingested with an empty
    stack) is yielded with the empty path ``()`` so no mass is ever dropped.
    """

    def rec(node: CallNode, path: tuple[str, ...]) -> Iterator[tuple[tuple[str, ...], float]]:
        kids = sorted(node.children.values(), key=lambda c: c.name)
        residual = node.metrics.get(metric, 0.0) - sum(c.metrics.get(metric, 0.0) for c in kids)
        if residual:
            yield path, residual
        for c in kids:
            yield from rec(c, path + (c.name,))

    yield from rec(tree.root, ())


def _escape_frame(name: str) -> str:
    # ';' is the folded-format separator and '\n' the record separator; a
    # frame (e.g. an arbitrary HLO op_name path) may contain either.
    return name.replace("\\", "\\\\").replace(";", "\\;").replace("\n", "\\n")


def _split_frames(stack: str) -> list[str]:
    frames: list[str] = []
    cur: list[str] = []
    it = iter(stack)
    for ch in it:
        if ch == "\\":
            nxt = next(it, "")
            cur.append("\n" if nxt == "n" else nxt)
        elif ch == ";":
            frames.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    frames.append("".join(cur))
    return frames


def to_folded(tree: CallTree, metric: str = SAMPLES) -> str:
    """FlameGraph-compatible collapsed stacks, one ``a;b;c value`` per line.

    Values use ``repr`` (shortest exact float roundtrip) and frame names
    escape ``;``/``\\``/newlines, so the text layer never loses information.
    Re-ingestion is bit-exact whenever the residuals themselves are (always
    true for count-like metrics; a parent mixing a tiny self value into a
    huge child total is subject to ordinary float subtraction error, text
    format regardless).
    """
    lines = []
    for path, v in iter_folded(tree, metric):
        if not path:
            # Root residual (empty-stack samples): the root token is the only
            # way folded text can carry it; from_folded maps it back to [].
            stack = CallTree.ROOT
        else:
            stack = ";".join(_escape_frame(f) for f in path)
            if stack == CallTree.ROOT:  # a real frame named "<root>": disambiguate
                stack = "\\" + stack
            if stack.startswith("#"):  # would read back as a comment line
                stack = "\\" + stack
        lines.append(f"{stack} {v!r}")
    return "\n".join(lines)


def from_folded(text: str, metric: str = SAMPLES) -> CallTree:
    """Re-ingest a folded dump (inverse of :func:`to_folded`)."""
    tree = CallTree()
    # Split on '\n' only (not splitlines): '\r', '\x0b', ' ' etc. are
    # legal inside frame names and must not break records.  The rstrip below
    # still swallows a '\r\n' ending from externally-produced files.
    for line in text.split("\n"):
        if not line.strip() or (line.startswith("#") and not line.startswith("\\#")):
            continue
        # No lstrip: leading whitespace belongs to the first frame's name.
        stack, sep, value = line.rstrip().rpartition(" ")
        if not sep:
            continue  # no value field: malformed/foreign line
        # stack == "" is a legitimate single frame whose name is empty.
        if stack == CallTree.ROOT:
            tree.add_stack([], {metric: float(value)})  # root residual
        else:
            tree.add_stack(_split_frames(stack), {metric: float(value)})
    return tree


# -- speedscope --------------------------------------------------------------


def to_speedscope(tree: CallTree, metric: str = SAMPLES, name: str = "profile") -> dict:
    """Speedscope file-format dict (``shared.frames`` + one sampled profile).

    Each unique stack becomes one sample whose weight is the stack's residual
    value; non-positive residuals are skipped (speedscope weights must be
    positive — diff trees belong in the HTML diff view instead), as is any
    root residual (a weight needs at least one frame to attach to).
    """
    frames: list[dict] = []
    index: dict[str, int] = {}
    samples: list[list[int]] = []
    weights: list[float] = []
    for path, v in iter_folded(tree, metric):
        if v <= 0 or not path:
            continue
        stack = []
        for frame in path:
            i = index.get(frame)
            if i is None:
                i = index[frame] = len(frames)
                frames.append({"name": frame})
            stack.append(i)
        samples.append(stack)
        weights.append(v)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "name": name,
        "exporter": "repro.core.export",
        "activeProfileIndex": 0,
        "shared": {"frames": frames},
        "profiles": [
            {
                "type": "sampled",
                "name": name,
                "unit": "none",
                "startValue": 0.0,
                "endValue": sum(weights),
                "samples": samples,
                "weights": weights,
            }
        ],
    }


def to_speedscope_json(tree: CallTree, metric: str = SAMPLES, name: str = "profile") -> str:
    return json.dumps(to_speedscope(tree, metric, name))


def prune_min_share(tree: CallTree, metric: str = SAMPLES, min_share: float = 0.0) -> CallTree:
    """Drop subtrees whose inclusive share of the root total is below
    ``min_share`` (the non-CSV formats' counterpart of ``ViewConfig.min_share``).
    """
    total = tree.total(metric)
    if min_share <= 0 or total <= 0:
        return tree
    cutoff = min_share * total

    def keep(node: CallNode) -> CallNode:
        out = CallNode(node.name, dict(node.metrics), dict(node.self_metrics))
        for name, c in node.children.items():
            if abs(c.metrics.get(metric, 0.0)) >= cutoff:
                out.children[name] = keep(c)
        return out

    return CallTree(keep(tree.root))


# -- cross-run diff trees ----------------------------------------------------


def build_diff_tree(baseline: CallTree, candidate: CallTree, metric: str = SAMPLES) -> CallTree:
    """Union tree annotating every call-site with its cross-run share delta.

    Each node's metrics carry the candidate value under ``metric``, the
    baseline value under ``"baseline"`` and ``"share_delta"`` = candidate
    share minus baseline share (each tree normalized to its own total, so run
    length cancels out).  Sign convention: **positive = the candidate grew**
    (regression red), negative = it shrank (improvement blue).
    """
    btot = baseline.total(metric) or 1.0
    ctot = candidate.total(metric) or 1.0

    def rec(bnode: CallNode | None, cnode: CallNode | None, name: str) -> CallNode:
        bv = bnode.metrics.get(metric, 0.0) if bnode is not None else 0.0
        cv = cnode.metrics.get(metric, 0.0) if cnode is not None else 0.0
        bs = bnode.self_metrics.get(metric, 0.0) if bnode is not None else 0.0
        cs = cnode.self_metrics.get(metric, 0.0) if cnode is not None else 0.0
        out = CallNode(
            name,
            {metric: cv, DIFF_BASELINE: bv, DIFF_SHARE_DELTA: cv / ctot - bv / btot},
            {metric: cs, DIFF_BASELINE: bs, DIFF_SHARE_DELTA: cs / ctot - bs / btot},
        )
        names: dict[str, None] = {}
        if bnode is not None:
            names.update(dict.fromkeys(bnode.children))
        if cnode is not None:
            names.update(dict.fromkeys(cnode.children))
        for n in names:
            out.children[n] = rec(
                bnode.children.get(n) if bnode is not None else None,
                cnode.children.get(n) if cnode is not None else None,
                n,
            )
        return out

    return CallTree(rec(baseline.root, candidate.root, CallTree.ROOT))


# -- self-contained flamegraph HTML ------------------------------------------

_FLAME_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font: 12px ui-monospace, Menlo, monospace; background:#101014; color:#ddd; margin:0; }}
 #hdr {{ padding:8px 12px; }} #hdr b {{ color:#fff; }}
 #crumb span {{ color:#8cf; cursor:pointer; margin-left:.6em; }}
 #fg {{ position:relative; margin:0 12px 12px; }}
 .f {{ position:absolute; height:16px; line-height:15px; overflow:hidden; white-space:nowrap;
      font-size:11px; padding:0 3px; box-sizing:border-box; cursor:pointer; color:#15151a;
      border-right:1px solid #101014; border-bottom:1px solid #101014; border-radius:2px; }}
 .f:hover {{ filter: brightness(1.25); }}
 #legend {{ color:#888; padding:0 12px 10px; }}
</style></head>
<body>
<div id="hdr"><b>{title}</b> &mdash; metric <b>{metric}</b>, total <b>{total:.6g}</b>
 <span id="crumb"></span></div>
<div id="fg"></div>
<div id="legend">{legend}</div>
<script id="fgdata" type="application/json">{data}</script>
<script>
(function () {{
 "use strict";
 var root = JSON.parse(document.getElementById('fgdata').textContent);
 var DIFF = !!root.diff;
 var ROOF = !!root.roofline;
 var el = document.getElementById('fg'), crumb = document.getElementById('crumb');
 (function link(n) {{ n.c.forEach(function (k) {{ k.p = n; link(k); }}); }})(root);
 var zoomed = root;
 function pct(x) {{ return (100 * x).toFixed(2) + '%'; }}
 function hue(s) {{
   var h = 0;
   for (var i = 0; i < s.length; i++) h = (h * 31 + s.charCodeAt(i)) >>> 0;
   return h;
 }}
 function color(n) {{
   if (DIFF) {{
     var d = Math.max(-1, Math.min(1, (n.d || 0) * 4));
     if (d >= 0) return 'rgb(255,' + Math.round(225 - 150 * d) + ',' + Math.round(160 - 120 * d) + ')';
     return 'rgb(' + Math.round(160 + 120 * d) + ',' + Math.round(205 + 40 * d) + ',255)';
   }}
   if (ROOF) {{
     var o = Math.max(0, Math.min(1, n.o || 0));
     var l = (74 - 28 * o).toFixed(0) + '%';
     if (n.t === 'compute') return 'hsl(28,90%,' + l + ')';
     if (n.t === 'memory') return 'hsl(210,85%,' + l + ')';
     if (n.t === 'collective') return 'hsl(130,55%,' + l + ')';
     return 'hsl(240,3%,62%)';
   }}
   var h = hue(n.n);
   return 'hsl(' + (h % 55) + ',' + (55 + h % 25) + '%,' + (52 + h % 12) + '%)';
 }}
 function depth(n) {{
   var d = 1;
   n.c.forEach(function (k) {{ d = Math.max(d, 1 + depth(k)); }});
   return d;
 }}
 function title(n) {{
   var t = n.n + '\\nvalue=' + n.v;
   if (DIFF) t += '\\nbaseline=' + n.b + '\\n\\u0394share=' + pct(n.d || 0);
   else if (root.v) t += '  (' + pct(n.v / root.v) + ' of total)';
   if (ROOF && n.t) t += '\\ndominant=' + n.t + '\\noccupancy=' + pct(n.o || 0);
   return t;
 }}
 function render() {{
   el.innerHTML = '';
   var W = el.clientWidth || 1200;
   el.style.height = (depth(zoomed) * 16 + 2) + 'px';
   (function rec(n, x, width, lvl) {{
     if (width < 0.4) return;
     var d = document.createElement('div');
     d.className = 'f';
     d.style.left = x.toFixed(1) + 'px';
     d.style.top = (lvl * 16) + 'px';
     d.style.width = Math.max(1, width - 1).toFixed(1) + 'px';
     d.style.background = color(n);
     d.textContent = width > 34 ? n.n : '';
     d.title = title(n);
     d.onclick = function (ev) {{ ev.stopPropagation(); zoom(n); }};
     el.appendChild(d);
     var sumc = 0;
     n.c.forEach(function (k) {{ sumc += k.w; }});
     if (!sumc) return;
     var unit = width / Math.max(n.w, sumc);
     var cx = x;
     n.c.forEach(function (k) {{ rec(k, cx, k.w * unit, lvl + 1); cx += k.w * unit; }});
   }})(zoomed, 0, W, 0);
   var trail = [], n = zoomed;
   while (n) {{ trail.unshift(n); n = n.p; }}
   crumb.innerHTML = '';
   trail.forEach(function (t) {{
     var s = document.createElement('span');
     s.textContent = t === root ? '[reset zoom]' : t.n;
     s.onclick = function () {{ zoom(t); }};
     crumb.appendChild(s);
   }});
 }}
 function zoom(n) {{ zoomed = n; render(); }}
 window.onresize = render;
 render();
}})();
</script>
</body></html>
"""


def _fg_data(node: CallNode, metric: str, diff: bool, roofline: bool = False) -> dict:
    v = node.metrics.get(metric, 0.0)
    d: dict = {"n": node.name, "v": v, "w": abs(v), "c": []}
    if diff:
        b = node.metrics.get(DIFF_BASELINE, 0.0)
        d["b"] = b
        d["d"] = node.metrics.get(DIFF_SHARE_DELTA, 0.0)
        d["w"] = abs(v) + abs(b)
    if roofline:
        from .planes import OCCUPANCY, dominant_term

        term = dominant_term(node.metrics)
        if term is not None:
            d["t"] = term
            d["o"] = node.metrics.get(OCCUPANCY, 0.0)
    for c in sorted(node.children.values(), key=lambda c: -abs(c.metrics.get(metric, 0.0))):
        d["c"].append(_fg_data(c, metric, diff, roofline))
    return d


def flamegraph_html(
    tree: CallTree,
    metric: str = SAMPLES,
    title: str = "flamegraph",
    *,
    diff: bool = False,
    roofline: bool = False,
) -> str:
    """One self-contained interactive flamegraph page (no external resources).

    ``diff=True`` expects a tree from :func:`build_diff_tree`: rect widths
    combine baseline+candidate mass and colors encode the share delta
    (red = candidate gained share, blue = lost).

    ``roofline=True`` expects a merged-plane tree from
    :func:`repro_torch.core.planes.annotate_tree`: each frame is colored by its
    dominant roofline term (orange = compute, blue = memory, green =
    collective; gray = no device annotation), with the shade deepening as the
    node's roofline occupancy grows.
    """
    data = _fg_data(tree.root, metric, diff, roofline)
    data["diff"] = diff
    data["roofline"] = roofline
    if diff:
        legend = "color: share delta vs baseline &mdash; red grew, blue shrank; click a frame to zoom"
    elif roofline:
        legend = (
            "color: dominant roofline term &mdash; "
            '<span style="color:hsl(28,90%,55%)">compute</span>, '
            '<span style="color:hsl(210,85%,60%)">memory</span>, '
            '<span style="color:hsl(130,55%,50%)">collective</span>, '
            "gray = no device annotation; darker = higher roofline occupancy; "
            "click a frame to zoom"
        )
    else:
        legend = "click a frame to zoom; click [reset zoom] to return"
    # `</` must not appear verbatim inside the <script> data island (a frame
    # named "</script>" would terminate it); "<\/" is the same JSON string.
    blob = json.dumps(data).replace("</", "<\\/")
    return _FLAME_PAGE.format(
        title=_html.escape(title),
        metric=_html.escape(metric),
        total=tree.total(metric),
        legend=legend,
        data=blob,
    )


def diff_flamegraph_html(
    baseline: CallTree,
    candidate: CallTree,
    metric: str = SAMPLES,
    title: str = "diff flamegraph (red = candidate grew)",
) -> str:
    """Baseline-vs-candidate flamegraph with share-delta coloring."""
    return flamegraph_html(build_diff_tree(baseline, candidate, metric), metric, title, diff=True)


# -- the view-routed export front door ---------------------------------------


def resolve_view(view: str | object | None):
    """Normalize a view argument: name -> library ViewConfig, None passes."""
    from .report import ViewConfig

    if isinstance(view, str):
        from .views_library import VIEWS

        if view not in VIEWS:
            raise KeyError(f"unknown view {view!r} (see views_library.list_views())")
        return VIEWS[view]
    if view is not None and not isinstance(view, ViewConfig):
        raise TypeError(f"view must be a ViewConfig or view name, got {type(view).__name__}")
    return view


def prepare_view(
    tree: CallTree,
    view,
    metric: str | None = None,
    fmt: str | None = None,
) -> tuple[CallTree, str, str | None]:
    """Apply a view (zoom/filters/level **and** min_share pruning) exactly once.

    Returns ``(applied_tree, metric, marker)``: ``marker`` is non-None when a
    non-empty input tree came out empty — the no-match / filter-emptied /
    min_share-pruned-everything verdicts the CLI and server turn into exit
    code 4 / HTTP 404 so a vacuous export never ships silently.  Pass ``fmt``
    to also mark structural stacklessness (a level=0 fold leaves a root-only
    tree): CSV still carries the total in its header, but the stack-shaped
    formats (``folded``/``speedscope``) would render nothing at all.
    """
    view = resolve_view(view)
    if view is None:
        return tree, metric or SAMPLES, None
    metric = metric or view.metric
    applied = view.apply(tree)
    pruned = prune_min_share(applied, metric, view.min_share) if view.min_share > 0 else applied
    marker = None
    if not pruned.root.children and tree.root.children:
        from .report import min_share_marker

        marker = view.empty_marker(tree)
        if marker is None and applied.root.children:
            marker = min_share_marker(view.min_share)
        if marker is None and fmt in ("folded", "speedscope"):
            marker = f"# empty export: the view left no stacks for fmt={fmt} (level=0?)"
    return pruned, metric, marker


def export_tree(
    tree: CallTree,
    fmt: str = "csv",
    *,
    view: str | object | None = None,
    metric: str | None = None,
    title: str = "calltree",
    diff: bool = False,
    roofline: bool = False,
) -> str:
    """Render ``tree`` in any supported format, optionally through a view.

    ``view`` is a :class:`~repro_torch.core.report.ViewConfig` or the name of one in
    :data:`repro_torch.core.views_library.VIEWS`; its zoom/level/filters/min_share
    apply to every format (the paper's exploration configs, now export-format
    agnostic).  ``metric`` overrides the view's metric (default ``samples``).
    Callers that must fail loudly on vacuously-empty views use
    :func:`prepare_view` first and pass the applied tree here with no view.
    """
    if fmt not in EXPORT_FORMATS:
        raise ValueError(f"unknown format {fmt!r} (choose from {', '.join(EXPORT_FORMATS)})")
    view = resolve_view(view)
    if view is not None and fmt == "csv":
        from dataclasses import replace

        return replace(view, metric=metric or view.metric).to_csv(tree)
    applied, metric, _marker = prepare_view(tree, view, metric)
    if view is not None and view.name not in title:
        title = f"{title} [{view.name}]"
    if fmt == "csv":
        from .report import ViewConfig as _VC

        return _VC(name=title, metric=metric).to_csv(applied)
    if fmt == "folded":
        return to_folded(applied, metric)
    if fmt == "speedscope":
        return to_speedscope_json(applied, metric, name=title)
    if fmt == "json":
        return applied.to_json()
    return flamegraph_html(applied, metric, title=title, diff=diff, roofline=roofline)
