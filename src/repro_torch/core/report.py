"""Standalone HTML/JSON report of a call tree (a copy of ``render_html`` and
``write_report`` from ``repro.core.report``): nested ``<details>`` elements
with share bars, plus the raw JSON tree.
"""

from __future__ import annotations

import html
import os

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
