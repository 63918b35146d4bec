"""Profile coverage: cross-join the static call graph with a sampled profile;
a copy of ``repro.analysis.coverage``, the same report and schema.

Two asymmetric questions, one report:

* **Cold defs** — functions the extractor can see but the profiler never
  sampled (zero dynamic mass).  Blind spot or dead weight; either way the
  flamegraph silently says nothing about them.
* **Symbolization drift** — sampled ``repro::`` frames whose ``co_name``
  maps to no known def.  A def was renamed/deleted after the profile (or
  the static artifact) was taken: the sample did NOT vanish, it just no
  longer joins, and this report is where that surfaces.

The join key is the resolver's own symbol scheme: a sampled repo frame is
``repro::<co_name>`` and the extractor names def nodes identically, so a
flatten-view name match needs no heuristics.  Interpreter-synthetic names
(``<module>``, ``<lambda>``, ...) and origin-collapse stars are excluded
from drift — they are real samples but never defs.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.calltree import CallTree

from .extract import DEFS, SYNTHETIC_NAMES, StaticGraph

COVERAGE_SCHEMA = "repro-coverage-report/v1"

_REPRO = "repro::"


def _static_def_masses(static: CallTree) -> dict[str, float]:
    """name -> def count, from the static plane's flatten view (call-edge
    child nodes flatten to 0.0 defs and are dropped)."""
    return {
        name[len(_REPRO):]: v
        for name, v in static.flatten(DEFS).items()
        if name.startswith(_REPRO) and v > 0.0
    }


def _dynamic_repro_masses(dynamic: CallTree, metric: str) -> dict[str, float]:
    out: dict[str, float] = {}
    for name, v in dynamic.flatten(metric).items():
        if not name.startswith(_REPRO) or v <= 0.0:
            continue
        short = name[len(_REPRO):]
        if short == "*" or short in SYNTHETIC_NAMES:
            continue
        out[short] = out.get(short, 0.0) + v
    return out


def coverage_report(
    static: StaticGraph | CallTree,
    dynamic: CallTree,
    *,
    metric: str = "samples",
) -> dict[str, Any]:
    """Build the cross-join report (JSON-serializable).

    ``static`` may be a live :class:`StaticGraph` (cold entries then carry
    def sites) or a bare static-plane tree loaded from ``static_tree.json``.
    """
    graph = static if isinstance(static, StaticGraph) else None
    tree = static.tree if graph is not None else static
    def_masses = _static_def_masses(tree)
    dyn = _dynamic_repro_masses(dynamic, metric)

    sites: dict[str, Any] = {}
    if graph is not None:
        for d in graph.defs:
            sites.setdefault(d.name, {"qualname": d.qualname, "path": d.relpath, "line": d.line})

    cold = []
    covered = []
    for name in sorted(def_masses):
        entry: dict[str, Any] = {"name": name, "defs": def_masses[name]}
        if name in sites:
            entry.update(sites[name])
        if dyn.get(name, 0.0) > 0.0:
            entry["mass"] = dyn[name]
            covered.append(entry)
        else:
            cold.append(entry)
    drift = [
        {"name": name, "mass": mass}
        for name, mass in sorted(dyn.items(), key=lambda kv: (-kv[1], kv[0]))
        if name not in def_masses
    ]
    n_defs = len(def_masses)
    return {
        "schema": COVERAGE_SCHEMA,
        "metric": metric,
        "defs": n_defs,
        "covered": len(covered),
        "cold": cold,
        "drift": drift,
        "coverage": (len(covered) / n_defs) if n_defs else 0.0,
        "hot": sorted(covered, key=lambda e: (-e["mass"], e["name"]))[:10],
    }


def coverage_tree(report: dict[str, Any]) -> CallTree:
    """Fold the report into a CallTree so it round-trips through every
    export format (folded, html, speedscope) like any other profile."""
    tree = CallTree()
    for entry in report.get("cold", []):
        tree.add_stack(["coverage::cold", f"repro::{entry['name']}"], {"samples": 1.0, DEFS: entry.get("defs", 1.0)})
    for entry in report.get("drift", []):
        tree.add_stack(["coverage::drift", f"repro::{entry['name']}"], {"samples": entry["mass"]})
    for entry in report.get("hot", []):
        tree.add_stack(["coverage::covered", f"repro::{entry['name']}"], {"samples": entry["mass"], DEFS: entry.get("defs", 1.0)})
    return tree


def render_coverage(report: dict[str, Any], *, limit: int = 20) -> str:
    """Terminal rendering (what ``python -m repro_torch.analysis coverage`` prints)."""
    lines = [
        f"profile coverage: {report['covered']}/{report['defs']} defs sampled "
        f"({report['coverage']:.1%}, metric={report['metric']})"
    ]
    cold = report["cold"]
    lines.append(f"cold defs (statically reachable, zero dynamic mass): {len(cold)}")
    for entry in cold[:limit]:
        where = f"  {entry['qualname']} ({entry['path']}:{entry['line']})" if "qualname" in entry else f"  {entry['name']}"
        lines.append(where)
    if len(cold) > limit:
        lines.append(f"  ... {len(cold) - limit} more")
    drift = report["drift"]
    lines.append(f"symbolization drift (sampled frames with no known def): {len(drift)}")
    for entry in drift[:limit]:
        lines.append(f"  repro::{entry['name']}  mass={entry['mass']:g}")
    if len(drift) > limit:
        lines.append(f"  ... {len(drift) - limit} more")
    return "\n".join(lines)


__all__ = [
    "COVERAGE_SCHEMA",
    "coverage_report",
    "coverage_tree",
    "render_coverage",
]
