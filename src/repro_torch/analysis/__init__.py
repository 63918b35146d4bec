"""repro_torch.analysis — the static dual of the sampled profile, a copy of
``repro.analysis`` for the port.

AST-based static call-graph extraction (``/tree?plane=static``), the
repro-lint invariant passes (six carried over as they are, ``scope-coverage``
rewritten for the port's ``scope`` ranges), profile-coverage cross-joins,
and the ``check --baseline`` CI gate.  Pure stdlib on top of
``repro_torch.core.calltree``: no torch, no numpy.

Exports are lazy (PEP 562), mirroring ``repro_torch.core``: importing the
package costs nothing until a symbol is touched, so the profiling plane's
millisecond-import budget is unaffected.
"""

from __future__ import annotations

_EXPORTS = {
    "STATIC_TREE_SCHEMA": ".static_tree",
    "STATIC_TREE_FILENAME": ".static_tree",
    "save_static_tree": ".static_tree",
    "load_static_tree": ".static_tree",
    "static_meta": ".static_tree",
    "StaticGraph": ".extract",
    "DefSite": ".extract",
    "extract_static_graph": ".extract",
    "extract_to_file": ".extract",
    "default_package_root": ".extract",
    "SYNTHETIC_NAMES": ".extract",
    "COVERAGE_SCHEMA": ".coverage",
    "coverage_report": ".coverage",
    "coverage_tree": ".coverage",
    "render_coverage": ".coverage",
    "Finding": ".lint",
    "LintPass": ".lint",
    "PASSES": ".lint",
    "PASS_IDS": ".lint",
    "RepoIndex": ".lint",
    "run_passes": ".lint",
    "BASELINE_SCHEMA": ".baseline",
    "check": ".baseline",
    "load_baseline": ".baseline",
    "save_baseline": ".baseline",
    "score_fixtures": ".score",
    "render_score": ".score",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(mod, __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
