"""Committed-baseline gating for repro-lint — the ``profilerd check`` of
static analysis; a copy of ``repro.analysis.baseline`` whose baselines are
labelled ``repro_torch``.

The baseline is a JSON document listing the finding keys the repo has
accepted (for a clean tree: none).  ``check`` re-runs the passes and fails
only on findings *not* in the baseline, so adopting the gate on a tree with
known debt is possible without ratcheting noise — and fixing debt shows up
as "fixed" keys the next ``--update`` drops.

Exit-code contract (shared with ``profilerd check`` so CI wiring is
uniform): 0 pass, 2 regression (new findings), 3 unreadable (missing or
malformed baseline, unparsable tree — never a vacuous pass).
"""

from __future__ import annotations

import json
import os
from typing import Any

from .lint import Finding, RepoIndex, run_passes

BASELINE_SCHEMA = "repro-analysis-baseline/v1"

EXIT_PASS = 0
EXIT_REGRESSION = 2
EXIT_UNREADABLE = 3


class BaselineError(RuntimeError):
    pass


def save_baseline(findings: list[Finding], path: str, *, root_label: str = "repro_torch") -> None:
    doc: dict[str, Any] = {
        "schema": BASELINE_SCHEMA,
        "root": root_label,
        "keys": sorted({f.key() for f in findings}),
    }
    tmp = f"{path}.tmp.{id(doc)}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)


def load_baseline(path: str) -> frozenset[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise BaselineError(f"{path}: unreadable baseline: {e}") from None
    except ValueError as e:
        raise BaselineError(f"{path}: malformed baseline: {e}") from None
    if not isinstance(doc, dict) or doc.get("schema") != BASELINE_SCHEMA:
        raise BaselineError(
            f"{path}: not an analysis baseline (expected schema {BASELINE_SCHEMA!r})"
        )
    keys = doc.get("keys")
    if not isinstance(keys, list) or not all(isinstance(k, str) for k in keys):
        raise BaselineError(f"{path}: malformed baseline: 'keys' must be a list of strings")
    return frozenset(keys)


def diff_baseline(
    findings: list[Finding], allowed: frozenset[str]
) -> tuple[list[Finding], list[str]]:
    """(new findings not in the baseline, baseline keys no longer found)."""
    seen = {f.key() for f in findings}
    new = [f for f in findings if f.key() not in allowed]
    fixed = sorted(allowed - seen)
    return new, fixed


def check(
    root: str, baseline_path: str, *, update: bool = False, only: str | None = None
) -> tuple[int, str]:
    """Run the passes against ``root`` and gate on the committed baseline.

    Returns (exit code, report text).  An empty or unparsable tree is
    "unreadable" (3), never a pass — the gate must not succeed vacuously
    because ``--root`` pointed somewhere empty.
    """
    try:
        index = RepoIndex.load(root)
    except (OSError, SyntaxError) as e:
        return EXIT_UNREADABLE, f"UNREADABLE: {e}"
    if not index.files:
        return EXIT_UNREADABLE, f"UNREADABLE: {root}: no python files to analyze"
    try:
        findings = run_passes(index, only=only)
    except ValueError as e:
        return EXIT_UNREADABLE, f"UNREADABLE: {e}"

    if update:
        save_baseline(findings, baseline_path)
        return EXIT_PASS, (
            f"baseline updated: {baseline_path} ({len(findings)} accepted finding(s))"
        )

    try:
        allowed = load_baseline(baseline_path)
    except BaselineError as e:
        return EXIT_UNREADABLE, f"UNREADABLE: {e}"
    new, fixed = diff_baseline(findings, allowed)
    lines = [
        f"repro-lint: {len(index.files)} files, {len(findings)} finding(s), "
        f"{len(allowed)} baselined, {len(new)} new, {len(fixed)} fixed"
    ]
    for f in new:
        lines.append(f"NEW: {f.render()}")
    for k in fixed:
        lines.append(f"FIXED (run check --update to drop from baseline): {k}")
    if new:
        lines.append("FAIL: new static-analysis findings vs baseline")
        return EXIT_REGRESSION, "\n".join(lines)
    lines.append("PASS")
    return EXIT_PASS, "\n".join(lines)


__all__ = [
    "BASELINE_SCHEMA",
    "BaselineError",
    "EXIT_PASS",
    "EXIT_REGRESSION",
    "EXIT_UNREADABLE",
    "check",
    "diff_baseline",
    "load_baseline",
    "save_baseline",
]
