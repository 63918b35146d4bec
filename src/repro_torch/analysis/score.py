"""Precision/recall scoring of the lint passes against seeded fixtures; a
copy of ``repro.analysis.score``.

Every pass ships a fixture tree under ``tests/data/analysis_fixtures_torch/<pass>/``
containing exactly the violation the pass exists to catch.  The scorer runs
each pass over its own fixture (recall: the seeded violation must be found)
and the full pass set over the clean repo (precision: a clean tree yields
zero findings).  CI runs this nightly; a pass that stops catching its own
fixture — or starts flagging healthy code — fails the matrix.
"""

from __future__ import annotations

import os
from typing import Any

from .lint import PASSES, RepoIndex, run_passes

SCORE_SCHEMA = "repro-analysis-score/v1"


def score_fixtures(fixtures_dir: str, clean_root: str) -> dict[str, Any]:
    """Build the matrix; ``ok`` is the CI gate verdict."""
    clean_index = RepoIndex.load(clean_root)
    clean_findings = run_passes(clean_index)
    clean_by_pass: dict[str, int] = {}
    for f in clean_findings:
        clean_by_pass[f.pass_id] = clean_by_pass.get(f.pass_id, 0) + 1

    matrix: dict[str, Any] = {}
    ok = True
    for p in PASSES:
        fdir = os.path.join(fixtures_dir, p.id)
        row: dict[str, Any] = {
            "description": p.description,
            "clean_findings": clean_by_pass.get(p.id, 0),
            "precision": 1.0 if clean_by_pass.get(p.id, 0) == 0 else 0.0,
        }
        if not os.path.isdir(fdir):
            row.update({"fixture": False, "seeded_found": 0, "recall": 0.0})
            ok = False
        else:
            index = RepoIndex.load(fdir)
            own = run_passes(index, only=p.id)
            row.update(
                {
                    "fixture": True,
                    "seeded_found": len(own),
                    "recall": 1.0 if own else 0.0,
                    "findings": [f.render() for f in own],
                }
            )
            if not own:
                ok = False
        if row["precision"] < 1.0:
            ok = False
        matrix[p.id] = row
    return {
        "schema": SCORE_SCHEMA,
        "fixtures_dir": fixtures_dir,
        "clean_root": os.path.basename(os.path.abspath(clean_root)),
        "passes": matrix,
        "clean_total": len(clean_findings),
        "ok": ok,
    }


def render_score(score: dict[str, Any]) -> str:
    lines = [f"{'pass':<20} {'recall':>6} {'precision':>9}  seeded/clean"]
    for pid, row in score["passes"].items():
        lines.append(
            f"{pid:<20} {row['recall']:>6.1f} {row['precision']:>9.1f}  "
            f"{row['seeded_found']}/{row['clean_findings']}"
            + ("" if row.get("fixture") else "  (MISSING FIXTURE)")
        )
    lines.append("OK" if score["ok"] else "FAIL: recall or precision below 1.0")
    return "\n".join(lines)


__all__ = ["SCORE_SCHEMA", "render_score", "score_fixtures"]
