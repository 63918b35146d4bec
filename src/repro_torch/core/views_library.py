"""Predefined exploration views (artifact §G: the paper ships 125 parser
configs — root function, fold level, white/blacklists, plot knobs).

These are the curated equivalents for this framework's component vocabulary,
usable against either profiling plane:

    from repro_torch.core.views_library import VIEWS, render_view
    print(render_view(tree, "attention_internals", metric="flops"))

Each view is a :class:`~repro_torch.core.report.ViewConfig`; ``save_views`` writes
the whole library as CSVs next to a run's reports.

A copy of ``repro.core.views_library``, the same views but one:
``host_dispatch_noise`` keeps the framework's dispatch frames, which the
port's sampler classifies as ``torch::`` where the JAX package's are
``jax::``.
"""

from __future__ import annotations

from .calltree import CallTree
from .report import ViewConfig

VIEWS: dict[str, ViewConfig] = {
    v.name: v
    for v in [
        # ---- holistic (zoom-out) --------------------------------------------------
        ViewConfig(name="top_level", level=2),
        ViewConfig(name="train_step_phases", root="train_step", level=2),
        ViewConfig(name="serve_step_phases", root="serve_step", level=2),
        ViewConfig(name="model_components", root="model", level=3),
        # ---- per-component (zoom-in) ---------------------------------------------
        ViewConfig(name="attention_internals", root="attention", level=-1),
        ViewConfig(name="attention_scores_only", root="attention", whitelist=["scores", "chunk_scores"]),
        ViewConfig(name="moe_internals", root="moe", level=2),
        ViewConfig(name="moe_dispatch_combine", root="moe", whitelist=["dispatch", "combine", "a2a"]),
        ViewConfig(name="recurrent_internals", root="recurrent_block", level=-1),
        ViewConfig(name="rglru_scan", root="rg_lru", level=-1),
        ViewConfig(name="mlstm_internals", root="mlstm", level=2),
        ViewConfig(name="optimizer", root="optimizer", level=2),
        ViewConfig(name="lm_head_and_loss", root="loss", level=2),
        # ---- cost-specific -------------------------------------------------------
        ViewConfig(name="collectives_by_site", metric="coll_bytes", level=-1, min_share=0.01),
        ViewConfig(name="memory_traffic_hotspots", metric="bytes", level=6, min_share=0.02),
        ViewConfig(name="flops_by_layer_stage", metric="flops", level=5, min_share=0.02),
        # ---- host plane ----------------------------------------------------------
        ViewConfig(name="host_threads", level=1),
        ViewConfig(name="host_data_pipeline", root="_prefetch_worker", level=-1),
        ViewConfig(name="host_dispatch_noise", whitelist=["torch::"], level=-1),
        ViewConfig(name="host_checkpoint_writer", root="repro-ckpt", level=-1),
        # ---- anomaly forensics (what the detector saw) ----------------------------
        ViewConfig(name="dominant_leaves", level=-1, min_share=0.10),
        # ---- timeline / differential -----------------------------------------------
        # Applied to one sealed epoch *window* (not the cumulative tree):
        ViewConfig(name="epoch_window_hotspots", level=-1, min_share=0.05),
        ViewConfig(name="epoch_window_phases", level=2),
        # Applied to a cross-run diff context before rendering share deltas:
        ViewConfig(name="diff_regression_context", level=4, min_share=0.01),
    ]
}


# -- timeline views (epoch sequences, not single trees) ----------------------


def epoch_share_vectors(epochs, metric: str = "samples") -> list[dict[str, float]]:
    """Flattened share vector per sealed epoch window (phase-segmentation input)."""
    from .detector import flat_shares

    return [flat_shares(window, metric) for _meta, window, _cum in epochs]


def timeline_table(epochs, metric: str = "samples", k: int = 1) -> str:
    """One line per sealed epoch: when, how much activity, where it went."""
    lines = [f"{'epoch':>5}  {'wall_time':>13}  {'window':>9}  {'progress':>8}  top self path"]
    for meta, window, _cum in epochs:
        tops = window.hot_paths(metric, k=k, self_only=True)
        top = "/".join(tops[0][0]) + f" ({tops[0][1]:.0%})" if tops else "-"
        lines.append(
            f"{meta.epoch:>5}  {meta.wall_time:>13.2f}  {window.total(metric):>9.6g}  "
            f"{meta.progress:>8.6g}  {top}"
        )
    return "\n".join(lines)


def phase_table(epochs, boundary: float = 0.25, metric: str = "samples", k: int = 3) -> str:
    """Phase segmentation over sealed epochs (the paper's time-evolution view).

    Splits the epoch sequence wherever the window share distribution jumps by
    more than ``boundary`` (TV distance) and summarizes each phase's top
    self-time functions — "when did the behavior change, and into what".
    """
    from .detector import segment_phases
    from .report import name_shares

    if not epochs:
        return "# empty timeline"
    vectors = epoch_share_vectors(epochs, metric)
    lines = [f"# {len(epochs)} epoch(s), boundary={boundary}"]
    for start, end in segment_phases(vectors, boundary):
        merged = CallTree()
        wall0 = epochs[start][0].wall_time
        wall1 = epochs[end][0].wall_time
        for _meta, window, _cum in epochs[start : end + 1]:
            merged.merge(window)  # merge only reads its argument
        top = sorted(name_shares(merged, metric).items(), key=lambda kv: -kv[1])[:k]
        summary = ", ".join(f"{name} {share:.0%}" for name, share in top) or "-"
        lines.append(
            f"phase epochs {epochs[start][0].epoch}..{epochs[end][0].epoch} "
            f"({max(0.0, wall1 - wall0):.1f}s, {merged.total(metric):.6g} {metric}): {summary}"
        )
    return "\n".join(lines)


def render_view(tree: CallTree, name: str, metric: str | None = None) -> str:
    cfg = VIEWS[name]
    if metric is not None:
        from dataclasses import replace

        cfg = replace(cfg, metric=metric)
    return cfg.to_csv(tree)


def export_view(tree: CallTree, name: str, fmt: str = "csv", metric: str | None = None) -> str:
    """Render a library view in any export format (folded/speedscope/html/...).

    The format-agnostic sibling of :func:`render_view`: the whole 20+ view
    library becomes flamegraph/speedscope material through one call.
    """
    from .export import export_tree

    return export_tree(tree, fmt, view=name, metric=metric, title=name)


def list_views() -> list[str]:
    return sorted(VIEWS)
