"""Figs. 10/12 analogue for the port: zoom-in views (the counterpart of the
JAX package's ``benchmarks/fig10_12_zoom.py``). The paper zooms from
model-level breakdowns into the L1/L2 cache controllers and the fetch stage;
here the same tree zooms into attention internals and MoE internals
(router/dispatch/experts/combine).

The JAX zooms read the compiled HLO tree of a train step; the port's read the
device tree of one profiled train step (``core/device_tree.py``) through the
same ``CallTree.zoom``. The port's attention runs the scores and the PV
product in one kernel, under its wrapper's ``flash_attention`` range, where
the JAX xla path has ``scores`` and ``pv``: the attention row names it.

``--device cpu`` profiles the smoke configs at B 2 x S 32, the JAX
benchmark's shape; the card (the default) ``fig08_11_breakdown.CARD``'s
train setups (qwen3-4b at 1 x 2048, deepseek-moe-16b at full width cut to 6
layers).

  PYTHONPATH=src python -m repro_torch.benchmarks.fig10_12_zoom [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.calltree import CallTree

from .common import row
from .fig08_11_breakdown import CARD, SMOKE, profile_train_step

ATTENTION_PARTS = ("qkv_proj", "scores", "chunk_scores", "pv", "chunk_pv", "flash_attention", "out_proj", "rope")
MOE_PARTS = ("router", "dispatch", "experts", "combine", "shared_experts", "aux_loss")


def _zoom_row(name: str, zoomed: CallTree, parts: tuple[str, ...], metric: str) -> str:
    total = max(zoomed.total(metric), 1e-9)
    shares = []
    for sub in parts:
        z = zoomed.zoom(sub)
        if z.total(metric) / total > 0.005:
            shares.append(f"{sub}={z.total(metric)/total:.2f}")
    return row(name, 0.0, ";".join(shares))


def attention_row(tree: CallTree) -> str:
    """Zoom one: the attention internals of a dense arch, by flops."""
    return _zoom_row("fig10_zoom_attention_qwen3", tree.zoom("attention"), ATTENTION_PARTS, "flops")


def moe_row(tree: CallTree) -> str:
    """Zoom two: the MoE internals, by ops."""
    return _zoom_row("fig12_zoom_moe_deepseek", tree.zoom("moe"), MOE_PARTS, "ops")


def _tree(arch: str, device: str) -> CallTree:
    smoke = torch.device(device).type == "cpu"
    n_layers, B, S = (None, SMOKE["B"], SMOKE["S"]) if smoke else CARD[arch]
    return profile_train_step(arch, device, smoke=smoke, n_layers=n_layers, B=B, S=S)[0]


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default: chip_smoke's train sizes) or cpu (smoke)")
    args = ap.parse_args(argv)
    out = [attention_row(_tree("qwen3-4b", args.device))]
    if torch.device(args.device).type == "cuda":
        torch.cuda.empty_cache()
    out.append(moe_row(_tree("deepseek-moe-16b", args.device)))
    return out


if __name__ == "__main__":
    for r in main():
        print(r)
