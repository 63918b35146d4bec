"""Fig. 1 analogue for the port: execution-engine comparison (AS/TS/O3 ->
eager/blockwise/compiled) for the same model, profiled by the same external
sampler (the counterpart of the JAX package's ``benchmarks/fig01_engines.py``).

Reports tokens/host-second per engine plus the share of host samples whose
leaf frame is torch's — the "bookkeeping frames dominate" observation (paper
§II-B: ~20 pybind frames per gem5 stack <-> torch dispatch frames here). The
engines are ``core/engines.py``'s: eager is PyTorch's op-by-op dispatch;
blockwise captures each stage (embed, each layer's ``block_apply``, the head
with cross-entropy) into a CUDA graph of its own and synchronises between
them; compiled captures the whole loss into one graph. The capture happens
inside the timed window, as JAX's compile does: over ``STEPS`` the graph
engines pay it once.

As in the JAX benchmark, the blockwise head computes the cross-entropy only,
where eager and compiled run ``Model.loss``, which adds the z-loss: the
blockwise loss differs from the other two (in the JAX package as well).

The graph engines take the weights as donated (``donate_argnums=(0,)``):
their graphs read the weights where they lie, as JAX's ``jit`` reads its
argument's buffers; without it every step would copy the weights into the
graph's static buffer.

``--device cpu`` runs the smoke config, where the engines run their protocol
without a graph; the default, the card, runs qwen3-4b at full width and
depth (36 layers, 8.8 GB of bf16 weights).

  PYTHONPATH=src python -m repro_torch.benchmarks.fig01_engines [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import BlockwiseEngine, CompiledEngine, EagerEngine, SamplerConfig, StackSampler
from repro_torch.core.engines import Engine
from repro_torch.models import Model
from repro_torch.models.modules import embed, rms_norm
from repro_torch.models.transformer import _ffn_kind, _unit, block_apply

from .common import row

ARCH = "qwen3-4b"
B, S, STEPS = 2, 64, 3
PERIOD_S = 0.02


def make_batch(cfg, device, seed: int = 0) -> dict:
    """The benchmark's tokens and labels, B x S, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)).to(device)
            for k in ("tokens", "labels")}


def make_fns(model: Model, params: dict, batch: dict) -> tuple[Callable, list[Callable]]:
    """-> (the full loss of ``params``, the blockwise stages over ``params``):
    the JAX benchmark's functions. Autograd records nothing (the forward
    only, as JAX's)."""
    cfg = model.cfg
    tokens, labels = batch["tokens"], batch["labels"]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)

    @torch.no_grad()
    def full_loss(p):
        return model.loss(p, batch)[0]

    # blockwise stages with REAL math: embed -> layer_j... -> head+CE
    @torch.no_grad()
    def stage_embed(_):
        return embed(params["embed"], tokens).to(torch.bfloat16)

    def make_layer_stage(j):
        @torch.no_grad()
        def stage(x):
            unit = _unit(params["layers"]["scan"], j)
            h, _, _ = block_apply(unit["block0"], x, cfg, "attn", _ffn_kind(cfg, 0), positions, scope=f"layer{j}")
            return h

        return stage

    @torch.no_grad()
    def stage_head(x):
        x = rms_norm(params["final_norm"], x, scope="final_norm")
        logits = model.logits_fn(params, x)
        lsm = torch.log_softmax(logits.float(), -1)
        return -lsm.gather(-1, labels.long()[..., None]).mean()

    n_units = params["layers"]["scan"]["block0"]["norm1"]["scale"].shape[0]
    return full_loss, [stage_embed] + [make_layer_stage(j) for j in range(n_units)] + [stage_head]


def make_engines(full_loss: Callable, stages: list[Callable]) -> list[Engine]:
    return [EagerEngine(full_loss), BlockwiseEngine(stages, donate_argnums=(0,)),
            CompiledEngine(full_loss, donate_argnums=(0,))]


def setup(device: str | torch.device, *, smoke: bool, n_layers: int | None = None, seed: int = 0):
    """-> (model, params drawn from ``seed``, batch) of qwen3-4b, its smoke
    config with ``smoke``, cut to ``n_layers`` where given."""
    cfg = get_config(ARCH, smoke=smoke)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(seed))
    return model, params, make_batch(cfg, model.device, seed + 1)


def torch_frame_share(tree) -> float:
    """The share of samples whose *leaf* frame is torch-internal (dispatch etc.)."""
    total = max(tree.total(), 1)
    return sum(n.self_metrics.get("samples", 0.0) for _, n in tree.root.walk() if n.name.startswith("torch::")) / total


def run_engine(eng: Engine, params: dict, steps: int = STEPS, period_s: float | None = PERIOD_S) -> dict:
    """``steps`` steps of ``eng`` on ``params`` under a fresh thread sampler
    (none with ``period_s`` None) -> wall, tokens/s, the torch frame share,
    whether it ran a CUDA graph, and its last loss."""
    sampler = StackSampler(SamplerConfig(period_s=period_s)).start() if period_s else None
    res = eng.run(steps, lambda i: (params,))
    tree = sampler.stop() if sampler else None
    return {"engine": eng.name, "steps": steps, "wall_s": res.wall_s, "us_per_step": res.wall_s / steps * 1e6,
            "tokens_per_s": B * S * steps / res.wall_s, "captured": eng.captured,
            "torch_frame_share": torch_frame_share(tree) if tree else None, "loss": float(res.outputs)}


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default: qwen3-4b at full size) or cpu (smoke)")
    args = ap.parse_args(argv)
    model, params, batch = setup(args.device, smoke=torch.device(args.device).type == "cpu")
    out = []
    for eng in make_engines(*make_fns(model, params, batch)):
        r = run_engine(eng, params)
        out.append(row(
            f"fig01_engine_{eng.name}",
            r["us_per_step"],
            f"tokens_per_s={r['tokens_per_s']:.0f};torch_frame_share={r['torch_frame_share']:.2f}",
        ))
    return out


if __name__ == "__main__":
    for r in main():
        print(r)
