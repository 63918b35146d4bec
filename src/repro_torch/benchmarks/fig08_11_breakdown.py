"""Figs. 8/9/11 analogue for the port: per-architecture-family decomposition
of one train step by component (the counterpart of the JAX package's
``benchmarks/fig08_11_breakdown.py``).

The paper breaks gem5 runtime down per CPU model and finds the breakdown
differentiates workloads only when the model is detailed enough. Here the
device tree of one profiled train step (``core/device_tree.py``) is split by
the JAX package's components for one arch of each family: each component's
share of the step's ``flops`` and, on the card, of its ``device_ms``, and the
step's device time in the forward (``jvp(loss)``), the backward
(``transpose(jvp(loss))``) and the optimizer.

On the CPU (``--device cpu``) it runs the smoke configs at B 2 x S 32, the
JAX benchmark's shape. On the card (the default) it runs ``chip_smoke.py``'s
train phases: full width, depth cut to fit one card's f32 state
(``CARD``), one warm-up step, then one profiled step.

  PYTHONPATH=src python -m repro_torch.benchmarks.fig08_11_breakdown --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.calltree import CallTree
from repro_torch.core.device_tree import build_device_tree, profiling
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule

FAMILIES = ["qwen3-4b", "deepseek-moe-16b", "recurrentgemma-9b", "xlstm-125m"]
COMPONENTS = ["attention", "mlp", "moe", "rg_lru", "recurrent", "mlstm", "slstm", "lm_head", "embed", "optimizer"]
SMOKE = {"B": 2, "S": 32}
# chip_smoke.py's train phases: (layers, B, S); None keeps the config's depth
CARD = {
    "qwen3-4b": (None, 1, 2048),
    "recurrentgemma-9b": (8, 1, 4096),
    "deepseek-moe-16b": (6, 1, 2048),
    "xlstm-125m": (None, 8, 512),
}
FORWARD, BACKWARD, OPTIMIZER = "jvp(loss)", "transpose(jvp(loss))", "optimizer"


def component_shares(tree: CallTree, metric: str, *, floor: float = 0.005) -> dict[str, float]:
    """Each component's share of the tree's ``metric`` (the JAX benchmark's
    rule: every node whose name starts with the component's, not counted
    twice below a match), those above ``floor``."""
    total = tree.total(metric)
    if total <= 0:
        return {}
    shares = {}
    for comp in COMPONENTS:
        s = tree.zoom(lambda n, c=comp: n.startswith(c)).total(metric) / total
        if s > floor:
            shares[comp] = s
    return shares


def step_split(tree: CallTree, metric: str = "device_ms") -> dict[str, float]:
    """``metric`` under the forward, the backward and the optimizer, and the rest of the step."""
    flat = tree.flatten(metric)
    out = {k: flat.get(name, 0.0) for k, name in (("forward", FORWARD), ("backward", BACKWARD),
                                                   ("optimizer", OPTIMIZER))}
    out["rest"] = tree.total(metric) - sum(out.values())
    return out


def train_batch(cfg, B: int, S: int, device, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)).to(device)
            for k in ("tokens", "labels")}


def profile_train_step(arch: str, device: str, *, smoke: bool, n_layers: int | None, B: int, S: int,
                       seed: int = 0) -> tuple[CallTree, float, object]:
    """One warm-up train step of ``arch``, then one profiled step -> (its
    device tree, its wall ms (synchronised), the config)."""
    cfg = get_config(arch, smoke=smoke)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(seed), train=True)
    opt = adamw_init(params)
    step = make_train_step(model, cosine_schedule(3e-4, warmup_steps=1, total_steps=100), AdamWConfig())
    params, opt, _ = step(params, opt, train_batch(cfg, B, S, model.device, seed))
    batch = train_batch(cfg, B, S, model.device, seed + 1)
    with profiling(model.device) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
    wall_ms = (time.perf_counter() - t0) * 1e3
    return build_device_tree(prof), wall_ms, cfg


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default: chip_smoke's train sizes) or cpu (smoke)")
    ap.add_argument("--arch", action="append", help="one of FAMILIES (repeatable; default: all four)")
    args = ap.parse_args(argv)
    smoke = torch.device(args.device).type == "cpu"
    rows = []
    for arch in args.arch or FAMILIES:
        n_layers, B, S = (None, SMOKE["B"], SMOKE["S"]) if smoke else CARD[arch]
        tree, wall_ms, _ = profile_train_step(arch, args.device, smoke=smoke, n_layers=n_layers, B=B, S=S)
        parts = [f"flops.{k}={v:.2f}" for k, v in component_shares(tree, "flops").items()]
        if tree.total("device_ms"):
            parts += [f"device.{k}={v:.2f}" for k, v in component_shares(tree, "device_ms").items()]
            parts += [f"split.{k}_ms={v:.1f}" for k, v in step_split(tree).items()]
        row = f"fig08_11_breakdown_{arch},{wall_ms * 1e3:.1f},{';'.join(parts)}"
        print(row, flush=True)
        rows.append(row)
        del tree
        if not smoke:
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
