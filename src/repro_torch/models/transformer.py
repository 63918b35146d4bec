"""Block assembly: pattern-cycled layers over a stacked leading axis + decode.

The parameter layout is the JAX package's: [prefix | n_units x pattern |
remainder], with the units' parameters stacked along a leading 'layers' axis.
The JAX ``lax.scan`` over that axis becomes a Python loop. This slice ports
the ``attn`` layer kind with a dense MLP; the other kinds raise.
"""

from __future__ import annotations

from typing import Any

import torch

from . import attention as attn_mod
from .mlp import mlp, mlp_spec
from .modules import rms_norm, rms_norm_spec, stack_specs

_NOT_PORTED = {
    "rec": "the recurrent block (recurrentgemma) is not ported yet: ROADMAP Queue 1 item 10",
    "slstm": "sLSTM (xlstm) is not ported yet: ROADMAP Queue 1 item 12",
    "mlstm": "mLSTM (xlstm) is not ported yet: ROADMAP Queue 1 item 12",
    "moe": "MoE feed-forward is not ported yet: ROADMAP Queue 1 item 11",
}


def _ffn_kind(cfg, layer_idx: int) -> str:
    if layer_idx < cfg.first_dense:
        return "dense_mlp"
    if cfg.n_experts:
        return "moe"
    if cfg.d_ff == 0:
        return "none"
    return "mlp"


def layer_kind(cfg, layer_idx: int) -> str:
    return cfg.pattern[layer_idx % len(cfg.pattern)]


def _check_ported(kind: str, ffn: str) -> None:
    for k in (kind, ffn):
        if k in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[k])
    if kind != "attn":
        raise ValueError(f"unknown layer kind {kind}")


def block_spec(cfg, kind: str, ffn: str) -> dict:
    _check_ported(kind, ffn)
    d = cfg.d_model
    spec: dict[str, Any] = {"norm1": rms_norm_spec(d), "attn": attn_mod.attention_spec(cfg)}
    if ffn == "mlp":
        spec["norm2"] = rms_norm_spec(d)
        spec["mlp"] = mlp_spec(d, cfg.d_ff)
    elif ffn == "dense_mlp":
        spec["norm2"] = rms_norm_spec(d)
        spec["mlp"] = mlp_spec(d, cfg.dense_d_ff or 4 * d)
    return spec


def block_apply(params, x: torch.Tensor, cfg, kind: str, ffn: str, positions: torch.Tensor) -> torch.Tensor:
    """One residual block (prefill)."""
    _check_ported(kind, ffn)
    h = rms_norm(params["norm1"], x)
    y = attn_mod.attention(params["attn"], h, cfg, positions, window=cfg.window)
    return _residual_ffn(params, x, y, cfg, ffn)


def block_decode(params, x: torch.Tensor, state, pos: int, cfg, kind: str, ffn: str):
    """One residual block, single-token decode. Returns (x, state)."""
    _check_ported(kind, ffn)
    h = rms_norm(params["norm1"], x)
    y, state = attn_mod.decode_attention(params["attn"], h, state, pos, cfg, window=cfg.window)
    return _residual_ffn(params, x, y, cfg, ffn), state


def _residual_ffn(params, x: torch.Tensor, y: torch.Tensor, cfg, ffn: str) -> torch.Tensor:
    """x + y, then the pre-MLP norm and the MLP residual.

    The norm reads the f32 sum, not the bf16 residual: compiled, the JAX
    package fuses ``rms_norm(x + y)`` and XLA keeps the sum in f32 (excess
    precision), while the residual stream itself is rounded to bf16. The
    norm's output is rounded to bf16 once, as there."""
    s = x.float() + y.float()
    x = s.to(x.dtype)
    if ffn in ("mlp", "dense_mlp"):
        x = x + mlp(params["mlp"], rms_norm(params["norm2"], s).to(x.dtype), act=cfg.act)
    return x


# ---------------------------------------------------------------------------
# Stack layout: prefix (unrolled) + stacked units + remainder (unrolled)
# ---------------------------------------------------------------------------


class StackLayout:
    """Partition of n_layers into [prefix | n_units x pattern | remainder]."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.prefix = list(range(cfg.first_dense))
        body = cfg.n_layers - cfg.first_dense
        p = len(cfg.pattern)
        self.n_units = body // p
        self.unit_kinds = tuple(cfg.pattern)
        rem = body % p
        self.remainder = [cfg.first_dense + self.n_units * p + i for i in range(rem)]
        self.rem_kinds = tuple(cfg.pattern[i] for i in range(rem))


def stack_spec(cfg) -> dict:
    lay = StackLayout(cfg)
    spec: dict[str, Any] = {}
    if lay.prefix:
        spec["prefix"] = {f"layer{i}": block_spec(cfg, layer_kind(cfg, i), _ffn_kind(cfg, i)) for i in lay.prefix}
    if lay.n_units:
        unit = {
            f"block{j}": block_spec(cfg, k, _ffn_kind(cfg, cfg.first_dense + j)) for j, k in enumerate(lay.unit_kinds)
        }
        spec["scan"] = stack_specs(unit, lay.n_units)
    if lay.remainder:
        spec["remainder"] = {
            f"layer{i}": block_spec(cfg, layer_kind(cfg, i), _ffn_kind(cfg, i)) for i in lay.remainder
        }
    return spec


def _unit(tree, i: int):
    """Slice unit ``i`` off the stacked leading axis. Matrix weights (>= 3-D
    when stacked) go to bf16, as the JAX package casts them before its scan;
    they are stored in bf16 already, so this is a view."""
    if isinstance(tree, dict):
        return {k: _unit(v, i) for k, v in tree.items()}
    a = tree[i]
    return a.to(torch.bfloat16) if (tree.dtype == torch.float32 and tree.ndim >= 3) else a


def stack_apply(params, x: torch.Tensor, cfg, positions: torch.Tensor) -> torch.Tensor:
    """Full layer stack forward."""
    lay = StackLayout(cfg)
    for i in lay.prefix:
        x = block_apply(params["prefix"][f"layer{i}"], x, cfg, layer_kind(cfg, i), _ffn_kind(cfg, i), positions)
    for u in range(lay.n_units):
        unit_params = _unit(params["scan"], u)
        for j, kind in enumerate(lay.unit_kinds):
            x = block_apply(unit_params[f"block{j}"], x, cfg, kind, _ffn_kind(cfg, cfg.first_dense + j), positions)
    for i in lay.remainder:
        x = block_apply(params["remainder"][f"layer{i}"], x, cfg, layer_kind(cfg, i), _ffn_kind(cfg, i), positions)
    return x


def stack_decode(params, x: torch.Tensor, states, pos: int, cfg):
    """Single-token decode through the stack. Returns (x, states); the caches
    in ``states`` are updated in place."""
    lay = StackLayout(cfg)
    for i in lay.prefix:
        key = f"layer{i}"
        x, _ = block_decode(
            params["prefix"][key], x, states["prefix"][key], pos, cfg, layer_kind(cfg, i), _ffn_kind(cfg, i)
        )
    for u in range(lay.n_units):
        unit_params = _unit(params["scan"], u)
        for j, kind in enumerate(lay.unit_kinds):
            key = f"block{j}"
            unit_state = {name: t[u] for name, t in states["scan"][key].items()}  # views into the stacked cache
            x, _ = block_decode(unit_params[key], x, unit_state, pos, cfg, kind, _ffn_kind(cfg, cfg.first_dense + j))
    for i in lay.remainder:
        key = f"layer{i}"
        x, _ = block_decode(
            params["remainder"][key], x, states["remainder"][key], pos, cfg, layer_kind(cfg, i), _ffn_kind(cfg, i)
        )
    return x, states


def stack_state(cfg, batch: int, max_len: int, device) -> dict:
    """Decode-state tree matching the params layout."""
    lay = StackLayout(cfg)
    for kind in set(cfg.pattern):
        _check_ported(kind, "none")
    states: dict[str, Any] = {}
    if lay.prefix:
        states["prefix"] = {f"layer{i}": attn_mod.init_kv_cache(cfg, batch, max_len, device) for i in lay.prefix}
    if lay.n_units:
        states["scan"] = {
            f"block{j}": {
                name: t.new_zeros((lay.n_units, *t.shape))
                for name, t in attn_mod.init_kv_cache(cfg, batch, max_len, device).items()
            }
            for j in range(len(lay.unit_kinds))
        }
    if lay.remainder:
        states["remainder"] = {
            f"layer{i}": attn_mod.init_kv_cache(cfg, batch, max_len, device) for i in lay.remainder
        }
    return states
