"""Block assembly: pattern-cycled layers over a stacked leading axis + decode.

The parameter layout is the JAX package's: [prefix | n_units x pattern |
remainder], with the units' parameters stacked along a leading 'layers' axis.
The JAX ``lax.scan`` over that axis becomes a Python loop. The port has every
layer kind of the JAX package: ``attn``, ``rec`` (Griffin recurrent block) and
the xLSTM cells ``slstm`` and ``mlstm``, each with a dense MLP, an MoE or no
feed-forward (``d_ff = 0``: the block is the cell's residual add alone).

Under autograd each stacked unit runs as ``cfg.remat`` says, the counterpart
of the JAX package's ``jax.checkpoint`` around its scan body: ``"none"``
stores every activation, ``"full"`` stores only the unit's input and
recomputes the rest in the backward pass, ``"dots"`` stores the outputs of
the matrix products (``aten.mm``: the counterpart of
``dots_with_no_batch_dims_saveable``: the router's product is saved, the
experts' batched products, ``aten.bmm``, are not) and recomputes the rest.

Scopes are the JAX package's: ``layer{i}`` for a prefix or remainder layer,
``layers`` around the stacked units and ``unit_block{j}_{kind}`` /
``block{j}`` for each block of a unit; a checkpointed unit runs under
``checkpoint``, the name the JAX package's remat gives its backward
(``core/device_tree.py`` drops it from the forward, as the JAX tree has it).
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.core.scope import scope as _scope
from repro_torch.sharding.ctx import shard_activation

from . import attention as attn_mod
from . import rglru as rec_mod
from . import xlstm as xlstm_mod
from .mlp import mlp, mlp_spec
from .moe import moe, moe_spec
from .modules import rms_norm, rms_norm_spec, stack_specs


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


_SPECS = {  # layer kind -> its parameters, under the kind's name
    "attn": attn_mod.attention_spec,
    "rec": rec_mod.recurrent_block_spec,
    "slstm": xlstm_mod.slstm_spec,
    "mlstm": xlstm_mod.mlstm_spec,
}


def _check_kind(kind: str) -> None:
    if kind not in _SPECS:
        raise ValueError(f"unknown layer kind {kind}")


def block_spec(cfg, kind: str, ffn: str) -> dict:
    _check_kind(kind)
    d = cfg.d_model
    spec: dict[str, Any] = {"norm1": rms_norm_spec(d), kind: _SPECS[kind](cfg)}
    if ffn == "mlp":
        spec["norm2"] = rms_norm_spec(d)
        spec["mlp"] = mlp_spec(d, cfg.d_ff)
    elif ffn == "dense_mlp":
        spec["norm2"] = rms_norm_spec(d)
        spec["mlp"] = mlp_spec(d, cfg.dense_d_ff or 4 * d)
    elif ffn == "moe":
        spec["norm2"] = rms_norm_spec(d)
        spec["moe"] = moe_spec(cfg)
    return spec


def block_apply(
    params, x: torch.Tensor, cfg, kind: str, ffn: str, positions: torch.Tensor, x_sum: torch.Tensor | None = None,
    *, scope: str = "block",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """One residual block (prefill). ``x_sum`` is x before its rounding to
    bf16, where the previous block's residual sum reaches this block's norm
    unrounded (see :func:`stack_apply`). Returns (x, x_sum) for the next
    block and the MoE load-balance loss (None without an MoE)."""
    _check_kind(kind)
    with _scope(scope):
        h = rms_norm(params["norm1"], x if x_sum is None else x_sum, scope="pre_norm").to(x.dtype)
        if kind == "attn":
            y = attn_mod.attention(params["attn"], h, cfg, positions, window=cfg.window)
        elif kind == "rec":
            y = rec_mod.recurrent_block(params["rec"], h, cfg)
        elif kind == "slstm":
            y, _ = xlstm_mod.slstm(params["slstm"], h, cfg)
        else:
            y, _ = xlstm_mod.mlstm(params["mlstm"], h, cfg)
        return _residual_ffn(params, x, y, cfg, ffn)


def block_decode(
    params, x: torch.Tensor, state, pos: int, cfg, kind: str, ffn: str, x_sum: torch.Tensor | None = None,
    *, scope: str = "block",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One residual block, single-token decode, as :func:`block_apply`
    (-> (x, x_sum)). The layer's state (KV cache; conv window and h; the
    xLSTM cell's) is updated in place. An MoE routes the B tokens of the step
    as one batch."""
    _check_kind(kind)
    with _scope(scope):
        h = rms_norm(params["norm1"], x if x_sum is None else x_sum, scope="pre_norm").to(x.dtype)
        if kind == "attn":
            y, _ = attn_mod.decode_attention(params["attn"], h, state, pos, cfg, window=cfg.window)
        elif kind == "rec":
            y, _ = rec_mod.recurrent_block_step(params["rec"], h, state, cfg)
        elif kind == "slstm":
            y, _ = xlstm_mod.slstm_step(params["slstm"], h, state, cfg)
        else:
            y, _ = xlstm_mod.mlstm_step(params["mlstm"], h, state, cfg)
        return _residual_ffn(params, x, y, cfg, ffn)[:2]


def _residual_ffn(
    params, x: torch.Tensor, y: torch.Tensor, cfg, ffn: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """x + y, then the pre-MLP (or pre-MoE) norm and the feed-forward's
    residual. -> (x, x_sum, lb): the new residual in bf16, the f32 sum it was
    rounded from, and the MoE's load-balance loss (None without one).

    The norm reads the f32 sum, not the bf16 residual: compiled, the JAX
    package fuses ``rms_norm(x + y)`` and XLA keeps the sum in f32 (excess
    precision), while the residual stream itself is rounded to bf16. The
    norm's output is rounded to bf16 once, as there."""
    s = x.float() + y.float()
    x = shard_activation(s.to(x.dtype), ("batch", None, None))
    lb = None
    if ffn in ("mlp", "dense_mlp"):
        y = mlp(params["mlp"], rms_norm(params["norm2"], s, scope="pre_mlp_norm").to(x.dtype), act=cfg.act)
    elif ffn == "moe":
        y, aux = moe(params["moe"], rms_norm(params["norm2"], s, scope="pre_moe_norm").to(x.dtype), cfg)
        lb = aux["lb_loss"]
    else:
        return x, s, lb
    s = x.float() + y.float()
    return shard_activation(s.to(x.dtype), ("batch", None, None)), s, lb


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


def stack_grad_leaves(params, grads, leaf):
    """The layer stack's params tree for one backward pass: ``leaf(p, g)`` for
    each tensor ``p`` and its gradient buffer ``g`` (``grads``, the same
    structure), where the stacked units' weights (``params["scan"]``) become
    lists of per-unit ``leaf(p[u], g[u])``, views of one slice each: autograd
    would otherwise turn each unit's gradient of a slice into a zero tensor
    the size of the whole stack. ``_unit`` reads either form."""

    def tree(p, g, stacked: bool):
        if isinstance(p, dict):
            return {k: tree(p[k], g[k], stacked) for k in p}
        return [leaf(p[u], g[u]) for u in range(p.shape[0])] if stacked else leaf(p, g)

    return {n: tree(v, grads[n], n == "scan") for n, v in params.items()}


def _unit(tree, i: int):
    """Unit ``i`` of the stacked units: a slice of each stacked tensor, or
    element ``i`` where a leaf is a list of per-unit tensors
    (``stack_grad_leaves``). Matrix weights (>= 2-D per unit)
    go to bf16, as the JAX package casts them before its scan; for inference
    they are stored in bf16 already, so this is a view."""
    if isinstance(tree, dict):
        return {k: _unit(v, i) for k, v in tree.items()}
    a = tree[i]
    return a.to(torch.bfloat16) if (a.dtype == torch.float32 and a.ndim >= 2) else a


def _unit_apply(scan_params, u: int, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Stacked unit ``u``, its weights sliced and cast inside, so that a
    checkpoint recomputes the bf16 copies instead of storing them. The f32
    residual sum is handed from block to block within the unit and returned
    with x, and the unit's load-balance losses are summed in block order
    (-> (x, x_sum, lb), lb None without an MoE)."""
    lay = StackLayout(cfg)
    unit_params = _unit(scan_params, u)
    x_sum, lb = None, None
    for j, kind in enumerate(lay.unit_kinds):
        with _scope(f"unit_block{j}_{kind}"):
            x, x_sum, block_lb = block_apply(unit_params[f"block{j}"], x, cfg, kind,
                                             _ffn_kind(cfg, cfg.first_dense + j), positions, x_sum, scope=f"block{j}")
        lb = _add_lb(lb, block_lb)
    return x, x_sum, lb


def _add_lb(total: torch.Tensor | None, lb: torch.Tensor | None) -> torch.Tensor | None:
    return lb if total is None else total if lb is None else total + lb


_MATMULS = (torch.ops.aten.mm.default,)


def _save_matmuls(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(mode: str):
    """``cfg.remat`` -> a function that runs ``_unit_apply`` under the
    checkpoint it names (None: run it as it is)."""
    if mode == "none":
        return None
    if mode == "full":
        return functools.partial(checkpoint, _unit_apply, use_reentrant=False)
    if mode == "dots":
        return functools.partial(
            checkpoint, _unit_apply, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_matmuls),
        )
    raise ValueError(f"unknown remat mode {mode!r} (expected 'none', 'full' or 'dots')")


def stack_apply(
    params, x: torch.Tensor, cfg, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """Full layer stack forward. -> (x, x_sum) for the final norm, and the
    load-balance loss summed over the MoE layers in layer order, as the JAX
    package sums it (an f32 0 without an MoE).

    Compiled, the JAX package fuses a block's last residual add into the
    next consumer's RMSNorm, and XLA keeps the sum in f32 there (excess
    precision): within one scan unit (Griffin's rec, rec, attn), from one
    unrolled prefix or remainder layer to the next, and from the last
    remainder layer to the final norm. Only the scan's carry, stored between
    units, is rounded to bf16. So each block hands its f32 sum on, and it is
    dropped where JAX stores the carry (``x_sum = None``)."""
    lay = StackLayout(cfg)
    x_sum, lb = None, None
    for i in lay.prefix:
        x, x_sum, block_lb = block_apply(params["prefix"][f"layer{i}"], x, cfg, layer_kind(cfg, i),
                                         _ffn_kind(cfg, i), positions, x_sum, scope=f"layer{i}")
        lb = _add_lb(lb, block_lb)
    remat = _remat(cfg.remat) if torch.is_grad_enabled() else None
    with _scope("layers"):
        for u in range(lay.n_units):
            if remat is None:
                x, x_sum, unit_lb = _unit_apply(params["scan"], u, x, cfg, positions)
            else:
                with _scope("checkpoint"):
                    x, x_sum, unit_lb = remat(params["scan"], u, x, cfg, positions)
            lb = _add_lb(lb, unit_lb)
    if lay.n_units:
        x_sum = None
    for i in lay.remainder:
        x, x_sum, block_lb = block_apply(params["remainder"][f"layer{i}"], x, cfg, layer_kind(cfg, i),
                                         _ffn_kind(cfg, i), positions, x_sum, scope=f"layer{i}")
        lb = _add_lb(lb, block_lb)
    return x, x_sum, torch.zeros((), device=x.device) if lb is None else lb


def stack_decode(params, x: torch.Tensor, states, pos: int, cfg) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Single-token decode through the stack, rounding as :func:`stack_apply`.
    -> (x, x_sum); the states are updated in place (the stacked ones through
    views)."""
    lay = StackLayout(cfg)
    x_sum = None
    for i in lay.prefix:
        key = f"layer{i}"
        x, x_sum = block_decode(params["prefix"][key], x, states["prefix"][key], pos, cfg, layer_kind(cfg, i),
                                _ffn_kind(cfg, i), x_sum, scope=key)
    with _scope("layers"):
        for u in range(lay.n_units):
            unit_params = _unit(params["scan"], u)
            x_sum = None
            for j, kind in enumerate(lay.unit_kinds):
                key = f"block{j}"
                unit_state = {name: t[u] for name, t in states["scan"][key].items()}  # views into the stacked state
                with _scope(f"unit_block{j}_{kind}"):
                    x, x_sum = block_decode(unit_params[key], x, unit_state, pos, cfg, kind,
                                            _ffn_kind(cfg, cfg.first_dense + j), x_sum, scope=key)
    if lay.n_units:
        x_sum = None
    for i in lay.remainder:
        key = f"layer{i}"
        x, x_sum = block_decode(params["remainder"][key], x, states["remainder"][key], pos, cfg, layer_kind(cfg, i),
                                _ffn_kind(cfg, i), x_sum, scope=key)
    return x, x_sum


def layer_state_init(cfg, kind: str, batch: int, max_len: int, device) -> dict:
    _check_kind(kind)
    if kind == "attn":
        return attn_mod.init_kv_cache(cfg, batch, max_len, device)
    if kind == "rec":
        return rec_mod.init_recurrent_state(cfg, batch, device)
    if kind == "slstm":
        return xlstm_mod.init_slstm_state(cfg, batch, device)
    return xlstm_mod.init_mlstm_state(cfg, batch, device)


def stack_state(cfg, batch: int, max_len: int, device) -> dict:
    """Decode-state tree matching the params layout."""
    lay = StackLayout(cfg)
    states: dict[str, Any] = {}
    if lay.prefix:
        states["prefix"] = {
            f"layer{i}": layer_state_init(cfg, layer_kind(cfg, i), batch, max_len, device) for i in lay.prefix
        }
    if lay.n_units:
        states["scan"] = {
            f"block{j}": {
                name: t.new_zeros((lay.n_units, *t.shape))
                for name, t in layer_state_init(cfg, kind, batch, max_len, device).items()
            }
            for j, kind in enumerate(lay.unit_kinds)
        }
    if lay.remainder:
        states["remainder"] = {
            f"layer{i}": layer_state_init(cfg, layer_kind(cfg, i), batch, max_len, device) for i in lay.remainder
        }
    return states
