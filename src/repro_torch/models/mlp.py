"""Gated MLP (SwiGLU / GeGLU) and plain FFN."""

from __future__ import annotations

import torch

from repro_torch.core.scope import scope as _scope

from .modules import ACTIVATIONS, ArraySpec


def mlp_spec(d_model: int, d_ff: int, *, gated: bool = True) -> dict:
    spec = {
        "wi": ArraySpec((d_model, d_ff), ("embed", "mlp")),
        "wo": ArraySpec((d_ff, d_model), ("mlp", "embed")),
    }
    if gated:
        spec["wg"] = ArraySpec((d_model, d_ff), ("embed", "mlp"))
    return spec


def mlp(params, x: torch.Tensor, *, act: str = "silu", scope: str = "mlp") -> torch.Tensor:
    """x: (..., d_model) -> (..., d_model). Gated when 'wg' is present."""
    with _scope(scope):
        f = ACTIVATIONS[act]
        with _scope("up_proj"):
            h = x @ params["wi"].to(x.dtype)
        if "wg" in params:
            with _scope("gate_proj"):
                g = x @ params["wg"].to(x.dtype)
            h = f(g) * h
        else:
            h = f(h)
        with _scope("down_proj"):
            return h @ params["wo"].to(x.dtype)
