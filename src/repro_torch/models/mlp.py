"""Gated MLP (SwiGLU / GeGLU) and plain FFN."""

from __future__ import annotations

import torch

from .modules import ACTIVATIONS, ArraySpec


def mlp_spec(d_model: int, d_ff: int, *, gated: bool = True) -> dict:
    spec = {
        "wi": ArraySpec((d_model, d_ff), ("embed", "mlp")),
        "wo": ArraySpec((d_ff, d_model), ("mlp", "embed")),
    }
    if gated:
        spec["wg"] = ArraySpec((d_model, d_ff), ("embed", "mlp"))
    return spec


def mlp(params, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """x: (..., d_model) -> (..., d_model). Gated when 'wg' is present."""
    f = ACTIVATIONS[act]
    h = x @ params["wi"].to(x.dtype)
    if "wg" in params:
        h = f(x @ params["wg"].to(x.dtype)) * h
    else:
        h = f(h)
    return h @ params["wo"].to(x.dtype)
