"""Griffin / RecurrentGemma recurrent block: causal conv1d + RG-LRU.

RG-LRU recurrence (arXiv:2402.19427):

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)  (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence through ``ops.rglru_scan`` (the CUDA kernel on
the card, its plain version on the CPU). Decode is an O(1) state update in
plain PyTorch that writes the new conv window and ``h`` into the state in
place.

Block structure (Griffin):  x -> [linear_x -> conv1d -> RG-LRU] * gelu(linear_gate) -> linear_out

Rounding follows the JAX package compiled: the gate products run in f32 on
the weights as stored (bf16-valued in the stacked units, f32 in the remainder
layers), the projections and the conv's products in the bf16 activation
dtype, the conv's bias add in f32 (the gates read it in f32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scope import scope as _scope
from repro_torch.kernels import ops

from .modules import ACTIVATIONS, ArraySpec

_C = 8.0


def rglru_spec(width: int) -> dict:
    return {
        "lam": ArraySpec((width,), ("state",), torch.float32, "normal", 0.8),
        "wa": ArraySpec((width, width), ("state", "state_out")),
        "ba": ArraySpec((width,), ("state",), torch.float32, "zeros"),
        "wx": ArraySpec((width, width), ("state", "state_out")),
        "bx": ArraySpec((width,), ("state",), torch.float32, "zeros"),
    }


def recurrent_block_spec(cfg) -> dict:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "in_x": {"w": ArraySpec((d, w), ("embed", "state"))},
        "in_gate": {"w": ArraySpec((d, w), ("embed", "state"))},
        "conv_w": ArraySpec((cfg.conv_width, w), ("conv", "state")),
        "conv_b": ArraySpec((w,), ("state",), torch.float32, "zeros"),
        "lru": rglru_spec(w),
        "out": {"w": ArraySpec((w, d), ("state", "embed"))},
    }


def _gates(params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a_t and the gated input b_t of the recurrence, both f32. x: (B,S,W).

    The products are f32 by f32 (``allow_tf32`` off, PyTorch's default for
    matmuls), as the JAX package multiplies f32 activations by the weights."""
    with _scope("gates"):
        xf = x.float()
        r = torch.sigmoid(xf @ params["wa"].float() + params["ba"])
        i = torch.sigmoid(xf @ params["wx"].float() + params["bx"])
        log_a = -_C * F.softplus(params["lam"]) * r  # <= 0
        a = torch.exp(log_a)
        # sqrt(1-a^2) in a numerically safe form
        beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
        return a, beta * (i * xf)


def rglru(params, x: torch.Tensor, *, h0: torch.Tensor | None = None,
          scope: str = "rg_lru") -> tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU over the sequence through the scan kernel. x: (B,S,W) ->
    (h in x's dtype, final state (B,W) f32). ``h0`` is folded into the first
    step's input, as the JAX package's XLA branch does."""
    with _scope(scope):
        a, b = _gates(params, x)
        if h0 is not None:
            b[:, 0] += a[:, 0] * h0.float()
        h = ops.rglru_scan(a, b)
        return h.to(x.dtype), h[:, -1]


def rglru_step(params, x_t: torch.Tensor, h_prev: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x_t: (B,1,W); h_prev: (B,W) -> (h (B,1,W) in x_t's dtype, h (B,W) f32)."""
    with _scope("rg_lru"):
        a, b = _gates(params, x_t)
        h = a[:, 0] * h_prev.float() + b[:, 0]
        return h[:, None].to(x_t.dtype), h


def causal_conv1d(params, x: torch.Tensor, *, scope: str = "conv1d") -> torch.Tensor:
    """Depthwise causal conv plus bias, width W_c, as the gates read it in the
    JAX package compiled. x: (B,S,W) -> f32 (B,S,W). The shifted
    multiply-adds are rounded op by op in x's dtype (not ``F.conv1d``: cuDNN
    would take f32 into TF32 and sum in another order); XLA fuses the conv
    into the gates, which take it in f32, and keeps the bias add in f32 there
    (excess precision). Rounded to x's dtype, this is the JAX function's
    output. At the initial zero bias the two agree; after one train step a
    bias add rounded to bf16 moves the smoke model's block output by ~1 %
    (std-1 gate weights drive some r to ~1e-9, where beta is ill-conditioned)."""
    with _scope(scope):
        w = params["conv_w"].to(x.dtype)  # (Wc, W)
        Wc, S = w.shape[0], x.shape[1]
        pad = F.pad(x, (0, 0, Wc - 1, 0))
        y = sum(pad[:, i : i + S] * w[i] for i in range(Wc))
        return y.float() + params["conv_b"].to(x.dtype).float()


def causal_conv1d_step(params, x_t: torch.Tensor, conv_state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode: conv_state holds the last Wc-1 inputs. x_t: (B,1,W) -> (y f32
    (B,1,W), new conv state). The products are summed in f32 and rounded to
    x_t's dtype, the bias added in f32, as :func:`causal_conv1d` adds it."""
    with _scope("conv1d"):
        w = params["conv_w"].to(x_t.dtype)
        window = torch.cat([conv_state, x_t], dim=1)  # (B, Wc, W)
        y = (window.float() * w.float()).sum(dim=1).to(x_t.dtype)[:, None]
        return y.float() + params["conv_b"].to(x_t.dtype).float(), window[:, 1:]


def recurrent_block(params, x: torch.Tensor, cfg, *, scope: str = "recurrent_block") -> torch.Tensor:
    """Full Griffin temporal-mixing block (prefill). x: (B,S,D)."""
    with _scope(scope):
        with _scope("in_proj"):
            xb = x @ params["in_x"]["w"].to(x.dtype)
            gb = x @ params["in_gate"]["w"].to(x.dtype)
        h, _ = rglru(params["lru"], causal_conv1d(params, xb))
        with _scope("gate"):
            y = h.to(x.dtype) * ACTIVATIONS["gelu"](gb)
        with _scope("out_proj"):
            return y @ params["out"]["w"].to(x.dtype)


def init_recurrent_state(cfg, batch: int, device) -> dict:
    """Zero decode state: the last Wc-1 conv inputs in the bf16 activation
    dtype, and ``h`` in f32."""
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=torch.bfloat16, device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def recurrent_block_step(params, x_t: torch.Tensor, state: dict, cfg, *,
                         scope: str = "recurrent_block") -> tuple[torch.Tensor, dict]:
    """Decode step, O(1) in sequence length. x_t: (B,1,D). Returns (y, state);
    the state's ``conv`` and ``h`` are overwritten in place (the JAX package
    returns new arrays instead)."""
    with _scope(scope):
        with _scope("in_proj"):
            xb = x_t @ params["in_x"]["w"].to(x_t.dtype)
            gb = x_t @ params["in_gate"]["w"].to(x_t.dtype)
        xc, conv = causal_conv1d_step(params, xb, state["conv"])
        h_seq, h = rglru_step(params["lru"], xc, state["h"])
        with _scope("gate"):
            y = h_seq.to(x_t.dtype) * ACTIVATIONS["gelu"](gb)
        with _scope("out_proj"):
            out = y @ params["out"]["w"].to(x_t.dtype)
        state["conv"].copy_(conv)
        state["h"].copy_(h)
        return out, state
