"""xLSTM cells (arXiv:2405.04517): mLSTM (matrix memory, chunkwise parallel)
and sLSTM (scalar memory, sequential), with exponential gating; the
counterpart of the JAX package's ``models/xlstm.py``.

mLSTM cell (per head, dk = dv = d):

    C_t = f_t * C_{t-1} + i_t * v_t k_t^T        (matrix memory)
    n_t = f_t * n_{t-1} + i_t * k_t              (normalizer)
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)

Prefill and training run it chunkwise: within a chunk of ``cfg.chunk`` steps
an attention-like masked product with gate-decay weights, across chunks the
boundary state (C, n), carried by a Python loop (JAX: ``lax.scan``). Gate
exponents run in f32, with log-sigmoid forget gates (log f <= 0) and the
input-gate exponent capped at ``_ICAP``. Decode is the O(1) recurrence above.

sLSTM feeds h back into its gates, so it runs step by step: a Python loop
over time (JAX: ``lax.scan``), each step a handful of small launches. Both
cells run under the JAX package's scopes (``core/scope.py``): ``slstm`` with
``in_proj``, ``time_scan`` (the loop) and ``out``; ``mlstm`` with
``qkv_proj``, ``chunk_scan`` (the loop; each chunk's ``intra``, ``inter``,
``normalize`` and ``state_update``) and ``out``, so a profile can say what
the loops cost.

Rounding follows the JAX package compiled: the projections in the bf16
activation dtype, the gate products and both cells' recurrences in f32 on
the weights as stored (bf16-valued in the stacked units). One deliberate
difference: the intra-chunk weights are ``exp(where(mask, E, -inf))``, where
the JAX package takes ``where(mask, exp(E), 0)``. The values are the same,
0 above the diagonal, but above the diagonal ``E`` sums up to L - 1 values of
``-log f`` and overflows ``exp`` at a chunk of 256; JAX's gradient there is
0 * inf = NaN, the port's is 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.scope import scope as _scope

from .modules import ArraySpec, dtype_const, project_heads, rms_norm, rms_norm_spec, sigmoid

_ICAP = 15.0  # cap on the input-gate exponent (f32-safe)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_spec(cfg) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    return {
        "wq": ArraySpec((d, H, hd), ("embed", "q_heads", "head")),
        "wk": ArraySpec((d, H, hd), ("embed", "q_heads", "head")),
        "wv": ArraySpec((d, H, hd), ("embed", "q_heads", "head")),
        "wi": ArraySpec((d, H), ("embed", "q_heads")),
        "wf": ArraySpec((d, H), ("embed", "q_heads")),
        "wo_gate": ArraySpec((d, d), ("embed", "embed_out")),
        "out_norm": rms_norm_spec(d),
        "wo": ArraySpec((d, d), ("embed", "embed_out")),
    }


def _mlstm_gates(params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(log i, log f), each (B,S,H) f32: f32 products of the activations and
    the weights as stored, log-sigmoid forget gates, capped input gates."""
    xf = x.float()
    log_f = F.logsigmoid(xf @ params["wf"].float() + 1.0)
    log_i = torch.clamp(xf @ params["wi"].float(), max=_ICAP)
    return log_i, log_f


def _mlstm_chunk(C, n, q, k, v, li, lf):
    """One chunk of L steps from the boundary state (C (B,H,K,K), n (B,H,K)):
    q, k, v (B,L,H,K) and the gates (B,L,H), all f32. -> (C, n) at the
    chunk's end and h (B,L,H,K)."""
    L = q.shape[1]
    cumf = torch.cumsum(lf, dim=1)  # (B,L,H)
    # w_ij = exp(cumf_i - cumf_j + li_j) for j <= i, 0 above the diagonal,
    # where E_ij may overflow exp: mask before exp, so its gradient is 0 there
    E = cumf[:, :, None] - cumf[:, None, :] + li[:, None, :]  # (B,L,L,H)
    above = ~torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    with _scope("intra"):
        w = torch.exp(E.masked_fill(above[None, :, :, None], -math.inf))
        s = torch.einsum("blhk,bmhk->blmh", q, k) * w
        num_intra = torch.einsum("blmh,bmhk->blhk", s, v)
        den_vec = torch.einsum("blmh,bmhk->blhk", w, k)
        den_intra = torch.einsum("blhk,blhk->blh", q, den_vec)
    with _scope("inter"):
        decay = torch.exp(cumf)
        num_inter = torch.einsum("blhk,bhkv->blhv", q, C) * decay[..., None]
        den_inter = torch.einsum("blhk,bhk->blh", q, n) * decay
    with _scope("normalize"):
        den = torch.abs(den_intra + den_inter)
        h = (num_intra + num_inter) / torch.clamp(den, min=1.0)[..., None]
    with _scope("state_update"):
        decay_end = torch.exp(cumf[:, -1])  # (B,H)
        wj = torch.exp(cumf[:, -1:] - cumf + li)  # (B,L,H), exponents <= _ICAP
        C_new = decay_end[..., None, None] * C + torch.einsum("blhk,blhv->bhkv", wj[..., None] * k, v)
        n_new = decay_end[..., None] * n + torch.einsum("blh,blhk->bhk", wj, k)
    return C_new, n_new, h


def mlstm(params, x: torch.Tensor, cfg, *, state: dict | None = None,
          scope: str = "mlstm") -> tuple[torch.Tensor, dict]:
    """Chunkwise-parallel mLSTM. x: (B,S,D) -> (y (B,S,D), {"C", "n"} f32).

    Where autograd records, each chunk runs under ``torch.utils.checkpoint``
    (and the ``checkpoint`` scope), as the JAX package checkpoints its chunk
    body: the (B,L,L,H) intra-chunk weights are recomputed in the backward
    pass, not saved once per chunk."""
    with _scope(scope):
        return _mlstm(params, x, cfg, state)


def _mlstm(params, x: torch.Tensor, cfg, state: dict | None) -> tuple[torch.Tensor, dict]:
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    L = min(cfg.chunk, S)
    assert S % L == 0, f"seq {S} must be divisible by chunk {L}"
    with _scope("qkv_proj"):
        # JAX multiplies the bf16 product by the scale rounded to bf16
        q = project_heads(x, params["wq"]) * dtype_const(1.0 / math.sqrt(hd), x.dtype)
        k = project_heads(x, params["wk"])
        v = project_heads(x, params["wv"])
    log_i, log_f = _mlstm_gates(params, x)
    if state is None:
        C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    else:
        C, n = state["C"], state["n"]
    records = torch.is_grad_enabled()
    hs = []
    with _scope("chunk_scan"):
        for c in range(S // L):
            t = slice(c * L, (c + 1) * L)
            args = (C, n, q[:, t].float(), k[:, t].float(), v[:, t].float(), log_i[:, t], log_f[:, t])
            if records:
                with _scope("checkpoint"):
                    C, n, h = checkpoint(_mlstm_chunk, *args, use_reentrant=False)
            else:
                C, n, h = _mlstm_chunk(*args)
            hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, S, D).to(x.dtype)
    with _scope("out"):
        og = sigmoid(x @ params["wo_gate"].to(x.dtype))
        h = rms_norm(params["out_norm"], h, scope="out_norm") * og
        return h @ params["wo"].to(x.dtype), {"C": C, "n": n}


def mlstm_step(params, x_t: torch.Tensor, state: dict, cfg, *, scope: str = "mlstm") -> tuple[torch.Tensor, dict]:
    """O(1) decode step. x_t: (B,1,D) -> (y, state); the state's C and n are
    overwritten in place (the JAX package returns new arrays instead)."""
    with _scope(scope):
        return _mlstm_step(params, x_t, state, cfg)


def _mlstm_step(params, x_t: torch.Tensor, state: dict, cfg) -> tuple[torch.Tensor, dict]:
    B, _, D = x_t.shape
    H = cfg.n_heads
    scale = 1.0 / math.sqrt(D // H)  # an f32 product here, as in JAX's step
    q = project_heads(x_t, params["wq"])[:, 0].float() * scale
    k = project_heads(x_t, params["wk"])[:, 0].float()
    v = project_heads(x_t, params["wv"])[:, 0].float()
    log_i, log_f = _mlstm_gates(params, x_t)
    i_t, f_t = torch.exp(log_i[:, 0]), torch.exp(log_f[:, 0])  # (B,H)
    C = f_t[..., None, None] * state["C"] + i_t[..., None, None] * torch.einsum("bhk,bhv->bhkv", k, v)
    n = f_t[..., None] * state["n"] + i_t[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", C, q)
    den = torch.abs(torch.einsum("bhk,bhk->bh", n, q))
    h = (num / torch.clamp(den, min=1.0)[..., None]).reshape(B, 1, D).to(x_t.dtype)
    og = sigmoid(x_t @ params["wo_gate"].to(x_t.dtype))
    h = rms_norm(params["out_norm"], h, scope="out_norm") * og
    state["C"].copy_(C)
    state["n"].copy_(n)
    return h @ params["wo"].to(x_t.dtype), state


def init_mlstm_state(cfg, batch: int, device) -> dict:
    hd = cfg.d_model // cfg.n_heads
    return {
        "C": torch.zeros((batch, cfg.n_heads, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, cfg.n_heads, hd), dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_spec(cfg) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    return {
        # input projections for 4 gates (i, f, z, o)
        "wx": ArraySpec((d, 4, H, hd), ("embed", None, "q_heads", "head")),
        # per-head recurrent (block-diagonal) projections
        "r": ArraySpec((4, H, hd, hd), (None, "q_heads", "head", "head_out"), torch.float32, "normal", 0.02),
        "b": ArraySpec((4, H, hd), (None, "q_heads", "head"), torch.float32, "zeros"),
        "out_norm": rms_norm_spec(d),
        "wo": ArraySpec((d, d), ("embed", "embed_out")),
    }


def slstm(params, x: torch.Tensor, cfg, *, state: dict | None = None,
          scope: str = "slstm") -> tuple[torch.Tensor, dict]:
    """Sequential sLSTM over time. x: (B,S,D) -> (y (B,S,D), {"h", "c", "n",
    "m"} f32 (B,H,hd)). The stabilizer ``m`` keeps both exponents <= 0; the
    input gate is capped at ``_ICAP`` inside the ``max`` and the ``exp``, as
    in the JAX package. A new state is returned; ``state`` is not written."""
    with _scope(scope):
        return _slstm(params, x, cfg, state)


def _slstm(params, x: torch.Tensor, cfg, state: dict | None) -> tuple[torch.Tensor, dict]:
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    with _scope("in_proj"):
        gx = (x.float() @ params["wx"].float().reshape(D, 4 * H * hd)).view(B, S, 4, H, hd)
    if state is None:
        state = init_slstm_state(cfg, B, x.device)
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    # rec = einsum("bhk,ghkl->bghl", h, r) as one batched product over heads.
    # r and b are taken to f32 inside the step, as in JAX's scan body: their
    # gradients are rounded to the stored dtype step by step and summed there.
    r = params["r"].permute(1, 2, 0, 3).reshape(H, hd, 4 * hd)
    b = params["b"]
    hs = []
    with _scope("time_scan"):
        for t in range(S):
            rec = torch.bmm(h.transpose(0, 1), r.float()).view(H, B, 4, hd).permute(1, 2, 0, 3) + b.float()
            g = gx[:, t] + rec  # (B,4,H,hd)
            gi, gf, gz, go = g.unbind(1)
            log_f = F.logsigmoid(gf)
            gi = torch.clamp(gi, max=_ICAP)
            m_new = torch.maximum(log_f + m, gi)
            i_p = torch.exp(gi - m_new)
            f_p = torch.exp(log_f + m - m_new)
            c = f_p * c + i_p * torch.tanh(gz)
            n = f_p * n + i_p
            h = sigmoid(go) * c / torch.clamp(n, min=1.0)
            m = m_new
            hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    with _scope("out"):
        y = rms_norm(params["out_norm"], y, scope="out_norm")
        return y @ params["wo"].to(x.dtype), {"h": h, "c": c, "n": n, "m": m}


def slstm_step(params, x_t: torch.Tensor, state: dict, cfg, *, scope: str = "slstm") -> tuple[torch.Tensor, dict]:
    """Decode step: :func:`slstm` at S = 1, its new state copied into
    ``state`` in place."""
    y, new = slstm(params, x_t, cfg, state=state, scope=scope)
    for name, t in new.items():
        state[name].copy_(t)
    return y, state


def init_slstm_state(cfg, batch: int, device) -> dict:
    shape = (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    return {name: torch.zeros(shape, dtype=torch.float32, device=device) for name in ("h", "c", "n", "m")}
