"""Plain PyTorch versions of the hand-written kernels.

They compute what the kernels compute, in the layouts the kernels take. The
wrappers in ``ops.py`` call them for CPU tensors, the CPU tests hold them
against the JAX package, and ``chip_smoke.py`` holds each kernel against
them on the card.
"""

from __future__ import annotations

import math

import torch


def attention_ref(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    p_bf16: int = 0,
) -> torch.Tensor:
    """Softmax attention in f32. ``p_bf16`` > 0 feeds the PV product the
    unnormalised probabilities ``p = exp(s - rowmax)`` as bf16 and divides by
    the f32 sum of ``p``: 1 rounds ``p`` once (one bf16 pass of P through a
    matrix unit, as the TPU's f32 ``dot_general`` at default precision takes
    it), 2 feeds it as two bf16 terms ``hi = bf16(p)`` and ``lo = bf16(p - hi)``,
    as the wgmma kernel does (``csrc/flash_attention.cu``)."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, S, D).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, kf) / math.sqrt(D)
    q_idx = torch.arange(S, device=q.device)[:, None]
    k_idx = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_idx <= q_idx
    if window is not None:
        mask &= (q_idx - k_idx) < window
    s = s.masked_fill(~mask, -math.inf)
    if p_bf16:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        hi = p.bfloat16().float()
        o = torch.einsum("bkgst,bktd->bkgsd", hi, vf)
        if p_bf16 == 2:
            o = o + torch.einsum("bkgst,bktd->bkgsd", (p - hi).bfloat16().float(), vf)
        o = o / p.sum(dim=-1, keepdim=True)
    else:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgst,bktd->bkgsd", p, vf)
    return o.reshape(B, Hq, S, D).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rglru_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sequential scan ``h_t = a_t * h_{t-1} + b_t`` with ``h_{-1} = 0``.
    a, b: (B, S, W); arithmetic in f32, output in a's dtype."""
    af, bf = a.float(), b.float()
    h = torch.zeros_like(af[:, 0])
    out = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)
