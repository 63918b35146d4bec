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


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """f32 ``x * y + z`` rounded once, as ``fmaf``: the f32 product is exact in
    f64 and only the sum rounds (a second rounding to f32 can differ from one
    true rounding only at an exact f32 midpoint)."""
    return torch.addcmul(z.double(), x.double(), y.double()).float()


def rglru_chunked_ref(a: torch.Tensor, b: torch.Tensor, chunk: int, *, warps: int, cluster: int) -> torch.Tensor:
    """The scan in the chunked kernel's order of f32 arithmetic
    (``csrc/rglru_scan.cu``, ``rglru_chunked_kernel``); the tests use it.

    S splits into sub-chunks of ``chunk`` steps, ``warps`` of them a block and
    ``cluster`` blocks a round, the rounds in turn; the tail pads with the
    identity a = 1, b = 0. Each sub-chunk's aggregate (A, H) is its product of
    a and its scan from 0; the warps' aggregates fold into the block's in
    order; each round applies the blocks' aggregates to the state in time
    order, and each block's warps' to the state that enters it; each
    sub-chunk then runs the recurrence from the state that enters it. Every
    multiply-add is one fused f32 operation. a, b: (B, S, W); output in a's
    dtype."""
    B, S, W = a.shape
    per_round = chunk * warps * cluster
    rounds = -(-S // per_round)
    pad = rounds * per_round - S
    af = torch.cat([a.float(), a.new_ones((B, pad, W), dtype=torch.float32)], dim=1)
    bf = torch.cat([b.float(), b.new_zeros((B, pad, W), dtype=torch.float32)], dim=1)
    af = af.view(B, rounds, cluster, warps, chunk, W)
    bf = bf.view(B, rounds, cluster, warps, chunk, W)
    A = torch.ones_like(af[..., 0, :])  # (B, rounds, cluster, warps, W)
    H = torch.zeros_like(A)
    for i in range(chunk):
        H = _fma(af[..., i, :], H, bf[..., i, :])
        A = A * af[..., i, :]
    A_blk, H_blk = torch.ones_like(A[..., 0, :]), torch.zeros_like(A[..., 0, :])
    for w in range(warps):
        H_blk = _fma(A[..., w, :], H_blk, H[..., w, :])
        A_blk = A_blk * A[..., w, :]
    carry = torch.empty_like(A)
    state = torch.zeros_like(A[:, 0, 0, 0])
    for r in range(rounds):
        for k in range(cluster):
            x = state
            for w in range(warps):
                carry[:, r, k, w] = x
                x = _fma(A[:, r, k, w], x, H[:, r, k, w])
            state = _fma(A_blk[:, r, k], state, H_blk[:, r, k])
    out = torch.empty_like(af)
    x = carry
    for i in range(chunk):
        x = _fma(af[..., i, :], x, bf[..., i, :])
        out[..., i, :] = x
    return out.view(B, rounds * per_round, W)[:, :S].to(a.dtype)
