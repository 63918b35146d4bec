"""Plain PyTorch versions of the hand-written kernels.

They compute what the kernels compute, in the layouts the kernels take. The
wrappers in ``ops.py`` call them for CPU tensors, the CPU tests hold them
against the JAX package, and ``chip_smoke.py`` holds each kernel against
them on the card.
"""

from __future__ import annotations

import math

import torch


def _attention_mask(S: int, T: int, causal: bool, window: int | None, device) -> torch.Tensor:
    q_idx = torch.arange(S, device=device)[:, None]
    k_idx = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= k_idx <= q_idx
    if window is not None:
        mask &= (q_idx - k_idx) < window
    return mask


def attention_ref(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    p_bf16: int = 0,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention in f32. ``p_bf16`` > 0 feeds the PV product the
    unnormalised probabilities ``p = exp(s - rowmax)`` as bf16 and divides by
    the f32 sum of ``p``: 1 rounds ``p`` once (one bf16 pass of P through a
    matrix unit, as the TPU's f32 ``dot_general`` at default precision takes
    it), 2 feeds it as two bf16 terms ``hi = bf16(p)`` and ``lo = bf16(p - hi)``,
    as the wgmma kernel does (``csrc/flash_attention.cu``). ``return_lse``
    also returns the rows' statistics as the wgmma kernel writes them for the
    backward: ``lse`` (B, Hq, S) f32 (:func:`_row_lse`)."""
    B, Hq, S, D = q.shape
    s = _scores(q, k, causal, window)
    vf = v.float()
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
    o = o.reshape(B, Hq, S, D).to(q.dtype)
    return (o, _row_lse(s).reshape(B, Hq, S)) if return_lse else o


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int | None) -> torch.Tensor:
    """The masked, scaled scores in f32, grouped: (B, Hkv, G, S, T); -inf where masked."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, S, D).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(D)
    return s.masked_fill(~_attention_mask(S, T, causal, window, q.device), -math.inf)


def _row_lse(s: torch.Tensor) -> torch.Tensor:
    """logsumexp over the keys of masked scores, +inf for a row that sees no
    key (its P is then 0 in the backward, where -inf would give NaN)."""
    lse = torch.logsumexp(s, dim=-1)
    return lse.masked_fill(lse == -math.inf, math.inf)


def attention_bwd_ref(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, Hq, S, D): the forward's output
    do: torch.Tensor,  # (B, Hq, S, D): its gradient
    *,
    causal: bool = True,
    window: int | None = None,
    lse: torch.Tensor | None = None,  # (B, Hq, S): the forward's row statistics
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`attention_ref` by its explicit formulas, in f32:
    the row log-sum-exp from q and k (or the forward's ``lse``, as
    ``attention_ref(return_lse=True)`` gives it), ``P = exp(s - lse)``,
    ``Dr = rowsum(do * o)`` over the given output, ``dS = P * (dP - Dr)``
    with ``dP = do v^T``; dk and dv summed over the q heads of each kv group.
    -> (dq, dk, dv) in q's dtype."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, S, D).float()
    dog = do.reshape(B, Hkv, G, S, D).float()
    kf, vf = k.float(), v.float()
    s = _scores(q, k, causal, window)
    lse = _row_lse(s) if lse is None else lse.float().reshape(B, Hkv, G, S)
    p = torch.exp(s - lse[..., None])
    dr = (dog * o.reshape(B, Hkv, G, S, D).float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bkgsd,bktd->bkgst", dog, vf) - dr)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg) * scale
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    return dq.reshape(B, Hq, S, D).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_bwd_ref(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rmsnorm_ref` by its explicit formulas, in f32:
    with ``r = rsqrt(mean(x^2) + eps)``, ``xhat = x r`` and
    ``g = dy (1 + scale)``, ``dx = r (g - xhat mean(g xhat))`` and
    ``dscale = sum over rows of dy xhat``. -> (dx in x's dtype, dscale f32)."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    g = dyf * (1.0 + scale.float())
    dx = r * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dscale = (dyf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale


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


def rglru_bwd_ref(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rglru_ref` from its input ``a``, its output
    ``h`` and the output's gradient ``dh``, all (B, S, W): the reverse-time
    scan ``g_t = dh_t + a_{t+1} g_{t+1}`` with ``g_S = 0``, then
    ``db_t = g_t`` and ``da_t = g_t h_{t-1}`` with ``h_{-1} = 0``. Arithmetic
    in f32 (h as given, rounded where the forward rounded it); -> (da, db) in
    a's dtype."""
    af, dhf = a.float(), dh.float()
    g = torch.zeros_like(af[:, 0])
    db = torch.empty_like(af)
    for t in range(a.shape[1] - 1, -1, -1):
        g = dhf[:, t] + (af[:, t + 1] * g if t + 1 < a.shape[1] else 0.0)
        db[:, t] = g
    da = torch.zeros_like(db)
    da[:, 1:] = db[:, 1:] * h[:, :-1].float()
    return da.to(a.dtype), db.to(a.dtype)


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


def rglru_bwd_chunked_ref(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor, chunk: int, *, warps: int,
                          cluster: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rglru_bwd_ref` in the chunked backward kernel's order of f32
    arithmetic: :func:`rglru_chunked_ref` over reversed time of the shifted
    coefficients ``a_{t+1}`` (0 at the last step, where there is no
    ``a_S``) and of dh gives g; then ``db_t = g_t`` and
    ``da_t = g_t h_{t-1}``, each rounded once to a's dtype."""
    c = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1).float()
    g = rglru_chunked_ref(c.flip(1), dh.float().flip(1), chunk, warps=warps, cluster=cluster).flip(1)
    da = torch.zeros_like(g)
    da[:, 1:] = g[:, 1:] * h[:, :-1].float()
    return da.to(a.dtype), g.to(a.dtype)
