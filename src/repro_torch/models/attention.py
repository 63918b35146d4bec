"""Attention: GQA/MQA with RoPE or M-RoPE, qk-norm, sliding windows, KV cache.

Prefill always runs the flash-attention kernel through ``ops.flash_attention``
(its plain version for CPU tensors): the JAX package's ``pallas`` path, at
every length. Decode is plain PyTorch, as the JAX package's decode is plain
jnp, and rounds where it rounds: scores and the softmax probabilities pass
through bf16.

The JAX package's ``xla`` path, ``_attend_full`` and, above
``chunk_threshold``, ``_attend_chunked`` (query chunks of ``cfg.chunk``
rows, a (window + chunk)-key strip under a window), is here with its
semantics as a reference: the layout (B, S, H, D), f32 scores, P rounded to
the inputs' dtype before the PV product, masked scores ``NEG_INF``. No path
of a model, server or trainer calls it; the tests hold it to the JAX
package's, and ``chip_smoke.py`` holds the flash kernels to
``_attend_chunked`` on f32 copies at 32k tokens, where a reference that
materialises all S x T scores would need 137 GB. Each chunk runs under
``torch.utils.checkpoint`` (JAX's body under ``jax.checkpoint`` with
``nothing_saveable``), so a backward never holds S x T either.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.scope import scope as _scope
from repro_torch.kernels import ops
from repro_torch.sharding.ctx import shard_activation

from .modules import ArraySpec, apply_mrope, apply_rope, project_heads, rms_norm, rms_norm_spec

NEG_INF = -2.0e38


def attention_spec(cfg) -> dict:
    hd = cfg.head_dim
    spec = {
        "wq": ArraySpec((cfg.d_model, cfg.n_heads, hd), ("embed", "q_heads", "head")),
        "wk": ArraySpec((cfg.d_model, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head")),
        "wv": ArraySpec((cfg.d_model, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head")),
        "wo": ArraySpec((cfg.n_heads, hd, cfg.d_model), ("q_heads", "head", "embed")),
    }
    if cfg.qk_norm:
        spec["q_norm"] = rms_norm_spec(hd, "head")
        spec["k_norm"] = rms_norm_spec(hd, "head")
    return spec


def _project_qkv(params, x: torch.Tensor, cfg, positions: torch.Tensor):
    """positions: (B,S), or (B,S,3) with M-RoPE."""
    with _scope("qkv_proj"):
        q = project_heads(x, params["wq"])
        k = project_heads(x, params["wk"])
        v = project_heads(x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, scope="q_norm")
        k = rms_norm(params["k_norm"], k, scope="k_norm")
    rope = apply_mrope if cfg.mrope else apply_rope
    with _scope("rope"):
        return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    B, S, H, k = o.shape
    with _scope("out_proj"):
        return o.reshape(B, S, H * k) @ wo.to(o.dtype).reshape(H * k, -1)


def _mask(q_idx: torch.Tensor, k_idx: torch.Tensor, window: int | None) -> torch.Tensor:
    m = k_idx[None, :] <= q_idx[:, None]
    if window is not None:
        m &= (q_idx[:, None] - k_idx[None, :]) < window
    return m


def _attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg, *, q_offset: int = 0,
                 window: int | None = None) -> torch.Tensor:
    """q: (B,S,Hq,D); k,v: (B,T,Hkv,D) -> (B,S,Hq,D). Materialises (B,Hkv,G,S,T)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    scale = 1.0 / math.sqrt(D)
    with _scope("scores"):
        s = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
        mask = _mask(torch.arange(S, device=q.device) + q_offset, torch.arange(T, device=q.device), window)
        p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1).to(q.dtype)
    with _scope("pv"):
        o = torch.einsum("bkgst,btkd->bskgd", p, v)
    return o.reshape(B, S, Hq, D)


def _attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg, *,
                    window: int | None = None) -> torch.Tensor:
    """The softmax attention of :func:`_attend_full` one chunk of
    ``cfg.chunk`` query rows at a time (S padded to whole chunks): memory
    O(chunk x T), or O(chunk x (window + chunk)) where a window leaves each
    chunk a strip of keys."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    C = min(cfg.chunk, S)
    n_chunks = -(-S // C)
    pad = n_chunks * C - S
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, n_chunks, C, Hkv, G, D)
    scale = 1.0 / math.sqrt(D)
    # under a window each chunk reads the (window + C) keys that end at its
    # last row, not all T
    use_strip = window is not None and (window + C) < T
    Lk = min(window + C, T) if window is not None else T

    def body(i: int, qc: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if cfg.attn_cp:
            # context parallelism: the chunk's rows over the model axis (the
            # identity on a plain tensor)
            qc = shard_activation(qc, (None, "ctx_chunk", None, None, None))
        kstart = min(max(i * C + C - Lk, 0), T - Lk) if use_strip else 0
        kc, vc = k[:, kstart:kstart + Lk], v[:, kstart:kstart + Lk]
        with _scope("chunk_scores"):
            s = torch.einsum("bckgd,btkd->bkgct", qc, kc).float() * scale
            m = _mask(i * C + torch.arange(C, device=q.device), kstart + torch.arange(Lk, device=q.device), window)
            p = torch.softmax(s.masked_fill(~m, NEG_INF), dim=-1).to(qc.dtype)
        with _scope("chunk_pv"):
            return torch.einsum("bkgct,btkd->bckgd", p, vc)

    with _scope("q_chunk_scan"):
        o = torch.stack([checkpoint(body, i, qg[:, i], k, v, use_reentrant=False) for i in range(n_chunks)], dim=1)
    return o.reshape(B, n_chunks * C, Hq, D)[:, :S]


def attention(params, x: torch.Tensor, cfg, positions: torch.Tensor, *, window: int | None = None,
              scope: str = "attention") -> torch.Tensor:
    """Prefill self-attention. x: (B,S,D) -> (B,S,D). The scores and the PV
    product run in the flash kernel, under its wrapper's ``flash_attention``
    range, where the JAX package's xla path has ``scores`` and ``pv``."""
    with _scope(scope):
        q, k, v = _project_qkv(params, x, cfg, positions)
        o = ops.flash_attention(q, k, v, causal=True, window=window)
        return _out_proj(o, params["wo"])


# ---------------------------------------------------------------------------
# Decode path (one new token against a KV cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg, batch: int, max_len: int, device, dtype=torch.bfloat16) -> dict:
    # Windowed attention only caches its window (sub-quadratic decode).
    L = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(params, x: torch.Tensor, cache: dict, pos: int, cfg, *, window: int | None = None,
                     scope: str = "attention"):
    """One-token decode. x: (B,1,D); pos: current position.

    Returns (y, cache). The cache is updated in place (the JAX package
    donates it instead); it ring-buffers over the window for windowed
    attention and is max_len long for full attention.
    """
    with _scope(scope):
        return _decode_attention(params, x, cache, pos, cfg, window)


def _decode_attention(params, x: torch.Tensor, cache: dict, pos: int, cfg, window: int | None):
    B = x.shape[0]
    L = cache["k"].shape[1]
    positions = torch.full((B, 1, 3) if cfg.mrope else (B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)
    slot = pos % L if window else min(pos, L - 1)
    k, v = cache["k"], cache["v"]
    with _scope("cache_update"):
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)
    Hq, D = q.shape[2], q.shape[3]
    Hkv = k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    with _scope("scores"):
        s = torch.einsum("bkgd,btkd->bkgt", qg, k.to(q.dtype)).float()
        s *= 1.0 / math.sqrt(D)
        t_idx = torch.arange(L, device=x.device)
        if window:
            # Ring buffer: valid slots are the last `window` positions.
            age = torch.remainder(pos - t_idx, L)
            valid = (age >= 0) & (age < min(pos + 1, L))
        else:
            valid = t_idx <= pos
        s = s.masked_fill(~valid, NEG_INF)
        p = torch.softmax(s, dim=-1).to(q.dtype)
    with _scope("pv"):
        o = torch.einsum("bkgt,btkd->bkgd", p, v.to(q.dtype)).reshape(B, 1, Hq, D)
    return _out_proj(o, params["wo"]), cache
