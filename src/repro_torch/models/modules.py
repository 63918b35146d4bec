"""Parameter system + primitive modules.

Models are plain functions over a params tree (nested dicts of tensors) with
the JAX package's keys, shapes and einsum layouts, so weights pass between
the two packages 1:1 (``repro_torch.params``). Each parameter is declared by
an :class:`ArraySpec`; logical axis names are kept for the later sharding
slice. Module bodies run under the JAX package's ``named_scope`` names
(``core/scope.py``: a profiler range, entered only while one records), so the
device tree of a profiled step is keyed as the JAX package's.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core.scope import scope as _scope
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArraySpec:
    """Declarative parameter: shape + logical axes + initializer."""

    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None  # overrides fan-in scaling

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes {self.logical} differ in rank")

    def std(self) -> float:
        """Standard deviation of the normal draw, as the JAX package computes it.

        ``fan_in`` is ``shape[0]``: after :func:`stack_specs` prepends the
        layer axis that is ``n_layers`` for every stacked weight. The JAX
        package does this too; the port keeps it so a full-width run sees the
        same activation scales."""
        if self.init == "embed":
            return self.scale if self.scale is not None else 1.0
        fan_in = self.shape[0] if len(self.shape) > 1 else max(self.shape[-1], 1)
        if len(self.shape) >= 2:
            fan_in = int(math.prod(self.shape[:-1])) if self.init == "normal_fan_full" else self.shape[0]
        return self.scale if self.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))

    def initializer(self, generator: torch.Generator, dtype: torch.dtype | None = None) -> torch.Tensor:
        """Draw on ``generator``'s device, stored in ``dtype`` (default the spec's)."""
        dtype = dtype or self.dtype
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=generator.device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=generator.device)
        x = torch.randn(self.shape, generator=generator, device=generator.device, dtype=torch.float32)
        return x.mul_(self.std()).to(dtype)


def tree_map_with_path(fn, tree, path: tuple[str, ...] = ()):
    """Apply ``fn(path, leaf)`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def tree_leaves(tree, path: tuple[str, ...] = ()):
    """Yield ``(path, leaf)`` for every leaf of a nested dict, in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (k,))
    else:
        yield path, tree


def storage_dtype(path: tuple[str, ...], ndim: int, *, train: bool = False) -> torch.dtype:
    """The dtype the port stores a parameter in.

    For training (``train``) every parameter is f32, as the JAX package keeps
    them: the optimizer updates f32 values. For inference, bf16 only where the
    JAX package casts the weight to bf16 before every use, so the stored
    values equal what it computes with: stacked weights of 3 or more dims
    (cast before the layer scan), ``lm_head.w`` and the embedding table
    (gathered in f32 and cast to bf16, or cast to the bf16 activations for the
    tied unembedding) and ``embed_proj.w`` (the embeddings' projection). Everything
    else, the norm scales included, stays f32."""
    if train:
        return torch.float32
    if path[:2] == ("layers", "scan") and ndim >= 3:
        return torch.bfloat16
    if path in (("lm_head", "w"), ("embed", "table"), ("embed_proj", "w")):
        return torch.bfloat16
    return torch.float32


def init_params(spec_tree, generator: torch.Generator, *, train: bool = False):
    """Materialize parameters on ``generator``'s device in their storage dtypes
    (``storage_dtype``). Draws from the same distributions as the JAX
    package, not the same bits; the draw does not depend on ``train``."""
    return tree_map_with_path(
        lambda p, s: s.initializer(generator, storage_dtype(p, len(s.shape), train=train)), spec_tree
    )


def param_count(spec_tree) -> int:
    total = 0

    def add(_, s):
        nonlocal total
        total += int(math.prod(s.shape))

    tree_map_with_path(add, spec_tree)
    return total


def at_unstacked_std(params: dict) -> dict:
    """``params`` with each stacked matrix of the layer stack (``layers.scan``,
    (n_units, d_in, ...)) scaled from the std its init draws, 1/sqrt(n_units)
    (:meth:`ArraySpec.std`), to 1/sqrt(d_in), that of its unstacked spec. The
    model never calls it: it gives checks weights where a smoke config with
    one unit (std 1) has a well-conditioned gradient."""

    def scaled(path, x):
        if path[:2] == ("layers", "scan") and x.ndim >= 3:
            return x * math.sqrt(x.shape[0] / x.shape[1])
        return x

    return tree_map_with_path(scaled, params)


def stack_specs(spec_tree, n: int, axis_name: str = "layers"):
    """Stack a per-layer spec ``n`` times along a leading 'layers' axis."""
    return tree_map_with_path(
        lambda _, s: ArraySpec((n,) + s.shape, (axis_name,) + s.logical, s.dtype, s.init, s.scale), spec_tree
    )


# ---------------------------------------------------------------------------
# Numerics helpers
# ---------------------------------------------------------------------------


def rms_norm(params, x: torch.Tensor, *, eps: float = 1e-6, scope: str = "rms_norm") -> torch.Tensor:
    """RMSNorm over the last axis through the fused kernel (its plain version
    on the CPU). x must be contiguous in its last axis."""
    with _scope(scope):
        return ops.fused_rmsnorm(x, params["scale"], eps=eps)


def rms_norm_spec(dim: int, logical: str = "embed") -> dict:
    return {"scale": ArraySpec((dim,), (logical,), torch.float32, "zeros")}


def dense(params, x: torch.Tensor, spec: str) -> torch.Tensor:
    """einsum-based projection; ``spec`` is the einsum equation."""
    y = torch.einsum(spec, x, params["w"].to(x.dtype))
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w in x's dtype) as one matmul; the result is contiguous."""
    B, S, _ = x.shape
    d, H, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, H * k)).view(B, S, H, k)


def dtype_const(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as JAX casts a Python constant to the array's dtype."""
    return float(torch.tensor(v, dtype=dtype))


class _Silu(torch.autograd.Function):
    """jax.nn.silu. The forward op by op (x * 1 / (1 + exp(-x))), rounding to
    x's dtype after each op as JAX does; F.silu rounds once and differs in
    ~40% of bf16 values. The backward is the logistic's derivative,
    g s (1 + x (1 - s)) with s = sigmoid(x), as JAX differentiates
    ``x * logistic(x)`` (``aten.silu_backward``: one kernel, f32 inside):
    autograd through the ops above multiplies 0 by exp(-x) = inf where
    x < -88 and gives NaN."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return x * torch.reciprocal(1 + torch.exp(-x))

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return torch.ops.aten.silu_backward(g, x)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return _Silu.apply(x)


class _Sigmoid(torch.autograd.Function):
    """jax.nn.sigmoid. The forward op by op (1 / (1 + exp(-x))), rounding to
    x's dtype after each op as the compiled JAX package does (torch.sigmoid
    rounds once and differs in a third of bf16 values). The backward is
    g (y (1 - y)) from the output y, op by op in y's dtype, as JAX
    differentiates ``lax.logistic``; autograd through the ops above would
    multiply 0 by exp(-x) = inf where x < -88."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _Sigmoid.apply(x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu(approximate=True) op by op, constants rounded to x's dtype.
    c, a = dtype_const(math.sqrt(2 / math.pi), x.dtype), dtype_const(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


ACTIVATIONS: dict[str, Callable] = {
    "silu": _silu,
    "gelu": _gelu_tanh,
    "relu": F.relu,
    "tanh": torch.tanh,
}


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D) rotated in f32 by angles (..., S, D/2), pair (i, i + D/2) by angle i."""
    angles = angles[..., None, :]  # head axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(
    x: torch.Tensor, positions: torch.Tensor, theta: float, sections: tuple[int, int, int] | None = None
) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the D/2 frequencies split into three
    sections, rotated by the (temporal, height, width) position streams.
    x: (..., S, H, D); positions: (..., S, 3). Default sections
    (D/2 - 2 (D/2 // 4), D/2 // 4, D/2 // 4), as the JAX package's."""
    d2 = x.shape[-1] // 2
    if sections is None:
        sections = (d2 - 2 * (d2 // 4), d2 // 4, d2 // 4)
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    bounds = [0, sections[0], sections[0] + sections[1], sum(sections)]
    angles = torch.cat([positions[..., i, None].float() * freqs[bounds[i] : bounds[i + 1]] for i in range(3)], dim=-1)
    return _rotate(x, angles)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_spec(vocab: int, d_model: int) -> dict:
    return {"table": ArraySpec((vocab, d_model), ("vocab", "embed"), torch.float32, "embed", 0.02)}


def embed(params, tokens: torch.Tensor, *, scope: str = "embed") -> torch.Tensor:
    # F.embedding, not indexing: on the card its backward sums repeated tokens
    # in a fixed order, where indexing's accumulates with atomics.
    with _scope(scope):
        return F.embedding(tokens, params["table"])


def unembed(params, x: torch.Tensor, *, scope: str = "lm_head") -> torch.Tensor:
    with _scope(scope):
        return x @ params["table"].to(x.dtype).T


def lm_head_spec(vocab: int, d_model: int) -> dict:
    return {"w": ArraySpec((d_model, vocab), ("embed", "vocab"), torch.float32, "normal")}


def lm_head(params, x: torch.Tensor, *, scope: str = "lm_head") -> torch.Tensor:
    with _scope(scope):
        return x @ params["w"].to(x.dtype)
