"""Config system: ModelConfig (architecture), ShapeSpec (workload), registry.

A copy of the JAX package's config module, so the port imports nothing of
it. Every registered architecture has a full config plus a reduced ``smoke``
variant (same family, tiny dims) used by CPU tests. The port registers all
ten of the JAX package's: the four dense decoders, which all run through the
same code, the hybrid ``recurrentgemma-9b`` (recurrent blocks beside windowed
attention), the two MoE decoders ``deepseek-moe-16b`` and
``qwen3-moe-235b-a22b``, the attention-free ``xlstm-125m`` (sLSTM and mLSTM
cells), and the two that take embeddings as input, ``qwen2-vl-2b`` (M-RoPE)
and ``musicgen-medium``.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim_: int | None = None  # explicit head dim (default d_model/n_heads)
    act: str = "silu"
    qk_norm: bool = False
    tied_embeddings: bool = False
    # attention
    window: int | None = None  # sliding-window size for attn layers
    pattern: tuple[str, ...] = ("attn",)  # layer-kind cycle
    rope_theta: float = 10000.0
    mrope: bool = False
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    first_dense: int = 0  # leading dense-FFN layers (DeepSeekMoE)
    dense_d_ff: int = 0
    # "shard_map": the expert-parallel MoE (``models/moe_shard_map.py``) where
    # a sharding context's mesh has a ``model`` axis the experts divide by;
    # otherwise, and with "dense", the dense dispatch (``models/moe.py``), by
    # the JAX package's rule (``models/transformer.py`` ``_apply_moe``).
    moe_impl: str = "dense"
    # recurrent / ssm
    lru_width: int | None = None
    conv_width: int = 4
    # execution
    chunk: int = 512
    chunk_threshold: int = 8192
    attn_cp: bool = False
    # The port reads it nowhere: prefill runs the flash kernel at every length
    # (the CUDA kernel on the card, its plain version on the CPU), the JAX
    # package's "pallas" path; its "xla" path (``models/attention.py``
    # ``_attend_full``, ``_attend_chunked``) is a reference no model calls.
    # Kept so configs compare field by field with the JAX package's.
    attention_impl: str = "xla"
    remat: str = "full"  # none | full | dots: the stacked units under autograd (models/transformer.py)
    input_mode: str = "tokens"  # tokens | embeddings
    logit_softcap: float = 0.0
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.head_dim_ or self.d_model // self.n_heads

    def n_params(self) -> int:
        from repro_torch.models.model import Model

        return Model(self, device="meta").n_params

    def n_active_params(self) -> int:
        from repro_torch.models.model import Model

        return Model(self, device="meta").n_active_params


# ---------------------------------------------------------------------------
# Workload shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Families with sub-quadratic decode state: the only ones that run long_500k.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, "full-attention arch: 500k dense-KV decode is quadratic-cost (skip per assignment)"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig], smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(table)}")
    return table[name]()


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_loaded = False


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    from . import (  # noqa: F401
        deepseek_moe_16b,
        gemma_2b,
        granite_3_8b,
        llama3_2_3b,
        musicgen_medium,
        qwen2_vl_2b,
        qwen3_4b,
        qwen3_moe_235b,
        recurrentgemma_9b,
        xlstm_125m,
    )

    _loaded = True
