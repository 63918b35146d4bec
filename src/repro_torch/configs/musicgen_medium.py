"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens
(arXiv:2306.05284). The EnCodec frontend is a STUB: input_specs() provides
precomputed frame embeddings; the LM head predicts the 2048-entry codebook."""

from .base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,  # MHA
        d_ff=6144,
        vocab=2048,  # EnCodec codebook
        head_dim_=64,
        act="gelu",
        input_mode="embeddings",
        notes="EnCodec frontend stubbed: input_specs() provides frame embeddings",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        family="audio",
        n_layers=3,
        d_model=48,
        n_heads=6,
        n_kv_heads=6,
        d_ff=96,
        vocab=128,
        head_dim_=8,
        act="gelu",
        input_mode="embeddings",
        remat="none",
    )


register("musicgen-medium", config, smoke)
