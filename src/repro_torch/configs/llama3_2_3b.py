"""llama3.2-3b [dense] — GQA kv=8, tied embeddings (llama3.2 small variants)."""

from .base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab=128_256,
        head_dim_=128,
        tied_embeddings=True,
        rope_theta=500_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b-smoke",
        family="dense",
        n_layers=3,
        d_model=48,
        n_heads=6,
        n_kv_heads=2,
        d_ff=96,
        vocab=256,
        head_dim_=8,
        tied_embeddings=True,
        rope_theta=500_000.0,
        remat="none",
    )


register("llama3.2-3b", config, smoke)
