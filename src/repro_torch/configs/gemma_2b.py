"""gemma-2b [dense] — MQA (kv=1), head_dim=256, GeGLU, tied embeddings."""

from .base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        d_ff=16384,
        vocab=256_000,
        head_dim_=256,
        act="gelu",
        tied_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-smoke",
        family="dense",
        n_layers=2,
        d_model=32,
        n_heads=2,
        n_kv_heads=1,
        d_ff=64,
        vocab=128,
        head_dim_=16,
        act="gelu",
        tied_embeddings=True,
        remat="none",
    )


register("gemma-2b", config, smoke)
