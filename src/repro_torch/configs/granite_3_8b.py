"""granite-3-8b [dense] — GQA kv=8."""

from .base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12800,
        vocab=49_155,
        head_dim_=128,
        rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab=256,
        head_dim_=16,
        remat="none",
    )


register("granite-3-8b", config, smoke)
