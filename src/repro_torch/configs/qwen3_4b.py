"""qwen3-4b [dense] — GQA kv=8, qk_norm, explicit head_dim=128."""

from .base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=9728,
        vocab=151_936,
        head_dim_=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim_=16,
        qk_norm=True,
        rope_theta=1_000_000.0,
        remat="none",
    )


register("qwen3-4b", config, smoke)
