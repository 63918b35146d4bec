"""qwen3-moe-235b-a22b [moe] — 94L, 128 routed experts top-8, GQA kv=4,
qk_norm. On one card the port runs it at full width, cut in depth."""

from .base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_ff=1536,  # per-expert FF dim
        vocab=151_936,
        head_dim_=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
        n_experts=128,
        n_shared_experts=0,
        top_k=8,
        moe_d_ff=1536,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b-smoke",
        family="moe",
        n_layers=4,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        d_ff=16,
        vocab=128,
        head_dim_=8,
        qk_norm=True,
        n_experts=8,
        n_shared_experts=0,
        top_k=2,
        moe_d_ff=16,
        remat="none",
    )


register("qwen3-moe-235b-a22b", config, smoke)
