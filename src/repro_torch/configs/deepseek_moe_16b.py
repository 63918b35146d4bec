"""deepseek-moe-16b [moe] — fine-grained MoE: 2 shared + 64 routed top-6
(arXiv:2401.06066); layer 0 is a dense FFN (d_ff 10944), MHA (kv=16)."""

from .base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,  # per-routed-expert FF dim (assignment)
        vocab=102_400,
        head_dim_=128,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1408,
        first_dense=1,
        dense_d_ff=10944,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        family="moe",
        n_layers=3,
        d_model=32,
        n_heads=4,
        n_kv_heads=4,
        d_ff=24,
        vocab=128,
        head_dim_=8,
        n_experts=8,
        n_shared_experts=2,
        top_k=2,
        moe_d_ff=24,
        first_dense=1,
        dense_d_ff=64,
        remat="none",
    )


register("deepseek-moe-16b", config, smoke)
