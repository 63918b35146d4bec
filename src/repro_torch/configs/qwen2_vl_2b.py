"""qwen2-vl-2b [vlm] — M-RoPE backbone; vision frontend is a STUB: the model
consumes precomputed patch embeddings (assignment note), with (t,h,w)
position ids driving multimodal RoPE."""

from .base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab=151_936,
        head_dim_=128,
        mrope=True,
        rope_theta=1_000_000.0,
        input_mode="embeddings",
        notes="vision frontend stubbed: input_specs() provides patch embeddings",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b-smoke",
        family="vlm",
        n_layers=3,
        d_model=48,
        n_heads=6,
        n_kv_heads=2,
        d_ff=96,
        vocab=256,
        head_dim_=8,
        mrope=True,
        rope_theta=1_000_000.0,
        input_mode="embeddings",
        remat="none",
    )


register("qwen2-vl-2b", config, smoke)
