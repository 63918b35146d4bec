"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent : 1 attn
pattern (arXiv:2402.19427). 38L = 12 scan units x (rec,rec,attn) + 2 remainder."""

from .base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,  # MQA on the local-attention layers
        d_ff=12288,
        vocab=256_000,
        head_dim_=256,
        act="gelu",  # GeGLU
        tied_embeddings=True,
        window=2048,  # local attention
        pattern=("rec", "rec", "attn"),
        lru_width=4096,
        conv_width=4,
        logit_softcap=30.0,
        notes="RG-LRU + local attn 1:2; runs long_500k (sub-quadratic decode)",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        family="hybrid",
        n_layers=5,  # 1 scan unit + 2 remainder layers (exercises both paths)
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab=256,
        head_dim_=16,
        act="gelu",
        tied_embeddings=True,
        window=8,
        pattern=("rec", "rec", "attn"),
        lru_width=64,
        conv_width=4,
        logit_softcap=30.0,
        chunk=16,
        remat="none",
    )


register("recurrentgemma-9b", config, smoke)
