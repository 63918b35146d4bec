"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517), attention-free.
Pattern (slstm, mlstm, mlstm, mlstm) x 3 = 12 layers; d_ff=0 (cells only)."""

from .base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50_304,
        pattern=("slstm", "mlstm", "mlstm", "mlstm"),
        chunk=256,  # mLSTM chunkwise-parallel chunk
        notes="attention-free; runs long_500k (O(1) decode state)",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke",
        family="ssm",
        n_layers=4,
        d_model=32,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab=128,
        pattern=("slstm", "mlstm", "mlstm", "mlstm"),
        chunk=8,
        remat="none",
    )


register("xlstm-125m", config, smoke)
