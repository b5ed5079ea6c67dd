"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, qk_norm, head_dim=128, tied embeddings."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
        head_dim=128, d_ff=3072, vocab_size=151936,
        pattern=("attn",), activation="silu", gated_ffn=True,
        norm="rmsnorm", qk_norm=True, rope_theta=1000000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256,
    )
