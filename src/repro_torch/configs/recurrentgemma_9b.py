"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427; unverified]"""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        head_dim=256, d_ff=12288, vocab_size=256000,
        pattern=("rec", "rec", "attn"), activation="gelu", gated_ffn=True,
        norm="rmsnorm", rope_theta=10000.0, window=2048,
        lru_width=4096, conv_width=4,
        tie_embeddings=True, scale_embed=True,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=256, lru_width=64, window=16,
    )
