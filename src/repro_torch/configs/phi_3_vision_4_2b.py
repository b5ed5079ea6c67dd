"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP frontend (stub: the caller gives
precomputed patch embeddings, 576 rows a request, prepended to the
text)."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        head_dim=96, d_ff=8192, vocab_size=32064,
        pattern=("attn",), activation="silu", gated_ffn=True,
        norm="rmsnorm", rope_theta=10000.0,
        frontend="vision", frontend_tokens=576,   # 24x24 CLIP patch grid
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, frontend_tokens=8,
    )
