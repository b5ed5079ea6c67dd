"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]"""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=32768, vocab_size=131072,
        pattern=("attn",), activation="gelu", gated_ffn=True,
        norm="rmsnorm", rope_theta=10000.0,
        num_experts=8, experts_per_token=2,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, num_experts=4,
    )
