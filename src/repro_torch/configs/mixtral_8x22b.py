"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA.  [arXiv:2401.04088; hf]"""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=16384, vocab_size=32768,
        pattern=("attn",), activation="silu", gated_ffn=True,
        norm="rmsnorm", rope_theta=1000000.0, window=4096,
        num_experts=8, experts_per_token=2,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, num_experts=4, window=32,
    )
