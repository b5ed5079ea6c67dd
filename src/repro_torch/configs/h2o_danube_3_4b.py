"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix, SWA.  [arXiv:2401.16818; unverified]"""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense",
        num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
        head_dim=120, d_ff=10240, vocab_size=32000,
        pattern=("attn",), activation="silu", gated_ffn=True,
        norm="rmsnorm", rope_theta=10000.0, window=4096,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, window=32,
    )
