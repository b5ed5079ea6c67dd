"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix, SWA.  [arXiv:2401.16818; hf]"""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
        head_dim=80, d_ff=6912, vocab_size=32000,
        pattern=("attn",), activation="silu", gated_ffn=True,
        norm="rmsnorm", rope_theta=10000.0, window=4096,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, window=32,
    )
