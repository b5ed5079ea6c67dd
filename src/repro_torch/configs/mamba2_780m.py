"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) d_ff=0 vocab=50280,
ssm_state=128 — SSD (state-space duality).

Attention-free and FFN-free, so sparse MHA and the routed FFN do not
apply: SPT reduces to LoRA on the SSM in/out projections, and no SPT
kernel runs on its paths."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        pattern=("ssd",), norm="rmsnorm", rope_theta=None,
        positional="none",                  # SSM: the conv carries position
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
        conv_width=4, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, vocab_size=256,
        ssm_state=16, ssm_headdim=16, ssm_chunk=16,
    )
