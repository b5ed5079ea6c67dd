"""whisper-base [audio]: 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865 —
encoder-decoder; the conv frontend is a stub (the caller gives
precomputed frame embeddings).

seq_len applies to the decoder; the encoder takes the fixed 1500-frame
(30 s) window.  long_500k does not apply (full attention, bounded encoder
context)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

ENCODER_FRAMES = 1500


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=51865,
        pattern=("attn",), activation="gelu", gated_ffn=False,
        norm="layernorm", rope_theta=None, positional="learned",
        max_position=65536,
        encoder_layers=6, cross_attention=True,
        frontend="audio", frontend_tokens=ENCODER_FRAMES,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        max_position=512, frontend_tokens=12,
    )
