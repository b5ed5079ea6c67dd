"""The paper's Table 2 Transformer-block configurations, and its two
end-to-end models (the port's copy of the JAX package's module).

| Name       | d_model | d_head | d_ffn  | source model          |
| OPT-1024   | 1024    | 64     | 4096   | GPT2-medium, OPT-350M |
| OPT-2048   | 2048    | 64     | 8192   | OPT-1.3B              |
| OPT-2560   | 2560    | 80     | 10240  | OPT-2.7B              |
| LLaMA-2560 | 2560    | 128    | 6912   | Sheared-LLaMA-2.7B    |
| LLaMA-4096 | 4096    | 128    | 11008  | Open-LLaMA-7B         |

OPT blocks: ReLU FFN, LayerNorm, learned positions (paper §6.1).
LLaMA blocks: SwiGLU, RMSNorm, RoPE.
``num_layers=1`` — the paper benchmarks single blocks.
"""
import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig


def _opt(name: str, d_model: int, d_head: int, d_ffn: int) -> ModelConfig:
    return ModelConfig(
        name=name, family="dense", num_layers=1,
        d_model=d_model, num_heads=d_model // d_head,
        num_kv_heads=d_model // d_head, head_dim=d_head, d_ff=d_ffn,
        vocab_size=50272, pattern=("attn",), activation="relu",
        gated_ffn=False, norm="layernorm", rope_theta=None,
        positional="learned", max_position=8192,
    )


def _llama(name: str, d_model: int, d_head: int, d_ffn: int) -> ModelConfig:
    return ModelConfig(
        name=name, family="dense", num_layers=1,
        d_model=d_model, num_heads=d_model // d_head,
        num_kv_heads=d_model // d_head, head_dim=d_head, d_ff=d_ffn,
        vocab_size=32000, pattern=("attn",), activation="silu",
        gated_ffn=True, norm="rmsnorm", rope_theta=10000.0,
    )


def blocks() -> Dict[str, ModelConfig]:
    return {
        "opt-1024": _opt("opt-1024", 1024, 64, 4096),
        "opt-2048": _opt("opt-2048", 2048, 64, 8192),
        "opt-2560": _opt("opt-2560", 2560, 80, 10240),
        "llama-2560": _llama("llama-2560", 2560, 128, 6912),
        "llama-4096": _llama("llama-4096", 4096, 128, 11008),
    }


def opt_2_7b(num_layers: int = 32) -> ModelConfig:
    """OPT-2.7B (the paper's end-to-end model): 32 x OPT-2560 blocks."""
    return dataclasses.replace(_opt("opt-2.7b", 2560, 80, 10240),
                               num_layers=num_layers)


def llama_2_7b(num_layers: int = 32) -> ModelConfig:
    """Sheared-LLaMA-2.7B (the paper's end-to-end model): 32 x LLaMA-2560."""
    return dataclasses.replace(_llama("llama-2.7b", 2560, 128, 6912),
                               num_layers=num_layers)
