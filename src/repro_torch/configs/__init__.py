"""Config registry of the port: the ten assigned architectures, and the
paper's own blocks and end-to-end models."""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs import (gemma_7b, grok_1_314b, h2o_danube_1_8b,
                                 h2o_danube_3_4b, mamba2_780m,
                                 mixtral_8x22b, paper_blocks,
                                 phi_3_vision_4_2b, qwen3_0_6b,
                                 recurrentgemma_9b, whisper_base)
from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME, ModelConfig,
                                      ShapeSpec, SPTConfig)

_MODULES = {
    "grok-1-314b": grok_1_314b,
    "mixtral-8x22b": mixtral_8x22b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "phi-3-vision-4.2b": phi_3_vision_4_2b,
    "mamba2-780m": mamba2_780m,
    "qwen3-0.6b": qwen3_0_6b,
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "gemma-7b": gemma_7b,
    "h2o-danube-3-4b": h2o_danube_3_4b,
    "whisper-base": whisper_base,
}

ARCH_NAMES: Tuple[str, ...] = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name in _MODULES:
        return _MODULES[name].config()
    pb = paper_blocks.blocks()
    if name in pb:
        return pb[name]
    if name == "opt-2.7b":
        return paper_blocks.opt_2_7b()
    if name == "llama-2.7b":
        return paper_blocks.llama_2_7b()
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")


def get_smoke(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return _MODULES[name].smoke()


# (arch, shape) applicability: long_500k needs a sub-quadratic path —
# SSM state, RG-LRU+local window, or SWA-bounded KV.
_LONG_OK = {"mamba2-780m", "recurrentgemma-9b", "mixtral-8x22b",
            "h2o-danube-1.8b", "h2o-danube-3-4b"}


def cell_supported(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in _LONG_OK:
        return False, ("pure full-attention arch: 500k dense KV decode is "
                       "architecturally unsupported (no window/state)")
    return True, ""
