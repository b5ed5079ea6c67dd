"""Config registry of the port: the assigned architectures it serves so
far, and the paper's own blocks and end-to-end models."""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs import paper_blocks, qwen3_0_6b
from repro_torch.configs.base import ModelConfig, SPTConfig

_MODULES = {"qwen3-0.6b": qwen3_0_6b}

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
