"""Config registry of the port (the architectures it serves so far)."""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs import qwen3_0_6b
from repro_torch.configs.base import ModelConfig, SPTConfig

_MODULES = {"qwen3-0.6b": qwen3_0_6b}

ARCH_NAMES: Tuple[str, ...] = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return _MODULES[name].config()


def get_smoke(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return _MODULES[name].smoke()
