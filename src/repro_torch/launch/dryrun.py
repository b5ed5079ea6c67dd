"""The paper's baselines as configs: ``apply_variant`` (the JAX package's
``launch/dryrun.py`` keeps it beside its multi-pod AOT lowering; that
lowering is JAX-specific and is not ported — only the variant logic,
which the launchers share, lives here)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import LoRAConfig

VARIANTS = ("spt", "lora", "full")


def apply_variant(cfg: ModelConfig, variant: str) -> ModelConfig:
    """spt: the config as given (sparse MHA, routed FFN, LoRA); lora:
    dense attention and FFN with LoRA; full: dense, LoRA off (the base
    weights are frozen leaves, so nothing is trainable — as in JAX)."""
    if variant == "spt":
        return cfg
    if variant == "lora":
        return cfg.with_spt(sparse_mha=False, routed_ffn=False)
    if variant == "full":
        return cfg.with_spt(sparse_mha=False, routed_ffn=False,
                            lora=LoRAConfig(enabled=False))
    raise ValueError(variant)
