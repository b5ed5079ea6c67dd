"""Train state: {step, train (LoRA/router/codebooks), frozen (base), opt}.

The trainable/frozen split is at the tree level (core.params.partition),
so gradients are only ever taken over the small trainable subtree; the
frozen base never gets gradient buffers.  The layout is the JAX
package's, so a JAX state loads with ``core.params.from_numpy_state``.
The step counter is a 0-d int32 tensor on the host whatever the device of
the rest: the learning rate is computed there from it
(``optim/schedule.lr_at``), with no device-to-host read in a step.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import params as P
from repro_torch.models import encdec, transformer
from repro_torch.optim.adamw import adamw_init


def model_defs(cfg: ModelConfig) -> dict:
    """The param defs of a model: the encoder-decoder for the audio
    family, the decoder-only LM otherwise."""
    if cfg.family == "audio":
        return encdec.encdec_defs(cfg)
    return transformer.lm_defs(cfg)


def model_hidden(params: dict, cfg: ModelConfig, batch: Dict[str, Any],
                 remat: bool = True):
    if cfg.family == "audio":
        return encdec.encdec_hidden(params, cfg, batch, remat=remat)
    return transformer.lm_hidden(params, cfg, batch, remat=remat)


def init_state(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights from a seed on ``device`` (CUDA unless the caller
    asks for the CPU), split into trainable and frozen trees, with zero
    AdamW moments."""
    dev = transformer.resolve_device(device)
    defs = model_defs(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = P.init_tree(defs, gen)
    train, frozen = P.partition(params, P.trainable_mask(defs))
    return {"step": torch.zeros((), dtype=torch.int32),
            "train": train, "frozen": frozen, "opt": adamw_init(train)}


def abstract_state(cfg: ModelConfig) -> dict:
    """The state ``init_state`` gives, as meta tensors (no storage, no
    data): what one rank holds, for a dry run (launch/dryrun.py).  The
    step counter stays a 0-d CPU tensor, as in every state."""
    defs = model_defs(cfg)
    train, frozen = P.partition(P.abstract_tree(defs),
                                P.trainable_mask(defs))
    return {"step": torch.zeros((), dtype=torch.int32),
            "train": train, "frozen": frozen, "opt": adamw_init(train)}


def state_device(state: dict) -> torch.device:
    """The device a state's parameters live on (the step counter is on
    the host)."""
    for part in ("frozen", "train"):
        for _, t in P.leaves(state[part]):
            if t is not None:
                return t.device
    return state["step"].device


def state_specs(cfg: ModelConfig, rules) -> dict:
    """The state's placement tree under ``rules`` (JAX's ``PartitionSpec``
    tree read as tuples; core/params.spec_tree).  The port keeps every
    leaf whole on every rank and slices its shard where it is used, as
    the JAX Trainer jits its step on whole arrays."""
    defs = model_defs(cfg)
    train_s, frozen_s = P.partition(P.spec_tree(defs, rules),
                                    P.trainable_mask(defs))
    return {"step": (), "train": train_s, "frozen": frozen_s,
            "opt": {"m": train_s, "v": train_s}}


def param_specs(cfg: ModelConfig, rules) -> dict:
    return P.spec_tree(model_defs(cfg), rules)


def full_params(state: dict) -> dict:
    """The model's whole parameter tree: the trainable and frozen halves
    of ``state`` put back together."""
    return P.combine(state["train"], state["frozen"])
