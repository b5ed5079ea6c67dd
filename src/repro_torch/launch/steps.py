"""Step builders (single device; the JAX package's without their
sharding): the train step — forward, chunked cross-entropy, backward into
the trainable leaves, AdamW — and the serving prefill and decode steps."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import params as P
from repro_torch.optim.adamw import OptimizerConfig, adamw_update
from repro_torch.serving import engine
from repro_torch.train import state as S
from repro_torch.train.loss import lm_cross_entropy


def loss_and_grads(state: dict, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor], loss_chunk: int = 512):
    """(total loss, metrics, grads) of one batch; grads has the train
    tree's structure (zeros where no path from the loss reaches a leaf;
    empty when nothing is trainable, as under the "full" variant).
    total = lm + lb_w * lb / num_layers (+ qerr_w * qerr / num_layers)."""
    pairs = list(P.leaves(state["train"]))
    paths = [p for p, _ in pairs]
    train_vals = [v.detach().requires_grad_(True) for _, v in pairs]
    train = P.unflatten(paths, train_vals)
    params = P.combine(train, state["frozen"])
    with torch.enable_grad():
        hidden, aux = S.model_hidden(params, cfg, batch, remat=True)
        lm_loss, stats = lm_cross_entropy(params, cfg, hidden,
                                          batch["labels"], loss_chunk)
        nl = max(1, cfg.num_layers)
        total = lm_loss + cfg.spt.lb_loss_weight * aux["lb_loss"] / nl
        if cfg.spt.qerr_loss_weight:
            total = total + cfg.spt.qerr_loss_weight * aux["qerr"] / nl
        grads = (torch.autograd.grad(total, train_vals, allow_unused=True)
                 if train_vals else [])
    # a leaf no path reaches has a zero gradient, as jax.grad gives it
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(train_vals, grads)]
    metrics = {"lm_loss": lm_loss, **stats, "lb_loss": aux["lb_loss"],
               "dropped": aux["dropped"]}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, P.unflatten(paths, grads)


def build_train_step(cfg: ModelConfig, ocfg: OptimizerConfig,
                     loss_chunk: int = 512) -> Callable:
    """train_step(state, batch) -> (new_state, metrics): loss, lm_loss,
    nll_sum, tokens, accuracy, lb_loss, dropped, grad_norm, lr (0-d
    tensors).  batch: {"tokens", "labels"} (B, S) integer tensors on the
    state's device."""
    def train_step(state: dict, batch: Dict[str, torch.Tensor]):
        loss, metrics, grads = loss_and_grads(state, cfg, batch, loss_chunk)
        new_train, new_opt, om = adamw_update(
            state["train"], grads, state["opt"], state["step"], ocfg)
        new_state = {"step": state["step"] + 1, "train": new_train,
                     "frozen": state["frozen"], "opt": new_opt}
        return new_state, {"loss": loss, **metrics, **om}

    return train_step


def build_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    return engine.build_prefill_step(cfg, max_len)


def build_decode_step(cfg: ModelConfig) -> Callable:
    return engine.build_decode_step(cfg)
