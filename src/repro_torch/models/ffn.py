"""FFN layer: dense (Full/LoRA baseline) or the paper's routed FFN.

Routed-FFN execution paths (selected by core/dispatch.py, JAX semantics):
  * ``spt.ffn_impl="pallas"`` — the grouped-FFN CUDA kernel with the token
    gather in the kernel; REPRO_DISABLE_KERNELS=1 demotes it to "grouped";
  * ``mode="decode"`` at (B, 1, d) — the block-gather decode CUDA kernel
    when ``dispatch.use_decode_ffn_kernel(cfg)`` says so;
  * ``"grouped"`` — the core/ capacity path (the oracle);
    ``"grouped_shmap"`` runs it too, as JAX does without a mesh.
Inference modes skip the router softmax and the load-balance loss.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch, lora, routed_ffn


def _routed_cfg(cfg: ModelConfig) -> routed_ffn.RoutedFFNConfig:
    return routed_ffn.RoutedFFNConfig(
        d_model=cfg.d_model, d_ff=cfg.d_ff,
        num_groups=cfg.spt.ffn_groups,
        active_groups=cfg.spt.ffn_active_groups,
        capacity_factor=cfg.spt.ffn_capacity_factor,
        capacity_pad=cfg.spt.dispatch_pad,
        activation=cfg.activation, gated=cfg.gated_ffn,
        lb_loss_weight=cfg.spt.lb_loss_weight)


def routed_applicable(cfg: ModelConfig) -> bool:
    return (cfg.spt.routed_ffn and cfg.d_ff > 0
            and cfg.d_ff % cfg.spt.ffn_groups == 0)


def ffn_defs(cfg: ModelConfig) -> dict:
    lc = cfg.spt.lora
    if routed_applicable(cfg):
        return routed_ffn.param_defs(_routed_cfg(cfg), lc)
    d, f = cfg.d_model, cfg.d_ff
    defs = {"wi": lora.linear_defs(d, f, lc), "wo": lora.linear_defs(f, d, lc)}
    if cfg.gated_ffn:
        defs["wg"] = lora.linear_defs(d, f, lc)
    return defs


def _tel_expert_load(choice: torch.Tensor, num_groups: int, x: torch.Tensor,
                     seq_lengths) -> torch.Tensor:
    """(B, G) per-row token->group load from the router's top-G' choices
    (telemetry); right-pad rows of a ragged prefill batch are masked out,
    so loads count real tokens only."""
    oh = torch.nn.functional.one_hot(choice.long(), num_groups).float()
    if seq_lengths is not None:                          # (B, S, G', G)
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < seq_lengths[:, None]).float()
        oh = oh * valid[:, :, None, None]
    return oh.sum((1, 2))


def _routed_forward(p, x: torch.Tensor, cfg: ModelConfig, mode: str,
                    seq_lengths=None) -> Tuple[torch.Tensor, dict]:
    lc = cfg.spt.lora
    rcfg = _routed_cfg(cfg)
    need_aux = mode == "train"
    if mode == "decode" and x.dim() == 3 and x.shape[1] == 1:
        if dispatch.use_decode_ffn_kernel(cfg):
            from repro_torch.kernels.routed_ffn import ops as rffn_ops
            return rffn_ops.routed_ffn_decode(x, p, rcfg, lc)
        if cfg.spt.decode_ffn_impl == "jnp":
            return routed_ffn.routed_ffn(x, p, rcfg, lc, impl="grouped",
                                         need_aux=False)
    impl = cfg.spt.ffn_impl
    if impl == "pallas":
        if dispatch.use_routed_ffn_kernel(cfg):
            from repro_torch.kernels.routed_ffn import ops as rffn_ops
            return rffn_ops.routed_ffn(x, p, rcfg, lc, need_aux=need_aux,
                                       seq_lengths=seq_lengths)
        impl = "grouped"                             # REPRO_DISABLE_KERNELS=1
    if impl == "grouped_shmap":
        # the sharded path (core/ffn_shmap.py) is not ported: one card has
        # no mesh, where JAX falls back to "grouped" as well
        impl = "grouped"
    return routed_ffn.routed_ffn(x, p, rcfg, lc, impl=impl,
                                 need_aux=need_aux, seq_lengths=seq_lengths)


def _routed_apply(p, x: torch.Tensor, cfg: ModelConfig, mode: str,
                  seq_lengths=None) -> Tuple[torch.Tensor, dict]:
    y, aux = _routed_forward(p, x, cfg, mode, seq_lengths)
    if (dispatch.use_telemetry_counters(cfg) and x.dim() == 3
            and mode in ("prefill", "decode")):
        # telemetry counters: re-run the (small) router product so the
        # kernel and plain paths report the same loads
        rcfg = _routed_cfg(cfg)
        choice, _, _ = routed_ffn.route(x, p["router"], rcfg,
                                        need_aux=False)
        aux = dict(aux)
        aux["tel_expert_load"] = _tel_expert_load(
            choice, rcfg.num_groups, x, seq_lengths)
        aux["tel_expert_drop"] = torch.as_tensor(
            aux.get("dropped", 0.0), dtype=torch.float32, device=x.device)
    return y, aux


def ffn_apply(p, x: torch.Tensor, cfg: ModelConfig, mode: str = "train",
              seq_lengths=None) -> Tuple[torch.Tensor, dict]:
    """seq_lengths: per-row real lengths (B,) of a ragged prefill batch —
    the routed paths give each row its exact-length dispatch capacity."""
    lc = cfg.spt.lora
    if routed_applicable(cfg):
        return _routed_apply(p, x, cfg, mode, seq_lengths=seq_lengths)
    act = routed_ffn.ACTIVATIONS[cfg.activation]
    up = lora.linear(x, p["wi"], lc)
    h = act(lora.linear(x, p["wg"], lc)) * up if cfg.gated_ffn else act(up)
    return lora.linear(h, p["wo"], lc), {}
