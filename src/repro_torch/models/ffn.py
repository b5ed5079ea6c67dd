"""FFN layer: dense (Full/LoRA baseline) or the paper's routed FFN.

Routed-FFN execution paths (selected by core/dispatch.py, JAX semantics):
  * ``spt.ffn_impl="pallas"`` — the grouped-FFN CUDA kernel with the token
    gather in the kernel; REPRO_DISABLE_KERNELS=1 demotes it to "grouped";
  * ``mode="decode"`` at (B, 1, d) — the block-gather decode CUDA kernel
    when ``dispatch.use_decode_ffn_kernel(cfg)`` says so;
  * ``"grouped"`` — the core/ capacity path (the oracle);
  * ``"grouped_shmap"`` — under a mesh, the explicit sequence-parallel
    schedule of core/ffn_shmap.py where ``ffn_shmap.applicable`` holds
    and the residual is sequence-sharded (or the model axis has extent
    1); ``"grouped"`` otherwise, as in JAX.
Inference modes skip the router softmax and the load-balance loss.

Under the sequence-parallel layout (``tp``, train mode) the default
paths form a tensor-parallel region: the sequence is gathered, this
rank's F/n hidden columns run (of each group, for the routed FFN: kernel
9 at the shard's widths on the default path) and the partial output is
reduce-scattered back over the sequence; a width that does not divide
runs replicated, as the rules fall back.  Serving under a mesh
(``transformer.ShardedLM``) runs the same split (``tp_specs``, sliced
once) with x whole: kernel 9 (prefill) or 10 (decode) at F/n, the
partial output summed over the model axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core import dispatch, ffn_shmap, lora, routed_ffn
from repro_torch.core.params import spec_tree
from repro_torch.sharding.context import current_rules


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
    defs = {"wi": lora.linear_defs(d, f, lc, "embed", "ffn"),
            "wo": lora.linear_defs(f, d, lc, "ffn", "embed")}
    if cfg.gated_ffn:
        defs["wg"] = lora.linear_defs(d, f, lc, "embed", "ffn")
    return defs


def _tel_expert_load(choice: torch.Tensor, num_groups: int, x: torch.Tensor,
                     seq_lengths) -> torch.Tensor:
    """(B, G) per-row token->group load from the router's top-G' choices
    (telemetry); right-pad rows of a ragged prefill batch are masked out,
    so loads count real tokens only."""
    oh = dispatch.one_hot(choice, num_groups, torch.float32)
    if seq_lengths is not None:                          # (B, S, G', G)
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < seq_lengths[:, None]).float()
        oh = oh * valid[:, :, None, None]
    return oh.sum((1, 2))


def _shmap_mesh(cfg: ModelConfig, x: torch.Tensor, seq_lengths,
                tp: Optional[C.Axis]):
    """The mesh of the rules when ``grouped_shmap`` takes core/ffn_shmap
    for x (this rank's rows, and with ``tp`` its sequence chunk): the
    residual must be sequence-sharded on the model axis, so a model axis
    of extent > 1 needs the sequence-parallel layout and the columns
    stored split over it (``tp_plan``); else None."""
    mesh = (current_rules() or {}).get("__mesh__")
    if mesh is None or x.dim() != 3 or seq_lengths is not None:
        return None
    model = C.mesh_axis(mesh, "model")
    if tp is None and model is not None:
        return None
    if model is not None and tp_plan(cfg, model.size) is None:
        return None                 # stored whole (train/state.py)
    dp = C.batch_axis()
    seq = x.shape[1] * (tp.size if tp else 1)
    batch = x.shape[0] * (dp.size if dp else 1)
    return (mesh if ffn_shmap.applicable(mesh, _routed_cfg(cfg), cfg.d_ff,
                                         seq, batch) else None)


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
        mesh = _shmap_mesh(cfg, x, seq_lengths, None)
        if mesh is not None:
            return ffn_shmap.routed_ffn_shmap(x, p, rcfg, lc, mesh,
                                              need_aux=need_aux)
        impl = "grouped"                 # no mesh, or not applicable
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


def tp_plan(cfg: ModelConfig, n: int) -> Optional[ModelConfig]:
    """The config of this rank's F/n hidden columns (of each routed
    group); None when the width does not divide by n, or where the
    routed kernels run (9 and 10 read 16-byte rows of F) when F/n is not
    a multiple of 8 (h2o-danube-1.8b's 864 columns over 16 ranks)."""
    routed = routed_applicable(cfg)
    width = _routed_cfg(cfg).group_dim if routed else cfg.d_ff
    if width == 0 or width % n:
        return None
    if routed and (width // n) % 8 and (
            dispatch.use_routed_ffn_kernel(cfg)
            or dispatch.use_decode_ffn_kernel(cfg)):
        return None
    return dataclasses.replace(cfg, d_ff=cfg.d_ff // n)


def tp_specs(cfg: ModelConfig, n: int) -> dict:
    """Placements of ``ffn_defs(cfg)`` under ``tp_plan``."""
    return spec_tree(ffn_defs(cfg), {"ffn": "model",
                                     "__sizes__": {"model": n}})


def _ffn_region(p, x: torch.Tensor, cfg: ModelConfig, mode: str,
                tp: C.Axis) -> Tuple[torch.Tensor, dict]:
    """Train-mode FFN on this rank's sequence chunk x (B, S/n, d): the
    whole sequence in, this rank's F/n hidden columns (of each routed
    group) where they divide by n (else every column, replicated), the
    output's chunk out.  The routing and ``lb_loss`` are computed alike
    on every rank; ``lb_loss`` leaves the region by ``mean_exit``."""
    C.train_layout(mode)
    routed = routed_applicable(cfg)
    if routed and cfg.spt.ffn_impl == "grouped_shmap":
        mesh = _shmap_mesh(cfg, x, None, tp)
        if mesh is not None:
            return ffn_shmap.routed_ffn_shmap(x, p, _routed_cfg(cfg),
                                              cfg.spt.lora, mesh)
    local = tp_plan(cfg, tp.size)
    if local is not None:
        xf, p = C.enter_region(x, p, tp_specs(cfg, tp.size), tp)
        y, aux = ffn_apply(p, xf, local, mode)
        y = C.scatter_seq(y, tp)
    else:
        xf, p = C.enter_region(x, p, None, tp)
        y, aux = ffn_apply(p, xf, cfg, mode)
        y = C.split_seq(y, tp)
    if "lb_loss" in aux:
        aux = {**aux, "lb_loss": C.mean_exit(aux["lb_loss"], tp)}
    return y, aux


def ffn_apply(p, x: torch.Tensor, cfg: ModelConfig, mode: str = "train",
              seq_lengths=None, tp: Optional[C.Axis] = None
              ) -> Tuple[torch.Tensor, dict]:
    """seq_lengths: per-row real lengths (B,) of a ragged prefill batch —
    the routed paths give each row its exact-length dispatch capacity.
    tp: the model axis of the sequence-parallel layout (train mode); x is
    then this rank's sequence chunk, and so is y."""
    if tp is not None:
        return _ffn_region(p, x, cfg, mode, tp)
    lc = cfg.spt.lora
    if routed_applicable(cfg):
        return _routed_apply(p, x, cfg, mode, seq_lengths=seq_lengths)
    act = routed_ffn.ACTIVATIONS[cfg.activation]
    up = lora.linear(x, p["wi"], lc)
    h = act(lora.linear(x, p["wg"], lc)) * up if cfg.gated_ffn else act(up)
    return lora.linear(h, p["wo"], lc), {}
