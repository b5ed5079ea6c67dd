"""Routed FFN (paper §4.2, §5.2), plain torch.

W_I (d x D) is split into G row-groups of F = D/G columns and W_O into the
matching row groups.  A router x W_R picks the top-G' groups by |logit|
per token; only those blocks are computed:

    y = sum_{g in top-G'}  act(x W_I[g]) W_O[g]

The grouped path batches the tokens of each activated group through the
capacity plan of core/dispatch.py (one dense product per group, then a
scatter-add combine).  It is the oracle the CUDA kernels are held to.
The dense path (``impl="dense"``) runs the whole FFN and masks the hidden
columns of the groups a token did not choose: the per-token oracle, with
no capacity and so no drops.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch, lora
from repro_torch.core.params import ParamDef

ACTIVATIONS: Dict[str, Callable] = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
    "silu": F.silu,
}


@dataclasses.dataclass(frozen=True)
class RoutedFFNConfig:
    d_model: int
    d_ff: int
    num_groups: int = 8            # G
    active_groups: int = 4         # G'
    capacity_factor: float = 2.0
    activation: str = "relu"
    gated: bool = False            # GeGLU/SwiGLU (gate * up)
    gate_outputs: bool = False     # sigmoid(router logit) output gate
    capacity_pad: int = 8
    lb_loss_weight: float = 0.01

    @property
    def group_dim(self) -> int:
        if self.d_ff % self.num_groups:
            raise ValueError((self.d_ff, self.num_groups))
        return self.d_ff // self.num_groups


def param_defs(cfg: RoutedFFNConfig, lora_cfg: lora.LoRAConfig) -> dict:
    g, d, f = cfg.num_groups, cfg.d_model, cfg.group_dim
    bf16, f32 = torch.bfloat16, torch.float32
    defs = {
        "router": ParamDef((d, g), f32, ("embed", "group"), init="fan_in"),
        "w_inner": ParamDef((g, d, f), bf16, ("group", "embed", "ffn"),
                            init="fan_in", trainable=False),
        "w_outer": ParamDef((g, f, d), bf16, ("group", "ffn", "embed"),
                            init="fan_in", trainable=False),
    }
    if cfg.gated:
        defs["w_gate"] = ParamDef((g, d, f), bf16, ("group", "embed", "ffn"),
                                  init="fan_in",
                                  trainable=False)
    if lora_cfg.enabled:
        r = lora_cfg.rank
        inner = {"b": ParamDef((d, r), f32, ("embed", "lora_rank"),
                               init="fan_in"),
                 "c": ParamDef((g, r, f), f32, ("group", "lora_rank", "ffn"),
                               init="zeros")}
        defs["lora_inner"] = inner
        defs["lora_outer"] = {
            "b": ParamDef((g, f, r), f32, ("group", "ffn", "lora_rank"),
                          init="fan_in"),
            "c": ParamDef((r, d), f32, ("lora_rank", "embed"),
                          init="zeros")}
        if cfg.gated:
            defs["lora_gate"] = dict(inner)
    return defs


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: RoutedFFNConfig,
          need_aux: bool = True):
    """Top-G' groups by |logit| (paper: largest magnitude).
    x: (B, S, d) -> (choice (B,S,G') int32, gate (B,S,G') f32,
    probs (B,S,G) or None when need_aux is False)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1) if need_aux else None
    choice = torch.topk(logits.abs(), cfg.active_groups, dim=-1).indices
    if cfg.gate_outputs:
        gate = torch.sigmoid(logits.gather(-1, choice))
    else:
        gate = torch.ones(choice.shape, dtype=torch.float32,
                          device=x.device)
    return choice.to(torch.int32), gate, probs


def plan_for(x: torch.Tensor, choice: torch.Tensor, gate: torch.Tensor,
             cfg: RoutedFFNConfig,
             seq_lengths: Optional[torch.Tensor] = None
             ) -> dispatch.DispatchPlan:
    """The capacity plan of one call; seq_lengths gives right-padded
    ragged rows the capacity of their exact length."""
    s = x.shape[1]
    cap = dispatch.capacity(s, cfg.num_groups, cfg.active_groups,
                            cfg.capacity_factor, pad=cfg.capacity_pad)
    cap_dyn = None if seq_lengths is None else dispatch.capacity_dyn(
        seq_lengths, cfg.num_groups, cfg.active_groups,
        cfg.capacity_factor, pad=cfg.capacity_pad)
    return dispatch.make_plan(choice, gate, cfg.num_groups, cap,
                              cap_dyn=cap_dyn)


def _dense_forward(x: torch.Tensor, p, cfg: RoutedFFNConfig,
                   lora_cfg: lora.LoRAConfig,
                   hidden_mask: torch.Tensor) -> torch.Tensor:
    """The full dense FFN with the (B, S, D) hidden group mask applied."""
    g, d, f = p["w_inner"].shape[0], cfg.d_model, cfg.group_dim
    dt = x.dtype
    act = ACTIVATIONS[cfg.activation]

    def inner(w_key, lora_key):
        w = p[w_key].detach().transpose(0, 1).reshape(d, g * f)
        up = x @ w.to(dt)
        if lora_cfg.enabled and lora_key in p:
            li = p[lora_key]
            c = li["c"].transpose(0, 1).reshape(-1, g * f)
            up = up + lora_cfg.scale * ((x @ li["b"].to(dt)) @ c.to(dt))
        return up

    up = inner("w_inner", "lora_inner")
    h = act(inner("w_gate", "lora_gate")) * up if cfg.gated else act(up)
    h = h * hidden_mask.to(h.dtype)
    y = h @ p["w_outer"].detach().reshape(g * f, d).to(dt)
    if lora_cfg.enabled and "lora_outer" in p:
        lo = p["lora_outer"]
        hb = h @ lo["b"].reshape(g * f, -1).to(dt)
        y = y + lora_cfg.scale * (hb @ lo["c"].to(dt))
    return y


def _grouped_forward(x: torch.Tensor, p, cfg: RoutedFFNConfig,
                     lora_cfg: lora.LoRAConfig, choice: torch.Tensor,
                     gate_w: torch.Tensor,
                     seq_lengths: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BSpMV analogue: batch tokens per activated block, dense product per
    block, scatter-add combine."""
    plan = plan_for(x, choice, gate_w, cfg, seq_lengths)
    xg = dispatch.gather(x, plan)                        # (B, G, C, d)
    dt = x.dtype
    act = ACTIVATIONS[cfg.activation]

    def inner(w_key, lora_key):
        up = torch.einsum("bgcd,gdf->bgcf", xg, p[w_key].to(dt))
        if lora_cfg.enabled and lora_key in p:
            li = p[lora_key]
            xb = torch.einsum("bgcd,dr->bgcr", xg, li["b"].to(dt))
            up = up + lora_cfg.scale * torch.einsum(
                "bgcr,grf->bgcf", xb, li["c"].to(dt))
        return up

    up = inner("w_inner", "lora_inner")
    h = act(inner("w_gate", "lora_gate")) * up if cfg.gated else act(up)
    y = torch.einsum("bgcf,gfd->bgcd", h, p["w_outer"].to(dt))
    if lora_cfg.enabled and "lora_outer" in p:
        lo = p["lora_outer"]
        hb = torch.einsum("bgcf,gfr->bgcr", h, lo["b"].to(dt))
        y = y + lora_cfg.scale * torch.einsum("bgcr,rd->bgcd", hb,
                                              lo["c"].to(dt))
    return dispatch.combine(y, plan, x.shape[1]), plan.dropped


def routed_ffn(x: torch.Tensor, p, cfg: RoutedFFNConfig,
               lora_cfg: lora.LoRAConfig, impl: str = "grouped",
               need_aux: bool = True,
               seq_lengths: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Apply the routed FFN.  x: (B, S, d) (2-D inputs get a batch dim).
    impl: "grouped" (the capacity path) or "dense" (the per-token oracle,
    which needs no seq_lengths and drops nothing).  need_aux=False
    (inference) skips the router softmax and the load-balance loss;
    aux["lb_loss"] is then zero."""
    if impl not in ("grouped", "dense"):
        raise ValueError(f"unknown impl {impl!r}")
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    choice, gate_w, probs = route(x, p["router"], cfg, need_aux=need_aux)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if impl == "dense":
        oh = dispatch.one_hot(choice, cfg.num_groups)
        group_mask = (oh.float() * gate_w[..., None]).amax(2)   # (B, S, G)
        hidden_mask = group_mask.repeat_interleave(cfg.group_dim, dim=-1)
        y, dropped = _dense_forward(x, p, cfg, lora_cfg, hidden_mask), zero
    else:
        y, dropped = _grouped_forward(x, p, cfg, lora_cfg, choice, gate_w,
                                      seq_lengths=seq_lengths)
    aux = {"lb_loss": (dispatch.load_balance_loss(probs, choice,
                                                  cfg.num_groups)
                       if need_aux else zero),
           "dropped": dropped}
    y = y.to(x.dtype)
    return (y[0] if squeeze else y), aux
