"""Mixture-of-Experts FFN (grok-1 / mixtral style: softmax top-k of E).

The capacity-bucketed dispatch of core/dispatch.py that carries the
paper's routed FFN carries MoE too, at expert granularity: experts are the
groups, ``experts_per_token`` the active count.  So the routed-FFN CUDA
kernels serve MoE unchanged: ``spt.ffn_impl="pallas"`` sends train and
prefill through the grouped-FFN kernel (the token gather in the kernel on
the plan index, softmax top-k gates in place of the |logit| router) with
the plain capacity path as the differentiated reference, and decode at
(B, 1, d) through the decode-FFN kernel (the top-k expert ids index the
weight blocks: no plan, no dispatch buffer).  ``REPRO_DISABLE_KERNELS=1``
sends every path to the plain one.

Under a model axis of extent n each expert's hidden columns split over
it (``tp_plan``; the router runs alike on every rank, so the choices,
plans, ``lb_loss`` and ``dropped`` are the unsharded ones): kernels 9
and 10 run at F/n, and the partial output is reduce-scattered over the
sequence (train, the sequence-parallel layout) or, serving
(``transformer.ShardedLM``), summed over the model axis.  A rank stores
a 1/data share of its columns besides (``storage_specs``, ZeRO-3) and
all-gathers them over the data axis where a layer uses them, forward
only for the frozen weights.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core import dispatch
from repro_torch.core.params import ParamDef, leaves, spec_tree
from repro_torch.core.routed_ffn import ACTIVATIONS
from repro_torch.sharding.context import current_rules


def moe_defs(cfg: ModelConfig) -> dict:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    lc = cfg.spt.lora
    bf16, f32 = torch.bfloat16, torch.float32
    defs = {
        "router": ParamDef((d, e), f32, ("embed", "expert"), init="fan_in"),
        "wi": ParamDef((e, d, f), bf16, ("expert", "embed", "expert_ffn"),
                       init="fan_in", trainable=False),
        "wo": ParamDef((e, f, d), bf16, ("expert", "expert_ffn", "embed"),
                       init="fan_in", trainable=False),
    }
    if cfg.gated_ffn:
        defs["wg"] = ParamDef((e, d, f), bf16,
                              ("expert", "embed", "expert_ffn"), init="fan_in",
                              trainable=False)
    if lc.enabled:
        r = lc.rank
        defs["lora_wi"] = {
            "b": ParamDef((d, r), f32, ("embed", "lora_rank"), init="fan_in"),
            "c": ParamDef((e, r, f), f32,
                          ("expert", "lora_rank", "expert_ffn"),
                          init="zeros")}
        defs["lora_wo"] = {
            "b": ParamDef((e, f, r), f32,
                          ("expert", "expert_ffn", "lora_rank"),
                          init="fan_in"),
            "c": ParamDef((r, d), f32, ("lora_rank", "embed"), init="zeros")}
        if cfg.gated_ffn:
            # JAX names this C's last axis "ffn" (not "expert_ffn")
            defs["lora_wg"] = {
                "b": ParamDef((d, r), f32, ("embed", "lora_rank"),
                              init="fan_in"),
                "c": ParamDef((e, r, f), f32, ("expert", "lora_rank", "ffn"),
                              init="zeros")}
    return defs


def _route_experts(p, x: torch.Tensor, cfg: ModelConfig):
    """Softmax router: (choice (B,S,k) int32, gate (B,S,k) f32
    renormalised over the top-k, probs (B,S,E) f32).  The top-k is a
    stable descending sort, so a tie goes to the lower expert index, as
    ``jax.lax.top_k`` breaks it."""
    k = cfg.experts_per_token
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, choice = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, choice = gate[..., :k], choice[..., :k]
    gate = gate / gate.sum(-1, keepdim=True)          # renormalise top-k
    return choice.to(torch.int32), gate, probs


def _moe_lora_tree(p) -> Optional[dict]:
    """The MoE LoRA leaves under the routed-FFN kernels' names (the same
    shapes: experts are the group axis)."""
    if "lora_wi" not in p:
        return None
    t = {"lora_inner": p["lora_wi"], "lora_outer": p["lora_wo"]}
    if "lora_wg" in p:
        t["lora_gate"] = p["lora_wg"]
    return t


def _moe_cap_dyn(cfg: ModelConfig, seq_lengths):
    if seq_lengths is None:
        return None
    return dispatch.capacity_dyn(seq_lengths, cfg.num_experts,
                                 cfg.experts_per_token,
                                 cfg.moe_capacity_factor,
                                 pad=cfg.spt.dispatch_pad)


def _plan(x: torch.Tensor, choice, gate, cfg: ModelConfig, seq_lengths):
    cap = dispatch.capacity(x.shape[1], cfg.num_experts,
                            cfg.experts_per_token, cfg.moe_capacity_factor,
                            pad=cfg.spt.dispatch_pad)
    return dispatch.make_plan(choice, gate, cfg.num_experts, cap,
                              cap_dyn=_moe_cap_dyn(cfg, seq_lengths))


def _aux(probs, choice, cfg: ModelConfig, need_aux: bool, dropped, device):
    lb = (dispatch.load_balance_loss(probs, choice, cfg.num_experts)
          if need_aux else torch.zeros((), dtype=torch.float32,
                                       device=device))
    return {"lb_loss": lb, "dropped": dropped}


def _moe_reference(x: torch.Tensor, p, cfg: ModelConfig, need_aux: bool,
                   seq_lengths=None) -> Tuple[torch.Tensor, dict]:
    """The plain capacity-dispatch path: the oracle of the kernels and the
    differentiated reference of the kernel forward."""
    lc = cfg.spt.lora
    dt = x.dtype
    choice, gate, probs = _route_experts(p, x, cfg)
    plan = _plan(x, choice, gate, cfg, seq_lengths)
    xg = dispatch.gather(x, plan)                        # (B, E, C, d)

    def proj_in(w_key, lora_key):
        up = torch.einsum("becd,edf->becf", xg, p[w_key].detach().to(dt))
        if lc.enabled and lora_key in p:
            li = p[lora_key]
            xb = torch.einsum("becd,dr->becr", xg, li["b"].to(dt))
            up = up + lc.scale * torch.einsum("becr,erf->becf", xb,
                                              li["c"].to(dt))
        return up

    act = ACTIVATIONS[cfg.activation]
    up = proj_in("wi", "lora_wi")
    h = act(proj_in("wg", "lora_wg")) * up if cfg.gated_ffn else act(up)
    y = torch.einsum("becf,efd->becd", h, p["wo"].detach().to(dt))
    if lc.enabled and "lora_wo" in p:
        lo = p["lora_wo"]
        hb = torch.einsum("becf,efr->becr", h, lo["b"].to(dt))
        y = y + lc.scale * torch.einsum("becr,rd->becd", hb, lo["c"].to(dt))
    out = dispatch.combine(y, plan, x.shape[1]).to(dt)
    return out, _aux(probs, choice, cfg, need_aux, plan.dropped, x.device)


def _moe_kernel_forward(x: torch.Tensor, p, cfg: ModelConfig,
                        need_aux: bool, seq_lengths=None
                        ) -> Tuple[torch.Tensor, dict]:
    """Route and plan in torch, the expert products in the grouped-FFN
    kernel (kernel 9, the token gather inside it on the plan index), the
    combine scatter in torch."""
    from repro_torch.kernels.routed_ffn import ops as rffn_ops
    choice, gate, probs = _route_experts(p, x, cfg)
    plan = _plan(x, choice, gate, cfg, seq_lengths)
    y = rffn_ops.grouped_ffn(
        x.contiguous(), plan.index, p["wi"].detach(), p["wo"].detach(),
        p["wg"].detach() if cfg.gated_ffn else None, _moe_lora_tree(p),
        cfg.spt.lora.scale, act=cfg.activation)
    out = dispatch.combine(y.to(x.dtype), plan, x.shape[1])
    return out, _aux(probs, choice, cfg, need_aux, plan.dropped, x.device)


def _moe_kernel_op(x: torch.Tensor, p, cfg: ModelConfig, need_aux: bool):
    """The kernel forward with the reference's gradients (JAX's
    ``_moe_kernel_op`` custom_vjp): the same routing plan, so the same
    function."""
    from repro_torch.kernels.routed_ffn import ops as rffn_ops

    def fwd(x_, p_):
        out, aux = _moe_kernel_forward(x_, p_, cfg, need_aux)
        return out, aux["lb_loss"], aux["dropped"]

    def ref(x_, p_):
        out, aux = _moe_reference(x_, p_, cfg, need_aux)
        return out, aux["lb_loss"]

    out, lb, dropped = rffn_ops.kernel_forward(x, p, fwd, ref)
    return out, {"lb_loss": lb, "dropped": dropped}


def _moe_decode_kernel(x: torch.Tensor, p, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, dict]:
    """Decode at (B, 1, d): the top-k expert ids index the expert weight
    blocks inside the decode-FFN kernel (kernel 10).  Inference-only."""
    from repro_torch.kernels.routed_ffn import ops as rffn_ops
    choice, gate, _ = _route_experts(p, x, cfg)
    y = rffn_ops.decode_ffn(
        x[:, 0].contiguous(), choice[:, 0].contiguous(),
        gate[:, 0].contiguous(), p["wi"], p["wo"],
        p["wg"] if cfg.gated_ffn else None, _moe_lora_tree(p),
        cfg.spt.lora.scale, act=cfg.activation)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return y.to(x.dtype)[:, None], {"lb_loss": zero, "dropped": zero}


def tp_plan(cfg: ModelConfig, n: int) -> Optional[ModelConfig]:
    """The config of this rank's F/n columns of every expert; None when F
    does not divide by n."""
    if cfg.d_ff % n:
        return None
    return dataclasses.replace(cfg, d_ff=cfg.d_ff // n)


def tp_specs(cfg: ModelConfig, n: int) -> dict:
    """Placements of ``moe_defs(cfg)`` under ``tp_plan``: the experts'
    hidden columns over the model axis (the rules' ``expert_ffn`` also
    places them over data, for storage; the compute splits over model)."""
    return spec_tree(moe_defs(cfg), {"expert_ffn": "model", "ffn": "model",
                                     "__sizes__": {"model": n}})


def storage_specs(cfg: ModelConfig, sizes) -> dict:
    """The placements ``moe_defs(cfg)`` are stored under on a mesh of
    axis extents ``sizes``: ``tp_specs`` where ``tp_plan`` splits, and
    the ``expert_ffn`` dims over the data axis as well where the model
    chunk divides by its extent — JAX's ("data", "model") ZeRO-3 rule,
    ordered model-major here, so that the data gather at use gives the
    region's model chunk of the columns (the bytes a rank stores are the
    same); every leaf whole where the columns do not split over model."""
    n, dsz = sizes.get("model", 1), sizes.get(C.ZERO_AXIS, 1)
    defs = moe_defs(cfg)
    if (n == 1 and dsz == 1) or tp_plan(cfg, n) is None:
        return spec_tree(defs, {})
    specs = tp_specs(cfg, n)
    if dsz == 1 or (cfg.d_ff // n) % dsz:
        return specs

    def walk(d, sp):
        if isinstance(d, ParamDef):
            return tuple(("model", C.ZERO_AXIS) if a == "expert_ffn" else e
                         for a, e in zip(d.axes, sp))
        return {k: walk(d[k], sp[k]) for k in d}
    return walk(defs, specs)


def _stored(cfg: ModelConfig) -> Optional[dict]:
    """``storage_specs`` under the active rules (None without them)."""
    rules = current_rules()
    return None if rules is None else storage_specs(
        cfg, rules.get("__sizes__", {}))


def _moe_region(p, x: torch.Tensor, cfg: ModelConfig, mode: str,
                tp: C.Axis) -> Tuple[torch.Tensor, dict]:
    """Train-mode moe_apply on this rank's columns: x is this rank's
    sequence chunk, gathered in, the output's chunk out, ``lb_loss``
    leaving by ``mean_exit``; expert columns stored over data are
    gathered over it on entry."""
    C.train_layout(mode)
    local = tp_plan(cfg, tp.size)
    xf, p = C.enter_region(x, p, _stored(cfg), tp)
    if local is not None:
        y, aux = _moe_local(p, xf, local, mode)
        y = C.scatter_seq(y, tp)
    else:
        y, aux = _moe_local(p, xf, cfg, mode)
        y = C.split_seq(y, tp)
    return y, {**aux, "lb_loss": C.mean_exit(aux["lb_loss"], tp)}


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, mode: str = "train",
              seq_lengths=None, tp: Optional[C.Axis] = None
              ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (y, aux).  Inference modes skip the load-balance
    loss (the router softmax stays: it feeds the gates).  seq_lengths:
    per-row real lengths (B,) of a right-padded ragged prefill batch (each
    row keeps its exact-length expert capacity); that form is
    forward-only, as in JAX.  tp: the model axis of the sequence-parallel
    layout (train mode, ``_moe_region``)."""
    if tp is not None:
        return _moe_region(p, x, cfg, mode, tp)
    if mode == "train":         # a data axis alone: the ZeRO-3 gather
        x, p = C.enter_region(x, p, _stored(cfg), None)
    return _moe_local(p, x, cfg, mode, seq_lengths)


def _moe_local(p, x: torch.Tensor, cfg: ModelConfig, mode: str,
               seq_lengths=None) -> Tuple[torch.Tensor, dict]:
    """moe_apply on the columns ``p`` holds as it uses them."""
    need_aux = mode == "train"
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    if (mode == "decode" and x.shape[1] == 1
            and dispatch.use_decode_ffn_kernel(cfg)):
        out, aux = _moe_decode_kernel(x, p, cfg)
    elif dispatch.use_routed_ffn_kernel(cfg):
        if seq_lengths is not None:
            if torch.is_grad_enabled() and (
                    x.requires_grad or any(t.requires_grad
                                           for _, t in leaves(p))):
                raise RuntimeError("moe_apply: the ragged seq_lengths "
                                   "kernel path is forward-only (serving)")
            out, aux = _moe_kernel_forward(x, p, cfg, need_aux, seq_lengths)
        else:
            out, aux = _moe_kernel_op(x, p, cfg, need_aux)
    else:
        out, aux = _moe_reference(x, p, cfg, need_aux, seq_lengths)
    if dispatch.use_telemetry_counters(cfg) and mode in ("prefill", "decode"):
        # telemetry counters: re-run the small router product so the
        # kernel and plain paths report the same loads
        from repro_torch.models.ffn import _tel_expert_load
        choice, _, _ = _route_experts(p, x, cfg)
        aux = dict(aux)
        aux["tel_expert_load"] = _tel_expert_load(choice, cfg.num_experts,
                                                  x, seq_lengths)
        aux["tel_expert_drop"] = torch.as_tensor(
            aux.get("dropped", 0.0), dtype=torch.float32, device=x.device)
    return (out[0] if squeeze else out), aux
