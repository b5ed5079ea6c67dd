"""Griffin/RecurrentGemma recurrent block: temporal conv + RG-LRU.

    r_t = sigmoid(x_t W_a)                 (recurrence gate)
    i_t = sigmoid(x_t W_i)                 (input gate)
    log a_t = -c * softplus(Lambda) * r_t  (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill run the linear recurrence as a scan over time with
JAX's combine ``(al * ar, ar * bl + br)``, written as a log-depth
doubling (Hillis-Steele) in torch ops: ceil(log2 S) elementwise rounds,
no Python loop over the sequence.  Its float order differs from XLA's
``associative_scan``, so the two agree to rounding, not bit for bit.
Decode is a single step.  The r/i gate weights are block-diagonal as in
Griffin.  The paper's sparse MHA applies to Griffin's local attention
layers, not here; LoRA applies to every projection of this block.  The
decode step writes its cache view (``h``, ``conv``) in place, as the
attention layers write theirs.

Under a model axis of extent n the width splits (``tp_plan``): this
rank's W/n channels of the branch, the conv, the recurrence and its
``h`` / ``conv`` caches, and the output projection's partial sum.  The
gates read their own block of the block-diagonal W_a / W_i when n
divides the block count; with one block (the whole matrix) each rank
all-gathers the conv output over the model axis and applies its W/n
columns.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core import lora
from repro_torch.core.params import ParamDef, spec_tree

_C = 8.0


def _gate_blocks(cfg: ModelConfig) -> int:
    """Block-diagonal gate count (Griffin's design): 16 when the width
    divides into blocks of a multiple of 8, else 1 (the full matrix)."""
    w = cfg.resolved_lru_width
    return 16 if w % (16 * 8) == 0 else 1


def rglru_defs(cfg: ModelConfig) -> dict:
    d, w = cfg.d_model, cfg.resolved_lru_width
    nb = _gate_blocks(cfg)
    wb = w // nb
    lc = cfg.spt.lora
    return {
        "w_gate": lora.linear_defs(d, w, lc, "embed", "lru"),
        "w_branch": lora.linear_defs(d, w, lc, "embed", "lru"),
        "w_out": lora.linear_defs(w, d, lc, "lru", "embed"),
        "conv": ParamDef((cfg.conv_width, w), torch.float32,
                         ("conv", "lru"), init="normal:0.1", trainable=False),
        "w_a": ParamDef((nb, wb, wb), torch.float32,
                        ("lru_blocks", None, None), init="fan_in",
                        trainable=False),
        "w_i": ParamDef((nb, wb, wb), torch.float32,
                        ("lru_blocks", None, None), init="fan_in",
                        trainable=False),
        "lam": ParamDef((w,), torch.float32, ("lru",), init="uniform:1.0",
                        trainable=False),
    }


def init_rec_cache(cfg: ModelConfig, batch: int, device
                   ) -> Dict[str, torch.Tensor]:
    w = cfg.resolved_lru_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                            dtype=torch.float32, device=device),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time.  x: (B, S, W); kernel: (K, W).
    Returns (y, new_state) where the state carries the last K-1 inputs;
    a stored (f32) state is cast to x's dtype at use."""
    k = kernel.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * kernel[0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i:i + s] * kernel[i].to(x.dtype)
    return y, xp[:, -(k - 1):]


def tp_plan(cfg: ModelConfig, n: int) -> Optional[ModelConfig]:
    """The config of this rank's W/n channels; None when the width, or a
    block count above one, does not divide by n."""
    w, nb = cfg.resolved_lru_width, _gate_blocks(cfg)
    if w % n or (nb > 1 and nb % n):
        return None
    return dataclasses.replace(cfg, lru_width=w // n)


def tp_specs(cfg: ModelConfig, n: int) -> dict:
    """Placements of ``rglru_defs(cfg)`` under ``tp_plan``: the width and
    the gate blocks over the model axis, or with one gate block its
    output columns."""
    specs = spec_tree(rglru_defs(cfg), {"lru": "model",
                                        "lru_blocks": "model",
                                        "__sizes__": {"model": n}})
    if _gate_blocks(cfg) == 1:
        specs["w_a"] = specs["w_i"] = (None, None, "model")
    return specs


def _gates(p, xc: torch.Tensor, xg: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, in f32.  xg: the
    gates' input where it is wider than xc (the whole width, gathered,
    against this rank's columns of a one-block W_a / W_i)."""
    xf = xc.float()
    nb, wb, wv = p["w_a"].shape
    lead = xf.shape[:-1]
    xb = (xf if xg is None else xg.float()).reshape(*lead, nb, wb)
    r = torch.sigmoid(torch.einsum("...nw,nwv->...nv", xb, p["w_a"])
                      ).reshape(*lead, nb * wv)
    i = torch.sigmoid(torch.einsum("...nw,nwv->...nv", xb, p["w_i"])
                      ).reshape(*lead, nb * wv)
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t with h_{-1} = 0, over axis 1: round k
    combines each step with the one 2^k earlier, (a, b)[t] <-
    (a[t - o] a[t], a[t] b[t - o] + b[t]), JAX's combine with the earlier
    element on the left."""
    s = a.shape[1]
    o = 1
    while o < s:
        a_prev, b_prev = a[:, :-o], b[:, :-o]
        a_cur, b_cur = a[:, o:], b[:, o:]
        b = torch.cat([b[:, :o], a_cur * b_prev + b_cur], dim=1)
        a = torch.cat([a[:, :o], a_prev * a_cur], dim=1)
        o *= 2
    return b


def rglru_scan(p, xc: torch.Tensor, h0: Optional[torch.Tensor],
               xg: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The linear recurrence over xc (B, S, W), the post-conv branch
    input, from state h0 (B, W) or zeros.  Returns (h_seq, h_last), f32.
    xg: the gates' wider input (``_gates``)."""
    a, b = _gates(p, xc, xg)
    if h0 is not None:          # fold the initial state into step 0
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = _linear_scan(a, b)
    return h, h[:, -1]


def rglru_step(p, xc: torch.Tensor, h: torch.Tensor,
               xg: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  xc: (B, W); h: (B, W); xg: ``_gates``' wider
    input, (B, W_whole)."""
    a, b = _gates(p, xc[:, None, :], None if xg is None else xg[:, None])
    h_new = a[:, 0] * h + b[:, 0]
    return h_new, h_new


def rec_apply(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str = "train",
              cache: Optional[dict] = None, tp: Optional[C.Axis] = None):
    """Griffin recurrent block.  x: (B, S, d).  Returns (y, cache, aux):
    prefill writes the final state and conv window into ``cache`` (the
    caller's view of the block's cache), decode advances them by one
    step, both in place.  tp: the model axis of the sequence-parallel
    layout (train mode; x and y this rank's sequence chunk): a tensor-
    parallel region over this rank's channels (``tp_plan``)."""
    if tp is None:
        return rec_forward(p, x, cfg, mode=mode, cache=cache)
    C.train_layout(mode)
    local = tp_plan(cfg, tp.size)
    if local is None:
        xf, p = C.enter_region(x, p, None, tp)
        y, _, aux = rec_forward(p, xf, cfg, mode=mode)
        return C.split_seq(y, tp), None, aux
    xf, p = C.enter_region(x, p, tp_specs(cfg, tp.size), tp)
    y, _, aux = rec_forward(p, xf, local, mode=mode, ax=tp)
    return C.scatter_seq(y, tp), None, aux


def rec_forward(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                cache: Optional[dict] = None, ax: Optional[C.Axis] = None):
    """The block on the channels ``p`` holds (all of them, or this rank's
    under ``tp_specs``; then y is this rank's partial sum).  ax: the model
    axis over which a one-block gate gathers the conv output."""
    lc = cfg.spt.lora
    gate = F.gelu(lora.linear(x, p["w_gate"], lc), approximate="tanh")
    branch = lora.linear(x, p["w_branch"], lc)
    conv_state = None if cache is None else cache["conv"]
    xc, new_conv = _causal_conv(branch, p["conv"], conv_state)
    wa = p["w_a"].shape
    xg = (C.gather(xc, xc.dim() - 1, ax)
          if ax is not None and wa[1] != wa[2] else None)
    if mode in ("train", "prefill"):
        h_seq, h_last = rglru_scan(p, xc, None if cache is None
                                   else cache["h"], xg)
        if mode == "prefill" and cache is not None:
            cache["h"].copy_(h_last)
            cache["conv"].copy_(new_conv)
        out = h_seq.to(x.dtype)
    elif mode == "decode":
        if cache is None:
            raise ValueError("rec_apply: decode needs a cache")
        h_new, _ = rglru_step(p, xc[:, 0], cache["h"],
                              None if xg is None else xg[:, 0])
        cache["h"].copy_(h_new)
        cache["conv"].copy_(new_conv)
        out = h_new[:, None, :].to(x.dtype)
    else:
        raise ValueError(mode)
    y = lora.linear(out * gate, p["w_out"], lc)
    return y, cache, {}
