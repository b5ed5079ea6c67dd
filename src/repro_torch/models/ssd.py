"""Mamba-2 block via SSD (state-space duality), chunked matmul form.

  * intra-chunk: (Q x Q) masked-decay attention-like products;
  * inter-chunk: per-chunk states carried by a loop over the chunks (the
    JAX package's short scan).

Decode is the O(1) recurrent update  h <- h * exp(dt A) + dt B (x) x ;
y = C h + D x.  The state and ``exp`` of the decays stay in f32, as in
JAX; the products follow JAX's dtype promotions (an operand cast to the
activation dtype where JAX casts it).  Plain PyTorch: the JAX package
has no Pallas kernel here either.

SPT: mamba2 is attention-free and has no FFN (d_ff = 0), so sparse MHA
and the routed FFN do not apply — SPT reduces to LoRA on the in/out
projections.  Prefill and decode write the block's cache view (``h``,
``conv``) in place, as the attention layers write theirs.

Under a model axis of extent n the SSM heads split (``tp_plan``): each
rank takes its H/n heads' columns of z, x and dt from the fused input
projection and B, C whole (``tp_specs``: index sets, a ``Pick`` per
leaf), its conv channels, its part of the state cache, and the output
projection's partial sum.  The gated RMSNorm over the inner width sums
its squares over the model axis.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core import lora
from repro_torch.core.params import ParamDef
from repro_torch.models.layers import apply_norm, norm_defs


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    h = cfg.ssm_heads
    n = cfg.ssm_state
    conv_dim = di + 2 * n
    proj_out = 2 * di + 2 * n + h   # z, x, B, C, dt
    return di, h, n, conv_dim, proj_out


def ssd_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, h, n, conv_dim, proj_out = _dims(cfg)
    lc = cfg.spt.lora
    return {
        "in_proj": lora.linear_defs(d, proj_out, lc, "embed", "ssm_inner"),
        "out_proj": lora.linear_defs(di, d, lc, "ssm_inner", "embed"),
        "conv": ParamDef((cfg.conv_width, conv_dim), torch.float32,
                         ("conv", None), init="normal:0.1", trainable=False),
        "a_log": ParamDef((h,), torch.float32, (None,), init="zeros",
                          trainable=False),
        "d_skip": ParamDef((h,), torch.float32, (None,), init="ones",
                           trainable=False),
        "dt_bias": ParamDef((h,), torch.float32, (None,), init="zeros",
                            trainable=False),
        "norm": norm_defs(di, "rmsnorm", None),
    }


def tp_plan(cfg: ModelConfig, n: int) -> bool:
    """The heads split over a model axis of extent n."""
    return cfg.ssm_heads > 0 and cfg.ssm_heads % n == 0


def _local_dims(cfg: ModelConfig, n: int):
    di, h, nst, _, _ = _dims(cfg)
    return di // n, h // n, nst


def tp_specs(cfg: ModelConfig, n: int) -> dict:
    """Placements of ``ssd_defs(cfg)`` under ``tp_plan``: rank r's columns
    of the fused [z | x | B | C | dt] projection and of the [x | B | C]
    conv (B and C on every rank), its heads' rows of the output
    projection, of the norm and of the per-head vectors."""
    di, h, nst, _, _ = _dims(cfg)
    dl, hl, _ = _local_dims(cfg, n)

    def part(start, size, r):
        return list(range(start + r * size, start + (r + 1) * size))

    bc_in = list(range(2 * di, 2 * di + 2 * nst))
    bc_conv = list(range(di, di + 2 * nst))
    proj = C.Pick(1, tuple(tuple(part(0, dl, r) + part(di, dl, r) + bc_in
                                 + part(2 * di + 2 * nst, hl, r))
                           for r in range(n)))
    conv = C.Pick(1, tuple(tuple(part(0, dl, r) + bc_conv)
                           for r in range(n)))
    rows, heads = ("model", None), ("model",)
    specs = {"in_proj": {"w": proj}, "out_proj": {"w": rows},
             "conv": conv, "a_log": heads, "d_skip": heads,
             "dt_bias": heads, "norm": {"scale": heads}}
    if cfg.spt.lora.enabled:
        specs["in_proj"]["lora"] = {"b": None, "c": proj}
        specs["out_proj"]["lora"] = {"b": rows, "c": None}
    return specs


def init_ssm_cache(cfg: ModelConfig, batch: int, device, n: int = 1
                   ) -> Dict[str, torch.Tensor]:
    """The block's state; n: the model extent the heads split over."""
    _, h, nst, conv_dim, _ = _dims(cfg)
    h, conv_dim = h // n, conv_dim - (n - 1) * (cfg.d_inner // n)
    return {
        "h": torch.zeros((batch, h, cfg.ssm_headdim, nst),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=torch.float32, device=device),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time, then SiLU.  x: (B, S, C);
    kernel: (K, C).  Returns (y, new_state), the state carrying the last
    K-1 inputs; a stored (f32) state is cast to x's dtype at use."""
    k = kernel.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * kernel[0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i:i + s] * kernel[i].to(x.dtype)
    return F.silu(y), xp[:, -(k - 1):]


def _segsum(da: torch.Tensor) -> torch.Tensor:
    """da: (..., Q) -> (..., Q, Q) lower-triangular exp-arg differences:
    out[i, j] = sum_{j < t <= i} da[t]  (-inf above the diagonal)."""
    q = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]            # (.., i, j)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=da.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  x: (B, S, H, P), dt: (B, S, H) f32 (>= 0), a: (H,)
    f32 (< 0), bm / cm: (B, S, N).  Chunks of ``chunk`` steps, or one
    chunk of S when S is not a multiple.  Returns (y (B, S, H, P),
    h_last (B, H, P, N) f32)."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    xd = x.dtype
    q = min(chunk, s)
    if s % q != 0:
        q = s
    nc = s // q
    xr = x.reshape(b, nc, q, h, p)
    dtr = dt.reshape(b, nc, q, h)
    br = bm.reshape(b, nc, q, n)
    cr = cm.reshape(b, nc, q, n)
    da = dtr * a                                          # (B,NC,Q,H) f32
    seg = _segsum(da.movedim(-1, 2))                      # (B,NC,H,Q,Q)
    l_mat = torch.exp(seg)
    xdt = xr * dtr[..., None]                             # f32, as in JAX
    # intra-chunk (quadratic within the chunk, matmul form)
    cb = torch.einsum("bcin,bcjn->bcij", cr.float(), br.float())
    scores = cb[:, :, None] * l_mat                       # (B,NC,H,Q,Q)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", scores.to(xd).float(),
                           xdt)
    # chunk states
    da_cs = torch.cumsum(da, dim=2)                       # (B,NC,Q,H)
    decay_tail = torch.exp(da_cs[:, :, -1:, :] - da_cs)   # (B,NC,Q,H)
    states = torch.einsum("bcjn,bcjhp->bchpn", br.float(),
                          decay_tail.to(xd).float()[..., None] * xdt)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])           # (B,NC,H)
    hc = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):              # the inter-chunk recurrence
        h_prevs.append(hc)
        hc = hc * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                  # (B,NC,H,P,N)
    decay_in = torch.exp(da_cs)                           # (B,NC,Q,H)
    y_inter = (torch.einsum("bcin,bchpn->bcihp", cr.to(xd), h_prev.to(xd))
               * decay_in.to(xd)[..., None])
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, hc


def ssd_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor, hst: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  x: (B, H, P), dt: (B, H) f32, bm / cm: (B, N),
    hst: (B, H, P, N) f32."""
    da = torch.exp(dt * a)[..., None, None]               # (B,H,1,1)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, bm.float(), x.float())
    h_new = hst * da + upd
    y = torch.einsum("bhpn,bn->bhp", h_new.to(x.dtype), cm.to(x.dtype))
    return y, h_new


def ssd_apply(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str = "train",
              cache: Optional[dict] = None, tp: Optional[C.Axis] = None):
    """Mamba-2 block.  x: (B, S, d_model).  Returns (y, cache, aux):
    prefill writes the final state and conv window into ``cache`` (the
    caller's view of the block's cache), decode advances them by one
    step, both in place.  tp: the model axis of the sequence-parallel
    layout (train mode; x and y this rank's sequence chunk): a tensor-
    parallel region over this rank's heads (``tp_plan``)."""
    if tp is None:
        return ssd_forward(p, x, cfg, mode=mode, cache=cache)
    C.train_layout(mode)
    split = tp_plan(cfg, tp.size)
    xf, p = C.enter_region(x, p, tp_specs(cfg, tp.size) if split else None,
                           tp)
    y, _, aux = ssd_forward(p, xf, cfg, mode=mode, ax=tp if split else None)
    return (C.scatter_seq(y, tp) if split else C.split_seq(y, tp), None,
            aux)


def _split_rmsnorm(p, x: torch.Tensor, width: int, ax: C.Axis,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over a width split over ``ax``: this rank's columns x,
    normalised by the mean square of the whole width."""
    xf = x.float()
    ss = C.region_sum((xf * xf).sum(-1, keepdim=True), ax)
    return (xf * torch.rsqrt(ss / width + eps) * p["scale"]).to(x.dtype)


def ssd_forward(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                cache: Optional[dict] = None, ax: Optional[C.Axis] = None):
    """The block on the heads ``p`` holds: all of them, or with ``ax``
    this rank's (``tp_specs``), y then this rank's partial sum."""
    lc = cfg.spt.lora
    di, h, n = _local_dims(cfg, 1 if ax is None else ax.size)
    phead = cfg.ssm_headdim
    bsz, s, _ = x.shape
    zxbcdt = lora.linear(x, p["in_proj"], lc)
    z, xc, bm, cm, dt = torch.split(zxbcdt, [di, di, n, n, h], dim=-1)
    conv_in = torch.cat([xc, bm, cm], dim=-1)
    conv_state = None if cache is None else cache["conv"]
    conv_out, new_conv = _causal_conv(conv_in, p["conv"], conv_state)
    xc, bm, cm = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = xc.reshape(bsz, s, h, phead)
    if mode in ("train", "prefill"):
        y, h_last = ssd_scan(xh, dt, a, bm, cm, cfg.ssm_chunk,
                             None if cache is None else cache["h"])
        if mode == "prefill" and cache is not None:
            cache["h"].copy_(h_last)
            cache["conv"].copy_(new_conv)
    elif mode == "decode":
        if cache is None:
            raise ValueError("ssd_apply: decode needs a cache")
        y1, h_new = ssd_step(xh[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0],
                             cache["h"])
        cache["h"].copy_(h_new)
        cache["conv"].copy_(new_conv)
        y = y1[:, None]
    else:
        raise ValueError(mode)
    y = y + xh * p["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(bsz, s, di)
    if ax is None:
        y = apply_norm(p["norm"], y * F.silu(z), "rmsnorm")
    else:
        y = _split_rmsnorm(p["norm"], y * F.silu(z), cfg.d_inner, ax)
    return lora.linear(y, p["out_proj"], lc), cache, {}
