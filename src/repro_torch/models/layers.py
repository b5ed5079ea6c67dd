"""Shared neural building blocks: norms, RoPE, embeddings (token and
learned-position)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.params import ParamDef


def norm_defs(dim: int, kind: str, axis: Optional[str] = "embed") -> dict:
    defs = {"scale": ParamDef((dim,), torch.float32, (axis,), init="ones",
                              trainable=False)}
    if kind == "layernorm":
        defs["bias"] = ParamDef((dim,), torch.float32, (axis,), init="zeros",
                                trainable=False)
    return defs


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, head_dim); pos: (seq,) or (batch, seq) absolute
    positions (decode slots sit at ragged depths).  Rotate-half RoPE."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    if pos.dim() == 2 and x.dim() == 4:
        pos = pos[:, None]                               # over heads
    angles = pos[..., :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


def embed_defs(vocab: int, dim: int) -> dict:
    return {"embedding": ParamDef((vocab, dim), torch.bfloat16,
                                  ("vocab", "embed"),
                                  init="normal:0.02", trainable=False)}


def embed_lookup(p, tokens: torch.Tensor, scale: bool,
                 d_model: int) -> torch.Tensor:
    x = p["embedding"][tokens.long()]
    if scale:
        x = x * torch.tensor(d_model ** 0.5, dtype=x.dtype)
    return x


def pos_embed_defs(max_pos: int, dim: int) -> dict:
    """The learned-position table (OPT): frozen, bf16, (max_pos, dim)."""
    return {"pos_embedding": ParamDef((max_pos, dim), torch.bfloat16,
                                      (None, "embed"),
                                      init="normal:0.02", trainable=False)}
