"""Plain torch versions of the routed-FFN kernels' functions, in f32.

``grouped_ffn_ref`` is the grouped kernel's function (csrc/grouped_ffn.cu)
and ``decode_ffn_ref`` the decode kernel's (csrc/decode_ffn.cu), with the
same inputs and outputs.  The CPU tests hold them to the JAX kernels;
``chip_smoke.py`` holds the CUDA kernels to them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.routed_ffn import ACTIVATIONS


def grouped_ffn_ref(x: torch.Tensor, index: torch.Tensor,
                    w_inner: torch.Tensor, w_outer: torch.Tensor,
                    w_gate: Optional[torch.Tensor] = None,
                    lora_params: Optional[dict] = None,
                    lora_scale: float = 1.0, act: str = "relu"
                    ) -> torch.Tensor:
    """x: (B, S, d); index: (B, G, C) slot -> token (S = empty, clamped to
    a real row); w_inner/w_gate: (G, d, F); w_outer: (G, F, d).
    Returns y (B, G, C, d) in x's dtype; empty slots hold finite rows."""
    fn = ACTIVATIONS[act]
    b, s, d = x.shape
    _, g, c = index.shape
    rows = torch.clamp(index.long(), max=s - 1).reshape(b, g * c)
    xg = x.float().gather(1, rows[..., None].expand(b, g * c, d))
    xg = xg.reshape(b, g, c, d)

    def up_of(w, key):
        up = torch.einsum("bgcd,gdf->bgcf", xg, w.float())
        if lora_params is not None and key in lora_params:
            li = lora_params[key]
            xb = torch.einsum("bgcd,dr->bgcr", xg, li["b"].float())
            up = up + lora_scale * torch.einsum("bgcr,grf->bgcf", xb,
                                                li["c"].float())
        return up

    up = up_of(w_inner, "lora_inner")
    h = fn(up_of(w_gate, "lora_gate")) * up if w_gate is not None else fn(up)
    y = torch.einsum("bgcf,gfd->bgcd", h, w_outer.float())
    if lora_params is not None and "lora_outer" in lora_params:
        lo = lora_params["lora_outer"]
        hb = torch.einsum("bgcf,gfr->bgcr", h, lo["b"].float())
        y = y + lora_scale * torch.einsum("bgcr,rd->bgcd", hb,
                                          lo["c"].float())
    return y.to(x.dtype)


def decode_ffn_ref(x: torch.Tensor, choice: torch.Tensor, gate: torch.Tensor,
                   w_inner: torch.Tensor, w_outer: torch.Tensor,
                   w_gate: Optional[torch.Tensor] = None,
                   lora_params: Optional[dict] = None,
                   lora_scale: float = 1.0, act: str = "relu"
                   ) -> torch.Tensor:
    """Top-G' weight blocks gathered per token and contracted directly (no
    capacity plan).  x: (B, d); choice: (B, G') int; gate: (B, G') f32.
    Returns y (B, d) in x's dtype."""
    fn = ACTIVATIONS[act]
    xf = x.float()
    ch = choice.long()

    def proj_up(w, key):
        up = torch.einsum("bd,bgdf->bgf", xf, w[ch].float())
        if lora_params is not None and key in lora_params:
            li = lora_params[key]
            xb = xf @ li["b"].float()
            up = up + lora_scale * torch.einsum("br,bgrf->bgf", xb,
                                                li["c"][ch].float())
        return up

    up = proj_up(w_inner, "lora_inner")
    h = fn(proj_up(w_gate, "lora_gate")) * up if w_gate is not None \
        else fn(up)
    y = torch.einsum("bgf,bgfd->bgd", h, w_outer[ch].float())
    if lora_params is not None and "lora_outer" in lora_params:
        lo = lora_params["lora_outer"]
        hb = torch.einsum("bgf,bgfr->bgr", h, lo["b"][ch].float())
        y = y + lora_scale * torch.einsum("bgr,rd->bgd", hb, lo["c"].float())
    y = torch.einsum("bg,bgd->bd", gate.float(), y)
    return y.to(x.dtype)
