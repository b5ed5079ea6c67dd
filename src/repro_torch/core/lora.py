"""LoRA: low-rank adaptation (paper §2.2, Eq. 5).

Y = X W + s * (X B) C     with W frozen, B in R^{d x r}, C in R^{r x h}.

B is fan-in initialized, C zero-initialized so fine-tuning starts from the
pre-trained function exactly (s = alpha / r).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.params import ParamDef


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 16.0
    enabled: bool = True

    @property
    def scale(self) -> float:
        return self.alpha / max(1, self.rank)


def param_defs(d_in: int, d_out: int, cfg: LoRAConfig,
               in_axis: Optional[str] = None,
               out_axis: Optional[str] = None) -> dict:
    """LoRA adapter defs for a (d_in, d_out) projection.  The B side
    carries the input's logical axis, the C side the output's, so tensor
    parallelism places them as the frozen weight they adapt."""
    return {
        "b": ParamDef((d_in, cfg.rank), torch.float32,
                      (in_axis, "lora_rank"), init="fan_in"),
        "c": ParamDef((cfg.rank, d_out), torch.float32,
                      ("lora_rank", out_axis), init="zeros"),
    }


def linear_defs(d_in: int, d_out: int, cfg: LoRAConfig,
                in_axis: Optional[str] = None,
                out_axis: Optional[str] = None,
                base_init: str = "fan_in", dtype=torch.bfloat16) -> dict:
    """A frozen base projection + its LoRA adapter."""
    out = {"w": ParamDef((d_in, d_out), dtype, (in_axis, out_axis),
                         init=base_init,
                         trainable=False)}
    if cfg.enabled:
        out["lora"] = param_defs(d_in, d_out, cfg, in_axis, out_axis)
    return out


def apply_lora(x: torch.Tensor, lora, scale: float) -> torch.Tensor:
    """s * (x B) C, narrow first so FLOPs stay O(n d r)."""
    xb = x @ lora["b"].to(x.dtype)
    return scale * (xb @ lora["c"].to(x.dtype))


def linear(x: torch.Tensor, p, cfg: LoRAConfig) -> torch.Tensor:
    """Y = X W (+ LoRA delta); W is frozen (``requires_grad=False``)."""
    y = x @ p["w"].to(x.dtype)
    if cfg.enabled and "lora" in p:
        y = y + apply_lora(x, p["lora"], cfg.scale)
    return y


def merge(p, cfg: LoRAConfig) -> torch.Tensor:
    """W' = W + s B C, in f32 and stored back in W's dtype: the
    inference-time merge (paper §2.2)."""
    w = p["w"].float()
    if cfg.enabled and "lora" in p:
        w = w + cfg.scale * (p["lora"]["b"].float() @ p["lora"]["c"].float())
    return w.to(p["w"].dtype)
