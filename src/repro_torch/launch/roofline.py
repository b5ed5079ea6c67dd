"""Roofline model of a step on one H100 (the JAX package's
``launch/roofline.py`` without its XLA HLO parsers).

Three terms per step, in seconds on one card:

    compute    = FLOPs        / PEAK_FLOPS (bf16)
    memory     = HBM bytes    / HBM_BW
    collective = collective bytes / NVLINK_BW

and ``model_flops`` / ``active_params``, the 6 N D convention on a
config, equal to JAX's for every config.  The constants are NVIDIA's
datasheet peaks for the H100 SXM part ("H100 80GB HBM3", 700 W; dense
rates, no sparsity), not measurements: a card set below 700 W runs
slower under load.  The collective term takes the payload over one
direction of the card's NVLink (900 GB/s both directions together), a
comparison metric like JAX's, not a wall-clock prediction.  (JAX's
``shape_bytes``, ``hbm_traffic``, ``collective_bytes`` and ``analyze``
read XLA's HLO text and ``cost_analysis``; the port has no counterpart
of either yet.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12          # dense bf16 / fp16, tensor cores
PEAK_FLOPS_F32 = 67e12       # float32, outside the tensor cores
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s, one direction


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, int]
    peak_memory: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time: max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "coll_by_kind": self.coll_by_kind,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "t_bound": self.t_bound, "peak_memory": self.peak_memory,
        }


def model_flops(cfg, tokens: int) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for a train step;
    2 N D for inference steps (caller divides)."""
    return 6.0 * active_params(cfg) * tokens


def active_params(cfg) -> float:
    """Active (FLOP-relevant) parameter count: standard 6ND convention —
    embeddings excluded; MoE experts count experts_per_token/num_experts;
    routed-FFN weights count beta = G'/G (only activated blocks compute)."""
    from repro_torch.core.params import count_params
    from repro_torch.train.state import model_defs
    total = count_params(model_defs(cfg))
    total -= cfg.padded_vocab * cfg.d_model          # embedding lookup
    if cfg.positional == "learned":
        total -= cfg.max_position * cfg.d_model
        if cfg.family == "audio":
            total -= cfg.max_position * cfg.d_model  # enc+dec tables
    n_ffn_layers = sum(1 for t in cfg.layer_types() if t != "ssd")
    ffn_mats = 3 if cfg.gated_ffn else 2
    if cfg.num_experts > 0:
        frac = cfg.experts_per_token / cfg.num_experts
        per_layer = cfg.num_experts * cfg.d_model * cfg.d_ff * ffn_mats
        total -= per_layer * n_ffn_layers * (1.0 - frac)
    elif cfg.spt.routed_ffn and cfg.d_ff > 0 \
            and cfg.d_ff % cfg.spt.ffn_groups == 0:
        beta = cfg.spt.ffn_active_groups / cfg.spt.ffn_groups
        per_layer = cfg.d_model * cfg.d_ff * ffn_mats
        if cfg.family == "audio":
            n_ffn_layers += cfg.encoder_layers
        total -= per_layer * n_ffn_layers * (1.0 - beta)
    return float(max(total, 1.0))
