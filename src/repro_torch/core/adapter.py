"""Model Adapter (paper §3, Figure 2).

Takes a *dense* pre-trained parameter tree (the zoo's layout under
``spt.disabled()``) and produces the SPT tree for the same architecture:
LoRA adapters inserted (C zero-initialized, so the function is unchanged
at step 0), FFN weights re-blocked into routed groups, router and PQ
codebooks initialized.  The port of the JAX package's ``core/adapter.py``;
the fresh leaves come from a ``torch.Generator``, so they are other
numbers than JAX's key gives, while every copied and re-blocked leaf is
the dense tree's, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import init_tree
from repro_torch.models import transformer

_FRESH = ("router", "lora_inner", "lora_outer", "lora_gate", "pq", "lora")


def _reblock_ffn(dense_ffn: dict, cfg: ModelConfig, spt_init: dict) -> dict:
    """dense {wi: {w}, wo: {w} [, wg]} -> routed {w_inner, w_outer
    [, w_gate], router, lora_*}, keeping the pre-trained weights exact."""
    g = cfg.spt.ffn_groups
    d, dff = cfg.d_model, cfg.d_ff
    f = dff // g
    out = dict(spt_init)

    def rows(w):        # (.., d, D) -> (.., G, d, F); stacked units too
        return w.reshape(*w.shape[:-2], d, g, f).transpose(-3, -2)

    def cols(w):        # (.., D, d) -> (.., G, F, d)
        return w.reshape(*w.shape[:-2], g, f, d)

    out["w_inner"] = rows(dense_ffn["wi"]["w"]).contiguous()
    out["w_outer"] = cols(dense_ffn["wo"]["w"]).contiguous()
    if "wg" in dense_ffn:
        out["w_gate"] = rows(dense_ffn["wg"]["w"]).contiguous()
    return out


def adapt(dense_params: dict, dense_cfg: ModelConfig, spt_cfg: ModelConfig,
          generator: torch.Generator) -> dict:
    """Upgrade a dense-model tree to the SPT tree of ``spt_cfg`` (same
    architecture dims; dense_cfg has the sparse features off).  New leaves
    (LoRA B/C, router, codebooks) come from spt_cfg's initializers drawn
    from ``generator``; pre-trained weights are copied (the FFN
    re-blocked).  The tree keeps the definitions' key order, as JAX's
    ``init_tree`` does."""
    defs = transformer.lm_defs(spt_cfg)
    spt_init = init_tree(defs, generator)

    def walk(dense: dict, spt: dict, d: dict) -> dict:
        out = {}
        for k in d:
            v = spt[k]
            if k in _FRESH or k in ("w_inner", "w_outer", "w_gate"):
                out[k] = v                     # fresh, or re-blocked below
            elif isinstance(v, dict):
                if k == "ffn" and "w_inner" in v and "wi" in dense.get(k, {}):
                    out[k] = _reblock_ffn(dense[k], spt_cfg,
                                          walk({}, v, d[k]))
                elif k in dense and isinstance(dense[k], dict):
                    out[k] = walk(dense[k], v, d[k])
                else:
                    out[k] = walk({}, v, d[k])
            else:
                out[k] = dense[k] if k in dense else v
        return out

    return walk(dense_params, spt_init, defs)


def upgrade_report(dense_params: dict, adapted: dict) -> str:
    """The '[UPGRADE]' log of the paper's Model Adapter."""
    lines = []

    def walk(a, path):
        if not isinstance(a, dict):
            return
        for k, v in a.items():
            if k in ("lora", "lora_inner", "lora_outer", "lora_gate"):
                lines.append(f"[UPGRADE] {'.'.join(path)} Linear -> LoRALinear")
            elif k == "router":
                lines.append(f"[UPGRADE] {'.'.join(path)} FFN -> RoutedFFN")
            elif k == "pq":
                lines.append(f"[UPGRADE] {'.'.join(path)} MHA -> SparseMHA")
            elif isinstance(v, dict):
                walk(v, path + (k,))

    walk(adapted, ())
    return "\n".join(lines)
