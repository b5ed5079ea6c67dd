"""Decoder-only LM: embeddings -> blocks (a Python loop over layers) ->
final norm -> (tied or separate) LM head.

The parameter tree keeps the JAX layout — ``{"embed", "final_norm",
"units": {"b0_attn": ...} stacked on a leading unit axis U, ["head"]}`` —
so the JAX package's params load unchanged (core/params.from_numpy_tree);
:class:`LM` holds each unit as its own ``ParamTree`` (views of the stacked
tensors).  Caches keep the JAX tree too, stacked on U, and are written in
place.  This slice serves the dense attention stack (pattern ("attn",)).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import (ParamDef, ParamTree, init_tree,
                                     stack_defs)
from repro_torch.models import attention, ffn, layers


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU; asking for CUDA without a card raises (no silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return dev


# ---------------------------------------------------------------- blocks
def block_defs(cfg: ModelConfig, kind: str) -> dict:
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    defs = {"norm_mix": layers.norm_defs(cfg.d_model, cfg.norm),
            "mixer": attention.attn_defs(cfg)}
    if cfg.d_ff > 0:
        defs["norm_ffn"] = layers.norm_defs(cfg.d_model, cfg.norm)
        defs["ffn"] = ffn.ffn_defs(cfg)
    return defs


def block_apply(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                cache=None, pos=None, kv_valid=None, seq_lengths=None):
    h = layers.apply_norm(p["norm_mix"], x, cfg.norm)
    y, cache = attention.attn_apply(
        p["mixer"], h, cfg, mode=mode, causal=True, window=cfg.window,
        cache=cache, pos=pos, kv_valid=kv_valid, seq_lengths=seq_lengths)
    x = x + y.to(x.dtype)
    if "ffn" in p:
        h2 = layers.apply_norm(p["norm_ffn"], x, cfg.norm)
        y2, _ = ffn.ffn_apply(p["ffn"], h2, cfg, mode=mode,
                              seq_lengths=seq_lengths)
        x = x + y2.to(x.dtype)
    return x, cache


def _unit_defs(cfg: ModelConfig) -> dict:
    return {f"b{i}_{kind}": block_defs(cfg, kind)
            for i, kind in enumerate(cfg.pattern)}


def num_units(cfg: ModelConfig) -> int:
    return cfg.num_layers // len(cfg.pattern)


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.pattern != ("attn",) or cfg.num_experts or cfg.frontend
            or cfg.positional == "learned" or cfg.family == "audio"):
        raise NotImplementedError(
            f"{cfg.name}: only dense decoder-only attention stacks are "
            "ported so far")


def lm_defs(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    defs: dict = {
        "embed": layers.embed_defs(cfg.padded_vocab, cfg.d_model),
        "final_norm": layers.norm_defs(cfg.d_model, cfg.norm),
        "units": stack_defs(_unit_defs(cfg), num_units(cfg)),
    }
    if not cfg.tie_embeddings:
        defs["head"] = {"w": ParamDef((cfg.d_model, cfg.padded_vocab),
                                      torch.bfloat16, init="fan_in",
                                      trainable=False)}
    return defs


def _unit_slice(tree, u: int):
    return {k: _unit_slice(v, u) if isinstance(v, dict) else v[u]
            for k, v in tree.items()}


class LM(nn.Module):
    """The language model as modules: ``embed``, ``final_norm``, one
    ``ParamTree`` per unit in ``units``, and ``head`` when untied.

    params: the JAX-layout tree of tensors (``init_tree`` or
    ``from_numpy_tree``); it is moved to ``device`` (CUDA by default)."""

    def __init__(self, cfg: ModelConfig, params: dict, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        defs = lm_defs(cfg)
        self.cfg = cfg
        params = {k: _to(v, dev) for k, v in params.items()}
        self.embed = ParamTree(params["embed"], defs["embed"])
        self.final_norm = ParamTree(params["final_norm"], defs["final_norm"])
        unit_defs = _unit_defs(cfg)
        self.units = nn.ModuleList(
            ParamTree(_unit_slice(params["units"], u), unit_defs)
            for u in range(num_units(cfg)))
        if "head" in defs:
            self.head = ParamTree(params["head"], defs["head"])

    @classmethod
    def init(cls, cfg: ModelConfig, seed: int = 0, device="cuda") -> "LM":
        """Random weights drawn from a seed on ``device``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_tree(lm_defs(cfg), gen), device=dev)

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device


def _to(t, dev):
    if isinstance(t, dict):
        return {k: _to(v, dev) for k, v in t.items()}
    return t.to(dev)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    one = attention.init_cache(cfg, batch, max_len, device, cfg.window)
    u = num_units(cfg)
    return {"units": {"b0_attn": {
        k: v[None].expand(u, *v.shape).contiguous() for k, v in one.items()}}}


# ---------------------------------------------------------------- forward
def _run_blocks(model: LM, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
                caches=None, pos=None, kv_valid=None, seq_lengths=None):
    for u, unit in enumerate(model.units):
        for i, kind in enumerate(cfg.pattern):
            name = f"b{i}_{kind}"
            c = (None if caches is None else
                 {k: v[u] for k, v in caches["units"][name].items()})
            x, _ = block_apply(unit[name], x, cfg, mode=mode, cache=c,
                               pos=pos, kv_valid=kv_valid,
                               seq_lengths=seq_lengths)
    return x


def logits_of(model: LM, cfg: ModelConfig, hidden: torch.Tensor
              ) -> torch.Tensor:
    w = (model.embed["embedding"].t() if cfg.tie_embeddings
         else model.head["w"])
    out = hidden @ w.to(hidden.dtype)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        out = torch.tanh(out / c) * c
    return out


@torch.no_grad()
def lm_decode_step(model: LM, cfg: ModelConfig, caches: dict,
                   token: torch.Tensor, pos: torch.Tensor,
                   kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token for every row.  token: (B,); pos: (B,) per-slot
    positions; kv_valid: optional (B, cache_size) slot validity shared by
    every layer.  Writes the caches in place; returns logits (B, 1, V)."""
    x = layers.embed_lookup(model.embed, token[:, None], cfg.scale_embed,
                            cfg.d_model)
    x = _run_blocks(model, cfg, x, mode="decode", caches=caches, pos=pos,
                    kv_valid=kv_valid)
    x = layers.apply_norm(model.final_norm, x, cfg.norm)
    return logits_of(model, cfg, x)


def length_sensitive(cfg: ModelConfig) -> bool:
    """Right-padding changes real-token outputs unless per-row lengths
    reach the layers: sparse MHA's top-L budget and routed-FFN capacity
    scale with the sequence length."""
    return attention.sparse_applicable(cfg) or ffn.routed_applicable(cfg)


def _mask_invalid_slots(caches: dict, lengths: torch.Tensor) -> dict:
    """Mark cache slots holding positions >= lengths[b] as empty (slot_pos
    -1) so a right-padded prefill leaves no phantom KV."""
    for blk in caches["units"].values():
        sp = blk["slot_pos"]                              # (U, B, S)
        sp.masked_fill_(sp >= lengths.reshape(1, -1, 1), -1)
    return caches


@torch.no_grad()
def lm_prefill_ragged(model: LM, cfg: ModelConfig,
                      batch: Dict[str, torch.Tensor], lengths: torch.Tensor,
                      max_len: int):
    """Prefill a (B, S) batch of right-padded prompts of per-row
    ``lengths``.  Returns (caches, logits (B, 1, V) at each row's last
    real position).  Each row's outputs equal an exact-length batch-1
    prefill: the causal mask hides pad keys, and the lengths reach the
    sparse-MHA budgets and routed-FFN capacities."""
    tokens = batch["tokens"]
    bsz = tokens.shape[0]
    caches = init_caches(cfg, bsz, max_len, tokens.device)
    x = layers.embed_lookup(model.embed, tokens, cfg.scale_embed,
                            cfg.d_model)
    sl = lengths if length_sensitive(cfg) else None
    x = _run_blocks(model, cfg, x, mode="prefill", caches=caches, pos=0,
                    seq_lengths=sl)
    idx = torch.clamp(lengths.long() - 1, 0, x.shape[1] - 1)
    x_last = x.gather(1, idx[:, None, None].expand(bsz, 1, x.shape[-1]))
    x_last = layers.apply_norm(model.final_norm, x_last, cfg.norm)
    caches = _mask_invalid_slots(caches, lengths)
    return caches, logits_of(model, cfg, x_last)


def write_slot_caches_rows(dst: dict, rows: dict, slots: torch.Tensor
                           ) -> dict:
    """Copy every row of a (Bp, ...) prefill group's caches into its
    engine slot, in place; the whole row is replaced, which doubles as the
    slot's recycling reset.  slots: (Bp,) int; -1 marks a bucket-padding
    row, which is dropped."""
    keep = torch.nonzero(slots >= 0).flatten()
    dest = slots[keep].long()
    for name, blk in dst["units"].items():
        for k, v in blk.items():                          # (U, B, ...)
            v[:, dest] = rows["units"][name][k][:, keep].to(v.dtype)
    return dst
