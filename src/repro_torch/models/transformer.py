"""Decoder-only LM: embeddings -> blocks (a Python loop over layers) ->
final norm -> (tied or separate) LM head.

The parameter tree keeps the JAX layout — ``{"embed", "final_norm",
"units": {"b0_attn": ...} stacked on a leading unit axis U, ["head"]}`` —
so the JAX package's params load unchanged (core/params.from_numpy_tree);
:class:`LM` holds each unit as its own ``ParamTree`` (views of the stacked
tensors).  Caches keep the JAX tree too, stacked on U — per-slot strips,
or with ``kv_pages`` page pools shared by the slots (serving/kv_pages.py)
— and are written in place.  Training runs on the param tree itself
(``lm_hidden``: per-unit views of the stacked leaves, so gradients land
on the stacked leaves as JAX's scan gives them).  The port covers the
dense attention stack (pattern ("attn",)).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import (ParamDef, ParamTree, init_tree,
                                     stack_defs)
from repro_torch.models import attention, ffn, layers
from repro_torch.serving import kv_pages as kvp


AUX_KEYS = ("lb_loss", "dropped", "qerr")


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
                cache=None, pos=None, kv_valid=None, page_table=None,
                seq_lengths=None):
    """Returns (x, cache, aux) with aux the block's AUX_KEYS entries that
    its layers report (scalars, f32)."""
    h = layers.apply_norm(p["norm_mix"], x, cfg.norm)
    y, cache, a_aux = attention.attn_apply(
        p["mixer"], h, cfg, mode=mode, causal=True, window=cfg.window,
        cache=cache, pos=pos, kv_valid=kv_valid, page_table=page_table,
        seq_lengths=seq_lengths)
    x = x + y.to(x.dtype)
    f_aux: dict = {}
    if "ffn" in p:
        h2 = layers.apply_norm(p["norm_ffn"], x, cfg.norm)
        y2, f_aux = ffn.ffn_apply(p["ffn"], h2, cfg, mode=mode,
                                  seq_lengths=seq_lengths)
        x = x + y2.to(x.dtype)
    # attention reports qerr, the FFN lb_loss and dropped: no key in both
    aux = {k: v for a in (a_aux, f_aux) for k, v in a.items()
           if k in AUX_KEYS}
    return x, cache, aux


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

    def __getitem__(self, k: str):
        """``model["embed"]`` as on the param tree."""
        return getattr(self, k)

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device


def _to(t, dev):
    if isinstance(t, dict):
        return {k: _to(v, dev) for k, v in t.items()}
    return t.to(dev)


def _kind_paged(cfg: ModelConfig, kind: str, kv_pages) -> bool:
    """A block's cache uses the paged pool layout: attention without a SWA
    ring (the ring is already window-bounded) under a paged engine."""
    return kind == "attn" and kv_pages is not None and cfg.window is None


def paged_applicable(cfg: ModelConfig) -> bool:
    """The paged KV layout has something to page: at least one attention
    block whose cache is a full-length strip (no SWA ring bound)."""
    return ("attn" in cfg.pattern and cfg.window is None
            and cfg.family != "audio")


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                kv_pages: Optional[int] = None) -> dict:
    """kv_pages: when set, the attention caches are (kv_pages, page_size,
    ...) pools shared across slots instead of per-slot (batch, max_len,
    ...) strips."""
    if _kind_paged(cfg, "attn", kv_pages):
        one = attention.init_paged_cache(cfg, kv_pages, device)
    else:
        one = attention.init_cache(cfg, batch, max_len, device, cfg.window)
    u = num_units(cfg)
    return {"units": {"b0_attn": {
        k: v[None].expand(u, *v.shape).contiguous() for k, v in one.items()}}}


# ---------------------------------------------------------------- forward
def _run_blocks(units, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
                caches=None, pos=None, remat: bool = True, kv_valid=None,
                page_table=None, seq_lengths=None):
    """Run the pattern units (``LM.units`` or per-unit param dicts) over
    x.  Returns (x, aux): in train mode aux sums AUX_KEYS over every
    block, and with ``remat`` each unit runs under a non-reentrant
    checkpoint (its activations are recomputed in backward, kernels
    included, as JAX's jax.checkpoint of the scan body does).  Inference
    modes skip the aux sums (no extra launches on the decode path)."""
    train = mode == "train"
    aux_total = ({k: torch.zeros((), dtype=torch.float32, device=x.device)
                  for k in AUX_KEYS} if train else {})

    def unit_body(h, unit, u):
        aux_u = {}
        for i, kind in enumerate(cfg.pattern):
            name = f"b{i}_{kind}"
            c = (None if caches is None else
                 {k: v[u] for k, v in caches["units"][name].items()})
            h, _, aux = block_apply(unit[name], h, cfg, mode=mode, cache=c,
                                    pos=pos, kv_valid=kv_valid,
                                    page_table=page_table,
                                    seq_lengths=seq_lengths)
            for k, val in aux.items():
                aux_u[k] = aux_u[k] + val if k in aux_u else val
        return h, aux_u

    for u, unit in enumerate(units):
        if train and remat and torch.is_grad_enabled():
            x, aux_u = checkpoint(unit_body, x, unit, u, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            x, aux_u = unit_body(x, unit, u)
        for k, val in aux_u.items():
            if train:
                aux_total[k] = aux_total[k] + val
    return x, aux_total


def _unit_trees(params: dict, cfg: ModelConfig) -> list:
    """Per-unit views of the stacked ``params["units"]`` tree."""
    return [_unit_slice(params["units"], u) for u in range(num_units(cfg))]


def lm_hidden(params: dict, cfg: ModelConfig,
              batch: Dict[str, torch.Tensor], remat: bool = True
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train-mode forward of a JAX-layout param tree to the final hidden
    states (B, S, d) and the summed aux.  Gradients reach the stacked
    leaves through the per-unit views."""
    x = layers.embed_lookup(params["embed"], batch["tokens"], cfg.scale_embed,
                            cfg.d_model)
    x, aux = _run_blocks(_unit_trees(params, cfg), cfg, x, mode="train",
                         remat=remat)
    return layers.apply_norm(params["final_norm"], x, cfg.norm), aux


def head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    """(d, V_padded) LM head: the tied embedding's transpose or ``head``."""
    if cfg.tie_embeddings:
        return params["embed"]["embedding"].t()
    return params["head"]["w"]


def logits_of(model: LM, cfg: ModelConfig, hidden: torch.Tensor
              ) -> torch.Tensor:
    out = hidden @ head_weight(model, cfg).to(hidden.dtype)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        out = torch.tanh(out / c) * c
    return out


@torch.no_grad()
def lm_decode_step(model: LM, cfg: ModelConfig, caches: dict,
                   token: torch.Tensor, pos: torch.Tensor,
                   kv_valid: Optional[torch.Tensor] = None,
                   page_table: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """One token for every row.  token: (B,); pos: (B,) per-slot
    positions; kv_valid: optional (B, cache_size) slot validity shared by
    every layer ((B, MP * page_size) with a page table); page_table:
    optional (B, MP) slot->page map, given when the attention caches are
    paged pools (``init_caches(..., kv_pages=)``).  Writes the caches in
    place; returns logits (B, 1, V)."""
    x = layers.embed_lookup(model.embed, token[:, None], cfg.scale_embed,
                            cfg.d_model)
    x, _ = _run_blocks(model.units, cfg, x, mode="decode", caches=caches,
                       pos=pos, kv_valid=kv_valid, page_table=page_table)
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
    x, _ = _run_blocks(model.units, cfg, x, mode="prefill", caches=caches,
                       pos=0, seq_lengths=sl)
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


def write_slot_caches_paged_rows(dst: dict, rows: dict, slots: torch.Tensor,
                                 page_table: torch.Tensor,
                                 cfg: ModelConfig) -> dict:
    """Paged counterpart of ``write_slot_caches_rows``: one page-wise
    write per cache tensor covers every row of a prefill group, in place.
    slots: (Bp,) slot per row, -1 for bucket-padding dummy rows, whose
    page rows become all -1 so every write drops; page rows past a
    slot's allocation (bucketed right-pad overhang, -1 ids) drop too —
    decode overwrites them before any read.  The U units are folded into
    the page axis (unit u's page i is row u * P + i of the folded pool),
    so each tensor takes one write.  Page ids are unique across slots."""
    ps = cfg.spt.kv_page_size
    ns = page_table.shape[0]
    slots = slots.to(page_table.device)
    pt_rows = torch.where(slots[:, None] >= 0,
                          page_table[slots.clamp(0, ns - 1).long()],
                          -1)                             # (Bp, MP)
    for name, blk in dst["units"].items():
        for key, pool in blk.items():                     # (U, P, ...)
            u, p = pool.shape[:2]
            off = torch.arange(u, device=pool.device)[:, None, None] * p
            pts = torch.where(pt_rows[None] >= 0, pt_rows[None] + off, -1)
            seqs = rows["units"][name][key]               # (U, Bp, ...)
            kvp.scatter_prefill_rows(
                pool.view(u * p, *pool.shape[2:]),
                pts.reshape(-1, pts.shape[-1]),
                seqs.reshape(-1, *seqs.shape[2:]).to(pool.dtype), ps,
                pad_value=-1 if key == "slot_pos" else 0)
    return dst


def reset_page_slots(caches: dict, cfg: ModelConfig, pid: torch.Tensor,
                     ok: torch.Tensor) -> dict:
    """Invalidate slot_pos of freshly allocated pages, in place (pid (B,),
    ok (B,) from kv_pages.alloc_masked): a recycled page still carries its
    previous tenant's slot_pos rows, which would look valid to the
    self-derived kv_valid of the gathered-view tier.  K/V/code rows need
    no reset — validity masks them until they are overwritten."""
    for blk in caches["units"].values():
        sp = blk["slot_pos"]                              # (U, P, ps)
        kvp.put_masked(sp, (slice(None), pid),
                       sp.new_full((sp.shape[0], pid.shape[0], sp.shape[2]),
                                   -1), ok, axis=1)
    return caches
