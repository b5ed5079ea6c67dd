"""Attention layer: GQA, RoPE, qk-norm, with the paper's sparse MHA as the
execution mode (SPTConfig.sparse_mha).

Modes: ``train`` (full-sequence causal), ``prefill`` (train-mode compute
+ populate the KV and PQ-code cache), ``decode`` (one token per row
against the cache; sparse MHA selects the top-L over the cached keys'
codes).  Caches keep the JAX layout — k/v (B, Hk, S, hd), codes (B, Hk,
S, M) int8, slot_pos (B, S) — or, paged (serving/kv_pages.py), the same
keys as pools of (P, Hk, page_size, .) pages addressed through the
engine's (B, MP) page table.  Both are updated IN PLACE (the JAX
functions return new arrays; here the returned dict is the same, mutated
one).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch, lora, pq
from repro_torch.core import sparse_attention as sa
from repro_torch.models import layers, paged_fallback
from repro_torch.serving import kv_pages


def _pq_config(cfg: ModelConfig) -> pq.PQConfig:
    return pq.PQConfig(head_dim=cfg.resolved_head_dim,
                       code_dim=cfg.spt.pq_code_dim,
                       num_codewords=cfg.spt.pq_codewords,
                       update_interval=cfg.spt.pq_update_interval)


def _sa_config(cfg: ModelConfig) -> sa.SparseAttentionConfig:
    return sa.SparseAttentionConfig(
        pq=_pq_config(cfg), top_fraction=cfg.spt.attn_top_fraction,
        min_l=cfg.spt.attn_min_l, pad_l_to=cfg.spt.attn_pad_l_to,
        chunk_q=cfg.spt.chunk_q,
        select_granularity=cfg.spt.select_granularity,
        qerr_loss_weight=cfg.spt.qerr_loss_weight)


def sparse_applicable(cfg: ModelConfig) -> bool:
    return (cfg.spt.sparse_mha
            and cfg.resolved_head_dim % cfg.spt.pq_code_dim == 0)


def attn_defs(cfg: ModelConfig) -> dict:
    d, hq, hk = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    lc = cfg.spt.lora
    defs = {
        "wq": lora.linear_defs(d, hq * hd, lc),
        "wk": lora.linear_defs(d, hk * hd, lc),
        "wv": lora.linear_defs(d, hk * hd, lc),
        "wo": lora.linear_defs(hq * hd, d, lc),
    }
    if cfg.qk_norm:
        defs["q_norm"] = layers.norm_defs(hd, "rmsnorm")
        defs["k_norm"] = layers.norm_defs(hd, "rmsnorm")
    if sparse_applicable(cfg):
        defs["pq"] = pq.param_defs(_pq_config(cfg))
    return defs


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               window: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Cache sized to the SWA window when present (ring buffer)."""
    size = max_len if window is None else min(max_len, window)
    hk, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {
        "k": torch.zeros((batch, hk, size, hd), dtype=cfg.dtype,
                         device=device),
        "v": torch.zeros((batch, hk, size, hd), dtype=cfg.dtype,
                         device=device),
        "slot_pos": torch.full((batch, size), -1, dtype=torch.int32,
                               device=device),
    }
    if sparse_applicable(cfg):
        m = _pq_config(cfg).num_books
        cache["codes"] = torch.zeros((batch, hk, size, m), dtype=torch.int8,
                                     device=device)
    return cache


def init_paged_cache(cfg: ModelConfig, num_pages: int, device
                     ) -> Dict[str, torch.Tensor]:
    """Paged pool layout: the per-slot (B, size, ...) strips become a
    global (num_pages, page_size, ...) pool addressed through the engine's
    slot->page table.  Same keys as init_cache."""
    ps = cfg.spt.kv_page_size
    hk, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {
        "k": torch.zeros((num_pages, hk, ps, hd), dtype=cfg.dtype,
                         device=device),
        "v": torch.zeros((num_pages, hk, ps, hd), dtype=cfg.dtype,
                         device=device),
        "slot_pos": torch.full((num_pages, ps), -1, dtype=torch.int32,
                               device=device),
    }
    if sparse_applicable(cfg):
        m = _pq_config(cfg).num_books
        cache["codes"] = torch.zeros((num_pages, hk, ps, m),
                                     dtype=torch.int8, device=device)
    return cache


def _project(p, x: torch.Tensor, lc, heads: int, hd: int) -> torch.Tensor:
    y = lora.linear(x, p, lc)
    b, s, _ = y.shape
    return y.reshape(b, s, heads, hd).transpose(1, 2)


def write_cache(cache: dict, cfg: ModelConfig, p, k: torch.Tensor,
                v: torch.Tensor, pos_k: torch.Tensor) -> dict:
    """Scatter new keys/values (and their PQ codes) into the cache in
    place.  pos_k: (S_new,) shared positions, or (B, S_new) per-row
    positions (decode slots at ragged depths)."""
    size = cache["k"].shape[2]
    if pos_k.dim() == 2:
        b = cache["k"].shape[0]
        slots = (pos_k % size).long()                     # (B, S_new)
        bidx = torch.arange(b, device=k.device)[:, None]
        # advanced-index target view is (B, S_new, Hk, hd)
        cache["k"][bidx, :, slots] = k.transpose(1, 2).to(cache["k"].dtype)
        cache["v"][bidx, :, slots] = v.transpose(1, 2).to(cache["v"].dtype)
        cache["slot_pos"][bidx, slots] = pos_k.to(torch.int32)
        if "codes" in cache:
            codes = pq.assign(k, p["pq"]["codebooks"])    # (B, Hk, S_new, M)
            cache["codes"][bidx, :, slots] = codes.transpose(1, 2).to(
                torch.int8)
        return cache
    if k.shape[2] > size:
        k, v, pos_k = k[:, :, -size:], v[:, :, -size:], pos_k[-size:]
    slots = (pos_k % size).long()
    cache["k"][:, :, slots] = k.to(cache["k"].dtype)
    cache["v"][:, :, slots] = v.to(cache["v"].dtype)
    cache["slot_pos"][:, slots] = pos_k.to(torch.int32)[None]
    if "codes" in cache:
        codes = pq.assign(k, p["pq"]["codebooks"])
        cache["codes"][:, :, slots] = codes.to(torch.int8)
    return cache


def write_cache_paged(cache: dict, cfg: ModelConfig, p, k: torch.Tensor,
                      v: torch.Tensor, pos: torch.Tensor,
                      page_table: torch.Tensor) -> dict:
    """Decode-time paged write, in place: one new token per slot at
    absolute position ``pos`` (B,), into page page_table[b, pos // ps],
    row pos % ps.  Slots whose page is unallocated (retired slots
    decoding dead air inside a chunk) drop the write."""
    ps = cache["k"].shape[2]
    kv_pages.scatter_row(cache["k"], page_table, pos, k[:, :, 0], ps)
    kv_pages.scatter_row(cache["v"], page_table, pos, v[:, :, 0], ps)
    kv_pages.scatter_row(cache["slot_pos"], page_table, pos,
                         pos.to(torch.int32), ps)
    if "codes" in cache:
        codes = pq.assign(k, p["pq"]["codebooks"])        # (B, Hk, 1, M)
        kv_pages.scatter_row(cache["codes"], page_table, pos,
                             codes[:, :, 0].to(torch.int8), ps)
    return cache


def kv_valid_mask(cache: dict, q_pos, window: Optional[int]
                  ) -> torch.Tensor:
    """(B, S) — slot holds a token visible to a query at q_pos (per row)."""
    sp = cache["slot_pos"]
    q = torch.as_tensor(q_pos, device=sp.device).reshape(-1, 1)
    ok = (sp >= 0) & (sp <= q)
    if window is not None:
        ok &= sp > q - window
    return ok


def attend(p, cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, causal: bool, window: Optional[int],
           q_offset: int = 0, seq_lengths: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence attention (train/prefill), sparse or dense; returns
    (out, aux).  Sparse MHA takes the fused CUDA kernels when
    ``dispatch.use_sparse_attn_kernel`` says so and the rows are not
    ragged; ragged prefill (``seq_lengths``: per-row top-L budgets) always
    takes the core/ gather path, as in the JAX package."""
    scale = cfg.resolved_head_dim ** -0.5
    if not sparse_applicable(cfg):
        return sa.dense_attention(q, k, v, scale, causal=causal,
                                  window=window, q_offset=q_offset,
                                  chunk_q=cfg.spt.chunk_q), {}
    args = (q, k, v, p["pq"]["codebooks"], _sa_config(cfg), scale)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if seq_lengths is not None:
        return sa.sparse_mha(*args, seq_lengths=seq_lengths, **kw)
    if dispatch.use_sparse_attn_kernel(cfg):
        from repro_torch.kernels.sparse_attention import ops as sa_ops
        return sa_ops.sparse_mha(*args, **kw)
    return sa.sparse_mha(*args, **kw)


def _decode_paged(p, cfg: ModelConfig, q, k, v, cache: dict, pos_b,
                  kv_valid, page_table, scale: float) -> torch.Tensor:
    """Paged-pool decode: write the new token into its slot's page, then
    attend.  Kernel-native tier: kernel 7 (sparse) or 8 (dense) reads the
    pools through the page table.  Gathered-view tier (the core/ oracle,
    the kill switch, ``kv_paged_native="gather"``, or a caller without a
    view-coordinate validity mask): models/paged_fallback.py."""
    write_cache_paged(cache, cfg, p, k, v, pos_b, page_table)
    s_view = page_table.shape[1] * cache["k"].shape[2]
    sparse = sparse_applicable(cfg)
    engine_valid = kv_valid is not None and kv_valid.shape[-1] == s_view
    if (engine_valid and dispatch.use_paged_native_decode(cfg)
            and (not sparse or dispatch.use_sparse_decode_kernel(cfg))):
        from repro_torch.kernels.sparse_attention import ops as sa_ops
        if sparse:
            return sa_ops.sparse_mha_decode_paged(
                q, cache["k"], cache["v"], cache["codes"],
                p["pq"]["codebooks"], _sa_config(cfg), scale, kv_valid,
                page_table)
        return sa_ops.dense_mha_decode_paged(q, cache["k"], cache["v"],
                                             scale, kv_valid, page_table)
    return paged_fallback.decode_attend_gathered(
        p, cfg, q, cache, page_table, pos_b, kv_valid, scale)


def attn_apply(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str = "train",
               causal: bool = True, window: Optional[int] = None,
               cache: Optional[dict] = None, pos=None,
               kv_valid: Optional[torch.Tensor] = None,
               page_table: Optional[torch.Tensor] = None,
               seq_lengths: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[dict], dict]:
    """Returns (y, cache, aux).  x: (B, S, d_model).  pos: absolute
    position of x[:, 0], an int or a (B,) tensor (ragged decode slots).
    kv_valid: decode only, the engine's (B, S_cache) slot validity (with
    a page table, (B, MP * page_size) in view coordinates); without it
    the mask is derived from the cache's slot_pos.  page_table: decode
    only, the (B, MP) slot->page map that marks ``cache`` as a paged pool
    (ring-buffer SWA caches ignore it)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    lc = cfg.spt.lora
    start = torch.as_tensor(0 if pos is None else pos, dtype=torch.int32,
                            device=x.device)
    ar = torch.arange(s, dtype=torch.int32, device=x.device)
    pos_q = start[:, None] + ar if start.dim() == 1 else start + ar
    q = _project(p["wq"], x, lc, cfg.num_heads, hd)
    k = _project(p["wk"], x, lc, cfg.num_kv_heads, hd)
    v = _project(p["wv"], x, lc, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.apply_norm(p["q_norm"], q, "rmsnorm")
        k = layers.apply_norm(p["k_norm"], k, "rmsnorm")
    if cfg.rope_theta is not None:
        q = layers.apply_rope(q, pos_q, cfg.rope_theta)
        k = layers.apply_rope(k, pos_q, cfg.rope_theta)

    aux: dict = {}
    if mode in ("train", "prefill"):
        out, aux = attend(p, cfg, q, k, v, causal, window,
                          seq_lengths=seq_lengths)
        if mode == "prefill":
            cache = write_cache(cache, cfg, p, k, v, pos_q)
    elif mode == "decode" and page_table is not None and window is None:
        pos_b = start.expand(b) if start.dim() == 0 else start
        out = _decode_paged(p, cfg, q, k, v, cache, pos_b, kv_valid,
                            page_table, hd ** -0.5)
    elif mode == "decode":
        cache = write_cache(cache, cfg, p, k, v, pos_q)
        size = cache["k"].shape[2]
        if (kv_valid is not None and window is None
                and kv_valid.shape[-1] == size):
            valid = kv_valid                               # engine-tracked
        else:
            valid = kv_valid_mask(cache, start, window)
        scale = hd ** -0.5
        if sparse_applicable(cfg):
            args = (q, cache["k"], cache["v"], cache["codes"],
                    p["pq"]["codebooks"], _sa_config(cfg), scale, valid)
            if dispatch.use_sparse_decode_kernel(cfg):
                from repro_torch.kernels.sparse_attention import ops as sa_ops
                out = sa_ops.sparse_mha_decode(
                    *args, fuse=dispatch.use_fused_decode_attn(cfg))
            else:
                out = sa.sparse_mha_decode(*args)
        else:
            out = sa.dense_attention(q, cache["k"], cache["v"], scale,
                                     causal=False, kv_valid=valid, chunk_q=1)
    else:
        raise ValueError(mode)

    out = out.transpose(1, 2).reshape(b, s, cfg.num_heads * hd)
    return lora.linear(out, p["wo"], lc), cache, aux
