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

Under a mesh with a model axis of extent n the layer runs this rank's
Hq/n query heads (``tp_plan``): with them its Hk/n kv heads where n
divides Hk (a kv group stays whole on one rank, so
``select_granularity="kvgroup"`` selects as without a mesh), or, where
the kv heads do not split but n is a multiple of Hk, the one kv head
its query heads lie in (rank r reads head r // (n / Hk)).  The params
are stored as JAX places them (``tp_specs``): q and o over the heads,
k and v over their columns wherever those divide n — split inside a kv
head there, so the layer gathers them: the weights at a train region's
entry (``collectives.Gathered``), the K/V projections when serving.  In
train mode under the sequence-parallel layout (``tp``) it is a
tensor-parallel region: it gathers the sequence and reduce-scatters the
o-projection's partial output back over it (core/collectives.py).

Serving under a mesh (``transformer.ShardedLM``, ``AttnShard``) keeps a
cache as JAX's ``cache_axes`` place it: over the kv heads where they
split, else its sequence over the model axis where the length divides
(``seq_parts``: rank r holds slots [r S/n, (r+1) S/n) of every kv head;
``slot_pos`` stays whole), else whole.  A token is written by the rank
that holds its slot.  Decode over a split sequence (``decode_seq_split``)
takes every query head (gathered over the model axis), scores its own
slots (kernel 3, which also writes the row's histogram), adds the
ranks' histograms up to the whole row's [t, need] (``split_thresholds``:
ties newest first by cache index, so a higher rank's ties come first),
attends over its own selection (kernel 5, with each row's log-sum-exp),
and combines the parts by their log-sum-exps (``combine_parts``), each
rank keeping its heads' rows; the output projection's partial output
is then summed over the model axis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core import dispatch, lora, pq
from repro_torch.core.params import spec_tree
from repro_torch.core import sparse_attention as sa
from repro_torch.kernels.topl_select.ref import hist_reduce
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
        "wq": lora.linear_defs(d, hq * hd, lc, "embed", "heads"),
        "wk": lora.linear_defs(d, hk * hd, lc, "embed", "kv_heads"),
        "wv": lora.linear_defs(d, hk * hd, lc, "embed", "kv_heads"),
        "wo": lora.linear_defs(hq * hd, d, lc, "heads", "embed"),
    }
    if cfg.qk_norm:
        defs["q_norm"] = layers.norm_defs(hd, "rmsnorm", None)
        defs["k_norm"] = layers.norm_defs(hd, "rmsnorm", None)
    if sparse_applicable(cfg):
        defs["pq"] = pq.param_defs(_pq_config(cfg))
    return defs


def cache_size(max_len: int, window: Optional[int]) -> int:
    """Slots of a sequence's cache: the SWA window when present (ring
    buffer)."""
    return max_len if window is None else min(max_len, window)


def seq_parts(kv_heads: int, size: int, n: int) -> int:
    """The parts that a cache's sequence of ``size`` slots splits into
    over a model axis of extent n: n where the kv heads do not take the
    axis and the length divides, else 1 — JAX's ("batch", "kv_heads",
    "seq_shard", None) under its rules (one mesh axis a spec, the kv
    heads first; a dim that does not divide stays whole)."""
    return n if n > 1 and kv_heads % n and size % n == 0 else 1


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               window: Optional[int] = None, *,
               kv_heads: Optional[int] = None,
               parts: int = 1) -> Dict[str, torch.Tensor]:
    """Cache sized to the SWA window when present (ring buffer).  kv_heads:
    the heads it holds (default the config's); parts: its sequence split
    into that many parts, of which it holds one (``slot_pos`` stays
    whole)."""
    size = cache_size(max_len, window)
    hk = cfg.num_kv_heads if kv_heads is None else kv_heads
    hd = cfg.resolved_head_dim
    local = size // parts
    cache = {
        "k": torch.zeros((batch, hk, local, hd), dtype=cfg.dtype,
                         device=device),
        "v": torch.zeros((batch, hk, local, hd), dtype=cfg.dtype,
                         device=device),
        "slot_pos": torch.full((batch, size), -1, dtype=torch.int32,
                               device=device),
    }
    if sparse_applicable(cfg):
        m = _pq_config(cfg).num_books
        cache["codes"] = torch.zeros((batch, hk, local, m),
                                     dtype=torch.int8, device=device)
    return cache


def init_paged_cache(cfg: ModelConfig, num_pages: int, device,
                     kv_heads: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """Paged pool layout: the per-slot (B, size, ...) strips become a
    global (num_pages, page_size, ...) pool addressed through the engine's
    slot->page table.  Same keys as init_cache."""
    ps = cfg.spt.kv_page_size
    hk = cfg.num_kv_heads if kv_heads is None else kv_heads
    hd = cfg.resolved_head_dim
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


def _project(p, x: torch.Tensor, lc, heads: int, hd: int,
             serve: Optional["AttnShard"] = None) -> torch.Tensor:
    """(B, heads, S, hd) of a projection; a serving rank's k or v columns
    gathered over its axis where they split (``AttnShard.kv_cols``)."""
    y = lora.linear(x, p, lc)
    if serve is not None and serve.kv_cols:
        y = C.gather(y, y.dim() - 1, serve.ax)
    b, s, _ = y.shape
    return y.reshape(b, s, heads, hd).transpose(1, 2)


def _write_split(cache: dict, p, k: torch.Tensor, v: torch.Tensor,
                 pos_k, rank: int) -> dict:
    """``write_cache`` on rank ``rank``'s part of a split sequence: slot
    pos % S of a token, S the whole length (``slot_pos``'s), is written
    where this rank holds it, at slot - rank * S_local; ``slot_pos``
    (whole) everywhere.  pos_k: the decode's position of each row ((B, 1)
    or one for all, on the device), or an int, the first of the prompt's
    positions (prefill)."""
    size, local = cache["slot_pos"].shape[-1], cache["k"].shape[2]
    lo = rank * local
    if isinstance(pos_k, int):                   # prefill: host indices
        pos = torch.arange(pos_k, pos_k + k.shape[2])[-size:]
        keep = k.shape[2] - pos.shape[0]
        slot = pos % size
        mine = torch.nonzero((slot >= lo) & (slot < lo + local)).flatten()
        cache["slot_pos"][:, slot.to(k.device)] = pos.to(
            device=k.device, dtype=torch.int32)[None]
        if mine.numel() == 0:
            return cache
        src = (mine + keep).to(k.device)
        dst = (slot[mine] - lo).to(k.device)
        ks = k.index_select(2, src)
        cache["k"][:, :, dst] = ks.to(cache["k"].dtype)
        cache["v"][:, :, dst] = v.index_select(2, src).to(cache["v"].dtype)
        if "codes" in cache:
            cache["codes"][:, :, dst] = pq.assign(
                ks, p["pq"]["codebooks"]).to(torch.int8)
        return cache
    b = cache["k"].shape[0]
    pos_k = pos_k.reshape(-1, 1).expand(b, 1)    # one position a row
    slot = (pos_k[:, 0] % size).long()                    # (B,)
    cache["slot_pos"][torch.arange(b, device=k.device), slot] = \
        pos_k[:, 0].to(torch.int32)
    mine = (slot >= lo) & (slot < lo + local)
    dst = (slot - lo).clamp(0, local - 1)
    bidx = torch.arange(b, device=k.device)
    news = {"k": k[:, :, 0], "v": v[:, :, 0]}
    if "codes" in cache:
        news["codes"] = pq.assign(k, p["pq"]["codebooks"])[:, :, 0]
    for key, new in news.items():               # a row not held: kept
        old = cache[key][bidx, :, dst]                    # (B, Hk, X)
        cache[key][bidx, :, dst] = torch.where(
            mine[:, None, None], new.to(old.dtype), old)
    return cache


def write_cache(cache: dict, cfg: ModelConfig, p, k: torch.Tensor,
                v: torch.Tensor, pos_k: torch.Tensor,
                split: Optional[Tuple[int, int]] = None) -> dict:
    """Scatter new keys/values (and their PQ codes) into the cache in
    place.  pos_k: (S_new,) shared positions, or (B, S_new) per-row
    positions (decode slots at ragged depths).  split: (rank, parts) of a
    cache whose sequence splits over the model axis (``seq_parts``); pos_k
    is then the decode's (B, 1) positions or the prefill's first position
    as an int."""
    if split is not None and split[1] > 1:
        return _write_split(cache, p, k, v, pos_k, split[0])
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
    takes the core/ gather path, as in the JAX package;
    ``attn_impl="sparse_masked"`` takes the masked oracle."""
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
    if cfg.spt.attn_impl == "sparse_masked":
        return sa.sparse_mha_masked(*args, **kw)
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


def _tel_decode_counters(cfg: ModelConfig, valid: torch.Tensor) -> dict:
    """Sparsity counters of one decode step (telemetry), from the validity
    mask alone: the decode paths select top-L = top_l(mask width) of the
    valid slots, so per row kept = min(L, n_valid) and eligible = n_valid.
    One mask reduction per attention layer; no score is recomputed."""
    n_valid = valid.sum(-1).to(torch.float32)                   # (B,)
    l = sa.top_l(valid.shape[-1], _sa_config(cfg), None)
    return {"tel_attn_kept": torch.clamp(n_valid, max=float(l)),
            "tel_attn_elig": n_valid}


def tp_plan(cfg: ModelConfig, n: int) -> Optional[ModelConfig]:
    """The config of this rank's heads at model extent n: Hq/n query heads
    on Hk/n kv heads, or, where n is a multiple of Hk, inside one kv head
    (``kv_head_of``); None when the heads do not split (every rank
    computes them all, as the rules fall back) — also for kv heads that do
    not split under ``select_granularity="kvgroup"``, whose selection sums
    over all of a kv head's queries."""
    hq, hk = cfg.num_heads, cfg.num_kv_heads
    if hq == 0 or hq % n or (hk % n and n % hk):
        return None
    if hk % n and cfg.spt.select_granularity == "kvgroup":
        return None
    return dataclasses.replace(cfg, num_heads=hq // n,
                               num_kv_heads=hk // n if hk % n == 0 else 1,
                               head_dim=cfg.resolved_head_dim)


def kv_head_of(cfg: ModelConfig, n: int, rank: int) -> Optional[int]:
    """The kv head that rank ``rank``'s query heads lie in where the kv
    heads do not split (``tp_plan``); None where they split."""
    hk = cfg.num_kv_heads
    return None if hk % n == 0 else rank // (n // hk)


def tp_specs(cfg: ModelConfig, n: int) -> dict:
    """Placements of ``attn_defs(cfg)`` under ``tp_plan``, JAX's: q and o
    over the heads, k and v over their columns where those divide (over
    the kv heads where n divides them)."""
    rules = {"heads": "model", "kv_heads": "model",
             "__sizes__": {"model": n}}
    return spec_tree(attn_defs(cfg), rules)


def _gathered(specs):
    """``specs`` with each leaf split over "model" marked to be used whole
    in a region (``collectives.Gathered``)."""
    if isinstance(specs, dict):
        return {k: _gathered(v) for k, v in specs.items()}
    for dim, entry in enumerate(specs):
        if entry == "model":
            return C.Gathered(dim)
    return specs


def _head_cols(p: dict, h: int, hd: int) -> dict:
    """A k or v projection (w, LoRA) cut to kv head h's columns."""
    cols = slice(h * hd, (h + 1) * hd)
    out = {"w": p["w"][:, cols]}
    if "lora" in p:
        out["lora"] = {**p["lora"], "c": p["lora"]["c"][:, cols]}
    return out


def _attn_region(p, x: torch.Tensor, cfg: ModelConfig, tp: C.Axis,
                 kv_x: Optional[torch.Tensor] = None,
                 **kw) -> Tuple[torch.Tensor, None, dict]:
    """Train-mode attention on this rank's sequence chunk x (B, S/n, d):
    the whole sequence in, this rank's heads (``tp_plan``; else every
    head, replicated, as the rules fall back), the output's chunk out.
    Where the query heads split inside a kv head, k and v enter whole
    (gathered over the axis at the entry) and are cut to that head.
    kv_x: cross-attention's source, whole on every rank (gathered by the
    caller).  ``qerr`` leaves as the mean over the heads."""
    local = tp_plan(cfg, tp.size)
    if local is not None:
        specs = tp_specs(cfg, tp.size)
        h = kv_head_of(cfg, tp.size, tp.rank)
        if h is not None:
            specs = {**specs, "wk": _gathered(specs["wk"]),
                     "wv": _gathered(specs["wv"])}
        xf, p = C.enter_region(x, p, specs, tp)
        if h is not None:
            hd = cfg.resolved_head_dim
            p = {**p, "wk": _head_cols(p["wk"], h, hd),
                 "wv": _head_cols(p["wv"], h, hd)}
        y, _, aux = attn_apply(p, xf, local, mode="train", kv_x=kv_x, **kw)
        y, mean = C.scatter_seq(y, tp), C.pmean
    else:
        xf, p = C.enter_region(x, p, None, tp)
        y, _, aux = attn_apply(p, xf, cfg, mode="train", kv_x=kv_x, **kw)
        y, mean = C.split_seq(y, tp), C.mean_exit
    if "qerr" in aux:
        aux = {**aux, "qerr": mean(aux["qerr"], tp)}
    return y, None, aux


# ------------------------------------------------------------ serving
@dataclasses.dataclass(frozen=True)
class AttnShard:
    """One serving rank's attention layer over the model axis ``ax``:
    ``kv_heads`` is the layer's whole kv head count; ``kv_head`` the kv
    head its query heads lie in where the query heads split (``tp_plan``)
    and the kv heads do not (None where they split, or where the heads
    stay whole and every rank computes them all); ``kv_cols`` that wk and
    wv are stored split on their columns there (the K/V projections are
    then gathered over ``ax``)."""
    ax: C.Axis
    kv_heads: int
    kv_head: Optional[int]
    kv_cols: bool

    def cache_heads(self, cfg: ModelConfig) -> int:
        """The kv heads a cache of this rank holds (cfg its local
        config): its own where they split, else all of them."""
        return (cfg.num_kv_heads if self.kv_heads % self.ax.size == 0
                else self.kv_heads)

    def parts(self, size: int) -> int:
        """The parts a cache's sequence of ``size`` slots splits into."""
        return seq_parts(self.kv_heads, size, self.ax.size)


def serve_plan(cfg: ModelConfig, ax: Optional[C.Axis]
               ) -> Optional[AttnShard]:
    """The attention layers' ``AttnShard`` of a serving rank on the model
    axis ``ax`` (None at extent 1 or without heads)."""
    if ax is None or not cfg.num_heads:
        return None
    n = ax.size
    split = tp_plan(cfg, n) is not None
    h = kv_head_of(cfg, n, ax.rank) if split else None
    cols = (split and h is not None
            and (cfg.num_kv_heads * cfg.resolved_head_dim) % n == 0)
    return AttnShard(ax=ax, kv_heads=cfg.num_kv_heads, kv_head=h,
                     kv_cols=cols)


def split_thresholds(hists: torch.Tensor, l: int, rank: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hists (n, ..., nb): each rank's score histograms of its part of a
    split sequence -> ([t, need] of the whole rows (..., 2), [t, need_r]
    of rank ``rank``'s part), int32: the whole [t, need] from the summed
    histograms (``hist_reduce``); of the ``need`` ties at t, taken newest
    first by cache index, the higher ranks' come first, so rank r takes
    need_r = max(0, need - ties at t of the ranks above it)."""
    thr = hist_reduce(hists.sum(0), l)
    t = thr[..., 0].long()
    ties = hists.gather(-1, t.expand(hists.shape[:-1])[..., None])[..., 0]
    above = ties[rank + 1:].sum(0)
    need_r = (thr[..., 1] - above).clamp(min=0)
    return thr, torch.stack([thr[..., 0], need_r.to(torch.int32)], dim=-1)


def part_weight(lse: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The weight exp(lse - logsumexp over the ranks) of one rank's part
    of an attention over a split sequence: lse (...) its rows' log-sum-
    exps, lses (n, ...) every rank's; 0 where its row selects nothing
    (a row with no key on any rank then sums to 0)."""
    tot = torch.logsumexp(lses, dim=0)
    return torch.where(lse > float("-inf"), torch.exp(lse - tot), 0.0)


def combine_parts(o: torch.Tensor, lse: torch.Tensor, ax: C.Axis,
                  scatter_dim: Optional[int] = None) -> torch.Tensor:
    """The attention over a split sequence from each rank's part: o
    (..., d) this rank's output over its selected keys, lse (...) f32 its
    log-sum-exp -> sum over ranks of ``part_weight`` x o, in f32: the
    ranks' log-sum-exps all-gathered, the weighted parts summed over
    ``ax`` by an all-reduce, or by a reduce-scatter along ``scatter_dim``
    (each rank keeps its chunk of that dim)."""
    w = part_weight(lse, C.stack_ranks(lse, ax))
    part = o.float() * w[..., None]
    if scatter_dim is None:
        return C.model_sum(part, ax)
    return C.model_scatter(part, scatter_dim, ax)


def decode_seq_split(p, cfg: ModelConfig, q: torch.Tensor, cache: dict,
                     valid: torch.Tensor, ax: C.Axis, scatter: bool,
                     kernel: Optional[bool] = None
                     ) -> Tuple[torch.Tensor, dict]:
    """One decode step over a cache whose sequence splits over ``ax``:
    q (B, Hq, 1, d) every query head; cache this rank's part (B, Hk,
    S/n, .); valid (B, S) the whole rows' validity.  Sparse MHA selects
    top-L of the whole row (L = top_l(S)): kernel 3 (or its plain
    version) gives this rank's histograms, ``split_thresholds`` the whole
    [t, need] and this rank's tie budget, kernel 5 its part with each
    row's log-sum-exp; dense decode attends over every valid slot.
    ``combine_parts`` merges the parts; with ``scatter`` (the query heads
    split) each rank keeps its heads' rows.  kernel: the kernels or their
    plain versions (default ``dispatch.use_sparse_decode_kernel``).
    Returns (out (B, Hq', 1, d)
    in q's dtype, the telemetry counters of the whole rows, if on)."""
    b, hq, _, d = q.shape
    _, hk, s_loc, _ = cache["k"].shape
    n, r = ax.size, hq // hk
    lo = ax.rank * s_loc
    valid_loc = valid[:, lo:lo + s_loc].contiguous()
    scale = d ** -0.5
    qg = q.reshape(b * hk, r, d)
    kg = cache["k"].reshape(b * hk, s_loc, d)
    vg = cache["v"].reshape(b * hk, s_loc, d)
    aux: dict = {}
    if sparse_applicable(cfg):
        from repro_torch.kernels.sparse_attention import ops as sa_ops
        from repro_torch.kernels.sparse_attention.ref import (
            sparse_decode_attention_ref)
        from repro_torch.kernels.topl_select.ops import (
            decode_topl_thresholds)
        from repro_torch.kernels.topl_select.ref import decode_score_hist
        sc = _sa_config(cfg)
        sum_rows = sc.select_granularity == "kvgroup"
        l = sa.top_l(n * s_loc, sc, None)
        m = sc.pq.num_books
        sel = dict(max_score=m * (r if sum_rows else 1), sum_rows=sum_rows,
                   heads_per_batch=hk)
        codes_q = pq.assign(q, p["pq"]["codebooks"]).reshape(b * hk, r, m)
        ck = cache["codes"].reshape(b * hk, s_loc, m)
        if kernel is None:
            kernel = dispatch.use_sparse_decode_kernel(cfg)
        if kernel:
            _, hist = decode_topl_thresholds(codes_q, ck, valid_loc, l=l,
                                             return_hist=True, **sel)
        else:
            hist = decode_score_hist(codes_q, ck, valid_loc, **sel)
        hists = C.stack_ranks(hist, ax)              # (n, G, R_out, nb)
        _, thr_r = split_thresholds(hists, l, ax.rank)
        args = (qg, kg, vg, codes_q, ck, thr_r, valid_loc)
        kw = dict(scale=scale, sum_rows=sum_rows, heads_per_batch=hk,
                  return_lse=True)
        o, lse = (sa_ops.sparse_decode_attention(*args, **kw) if kernel
                  else sparse_decode_attention_ref(*args, **kw))
        if dispatch.use_telemetry_counters(cfg):
            # each valid slot counts once in a row's histogram
            nv = hists.sum(0).reshape(b, hk, -1, hists.shape[-1])[
                :, 0, 0].sum(-1).to(torch.float32)
            aux = {"tel_attn_kept": torch.clamp(nv, max=float(l)),
                   "tel_attn_elig": nv}
    else:
        from repro_torch.kernels.sparse_attention.ref import _attend
        o, lse = _attend(qg, kg, vg, valid_loc.repeat_interleave(
            hk, dim=0)[:, None, :], scale, lse=True)
    out = combine_parts(o.reshape(b, hq, d), lse.reshape(b, hq), ax,
                        1 if scatter else None)
    return out.to(q.dtype)[:, :, None], aux


def attn_apply(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str = "train",
               causal: bool = True, window: Optional[int] = None,
               cache: Optional[dict] = None, pos=None,
               kv_x: Optional[torch.Tensor] = None, rope: bool = True,
               kv_valid: Optional[torch.Tensor] = None,
               page_table: Optional[torch.Tensor] = None,
               seq_lengths: Optional[torch.Tensor] = None,
               tp: Optional[C.Axis] = None,
               serve: Optional[AttnShard] = None
               ) -> Tuple[torch.Tensor, Optional[dict], dict]:
    """Returns (y, cache, aux).  x: (B, S, d_model).  pos: absolute
    position of x[:, 0], an int or a (B,) tensor (ragged decode slots).
    kv_x: the source of K and V (cross-attention; x by default), whose
    keys take positions 0..F-1 while the queries keep theirs.  rope:
    False skips RoPE even where ``rope_theta`` is set.
    kv_valid: decode only, the engine's (B, S_cache) slot validity (with
    a page table, (B, MP * page_size) in view coordinates); without it
    the mask is derived from the cache's slot_pos.  page_table: decode
    only, the (B, MP) slot->page map that marks ``cache`` as a paged pool
    (ring-buffer SWA caches ignore it).  With telemetry counters on
    (``dispatch.use_telemetry_counters``), a sparse decode step reports
    ``tel_attn_kept`` / ``tel_attn_elig`` (B,) in aux.
    tp: the model axis of the sequence-parallel layout (train mode): x is
    this rank's sequence chunk, and so is y (kv_x, if given, is whole).
    serve: prefill and decode under a serving mesh (``AttnShard``; p and
    cfg this rank's, from ``transformer.ShardedLM``): the K/V projections
    gathered where their columns split, a query head split inside a kv
    head, and a cache whose sequence splits over the axis (module
    docstring); y is then this rank's partial output."""
    if tp is not None:
        C.train_layout(mode)
        return _attn_region(p, x, cfg, tp, kv_x=kv_x, causal=causal,
                            window=window, rope=rope)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    lc = cfg.spt.lora
    start = torch.as_tensor(0 if pos is None else pos, dtype=torch.int32,
                            device=x.device)
    ar = torch.arange(s, dtype=torch.int32, device=x.device)
    pos_q = start[:, None] + ar if start.dim() == 1 else start + ar
    kv_src = x if kv_x is None else kv_x
    pos_k = (pos_q if kv_x is None else
             torch.arange(kv_x.shape[1], dtype=torch.int32, device=x.device))
    inside = serve is not None and serve.kv_head is not None
    hk = serve.kv_heads if inside else cfg.num_kv_heads
    q = _project(p["wq"], x, lc, cfg.num_heads, hd)
    k = _project(p["wk"], kv_src, lc, hk, hd, serve)
    v = _project(p["wv"], kv_src, lc, hk, hd, serve)
    if cfg.qk_norm:
        q = layers.apply_norm(p["q_norm"], q, "rmsnorm")
        k = layers.apply_norm(p["k_norm"], k, "rmsnorm")
    if rope and cfg.rope_theta is not None:
        q = layers.apply_rope(q, pos_q, cfg.rope_theta)
        k = layers.apply_rope(k, pos_k, cfg.rope_theta)
    # a cache whose sequence splits over the model axis: (rank, parts)
    split = None
    if serve is not None and cache is not None and page_table is None:
        parts = cache["slot_pos"].shape[-1] // cache["k"].shape[2]
        split = (serve.ax.rank, parts) if parts > 1 else None

    aux: dict = {}
    if mode in ("train", "prefill"):
        ka, va = k, v
        if inside:                   # this rank's query heads' kv head
            h = serve.kv_head
            ka, va = k[:, h:h + 1], v[:, h:h + 1]
        out, aux = attend(p, cfg, q, ka, va, causal, window,
                          seq_lengths=seq_lengths)
        if mode == "prefill":
            cache = write_cache(cache, cfg, p, k, v,
                                pos_k if split is None else int(pos or 0),
                                split)
        out = out.transpose(1, 2).reshape(b, s, cfg.num_heads * hd)
        return lora.linear(out, p["wo"], lc), cache, aux
    if mode != "decode":
        raise ValueError(mode)
    # every query head where this rank's lie inside a kv head, or where
    # the cache's sequence splits (each rank then attends over its part)
    qd = C.gather(q, 1, serve.ax) if inside else q
    if page_table is not None and window is None:
        pos_b = start.expand(b) if start.dim() == 0 else start
        s_view = page_table.shape[1] * cfg.spt.kv_page_size
        if (sparse_applicable(cfg) and kv_valid is not None
                and kv_valid.shape[-1] == s_view
                and dispatch.use_telemetry_counters(cfg)):
            aux.update(_tel_decode_counters(cfg, kv_valid))
        out = _decode_paged(p, cfg, qd, k, v, cache, pos_b, kv_valid,
                            page_table, hd ** -0.5)
    else:
        cache = write_cache(cache, cfg, p, k, v, pos_q, split)
        size = cache["slot_pos"].shape[-1]
        if (kv_valid is not None and window is None
                and kv_valid.shape[-1] == size):
            valid = kv_valid                               # engine-tracked
        else:
            valid = kv_valid_mask(cache, start, window)
        if split is not None:
            out, tel = decode_seq_split(p, cfg, qd, cache, valid, serve.ax,
                                        scatter=inside)
            aux.update(tel)
        else:
            out = _decode_whole(p, cfg, qd, cache, valid, aux)
    if inside and split is None:     # this rank's heads of every head's
        nq = cfg.num_heads
        out = out[:, serve.ax.rank * nq:(serve.ax.rank + 1) * nq]
    out = out.transpose(1, 2).reshape(b, s, cfg.num_heads * hd)
    return lora.linear(out, p["wo"], lc), cache, aux


def _decode_whole(p, cfg: ModelConfig, q: torch.Tensor, cache: dict,
                  valid: torch.Tensor, aux: dict) -> torch.Tensor:
    """One decode step over a whole contiguous cache (the telemetry
    counters into aux)."""
    scale = cfg.resolved_head_dim ** -0.5
    if not sparse_applicable(cfg):
        return sa.dense_attention(q, cache["k"], cache["v"], scale,
                                  causal=False, kv_valid=valid, chunk_q=1)
    if dispatch.use_telemetry_counters(cfg):
        aux.update(_tel_decode_counters(cfg, valid))
    args = (q, cache["k"], cache["v"], cache["codes"],
            p["pq"]["codebooks"], _sa_config(cfg), scale, valid)
    if dispatch.use_sparse_decode_kernel(cfg):
        from repro_torch.kernels.sparse_attention import ops as sa_ops
        return sa_ops.sparse_mha_decode(
            *args, fuse=dispatch.use_fused_decode_attn(cfg))
    return sa.sparse_mha_decode(*args)
