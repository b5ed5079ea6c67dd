"""Sparse multi-head attention (paper §4.1, Algorithm 1), plain torch.

Pipeline per attention layer: PQ-quantize Q and K (core/pq.py), integer
match-count scores s(q, k) in [0, M], top-L selection under the causal /
window mask, attention restricted to the selected pairs with the softmax
renormalized over them.  Canonical tie-break (shared with the CUDA decode
kernel so index sets match exactly): higher score first, then the more
recent key (higher index).

These are the oracle paths: the ragged prefill always runs ``sparse_mha``
here, and ``REPRO_DISABLE_KERNELS=1`` sends decode to
``sparse_mha_decode`` instead of the fused CUDA kernel.  The masked forms
(``sparse_mha_masked``, ``attn_impl="sparse_masked"``, and
``sparse_mha_decode_masked``) apply the same selection as a mask on dense
logits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import pq


@dataclasses.dataclass(frozen=True)
class SparseAttentionConfig:
    pq: pq.PQConfig
    top_fraction: float = 0.125
    min_l: int = 16
    pad_l_to: int = 1
    chunk_q: int = 256
    select_granularity: str = "qhead"  # "qhead" | "kvgroup"
    qerr_loss_weight: float = 0.0


def top_l(seq_len: int, cfg: SparseAttentionConfig,
          window: Optional[int] = None) -> int:
    """L for a given sequence length (bounded by the SWA window if any)."""
    horizon = seq_len if window is None else min(seq_len, window)
    l = max(cfg.min_l, int(round(horizon * cfg.top_fraction)))
    l = -(-l // cfg.pad_l_to) * cfg.pad_l_to
    return min(l, horizon)


def top_l_dyn(horizon: torch.Tensor, cfg: SparseAttentionConfig,
              window: Optional[int] = None) -> torch.Tensor:
    """Per-row ``top_l`` for (B,) int lengths; float32 round-half-even like
    the host formula (exact for the dyadic fractions every config uses)."""
    h = horizon.to(torch.int32)
    if window is not None:
        h = torch.clamp(h, max=window)
    l = torch.round(h.float() * cfg.top_fraction).to(torch.int32)
    l = torch.clamp(l, min=cfg.min_l)
    l = -(-l // cfg.pad_l_to) * cfg.pad_l_to
    return torch.minimum(l, h)


def _combined_score(scores: torch.Tensor, key_pos: torch.Tensor,
                    mask: torch.Tensor, nk: int) -> torch.Tensor:
    """Fold the tie-break into one sortable f32: score*nk + key_index
    (exact for score*nk + j < 2^24); masked entries -1."""
    comb = scores.float() * float(nk) + key_pos.float()
    return torch.where(mask, comb, -1.0)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to
    the lower index as ``jax.lax.top_k`` breaks them (``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_topl(scores: torch.Tensor, l: int, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-L selection with the canonical tie-break, by sorting (the
    reference; ``bucket_select`` selects the same set without a sort).

    scores: (..., nq, nk) integer-valued; mask: (..., nq, nk) bool.
    Returns indices (..., nq, L) int32 by descending combined score,
    valid (..., nq, L) bool."""
    nk = scores.shape[-1]
    key_pos = torch.arange(nk, dtype=torch.int32, device=scores.device)
    top, idx = _top_k(_combined_score(scores, key_pos, mask, nk), l)
    return idx.to(torch.int32), top >= 0.0


def _eligibility(scores: torch.Tensor, valid: torch.Tensor, budget,
                 max_score: int) -> torch.Tensor:
    """The top-L set as a boolean mask: every key above the threshold
    bucket t plus the ``need`` most recent keys at t (ties newest first).
    scores: (..., nk) integer-valued in [0, max_score]; valid broadcastable
    to it; budget: L, or per-row budgets broadcastable to
    scores.shape[:-1]."""
    s = torch.where(valid, scores.to(torch.int32), -1)
    budget = torch.as_tensor(budget, dtype=torch.int64, device=s.device)
    counts = torch.stack([(s == v).sum(-1) for v in range(max_score + 1)],
                         dim=-1)
    ge = counts.flip(-1).cumsum(-1).flip(-1)                # #(s >= v)
    meets = (ge >= budget[..., None]).sum(-1)
    t = torch.clamp(meets - 1, min=0)                       # threshold bucket
    ge_pad = torch.cat([ge, torch.zeros_like(ge[..., :1])], dim=-1)
    n_above = ge_pad.gather(-1, (t + 1)[..., None])[..., 0]
    need = budget - n_above
    above = s > t[..., None]
    at_t = s == t[..., None]
    rev_rank = at_t.int().flip(-1).cumsum(-1).flip(-1)      # 1 = newest tie
    return above | (at_t & (rev_rank <= need[..., None]))


def bucket_select(scores: torch.Tensor, valid: torch.Tensor, l: int,
                  max_score: int, l_dyn: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-free top-L (the paper's bucket sort, Algorithm 3).

    scores: (..., nk) integer-valued in [0, max_score]; valid broadcastable
    to it.  Takes every key above the threshold bucket t plus the ``need``
    most recent keys at t.  l_dyn: optional per-row budgets (<= l)
    broadcastable to scores.shape[:-1].  Returns (idx (..., L) int32 in
    ascending key order, sel_valid (..., L) bool)."""
    nk = scores.shape[-1]
    eligible = _eligibility(scores, valid, l if l_dyn is None else l_dyn,
                            max_score)
    n_sel = eligible.sum(-1)
    pos = torch.arange(nk, dtype=torch.int32, device=scores.device)
    key = torch.where(eligible, pos, nk)
    idx = torch.topk(key, l, dim=-1, largest=False, sorted=True).values
    idx = torch.clamp(idx, max=nk - 1).to(torch.int32)
    targets = torch.arange(1, l + 1, device=scores.device)
    return idx, targets <= n_sel[..., None]


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                   window: Optional[int]) -> torch.Tensor:
    """(nq, nk) bool validity mask built from positions."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def _kv_rows(b: int, hk: int, hsel: int, device) -> torch.Tensor:
    """(B, Hsel) row of the flattened (B*Hk) kv-head axis serving each
    selection head (Hsel = Hq: query head h reads kv head h // R)."""
    r = hsel // hk
    heads = torch.arange(hsel, device=device) // r
    return torch.arange(b, device=device)[:, None] * hk + heads[None, :]


def _masked_softmax(logits: torch.Tensor, valid: torch.Tensor
                    ) -> torch.Tensor:
    logits = torch.where(valid, logits, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.where(valid, w, 0.0)                       # all-invalid -> 0


def attention_from_indices(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           indices: torch.Tensor, valid: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """Gather-based sparse attention.  q: (B, Hq, nq, d); k, v: (B, Hk,
    nk, d); indices/valid: (B, Hq, nq, L) key positions per query head.
    Only the gathered (B, Hq, nq, L, d) rows are built; the cache is never
    repeated across query heads."""
    b, hq, nq, d = q.shape
    _, hk, nk, _ = k.shape
    l = indices.shape[-1]
    rows = _kv_rows(b, hk, hq, q.device)[:, :, None, None] * nk
    flat = (rows + indices.long()).reshape(-1)
    k_sel = k.reshape(b * hk * nk, d).index_select(0, flat)
    v_sel = v.reshape(b * hk * nk, d).index_select(0, flat)
    k_sel = k_sel.reshape(b, hq, nq, l, d)
    v_sel = v_sel.reshape(b, hq, nq, l, d)
    logits = torch.einsum("bhnd,bhnld->bhnl", q.float(), k_sel.float())
    w = _masked_softmax(logits * scale, valid)
    return torch.einsum("bhnl,bhnld->bhnd", w.to(v.dtype), v_sel)


def _chunks(nq: int, chunk_q: int):
    """(start, rows) of the query chunks: chunk_q rows each, the last one
    shorter.  (JAX takes one chunk of nq when chunk_q does not divide it,
    for static shapes; each row's result is the same either way, and a
    576-row frontend ahead of a power-of-two prompt would otherwise make
    the whole (nq, L, d) gather live at once.)"""
    return [(s, min(chunk_q, nq - s)) for s in range(0, nq, chunk_q)]


def sparse_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               codebooks: torch.Tensor, cfg: SparseAttentionConfig,
               scale: float, causal: bool = True,
               window: Optional[int] = None, q_offset: int = 0,
               seq_lengths: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """Algorithm 1 for a (possibly GQA) layer, train/prefill form.

    q: (B, Hq, nq, d); k, v: (B, Hk, nk, d).  seq_lengths: optional (B,)
    real lengths of a right-padded ragged batch; each row then selects with
    the budget top_l(seq_lengths[b]) its exact-length prefill would have
    (the causal mask already hides the pad keys from real queries).
    Selection and gather run per query chunk (``_chunks``), so the live
    gather buffer is (B, H, chunk, L, d).  Returns (out (B, Hq, nq, d), aux {"l": L, and
    "qerr" when cfg.qerr_loss_weight > 0})."""
    b, hq, nq, d = q.shape
    _, hk, nk, _ = k.shape
    r = hq // hk
    m = codebooks.shape[0]
    l = top_l(nk, cfg, window)
    l_dyn = (None if seq_lengths is None
             else top_l_dyn(seq_lengths, cfg, window).reshape(b, 1, 1))
    codes_q = pq.assign(q, codebooks)                       # (B, Hq, nq, M)
    codes_k = pq.assign(k, codebooks)                       # (B, Hk, nk, M)
    k_pos = torch.arange(nk, dtype=torch.int32, device=q.device)
    kvgroup = cfg.select_granularity == "kvgroup"
    max_s = cfg.pq.num_books * (r if kvgroup else 1)

    def chunk_fn(start, chunk, q, k, v):
        q_pos = q_offset + start + torch.arange(chunk, dtype=torch.int32,
                                                device=q.device)
        mask = attention_mask(q_pos, k_pos, causal, window)
        cqc = codes_q[:, :, start:start + chunk].reshape(b, hk, r, chunk, m)
        s = pq.match_scores(cqc, codes_k[:, :, None], cfg.pq.num_codewords)
        s = s.sum(2) if kvgroup else s.reshape(b, hq, chunk, nk)
        idx, vld = bucket_select(s, mask[None, None], l, max_s, l_dyn=l_dyn)
        if kvgroup:                              # broadcast to query heads
            idx = idx.repeat_interleave(r, dim=1)
            vld = vld.repeat_interleave(r, dim=1)
        return attention_from_indices(q[:, :, start:start + chunk], k, v,
                                      idx, vld, scale)

    # Under autograd each chunk is checkpointed: its (chunk, L, d) gathers
    # are recomputed in backward instead of kept for all chunks, so O(n L d)
    # stays live chunk-wise (JAX: jax.checkpoint(chunk_fn)).
    remat = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    outs = [checkpoint(chunk_fn, start, n, q, k, v, use_reentrant=False,
                       preserve_rng_state=False) if remat
            else chunk_fn(start, n, q, k, v)
            for start, n in _chunks(nq, cfg.chunk_q)]
    aux: Dict[str, object] = {"l": l}
    if cfg.qerr_loss_weight > 0:
        aux["qerr"] = (pq.quantization_error(q, codebooks, codes_q)
                       + pq.quantization_error(k, codebooks, codes_k))
    return torch.cat(outs, dim=2), aux


def sparse_mha_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      codebooks: torch.Tensor, cfg: SparseAttentionConfig,
                      scale: float, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0
                      ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """The top-L set applied as a mask on dense per-chunk logits (no (n,
    L) index matrix, no gathered K/V): the fused kernel's compute graph,
    with sparse_mha's selection.  Selection is per query head, as in JAX's
    masked form, whatever ``select_granularity`` says."""
    b, hq, nq, d = q.shape
    _, hk, nk, _ = k.shape
    r = hq // hk
    l = top_l(nk, cfg, window)
    codes_q = pq.assign(q, codebooks)
    codes_k = pq.assign(k, codebooks)
    ckq = codes_k.repeat_interleave(r, dim=1)               # (B, Hq, nk, M)
    k_pos = torch.arange(nk, dtype=torch.int32, device=q.device)

    def chunk_fn(start, chunk, q, k, v):
        q_pos = q_offset + start + torch.arange(chunk, dtype=torch.int32,
                                                device=q.device)
        mask = attention_mask(q_pos, k_pos, causal, window)
        s = pq.match_scores(codes_q[:, :, start:start + chunk], ckq,
                            cfg.pq.num_codewords)
        eligible = _eligibility(s, mask[None, None], l, cfg.pq.num_books)
        k_rep = k.repeat_interleave(r, dim=1)
        v_rep = v.repeat_interleave(r, dim=1)
        logits = torch.einsum("bhnd,bhmd->bhnm",
                              q[:, :, start:start + chunk].float(),
                              k_rep.float())
        w = _masked_softmax(logits * scale, eligible)
        return torch.einsum("bhnm,bhmd->bhnd", w.to(v.dtype), v_rep)

    remat = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    outs = [checkpoint(chunk_fn, start, n, q, k, v, use_reentrant=False,
                       preserve_rng_state=False) if remat
            else chunk_fn(start, n, q, k, v)
            for start, n in _chunks(nq, cfg.chunk_q)]
    aux: Dict[str, object] = {"l": l}
    if cfg.qerr_loss_weight > 0:
        aux["qerr"] = (pq.quantization_error(q, codebooks, codes_q)
                       + pq.quantization_error(k, codebooks, codes_k))
    return torch.cat(outs, dim=2), aux


def _decode_attention_from_indices(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, indices: torch.Tensor,
                                   valid: torch.Tensor, scale: float
                                   ) -> torch.Tensor:
    """Single-token gather attention grouped by kv head.  q: (B, Hq, 1,
    d); k, v: (B, Hk, S, d); indices/valid: (B, Hsel, 1, L) with Hsel = Hk
    ("kvgroup") or Hq ("qhead")."""
    b, hq, _, d = q.shape
    _, hk, s, _ = k.shape
    r = hq // hk
    l = indices.shape[-1]
    rsel = indices.shape[1] // hk
    rows = _kv_rows(b, hk, hk, q.device)[:, :, None] * s
    flat = (rows + indices.reshape(b, hk, rsel * l).long()).reshape(-1)
    k_sel = k.reshape(b * hk * s, d).index_select(0, flat)
    v_sel = v.reshape(b * hk * s, d).index_select(0, flat)
    k_sel = k_sel.reshape(b, hk, rsel, l, d)
    v_sel = v_sel.reshape(b, hk, rsel, l, d)
    qg = q.reshape(b, hk, r, d).float()
    vld = valid.reshape(b, hk, rsel, l)
    if rsel == 1:                        # selection shared by the R heads
        k_sel, v_sel = k_sel[:, :, 0], v_sel[:, :, 0]
        logits = torch.einsum("bgrd,bgld->bgrl", qg, k_sel.float())
    else:
        logits = torch.einsum("bgrd,bgrld->bgrl", qg, k_sel.float())
    w = _masked_softmax(logits * scale, vld).to(v.dtype)
    eq = "bgrl,bgld->bgrd" if rsel == 1 else "bgrl,bgrld->bgrd"
    return torch.einsum(eq, w, v_sel).reshape(b, hq, 1, d)


def sparse_mha_decode(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, codes_cache: torch.Tensor,
                      codebooks: torch.Tensor, cfg: SparseAttentionConfig,
                      scale: float, kv_valid: torch.Tensor) -> torch.Tensor:
    """One-token decode over the cached keys' codes (the kernel's oracle).

    q: (B, Hq, 1, d); caches: (B, Hk, S, d); codes_cache: (B, Hk, S, M);
    kv_valid: (B, S) bool.  GQA broadcasting is by reshape only."""
    b, hq, _, d = q.shape
    _, hk, s, _ = k_cache.shape
    r = hq // hk
    l = top_l(s, cfg, None)
    codes_q = pq.assign(q, codebooks)                       # (B, Hq, 1, M)
    cq = codes_q.reshape(b, hk, r, 1, -1)
    scores = pq.match_scores(cq, codes_cache[:, :, None],
                             cfg.pq.num_codewords)          # (B,Hk,R,1,S)
    kvgroup = cfg.select_granularity == "kvgroup"
    scores = scores.sum(2) if kvgroup else scores.reshape(b, hq, 1, s)
    max_s = cfg.pq.num_books * (r if kvgroup else 1)
    idx, vld = bucket_select(scores, kv_valid[:, None, None, :], l, max_s)
    return _decode_attention_from_indices(q, k_cache, v_cache, idx, vld,
                                          scale)


def sparse_mha_decode_masked(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, codes_cache: torch.Tensor,
                             codebooks: torch.Tensor,
                             cfg: SparseAttentionConfig, scale: float,
                             kv_valid: torch.Tensor) -> torch.Tensor:
    """``sparse_mha_decode`` with the top-L set applied as a mask on the
    grouped dense logits: no index row, no gathered K/V (the decode
    kernels' compute graph).  Same selection, same shapes."""
    b, hq, _, d = q.shape
    _, hk, s, _ = k_cache.shape
    r = hq // hk
    l = top_l(s, cfg, None)
    codes_q = pq.assign(q, codebooks)
    cq = codes_q.reshape(b, hk, r, 1, -1)
    scores = pq.match_scores(cq, codes_cache[:, :, None],
                             cfg.pq.num_codewords)          # (B,Hk,R,1,S)
    valid = kv_valid[:, None, None, None, :]
    if cfg.select_granularity == "kvgroup":
        eligible = _eligibility(scores.sum(2, keepdim=True), valid, l,
                                cfg.pq.num_books * r)
    else:
        eligible = _eligibility(scores, valid, l, cfg.pq.num_books)
    logits = torch.einsum("bgrnd,bgsd->bgrns",
                          q.reshape(b, hk, r, 1, d).float(), k_cache.float())
    w = _masked_softmax(logits * scale, eligible)
    out = torch.einsum("bgrns,bgsd->bgrnd", w.to(v_cache.dtype), v_cache)
    return out.reshape(b, hq, 1, d)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    kv_valid: Optional[torch.Tensor] = None,
                    chunk_q: int = 512) -> torch.Tensor:
    """Dense (Full/LoRA baseline) attention, query-chunked, GQA-aware.
    kv_valid: optional (B, nk) bool for decode-style masking."""
    b, hq, nq, d = q.shape
    _, hk, nk, _ = k.shape
    r = hq // hk
    qf = q.reshape(b, hk, r, nq, d)
    k_pos = torch.arange(nk, dtype=torch.int32, device=q.device)
    outs = []
    for start, chunk in _chunks(nq, chunk_q):
        q_pos = q_offset + start + torch.arange(chunk, dtype=torch.int32,
                                                device=q.device)
        mask = attention_mask(q_pos, k_pos, causal, window)
        if kv_valid is not None:
            mask = (mask[None] & kv_valid[:, None, :])[:, None, None]
        logits = torch.einsum("bgrnd,bgmd->bgrnm",
                              qf[:, :, :, start:start + chunk].float(),
                              k.float()) * scale
        logits = torch.where(mask, logits, float("-inf"))
        w = torch.softmax(logits, dim=-1)
        w = torch.where(torch.isfinite(logits).any(-1, keepdim=True), w, 0.0)
        outs.append(torch.einsum("bgrnm,bgmd->bgrnd", w.to(v.dtype), v))
    return torch.cat(outs, dim=3).reshape(b, hq, nq, d)


def _index_sets(idx: torch.Tensor, ok: torch.Tensor, nk: int
                ) -> torch.Tensor:
    """(..., nk) f32 membership of the top-k index rows whose entry is ok."""
    out = torch.zeros((*idx.shape[:-1], nk), dtype=torch.float32,
                      device=idx.device)
    return out.scatter_(-1, idx, ok.expand(idx.shape).float())


def selection_recall(q: torch.Tensor, k: torch.Tensor,
                     codebooks: torch.Tensor, cfg: SparseAttentionConfig,
                     causal: bool = True,
                     window: Optional[int] = None) -> torch.Tensor:
    """Diagnostic (paper §4.1 reports ~90%): the fraction of the true
    top-L q.k pairs that PQ selection recovers, as a 0-d f32 tensor.
    O(n^2): small shapes only."""
    b, hq, nq, d = q.shape
    _, hk, nk, _ = k.shape
    r = hq // hk
    l = top_l(nk, cfg, window)
    q_pos = torch.arange(nq, dtype=torch.int32, device=q.device)
    k_pos = torch.arange(nk, dtype=torch.int32, device=q.device)
    mask = attention_mask(q_pos, k_pos, causal, window)
    k_rep = k.repeat_interleave(r, dim=1)                 # (B, Hq, nk, d)
    exact = torch.einsum("bhnd,bhmd->bhnm", q.float(), k_rep.float())
    exact = torch.where(mask, exact, float("-inf"))
    true_top, true_idx = _top_k(exact, l)
    codes_q = pq.assign(q, codebooks)
    codes_k = pq.assign(k, codebooks)
    s = pq.match_scores(codes_q.reshape(b, hk, r, nq, -1),
                        codes_k[:, :, None], cfg.pq.num_codewords)
    s = s.reshape(b, hq, nq, nk)
    sel_top, sel_idx = _top_k(_combined_score(s, k_pos, mask, nk), l)
    true_sets = _index_sets(true_idx, torch.isfinite(true_top), nk)
    sel_sets = _index_sets(sel_idx, sel_top >= 0.0, nk)
    inter = (true_sets * sel_sets).sum(-1)
    denom = torch.clamp(mask.sum(-1), max=l).float().expand(inter.shape)
    return torch.where(denom > 0, inter / torch.clamp(denom, min=1.0),
                       1.0).mean()
