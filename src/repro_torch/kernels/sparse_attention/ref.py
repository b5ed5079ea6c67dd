"""Plain torch versions of the sparse attention kernels' functions.

``sparse_attention_ref`` is the train/prefill kernel's function
(csrc/sparse_attention.cu): given [t, need] per query row, attention over
the keys the causal / window mask admits with score > t plus the ``need``
newest keys with score == t.  The decode kernels' functions:
``fused_decode_ref`` (csrc/sparse_decode.cu, kernel 6): the [t, need] of
every row from a histogram of its whole valid code row, then the same
selection; ``sparse_decode_attention_ref`` (the two-pass attention half,
kernel 5): the same selection from given [t, need], with each row's
log-sum-exp where asked; the paged forms read
the pools through a page table (``fused_decode_paged_ref``, kernel 7;
``dense_decode_paged_ref``, kernel 8: every valid slot).  All take the
softmax in f32 and give 0 for a row with nothing selected.  The CPU tests
hold them to the JAX kernels; ``chip_smoke.py`` holds the CUDA kernels to
them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.topl_select.ref import (decode_scores,
                                                 decode_topl_thresholds_ref,
                                                 kv_groups, masked_scores)
from repro_torch.serving.kv_pages import gather_pages


def newest_ties(sm: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """The selection as a mask: score > t, or score == t with fewer than
    ``need`` ties at newer (higher) key positions.  sm: (..., nk) masked
    scores (-1 = dropped); thr: (..., 2) [t, need]."""
    t = thr[..., 0:1].long()
    need = thr[..., 1:2].long()
    at_t = sm == t
    newer_ties = at_t.long().flip(-1).cumsum(-1).flip(-1) - at_t.long()
    return (sm > t) | (at_t & (newer_ties < need))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            eligible: torch.Tensor, scale: float, lse: bool = False):
    """Softmax attention restricted to ``eligible`` (..., nq, nk), in f32;
    a row with nothing eligible gives 0.  Returns q's dtype, and with
    ``lse`` also each row's f32 log-sum-exp of its eligible logits
    (-inf where none is)."""
    logits = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    logits = torch.where(eligible, logits, float("-inf"))
    w = torch.where(eligible, torch.softmax(logits, dim=-1), 0.0)
    out = torch.einsum("...qk,...kd->...qd", w, v.float()).to(q.dtype)
    return (out, torch.logsumexp(logits, dim=-1)) if lse else out


def sparse_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         codes_q: torch.Tensor, codes_k: torch.Tensor,
                         thresholds: torch.Tensor, *, scale: float,
                         causal: bool = True, window: Optional[int] = None,
                         q_offset: int = 0, heads_per_batch: int = 1,
                         rep: int = 1) -> torch.Tensor:
    """q: (G, nq, dh); k, v: (G / rep, nk, dh); codes_q: (G, nq, M);
    codes_k: (G / rep, nk, M); thresholds: (G, nq, 2) int32.  Returns
    (G, nq, dh) in q's dtype."""
    sm = masked_scores(codes_q, codes_k, causal=causal, window=window,
                       q_offset=q_offset, heads_per_batch=heads_per_batch,
                       rep=rep)
    kv = kv_groups(q.shape[0], heads_per_batch, rep, q.device)
    return _attend(q, k[kv], v[kv], newest_ties(sm, thresholds), scale)


def select(codes_q: torch.Tensor, codes_k: torch.Tensor,
           kv_valid: torch.Tensor, *, l: int, max_score: int,
           sum_rows: bool, heads_per_batch: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode kernels' selection: (eligible (G, R_out, S) bool,
    thresholds (G, R_out, 2) int32).  R_out = 1 for the shared "kvgroup"
    selection."""
    kw = dict(sum_rows=sum_rows, heads_per_batch=heads_per_batch)
    thr = decode_topl_thresholds_ref(codes_q, codes_k, kv_valid, l=l,
                                     max_score=max_score, **kw)
    return newest_ties(decode_scores(codes_q, codes_k, kv_valid, **kw),
                       thr), thr


def fused_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     codes_q: torch.Tensor, codes_k: torch.Tensor,
                     kv_valid: torch.Tensor, *, scale: float, l: int,
                     max_score: int, sum_rows: bool, heads_per_batch: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (G, R, dh); k, v: (G, S, dh); codes_q: (G, R, M) int;
    codes_k: (G, S, M) int; kv_valid: (B, S) bool with G = B * Hk.
    Returns (out (G, R, dh) in q's dtype, thresholds (G, R_out, 2) int32)."""
    eligible, thr = select(codes_q, codes_k, kv_valid, l=l,
                           max_score=max_score, sum_rows=sum_rows,
                           heads_per_batch=heads_per_batch)
    return _attend(q, k, v, eligible, scale), thr


def sparse_decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, codes_q: torch.Tensor,
                                codes_k: torch.Tensor,
                                thresholds: torch.Tensor,
                                kv_valid: torch.Tensor, *, scale: float,
                                sum_rows: bool, heads_per_batch: int,
                                return_lse: bool = False):
    """The two-pass attention half: shapes as ``fused_decode_ref`` plus
    thresholds (G, R_out, 2) [t, need].  Returns (G, R, dh), and with
    ``return_lse`` also each row's log-sum-exp (G, R) f32."""
    sm = decode_scores(codes_q, codes_k, kv_valid, sum_rows=sum_rows,
                       heads_per_batch=heads_per_batch)
    return _attend(q, k, v, newest_ties(sm, thresholds), scale,
                   lse=return_lse)


def _views(page_table: torch.Tensor, *pools):
    """(G, MP*ps, X) per-group views of (P, Hk, ps, X) pools."""
    out = []
    for pool in pools:
        view = gather_pages(pool, page_table)             # (B, Hk, S, X)
        out.append(view.reshape(-1, *view.shape[2:]))
    return out


def fused_decode_paged_ref(page_table: torch.Tensor, q: torch.Tensor,
                           k_pool: torch.Tensor, v_pool: torch.Tensor,
                           codes_q: torch.Tensor, codes_pool: torch.Tensor,
                           kv_valid: torch.Tensor, *, scale: float, l: int,
                           max_score: int, sum_rows: bool,
                           heads_per_batch: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_decode_ref`` read through a page table: page_table (B, MP)
    (-1 reads page 0, whose rows kv_valid must leave out); q, codes_q
    (G, R, .) with G = B * Hk; pools (P, Hk, ps, .); kv_valid
    (B, MP*ps).  Returns (out (G, R, dh), thresholds (G, R_out, 2))."""
    k, v, ck = _views(page_table, k_pool, v_pool, codes_pool)
    return fused_decode_ref(q, k, v, codes_q, ck, kv_valid, scale=scale,
                            l=l, max_score=max_score, sum_rows=sum_rows,
                            heads_per_batch=heads_per_batch)


def dense_decode_paged_ref(page_table: torch.Tensor, q: torch.Tensor,
                           k_pool: torch.Tensor, v_pool: torch.Tensor,
                           kv_valid: torch.Tensor, *, scale: float,
                           heads_per_batch: int) -> torch.Tensor:
    """Dense decode attention over every valid slot of the paged view:
    shapes as ``fused_decode_paged_ref``.  Returns (G, R, dh)."""
    k, v = _views(page_table, k_pool, v_pool)
    valid = kv_valid.bool().repeat_interleave(heads_per_batch, dim=0)
    return _attend(q, k, v, valid[:, None, :], scale)
