"""Plain torch versions of the sparse attention kernels' functions.

``sparse_attention_ref`` is the train/prefill kernel's function
(csrc/sparse_attention.cu): given [t, need] per query row, attention over
the keys the causal / window mask admits with score > t plus the ``need``
newest keys with score == t.  ``fused_decode_ref`` is the decode kernel's
(csrc/sparse_decode.cu): the [t, need] of every row from a histogram of
its whole valid code row, then the same selection.  Both take the softmax
in f32 and give 0 for a row with nothing selected.  The CPU tests hold
them to the JAX kernels; ``chip_smoke.py`` holds the CUDA kernels to them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.topl_select.ref import (hist_reduce, kv_groups,
                                                 masked_scores)


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
            eligible: torch.Tensor, scale: float) -> torch.Tensor:
    """Softmax attention restricted to ``eligible`` (..., nq, nk), in f32;
    a row with nothing eligible gives 0.  Returns q's dtype."""
    logits = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    logits = torch.where(eligible, logits, float("-inf"))
    w = torch.where(eligible, torch.softmax(logits, dim=-1), 0.0)
    return torch.einsum("...qk,...kd->...qd", w, v.float()).to(q.dtype)


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
    """The kernel's selection: (eligible (G, R_out, S) bool, thresholds
    (G, R_out, 2) int32).  R_out = 1 for the shared "kvgroup" selection."""
    g, s = codes_k.shape[:2]
    valid = kv_valid.bool().repeat_interleave(heads_per_batch, dim=0)
    scores = (codes_q.long()[:, :, None, :]
              == codes_k.long()[:, None, :, :]).sum(-1)      # (G, R, S)
    if sum_rows:
        scores = scores.sum(1, keepdim=True)                 # (G, 1, S)
    sm = torch.where(valid[:, None, :], scores, -1)
    r_out = sm.shape[1]
    flat = sm.reshape(g * r_out, s)
    hist = torch.stack([(flat == b).sum(-1) for b in range(max_score + 1)],
                       dim=-1)
    thr = hist_reduce(hist, l).reshape(g, r_out, 2)
    return newest_ties(sm, thr), thr


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
