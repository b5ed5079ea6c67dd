"""Plain torch version of the top-L threshold kernel's function, and the
histogram reduction every selection shares.

``thresholds_ref`` has the inputs and outputs of the train/prefill CUDA
kernel (csrc/topl_thresholds.cu): the per-query histogram of PQ match
scores under the causal / window mask, reduced by ``hist_reduce`` to
[t, need].  ``decode_topl_thresholds_ref`` is the decode kernel's
(csrc/sparse_decode_two_pass.cu): one histogram per decode row over its
valid cached code row (``decode_score_hist``, which the kernel also
writes out for a cache whose sequence splits over ranks).  The CPU tests hold both to the JAX kernels;
``chip_smoke.py`` holds the CUDA kernels to them, exactly.
"""
from __future__ import annotations

from typing import Optional

import torch


def hist_reduce(hist: torch.Tensor, l: int) -> torch.Tensor:
    """(..., max_score + 1) bucket counts -> (..., 2) int32 [t, need]: t is
    the highest bucket where the count of scores >= t reaches l (0 if none
    does), need = l - #(score > t)."""
    ge = hist.flip(-1).cumsum(-1).flip(-1)
    t = torch.clamp((ge >= l).sum(-1) - 1, min=0)
    ge_pad = torch.cat([ge, torch.zeros_like(ge[..., :1])], dim=-1)
    n_above = ge_pad.gather(-1, (t + 1)[..., None])[..., 0]
    return torch.stack([t, l - n_above], dim=-1).to(torch.int32)


def kv_groups(g: int, heads_per_batch: int, rep: int, device) -> torch.Tensor:
    """(G,) kv group of each query group g = b * Hq + h: b * Hk + h // R."""
    gi = torch.arange(g, device=device)
    return (gi // heads_per_batch) * (heads_per_batch // rep) \
        + (gi % heads_per_batch) // rep


def masked_scores(codes_q: torch.Tensor, codes_k: torch.Tensor, *,
                  causal: bool, window: Optional[int], q_offset: int,
                  heads_per_batch: int, rep: int) -> torch.Tensor:
    """(G, nq, nk) int64 match counts of each query row against its kv
    group's keys, -1 where the causal / window mask drops the pair."""
    g, nq, _ = codes_q.shape
    nk = codes_k.shape[1]
    ck = codes_k[kv_groups(g, heads_per_batch, rep, codes_q.device)]
    s = (codes_q[:, :, None, :] == ck[:, None, :, :]).sum(-1)
    q_pos = q_offset + torch.arange(nq, device=codes_q.device)[:, None]
    k_pos = torch.arange(nk, device=codes_q.device)[None, :]
    valid = torch.ones((nq, nk), dtype=torch.bool, device=codes_q.device)
    if causal:
        valid &= k_pos <= q_pos
    if window is not None:
        valid &= k_pos > q_pos - window
    return torch.where(valid, s, -1)


def thresholds_ref(codes_q: torch.Tensor, codes_k: torch.Tensor, *, l: int,
                   max_score: int, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0,
                   heads_per_batch: int = 1, rep: int = 1) -> torch.Tensor:
    """codes_q: (G, nq, M); codes_k: (G / R, nk, M) int, G = B * Hq with R
    query heads per kv head -> (G, nq, 2) int32 [t, need]."""
    sm = masked_scores(codes_q, codes_k, causal=causal, window=window,
                       q_offset=q_offset, heads_per_batch=heads_per_batch,
                       rep=rep)
    hist = torch.stack([(sm == b).sum(-1) for b in range(max_score + 1)],
                       dim=-1)
    return hist_reduce(hist, l)


def decode_scores(codes_q: torch.Tensor, codes_k: torch.Tensor,
                  kv_valid: torch.Tensor, *, sum_rows: bool,
                  heads_per_batch: int) -> torch.Tensor:
    """(G, R_out, S) int64 match counts of each decode row (codes_q
    (G, R, M)) against its kv group's cached codes (codes_k (G, S, M)),
    -1 at slots kv_valid (B, S), G = B * heads_per_batch, leaves out.
    sum_rows ("kvgroup"): the R rows' counts summed, R_out = 1."""
    valid = kv_valid.bool().repeat_interleave(heads_per_batch, dim=0)
    scores = (codes_q.long()[:, :, None, :]
              == codes_k.long()[:, None, :, :]).sum(-1)      # (G, R, S)
    if sum_rows:
        scores = scores.sum(1, keepdim=True)                 # (G, 1, S)
    return torch.where(valid[:, None, :], scores, -1)


def decode_score_hist(codes_q: torch.Tensor, codes_k: torch.Tensor,
                      kv_valid: torch.Tensor, *, max_score: int,
                      sum_rows: bool, heads_per_batch: int) -> torch.Tensor:
    """(G, R_out, max_score + 1) int32: each decode row's histogram of its
    valid scores (``decode_scores``)."""
    sm = decode_scores(codes_q, codes_k, kv_valid, sum_rows=sum_rows,
                       heads_per_batch=heads_per_batch)
    return torch.stack([(sm == b).sum(-1) for b in range(max_score + 1)],
                       dim=-1).to(torch.int32)


def decode_topl_thresholds_ref(codes_q: torch.Tensor, codes_k: torch.Tensor,
                               kv_valid: torch.Tensor, *, l: int,
                               max_score: int, sum_rows: bool,
                               heads_per_batch: int) -> torch.Tensor:
    """codes_q (G, R, M), codes_k (G, S, M) int, kv_valid (B, S) ->
    (G, R_out, 2) int32 [t, need] of each row's valid score histogram."""
    return hist_reduce(decode_score_hist(
        codes_q, codes_k, kv_valid, max_score=max_score, sum_rows=sum_rows,
        heads_per_batch=heads_per_batch), l)
