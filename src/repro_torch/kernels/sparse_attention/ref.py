"""Plain torch version of the fused sparse decode kernel's function.

Same inputs and outputs as the CUDA kernel (csrc/sparse_decode.cu): the
[t, need] threshold of every row from a histogram of its whole valid code
row (the integer math of topl_select.hist_reduce), then attention over the
keys with score > t plus the ``need`` newest keys with score == t, softmax
in f32, and 0 for a row with nothing selected.  The CPU tests hold it to
the JAX kernel; ``chip_smoke.py`` holds the CUDA kernel to it.
"""
from __future__ import annotations

from typing import Tuple

import torch


def hist_reduce(hist: torch.Tensor, l: int) -> torch.Tensor:
    """(R_out, max_score + 1) bucket counts -> (R_out, 2) int32 [t, need]:
    t is the highest bucket where the count of scores >= t reaches l (0 if
    none does), need = l - #(score > t)."""
    ge = hist.flip(-1).cumsum(-1).flip(-1)
    t = torch.clamp((ge >= l).sum(-1) - 1, min=0)
    ge_pad = torch.cat([ge, torch.zeros_like(ge[:, :1])], dim=-1)
    n_above = ge_pad.gather(-1, (t + 1)[:, None])[:, 0]
    return torch.stack([t, l - n_above], dim=-1).to(torch.int32)


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
    t = thr[..., 0:1].long()
    need = thr[..., 1:2].long()
    at_t = sm == t
    newer_ties = at_t.long().flip(-1).cumsum(-1).flip(-1) - at_t.long()
    return (sm > t) | (at_t & (newer_ties < need)), thr


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
    logits = torch.einsum("grd,gsd->grs", q.float(), k.float()) * scale
    logits = torch.where(eligible, logits, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    w = torch.where(eligible, w, 0.0)                        # none -> 0
    out = torch.einsum("grs,gsd->grd", w, v.float())
    return out.to(q.dtype), thr
