"""Public top-L threshold ops: [t, need] per query row (paper Algorithm
3, bucket form) for the train/prefill sparse attention
(``topl_thresholds``) and for the two-pass decode (``decode_topl_
thresholds``).  No indices are ever emitted: the attention kernels
consume the thresholds."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import cost
from repro_torch.kernels.topl_select.ref import (decode_score_hist,
                                                 hist_reduce, thresholds_ref)

BOOKS_MAX = 32          # PQ books the threshold kernel takes
SCORE_MAX = 32          # largest max_score (histogram buckets - 1)


def check_topl_args(codes_q: torch.Tensor, codes_k: torch.Tensor, *,
                    l: int, max_score: int, q_offset: int,
                    heads_per_batch: int, rep: int) -> None:
    """Kernel 2's input contract, checked before anything is built or
    launched: the shapes ``topl_thresholds`` names, int32 codes, 1 to
    BOOKS_MAX books, M <= max_score <= SCORE_MAX (the kernel's histogram
    rows), nq, nk, l >= 1 and q_offset >= 0."""
    name = "topl_thresholds"
    g, nq, m = codes_q.shape
    gk, nk, mk = codes_k.shape
    if (mk != m or g % heads_per_batch or heads_per_batch % rep
            or gk * rep != g):
        raise ValueError(f"{name}: codes {tuple(codes_q.shape)} vs "
                         f"{tuple(codes_k.shape)} with {heads_per_batch} "
                         f"heads per batch, {rep} per kv head")
    if codes_q.dtype != torch.int32 or codes_k.dtype != torch.int32:
        raise TypeError(f"{name}: takes int32 codes")
    if not (1 <= m <= BOOKS_MAX and m <= max_score <= SCORE_MAX):
        raise ValueError(f"{name}: takes 1 to {BOOKS_MAX} books and M <= "
                         f"max_score <= {SCORE_MAX}, got M = {m}, "
                         f"max_score = {max_score}")
    if nq < 1 or nk < 1 or l < 1 or q_offset < 0:
        raise ValueError(f"{name}: needs nq, nk, l >= 1 and q_offset >= 0")


@cost.counted("topl_thresholds")
def topl_thresholds(codes_q: torch.Tensor, codes_k: torch.Tensor, *, l: int,
                    max_score: int, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    heads_per_batch: int = 1, rep: int = 1) -> torch.Tensor:
    """codes_q: (G, nq, M) int32, G = B * heads_per_batch query groups;
    codes_k: (G / rep, nk, M) int32 (query head h of batch b reads kv
    group b * Hk + h // rep); codes may be any int32 values.  Returns
    (G, nq, 2) int32 [t, need].  CPU tensors take the plain version; CUDA
    tensors launch the kernel (csrc/topl_thresholds.cu); meta tensors get
    the output's shape."""
    kw = dict(l=l, max_score=max_score, causal=causal, window=window,
              q_offset=q_offset, heads_per_batch=heads_per_batch, rep=rep)
    if kernels.target(codes_q) == "cpu":
        return thresholds_ref(codes_q, codes_k, **kw).contiguous()
    name = "topl_thresholds"
    kernels.require_cuda(name, codes_q, codes_k)
    check_topl_args(codes_q, codes_k, l=l, max_score=max_score,
                    q_offset=q_offset, heads_per_batch=heads_per_batch,
                    rep=rep)
    g, nq, m = codes_q.shape
    nk = codes_k.shape[1]
    thr = torch.empty((g, nq, 2), dtype=torch.int32, device=codes_q.device)
    if codes_q.is_meta:
        return thr
    err = kernels.library().repro_topl_thresholds(
        codes_q.data_ptr(), codes_k.data_ptr(), thr.data_ptr(), g, nq, nk, m,
        heads_per_batch, rep, l, max_score, int(causal),
        0 if window is None else window, q_offset, kernels.stream_ptr())
    kernels.check(err, name)
    topl_thresholds.launches += 1
    return thr


topl_thresholds.launches = 0


@cost.counted("decode_topl_thresholds")
def decode_topl_thresholds(codes_q: torch.Tensor, codes_k: torch.Tensor,
                           kv_valid: torch.Tensor, *, l: int,
                           max_score: int, sum_rows: bool,
                           heads_per_batch: int, return_hist: bool = False):
    """The two-pass decode's first half: codes_q (G, R, M) int32 (the R
    query heads of each kv group, G = B * heads_per_batch); codes_k
    (G, S, M) int8 cached codes; kv_valid (B, S) bool.  Returns
    (G, R_out, 2) int32 [t, need] (R_out = 1 when ``sum_rows``, the
    "kvgroup" selection), and with ``return_hist`` also each row's score
    histogram (G, R_out, max_score + 1) int32, summed over the splits (a
    cache whose sequence splits over ranks adds the ranks' up).  CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (csrc/sparse_decode_two_pass.cu): one launch, whose last block per kv
    group reduces the splits; meta tensors get the outputs' shapes."""
    if kernels.target(codes_q) == "cpu":
        hist = decode_score_hist(codes_q, codes_k, kv_valid,
                                 max_score=max_score, sum_rows=sum_rows,
                                 heads_per_batch=heads_per_batch)
        thr = hist_reduce(hist, l).contiguous()
        return (thr, hist.contiguous()) if return_hist else thr
    name = "decode_topl_thresholds"
    kernels.require_cuda(name, codes_q, codes_k, kv_valid)
    g, r, m = codes_q.shape
    s = codes_k.shape[1]
    if (codes_k.shape != (g, s, m)
            or kv_valid.shape != (g // heads_per_batch, s)):
        raise ValueError(f"{name}: inconsistent shapes")
    if not (codes_q.dtype == torch.int32 and codes_k.dtype == torch.int8
            and kv_valid.dtype == torch.bool):
        raise TypeError(f"{name}: takes int32 query codes, int8 cached "
                        "codes and a bool mask")
    r_out = 1 if sum_rows else r
    kernels.check_decode_args(name, r, m=m, buckets=r_out * (max_score + 1))
    ns, sp = kernels.decode_splits(g, s)
    dev = codes_q.device
    thr = torch.empty((g, r_out, 2), dtype=torch.int32, device=dev)
    hist = torch.empty((g, ns, r_out, max_score + 1), dtype=torch.int32,
                       device=dev)
    hsum = (torch.empty((g, r_out, max_score + 1), dtype=torch.int32,
                        device=dev) if return_hist else None)
    out = (thr, hsum) if return_hist else thr
    if codes_q.is_meta:
        return out
    arrive = kernels.arrival_counters(g, dev)
    err = kernels.library().repro_decode_thresholds(
        codes_q.data_ptr(), codes_k.data_ptr(), kv_valid.data_ptr(),
        thr.data_ptr(), hist.data_ptr(),
        None if hsum is None else hsum.data_ptr(), arrive.data_ptr(), g, s,
        r, m, heads_per_batch, l, max_score, int(sum_rows), ns, sp,
        kernels.stream_ptr())
    kernels.check(err, name)
    decode_topl_thresholds.launches += 1
    return out


decode_topl_thresholds.launches = 0
