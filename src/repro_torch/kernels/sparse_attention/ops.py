"""Public fused sparse-MHA ops: CUDA forwards, reference backward.

Train/prefill (``sparse_mha``): the PQ assignment kernel for q and k, the
top-L threshold kernel, then ``sparse_attention`` (the thresholded
attention kernel), in a ``torch.autograd.Function`` whose backward
differentiates the reference ``core.sparse_attention.sparse_mha``.  The
reference selects the same top-L set (same integer thresholds and tie
rule), so the gradient is that of the fused forward up to float
summation order — the contract of the JAX custom_vjp it mirrors.

Serving decode, inference-only.  The one-token query codes are assigned
in plain torch (O(B*Hq*M*E), as the JAX op does); all O(S) work — code
matching, the threshold histogram and the attention sweep — runs in CUDA
kernels with the R query heads of a kv head in one block per split of the
cache (the same splits in every decode kernel, ``kernels.decode_
splits``):
  * ``sparse_mha_decode`` on the contiguous cache: the one-pass
    ``fused_sparse_decode_attention`` (kernel 6), or with ``fuse=False``
    the two-pass tier, ``decode_topl_thresholds`` (kernel 3) then
    ``sparse_decode_attention`` (kernel 5), with identical output;
  * ``sparse_mha_decode_paged`` on the page pools through the page table:
    ``fused_sparse_decode_attention_paged`` (kernel 7), identical to
    kernel 6 over gathered views; the top-L budget is taken over the view
    length MP * page_size, as in JAX;
  * ``dense_mha_decode_paged``: ``dense_decode_attention_paged``
    (kernel 8), the dense baseline on the page pools.
L comes from the unpadded cache (or view) length; the kernels mask their
ragged last tile themselves, so no padding enters the selection.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.core import pq
from repro_torch.core import sparse_attention as sa
from repro_torch.kernels import cost
from repro_torch.kernels.pq_quantize.ops import pq_assign
from repro_torch.kernels.sparse_attention.ref import (
    dense_decode_paged_ref, fused_decode_paged_ref, fused_decode_ref,
    sparse_attention_ref, sparse_decode_attention_ref)
from repro_torch.kernels.topl_select.ops import (decode_topl_thresholds,
                                                 topl_thresholds)


def _check_decode(name, q, k, v, codes_q, codes_k, kv_valid, s,
                  heads_per_batch, buckets=0):
    """The decode kernels' input contract: q (G, R, dh); k, v with dh
    wide rows; codes_q (G, R, M) int32; codes_k int8 with M wide rows;
    kv_valid (G / heads_per_batch, s) bool; R, dh, M and the histogram
    buckets within ``kernels.check_decode_args``."""
    g, r, dh = q.shape
    m = codes_q.shape[-1]
    kernels.check_decode_args(name, r, dh=dh, m=m, buckets=buckets)
    if (k.shape[-1] != dh or v.shape != k.shape or codes_q.shape[:2] != (g, r)
            or (codes_k is not None and codes_k.shape[-1] != m)
            or kv_valid.shape != (g // heads_per_batch, s)):
        raise ValueError(f"{name}: inconsistent shapes")
    if not (q.dtype == k.dtype == v.dtype and codes_q.dtype == torch.int32
            and (codes_k is None or codes_k.dtype == torch.int8)
            and kv_valid.dtype == torch.bool):
        raise TypeError(f"{name}: takes float q/k/v of one dtype, int32 "
                        "query codes, int8 cached codes and a bool mask")


def _scratch(g, ns, r, dh, dev):
    """The per-split partial softmaxes, (G, ns, R, dh + 2) f32."""
    return torch.empty((g, ns, r, dh + 2), dtype=torch.float32, device=dev)


def _pt_ids(page_table: torch.Tensor, num_pages: int) -> torch.Tensor:
    """Page ids the paged kernels may read: unallocated -1 entries clamp
    to page 0 (their rows carry kv_valid == 0, as in JAX), and nothing
    points past the pool."""
    return page_table.clamp(0, num_pages - 1).to(torch.int32).contiguous()


@cost.counted("fused_sparse_decode_attention")
def fused_sparse_decode_attention(q, k, v, codes_q, codes_k, kv_valid, *,
                                  scale: float, l: int, max_score: int,
                                  sum_rows: bool, heads_per_batch: int,
                                  return_thresholds: bool = False):
    """Kernel 6.  q: (G, R, dh); k, v: (G, S, dh) with G = B *
    heads_per_batch; codes_q: (G, R, M) int32; codes_k: (G, S, M) int8;
    kv_valid: (B, S) bool.  Returns out (G, R, dh) in q's dtype, and with
    ``return_thresholds`` also the (G, R_out, 2) int32 [t, need] the
    selection used.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (csrc/sparse_decode.cu); meta tensors get the
    outputs' shapes."""
    if kernels.target(q) == "cpu":
        out, thr = fused_decode_ref(
            q, k, v, codes_q, codes_k, kv_valid, scale=scale, l=l,
            max_score=max_score, sum_rows=sum_rows,
            heads_per_batch=heads_per_batch)
        out, thr = out.contiguous(), thr.contiguous()
        return (out, thr) if return_thresholds else out
    name = "fused_sparse_decode_attention"
    kernels.require_cuda(name, q, k, v, codes_q, codes_k, kv_valid)
    kernels.require_aligned(name, k, v)
    g, r, dh = q.shape
    s = k.shape[1]
    m = codes_q.shape[-1]
    r_out = 1 if sum_rows else r
    _check_decode(name, q, k, v, codes_q, codes_k, kv_valid, s,
                  heads_per_batch, r_out * (max_score + 1))
    if k.shape != (g, s, dh) or codes_k.shape != (g, s, m):
        raise ValueError(f"{name}: inconsistent shapes")
    ns, sp = kernels.decode_splits(g, s)
    dev = q.device
    out = torch.empty_like(q)
    thr = (torch.empty((g, r_out, 2), dtype=torch.int32, device=dev)
           if return_thresholds else None)
    hist = torch.empty((g, ns, r_out, max_score + 1), dtype=torch.int32,
                       device=dev)
    part = _scratch(g, ns, r, dh, dev)
    if q.is_meta:
        return (out, thr) if return_thresholds else out
    err = kernels.library().repro_fused_sparse_decode(
        kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        codes_q.data_ptr(), codes_k.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), None if thr is None else thr.data_ptr(),
        hist.data_ptr(), part.data_ptr(), g, s, r, dh, m, heads_per_batch, l,
        max_score, int(sum_rows), float(scale), ns, sp,
        kernels.decode_stages(dh, q.element_size()), kernels.stream_ptr())
    kernels.check(err, name)
    fused_sparse_decode_attention.launches += 1
    return (out, thr) if return_thresholds else out


fused_sparse_decode_attention.launches = 0


@cost.counted("sparse_decode_attention")
def sparse_decode_attention(q, k, v, codes_q, codes_k, thresholds,
                            kv_valid, *, scale: float, sum_rows: bool,
                            heads_per_batch: int, return_lse: bool = False):
    """Kernel 5, the two-pass decode's attention half: shapes as
    ``fused_sparse_decode_attention`` plus thresholds (G, R_out, 2) int32
    [t, need] (from ``decode_topl_thresholds``).  Returns (G, R, dh), and
    with ``return_lse`` also each row's log-sum-exp of its selected
    logits (G, R) f32 (-inf where it selects none), by which the parts of
    a sequence split over ranks combine.  CPU tensors take the plain
    version; CUDA tensors launch the kernel
    (csrc/sparse_decode_two_pass.cu); meta tensors get the outputs'
    shapes."""
    kw = dict(scale=scale, sum_rows=sum_rows, heads_per_batch=heads_per_batch)
    if kernels.target(q) == "cpu":
        out = sparse_decode_attention_ref(q, k, v, codes_q, codes_k,
                                          thresholds, kv_valid,
                                          return_lse=return_lse, **kw)
        return ((out[0].contiguous(), out[1].contiguous()) if return_lse
                else out.contiguous())
    name = "sparse_decode_attention"
    kernels.require_cuda(name, q, k, v, codes_q, codes_k, thresholds,
                         kv_valid)
    kernels.require_aligned(name, k, v)
    g, r, dh = q.shape
    s = k.shape[1]
    m = codes_q.shape[-1]
    r_out = 1 if sum_rows else r
    _check_decode(name, q, k, v, codes_q, codes_k, kv_valid, s,
                  heads_per_batch)
    if (k.shape != (g, s, dh) or codes_k.shape != (g, s, m)
            or thresholds.shape != (g, r_out, 2)
            or thresholds.dtype != torch.int32):
        raise ValueError(f"{name}: inconsistent shapes or thresholds")
    ns, sp = kernels.decode_splits(g, s)
    dev = q.device
    out = torch.empty_like(q)
    lse = (torch.empty((g, r), dtype=torch.float32, device=dev)
           if return_lse else None)
    ties = torch.empty((g, ns, r_out), dtype=torch.int32, device=dev)
    part = _scratch(g, ns, r, dh, dev)
    res = (out, lse) if return_lse else out
    if q.is_meta:
        return res
    err = kernels.library().repro_sparse_decode_attention(
        kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        codes_q.data_ptr(), codes_k.data_ptr(), thresholds.data_ptr(),
        kv_valid.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), ties.data_ptr(),
        part.data_ptr(), g, s, r, dh, m, heads_per_batch, int(sum_rows),
        float(scale), ns, sp, kernels.decode_stages(dh, q.element_size()),
        kernels.stream_ptr())
    kernels.check(err, name)
    sparse_decode_attention.launches += 1
    return res


sparse_decode_attention.launches = 0


@cost.counted("fused_sparse_decode_attention_paged")
def fused_sparse_decode_attention_paged(page_table, q, k_pool, v_pool,
                                        codes_q, codes_pool, kv_valid, *,
                                        scale: float, l: int,
                                        max_score: int, sum_rows: bool,
                                        heads_per_batch: int,
                                        return_thresholds: bool = False):
    """Kernel 7: kernel 6 read through a page table.  page_table (B, MP)
    int32 (-1 = unallocated, clamped to page 0 here); q (G, R, dh),
    codes_q (G, R, M) int32 with G = B * Hk; k_pool, v_pool (P, Hk, ps,
    dh); codes_pool (P, Hk, ps, M) int8; kv_valid (B, MP*ps) bool in view
    coordinates.  Returns as ``fused_sparse_decode_attention``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (csrc/sparse_decode.cu); meta tensors get the outputs' shapes."""
    kw = dict(scale=scale, l=l, max_score=max_score, sum_rows=sum_rows,
              heads_per_batch=heads_per_batch)
    if kernels.target(q) == "cpu":
        out, thr = fused_decode_paged_ref(page_table, q, k_pool, v_pool,
                                          codes_q, codes_pool, kv_valid, **kw)
        out, thr = out.contiguous(), thr.contiguous()
        return (out, thr) if return_thresholds else out
    name = "fused_sparse_decode_attention_paged"
    kernels.require_cuda(name, q, k_pool, v_pool, codes_q, codes_pool,
                         kv_valid, page_table)
    kernels.require_aligned(name, k_pool, v_pool)
    g, r, dh = q.shape
    npool, hk, ps, _ = k_pool.shape
    b, mp = page_table.shape
    m = codes_q.shape[-1]
    r_out = 1 if sum_rows else r
    _check_decode(name, q, k_pool, v_pool, codes_q, codes_pool, kv_valid,
                  mp * ps, heads_per_batch, r_out * (max_score + 1))
    if (hk != heads_per_batch or g != b * hk
            or codes_pool.shape != (npool, hk, ps, m)):
        raise ValueError(f"{name}: inconsistent shapes")
    ns, sp = kernels.decode_splits(g, mp * ps)
    dev = q.device
    pt = _pt_ids(page_table, npool)
    out = torch.empty_like(q)
    thr = (torch.empty((g, r_out, 2), dtype=torch.int32, device=dev)
           if return_thresholds else None)
    hist = torch.empty((g, ns, r_out, max_score + 1), dtype=torch.int32,
                       device=dev)
    part = _scratch(g, ns, r, dh, dev)
    if q.is_meta:
        return (out, thr) if return_thresholds else out
    err = kernels.library().repro_fused_sparse_decode_paged(
        kernels.dtype_code(q), pt.data_ptr(), q.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), codes_q.data_ptr(),
        codes_pool.data_ptr(), kv_valid.data_ptr(), out.data_ptr(),
        None if thr is None else thr.data_ptr(), hist.data_ptr(),
        part.data_ptr(), g, mp, ps, r, dh, m, hk, l, max_score,
        int(sum_rows), float(scale), ns, sp,
        kernels.decode_stages(dh, q.element_size()), kernels.stream_ptr())
    kernels.check(err, name)
    fused_sparse_decode_attention_paged.launches += 1
    return (out, thr) if return_thresholds else out


fused_sparse_decode_attention_paged.launches = 0


@cost.counted("dense_decode_attention_paged")
def dense_decode_attention_paged(page_table, q, k_pool, v_pool, kv_valid,
                                 *, scale: float,
                                 heads_per_batch: int) -> torch.Tensor:
    """Kernel 8: dense one-token attention over every valid slot of the
    paged view; shapes as ``fused_sparse_decode_attention_paged``.
    Returns (G, R, dh); a row with no valid slot gives 0.  CPU tensors
    take the plain version; CUDA tensors launch the kernel
    (csrc/dense_decode_paged.cu); meta tensors get the output's shape."""
    if kernels.target(q) == "cpu":
        return dense_decode_paged_ref(page_table, q, k_pool, v_pool,
                                      kv_valid, scale=scale,
                                      heads_per_batch=heads_per_batch
                                      ).contiguous()
    name = "dense_decode_attention_paged"
    kernels.require_cuda(name, q, k_pool, v_pool, kv_valid, page_table)
    kernels.require_aligned(name, k_pool, v_pool)
    g, r, dh = q.shape
    npool, hk, ps, _ = k_pool.shape
    b, mp = page_table.shape
    kernels.check_decode_args(name, r, dh=dh)
    if (k_pool.shape[-1] != dh or v_pool.shape != k_pool.shape
            or hk != heads_per_batch or g != b * hk
            or kv_valid.shape != (b, mp * ps)):
        raise ValueError(f"{name}: inconsistent shapes")
    if not (q.dtype == k_pool.dtype == v_pool.dtype
            and kv_valid.dtype == torch.bool):
        raise TypeError(f"{name}: takes float q and pools of one dtype and "
                        "a bool mask")
    ns, sp = kernels.decode_splits(g, mp * ps)
    pt = _pt_ids(page_table, npool)
    out = torch.empty_like(q)
    part = _scratch(g, ns, r, dh, q.device)
    if q.is_meta:
        return out
    err = kernels.library().repro_dense_decode_paged(
        kernels.dtype_code(q), pt.data_ptr(), q.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), part.data_ptr(), g, mp, ps, r, dh, hk,
        float(scale), ns, sp, kernels.decode_stages(dh, q.element_size()),
        kernels.stream_ptr())
    kernels.check(err, name)
    dense_decode_attention_paged.launches += 1
    return out


dense_decode_attention_paged.launches = 0


def _decode_setup(q, codebooks, cfg: sa.SparseAttentionConfig, hk: int,
                  s: int):
    """The query groups (G, R, d), their PQ codes (G, R, M) and the
    selection constants of a one-token decode over s slots."""
    b, hq, _, d = q.shape
    r = hq // hk
    m = codebooks.shape[0]
    sum_rows = cfg.select_granularity == "kvgroup"
    sel = dict(l=sa.top_l(s, cfg, None),
               max_score=cfg.pq.num_books * (r if sum_rows else 1),
               sum_rows=sum_rows, heads_per_batch=hk)
    codes_q = pq.assign(q, codebooks).reshape(b * hk, r, m)
    return q.reshape(b * hk, r, d), codes_q, sel


def sparse_mha_decode(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, codes_cache: torch.Tensor,
                      codebooks: torch.Tensor,
                      cfg: sa.SparseAttentionConfig, scale: float,
                      kv_valid: torch.Tensor, *,
                      fuse: bool = True) -> torch.Tensor:
    """Drop-in for core.sparse_attention.sparse_mha_decode.
    q: (B, Hq, 1, d); caches: (B, Hk, S, d); codes_cache: (B, Hk, S, M)
    int8; kv_valid: (B, S) bool.  fuse=True: the one-pass kernel 6;
    fuse=False: the two-pass tier (kernels 3 then 5), identical output."""
    b, hq, _, d = q.shape
    _, hk, s, _ = k_cache.shape
    m = codebooks.shape[0]
    qg, codes_q, sel = _decode_setup(q, codebooks, cfg, hk, s)
    kv = (k_cache.reshape(b * hk, s, d), v_cache.reshape(b * hk, s, d))
    ck = codes_cache.reshape(b * hk, s, m)
    if fuse:
        out = fused_sparse_decode_attention(qg, *kv, codes_q, ck, kv_valid,
                                            scale=scale, **sel)
    else:
        thr = decode_topl_thresholds(codes_q, ck, kv_valid, **sel)
        out = sparse_decode_attention(
            qg, *kv, codes_q, ck, thr, kv_valid, scale=scale,
            sum_rows=sel["sum_rows"], heads_per_batch=hk)
    return out.reshape(b, hq, 1, d)


def sparse_mha_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, codes_pool: torch.Tensor,
                            codebooks: torch.Tensor,
                            cfg: sa.SparseAttentionConfig, scale: float,
                            kv_valid: torch.Tensor,
                            page_table: torch.Tensor) -> torch.Tensor:
    """Paged counterpart of ``sparse_mha_decode``: kernel 7 reads the
    pools through the page table; no gathered view is built.  q: (B, Hq,
    1, d); pools: (P, Hk, ps, .); page_table: (B, MP) int32 (-1 =
    unallocated); kv_valid: (B, MP*ps) bool.  The top-L budget is taken
    over the view length, so the output equals ``sparse_mha_decode`` over
    ``kv_pages.gather_pages`` views."""
    b, hq, _, d = q.shape
    hk, ps = k_pool.shape[1], k_pool.shape[2]
    view = page_table.shape[1] * ps
    qg, codes_q, sel = _decode_setup(q, codebooks, cfg, hk, view)
    out = fused_sparse_decode_attention_paged(
        page_table, qg, k_pool, v_pool, codes_q, codes_pool, kv_valid,
        scale=scale, **sel)
    return out.reshape(b, hq, 1, d)


def dense_mha_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, scale: float,
                           kv_valid: torch.Tensor,
                           page_table: torch.Tensor) -> torch.Tensor:
    """Dense decode attention straight off the paged pools (kernel 8).
    q: (B, Hq, 1, d); pools: (P, Hk, ps, d); kv_valid: (B, MP*ps);
    page_table: (B, MP) int32 (-1 = unallocated)."""
    b, hq, _, d = q.shape
    hk = k_pool.shape[1]
    out = dense_decode_attention_paged(
        page_table, q.reshape(b * hk, hq // hk, d), k_pool, v_pool,
        kv_valid, scale=scale, heads_per_batch=hk)
    return out.reshape(b, hq, 1, d)


# ------------------------------------------------------------ train/prefill
D_MAX = 256                   # kernel 4's head dims: multiples of 8 up to this


def check_sparse_attention_args(q, k, v, codes_q, codes_k, thresholds, *,
                                heads_per_batch: int, rep: int) -> None:
    """Kernel 4's input contract, checked before anything is built or
    launched: the shapes ``sparse_attention`` names, float q/k/v of one
    dtype, int32 codes and thresholds, and a head dim that is a multiple
    of 8 and at most 256 (the kernel pads dh to its mma depth of 16 and
    keeps the output rows in registers)."""
    name = "sparse_attention"
    g, nq, dh = q.shape
    gk, nk, _ = k.shape
    m = codes_q.shape[-1]
    if (g % heads_per_batch or heads_per_batch % rep or gk * rep != g
            or v.shape != k.shape or k.shape[-1] != dh
            or codes_q.shape != (g, nq, m) or codes_k.shape != (gk, nk, m)
            or thresholds.shape != (g, nq, 2)):
        raise ValueError(f"{name}: inconsistent shapes")
    if dh % 8 or not 8 <= dh <= D_MAX:
        raise ValueError(f"{name}: head dim {dh} is not a multiple of 8 "
                         f"in [8, {D_MAX}]")
    if not (q.dtype == k.dtype == v.dtype and codes_q.dtype == torch.int32
            and codes_k.dtype == torch.int32
            and thresholds.dtype == torch.int32):
        raise TypeError(f"{name}: takes float q/k/v of one dtype and int32 "
                        "codes and thresholds")


@cost.counted("sparse_attention")
def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     codes_q: torch.Tensor, codes_k: torch.Tensor,
                     thresholds: torch.Tensor, *, scale: float,
                     causal: bool = True, window: Optional[int] = None,
                     q_offset: int = 0, heads_per_batch: int = 1,
                     rep: int = 1) -> torch.Tensor:
    """Kernel 4.  q: (G, nq, dh); k, v: (G / rep, nk, dh); codes_q:
    (G, nq, M) and codes_k: (G / rep, nk, M) int32 codes in [0, 128) (the
    bf16 kernel compares them as 7-bit bytes); thresholds: (G, nq, 2) int32
    [t, need].  G = B * heads_per_batch; query head h of batch b reads kv
    group b * Hk + h // rep.  dh: a multiple of 8 up to 256.  Returns
    (G, nq, dh) in q's dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (csrc/sparse_attention.cu): bf16 on the
    tensor cores, f32 on the CUDA cores; meta tensors get the output's
    shape."""
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset,
              heads_per_batch=heads_per_batch, rep=rep)
    if kernels.target(q) == "cpu":
        return sparse_attention_ref(q, k, v, codes_q, codes_k, thresholds,
                                    **kw).contiguous()
    name = "sparse_attention"
    kernels.require_cuda(name, q, k, v, codes_q, codes_k, thresholds)
    kernels.require_aligned(name, q, k, v)
    check_sparse_attention_args(q, k, v, codes_q, codes_k, thresholds,
                                heads_per_batch=heads_per_batch, rep=rep)
    g, nq, dh = q.shape
    nk = k.shape[1]
    out = torch.empty_like(q)
    if q.is_meta:
        return out
    err = kernels.library().repro_sparse_attention(
        kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        codes_q.data_ptr(), codes_k.data_ptr(), thresholds.data_ptr(),
        out.data_ptr(), g, nq, nk, dh, codes_q.shape[-1], heads_per_batch,
        rep, float(scale), int(causal), 0 if window is None else window,
        q_offset, kernels.stream_ptr())
    kernels.check(err, name)
    sparse_attention.launches += 1
    return out


sparse_attention.launches = 0


def _fused_forward(q, k, v, codebooks, cfg: sa.SparseAttentionConfig,
                   scale, causal, window, q_offset):
    """PQ codes, thresholds and attention through the three kernels.  The
    selection is per query head whatever ``select_granularity`` says, as
    in the JAX package's fused forward (the reference backward honours
    "kvgroup"; the two agree for "qhead")."""
    b, hq, nq, dh = q.shape
    _, hk, nk, _ = k.shape
    r = hq // hk
    l = sa.top_l(nk, cfg, window)
    qf = q.reshape(b * hq, nq, dh).contiguous()
    kf = k.reshape(b * hk, nk, dh).contiguous()
    vf = v.reshape(b * hk, nk, dh).contiguous()
    cb = codebooks.float().contiguous()
    if kernels.target(q) == "cuda" and cb.shape[1] > 128:
        raise ValueError("sparse_mha: kernel 4 takes codes in [0, 128), "
                         f"got {cb.shape[1]} codewords")
    codes_q = pq_assign(qf, cb)
    codes_k = pq_assign(kf, cb)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              heads_per_batch=hq, rep=r)
    thr = topl_thresholds(codes_q, codes_k, l=l, max_score=cfg.pq.num_books,
                          **kw)
    out = sparse_attention(qf, kf, vf, codes_q, codes_k, thr, scale=scale,
                           **kw)
    return out.reshape(b, hq, nq, dh)


class _SparseMHA(torch.autograd.Function):
    """Kernel forward, reference backward (JAX: ``_sparse_mha_op``)."""

    @staticmethod
    def forward(ctx, q, k, v, codebooks, cfg, scale, causal, window,
                q_offset):
        ctx.save_for_backward(q, k, v, codebooks)
        ctx.args = (cfg, scale, causal, window, q_offset)
        return _fused_forward(q, k, v, codebooks, cfg, scale, causal, window,
                              q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v, codebooks = ctx.saved_tensors
        cfg, scale, causal, window, q_offset = ctx.args
        want = ctx.needs_input_grad[:3]
        grads = [None, None, None]
        if any(want):
            with torch.enable_grad():
                qkv = [x.detach().requires_grad_(w)
                       for x, w in zip((q, k, v), want)]
                out, _ = sa.sparse_mha(*qkv, codebooks.detach(), cfg, scale,
                                       causal=causal, window=window,
                                       q_offset=q_offset)
                wrt = [x for x, w in zip(qkv, want) if w]
                got = iter(torch.autograd.grad(out, wrt, g))
            grads = [next(got) if w else None for w in want]
        # argmin has no derivative: the codebooks get zeros (not None), so
        # AdamW decays them as the JAX package's zero gradient does
        g_cb = (torch.zeros_like(codebooks) if ctx.needs_input_grad[3]
                else None)
        return (*grads, g_cb, None, None, None, None, None)


def sparse_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               codebooks: torch.Tensor, cfg: sa.SparseAttentionConfig,
               scale: float, causal: bool = True,
               window: Optional[int] = None, q_offset: int = 0
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Drop-in for core.sparse_attention.sparse_mha (no ragged
    ``seq_lengths``).  q: (B, Hq, nq, d); k, v: (B, Hk, nk, d).  Returns
    (out (B, Hq, nq, d) in q's dtype, aux {"l", and "qerr" when
    cfg.qerr_loss_weight > 0})."""
    out = _SparseMHA.apply(q, k, v, codebooks, cfg, scale, causal, window,
                           q_offset)
    aux = {"l": sa.top_l(k.shape[2], cfg, window)}
    if cfg.qerr_loss_weight > 0:
        aux["qerr"] = (pq.quantization_error(q, codebooks)
                       + pq.quantization_error(k, codebooks))
    return out, aux
