"""Public fused sparse-MHA decode op (serving; inference-only).

``sparse_mha_decode`` is the drop-in for core.sparse_attention's oracle:
the one-token query codes are assigned in plain torch (O(B*Hq*M*E), as the
JAX op does), and all O(S) work — code matching, the threshold histogram
and the attention sweep — runs in the CUDA kernel
``fused_sparse_decode_attention`` with the R query heads of a kv head in
one block per split of the cache.  L comes from the unpadded cache
length; the kernel masks its ragged last tile itself, so no padding
enters the selection.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core import pq
from repro_torch.core import sparse_attention as sa
from repro_torch.kernels.sparse_attention.ref import fused_decode_ref

TILE = 128            # slots per tile of the CUDA kernel
BLOCKS_PER_CALL = 528  # ~4 blocks per SM of the H100's 132


def splits(g: int, s: int):
    """(ns, sp): the cache of each of the g kv groups is cut into ns
    splits of sp slots (a tile multiple) so that g * ns blocks fill the
    card."""
    tiles = -(-s // TILE)
    ns = max(1, min(tiles, -(-BLOCKS_PER_CALL // g)))
    sp = -(-tiles // ns) * TILE
    return -(-s // sp), sp


def fused_sparse_decode_attention(q, k, v, codes_q, codes_k, kv_valid, *,
                                  scale: float, l: int, max_score: int,
                                  sum_rows: bool, heads_per_batch: int,
                                  return_thresholds: bool = False):
    """q: (G, R, dh); k, v: (G, S, dh) with G = B * heads_per_batch;
    codes_q: (G, R, M) int32; codes_k: (G, S, M) int8; kv_valid: (B, S)
    bool.  Returns out (G, R, dh) in q's dtype, and with
    ``return_thresholds`` also the (G, R_out, 2) int32 [t, need] the
    selection used.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (csrc/sparse_decode.cu)."""
    if q.device.type == "cpu":
        out, thr = fused_decode_ref(
            q, k, v, codes_q, codes_k, kv_valid, scale=scale, l=l,
            max_score=max_score, sum_rows=sum_rows,
            heads_per_batch=heads_per_batch)
        return (out, thr) if return_thresholds else out
    name = "fused_sparse_decode_attention"
    kernels.require_cuda(name, q, k, v, codes_q, codes_k, kv_valid)
    g, r, dh = q.shape
    s = k.shape[1]
    m = codes_q.shape[-1]
    if (k.shape != (g, s, dh) or v.shape != k.shape
            or codes_k.shape != (g, s, m)
            or kv_valid.shape != (g // heads_per_batch, s)):
        raise ValueError(f"{name}: inconsistent shapes")
    if not (q.dtype == k.dtype == v.dtype and codes_q.dtype == torch.int32
            and codes_k.dtype == torch.int8 and kv_valid.dtype == torch.bool):
        raise TypeError(f"{name}: takes float q/k/v of one dtype, int32 "
                        "query codes, int8 cached codes and a bool mask")
    r_out = 1 if sum_rows else r
    ns, sp = splits(g, s)
    dev = q.device
    out = torch.empty_like(q)
    thr = (torch.empty((g, r_out, 2), dtype=torch.int32, device=dev)
           if return_thresholds else None)
    hist = torch.empty((g, ns, r_out, max_score + 1), dtype=torch.int32,
                       device=dev)
    part = torch.empty((g, ns, r, dh + 2), dtype=torch.float32, device=dev)
    err = kernels.library().repro_fused_sparse_decode(
        kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        codes_q.data_ptr(), codes_k.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), None if thr is None else thr.data_ptr(),
        hist.data_ptr(), part.data_ptr(), g, s, r, dh, m, heads_per_batch, l,
        max_score, int(sum_rows), float(scale), ns, sp,
        kernels.stream_ptr())
    kernels.check(err, name)
    fused_sparse_decode_attention.launches += 1
    return (out, thr) if return_thresholds else out


fused_sparse_decode_attention.launches = 0


def sparse_mha_decode(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, codes_cache: torch.Tensor,
                      codebooks: torch.Tensor,
                      cfg: sa.SparseAttentionConfig, scale: float,
                      kv_valid: torch.Tensor) -> torch.Tensor:
    """Drop-in for core.sparse_attention.sparse_mha_decode.
    q: (B, Hq, 1, d); caches: (B, Hk, S, d); codes_cache: (B, Hk, S, M)
    int8; kv_valid: (B, S) bool."""
    b, hq, _, d = q.shape
    _, hk, s, _ = k_cache.shape
    r = hq // hk
    m = codebooks.shape[0]
    sum_rows = cfg.select_granularity == "kvgroup"
    codes_q = pq.assign(q, codebooks).reshape(b * hk, r, m)
    out = fused_sparse_decode_attention(
        q.reshape(b * hk, r, d), k_cache.reshape(b * hk, s, d),
        v_cache.reshape(b * hk, s, d), codes_q,
        codes_cache.reshape(b * hk, s, m), kv_valid, scale=scale,
        l=sa.top_l(s, cfg, None),
        max_score=cfg.pq.num_books * (r if sum_rows else 1),
        sum_rows=sum_rows, heads_per_batch=hk)
    return out.reshape(b, hq, 1, d)
