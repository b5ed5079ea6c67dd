"""Public fused sparse-MHA ops: CUDA forwards, reference backward.

Train/prefill (``sparse_mha``): the PQ assignment kernel for q and k, the
top-L threshold kernel, then ``sparse_attention`` (the thresholded
attention kernel), in a ``torch.autograd.Function`` whose backward
differentiates the reference ``core.sparse_attention.sparse_mha``.  The
reference selects the same top-L set (same integer thresholds and tie
rule), so the gradient is that of the fused forward up to float
summation order — the contract of the JAX custom_vjp it mirrors.

Serving decode (``sparse_mha_decode``): the one-token query codes are
assigned in plain torch (O(B*Hq*M*E), as the JAX op does), and all O(S)
work — code matching, the threshold histogram and the attention sweep —
runs in the CUDA kernel ``fused_sparse_decode_attention`` with the R
query heads of a kv head in one block per split of the cache.  L comes
from the unpadded cache length; the kernel masks its ragged last tile
itself, so no padding enters the selection.  Inference-only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.core import pq
from repro_torch.core import sparse_attention as sa
from repro_torch.kernels.pq_quantize.ops import pq_assign
from repro_torch.kernels.sparse_attention.ref import (fused_decode_ref,
                                                      sparse_attention_ref)
from repro_torch.kernels.topl_select.ops import topl_thresholds

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


# ------------------------------------------------------------ train/prefill
def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     codes_q: torch.Tensor, codes_k: torch.Tensor,
                     thresholds: torch.Tensor, *, scale: float,
                     causal: bool = True, window: Optional[int] = None,
                     q_offset: int = 0, heads_per_batch: int = 1,
                     rep: int = 1) -> torch.Tensor:
    """q: (G, nq, dh); k, v: (G / rep, nk, dh); codes_q: (G, nq, M) and
    codes_k: (G / rep, nk, M) int32; thresholds: (G, nq, 2) int32
    [t, need].  G = B * heads_per_batch; query head h of batch b reads kv
    group b * Hk + h // rep.  Returns (G, nq, dh) in q's dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (csrc/sparse_attention.cu)."""
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset,
              heads_per_batch=heads_per_batch, rep=rep)
    if q.device.type == "cpu":
        return sparse_attention_ref(q, k, v, codes_q, codes_k, thresholds,
                                    **kw)
    name = "sparse_attention"
    kernels.require_cuda(name, q, k, v, codes_q, codes_k, thresholds)
    kernels.require_aligned(name, q, k, v)
    g, nq, dh = q.shape
    gk, nk, _ = k.shape
    m = codes_q.shape[-1]
    if (g % heads_per_batch or heads_per_batch % rep or gk * rep != g
            or v.shape != k.shape or k.shape[-1] != dh
            or codes_k.shape != (gk, nk, m)
            or thresholds.shape != (g, nq, 2)):
        raise ValueError(f"{name}: inconsistent shapes")
    if dh not in (32, 64, 128, 256):
        raise ValueError(f"{name}: head dim {dh} is not 32, 64, 128 or 256")
    if not (q.dtype == k.dtype == v.dtype and codes_q.dtype == torch.int32
            and codes_k.dtype == torch.int32
            and thresholds.dtype == torch.int32):
        raise TypeError(f"{name}: takes float q/k/v of one dtype and int32 "
                        "codes and thresholds")
    out = torch.empty_like(q)
    err = kernels.library().repro_sparse_attention(
        kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        codes_q.data_ptr(), codes_k.data_ptr(), thresholds.data_ptr(),
        out.data_ptr(), g, nq, nk, dh, m, heads_per_batch, rep,
        float(scale), int(causal), 0 if window is None else window,
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
