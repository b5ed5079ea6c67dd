"""Public top-L threshold op: [t, need] per query row for the fused
train/prefill sparse attention (paper Algorithm 3, bucket form).  No
indices are ever emitted: the attention kernel consumes the thresholds."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.topl_select.ref import thresholds_ref


def topl_thresholds(codes_q: torch.Tensor, codes_k: torch.Tensor, *, l: int,
                    max_score: int, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    heads_per_batch: int = 1, rep: int = 1) -> torch.Tensor:
    """codes_q: (G, nq, M) int32, G = B * heads_per_batch query groups;
    codes_k: (G / rep, nk, M) int32 (query head h of batch b reads kv
    group b * Hk + h // rep).  Returns (G, nq, 2) int32 [t, need].  CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (csrc/topl_thresholds.cu)."""
    kw = dict(l=l, max_score=max_score, causal=causal, window=window,
              q_offset=q_offset, heads_per_batch=heads_per_batch, rep=rep)
    if codes_q.device.type == "cpu":
        return thresholds_ref(codes_q, codes_k, **kw)
    name = "topl_thresholds"
    kernels.require_cuda(name, codes_q, codes_k)
    g, nq, m = codes_q.shape
    gk, nk, mk = codes_k.shape
    if (mk != m or g % heads_per_batch or heads_per_batch % rep
            or gk * rep != g):
        raise ValueError(f"{name}: codes {tuple(codes_q.shape)} vs "
                         f"{tuple(codes_k.shape)} with {heads_per_batch} "
                         f"heads per batch, {rep} per kv head")
    if codes_q.dtype != torch.int32 or codes_k.dtype != torch.int32:
        raise TypeError(f"{name}: takes int32 codes")
    thr = torch.empty((g, nq, 2), dtype=torch.int32, device=codes_q.device)
    err = kernels.library().repro_topl_thresholds(
        codes_q.data_ptr(), codes_k.data_ptr(), thr.data_ptr(), g, nq, nk, m,
        heads_per_batch, rep, l, max_score, int(causal),
        0 if window is None else window, q_offset, kernels.stream_ptr())
    kernels.check(err, name)
    topl_thresholds.launches += 1
    return thr


topl_thresholds.launches = 0
