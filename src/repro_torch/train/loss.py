"""LM cross-entropy, sequence-chunked, vocabulary-split under a mesh.

The logits of a 152k vocabulary dominate activation memory if made at
once, so the loss runs over sequence chunks and only (B, C, V) logits
exist per chunk.  As in the JAX package: the head weight is detached (a
frozen leaf), logits are taken in the hidden dtype and then cast to f32,
and the log-sum-exp and the accuracy's argmax run over the PADDED
vocabulary (``padded_vocab``, a multiple of 256), whose rows past
``vocab_size`` are embedding rows like any other.

Under the sequence-parallel layout (``tp``) the hidden states are this
rank's chunk of the sequence: they are gathered, and each rank takes the
logits of the V/n vocabulary rows it stores (train/state.py), with the
max, the sum of exponentials and the target logit all-reduced over the
model axis (JAX: reductions
over the "vocab"-sharded logits under pjit).  Under data parallelism
(``dp``) the nll and token sums are summed over the data axes before the
division: the loss is a mean over the global batch's tokens, not a mean
of per-shard means.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.models import transformer


def _vocab_split(logits: torch.Tensor, labels: torch.Tensor, lo: int,
                 tp: C.Axis):
    """(lse, target logit, argmax) of f32 logits (B, c, V/n) holding the
    vocabulary rows [lo, lo + V/n) of each rank; the argmax is the first
    index of the global maximum, as over the whole row."""
    vl = logits.shape[-1]
    top, arg = logits.detach().max(-1)
    m = C.all_reduce_(top.clone(), tp, dist.ReduceOp.MAX)
    se = C.reduce_sum(torch.exp(logits - m[..., None]).sum(-1), tp)
    lse = m + torch.log(se)
    idx = labels.clamp(min=0) - lo
    mine = (idx >= 0) & (idx < vl)
    tgt = logits.gather(-1, idx.clamp(0, vl - 1)[..., None])[..., 0]
    tgt = C.reduce_sum(torch.where(mine, tgt, torch.zeros_like(tgt)), tp)
    big = torch.iinfo(torch.int64).max
    first = torch.where(top == m, arg + lo, torch.full_like(arg, big))
    return lse, tgt, C.all_reduce_(first, tp, dist.ReduceOp.MIN)


def lm_cross_entropy(params, cfg: ModelConfig, hidden: torch.Tensor,
                     labels: torch.Tensor, chunk: int = 512,
                     tp: Optional[C.Axis] = None,
                     dp: Optional[C.Axis] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """hidden: (B, S_h, d) (with ``tp``, this rank's (B, S_h/n, d) chunk);
    labels: (B, S_lab) with -1 = ignore.  The last S_lab hidden positions
    predict the labels (a VLM's prepended frontend rows predict nothing).
    dp: the data axes that split the rows.  Returns (loss, {nll_sum,
    tokens, accuracy}), each over the global batch."""
    if tp is not None:
        hidden = C.gather_seq(hidden, tp)
    s_lab = labels.shape[1]
    h = hidden[:, -s_lab:, :]
    w = transformer.head_weight(params, cfg).detach().to(h.dtype)
    split = w.shape[1] != cfg.padded_vocab      # a stored part of V/n
    if split:
        lo = tp.rank * w.shape[1]
    c = min(chunk, s_lab)
    if s_lab % c:
        c = s_lab
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    denom = torch.zeros_like(total)
    correct = torch.zeros_like(total)
    for start in range(0, s_lab, c):
        lc = labels[:, start:start + c].long()
        logits = h[:, start:start + c] @ w
        if cfg.logits_softcap:
            cap = cfg.logits_softcap
            logits = torch.tanh(logits / cap) * cap
        logits = logits.float()
        if split:
            lse, tgt, arg = _vocab_split(logits, lc, lo, tp)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, lc.clamp(min=0)[..., None])[..., 0]
            arg = logits.argmax(-1)
        ok = (lc >= 0).float()
        total = total + ((lse - tgt) * ok).sum()
        denom = denom + ok.sum()
        correct = correct + ((arg == lc).float() * ok).sum()
    if tp is not None and not split:
        total = C.mean_exit(total, tp)   # the whole row on every rank
    total = C.reduce_sum(total, dp)
    C.all_reduce_(denom, dp)
    C.all_reduce_(correct, dp)
    denom = torch.clamp(denom, min=1.0)
    return total / denom, {"nll_sum": total, "tokens": denom,
                           "accuracy": correct / denom}
