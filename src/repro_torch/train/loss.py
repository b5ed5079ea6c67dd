"""LM cross-entropy, sequence-chunked.

The logits of a 152k vocabulary dominate activation memory if made at
once, so the loss runs over sequence chunks and only (B, C, V) logits
exist per chunk.  As in the JAX package: the head weight is detached (a
frozen leaf), logits are taken in the hidden dtype and then cast to f32,
and the log-sum-exp and the accuracy's argmax run over the PADDED
vocabulary (``padded_vocab``, a multiple of 256), whose rows past
``vocab_size`` are embedding rows like any other.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def lm_cross_entropy(params, cfg: ModelConfig, hidden: torch.Tensor,
                     labels: torch.Tensor, chunk: int = 512
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """hidden: (B, S_h, d); labels: (B, S_lab) with -1 = ignore.  The last
    S_lab hidden positions predict the labels (a VLM's prepended frontend
    rows predict nothing).  Returns (loss, {nll_sum,
    tokens, accuracy})."""
    s_lab = labels.shape[1]
    h = hidden[:, -s_lab:, :]
    w = transformer.head_weight(params, cfg).detach().to(h.dtype)
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
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, lc.clamp(min=0)[..., None])[..., 0]
        ok = (lc >= 0).float()
        total = total + ((lse - tgt) * ok).sum()
        denom = denom + ok.sum()
        correct = correct + ((logits.argmax(-1) == lc).float() * ok).sum()
    denom = torch.clamp(denom, min=1.0)
    return total / denom, {"nll_sum": total, "tokens": denom,
                           "accuracy": correct / denom}
