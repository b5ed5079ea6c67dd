"""Gathered-view tier of paged-pool decode attention (port of the JAX
package's ``models/paged_fallback.py``).

The default paged decode route (models/attention.py) is kernel-native:
kernels 7 and 8 read K/V/code rows straight out of the page pools through
the page table, so no per-slot gathered view exists.  This module is the
other tier: it builds the gathered (B, Hk, MP*page_size, .) views with
``kv_pages.gather_pages`` and runs the contiguous decode paths over them
(on the card: kernel 6, or kernels 3 and 5 under
``decode_attn_fuse="two_pass"``).  It serves
  * the core/ oracle (``attn_impl != "pallas"``) and
    ``kv_paged_native="gather"``,
  * the ``REPRO_DISABLE_KERNELS=1`` kill switch,
  * callers of ``lm_decode_step`` that hand in no view-coordinate
    validity mask (the fallback derives it from the gathered
    ``slot_pos`` and the page occupancy).
Only the views a path reads are gathered: K/V always, the cached PQ codes
on the sparse route, ``slot_pos`` only without the engine's mask.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import dispatch
from repro_torch.core import sparse_attention as sa
from repro_torch.serving import kv_pages


def decode_attend_gathered(p, cfg, q: torch.Tensor, cache: dict,
                           page_table: torch.Tensor, pos_b: torch.Tensor,
                           kv_valid: Optional[torch.Tensor],
                           scale: float) -> torch.Tensor:
    """One-token decode attention over a paged cache through gathered
    views.  q: (B, Hq, 1, d); cache: paged pools (k/v/codes (P, Hk, ps,
    .), slot_pos (P, ps)); page_table: (B, MP) int32; pos_b: (B,)
    absolute positions; kv_valid: optional engine (B, MP*ps) mask.
    Selection and masking are the contiguous path's, over the views."""
    from repro_torch.models import attention as mattn
    ps = cache["k"].shape[2]
    k_view = kv_pages.gather_pages(cache["k"], page_table)
    v_view = kv_pages.gather_pages(cache["v"], page_table)
    s_view = k_view.shape[2]
    if kv_valid is not None and kv_valid.shape[-1] == s_view:
        valid = kv_valid                                  # engine-tracked
    else:
        # self-derived: slot_pos visibility AND page-table occupancy
        # (unallocated pages read page 0's rows)
        sp = kv_pages.gather_pages(cache["slot_pos"], page_table)
        valid = ((sp >= 0) & (sp <= pos_b[:, None])
                 & kv_pages.occupancy(page_table, ps))
    if mattn.sparse_applicable(cfg):
        codes_view = kv_pages.gather_pages(cache["codes"], page_table)
        args = (q, k_view, v_view, codes_view, p["pq"]["codebooks"],
                mattn._sa_config(cfg), scale, valid)
        if dispatch.use_sparse_decode_kernel(cfg):
            from repro_torch.kernels.sparse_attention import ops as sa_ops
            return sa_ops.sparse_mha_decode(
                *args, fuse=dispatch.use_fused_decode_attn(cfg))
        return sa.sparse_mha_decode(*args)
    return sa.dense_attention(q, k_view, v_view, scale, causal=False,
                              kv_valid=valid, chunk_q=1)
