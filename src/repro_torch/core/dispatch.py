"""Capacity-bucketed token dispatch (the paper's BSpMV batching, §5.2) and
the kernel-path switches.

Token t of sequence b activating group g lands in slot rank(t within
(b, g)) if below capacity; overflowing (token, choice) pairs are dropped.
Dispatch is per sequence: ranks come from a cumsum along the sequence
axis only.  Shapes: x (B, S, d); choice/gate (B, S, K); plan.index
(B, G, C) with S marking an empty slot.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Static-shape routing plan for one layer invocation."""
    index: torch.Tensor      # (B, G, C) int32 — slot -> token (S if empty)
    slot_ok: torch.Tensor    # (B, G, C) bool
    combine_w: torch.Tensor  # (B, G, C) f32
    dropped: torch.Tensor    # () f32 — dropped share of (token, choice) pairs


def one_hot(x: torch.Tensor, n: int, dtype=torch.int64) -> torch.Tensor:
    """``F.one_hot(x, n)`` as ``dtype`` (values in [0, n)) through the same
    ops on every device: torch's own takes a min/max check and a scatter
    on the CPU, a scatter on a card and a compare on the meta device, so a
    dry run (launch/dryrun.py) would count another path than it runs."""
    ar = torch.arange(n, device=x.device, dtype=x.dtype)
    return (x.unsqueeze(-1) == ar).to(dtype)


def capacity(tokens_per_seq: int, num_groups: int, topk: int,
             capacity_factor: float, pad: int = 8) -> int:
    """Slots per (sequence, group), padded to a multiple of ``pad``."""
    pad = max(8, pad)
    c = int(tokens_per_seq * topk * capacity_factor / num_groups) + 1
    c = -(-c // pad) * pad
    return min(c, max(pad, -(-tokens_per_seq * topk // pad) * pad))


def capacity_dyn(tokens_per_seq: torch.Tensor, num_groups: int, topk: int,
                 capacity_factor: float, pad: int = 8) -> torch.Tensor:
    """Per-row ``capacity`` for (B,) lengths, in float32 like the JAX form
    (exact for the dyadic capacity factors of every config)."""
    pad = max(8, pad)
    t = tokens_per_seq.to(torch.int32)
    c = (t.float() * topk * capacity_factor / num_groups).to(torch.int32) + 1
    c = -(-c // pad) * pad
    return torch.minimum(c, torch.clamp(-(-t * topk // pad) * pad, min=pad))


def make_plan(choice: torch.Tensor, gate: torch.Tensor, num_groups: int,
              cap: int, cap_dyn: Optional[torch.Tensor] = None
              ) -> DispatchPlan:
    """choice: (B, S, K) int; gate: (B, S, K) f32.  cap_dyn: optional
    per-row (B,) capacities (<= cap) for right-padded ragged rows."""
    b, s, k = choice.shape
    dev = choice.device
    flat_choice = choice.reshape(b, s * k).long()
    flat_gate = gate.reshape(b, s * k).float()
    oh = one_hot(flat_choice, num_groups)           # (B, SK, G)
    ranks = oh.cumsum(1) - oh                       # exclusive, per seq
    rank = (ranks * oh).sum(-1)                     # (B, SK)
    limit = (cap if cap_dyn is None
             else torch.clamp(cap_dyn.long(), max=cap)[:, None])
    keep = rank < limit
    # XLA's mean: the sum times the f32 reciprocal of the count (a true
    # division rounds differently, so ``dropped`` would miss JAX's bits)
    dropped = 1.0 - keep.float().sum() * torch.tensor(
        1.0 / keep.numel(), dtype=torch.float32, device=dev)
    token_id = torch.arange(s, dtype=torch.int32, device=dev)
    token_id = token_id.repeat_interleave(k)[None].expand(b, s * k)
    # dropped pairs land in one trash column past G*C, cut off below
    dest = torch.where(keep, flat_choice * cap + rank, num_groups * cap)
    n = num_groups * cap + 1
    index = torch.full((b, n), s, dtype=torch.int32, device=dev)
    slot_ok = torch.zeros((b, n), dtype=torch.bool, device=dev)
    combine_w = torch.zeros((b, n), dtype=torch.float32, device=dev)
    index.scatter_(1, dest, token_id)
    slot_ok.scatter_(1, dest, torch.ones_like(keep))
    combine_w.scatter_(1, dest, flat_gate)
    shape = (b, num_groups, cap)
    return DispatchPlan(index[:, :-1].reshape(shape).contiguous(),
                        slot_ok[:, :-1].reshape(shape).contiguous(),
                        combine_w[:, :-1].reshape(shape).contiguous(),
                        dropped)


def gather(x: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """(B, S, d) -> (B, G, C, d); empty slots read a zero row."""
    b, s, d = x.shape
    _, g, c = plan.index.shape
    xz = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    rows = (torch.arange(b, device=x.device)[:, None] * (s + 1)
            + plan.index.reshape(b, g * c).long())
    return xz.reshape(b * (s + 1), d)[rows.reshape(-1)].reshape(b, g, c, d)


def combine(y: torch.Tensor, plan: DispatchPlan, seq_len: int
            ) -> torch.Tensor:
    """(B, G, C, d) -> (B, S, d) scatter-add with combine weights; empty
    and dropped slots carry weight 0 and index S, so their (arbitrary,
    finite) rows land in a discarded row.  The add is an accumulating
    ``index_put_``, which CUDA sums in a fixed (sorted) order; the
    atomics of ``index_add_`` sum a token's groups in an order that
    changes from run to run, so the same prefill differed in its last
    bits between runs."""
    b, g, c, d = y.shape
    w = torch.where(plan.slot_ok, plan.combine_w, 0.0).to(y.dtype)
    yw = (y * w[..., None]).reshape(b * g * c, d)
    rows = (torch.arange(b, device=y.device)[:, None] * (seq_len + 1)
            + plan.index.reshape(b, g * c).long())
    out = y.new_zeros(b * (seq_len + 1), d)
    out.index_put_((rows.reshape(-1),), yw, accumulate=True)
    return out.reshape(b, seq_len + 1, d)[:, :seq_len]


# ------------------------------------------------------ kernel dispatch
# Which execution path a layer takes: one global kill switch plus the
# per-feature config flags, with the JAX package's semantics.

def kernels_disabled() -> bool:
    """REPRO_DISABLE_KERNELS=1 sends every layer to its core/ oracle path
    (unset/0/false = kernels allowed)."""
    return os.environ.get("REPRO_DISABLE_KERNELS", "0").strip().lower() \
        not in ("", "0", "false")


def use_sparse_attn_kernel(cfg) -> bool:
    """Train/prefill sparse MHA through the fused CUDA kernels (PQ
    assignment, top-L thresholds, thresholded attention)?"""
    return cfg.spt.attn_impl == "pallas" and not kernels_disabled()


def use_sparse_decode_kernel(cfg) -> bool:
    """Sparse-MHA decode through the fused CUDA kernel?  decode_attn_impl
    "auto" follows attn_impl ("pallas" = kernel)."""
    if kernels_disabled():
        return False
    impl = cfg.spt.decode_attn_impl
    if impl == "auto":
        return cfg.spt.attn_impl == "pallas"
    return impl == "kernel"


def use_fused_decode_attn(cfg) -> bool:
    """Within the sparse-decode kernel tier: the one-pass fused kernel
    (kernel 6, or 7 on the paged pool) vs the two-pass pair (threshold
    kernel 3, then attention kernel 5), the bisection tier; both give
    identical output.  decode_attn_fuse "auto" = fused.  Only consulted
    once use_sparse_decode_kernel said yes, so the kill switch needs no
    handling here."""
    mode = cfg.spt.decode_attn_fuse
    return True if mode == "auto" else mode == "fused"


def use_paged_native_decode(cfg) -> bool:
    """Paged-pool decode attention addressed straight through the page
    table by the kernels (7 sparse, 8 dense) instead of over gathered
    per-slot views (models/paged_fallback.py)?  kv_paged_native "auto"
    follows attn_impl ("pallas" = native).  A kernel decision, so
    REPRO_DISABLE_KERNELS=1 sends the paged route to the gathered-view
    tier."""
    if kernels_disabled():
        return False
    impl = cfg.spt.kv_paged_native
    if impl == "auto":
        return cfg.spt.attn_impl == "pallas"
    return impl == "kernel"


def use_paged_kv(cfg) -> bool:
    """Serving KV cache laid out as fixed-size pages from a shared pool
    (serving/kv_pages.py) instead of one max_len strip per slot?  A pure
    layout decision, so the kill switch does not apply; the engine also
    needs transformer.paged_applicable(cfg)."""
    return cfg.spt.kv_layout == "paged"


def telemetry_mode(cfg) -> str:
    """Serving-observability level: "off" | "counters" | "trace".  A
    config decision, not a kernel, so the kill switch does not apply."""
    return cfg.spt.telemetry


def use_telemetry_counters(cfg) -> bool:
    """Do the model layers emit the device telemetry counters (``tel_*``
    aux entries: sparse-MHA kept/eligible slots, routed-FFN expert loads
    and capacity drops)?  Both "counters" and "trace" turn them on; off,
    the decode step does no counter work."""
    return telemetry_mode(cfg) in ("counters", "trace")


def use_routed_ffn_kernel(cfg) -> bool:
    """Train/prefill routed FFN through the grouped-FFN CUDA kernel?"""
    if kernels_disabled():
        return False
    return cfg.spt.ffn_impl == "pallas"


def use_decode_ffn_kernel(cfg) -> bool:
    """Decode routed FFN at (B, 1, d) through the block-gather CUDA
    kernel?  decode_ffn_impl "auto" follows ffn_impl."""
    if kernels_disabled():
        return False
    impl = cfg.spt.decode_ffn_impl
    if impl == "auto":
        return cfg.spt.ffn_impl == "pallas"
    return impl == "kernel"


def load_balance_loss(router_probs: torch.Tensor, choice: torch.Tensor,
                      num_groups: int, global_batch: bool = True
                      ) -> torch.Tensor:
    """Switch-style auxiliary loss: G * sum_g f_g p_g (== 1 when balanced).

    f and p are means over the batch: under a mesh whose data axes split
    the rows (``sharding.axis_rules``), each is averaged over those axes
    before the product, as JAX's GSPMD computes them on the global batch
    (a product of means does not split by rows).  ``global_batch=False``
    keeps this shard's own term (core/ffn_shmap.py pmeans it, as JAX's
    does)."""
    from repro_torch.core import collectives as C
    k = choice.shape[-1]
    oh = one_hot(choice, num_groups, torch.float32)
    f = oh.sum(2).mean((0, 1)) / k
    p = router_probs.float().mean((0, 1))
    dp = C.batch_axis() if global_batch else None
    if dp is not None:
        f = C.all_reduce_(f.clone(), dp) / dp.size
        p = C.reduce_sum(p, dp) / dp.size
    return num_groups * (f * p).sum()
