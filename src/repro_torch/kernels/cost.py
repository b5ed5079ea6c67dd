"""What each of the ten kernels costs: one function per TPU kernel.

Each function takes its wrapper's arguments (tensors, or anything with a
``shape`` and a ``dtype``; ``kernels/*/ops.py``) and returns a
:class:`Cost`: the operations the kernel does, by type — ``"bf16"`` on
the tensor cores, ``"f32"`` on the CUDA cores, ``"int"`` integer compares
(counted at the f32 rate) — the bytes it must move (each input it reads
once, each output written once) and the device scratch the wrapper
allocates for it beside its outputs.  Where the work depends on the data
the count takes the static budgets the arguments fix: the top-L budget
``l``, every capacity slot kept, every slot of a cache live, every
(slot, choice) block distinct.  Optional live counts (``pairs``,
``rows_read``, ``live``, ``kept``, ``blocks``) replace them where a caller
has the data (``chip_smoke.py``'s bounds).

``counted(name)`` makes a wrapper record its cost into the active
roofline counter and run uncounted inside it, so a kernel is counted by
its formula on every device: the card, the CPU's plain version and the
meta device's dry run alike.  With no counter active the wrapper pays one
global check.  This module holds that process-wide hook (``ACTIVE``,
which ``launch/roofline.Counter`` sets while it counts, and
``record_collective``), so neither the kernels nor ``core`` import
``launch``.

Kernels 4 and 5 take thresholds, not the top-L budget behind them: their
count reads the budget kernel 2 or 3 made those thresholds with under the
same counter (``budget_of``), and counts every admitted key (every slot)
for thresholds of unknown origin.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import Dict, Optional, Tuple

import torch

# NVIDIA's datasheet peaks for the H100 SXM part ("H100 80GB HBM3", 700 W;
# dense rates, no sparsity), not measurements (launch/roofline.py)
PEAK_FLOPS = 989e12          # dense bf16 / fp16, tensor cores
PEAK_FLOPS_F32 = 67e12       # float32, outside the tensor cores
HBM_BW = 3.35e12             # bytes/s

# the peak rate each type of operation is counted at
PEAKS = {"bf16": PEAK_FLOPS, "f32": PEAK_FLOPS_F32, "int": PEAK_FLOPS_F32}

# the roofline counter in force, process-wide (launch/roofline.Counter
# sets it on entry and puts the one before back on exit)
ACTIVE = None


def record_collective(kind: str, nbytes: int) -> None:
    """One collective of ``kind`` whose result holds ``nbytes``, into the
    active counter (core/collectives.py calls this for each)."""
    if ACTIVE is not None:
        ACTIVE.collective(kind, nbytes)


# thresholds made under a counter -> (a weak reference, the top-L budget)
_BUDGETS: Dict[int, tuple] = {}
# the wrappers whose output is thresholds made with their ``l``
_MAKE_THRESHOLDS = ("topl_thresholds", "decode_topl_thresholds")


def _note_budget(thr: torch.Tensor, l: int) -> None:
    key = id(thr)
    _BUDGETS[key] = (weakref.ref(thr, lambda _: _BUDGETS.pop(key, None)), l)


def budget_of(thr) -> Optional[int]:
    """The top-L budget kernel 2 or 3 made ``thr`` with under the active
    counter, or None."""
    entry = _BUDGETS.get(id(thr))
    return entry[1] if entry is not None and entry[0]() is thr else None


@dataclasses.dataclass(frozen=True)
class Cost:
    """ops: {type: count}; bytes: moved to or from device memory;
    scratch: bytes of device scratch alive during the launch."""
    ops: Dict[str, int]
    bytes: int
    scratch: int = 0

    def bound_ms(self) -> Tuple[float, str]:
        """The least ms the card could take: the bytes over its memory
        rate or the operations over the peak rate of their type, the
        larger (``launch/roofline.py``'s datasheet figures)."""
        t_bytes = self.bytes / HBM_BW * 1e3
        t_ops = sum(n / PEAKS[k] for k, n in self.ops.items()) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")


def _nb(*ts) -> int:
    """Bytes of tensors (None adds nothing)."""
    return sum(math.prod(t.shape) * t.dtype.itemsize for t in ts
               if t is not None)


def _kind(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def _admitted(nq: int, nk: int, causal: bool, window: Optional[int],
              q_offset: int) -> list:
    """Keys the causal / window mask admits for each query row."""
    out = []
    for i in range(nq):
        p = q_offset + i
        hi = min(nk - 1, p) if causal else nk - 1
        lo = max(0, p - window + 1) if window is not None else 0
        out.append(max(0, hi - lo + 1))
    return out


# ------------------------------------------------------------- kernel 1
def pq_assign(x, codebooks) -> Cost:
    """x (..., n, M d'), codebooks (M, E, d') f32 -> codes (..., n, M)
    int32: every row scored against every codeword, 2 d' + 2 operations
    a (row, book, codeword)."""
    m, e, dp = codebooks.shape
    rows = math.prod(x.shape[:-1])
    return Cost({_kind(x.dtype): rows * m * e * (2 * dp + 2)},
                _nb(x, codebooks) + rows * m * 4)


# ------------------------------------------------------------- kernel 2
def topl_thresholds(codes_q, codes_k, *, l: int, max_score: int,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, heads_per_batch: int = 1,
                    rep: int = 1) -> Cost:
    """M integer compares per admitted (query, key) pair; the codes read
    once, (G, nq, 2) int32 [t, need] written."""
    g, nq, m = codes_q.shape
    pairs = g * sum(_admitted(nq, codes_k.shape[1], causal, window,
                              q_offset))
    return Cost({"int": pairs * m}, _nb(codes_q, codes_k) + g * nq * 2 * 4)


# ------------------------------------------------------------- kernel 3
def _splits(g: int, s: int) -> int:
    from repro_torch import kernels
    return kernels.decode_splits(g, s)[0]


def decode_topl_thresholds(codes_q, codes_k, kv_valid, *, l: int,
                           max_score: int, sum_rows: bool,
                           heads_per_batch: int, return_hist: bool = False,
                           live: Optional[int] = None) -> Cost:
    """live: valid (kv group, slot) pairs (default every slot).  R x M
    compares and M code bytes per live pair; the histogram scratch; with
    ``return_hist`` the summed histograms written as well."""
    g, r, m = codes_q.shape
    s = codes_k.shape[1]
    live = g * s if live is None else live
    r_out = 1 if sum_rows else r
    hist = g * _splits(g, s) * r_out * (max_score + 1) * 4
    written = g * r_out * 2 * 4 + (g * r_out * (max_score + 1) * 4
                                   if return_hist else 0)
    return Cost({"int": live * r * m},
                _nb(codes_q, kv_valid) + written + live * m, scratch=hist)


# ------------------------------------------------------------- kernel 4
def sparse_attention(q, k, v, codes_q, codes_k, thresholds, *, scale: float,
                     causal: bool = True, window: Optional[int] = None,
                     q_offset: int = 0, heads_per_batch: int = 1,
                     rep: int = 1, l: Optional[int] = None,
                     pairs: Optional[int] = None,
                     rows_read: Optional[int] = None) -> Cost:
    """4 dh operations per selected (query, key) pair (q.k and p.v); q,
    the codes and thresholds read, the selected K and V rows read once,
    the output written.  Static: each row selects min(l, admitted) keys,
    ``l`` by default the thresholds' budget (``budget_of``; every
    admitted key where it is unknown), every K/V row is read."""
    g, nq, dh = q.shape
    gk, nk, _ = k.shape
    l = budget_of(thresholds) if l is None else l
    if pairs is None:
        adm = _admitted(nq, nk, causal, window, q_offset)
        pairs = g * sum(a if l is None else min(l, a) for a in adm)
    rows_read = gk * nk if rows_read is None else rows_read
    moved = (_nb(q, codes_q, codes_k, thresholds) + _nb(q)
             + 2 * rows_read * dh * k.dtype.itemsize)
    return Cost({_kind(q.dtype): 4 * dh * pairs}, moved)


# ---------------------------------------------------------- kernels 5-8
def _decode_sel(g, r, s, l, sum_rows, live, pairs, rows_read):
    """(live slots, selected (row, slot) pairs of the R_out selection
    rows, K/V rows read) with their static defaults."""
    r_out = 1 if sum_rows else r
    live = g * s if live is None else live
    if pairs is None:
        pairs = g * r_out * (s if l is None else min(l, s))
    if rows_read is None:
        rows_read = g * (s if l is None else min(s, r_out * l))
    return live, pairs, rows_read


def _part(g, s, r, dh) -> int:
    """The per-split partial softmaxes, (G, ns, R, dh + 2) f32."""
    return g * _splits(g, s) * r * (dh + 2) * 4


def _attn_ops(q, pairs, r, sum_rows) -> Dict[str, int]:
    dh = q.shape[-1]
    return {_kind(q.dtype): 4 * dh * pairs * (r if sum_rows else 1)}


def sparse_decode_attention(q, k, v, codes_q, codes_k, thresholds, kv_valid,
                            *, scale: float, sum_rows: bool,
                            heads_per_batch: int, return_lse: bool = False,
                            l: Optional[int] = None,
                            live: Optional[int] = None,
                            pairs: Optional[int] = None,
                            rows_read: Optional[int] = None) -> Cost:
    """Kernel 5: the live code rows, the selected K/V rows, q, thresholds
    and mask read, the output (and with ``return_lse`` each row's f32
    log-sum-exp) written; ties and partials scratch.  ``l`` as kernel 4's:
    by default the thresholds' budget."""
    g, r, dh = q.shape
    l = budget_of(thresholds) if l is None else l
    s, m = k.shape[1], codes_q.shape[-1]
    live, pairs, rows_read = _decode_sel(g, r, s, l, sum_rows, live, pairs,
                                         rows_read)
    r_out = 1 if sum_rows else r
    moved = (_nb(q, codes_q, thresholds, kv_valid) + live * m + _nb(q)
             + 2 * rows_read * dh * k.dtype.itemsize
             + (g * r * 4 if return_lse else 0))
    scratch = g * _splits(g, s) * r_out * 4 + _part(g, s, r, dh)
    return Cost(_attn_ops(q, pairs, r, sum_rows), moved, scratch)


def fused_sparse_decode_attention(q, k, v, codes_q, codes_k, kv_valid, *,
                                  scale: float, l: int, max_score: int,
                                  sum_rows: bool, heads_per_batch: int,
                                  return_thresholds: bool = False,
                                  live: Optional[int] = None,
                                  pairs: Optional[int] = None,
                                  rows_read: Optional[int] = None) -> Cost:
    """Kernel 6: kernel 3's reads and kernel 5's in one pass."""
    g, r, dh = q.shape
    s, m = k.shape[1], codes_q.shape[-1]
    live, pairs, rows_read = _decode_sel(g, r, s, l, sum_rows, live, pairs,
                                         rows_read)
    r_out = 1 if sum_rows else r
    moved = (_nb(q, codes_q, kv_valid) + live * m + _nb(q)
             + 2 * rows_read * dh * k.dtype.itemsize
             + (g * r_out * 2 * 4 if return_thresholds else 0))
    hist = g * _splits(g, s) * r_out * (max_score + 1) * 4
    return Cost(_attn_ops(q, pairs, r, sum_rows), moved,
                hist + _part(g, s, r, dh))


def fused_sparse_decode_attention_paged(page_table, q, k_pool, v_pool,
                                        codes_q, codes_pool, kv_valid, *,
                                        scale: float, l: int,
                                        max_score: int, sum_rows: bool,
                                        heads_per_batch: int,
                                        return_thresholds: bool = False,
                                        live: Optional[int] = None,
                                        pairs: Optional[int] = None,
                                        rows_read: Optional[int] = None
                                        ) -> Cost:
    """Kernel 7: kernel 6 over the page table's view (MP x ps slots),
    the table read once; the clamped table, histograms and partials
    scratch."""
    g, r, dh = q.shape
    b, mp = page_table.shape
    s, m = mp * k_pool.shape[2], codes_q.shape[-1]
    live, pairs, rows_read = _decode_sel(g, r, s, l, sum_rows, live, pairs,
                                         rows_read)
    r_out = 1 if sum_rows else r
    moved = (_nb(q, codes_q, page_table, kv_valid) + _nb(q) + live * m
             + 2 * rows_read * dh * k_pool.dtype.itemsize
             + (g * r_out * 2 * 4 if return_thresholds else 0))
    hist = g * _splits(g, s) * r_out * (max_score + 1) * 4
    return Cost(_attn_ops(q, pairs, r, sum_rows), moved,
                b * mp * 4 + hist + _part(g, s, r, dh))


def dense_decode_attention_paged(page_table, q, k_pool, v_pool, kv_valid, *,
                                 scale: float, heads_per_batch: int,
                                 live: Optional[int] = None) -> Cost:
    """Kernel 8: every live slot's K and V row read once, 4 dh operations
    per (query row, live slot)."""
    g, r, dh = q.shape
    b, mp = page_table.shape
    s = mp * k_pool.shape[2]
    live = g * s if live is None else live
    moved = (_nb(q, page_table, kv_valid) + _nb(q)
             + 2 * live * dh * k_pool.dtype.itemsize)
    return Cost({_kind(q.dtype): 4 * dh * r * live}, moved,
                b * mp * 4 + _part(g, s, r, dh))


# ---------------------------------------------------------- kernels 9, 10
_LORA = (("lora_inner", "b"), ("lora_inner", "c"), ("lora_gate", "b"),
         ("lora_gate", "c"), ("lora_outer", "b"), ("lora_outer", "c"))


def _lora(lora_params, gated: bool):
    """The LoRA leaves the kernels read (gate's only when gated) and the
    rank (0 without LoRA)."""
    if lora_params is None:
        return [], 0
    ts = [lora_params[a][b] for a, b in _LORA
          if gated or a != "lora_gate"]
    return ts, ts[0].shape[-1]


def _padded_copies(ts, r: int, multiple: int, dtype) -> int:
    """Bytes of the LoRA copies a wrapper makes: the rank padded to a
    multiple of ``multiple`` and cast to ``dtype`` (none when neither
    changes a leaf)."""
    pad = -r % multiple
    if not pad and dtype == torch.float32:
        return 0
    return sum(math.prod(t.shape) // r * (r + pad) * dtype.itemsize
               for t in ts)


# the bf16 body of kernel 9 (csrc/grouped_ffn.cu): its x and h tiles stay
# in a block's shared memory while this fits; past it the wide form keeps
# h (B, G, C, F) in device memory between its two kernels
_SMEM, _ALIGN, _TILE, _STAGES, _STAGE, _TM, _HC = (232448, 1024, 8192, 3,
                                                   16384, 64, 128)


def grouped_ffn_h_elems(dtype, d: int, f: int) -> int:
    """Elements of h scratch per capacity slot kernel 9 needs: F where
    its bf16 body takes the wide form, else 0 (``repro_grouped_ffn_h_
    elems`` of csrc/grouped_ffn.cu, restated)."""
    if dtype != torch.bfloat16:
        return 0
    nkt, nht = -(-d // 64), 2 * -(-f // _HC)
    smem = _ALIGN + (nkt + nht) * _TILE + _STAGES * _STAGE + _TM * 4
    return f if smem > _SMEM else 0


def grouped_ffn(x, index, w_inner, w_outer, w_gate=None, lora_params=None,
                lora_scale: float = 1.0, *, act: str = "relu",
                kept: Optional[int] = None) -> Cost:
    """kept: capacity slots that hold a token (default every slot).  Per
    kept slot the up (and gate) and down products and the LoRA terms;
    x, the plan, every group's weights and the LoRA leaves read once,
    (B, G, C, d) written."""
    b, s, d = x.shape
    _, g, c = index.shape
    f = w_inner.shape[-1]
    gated = w_gate is not None
    ts, r = _lora(lora_params, gated)
    kept = b * g * c if kept is None else kept
    per = (2 * d * f * 3 + 2 * r * (3 * d + 2 * f + d) if gated
           else 2 * d * f * 2 + 2 * r * (2 * d + 2 * f))
    moved = (_nb(x, index, w_inner, w_outer, w_gate, *ts)
             + b * g * c * d * x.dtype.itemsize)
    bf16 = x.dtype == torch.bfloat16
    scratch = (b * g * c * grouped_ffn_h_elems(x.dtype, d, f)
               * x.dtype.itemsize
               + _padded_copies(ts, r, 8 if bf16 else 1, x.dtype))
    return Cost({_kind(x.dtype): kept * per}, moved, scratch)


def decode_ffn(x, choice, gate, w_inner, w_outer, w_gate=None,
               lora_params=None, lora_scale: float = 1.0, *,
               act: str = "relu", blocks: Optional[int] = None) -> Cost:
    """blocks: distinct groups the slots chose (default min(G, B G')).
    Each chosen group's weight blocks read once, the LoRA leaves, x and
    the choices read, (B, d) written; the products per (slot, choice)."""
    b, d = x.shape
    ga = choice.shape[1]
    g, _, f = w_inner.shape
    gated = w_gate is not None
    mats = 3 if gated else 2
    ts, r = _lora(lora_params, gated)
    blocks = min(g, b * ga) if blocks is None else blocks
    moved = (blocks * mats * d * f * x.dtype.itemsize + _nb(*ts)
             + _nb(x, choice, gate) + b * d * x.dtype.itemsize)
    rp = r + -r % 4
    scratch = ((b * ga * (f + d) + -(-d // 64) * b * ga * rp) * 4
               + _padded_copies(ts, r, 4, torch.float32))
    return Cost({_kind(x.dtype): b * ga * 2 * d * f * mats}, moved, scratch)


def counted(name: str):
    """Decorator of the kernel wrapper ``name``: under an active roofline
    counter the call records this module's cost function of the same
    name and runs uncounted (the counter registers its outputs and the
    scratch), and thresholds it makes carry their budget to kernel 4 or
    5's count; otherwise one global check."""
    cost_of = globals()[name]
    makes_thresholds = name in _MAKE_THRESHOLDS

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            counter = ACTIVE
            if counter is None:
                return fn(*args, **kw)
            out = counter.kernel(name, cost_of(*args, **kw), fn, args, kw)
            if makes_thresholds:
                _note_budget(out[0] if isinstance(out, tuple) else out,
                             kw["l"])
            return out
        return wrapper
    return deco
