"""Layer 5: memory-lifetime reports of the hot entrypoints (the JAX
package's ``analysis/liveness.py``).

JAX derives liveness from a backward pass over the jaxpr.  The port runs
the entrypoint instead (op_audit's runs) under ``op_audit.OpLog``, which
counts a storage's bytes from the op that creates it to the weakref
finalizer that fires when its last reference dies, so the live set is
the one the allocator sees.  The residency model:

  * the entrypoint's arguments are pinned: the caller holds them for the
    whole call (parameters, caches, the page table), counted once apart
    (``arg_bytes``);
  * a cache written by ``index_put_`` / ``copy_`` / ``masked_fill_`` into
    its own storage counts once: an in-place write allocates nothing, and
    the bytes of the argument storages an op wrote are reported as
    **bytes updated in place** (JAX: donated bytes);
  * a kernel wrapper's outputs count from its call, and its scratch
    exactly as ``kernels/cost.py`` states it while it runs (on the CPU
    its plain version runs uncounted);
  * the peak is arguments + the most temporaries live at once.

Each report has a **waterfall** (live temporaries after every op), the
**top contributors** at the peak (op and source line, or a scratch) and
the **memory signature** that ``baselines.py`` ratchets: peak live
bytes, bytes updated in place, aten op count and kernel calls.

Rules: ``liveness.trace-failure`` (the entrypoint raised),
``liveness.empty`` (no resident bytes), ``liveness.inplace-unused``
(JAX: liveness.donation-unused; an entrypoint that should update its
caches in place reported no bytes updated in place).  JAX's while-carry
copy surcharge and scan residency have no counterpart: the port's loops
run in Python, and every iteration's allocations are seen as they happen.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis import op_audit
from repro_torch.analysis.op_audit import Contributor, OpLog
from repro_torch.analysis.registry import Violation, audit


@dataclasses.dataclass(frozen=True)
class MemorySignature:
    peak_live_bytes: int
    inplace_bytes: int
    ops: int
    kernel_calls: int


@dataclasses.dataclass(frozen=True)
class MemoryReport:
    entry: str
    signature: MemorySignature
    timeline: Tuple[Tuple[str, int], ...]
    peak_at: str
    contributors: Tuple[Contributor, ...]


def report_of(entry: str, log: OpLog) -> MemoryReport:
    sig = MemorySignature(
        peak_live_bytes=log.peak_live_bytes, inplace_bytes=log.inplace_bytes,
        ops=log.aten_ops,
        kernel_calls=sum(log.kernel_calls().values()))
    return MemoryReport(entry, sig, tuple(log.timeline), log.peak_at,
                        log.peak_top)


# entrypoints whose caches the call updates in place: no bytes updated in
# place there means the in-place plumbing (or the audit's hold) broke
EXPECT_INPLACE = ("engine.decode_chunk", "engine.decode_chunk_kernels_off",
                  "engine.decode_chunk_paged")
MEMORY_ENTRYPOINTS = ("engine.decode_chunk", "engine.decode_chunk_kernels_off",
                      "engine.decode_chunk_paged", "engine.prefill_ragged",
                      "ops.sparse_mha_decode", "ops.routed_ffn_decode",
                      "models.moe_decode", "kv_pages.alloc_free")


def memory_report(name: str, device=None) -> MemoryReport:
    """The report of one entrypoint, from its memoized run."""
    if name == "kv_pages.alloc_free":
        from repro_torch.analysis import donation
        run = donation.alloc_free_run(device)
    else:
        run = op_audit.run_entry(name, device)
    return report_of(name, run.log)


def all_reports(device=None) -> Dict[str, MemoryReport]:
    return {name: memory_report(name, device) for name in MEMORY_ENTRYPOINTS}


_BLOCKS = " ▁▂▃▄▅▆▇█"


def waterfall(timeline: Sequence[Tuple[str, int]], width: int = 60) -> str:
    """Sampled sparkline of live bytes over ops (max per bucket, scaled
    to the peak)."""
    vals = [v for _, v in timeline]
    if not vals:
        return ""
    peak = max(vals) or 1
    width = min(width, len(vals))
    cells = []
    for c in range(width):
        lo = c * len(vals) // width
        hi = max(lo + 1, (c + 1) * len(vals) // width)
        frac = max(vals[lo:hi]) / peak
        cells.append(_BLOCKS[min(len(_BLOCKS) - 1,
                                 int(round(frac * (len(_BLOCKS) - 1))))])
    return "".join(cells)


def format_report(rep: MemoryReport, top_k: int = 6, width: int = 60) -> str:
    sig = rep.signature
    lines = [f"{rep.entry}: peak {sig.peak_live_bytes:,} B  in place "
             f"{sig.inplace_bytes:,} B  ops {sig.ops}  kernel calls "
             f"{sig.kernel_calls}",
             "  live |" + waterfall(rep.timeline, width) + "|",
             f"  peak at {rep.peak_at}"]
    for c in rep.contributors[:top_k]:
        lines.append(f"    {c.nbytes:>12,} B  {c.aval:<24} {c.label}")
    return "\n".join(lines)


def format_memory_report(top_k: int = 6, width: int = 60,
                         device=None) -> str:
    lines = ["memory-lifetime report (arguments pinned, in-place writes "
             "counted once, kernel scratch by kernels/cost.py; see "
             "analysis/liveness.py)"]
    for rep in all_reports(device).values():
        lines += ["", format_report(rep, top_k, width)]
    return "\n".join(lines)


def entry_violations(name: str, device=None) -> List[Violation]:
    try:
        rep = memory_report(name, device)
    except Exception as e:               # a failure to run IS the finding
        return [Violation("liveness.trace-failure", name,
                          f"{type(e).__name__}: {e}")]
    out = []
    if rep.signature.peak_live_bytes <= 0:
        out.append(Violation(
            "liveness.empty", name,
            "peak live bytes is zero — the counter saw no resident "
            "storage (run or counter bug)"))
    if name in EXPECT_INPLACE and rep.signature.inplace_bytes <= 0:
        out.append(Violation(
            "liveness.inplace-unused", name,
            "the call should write its caches in place but no argument "
            "storage was written — the in-place path (or the hold) broke"))
    return out


@audit("liveness")
def _liveness_audit() -> List[Violation]:
    out: List[Violation] = []
    for name in MEMORY_ENTRYPOINTS:
        out.extend(entry_violations(name))
    return out
