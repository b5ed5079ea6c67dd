"""Layer 6: in-place update audit of the serving calls (the JAX package's
``analysis/donation.py``, about donation there).

JAX donates a cache, pool or slot-state operand so that XLA reuses its
buffer for the output; without it every cache is paid for twice across a
call.  Eager torch has no donation: the engine writes its caches in
place (``index_put_``, ``copy_``, the masked puts of ``serving/
kv_pages.py``).  What can go wrong is the same — a refactor that builds
new caches and rebinds them, or copies one and drops it — and parity
tests cannot see it.  Across a decode chunk (contiguous and paged, the
kernel tier), an admission (the ragged prefill and its rows written into
the slots, contiguous and paged) and a page alloc/free round trip:

  donation.copied  (JAX: donation.cannot-alias) a cache or pool storage
                   the engine held before the call is not the one it
                   holds after (data pointer or storage replaced), or a
                   decode chunk built a fresh tensor of a cache's shape
                   and dtype (whole, or one layer of a stacked one): a
                   copy of the cache
  donation.grown   (JAX: donation.missing) the call's temporaries exceed
                   its declared temporaries (``declared``): a decode
                   chunk less than the caches it updates (one that built
                   new caches would hold both); an admission its ragged
                   prefill's own peak, or its rows three times over while
                   they are written (the rows, the masked put's selected
                   and guarded copies); the allocator round trip four
                   int64 copies of the allocator and page table (its
                   functions return new state, as JAX's do, through int64
                   index vectors)

JAX's ``donation.jit-site`` lint does not transfer: there is no jit.
The allocator state and the page table are replaced by the functions of
``kv_pages.py`` as JAX's are (and donated there); their bytes are
declared temporaries, not audited storages.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.analysis import op_audit
from repro_torch.analysis.op_audit import OpLog, Run
from repro_torch.analysis.registry import Violation, audit
from repro_torch.launch import roofline

CHUNK_ENTRIES = ("engine.decode_chunk", "engine.decode_chunk_paged")


def _cache_shapes(caches) -> Dict[tuple, str]:
    """(shape, dtype) of every cache tensor, and of one layer of each
    stacked one -> its path."""
    out: Dict[tuple, str] = {}

    def walk(t, path, stacked):
        if isinstance(t, torch.Tensor):
            out[(tuple(t.shape), t.dtype)] = path
            if stacked and t.dim() > 1:
                out[(tuple(t.shape[1:]), t.dtype)] = path + "[u]"
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}.{k}", stacked or k == "units")
    walk(caches, "caches", False)
    return out


def copied_violations(run: Run, chunk: bool) -> List[Violation]:
    out = []
    for path, key in run.before.items():
        now = run.after.get(path)
        if now != key:
            out.append(Violation(
                "donation.copied", run.entry,
                f"{path} was replaced by the call (storage or data pointer "
                "changed): the cache was rebuilt instead of written in "
                "place"))
    if chunk:
        shapes = _cache_shapes(run.info["caches"])
        for r in run.log.records:
            if r.kernel or not r.fresh:
                continue
            for shape, dt in zip(r.shapes, r.dtypes):
                path = shapes.get((tuple(shape), dt))
                if path is not None:
                    out.append(Violation(
                        "donation.copied", run.entry,
                        f"{r.name} builds {str(dt)[6:]}{shape}, the shape "
                        f"of {path}, at {r.site}: a copy of a cache"))
    return out


def grown_violations(run: Run, declared: int, what: str) -> List[Violation]:
    if run.log.peak > declared:
        return [Violation(
            "donation.grown", run.entry,
            f"{run.log.peak:,} B of temporaries > the declared "
            f"{declared:,} B ({what})")]
    return []


def chunk_violations(name: str, device=None) -> List[Violation]:
    run = op_audit.run_entry(name, device)
    cache_bytes = roofline.storage_bytes(run.info["caches"])
    out = copied_violations(run, chunk=True)
    out += grown_violations(run, cache_bytes, "the caches it updates")
    arun: Run = run.info["admit"]
    out += copied_violations(arun, chunk=False)
    out += grown_violations(
        arun, max(arun.info["prefill_peak"], 3 * arun.info["rows_bytes"]),
        "its ragged prefill's own peak, or its rows three times over "
        "while they are written")
    return out


def alloc_free_run(device=None) -> Run:
    """A page allocation of a group's rows and a slot's release, run
    under an OpLog with the allocator state and page table held (memoized
    per device)."""
    dev = device or op_audit.DEVICE
    key = ("kv_pages.alloc_free", dev)
    if key in op_audit._RUNS:
        return op_audit._RUNS[key]
    from repro_torch.serving import kv_pages as kvp
    slots, pages_per, pool = 4, 4, 16
    state = kvp.init_state(pool, dev)
    pt = kvp.init_page_table(slots, pages_per, dev)
    rows = torch.tensor([0, 2, -1, 3], device=dev)
    npages = torch.tensor([2, 3, 1, 4], device=dev)
    log = OpLog().hold(state, pt, rows, npages)
    with torch.no_grad(), log:
        state2, pt2 = kvp.alloc_rows_pages(state, pt, rows, npages)
        out = kvp.free_slot_pages(state2, pt2, 0)
        del state2, pt2
    log.outputs(out)
    run = Run("kv_pages.alloc_free", log,
              dict(declared=8 * roofline.storage_bytes(state, pt)))
    op_audit._RUNS[key] = run
    return run


def alloc_free_violations(device=None) -> List[Violation]:
    run = alloc_free_run(device)
    return grown_violations(run, run.info["declared"],
                            "four int64 copies of the allocator and table")


def engine_violations(device=None) -> List[Violation]:
    out: List[Violation] = []
    for name in CHUNK_ENTRIES:
        out += chunk_violations(name, device)
    return out + alloc_free_violations(device)


@audit("donation")
def _donation_audit() -> List[Violation]:
    return engine_violations()
