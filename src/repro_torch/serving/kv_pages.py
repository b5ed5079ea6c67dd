"""Paged KV cache: page allocator, slot->page tables, and paged views
(port of the JAX package's ``serving/kv_pages.py``, same functions and
semantics).

  * the **pool** replaces each attention layer's per-slot ``(B, size, ...)``
    cache with a global ``(num_pages, Hk, page_size, ...)`` tensor;
  * the **page table** ``(num_slots, max_pages)`` int32 maps each slot's
    logical page j to a physical page id (-1 = unallocated);
  * the **allocator** is a free-list stack held in device tensors
    (``{"free": (P,), "top": (), "refs": (P,)}``, int32), so page growth
    inside the engine's decode chunk needs no host sync.

Allocator functions return new state and page-table tensors, as the JAX
functions do; the pool writes (``scatter_*``) update the pool in place and
return it.  Exhaustion never corrupts state: a failed alloc returns page
id -1, and every write to a -1 id is dropped.  JAX drops such writes by
routing them out of bounds (``mode="drop"``); torch raises on (CPU) or
asserts on (CUDA) an out-of-range index, so here ``put_masked`` masks the
dropped rows explicitly and never indexes out of range.

Only torch and ints; no model imports (models/attention.py imports this).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

AllocState = Dict[str, torch.Tensor]


# ------------------------------------------------------------ shape math
def num_pages(rows: int, page_size: int) -> int:
    """Pages needed to back ``rows`` cache rows (host-side)."""
    return max(1, -(-int(rows) // int(page_size)))


def pool_pages(num_slots: int, max_len: int, page_size: int) -> int:
    """Default pool size: the contiguous layout's footprint (every slot
    could still grow to max_len)."""
    return num_slots * num_pages(max_len, page_size)


def view_len(max_len: int, page_size: int) -> int:
    """Length of the per-slot gathered view: max_pages * page_size
    (>= max_len; the overhang is never valid)."""
    return num_pages(max_len, page_size) * page_size


# ---------------------------------------------------- masked in-place put
def put_masked(dst: torch.Tensor, index: tuple, vals: torch.Tensor,
               keep: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """``dst[index] = vals`` for the kept entries only, in place, with no
    host sync and no out-of-range index.

    index: a tuple of slices and (N,) integer tensors (any may be out of
    range where ``keep`` is False); vals: the shape ``dst[index]`` has,
    with the N entries along ``axis``; keep: (N,) bool.  A dropped entry
    is sent to the first kept entry's destination with that entry's
    value, so no two writes to one place differ; with nothing kept,
    every entry writes back the value already at the first entry's
    (clamped) destination."""
    n = keep.shape[0]
    src = torch.where(keep, torch.arange(n, device=keep.device),
                      keep.to(torch.int32).argmax())
    idx = tuple(i if isinstance(i, slice)
                else i.long()[src].clamp(0, dst.shape[d] - 1)
                for d, i in enumerate(index))
    first = tuple(i if isinstance(i, slice) else i[:1] for i in idx)
    v = vals.to(dst.dtype).index_select(axis, src)
    dst[idx] = torch.where(keep.any(), v, dst[first])
    return dst


# ------------------------------------------------------------- allocator
def init_state(total_pages: int, device="cpu") -> AllocState:
    """Fresh allocator: all pages free.  ``free[0:top]`` hold the free ids
    (a stack: alloc pops from ``free[top-1]``, free pushes back); ``refs``
    counts each page's mappings (a page returns to the stack when its
    count reaches zero)."""
    return {"free": torch.arange(total_pages, dtype=torch.int32,
                                 device=device),
            "top": torch.tensor(total_pages, dtype=torch.int32,
                                device=device),
            "refs": torch.zeros(total_pages, dtype=torch.int32,
                                device=device)}


def init_page_table(num_slots: int, max_pages: int,
                    device="cpu") -> torch.Tensor:
    return torch.full((num_slots, max_pages), -1, dtype=torch.int32,
                      device=device)


def alloc_masked(state: AllocState, want: torch.Tensor
                 ) -> Tuple[AllocState, torch.Tensor, torch.Tensor]:
    """Pop one page per True entry of ``want`` (any shape, row-major
    order).  Returns (state', page_ids, ok) with page_ids == -1 (and ok
    False) where ``want`` is False or the pool is exhausted."""
    free, top = state["free"], state["top"]
    p = free.shape[0]
    w = want.to(torch.int32)
    rank = torch.cumsum(w.reshape(-1), 0).reshape(w.shape) - w
    idx = top - 1 - rank
    ok = want & (idx >= 0)
    pid = torch.where(ok, free[idx.clamp(0, p - 1).long()],
                      torch.full_like(idx, -1)).to(torch.int32)
    new_top = (top - ok.to(torch.int32).sum()).to(torch.int32)
    refs = put_masked(state["refs"].clone(), (pid.reshape(-1),),
                      torch.ones(pid.numel(), dtype=torch.int32,
                                 device=pid.device), ok.reshape(-1))
    return {"free": free, "top": new_top, "refs": refs}, pid, ok


def alloc_slot_pages(state: AllocState, page_table: torch.Tensor, slot,
                     n) -> Tuple[AllocState, torch.Tensor]:
    """Allocate the first ``n`` pages of ``slot``'s row, replacing the
    whole row (so a recycled slot starts clean)."""
    mp = page_table.shape[1]
    want = (torch.arange(mp, device=page_table.device)
            < torch.as_tensor(n, device=page_table.device))
    state, pid, _ = alloc_masked(state, want)
    page_table = page_table.clone()
    page_table[slot] = pid
    return state, page_table


def alloc_rows_pages(state: AllocState, page_table: torch.Tensor,
                     slots: torch.Tensor, npages: torch.Tensor
                     ) -> Tuple[AllocState, torch.Tensor]:
    """Group admission: allocate the first ``npages[i]`` pages for each
    row of a batched prefill in one call (slots (Bp,), -1 = bucket-pad
    dummy row: nothing allocated, its page-table write dropped).  Each
    real slot's row is replaced wholesale."""
    mp = page_table.shape[1]
    dev = page_table.device
    slots = slots.to(dev)
    want = ((torch.arange(mp, device=dev)[None, :]
             < npages.to(dev)[:, None]) & (slots >= 0)[:, None])
    state, pid, _ = alloc_masked(state, want)
    page_table = put_masked(page_table.clone(), (slots,), pid, slots >= 0)
    return state, page_table


def free_slot_pages(state: AllocState, page_table: torch.Tensor, slot
                    ) -> Tuple[AllocState, torch.Tensor]:
    """Drop one reference on each of ``slot``'s pages, push the pages
    whose count reaches zero back on the free stack, and clear the slot's
    page-table row (the engine's retire path)."""
    free, top, refs = state["free"], state["top"], state["refs"]
    p = free.shape[0]
    row = page_table[slot]                                # (MP,)
    valid = row >= 0
    rc = row.clamp(0, p - 1).long()
    refs = refs.clone()
    refs.index_put_((rc,), torch.where(valid, -1, 0).to(refs.dtype),
                    accumulate=True)
    reclaim = valid & (refs[rc] <= 0)
    v = reclaim.to(torch.int32)
    rank = torch.cumsum(v, 0) - v
    free = put_masked(free.clone(), (top + rank,), row, reclaim)
    top = (top + v.sum()).to(torch.int32)
    refs = refs.clamp(min=0)
    page_table = page_table.clone()
    page_table[slot] = -1
    return {"free": free, "top": top, "refs": refs}, page_table


def add_ref(state: AllocState, pages: torch.Tensor) -> AllocState:
    """Bump the reference count of ``pages`` (any shape; -1 ignored)."""
    p = state["free"].shape[0]
    flat = pages.reshape(-1)
    refs = state["refs"].clone()
    refs.index_put_((flat.clamp(0, p - 1).long(),),
                    (flat >= 0).to(refs.dtype), accumulate=True)
    return {"free": state["free"], "top": state["top"], "refs": refs}


def pages_in_use(state: AllocState) -> torch.Tensor:
    return state["free"].shape[0] - state["top"]


# ----------------------------------------------------------- paged views
def gather_pages(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Per-slot contiguous views of a page pool: pool (P, Hk, ps, X) ->
    (B, Hk, MP*ps, X); pool (P, ps) -> (B, MP*ps).  Unallocated entries
    (-1) read page 0: callers mask those rows (``occupancy``)."""
    g = pool[page_table.clamp(min=0).long()]              # (B, MP, ...)
    if pool.dim() == 2:
        b, mp, ps = g.shape
        return g.reshape(b, mp * ps)
    b, mp, hk, ps, x = g.shape
    return g.transpose(1, 2).reshape(b, hk, mp * ps, x)


def occupancy(page_table: torch.Tensor, page_size: int) -> torch.Tensor:
    """(B, MP*ps) bool: view row is backed by an allocated page."""
    b, mp = page_table.shape
    return (page_table >= 0)[:, :, None].expand(b, mp, page_size).reshape(
        b, mp * page_size)


def scatter_row(pool: torch.Tensor, page_table: torch.Tensor,
                pos: torch.Tensor, val, page_size: int) -> torch.Tensor:
    """Write one row per slot at absolute position ``pos`` (B,), in place.
    pool (P, Hk, ps, X) takes val (B, Hk, X); pool (P, ps) takes val (B,)
    (or a broadcastable value).  Rows whose page is unallocated are
    dropped."""
    b, mp = page_table.shape
    pos = pos.long()
    pj = pos // page_size
    row = pos % page_size
    pid = page_table.gather(1, pj.clamp(0, mp - 1)[:, None])[:, 0]
    keep = (pid >= 0) & (pj < mp)
    val = torch.as_tensor(val, device=pool.device)
    if pool.dim() == 2:
        return put_masked(pool, (pid, row), val.expand(b), keep)
    return put_masked(pool, (pid, slice(None), row),
                      val.expand(b, *pool.shape[1:2], *pool.shape[3:]),
                      keep)


def scatter_prefill_rows(pool: torch.Tensor, page_tables: torch.Tensor,
                         seqs: torch.Tensor, page_size: int,
                         pad_value=0) -> torch.Tensor:
    """Write every row of a prefill group into its pages, in place.
    pool (P, Hk, ps, X) takes seqs (B, Hk, L, X); pool (P, ps) takes seqs
    (B, L).  L is padded (``pad_value``) to a page multiple; pages with a
    -1 id (bucketed-pad overhang, or a dummy row's all -1) are dropped.
    Page ids are unique across rows, so destinations never conflict."""
    ps = page_size
    l = seqs.shape[-2] if pool.dim() == 4 else seqs.shape[-1]
    npg = num_pages(l, ps)
    pad = npg * ps - l
    ids = page_tables[:, :npg].reshape(-1)                # (B * npg,)
    if pool.dim() == 2:
        rows = torch.nn.functional.pad(seqs, (0, pad), value=pad_value)
        return put_masked(pool, (ids,), rows.reshape(-1, ps), ids >= 0)
    b, hk, _, x = seqs.shape
    rows = torch.nn.functional.pad(seqs, (0, 0, 0, pad))
    rows = rows.reshape(b, hk, npg, ps, x).transpose(1, 2)
    return put_masked(pool, (ids,), rows.reshape(b * npg, hk, ps, x),
                      ids >= 0)


def scatter_prefill(pool: torch.Tensor, page_table_row: torch.Tensor,
                    seq: torch.Tensor, page_size: int,
                    pad_value=0) -> torch.Tensor:
    """One prefill row into its slot's pages: pool (P, Hk, ps, X) takes
    seq (Hk, L, X); pool (P, ps) takes seq (L,)."""
    return scatter_prefill_rows(pool, page_table_row[None], seq[None],
                                page_size, pad_value)


# ------------------------------------------------------ memory accounting
def kv_row_bytes(cfg) -> int:
    """Bytes of attention-cache state per cache row per slot, summed over
    the layers the paged layout covers (attention blocks without a SWA
    ring): K + V + slot_pos, plus int8 PQ codes under sparse MHA.
      contiguous bytes = num_slots * max_len * kv_row_bytes
      paged bytes      = num_pages * page_size * kv_row_bytes
    cfg is a ModelConfig (duck-typed)."""
    if cfg.window is not None:
        return 0
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if cfg.pattern[i % len(cfg.pattern)] == "attn")
    if n_attn == 0:
        return 0
    hk, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    per_row = 2 * hk * hd * itemsize + 4
    spt = cfg.spt
    if spt.sparse_mha and hd % spt.pq_code_dim == 0:
        per_row += hk * (hd // spt.pq_code_dim)
    return n_attn * per_row
