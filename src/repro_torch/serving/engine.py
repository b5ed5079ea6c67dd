"""Continuous-batching serving engine over decode slots (port of the JAX
``serving/engine.py`` burst path).

  * Requests queue up and are admitted into free slots as they open.
    Admission is batched: as many queued requests as there are free
    slots go through ONE ragged prefill, right-padded to a (Bp, S)
    power-of-two bucket (per-row lengths reach the sparse-MHA budgets and
    routed-FFN capacities, so every row equals its exact-length prefill),
    and all resulting cache rows are copied into their slots at once; the
    copy replaces whole rows, which recycles the slot.
  * Decode runs in chunks of ``decode_chunk`` steps: a plain loop of
    device work with per-slot positions that syncs to the host once per
    chunk (the JAX engine compiles the chunk as a lax.while_loop).
    Greedy decoding; a slot retires on EOS or on its token budget.
  * With ``SPTConfig.kv_layout="paged"`` the attention caches are pools
    of fixed-size pages shared by the slots (serving/kv_pages.py), the
    allocator state and page table living on the device.  Admission
    reserves each request's worst-case page count up front: a request
    that does not fit the pool's unreserved pages waits (counted in
    ``admission_stalls``, once per scheduling iteration) without blocking
    later requests that fit, and one larger than the whole pool is
    rejected.  A group's pages come from one ``alloc_rows_pages`` and its
    prefill rows land in one paged write; decode grows a slot by one page
    inside the chunk, on the device, when it writes the first row of a
    new page (the reservation makes that allocation infallible); retire
    frees the slot's pages.
  * Each decode step goes through the CUDA kernels when the config
    selects them (core/dispatch.py): the sparse decode attention (fused,
    or two-pass; paged: read through the page table, sparse or dense) and
    the block-gather routed FFN; the prefill's routed FFN runs the
    grouped-FFN kernel.
Timing is split into prefill and decode, each ended by a host sync.
Not ported yet: preemption, arrivals over time, sampling and telemetry.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch
from repro_torch.models import transformer
from repro_torch.serving import kv_pages as kvp


@dataclasses.dataclass
class Request:
    """One generation request."""
    uid: int
    tokens: Sequence[int]                  # prompt token ids
    max_new_tokens: int = 16


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]                      # generated ids (EOS included)
    finish_reason: str                     # "eos" | "length" | "rejected"
    prompt_len: int
    detail: str = ""                       # reject reason, else ""


@dataclasses.dataclass
class ServeStats:
    """Wall-clock split of one ``Engine.run`` (host-synced boundaries)."""
    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_tokens: int = 0                # prompt tokens processed
    decode_tokens: int = 0                 # tokens produced by decode steps
    decode_steps: int = 0                  # batch-wide decode steps run
    admitted: int = 0
    completed: int = 0
    prefill_batches: int = 0               # ragged prefill calls issued
    ttft_s_sum: float = 0.0                # over admitted requests of
    ttft_s_max: float = 0.0                # (first token ready - run start)
    # paged KV cache (zeros when kv_layout="contiguous")
    page_size: int = 0
    kv_pages_total: int = 0                # pool capacity in pages
    kv_pages_peak: int = 0                 # peak pages in use
    admission_stalls: int = 0              # free slot but no pages

    @property
    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / self.prefill_s if self.prefill_s else 0.0

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def ttft_avg_s(self) -> float:
        return self.ttft_s_sum / self.admitted if self.admitted else 0.0

    def as_dict(self) -> Dict[str, float]:
        out = dataclasses.asdict(self)
        out.update(prefill_tok_s=self.prefill_tok_s,
                   decode_tok_s=self.decode_tok_s,
                   ttft_avg_s=self.ttft_avg_s)
        return out


@dataclasses.dataclass
class _State:
    """Mutable state of one run(): host mirrors of the per-slot decode
    state, the caches (and, paged, the page table and allocator state)
    on the device, and the queue."""
    stats: ServeStats
    eos_id: Optional[int]
    max_gen: int
    caches: Any
    page_table: Optional[torch.Tensor]
    astate: Optional[Dict[str, torch.Tensor]]
    reserved: int                          # worst-case pages of live slots
    slot_ws: List[int]
    tok: np.ndarray
    pos: np.ndarray
    active: np.ndarray
    n_gen: np.ndarray
    limit: np.ndarray
    buf: np.ndarray
    slot_item: List[Optional[tuple]]       # (order, Request) per slot
    queue: List[tuple]
    results: Dict[int, Completion]
    t0: float


class Engine:
    """Continuous-batching engine over ``num_slots`` decode slots.

    model: a ``transformer.LM`` on ``device`` (CUDA unless the caller
    asks for the CPU; without a card that request raises).  kv_pages:
    the page pool of the paged layout, by default the contiguous
    footprint (``num_slots * ceil(max_len / page_size)``); pass fewer to
    serve under a fixed cache budget."""

    def __init__(self, cfg: ModelConfig, model: transformer.LM,
                 max_len: int = 512, *, num_slots: int = 8,
                 eos_id: Optional[int] = None, decode_chunk: int = 16,
                 kv_pages: Optional[int] = None, device="cuda"):
        self.device = transformer.resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.max_len = max_len
        self.num_slots = num_slots
        self.eos_id = eos_id
        self.decode_chunk = max(1, decode_chunk)
        self.last_stats: Optional[ServeStats] = None
        self._paged = (dispatch.use_paged_kv(cfg)
                       and transformer.paged_applicable(cfg))
        self.page_size = cfg.spt.kv_page_size if self._paged else 0
        if self._paged:
            self.max_pages_per_slot = kvp.num_pages(max_len, self.page_size)
            self.kv_pages = (num_slots * self.max_pages_per_slot
                             if kv_pages is None else int(kv_pages))
        else:
            self.kv_pages = 0

    # ------------------------------------------------------------ prefill
    def _pad_len(self, n: int) -> int:
        """Prompt-length bucket: right-pad to a power of two (>= 8, capped
        at max_len); cache slots past the real length are invalidated."""
        p = 8
        while p < max(1, n):
            p <<= 1
        return max(n, min(p, self.max_len))

    @staticmethod
    def _pad_rows(n: int) -> int:
        """Row-count bucket (power of two)."""
        p = 1
        while p < n:
            p <<= 1
        return p

    def _prefill_group(self, group: Sequence[tuple]):
        """ONE ragged prefill over an admission group; dummy rows fill the
        Bp bucket and are dropped by the slot copy.  Returns (cache rows,
        logits (Bp, 1, V), Bp)."""
        rows_toks = [list(req.tokens) for _, req in group]
        p = self._pad_len(max(len(t) for t in rows_toks))
        bpb = self._pad_rows(len(group))
        toks = np.zeros((bpb, p), np.int64)            # pad id 0
        lens = np.ones(bpb, np.int64)                  # dummies: length 1
        for i, t in enumerate(rows_toks):
            toks[i, :len(t)] = t
            lens[i] = len(t)
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        lengths = torch.as_tensor(lens, device=self.device)
        rows, logits = transformer.lm_prefill_ragged(
            self.model, self.cfg, batch, lengths, self.max_len)
        return rows, logits, bpb

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """Argmax over the full padded vocabulary, as the JAX engine takes
        it: the padded tail of the embedding holds (random) rows like any
        other, so an id >= vocab_size can win."""
        return logits.float().argmax(-1)

    def _pages_ws(self, req: Request) -> int:
        """Worst-case pages ``req`` can hold: one per page of rows
        [0, prompt + max_new - 1) (the last decode write lands at
        position prompt + max_new - 2)."""
        rows = len(req.tokens) + req.max_new_tokens - 1
        return kvp.num_pages(max(1, rows), self.page_size)

    def _form_group(self, st: _State, stalled: set) -> List[tuple]:
        """The next admission group: queued requests, in order, that have
        a free slot and (paged) a worst-case page reservation.  A request
        that does not fit the unreserved pages is skipped — it must not
        block later ones that fit — and counted as a stall once per
        scheduling iteration (``stalled`` holds this iteration's)."""
        free = st.slot_item.count(None)
        group: List[tuple] = []
        picked: List[int] = []
        group_ws = 0
        for qi, item in enumerate(st.queue):
            if len(group) == free:
                break
            if self._paged:
                ws = self._pages_ws(item[1])
                if ws > self.kv_pages - st.reserved - group_ws:
                    if item[1].uid not in stalled:
                        stalled.add(item[1].uid)
                        st.stats.admission_stalls += 1
                    continue
                group_ws += ws
            group.append(item)
            picked.append(qi)
        for qi in reversed(picked):
            del st.queue[qi]
        return group

    def _admit(self, st: _State, group: List[tuple]) -> None:
        t0 = time.perf_counter()
        rows, logits, bpb = self._prefill_group(group)
        slot_vec = np.full(bpb, -1, np.int64)
        assigned = []
        for i, item in enumerate(group):
            b = st.slot_item.index(None)
            st.slot_item[b] = item
            assigned.append(b)
            slot_vec[i] = b
        slots = torch.as_tensor(slot_vec, device=self.device)
        if self._paged:
            npages = np.zeros(bpb, np.int64)
            for i, (_, req) in enumerate(group):
                ws = self._pages_ws(req)
                st.reserved += ws
                st.slot_ws[assigned[i]] = ws
                npages[i] = kvp.num_pages(len(req.tokens), self.page_size)
            st.astate, st.page_table = kvp.alloc_rows_pages(
                st.astate, st.page_table, slots,
                torch.as_tensor(npages, device=self.device))
            transformer.write_slot_caches_paged_rows(
                st.caches, rows, slots, st.page_table, self.cfg)
        else:
            transformer.write_slot_caches_rows(st.caches, rows, slots)
        firsts = self._greedy(logits[:, -1]).tolist()  # the host sync
        now = time.perf_counter()
        st.stats.prefill_s += now - t0
        st.stats.prefill_batches += 1
        st.stats.prefill_tokens += sum(len(r.tokens) for _, r in group)
        st.stats.admitted += len(group)
        for i, (_, req) in enumerate(group):
            b = assigned[i]
            ttft = now - st.t0
            st.stats.ttft_s_sum += ttft
            st.stats.ttft_s_max = max(st.stats.ttft_s_max, ttft)
            first = firsts[i]
            st.limit[b] = req.max_new_tokens
            st.buf[b] = 0
            st.tok[b] = first
            st.pos[b] = len(req.tokens)
            st.n_gen[b] = 1
            st.buf[b, 0] = first
            done = (req.max_new_tokens <= 1
                    or (st.eos_id is not None and first == st.eos_id))
            st.active[b] = not done
            if done:
                self._retire(st, b)

    # ------------------------------------------------------------- decode
    def _decode_once(self, st: _State) -> None:
        """One decode chunk on the device; one host sync at its end."""
        act = st.active
        steps = min(self.decode_chunk,
                    int((st.limit[act] - st.n_gen[act]).max()))
        n_prev = st.n_gen.copy()
        was_active = st.active.copy()
        dev = self.device
        t0 = time.perf_counter()
        tok = torch.as_tensor(st.tok, device=dev)
        pos = torch.as_tensor(st.pos, device=dev)
        active = torch.as_tensor(st.active, device=dev)
        n = torch.as_tensor(st.n_gen, device=dev)
        limit = torch.as_tensor(st.limit, device=dev)
        buf = torch.as_tensor(st.buf, device=dev)
        bidx = torch.arange(self.num_slots, device=dev)
        ps = self.page_size
        view = (self.max_pages_per_slot * ps if self._paged
                else self.max_len)
        slot_ids = torch.arange(view, device=dev)[None, :]
        page_table, astate = st.page_table, st.astate
        for _ in range(steps):
            if self._paged:
                # grow pages in the loop: a slot writing the first row of
                # a new page pops one from the free list (admission
                # reserved the worst case, so the pop cannot fail)
                astate, pid, ok = kvp.alloc_masked(
                    astate, active & (pos % ps == 0))
                pj = torch.clamp(pos // ps, 0, page_table.shape[1] - 1)
                page_table[bidx, pj] = torch.where(ok, pid,
                                                   page_table[bidx, pj])
                transformer.reset_page_slots(st.caches, self.cfg, pid, ok)
            # slot validity from the engine's per-slot positions (and,
            # paged, the page occupancy), built once per step and shared
            # by every layer
            kv_valid = slot_ids <= pos[:, None]
            if self._paged:
                kv_valid = kv_valid & kvp.occupancy(page_table, ps)
            logits = transformer.lm_decode_step(
                self.model, self.cfg, st.caches, tok, pos, kv_valid=kv_valid,
                page_table=page_table if self._paged else None)
            nxt = self._greedy(logits[:, -1])
            col = torch.clamp(n, 0, st.max_gen - 1)
            buf[bidx, col] = torch.where(active, nxt, buf[bidx, col])
            step = active.to(n.dtype)
            n = n + step
            pos = pos + step.to(pos.dtype)
            done = n >= limit
            if st.eos_id is not None:
                done |= nxt == st.eos_id
            tok = torch.where(active, nxt, tok)
            active = active & ~done
        st.tok, st.pos, st.active, st.n_gen, st.buf = (
            t.cpu().numpy().copy() for t in (tok, pos, active, n, buf))
        st.stats.decode_s += time.perf_counter() - t0
        st.astate = astate
        self._track_peak(st)
        st.stats.decode_steps += steps
        st.stats.decode_tokens += int(st.n_gen.sum() - n_prev.sum())
        for b in range(self.num_slots):
            if st.slot_item[b] is not None and was_active[b] \
                    and not st.active[b]:
                self._retire(st, b)

    def _retire(self, st: _State, b: int) -> None:
        order, req = st.slot_item[b]
        toks = st.buf[b, :st.n_gen[b]].tolist()
        reason = ("eos" if st.eos_id is not None and toks
                  and toks[-1] == st.eos_id else "length")
        st.results[order] = Completion(uid=req.uid, tokens=toks,
                                       finish_reason=reason,
                                       prompt_len=len(req.tokens))
        st.stats.completed += 1
        st.slot_item[b] = None
        st.active[b] = False
        if self._paged:
            st.astate, st.page_table = kvp.free_slot_pages(
                st.astate, st.page_table, b)
            st.reserved -= st.slot_ws[b]
            st.slot_ws[b] = 0

    def _track_peak(self, st: _State) -> None:
        """Peak pages in use (one read of the allocator's stack top)."""
        if self._paged:
            used = self.kv_pages - int(st.astate["top"])
            st.stats.kv_pages_peak = max(st.stats.kv_pages_peak, used)

    def _validate(self, req: Request, seen: set) -> Optional[str]:
        if req.uid in seen:
            return f"duplicate request uid {req.uid}"
        if req.max_new_tokens < 1:
            return "max_new_tokens < 1"
        if not req.tokens:
            return "empty prompt"
        need = len(req.tokens) + req.max_new_tokens
        if need > self.max_len:
            return f"needs {need} positions > max_len={self.max_len}"
        if self._paged and self._pages_ws(req) > self.kv_pages:
            return (f"needs {self._pages_ws(req)} KV pages > pool size "
                    f"{self.kv_pages}")
        return None

    # ---------------------------------------------------------------- run
    def run(self, requests: Sequence[Request], *,
            eos_id: Any = "engine-default") -> List[Completion]:
        """Serve a burst of requests (any count vs. num_slots) to
        completion with greedy decoding.  Invalid requests finish as
        rejected Completions.  Returns completions in request order; the
        wall-clock split is left in ``self.last_stats``."""
        if eos_id == "engine-default":
            eos_id = self.eos_id
        slots = self.num_slots
        max_gen = max([r.max_new_tokens for r in requests] + [1])
        dev = self.device
        paged = self._paged
        st = _State(
            stats=ServeStats(page_size=self.page_size,
                             kv_pages_total=self.kv_pages),
            eos_id=eos_id, max_gen=max_gen,
            caches=transformer.init_caches(
                self.cfg, slots, self.max_len, dev,
                kv_pages=self.kv_pages if paged else None),
            page_table=(kvp.init_page_table(slots, self.max_pages_per_slot,
                                            dev) if paged else None),
            astate=kvp.init_state(self.kv_pages, dev) if paged else None,
            reserved=0, slot_ws=[0] * slots,
            tok=np.zeros(slots, np.int64), pos=np.zeros(slots, np.int64),
            active=np.zeros(slots, bool), n_gen=np.zeros(slots, np.int64),
            limit=np.ones(slots, np.int64),
            buf=np.zeros((slots, max_gen), np.int64),
            slot_item=[None] * slots, queue=[], results={},
            t0=time.perf_counter())
        seen: set = set()
        for order, req in enumerate(requests):
            why = self._validate(req, seen)
            if why is not None:
                st.results[order] = Completion(
                    uid=req.uid, tokens=[], finish_reason="rejected",
                    prompt_len=len(req.tokens), detail=why)
                continue
            seen.add(req.uid)
            st.queue.append((order, req))
        with torch.no_grad():
            while st.queue or st.active.any():
                stalled: set = set()
                while True:
                    group = self._form_group(st, stalled)
                    if not group:
                        break
                    self._admit(st, group)
                self._track_peak(st)
                if st.active.any():
                    self._decode_once(st)
        self.last_stats = st.stats
        return [st.results[i] for i in range(len(requests))]
