"""Fault-injection and invariant harness for the long-lived serving loop
(the port's own copy of the JAX package's ``serving/chaos.py``: the same
invariants, injector, seeds and report).

* ``check_invariants(engine)`` — snapshot the live scheduler state and
  return every violated invariant (slot leaks, page-conservation breaks,
  double completions, stale reservations).  Empty list == healthy.
* ``Watchdog`` — an ``on_iteration`` hook that asserts the invariants
  after EVERY scheduling iteration, so a leak is caught at the iteration
  that introduced it.
* ``ChaosMonkey`` — a seeded ``on_iteration`` injector: mid-stream
  cancels, forced preemptions, duplicate-uid and oversized submissions
  (rejection isolation), and page-pool "hog" requests that force
  admission stalls and pressure preemption.
* ``run_soak(engine, requests, ...)`` — all of the above on a Poisson
  arrival schedule and a ManualClock; returns the completions and a
  report of what was injected and observed.

``python -m repro_torch.serving.chaos [--device cpu]`` runs a short
fixed-seed soak on the smoke config and exits non-zero on any invariant
violation or lost request.
"""
from __future__ import annotations

import collections
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.engine import (ArrivalSchedule, Engine, ManualClock,
                                        Request)

__all__ = ["check_invariants", "Watchdog", "ChaosMonkey", "compose",
           "run_soak"]


# ------------------------------------------------------------ invariants
def check_invariants(eng: Engine) -> List[str]:
    """Every violated scheduler/allocator invariant, as readable strings
    (empty == healthy).  Safe from an ``on_iteration`` hook: it reads the
    live ``_SchedState`` and, for paged engines, copies the allocator
    state and page table to the host once per call."""
    st = eng._live
    bad: List[str] = []
    if st is None:
        return bad
    occ = {b for b, s in enumerate(st.slot_item) if s is not None}
    for b in range(eng.num_slots):
        if st.active[b] and b not in occ:
            bad.append(f"slot {b} active without a request (slot leak)")
    live = {it.order for it in st.queue}
    for b in occ:
        live.add(st.slot_item[b].order)
    for o in sorted(live & set(st.results)):
        bad.append(f"request order {o} is both live and completed")
    if not eng._paged:
        return bad

    free, top, refs, ptab = (t.cpu().numpy() for t in (
        st.astate["free"], st.astate["top"], st.astate["refs"],
        st.page_table))
    top = int(top)
    total = eng.kv_pages
    in_use = int((refs > 0).sum())
    if top + in_use != total:
        bad.append(f"page conservation broken: free {top} + in-use "
                   f"{in_use} != pool {total}")
    flist = free[:top].tolist()
    if len(set(flist)) != top:
        bad.append("free list holds duplicate page ids")
    if top and (refs[free[:top]] > 0).any():
        bad.append("page on the free list still referenced")
    mapped: dict = {}
    for b in range(eng.num_slots):
        row = ptab[b]
        pids = row[row >= 0].tolist()
        if b not in occ and pids:
            bad.append(f"slot {b} freed but page-table row non-empty "
                       f"(page leak)")
        for p in pids:
            if refs[p] < 1:
                bad.append(f"slot {b} maps page {p} with refcount "
                           f"{int(refs[p])}")
            mapped.setdefault(p, []).append(b)
    for p, slots_ in sorted(mapped.items()):
        if len(slots_) > 1:
            bad.append(f"page {p} mapped by slots {slots_} (the serve "
                       f"loop never shares pages)")
    overlap = sorted(set(mapped) & set(flist))
    if overlap:
        bad.append(f"pages both free and mapped: {overlap[:4]}")
    leaked = sorted(p for p in np.flatnonzero(refs > 0).tolist()
                    if p not in mapped)
    if leaked:
        bad.append(f"pages referenced but mapped by no slot (leak): "
                   f"{leaked[:4]}")
    if sum(st.slot_ws) != st.reserved:
        bad.append(f"reservation ledger broken: sum(slot_ws)="
                   f"{sum(st.slot_ws)} != reserved={st.reserved}")
    for b in range(eng.num_slots):
        if b not in occ and st.slot_ws[b]:
            bad.append(f"slot {b} holds {st.slot_ws[b]} reserved pages "
                       f"after release")
    return bad


class Watchdog:
    """``on_iteration`` hook asserting the scheduler/allocator invariants
    after every scheduling iteration.  With telemetry on, a trip also
    dumps the metrics snapshot and the last ``dump_events`` lifecycle
    events to stderr."""

    def __init__(self, dump_events: int = 40) -> None:
        self.iterations = 0
        self.dump_events = dump_events

    def __call__(self, eng: Engine, iteration: int) -> None:
        self.iterations += 1
        bad = check_invariants(eng)
        if bad:
            self._dump(eng, iteration, bad)
            raise AssertionError(
                f"invariant violation at iteration {iteration}: "
                + "; ".join(bad))

    def _dump(self, eng: Engine, iteration: int, bad: List[str]) -> None:
        import json
        import sys
        st = eng._live
        dump = {"iteration": iteration, "violations": bad}
        if st is not None:
            dump["metrics"] = st.stats.snapshot().as_dict()
        rec = eng.recorder
        if rec is not None:
            dump["device"] = rec.device_aggregates()
            dump["recent_events"] = rec.recent_events(self.dump_events)
        print("WATCHDOG DUMP " + json.dumps(dump, default=str),
              file=sys.stderr)


def compose(*hooks: Optional[Callable]) -> Callable:
    """Chain ``on_iteration`` hooks (injectors before the watchdog, so
    every injected fault is checked in the same iteration)."""
    def hook(eng: Engine, iteration: int) -> None:
        for h in hooks:
            if h is not None:
                h(eng, iteration)
    return hook


# -------------------------------------------------------------- injector
class ChaosMonkey:
    """Seeded fault injector, driven as an ``on_iteration`` hook.

    Per iteration it independently rolls for: cancelling a random live
    request (queued or mid-stream), force-preempting the default victim,
    re-submitting an already-seen uid (must reject), an oversized
    submission (must reject), and a low-priority page-pool "hog" whose
    worst-case reservation approaches the whole pool.
    ``force_preempt_at`` guarantees at least one successful preemption
    from that iteration on.  ``counts`` records what actually landed."""

    def __init__(self, seed: int = 0, *, cancel_p: float = 0.08,
                 preempt_p: float = 0.08, dup_p: float = 0.05,
                 oversized_p: float = 0.05, hog_p: float = 0.04,
                 force_preempt_at: Optional[int] = 3,
                 start_iteration: int = 2) -> None:
        self.rng = np.random.default_rng(seed)
        self.cancel_p = cancel_p
        self.preempt_p = preempt_p
        self.dup_p = dup_p
        self.oversized_p = oversized_p
        self.hog_p = hog_p
        self.force_preempt_at = force_preempt_at
        self.start_iteration = start_iteration
        self.counts: collections.Counter = collections.Counter()
        self._uid = 1_000_000                  # injector uid namespace

    def _fresh_uid(self) -> int:
        self._uid += 1
        return self._uid

    def __call__(self, eng: Engine, iteration: int) -> None:
        st = eng._live
        if st is None:
            return
        if (self.force_preempt_at is not None
                and iteration >= self.force_preempt_at
                and not self.counts["forced_preempt"]):
            if eng.preempt():
                self.counts["forced_preempt"] += 1
        if iteration < self.start_iteration:
            return
        now = st.clock()
        if self.rng.random() < self.cancel_p:
            uids = ([it.req.uid for it in st.queue]
                    + [s.req.uid for s in st.slot_item if s is not None])
            if uids:
                pick = uids[int(self.rng.integers(len(uids)))]
                if eng.cancel(pick):
                    self.counts["cancel"] += 1
        if self.rng.random() < self.preempt_p and eng.preempt():
            self.counts["preempt"] += 1
        if self.rng.random() < self.dup_p and st.seen_uids:
            seen = sorted(st.seen_uids)
            uid = seen[int(self.rng.integers(len(seen)))]
            eng.submit(Request(uid=uid, tokens=[1, 2], max_new_tokens=2),
                       now=now)
            self.counts["duplicate_submit"] += 1
        if self.rng.random() < self.oversized_p:
            eng.submit(Request(uid=self._fresh_uid(), tokens=[1, 2, 3],
                               max_new_tokens=eng.max_len + 1), now=now)
            self.counts["oversized_submit"] += 1
        if self.rng.random() < self.hog_p:
            budget = max(1, eng.max_len - eng.frontend - 2)
            eng.submit(Request(uid=self._fresh_uid(), tokens=[1, 2],
                               max_new_tokens=budget, priority=-1),
                       now=now)
            self.counts["hog_submit"] += 1


# ------------------------------------------------------------------ soak
def run_soak(eng: Engine, requests: Sequence[Request], *,
             seed: int = 0, rate_qps: Optional[float] = 4.0,
             monkey: Optional[ChaosMonkey] = None,
             watchdog: Optional[Watchdog] = None,
             temperature: float = 0.0,
             sample_seed: Optional[int] = None) -> Tuple[list, dict]:
    """Serve ``requests`` under chaos: Poisson arrivals (``rate_qps``
    None = one burst) on a ManualClock, with a seeded ChaosMonkey and the
    Watchdog on every scheduling iteration.  ``sample_seed`` is the
    engine's sampling seed (None = greedy).  Returns ``(completions,
    report)``; raises AssertionError the moment an invariant breaks."""
    monkey = ChaosMonkey(seed) if monkey is None else monkey
    watchdog = Watchdog() if watchdog is None else watchdog
    sched = (ArrivalSchedule.burst(list(requests)) if rate_qps is None
             else ArrivalSchedule.poisson(list(requests), rate_qps,
                                          seed=seed))
    out = eng.serve(sched, temperature=temperature, seed=sample_seed,
                    clock=ManualClock(dt=1.0 / 4.0),
                    on_iteration=compose(monkey, watchdog))
    stats = eng.last_stats
    report = {
        "iterations": watchdog.iterations,
        "injected": dict(monkey.counts),
        "completions": len(out),
        "finish_reasons": dict(collections.Counter(
            c.finish_reason for c in out)),
        "preemptions": stats.preemptions,
        "rejections": stats.rejections,
        "cancelled": stats.cancelled,
        "shed": stats.shed,
        "kv_pages_peak": stats.kv_pages_peak,
    }
    return out, report


def _main(argv=None) -> int:
    """Short fixed-seed chaos soak on the smoke config."""
    import argparse
    import json

    from repro_torch import configs
    from repro_torch.models import transformer

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-layout", default="paged",
                    choices=("contiguous", "paged"))
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto-loadable trace.json here "
                         "(turns telemetry=trace on for the soak)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch).with_spt(kv_layout=args.kv_layout,
                                                kv_page_size=16)
    if args.trace_out:
        cfg = cfg.with_spt(telemetry="trace")
    device = transformer.resolve_device(args.device)
    model = transformer.LM.init(cfg, seed=0, device=device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    tokens=rng.integers(
                        0, cfg.vocab_size, size=int(rng.integers(4, 17)),
                        dtype=np.int32).tolist(),
                    max_new_tokens=int(rng.integers(2, 9)),
                    priority=int(rng.integers(0, 3)))
            for i in range(args.requests)]
    eng = Engine(cfg, model, max_len=64, num_slots=4, decode_chunk=4,
                 kv_pages=12 if args.kv_layout == "paged" else None,
                 device=device)
    out, report = run_soak(eng, reqs, seed=args.seed)
    lost = [i for i, c in enumerate(out) if c is None]
    ok = (not lost and report["completions"] == eng.last_stats.submitted
          and report["injected"].get("forced_preempt", 0) >= 1)
    if args.trace_out:
        from repro_torch.serving import trace_export
        trace = trace_export.write_trace(eng.last_recorder, args.trace_out)
        errs = trace_export.validate_chrome_trace(trace)
        # every submitted uid (soak requests and injected ones) must own a
        # lane in the trace
        submitted = {c.uid for c in out}
        missing = sorted(submitted - trace_export.trace_uids(trace))
        report["trace_events"] = len(trace["traceEvents"])
        report["trace_schema_errors"] = errs
        report["trace_missing_uids"] = missing
        ok = ok and not errs and not missing
    report["metrics"] = eng.last_stats.snapshot().as_dict()
    print(json.dumps({"ok": ok, **report}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    import sys
    sys.exit(_main())
