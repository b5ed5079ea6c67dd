"""Serving observability: bounded reservoirs, metrics snapshots, and the
host-side telemetry recorder (the port's own copy of the JAX package's
``serving/telemetry.py``; same classes, seeds and aggregates).

  * ``Reservoir`` — bounded uniform sample (Algorithm R, deterministic
    seed) with an exact running mean, so long ``serve()`` runs keep the
    TTFT / TPOT samples in bounded host memory.
  * ``MetricsSnapshot`` — a point-in-time counters/gauges/histograms
    view; ``ServeStats.as_dict`` delegates to it, and the chaos watchdog
    dumps it on invariant failures.
  * ``TelemetryRecorder`` — per-request lifecycle timelines (submit ->
    queued -> admitted/stalled -> prefill -> first token -> preempt/
    resume -> retire/shed/rejected/cancelled), per-iteration scheduler
    spans and gauges, and aggregation of the device counters (``tel_*``
    trees) the engine drains at the decode chunk's one host sync and
    after each admission prefill.

This module is engine-agnostic: it never imports ``serving.engine`` and
holds no torch tensors — the engine hands it host data (floats / numpy),
so nothing here can add a device sync to the decode loop.
"""
from __future__ import annotations

import collections
import dataclasses
import random
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np

# keep at most this many host-side span/gauge/event records; old entries
# roll off (the per-request timelines stay complete — their length is
# bounded by the request's own lifecycle, not the run's)
MAX_HOST_RECORDS = 65536


class Reservoir:
    """Bounded uniform sample over a stream (Vitter's Algorithm R).

    Deterministic for a given (cap, seed, stream): item i <= cap is kept;
    after that item i replaces a random slot with probability cap/i.  The
    mean is exact (running total over every item seen); percentiles are
    computed over the retained sample, so they carry sampling error only
    once the stream exceeds ``cap``.  API is list-compatible where the
    engine's stats code needs it (append / len / iteration / truthiness).
    """

    __slots__ = ("cap", "_rng", "_items", "n_seen", "_total")

    def __init__(self, cap: int = 2048, seed: int = 0):
        assert cap > 0
        self.cap = cap
        self._rng = random.Random(seed)
        self._items: List[float] = []
        self.n_seen = 0
        self._total = 0.0

    def append(self, x: float) -> None:
        x = float(x)
        self.n_seen += 1
        self._total += x
        if len(self._items) < self.cap:
            self._items.append(x)
        else:
            j = self._rng.randrange(self.n_seen)
            if j < self.cap:
                self._items[j] = x

    add = append

    def extend(self, xs) -> None:
        for x in xs:
            self.append(x)

    @property
    def values(self) -> List[float]:
        return list(self._items)

    @property
    def mean(self) -> float:
        return self._total / self.n_seen if self.n_seen else 0.0

    @property
    def total(self) -> float:
        return self._total

    def percentile(self, q: float) -> float:
        if not self._items:
            return 0.0
        return float(np.percentile(np.array(self._items), q))

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def __iter__(self) -> Iterator[float]:
        return iter(self._items)


@dataclasses.dataclass
class MetricsSnapshot:
    """Point-in-time metrics view: monotonic counters, instantaneous
    gauges, and histogram summaries (from bounded reservoirs).

    ``legacy_order`` preserves the exact key order `ServeStats.as_dict`
    has always produced (benchmarks and tests consume it); keys not in
    the legacy set (device-counter aggregates like ``keep_rate``) are
    appended after it, sorted, so telemetry=off output is byte-identical
    to the pre-telemetry engine.
    """

    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    gauges: Dict[str, float] = dataclasses.field(default_factory=dict)
    histograms: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    legacy_order: Tuple[str, ...] = ()

    def flat(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        out.update(self.counters)
        out.update(self.gauges)
        for name, h in self.histograms.items():
            for stat, v in h.items():
                out[f"{name}_{stat}"] = v
        return out

    def as_dict(self) -> Dict[str, Any]:
        flat = self.flat()
        d: Dict[str, Any] = {}
        for k in self.legacy_order:
            if k in flat:
                d[k] = flat[k]
        for k in sorted(flat):
            if k not in d:
                d[k] = flat[k]
        return d


# ------------------------------------------------------------- recorder
@dataclasses.dataclass
class Span:
    """One scheduler phase within a scheduling iteration."""
    name: str
    t0: float
    t1: float
    iteration: int
    args: Dict[str, float] = dataclasses.field(default_factory=dict)


class TelemetryRecorder:
    """Host-side recorder for one engine run (reset per ``serve()``).

    mode "counters" keeps only device-counter aggregation; mode "trace"
    additionally records request timelines, scheduler spans, and gauges.
    Every method takes host scalars — the engine calls them strictly at
    scheduling-iteration boundaries, never inside the decode chunk.
    """

    def __init__(self, mode: str = "trace", time_origin: float = 0.0):
        self.mode = mode
        self.trace = mode == "trace"
        self.time_origin = time_origin
        self.timelines: Dict[int, List[dict]] = {}
        self.events: Deque[dict] = collections.deque(maxlen=MAX_HOST_RECORDS)
        self.spans: Deque[Span] = collections.deque(maxlen=MAX_HOST_RECORDS)
        self.gauge_tracks: Dict[str, Deque[Tuple[float, float]]] = {}
        # device-counter accumulators (all host floats / numpy)
        self.attn_kept = 0.0
        self.attn_elig = 0.0
        self.expert_load: Optional[np.ndarray] = None
        self.expert_dropped = 0.0
        self.pages_allocated = 0.0
        self.sampled_tokens = 0.0
        self.counted_decode_tokens = 0.0
        self.counter_drains = 0

    # ---------------------------------------------------- trace events
    def event(self, uid: Optional[int], name: str, t: float, **fields
              ) -> None:
        """One lifecycle event.  uid None = scheduler-lane instant."""
        if not self.trace:
            return
        ev = {"t": float(t), "uid": uid, "event": name}
        if fields:
            ev.update(fields)
        if uid is not None:
            self.timelines.setdefault(uid, []).append(ev)
        self.events.append(ev)

    def span(self, name: str, t0: float, t1: float, iteration: int,
             **args) -> None:
        if not self.trace:
            return
        self.spans.append(Span(name, float(t0), float(t1), iteration,
                               {k: float(v) for k, v in args.items()}))

    def gauge(self, name: str, t: float, value: float) -> None:
        if not self.trace:
            return
        track = self.gauge_tracks.setdefault(
            name, collections.deque(maxlen=MAX_HOST_RECORDS))
        track.append((float(t), float(value)))

    def recent_events(self, n: int = 50) -> List[dict]:
        evs = list(self.events)
        return evs[-n:]

    def timeline(self, uid: int) -> List[dict]:
        return list(self.timelines.get(uid, ()))

    # ------------------------------------------------- device counters
    def drain_counters(self, ctr: Optional[Dict[str, Any]]) -> None:
        """Fold one host-fetched counter tree (numpy leaves) into the run
        accumulators.  Called once per decode chunk and once per admission
        prefill with the tree the device accumulated."""
        if not ctr:
            return
        self.counter_drains += 1
        for k, v in ctr.items():
            a = np.array(v, dtype=np.float64)
            if k == "tel_attn_kept":
                self.attn_kept += float(a.sum())
            elif k == "tel_attn_elig":
                self.attn_elig += float(a.sum())
            elif k == "tel_expert_load":
                per = a.reshape(-1, a.shape[-1]).sum(axis=0)   # (G,)
                if self.expert_load is None:
                    self.expert_load = per
                else:
                    self.expert_load = self.expert_load + per
            elif k == "tel_expert_drop":
                self.expert_dropped += float(a.sum())
            elif k == "pages_allocated":
                self.pages_allocated += float(a.sum())
            elif k == "sampled_tokens":
                self.sampled_tokens += float(a.sum())
            elif k == "decode_tokens":
                self.counted_decode_tokens += float(a.sum())

    @staticmethod
    def merge_ranks(parts: List[Dict[str, Any]], slots: int
                    ) -> Dict[str, np.ndarray]:
        """One counter tree from every data rank's (``parts``, in rank
        order, each over its ``slots`` slots), as the world of one would
        have drained it: a per-slot leaf (its dim 1 the slots) is
        concatenated over the ranks, every count summed, and the expert
        drop fraction averaged: each rank's is over the (token, choice)
        pairs of its ``slots`` rows, as many on every rank, so the mean is
        the dropped pairs summed over the ranks divided by all of theirs.
        So every counter equals the world of one's."""
        out: Dict[str, np.ndarray] = {}
        for k in parts[0]:
            vals = [np.asarray(p[k]) for p in parts]
            if vals[0].ndim >= 2 and vals[0].shape[1] == slots:
                out[k] = np.concatenate(vals, axis=1)
            elif k == "tel_expert_drop":
                out[k] = sum(vals) / len(vals)
            else:
                out[k] = sum(vals)
        return out

    def device_aggregates(self) -> Dict[str, float]:
        """Run-level aggregates of the drained device counters — merged
        into ``ServeStats.as_dict`` (only when telemetry is on, so the
        off-mode dict stays byte-identical to the legacy engine)."""
        out: Dict[str, float] = {}
        if self.attn_elig > 0:
            out["keep_rate"] = round(self.attn_kept / self.attn_elig, 4)
        if self.expert_load is not None:
            total = float(self.expert_load.sum())
            mean = total / self.expert_load.size
            if mean > 0:
                out["expert_load_imbalance"] = round(
                    float(self.expert_load.max()) / mean, 3)
            out["expert_tokens_routed"] = total
            out["expert_dropped"] = round(self.expert_dropped, 1)
        if self.pages_allocated:
            out["pages_allocated_in_loop"] = self.pages_allocated
        if self.sampled_tokens:
            out["sampled_tokens"] = self.sampled_tokens
        if self.counted_decode_tokens:
            out["counted_decode_tokens"] = self.counted_decode_tokens
        return out

    def expert_load_vector(self) -> Optional[List[float]]:
        if self.expert_load is None:
            return None
        return [float(x) for x in self.expert_load]
