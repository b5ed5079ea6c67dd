"""Serving: prefill/decode step functions and a continuous-batching engine
over decode slots (port of the JAX package's ``serving/engine.py``).

  * ``Engine.serve`` is the long-lived loop over an ``ArrivalSchedule``
    (seeded Poisson, a trace, or a burst): requests arrive as the serve
    clock (wall time, or a ``ManualClock`` that advances once per
    scheduling iteration) passes their arrival time; ``submit``,
    ``cancel`` and ``preempt`` work from inside the loop (an
    ``on_iteration`` hook reaches the live state through
    ``Engine._live``).  ``Engine.run`` is its burst wrapper.
  * Admission is by priority, then submission order.  Up to
    ``prefill_batch`` queued requests go through ONE ragged prefill,
    right-padded to a (Bp, S) power-of-two bucket (per-row lengths reach
    the sparse-MHA budgets and routed-FFN capacities, so every row equals
    its exact-length prefill), and all its cache rows are copied into
    their slots at once; the copy replaces whole rows, which recycles the
    slot.  With ``prefill_decode_ratio > 0`` and decodes in flight, an
    iteration admits at most ratio * decode_chunk * active_slots prompt
    tokens before the next decode chunk.
  * A queued request whose TTFT deadline lapses is shed; under slot or
    page pressure the head of the queue evicts strictly-lower-priority
    running requests (or, past half its deadline, deadline-free peers of
    its priority).  An evicted request keeps its tokens and re-admits by
    recompute: the prefill takes its prompt plus all but its last
    generated token, and the last becomes the pending decode input, so
    the stream continues where it stopped (exactly so in f32).
  * Decode runs in chunks of ``decode_chunk`` steps: a plain loop of
    device work with per-slot positions that syncs to the host once per
    chunk (the JAX engine compiles the chunk as a lax.while_loop).  A
    slot retires on EOS or on its token budget.  Per-request sampling
    (temperature, top-k, top-p; both truncations on the temperature-
    scaled logits, intersected) runs inside the chunk on the sampled
    slots' rows only; a run or chunk with no sampled slot takes the
    argmax alone.  A request's draws depend only on (seed, uid, token
    index) — a counter-based Gumbel draw (``categorical``) — so its
    stream does not change with its slot, its batch mates or a
    preemption.  The first token is sampled at admission.
  * With ``SPTConfig.kv_layout="paged"`` the attention caches are pools
    of fixed-size pages shared by the slots (serving/kv_pages.py), the
    allocator state and page table living on the device.  Admission
    reserves each request's worst-case page count up front: a request
    that does not fit the pool's unreserved pages waits (counted in
    ``admission_stalls``, once per scheduling iteration) without blocking
    later requests that fit, and one larger than the whole pool is
    rejected.  Decode grows a slot by one page inside the chunk, on the
    device, when it writes the first row of a new page; retire, cancel
    and preemption free the slot's pages.
  * Telemetry (``SPTConfig.telemetry``): "counters" accumulates the
    model's device counters (serving/telemetry.py) inside the chunk and
    drains them in the chunk's one host transfer (and once per admission
    prefill); "trace" also records per-request lifecycle events and
    scheduler spans (serving/trace_export.py writes them as a Chrome
    trace).  "off" adds no counter work.
  * Each decode step goes through the CUDA kernels when the config
    selects them (core/dispatch.py): the sparse decode attention (fused,
    or two-pass; paged: read through the page table, sparse or dense) and
    the block-gather routed FFN; the prefill's routed FFN runs the
    grouped-FFN kernel.
  * A frontend config (VLM) takes each request's ``frontend_embeds``
    (F, d): its F rows are prepended to the prompt, so positions, the
    prefill lengths, the cache rows and the page reservation all count
    them.  The encoder-decoder (audio) family is served by
    ``generate``'s per-token loop over models/encdec.py, as in JAX.
  * Under a mesh (``mesh=``: launch/mesh.py; every rank of the world
    runs the engine on the same requests) the slots split over the data
    axes and each sub-layer's heads or columns and the vocabulary over
    ``model`` (``transformer.ShardedLM``: each rank stores only its
    part; expert columns over ``data`` as well, gathered at use).  Each
    data rank keeps the caches (and,
    paged, a page pool of the whole size with its own allocator) of its
    own slots and computes their rows of every prefill and decode chunk;
    the scheduler is host code taken alike on every rank from the same
    inputs, so the host state stays the world-of-one state: what a chunk
    brings back (tokens, positions, flags, counters, pages in use) comes
    in ONE all-gather over data per chunk, and an admission's first
    tokens in one all-reduce.  A wall serve clock is agreed by an
    all-reduce (max) per scheduling iteration.  Slots that do not divide
    over data are replicated, as the rules fall back.
Timing is split into prefill and decode, each ended by a host sync.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core import dispatch
from repro_torch.models import encdec, transformer
from repro_torch.serving import kv_pages as kvp
from repro_torch.serving.telemetry import (MetricsSnapshot, Reservoir,
                                           TelemetryRecorder)


def build_prefill_step(cfg: ModelConfig, max_len: int):
    """prefill(model, batch) -> (caches, last-position logits): the
    non-ragged prefill of full-length prompts (``transformer.lm_prefill``,
    or ``encdec.encdec_prefill`` for the audio family)."""
    fn = (encdec.encdec_prefill if cfg.family == "audio"
          else transformer.lm_prefill)

    def prefill(model, batch):
        return fn(model, cfg, batch, max_len)
    return prefill


def build_decode_step(cfg: ModelConfig):
    """decode(model, caches, token, pos) -> (caches, logits): one token a
    row; the caches are written in place and returned."""
    fn = (encdec.encdec_decode_step if cfg.family == "audio"
          else transformer.lm_decode_step)

    def decode(model, caches, token, pos):
        return caches, fn(model, cfg, caches, token, pos)
    return decode


# ---------------------------------------------------------------- sampling
_M32 = 0xFFFFFFFF


def abstract_decode_caches(cfg: ModelConfig, batch: int, cache_len: int,
                           kv_pages: Optional[int] = None,
                           shard: Optional[transformer.ServeShard] = None):
    """The decode caches of ``batch`` slots of ``cache_len`` as meta
    tensors (shapes, no data), for a dry run (JAX:
    ``abstract_decode_caches``); under ``shard`` (``transformer.
    serve_shard``; ``cfg`` then its local config) this rank's kv heads,
    channels, SSM heads and parts of split sequences, as
    ``steps.cache_local_shapes`` places them.
    The audio family's cross caches cover ``cfg.frontend_tokens``
    frames."""
    if cfg.family == "audio":
        return encdec.init_dec_caches(cfg, batch, cache_len,
                                      cfg.frontend_tokens, "meta",
                                      shard=shard)
    return transformer.init_caches(cfg, batch, cache_len, "meta",
                                   kv_pages=kv_pages, shard=shard)


def decode_cache_axes(cfg: ModelConfig, kv_paged: bool = False):
    """Logical partition axes of the decode caches' tree (JAX's, which
    the port's serving caches keep)."""
    if cfg.family == "audio":
        return encdec.cache_axes(cfg)
    return transformer.cache_axes(cfg, kv_paged=kv_paged)


def _mix32(x):
    """A 32-bit integer hash (xorshift-multiply rounds) of ints, numpy
    arrays or int64 tensors holding values in [0, 2**32).  Multipliers
    below 2**31 keep every product below 2**63, so int64 never
    overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def request_key(seed: int, uid: int) -> int:
    """A request's sampling key: a function of (seed, uid) alone."""
    return _mix32(_mix32(int(seed) & _M32) ^ (int(uid) & _M32))


def gumbel_noise(keys: torch.Tensor, n: torch.Tensor, vocab: int
                 ) -> torch.Tensor:
    """(R, V) f32 standard Gumbel noise, row r a function of (keys[r],
    n[r]) alone: the counter-based draw of token n of the request keyed
    keys[r].  23-bit uniforms in (0, 1), exact in f32."""
    row = _mix32(keys.long() ^ _mix32(n.long() & _M32))[:, None]
    j = torch.arange(vocab, dtype=torch.long, device=keys.device)[None]
    h = _mix32(_mix32(row ^ ((j * 0x9E3779B1) & _M32)) ^ row)
    u = ((h >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def categorical(logits: torch.Tensor, keys: torch.Tensor, n: torch.Tensor
                ) -> torch.Tensor:
    """One draw per row from softmax(logits) (Gumbel-max; -inf entries are
    never drawn).  logits (R, V) f32; keys (R,) request keys; n (R,) the
    index of the token being drawn.  Returns (R,) int64."""
    return (logits + gumbel_noise(keys, n, logits.shape[-1])).argmax(-1)


def truncate(lg: torch.Tensor, temps: torch.Tensor, topks: torch.Tensor,
             topps: torch.Tensor, kmax: int, use_topp: bool) -> torch.Tensor:
    """Temperature-scaled logits with top-k and top-p truncation (-inf
    outside), the distribution a sampled row draws from.

    lg (R, V) f32 logits; temps/topks/topps (R,).  Both truncations act
    on the temperature-scaled logits and are intersected; the nucleus
    keeps a token iff the mass strictly before it in sorted order is
    below top_p, so the top-1 token always survives.  ``kmax`` (the
    largest top_k of the rows, 0 = none) and ``use_topp`` (some row has
    0 < top_p < 1) are host facts: without them the rows pay no top-k
    selection and no sort."""
    scaled = lg / temps.clamp(min=1e-6)[:, None]
    vocab = scaled.shape[-1]
    masked = scaled
    srt = None
    if use_topp:
        srt = torch.sort(scaled, dim=-1, descending=True).values
    if kmax > 0:
        top = (srt if srt is not None else
               torch.topk(scaled, min(kmax, vocab), dim=-1).values)
        kcol = (topks.long() - 1).clamp(0, top.shape[-1] - 1)[:, None]
        thr_k = top.gather(1, kcol)
        masked = torch.where((topks > 0)[:, None] & (scaled < thr_k),
                             float("-inf"), masked)
    if use_topp:
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        kcnt = ((cum - probs) < topps[:, None]).sum(-1).clamp(1, vocab)
        thr_p = srt.gather(1, (kcnt - 1)[:, None])
        on = (topps > 0.0) & (topps < 1.0)
        masked = torch.where(on[:, None] & (scaled < thr_p), float("-inf"),
                             masked)
    return masked


def sample_rows(lg: torch.Tensor, keys: torch.Tensor, n: torch.Tensor,
                temps: torch.Tensor, topks: torch.Tensor,
                topps: torch.Tensor, kmax: int, use_topp: bool
                ) -> torch.Tensor:
    """One temperature + top-k + top-p draw per sampled row (temps > 0):
    ``categorical`` over ``truncate``'s logits; keys (R,) request keys,
    n (R,) the index of the token each row draws."""
    return categorical(truncate(lg, temps, topks, topps, kmax, use_topp),
                       keys, n)


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One float64 vector of ``tensors`` (exact for the ints and f32
    counters the engine moves), on their device."""
    return torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])


def _unflat(host: np.ndarray, tensors: Sequence[torch.Tensor],
            shapes=None) -> List[np.ndarray]:
    """Split a host copy of ``_flat(tensors)`` back into arrays of their
    shapes (or ``shapes``) and kinds."""
    out, i = [], 0
    for j, t in enumerate(tensors):
        shape = t.shape if shapes is None else shapes[j]
        size = int(np.prod(shape))
        a = host[i:i + size].reshape(shape)
        i += size
        out.append(a.astype(bool) if t.dtype == torch.bool
                   else a.astype(np.int64) if not t.is_floating_point()
                   else a)
    return out


# ---------------------------------------------------------------- arrivals
class ManualClock:
    """Deterministic serve clock: ``clock()`` reads virtual time, and the
    serve loop calls ``advance()`` once per scheduling iteration, so
    arrivals, deadlines and preemptions are a function of the seed."""

    def __init__(self, dt: float = 1.0):
        self.now = 0.0
        self.dt = float(dt)

    def __call__(self) -> float:
        return self.now

    def advance(self) -> None:
        self.now += self.dt


class ArrivalSchedule:
    """An arrival process feeding ``Engine.serve``: (t_s, Request) events
    in time order, popped as the serve clock passes each arrival time.
    Build one from a Poisson process (``poisson``), an explicit trace
    (``from_trace``), or an all-at-t=0 burst (``burst``, what ``run``
    serves)."""

    def __init__(self, events: Sequence[Tuple[float, "Request"]]):
        self._events = sorted(events, key=lambda e: e[0])      # stable
        self._i = 0

    @classmethod
    def burst(cls, requests: Sequence["Request"],
              at: float = 0.0) -> "ArrivalSchedule":
        return cls([(at, r) for r in requests])

    @classmethod
    def poisson(cls, requests: Sequence["Request"], rate_qps: float,
                seed: int = 0) -> "ArrivalSchedule":
        """Seeded Poisson arrivals at ``rate_qps`` mean offered load."""
        rng = np.random.default_rng(seed)
        t, events = 0.0, []
        for r in requests:
            t += float(rng.exponential(1.0 / max(rate_qps, 1e-9)))
            events.append((t, r))
        return cls(events)

    @classmethod
    def from_trace(cls, pairs: Sequence[Tuple[float, "Request"]]
                   ) -> "ArrivalSchedule":
        return cls(list(pairs))

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self._events)

    def next_time(self) -> Optional[float]:
        return None if self.exhausted else self._events[self._i][0]

    def due(self, now: float) -> List["Request"]:
        out = []
        while (self._i < len(self._events)
               and self._events[self._i][0] <= now):
            out.append(self._events[self._i][1])
            self._i += 1
        return out


# ---------------------------------------------------------------- requests
@dataclasses.dataclass
class Request:
    """One generation request.

    Sampling: temperature None = the run's temperature, <= 0 = greedy;
    top_k 0 = no truncation; top_p in (0, 1) keeps the smallest nucleus
    with that much mass (0 or >= 1 = off); the two intersect.
    Long-lived serving: priority — higher admits first, and under slot or
    page pressure may evict a strictly-lower-priority running request;
    deadline_s — TTFT target in serve-clock seconds after arrival: a
    queued request past it is shed, and one past half of it may evict
    deadline-free peers of its priority; on_token(uid, token_id, done) —
    called by the host scheduler as tokens leave each decode chunk."""
    uid: int
    tokens: Sequence[int]                  # prompt token ids
    max_new_tokens: int = 16
    frontend_embeds: Optional[Any] = None  # (F, d) for a VLM's frontend
    temperature: Optional[float] = None
    top_k: int = 0
    top_p: float = 0.0
    priority: int = 0
    deadline_s: Optional[float] = None
    on_token: Optional[Callable[[int, int, bool], None]] = None


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]                      # generated ids (EOS included)
    finish_reason: str     # "eos"|"length"|"rejected"|"cancelled"|"shed"
    prompt_len: int
    detail: str = ""                       # reject/shed reason, else ""
    preemptions: int = 0                   # evict+resume count for this uid


@dataclasses.dataclass
class ServeStats:
    """Wall-clock split and counters of one serve()/run() (host-synced
    boundaries)."""
    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_tokens: int = 0                # prompt tokens processed
    decode_tokens: int = 0                 # tokens produced by decode steps
    decode_steps: int = 0                  # steps with some slot active
    admitted: int = 0
    completed: int = 0
    prefill_batches: int = 0               # ragged prefill calls issued
    ttft_s_sum: float = 0.0                # over admitted requests of
    ttft_s_max: float = 0.0                # (first token ready - arrival)
    # long-lived serving (zeros for plain burst runs)
    submitted: int = 0                     # requests offered (incl. rejects)
    preemptions: int = 0                   # slot evictions
    rejections: int = 0                    # invalid requests isolated
    cancelled: int = 0                     # cancel() mid-queue/mid-stream
    shed: int = 0                          # TTFT deadline lapsed in queue
    # per-request latency samples: bounded reservoirs (Algorithm R, fixed
    # seeds) — the mean stays exact, percentiles carry sampling error only
    # past the cap
    ttft_samples: Reservoir = dataclasses.field(
        default_factory=lambda: Reservoir(cap=2048, seed=17))
    tpot_samples: Reservoir = dataclasses.field(
        default_factory=lambda: Reservoir(cap=2048, seed=29))
    # paged KV cache (zeros when kv_layout="contiguous")
    page_size: int = 0
    kv_pages_total: int = 0                # pool capacity in pages
    kv_pages_peak: int = 0                 # peak pages in use
    admission_stalls: int = 0              # free slot but no pages
    # device-counter aggregates (keep_rate, expert_load_imbalance, ...)
    # from the telemetry recorder — empty when telemetry is off
    device: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / self.prefill_s if self.prefill_s else 0.0

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def ttft_avg_s(self) -> float:
        """Mean time-to-first-token, exact over every sample seen."""
        return self.ttft_samples.mean

    @staticmethod
    def _pctl(xs, q: float) -> float:
        vals = xs.values if isinstance(xs, Reservoir) else list(xs)
        return float(np.percentile(np.array(vals), q)) if vals else 0.0

    @property
    def ttft_p50_s(self) -> float:
        return self._pctl(self.ttft_samples, 50)

    @property
    def ttft_p99_s(self) -> float:
        return self._pctl(self.ttft_samples, 99)

    @property
    def tpot_p50_s(self) -> float:
        """Median per-request time per output token (completion wall time
        after the first token, over the tokens generated after it)."""
        return self._pctl(self.tpot_samples, 50)

    @property
    def tpot_p99_s(self) -> float:
        return self._pctl(self.tpot_samples, 99)

    @property
    def prefill_batch_occupancy(self) -> float:
        """Mean admitted rows per prefill call (1.0 = serial admission)."""
        return (self.admitted / self.prefill_batches
                if self.prefill_batches else 0.0)

    # as_dict key order; snapshot() keys not in it (device-counter
    # aggregates) follow, sorted
    LEGACY_ORDER = (
        "prefill_s", "decode_s", "prefill_tokens", "decode_tokens",
        "decode_steps", "prefill_tok_s", "decode_tok_s", "admitted",
        "completed", "prefill_batches", "prefill_batch_occupancy",
        "ttft_avg_s", "ttft_max_s", "ttft_p50_s", "ttft_p99_s",
        "tpot_p50_s", "tpot_p99_s", "preemptions", "rejections",
        "cancelled", "shed", "page_size", "kv_pages_total",
        "kv_pages_peak", "admission_stalls")

    def snapshot(self) -> MetricsSnapshot:
        """Point-in-time counters/gauges/histograms view — what as_dict
        flattens, what the chaos watchdog dumps on invariant failures."""
        counters: Dict[str, float] = {
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "decode_steps": self.decode_steps,
            "admitted": self.admitted, "completed": self.completed,
            "prefill_batches": self.prefill_batches,
            "preemptions": self.preemptions,
            "rejections": self.rejections,
            "cancelled": self.cancelled, "shed": self.shed}
        gauges: Dict[str, float] = {
            "prefill_s": round(self.prefill_s, 4),
            "decode_s": round(self.decode_s, 4),
            "prefill_tok_s": round(self.prefill_tok_s, 1),
            "decode_tok_s": round(self.decode_tok_s, 1),
            "prefill_batch_occupancy": round(
                self.prefill_batch_occupancy, 2)}
        if self.kv_pages_total:
            gauges.update(page_size=self.page_size,
                          kv_pages_total=self.kv_pages_total,
                          kv_pages_peak=self.kv_pages_peak,
                          admission_stalls=self.admission_stalls)
        hists = {
            "ttft": {"avg_s": round(self.ttft_avg_s, 4),
                     "max_s": round(self.ttft_s_max, 4),
                     "p50_s": round(self.ttft_p50_s, 4),
                     "p99_s": round(self.ttft_p99_s, 4)},
            "tpot": {"p50_s": round(self.tpot_p50_s, 5),
                     "p99_s": round(self.tpot_p99_s, 5)}}
        counters.update(self.device)
        return MetricsSnapshot(counters=counters, gauges=gauges,
                               histograms=hists,
                               legacy_order=self.LEGACY_ORDER)

    def as_dict(self) -> Dict[str, float]:
        return self.snapshot().as_dict()


@dataclasses.dataclass
class GenerationResult:
    tokens: List[List[int]]
    steps: int


# ------------------------------------------------------- scheduler state
@dataclasses.dataclass
class _QItem:
    """A request's scheduling record: queued, running in a slot, or
    re-queued after preemption (``done`` holds the tokens generated before
    eviction; re-admission recomputes their KV through the ragged prefill
    and takes the last one as the pending decode input)."""
    req: Request
    order: int                             # submission order (stable key)
    arrival_s: float                       # serve-clock arrival time
    temp: float                            # resolved sampling temperature
    done: List[int] = dataclasses.field(default_factory=list)
    arrival_wall: float = 0.0              # wall clock at submit (TTFT base)
    first_tok_wall: Optional[float] = None
    preemptions: int = 0

    def prefill_tokens(self) -> List[int]:
        """Tokens to (re)compute through prefill: the prompt, plus — when
        resuming — every generated token except the last."""
        if self.done:
            return list(self.req.tokens) + self.done[:-1]
        return list(self.req.tokens)


@dataclasses.dataclass
class _SchedState:
    """Mutable state of one serve()/run(), held on ``Engine._live`` so
    submit()/cancel()/preempt() and the chaos watchdog reach it mid-loop:
    host mirrors of the per-slot decode state, the caches (and, paged,
    the page table and allocator state) on the device, and the queue."""
    stats: ServeStats
    clock: Callable[[], float]
    eos_id: Optional[int]
    greedy: bool                           # no seed: argmax everywhere
    seed: int
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
    keys: np.ndarray                       # request_key per slot
    temps: np.ndarray
    topks: np.ndarray
    topps: np.ndarray
    slot_item: List[Optional[_QItem]]
    queue: List[_QItem]
    results: Dict[int, Completion]
    seen_uids: set
    default_temp: float
    order: int = 0
    iteration: int = 0
    steps_run: int = 0                     # decode steps executed
    t0_wall: float = 0.0
    now: Optional[float] = None            # this iteration's serve time


def _queue_key(it: _QItem) -> Tuple[int, int]:
    """Admission order: priority descending, then submission order (a
    preempted request keeps its order, so it re-admits ahead of later
    arrivals of its priority)."""
    return (-it.req.priority, it.order)


# ---------------------------------------------------------------- engine
def serving_axes(cfg: ModelConfig, mesh):
    """(the model axis, the data axis expert columns are stored over) of
    a serving rank of ``mesh``; None where nothing splits (the whole
    model)."""
    tp = C.mesh_axis(mesh, "model")
    zero = C.mesh_axis(mesh, C.ZERO_AXIS)
    if tp is None and (zero is None or cfg.num_experts == 0):
        return None
    return tp, zero


def shard_model(model, cfg: ModelConfig, mesh, device=None):
    """``model`` as a rank of ``mesh`` serves it: a ``ShardedLM`` /
    ``ShardedEncDec`` of its stored part (heads, columns and vocabulary
    over ``model``, expert columns over ``data`` as well) on ``device``,
    sliced from a whole model (on the host or a device) one leaf at a
    time; a shard as it is; the model itself where nothing splits."""
    axes = serving_axes(cfg, mesh)
    if hasattr(model, "shard") or axes is None:
        return model
    cls = (encdec.ShardedEncDec if cfg.family == "audio"
           else transformer.ShardedLM)
    return cls(model, cfg, *axes, device=device)


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda", mesh=None):
    """The seeded model (``LM.init`` / ``EncDecLM.init``); under ``mesh``
    where it splits, this rank's part of it (``shard_model``'s), drawn on
    ``device`` alone: exactly the slices of the whole draw, with no more
    than one whole leaf (one layer of a stacked one) on the device at a
    time (``core/params.init_tree``)."""
    from repro_torch.core.params import init_tree
    from repro_torch.train import state as S
    dev = transformer.resolve_device(device)
    audio = cfg.family == "audio"
    axes = serving_axes(cfg, mesh)
    if axes is None:
        return (encdec.EncDecLM if audio else transformer.LM).init(
            cfg, seed=seed, device=dev)
    shard = transformer.serve_shard(cfg, *axes)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_tree(S.model_defs(cfg), gen,
                       S.model_storage_specs(cfg, shard.sizes), shard.sizes,
                       shard.coords)
    return (encdec.ShardedEncDec if audio else
            transformer.ShardedLM).from_local(params, cfg, *axes)


class Engine:
    """Continuous-batching engine over ``num_slots`` decode slots.

    model: a ``transformer.LM`` on ``device`` (CUDA unless the caller
    asks for the CPU; without a card that request raises), or for the
    audio family an ``encdec.EncDecLM``, which only ``generate`` serves.  kv_pages:
    the page pool of the paged layout, by default the contiguous
    footprint (``num_slots * ceil(max_len / page_size)``); pass fewer to
    serve under a fixed cache budget.  prefill_batch: most requests per
    admission prefill (default num_slots; 1 = serial admission);
    prefill_decode_ratio: > 0 interleaves admission with decode chunks
    (at most ratio * decode_chunk * active_slots prompt tokens per
    iteration while decodes are in flight); 0 fills every free slot
    before each chunk.

    ``serve(schedule)`` is the long-lived API, ``run(requests)`` its burst
    wrapper and ``generate(batch, steps)`` the legacy fixed-batch API.
    ``last_steps_run`` is the decode steps the last run's chunks executed
    (retired slots' dead air included): each runs the decode kernels once
    per layer, which is what a launch count is held to (on every rank
    under a mesh).  mesh: a (data, model) DeviceMesh over the started
    process group (launch/mesh.py); every rank builds the engine from the
    same whole model (on the host or the device; ``shard_model`` keeps
    this rank's part on the engine's device) or from its own part
    (``init_model(..., mesh=)``), and serves the same requests (module
    docstring)."""

    def __init__(self, cfg: ModelConfig, model: transformer.LM,
                 max_len: int = 512, *, num_slots: int = 8,
                 eos_id: Optional[int] = None, decode_chunk: int = 16,
                 kv_pages: Optional[int] = None,
                 prefill_batch: Optional[int] = None,
                 prefill_decode_ratio: float = 0.0, device="cuda",
                 mesh=None):
        self.device = transformer.resolve_device(device)
        self.cfg = cfg
        # the mesh: heads and columns over model, slots over data
        dp = C.mesh_axis(mesh, C.BATCH_AXES)
        model = shard_model(model, cfg, mesh, self.device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.mesh = mesh
        self._world = dist.get_world_size() if mesh is not None else 1
        self._data = dp
        self._dp = dp if dp is not None and num_slots % dp.size == 0 else None
        self._ns = num_slots // (self._dp.size if self._dp else 1)
        self._lo = self._dp.rank * self._ns if self._dp else 0
        self._shard = getattr(model, "shard", None)
        self._mcfg = model.cfg if self._shard is not None else cfg
        self.model = model
        self.max_len = max_len
        self.num_slots = num_slots
        self.eos_id = eos_id
        self.decode_chunk = max(1, decode_chunk)
        self.last_stats: Optional[ServeStats] = None
        self.last_steps_run = 0
        self._live: Optional[_SchedState] = None
        self._tel_mode = dispatch.telemetry_mode(cfg)
        self._tel_counters = dispatch.use_telemetry_counters(cfg)
        self.recorder: Optional[TelemetryRecorder] = None      # live run
        self.last_recorder: Optional[TelemetryRecorder] = None
        self.prefill_batch = max(1, min(num_slots, num_slots
                                        if prefill_batch is None
                                        else prefill_batch))
        self.prefill_decode_ratio = max(0.0, prefill_decode_ratio)
        # rows a VLM's frontend prepends to every prompt
        self.frontend = cfg.frontend_tokens if cfg.frontend else 0
        self._paged = (dispatch.use_paged_kv(cfg)
                       and transformer.paged_applicable(cfg))
        self.page_size = cfg.spt.kv_page_size if self._paged else 0
        if self._paged:
            self.max_pages_per_slot = kvp.num_pages(max_len, self.page_size)
            self.kv_pages = (num_slots * self.max_pages_per_slot
                             if kv_pages is None else int(kv_pages))
        else:
            self.kv_pages = 0
        # legacy per-token step functions (sampled generate())
        self._prefill = build_prefill_step(self._mcfg, max_len)
        self._decode = build_decode_step(self._mcfg)

    # ----------------------------------------------------------- the mesh
    def _owns(self, b: int) -> bool:
        """Slot b's caches live on this rank (its data rank's slots)."""
        return self._lo <= b < self._lo + self._ns

    def _now(self) -> float:
        """This iteration's serve time, the same on every rank: a wall
        clock is agreed by an all-reduce (max) over the world."""
        st = self._live
        now = st.clock()
        if self._world > 1 and not hasattr(st.clock, "advance"):
            t = torch.tensor([now], dtype=torch.float64, device=self.device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            now = float(t.item())
        st.now = now
        return now

    # ------------------------------------------------------------ prefill
    def _pad_invariant(self) -> bool:
        """True when right-padding alone (no per-row lengths reaching the
        layers) cannot change real-token outputs: a pure-attention stack,
        no sliding-window ring (padding displaces real KV), dense
        attention (sparse MHA's top-L budget counts the padded keys) and
        a dense FFN (routed-FFN / MoE capacity lets pad tokens take
        slots)."""
        cfg = self.cfg
        return (transformer.supports_ragged_prefill(cfg)
                and cfg.window is None
                and not transformer.length_sensitive(cfg))

    def _ragged_batchable(self) -> bool:
        """True when ragged rows may be right-padded to a common bucket:
        pure-attention stacks without a SWA ring, whose ring keeps the
        last ``window`` padded positions and so would lose real KV.
        Length-sensitive configs stay exact because lm_prefill_ragged
        threads the per-row lengths into the selection budgets and
        dispatch capacities.  Other stacks batch equal-length rows only."""
        return (transformer.supports_ragged_prefill(self.cfg)
                and self.cfg.window is None)

    def _pad_len(self, n: int) -> int:
        """Prompt-length bucket: ragged-batchable configs pad right to a
        power of two (>= 8, capped at max_len less a frontend's rows;
        cache slots past the real length are invalidated); the others
        prefill at the exact length."""
        n = max(1, n)
        if not self._ragged_batchable():
            return n
        p = 8
        while p < n:
            p <<= 1
        return max(n, min(p, self.max_len - self.frontend))

    @staticmethod
    def _pad_rows(n: int) -> int:
        """Row-count bucket (power of two)."""
        p = 1
        while p < n:
            p <<= 1
        return p

    def _bucket_share(self, assigned: Sequence[int]) -> int:
        """The rows of an admission group's bucket (``_pad_rows``) that
        this rank prefills: its own slots' rows, and the bucket's dummy
        rows dealt one at a time to the data rank that holds the fewest
        rows so far.  So the data ranks' prefills together hold the world
        of one's bucket, row for row (without a data axis: all of it)."""
        held = [0] * (self._dp.size if self._dp else 1)
        for b in assigned:
            held[b // self._ns] += 1
        for _ in range(self._pad_rows(len(assigned)) - len(assigned)):
            held[held.index(min(held))] += 1
        return held[self._dp.rank if self._dp else 0]

    def _prefill_group(self, group: Sequence[_QItem], p: int, bpb: int):
        """ONE ragged prefill over an admission group (under a data axis,
        this rank's rows of it) padded to length ``p``; dummy rows fill
        the ``bpb`` rows (at least one) and are dropped by the slot copy.
        Resumed rows prefill prompt + regenerated tokens, after their
        frontend rows (the lengths count those).  Returns (cache rows,
        logits (bpb, 1, V), bpb, counter tree or None)."""
        cfg = self.cfg
        rows_toks = [it.prefill_tokens() for it in group]
        toks = np.zeros((bpb, p), np.int64)            # pad id 0
        lens = np.ones(bpb, np.int64)                  # dummies: length 1
        for i, t in enumerate(rows_toks):
            toks[i, :len(t)] = t
            lens[i] = len(t)
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        if self.frontend:
            fe = np.zeros((bpb, self.frontend, cfg.d_model), np.float32)
            for i, it in enumerate(group):
                fe[i] = np.asarray(it.req.frontend_embeds,
                                   np.float32).reshape(self.frontend,
                                                       cfg.d_model)
            batch["frontend_embeds"] = torch.as_tensor(fe,
                                                       device=self.device)
        lengths = torch.as_tensor(self.frontend + lens, device=self.device)
        out = transformer.lm_prefill_ragged(
            self.model, self._mcfg, batch, lengths, self.max_len,
            return_counters=self._tel_counters, split_seq=not self._paged)
        if self._tel_counters:
            rows, logits, tel = out
        else:
            (rows, logits), tel = out, None
        return rows, logits, bpb, tel

    # ---------------------------------------------------------- sampling
    def _sample_plan(self, rows: Sequence[int], slots: Sequence[int]
                     ) -> Optional[dict]:
        """Device inputs of the draws of logit rows ``rows``, which belong
        to the sampling slots ``slots``; None when nothing samples (a
        greedy run, or no sampled slot): the argmax alone then runs."""
        if self._live.greedy or len(rows) == 0:
            return None
        st = self._live
        dev = self.device
        slots = np.asarray(slots, np.int64)
        tp = st.topps[slots]
        return {"idx": torch.as_tensor(np.asarray(rows, np.int64),
                                       device=dev),
                "keys": torch.as_tensor(st.keys[slots], device=dev),
                "temps": torch.as_tensor(st.temps[slots], device=dev),
                "topks": torch.as_tensor(st.topks[slots], device=dev),
                "topps": torch.as_tensor(tp, device=dev),
                "kmax": int(st.topks[slots].max()),
                "use_topp": bool(((tp > 0.0) & (tp < 1.0)).any())}

    @staticmethod
    def _draw(lg: torch.Tensor, plan: Optional[dict], n: torch.Tensor
              ) -> torch.Tensor:
        """Argmax over the full padded vocabulary (an id >= vocab_size can
        win, as in the JAX engine), with the plan's rows replaced by their
        draws; n: (R,) index of the token each row draws."""
        nxt = lg.argmax(-1)
        if plan is None:
            return nxt
        idx = plan["idx"]
        nxt[idx] = sample_rows(lg.index_select(0, idx), plan["keys"],
                               n.index_select(0, idx), plan["temps"],
                               plan["topks"], plan["topps"], plan["kmax"],
                               plan["use_topp"])
        return nxt

    # ---------------------------------------------------------- scheduler
    def _pages_ws(self, req: Request) -> int:
        """Worst-case pages ``req`` can hold: one per page of rows
        [0, frontend + prompt + max_new - 1) (the last decode write lands
        at position frontend + prompt + max_new - 2); the same for a
        resumed item."""
        rows = self.frontend + len(req.tokens) + req.max_new_tokens - 1
        return kvp.num_pages(max(1, rows), self.page_size)

    def _validate(self, req: Request, seen: set) -> Optional[str]:
        """Why ``req`` must be rejected, or None: a bad request becomes a
        rejected Completion while the rest keeps serving."""
        if req.uid in seen:
            return f"duplicate request uid {req.uid}"
        if req.max_new_tokens < 1:
            return "max_new_tokens < 1"
        if not req.tokens:
            return "empty prompt"
        if self.frontend and req.frontend_embeds is None:
            return (f"{self.cfg.name} has a {self.cfg.frontend} frontend; "
                    "frontend_embeds is required")
        need = self.frontend + len(req.tokens) + req.max_new_tokens
        if need > self.max_len:
            return f"needs {need} positions > max_len={self.max_len}"
        if self._paged and self._pages_ws(req) > self.kv_pages:
            return (f"needs {self._pages_ws(req)} KV pages > pool size "
                    f"{self.kv_pages}")
        return None

    # ------------------------------------------------- long-lived API
    def submit(self, req: Request, now: Optional[float] = None) -> bool:
        """Queue ``req`` into the live serve()/run() loop (from arrival
        schedules, chaos injectors or callbacks).  Returns False when the
        request is rejected; the rejection is a Completion in the
        results, never an exception."""
        st = self._live
        if st is None:
            raise RuntimeError("submit() requires a live serve()/run()")
        if now is None:      # under a mesh, the iteration's agreed time
            now = (st.now if self._world > 1 and st.now is not None
                   else st.clock())
        order = st.order
        st.order += 1
        st.stats.submitted += 1
        rec = self.recorder
        wall = time.perf_counter()
        if rec is not None:
            rec.event(req.uid, "submit", wall, prompt_len=len(req.tokens),
                      priority=req.priority)
        why = self._validate(req, st.seen_uids)
        if why is not None:
            st.stats.rejections += 1
            if rec is not None:
                rec.event(req.uid, "rejected", wall, detail=why)
            st.results[order] = Completion(
                uid=req.uid, tokens=[], finish_reason="rejected",
                prompt_len=len(req.tokens), detail=why)
            return False
        st.seen_uids.add(req.uid)
        if rec is not None:
            rec.event(req.uid, "queued", wall)
        temp = (st.default_temp if req.temperature is None
                else req.temperature)
        self._grow_gen(req.max_new_tokens)
        st.queue.append(_QItem(req=req, order=order, arrival_s=now,
                               temp=temp,
                               arrival_wall=time.perf_counter()))
        st.queue.sort(key=_queue_key)
        return True

    def cancel(self, uid: int) -> bool:
        """Cancel a queued or in-flight request: frees its slot and pages
        and finishes it as Completion(finish_reason="cancelled") with the
        tokens generated so far.  False when the uid is not live."""
        st = self._live
        if st is None:
            return False
        rec = self.recorder
        for qi, it in enumerate(st.queue):
            if it.req.uid == uid:
                del st.queue[qi]
                st.stats.cancelled += 1
                if rec is not None:
                    rec.event(uid, "cancelled", time.perf_counter(),
                              detail="while queued")
                st.results[it.order] = Completion(
                    uid=uid, tokens=list(it.done),
                    finish_reason="cancelled",
                    prompt_len=len(it.req.tokens),
                    detail="cancelled while queued",
                    preemptions=it.preemptions)
                return True
        for b, it in enumerate(st.slot_item):
            if it is not None and it.req.uid == uid:
                st.stats.cancelled += 1
                if rec is not None:
                    rec.event(uid, "cancelled", time.perf_counter(),
                              detail="mid-stream",
                              n_gen=int(st.n_gen[b]))
                st.results[it.order] = Completion(
                    uid=uid, tokens=st.buf[b, :st.n_gen[b]].tolist(),
                    finish_reason="cancelled",
                    prompt_len=len(it.req.tokens),
                    detail="cancelled mid-stream",
                    preemptions=it.preemptions)
                self._release_slot(b)
                return True
        return False

    def preempt(self, uid: Optional[int] = None) -> bool:
        """Force-preempt an active request: save its progress, free its
        slot and pages, and re-queue it for recompute re-admission.
        ``uid`` None picks the default victim (lowest priority, most
        recently admitted).  False when nothing matches."""
        st = self._live
        if st is None:
            return False
        if uid is None:
            b = self._pick_victim(None, False)
            if b is None:
                return False
            self._preempt_slot(b)
            return True
        for b, it in enumerate(st.slot_item):
            if it is not None and it.req.uid == uid and st.active[b]:
                self._preempt_slot(b)
                return True
        return False

    # ------------------------------------------------ slot-state plumbing
    def _grow_gen(self, need: int) -> None:
        """Grow the per-slot output buffer to a power-of-two token budget
        as arrivals raise it (run() presizes the exact maximum)."""
        st = self._live
        if need <= st.max_gen:
            return
        new = max(8, st.max_gen)
        while new < need:
            new <<= 1
        st.buf = np.pad(st.buf, ((0, 0), (0, new - st.buf.shape[1])))
        st.max_gen = new

    def _release_slot(self, b: int) -> None:
        """Return slot b to the free pool (retire, cancel and preempt all
        land here): paged, its pages go back to the allocator and its
        worst-case reservation is dropped."""
        st = self._live
        st.slot_item[b] = None
        st.active[b] = False
        if self._paged:
            if self._owns(b):
                st.astate, st.page_table = kvp.free_slot_pages(
                    st.astate, st.page_table, b - self._lo)
            st.reserved -= st.slot_ws[b]
            st.slot_ws[b] = 0

    def _retire(self, b: int) -> None:
        st = self._live
        it = st.slot_item[b]
        toks = st.buf[b, :st.n_gen[b]].tolist()
        reason = ("eos" if st.eos_id is not None and toks
                  and toks[-1] == st.eos_id else "length")
        now_wall = time.perf_counter()
        if self.recorder is not None:
            self.recorder.event(it.req.uid, "retired", now_wall,
                                finish=reason, n_gen=int(st.n_gen[b]))
        if it.first_tok_wall is not None and int(st.n_gen[b]) > 1:
            st.stats.tpot_samples.append(
                (now_wall - it.first_tok_wall) / (int(st.n_gen[b]) - 1))
        st.results[it.order] = Completion(
            uid=it.req.uid, tokens=toks, finish_reason=reason,
            prompt_len=len(it.req.tokens), preemptions=it.preemptions)
        st.stats.completed += 1
        self._release_slot(b)

    def _track_peak(self, used: Optional[int] = None) -> None:
        """Peak pages in use: ``used`` (a decode chunk brings it back), or
        one read of the allocator's stack top (summed over the data
        ranks' pools)."""
        st = self._live
        if self._paged:
            if used is None:
                used = self.kv_pages - st.astate["top"].to(torch.float64)
                used = int(C.all_reduce_flat(used.reshape(1), self._dp)[0])
            st.stats.kv_pages_peak = max(st.stats.kv_pages_peak, used)
            if self.recorder is not None:
                self.recorder.gauge("kv_pages_used", time.perf_counter(),
                                    used)

    def _preempt_slot(self, b: int) -> None:
        """Evict slot b: save its generated tokens on the queue item, free
        its pages and slot, and re-queue it for recompute re-admission."""
        st = self._live
        it = st.slot_item[b]
        it.done = st.buf[b, :st.n_gen[b]].tolist()
        it.preemptions += 1
        st.stats.preemptions += 1
        if self.recorder is not None:
            self.recorder.event(it.req.uid, "preempted",
                                time.perf_counter(), slot=b,
                                n_gen=int(st.n_gen[b]))
        self._release_slot(b)
        st.queue.append(it)
        st.queue.sort(key=_queue_key)

    def _pick_victim(self, cand: Optional[_QItem],
                     urgent: bool) -> Optional[int]:
        """Lowest-priority, most-recently-admitted active slot that
        ``cand`` may evict: strictly lower priority, or — when cand's
        TTFT deadline is at risk (urgent) — a deadline-free peer of equal
        priority.  cand None (forced preemption) matches any active
        slot."""
        st = self._live
        best = None
        for b, it in enumerate(st.slot_item):
            if it is None or not st.active[b]:
                continue
            if cand is not None:
                lower = it.req.priority < cand.req.priority
                peer = (urgent and it.req.priority == cand.req.priority
                        and it.req.deadline_s is None)
                if not (lower or peer):
                    continue
            key = (it.req.priority, -it.order)
            if best is None or key < best[0]:
                best = (key, b)
        return None if best is None else best[1]

    def _shed_expired(self, now: float) -> None:
        """Drop queued requests whose TTFT deadline already lapsed (resumed
        items produced their first token and are never shed)."""
        st = self._live
        keep = []
        for it in st.queue:
            d = it.req.deadline_s
            if (d is not None and it.first_tok_wall is None
                    and now - it.arrival_s > d):
                st.stats.shed += 1
                if self.recorder is not None:
                    self.recorder.event(it.req.uid, "shed",
                                        time.perf_counter(),
                                        deadline_s=d)
                st.results[it.order] = Completion(
                    uid=it.req.uid, tokens=[], finish_reason="shed",
                    prompt_len=len(it.req.tokens),
                    detail=f"TTFT deadline {d}s lapsed in queue",
                    preemptions=it.preemptions)
            else:
                keep.append(it)
        st.queue = keep

    def _pressure_preempt(self, now: float) -> None:
        """Slot / page-pool pressure: when the head of the queue cannot
        fit, evict eligible victims (``_pick_victim``) until it fits or
        none remains.  Uniform-priority bursts never trigger this."""
        st = self._live
        if not st.queue:
            return
        cand = st.queue[0]

        def blocked() -> bool:
            if not any(s is None for s in st.slot_item):
                return True
            return (self._paged and self._pages_ws(cand.req)
                    > self.kv_pages - st.reserved)

        d = cand.req.deadline_s
        urgent = (d is not None and cand.first_tok_wall is None
                  and now - cand.arrival_s >= 0.5 * d)
        guard = 0
        while blocked() and guard < self.num_slots:
            b = self._pick_victim(cand, urgent)
            if b is None:
                break
            self._preempt_slot(b)
            guard += 1
        if guard:
            # the eviction was for cand: re-queued victims of equal
            # priority carry an older order and would outrank it, so cand
            # keeps the head
            st.queue.remove(cand)
            st.queue.insert(0, cand)

    # -------------------------------------------------- admission + decode
    def _form_group(self, stalled_seen: set) -> List[_QItem]:
        """Scan the queue in order (priority, then submission) for the next
        admission group: up to prefill_batch requests that have a free slot
        and (paged) a worst-case page reservation.  A request that does not
        fit the pool is counted as a stall once per scheduling iteration
        and skipped, so it does not block later ones that fit.  Stacks
        that are not ragged-batchable (SWA rings) group equal-length rows
        only.  With overlap on and decodes in flight, the group is bounded
        by the prefill token budget (always >= 1 request)."""
        st = self._live
        free = sum(1 for s in st.slot_item if s is None)
        if not free or not st.queue:
            return []
        budget = None
        if self.prefill_decode_ratio > 0 and st.active.any():
            budget = max(1, int(self.prefill_decode_ratio
                                * self.decode_chunk
                                * int(st.active.sum())))
        ragged_ok = self._ragged_batchable()
        group: List[_QItem] = []
        picked: List[int] = []
        group_ws = group_tokens = 0
        for qi, it in enumerate(st.queue):
            if len(group) == min(free, self.prefill_batch):
                break
            ptoks = len(it.prefill_tokens())
            if (budget is not None and group
                    and group_tokens + ptoks > budget):
                break
            if (not ragged_ok and group
                    and ptoks != len(group[0].prefill_tokens())):
                continue
            if (self._paged
                    and self._pages_ws(it.req) > self.kv_pages
                    - st.reserved - group_ws):
                if it.req.uid not in stalled_seen:
                    stalled_seen.add(it.req.uid)
                    st.stats.admission_stalls += 1
                continue
            group.append(it)
            picked.append(qi)
            group_ws += self._pages_ws(it.req) if self._paged else 0
            group_tokens += ptoks
        for qi in reversed(picked):
            del st.queue[qi]
        return group

    def _stream(self, it: _QItem, toks: Sequence[int], done: bool) -> None:
        cb = it.req.on_token
        if cb is None:
            return
        for j, t in enumerate(toks):
            cb(it.req.uid, int(t), done and j == len(toks) - 1)

    def _admit(self, group: List[_QItem]) -> None:
        """ONE ragged prefill + ONE slot copy (and, paged, ONE page
        allocation) admits the whole group; the first tokens (argmax, or
        drawn for sampled requests) come to the host in one transfer with
        the prefill's counters.  Resumed rows take their last generated
        token as the pending decode input instead."""
        st = self._live
        ps = self.page_size
        t0 = time.perf_counter()
        assigned: List[int] = []
        for it in group:
            b = next(j for j, s in enumerate(st.slot_item) if s is None)
            st.slot_item[b] = it
            assigned.append(b)
        # this rank's rows (all of them without a data axis) and its share
        # of the bucket, at the group's length bucket; a rank with no share
        # prefills one dummy row all the same
        local = [i for i, b in enumerate(assigned) if self._owns(b)]
        share = self._bucket_share(assigned)
        rows, logits, bpb, tel = self._prefill_group(
            [group[i] for i in local],
            self._pad_len(max(len(it.prefill_tokens()) for it in group)),
            max(1, share))
        slot_vec = np.full(bpb, -1, np.int64)        # -1 rows: dummies
        for j, i in enumerate(local):
            slot_vec[j] = assigned[i] - self._lo
        slots = torch.as_tensor(slot_vec, device=self.device)
        if self._paged:
            npages = np.zeros(bpb, np.int64)
            for i, it in enumerate(group):
                ws = self._pages_ws(it.req)
                st.reserved += ws
                st.slot_ws[assigned[i]] = ws
            for j, i in enumerate(local):
                npages[j] = kvp.num_pages(
                    self.frontend + len(group[i].prefill_tokens()), ps)
            st.astate, st.page_table = kvp.alloc_rows_pages(
                st.astate, st.page_table, slots,
                torch.as_tensor(npages, device=self.device))
            transformer.write_slot_caches_paged_rows(
                st.caches, rows, slots, st.page_table, self._mcfg)
        else:
            transformer.write_slot_caches_rows(st.caches, rows, slots)
        for i, it in enumerate(group):            # sampling state per slot
            b, r = assigned[i], it.req
            st.keys[b] = request_key(st.seed, r.uid)
            st.temps[b] = it.temp
            st.topks[b] = r.top_k
            st.topps[b] = r.top_p
        # first tokens: the prefill's last logits, drawn where the request
        # samples (token index 0); resumed rows need none
        drawn = [j for j, i in enumerate(local)
                 if not group[i].done and group[i].temp > 0.0]
        plan = self._sample_plan(drawn, [assigned[local[j]] for j in drawn])
        firsts_d = self._draw(logits[:len(local), -1].float(), plan,
                              torch.zeros(len(local), dtype=torch.long,
                                          device=self.device))
        keys = sorted(tel) if tel else []
        firsts, ctr = self._admit_sync(group, local, share, bpb, firsts_d,
                                       [tel[k] for k in keys], keys)
        now_wall = time.perf_counter()
        rec = self.recorder
        if rec is not None and tel is not None:
            rec.drain_counters(ctr)
        if rec is not None:
            rec.span("prefill_batch", t0, now_wall, st.iteration,
                     group=len(group), bucket_rows=bpb)
        st.stats.prefill_s += now_wall - t0
        st.stats.prefill_batches += 1
        st.stats.prefill_tokens += sum(
            len(it.prefill_tokens()) for it in group)
        st.stats.admitted += len(group)
        for i, it in enumerate(group):
            b = assigned[i]
            r = it.req
            st.limit[b] = r.max_new_tokens
            st.buf[b] = 0
            if it.done:                         # resume after preemption
                nd = len(it.done)
                st.buf[b, :nd] = it.done
                st.tok[b] = it.done[-1]
                st.pos[b] = self.frontend + len(it.prefill_tokens())
                st.n_gen[b] = nd
                if rec is not None:
                    rec.event(r.uid, "resumed", now_wall, slot=b,
                              regenerated=nd)
                done_now = (nd >= r.max_new_tokens
                            or (st.eos_id is not None
                                and it.done[-1] == st.eos_id))
                st.active[b] = not done_now
                if done_now:
                    self._retire(b)
                continue
            if rec is not None:
                rec.event(r.uid, "admitted", now_wall, slot=b,
                          prompt_len=len(r.tokens))
            first = firsts[i]
            # TTFT is arrival-relative: for a burst every arrival is the
            # serve start; a late arrival is not charged for time it did
            # not wait
            ttft = now_wall - it.arrival_wall
            st.stats.ttft_s_sum += ttft
            st.stats.ttft_s_max = max(st.stats.ttft_s_max, ttft)
            st.stats.ttft_samples.append(ttft)
            it.first_tok_wall = now_wall
            if rec is not None:
                rec.event(r.uid, "first_token", now_wall,
                          ttft_s=round(ttft, 6))
            st.tok[b] = first
            st.pos[b] = self.frontend + len(r.tokens)
            st.n_gen[b] = 1
            st.buf[b, 0] = first
            done_now = (r.max_new_tokens <= 1
                        or (st.eos_id is not None and first == st.eos_id))
            st.active[b] = not done_now
            self._stream(it, [first], done_now)
            if done_now:
                self._retire(b)

    def _admit_sync(self, group, local, share, bpb, firsts_d, tels, keys):
        """The group's first tokens and prefill counters, from every data
        rank's rows, in one all-reduce (sum) over data and one transfer
        to the host.  Each rank puts its rows' tokens at their group
        index; a per-row counter (dim 1 the ``bpb`` prefill rows) is
        summed over the rank's real rows; a share of the batch (the
        expert drop fraction, over the pairs of every row of the bucket)
        is weighted by the rank's ``share`` of the bucket's rows, so the
        sum is the world of one's share."""
        ng, nl = len(group), len(local)
        pos = torch.as_tensor(local, dtype=torch.long, device=self.device)
        firsts = torch.zeros(ng, dtype=torch.float64, device=self.device)
        firsts[pos] = firsts_d.to(torch.float64)
        weight = share / self._pad_rows(ng)
        parts = []
        for v in tels:
            v = v.to(torch.float64)
            parts.append(v[:, :nl].sum(1) if v.dim() >= 2
                         and v.shape[1] == bpb else v * weight)
        host = C.all_reduce_flat(_flat([firsts, *parts]),
                                 self._dp).cpu().numpy()
        out = _unflat(host, [firsts, *parts])
        return out[0].astype(np.int64).tolist(), dict(zip(keys, out[1:]))

    def _chunk(self, steps: int, plan: Optional[dict]):
        """``steps`` decode steps on the device with no host sync: the
        per-slot state advances in device tensors, paged slots grow a page
        where they write a new page's first row, and (telemetry on) the
        counters accumulate, each per-slot leaf weighted by the slots
        still active.  Returns the state tensors and the counter dict."""
        st = self._live
        dev = self.device
        slots = self._ns                    # this rank's slots
        mine = slice(self._lo, self._lo + slots)
        tok = torch.as_tensor(st.tok[mine], device=dev)
        pos = torch.as_tensor(st.pos[mine], device=dev)
        active = torch.as_tensor(st.active[mine], device=dev)
        n = torch.as_tensor(st.n_gen[mine], device=dev)
        limit = torch.as_tensor(st.limit[mine], device=dev)
        buf = torch.as_tensor(np.ascontiguousarray(st.buf[mine]), device=dev)
        bidx = torch.arange(slots, device=dev)
        ps = self.page_size
        view = (self.max_pages_per_slot * ps if self._paged
                else self.max_len)
        slot_ids = torch.arange(view, device=dev)[None, :]
        tel_on = self._tel_counters
        ctr: Dict[str, torch.Tensor] = {}
        if tel_on and not st.greedy:
            sampled = torch.zeros(slots, dtype=torch.bool, device=dev)
            if plan is not None:
                sampled[plan["idx"]] = True

        def acc(k, v):
            ctr[k] = ctr[k] + v if k in ctr else v

        page_table = st.page_table
        for _ in range(steps):
            ok = None
            if self._paged:
                # grow pages in the loop: a slot writing the first row of
                # a new page pops one from the free list (admission
                # reserved the worst case, so the pop cannot fail)
                st.astate, pid, ok = kvp.alloc_masked(
                    st.astate, active & (pos % ps == 0))
                pj = torch.clamp(pos // ps, 0, page_table.shape[1] - 1)
                page_table[bidx, pj] = torch.where(ok, pid,
                                                   page_table[bidx, pj])
                transformer.reset_page_slots(st.caches, self.cfg, pid, ok)
            # slot validity from the per-slot positions (and, paged, the
            # page occupancy), built once per step and shared by every
            # layer
            kv_valid = slot_ids <= pos[:, None]
            if self._paged:
                kv_valid = kv_valid & kvp.occupancy(page_table, ps)
            out = transformer.lm_decode_step(
                self.model, self._mcfg, st.caches, tok, pos,
                kv_valid=kv_valid,
                page_table=page_table if self._paged else None,
                return_counters=tel_on)
            logits, stel = out if tel_on else (out, None)
            nxt = self._draw(logits[:, -1].float(), plan, n)
            if tel_on:
                amask = active.to(torch.float32)
                for k, v in stel.items():
                    v = v.to(torch.float32)
                    if v.dim() >= 2 and v.shape[1] == slots:
                        v = v * amask.reshape(
                            (1, slots) + (1,) * (v.dim() - 2))
                    acc(k, v)
                acc("decode_tokens", amask.sum())
                if self._paged:
                    acc("pages_allocated", ok.to(torch.float32).sum())
                if not st.greedy:
                    acc("sampled_tokens",
                        (active & sampled).to(torch.float32).sum())
            col = torch.clamp(n, 0, st.max_gen - 1)
            buf[bidx, col] = torch.where(active, nxt, buf[bidx, col])
            step = active.to(n.dtype)
            n = n + step
            pos = pos + step
            done = n >= limit
            if st.eos_id is not None:
                done |= nxt == st.eos_id
            tok = torch.where(active, nxt, tok)
            active = active & ~done
        return (tok, pos, active, n, buf), ctr

    def _decode_once(self) -> None:
        """One decode chunk, then stream fresh tokens and retire slots that
        finished inside it.  The chunk runs as many steps as the longest
        remaining budget allows (at most decode_chunk): without a host
        sync it cannot stop early when EOS retires every slot, so
        ``decode_steps`` counts the steps in which some slot was active —
        the largest per-slot token count the chunk added, read from the
        synced state (slots only ever retire inside a chunk)."""
        st = self._live
        act = st.active
        steps = min(self.decode_chunk,
                    int((st.limit[act] - st.n_gen[act]).max()))
        n_prev = st.n_gen.copy()
        was_active = st.active.copy()
        samp = np.flatnonzero(act & (st.temps > 0.0))
        samp = samp[(samp >= self._lo) & (samp < self._lo + self._ns)]
        t0 = time.perf_counter()
        state, ctr = self._chunk(steps,
                                 self._sample_plan(samp - self._lo, samp))
        keys = sorted(ctr)
        host, counters, used = self._chunk_sync(state, ctr, keys)
        t1 = time.perf_counter()
        st.stats.decode_s += t1 - t0
        st.tok, st.pos, act_new, st.n_gen, st.buf = host[:5]
        live = int((st.n_gen - n_prev).max())
        rec = self.recorder
        if rec is not None and self._tel_counters:
            rec.drain_counters(counters)
            t2 = time.perf_counter()
            rec.span("drain", t1, t2, st.iteration)
        if rec is not None:
            rec.span("decode_chunk", t0, t1, st.iteration, steps=live,
                     active=int(act_new.sum()))
        self._track_peak(used)
        st.steps_run += steps
        st.stats.decode_steps += live
        st.stats.decode_tokens += int(st.n_gen.sum() - n_prev.sum())
        st.active = act_new
        for b in range(self.num_slots):
            it = st.slot_item[b]
            if it is None or not was_active[b]:
                continue
            finished = not act_new[b]
            fresh = st.buf[b, n_prev[b]:st.n_gen[b]]
            if len(fresh):
                self._stream(it, fresh.tolist(), finished)
            if finished:
                self._retire(b)

    def _chunk_sync(self, state, ctr, keys):
        """A chunk's host state in ONE all-gather over data (none without
        a data axis) and one transfer to the host: each rank's slot rows
        of (tok, pos, active, n_gen, buf), its counters and (paged) its
        pages in use.  The slot rows come back in rank order (the
        world-of-one arrays), the counters merged as the world of one
        drains them (``TelemetryRecorder.merge_ranks``), the pages summed.
        Returns (state arrays, counter dict, pages in use or None)."""
        st, dp = self._live, self._dp
        tensors = [*state, *(ctr[k] for k in keys)]
        if self._paged:
            tensors.append(self.kv_pages - st.astate["top"].reshape(1))
        allp = C.all_gather_flat(_flat(tensors), dp).cpu().numpy()
        per = [_unflat(row, tensors) for row in allp]      # by rank
        host = [np.concatenate([r[j] for r in per]) for j in range(5)]
        counters = TelemetryRecorder.merge_ranks(
            [dict(zip(keys, r[5:5 + len(keys)])) for r in per], self._ns)
        used = (int(sum(r[-1][0] for r in per)) if self._paged else None)
        return host, counters, used

    # -------------------------------------------------------- serve loop
    def _start(self, *, temperature, seed, eos_id, clock, greedy,
               max_gen) -> _SchedState:
        if self.cfg.family == "audio":
            raise NotImplementedError(
                "continuous batching covers decoder-only LMs; use "
                "generate() for the enc-dec audio family")
        if self._live is not None:
            raise RuntimeError("engine already has a live serve()/run()")
        if eos_id == "engine-default":
            eos_id = self.eos_id
        slots = self.num_slots
        dev = self.device
        paged = self._paged
        t0 = time.perf_counter()
        st = _SchedState(
            stats=ServeStats(page_size=self.page_size,
                             kv_pages_total=self.kv_pages),
            clock=(clock if clock is not None
                   else (lambda: time.perf_counter() - t0)),
            eos_id=eos_id, greedy=greedy,
            seed=0 if seed is None else int(seed), max_gen=max_gen,
            caches=transformer.init_caches(
                self._mcfg, self._ns, self.max_len, dev,
                kv_pages=self.kv_pages if paged else None,
                shard=self._shard),
            page_table=(kvp.init_page_table(self._ns,
                                            self.max_pages_per_slot, dev)
                        if paged else None),
            astate=kvp.init_state(self.kv_pages, dev) if paged else None,
            reserved=0, slot_ws=[0] * slots,
            tok=np.zeros(slots, np.int64), pos=np.zeros(slots, np.int64),
            active=np.zeros(slots, bool), n_gen=np.zeros(slots, np.int64),
            limit=np.ones(slots, np.int64),
            buf=np.zeros((slots, max(0, max_gen)), np.int64),
            keys=np.zeros(slots, np.int64),
            temps=np.zeros(slots, np.float32),
            topks=np.zeros(slots, np.int64),
            topps=np.zeros(slots, np.float32),
            slot_item=[None] * slots, queue=[], results={},
            seen_uids=set(), default_temp=temperature, t0_wall=t0)
        if self._tel_mode != "off":
            rec = TelemetryRecorder(
                mode=("trace" if self._tel_mode == "trace"
                      else "counters"),
                time_origin=t0)
            self.recorder = rec
            self.last_recorder = rec
        self._live = st
        return st

    def _iterate(self, schedule: Optional[ArrivalSchedule],
                 on_iteration: Optional[Callable]) -> bool:
        """One scheduling iteration: arrivals -> deadline shedding ->
        pressure preemption -> batched admission -> one decode chunk
        (streaming and retirement inside) -> the on_iteration hook.
        Returns True when a decode chunk ran."""
        st = self._live
        rec = self.recorder
        now = self._now()
        if schedule is not None:
            for r in schedule.due(now):
                self.submit(r, now=now)
        self._shed_expired(now)
        tp0 = time.perf_counter()
        pre_before = st.stats.preemptions
        self._pressure_preempt(now)
        if rec is not None and st.stats.preemptions > pre_before:
            rec.span("pressure_preempt", tp0, time.perf_counter(),
                     st.iteration,
                     evicted=st.stats.preemptions - pre_before)
        ta0 = time.perf_counter()
        admitted_before = st.stats.admitted
        stalled_seen: set = set()
        while True:
            group = self._form_group(stalled_seen)
            if not group:
                break
            self._admit(group)
            if self.prefill_decode_ratio > 0 and st.active.any():
                break           # overlap: hand control back to decode
        if rec is not None and st.stats.admitted > admitted_before:
            rec.span("admission", ta0, time.perf_counter(), st.iteration,
                     admitted=st.stats.admitted - admitted_before,
                     stalled=len(stalled_seen))
        self._track_peak()
        stepped = False
        if st.active.any():
            self._decode_once()
            stepped = True
        if rec is not None:
            tg = time.perf_counter()
            rec.gauge("queue_depth", tg, len(st.queue))
            rec.gauge("active_slots", tg, int(st.active.sum()))
        st.iteration += 1
        if on_iteration is not None:
            on_iteration(self, st.iteration)
        if hasattr(st.clock, "advance"):
            st.clock.advance()
        return stepped

    def serve(self, schedule: ArrivalSchedule, *,
              temperature: float = 0.0, seed: Optional[int] = None,
              eos_id: Any = "engine-default",
              clock: Optional[Callable[[], float]] = None,
              on_iteration: Optional[Callable] = None,
              _greedy: Optional[bool] = None,
              _max_gen: int = 0) -> List[Completion]:
        """Long-lived serving loop over an ``ArrivalSchedule``.

        Runs until the schedule is exhausted and every submitted request
        reached a terminal state (completed, rejected, cancelled or
        shed); returns completions in submission order and leaves the
        stats in ``self.last_stats``.  ``seed`` None decodes greedily;
        with a seed, requests whose temperature is > 0 sample.
        ``clock`` reads serve time in seconds (default: wall clock since
        serve start; a ManualClock makes arrivals and deadlines advance
        per scheduling iteration).  ``on_iteration(engine, i)`` fires
        after every iteration (chaos injection, invariant watchdog)."""
        greedy = (seed is None) if _greedy is None else _greedy
        st = self._start(temperature=temperature, seed=seed, eos_id=eos_id,
                         clock=clock, greedy=greedy, max_gen=_max_gen)
        try:
            with torch.no_grad():
                while True:
                    stepped = self._iterate(schedule, on_iteration)
                    idle = (not stepped and not st.queue
                            and not st.active.any())
                    if (schedule.exhausted and idle
                            and all(s is None for s in st.slot_item)):
                        break
                    if idle and not schedule.exhausted:
                        nxt = schedule.next_time()
                        wait = (nxt - st.clock()) if nxt is not None else 0.0
                        if wait > 0 and not hasattr(st.clock, "advance"):
                            time.sleep(min(wait, 0.05))
        finally:
            rec = self.recorder
            if rec is not None:
                st.stats.device.update(rec.device_aggregates())
            self.last_stats = st.stats
            self.last_steps_run = st.steps_run
            self.recorder = None        # last_recorder keeps the handle
            self._live = None
        return [st.results[i] for i in range(st.order)]

    def run(self, requests: Sequence[Request], *, temperature: float = 0.0,
            seed: Optional[int] = None, eos_id: Any = "engine-default",
            on_iteration: Optional[Callable] = None) -> List[Completion]:
        """Serve a burst of requests (any count vs. num_slots) to
        completion: a burst schedule through ``serve``.  Invalid requests
        finish as rejected Completions.  Returns completions in request
        order; the stats are left in ``self.last_stats``."""
        eff = [(temperature if r.temperature is None else r.temperature)
               for r in requests]
        sampling = seed is not None and any(t > 0.0 for t in eff)
        max_gen = max([r.max_new_tokens for r in requests] + [1])
        return self.serve(ArrivalSchedule.burst(requests),
                          temperature=temperature, seed=seed, eos_id=eos_id,
                          on_iteration=on_iteration, _greedy=not sampling,
                          _max_gen=max_gen)

    # ------------------------------------------------------------- legacy
    def generate(self, batch: Dict[str, torch.Tensor], steps: int,
                 temperature: float = 0.0,
                 seed: Optional[int] = None) -> GenerationResult:
        """Fixed-batch generation (legacy API).  Greedy decoding runs on
        the continuous-batching engine; the enc-dec audio family,
        temperature sampling and rolling workloads where (frontend +)
        prompt + steps exceed max_len take the per-token loop
        (``_generate_per_token``).  batch: {"tokens" (B, S)[,
        "frontend_embeds" (B, F, d)]}."""
        tokens = torch.as_tensor(batch["tokens"])
        audio = self.cfg.family == "audio"
        need = (0 if audio else self.frontend) + tokens.shape[1] + steps
        if (audio or (temperature > 0.0 and seed is not None)
                or need > self.max_len):
            return self._generate_per_token(batch, steps, temperature, seed)
        rows = tokens.cpu().numpy()
        fes = batch.get("frontend_embeds")
        reqs = [Request(uid=i, tokens=rows[i].tolist(), max_new_tokens=steps,
                        frontend_embeds=(None if fes is None else
                                         torch.as_tensor(fes[i]).float()
                                         .cpu().numpy()))
                for i in range(rows.shape[0])]
        outs = self.run(reqs, temperature=0.0, eos_id=None)
        return GenerationResult(tokens=[c.tokens for c in outs], steps=steps)

    @torch.no_grad()
    def _generate_per_token(self, batch, steps, temperature, seed):
        """Under a data axis that divides the batch each data rank runs
        its rows, and the tokens come back in one all-gather."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        b = tokens.shape[0]
        dp = (self._data if self._data is not None
              and b % self._data.size == 0 else None)
        nb = b // (dp.size if dp else 1)
        lo = dp.rank * nb if dp else 0
        inputs = {"tokens": tokens[lo:lo + nb]}
        if batch.get("frontend_embeds") is not None:
            inputs["frontend_embeds"] = torch.as_tensor(
                batch["frontend_embeds"], device=self.device)[lo:lo + nb]
        caches, logits = self._prefill(self.model, inputs)
        pos0 = tokens.shape[1]
        if self.cfg.family != "audio":
            pos0 += self.frontend
        outs = []
        tok = self._sample(logits[:, -1], temperature, seed, 0, lo)
        outs.append(tok)
        for t in range(1, steps):
            caches, logits = self._decode(
                self.model, caches, tok,
                torch.tensor(pos0 + t - 1, device=self.device))
            tok = self._sample(logits[:, -1], temperature, seed, t, lo)
            outs.append(tok)
        toks = torch.stack(outs, dim=1)
        if dp is not None:
            toks = C.all_gather_flat(toks.reshape(-1), dp).reshape(b, steps)
        return GenerationResult(tokens=toks.tolist(), steps=steps)

    def _sample(self, logits, temperature, seed, t, row0: int = 0):
        """Greedy, or one draw per row from softmax(logits / temperature)
        keyed by (seed, row) at token index t (rows numbered from
        ``row0``)."""
        if temperature <= 0.0 or seed is None:
            return logits.float().argmax(-1)
        b = logits.shape[0]
        keys = torch.as_tensor([request_key(seed, row0 + i)
                                for i in range(b)], device=logits.device)
        n = torch.full((b,), t, dtype=torch.long, device=logits.device)
        return categorical(logits.float() / temperature, keys, n)
