"""Layer 1: op-level audits of the hot entrypoints (the JAX package's
``analysis/jaxpr_audit.py``; the port has no jaxpr, so it has a new name).

The paper's efficiency claims are absences — no dense dispatch buffer at
decode, no repeated GQA cache, no host sync inside the decode chunk — and
absences do not fail parity tests.  Here each registered hot entrypoint
runs once under :class:`OpLog`, a ``launch/roofline.Counter`` (a
``TorchDispatchMode``) that also keeps every aten op's output shapes, the
kernel wrappers' calls (``kernels/cost.counted``: on the CPU the wrapper
runs its plain version uncounted, so a kernel shows as one call on every
device), the live bytes after each op, the storages each op wrote in
place, and every read of device data by the host.  The run is on the CPU
at JAX's tiny shapes (2 layers, d 64, 4/2 heads of 16, d_ff 128, vocab
256, f32, capacity 8) unless ``DEVICE`` says "cuda".  Rules (stable ids):

  ops.dispatch-buffer     (JAX: jaxpr.dispatch-buffer) a decode-shaped
                          call builds a (B, G or E, C, ·) capacity buffer
  ops.cache-repeat        (JAX: jaxpr.cache-repeat) a decode attention
                          path builds a (B, Hq, S, ·) tensor with Hq > Hk
  ops.paged-gather        (JAX: jaxpr.paged-gather) a paged decode chunk
                          on the kernel tier builds a gathered (B, Hk, S,
                          ·) view (or its (B, MP, Hk, ps, ·) pre-transpose)
  ops.intermediate-budget (JAX: jaxpr.intermediate-budget) an op output
                          over a byte budget (``auto_budget``); kept for
                          tests and ad-hoc use: the per-entry byte gate at
                          HEAD is the ratchet (liveness.py, baselines.py)
  ops.host-sync           (JAX: jaxpr.forbidden-primitive) the host reads
                          device data inside an entrypoint: a scalar read
                          (``aten._local_scalar_dense``), a copy to the
                          CPU, ``.item()`` / ``.tolist()`` / ``.numpy()``
                          / ``.cpu()``, and on the card an op whose output
                          shape depends on the data (``nonzero`` ...) —
                          except inside a decode chunk's one
                          ``Engine._chunk_sync``, which must make exactly
                          one
  ops.kernel-missing      (JAX: jaxpr.kernel-missing) the dispatch switches
                          select a kernel but its wrapper was not called
  ops.kernel-present      (JAX: jaxpr.kernel-present) the kill switch (or
                          a plain override) is on but a wrapper was called
  ops.telemetry-cost      (JAX: jaxpr.telemetry-cost) telemetry "off" runs
                          more ops than the default config, or "counters"
                          no more than "off"

``kernel.accum-dtype`` (JAX: jaxpr.accum-dtype) reads the kernels'
sources, not a run: it lives in kernel_audit.py.  The kernel rules count
*distinct* kernels per entrypoint, which equal JAX's pallas_call counts
(``scripts/analysis_baselines.json``: the decode chunk 2, kernels off 0,
paged 2, the ragged prefill 1, each decode op 1).  New entrypoints
register with ``@hot_entrypoint("name")``; each returns a :class:`Run`,
memoized per device (the liveness, in-place and baseline layers read the
same runs).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch.analysis.registry import Violation, audit
from repro_torch.launch import roofline

DEVICE = "cpu"          # where the registered entrypoints run (--device)
SEED = 0

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS = os.path.dirname(os.path.abspath(__file__))
# ops whose output shape depends on the data: the card syncs to size them
_DATA_SHAPED = frozenset(("nonzero", "masked_select", "unique", "_unique",
                          "_unique2", "unique_consecutive", "unique_dim"))
_READS = ("item", "tolist", "numpy", "cpu")
_CONTRIB_KEEP = 12


def _site() -> str:
    """file:line of the innermost frame of the port outside this
    package."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PKG) and not fn.startswith(_ANALYSIS):
            return f"{os.path.relpath(fn, _PKG)}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _aval(t: torch.Tensor) -> str:
    return f"{str(t.dtype).replace('torch.', '')}{tuple(t.shape)}"


@dataclasses.dataclass(frozen=True)
class OpRecord:
    name: str
    shapes: Tuple[Tuple[int, ...], ...]
    nbytes: Tuple[int, ...]
    dtypes: Tuple[torch.dtype, ...]
    site: str
    kernel: bool = False
    fresh: bool = True       # the op allocated its outputs (no view/in place)


@dataclasses.dataclass(frozen=True)
class Contributor:
    nbytes: int
    aval: str           # dtype + shape
    label: str          # "op @ file:line", or a kernel's scratch


class OpLog(roofline.Counter):
    """A roofline counter that also records, for the run under it: every
    aten op and kernel call (``records``: output shapes and bytes, source
    line), the live temporaries after each (``timeline``), the top
    contributors at the peak (``peak_top``, ``peak_at``), the held
    storages written in place (``inplace``) and every host read of device
    data (``syncs``: (what, site, inside a declared sync window)).
    Nothing it does changes what runs."""

    def __init__(self):
        super().__init__()
        self.records: List[OpRecord] = []
        self.timeline: List[Tuple[str, int]] = []
        self.meta: Dict[int, Contributor] = {}
        self.inplace: Dict[int, int] = {}
        self.syncs: List[Tuple[str, str, bool]] = []
        self.peak_at = ""
        self.peak_top: Tuple[Contributor, ...] = ()
        self.allowed = 0        # > 0 inside a declared sync window
        self._depth = 0         # > 0 inside a patched Tensor read
        self._cur, self._where = "", ""
        self._saved: Dict[str, Callable] = {}
        self._just: Optional[weakref.ref] = None

    @property
    def peak_live_bytes(self) -> int:
        return self.arg_bytes + self.peak

    @property
    def inplace_bytes(self) -> int:
        return sum(self.inplace.values())

    def kernel_set(self) -> set:
        return set(self.kernels)

    # --------------------------------------------------------- liveness
    def _track(self, t, nbytes):
        key = id(t.untyped_storage())
        fresh = key not in self._tracked and key not in self._args
        peak = self.peak
        super()._track(t, nbytes)
        if fresh:
            self.meta[key] = Contributor(nbytes, _aval(t),
                                         f"{self._cur} @ {self._where}")
        if self.peak > peak:
            self._snapshot()

    def _release(self, key, nbytes):
        super()._release(key, nbytes)
        self.meta.pop(key, None)

    def _snapshot(self, extra: Sequence[Contributor] = ()) -> None:
        live = [self.meta[k] for k in self._tracked if k in self.meta]
        live.extend(extra)
        live.sort(key=lambda c: -c.nbytes)
        self.peak_top = tuple(live[:_CONTRIB_KEEP])
        self.peak_at = f"op {len(self.timeline)}: {self._cur} @ {self._where}"

    # ----------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused or func.namespace != "aten":
            return super().__torch_dispatch__(func, types, args, kwargs)
        name = func._overloadpacket.__name__
        self._cur = name
        self._where = _site()
        out = super().__torch_dispatch__(func, types, args, kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        fresh = not func.is_view and all(
            r.alias_info is None for r in func._schema.returns)
        self.records.append(OpRecord(
            name, tuple(tuple(t.shape) for t in outs),
            tuple(t.numel() * t.element_size() for t in outs),
            tuple(t.dtype for t in outs), self._where, fresh=fresh))
        self._note_writes(func, args, kwargs)
        if self._depth == 0 and _syncs_device(name, args, out):
            self._sync(name)
        self.timeline.append((name, self.live))
        return out

    def _note_writes(self, func, args, kwargs) -> None:
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = args[i] if i < len(args) else kwargs.get(a.name)
            if isinstance(v, torch.Tensor):
                st = v.untyped_storage()
                if id(st) in self._args:
                    self.inplace[id(st)] = st.nbytes()

    def kernel(self, name, cost, fn, args, kw):
        self._cur = name
        self._where = _site()
        out = super().kernel(name, cost, fn, args, kw)
        if cost.scratch and self.live + cost.scratch >= self.peak:
            self._snapshot([Contributor(cost.scratch, "scratch",
                                        f"{name} scratch (kernels/cost.py)")])
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.records.append(OpRecord(
            name, tuple(tuple(t.shape) for t in outs),
            tuple(t.numel() * t.element_size() for t in outs),
            tuple(t.dtype for t in outs), self._where, kernel=True))
        self.timeline.append((name, self.live + cost.scratch))
        return out

    # ----------------------------------------------------- host reads
    def _sync(self, what: str) -> None:
        self.syncs.append((what, _site(), self.allowed > 0))

    def __enter__(self):
        self._saved = _patch_reads(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _unpatch_reads(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def sync_window(self):
        """Host reads inside are declared (a chunk's one transfer)."""
        self.allowed += 1
        try:
            yield
        finally:
            self.allowed -= 1


def _patch_reads(owner) -> Dict[str, Callable]:
    """Wrap the Tensor methods that read data on the host so that each
    outer call records one read on ``owner`` (its ``_sync``); the first
    read of the tensor a ``.cpu()`` returned (its ``.numpy()``) is the
    same transfer, not a second one."""
    saved = {}
    for what in _READS:
        orig = getattr(torch.Tensor, what)
        saved[what] = orig

        def read(t, *a, _what=what, _orig=orig, **kw):
            just = owner._just() if owner._just is not None else None
            owner._just = None
            if owner._depth == 0 and not owner._paused and t is not just:
                owner._sync(_what)
            owner._depth += 1
            try:
                out = _orig(t, *a, **kw)
            finally:
                owner._depth -= 1
            if _what == "cpu" and isinstance(out, torch.Tensor):
                owner._just = weakref.ref(out)
            return out
        setattr(torch.Tensor, what, read)
    return saved


def _unpatch_reads(owner) -> None:
    for what, orig in owner._saved.items():
        setattr(torch.Tensor, what, orig)
    owner._saved = {}
    owner._just = None


def _syncs_device(name, args, out) -> bool:
    """Does aten op ``name`` read device data on the host?"""
    if name == "_local_scalar_dense":
        return True
    ins = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    on_card = any(t.device.type == "cuda" for t in ins)
    if name in ("_to_copy", "copy_") and on_card:
        dst = args[0] if name == "copy_" else out
        return isinstance(dst, torch.Tensor) and dst.device.type == "cpu"
    return on_card and name in _DATA_SHAPED


class HostReads(TorchDispatchMode):
    """Only the host reads of OpLog (``syncs``), at a fraction of its
    cost: for guarding a whole serve."""

    def __init__(self):
        super().__init__()
        self.syncs: List[Tuple[str, str, bool]] = []
        self.allowed = 0
        self._depth = 0
        self._paused = 0
        self._saved: Dict[str, Callable] = {}
        self._just: Optional[weakref.ref] = None

    def _sync(self, what: str) -> None:
        self.syncs.append((what, _site(), self.allowed > 0))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth == 0 and _syncs_device(
                func._overloadpacket.__name__, args, out):
            self._sync(func._overloadpacket.__name__)
        return out

    def __enter__(self):
        self._saved = _patch_reads(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _unpatch_reads(self)
        return super().__exit__(*exc)


# ------------------------------------------------------------ rule bodies
def dispatch_buffer_violations(log: OpLog, batch: int, groups: int,
                               entry: str, widths: Sequence[int] = ()
                               ) -> List[Violation]:
    """Any 4-d output (batch, groups, ·, ·) is a resurrected capacity
    dispatch buffer: decode-shaped calls index weight blocks directly.
    ``widths``: the rows' widths such a buffer has (d_model, the group's
    F), where the kv heads could equal the groups (qwen3: 8 and 8)."""
    out = []
    for r in log.records:
        for shape in r.shapes:
            if (len(shape) == 4 and shape[0] == batch and shape[1] == groups
                    and (not widths or shape[3] in widths)):
                out.append(Violation(
                    "ops.dispatch-buffer", entry,
                    f"{r.name} builds dispatch-shaped {shape} (B={batch}, "
                    f"G={groups}) at {r.site}"))
    return out


def cache_repeat_violations(log: OpLog, num_q_heads: int, num_kv_heads: int,
                            min_seq: int, entry: str) -> List[Violation]:
    """A (B, Hq, S, ·) output with Hq > Hk and S at cache length: the GQA
    cache (or its codes) expanded to the query heads."""
    if num_q_heads <= num_kv_heads:
        return []
    out = []
    for r in log.records:
        for shape in r.shapes:
            if (len(shape) == 4 and shape[1] == num_q_heads
                    and shape[2] >= min_seq):
                out.append(Violation(
                    "ops.cache-repeat", entry,
                    f"{r.name} expands a cache to {shape} (Hq={num_q_heads}"
                    f" > Hk={num_kv_heads}, S>={min_seq}) at {r.site}"))
    return out


def paged_gather_violations(log: OpLog, batch: int, num_kv_heads: int,
                            view: int, page_size: int, max_pages: int,
                            entry: str) -> List[Violation]:
    """A (B, Hk, >=view, ·) output, or its (B, MP, Hk, ps, ·)
    pre-transpose, inside a paged decode chunk on the kernel tier."""
    out = []
    for r in log.records:
        for shape in r.shapes:
            gathered = (len(shape) == 4 and shape[0] == batch
                        and shape[1] == num_kv_heads and shape[2] >= view)
            pre_t = (len(shape) == 5 and shape[0] == batch
                     and shape[1] == max_pages and shape[2] == num_kv_heads
                     and shape[3] == page_size)
            if gathered or pre_t:
                out.append(Violation(
                    "ops.paged-gather", entry,
                    f"{r.name} builds a gathered per-slot KV view {shape} "
                    f"(B={batch}, Hk={num_kv_heads}, view={view}) at "
                    f"{r.site}"))
    return out


def big_intermediate_violations(log: OpLog, max_bytes: int,
                                entry: str) -> List[Violation]:
    out = []
    for r in log.records:
        for shape, nb in zip(r.shapes, r.nbytes):
            if nb > max_bytes:
                out.append(Violation(
                    "ops.intermediate-budget", entry,
                    f"{r.name} builds {shape} = {nb} B (budget {max_bytes} "
                    f"B) at {r.site}"))
    return out


def auto_budget(*trees, factor: float = 1.5) -> int:
    """``factor`` x the largest tensor under ``trees`` (the call's
    operands): a decode step that builds more is materializing something
    the paper says it avoids."""
    biggest = max((t.numel() * t.element_size()
                   for tree in trees for t in roofline.tensors_of(tree)),
                  default=0)
    return int(biggest * factor)


def host_sync_violations(log: OpLog, entry: str,
                         windows: Optional[int] = None) -> List[Violation]:
    """Every host read outside a declared window; with ``windows`` (the
    chunks run), also a window that did not make exactly one read."""
    out = [Violation("ops.host-sync", entry,
                     f"{what} reads device data on the host at {site}")
           for what, site, allowed in log.syncs if not allowed]
    if windows is not None:
        inside = sum(1 for *_, allowed in log.syncs if allowed)
        if inside != windows:
            out.append(Violation(
                "ops.host-sync", entry,
                f"{inside} host reads inside {windows} chunk sync(s); each "
                "chunk brings its state back in exactly one"))
    return out


def kernel_count_violations(log: OpLog, entry: str, expect: str,
                            exact: Optional[Sequence[str]] = None
                            ) -> List[Violation]:
    """expect: "some" (the switches select kernels), "none" (kill switch
    or a plain override), or "exact" (the distinct kernels ``exact``)."""
    got = log.kernel_set()
    if expect == "some" and not got:
        return [Violation("ops.kernel-missing", entry,
                          "dispatch selected the kernel path but no kernel "
                          "wrapper was called")]
    if expect == "none" and got:
        return [Violation("ops.kernel-present", entry,
                          f"{sorted(got)} called with kernels switched off")]
    if expect == "exact":
        want = set(exact or ())
        out = []
        if want - got:
            out.append(Violation("ops.kernel-missing", entry,
                                 f"expected {sorted(want - got)} to be "
                                 f"called; got {sorted(got)}"))
        if got - want:
            out.append(Violation("ops.kernel-present", entry,
                                 f"{sorted(got - want)} called beyond the "
                                 f"expected {sorted(want)}"))
        return out
    return []


# --------------------------------------------------------- hot entrypoints
@dataclasses.dataclass
class Run:
    """One entrypoint's run: its log and what the rules need
    (``info``).  ``before`` / ``after``: {cache path: (storage id,
    data_ptr)} of the engine's caches around the call (the in-place
    audit); ``chunks``: decode chunks run (their sync windows);
    ``card_growth``: the card's ``max_memory_allocated`` rise over the
    call; ``sync_sites``: file:line of each synchronizing CUDA call of the
    chunk under ``set_sync_debug_mode`` on the card."""
    entry: str
    log: OpLog
    info: dict
    before: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    after: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    chunks: Optional[int] = None
    card_growth: Optional[int] = None
    sync_sites: Optional[List[str]] = None


ENTRYPOINTS: Dict[str, Callable[..., Run]] = {}
_RULES: Dict[str, Callable[[Run], List[Violation]]] = {}
_RUNS: Dict[Tuple[str, str], Run] = {}


def hot_entrypoint(name: str, rules: Callable[[Run], List[Violation]]):
    def register(fn):
        if name in ENTRYPOINTS:
            raise ValueError(f"duplicate hot entrypoint {name!r}")
        ENTRYPOINTS[name] = fn
        _RULES[name] = rules
        return fn
    return register


def run_entry(name: str, device: Optional[str] = None) -> Run:
    """The memoized run of entrypoint ``name`` on ``device``."""
    dev = device or DEVICE
    key = (name, dev)
    if key not in _RUNS:
        _RUNS[key] = ENTRYPOINTS[name](dev)
    return _RUNS[key]


def entry_violations(name: str, device: Optional[str] = None
                     ) -> List[Violation]:
    return _RULES[name](run_entry(name, device))


@contextlib.contextmanager
def kill_switch(on: bool = True):
    """REPRO_DISABLE_KERNELS=1 around a run (read at call time by
    core/dispatch.py)."""
    prev = os.environ.get("REPRO_DISABLE_KERNELS")
    if on:
        os.environ["REPRO_DISABLE_KERNELS"] = "1"
    else:
        os.environ.pop("REPRO_DISABLE_KERNELS", None)
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("REPRO_DISABLE_KERNELS", None)
        else:
            os.environ["REPRO_DISABLE_KERNELS"] = prev


def tiny_cfg(**spt):
    """JAX's audit shape: the qwen3 smoke at 2 layers, d 64, 4/2 heads of
    16, d_ff 128, vocab 256, in f32, routed-FFN capacity 8."""
    cfg = dataclasses.replace(
        configs.get_smoke("qwen3-0.6b"), num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=256, dtype=torch.float32)
    return cfg.with_spt(ffn_capacity_factor=8.0, **spt)


def tiny_model(cfg, device):
    """Random weights from ``SEED`` in the config's dtype (the frozen
    weights' defs are bf16; an f32 config casts them, as the port's f32
    runs do, so that the kernels see one float type)."""
    from repro_torch.models import transformer
    dev = transformer.resolve_device(device)
    return transformer.LM.init(cfg, seed=SEED, device=dev).to(cfg.dtype)


def _storages(tree, prefix: str) -> Dict[str, Tuple[int, int]]:
    out = {}

    def walk(t, path):
        if isinstance(t, torch.Tensor):
            out[path] = (id(t.untyped_storage()), t.data_ptr())
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}.{k}")
    walk(tree, prefix)
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def engine_chunk_run(entry: str, cfg, device, *, slots: int = 2,
                     max_len: int = 32, gen: int = 6, prompt: int = 9,
                     decode_chunk: int = 4, model=None,
                     sync_debug: bool = False) -> Run:
    """The engine's first decode chunk exactly as ``Engine.run`` runs it
    (after one admission filled every slot), under an OpLog: the model's
    weights, the caches and (paged) the page table and allocator held as
    the arguments; ``_chunk_sync`` the one declared sync window.  The
    first admission (ragged prefill and slot writes) runs under an OpLog
    of its own: ``info["admit"]``, a Run.  On the card ``sync_debug``
    also runs ``Engine._chunk`` under ``set_sync_debug_mode("warn")`` and
    keeps each warning's source line (each blocking host-to-device upload
    of the slot state warns once; anything else is a sync)."""
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine, Request

    dev = transformer.resolve_device(device)
    if model is None:
        model = tiny_model(cfg, dev)
    eng = Engine(cfg, model, max_len=max_len, num_slots=slots,
                 decode_chunk=decode_chunk, device=dev)
    log = OpLog()
    run = Run(entry, log, dict(cfg=cfg, slots=slots, max_len=max_len))
    orig_once, orig_sync, orig_chunk, orig_admit = (
        eng._decode_once, eng._chunk_sync, eng._chunk, eng._admit)

    def chunk_sync(*a, **kw):
        with log.sync_window():
            return orig_sync(*a, **kw)

    def chunk(*a, **kw):
        if not (sync_debug and dev.type == "cuda"):
            return orig_chunk(*a, **kw)
        import warnings
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = orig_chunk(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        run.sync_sites = [
            f"{os.path.relpath(w.filename, _PKG)}:{w.lineno}"
            for w in caught if "synchroniz" in str(w.message)]
        return out

    def decode_once():
        if run.chunks is not None:
            return orig_once()
        st = eng._live
        held = dict(caches=st.caches)
        if st.page_table is not None:
            held.update(page_table=st.page_table, astate=st.astate)
        run.before = _storages(st.caches, "caches")
        log.hold(model, held)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        with log:
            orig_once()
        _sync(dev)
        if dev.type == "cuda":
            run.card_growth = torch.cuda.max_memory_allocated() - base
        run.after = _storages(st.caches, "caches")
        run.chunks = 1
        run.info["caches"] = st.caches
        return None

    def admit(group):
        if "admit" in run.info:
            return orig_admit(group)
        st = eng._live
        alog = OpLog()
        held = dict(caches=st.caches)
        if st.page_table is not None:
            held.update(page_table=st.page_table, astate=st.astate)
        before = _storages(st.caches, "caches")
        alog.hold(model, held)
        info = dict(cfg=cfg, caches=st.caches)
        orig_group = eng._prefill_group

        def prefill_group(*a, **kw):
            out = orig_group(*a, **kw)
            info["rows_bytes"] = roofline.storage_bytes(out[0])
            info["prefill_peak"] = alog.peak
            return out
        eng._prefill_group = prefill_group
        try:
            with alog:
                orig_admit(group)
        finally:
            eng._prefill_group = orig_group
        arun = Run(entry.replace("decode_chunk", "admit"), alog, info,
                   before=before, after=_storages(st.caches, "caches"))
        run.info["admit"] = arun
        return None

    eng._decode_once, eng._chunk_sync, eng._chunk, eng._admit = (
        decode_once, chunk_sync, chunk, admit)
    rng = np.random.default_rng(SEED)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size,
                                               size=prompt).tolist(),
                    max_new_tokens=gen) for i in range(slots)]
    eng.run(reqs)
    if run.chunks is None:
        raise RuntimeError(f"{entry}: the run made no decode chunk")
    run.info.update(paged=eng._paged, page_size=eng.page_size,
                    max_pages=getattr(eng, "max_pages_per_slot", 0),
                    model=model, engine=eng)
    return run


def _chunk_rules(run: Run, expect: str,
                 exact: Sequence[str] = ()) -> List[Violation]:
    cfg = run.info["cfg"]
    entry = run.entry
    out = host_sync_violations(run.log, entry, windows=run.chunks)
    out += kernel_count_violations(run.log, entry, expect, exact)
    if expect != "none":          # the plain paths upload Python scalars
        out += sync_debug_violations(run)
    if expect != "none":
        out += dispatch_buffer_violations(
            run.log, run.info["slots"], cfg.spt.ffn_groups, entry,
            (cfg.d_model, cfg.d_ff // cfg.spt.ffn_groups))
    if run.info["paged"]:
        from repro_torch.serving import kv_pages as kvp
        ps = run.info["page_size"]
        view = kvp.view_len(run.info["max_len"], ps)
        if expect != "none":
            out += paged_gather_violations(
                run.log, run.info["slots"], cfg.num_kv_heads, view, ps,
                run.info["max_pages"], entry)
        out += cache_repeat_violations(run.log, cfg.num_heads,
                                       cfg.num_kv_heads, view, entry)
    else:
        out += cache_repeat_violations(run.log, cfg.num_heads,
                                       cfg.num_kv_heads,
                                       run.info["max_len"], entry)
    return out


def chunk_upload_lines() -> set:
    """file:line of ``Engine._chunk``'s uploads of the slot state, ahead
    of its step loop: blocking host-to-device copies, each of which
    ``set_sync_debug_mode`` reports once a chunk."""
    import inspect
    from repro_torch.serving.engine import Engine
    lines, start = inspect.getsourcelines(Engine._chunk)
    rel = os.path.relpath(inspect.getsourcefile(Engine._chunk), _PKG)
    out = set()
    for i, text in enumerate(lines):
        if "for _ in range(steps)" in text:
            break
        if "torch.as_tensor(" in text:
            out.add(f"{rel}:{start + i}")
    return out


def sync_debug_violations(run: Run) -> List[Violation]:
    """On the card, kernel tier: every synchronizing CUDA call of the
    chunk is one of its slot-state uploads (no device-to-host sync)."""
    if run.sync_sites is None:
        return []
    declared = chunk_upload_lines()
    extra = [s for s in run.sync_sites if s not in declared]
    if extra:
        return [Violation(
            "ops.host-sync", run.entry,
            f"{len(extra)} synchronizing CUDA call(s) in the chunk under "
            f"set_sync_debug_mode beyond its {len(declared)} slot-state "
            f"uploads: {sorted(set(extra))}")]
    return []


DECODE_KERNELS = ("fused_sparse_decode_attention", "decode_ffn")
PAGED_KERNELS = ("fused_sparse_decode_attention_paged", "decode_ffn")
PREFILL_KERNELS = ("grouped_ffn",)
DECODE_SPT = dict(decode_attn_impl="kernel", ffn_impl="pallas")
PAGED_SPT = dict(decode_attn_impl="kernel", attn_impl="pallas",
                 ffn_impl="pallas", kv_layout="paged", kv_page_size=16)


@hot_entrypoint("engine.decode_chunk",
                lambda r: _chunk_rules(r, "exact", DECODE_KERNELS))
def _decode_chunk(device) -> Run:
    return engine_chunk_run("engine.decode_chunk[kernel]",
                            tiny_cfg(**DECODE_SPT), device)


@hot_entrypoint("engine.decode_chunk_kernels_off",
                lambda r: _chunk_rules(r, "none"))
def _decode_chunk_off(device) -> Run:
    """REPRO_DISABLE_KERNELS=1 demotes the same chunk to the plain paths:
    no kernel wrapper may be called."""
    with kill_switch():
        return engine_chunk_run("engine.decode_chunk[kernels-off]",
                                tiny_cfg(**DECODE_SPT), device)


def _telemetry_rules(run: Run) -> List[Violation]:
    n = run.info["ops"]
    out = []
    if n["off"] != n["default"]:
        out.append(Violation(
            "ops.telemetry-cost", run.entry,
            f"telemetry=off chunk runs {n['off']} ops vs {n['default']} "
            "for the default config — the off path must be zero-cost"))
    if n["counters"] <= n["off"]:
        out.append(Violation(
            "ops.telemetry-cost", run.entry,
            "telemetry=counters chunk runs no more ops than off — the "
            "counters are not accumulating"))
    return out + host_sync_violations(run.log, run.entry, run.chunks)


@hot_entrypoint("engine.decode_chunk_telemetry", _telemetry_rules)
def _decode_chunk_telemetry(device) -> Run:
    base = tiny_cfg()
    runs = {tag: engine_chunk_run(f"engine.decode_chunk[telemetry {tag}]",
                                  cfg, device)
            for tag, cfg in (("default", base),
                             ("off", base.with_spt(telemetry="off")),
                             ("counters",
                              base.with_spt(telemetry="counters")))}
    run = runs["counters"]
    run.entry = "engine.decode_chunk[telemetry]"
    run.info["ops"] = {k: r.log.aten_ops for k, r in runs.items()}
    return run


@hot_entrypoint("engine.prefill_ragged", lambda r: (
    host_sync_violations(r.log, r.entry)
    + kernel_count_violations(r.log, r.entry, "exact", PREFILL_KERNELS)))
def _prefill_ragged(device) -> Run:
    """The batched ragged prefill of an admission group: no host read,
    and kernel 9 when ffn_impl="pallas" (no byte rule: a prefill builds
    (B, G, C, d) capacity buffers and S x S score tiles)."""
    from repro_torch.models import transformer
    cfg = tiny_cfg(ffn_impl="pallas")
    dev = transformer.resolve_device(device)
    model = tiny_model(cfg, dev)
    rng = np.random.default_rng(SEED)
    bpb, s, max_len = 2, 16, 32
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    size=(bpb, s)),
                                       device=dev)}
    lengths = torch.as_tensor(np.array([s, 11]), device=dev)
    log = OpLog().hold(model, batch, lengths)
    with torch.no_grad(), log:
        out = transformer.lm_prefill_ragged(model, cfg, batch, lengths,
                                            max_len)
    log.outputs(out)
    return Run("engine.prefill_ragged", log, dict(cfg=cfg))


def _sparse_decode_operands(device):
    """(b, hq, hk, s, d), config, codebooks and operands of a one-token
    decode at a serving-representative shape (JAX's)."""
    from repro_torch.core import pq
    from repro_torch.core import sparse_attention as sa
    from repro_torch.core.params import init_tree
    b, hq, hk, s, d, m = 4, 8, 2, 256, 64, 8
    pcfg = pq.PQConfig(head_dim=d, code_dim=m, num_codewords=16)
    gen = torch.Generator(device=device).manual_seed(SEED)
    cb = init_tree(pq.param_defs(pcfg), gen)["codebooks"].to(device)
    scfg = sa.SparseAttentionConfig(pq=pcfg, top_fraction=0.25, min_l=4)
    q = torch.randn(b, hq, 1, d, generator=gen, device=device)
    k = torch.randn(b, hk, s, d, generator=gen, device=device)
    v = torch.randn(b, hk, s, d, generator=gen, device=device)
    codes = torch.randint(0, 16, (b, hk, s, d // m), generator=gen,
                          device=device).to(torch.int8)
    kv_valid = torch.ones(b, s, dtype=torch.bool, device=device)
    return (b, hq, hk, s, d), scfg, cb, q, k, v, codes, kv_valid


def _sparse_decode_run(entry: str, device, fuse: bool) -> Run:
    from repro_torch.kernels.sparse_attention import ops as sa_ops
    dims, scfg, cb, q, k, v, codes, kv = _sparse_decode_operands(device)
    log = OpLog().hold(q, k, v, codes, cb, kv)
    with torch.no_grad(), log:
        out = sa_ops.sparse_mha_decode(q, k, v, codes, cb, scfg,
                                       dims[4] ** -0.5, kv, fuse=fuse)
    log.outputs(out)
    return Run(entry, log, dict(dims=dims))


def _sparse_decode_rules(exact):
    def rules(run: Run) -> List[Violation]:
        b, hq, hk, s, d = run.info["dims"]
        return (kernel_count_violations(run.log, run.entry, "exact", exact)
                + host_sync_violations(run.log, run.entry)
                + cache_repeat_violations(run.log, hq, hk, s, run.entry))
    return rules


@hot_entrypoint("ops.sparse_mha_decode", _sparse_decode_rules(
    ("fused_sparse_decode_attention",)))
def _sparse_mha_decode(device) -> Run:
    """The one-pass decode attention op: exactly one kernel (the
    histogram and the attention in one launch), no GQA expansion."""
    return _sparse_decode_run("ops.sparse_mha_decode[fused]", device, True)


@hot_entrypoint("ops.sparse_mha_decode_two_pass", _sparse_decode_rules(
    ("decode_topl_thresholds", "sparse_decode_attention")))
def _sparse_mha_decode_two_pass(device) -> Run:
    """The bisection tier: fuse=False calls the thresholds and attention
    kernels (3 then 5), with the same shape discipline."""
    return _sparse_decode_run("ops.sparse_mha_decode[two-pass]", device,
                              False)


@hot_entrypoint("engine.decode_chunk_paged",
                lambda r: _chunk_rules(r, "exact", PAGED_KERNELS))
def _decode_chunk_paged(device) -> Run:
    """Paged layout, kernel tier: the chunk reads the pools through the
    page table (kernel 7), with no gathered per-slot view."""
    return engine_chunk_run("engine.decode_chunk[paged-native]",
                            tiny_cfg(**PAGED_SPT), device)


def _routed_decode_rules(run: Run) -> List[Violation]:
    b, g = run.info["batch"], run.info["groups"]
    return (kernel_count_violations(run.log, run.entry, "exact",
                                    ("decode_ffn",))
            + dispatch_buffer_violations(run.log, b, g, run.entry)
            + host_sync_violations(run.log, run.entry))


@hot_entrypoint("ops.routed_ffn_decode", _routed_decode_rules)
def _routed_ffn_decode(device) -> Run:
    """Block-gather decode FFN: one kernel, no (B, G, C, d) buffer."""
    from repro_torch.core import lora as lora_mod
    from repro_torch.core import routed_ffn as rf
    from repro_torch.core.params import init_tree
    from repro_torch.kernels.routed_ffn import ops as rffn_ops
    b, d, dff, g, gp = 4, 64, 128, 8, 2
    lcfg = lora_mod.LoRAConfig(rank=4, alpha=4.0, enabled=True)
    rcfg = rf.RoutedFFNConfig(d_model=d, d_ff=dff, num_groups=g,
                              active_groups=gp, capacity_factor=4.0,
                              gated=True, activation="gelu")
    gen = torch.Generator(device=device).manual_seed(SEED)
    p = init_tree(rf.param_defs(rcfg, lcfg), gen)
    p = {k: (v.to(device, torch.float32) if isinstance(v, torch.Tensor)
             else {kk: vv.to(device, torch.float32) for kk, vv in v.items()})
         for k, v in p.items()}
    x = torch.randn(b, 1, d, generator=gen, device=device)
    log = OpLog().hold(p, x)
    with torch.no_grad(), log:
        out = rffn_ops.routed_ffn_decode(x, p, rcfg, lcfg)[0]
    log.outputs(out)
    return Run("ops.routed_ffn_decode", log, dict(batch=b, groups=g))


def _moe_rules(run: Run) -> List[Violation]:
    return (dispatch_buffer_violations(run.log, run.info["batch"],
                                       run.info["groups"], run.entry)
            + kernel_count_violations(run.log, run.entry, "exact",
                                      ("decode_ffn",))
            + host_sync_violations(run.log, run.entry))


@hot_entrypoint("models.moe_decode", _moe_rules)
def _moe_decode(device) -> Run:
    """MoE decode through the block-gather kernel: expert ids index
    weight blocks directly — no (B, E, C, d) capacity buffer."""
    from repro_torch.core.params import init_tree
    from repro_torch.models import moe
    cfg = configs.get_smoke("grok-1-314b").with_spt(ffn_impl="pallas")
    gen = torch.Generator(device=device).manual_seed(SEED)
    p = init_tree(moe.moe_defs(cfg), gen)
    b = 4
    x = torch.randn(b, 1, cfg.d_model, generator=gen,
                    device=device).to(cfg.dtype)
    log = OpLog().hold(p, x)
    with torch.no_grad(), log:
        out = moe.moe_apply(p, x, cfg, mode="decode")[0]
    log.outputs(out)
    return Run("models.moe_decode", log, dict(batch=b,
                                              groups=cfg.num_experts))


@audit("ops")
def _ops_audit() -> List[Violation]:
    out: List[Violation] = []
    for name in ENTRYPOINTS:
        out.extend(entry_violations(name))
    return out
