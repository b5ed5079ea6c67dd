"""Layer 3: runtime guard of the serving engine's host syncs and rebuilds
(the JAX package's ``analysis/trace_guard.py``).

JAX's serving story rests on "the generation traces once": its guard
counts jit-cache growth against call-signature buckets.  The port does
not trace; its counterparts are the two things that silently multiply a
decode loop's cost while every output stays right:

  trace.host-sync  (JAX: trace.retrace) the engine reads device data on
                   the host more often in a scheduling iteration than it
                   ran decode chunks (one ``_chunk_sync`` each) and
                   admission prefill groups (one ``_admit_sync`` each),
                   plus, paged, the one read of the pool's stack top that
                   records the peak pages (``Engine._track_peak``, as
                   JAX's engine reads it every iteration)
  trace.rebuild    (JAX: trace.per-iteration-jit) the kernel library was
                   built or loaded again while it was loaded, or a module
                   (``torch.nn.Module``) was constructed inside the
                   serving loop — a model or kernel plan rebuilt per
                   iteration

A host read is what ``op_audit.HostReads`` (and ``OpLog``) counts: a scalar read
(``_local_scalar_dense``), a copy to the CPU, ``.item()`` / ``.tolist()``
/ ``.numpy()`` / ``.cpu()``, and on the card an op whose output shape
depends on the data.  ``guard_engine(engine)`` instruments a live Engine
for a ``with`` block and raises on violations at exit (on the card the
op audit also runs the decode chunk under
``torch.cuda.set_sync_debug_mode``: ``op_audit.engine_chunk_run``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.analysis import op_audit
from repro_torch.analysis.op_audit import HostReads
from repro_torch.analysis.registry import Violation, audit


@dataclasses.dataclass
class Iteration:
    syncs: int = 0
    chunks: int = 0
    groups: int = 0
    sites: tuple = ()


class Guard:
    """Per-iteration sync counts, module constructions and library loads
    of a guarded engine."""

    def __init__(self, engine):
        self.engine = engine
        self.iterations: List[Iteration] = []
        self.modules: List[str] = []
        self.builds = 0
        self.loaded = kernels._lib is not None

    def violations(self) -> List[Violation]:
        out = []
        paged = 1 if self.engine._paged else 0
        for i, it in enumerate(self.iterations):
            allowed = it.chunks + it.groups + paged
            if it.syncs > allowed:
                out.append(Violation(
                    "trace.host-sync", f"iteration {i}",
                    f"{it.syncs} host reads against {it.chunks} chunk(s) + "
                    f"{it.groups} prefill group(s)"
                    + (" + the peak-pages read" if paged else "")
                    + f": {', '.join(it.sites)}"))
        if self.builds > (0 if self.loaded else 1):
            out.append(Violation(
                "trace.rebuild", "kernels.build",
                f"the kernel library was built {self.builds} time(s) in the "
                "serving loop" + (" after it was loaded" if self.loaded
                                  else "")))
        if self.modules:
            out.append(Violation(
                "trace.rebuild", "serving loop",
                f"{len(self.modules)} module(s) constructed while serving: "
                f"{sorted(set(self.modules))[:4]}"))
        return out


@contextlib.contextmanager
def guard_engine(engine, raise_on_violation: bool = True):
    """Instrument a live ``serving.engine.Engine`` for the with-block:
    each scheduling iteration's host reads, decode chunks and admission
    groups, the modules constructed and the kernel library's builds; at
    exit, violations raise (or stay on ``guard.violations()`` with
    ``raise_on_violation=False``)."""
    guard = Guard(engine)
    log = HostReads()
    saved = {k: getattr(engine, k) for k in ("_iterate", "_admit",
                                             "_decode_once")}
    cur = {"it": None}

    def iterate(*a, **kw):
        it = Iteration()
        cur["it"] = it
        n0 = len(log.syncs)
        try:
            return saved["_iterate"](*a, **kw)
        finally:
            new = log.syncs[n0:]
            it.syncs = len(new)
            it.sites = tuple(f"{w} @ {s}" for w, s, _ in new)
            guard.iterations.append(it)
            cur["it"] = None

    def admit(group):
        if cur["it"] is not None:
            cur["it"].groups += 1
        return saved["_admit"](group)

    def decode_once():
        if cur["it"] is not None:
            cur["it"].chunks += 1
        return saved["_decode_once"]()

    orig_init, orig_build = torch.nn.Module.__init__, kernels.build

    def module_init(mod, *a, **kw):
        guard.modules.append(type(mod).__name__)
        return orig_init(mod, *a, **kw)

    def build(*a, **kw):
        guard.builds += 1
        return orig_build(*a, **kw)

    engine._iterate, engine._admit, engine._decode_once = (iterate, admit,
                                                           decode_once)
    torch.nn.Module.__init__ = module_init
    kernels.build = build
    try:
        with log:
            yield guard
    finally:
        for k, v in saved.items():
            setattr(engine, k, v)
        torch.nn.Module.__init__ = orig_init
        kernels.build = orig_build
    if raise_on_violation:
        vs = guard.violations()
        if vs:
            raise RuntimeError("trace guard violations:\n  "
                               + "\n  ".join(str(v) for v in vs))


def serve_workload(engine, vocab: int, seed: int = 0) -> None:
    """JAX's trace workload: a burst ``Engine.run`` of three requests, then
    the long-lived ``serve`` of six Poisson arrivals on a ManualClock with
    a mid-stream cancel and a forced preemption whose victim re-admits by
    recompute."""
    from repro_torch.serving.engine import (ArrivalSchedule, ManualClock,
                                            Request)
    rng = np.random.default_rng(seed)
    reqs = [Request(uid=i, tokens=rng.integers(0, vocab, size=n).tolist(),
                    max_new_tokens=4) for i, n in enumerate([5, 9, 12])]
    arrivals = [Request(uid=10 + i, priority=i % 2,
                        tokens=rng.integers(0, vocab, size=n).tolist(),
                        max_new_tokens=6)
                for i, n in enumerate([4, 7, 11, 6, 9, 13])]
    fired = {"preempt": False}

    def chaos(e, iteration):
        if iteration == 3:
            e.cancel(12)
        if iteration >= 4 and not fired["preempt"]:
            fired["preempt"] = e.preempt()

    engine.run(reqs)
    engine.serve(ArrivalSchedule.poisson(arrivals, 4.0, seed=seed),
                 clock=ManualClock(dt=0.25), on_iteration=chaos)


def engine_violations(device=None, paged: bool = False) -> List[Violation]:
    """The trace workload on the tiny config (contiguous, or paged on
    pages of 16) under the guard."""
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine
    dev = transformer.resolve_device(device or op_audit.DEVICE)
    spt = dict(kv_layout="paged", kv_page_size=16) if paged else {}
    cfg = op_audit.tiny_cfg(**spt)
    model = op_audit.tiny_model(cfg, dev)
    eng = Engine(cfg, model, max_len=32, num_slots=2, decode_chunk=4,
                 device=dev)
    with guard_engine(eng, raise_on_violation=False) as guard:
        serve_workload(eng, cfg.vocab_size)
    tag = "paged" if paged else "contiguous"
    return [dataclasses.replace(v, entry=f"{tag} {v.entry}")
            for v in guard.violations()]


@audit("trace")
def _trace_audit() -> List[Violation]:
    return engine_violations() + engine_violations(paged=True)
