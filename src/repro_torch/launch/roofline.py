"""Roofline model of a step on one H100 (the JAX package's
``launch/roofline.py`` without its XLA HLO parsers).

Three terms per step, in seconds on one card:

    compute    = FLOPs        / PEAK_FLOPS (bf16)
    memory     = HBM bytes    / HBM_BW
    collective = collective bytes / NVLINK_BW

and ``model_flops`` / ``active_params``, the 6 N D convention on a
config, equal to JAX's for every config.  The constants are NVIDIA's
datasheet peaks for the H100 SXM part ("H100 80GB HBM3", 700 W; dense
rates, no sparsity), not measurements: a card set below 700 W runs
slower under load.  The collective term takes the payload over one
direction of the card's NVLink (900 GB/s both directions together), a
comparison metric like JAX's, not a wall-clock prediction.

JAX reads the terms off a compiled HLO module (``cost_analysis``,
``hbm_traffic``, ``collective_bytes``).  The port counts the ops it runs
instead: :class:`Counter` is a ``TorchDispatchMode`` that tallies, for
every aten op under it,

  * FLOPs by torch's own formulas (``torch.utils.flop_counter``: the
    matmuls, convolutions and attention ops; elementwise ops count 0);
  * HBM bytes: the input plus output bytes of every op that is neither a
    view nor an allocation (the eager counterpart of XLA's per-op bytes
    accessed; every op reads its inputs from and writes its outputs to
    device memory);
  * the kernels' costs (``kernels/cost.py``: each wrapper records its own
    and runs uncounted, so a kernel counts by its formula on every
    device);
  * collective bytes by kind (``core/collectives.py`` records each
    collective's result bytes, JAX's convention, through
    ``kernels/cost.record_collective``);
  * live and peak bytes: a storage's bytes are added when an op creates
    it and subtracted when its last reference dies (a weakref
    finalizer), the kernels' scratch counted while they run; the step's
    arguments (``hold``) are counted apart.

``analyze(counter)`` gives the :class:`Roofline` of what it counted.  It
runs on any device: on the card, on the CPU, and on the meta device,
where a dry run (launch/dryrun.py) traces a step without data.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry as _FLOPS

from repro_torch import kernels
from repro_torch.kernels import cost
# the datasheet rates live beside the kernels' counts, which use them too
from repro_torch.kernels.cost import HBM_BW, PEAK_FLOPS, PEAK_FLOPS_F32

NVLINK_BW = 450e9            # bytes/s, one direction


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, int]
    peak_memory: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time: max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "coll_by_kind": self.coll_by_kind,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "t_bound": self.t_bound, "peak_memory": self.peak_memory,
        }


# ------------------------------------------------------------- counting
_ALLOC = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                    "new_empty_strided", "empty_permuted"))
# ops that move no data though their schema does not say they alias
_NO_TRAFFIC = frozenset(("_unsafe_view", "lift_fresh", "detach", "alias"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_TO_COPY = torch.ops.aten._to_copy.default


def _host_to_cpu_target(src: torch.Tensor, out) -> bool:
    """A host tensor (e.g. the step counter) moved to the meta device
    where meta tensors stand for the CPU: on the CPU the same ``.to`` is
    no op at all."""
    return (src.device.type == "cpu" and isinstance(out, torch.Tensor)
            and out.is_meta and out.dtype == src.dtype
            and kernels.target(out) == "cpu")


def tensors_of(obj, seen=None):
    """Every tensor reachable from ``obj``: a tensor, dicts, lists and
    tuples of them, and the attributes of objects (an ``nn.Module``'s
    parameters and buffers, a ``ShardedLM``'s trees)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors_of(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors_of(v, seen)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        for v in vars(obj).values():
            yield from tensors_of(v, seen)


def storage_bytes(*objs) -> int:
    """Bytes of the distinct storages under ``objs`` (a storage shared by
    several tensors counts once)."""
    seen: Dict[int, int] = {}
    for obj in objs:
        for t in tensors_of(obj):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


class Counter(TorchDispatchMode):
    """Counts what runs under it (module docstring): ``flops``,
    ``hbm_bytes`` (by op: ``bytes_by_op``), ``kernels`` ({name: {"calls",
    "bytes", "ops"}}), ``coll_by_kind``, and memory — ``hold`` the step's
    arguments first, ``outputs`` its results after, then ``memory()``.
    One counter is active at a time (``kernels/cost.ACTIVE``, where the
    kernel wrappers and the collectives find it), for every thread:
    autograd's backward threads see its dispatch mode and that global
    alike.
    Nothing it does changes what runs: every op executes as it would
    without it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.bytes_by_op: Dict[str, int] = {}
        self.aten_ops = 0
        self.kernels: Dict[str, Dict[str, Any]] = {}
        self.coll_by_kind: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self.arg_bytes = 0
        self.out_bytes = 0
        self.alias_bytes = 0
        self._args: Dict[int, int] = {}
        self._tracked: Dict[int, int] = {}
        self._paused = 0
        self._prev: Optional[Counter] = None

    # ---------------------------------------------------------- memory
    def hold(self, *objs) -> "Counter":
        """Count the tensors under ``objs`` as the step's arguments."""
        for t in (t for obj in objs for t in tensors_of(obj)):
            st = t.untyped_storage()
            if id(st) not in self._args:
                self._args[id(st)] = st.nbytes()
                self.arg_bytes += st.nbytes()
        return self

    def outputs(self, *objs) -> "Counter":
        """Count the tensors under ``objs`` as the step's results: their
        bytes, and those that are arguments' storages (aliases)."""
        seen = set()
        for t in (t for obj in objs for t in tensors_of(obj)):
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            self.out_bytes += st.nbytes()
            if id(st) in self._args:
                self.alias_bytes += st.nbytes()
        return self

    def _track(self, t: torch.Tensor, nbytes: int) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._tracked or key in self._args:
            return
        self._tracked[key] = nbytes
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key, nbytes)

    def _release(self, key: int, nbytes: int) -> None:
        if self._tracked.pop(key, None) is not None:
            self.live -= nbytes

    def memory(self) -> Dict[str, int]:
        """JAX's ``memory_analysis`` keys: the arguments, the results,
        the temporaries (the peak of live bytes beyond the arguments,
        scratch included) and the results that alias arguments, plus
        ``peak_bytes`` (arguments + temporaries)."""
        return {"argument_size_in_bytes": self.arg_bytes,
                "output_size_in_bytes": self.out_bytes,
                "temp_size_in_bytes": self.peak,
                "alias_size_in_bytes": self.alias_bytes,
                "peak_bytes": self.arg_bytes + self.peak}

    # --------------------------------------------------------- counting
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or func.namespace != "aten":
            return out      # collectives count in ``collective``
        if func is _TO_COPY and _host_to_cpu_target(args[0], out):
            return out      # no op on the CPU the meta tensor stands for
        packet = func._overloadpacket
        name = packet.__name__
        if packet in _FLOPS:
            self.flops += _FLOPS[packet](*args, **kwargs, out_val=out)
        fresh = not func.is_view and all(
            r.alias_info is None for r in func._schema.returns)
        if not (func.is_view or name in _ALLOC or name in _NO_TRAFFIC):
            self.aten_ops += 1
            self._bytes(name, sum(
                _nbytes(t) for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor)))
        if fresh:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._track(t, t.untyped_storage().nbytes())
        return out

    def kernel(self, name: str, cost, fn, args, kw):
        """A kernel wrapper's call: its cost counted, the call run
        uncounted, its outputs tracked as new storages and its scratch
        counted while it runs."""
        rec = self.kernels.setdefault(name, {"calls": 0, "bytes": 0,
                                             "ops": {}})
        rec["calls"] += 1
        rec["bytes"] += cost.bytes
        for k, n in cost.ops.items():
            rec["ops"][k] = rec["ops"].get(k, 0) + n
        self.flops += sum(cost.ops.values())
        self._bytes(name, cost.bytes)
        self._paused += 1
        try:
            out = fn(*args, **kw)
        finally:
            self._paused -= 1
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t, _nbytes(t))
        self.peak = max(self.peak, self.live + cost.scratch)
        return out

    def _bytes(self, name: str, nbytes: int) -> None:
        self.hbm_bytes += nbytes
        self.bytes_by_op[name] = self.bytes_by_op.get(name, 0) + nbytes

    def top_bytes(self, n: int = 8) -> Dict[str, int]:
        """The ``n`` ops (aten ops by name, kernels by wrapper) that move
        the most HBM bytes, largest first."""
        return dict(sorted(self.bytes_by_op.items(),
                           key=lambda kv: -kv[1])[:n])

    def collective(self, kind: str, nbytes: int) -> None:
        """One collective of ``kind`` (JAX's names: all-reduce,
        all-gather, reduce-scatter, ...) with a result of ``nbytes``."""
        self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0) + nbytes

    def kernel_calls(self) -> Dict[str, int]:
        return {k: v["calls"] for k, v in sorted(self.kernels.items())}

    def __enter__(self):
        self._prev, cost.ACTIVE = cost.ACTIVE, self
        return super().__enter__()

    def __exit__(self, *exc):
        cost.ACTIVE = self._prev
        return super().__exit__(*exc)


def analyze(counter: Counter) -> Roofline:
    """The roofline of what ``counter`` counted (JAX: ``analyze`` of a
    compiled module); ``peak_memory`` is its peak bytes."""
    coll = dict(counter.coll_by_kind)
    return Roofline(flops=float(counter.flops),
                    hbm_bytes=float(counter.hbm_bytes),
                    coll_bytes=float(sum(coll.values())),
                    coll_by_kind=coll,
                    peak_memory=float(counter.arg_bytes + counter.peak))


def model_flops(cfg, tokens: int) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for a train step;
    2 N D for inference steps (caller divides)."""
    return 6.0 * active_params(cfg) * tokens


def active_params(cfg) -> float:
    """Active (FLOP-relevant) parameter count: standard 6ND convention —
    embeddings excluded; MoE experts count experts_per_token/num_experts;
    routed-FFN weights count beta = G'/G (only activated blocks compute)."""
    from repro_torch.core.params import count_params
    from repro_torch.train.state import model_defs
    total = count_params(model_defs(cfg))
    total -= cfg.padded_vocab * cfg.d_model          # embedding lookup
    if cfg.positional == "learned":
        total -= cfg.max_position * cfg.d_model
        if cfg.family == "audio":
            total -= cfg.max_position * cfg.d_model  # enc+dec tables
    n_ffn_layers = sum(1 for t in cfg.layer_types() if t != "ssd")
    ffn_mats = 3 if cfg.gated_ffn else 2
    if cfg.num_experts > 0:
        frac = cfg.experts_per_token / cfg.num_experts
        per_layer = cfg.num_experts * cfg.d_model * cfg.d_ff * ffn_mats
        total -= per_layer * n_ffn_layers * (1.0 - frac)
    elif cfg.spt.routed_ffn and cfg.d_ff > 0 \
            and cfg.d_ff % cfg.spt.ffn_groups == 0:
        beta = cfg.spt.ffn_active_groups / cfg.spt.ffn_groups
        per_layer = cfg.d_model * cfg.d_ff * ffn_mats
        if cfg.family == "audio":
            n_ffn_layers += cfg.encoder_layers
        total -= per_layer * n_ffn_layers * (1.0 - beta)
    return float(max(total, 1.0))
