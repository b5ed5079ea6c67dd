"""Collectives of the data- and tensor-parallel paths: the port's
counterpart of the JAX package's ``core/compat.py`` shard_map shim.

JAX states a layout (``shard`` annotations, ``shard_map`` specs) and lets
XLA place the collectives.  The port calls them itself, on this rank's
local tensors, through two kinds of helper:

  * process groups by mesh axis: :func:`mesh_axis` / :func:`axis` give an
    :class:`Axis` (group, size, this rank's index) of the current rules'
    mesh (``sharding.axis_rules``), or None when no mesh is active or the
    axis has extent 1 — then every helper below is the identity and the
    path computes exactly what it computes without a mesh;
  * autograd-aware region functions (Megatron's conjugate pairs).

Every rank stores only its part of each parameter (train/state.py's
storage rule, the placements below).  Inside a tensor-parallel region
every rank holds the whole sequence and its shard of the heads or of the
FFN's hidden columns, which is the part it stores.  The gradient a rank
computes there for a replicated value is its *partial* share: the sum
over the ranks is the true gradient.  The region functions keep that so,
and hand each rank its part of the whole gradient at the region's edges:

  ==================  ========================  =========================
  function            forward                   backward
  ==================  ========================  =========================
  ``enter_region``    all-gather the sequence;  reduce-scatter; leaves:
                      leaves as stored, those   all-reduce (replicated),
                      stored over data too      none (split over model),
                      all-gathered over it      the shared columns summed
                      (ZeRO-3)                  (Pick); reduce-scatter
                                                over data (ZeRO-3)
  ``gather_seq``      all-gather the sequence   reduce-scatter
  ``scatter_seq``     reduce-scatter            all-gather
  ``split_seq``       this rank's chunk         zero-padded (partial)
  ``reduce_sum``      all-reduce                identity
  ``pmean``           all-reduce / n            gradient / n
  ``mean_exit``       identity (value equal     gradient / n
                      on every rank)
  ``region_sum``      all-reduce                all-reduce
  ``gather``          all-gather along a dim    reduce-scatter
  ``gather_whole``    each leaf whole           this rank's part (model),
                      (replicated compute)      reduce-scatter (data)
  ==================  ========================  =========================

A leaf that a region uses whole while each rank stores a part of it
(``Gathered``: a k or v projection split inside a kv head) is
all-gathered over the model axis at the entry, its gradient
reduce-scattered there.

A region's trainable leaves enter with its activations, in one autograd
node: a replicated leaf as it is (its gradient all-reduced over the
model axis), a leaf split over it as this rank's part (its gradient is
already this rank's part of the whole), an expert leaf stored over the
data axis as well gathered over data (its gradient reduce-scattered over
data: the sum of the data ranks' rows, this rank's part).  One node,
because the backward must issue its collectives in the same order on
every rank: the regions follow each other along the residual stream,
while the branches inside a region (heads, LoRA products) run in an
order that their data can change.  The gathers sit inside the
checkpointed unit, so the recompute gathers again and no gathered
weight outlives its layer.  Over the data axes the same rule holds with
the rows in place of the sequence: a sum over the batch goes through
``reduce_sum`` (each rank's backward reaches its own rows only), and
the gradients of the leaves replicated over data are summed over the
data axes after backward (``all_reduce_``).

Serving runs forward only, on each rank's stored parts: ``zero_gather``
gathers expert columns stored over data at use, ``model_sum`` adds a
sub-layer's partial outputs over the model axis in place, and
``all_gather_flat`` brings one flat vector per rank of the data axis to
every rank (the engine's one host transfer per chunk); ``stack_ranks``
and ``model_scatter`` serve a decode over a sequence split over the
model axis (each rank's histograms and log-sum-exps, the combined
output's heads).  They cost
nothing at extent 1.  ``gather_stored`` makes a stored leaf whole (a
checkpoint's save, one leaf at a time).

Every collective goes through :func:`_issue`, which records its kind and
its result's bytes (JAX's ``collective_bytes`` convention) into an active
roofline counter (``kernels/cost.record_collective``) before it calls
torch.distributed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.params import unflatten
from repro_torch.kernels import cost
from repro_torch.sharding.context import Pick, current_rules, entry_axes

BATCH_AXES = ("pod", "data")
SEQ = 1                     # the sequence dim of a (B, S, d) activation


@dataclasses.dataclass(frozen=True)
class Gathered:
    """A region's placement of a leaf stored split over the model axis on
    ``dim`` that the region uses whole: all-gathered at the entry, its
    gradient (each rank's partial one) reduce-scattered back to parts."""
    dim: int


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis, or the product of several, as the model code sees
    it: its process group, its extent and this rank's index along it."""
    group: Any
    size: int
    rank: int


_FLAT_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Axis] = {}


def mesh_axis(mesh, names: Union[str, Sequence[str]]) -> Optional[Axis]:
    """The :class:`Axis` of ``mesh``'s axes ``names`` (one name, or a
    product such as ("pod", "data") of the names the mesh has); None when
    their extent is 1 or the mesh has none of them."""
    if mesh is None:
        return None
    names = (names,) if isinstance(names, str) else tuple(names)
    dims = [i for i, n in enumerate(mesh.mesh_dim_names) if n in names]
    shape = tuple(int(s) for s in mesh.mesh.shape)
    size = math.prod(shape[i] for i in dims)
    if size == 1:
        return None
    if len(dims) == 1:
        name = mesh.mesh_dim_names[dims[0]]
        return Axis(mesh.get_group(name), size, mesh.get_local_rank(name))
    key = (id(mesh), tuple(mesh.mesh_dim_names[i] for i in dims))
    if key not in _FLAT_GROUPS:
        # every rank builds every group of the flattened axes, in order
        rest = [i for i in range(len(shape)) if i not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(-1, size)
        mine, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
        me = dist.get_rank()
        row = next(r for r in ranks.tolist() if me in r)
        _FLAT_GROUPS[key] = Axis(mine, size, row.index(me))
    return _FLAT_GROUPS[key]


def forget_groups() -> None:
    """Drop the flattened axes' groups (their process group is being
    destroyed, and a later mesh may reuse its id)."""
    _FLAT_GROUPS.clear()


def axis(names: Union[str, Sequence[str]]) -> Optional[Axis]:
    """:func:`mesh_axis` of the mesh in the current rules."""
    rules = current_rules()
    return mesh_axis(None if rules is None else rules.get("__mesh__"),
                     names)


_REPLICATED = False


def model_axis() -> Optional[Axis]:
    """The model axis of the current rules; None inside
    :func:`replicated_compute`."""
    return None if _REPLICATED else axis("model")


@contextlib.contextmanager
def replicated_compute():
    """The code it wraps computes alike on every rank of the model axis,
    on parameters made whole (:func:`gather_whole`): no model axis, no
    ZeRO-3 gather.  A process-wide value, as the rules (the backward's
    recompute may run on another thread)."""
    global _REPLICATED
    prev, _REPLICATED = _REPLICATED, True
    try:
        yield
    finally:
        _REPLICATED = prev


def batch_axis() -> Optional[Axis]:
    """The data axes ("pod", "data") that split the batch's rows."""
    return axis(BATCH_AXES)


# ------------------------------------------------------ plain collectives
def _issue(kind: str, result_bytes: int, call) -> None:
    """Issue one collective, ``call()``, of ``kind`` (JAX's names:
    all-reduce, all-gather, reduce-scatter) whose result holds
    ``result_bytes``: the one place the port calls torch.distributed's
    collectives, so a roofline counter sees each of them."""
    cost.record_collective(kind, result_bytes)
    call()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    _issue("all-reduce", _nbytes(t), lambda: dist.all_reduce(
        t, op=op or dist.ReduceOp.SUM, group=group))
    return t


def _gather_parts(x: torch.Tensor, ax: Axis) -> list:
    """Every rank's ``x`` (contiguous, same shape), in rank order."""
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    _issue("all-gather", _nbytes(x) * ax.size, lambda: dist.all_gather(
        parts, x.contiguous(), group=ax.group))
    return parts


def all_reduce_(t: torch.Tensor, ax: Optional[Axis], op=None
                ) -> torch.Tensor:
    """Sum (or ``op``) ``t`` over ``ax`` in place; no autograd."""
    if ax is not None:
        _all_reduce(t, ax.group, op)
    return t


def _all_gather(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    return torch.cat(_gather_parts(x, ax), dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    if x.shape[dim] % ax.size:
        raise ValueError(f"reduce-scatter of dim {dim} of {tuple(x.shape)} "
                         f"over {ax.size} ranks")
    parts = [c.contiguous() for c in x.chunk(ax.size, dim=dim)]
    out = torch.empty_like(parts[0])
    _issue("reduce-scatter", _nbytes(out), lambda: dist.reduce_scatter(
        out, parts, group=ax.group))
    return out


def _chunk(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    if x.shape[dim] % ax.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {ax.size} ranks")
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n).contiguous()


# ------------------------------------------------------- region functions
class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.args = (dim, ax)
        return _all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        dim, ax = ctx.args
        return _reduce_scatter(g, dim, ax), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.args = (dim, ax)
        return _reduce_scatter(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        dim, ax = ctx.args
        return _all_gather(g, dim, ax), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.args = (dim, ax, x.shape[dim])
        return _chunk(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        dim, ax, full = ctx.args
        shape = list(g.shape)
        shape[dim] = full
        out = g.new_zeros(shape)
        out.narrow(dim, ax.rank * g.shape[dim], g.shape[dim]).copy_(g)
        return out, None, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x.contiguous().clone(), ax.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_reduce(x.contiguous().clone(), ax.group) / ax.size

    @staticmethod
    def backward(ctx, g):
        return g / ctx.ax.size, None


class _MeanExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.ax.size, None


def train_layout(mode: str) -> None:
    """A layer's ``tp`` argument marks train mode's sequence-parallel
    layout; serving under a mesh runs transformer.ShardedLM's params,
    sliced once, instead."""
    if mode != "train":
        raise ValueError(f"tp in {mode} mode: tp is train mode's sequence-"
                         "parallel layout; serving under a mesh runs "
                         "transformer.ShardedLM")


def gather_seq(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Enter a region: this rank's sequence chunk -> the whole sequence."""
    return x if ax is None else _GatherSeq.apply(x, SEQ, ax)


def scatter_seq(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Leave a region: partial sums over the whole sequence -> this rank's
    chunk of their sum."""
    return x if ax is None else _ScatterSeq.apply(x, SEQ, ax)


def split_seq(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Leave a region: a value equal on every rank -> this rank's chunk."""
    return x if ax is None else _SplitSeq.apply(x, SEQ, ax)


def reduce_sum(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The sum over ``ax`` of each rank's part (gradient: each rank's part
    gets the whole's)."""
    return x if ax is None else _ReduceSum.apply(x, ax)


def pmean(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The mean over ``ax`` of each rank's value (JAX's ``pmean``)."""
    return x if ax is None else _Pmean.apply(x, ax)


def mean_exit(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Leave a region with a value every rank computed alike (no
    communication; each rank's gradient is its 1/n share)."""
    return x if ax is None else _MeanExit.apply(x, ax)


class _EnterRegion(torch.autograd.Function):
    """(x, *leaves) -> (x with its sequence gathered over the model axis
    ``ax`` (as it is without one), *leaves as the region uses them:
    gathered over the data axis ``zero`` where they are stored over it,
    else as stored).  ``how`` holds per leaf (its model placement: None
    replicated, the split dim, or a :class:`Pick`; the dim it is stored
    over data on, or None)."""

    @staticmethod
    def forward(ctx, ax, zero, how, x, *leaves):
        ctx.args = (ax, zero, how)
        outs = []
        for t, (mh, zd) in zip(leaves, how):
            if isinstance(mh, Gathered):
                t = _all_gather(t, mh.dim, ax)
            outs.append(t.view_as(t) if zd is None
                        else _all_gather(t, zd, zero))
        return (x.view_as(x) if ax is None else _all_gather(x, SEQ, ax),
                *outs)

    @staticmethod
    def backward(ctx, gx, *gl):
        ax, zero, how = ctx.args
        out = [gx if ax is None else _reduce_scatter(gx, SEQ, ax)]
        for g, (mh, zd) in zip(gl, how):
            if ax is not None and mh is None:
                g = _all_reduce(g.contiguous().clone(), ax.group)
            elif ax is not None and isinstance(mh, Pick):
                g = _pick_sum(g, mh, ax)
            elif isinstance(mh, Gathered):
                g = _reduce_scatter(g, mh.dim, ax)
            if zd is not None:
                g = _reduce_scatter(g, zd, zero)
            out.append(g)
        return (None, None, None, *out)


def _pick_sum(g: torch.Tensor, pick: Pick, ax: Axis) -> torch.Tensor:
    """This rank's part of the sum of every rank's partial gradient of a
    :class:`Pick` leaf: its own columns, the shared ones summed."""
    shape = list(g.shape)
    shape[pick.dim] = 1 + max(max(ix) for ix in pick.index)
    idx = torch.as_tensor(pick.index[ax.rank], dtype=torch.long,
                          device=g.device)
    whole = g.new_zeros(shape).index_add_(pick.dim, idx, g)
    return _all_reduce(whole, ax.group).index_select(pick.dim, idx)


ZERO_AXIS = "data"          # the axis the ZeRO-3 leaves are also stored over


def _slice_dim(spec):
    """The dim a placement puts "model" on (None: replicated); a Pick or
    a Gathered is its own answer."""
    if isinstance(spec, (Pick, Gathered)):
        return spec
    for dim, entry in enumerate(spec or ()):
        if "model" in entry_axes(entry):
            return dim
    return None


def zero_dim(spec) -> Optional[int]:
    """The dim a placement stores over the data axis as well (ZeRO-3:
    gathered over data where it is used), or None."""
    if isinstance(spec, (Pick, Gathered)):
        return None
    for dim, entry in enumerate(spec or ()):
        if ZERO_AXIS in entry_axes(entry):
            return dim
    return None


def _has_zero(specs) -> bool:
    if specs is None or not isinstance(specs, dict):
        return zero_dim(specs) is not None
    return any(_has_zero(v) for v in specs.values())


def enter_region(x: torch.Tensor, p, specs, ax: Optional[Axis]):
    """Enter a tensor-parallel region on the model axis ``ax``: returns (x
    with its sequence all-gathered, the param (sub)tree ``p`` as the
    region uses it).  ``p`` holds this rank's stored leaves under
    ``specs`` (their storage placements, train/state.storage_specs;
    None: every leaf replicated): a leaf split over "model" or taken by a
    :class:`Pick` is used as it is, and so is a replicated one; a leaf
    stored over the data axis as well is all-gathered over it (ZeRO-3),
    here, inside the checkpointed unit, so the recompute gathers again.
    Without a model axis (``ax`` None) only that gather is made, and x
    passes.  The trainable leaves pass through the entry's autograd node
    (module docstring)."""
    zero = (axis(ZERO_AXIS) if _has_zero(specs) and not _REPLICATED
            else None)
    if ax is None and zero is None:
        return x, p
    pairs, trainable = [], []

    def walk(t, spec, path):
        if isinstance(t, torch.Tensor):
            how = (_slice_dim(spec), None if zero is None else zero_dim(spec))
            if t.requires_grad:
                trainable.append((path, t, how))
                return
            if isinstance(how[0], Gathered):  # frozen: forward gathers only
                t = _all_gather(t, how[0].dim, ax)
            pairs.append((path, t if how[1] is None
                          else _all_gather(t, how[1], zero)))
            return
        for k in sorted(t.keys()):      # one order on every rank
            walk(t[k], None if spec is None else spec[k], path + (k,))

    walk(p, specs, ())
    del walk            # a recursive closure: its cycle would hold pairs
    outs = _EnterRegion.apply(ax, zero, tuple(h for _, _, h in trainable), x,
                              *(t for _, t, _ in trainable))
    pairs += [(path, o) for (path, _, _), o in zip(trainable, outs[1:])]
    return outs[0], unflatten([k for k, _ in pairs], [v for _, v in pairs])


class _RegionSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_reduce(x.contiguous().clone(), ax.group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.ax.group), None


def region_sum(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Inside a region: the sum over ``ax`` of each rank's part, a value
    the region then uses alike on every rank (e.g. a norm's sum of
    squares over a split width).  Its gradient there is each rank's
    partial share, so the backward sums it too."""
    return x if ax is None else _RegionSum.apply(x, ax)


def gather(x: torch.Tensor, dim: int, ax: Optional[Axis]) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` (a split width made whole inside a
    region; backward: reduce-scatter of the partial gradients)."""
    return x if ax is None else _GatherSeq.apply(x, dim, ax)


# --------------------------------------------------- serving (forward only)
def zero_gather(p: dict, dims, zero: Optional[Axis]) -> dict:
    """Serving: a param (sub)tree with each leaf stored over the data axis
    ``zero`` (``dims``: (path, dim) pairs) all-gathered along its dim, at
    use, forward only (ZeRO-3); the tree itself without a data axis."""
    if zero is None or not dims:
        return p
    out = dict(p)
    for path, dim in dims:
        node = out
        for k in path[:-1]:
            node[k] = dict(node[k])
            node = node[k]
        node[path[-1]] = _all_gather(node[path[-1]], dim, zero)
    return out


def gather_stored(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole array of which ``t`` is this rank's stored part under
    ``spec`` (``sharding.local_slice``'s layout) on ``mesh``: gathered
    over each placed axis, the minor one first; a :class:`Pick` leaf's
    parts put back at their index sets.  Every rank of the mesh calls it
    (a checkpoint's save, one leaf at a time)."""
    if isinstance(spec, Pick):
        ax = mesh_axis(mesh, "model")
        if ax is None:
            return t
        shape = list(t.shape)
        shape[spec.dim] = 1 + max(max(ix) for ix in spec.index)
        whole = t.new_empty(shape)
        for r, part in enumerate(_gather_parts(t, ax)):
            whole.index_copy_(spec.dim, torch.as_tensor(
                spec.index[r], dtype=torch.long, device=t.device), part)
        return whole
    for dim, entry in enumerate(spec or ()):
        for name in reversed(entry_axes(entry)):
            ax = mesh_axis(mesh, name)
            if ax is not None:
                t = _all_gather(t, dim, ax)
    return t


class _GatherWhole(torch.autograd.Function):
    """(*leaves) -> the whole leaves (``gather_stored``); backward: each
    rank computed alike over the model axis, so a gradient's model part
    is this rank's slice, its data part summed over the data axis and
    scattered (its rows differ by data rank)."""

    @staticmethod
    def forward(ctx, mesh, specs, *leaves):
        ctx.args = (mesh, specs)
        outs = [gather_stored(t, sp, mesh) for t, sp in zip(leaves, specs)]
        return tuple(o.view_as(o) if o is t else o
                     for o, t in zip(outs, leaves))

    @staticmethod
    def backward(ctx, *grads):
        mesh, specs = ctx.args
        out = []
        for g, sp in zip(grads, specs):
            if isinstance(sp, Pick):
                ax = mesh_axis(mesh, "model")
                if ax is not None:
                    g = g.index_select(sp.dim, torch.as_tensor(
                        sp.index[ax.rank], dtype=torch.long, device=g.device))
                out.append(g)
                continue
            for dim, entry in enumerate(sp or ()):
                for name in entry_axes(entry):
                    ax = mesh_axis(mesh, name)
                    if ax is None:
                        continue
                    g = (_reduce_scatter(g, dim, ax) if name == ZERO_AXIS
                         else _chunk(g, dim, ax))
            out.append(g)
        return (None, None, *out)


def gather_whole(p, specs):
    """The whole param (sub)tree of this rank's stored parts ``p`` under
    ``specs`` (storage placements) on the current rules' mesh, for a step
    that computes alike on every rank of the model axis (under
    :func:`replicated_compute`): the frozen leaves gathered as they are,
    the trainable ones through one autograd node, in one order on every
    rank."""
    mesh = current_rules()["__mesh__"]
    pairs, trainable = [], []

    def walk(t, spec, path):
        if t is None:
            return
        if isinstance(t, torch.Tensor):
            if t.requires_grad:
                trainable.append((path, t, spec))
            else:
                pairs.append((path, gather_stored(t, spec, mesh)))
            return
        for k in sorted(t.keys()):
            walk(t[k], spec[k], path + (k,))

    walk(p, specs, ())
    del walk            # a recursive closure: its cycle would hold pairs
    outs = (_GatherWhole.apply(mesh, tuple(sp for _, _, sp in trainable),
                               *(t for _, t, _ in trainable))
            if trainable else ())
    pairs += [(path, o) for (path, _, _), o in zip(trainable, outs)]
    return unflatten([k for k, _ in pairs], [v for _, v in pairs])


def model_sum(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Serving: the sum over the model axis of a sub-layer's partial
    output (its row-split output projection, LoRA included), in place;
    the identity at extent 1."""
    if ax is None:
        return x
    return _all_reduce(x.contiguous(), ax.group)


def stack_ranks(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Serving: (n, ...) every rank's ``x`` of ``ax`` in rank order, in
    one all-gather."""
    return torch.stack(_gather_parts(x, ax))


def model_scatter(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """Serving: this rank's chunk along ``dim`` of the sum over ``ax`` of
    every rank's ``x``, in one reduce-scatter."""
    return _reduce_scatter(x, dim, ax)


def all_gather_flat(v: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """(n, L): the flat vector ``v`` (L,) of every rank of ``ax`` in rank
    order, in one all-gather ((1, L) at extent 1)."""
    if ax is None:
        return v[None]
    return torch.stack(_gather_parts(v, ax))


def all_reduce_flat(v: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The sum over ``ax`` of the flat vector ``v`` (a copy)."""
    v = v.clone()
    if ax is not None:
        _all_reduce(v, ax.group)
    return v
