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

Inside a tensor-parallel region every rank holds the whole sequence and
its shard of the heads or of the FFN's hidden columns.  The gradient a
rank computes there for a replicated value is its *partial* share: the
sum over the ranks is the true gradient.  The region functions keep that
so, and hand whole gradients back at the region's edges:

  ==================  ========================  =========================
  function            forward                   backward
  ==================  ========================  =========================
  ``enter_region``    all-gather the sequence;  reduce-scatter; leaves:
                      the leaves as the region  all-reduce (replicated),
                      uses them                 all-gather (sliced)
  ``gather_seq``      all-gather the sequence   reduce-scatter
  ``scatter_seq``     reduce-scatter            all-gather
  ``split_seq``       this rank's chunk         zero-padded (partial)
  ``reduce_sum``      all-reduce                identity
  ``pmean``           all-reduce / n            gradient / n
  ``mean_exit``       identity (value equal     gradient / n
                      on every rank)
  ``region_sum``      all-reduce                all-reduce
  ``gather``          all-gather along a dim    reduce-scatter
  ==================  ========================  =========================

A region's trainable leaves enter with its activations, in one autograd
node: a replicated leaf as it is (its gradient all-reduced), a leaf
stored whole but used by its shard as this rank's slice (the slices'
gradients all-gathered back to the whole), so every leaf's gradient comes
out whole and equal on every rank of the model axis.  One node, because
the backward must issue its collectives in the same order on every rank:
the regions follow each other along the residual stream, while the
branches inside a region (heads, LoRA products) run in an order that
their data can change.  Over the data axes the same rule holds with the
rows in place of the sequence: a sum over the batch goes through
``reduce_sum`` (each rank's backward reaches its own rows only), and the
trainable gradients are summed over the data axes after backward
(``all_reduce_``).

Serving runs forward only, on parameters sliced once (``local_tree``):
``model_sum`` adds a sub-layer's partial outputs over the model axis in
place, and ``all_gather_flat`` brings one flat vector per rank of the
data axis to every rank (the engine's one host transfer per chunk).
Both cost nothing at extent 1.

Every collective goes through :func:`_issue`, which records its kind and
its result's bytes (JAX's ``collective_bytes`` convention) into an active
roofline counter (``kernels/cost.record_collective``) before it calls
torch.distributed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.params import unflatten
from repro_torch.kernels import cost
from repro_torch.sharding.context import current_rules

BATCH_AXES = ("pod", "data")
SEQ = 1                     # the sequence dim of a (B, S, d) activation


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


def model_axis() -> Optional[Axis]:
    return axis("model")


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
    """(x, *leaves) -> (x gathered, *leaves as the region uses them);
    ``how`` holds per leaf None (replicated) or the sliced dim."""

    @staticmethod
    def forward(ctx, ax, how, x, *leaves):
        ctx.args = (ax, how)
        ctx.whole = [t.shape[d.dim] if isinstance(d, Pick) else None
                     for t, d in zip(leaves, how)]
        return (_all_gather(x, SEQ, ax),
                *(t.view_as(t) if d is None else _slice(t, d, ax)
                  for t, d in zip(leaves, how)))

    @staticmethod
    def backward(ctx, gx, *gl):
        ax, how = ctx.args
        out = [_reduce_scatter(gx, SEQ, ax)]
        for g, d in zip(gl, how):
            if d is None:
                out.append(_all_reduce(g.contiguous().clone(), ax.group))
            elif isinstance(d, Pick):
                parts = _gather_parts(g, ax)
                shape = list(g.shape)
                shape[d.dim] = ctx.whole[len(out) - 1]
                whole = g.new_zeros(shape)
                for r, part in enumerate(parts):
                    whole.index_add_(d.dim, torch.as_tensor(
                        d.index[r], dtype=torch.long, device=g.device), part)
                out.append(whole)
            else:
                out.append(_all_gather(g, d, ax))
        return (None, None, *out)


@dataclasses.dataclass(frozen=True)
class Pick:
    """A leaf spec (in place of a placement tuple) for a leaf that each
    rank uses by an index set of one dimension, e.g. the columns of a
    fused projection whose parts split differently: rank r uses
    ``index[r]`` of dim ``dim``.  Indices shared by several ranks take
    the sum of their partial gradients."""
    dim: int
    index: Tuple[Tuple[int, ...], ...]


def _slice(t: torch.Tensor, how, ax: Axis) -> torch.Tensor:
    """This rank's part of a leaf: whole (None), its contiguous chunk of
    a dim (int), or its index set (Pick)."""
    if how is None:
        return t
    if isinstance(how, Pick):
        idx = torch.as_tensor(how.index[ax.rank], dtype=torch.long,
                              device=t.device)
        return t.index_select(how.dim, idx)
    return _chunk(t, how, ax)


def _slice_dim(spec):
    """The dim a placement puts "model" on (None: replicated); a Pick is
    its own answer."""
    if isinstance(spec, Pick):
        return spec
    for dim, entry in enumerate(spec or ()):
        flat = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if "model" in flat:
            return dim
    return None


def enter_region(x: torch.Tensor, p, specs, ax: Optional[Axis]):
    """Enter a tensor-parallel region on the model axis ``ax``: returns (x
    with its sequence all-gathered, the param (sub)tree ``p`` as the
    region uses it).  A leaf whose spec (``core/params.spec_tree``;
    ``specs`` None: every leaf replicated) places "model" on a dimension
    is sliced there (contiguous), one whose spec is a :class:`Pick` is
    taken by its index set; every other leaf is used whole.  The
    trainable leaves pass through the entry's autograd node (module
    docstring)."""
    if ax is None:
        return x, p
    pairs, trainable = [], []

    def walk(t, spec, path):
        if isinstance(t, torch.Tensor):
            d = _slice_dim(spec)
            if t.requires_grad:
                trainable.append((path, t, d))
            else:
                pairs.append((path, _slice(t, d, ax)))
            return
        for k in sorted(t.keys()):      # one order on every rank
            walk(t[k], None if spec is None else spec[k], path + (k,))

    walk(p, specs, ())
    outs = _EnterRegion.apply(ax, tuple(d for _, _, d in trainable), x,
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
def local_tree(p, specs, ax: Optional[Axis]):
    """This rank's copy of a param (sub)tree ``p`` (dicts or ParamTrees)
    under ``specs`` (placement tuples or :class:`Pick` leaves, as
    ``enter_region`` reads them): each leaf sliced once, contiguous,
    without autograd; at extent 1 the tree itself."""
    if ax is None:
        return p

    def walk(t, spec):
        if isinstance(t, torch.Tensor):
            return _slice(t.detach(), _slice_dim(spec), ax).contiguous()
        return {k: walk(t[k], None if spec is None else spec[k])
                for k in t.keys()}
    return walk(p, specs)


def model_sum(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Serving: the sum over the model axis of a sub-layer's partial
    output (its row-split output projection, LoRA included), in place;
    the identity at extent 1."""
    if ax is None:
        return x
    return _all_reduce(x.contiguous(), ax.group)


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
