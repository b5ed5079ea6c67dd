"""Sharding context: logical-axis annotations of activations.

Model code may annotate an activation with *logical* axis names through
``shard``.  In the JAX package the annotation becomes a sharding
constraint when a rules context is active.  In the port every tensor is
this rank's local tensor and the collectives are explicit (the region
functions of core/collectives.py), so ``shard`` only checks the
annotation (one name per dimension) and returns the tensor unchanged;
``spec_for`` gives the placement JAX would constrain it to, as a tuple,
``local_shape`` the shape of the part one rank holds and ``local_slice``
that part itself: the one place the port's storage rule
(train/state.storage_specs) is read.
``axis_rules`` sets the rules (``sharding.rules_for_mesh``) for the code
it wraps: the Trainer runs each step under them, and the collectives read
the mesh from them.  The rules are one process-wide value, not a context
variable as in JAX: on a CUDA device autograd runs the backward (a
checkpointed unit's recompute, a kernel op's reference backward) on a
thread of its own, which must see the rules of the step that waits for
it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import torch

_RULES: Optional[Mapping[str, Any]] = None


@contextlib.contextmanager
def axis_rules(rules: Mapping[str, Any]):
    global _RULES
    prev, _RULES = _RULES, rules
    try:
        yield
    finally:
        _RULES = prev


def current_rules() -> Optional[Mapping[str, Any]]:
    return _RULES


def _resolve(dim: int, name: Optional[str], rules: Mapping[str, Any],
             used: set) -> Optional[Union[str, tuple]]:
    if name is None:
        return None
    mesh_axes = rules.get(name)
    if mesh_axes is None:
        return None
    flat = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
    sizes = rules.get("__sizes__", {})
    total = math.prod(int(sizes.get(a, 1)) for a in flat)
    if total <= 0 or dim % total != 0 or any(a in used for a in flat):
        return None
    used.update(flat)
    return mesh_axes


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             rules: Mapping[str, Any]) -> Tuple:
    """The placement of an array of ``shape`` with logical ``axes``: one
    entry per dimension, a mesh axis, a tuple of them or None (JAX's
    ``PartitionSpec`` as a tuple).  A rule that does not divide the
    dimension, or reuses a mesh axis, leaves the dimension replicated."""
    used: set = set()
    return tuple(_resolve(d, n, rules, used) for d, n in zip(shape, axes))


@dataclasses.dataclass(frozen=True)
class Pick:
    """A leaf spec (in place of a placement tuple) for a leaf that each
    rank of the model axis holds by an index set of one dimension, e.g.
    the columns of a fused projection whose parts split differently: rank
    r holds ``index[r]`` of dim ``dim``.  Indices shared by several ranks
    are held by each of them (their partial gradients summed)."""
    dim: int
    index: Tuple[Tuple[int, ...], ...]


def entry_axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def local_shape(shape: Sequence[int], spec,
                sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape one rank holds of an array of ``shape`` placed by
    ``spec`` (``spec_for``'s tuple, or a :class:`Pick`): each dimension
    divided by the extents of the mesh axes placed on it."""
    if isinstance(spec, Pick):
        out = list(shape)
        out[spec.dim] = len(spec.index[0])
        return tuple(out)
    out = []
    for dim, entry in zip(shape, tuple(spec or ()) + (None,) * len(shape)):
        out.append(dim // math.prod(int(sizes.get(a, 1))
                                    for a in entry_axes(entry)))
    return tuple(out)


def local_slice(t: torch.Tensor, spec, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> torch.Tensor:
    """The part of the whole array ``t`` that the rank at ``coords`` ({mesh
    axis: its index}) holds under ``spec`` (contiguous): on a dimension
    placed on axes (a, b) it holds chunk ``coords[a] * sizes[b] +
    coords[b]`` of ``sizes[a] * sizes[b]`` (the first axis major, as in
    JAX's PartitionSpec); a :class:`Pick` holds its model index set.
    A split part is a tensor of its own (a view would keep the whole
    storage alive); an unsplit leaf is ``t`` itself.  ``local_shape``
    gives the part's shape."""
    if isinstance(spec, Pick):
        idx = torch.as_tensor(spec.index[int(coords.get("model", 0))],
                              dtype=torch.long, device=t.device)
        return t.index_select(spec.dim, idx)
    part = t
    for dim, entry in enumerate(tuple(spec or ())):
        axes = entry_axes(entry)
        n = math.prod(int(sizes.get(a, 1)) for a in axes)
        if n == 1:
            continue
        chunk = 0
        for a in axes:
            chunk = chunk * int(sizes.get(a, 1)) + int(coords.get(a, 0))
        size = part.shape[dim] // n
        part = part.narrow(dim, chunk * size, size)
    return (t.contiguous() if part is t
            else part.clone(memory_format=torch.contiguous_format))


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Annotate ``x`` with logical axes, e.g. shard(h, 'batch', None,
    'embed'); checks the rank under active rules, returns ``x``."""
    rules = _RULES
    if rules is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"shard(): {len(axes)} axes for rank-{x.dim()} "
                         "tensor")
    spec_for(x.shape, axes, rules)
    return x
