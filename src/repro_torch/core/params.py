"""Parameter definition machinery (port of the JAX ``core/params.py``).

Every layer declares its parameters as a nested dict of :class:`ParamDef`
(shape + dtype + *logical* partition axes + initializer + trainable flag).
``spec_tree`` maps the logical axes onto mesh axes through a rule table
(sharding/rules.py), as the JAX package does; ``init_tree`` materializes
one on a device from an explicit ``torch.Generator`` (whole, or the part
one rank of a mesh stores); ``from_numpy_tree``
loads the JAX package's parameter tree (nested dicts of numpy arrays, the
same layout: stacked units on a leading axis U) so both packages compute
the same function.  :class:`ParamTree` turns either tree into an
``nn.Module`` whose frozen leaves have ``requires_grad=False``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.sharding.context import Pick, local_shape, local_slice

Tree = Any  # nested dict of ParamDef / tensors


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative description of a single parameter tensor."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    axes: Tuple[Optional[str], ...] = ()
    init: str = "normal:0.02"  # zeros | ones | normal:<std> | uniform:<s> | fan_in
    trainable: bool = True     # False => frozen (pre-trained base weights)

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank mismatch with shape {self.shape}")


def is_def(x: Any) -> bool:
    return isinstance(x, ParamDef)


def _map_defs(fn, tree: Tree) -> Tree:
    if is_def(tree):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map_defs(fn, v) for k, v in tree.items()}
    raise TypeError(f"bad def tree node: {type(tree)}")


def _draw(d: ParamDef, shape, gen: torch.Generator) -> torch.Tensor:
    """A draw of ``shape`` (the whole def, or one layer of a stacked one)
    from ``d``'s random init; the scale is the whole def's."""
    kind, _, arg = d.init.partition(":")
    dev = gen.device
    if kind in ("normal", "fan_in"):
        if kind == "normal":
            std = float(arg or 0.02)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            std = 1.0 / math.sqrt(max(1, fan_in))
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (x * std).to(d.dtype)
    if kind == "uniform":
        s = float(arg or 1.0)
        x = torch.rand(shape, generator=gen, device=dev,
                       dtype=torch.float32)
        return ((2.0 * x - 1.0) * s).to(d.dtype)
    raise ValueError(f"unknown init {d.init!r}")


def layer_spec(spec):
    """The spec of one layer of a stacked leaf (its leading layer entry,
    which no rule places, dropped)."""
    if isinstance(spec, Pick):
        return Pick(spec.dim - 1, spec.index)
    if spec and spec[0] is not None:
        raise ValueError(f"a stacked leaf placed on its layer axis: {spec}")
    return tuple(spec or ())[1:]


def _materialize(d: ParamDef, gen: torch.Generator, spec=None,
                 sizes=None, coords=None) -> torch.Tensor:
    """The leaf of ``d``, or with ``spec`` the part of it the rank at
    ``coords`` holds (``sharding.local_slice``).  A layer-stacked leaf is
    drawn one layer at a time, so no more than one layer of it is ever
    whole, and a part is exactly the slice of the whole draw."""
    kind = d.init.partition(":")[0]
    dev = gen.device
    shape = (d.shape if spec is None
             else local_shape(d.shape, spec, sizes or {}))
    if kind == "zeros":
        return torch.zeros(shape, dtype=d.dtype, device=dev)
    if kind == "ones":
        return torch.ones(shape, dtype=d.dtype, device=dev)

    def keep(t, sp):
        return t if spec is None else local_slice(t, sp, sizes or {},
                                                  coords or {})
    if not stacked(d):
        return keep(_draw(d, d.shape, gen), spec)
    lspec = layer_spec(spec)
    out = torch.empty(shape, dtype=d.dtype, device=dev)
    for u in range(d.shape[0]):
        out[u] = keep(_draw(d, d.shape[1:], gen), lspec)
    return out


def init_tree(tree: Tree, generator: torch.Generator, specs: Tree = None,
              sizes: Optional[Mapping[str, int]] = None,
              coords: Optional[Mapping[str, int]] = None) -> Tree:
    """Materialize parameters on ``generator.device``.  Leaves are drawn in
    sorted-path order, so a seed fixes the whole tree.  (The numbers differ
    from JAX's PRNG; parity tests load JAX's tree with from_numpy_tree.)
    With ``specs`` (placements of a mesh of axis extents ``sizes``) each
    leaf is the part the rank at ``coords`` holds: every rank draws every
    leaf (one whole leaf, or one layer of a stacked one, at a time) and
    keeps its slice, so the parts are exactly the slices of the tree a
    world of one draws."""
    def build(t, sp):
        if is_def(t):
            return _materialize(t, generator, sp, sizes, coords)
        return {k: build(t[k], None if specs is None else sp[k])
                for k in sorted(t)}
    return build(tree, specs)


def stack_defs(tree: Tree, n: int) -> Tree:
    """Prepend a leading unit axis of size n (logical axis ``layer``) to
    every def."""
    def one(d: ParamDef) -> ParamDef:
        axes = d.axes if d.axes else (None,) * len(d.shape)
        return dataclasses.replace(d, shape=(n, *d.shape),
                                   axes=("layer", *axes))
    return _map_defs(one, tree)


Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def abstract_tree(tree: Tree, specs: Tree = None,
                  sizes: Optional[Mapping[str, int]] = None) -> Tree:
    """Meta tensors of a def tree's shapes and dtypes: the parameters with
    no storage and no data, for a dry run (JAX: ``ShapeDtypeStruct``
    leaves); with ``specs``, the shapes one rank holds under them."""
    def build(t, sp):
        if is_def(t):
            shape = (t.shape if specs is None
                     else local_shape(t.shape, sp, sizes or {}))
            return torch.empty(shape, dtype=t.dtype, device="meta")
        return {k: build(t[k], None if specs is None else sp[k]) for k in t}
    return build(tree, specs)


def spec_tree(tree: Tree, rules: Mapping[str, Any]) -> Tree:
    """Map logical axes -> mesh axes: one placement tuple per def, an
    entry per dimension (a mesh-axis name, a tuple of them, or None for
    replicated), as JAX's ``PartitionSpec`` tree read as tuples.

    ``rules[name]`` may be a mesh-axis name, a tuple of mesh axes, or None;
    a logical axis missing from the rules is replicated.  A rule applies
    only if the dimension divides by the mesh-axis extent recorded in
    ``rules['__sizes__']`` (small models degrade to replication instead
    of failing to shard), and a mesh axis is used at most once per spec.
    A def without axes gives ``()``."""
    sizes = rules.get("__sizes__", {})

    def one(d: ParamDef) -> Spec:
        if not d.axes:
            return ()
        out, used = [], set()
        for dim, name in zip(d.shape, d.axes):
            mesh_axes = rules.get(name) if name is not None else None
            if mesh_axes is None:
                out.append(None)
                continue
            flat = ((mesh_axes,) if isinstance(mesh_axes, str)
                    else tuple(mesh_axes))
            total = math.prod(int(sizes.get(a, 1)) for a in flat)
            if total <= 0 or dim % total or any(a in used for a in flat):
                out.append(None)
                continue
            used.update(flat)
            out.append(mesh_axes if isinstance(mesh_axes, str) else flat)
        return tuple(out)

    return _map_defs(one, tree)


def count_params(tree: Tree, only_trainable: Optional[bool] = None) -> int:
    total = 0

    def one(d: ParamDef):
        nonlocal total
        if only_trainable is None or d.trainable == only_trainable:
            total += math.prod(d.shape)

    _map_defs(one, tree)
    return total


def param_bytes(tree: Tree, only_trainable: Optional[bool] = None) -> int:
    """Bytes of a def tree's tensors (of its trainable or frozen ones
    only, when asked)."""
    total = 0

    def one(d: ParamDef):
        nonlocal total
        if only_trainable is None or d.trainable == only_trainable:
            total += math.prod(d.shape) * d.dtype.itemsize

    _map_defs(one, tree)
    return total


def tree_paths(tree: Tree) -> list:
    """Key paths (tuples) of a def or value tree's leaves, sorted."""
    out = []

    def walk(t, path):
        if is_def(t) or not isinstance(t, Mapping):
            out.append(path)
            return
        for k in sorted(t.keys()):
            walk(t[k], path + (k,))

    walk(tree, ())
    return out


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes bf16 from a JAX array
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def from_numpy_tree(tree: Tree, device, dtype_map: Optional[Mapping] = None
                    ) -> Tree:
    """JAX param tree as nested dicts of numpy arrays -> the same tree of
    torch tensors on ``device``.  ``dtype_map`` maps a source dtype name
    ("bfloat16", "float32", ...) to the torch dtype to store it as."""
    dtype_map = dict(dtype_map or {})

    def conv(t):
        if isinstance(t, Mapping):
            return {k: conv(v) for k, v in t.items()}
        a = np.asarray(t)
        x = _to_torch(a)
        if a.dtype.name in dtype_map:
            x = x.to(dtype_map[a.dtype.name])
        return x.to(device)
    return conv(tree)


def trainable_mask(tree: Tree) -> Tree:
    """Boolean tree: True for trainable leaves (LoRA/router/codebooks)."""
    return _map_defs(lambda d: d.trainable, tree)


def stacked(d: ParamDef) -> bool:
    """A layer-stacked def: its leading axis is "layer"."""
    return d.axes[:1] == ("layer",)


def stacked_mask(tree: Tree) -> Tree:
    """Boolean tree: True for layer-stacked leaves (``stacked``)."""
    return _map_defs(stacked, tree)


def partition(tree: Tree, mask: Tree) -> Tuple[Tree, Tree]:
    """Split a value tree into (selected, rest) by a bool tree of the same
    dict structure; unselected positions become None, so gradients are
    only ever taken over the selected tree."""
    def pick(t, m, keep):
        if isinstance(t, Mapping):
            return {k: pick(t[k], m[k], keep) for k in t}
        return t if bool(m) == keep else None
    return pick(tree, mask, True), pick(tree, mask, False)


def combine(a: Tree, b: Tree) -> Tree:
    """Inverse of :func:`partition`."""
    if a is None:
        return b
    if b is None:
        return a
    if not (isinstance(a, Mapping) and isinstance(b, Mapping)):
        raise ValueError("combine: two leaves at one position")
    return {k: combine(a.get(k), b.get(k)) for k in set(a) | set(b)}


def leaves(tree: Tree, path: Tuple[str, ...] = ()):
    """(path, leaf) pairs of a value tree (nested dicts or a ParamTree) in
    sorted-path order, None positions skipped."""
    if isinstance(tree, (Mapping, ParamTree)):
        for k in sorted(tree.keys()):
            yield from leaves(tree[k], path + (k,))
    elif tree is not None:
        yield path, tree


def unflatten(paths, values) -> dict:
    """The nested dict holding ``values`` at ``paths`` (inverse of
    :func:`leaves`)."""
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def from_numpy_state(state: Mapping, device,
                     dtype_map: Optional[Mapping] = None) -> dict:
    """A JAX train state ``{step, train, frozen, opt: {m, v}}`` given as
    numpy arrays (None for the empty positions of the partition) -> the
    port's state of the same layout on ``device``: ``step`` an int32
    scalar tensor, every other leaf as ``from_numpy_tree`` loads it."""
    def conv(t):
        if t is None:
            return None
        if isinstance(t, Mapping):
            return {k: conv(v) for k, v in t.items()}
        return from_numpy_tree({"x": t}, device, dtype_map)["x"]
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32),
            "train": conv(state["train"]), "frozen": conv(state["frozen"]),
            "opt": {"m": conv(state["opt"]["m"]),
                    "v": conv(state["opt"]["v"])}}


class ParamTree(nn.Module):
    """A nested parameter dict as an nn.Module: ``p["wq"]["w"]`` and
    ``"lora" in p`` work as on the dict, and ``parameters()`` /
    ``state_dict()`` see every leaf.  ``defs`` (the matching ParamDef
    tree) checks each leaf's shape and sets ``requires_grad`` from the
    def's trainable flag — frozen base weights never collect grads."""

    def __init__(self, tree: Tree, defs: Tree):
        super().__init__()
        if set(tree) != set(defs):
            raise ValueError(f"param keys {sorted(tree)} != defs "
                             f"{sorted(defs)}")
        for k in sorted(tree):
            v, d = tree[k], defs[k]
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v, d))
                continue
            if tuple(v.shape) != tuple(d.shape):
                raise ValueError(f"param {k}: shape {tuple(v.shape)} != "
                                 f"def {tuple(d.shape)}")
            self.register_parameter(
                k, nn.Parameter(v, requires_grad=d.trainable))

    def __getitem__(self, k: str):
        return getattr(self, k)

    def keys(self):
        return [*self._modules, *self._parameters]

    def __contains__(self, k: str) -> bool:
        return k in self._modules or k in self._parameters
