"""Checkpointing: atomic, content-addressed, on the JAX package's layout.

Layout per step:  <dir>/step_<n>.tmp-<pid>/  ->  atomic rename  ->
<dir>/step_<n>/  holding one ``arrays.npz`` (dotted leaf path -> array)
and ``manifest.json`` (step, the leaf list with each leaf's logical dtype
and shape, the sha256 of the npz).  bf16 leaves are stored as their raw
uint16 view under the logical dtype "bfloat16", as JAX stores its
ml_dtypes arrays, so each package restores the other's checkpoints.
Partitioned trees (train/frozen with None holes) round-trip exactly: a
None position is a ``__none__`` leaf in the manifest.

A state stored in parts over a mesh (train/state.storage_specs) is
written whole: each leaf — a layer-stacked one a layer at a time — is
all-gathered (``collectives.gather_stored``), and rank 0 streams it into
the npz, so no rank ever holds more than one whole leaf (or layer).
``restore(..., specs=, mesh=)`` reads each leaf (a stacked one a layer
at a time) and keeps this rank's slice on the host before it moves it to
the device: the counterpart of JAX's ``restore(shardings=)``.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
from typing import Any, Dict, List, Optional, Tuple

import zipfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import collectives as C
from repro_torch.core.params import layer_spec
from repro_torch.sharding.context import Pick, local_slice
from repro_torch.sharding.rules import mesh_coords, mesh_sizes


def _walk(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return [(path + "/__none__", None)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_walk(tree[k], f"{path}/{k}"))
        return out
    return [(path, tree)]


def _unwalk(items: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, value in items.items():
        parts = [p for p in path.split("/") if p]
        if parts[-1] == "__none__":
            parts = parts[:-1]
            value = None
        if not parts:
            return value
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def _to_numpy(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array to store, logical dtype name) of one leaf."""
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:           # numpy has no bf16
        return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = x.numpy()
    return arr, str(arr.dtype)


def _sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _split(spec) -> bool:
    """A storage placement that splits its leaf."""
    return isinstance(spec, Pick) or any(e is not None for e in spec or ())


def _placements(specs: Any, stacked: Any, mesh) -> Tuple[dict, dict]:
    """{path: storage placement} and {path: layer-stacked} of a state's
    leaves under ``mesh`` (both empty without one)."""
    if mesh is None:
        return {}, {}
    if specs is None or stacked is None:
        raise ValueError("a mesh needs the state's storage placements and "
                         "its layer-stacked flags (train/state.storage_specs"
                         ", stacked_leaves)")
    return dict(_walk(specs)), dict(_walk(stacked))


def save(state: Any, step: int, ckpt_dir: str, keep: int = 3,
         specs: Any = None, mesh=None, stacked: Any = None) -> str:
    """Write ``state`` (nested dicts of tensors, None holes allowed) as
    step ``step`` under ``ckpt_dir``; keep the newest ``keep`` steps.
    Returns the step's directory; a step already published is kept.
    Under ``mesh`` (every rank calls it) ``state`` holds this rank's parts
    placed by ``specs`` (its tree of storage placements): each leaf is
    gathered whole, one at a time — a layer at a time where ``stacked``
    (train/state.stacked_leaves) flags it — and rank 0 writes it."""
    base = pathlib.Path(ckpt_dir)
    tmp = base / f"step_{step:08d}.tmp-{os.getpid()}"
    final = base / f"step_{step:08d}"
    writer = mesh is None or dist.get_rank() == 0
    if final.exists():
        return str(final)
    if writer:
        tmp.mkdir(parents=True, exist_ok=True)
    spec_of, stacked_of = _placements(specs, stacked, mesh)
    meta = {"step": int(step), "leaves": []}
    npz_path = tmp / "arrays.npz"
    zf = (zipfile.ZipFile(npz_path, "w", zipfile.ZIP_STORED,
                          allowZip64=True) if writer else None)
    try:
        for path, value in _walk(state):
            if value is None:
                meta["leaves"].append({"path": path, "none": True})
                continue
            value = torch.as_tensor(value)
            spec = spec_of.get(path)
            lead = None
            if not _split(spec):
                parts = [value]
            elif stacked_of[path]:          # a layer at a time
                lead = value.shape[0]
                parts = (C.gather_stored(value[u], layer_spec(spec), mesh)
                         for u in range(lead))
            else:
                parts = [C.gather_stored(value, spec, mesh)]
            if not writer:
                for _ in parts:             # its gathers only
                    pass
                continue
            key = path.strip("/").replace("/", ".")
            parts = iter(parts)
            arr, logical = _to_numpy(next(parts))
            shape = [lead] * (lead is not None) + list(arr.shape)
            with zf.open(f"{key}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_2_0(f, {
                    "descr": np.lib.format.dtype_to_descr(arr.dtype),
                    "fortran_order": False, "shape": tuple(shape)})
                f.write(arr.tobytes())
                for part in parts:
                    f.write(_to_numpy(part)[0].tobytes())
            meta["leaves"].append({"path": path, "key": key,
                                   "dtype": logical, "shape": shape})
    finally:
        if zf is not None:
            zf.close()
    if not writer:
        return str(final)
    meta["sha256"] = _sha256(npz_path)
    (tmp / "manifest.json").write_text(json.dumps(meta))
    os.replace(tmp, final)          # atomic publish
    _gc(base, keep)
    return str(final)


def _gc(base: pathlib.Path, keep: int) -> None:
    steps = sorted(p for p in base.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and ".tmp-" not in p.name)
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
    for p in base.iterdir():        # orphaned tmp dirs from crashes
        if ".tmp-" in p.name:
            shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in base.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and ".tmp-" not in p.name)
    return steps[-1] if steps else None


def _to_torch(arr: np.ndarray, logical: str) -> torch.Tensor:
    if str(arr.dtype) == logical:
        return torch.from_numpy(arr)
    signed = arr.view(f"i{arr.dtype.itemsize}")     # a raw view (bf16)
    return torch.from_numpy(signed).view(getattr(torch, logical))


def _read_header(f):
    version = np.lib.format.read_magic(f)
    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0)
    return read(f)


def _read(f, n: int, dtype) -> np.ndarray:
    """The next ``n`` elements of an npy member's data."""
    return np.frombuffer(bytearray(f.read(n * dtype.itemsize)), dtype)


def restore(ckpt_dir: str, step: Optional[int] = None, device="cuda",
            verify: bool = True, specs: Any = None, mesh=None,
            stacked: Any = None) -> Any:
    """Load step ``step`` (the newest by default) onto ``device``.  With
    ``verify`` the npz's sha256 must match the manifest's (IOError).
    Under ``mesh``, each leaf as this rank stores it under ``specs`` (the
    tree's storage placements): read a layer at a time where ``stacked``
    (train/state.stacked_leaves) flags it, sliced on the host
    (``sharding.local_slice``), then moved to ``device``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    final = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((final / "manifest.json").read_text())
    if verify and _sha256(final / "arrays.npz") != meta["sha256"]:
        raise IOError(f"checkpoint {final} corrupt (sha mismatch)")
    spec_of, stacked_of = _placements(specs, stacked, mesh)
    sizes = mesh_sizes(mesh) if mesh is not None else {}
    coords = mesh_coords(mesh) if mesh is not None else {}
    items: Dict[str, Any] = {}
    with zipfile.ZipFile(final / "arrays.npz") as zf:
        for leaf in meta["leaves"]:
            if leaf.get("none"):
                items[leaf["path"]] = None
                continue
            spec = spec_of.get(leaf["path"])
            with zf.open(f"{leaf['key']}.npy") as f:
                shape, fortran, dtype = _read_header(f)
                if fortran:
                    raise IOError(f"{leaf['key']}: Fortran order")
                if _split(spec) and stacked_of[leaf["path"]]:
                    lspec = layer_spec(spec)
                    n = int(np.prod(shape[1:], dtype=np.int64))
                    t = torch.stack([local_slice(_to_torch(
                        _read(f, n, dtype).reshape(shape[1:]),
                        leaf["dtype"]), lspec, sizes, coords)
                        for _ in range(shape[0])])
                else:
                    n = int(np.prod(shape, dtype=np.int64))
                    t = _to_torch(_read(f, n, dtype).reshape(shape),
                                  leaf["dtype"])
                    if _split(spec):
                        t = local_slice(t, spec, sizes, coords)
            items[leaf["path"]] = t.clone().to(device)
    out = _unwalk(items)
    if isinstance(out, dict) and isinstance(out.get("step"), torch.Tensor):
        out["step"] = out["step"].cpu()     # a state's counter: on the host
    return out
