"""Checkpointing: atomic, content-addressed, on the JAX package's layout.

Layout per step:  <dir>/step_<n>.tmp-<pid>/  ->  atomic rename  ->
<dir>/step_<n>/  holding one ``arrays.npz`` (dotted leaf path -> array)
and ``manifest.json`` (step, the leaf list with each leaf's logical dtype
and shape, the sha256 of the npz).  bf16 leaves are stored as their raw
uint16 view under the logical dtype "bfloat16", as JAX stores its
ml_dtypes arrays, so each package restores the other's checkpoints.
Partitioned trees (train/frozen with None holes) round-trip exactly: a
None position is a ``__none__`` leaf in the manifest.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

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


def save(state: Any, step: int, ckpt_dir: str, keep: int = 3) -> str:
    """Write ``state`` (nested dicts of tensors, None holes allowed) as
    step ``step`` under ``ckpt_dir``; keep the newest ``keep`` steps.
    Returns the step's directory; a step already published is kept."""
    base = pathlib.Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    tmp = base / f"step_{step:08d}.tmp-{os.getpid()}"
    final = base / f"step_{step:08d}"
    if final.exists():
        return str(final)
    tmp.mkdir(parents=True, exist_ok=True)
    arrays = {}
    meta = {"step": int(step), "leaves": []}
    for path, value in _walk(state):
        if value is None:
            meta["leaves"].append({"path": path, "none": True})
            continue
        arr, logical = _to_numpy(torch.as_tensor(value))
        key = path.strip("/").replace("/", ".")
        arrays[key] = arr
        meta["leaves"].append({"path": path, "key": key, "dtype": logical,
                               "shape": list(arr.shape)})
    npz_path = tmp / "arrays.npz"
    np.savez(npz_path, **arrays)
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


def restore(ckpt_dir: str, step: Optional[int] = None, device="cuda",
            verify: bool = True) -> Any:
    """Load step ``step`` (the newest by default) onto ``device``.  With
    ``verify`` the npz's sha256 must match the manifest's (IOError)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    final = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((final / "manifest.json").read_text())
    if verify and _sha256(final / "arrays.npz") != meta["sha256"]:
        raise IOError(f"checkpoint {final} corrupt (sha mismatch)")
    items: Dict[str, Any] = {}
    with np.load(final / "arrays.npz") as npz:
        for leaf in meta["leaves"]:
            if leaf.get("none"):
                items[leaf["path"]] = None
                continue
            items[leaf["path"]] = _to_torch(npz[leaf["key"]],
                                            leaf["dtype"]).to(device)
    out = _unwalk(items)
    if isinstance(out, dict) and isinstance(out.get("step"), torch.Tensor):
        out["step"] = out["step"].cpu()     # a state's counter: on the host
    return out
