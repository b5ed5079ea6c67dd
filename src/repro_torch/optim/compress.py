"""Gradient compression for a slow all-reduce (the JAX package's
``optim/compress.py`` in torch).

Two schemes, both stateless:
  * int8: per-tensor absmax scaling, symmetric int8 quantization.
  * topk: keep the top-k fraction by magnitude (values + int32 indices),
    the rest dropped (error feedback is the caller's choice).  Ties in
    magnitude go to the lower flat index, as ``jax.lax.top_k`` breaks
    them (a stable descending sort; ``torch.topk`` promises no order).

With LoRA-only gradients the traffic is already ~1000x smaller than full
tuning; compression is for clusters where even that crosses slow links
every step.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "int8"   # int8 | topk | none
    topk_fraction: float = 0.1


def _c_int8(x: torch.Tensor) -> dict:
    absmax = torch.clamp(x.abs().max(), min=1e-12)
    q = torch.clamp(torch.round(x / absmax * 127.0), -127, 127)
    return {"q": q.to(torch.int8), "scale": absmax / 127.0}


def _d_int8(c: dict) -> torch.Tensor:
    return c["q"].float() * c["scale"]


def _c_topk(x: torch.Tensor, frac: float) -> dict:
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return {"vals": flat[idx], "idx": idx.to(torch.int32),
            "shape": tuple(x.shape)}


def _d_topk(c: dict) -> torch.Tensor:
    n = 1
    for d in c["shape"]:
        n *= d
    out = torch.zeros(n, dtype=torch.float32, device=c["vals"].device)
    out[c["idx"].long()] = c["vals"].float()
    return out.reshape(c["shape"])


def _map(fn, tree: Any, is_leaf) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: _map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def _is_packet(x) -> bool:
    return isinstance(x, dict) and ("q" in x or "vals" in x)


def compress_tree(tree: Any, cfg: CompressionConfig) -> Any:
    """Each tensor of a nested dict (None holes kept) as its packet."""
    if cfg.scheme == "none":
        return tree
    if cfg.scheme == "int8":
        return _map(_c_int8, tree, lambda x: False)
    if cfg.scheme == "topk":
        return _map(lambda x: _c_topk(x, cfg.topk_fraction), tree,
                    lambda x: False)
    raise ValueError(cfg.scheme)


def decompress_tree(tree: Any, cfg: CompressionConfig) -> Any:
    """The f32 tensors of a tree of packets."""
    if cfg.scheme == "none":
        return tree
    fn = _d_int8 if cfg.scheme == "int8" else _d_topk
    return _map(fn, tree, _is_packet)
