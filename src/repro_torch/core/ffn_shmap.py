"""Routed FFN with the explicit sequence-parallel collective schedule (the
port of the JAX package's ``core/ffn_shmap.py``, a ``shard_map`` there).

The Megatron-SP schedule, step by step as JAX pins it:

    x (batch->data, seq->model)                     [seq-sharded residual]
      -- all-gather(seq, model) -> the whole local sequence
      -- route + capacity dispatch (local, per sequence)
      -- up/gate products with the local (G, d, F/TP) weight shard, LoRA
      -- down product -> partial (B, G, C, d)
      -- combine scatter -> partial (B, S, d)
      -- reduce-scatter(seq, model) -> (batch->data, seq->model) output
      -- lb_loss pmean'd over the batch axes, dropped over model

Collective bytes per layer: AG(N) + RS(N) forward, RS(N) + AG(N)
backward, N = |activations|.  The local products are the grouped-FFN
kernel's op (kernel 9, at the shard's widths; its reference backward)
unless REPRO_DISABLE_KERNELS=1, then the core/ grouped path (JAX's
einsums); either is the function of ``impl="grouped"``.  The region
functions are core/collectives.py's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import collectives as C
from repro_torch.core import dispatch, lora
from repro_torch.core import routed_ffn as rf
from repro_torch.core.params import spec_tree
from repro_torch.sharding.rules import mesh_sizes, rules_for_mesh


def applicable(mesh, cfg: rf.RoutedFFNConfig, d_ff: int, seq: int,
               batch: int) -> bool:
    """The schedule applies: a mesh with a model axis whose extent divides
    each group's hidden width and the (global) sequence, and data axes
    that divide the (global) batch."""
    if mesh is None or "model" not in getattr(mesh, "mesh_dim_names", ()):
        return False
    sizes = mesh_sizes(mesh)
    tp = sizes["model"]
    dp = 1
    for a in C.BATCH_AXES:
        dp *= sizes.get(a, 1)
    return cfg.group_dim % tp == 0 and seq % tp == 0 and batch % dp == 0


def routed_ffn_shmap(x: torch.Tensor, p, cfg: rf.RoutedFFNConfig,
                     lora_cfg: lora.LoRAConfig, mesh, need_aux: bool = True
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B/dp, S/tp, d), this rank's rows and sequence chunk; returns y
    of the same shape and {"lb_loss", "dropped"}.  ``need_aux=False``
    (inference) skips the router softmax and the load-balance loss."""
    tp = C.mesh_axis(mesh, "model")
    dp = C.mesh_axis(mesh, C.BATCH_AXES)
    n = tp.size if tp else 1
    specs = spec_tree(rf.param_defs(cfg, lora_cfg), rules_for_mesh(mesh))
    xf, p_loc = C.enter_region(x, p, specs, tp)
    local = dataclasses.replace(cfg, d_ff=cfg.d_ff // n)
    if dispatch.kernels_disabled():
        y, aux = rf.routed_ffn(xf, p_loc, local, lora_cfg, impl="grouped",
                               need_aux=False)
    else:
        from repro_torch.kernels.routed_ffn import ops as rffn_ops
        y, aux = rffn_ops.routed_ffn(xf, p_loc, local, lora_cfg,
                                     need_aux=False)
    y = C.scatter_seq(y.to(x.dtype), tp)
    if need_aux:
        choice, _, probs = rf.route(xf, p_loc["router"], cfg)
        lb = dispatch.load_balance_loss(probs, choice, cfg.num_groups,
                                        global_batch=False)
        # JAX pmeans over the batch axes; the value is alike on every
        # model rank, so it leaves the region by mean_exit
        lb = C.mean_exit(C.pmean(lb, dp), tp)
    else:
        lb = torch.zeros((), dtype=torch.float32, device=x.device)
    dropped = aux["dropped"].detach()
    if tp is not None:
        dropped = C.all_reduce_(dropped.clone(), tp) / tp.size
    return y, {"lb_loss": lb, "dropped": dropped}
