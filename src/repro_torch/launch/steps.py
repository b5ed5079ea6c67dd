"""Step builders and placement trees.

  * ``build_train_step`` — forward, chunked cross-entropy, backward into
    the trainable leaves, AdamW; under a mesh (``sharding.axis_rules``)
    each rank holds its stored parts of the state (train/state.py) and
    takes its data rank's rows, the loss's sums and the aux statistics
    are reduced over the data axes before division, each gradient is
    this rank's part of the global batch's, and the global-norm clip
    counts every element of the model once;
  * the serving prefill and decode steps;
  * ``batch_specs`` / ``cache_specs`` — the JAX package's placement
    trees, each ``PartitionSpec`` read as a tuple; ``train_shardings`` /
    ``decode_shardings`` — the placements the port's state and serving
    params are stored under (train/state.storage_specs, which says
    where they differ from JAX's), with JAX's batch and cache placements,
    which the port's caches keep;
    ``cache_local_shapes``, the decode caches a rank of a serving mesh
    holds.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core import params as P
from repro_torch.optim.adamw import OptimizerConfig, adamw_update
from repro_torch.models import transformer
from repro_torch.serving import engine
from repro_torch.sharding.context import current_rules, local_shape, spec_for
from repro_torch.train import state as S
from repro_torch.train.loss import lm_cross_entropy


def _storage(cfg: ModelConfig):
    """The state's storage placements under the active rules (None
    without a mesh)."""
    rules = current_rules()
    if rules is None or rules.get("__mesh__") is None:
        return None
    return S.storage_specs(cfg, rules)


def loss_and_grads(state: dict, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor], loss_chunk: int = 512):
    """(total loss, metrics, grads) of one batch; grads has the train
    tree's structure (zeros where no path from the loss reaches a leaf;
    empty when nothing is trainable, as under the "full" variant).
    total = lm + lb_w * lb / num_layers (+ qerr_w * qerr / num_layers).
    Under a mesh ``batch`` holds this data rank's rows and ``state`` this
    rank's stored parts (train/state.storage_specs): the loss's sums,
    ``qerr`` and ``dropped`` are reduced over the data axes (``lb_loss``
    already is, in dispatch.load_balance_loss or core/ffn_shmap.py), and
    each gradient is this rank's part of the global batch's: summed over
    the data axes here for a leaf replicated over them, by the ZeRO-3
    reduce-scatter of its region's backward for one stored over data.
    Positions that do not divide the model extent take no sequence-
    parallel layout: the step gathers the whole parameters
    (``collectives.gather_whole``) and computes alike on every model
    rank."""
    pairs = list(P.leaves(state["train"]))
    paths = [p for p, _ in pairs]
    train_vals = [v.detach().requires_grad_(True) for _, v in pairs]
    train = P.unflatten(paths, train_vals)
    params = P.combine(train, state["frozen"])
    specs = _storage(cfg)
    dp = C.batch_axis()
    tp = transformer.seq_parallel(cfg, batch)
    whole = tp is None and C.model_axis() is not None
    with torch.enable_grad(), (C.replicated_compute() if whole
                               else contextlib.nullcontext()):
        if whole:
            params = C.gather_whole(params, P.combine(specs["train"],
                                                      specs["frozen"]))
        hidden, aux = S.model_hidden(params, cfg, batch, remat=True)
        lm_loss, stats = lm_cross_entropy(params, cfg, hidden,
                                          batch["labels"], loss_chunk,
                                          tp=tp, dp=dp)
        if dp is not None:
            aux = {**aux, "qerr": C.pmean(aux["qerr"], dp),
                   "dropped": C.all_reduce_(aux["dropped"].detach().clone(),
                                            dp) / dp.size}
        nl = max(1, cfg.num_layers)
        total = lm_loss + cfg.spt.lb_loss_weight * aux["lb_loss"] / nl
        if cfg.spt.qerr_loss_weight:
            total = total + cfg.spt.qerr_loss_weight * aux["qerr"] / nl
        grads = (torch.autograd.grad(total, train_vals, allow_unused=True)
                 if train_vals else [])
    # a leaf no path reaches has a zero gradient, as jax.grad gives it
    zero = ([None] * len(paths) if specs is None else
            [C.zero_dim(sp) for _, sp in P.leaves(specs["train"])])
    grads = [torch.zeros_like(v) if g is None else
             C.all_reduce_(g, dp if z is None else None)
             for v, g, z in zip(train_vals, grads, zero)]
    metrics = {"lm_loss": lm_loss, **stats, "lb_loss": aux["lb_loss"],
               "dropped": aux["dropped"]}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, P.unflatten(paths, grads)


def build_train_step(cfg: ModelConfig, ocfg: OptimizerConfig,
                     loss_chunk: int = 512) -> Callable:
    """train_step(state, batch) -> (new_state, metrics): loss, lm_loss,
    nll_sum, tokens, accuracy, lb_loss, dropped, grad_norm, lr (0-d
    tensors).  batch: {"tokens", "labels"} (B, S) integer tensors on the
    state's device.  Under a mesh the state is this rank's parts, and
    AdamW updates them in place of the whole leaves."""
    def train_step(state: dict, batch: Dict[str, torch.Tensor]):
        loss, metrics, grads = loss_and_grads(state, cfg, batch, loss_chunk)
        specs = _storage(cfg)
        new_train, new_opt, om = adamw_update(
            state["train"], grads, state["opt"], state["step"], ocfg,
            specs=None if specs is None else specs["train"])
        new_state = {"step": state["step"] + 1, "train": new_train,
                     "frozen": state["frozen"], "opt": new_opt}
        return new_state, {"loss": loss, **metrics, **om}

    return train_step


def build_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    return engine.build_prefill_step(cfg, max_len)


def build_decode_step(cfg: ModelConfig) -> Callable:
    return engine.build_decode_step(cfg)


# ------------------------------------------------------------- placements
def batch_specs(cfg: ModelConfig, specs: Dict[str, Any], rules) -> dict:
    """Placement per batch input (train/prefill); ``specs`` maps a name to
    anything with a ``shape`` (configs/shapes.TensorSpec, a tensor)."""
    out = {}
    for name, sds in specs.items():
        if name in ("tokens", "labels"):
            out[name] = spec_for(sds.shape, ("batch", None), rules)
        elif name == "frontend_embeds":
            out[name] = spec_for(sds.shape, ("batch", None, None), rules)
        elif name == "token":
            out[name] = spec_for(sds.shape, ("batch",), rules)
        elif name == "pos":
            out[name] = ()
        else:
            raise KeyError(name)
    return out


def cache_specs(cfg: ModelConfig, abstract_caches, rules):
    """Placements of a decode cache tree (tensors, e.g. on the meta
    device, or anything with a ``shape``)."""
    def walk(c, ax):
        if isinstance(c, dict):
            return {k: walk(c[k], ax[k]) for k in c}
        return spec_for(c.shape, ax, rules)
    return walk(abstract_caches, engine.decode_cache_axes(cfg))


def cache_local_shapes(cfg: ModelConfig, abstract_caches, rules,
                       kv_paged: bool = False) -> dict:
    """The shape of every decode cache one rank holds when the engine
    serves under the mesh of ``rules`` (``abstract_caches``: the tree of
    ``init_caches`` / ``init_dec_caches`` for all the slots, e.g. on the
    meta device): JAX's ``cache_specs`` — slots over the data axes, kv
    heads, RG-LRU channels and SSM heads over ``model`` where they divide,
    else an attention cache's sequence over ``model`` where it divides.
    An SSD block's conv window is left out: the port splits its x
    channels and keeps B and C whole, which no spec expresses."""
    sizes = rules.get("__sizes__", {})

    def walk(c, ax, path):
        if isinstance(c, dict):
            return {k: walk(c[k], ax[k], path + (k,)) for k in c
                    if not (path and path[-1].endswith("_ssd")
                            and k == "conv")}
        return local_shape(c.shape, spec_for(c.shape, ax, rules), sizes)
    return walk(abstract_caches, engine.decode_cache_axes(
        cfg, kv_paged=kv_paged), ())


def train_shardings(cfg: ModelConfig, mesh, rules, specs):
    """(state, batch, new state, metrics) placements of a train step: the
    state as each rank stores it (``S.storage_specs``)."""
    st = S.storage_specs(cfg, rules)
    return st, batch_specs(cfg, specs, rules), st, ()


def decode_shardings(cfg: ModelConfig, mesh, rules, abstract_caches, specs):
    """(params, caches, batch, logits) placements of a decode step: the
    params as a serving rank stores them (``S.model_storage_specs``; the
    experts' columns over data as well), JAX's cache placements (the
    port's too: ``cache_local_shapes``), and the
    logits as the decode step returns them, all-gathered over the
    vocabulary."""
    logits = spec_for((1, 1, cfg.padded_vocab), ("batch", None, None),
                      rules)
    return (S.model_storage_specs(cfg, rules.get("__sizes__", {})),
            cache_specs(cfg, abstract_caches, rules),
            batch_specs(cfg, specs, rules), logits)
