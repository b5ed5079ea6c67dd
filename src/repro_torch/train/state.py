"""Train state: {step, train (LoRA/router/codebooks), frozen (base), opt}.

The trainable/frozen split is at the tree level (core.params.partition),
so gradients are only ever taken over the small trainable subtree; the
frozen base never gets gradient buffers.  The layout is the JAX
package's, so a JAX state loads with ``core.params.from_numpy_state``.
The step counter is a 0-d int32 tensor on the host whatever the device of
the rest: the learning rate is computed there from it
(``optim/schedule.lr_at``), with no device-to-host read in a step.

Under a mesh every rank holds only its part of each parameter, gradient
and AdamW moment, placed by one storage rule (``storage_specs``, read by
``sharding.local_slice``): ``init_state(..., mesh=)`` draws the parts,
``abstract_state(cfg, rules)`` gives their shapes, ``local_state`` cuts
a whole state (a JAX one, say) down to them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import params as P
from repro_torch.models import encdec, transformer
from repro_torch.optim.adamw import adamw_init
from repro_torch.sharding.context import local_shape, local_slice
from repro_torch.sharding.rules import mesh_coords, mesh_sizes


def model_defs(cfg: ModelConfig) -> dict:
    """The param defs of a model: the encoder-decoder for the audio
    family, the decoder-only LM otherwise."""
    if cfg.family == "audio":
        return encdec.encdec_defs(cfg)
    return transformer.lm_defs(cfg)


def model_hidden(params: dict, cfg: ModelConfig, batch: Dict[str, Any],
                 remat: bool = True):
    if cfg.family == "audio":
        return encdec.encdec_hidden(params, cfg, batch, remat=remat)
    return transformer.lm_hidden(params, cfg, batch, remat=remat)


def init_state(cfg: ModelConfig, seed: int = 0, device="cuda",
               mesh=None) -> dict:
    """Random weights from a seed on ``device`` (CUDA unless the caller
    asks for the CPU), split into trainable and frozen trees, with zero
    AdamW moments.  Under ``mesh`` this rank's parts only
    (``storage_specs``): exactly the slices of the state a world of one
    draws from the seed, with no more than one whole leaf (one layer of a
    stacked one) drawn at a time (``core/params.init_tree``)."""
    dev = transformer.resolve_device(device)
    defs = model_defs(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mesh is None:
        params = P.init_tree(defs, gen)
    else:
        sizes, coords = mesh_sizes(mesh), mesh_coords(mesh)
        params = P.init_tree(defs, gen, model_storage_specs(cfg, sizes),
                             sizes, coords)
    train, frozen = P.partition(params, P.trainable_mask(defs))
    return {"step": torch.zeros((), dtype=torch.int32),
            "train": train, "frozen": frozen, "opt": adamw_init(train)}


def abstract_state(cfg: ModelConfig, rules=None) -> dict:
    """The state ``init_state`` gives, as meta tensors (no storage, no
    data): what one rank holds, for a dry run (launch/dryrun.py) — the
    whole state, or under ``rules`` (``sharding.rules_for_mesh``) the
    parts ``storage_specs`` gives a rank.  The step counter stays a 0-d
    CPU tensor, as in every state."""
    defs = model_defs(cfg)
    specs = sizes = None
    if rules is not None:
        sizes = rules.get("__sizes__", {})
        specs = model_storage_specs(cfg, sizes)
    train, frozen = P.partition(P.abstract_tree(defs, specs, sizes),
                                P.trainable_mask(defs))
    return {"step": torch.zeros((), dtype=torch.int32),
            "train": train, "frozen": frozen, "opt": adamw_init(train)}


def model_storage_specs(cfg: ModelConfig, sizes) -> dict:
    """The placements the model's params are stored under on a mesh of
    axis extents ``sizes`` (``storage_specs``' parameter tree)."""
    if cfg.family == "audio":
        return encdec.encdec_storage_specs(cfg, sizes)
    return transformer.lm_storage_specs(cfg, sizes)


def storage_specs(cfg: ModelConfig, rules) -> dict:
    """The state's storage placements under ``rules`` (the mesh's extents
    in ``rules["__sizes__"]``): one tuple per leaf (an entry per dim: a
    mesh axis, a tuple of them, or None), or a ``sharding.Pick``, as
    ``sharding.local_slice`` reads them; the AdamW moments as their
    leaves.  The placements are those the port's regions use
    (``transformer.block_storage_specs``): heads, kv heads, FFN and
    expert columns, RG-LRU channels and SSM heads over ``model`` where
    each module's ``tp_plan`` splits; the embedding's rows and the head's
    columns over ``model`` (``vocab``); the MoE's ``expert_ffn`` dims over
    ``model`` and ``data`` (ZeRO-3).  Where they differ from JAX's
    ``state_specs``, leaf by leaf (the bytes a rank holds differ only in
    the first three):

      * the SSD block: ``in_proj.w`` and ``in_proj.lora.c`` and ``conv``
        are a Pick of rank r's z, x and dt columns plus B and C whole
        (JAX: ``ssm_inner`` splits the fused columns contiguously, and
        ``conv`` is whole); ``a_log``, ``d_skip``, ``dt_bias`` and
        ``norm.scale`` split over the heads (JAX: whole);
      * a module whose ``tp_plan`` does not split keeps every leaf whole
        where JAX splits a dim that divides: h2o-danube-1.8b's routed FFN
        at model 16 (54 columns a rank are not kernel rows), query heads
        that do not divide the model extent (whisper-base's 8 at 16), kv
        heads that neither divide it nor divide into it, and kv heads that
        do not split under "kvgroup" selection;
      * a one-block RG-LRU gate: ``w_a`` / ``w_i`` split on their output
        columns (JAX: whole, one block does not divide);
      * MoE ``expert_ffn`` dims: ordered ("model", "data"), model-major,
        so a data gather gives the region's model chunk (JAX:
        ("data", "model")); over ``model`` alone where the model chunk
        does not divide by the data extent (JAX: whole unless data x
        model divides).

    The attention follows JAX's placement wherever its heads split,
    also where the query heads split inside a kv head: ``wk`` / ``wv``
    over their columns (each rank gathers them where it uses them).
    JAX's compiled decode step takes as arguments only the leaves it
    reads, the port's the whole serving model: an encoder-decoder's
    encoder and cross-attention ``wk`` / ``wv`` (read at prefill only)
    count in the port's decode arguments and not in JAX's
    (whisper-base's smoke at (1, 4): 172,544 + 28,672 B a rank, the
    whole of the 201,216 B between the two)."""
    sizes = rules.get("__sizes__", {})
    defs = model_defs(cfg)
    train_s, frozen_s = P.partition(model_storage_specs(cfg, sizes),
                                    P.trainable_mask(defs))
    return {"step": (), "train": train_s, "frozen": frozen_s,
            "opt": {"m": train_s, "v": train_s}}


def stacked_leaves(cfg: ModelConfig) -> dict:
    """Per leaf of the state (the tree ``storage_specs`` gives), whether
    it is layer-stacked (``core/params.stacked``): the checkpoint moves
    such a leaf a layer at a time."""
    defs = model_defs(cfg)
    train, frozen = P.partition(P.stacked_mask(defs), P.trainable_mask(defs))
    return {"step": False, "train": train, "frozen": frozen,
            "opt": {"m": train, "v": train}}


def local_state(state: dict, cfg: ModelConfig, mesh) -> dict:
    """This rank's part of ``state`` under ``mesh`` (``storage_specs``): a
    leaf of its whole shape is sliced (``sharding.local_slice``), one of
    its stored shape kept."""
    sizes, coords = mesh_sizes(mesh), mesh_coords(mesh)
    specs = storage_specs(cfg, {"__sizes__": sizes})

    def walk(t, sp, whole):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k], sp[k], whole[k]) for k in t}
        if tuple(t.shape) == tuple(whole.shape):
            return local_slice(t, sp, sizes, coords)
        if tuple(t.shape) != local_shape(whole.shape, sp, sizes):
            raise ValueError(f"a leaf of shape {tuple(t.shape)} is neither "
                             f"whole {tuple(whole.shape)} nor a part of it "
                             f"under {sp}")
        return t
    whole = abstract_state(cfg)
    whole["opt"] = {"m": whole["train"], "v": whole["train"]}
    return {"step": state["step"],
            **{k: walk(state[k], specs[k], whole[k])
               for k in ("train", "frozen", "opt")}}


def state_device(state: dict) -> torch.device:
    """The device a state's parameters live on (the step counter is on
    the host)."""
    for part in ("frozen", "train"):
        for _, t in P.leaves(state[part]):
            if t is not None:
                return t.device
    return state["step"].device


def state_specs(cfg: ModelConfig, rules) -> dict:
    """JAX's placement tree of the state under ``rules`` (its
    ``PartitionSpec`` tree read as tuples; core/params.spec_tree).  The
    port stores by ``storage_specs``."""
    defs = model_defs(cfg)
    train_s, frozen_s = P.partition(P.spec_tree(defs, rules),
                                    P.trainable_mask(defs))
    return {"step": (), "train": train_s, "frozen": frozen_s,
            "opt": {"m": train_s, "v": train_s}}


def param_specs(cfg: ModelConfig, rules) -> dict:
    return P.spec_tree(model_defs(cfg), rules)


def full_params(state: dict) -> dict:
    """The model's whole parameter tree: the trainable and frozen halves
    of ``state`` put back together."""
    return P.combine(state["train"], state["frozen"])
