"""Decoder-only LM: embeddings (plus learned positions, OPT) -> blocks (a
Python loop over pattern units, then the tail) -> final norm -> (tied or
separate) LM head.

Layer patterns (``ModelConfig.pattern``) cycle block kinds over layers:
("attn",) for the dense, MoE and VLM stacks, ("rec", "rec", "attn") for
RecurrentGemma (models/rglru.py), ("ssd",) for Mamba-2 (models/ssd.py,
a block without an FFN sub-layer).  The layers form pattern *units*; the
remainder layers (num_layers % len(pattern)) are the *tail*, blocks of
their own that run after the units and, in training, outside the
checkpoint, as in JAX.

The parameter tree keeps the JAX layout — ``{"embed", "final_norm",
"units": {"b0_attn": ...} stacked on a leading unit axis U, ["tail":
{"t0_rec": ...}], ["head"], ["pos"]}`` —
so the JAX package's params load unchanged (core/params.from_numpy_tree);
:class:`LM` holds each unit as its own ``ParamTree`` (views of the stacked
tensors).  Caches keep the JAX tree too, stacked on U — per-slot strips,
or with ``kv_pages`` page pools shared by the slots (serving/kv_pages.py)
— and are written in place.  Training runs on the param tree itself
(``lm_hidden``: per-unit views of the stacked leaves, so gradients land
on the stacked leaves as JAX's scan gives them).  The port covers the
attention stack (pattern ("attn",)), with RoPE or learned positions and
a dense, routed or MoE (models/moe.py, ``num_experts`` > 0) FFN, the
hybrid ("rec", "rec", "attn") stack and the SSD stack.

Under a mesh whose model axis has extent n > 1 (``sharding.axis_rules``),
a train step runs the Megatron sequence-parallel layout of JAX's
``seq_sp`` rule wherever n divides the positions (``seq_parallel``): the
residual between blocks is this rank's S/n chunk of the sequence, each
mixer (attention heads, RG-LRU channels, SSM heads) and FFN (hidden
columns, of each routed group or expert) is a tensor-parallel region
over its local part (models/attention.py, ffn.py, moe.py, rglru.py,
ssd.py), and the embedding lookup and the loss (train/loss.py) split the
vocabulary.  A sub-layer whose width does not divide computes replicated
inside its region.  Each rank stores only its part of every leaf
(``lm_storage_specs``, the placements the regions use; train/state.py):
the params a region gets are already local.

Serving under a mesh runs :class:`ShardedLM`: this rank's stored part of
every leaf (``ServeShard``: the same splits), its caches at the local
head / channel counts, or an attention cache's sequence split over the
model axis where JAX's ``cache_axes`` split it (``init_caches(...,
shard=)``; models/attention.py), one all-reduce of
each split sub-layer's partial output over the model axis
(``core/collectives.model_sum``), of the vocabulary-split embedding's
lookups, and one all-gather of the logits over the model axis a step;
expert columns stored over the data axis are gathered over it per layer
at use (ZeRO-3).

Frontends are stubs, as in JAX: a VLM's ``batch["frontend_embeds"]``
(B, F, d) carries precomputed patch embeddings, prepended to the token
embeddings.  The encoder-decoder (audio) family has its own module,
models/encdec.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core.params import (ParamDef, ParamTree, init_tree,
                                     leaves, spec_tree, stack_defs,
                                     unflatten)
from repro_torch.models import attention, ffn, layers, moe, rglru, ssd
from repro_torch.serving import kv_pages as kvp
from repro_torch.sharding.context import local_slice


AUX_KEYS = ("lb_loss", "dropped", "qerr")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU; asking for CUDA without a card raises (no silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return dev


# ---------------------------------------------------------------- blocks
def block_defs(cfg: ModelConfig, kind: str) -> dict:
    defs = {"norm_mix": layers.norm_defs(cfg.d_model, cfg.norm)}
    if kind == "attn":
        defs["mixer"] = attention.attn_defs(cfg)
    elif kind == "rec":
        defs["mixer"] = rglru.rglru_defs(cfg)
    elif kind == "ssd":
        defs["mixer"] = ssd.ssd_defs(cfg)
        return defs                 # ssd blocks have no FFN sub-layer
    else:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    if cfg.num_experts > 0:
        defs["norm_ffn"] = layers.norm_defs(cfg.d_model, cfg.norm)
        defs["ffn"] = moe.moe_defs(cfg)
    elif cfg.d_ff > 0:
        defs["norm_ffn"] = layers.norm_defs(cfg.d_model, cfg.norm)
        defs["ffn"] = ffn.ffn_defs(cfg)
    return defs


def block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                device, shard: Optional["ServeShard"] = None,
                split_seq: bool = True) -> dict:
    """One block's cache; under ``shard`` (cfg its local config) at this
    rank's kv head / channel / SSM head counts, an attention cache's
    sequence split over the model axis where JAX splits it (unless
    ``split_seq`` is False: a paged engine's prefill rows, copied into
    pools that stay whole)."""
    if kind == "attn":
        sh = None if shard is None else shard.attn_sh
        if sh is None:
            return attention.init_cache(cfg, batch, max_len, device,
                                        cfg.window)
        return attention.init_cache(
            cfg, batch, max_len, device, cfg.window,
            kv_heads=sh.cache_heads(cfg),
            parts=(sh.parts(attention.cache_size(max_len, cfg.window))
                   if split_seq else 1))
    if kind == "rec":
        return rglru.init_rec_cache(cfg, batch, device)
    if kind == "ssd":
        n = shard.ax.size if shard is not None and shard.ssd else 1
        return ssd.init_ssm_cache(cfg, batch, device, n)
    raise NotImplementedError(f"block kind {kind!r} is not ported")


@dataclasses.dataclass(frozen=True)
class ServeShard:
    """How one rank's part of a model splits for serving: over the model
    axis ``ax`` (None: extent 1) ``cfg`` is the rank's config (local
    heads, hidden columns, RG-LRU width), each flag says that sub-layer
    splits (its partial outputs are summed over ``ax``; else it runs
    whole), ``vocab`` that the embedding's rows and the head's columns
    split; ``zero`` is the data axis that the expert columns of
    ``ffn_zero`` ((path, dim) pairs of an FFN's leaves) are stored over as
    well, gathered over it at use (ZeRO-3); ``attn_sh`` the attention
    layers' split (``attention.AttnShard``: the heads, the kv heads' and
    the caches' placement)."""
    ax: Optional[C.Axis]
    cfg: ModelConfig
    attn: bool
    ffn: bool
    rec: bool
    ssd: bool
    vocab: bool = False
    zero: Optional[C.Axis] = None
    ffn_zero: Tuple = ()
    attn_sh: Optional[attention.AttnShard] = None

    def mixer_ax(self, kind: str) -> Optional[C.Axis]:
        return self.ax if getattr(self, kind) else None

    @property
    def ffn_ax(self) -> Optional[C.Axis]:
        return self.ax if self.ffn else None

    @property
    def sizes(self) -> Dict[str, int]:
        return {"model": self.ax.size if self.ax else 1,
                C.ZERO_AXIS: self.zero.size if self.zero else 1}

    @property
    def coords(self) -> Dict[str, int]:
        return {"model": self.ax.rank if self.ax else 0,
                C.ZERO_AXIS: self.zero.rank if self.zero else 0}


def serve_shard(cfg: ModelConfig, ax: Optional[C.Axis],
                zero: Optional[C.Axis] = None) -> ServeShard:
    """The splits of ``cfg`` at the model extent ``ax.size``: the query
    heads (with their kv heads, or inside one kv head), the FFN's or
    each expert's hidden columns, the RG-LRU channels and the SSM heads,
    each where it divides (``tp_plan`` of each module), the vocabulary
    where it divides; and the expert columns stored over the data axis
    ``zero`` (``moe.storage_specs``)."""
    n = ax.size if ax is not None else 1
    local = cfg
    la = attention.tp_plan(cfg, n) if cfg.num_heads and n > 1 else None
    if la is not None:
        local = dataclasses.replace(local, num_heads=la.num_heads,
                                    num_kv_heads=la.num_kv_heads,
                                    head_dim=la.head_dim)
    lf = None
    if cfg.d_ff > 0 and n > 1:
        lf = (moe if cfg.num_experts > 0 else ffn).tp_plan(cfg, n)
    if lf is not None:
        local = dataclasses.replace(local, d_ff=lf.d_ff)
    lr = rglru.tp_plan(cfg, n) if "rec" in cfg.pattern and n > 1 else None
    if lr is not None:
        local = dataclasses.replace(local, lru_width=lr.lru_width)
    ffn_zero = ()
    if zero is not None and cfg.num_experts > 0:
        specs = moe.storage_specs(cfg, {"model": n, C.ZERO_AXIS: zero.size})
        ffn_zero = tuple((path, C.zero_dim(sp)) for path, sp in
                         leaves(specs)
                         if C.zero_dim(sp) is not None)
    return ServeShard(ax=ax, cfg=local, attn=la is not None,
                      ffn=lf is not None, rec=lr is not None,
                      ssd=n > 1 and "ssd" in cfg.pattern
                      and ssd.tp_plan(cfg, n),
                      vocab=n > 1 and cfg.padded_vocab % n == 0,
                      zero=zero if ffn_zero else None, ffn_zero=ffn_zero,
                      attn_sh=attention.serve_plan(cfg, ax if n > 1
                                                   else None))


# ------------------------------------------------------- storage placements
def whole_specs(defs: dict) -> dict:
    """Every leaf of a def tree replicated."""
    return spec_tree(defs, {})


def stack_specs(specs):
    """Specs of a layer-stacked tree (``stack_defs``): a leading layer
    entry, which no rule places."""
    if isinstance(specs, C.Pick):
        return C.Pick(specs.dim + 1, specs.index)
    if isinstance(specs, tuple):
        return (None, *specs)
    return {k: stack_specs(v) for k, v in specs.items()}


def block_storage_specs(cfg: ModelConfig, kind: str, sizes) -> dict:
    """The placements one block's params (``block_defs``) are stored
    under on a mesh of axis extents ``sizes``: each module's ``tp_specs``
    where its ``tp_plan`` splits at the model extent (the placements its
    regions and ``ShardedLM`` use), the MoE's ``storage_specs`` (expert
    columns over data as well), every other leaf whole."""
    n = sizes.get("model", 1)
    defs = block_defs(cfg, kind)
    out = whole_specs(defs)
    if kind == "attn" and n > 1 and attention.tp_plan(cfg, n) is not None:
        out["mixer"] = attention.tp_specs(cfg, n)
    elif kind == "rec" and n > 1 and rglru.tp_plan(cfg, n) is not None:
        out["mixer"] = rglru.tp_specs(cfg, n)
    elif kind == "ssd" and n > 1 and ssd.tp_plan(cfg, n):
        out["mixer"] = ssd.tp_specs(cfg, n)
    if "ffn" in defs and cfg.num_experts > 0:
        out["ffn"] = moe.storage_specs(cfg, sizes)
    elif "ffn" in defs and n > 1 and ffn.tp_plan(cfg, n) is not None:
        out["ffn"] = ffn.tp_specs(cfg, n)
    return filled_specs(defs, out)


def filled_specs(defs, specs):
    """``specs`` with each None (replicated) leaf spelled as a tuple of
    Nones, one a dim."""
    if isinstance(defs, ParamDef):
        return (None,) * len(defs.shape) if specs is None else specs
    return {k: filled_specs(defs[k], specs[k]) for k in defs}


def vocab_specs(defs: dict, sizes) -> dict:
    """``defs``' top-level embedding and head placements: the vocabulary
    over the model axis where it divides (JAX's "vocab" rule)."""
    n = sizes.get("model", 1)
    out = {}
    if "embed" in defs:
        v = defs["embed"]["embedding"].shape[0]
        out["embed"] = {"embedding": ("model", None) if n > 1 and v % n == 0
                        else (None, None)}
    if "head" in defs:
        v = defs["head"]["w"].shape[1]
        out["head"] = {"w": (None, "model") if n > 1 and v % n == 0
                       else (None, None)}
    return out


def lm_storage_specs(cfg: ModelConfig, sizes) -> dict:
    """The placements the LM's params (``lm_defs``) are stored under on a
    mesh of axis extents ``sizes`` (train/state.storage_specs documents
    where they differ from JAX's)."""
    defs = lm_defs(cfg)
    out = whole_specs(defs)
    out["units"] = stack_specs({f"b{i}_{kind}": block_storage_specs(
        cfg, kind, sizes) for i, kind in enumerate(cfg.pattern)})
    if "tail" in defs:
        out["tail"] = {f"t{i}_{kind}": block_storage_specs(cfg, kind, sizes)
                       for i, kind in enumerate(_tail_kinds(cfg))}
    out.update(vocab_specs(defs, sizes))
    return out


def local_params(tree, specs, sizes, coords, device=None):
    """This rank's part of a whole param tree (dicts, ParamTrees or an
    LM) under ``specs``: each leaf sliced (``sharding.local_slice``),
    contiguous, then moved to ``device`` — one leaf at a time, so a whole
    model on the host never reaches the device."""
    def walk(t, sp):
        if isinstance(t, torch.Tensor):
            out = local_slice(t.detach(), sp, sizes, coords)
            return out if device is None else out.to(device)
        return {k: walk(t[k], sp[k]) for k in t.keys()}
    return walk(tree, specs)


def block_apply(p, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                mode: str, cache=None, pos=None, kv_valid=None,
                page_table=None, seq_lengths=None, tp=None, shard=None):
    """Returns (x, cache, aux) with aux the block's AUX_KEYS entries that
    its layers report (scalars, f32) and, with telemetry counters on, its
    ``tel_*`` counters.  A ``rec`` or ``ssd`` block's mixer takes no
    positions, validity or lengths: its state is the whole history.
    tp: the model axis of the sequence-parallel layout (``seq_parallel``;
    x is this rank's sequence chunk).  shard: serving under a model axis
    (``ServeShard``): p is this rank's stored part, cfg the
    local config, and each split sub-layer's output is summed over the
    axis."""
    h = layers.apply_norm(p["norm_mix"], x, cfg.norm)
    ax = None if shard is None else shard.mixer_ax(kind)
    if kind == "attn":
        y, cache, a_aux = attention.attn_apply(
            p["mixer"], h, cfg, mode=mode, causal=True, window=cfg.window,
            cache=cache, pos=pos, kv_valid=kv_valid, page_table=page_table,
            seq_lengths=seq_lengths, tp=tp,
            serve=None if shard is None else shard.attn_sh)
    elif kind == "rec" and shard is not None:
        y, cache, a_aux = rglru.rec_forward(p["mixer"], h, cfg, mode=mode,
                                            cache=cache, ax=ax)
    elif kind == "rec":
        y, cache, a_aux = rglru.rec_apply(p["mixer"], h, cfg, mode=mode,
                                          cache=cache, tp=tp)
    elif kind == "ssd" and shard is not None:
        y, cache, a_aux = ssd.ssd_forward(p["mixer"], h, cfg, mode=mode,
                                          cache=cache, ax=ax)
    elif kind == "ssd":
        y, cache, a_aux = ssd.ssd_apply(p["mixer"], h, cfg, mode=mode,
                                        cache=cache, tp=tp)
    else:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    x = x + C.model_sum(y, ax).to(x.dtype)
    f_aux: dict = {}
    if "ffn" in p:
        h2 = layers.apply_norm(p["norm_ffn"], x, cfg.norm)
        if cfg.num_experts > 0:
            pf = (p["ffn"] if shard is None else
                  C.zero_gather(p["ffn"], shard.ffn_zero, shard.zero))
            y2, f_aux = moe.moe_apply(pf, h2, cfg, mode=mode,
                                      seq_lengths=seq_lengths, tp=tp)
        else:
            y2, f_aux = ffn.ffn_apply(p["ffn"], h2, cfg, mode=mode,
                                      seq_lengths=seq_lengths, tp=tp)
        if shard is not None:
            y2 = C.model_sum(y2, shard.ffn_ax)
        x = x + y2.to(x.dtype)
    # attention reports qerr (and tel_attn_*), the FFN or MoE lb_loss and
    # dropped (and tel_expert_*): no key in both
    aux = {k: v for a in (a_aux, f_aux) for k, v in a.items()
           if k in AUX_KEYS or k.startswith("tel_")}
    return x, cache, aux


def _unit_defs(cfg: ModelConfig) -> dict:
    return {f"b{i}_{kind}": block_defs(cfg, kind)
            for i, kind in enumerate(cfg.pattern)}


def _tail_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    return cfg.pattern[:cfg.num_layers % len(cfg.pattern)]


def num_units(cfg: ModelConfig) -> int:
    return cfg.num_layers // len(cfg.pattern)


_PATTERNS = (("attn",), ("rec", "rec", "attn"), ("ssd",))


def _check_supported(cfg: ModelConfig) -> None:
    """Every family the JAX package builds: the block patterns above,
    with or without a stub frontend; the audio family as the
    encoder-decoder of models/encdec.py (attention blocks, an encoder
    and cross-attention)."""
    if cfg.pattern not in _PATTERNS:
        raise NotImplementedError(f"{cfg.name}: block pattern "
                                  f"{cfg.pattern} is not ported")
    if cfg.family == "audio" and not (cfg.pattern == ("attn",)
                                      and cfg.encoder_layers > 0
                                      and cfg.cross_attention):
        raise NotImplementedError(f"{cfg.name}: the audio family is an "
                                  "encoder-decoder with cross-attention")


def block_cache_axes(cfg: ModelConfig, kind: str,
                     kv_paged: bool = False) -> dict:
    """Logical partition axes mirroring ``block_cache``'s structure (the
    paged pools' page axis replaces the batch and stays replicated)."""
    if kind == "attn":
        if kv_paged and cfg.window is None:
            kv, sp = (None, "kv_heads", None, None), (None, None)
        else:
            kv = ("batch", "kv_heads", "seq_shard", None)
            sp = ("batch", None)
        ax = {"k": kv, "v": kv, "slot_pos": sp}
        if attention.sparse_applicable(cfg):
            ax["codes"] = kv
        return ax
    if kind == "rec":
        return {"h": ("batch", "lru"), "conv": ("batch", None, "lru")}
    if kind == "ssd":
        return {"h": ("batch", "ssm_heads", None, None),
                "conv": ("batch", None, None)}
    raise NotImplementedError(f"block kind {kind!r} is not ported")


def cache_axes(cfg: ModelConfig, kv_paged: bool = False) -> dict:
    """Logical partition axes mirroring ``init_caches``' tree."""
    out = {"units": {
        f"b{i}_{kind}": {k: ("layer", *t) for k, t in
                         block_cache_axes(cfg, kind, kv_paged).items()}
        for i, kind in enumerate(cfg.pattern)}}
    tail = _tail_kinds(cfg)
    if tail:
        out["tail"] = {f"t{i}_{kind}": block_cache_axes(cfg, kind, kv_paged)
                       for i, kind in enumerate(tail)}
    return out


def lm_defs(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name} is an encoder-decoder: its params "
                         "are models/encdec.encdec_defs")
    defs: dict = {
        "embed": layers.embed_defs(cfg.padded_vocab, cfg.d_model),
        "final_norm": layers.norm_defs(cfg.d_model, cfg.norm),
        "units": stack_defs(_unit_defs(cfg), num_units(cfg)),
    }
    tail = _tail_kinds(cfg)
    if tail:
        defs["tail"] = {f"t{i}_{kind}": block_defs(cfg, kind)
                        for i, kind in enumerate(tail)}
    if not cfg.tie_embeddings:
        defs["head"] = {"w": ParamDef((cfg.d_model, cfg.padded_vocab),
                                      torch.bfloat16, ("embed", "vocab"),
                                      init="fan_in",
                                      trainable=False)}
    if cfg.positional == "learned":
        defs["pos"] = layers.pos_embed_defs(cfg.max_position, cfg.d_model)
    return defs


class LM(nn.Module):
    """The language model as modules: ``embed``, ``final_norm``, one
    ``ParamTree`` per unit in ``units``, the ``tail`` blocks (None when
    the layers fill whole units), ``head`` when untied and ``pos`` with
    learned positions.

    params: the JAX-layout tree of tensors (``init_tree`` or
    ``from_numpy_tree``); it is moved to ``device`` (CUDA by default)."""

    def __init__(self, cfg: ModelConfig, params: dict, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        defs = lm_defs(cfg)
        self.cfg = cfg
        params = {k: _to(v, dev) for k, v in params.items()}
        self.embed = ParamTree(params["embed"], defs["embed"])
        self.final_norm = ParamTree(params["final_norm"], defs["final_norm"])
        unit_defs = _unit_defs(cfg)
        self.units = nn.ModuleList(
            ParamTree(t, unit_defs)
            for t in unit_views(params["units"], num_units(cfg)))
        self.tail = (ParamTree(params["tail"], defs["tail"])
                     if "tail" in defs else None)
        for key in ("head", "pos"):
            if key in defs:
                setattr(self, key, ParamTree(params[key], defs[key]))

    @classmethod
    def init(cls, cfg: ModelConfig, seed: int = 0, device="cuda") -> "LM":
        """Random weights drawn from a seed on ``device``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_tree(lm_defs(cfg), gen), device=dev)

    def __getitem__(self, k: str):
        """``model["embed"]`` as on the param tree."""
        return getattr(self, k)

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device


class ShardedLM:
    """This rank's part of an :class:`LM` for serving under a mesh:
    ``shard`` (``ServeShard``), ``cfg`` the local config, every leaf as
    the storage rule places it (``lm_storage_specs``: heads, columns and
    the vocabulary over the model axis ``ax``, expert columns over the
    data axis ``zero`` as well), each unit a dict of views.  Built from a
    whole ``model`` (on the host or a device; each leaf sliced, then moved
    to ``device``, one at a time) or, by :meth:`from_local`, from the
    local param tree a rank already holds (a sharded train state's).  The
    decode and prefill functions of this module take it as they take an
    LM."""

    def __init__(self, model, cfg: ModelConfig, ax: Optional[C.Axis],
                 zero: Optional[C.Axis] = None, device=None, *,
                 local: bool = False):
        self.shard = serve_shard(cfg, ax, zero)
        self.cfg = self.shard.cfg
        sh = self.shard
        if not local:
            specs = lm_storage_specs(cfg, sh.sizes)
            whole = {k: getattr(model, k) for k in
                     ("embed", "final_norm", "head", "pos", "tail")
                     if getattr(model, k, None) is not None}
            unit = specs["units"]
            tree = local_params(whole, {k: specs[k] for k in whole},
                                sh.sizes, sh.coords, device)
            # per unit: its views' slices under the unstacked specs
            one = {k: unstack_specs(v) for k, v in unit.items()}
            units = [local_params(u, one, sh.sizes, sh.coords, device)
                     for u in model.units]
        else:
            tree = {k: v for k, v in model.items() if k != "units"}
            units = unit_views(model["units"], num_units(cfg))
        for key in ("embed", "final_norm", "head", "pos"):
            if key in tree:
                setattr(self, key, tree[key])
        self.units = units
        self.tail = tree.get("tail")

    @classmethod
    def from_local(cls, params: dict, cfg: ModelConfig,
                   ax: Optional[C.Axis], zero: Optional[C.Axis] = None
                   ) -> "ShardedLM":
        """The shard of the local param tree ``params`` (the JAX layout,
        every leaf already this rank's part: ``train/state.init_state(...,
        mesh=)``'s, or ``abstract_state``'s for a dry run)."""
        return cls(params, cfg, ax, zero, local=True)

    def __getitem__(self, k: str):
        return getattr(self, k)

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device


def unstack_specs(specs):
    """The specs of one unit of a stacked tree (``stack_specs``'
    inverse)."""
    if isinstance(specs, C.Pick):
        return C.Pick(specs.dim - 1, specs.index)
    if isinstance(specs, tuple):
        return specs[1:]
    return {k: unstack_specs(v) for k, v in specs.items()}


def _shard_of(model) -> Optional[ServeShard]:
    return getattr(model, "shard", None)


def _to(t, dev):
    if isinstance(t, dict):
        return {k: _to(v, dev) for k, v in t.items()}
    return t.to(dev)


def _kind_paged(cfg: ModelConfig, kind: str, kv_pages) -> bool:
    """A block's cache uses the paged pool layout: attention without a SWA
    ring (the ring is already window-bounded) under a paged engine."""
    return kind == "attn" and kv_pages is not None and cfg.window is None


def paged_applicable(cfg: ModelConfig) -> bool:
    """The paged KV layout has something to page: at least one attention
    block whose cache is a full-length strip (no SWA ring bound)."""
    return ("attn" in cfg.pattern and cfg.window is None
            and cfg.family != "audio")


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                kv_pages: Optional[int] = None,
                shard: Optional[ServeShard] = None,
                split_seq: bool = True) -> dict:
    """Every block's cache: stacked (U, ...) under ``units``, the tail's
    unstacked under ``tail``.  kv_pages: when set, the attention caches
    without a SWA ring are (kv_pages, page_size, ...) pools shared across
    slots instead of per-slot (batch, max_len, ...) strips; recurrent
    states and ring caches keep the per-slot layout.  shard: serving under
    a model axis (cfg is then ``shard.cfg``): this rank's kv heads,
    channels and SSM heads, and its part of a sequence split over the
    axis (``block_cache``; ``split_seq`` False keeps them whole)."""
    def one_cache(kind):
        if _kind_paged(cfg, kind, kv_pages):
            sh = None if shard is None else shard.attn_sh
            return attention.init_paged_cache(
                cfg, kv_pages, device,
                None if sh is None else sh.cache_heads(cfg))
        return block_cache(cfg, kind, batch, max_len, device, shard,
                           split_seq)

    u = num_units(cfg)
    caches = {"units": {
        f"b{i}_{kind}": {k: v[None].repeat(u, *(1,) * v.dim())
                         for k, v in one_cache(kind).items()}
        for i, kind in enumerate(cfg.pattern)}}
    tail = _tail_kinds(cfg)
    if tail:
        caches["tail"] = {f"t{i}_{kind}": one_cache(kind)
                          for i, kind in enumerate(tail)}
    return caches


# ---------------------------------------------------------------- forward
def seq_parallel(cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                 ) -> Optional[C.Axis]:
    """The model axis when a train step on ``batch`` runs the sequence-
    parallel layout: a mesh whose model axis has extent n > 1 and divides
    the positions (a decoder's frontend rows included; the encoder-
    decoder's frames and decoder tokens each); None otherwise (the step
    then gathers the whole parameters and computes replicated over the
    model axis: launch/steps.loss_and_grads)."""
    ax = C.model_axis()
    if ax is None:
        return None
    s = batch["tokens"].shape[1]
    fe = batch.get("frontend_embeds")
    if cfg.family == "audio":
        return (ax if s % ax.size == 0 and fe is not None
                and fe.shape[1] % ax.size == 0 else None)
    if cfg.frontend_tokens and fe is not None:
        s += fe.shape[1]
    return ax if s % ax.size == 0 else None


def vocab_rows(params, cfg: ModelConfig, tokens: torch.Tensor,
               ax: Optional[C.Axis]) -> Tuple[torch.Tensor, bool]:
    """(embeddings of ``tokens``, whole): the lookup in the whole table
    (whole True), or, where the table's rows split over the model axis
    ``ax`` (a stored part of V/n rows), in this rank's rows, zeros for the
    tokens the other ranks hold (whole False: the sum over ``ax`` is the
    lookup, each row its one nonzero part, so the sum is exact)."""
    emb = params["embed"]["embedding"]
    vl = emb.shape[0]
    if vl == cfg.padded_vocab:
        return layers.embed_lookup(params["embed"], tokens, cfg.scale_embed,
                                   cfg.d_model), True
    local = tokens.long() - ax.rank * vl
    ok = (local >= 0) & (local < vl)
    x = layers.embed_lookup({"embedding": emb}, local.clamp(0, vl - 1),
                            cfg.scale_embed, cfg.d_model)
    return x * ok[..., None].to(x.dtype), False


def _embed_seq_parallel(params, cfg: ModelConfig, tokens: torch.Tensor,
                        frontend_embeds, tp: C.Axis) -> torch.Tensor:
    """This rank's chunk of the input rows (B, S/n, d) of a train step.
    With the vocabulary split over the model axis, each rank looks up the
    tokens in its rows of the embedding (``vocab_rows``; a frontend's
    rows ride on rank 0) and one reduce-scatter sums the parts and keeps
    the rank's chunk.  Else the whole lookup, split."""
    x, whole = vocab_rows(params, cfg, tokens, tp)
    fe = (frontend_embeds if cfg.frontend_tokens
          and frontend_embeds is not None else None)
    if fe is not None:
        fe = fe.to(x.dtype)
        x = torch.cat([fe if whole or tp.rank == 0 else torch.zeros_like(fe),
                       x], dim=1)
    x = C.split_seq(x, tp) if whole else C.scatter_seq(x, tp)
    if cfg.positional == "learned":
        s = x.shape[1]
        pos = tp.rank * s + torch.arange(s, dtype=torch.long, device=x.device)
        x = x + params["pos"]["pos_embedding"][
            pos.clamp(0, cfg.max_position - 1)]
    return x


def _embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor, pos0=0,
                  frontend_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Token embeddings (B, s, d) — with ``frontend_embeds`` (B, F, d) of
    a frontend config prepended, (B, F + s, d) — plus the learned
    position rows when ``cfg.positional == "learned"``: a scalar ``pos0``
    gives positions pos0 + [0, s), a per-slot (B,) ``pos0`` gives (B, s)
    of them; each is clamped to [0, max_position - 1], as JAX's
    ``take(mode="clip")``.  A serving shard's vocabulary-split table adds
    its ranks' lookups over the model axis."""
    ax = getattr(_shard_of(params), "ax", None)
    x, whole = vocab_rows(params, cfg, tokens, ax)
    if not whole:
        x = C.model_sum(x, ax)
    if cfg.frontend_tokens and frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    if cfg.positional == "learned":
        s = x.shape[1]
        p0 = torch.as_tensor(pos0, dtype=torch.long, device=x.device)
        ar = torch.arange(s, dtype=torch.long, device=x.device)
        pos = p0[:, None] + ar if p0.dim() else p0 + ar
        x = x + params["pos"]["pos_embedding"][
            pos.clamp(0, cfg.max_position - 1)]
    return x


def _run_blocks(units, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
                caches=None, pos=None, remat: bool = True, kv_valid=None,
                page_table=None, seq_lengths=None, tail=None, tp=None,
                shard=None):
    """Run the pattern units (``LM.units`` or per-unit param dicts), then
    the tail blocks (``tail``: ``LM.tail`` or the ``"tail"`` param dict)
    over x.  Returns (x, aux): in train mode aux sums AUX_KEYS over every
    block, and with ``remat`` each unit runs under a non-reentrant
    checkpoint (its activations are recomputed in backward, kernels
    included, as JAX's jax.checkpoint of the scan body does); the tail
    runs outside it, once.  Inference modes skip the aux sums (no extra
    launches on the decode path); the telemetry counters (``tel_*``,
    present only when the config turns them on) are summed over a unit's
    blocks and stacked per unit, (U, ...), as JAX's scan stacks them, and
    each tail block appends a row of the counters it reports.  tp: the
    model axis of the sequence-parallel layout (x is this rank's chunk);
    shard: serving under a model axis (``block_apply``)."""
    train = mode == "train"
    aux_total = ({k: torch.zeros((), dtype=torch.float32, device=x.device)
                  for k in AUX_KEYS} if train else {})
    tel: Dict[str, list] = {}
    rows = []                   # each unit's, then each tail block's, aux

    def unit_body(h, unit, u):
        aux_u = {}
        for i, kind in enumerate(cfg.pattern):
            name = f"b{i}_{kind}"
            c = (None if caches is None else
                 {k: v[u] for k, v in caches["units"][name].items()})
            h, _, aux = block_apply(unit[name], h, cfg, kind, mode=mode,
                                    cache=c, pos=pos, kv_valid=kv_valid,
                                    page_table=page_table,
                                    seq_lengths=seq_lengths, tp=tp,
                                    shard=shard)
            for k, val in aux.items():
                aux_u[k] = aux_u[k] + val if k in aux_u else val
        return h, aux_u

    for u, unit in enumerate(units):
        if train and remat and torch.is_grad_enabled():
            x, aux_u = checkpoint(unit_body, x, unit, u, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            x, aux_u = unit_body(x, unit, u)
        rows.append(aux_u)
    for i, kind in enumerate(_tail_kinds(cfg)):
        name = f"t{i}_{kind}"
        c = None if caches is None else caches["tail"][name]
        x, _, aux = block_apply(tail[name], x, cfg, kind, mode=mode, cache=c,
                                pos=pos, kv_valid=kv_valid,
                                page_table=page_table,
                                seq_lengths=seq_lengths, tp=tp, shard=shard)
        rows.append(aux)
    for aux in rows:
        for k, val in aux.items():
            if k.startswith("tel_"):
                tel.setdefault(k, []).append(val)
            elif train:
                aux_total[k] = aux_total[k] + val
    aux_total.update({k: torch.stack(v) for k, v in tel.items()})
    return x, aux_total


def unit_views(tree: dict, n: int) -> list:
    """Per-unit views of a stacked (n, ...) param tree, each leaf unbound
    once: its gradient is then one stack of the units' gradients (a view
    ``t[u]`` a unit would give each unit's at the stacked size, and their
    sum would grow with n squared)."""
    pairs = list(leaves(tree))
    parts = [t.unbind(0) for _, t in pairs]
    return [unflatten([p for p, _ in pairs], [part[u] for part in parts])
            for u in range(n)]


def _unit_trees(params: dict, cfg: ModelConfig) -> list:
    """Per-unit views of the stacked ``params["units"]`` tree."""
    return unit_views(params["units"], num_units(cfg))


def lm_hidden(params: dict, cfg: ModelConfig,
              batch: Dict[str, torch.Tensor], remat: bool = True
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train-mode forward of a JAX-layout param tree to the final hidden
    states (B, S_total, d) (S_total counts the frontend rows) and the
    summed aux.  Gradients reach the stacked leaves through the per-unit
    views.  Under the sequence-parallel layout (``seq_parallel``) the
    hidden states are this rank's chunk of the positions."""
    tp = seq_parallel(cfg, batch)
    if tp is not None:
        x = _embed_seq_parallel(params, cfg, batch["tokens"],
                                batch.get("frontend_embeds"), tp)
    else:
        x = _embed_inputs(params, cfg, batch["tokens"],
                          frontend_embeds=batch.get("frontend_embeds"))
    x, aux = _run_blocks(_unit_trees(params, cfg), cfg, x, mode="train",
                         remat=remat, tail=params.get("tail"), tp=tp)
    return layers.apply_norm(params["final_norm"], x, cfg.norm), aux


def head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    """(d, V_padded) LM head: the tied embedding's transpose or ``head``."""
    if cfg.tie_embeddings:
        return params["embed"]["embedding"].t()
    return params["head"]["w"]


def logits_of(model: LM, cfg: ModelConfig, hidden: torch.Tensor
              ) -> torch.Tensor:
    """Logits (..., V_padded); a serving shard's head of V/n columns
    gives its part, all-gathered over the model axis (one gather a
    step)."""
    out = hidden @ head_weight(model, cfg).to(hidden.dtype)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        out = torch.tanh(out / c) * c
    shard = _shard_of(model)
    if shard is not None and shard.vocab:
        out = C.gather(out, out.dim() - 1, shard.ax)
    return out


def _counters(aux: dict) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in aux.items() if k.startswith("tel_")}


@torch.no_grad()
def lm_decode_step(model: LM, cfg: ModelConfig, caches: dict,
                   token: torch.Tensor, pos: torch.Tensor,
                   kv_valid: Optional[torch.Tensor] = None,
                   page_table: Optional[torch.Tensor] = None,
                   return_counters: bool = False):
    """One token for every row.  token: (B,); pos: (B,) per-slot
    positions; kv_valid: optional (B, cache_size) slot validity shared by
    every layer ((B, MP * page_size) with a page table); page_table:
    optional (B, MP) slot->page map, given when the attention caches are
    paged pools (``init_caches(..., kv_pages=)``).  Writes the caches in
    place; returns logits (B, 1, V), and with ``return_counters`` also the
    telemetry counter tree (``tel_*`` stacked per unit; empty unless
    ``spt.telemetry`` != "off")."""
    x = _embed_inputs(model, cfg, token[:, None], pos0=pos)
    x, aux = _run_blocks(model.units, cfg, x, mode="decode", caches=caches,
                         pos=pos, kv_valid=kv_valid, page_table=page_table,
                         tail=model.tail, shard=_shard_of(model))
    x = layers.apply_norm(model.final_norm, x, cfg.norm)
    logits = logits_of(model, cfg, x)
    return (logits, _counters(aux)) if return_counters else logits


@torch.no_grad()
def lm_prefill(model: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
               max_len: int):
    """Prefill a (B, S) batch of full-length prompts (after the
    ``frontend_embeds`` rows of a frontend config).  Returns (caches,
    logits (B, 1, V) at the last position).  The attention takes the
    train-path kernels (PQ assignment, top-L thresholds, sparse
    attention) when the config selects them: no per-row lengths, so no
    ragged oracle."""
    tokens = batch["tokens"]
    shard = _shard_of(model)
    caches = init_caches(cfg, tokens.shape[0], max_len, tokens.device,
                         shard=shard)
    x = _embed_inputs(model, cfg, tokens,
                      frontend_embeds=batch.get("frontend_embeds"))
    x, _ = _run_blocks(model.units, cfg, x, mode="prefill", caches=caches,
                       pos=0, remat=False, tail=model.tail, shard=shard)
    x = layers.apply_norm(model.final_norm, x[:, -1:], cfg.norm)
    return caches, logits_of(model, cfg, x)


def supports_ragged_prefill(cfg: ModelConfig) -> bool:
    """Right-padded ragged prefill is exact only for pure-attention
    stacks: padding past a row's length is causally invisible to
    attention, but it would corrupt recurrent (rec / ssd) states."""
    return all(k == "attn" for k in cfg.pattern)


def length_sensitive(cfg: ModelConfig) -> bool:
    """Right-padding changes real-token outputs unless per-row lengths
    reach the layers: sparse MHA's top-L budget and routed-FFN / MoE
    dispatch capacity scale with the sequence length.  An attention-free
    stack (num_heads 0) has no top-L budget."""
    return ((cfg.num_heads > 0 and attention.sparse_applicable(cfg))
            or ffn.routed_applicable(cfg) or cfg.num_experts > 0)


def _mask_invalid_slots(caches: dict, lengths: torch.Tensor) -> dict:
    """Mark attention-cache slots holding positions >= lengths[b] as
    empty (slot_pos -1) so a right-padded prefill leaves no phantom KV;
    recurrent states have no slots."""
    for part, _, blk in _named_blocks(caches):
        if "slot_pos" in blk:
            sp = blk["slot_pos"]                          # ([U,] B, S)
            ln = lengths.reshape((1,) * (part == "units") + (-1, 1))
            sp.masked_fill_(sp >= ln, -1)
    return caches


@torch.no_grad()
def lm_prefill_ragged(model: LM, cfg: ModelConfig,
                      batch: Dict[str, torch.Tensor], lengths: torch.Tensor,
                      max_len: int, return_counters: bool = False,
                      split_seq: bool = True):
    """Prefill a (B, S) batch of right-padded prompts of per-row
    ``lengths`` (model positions: the frontend rows of a frontend config
    count, as in JAX).  Returns (caches, logits (B, 1, V) at each row's
    last real position), and with ``return_counters`` also the telemetry
    counter tree.  Each row's outputs equal an exact-length batch-1
    prefill: the causal mask hides pad keys, and the lengths reach the
    sparse-MHA budgets and routed-FFN capacities.  split_seq: as
    ``init_caches``' (False for rows bound for whole page pools)."""
    tokens = batch["tokens"]
    bsz = tokens.shape[0]
    shard = _shard_of(model)
    caches = init_caches(cfg, bsz, max_len, tokens.device, shard=shard,
                         split_seq=split_seq)
    x = _embed_inputs(model, cfg, tokens,
                      frontend_embeds=batch.get("frontend_embeds"))
    sl = lengths if length_sensitive(cfg) else None
    x, aux = _run_blocks(model.units, cfg, x, mode="prefill",
                         caches=caches, pos=0, seq_lengths=sl,
                         tail=model.tail, shard=shard)
    idx = torch.clamp(lengths.long() - 1, 0, x.shape[1] - 1)
    x_last = x.gather(1, idx[:, None, None].expand(bsz, 1, x.shape[-1]))
    x_last = layers.apply_norm(model.final_norm, x_last, cfg.norm)
    caches = _mask_invalid_slots(caches, lengths)
    logits = logits_of(model, cfg, x_last)
    if return_counters:
        return caches, logits, _counters(aux)
    return caches, logits


def write_slot_caches_rows(dst: dict, rows: dict, slots: torch.Tensor
                           ) -> dict:
    """Copy every row of a (Bp, ...) prefill group's caches into its
    engine slot, in place; the whole row is replaced, which doubles as the
    slot's recycling reset.  slots: (Bp,) int; -1 marks a bucket-padding
    row, which is dropped."""
    keep = torch.nonzero(slots >= 0).flatten()
    dest = slots[keep].long()
    for part, name, blk in _named_blocks(dst):
        _write_rows(blk, rows[part][name], keep, dest, part == "units")
    return dst


def _named_blocks(caches: dict):
    """(part, name, block cache) of every block, units then tail."""
    for part in ("units", "tail"):
        for name, blk in caches.get(part, {}).items():
            yield part, name, blk


def _write_rows(blk: dict, rows: dict, keep, dest, stacked: bool) -> None:
    for k, v in blk.items():
        if stacked:                                       # (U, B, ...)
            v[:, dest] = rows[k][:, keep].to(v.dtype)
        else:                                             # (B, ...)
            v[dest] = rows[k][keep].to(v.dtype)


def write_slot_caches_paged_rows(dst: dict, rows: dict, slots: torch.Tensor,
                                 page_table: torch.Tensor,
                                 cfg: ModelConfig) -> dict:
    """Paged counterpart of ``write_slot_caches_rows``: one page-wise
    write per cache tensor covers every row of a prefill group, in place.
    slots: (Bp,) slot per row, -1 for bucket-padding dummy rows, whose
    page rows become all -1 so every write drops; page rows past a
    slot's allocation (bucketed right-pad overhang, -1 ids) drop too —
    decode overwrites them before any read.  The U units are folded into
    the page axis (unit u's page i is row u * P + i of the folded pool),
    so each tensor takes one write.  Page ids are unique across slots."""
    ps = cfg.spt.kv_page_size
    ns = page_table.shape[0]
    slots = slots.to(page_table.device)
    pt_rows = torch.where(slots[:, None] >= 0,
                          page_table[slots.clamp(0, ns - 1).long()],
                          -1)                             # (Bp, MP)
    keep = torch.nonzero(slots >= 0).flatten()
    dest = slots[keep].long()
    for part, name, blk in _named_blocks(dst):
        if not _kind_paged(cfg, name.split("_", 1)[1], True):
            # recurrent states (the tail's too): per-slot rows
            _write_rows(blk, rows[part][name], keep, dest, part == "units")
            continue
        for key, pool in blk.items():                     # (U, P, ...)
            seqs = rows[part][name][key]                  # (U, Bp, ...)
            u, p = pool.shape[:2]
            off = torch.arange(u, device=pool.device)[:, None, None] * p
            pts = torch.where(pt_rows[None] >= 0, pt_rows[None] + off, -1)
            kvp.scatter_prefill_rows(
                pool.view(u * p, *pool.shape[2:]),
                pts.reshape(-1, pts.shape[-1]),
                seqs.reshape(-1, *seqs.shape[2:]).to(pool.dtype), ps,
                pad_value=-1 if key == "slot_pos" else 0)
    return dst


def reset_page_slots(caches: dict, cfg: ModelConfig, pid: torch.Tensor,
                     ok: torch.Tensor) -> dict:
    """Invalidate slot_pos of freshly allocated pages, in place (pid (B,),
    ok (B,) from kv_pages.alloc_masked): a recycled page still carries its
    previous tenant's slot_pos rows, which would look valid to the
    self-derived kv_valid of the gathered-view tier.  K/V/code rows need
    no reset — validity masks them until they are overwritten."""
    for name, blk in caches["units"].items():
        if not _kind_paged(cfg, name.split("_", 1)[1], True):
            continue                    # a recurrent state has no pages
        sp = blk["slot_pos"]                              # (U, P, ps)
        kvp.put_masked(sp, (slice(None), pid),
                       sp.new_full((sp.shape[0], pid.shape[0], sp.shape[2]),
                                   -1), ok, axis=1)
    return caches
