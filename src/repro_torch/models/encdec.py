"""Encoder-decoder LM (whisper-base backbone).

The conv audio frontend is a stub, as in the JAX package: the caller
gives precomputed frame embeddings (B, F, d).  The encoder is a
bidirectional transformer stack over the frames; the decoder adds causal
self-attention and cross-attention to the encoder output.  Sparse MHA
applies to all three attention forms (the paper covers encoders and
decoders through the look-ahead mask, §4.1), the routed FFN to both
stacks.

Kernels: the encoder's attention, and the decoder's self- and
cross-attention at train and prefill, go through the fused sparse-MHA
kernels (PQ assignment, top-L thresholds, sparse attention) when the
config selects them, as JAX's ``attend`` sends them to its Pallas op;
the FFNs take the grouped-FFN kernel (train, prefill) and the
block-gather kernel (decode).  The decoder's self-attention decodes
through the sparse decode kernels.  The cross cache's PQ codes come from
the plain ``core.pq.assign`` and cross-attention decodes through the
plain ``core.sparse_attention.sparse_mha_decode``, as in JAX.

The cross-attention K / V (and PQ codes) are computed once at prefill
and cached.  Params keep the JAX tree (``enc_blocks`` / ``dec_blocks``
stacked on a leading layer axis); :class:`EncDecLM` holds each layer as
its own ``ParamTree`` (views of the stacked tensors).  Caches keep the
JAX tree too — ``{"self": attention caches, "cross": {k, v[, codes]}}``
stacked on the decoder layers — and are written in place.  Training
checkpoints each encoder and decoder layer, as JAX's ``jax.checkpoint``
of its scan bodies, so a layer's forward (its kernels included) runs
twice a step.

Under a model axis of extent n: a train step whose frames and decoder
tokens both divide by n runs the sequence-parallel layout
(``transformer.seq_parallel``): the encoder's and the decoder's residual
streams are this rank's chunks, every attention (self and cross) and FFN
a tensor-parallel region over its local heads or columns, the cross-
attention reading the encoder output gathered once.  Each rank stores
its heads, columns and V/n rows of the embedding (``encdec_storage_specs``).
Serving runs :class:`ShardedEncDec`: this rank's stored part, the self
and cross caches over the local kv heads (or, where the heads do not
split, their sequence over the model axis where it divides, as JAX's
``cache_axes`` place them: models/attention.py), each split sub-layer's
partial output summed over the model axis, the logits gathered over it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core import lora, pq
from repro_torch.core import sparse_attention as sa
from repro_torch.core.params import ParamTree, init_tree, stack_defs
from repro_torch.models import attention, ffn, layers, transformer


# ------------------------------------------------------------- defs
def _enc_block_defs(cfg: ModelConfig) -> dict:
    return {
        "norm_attn": layers.norm_defs(cfg.d_model, cfg.norm),
        "attn": attention.attn_defs(cfg),
        "norm_ffn": layers.norm_defs(cfg.d_model, cfg.norm),
        "ffn": ffn.ffn_defs(cfg),
    }


def _dec_block_defs(cfg: ModelConfig) -> dict:
    return {
        "norm_self": layers.norm_defs(cfg.d_model, cfg.norm),
        "self_attn": attention.attn_defs(cfg),
        "norm_cross": layers.norm_defs(cfg.d_model, cfg.norm),
        "cross_attn": attention.attn_defs(cfg),
        "norm_ffn": layers.norm_defs(cfg.d_model, cfg.norm),
        "ffn": ffn.ffn_defs(cfg),
    }


def encdec_defs(cfg: ModelConfig) -> dict:
    transformer._check_supported(cfg)
    return {
        "embed": layers.embed_defs(cfg.padded_vocab, cfg.d_model),
        "pos_enc": layers.pos_embed_defs(cfg.max_position, cfg.d_model),
        "pos_dec": layers.pos_embed_defs(cfg.max_position, cfg.d_model),
        "enc_blocks": stack_defs(_enc_block_defs(cfg), cfg.encoder_layers),
        "enc_norm": layers.norm_defs(cfg.d_model, cfg.norm),
        "dec_blocks": stack_defs(_dec_block_defs(cfg), cfg.num_layers),
        "dec_norm": layers.norm_defs(cfg.d_model, cfg.norm),
    }


class EncDecLM(nn.Module):
    """The encoder-decoder as modules: ``embed``, ``pos_enc``,
    ``pos_dec``, ``enc_norm``, ``dec_norm`` and one ``ParamTree`` per
    layer in ``enc_blocks`` and ``dec_blocks``.

    params: the JAX-layout tree of tensors (``init_tree`` or
    ``from_numpy_tree``); it is moved to ``device`` (CUDA by default)."""

    def __init__(self, cfg: ModelConfig, params: dict, device="cuda"):
        super().__init__()
        dev = transformer.resolve_device(device)
        defs = encdec_defs(cfg)
        self.cfg = cfg
        params = transformer._to(params, dev)
        for key in ("embed", "pos_enc", "pos_dec", "enc_norm", "dec_norm"):
            setattr(self, key, ParamTree(params[key], defs[key]))
        self.enc_blocks = nn.ModuleList(
            ParamTree(t, _enc_block_defs(cfg)) for t in
            transformer.unit_views(params["enc_blocks"], cfg.encoder_layers))
        self.dec_blocks = nn.ModuleList(
            ParamTree(t, _dec_block_defs(cfg)) for t in
            transformer.unit_views(params["dec_blocks"], cfg.num_layers))

    @classmethod
    def init(cls, cfg: ModelConfig, seed: int = 0,
             device="cuda") -> "EncDecLM":
        """Random weights drawn from a seed on ``device``."""
        dev = transformer.resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_tree(encdec_defs(cfg), gen), device=dev)

    def __getitem__(self, k: str):
        return getattr(self, k)

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device


class ShardedEncDec:
    """This rank's part of an :class:`EncDecLM` for serving under a model
    axis ``ax``: ``shard`` (``transformer.ServeShard``), ``cfg`` the
    local config, every leaf as the storage rule places it
    (``encdec_storage_specs``: heads, columns and the vocabulary over
    ``ax``; positions and norms whole), built from a whole ``model`` (each
    leaf sliced, then moved to ``device``) or, with ``local``, from the
    local param tree a rank holds."""

    def __init__(self, model, cfg: ModelConfig, ax: Optional[C.Axis],
                 zero: Optional[C.Axis] = None, device=None, *,
                 local: bool = False):
        self.shard = transformer.serve_shard(cfg, ax, zero)
        self.cfg = self.shard.cfg
        sh = self.shard
        specs = encdec_storage_specs(cfg, sh.sizes)
        keys = ("embed", "pos_enc", "pos_dec", "enc_norm", "dec_norm")
        if local:
            for key in keys:
                setattr(self, key, model[key])
            self.enc_blocks = transformer.unit_views(model["enc_blocks"],
                                                     cfg.encoder_layers)
            self.dec_blocks = transformer.unit_views(model["dec_blocks"],
                                                     cfg.num_layers)
            return
        for key in keys:
            setattr(self, key, transformer.local_params(
                getattr(model, key), specs[key], sh.sizes, sh.coords,
                device))
        for key in ("enc_blocks", "dec_blocks"):
            one = transformer.unstack_specs(specs[key])
            setattr(self, key, [transformer.local_params(
                p, one, sh.sizes, sh.coords, device)
                for p in getattr(model, key)])

    @classmethod
    def from_local(cls, params: dict, cfg: ModelConfig,
                   ax: Optional[C.Axis], zero: Optional[C.Axis] = None
                   ) -> "ShardedEncDec":
        return cls(params, cfg, ax, zero, local=True)

    def __getitem__(self, k: str):
        return getattr(self, k)

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device


def encdec_storage_specs(cfg: ModelConfig, sizes) -> dict:
    """The placements the encoder-decoder's params (``encdec_defs``) are
    stored under on a mesh of axis extents ``sizes``: each attention's
    heads and each FFN's columns over the model axis where their
    ``tp_plan`` splits, the vocabulary over it where it divides, every
    other leaf whole."""
    n = sizes.get("model", 1)
    defs = encdec_defs(cfg)
    out = transformer.whole_specs(defs)
    attn = (attention.tp_specs(cfg, n) if n > 1
            and attention.tp_plan(cfg, n) is not None else None)
    mlp = ffn.tp_specs(cfg, n) if n > 1 and ffn.tp_plan(cfg, n) else None
    for key in ("enc_blocks", "dec_blocks"):
        blocks = out[key]
        for k in blocks:
            if attn is not None and k in ("attn", "self_attn",
                                          "cross_attn"):
                blocks[k] = transformer.stack_specs(attn)
            elif mlp is not None and k == "ffn":
                blocks[k] = transformer.stack_specs(mlp)
    out.update(transformer.vocab_specs(defs, sizes))
    return transformer.filled_specs(defs, out)


def _sums(params):
    """The model axes over which a sharded model's attention and FFN
    outputs are summed (None, None without a serving shard)."""
    shard = getattr(params, "shard", None)
    if shard is None:
        return None, None
    return shard.mixer_ax("attn"), shard.ffn_ax


def _layers(params, key: str, n: int) -> list:
    """Per-layer trees of ``params[key]``: an EncDecLM's modules (or a
    ShardedEncDec's dicts), or views of a stacked param tree's leaves
    (gradients reach the stacked leaves)."""
    if isinstance(params, (EncDecLM, ShardedEncDec)):
        return list(getattr(params, key))
    return transformer.unit_views(params[key], n)


def _remat(fn, remat: bool, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


# ------------------------------------------------------------- encoder
def encode(params, cfg: ModelConfig, audio_embeds: torch.Tensor,
           remat: bool = True, tp: Optional[C.Axis] = None
           ) -> torch.Tensor:
    """audio_embeds: (B, F, d) stub frame embeddings -> (B, F, d): the
    bidirectional stack (each layer checkpointed in training).  tp: the
    sequence-parallel layout (the output is this rank's F/n chunk)."""
    f = audio_embeds.shape[1]
    pos = torch.arange(f, device=audio_embeds.device).clamp(
        max=cfg.max_position - 1)
    x = (audio_embeds.to(cfg.dtype)
         + params["pos_enc"]["pos_embedding"][pos])
    x = C.split_seq(x, tp)
    sa_ax, sf_ax = _sums(params)

    def body(h, p):
        hh = layers.apply_norm(p["norm_attn"], h, cfg.norm)
        y, _, _ = attention.attn_apply(p["attn"], hh, cfg, mode="train",
                                       causal=False, rope=False, tp=tp)
        h = h + C.model_sum(y, sa_ax)
        hh = layers.apply_norm(p["norm_ffn"], h, cfg.norm)
        y, _ = ffn.ffn_apply(p["ffn"], hh, cfg, mode="train", tp=tp)
        return h + C.model_sum(y, sf_ax)

    for p in _layers(params, "enc_blocks", cfg.encoder_layers):
        x = _remat(body, remat, x, p)
    return layers.apply_norm(params["enc_norm"], x, cfg.norm)


# ------------------------------------------------------------- decoder
def _build_cross_cache(p, cfg: ModelConfig, enc_out: torch.Tensor) -> dict:
    lc = cfg.spt.lora
    hd = cfg.resolved_head_dim
    k = attention._project(p["wk"], enc_out, lc, cfg.num_kv_heads, hd)
    v = attention._project(p["wv"], enc_out, lc, cfg.num_kv_heads, hd)
    out = {"k": k.to(cfg.dtype), "v": v.to(cfg.dtype)}
    if attention.sparse_applicable(cfg):
        out["codes"] = pq.assign(k, p["pq"]["codebooks"]).to(torch.int8)
    return out


def _cross_parts(cfg: ModelConfig, sh, frames: int) -> int:
    """The parts the cross cache's frames split into over a serving
    rank's model axis (``sh``: its ``attention.AttnShard``): JAX's rule
    (``attention.seq_parts``) for the config's frame count, the frames
    its cache layout is made for; other counts stay whole."""
    if sh is None or frames != cfg.frontend_tokens:
        return 1
    return sh.parts(frames)


def _cross_decode(p, x: torch.Tensor, cfg: ModelConfig,
                  cross: dict, sh=None) -> torch.Tensor:
    """One query row per sequence over the cached encoder frames (all
    valid), through the plain decode oracles, as in JAX (under a serving
    shard: this rank's heads, a partial sum; over frames split over the
    model axis, ``attention.decode_seq_split`` on this rank's, every
    rank computing every head)."""
    lc = cfg.spt.lora
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    q = attention._project(p["wq"], x, lc, cfg.num_heads, hd)
    scale = hd ** -0.5
    f = cross["k"].shape[2]
    n = 1 if sh is None else sh.ax.size
    if n > 1 and _cross_parts(cfg, sh, f * n) == n:
        valid = torch.ones((b, f * n), dtype=torch.bool, device=x.device)
        out, _ = attention.decode_seq_split(p, cfg, q, cross, valid, sh.ax,
                                            scatter=False, kernel=False)
        out = out.transpose(1, 2).reshape(b, s, cfg.num_heads * hd)
        return lora.linear(out, p["wo"], lc)
    valid = torch.ones((b, f), dtype=torch.bool, device=x.device)
    if attention.sparse_applicable(cfg):
        out = sa.sparse_mha_decode(q, cross["k"], cross["v"], cross["codes"],
                                   p["pq"]["codebooks"],
                                   attention._sa_config(cfg), scale, valid)
    else:
        out = sa.dense_attention(q, cross["k"], cross["v"], scale,
                                 causal=False, kv_valid=valid, chunk_q=1)
    out = out.transpose(1, 2).reshape(b, s, cfg.num_heads * hd)
    return lora.linear(out, p["wo"], lc)


def _dec_block(p, x: torch.Tensor, cfg: ModelConfig, enc_out, *, mode: str,
               cache=None, pos=None, seq_lengths=None, tp=None,
               sums=(None, None), sh=None):
    """Returns (x, aux): the FFN's aux.  With a cache (prefill, decode)
    its ``self`` view is written in place, and prefill fills its
    ``cross`` view (this rank's frames of a split one).  tp: the
    sequence-parallel layout (train; enc_out is then whole); sums: a
    serving shard's axes (``_sums``); sh: its attention split
    (``attention.AttnShard``)."""
    sa_ax, sf_ax = sums
    h = layers.apply_norm(p["norm_self"], x, cfg.norm)
    y, _, _ = attention.attn_apply(
        p["self_attn"], h, cfg, mode=mode, causal=True,
        cache=None if cache is None else cache["self"], pos=pos, rope=False,
        seq_lengths=seq_lengths, tp=tp, serve=sh)
    x = x + C.model_sum(y, sa_ax)
    h = layers.apply_norm(p["norm_cross"], x, cfg.norm)
    if mode == "decode":
        y = _cross_decode(p["cross_attn"], h, cfg, cache["cross"], sh)
    else:
        # the cross keys are the encoder frames (all real); a ragged
        # right-padded batch pads only queries, whose outputs are dropped
        y, _, _ = attention.attn_apply(p["cross_attn"], h, cfg, mode="train",
                                       causal=False, kv_x=enc_out, rope=False,
                                       tp=tp)
        if mode == "prefill":
            f = cache["cross"]["k"].shape[2]        # this rank's frames
            lo = 0 if sh is None or f == enc_out.shape[1] else sh.ax.rank * f
            for k, v in _build_cross_cache(p["cross_attn"], cfg,
                                           enc_out).items():
                cache["cross"][k].copy_(v[:, :, lo:lo + f])
    x = x + C.model_sum(y, sa_ax)
    h = layers.apply_norm(p["norm_ffn"], x, cfg.norm)
    y, aux = ffn.ffn_apply(p["ffn"], h, cfg, mode=mode,
                           seq_lengths=seq_lengths, tp=tp)
    return x + C.model_sum(y, sf_ax), aux


def _decode_stack(params, cfg: ModelConfig, x: torch.Tensor, enc_out, *,
                  mode: str, caches=None, pos=None, remat: bool = True,
                  seq_lengths=None, tp=None):
    """The decoder layers over x; in train mode each layer runs under a
    checkpoint (with ``remat``) and aux sums AUX_KEYS over the layers.
    tp: the sequence-parallel layout (x this rank's chunk, enc_out
    whole)."""
    train = mode == "train"
    sums = _sums(params)
    sh = getattr(getattr(params, "shard", None), "attn_sh", None)
    aux_total = ({k: torch.zeros((), dtype=torch.float32, device=x.device)
                  for k in transformer.AUX_KEYS} if train else {})

    def body(h, p, layer):
        c = None
        if caches is not None:
            c = {part: {k: v[layer] for k, v in caches[part].items()}
                 for part in ("self", "cross")}
        return _dec_block(p, h, cfg, enc_out, mode=mode, cache=c, pos=pos,
                          seq_lengths=seq_lengths, tp=tp, sums=sums, sh=sh)

    for i, p in enumerate(_layers(params, "dec_blocks", cfg.num_layers)):
        x, aux = _remat(body, remat and train, x, p, i)
        if train:
            for k in transformer.AUX_KEYS:
                if k in aux:
                    aux_total[k] = aux_total[k] + aux[k]
    return x, aux_total


def _embed_dec(params, cfg: ModelConfig, tokens: torch.Tensor,
               pos0, tp: Optional[C.Axis] = None) -> torch.Tensor:
    """Token embeddings plus the decoder's learned positions pos0 + [0, s)
    (a scalar pos0, or (B,) per row), clamped as JAX's take(mode="clip").
    A vocabulary-split table's lookups are summed over the model axis:
    under the sequence-parallel layout ``tp`` by the reduce-scatter that
    leaves this rank's chunk of the rows (the whole lookup is split
    there), under a serving shard by an all-reduce."""
    ax = tp if tp is not None else getattr(
        getattr(params, "shard", None), "ax", None)
    x, whole = transformer.vocab_rows(params, cfg, tokens, ax)
    ar = torch.arange(tokens.shape[1], dtype=torch.long, device=x.device)
    if tp is not None:
        x = C.split_seq(x, tp) if whole else C.scatter_seq(x, tp)
        ar = ar[tp.rank * x.shape[1]:(tp.rank + 1) * x.shape[1]]
    elif not whole:
        x = C.model_sum(x, ax)
    p0 = torch.as_tensor(pos0, dtype=torch.long, device=x.device)
    pos = p0[:, None] + ar if p0.dim() else p0 + ar
    return x + params["pos_dec"]["pos_embedding"][
        pos.clamp(0, cfg.max_position - 1)]


# ------------------------------------------------------------- public API
def encdec_hidden(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  remat: bool = True
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train forward.  batch: {frontend_embeds (B, F, d), tokens (B, S)}.
    Returns the decoder's final hidden states (B, S, d) and the summed
    aux (the FFNs' lb_loss and dropped; qerr stays 0, as the attention
    aux is not collected in JAX either).  Under the sequence-parallel
    layout (``transformer.seq_parallel``) the hidden states are this
    rank's chunk of the decoder positions."""
    tp = transformer.seq_parallel(cfg, batch)
    enc_out = encode(params, cfg, batch["frontend_embeds"], remat=remat,
                     tp=tp)
    x = _embed_dec(params, cfg, batch["tokens"], 0, tp)
    x, aux = _decode_stack(params, cfg, x, C.gather_seq(enc_out, tp),
                           mode="train", remat=remat, tp=tp)
    return layers.apply_norm(params["dec_norm"], x, cfg.norm), aux


def init_dec_caches(cfg: ModelConfig, batch: int, max_len: int,
                    enc_len: int, device, shard=None) -> dict:
    """{"self": the decoder's attention caches, "cross": k, v (and codes
    with sparse MHA) over ``enc_len`` frames}, each stacked on the
    num_layers decoder layers.  shard: a serving rank's
    (``transformer.ServeShard``; cfg its local config): its kv heads, or
    its part of a sequence split over the model axis
    (``transformer.block_cache``; the cross cache's frames by
    ``_cross_parts``)."""
    n = cfg.num_layers
    hd = cfg.resolved_head_dim
    one = transformer.block_cache(cfg, "attn", batch, max_len, device, shard)
    self_c = {k: v[None].repeat(n, *(1,) * v.dim())
              for k, v in one.items()}
    sh = None if shard is None else shard.attn_sh
    if sh is not None and sh.kv_head is not None:
        raise NotImplementedError("query heads split inside a kv head: no "
                                  "encoder-decoder config has them")
    hk = cfg.num_kv_heads if sh is None else sh.cache_heads(cfg)
    f = enc_len // _cross_parts(cfg, sh, enc_len)
    cross = {"k": torch.zeros((n, batch, hk, f, hd), dtype=cfg.dtype,
                              device=device),
             "v": torch.zeros((n, batch, hk, f, hd), dtype=cfg.dtype,
                              device=device)}
    if attention.sparse_applicable(cfg):
        m = attention._pq_config(cfg).num_books
        cross["codes"] = torch.zeros((n, batch, hk, f, m),
                                     dtype=torch.int8, device=device)
    return {"self": self_c, "cross": cross}


def cache_axes(cfg: ModelConfig) -> dict:
    """Logical partition axes mirroring ``init_dec_caches``' tree."""
    kv = ("layer", "batch", "kv_heads", "seq_shard", None)
    self_ax = {"k": kv, "v": kv, "slot_pos": ("layer", "batch", None)}
    cross = {"k": kv, "v": kv}
    if attention.sparse_applicable(cfg):
        self_ax["codes"] = kv
        cross["codes"] = kv
    return {"self": self_ax, "cross": cross}


@torch.no_grad()
def encdec_prefill(model, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   max_len: int):
    """Encode the frames and prefill the (B, S) decoder prompts.  Returns
    (caches, logits (B, 1, V) at the last position)."""
    fe = batch["frontend_embeds"]
    tokens = batch["tokens"]
    enc_out = encode(model, cfg, fe, remat=False)
    caches = init_dec_caches(cfg, tokens.shape[0], max_len, fe.shape[1],
                             tokens.device, getattr(model, "shard", None))
    x = _embed_dec(model, cfg, tokens, 0)
    x, _ = _decode_stack(model, cfg, x, enc_out, mode="prefill",
                         caches=caches, pos=0, remat=False)
    x = layers.apply_norm(model["dec_norm"], x[:, -1:], cfg.norm)
    return caches, transformer.logits_of(model, cfg, x)


@torch.no_grad()
def encdec_prefill_ragged(model, cfg: ModelConfig,
                          batch: Dict[str, torch.Tensor],
                          lengths: torch.Tensor, max_len: int):
    """Batched ragged prefill: (B, S) right-padded decoder prompts of
    per-row ``lengths`` (decoder tokens only; the encoder frames are a
    separate, dense axis).  Each row equals an exact-length batch-1
    ``encdec_prefill``: the causal self-attention mask hides pad keys,
    sparse self-attention gets per-row top-L budgets and the routed FFN
    per-row capacities, and cross-attention pads only queries.  Returns
    (caches, logits at each row's last real position); self-cache slots
    past a row's length are marked empty."""
    fe = batch["frontend_embeds"]
    tokens = batch["tokens"]
    bsz = tokens.shape[0]
    enc_out = encode(model, cfg, fe, remat=False)
    caches = init_dec_caches(cfg, bsz, max_len, fe.shape[1], tokens.device,
                             getattr(model, "shard", None))
    x = _embed_dec(model, cfg, tokens, 0)
    sl = lengths if transformer.length_sensitive(cfg) else None
    x, _ = _decode_stack(model, cfg, x, enc_out, mode="prefill",
                         caches=caches, pos=0, remat=False, seq_lengths=sl)
    idx = torch.clamp(lengths.long() - 1, 0, x.shape[1] - 1)
    x_last = x.gather(1, idx[:, None, None].expand(bsz, 1, x.shape[-1]))
    x_last = layers.apply_norm(model["dec_norm"], x_last, cfg.norm)
    sp = caches["self"]["slot_pos"]                       # (n, B, size)
    sp.masked_fill_(sp >= lengths.reshape(1, -1, 1), -1)
    return caches, transformer.logits_of(model, cfg, x_last)


@torch.no_grad()
def encdec_decode_step(model, cfg: ModelConfig, caches: dict,
                       token: torch.Tensor, pos) -> torch.Tensor:
    """One decoder token for every row at position ``pos`` (a scalar, as
    the per-token generate loop gives it).  Writes the self caches in
    place; returns logits (B, 1, V)."""
    x = _embed_dec(model, cfg, token[:, None], pos)
    x, _ = _decode_stack(model, cfg, x, None, mode="decode", caches=caches,
                         pos=pos, remat=False)
    x = layers.apply_norm(model["dec_norm"], x, cfg.norm)
    return transformer.logits_of(model, cfg, x)
