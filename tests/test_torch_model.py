"""Parity of the PyTorch port's core and model code with the JAX package.

The same inputs, made with numpy from a seed, go through both packages in
f32: PQ codes (equal except across a distance near-tie), bucket_select
index sets and dispatch plans (equal), the attention and FFN layers, and
the 2-layer qwen3 smoke LM's ragged-prefill and decode logits (1e-4).
Where JAX reaches a Pallas kernel it runs in interpret mode, as the JAX
suite runs it on the CPU; the port's wrappers take their plain versions
on CPU tensors.  Helpers here are shared by the other test_torch_* files.
"""
import dataclasses
import functools
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import dispatch as jdispatch
from repro.core import pq as jpq
from repro.core import sparse_attention as jsa
from repro.core import params as jparams
from repro.models import attention as jattention
from repro.models import ffn as jffn
from repro.models import transformer as jtransformer
from repro.train import state as JS
from repro.train.state import model_defs
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs.base import ModelConfig, SPTConfig
from repro_torch.core import dispatch, pq
from repro_torch.core import sparse_attention as sa
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.params import ParamTree, from_numpy_tree
from repro_torch.models import attention, ffn, transformer

TOL = 1e-5          # f32 op/layer parity (different summation orders)
LOGIT_TOL = 1e-4    # f32 logits after two full layers


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Inference only, on one torch thread: the suite runs in several
    worker processes, and torch's own thread pool on top of them
    oversubscribes the CPU ~30x at these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def keep_sigterm():
    """Put back, when a module's tests are done, the SIGTERM handler that
    a Trainer (either package's) installs, module-scoped fixtures' ones
    included; the files that build trainers import this autouse
    fixture."""
    handler = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, handler)


# ------------------------------------------------------------ helpers
def port_cfg(jcfg) -> ModelConfig:
    """The port's ModelConfig with every field of a JAX ModelConfig."""
    sf = {f.name: getattr(jcfg.spt, f.name)
          for f in dataclasses.fields(jcfg.spt)}
    sf["lora"] = LoRAConfig(**dataclasses.asdict(jcfg.spt.lora))
    mf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    mf["spt"] = SPTConfig(**sf)
    mf["dtype"] = getattr(torch, jnp.dtype(jcfg.dtype).name)
    return ModelConfig(**mf)


def smoke_cfg(**spt):
    """The 2-layer qwen3 smoke shape (d_model 64) in f32."""
    base = dataclasses.replace(
        jconfigs.get_smoke("qwen3-0.6b"), num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=256, dtype=jnp.float32)
    return base.with_spt(**spt) if spt else base


def perturb_lora(tree, rng):
    """LoRA c leaves start at zero; give every one nonzero values so the
    LoRA halves of the kernels are exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb_lora(v, rng)
        elif k == "c":
            out[k] = (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


def np_init_tree(defs, seed):
    """A JAX def tree materialized with numpy: each leaf drawn by its def's
    init (zeros, ones, normal:<std>, uniform:<s>, fan_in) from one
    generator seeded ``seed``, in sorted-path order, in the def's dtype.
    The distributions of JAX's ``init_tree`` without its per-shape
    compiles of eager random ops (other draws; both packages get this
    same tree)."""
    rng = np.random.default_rng(seed)

    def leaf(d):
        kind, _, arg = d.init.partition(":")
        if kind in ("zeros", "ones"):
            x = (np.zeros if kind == "zeros" else np.ones)(d.shape,
                                                           np.float32)
        elif kind == "uniform":
            s = float(arg or 1.0)
            x = rng.uniform(-s, s, d.shape).astype(np.float32)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            std = (float(arg or 0.02) if kind == "normal"
                   else 1.0 / np.sqrt(max(1, fan_in)))
            x = (std * rng.standard_normal(d.shape)).astype(np.float32)
        return x.astype(jnp.dtype(d.dtype))

    def build(t):
        if isinstance(t, jparams.ParamDef):
            return leaf(t)
        return {k: build(t[k]) for k in sorted(t)}
    return build(defs)


def np_train_state(jcfg, seed=0):
    """A JAX train state in ``init_state``'s layout as numpy: the params
    of ``np_init_tree`` in f32 (frozen leaves too, as the f32 configs
    compute), JAX's partition with its None holes, zero f32 AdamW moments
    and an int32 step 0."""
    defs = model_defs(jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  np_init_tree(defs, seed))
    train, frozen = jparams.partition(tree, jparams.trainable_mask(defs))
    zeros = lambda a: np.zeros(a.shape, np.float32)       # noqa: E731
    return {"step": np.zeros((), np.int32), "train": train, "frozen": frozen,
            "opt": {"m": jax.tree_util.tree_map(zeros, train),
                    "v": jax.tree_util.tree_map(zeros, train)}}


def jax_trainer(jcfg, ocfg, tcfg, state):
    """JAX's Trainer started from ``state`` (numpy, JAX's layout).  Its
    own ``init_state``, whose result the state replaces, is skipped."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "init_state", lambda cfg, key: None)
        trainer = JTrainer(jcfg, ocfg, tcfg)
    trainer.state = jax.tree_util.tree_map(jnp.asarray, state)
    return trainer


@functools.lru_cache(maxsize=None)
def jax_params(jcfg, seed=0):
    """f32 numpy param tree of a JAX config (``np_init_tree`` of its
    defs), LoRA c perturbed (cached per config: callers only read it)."""
    tree = np_init_tree(model_defs(jcfg), seed)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    return perturb_lora(tree, np.random.default_rng(seed + 100))


def port_model(jcfg, tree) -> transformer.LM:
    return transformer.LM(port_cfg(jcfg), from_numpy_tree(tree, "cpu"),
                          device="cpu")


def t(a, dtype=None):
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------ core
def test_pq_assign_matches_up_to_distance_near_ties():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
    cb = rng.standard_normal((2, 16, 8)).astype(np.float32)
    want = np.asarray(jpq.assign(jnp.asarray(x), jnp.asarray(cb)))
    got = pq.assign(t(x), t(cb)).numpy()
    xs = x.reshape(2, 3, 40, 2, 8)
    dist = (cb * cb).sum(-1) - 2.0 * np.einsum("...md,med->...me", xs, cb)
    srt = np.sort(dist, axis=-1)
    tie = (srt[..., 1] - srt[..., 0]) < 1e-5
    assert got.dtype == np.int32
    assert np.array_equal(got[~tie], want[~tie])


@pytest.mark.parametrize("max_score,use_dyn", [(8, False), (16, True)])
def test_bucket_select_index_sets_match(max_score, use_dyn):
    rng = np.random.default_rng(max_score)
    scores = rng.integers(0, max_score + 1, (3, 2, 5, 40)).astype(np.float32)
    valid = rng.random((3, 1, 5, 40)) < 0.8
    valid[0, 0, 1] = False                                # an empty row
    l = 10
    l_dyn = np.array([10, 4, 7], np.int32).reshape(3, 1, 1) if use_dyn \
        else None
    wi, wv = jsa.bucket_select(jnp.asarray(scores), jnp.asarray(valid), l,
                               max_score, None if l_dyn is None
                               else jnp.asarray(l_dyn))
    gi, gv = sa.bucket_select(t(scores), t(valid), l, max_score,
                              None if l_dyn is None else t(l_dyn))
    wv, wi = np.asarray(wv), np.asarray(wi)
    assert np.array_equal(gv.numpy(), wv)
    assert np.array_equal(np.where(wv, gi.numpy(), -1), np.where(wv, wi, -1))


@pytest.mark.parametrize("cap_dyn", [None, [6, 16]])
def test_make_plan_matches(cap_dyn):
    rng = np.random.default_rng(1)
    choice = np.stack([rng.permutation(4)[:2] for _ in range(2 * 12)])
    choice = choice.reshape(2, 12, 2).astype(np.int32)
    gate = rng.random((2, 12, 2)).astype(np.float32)
    cap = jdispatch.capacity(12, 4, 2, 1.0)
    cd = None if cap_dyn is None else np.asarray(cap_dyn, np.int32)
    want = jdispatch.make_plan(jnp.asarray(choice), jnp.asarray(gate), 4,
                               cap, None if cd is None else jnp.asarray(cd))
    got = dispatch.make_plan(t(choice), t(gate), 4, cap,
                             None if cd is None else t(cd))
    assert np.array_equal(got.index.numpy(), np.asarray(want.index))
    assert np.array_equal(got.slot_ok.numpy(), np.asarray(want.slot_ok))
    assert np.array_equal(got.combine_w.numpy(), np.asarray(want.combine_w))
    assert float(got.dropped) == pytest.approx(float(want.dropped), abs=1e-7)
    lens = np.array([5, 12], np.int32)
    assert np.array_equal(
        dispatch.capacity_dyn(t(lens), 8, 4, 1.25).numpy(),
        np.asarray(jdispatch.capacity_dyn(jnp.asarray(lens), 8, 4, 1.25)))


# ------------------------------------------------------------ layers
def _layer(tree, key):
    return jax.tree_util.tree_map(lambda a: a[0], tree["units"]["b0_attn"][key])


def _layer_setup(**spt):
    jcfg = smoke_cfg(attn_impl="pallas", ffn_impl="pallas", **spt)
    tree = jax_params(jcfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 16, 64)).astype(np.float32)
    lens = np.array([16, 9, 12], np.int32)
    return jcfg, port_cfg(jcfg), tree, x, lens


@pytest.mark.parametrize("gran", ["qhead", "kvgroup"])
def test_attention_layer_prefill_and_decode_match(gran):
    jcfg, pcfg, tree, x, lens = _layer_setup(select_granularity=gran)
    jp = _layer(tree, "mixer")
    tp = ParamTree(from_numpy_tree(jp, "cpu"), attention.attn_defs(pcfg))
    prefill = jax.jit(lambda p, x, c, sl: jattention.attn_apply(
        p, x, jcfg, mode="prefill", cache=c, pos=0, seq_lengths=sl))
    decode = jax.jit(lambda p, x, c, pos, v: jattention.attn_apply(
        p, x, jcfg, mode="decode", cache=c, pos=pos, kv_valid=v))
    jy, jc, _ = prefill(jp, jnp.asarray(x), jattention.init_cache(jcfg, 3, 32),
                        jnp.asarray(lens))
    tc = attention.init_cache(pcfg, 3, 32, "cpu")
    ty, tc, _ = attention.attn_apply(tp, t(x), pcfg, mode="prefill",
                                     cache=tc, pos=0, seq_lengths=t(lens))
    close(ty, jy)
    close(tc["k"], jc["k"])
    # decode one token per row against the SAME cache (JAX's codes)
    tc = {k: t(v) for k, v in jc.items()}
    pos = lens
    valid = np.arange(32)[None, :] <= pos[:, None]
    xd = np.random.default_rng(8).standard_normal((3, 1, 64)).astype(
        np.float32)
    jy, jc2, _ = decode(jp, jnp.asarray(xd), jc, jnp.asarray(pos),
                        jnp.asarray(valid))
    ty, tc, _ = attention.attn_apply(tp, t(xd), pcfg, mode="decode",
                                     cache=tc, pos=t(pos), kv_valid=t(valid))
    close(ty, jy)
    assert np.array_equal(tc["slot_pos"].numpy(), np.asarray(jc2["slot_pos"]))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_ffn_layer_matches(mode):
    jcfg, pcfg, tree, x, lens = _layer_setup()
    jp = _layer(tree, "ffn")
    tp = ParamTree(from_numpy_tree(jp, "cpu"), ffn.ffn_defs(pcfg))
    if mode == "decode":
        x, sl = x[:, :1], None
    else:
        sl = lens
    jy, _ = jax.jit(lambda p, x, sl: jffn.ffn_apply(
        p, x, jcfg, mode=mode, seq_lengths=sl))(
            jp, jnp.asarray(x), None if sl is None else jnp.asarray(sl))
    ty, _ = ffn.ffn_apply(tp, t(x), pcfg, mode=mode,
                          seq_lengths=None if sl is None else t(sl))
    close(ty, jy)


# ------------------------------------------------------------ model
def _prefill_batch():
    rng = np.random.default_rng(11)
    lens = np.array([5, 16, 11], np.int32)
    toks = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, 256, n)
    return toks, lens


@pytest.mark.parametrize("spt", [
    dict(attn_impl="pallas", ffn_impl="pallas"),       # kernel paths
    dict(attn_impl="sparse_jnp", ffn_impl="grouped"),  # core/ oracle paths
])
def test_lm_prefill_ragged_and_decode_logits_match(spt):
    jcfg = smoke_cfg(**spt)
    tree = jax_params(jcfg)
    model = port_model(jcfg, tree)
    pcfg = model.cfg
    toks, lens = _prefill_batch()
    jc, jl = jax.jit(lambda p, b, n: jtransformer.lm_prefill_ragged(
        p, jcfg, b, n, 32))(tree, {"tokens": jnp.asarray(toks)},
                            jnp.asarray(lens))
    tc, tl = transformer.lm_prefill_ragged(
        model, pcfg, {"tokens": t(toks, torch.long)}, t(lens), 32)
    close(tl, jl, LOGIT_TOL)
    jblk, tblk = jc["units"]["b0_attn"], tc["units"]["b0_attn"]
    assert np.array_equal(tblk["slot_pos"].numpy(),
                          np.asarray(jblk["slot_pos"]))
    close(tblk["v"], jblk["v"])
    # one decode step from the SAME caches (JAX's PQ codes)
    tc = {"units": {"b0_attn": {k: t(v) for k, v in jblk.items()}}}
    tok = np.asarray(jl[:, -1].argmax(-1), np.int32)
    valid = np.arange(32)[None, :] <= lens[:, None]
    _, jd = jax.jit(lambda p, c, tk, ps, v: jtransformer.lm_decode_step(
        p, jcfg, c, tk, ps, kv_valid=v))(tree, jc, jnp.asarray(tok),
                                         jnp.asarray(lens), jnp.asarray(valid))
    td = transformer.lm_decode_step(model, pcfg, tc, t(tok, torch.long),
                                    t(lens), kv_valid=t(valid))
    close(td, jd, LOGIT_TOL)
