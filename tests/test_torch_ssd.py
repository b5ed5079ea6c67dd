"""The port's SSD family (mamba2-780m: attention-free, FFN-free Mamba-2
blocks) against the JAX package, in f32 on the CPU, with params from
JAX's defs (``np_init_tree``) through numpy:

  * the SSD pieces (models/ssd.py): the chunked ``ssd_scan`` with and
    without h0 and at a length that is not a multiple of the chunk (one
    chunk of S then) to rtol 1e-5 and atol 1e-6 x max |JAX| (the chunk
    sums run in another order), ``ssd_step`` chained S times equal to
    the scan, and ``ssd_apply`` in the train, prefill and decode modes
    with its caches;
  * the 2-layer smoke LM: ``lm_hidden``'s logits, ``lm_prefill`` then
    ``lm_decode_step`` with the caches, and the train step's loss and
    gradients (the AdamW first moment) against ``jax.grad``;
  * the serving engine: JAX's exact-length prefill test mirrored (one
    slot, slot recycling, streams equal to the per-token loop), and the
    engine's streams and stats against JAX's Engine;
  * SPT reduces to LoRA: no block has attention or an FFN, and no
    sparse-MHA budget or routed capacity makes the stack length
    sensitive.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import ssd as jssd
from repro.models import transformer as jtransformer
from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.core.params import (from_numpy_state, from_numpy_tree,
                                     leaves)
from repro_torch.data import pipeline
from repro_torch.models import ssd, transformer
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.serving.engine import Engine, Request
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_model import (close, jax_params, np_init_tree,
                              perturb_lora, port_cfg, port_model, t)
from test_torch_model import (jax_trainer, keep_sigterm,  # noqa: F401
                              np_train_state)

ARCH = "mamba2-780m"
RTOL, ATOL = 1e-5, 1e-6
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(**kw):
    return dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.float32,
                               **kw)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _allclose(got, want, rtol=RTOL, atol=ATOL):
    """rtol, with atol taken relative to the largest |want| (entries
    near zero are sums that cancel)."""
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), w, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(w).max())))


def _scan_inputs(rng, b=2, s=40, h=4, p=16, n=16):
    x = _normal(rng, b, s, h, p)
    dt = np.abs(_normal(rng, b, s, h, scale=0.5)).astype(np.float32)
    a = -np.exp(_normal(rng, h, scale=0.3)).astype(np.float32)
    bm, cm = _normal(rng, b, s, n), _normal(rng, b, s, n)
    return x, dt, a, bm, cm


# ------------------------------------------------------------ SSD parts
@pytest.mark.parametrize("s,with_h0", [(48, False), (48, True), (40, False),
                                       (40, True)],
                         ids=["chunks", "chunks-h0", "one-chunk",
                              "one-chunk-h0"])
def test_ssd_scan_matches(s, with_h0):
    """Chunks of 16: S 48 runs three chunks through the inter-chunk loop,
    S 40 (not a multiple) one chunk of 40, as in JAX."""
    rng = np.random.default_rng(0)
    x, dt, a, bm, cm = _scan_inputs(rng, s=s)
    h0 = _normal(rng, 2, 4, 16, 16) if with_h0 else None
    jy, jh = jssd.ssd_scan(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)),
                           16, None if h0 is None else jnp.asarray(h0))
    ty, th = ssd.ssd_scan(*(t(v) for v in (x, dt, a, bm, cm)), 16,
                          None if h0 is None else t(h0))
    _allclose(ty, jy)
    _allclose(th, jh)


def test_ssd_step_chain_equals_scan():
    rng = np.random.default_rng(1)
    x, dt, a, bm, cm = (t(v) for v in _scan_inputs(rng, s=21))
    h = t(_normal(rng, 2, 4, 16, 16))
    want, want_h = ssd.ssd_scan(x, dt, a, bm, cm, 8, h)
    jy, _ = jssd.ssd_step(*(jnp.asarray(v.numpy()) for v in
                            (x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0], h)))
    ys = []
    for i in range(x.shape[1]):
        y, h = ssd.ssd_step(x[:, i], dt[:, i], a, bm[:, i], cm[:, i], h)
        if i == 0:
            _allclose(y, jy)
        ys.append(y)
    _allclose(torch.stack(ys, 1), want, rtol=1e-4, atol=1e-5)
    _allclose(h, want_h, rtol=1e-4, atol=1e-5)


def _ssd_params(jcfg, seed=0):
    """(JAX, port) params of one SSD mixer, f32, with nonzero decays and
    LoRA c perturbed."""
    tree = np_init_tree(jssd.ssd_defs(jcfg), seed)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    tree = perturb_lora(tree, np.random.default_rng(seed + 1))
    rng = np.random.default_rng(seed + 2)
    tree["a_log"] = _normal(rng, *tree["a_log"].shape, scale=0.5)
    tree["dt_bias"] = _normal(rng, *tree["dt_bias"].shape, scale=0.5)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_numpy_tree(tree, "cpu"))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_ssd_apply_matches(mode):
    jcfg = _jcfg()
    pcfg = port_cfg(jcfg)
    jp, tp = _ssd_params(jcfg, seed=3)
    rng = np.random.default_rng(4)
    s = 1 if mode == "decode" else 37
    x = _normal(rng, 2, s, jcfg.d_model)
    cache = None
    if mode != "train":
        shapes = {k: tuple(v.shape) for k, v in
                  ssd.init_ssm_cache(pcfg, 2, "cpu").items()}
        cache = {k: _normal(rng, *sh, scale=0.5) for k, sh in shapes.items()}
    jy, jc, _ = jssd.ssd_apply(
        jp, jnp.asarray(x), jcfg, mode=mode,
        cache=None if cache is None else
        {k: jnp.asarray(v) for k, v in cache.items()})
    tc = None if cache is None else {k: t(v) for k, v in cache.items()}
    with torch.no_grad():
        ty, tc, _ = ssd.ssd_apply(tp, t(x), pcfg, mode=mode, cache=tc)
    _allclose(ty, jy)
    if cache is not None:
        for k in ("h", "conv"):
            _allclose(tc[k], jc[k])


# ------------------------------------------------------------ the LM
def _model():
    jcfg = _jcfg()
    tree = jax_params(jcfg)
    return jcfg, tree, port_model(jcfg, tree)


def test_spt_reduces_to_lora():
    jcfg, tree, model = _model()
    pcfg = model.cfg
    assert transformer.block_defs(pcfg, "ssd").keys() == {"norm_mix",
                                                          "mixer"}
    assert set(tree["units"]["b0_ssd"]) == {"norm_mix", "mixer"}
    assert not transformer.length_sensitive(pcfg)
    assert not transformer.supports_ragged_prefill(pcfg)
    assert not transformer.paged_applicable(pcfg)
    trainable = [p for p, v in leaves(model.units[0]) if v.requires_grad]
    assert trainable and all("lora" in p for p in trainable)


def test_lm_hidden_prefill_and_decode_match():
    jcfg, tree, model = _model()
    pcfg = model.cfg
    toks = np.random.default_rng(6).integers(0, 256, (2, 40)).astype(
        np.int32)
    jh, _ = jax.jit(lambda p, b: jtransformer.lm_hidden(p, jcfg, b))(
        tree, {"tokens": jnp.asarray(toks)})
    params = from_numpy_tree(tree, "cpu")
    with torch.no_grad():
        th, _ = transformer.lm_hidden(params, pcfg,
                                      {"tokens": t(toks, torch.long)})
        tl = transformer.logits_of(model, pcfg, th)
    close(tl, jtransformer.logits_of(tree, jcfg, jh), LOGIT_TOL)
    jc, jl = jax.jit(lambda p, b: jtransformer.lm_prefill(p, jcfg, b, 48))(
        tree, {"tokens": jnp.asarray(toks)})
    tc, tl = transformer.lm_prefill(model, pcfg,
                                    {"tokens": t(toks, torch.long)}, 48)
    close(tl, jl, LOGIT_TOL)
    for k in ("h", "conv"):
        close(tc["units"]["b0_ssd"][k], jc["units"]["b0_ssd"][k], LOGIT_TOL)
    tok = np.asarray(jl[:, -1].argmax(-1), np.int32)
    pos = np.full(2, 40, np.int32)
    jc2, jd = jax.jit(lambda p, c, k, q: jtransformer.lm_decode_step(
        p, jcfg, c, k, q))(tree, jc, jnp.asarray(tok), jnp.asarray(pos))
    td = transformer.lm_decode_step(model, pcfg, tc, t(tok, torch.long),
                                    t(pos))
    close(td, jd, LOGIT_TOL)
    for k in ("h", "conv"):
        close(tc["units"]["b0_ssd"][k], jc2["units"]["b0_ssd"][k], LOGIT_TOL)


def test_train_step_matches_jax():
    """One step of the smoke config at 2 x 48 (three chunks of 16): loss,
    grad norm and every trainable leaf's gradient, read as the AdamW
    first moment (1 - b1) g of both."""
    jcfg = _jcfg()
    st = np_train_state(jcfg)
    st["train"] = perturb_lora(st["train"], np.random.default_rng(1))
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    dcfg = dict(vocab_size=256, seq_len=48, global_batch=2, kind="random",
                seed=3)
    jtr = jax_trainer(jcfg, JOptimizerConfig(**ocfg),
                      JTrainerConfig(total_steps=1, log_interval=1), st)
    jrep = jtr.run(iter(list(jpipeline.synthetic_dataset(
        jpipeline.DataConfig(**dcfg), 1))))
    tr = Trainer(port_cfg(jcfg), OptimizerConfig(**ocfg),
                 TrainerConfig(total_steps=1, log_interval=1),
                 state=from_numpy_state(st, "cpu"))
    rep = tr.run(iter(list(pipeline.synthetic_dataset(
        pipeline.DataConfig(**dcfg), 1))))
    jm, m = jrep["metrics"][-1], rep["metrics"][-1]
    for k in ("loss", "lm_loss", "grad_norm"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, err_msg=k)
    want = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jtr.state["opt"]["m"])[0]}
    got = dict(leaves(tr.state["opt"]["m"]))
    assert set(got) == set(want)
    assert any("in_proj" in p for p in got)
    for path, g in got.items():
        g, w = g.numpy().ravel(), want[path].ravel()
        scale = float(np.abs(w).max())
        assert scale > 0.0, path
        cos = float(g @ w) / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos >= 0.9999, (path, cos)
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, path


# ------------------------------------------------------------ serving
def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in lens]


def _per_token_greedy(model, cfg, prompt, steps, max_len):
    with torch.no_grad():
        caches, lg = transformer.lm_prefill(
            model, cfg, {"tokens": t([prompt], torch.long)}, max_len)
        out = [int(lg[0, -1].argmax())]
        for i in range(1, steps):
            lg = transformer.lm_decode_step(
                model, cfg, caches, torch.tensor([out[-1]]),
                torch.tensor([len(prompt) + i - 1]))
            out.append(int(lg[0, -1].argmax()))
    return out


def test_recurrent_arch_exact_length_prefill():
    """JAX's test mirrored: the SSD state cannot take right padding, so
    the engine prefills at the exact length; one slot recycled for two
    prompts gives the per-token loop's streams."""
    _, _, model = _model()
    cfg = model.cfg
    prompts = _prompts([7, 12])
    eng = Engine(cfg, model, max_len=32, num_slots=1, decode_chunk=4,
                 device="cpu")
    assert not eng._ragged_batchable()
    with torch.no_grad():
        out = eng.run([Request(uid=i, tokens=p, max_new_tokens=3)
                       for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        assert out[i].tokens == _per_token_greedy(model, cfg, p, 3, 32), i


STAT_KEYS = ("admitted", "completed", "prefill_batches", "prefill_tokens",
             "decode_tokens", "decode_steps")


def test_engine_streams_and_stats_match_jax():
    """Greedy Engine.run on 2 slots, prompts of 9, 20, 5, 20 and 13 (the
    two of 20 share a prefill group, the others prefill alone)."""
    jcfg, tree, model = _model()
    prompts = _prompts([9, 20, 5, 20, 13], seed=9)
    kw = dict(max_len=40, num_slots=2, decode_chunk=4, prefill_batch=2)
    jeng = JEngine(jcfg, tree, **kw)
    want = jeng.run([JRequest(uid=i, tokens=p, max_new_tokens=6)
                     for i, p in enumerate(prompts)])
    eng = Engine(model.cfg, model, device="cpu", **kw)
    with torch.no_grad():
        got = eng.run([Request(uid=i, tokens=p, max_new_tokens=6)
                       for i, p in enumerate(prompts)])
    for g, w in zip(got, want):
        assert g.tokens == w.tokens and g.finish_reason == w.finish_reason
    for key in STAT_KEYS:
        assert getattr(eng.last_stats, key) == getattr(jeng.last_stats,
                                                       key), key
