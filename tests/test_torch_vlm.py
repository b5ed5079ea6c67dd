"""The port's VLM family (phi-3-vision-4.2b: a decoder-only attention
stack with a stub vision frontend whose precomputed patch embeddings are
prepended to the text) against the JAX package, in f32 on the CPU, with
params drawn from JAX's defs (``np_init_tree``) through numpy:

  * the 2-layer smoke LM with ``frontend_embeds``, on the kernel and the
    oracle paths: ``lm_hidden``'s hidden states and logits, and
    ``lm_prefill`` / ``lm_prefill_ragged`` (lengths that count the
    frontend rows) then ``lm_decode_step``, each to max-abs <= 1e-5 x
    max |JAX|;
  * one train step with frontend rows: loss, grad norm and every
    trainable leaf's gradient (the AdamW first moment) against
    ``jax.grad``, the loss predicting from the text positions only;
  * greedy ``Engine.run`` streams and ServeStats against JAX's Engine on
    the contiguous and the paged layouts (the page reservation counts
    the frontend rows), ``generate`` on the engine path, and a request
    without frontend rows rejected as in JAX.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import shapes
from repro_torch.core.params import (from_numpy_state, from_numpy_tree,
                                     leaves)
from repro_torch.models import transformer
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.serving.engine import Engine, Request
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_model import jax_params, perturb_lora, port_cfg, port_model, t
from test_torch_model import (jax_trainer, keep_sigterm,  # noqa: F401
                              np_train_state)

ARCH = "phi-3-vision-4.2b"
KERNEL = dict(attn_impl="pallas", ffn_impl="pallas")
ORACLE = dict(attn_impl="sparse_jnp", ffn_impl="grouped")
F = 8                                   # the smoke config's frontend rows


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(**spt):
    cfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.float32)
    return cfg.with_spt(**spt) if spt else cfg


def _rel_close(got, want, rel=1e-5):
    """max |got - want| <= rel x max |want|."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape
    scale = float(np.abs(w).max())
    assert float(np.abs(g - w).max()) <= rel * scale, (
        float(np.abs(g - w).max()), scale)


def _frontend(rng, b):
    return rng.standard_normal((b, F, 64)).astype(np.float32)


@pytest.mark.parametrize("spt", [KERNEL, ORACLE], ids=["kernel", "oracle"])
def test_hidden_prefill_and_decode_match(spt):
    jcfg = _jcfg(**spt)
    tree = jax_params(jcfg)
    model = port_model(jcfg, tree)
    pcfg = model.cfg
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 20)).astype(np.int32)
    fe = _frontend(rng, 2)
    jb = {"tokens": jnp.asarray(toks), "frontend_embeds": jnp.asarray(fe)}
    tb = {"tokens": t(toks, torch.long), "frontend_embeds": t(fe)}
    jh, _ = jax.jit(lambda p, b: jtransformer.lm_hidden(p, jcfg, b))(tree, jb)
    with torch.no_grad():
        th, _ = transformer.lm_hidden(from_numpy_tree(tree, "cpu"), pcfg, tb)
        assert th.shape == (2, F + 20, 64)
        _rel_close(th, jh)
        _rel_close(transformer.logits_of(model, pcfg, th),
                   jtransformer.logits_of(tree, jcfg, jh))
    max_len = 48
    jc, jl = jax.jit(lambda p, b: jtransformer.lm_prefill(
        p, jcfg, b, max_len))(tree, jb)
    tc, tl = transformer.lm_prefill(model, pcfg, tb, max_len)
    _rel_close(tl, jl)
    sp = tc["units"]["b0_attn"]["slot_pos"]
    assert int(sp.max()) == F + 19                # frontend rows cached
    _rel_close(tc["units"]["b0_attn"]["k"], jc["units"]["b0_attn"]["k"])
    # ragged rows: lengths count the frontend rows, as in JAX
    lens = np.array([F + 20, F + 13], np.int32)
    jc, jl = jax.jit(lambda p, b, n: jtransformer.lm_prefill_ragged(
        p, jcfg, b, n, max_len))(tree, jb, jnp.asarray(lens))
    tc, tl = transformer.lm_prefill_ragged(model, pcfg, tb, t(lens), max_len)
    _rel_close(tl, jl)
    np.testing.assert_array_equal(tc["units"]["b0_attn"]["slot_pos"].numpy(),
                                  np.asarray(jc["units"]["b0_attn"]
                                             ["slot_pos"]))
    tok = np.asarray(jl[:, -1].argmax(-1), np.int32)
    pos = lens
    jd = jax.jit(lambda p, c, k, q: jtransformer.lm_decode_step(
        p, jcfg, c, k, q)[1])(tree, jc, jnp.asarray(tok), jnp.asarray(pos))
    tc = jax.tree_util.tree_map(lambda a: t(np.asarray(a)), jc)
    td = transformer.lm_decode_step(model, pcfg, tc, t(tok, torch.long),
                                    t(pos))
    _rel_close(td, jd)


def test_train_step_matches_jax():
    """One kernel-config step at 2 x (8 frontend + 32 text) positions:
    labels cover the text, the loss reads the last 32 hidden rows."""
    jcfg = _jcfg(**KERNEL)
    st = np_train_state(jcfg)
    st["train"] = perturb_lora(st["train"], np.random.default_rng(1))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (2, 33))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32),
             "frontend_embeds": _frontend(rng, 2)}
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jtr = jax_trainer(jcfg, JOptimizerConfig(**ocfg),
                      JTrainerConfig(total_steps=1, log_interval=1), st)
    jm = jtr.run(iter([batch]))["metrics"][-1]
    tr = Trainer(port_cfg(jcfg), OptimizerConfig(**ocfg),
                 TrainerConfig(total_steps=1, log_interval=1),
                 state=from_numpy_state(st, "cpu"))
    m = tr.run(iter([batch]))["metrics"][-1]
    assert m["tokens"] == 64.0                    # the text positions
    for k in ("loss", "lm_loss", "lb_loss", "grad_norm", "dropped"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jtr.state["opt"]["m"])[0]}
    got = dict(leaves(tr.state["opt"]["m"]))
    assert set(got) == set(want)
    for path, g in got.items():
        g, w = g.numpy().ravel(), want[path].ravel()
        scale = float(np.abs(w).max())
        if scale == 0.0:
            assert float(np.abs(g).max()) == 0.0, path
            continue
        cos = float(g @ w) / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos >= 0.9999, (path, cos)
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, path


STAT_KEYS = ("admitted", "completed", "rejections", "prefill_batches",
             "prefill_tokens", "decode_tokens", "decode_steps",
             "kv_pages_total", "kv_pages_peak", "admission_stalls")
PAGED = dict(KERNEL, kv_layout="paged", kv_page_size=8)


@pytest.mark.parametrize("spt", [KERNEL, PAGED], ids=["contiguous", "paged"])
def test_engine_streams_and_stats_match_jax(spt):
    """Greedy Engine.run on 2 slots: five requests with their frontend
    rows (prompts of 9, 20, 5, 20, 13 tokens), and one without, rejected
    in both packages; paged, the 8 + prompt + 6 rows of each request
    take their pages."""
    jcfg = _jcfg(**spt)
    tree = jax_params(jcfg)
    model = port_model(jcfg, tree)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, n).tolist() for n in (9, 20, 5, 20, 13)]
    fes = list(_frontend(rng, 5)) + [None]
    prompts.append([1, 2, 3])
    kw = dict(max_len=40, num_slots=2, decode_chunk=4, prefill_batch=2)
    jeng = JEngine(jcfg, tree, **kw)
    want = jeng.run([JRequest(uid=i, tokens=p, max_new_tokens=6,
                              frontend_embeds=f)
                     for i, (p, f) in enumerate(zip(prompts, fes))])
    eng = Engine(model.cfg, model, device="cpu", **kw)
    with torch.no_grad():
        got = eng.run([Request(uid=i, tokens=p, max_new_tokens=6,
                               frontend_embeds=f)
                       for i, (p, f) in enumerate(zip(prompts, fes))])
    assert [c.finish_reason for c in got] == ["length"] * 5 + ["rejected"]
    for g, w in zip(got, want):
        assert g.tokens == w.tokens and g.finish_reason == w.finish_reason
    for key in STAT_KEYS:
        assert getattr(eng.last_stats, key) == getattr(jeng.last_stats,
                                                       key), key
    assert eng._paged == ("kv_layout" in spt)


def test_generate_takes_the_frontend():
    """generate() on the engine path carries each row's frontend rows;
    its tokens equal the per-token loop's (positions start after the
    frontend)."""
    jcfg = _jcfg(**ORACLE)
    model = port_model(jcfg, jax_params(jcfg))
    rng = np.random.default_rng(11)
    batch = {"tokens": t(rng.integers(0, 256, (2, 12)), torch.long),
             "frontend_embeds": t(_frontend(rng, 2))}
    eng = Engine(model.cfg, model, max_len=32, num_slots=2, device="cpu")
    with torch.no_grad():
        engine_path = eng.generate(batch, 5).tokens
        per_token = eng._generate_per_token(batch, 5, 0.0, None).tokens
    assert engine_path == per_token


def test_input_specs_follow_the_family_rules():
    cfg = port_cfg(jconfigs.get_config(ARCH))
    spec = shapes.input_specs(cfg, shapes.ShapeSpec("t", "train", 1024, 4))
    assert spec["frontend_embeds"].shape == (4, 576, 3072)
    assert spec["tokens"].shape == spec["labels"].shape == (4, 448)
