"""The port's hybrid family (recurrentgemma-9b: RG-LRU blocks and local
MQA attention in ("rec", "rec", "attn") units) against the JAX package,
in f32 on the CPU, with params drawn from JAX's defs
(``np_init_tree``) through numpy:

  * the RG-LRU block (models/rglru.py): ``_causal_conv`` with and without
    a carried state and ``_gates`` to 1e-5; ``rglru_scan`` (the port's
    log-depth doubling) against ``jax.lax.associative_scan``, with and
    without h0, to rtol 1e-5 / atol 1e-6 (the two sum in other orders);
    ``rglru_step`` chained S times equal to the scan; ``rec_apply`` in
    the train, prefill and decode modes at one gate block (the smoke
    width) and sixteen (``lru_width`` 128), outputs and caches to 1e-5;
  * the 5-layer smoke LM, one unit plus a tail of two ``rec`` blocks, on
    the kernel and the oracle paths: ``lm_hidden``'s logits,
    ``lm_prefill`` then ``lm_decode_step``, and ``lm_prefill_ragged`` of
    an equal-length group (the engine groups no other), logits to 1e-4
    and the caches, tail included;
  * greedy ``Engine.run`` streams and ServeStats against JAX's Engine
    (replay rule of tests/test_sparse_decode.py), prompts past the
    16-slot window, and without a window on the paged layout (page pools
    for attention, per-slot recurrent states); the windowed stack is
    never paged; a re-prefill (recompute resume) rebuilds the recurrent
    state that decoding reached;
  * one train step: loss, grad norm and each trainable leaf's gradient
    (the AdamW first moment) by cosine >= 0.9999 and max-abs <= 1e-4 x
    the leaf's largest entry;
  * the telemetry counter rows: one per unit, then one per tail block
    that reports the counter, as JAX's scan and tail append them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import rglru as jrglru
from repro.models import transformer as jtransformer
from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.core.params import (from_numpy_state, from_numpy_tree,
                                     leaves)
from repro_torch.data import pipeline
from repro_torch.models import rglru, transformer
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.serving.engine import Engine, Request
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_model import (close, jax_params, np_init_tree,
                              perturb_lora, port_cfg, port_model, t)
from test_torch_model import (jax_trainer, keep_sigterm,  # noqa: F401
                              np_train_state)

ARCH = "recurrentgemma-9b"
LOGIT_TOL = 1e-4
KERNEL = dict(attn_impl="pallas", ffn_impl="pallas")
ORACLE = dict(attn_impl="sparse_jnp", ffn_impl="grouped")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(**kw):
    spt = kw.pop("spt", None)
    cfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.float32,
                              **kw)
    return cfg.with_spt(**spt) if spt else cfg


def _rec_params(jcfg, seed=0):
    """(JAX, port) params of one RG-LRU mixer, f32, LoRA c perturbed."""
    tree = np_init_tree(jrglru.rglru_defs(jcfg), seed)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    tree = perturb_lora(tree, np.random.default_rng(seed + 1))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_numpy_tree(tree, "cpu"))


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------------ RG-LRU parts
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    rng = np.random.default_rng(0)
    x, kern = _normal(rng, 2, 9, 64), _normal(rng, 4, 64)
    state = _normal(rng, 2, 3, 64) if with_state else None
    jy, js = jrglru._causal_conv(jnp.asarray(x), jnp.asarray(kern),
                                 None if state is None
                                 else jnp.asarray(state))
    ty, ts = rglru._causal_conv(t(x), t(kern),
                                None if state is None else t(state))
    close(ty, jy)
    close(ts, js)


@pytest.mark.parametrize("lru_width", [64, 128])
def test_gates_match(lru_width):
    jcfg = _jcfg(lru_width=lru_width)
    jp, tp = _rec_params(jcfg)
    assert tp["w_a"].shape[0] == jrglru._gate_blocks(jcfg)
    xc = _normal(np.random.default_rng(1), 2, 7, lru_width)
    ja, jb = jrglru._gates(jp, jnp.asarray(xc))
    ta, tb = rglru._gates(tp, t(xc))
    close(ta, ja)
    close(tb, jb)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_associative_scan(with_h0):
    """The doubling scan against XLA's associative scan over 37 steps
    (not a power of two): the float order differs, so rtol 1e-5 / atol
    1e-6 rather than equality."""
    jp, tp = _rec_params(_jcfg())
    rng = np.random.default_rng(2)
    xc = _normal(rng, 3, 37, 64)
    h0 = _normal(rng, 3, 64) if with_h0 else None
    jh, jlast = jrglru.rglru_scan(jp, jnp.asarray(xc),
                                  None if h0 is None else jnp.asarray(h0))
    th, tlast = rglru.rglru_scan(tp, t(xc), None if h0 is None else t(h0))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=1e-5,
                               atol=1e-6)


def test_rglru_step_chain_equals_scan():
    _, tp = _rec_params(_jcfg())
    rng = np.random.default_rng(3)
    xc, h = t(_normal(rng, 2, 21, 64)), t(_normal(rng, 2, 64))
    want, _ = rglru.rglru_scan(tp, xc, h)
    steps = []
    for s in range(xc.shape[1]):
        h, _ = rglru.rglru_step(tp, xc[:, s], h)
        steps.append(h)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("lru_width", [64, 128])          # 1 and 16 blocks
def test_rec_apply_matches(mode, lru_width):
    jcfg = _jcfg(lru_width=lru_width)
    pcfg = port_cfg(jcfg)
    jp, tp = _rec_params(jcfg, seed=4)
    rng = np.random.default_rng(5)
    s = 1 if mode == "decode" else 13
    x = _normal(rng, 2, s, jcfg.d_model)
    cache = None
    if mode != "train":
        cache = {"h": _normal(rng, 2, lru_width),
                 "conv": _normal(rng, 2, jcfg.conv_width - 1, lru_width)}
    jy, jc, _ = jrglru.rec_apply(
        jp, jnp.asarray(x), jcfg, mode=mode,
        cache=None if cache is None else
        {k: jnp.asarray(v) for k, v in cache.items()})
    tc = None if cache is None else {k: t(v) for k, v in cache.items()}
    with torch.no_grad():
        ty, tc, _ = rglru.rec_apply(tp, t(x), pcfg, mode=mode, cache=tc)
    close(ty, jy)
    if cache is not None:
        for k in ("h", "conv"):
            close(tc[k], jc[k])


# ------------------------------------------------------------ the LM
def _model(spt):
    jcfg = _jcfg(spt=spt)
    tree = jax_params(jcfg)
    return jcfg, tree, port_model(jcfg, tree)


def _close_caches(got, want):
    assert set(got) == set(want) == {"units", "tail"}
    for part in ("units", "tail"):
        assert set(got[part]) == set(want[part])
        for name, blk in got[part].items():
            for k, v in blk.items():
                w = np.asarray(want[part][name][k])
                if v.dtype in (torch.int8, torch.int32, torch.int64):
                    np.testing.assert_array_equal(v.numpy(), w)
                elif k != "codes":
                    close(v, w)


@pytest.mark.parametrize("spt", [KERNEL, ORACLE], ids=["kernel", "oracle"])
def test_lm_hidden_prefill_and_decode_match(spt):
    jcfg, tree, model = _model(spt)
    pcfg = model.cfg
    assert transformer._tail_kinds(pcfg) == ("rec", "rec")
    toks = np.random.default_rng(6).integers(0, 256, (2, 24)).astype(
        np.int32)
    # train-mode hidden states through the head (24 > the window of 16)
    jh, _ = jax.jit(lambda p, b: jtransformer.lm_hidden(p, jcfg, b))(
        tree, {"tokens": jnp.asarray(toks)})
    params = from_numpy_tree(tree, "cpu")
    with torch.no_grad():
        th, _ = transformer.lm_hidden(params, pcfg,
                                      {"tokens": t(toks, torch.long)})
        tl = transformer.logits_of(model, pcfg, th)
    close(tl, jtransformer.logits_of(tree, jcfg, jh), LOGIT_TOL)
    # prefill, then one decode step from the port's own caches
    jc, jl = jax.jit(lambda p, b: jtransformer.lm_prefill(p, jcfg, b, 40))(
        tree, {"tokens": jnp.asarray(toks)})
    tc, tl = transformer.lm_prefill(model, pcfg,
                                    {"tokens": t(toks, torch.long)}, 40)
    close(tl, jl, LOGIT_TOL)
    _close_caches(tc, jc)
    # the decode step from JAX's caches (its PQ codes) on both sides
    tc = jax.tree_util.tree_map(lambda a: t(np.asarray(a)), jc)
    tok = np.asarray(jl[:, -1].argmax(-1), np.int32)
    pos = np.full(2, 24, np.int32)
    jc2, jd = jax.jit(lambda p, c, k, q: jtransformer.lm_decode_step(
        p, jcfg, c, k, q))(tree, jc, jnp.asarray(tok), jnp.asarray(pos))
    td = transformer.lm_decode_step(model, pcfg, tc, t(tok, torch.long),
                                    t(pos))
    close(td, jd, LOGIT_TOL)
    _close_caches(tc, jc2)


@pytest.mark.parametrize("spt", [KERNEL, ORACLE], ids=["kernel", "oracle"])
def test_lm_prefill_ragged_equal_length_group_matches(spt):
    jcfg, tree, model = _model(spt)
    toks = np.random.default_rng(7).integers(0, 256, (3, 19)).astype(
        np.int32)
    lens = np.full(3, 19, np.int32)
    jc, jl = jax.jit(lambda p, b, n: jtransformer.lm_prefill_ragged(
        p, jcfg, b, n, 32))(tree, {"tokens": jnp.asarray(toks)},
                            jnp.asarray(lens))
    tc, tl = transformer.lm_prefill_ragged(
        model, model.cfg, {"tokens": t(toks, torch.long)}, t(lens), 32)
    close(tl, jl, LOGIT_TOL)
    _close_caches(tc, jc)


def test_telemetry_counter_rows_match():
    """Counters of a prefill and a decode step: the decode attention's
    per unit (one row), the FFN's per unit and per tail block (three
    rows)."""
    jcfg, tree, model = _model(dict(KERNEL, telemetry="counters"))
    toks = np.random.default_rng(8).integers(0, 256, (2, 18)).astype(
        np.int32)
    lens = np.full(2, 18, np.int32)
    jc, _, jtel = jax.jit(lambda p, b, n: jtransformer.lm_prefill_ragged(
        p, jcfg, b, n, 32, return_counters=True))(
        tree, {"tokens": jnp.asarray(toks)}, jnp.asarray(lens))
    tc, _, ttel = transformer.lm_prefill_ragged(
        model, model.cfg, {"tokens": t(toks, torch.long)}, t(lens), 32,
        return_counters=True)
    tok = np.array([3, 5], np.int32)
    _, _, jtel_d = jax.jit(lambda p, c, k, q: jtransformer.lm_decode_step(
        p, jcfg, c, k, q, return_counters=True))(
        tree, jc, jnp.asarray(tok), jnp.asarray(lens))
    _, ttel_d = transformer.lm_decode_step(
        model, model.cfg, tc, t(tok, torch.long), t(lens),
        return_counters=True)
    assert "tel_attn_kept" in ttel_d             # decode counts the keys
    for got, want in ((ttel, jtel), (ttel_d, jtel_d)):
        assert set(got) == set(want)
        assert got["tel_expert_load"].shape[0] == 3
        for k in ("tel_attn_kept", "tel_attn_elig"):
            assert k not in got or got[k].shape[0] == 1
        for k, v in got.items():
            assert tuple(v.shape) == tuple(np.shape(want[k])), k
            close(v, want[k])


# ------------------------------------------------------------ serving
def _replay_gap(jcfg, tree, ctx, a, b, max_len):
    batch = {"tokens": jnp.asarray(np.asarray(ctx, np.int32)[None, :])}
    _, logits = jax.jit(lambda p, bt, n: jtransformer.lm_prefill_ragged(
        p, jcfg, bt, n, max_len))(tree, batch, jnp.asarray([len(ctx)]))
    lg = np.asarray(logits[0, -1], np.float32)
    return float(lg.max()) - min(float(lg[a]), float(lg[b]))


STAT_KEYS = ("admitted", "completed", "prefill_batches", "prefill_tokens",
             "decode_tokens", "decode_steps", "preemptions",
             "kv_pages_total", "kv_pages_peak", "admission_stalls")
PAGED_NO_WINDOW = dict(KERNEL, kv_layout="paged", kv_page_size=8)


@pytest.mark.parametrize("spt,window", [(KERNEL, 16), (ORACLE, 16),
                                        (PAGED_NO_WINDOW, None)],
                         ids=["kernel", "oracle", "paged-no-window"])
def test_engine_streams_and_stats_match_jax(spt, window):
    """Greedy Engine.run on 2 slots: prompts past the 16-slot window, two
    of one length (one prefill group); the recurrent states travel with
    their rows into the slots.  Without a window the attention caches
    are page pools and the recurrent states stay per slot, in both
    packages."""
    jcfg = _jcfg(window=window, spt=spt)
    tree = jax_params(jcfg)
    model = port_model(jcfg, tree)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, n).tolist() for n in (9, 20, 5, 20, 13)]
    kw = dict(max_len=40, num_slots=2, decode_chunk=4, prefill_batch=2)
    jeng = JEngine(jcfg, tree, **kw)
    want = jeng.run([JRequest(uid=i, tokens=p, max_new_tokens=6)
                     for i, p in enumerate(prompts)])
    eng = Engine(model.cfg, model, device="cpu", **kw)
    with torch.no_grad():
        got = eng.run([Request(uid=i, tokens=p, max_new_tokens=6)
                       for i, p in enumerate(prompts)])
    assert not eng._ragged_batchable()
    for row, (prompt, g, w) in enumerate(zip(prompts, got, want)):
        assert g.finish_reason == w.finish_reason
        if g.tokens == w.tokens:
            continue
        i = next(j for j, (a, b) in enumerate(zip(g.tokens, w.tokens))
                 if a != b)
        gap = _replay_gap(jcfg, tree, prompt + w.tokens[:i], g.tokens[i],
                          w.tokens[i], 40)
        assert gap <= 1e-3, (row, i, gap)
    for key in STAT_KEYS:
        assert getattr(eng.last_stats, key) == getattr(jeng.last_stats,
                                                       key), key
    assert eng._paged == (window is None)


def test_paged_layout_does_not_apply_to_the_windowed_stack():
    """A windowed hybrid stack has no full-length strip to page, in both
    packages; asking for paged KV keeps the contiguous ring."""
    jcfg = _jcfg(spt=dict(kv_layout="paged", kv_page_size=8))
    assert not jtransformer.paged_applicable(jcfg)
    assert not transformer.paged_applicable(port_cfg(jcfg))
    tree = jax_params(jcfg)
    model = port_model(jcfg, tree)
    eng = Engine(model.cfg, model, max_len=32, num_slots=2, device="cpu")
    assert not eng._paged and eng.kv_pages == 0


def test_resumed_request_rebuilds_its_recurrent_state():
    """A request resumed by re-prefill (prompt + its generated tokens)
    gets the recurrent state a straight run reaches: the port's re-prefill
    of 16 + 4 tokens gives the caches of decoding the 4 tokens after the
    16-token prefill, up to f32 rounding."""
    jcfg, tree, model = _model(ORACLE)
    pcfg = model.cfg
    prompt = np.random.default_rng(10).integers(0, 256, 16).tolist()
    with torch.no_grad():
        caches, lg = transformer.lm_prefill(
            model, pcfg, {"tokens": t([prompt], torch.long)}, 32)
        toks = []
        for i in range(4):
            tok = lg[:, -1].argmax(-1)
            toks.append(int(tok))
            lg = transformer.lm_decode_step(model, pcfg, caches, tok,
                                            torch.tensor([16 + i]))
        again, _ = transformer.lm_prefill(
            model, pcfg, {"tokens": t([prompt + toks], torch.long)}, 32)
    for part, name in (("units", "b0_rec"), ("units", "b1_rec"),
                       ("tail", "t0_rec"), ("tail", "t1_rec")):
        for k in ("h", "conv"):
            np.testing.assert_allclose(again[part][name][k].numpy(),
                                       caches[part][name][k].numpy(),
                                       rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ training
def test_train_step_matches_jax():
    """One step of the smoke config on the kernel config at sequences of
    40 (past the window): loss, grad norm and every trainable leaf's
    gradient, read as the AdamW first moment (1 - b1) g of both."""
    jcfg = _jcfg(spt=KERNEL)
    st = np_train_state(jcfg)
    st["train"] = perturb_lora(st["train"], np.random.default_rng(1))
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    dcfg = dict(vocab_size=256, seq_len=40, global_batch=2, kind="random",
                seed=3)
    jbatches = list(jpipeline.synthetic_dataset(
        jpipeline.DataConfig(**dcfg), 1))
    jtr = jax_trainer(jcfg, JOptimizerConfig(**ocfg),
                      JTrainerConfig(total_steps=1, log_interval=1), st)
    jrep = jtr.run(iter(jbatches))
    batches = list(pipeline.synthetic_dataset(pipeline.DataConfig(**dcfg),
                                              1))
    tr = Trainer(port_cfg(jcfg), OptimizerConfig(**ocfg),
                 TrainerConfig(total_steps=1, log_interval=1),
                 state=from_numpy_state(st, "cpu"))
    rep = tr.run(iter(batches))
    jm, m = jrep["metrics"][-1], rep["metrics"][-1]
    for k in ("loss", "lm_loss", "lb_loss", "grad_norm", "dropped"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jtr.state["opt"]["m"])[0]}
    got = dict(leaves(tr.state["opt"]["m"]))
    assert set(got) == set(want)
    assert any(p[0] == "tail" for p in got)
    assert any("w_gate" in p for p in got)
    for path, g in got.items():
        g, w = g.numpy().ravel(), want[path].ravel()
        scale = float(np.abs(w).max())
        if scale == 0.0:
            assert float(np.abs(g).max()) == 0.0, path
            continue
        cos = float(g @ w) / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos >= 0.9999, (path, cos)
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, path
