"""The paper's own models in the port against the JAX package.

  * configs: the five Table-2 blocks, opt-2.7b and llama-2.7b equal JAX's
    ``get_config`` field for field; ``apply_variant`` spt / lora / full
    equals JAX's; ``lm_defs`` (the learned-position leaf ``pos``
    included) has JAX's paths, shapes, dtypes, inits and trainable flags;
    ``kv_row_bytes`` equals JAX's (dh 80 and 128);
  * two reduced configs of 2 layers in f32, with attn_impl / ffn_impl
    "pallas" (the JAX kernels in interpret mode; the port's wrappers take
    their plain versions on CPU tensors):
      - OPT-like: d_model 160, 2 heads of 80 (R = 1, M = 10 PQ books),
        d_ff 640 (ungated ReLU), LayerNorm, learned positions, vocab 512,
        max_position 256;
      - LLaMA-like: d_model 128, 2 heads of 64 (M = 8), d_ff 512
        (SwiGLU), RMSNorm, RoPE, vocab 512;
    forward logits, the loss and every trainable leaf's gradient, one
    AdamW step, and ``lm_prefill``'s logits and caches equal JAX's; the
    port's ``lm_prefill`` writes the caches its ragged prefill writes at
    full length;
  * the OPT-like config's greedy streams equal the JAX engine's on the
    contiguous and the paged layouts; a decode at positions past
    max_position clips the position rows as JAX does;
  * the "full" variant trains nothing in either package (its base
    weights are frozen leaves): equal losses, grad_norm 0;
  * ``launch/train.py --arch opt-1024 --variant lora --device cpu`` runs.

Tolerances (f32, the packages sum in different orders), those of
tests/test_torch_model.py and tests/test_torch_train.py: layers and
caches 1e-5, logits 1e-4, losses rel 1e-5, gradients and moments max-abs
<= 1e-4 x the leaf's largest entry, parameters after AdamW 1e-6 (where
the JAX gradient is above that gradient tolerance; below it AdamW's
first step lr x g / (|g| + eps) is not fixed by the gradients, and both
packages only keep its bound lr x (1 + wd |p|)); PQ codes
equal except where the two nearest codeword distances lie within 1e-5;
greedy streams equal up to a logit near-tie (<= 1e-3, replayed).
"""
import dataclasses
import functools
import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import params as JP
from repro.models import transformer as jtransformer
from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
from repro.optim.adamw import adamw_update as jadamw_update
from repro.serving import kv_pages as jkvp
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.train import state as JS
from repro.train.loss import lm_cross_entropy as jlm_cross_entropy
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.core.params import (combine, from_numpy_state,
                                     from_numpy_tree, is_def, leaves)
from repro_torch.launch import steps
from repro_torch.launch.dryrun import VARIANTS, apply_variant
from repro_torch.models import transformer
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.serving import kv_pages
from repro_torch.serving.engine import Engine, Request
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_model import (LOGIT_TOL, close, jax_params,
                              perturb_lora, port_cfg, port_model, t)
from test_torch_model import (jax_trainer, keep_sigterm,  # noqa: F401
                              np_train_state)

PAPER = ("opt-1024", "opt-2048", "opt-2560", "llama-2560", "llama-4096",
         "opt-2.7b", "llama-2.7b")
LOSS_TOL, GRAD_TOL, PARAM_TOL, TIE = 1e-5, 1e-4, 1e-6, 1e-5
BATCH, SEQ, CHUNK, MAX_LEN = 2, 32, 16, 48
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
PALLAS = dict(attn_impl="pallas", ffn_impl="pallas")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread (the suite runs in several worker processes);
    gradients stay on, unlike test_torch_model's inference fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def opt_like(**spt):
    cfg = dataclasses.replace(
        jconfigs.get_config("opt-2.7b"), num_layers=2, d_model=160,
        num_heads=2, num_kv_heads=2, head_dim=80, d_ff=640, vocab_size=512,
        max_position=256, dtype=jnp.float32)
    return cfg.with_spt(**PALLAS, **spt)


def llama_like(**spt):
    cfg = dataclasses.replace(
        jconfigs.get_config("llama-2.7b"), num_layers=2, d_model=128,
        num_heads=2, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        dtype=jnp.float32)
    return cfg.with_spt(**PALLAS, **spt)


REDUCED = {"opt": opt_like, "llama": llama_like}


def _japply_variant(cfg, variant):
    """JAX's apply_variant.  Its module sets XLA_FLAGS for the dry-run's
    512 host devices when first imported; the backend is started first so
    the flag cannot reach it, and the variable is put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    from repro.launch.dryrun import apply_variant as jav
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return jav(cfg, variant)


def _tokens(seed, b=BATCH, s=SEQ, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("name", PAPER)
def test_paper_configs_equal_jax(name):
    got = configs.get_config(name)
    assert got == port_cfg(jconfigs.get_config(name))
    assert got.name == name
    assert name not in configs.ARCH_NAMES       # assigned archs only


@pytest.mark.parametrize("variant", VARIANTS)
def test_apply_variant_matches_jax(variant):
    for name in PAPER:
        jcfg = jconfigs.get_config(name)
        assert apply_variant(configs.get_config(name), variant) == \
            port_cfg(_japply_variant(jcfg, variant))
    with pytest.raises(ValueError):
        apply_variant(configs.get_config("opt-1024"), "dense")


def _def_table(defs, jax_side):
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if (JP.is_def(v) if jax_side else is_def(v)):
                dt = jnp.dtype(v.dtype).name if jax_side else \
                    str(v.dtype).split(".")[-1]
                out[path + (k,)] = (tuple(v.shape), dt, v.init, v.trainable)
            else:
                walk(v, path + (k,))
    walk(defs, ())
    return out


@pytest.mark.parametrize("name", PAPER + ("opt-like", "llama-like"))
def test_lm_defs_match_jax(name):
    jcfg = (opt_like() if name == "opt-like" else llama_like()
            if name == "llama-like" else jconfigs.get_config(name))
    got = _def_table(transformer.lm_defs(port_cfg(jcfg)), False)
    want = _def_table(jtransformer.lm_defs(jcfg), True)
    assert got == want
    learned = jcfg.positional == "learned"
    assert (("pos", "pos_embedding") in got) == learned
    if learned:
        assert got[("pos", "pos_embedding")] == (
            (jcfg.max_position, jcfg.d_model), "bfloat16", "normal:0.02",
            False)


@pytest.mark.parametrize("name", PAPER)
def test_kv_row_bytes_match_jax(name):
    jcfg = jconfigs.get_config(name)
    assert kv_pages.kv_row_bytes(port_cfg(jcfg)) == jkvp.kv_row_bytes(jcfg)


# ------------------------------------------------------------ forward
@pytest.mark.parametrize("which", list(REDUCED))
def test_forward_logits_match_jax(which):
    """Logits of the train-step state's params on the step's batch."""
    jr = _jax_run(which)
    state = from_numpy_state(jr["state"], "cpu")
    params = combine(state["train"], state["frozen"])
    cfg = port_cfg(jr["cfg"])
    with torch.no_grad():
        h, _ = transformer.lm_hidden(
            params, cfg, {"tokens": t(jr["batch"]["tokens"], torch.long)},
            remat=False)
        got = transformer.logits_of(params, cfg, h)
    close(got, jr["logits"], LOGIT_TOL)


def test_learned_positions_clip_as_jax():
    """``_embed_inputs`` for a scalar pos0 and a per-slot (B,) pos0 whose
    positions run past max_position (and one below 0): the rows JAX's
    take(mode="clip") gives."""
    jcfg = opt_like()
    tree = jax_params(jcfg)
    params = from_numpy_tree(tree, "cpu")
    cfg = port_cfg(jcfg)
    toks = _tokens(2, b=4, s=6)
    for pos0 in (250, np.array([0, 252, 256, 900], np.int32),
                 np.array([-3, 5, 255, 254], np.int32)):
        want = jtransformer._embed_inputs(tree, jcfg,
                                          {"tokens": jnp.asarray(toks)},
                                          pos0=jnp.asarray(pos0))
        got = transformer._embed_inputs(params, cfg, t(toks, torch.long),
                                        pos0=t(pos0))
        assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ training
def _np_state(jcfg):
    """A JAX train state as numpy (``np_train_state``), LoRA c
    perturbed."""
    st = np_train_state(jcfg)
    st["train"] = perturb_lora(st["train"], np.random.default_rng(1))
    return st


def _batch(seed):
    toks = _tokens(seed, s=SEQ + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@functools.lru_cache(maxsize=None)
def _jax_run(which):
    """One jit of JAX's build_train_step loss (value_and_grad of its
    loss_fn, with the logits of the forward as aux) on the reduced
    config's state and batch, then its AdamW update; cached per config
    (callers only read it)."""
    jcfg = REDUCED[which]()
    state = _np_state(jcfg)
    batch = _batch(3)
    jt = lambda tr: jax.tree_util.tree_map(jnp.asarray, tr)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    frozen = jt(state["frozen"])

    def loss_fn(train):
        params = JP.combine(train, frozen)
        hidden, aux = JS.model_hidden(params, jcfg, b, remat=True)
        lm, _ = jlm_cross_entropy(params, jcfg, hidden, b["labels"], CHUNK)
        loss = lm + jcfg.spt.lb_loss_weight * aux["lb_loss"] / jcfg.num_layers
        return loss, jtransformer.logits_of(params, jcfg, hidden)

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jt(state["train"]))
    new_train, new_opt, _ = jadamw_update(
        jt(state["train"]), grads, jt(state["opt"]),
        jnp.asarray(0, jnp.int32), JOptimizerConfig(**OCFG))
    as_np = lambda tr: jax.tree_util.tree_map(np.asarray, tr)
    return {"cfg": jcfg, "state": state, "batch": batch, "loss": float(loss),
            "logits": np.asarray(logits), "grads": as_np(grads),
            "train": as_np(new_train), "opt": as_np(new_opt)}


def _leaf_close(got, want, tol):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=tol * max(float(np.abs(w).max()), 1e-30))


def _zip_leaves(port_tree, jax_tree):
    got = list(leaves(port_tree))
    want = {tuple(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    assert {p for p, _ in got} == set(want)
    return [(p, v, want[p]) for p, v in got]


@pytest.mark.parametrize("which", list(REDUCED))
def test_train_step_matches_jax(which):
    """Loss and every trainable leaf's gradient, then the state after one
    ``build_train_step`` step (train leaves, AdamW moments)."""
    jr = _jax_run(which)
    state, batch = jr["state"], jr["batch"]
    jloss, jgrads, jtrain, jopt = (jr[k] for k in ("loss", "grads", "train",
                                                   "opt"))
    cfg = port_cfg(jr["cfg"])
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, _, grads = steps.loss_and_grads(from_numpy_state(state, "cpu"),
                                          cfg, tb, CHUNK)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_TOL)
    for path, got, want in _zip_leaves(grads, jgrads):
        if path[-1] == "codebooks":      # argmin: zero on both sides
            assert not got.any() and not np.asarray(want).any()
            continue
        assert np.abs(want).max() > 0, path
        _leaf_close(got, want, GRAD_TOL)
    step = steps.build_train_step(cfg, OptimizerConfig(**OCFG), CHUNK)
    new, metrics = step(from_numpy_state(state, "cpu"), tb)
    assert int(new["step"]) == 1
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=LOSS_TOL)
    jg = {p: np.asarray(w) for p, _, w in _zip_leaves(grads, jgrads)}
    old = dict(leaves(from_numpy_state(state, "cpu")["train"]))
    for path, got, want in _zip_leaves(new["train"], jtrain):
        g, p0 = jg[path], old[path].numpy()
        # AdamW's first step moves an entry by lr x g / (|g| + eps): where
        # |g| lies below the gradient tolerance that ratio is not fixed by
        # gradients that agree to it, so there both packages must only
        # keep the step's bound
        sure = np.abs(g) >= GRAD_TOL * np.abs(g).max()
        diff = np.abs(got.numpy() - want)
        assert sure.mean() > 0.9, path
        assert diff[sure].max(initial=0.0) <= PARAM_TOL, path
        bound = OCFG["lr"] * (1 + 0.01 * np.abs(p0)) + 1e-7
        for moved in (got.numpy() - p0, want - p0):
            assert (np.abs(moved) <= bound).all(), path
    for key in ("m", "v"):
        for path, got, want in _zip_leaves(new["opt"][key], jopt[key]):
            if np.abs(want).max() > 0:
                _leaf_close(got, want, GRAD_TOL)
            else:
                assert not got.any(), path


def test_full_variant_trains_nothing_in_either_package():
    """"full" freezes every leaf (LoRA off, base weights frozen), so the
    trainer steps with an empty trainable tree: the same losses as JAX's
    Trainer, grad_norm 0, no AdamW moment."""
    jcfg = _japply_variant(opt_like(), "full")
    cfg = apply_variant(port_cfg(opt_like()), "full")
    assert cfg == port_cfg(jcfg)
    state = np_train_state(jcfg)
    assert not jax.tree_util.tree_leaves(state["train"])
    batches = [_batch(s) for s in (4, 5)]
    tcfg = dict(total_steps=2, log_interval=1, loss_chunk=CHUNK)
    jtr = jax_trainer(jcfg, JOptimizerConfig(**OCFG), JTrainerConfig(**tcfg),
                      state)
    want = jtr.run(iter(batches))["metrics"]
    tr = Trainer(cfg, OptimizerConfig(**OCFG), TrainerConfig(**tcfg),
                 state=from_numpy_state(state, "cpu"))
    assert not list(leaves(tr.state["train"]))
    got = tr.run(iter(batches))["metrics"]
    assert [m["grad_norm"] for m in got] == [m["grad_norm"] for m in want] \
        == [0.0, 0.0]
    np.testing.assert_allclose([m["loss"] for m in got],
                               [m["loss"] for m in want], rtol=LOSS_TOL)


# ------------------------------------------------------------ prefill
def _codes_close(got, want, k, codebooks):
    """PQ codes equal except at distance near-ties (<= TIE).  k: (U, B,
    Hk, S, dh) cached keys; codebooks: (U, M, E, d')."""
    got, want = np.asarray(got), np.asarray(want)
    u, b, hk, s, dh = k.shape
    m, e, dp = codebooks.shape[1:]
    xs = np.asarray(k, np.float32).reshape(u, b, hk, s, m, dp)
    cb = np.asarray(codebooks, np.float32)[:, None, None, None]
    dist = (cb * cb).sum(-1) - 2.0 * np.einsum("ubhsmd,ubhsmed->ubhsme",
                                               xs, np.broadcast_to(
                                                   cb, (u, b, hk, s, m, e,
                                                        dp)))
    srt = np.sort(dist, axis=-1)
    tie = (srt[..., 1] - srt[..., 0]) < TIE
    assert np.array_equal(got[~tie], want[~tie])


@functools.lru_cache(maxsize=None)
def _jax_prefill(which):
    """JAX's lm_prefill of the reduced config on _tokens(6) (cached)."""
    jcfg = REDUCED[which]()
    return jax.jit(lambda p, b: jtransformer.lm_prefill(
        p, jcfg, b, MAX_LEN))(jax_params(jcfg),
                              {"tokens": jnp.asarray(_tokens(6))})


@pytest.mark.parametrize("which", list(REDUCED))
def test_lm_prefill_matches_jax(which):
    """JAX's lm_prefill (no per-row lengths: its attention runs the
    train-path Pallas kernels, interpret mode) against the port's through
    ``steps.build_prefill_step``: last-position logits, K, V, codes and
    slot_pos of every layer."""
    jcfg = REDUCED[which]()
    tree = jax_params(jcfg)
    toks = _tokens(6)
    jc, jl = _jax_prefill(which)
    model = port_model(jcfg, tree)
    tc, tl = steps.build_prefill_step(model.cfg, MAX_LEN)(
        model, {"tokens": t(toks, torch.long)})
    assert tl.shape == (BATCH, 1, jcfg.padded_vocab)
    close(tl, jl, LOGIT_TOL)
    jb, tb = jc["units"]["b0_attn"], tc["units"]["b0_attn"]
    assert np.array_equal(tb["slot_pos"].numpy(), np.asarray(jb["slot_pos"]))
    for key in ("k", "v"):
        close(tb[key], jb[key])
    cb = tree["units"]["b0_attn"]["mixer"]["pq"]["codebooks"]
    _codes_close(tb["codes"].numpy(), jb["codes"], tb["k"].numpy(), cb)


@pytest.mark.parametrize("which", list(REDUCED))
def test_lm_prefill_writes_the_ragged_prefill_caches_at_full_length(which):
    """Within the port: every row at full length, the non-ragged prefill
    (kernel path) and the ragged one (the oracle attention with per-row
    budgets) give the same caches and logits."""
    jcfg = REDUCED[which]()
    tree = jax_params(jcfg)
    model = port_model(jcfg, tree)
    toks = t(_tokens(7), torch.long)
    lens = torch.full((BATCH,), SEQ, dtype=torch.int32)
    ac, al = transformer.lm_prefill(model, model.cfg, {"tokens": toks},
                                    MAX_LEN)
    bc, bl = transformer.lm_prefill_ragged(model, model.cfg,
                                           {"tokens": toks}, lens, MAX_LEN)
    close(al, bl, LOGIT_TOL)
    a, b = ac["units"]["b0_attn"], bc["units"]["b0_attn"]
    assert torch.equal(a["slot_pos"], b["slot_pos"])
    assert int((a["slot_pos"] >= 0).sum()) == 2 * BATCH * SEQ
    for key in ("k", "v"):
        close(a[key], b[key])
    cb = tree["units"]["b0_attn"]["mixer"]["pq"]["codebooks"]
    _codes_close(a["codes"].numpy(), b["codes"].numpy(), b["k"].numpy(), cb)


# ------------------------------------------------------------ serving
PROMPTS = [9, 14, 5, 12]          # 4 ragged requests over 2 slots
GEN, PAGE, POOL = 6, 8, 4


def _workload():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 512, size=n).tolist() for n in PROMPTS]


def _replay_gap(jcfg, tree, ctx, a, b):
    batch = {"tokens": jnp.asarray(np.asarray(ctx, np.int32)[None, :])}
    _, logits = jax.jit(lambda p, bt, n: jtransformer.lm_prefill_ragged(
        p, jcfg, bt, n, MAX_LEN))(tree, batch, jnp.asarray([len(ctx)]))
    lg = np.asarray(logits[0, -1], np.float32)
    return float(lg.max()) - min(float(lg[a]), float(lg[b]))


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_opt_greedy_streams_match_the_jax_engine(layout):
    """The OPT-like config served by both engines (2 slots, so slots are
    recycled; paged: pages of 8 from a 4-page pool, under the footprint,
    so admission stalls)."""
    spt = dict(kv_layout=layout, kv_page_size=PAGE)
    jcfg = opt_like(**spt)
    tree = jax_params(opt_like())
    pages = POOL if layout == "paged" else None
    jeng = JEngine(jcfg, tree, max_len=MAX_LEN, num_slots=2, decode_chunk=4,
                   kv_pages=pages)
    want = jeng.run([JRequest(uid=i, tokens=p, max_new_tokens=GEN)
                     for i, p in enumerate(_workload())])
    model = port_model(jcfg, tree)
    eng = Engine(model.cfg, model, max_len=MAX_LEN, num_slots=2,
                 decode_chunk=4, kv_pages=pages, device="cpu")
    got = eng.run([Request(uid=i, tokens=p, max_new_tokens=GEN)
                   for i, p in enumerate(_workload())])
    assert [c.finish_reason for c in got] == \
        [c.finish_reason for c in want] == ["length"] * len(PROMPTS)
    for key in ("admitted", "completed", "kv_pages_total", "kv_pages_peak",
                "admission_stalls"):
        assert getattr(eng.last_stats, key) == \
            getattr(jeng.last_stats, key), key
    if layout == "paged":
        assert eng.last_stats.admission_stalls > 0
    for row, (prompt, g, w) in enumerate(zip(_workload(), got, want)):
        if g.tokens == w.tokens:
            continue
        i = next(j for j, (a, b) in enumerate(zip(g.tokens, w.tokens))
                 if a != b)
        gap = _replay_gap(opt_like(), tree, prompt + w.tokens[:i],
                          g.tokens[i], w.tokens[i])
        assert gap <= 1e-3, (
            f"row {row} diverged at step {i} with a logit gap {gap:.3e}")


def test_decode_past_max_position_clips_as_jax():
    """One decode step through ``steps.build_decode_step`` at positions
    up to and past max_position (256) from JAX's prefill caches: the
    logits equal JAX's lm_decode_step, which clips the position rows."""
    jcfg = opt_like()
    tree = jax_params(jcfg)
    jc, _ = _jax_prefill("opt")
    pos = np.array([256, 1000], np.int32)
    tok = np.array([3, 500], np.int32)
    valid = np.arange(MAX_LEN)[None, :] < SEQ
    valid = valid | (np.arange(MAX_LEN)[None, :] == (pos % MAX_LEN)[:, None])
    _, jl = jax.jit(lambda p, c, tk, ps, v: jtransformer.lm_decode_step(
        p, jcfg, c, tk, ps, kv_valid=v))(tree, jc, jnp.asarray(tok),
                                         jnp.asarray(pos), jnp.asarray(valid))
    model = port_model(jcfg, tree)
    caches = jax.tree_util.tree_map(lambda a: t(a), jc)
    caches, tl = steps.build_decode_step(model.cfg)(
        model, caches, t(tok, torch.long), t(pos))
    close(tl, jl, LOGIT_TOL)
    # the port's own decode with pos clipped by hand gives the same rows
    clipped = np.minimum(pos, jcfg.max_position - 1)
    x_clip = transformer._embed_inputs(model, model.cfg,
                                       t(tok, torch.long)[:, None],
                                       pos0=t(clipped))
    x = transformer._embed_inputs(model, model.cfg,
                                  t(tok, torch.long)[:, None], pos0=t(pos))
    assert torch.equal(x, x_clip)


# ------------------------------------------------------------ launcher
def test_train_launcher_takes_a_paper_block_and_a_variant():
    from repro_torch.launch import train
    out = io.StringIO()
    with redirect_stdout(out):
        assert train.main(["--arch", "opt-1024", "--variant", "lora",
                           "--device", "cpu", "--steps", "1", "--batch", "1",
                           "--seq", "16"]) == 0
    rep = json.loads(out.getvalue())
    assert rep["arch"] == "opt-1024" and rep["variant"] == "lora"
    assert rep["final_step"] == 1 and rep["device"] == "cpu"
    assert np.isfinite(rep["last_metrics"]["loss"])
    assert rep["last_metrics"]["grad_norm"] > 0
