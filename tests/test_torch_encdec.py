"""The port's encoder-decoder family (whisper-base: a bidirectional
encoder over stub frame embeddings, a decoder with causal self-attention
and cross-attention) against the JAX package, in f32 on the CPU, with
params drawn from JAX's defs (``np_init_tree``) through numpy:

  * ``encode`` and ``encdec_hidden``'s logits, on the kernel and the
    oracle paths, to max-abs <= 1e-5 x max |JAX|;
  * ``encdec_prefill`` (logits, the self and cross caches) and
    ``encdec_decode_step`` from JAX's caches on both sides;
  * ``encdec_prefill_ragged``: each row's logits equal the batch-1
    prefill at its exact length, and JAX's ragged prefill;
  * one train step: loss, grad norm and every trainable leaf's gradient
    (the AdamW first moment) against ``jax.grad``;
  * ``Engine.generate`` tokens against JAX's engine (the per-token loop),
    ``serve`` / ``run`` refused as in JAX, and the launcher's
    ``legacy-audio`` blob with the JAX launcher's keys.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import encdec as jencdec
from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
from repro.serving.engine import Engine as JEngine
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.core.params import (from_numpy_state, from_numpy_tree,
                                     leaves)
from repro_torch.launch import serve
from repro_torch.models import encdec
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.serving.engine import Engine, Request
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_model import jax_params, perturb_lora, port_cfg, t
from test_torch_model import (jax_trainer, keep_sigterm,  # noqa: F401
                              np_train_state)

ARCH = "whisper-base"
KERNEL = dict(attn_impl="pallas", ffn_impl="pallas")
ORACLE = dict(attn_impl="sparse_jnp", ffn_impl="grouped")
FRAMES = 12                             # the smoke config's frontend rows


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(**spt):
    cfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.float32)
    return cfg.with_spt(**spt) if spt else cfg


def _model(spt):
    jcfg = _jcfg(**spt)
    tree = jax_params(jcfg)
    return jcfg, tree, encdec.EncDecLM(port_cfg(jcfg),
                                       from_numpy_tree(tree, "cpu"),
                                       device="cpu")


def _rel_close(got, want, rel=1e-5):
    """max |got - want| <= rel x max |want|."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape
    scale = float(np.abs(w).max())
    assert float(np.abs(g - w).max()) <= rel * scale, (
        float(np.abs(g - w).max()), scale)


def _batch(rng, b, s):
    toks = rng.integers(0, 256, (b, s)).astype(np.int32)
    fe = rng.standard_normal((b, FRAMES, 64)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "frontend_embeds": jnp.asarray(fe)},
            {"tokens": t(toks, torch.long), "frontend_embeds": t(fe)})


@pytest.mark.parametrize("spt", [KERNEL, ORACLE], ids=["kernel", "oracle"])
def test_encode_and_hidden_match(spt):
    jcfg, tree, model = _model(spt)
    pcfg = model.cfg
    jb, tb = _batch(np.random.default_rng(0), 2, 10)
    je = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(
        tree, jb["frontend_embeds"])
    jh, _ = jax.jit(lambda p, b: jencdec.encdec_hidden(p, jcfg, b))(tree, jb)
    params = from_numpy_tree(tree, "cpu")
    with torch.no_grad():
        _rel_close(encdec.encode(model, pcfg, tb["frontend_embeds"]), je)
        th, aux = encdec.encdec_hidden(params, pcfg, tb)
    assert set(aux) == {"lb_loss", "dropped", "qerr"}
    from repro.models.transformer import logits_of as jlogits_of
    from repro_torch.models.transformer import logits_of
    _rel_close(logits_of(model, pcfg, th), jlogits_of(tree, jcfg, jh))


def _close_caches(got, want):
    for part in ("self", "cross"):
        assert set(got[part]) == set(want[part])
        for k, v in got[part].items():
            w = np.asarray(want[part][k])
            if k == "codes":     # plain PQ codes: equal up to near-ties
                assert float((v.numpy() == w).mean()) >= 0.99
            elif k == "slot_pos":
                np.testing.assert_array_equal(v.numpy(), w)
            else:
                _rel_close(v, w)


@pytest.mark.parametrize("spt", [KERNEL, ORACLE], ids=["kernel", "oracle"])
def test_prefill_and_decode_step_match(spt):
    jcfg, tree, model = _model(spt)
    pcfg = model.cfg
    jb, tb = _batch(np.random.default_rng(1), 2, 9)
    jc, jl = jax.jit(lambda p, b: jencdec.encdec_prefill(p, jcfg, b, 24))(
        tree, jb)
    tc, tl = encdec.encdec_prefill(model, pcfg, tb, 24)
    _rel_close(tl, jl)
    _close_caches(tc, jc)
    # one decode step from JAX's caches (its codes) on both sides
    tc = jax.tree_util.tree_map(lambda a: t(np.asarray(a)), jc)
    tok = np.asarray(jl[:, -1].argmax(-1), np.int32)
    jc2, jd = jax.jit(lambda p, c, k, q: jencdec.encdec_decode_step(
        p, jcfg, c, k, q))(tree, jc, jnp.asarray(tok), jnp.asarray(9))
    td = encdec.encdec_decode_step(model, pcfg, tc, t(tok, torch.long),
                                   torch.tensor(9))
    _rel_close(td, jd)
    _close_caches(tc, jc2)


def test_prefill_ragged_rows_match_batch1_and_jax():
    """JAX's ragged test mirrored (rows of 4, 9 and 6 decoder tokens over
    their own frames), held to the port's batch-1 prefill and to JAX's
    ragged prefill."""
    jcfg, tree, model = _model(KERNEL)
    pcfg = model.cfg
    rng = np.random.default_rng(13)
    frames = rng.standard_normal((3, FRAMES, 64)).astype(np.float32)
    lens = [4, 9, 6]
    toks = np.zeros((3, 9), np.int32)
    for i, ln in enumerate(lens):
        toks[i, :ln] = rng.integers(0, 256, ln)
    tc, tl = encdec.encdec_prefill_ragged(
        model, pcfg, {"tokens": t(toks, torch.long),
                      "frontend_embeds": t(frames)},
        t(np.asarray(lens, np.int32)), 24)
    jc, jl = jax.jit(lambda p, b, n: jencdec.encdec_prefill_ragged(
        p, jcfg, b, n, 24))(tree, {"tokens": jnp.asarray(toks),
                                   "frontend_embeds": jnp.asarray(frames)},
                            jnp.asarray(lens, jnp.int32))
    _rel_close(tl, jl)
    np.testing.assert_array_equal(tc["self"]["slot_pos"].numpy(),
                                  np.asarray(jc["self"]["slot_pos"]))
    for i, ln in enumerate(lens):
        _, l1 = encdec.encdec_prefill(
            model, pcfg, {"tokens": t(toks[i:i + 1, :ln], torch.long),
                          "frontend_embeds": t(frames[i:i + 1])}, 24)
        _rel_close(tl[i, -1], l1[0, -1])


def test_train_step_matches_jax():
    """One kernel-config step at 2 x 16 decoder tokens over 12 frames:
    loss, grad norm and every trainable leaf's gradient (the AdamW first
    moment), encoder and decoder leaves alike."""
    jcfg = _jcfg(**KERNEL)
    st = np_train_state(jcfg)
    st["train"] = perturb_lora(st["train"], np.random.default_rng(1))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (2, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32),
             "frontend_embeds": rng.standard_normal(
                 (2, FRAMES, 64)).astype(np.float32)}
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jtr = jax_trainer(jcfg, JOptimizerConfig(**ocfg),
                      JTrainerConfig(total_steps=1, log_interval=1), st)
    jm = jtr.run(iter([batch]))["metrics"][-1]
    tr = Trainer(port_cfg(jcfg), OptimizerConfig(**ocfg),
                 TrainerConfig(total_steps=1, log_interval=1),
                 state=from_numpy_state(st, "cpu"))
    m = tr.run(iter([batch]))["metrics"][-1]
    for k in ("loss", "lm_loss", "lb_loss", "grad_norm", "dropped"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jtr.state["opt"]["m"])[0]}
    got = dict(leaves(tr.state["opt"]["m"]))
    assert set(got) == set(want)
    assert {p[0] for p in got} == {"enc_blocks", "dec_blocks"}
    for path, g in got.items():
        g, w = g.numpy().ravel(), want[path].ravel()
        scale = float(np.abs(w).max())
        if scale == 0.0:
            assert float(np.abs(g).max()) == 0.0, path
            continue
        cos = float(g @ w) / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos >= 0.9999, (path, cos)
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, path


def test_generate_matches_jax_and_serve_is_refused():
    jcfg, tree, model = _model(KERNEL)
    jb, tb = _batch(np.random.default_rng(3), 3, 4)
    want = JEngine(jcfg, tree, max_len=32).generate(jb, 8).tokens
    eng = Engine(model.cfg, model, max_len=32, device="cpu")
    with torch.no_grad():
        got = eng.generate(tb, 8).tokens
    assert got == want
    with pytest.raises(NotImplementedError, match="audio"):
        eng.run([Request(uid=0, tokens=[1, 2], max_new_tokens=2)])


def test_launcher_blob_has_the_jax_keys(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "4", "--gen",
                       "5"]) == 0
    out = json.loads(capsys.readouterr().out)
    jax_keys = {"arch", "mode", "requests", "generated_tokens",
                "steady_wall_s", "tokens_per_s", "sample"}
    assert set(out) == jax_keys | {"device", "device_name"}
    assert out["mode"] == "legacy-audio"
    assert out["generated_tokens"] == 15 and len(out["sample"]) == 5


def test_input_specs_keep_the_frames_apart():
    cfg = port_cfg(jconfigs.get_config(ARCH))
    spec = shapes.input_specs(cfg, shapes.ShapeSpec("t", "train", 448, 4))
    assert spec["frontend_embeds"].shape == (4, 1500, 512)
    assert spec["tokens"].shape == spec["labels"].shape == (4, 448)
    gen = torch.Generator().manual_seed(0)
    got = shapes.materialize(
        shapes.input_specs(port_cfg(jconfigs.get_smoke(ARCH)),
                           configs.SHAPES_BY_NAME["decode_32k"], 2), gen, 256)
    assert got["token"].shape == (2,) and int(got["pos"]) == 0
