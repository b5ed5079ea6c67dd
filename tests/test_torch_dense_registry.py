"""The dense configs of the registry that no other test runs end to end —
gemma-7b (GeGLU, head_dim 256 at full width, tied embeddings scaled by
sqrt(d_model)) and the two h2o-danube configs (sliding window) — and the
routed FFN's ``grouped_shmap`` switch, against the JAX package in f32 on
their smoke configs, params drawn from JAX's defs (``np_init_tree``):

  * ``lm_prefill_ragged`` logits of a right-padded batch, then one
    ``lm_decode_step`` from the same caches, on the kernel path and on
    the oracle path, to atol 1e-5 (a scratch run saw 5e-7 for gemma and
    3e-6 for danube); the embedding scale is checked on its own;
  * ``ffn_impl="grouped_shmap"`` on the 2-layer qwen3 smoke config gives
    JAX's ragged-prefill logits (without a mesh both packages run the
    grouped path), to atol 1e-5;
  * the serve launcher takes ``--ffn-impl dense``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch.launch import serve
from repro_torch.models import layers, transformer
from test_torch_model import jax_params, port_model, smoke_cfg, t

ATOL = 1e-5
ARCHS = ("gemma-7b", "h2o-danube-1.8b", "h2o-danube-3-4b")
KERNEL = dict(attn_impl="pallas", ffn_impl="pallas")
ORACLE = dict(attn_impl="sparse_jnp", ffn_impl="grouped")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prefill_batch(s=24):
    rng = np.random.default_rng(12)
    lens = np.array([s, s // 3, s - 5], np.int32)
    toks = np.zeros((3, s), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, 256, n)
    return toks, lens


def _logits_match(jcfg, max_len=48):
    """Ragged-prefill then decode logits of both packages, atol 1e-5."""
    tree = jax_params(jcfg)
    model = port_model(jcfg, tree)
    toks, lens = _prefill_batch()
    jc, jl = jax.jit(lambda p, b, n: jtransformer.lm_prefill_ragged(
        p, jcfg, b, n, max_len))(tree, {"tokens": jnp.asarray(toks)},
                                 jnp.asarray(lens))
    with torch.no_grad():
        tc, tl = transformer.lm_prefill_ragged(
            model, model.cfg, {"tokens": t(toks, torch.long)}, t(lens),
            max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    # one decode step from JAX's caches (its PQ codes) on both sides
    tc = jax.tree_util.tree_map(lambda a: t(np.asarray(a)), jc)
    tok = np.asarray(jl[:, -1].argmax(-1), np.int32)
    _, jd = jax.jit(lambda p, c, k, q: jtransformer.lm_decode_step(
        p, jcfg, c, k, q))(tree, jc, jnp.asarray(tok), jnp.asarray(lens))
    with torch.no_grad():
        td = transformer.lm_decode_step(model, model.cfg, tc,
                                        t(tok, torch.long), t(lens))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spt", [KERNEL, ORACLE], ids=["kernel", "oracle"])
def test_prefill_and_decode_logits_match_jax(arch, spt):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               dtype=jnp.float32).with_spt(**spt)
    _logits_match(jcfg)


def test_scaled_embedding_matches_jax():
    """gemma's embedding rows times sqrt(d_model), in the table's dtype."""
    rng = np.random.default_rng(13)
    table = rng.standard_normal((32, 64)).astype(np.float32)
    toks = rng.integers(0, 32, (2, 5)).astype(np.int32)
    for scale in (False, True):
        want = jlayers.embed_lookup({"embedding": jnp.asarray(table)},
                                    jnp.asarray(toks), scale, 64)
        got = layers.embed_lookup({"embedding": t(table)},
                                  t(toks, torch.long), scale, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_grouped_shmap_gives_jax_logits():
    """Without a mesh JAX's ``grouped_shmap`` runs the grouped path; so
    does the port's, where it used to raise."""
    _logits_match(smoke_cfg(ffn_impl="grouped_shmap"), max_len=32)


def test_serve_launcher_takes_the_dense_ffn(capsys):
    assert serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "12", "--gen", "4",
                       "--slots", "2", "--ffn-impl", "dense"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["completed"] == 3 and out["decode_tokens"] > 0
