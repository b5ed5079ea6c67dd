"""The port's remaining oracles against the JAX package's, in f32 on the
CPU: every reference switch value now means the same thing in both.

  * ``sparse_mha_masked`` (``attn_impl="sparse_masked"``): equal to JAX's
    masked form and to the port's gather oracle (1e-5), and what
    ``attend`` runs for that switch value;
  * ``sparse_mha_decode_masked``: equal to JAX's and to the port's gather
    decode oracle, per query head and per kv group;
  * the routed FFN's dense oracle (``impl="dense"``,
    ``ffn_impl="dense"``): equal to JAX's, and to the grouped path where
    the capacity drops nothing;
  * PQ ``ema_update``: equal to JAX's, with and without given codes;
  * ``init_codebooks_from_data``: its contract (every codeword one of x's
    sub-vectors of its book, distinct rows when x has enough), and JAX's
    result when both draw the same rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pq as jpq
from repro.core import routed_ffn as jrf
from repro.core import sparse_attention as jsa
from repro.models import attention as jattention
from repro.models import ffn as jffn
from repro_torch.core import pq, routed_ffn
from repro_torch.core import sparse_attention as sa
from repro_torch.core.params import from_numpy_tree
from repro_torch.models import attention, ffn
from test_torch_model import (close, np_init_tree, perturb_lora, port_cfg,
                              smoke_cfg, t)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(n)


def _qkv(rng, b=2, hq=4, hk=2, nq=40, nk=40, d=16):
    q = rng.standard_normal((b, hq, nq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, nk, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, nk, d)).astype(np.float32)
    cb = rng.standard_normal((2, 16, 8)).astype(np.float32)
    return q, k, v, cb


def _sa_cfgs(**spt):
    jcfg = smoke_cfg(**spt)
    return jattention._sa_config(jcfg), attention._sa_config(port_cfg(jcfg))


# ------------------------------------------------------ sparse attention
@pytest.mark.parametrize("causal,window,q_offset,nq", [
    (True, None, 0, 40), (True, 12, 0, 40), (False, None, 0, 40),
    (True, None, 24, 16)])
def test_sparse_mha_masked_matches_jax_and_the_gather_oracle(
        causal, window, q_offset, nq):
    rng = np.random.default_rng(0)
    q, k, v, cb = _qkv(rng, nq=nq)
    jcfg, pcfg = _sa_cfgs(chunk_q=8)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want, waux = jsa.sparse_mha_masked(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(cb), jcfg,
                                       0.25, **kw)
    got, aux = sa.sparse_mha_masked(t(q), t(k), t(v), t(cb), pcfg, 0.25, **kw)
    close(got, want)
    assert aux["l"] == int(waux["l"])
    gather, _ = sa.sparse_mha(t(q), t(k), t(v), t(cb), pcfg, 0.25, **kw)
    close(got, gather)


@pytest.mark.parametrize("form", ["gather", "ragged", "masked", "dense"])
def test_short_last_query_chunk_matches_jax(form):
    """chunk_q 16 over 40 queries: the port runs chunks of 16, 16 and 8
    where JAX runs one chunk of 40; every row is the same (a 576-row
    frontend before a power-of-two prompt makes such lengths)."""
    rng = np.random.default_rng(5)
    q, k, v, cb = _qkv(rng)
    jcfg, pcfg = _sa_cfgs(chunk_q=16)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    targs = (t(q), t(k), t(v))
    if form == "dense":
        want = jsa.dense_attention(*jargs, 0.25, chunk_q=16)
        close(sa.dense_attention(*targs, 0.25, chunk_q=16), want)
        return
    kw = {}
    if form == "ragged":
        kw["seq_lengths"] = np.array([40, 23], np.int32)
    fn = "sparse_mha_masked" if form == "masked" else "sparse_mha"
    want, _ = getattr(jsa, fn)(*jargs, jnp.asarray(cb), jcfg, 0.25, **{
        k_: jnp.asarray(v_) for k_, v_ in kw.items()})
    got, _ = getattr(sa, fn)(*targs, t(cb), pcfg, 0.25, **{
        k_: t(v_) for k_, v_ in kw.items()})
    close(got, want)


def test_attend_runs_the_masked_oracle_for_sparse_masked(monkeypatch):
    jcfg = smoke_cfg(attn_impl="sparse_masked")
    cfg = port_cfg(jcfg)
    rng = np.random.default_rng(1)
    q, k, v, cb = _qkv(rng, nq=24, nk=24)
    p = {"pq": {"codebooks": t(cb)}}
    want, _ = jattention.attend({"pq": {"codebooks": jnp.asarray(cb)}}, jcfg,
                                jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), True, None)

    def no_gather(*a, **kw):
        raise AssertionError("sparse_masked ran the gather oracle")
    monkeypatch.setattr(sa, "sparse_mha", no_gather)
    got, aux = attention.attend(p, cfg, t(q), t(k), t(v), True, None)
    close(got, want)
    assert aux["l"] == sa.top_l(24, attention._sa_config(cfg))


@pytest.mark.parametrize("gran", ["qhead", "kvgroup"])
def test_sparse_mha_decode_masked_matches_jax_and_the_gather_oracle(gran):
    rng = np.random.default_rng(2)
    b, hq, hk, s, d = 3, 4, 2, 48, 16
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    kc = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    vc = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    cb = rng.standard_normal((2, 16, 8)).astype(np.float32)
    codes = rng.integers(0, 16, (b, hk, s, 2)).astype(np.int8)
    valid = np.arange(s)[None, :] < np.array([48, 20, 1])[:, None]
    jcfg, pcfg = _sa_cfgs(select_granularity=gran)
    want = jsa.sparse_mha_decode_masked(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(codes),
        jnp.asarray(cb), jcfg, 0.25, jnp.asarray(valid))
    args = (t(q), t(kc), t(vc), t(codes), t(cb), pcfg, 0.25, t(valid))
    got = sa.sparse_mha_decode_masked(*args)
    close(got, want)
    close(got, sa.sparse_mha_decode(*args))


# ------------------------------------------------------ routed FFN
def _rcfgs(gate_outputs, groups=8, active=4):
    kw = dict(d_model=64, d_ff=128, num_groups=groups, active_groups=active,
              capacity_factor=8.0, activation="silu", gated=True,
              gate_outputs=gate_outputs)
    return jrf.RoutedFFNConfig(**kw), routed_ffn.RoutedFFNConfig(**kw)


@pytest.mark.parametrize("gate_outputs", [False, True])
def test_routed_ffn_dense_oracle_matches_jax_and_grouped(gate_outputs):
    jc, pc = _rcfgs(gate_outputs)
    lc = smoke_cfg().spt.lora
    tree = np_init_tree(jrf.param_defs(jc, lc), 0)
    tree = perturb_lora(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), tree), np.random.default_rng(3))
    p = from_numpy_tree(tree, "cpu")
    x = np.random.default_rng(4).standard_normal((2, 12, 64)).astype(
        np.float32)
    want, waux = jrf.routed_ffn(jnp.asarray(x), tree, jc, lc, impl="dense")
    got, aux = routed_ffn.routed_ffn(t(x), p, pc, port_cfg(smoke_cfg()).spt.lora,
                                     impl="dense")
    close(got, want)
    close(aux["lb_loss"], waux["lb_loss"])
    assert float(aux["dropped"]) == float(waux["dropped"]) == 0.0
    grouped, gaux = routed_ffn.routed_ffn(
        t(x), p, pc, port_cfg(smoke_cfg()).spt.lora, impl="grouped")
    assert float(gaux["dropped"]) == 0.0            # capacity 8: no drops
    close(got, grouped)
    with pytest.raises(ValueError, match="unknown impl"):
        routed_ffn.routed_ffn(t(x), p, pc, port_cfg(smoke_cfg()).spt.lora,
                              impl="sparse")


def test_ffn_impl_dense_layer_matches_jax():
    jcfg = smoke_cfg(ffn_impl="dense")
    pcfg = port_cfg(jcfg)
    tree = np_init_tree(jffn.ffn_defs(jcfg), 5)
    tree = perturb_lora(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), tree), np.random.default_rng(6))
    x = np.random.default_rng(7).standard_normal((2, 10, 64)).astype(
        np.float32)
    for mode in ("train", "prefill"):
        want, waux = jffn.ffn_apply(tree, jnp.asarray(x), jcfg, mode=mode)
        got, aux = ffn.ffn_apply(
            from_numpy_tree(tree, "cpu", {"bfloat16": torch.float32}), t(x),
            pcfg, mode=mode)
        close(got, want)
        close(aux["lb_loss"], waux["lb_loss"])


# ------------------------------------------------------ PQ
@pytest.mark.parametrize("given_codes", [False, True])
def test_pq_ema_update_matches_jax(given_codes):
    rng = np.random.default_rng(8)
    cb = rng.standard_normal((2, 16, 8)).astype(np.float32)
    x = rng.standard_normal((3, 30, 16)).astype(np.float32)
    codes = (np.asarray(jpq.assign(jnp.asarray(x), jnp.asarray(cb)))
             if given_codes else None)
    want = jpq.ema_update(jnp.asarray(cb), jnp.asarray(x),
                          None if codes is None else jnp.asarray(codes),
                          ema=0.1)
    got = pq.ema_update(t(cb), t(x), None if codes is None else t(codes),
                        ema=0.1)
    close(got, want)
    unused = np.ones((2, 16), bool)                 # codewords nobody chose
    used = np.asarray(jpq.assign(jnp.asarray(x), jnp.asarray(cb))).reshape(
        -1, 2)
    for m in range(2):
        unused[m, np.unique(used[:, m])] = False
    assert unused.any()
    np.testing.assert_array_equal(got.numpy()[unused],
                                  (cb * 0.9 + 0.1 * cb)[unused])


def _pq_cfgs():
    jcfg = smoke_cfg()
    return jattention._pq_config(jcfg), attention._pq_config(port_cfg(jcfg))


@pytest.mark.parametrize("rows", [40, 10])
def test_init_codebooks_from_data_contract(rows):
    """(M, E, d') f32 codewords, each a sub-vector of x for its book;
    distinct rows (without replacement) when x has at least E of them."""
    _, pcfg = _pq_cfgs()
    x = torch.randn(rows, pcfg.head_dim, generator=torch.Generator()
                    .manual_seed(9))
    gen = torch.Generator().manual_seed(10)
    cb = pq.init_codebooks_from_data(x, pcfg, gen)
    m, e, dp = pcfg.num_books, pcfg.num_codewords, pcfg.code_dim
    assert cb.shape == (m, e, dp) and cb.dtype == torch.float32
    xs = x.reshape(-1, m, dp)
    for book in range(m):
        hit = (cb[book][:, None, :] == xs[None, :, book, :]).all(-1)
        assert bool(hit.any(-1).all())              # every codeword is a row
        rows_of = hit.float().argmax(-1)
        if rows >= e:
            assert len(set(rows_of.tolist())) == e
    again = pq.init_codebooks_from_data(x, pcfg, torch.Generator()
                                        .manual_seed(10))
    assert torch.equal(cb, again)                   # the generator fixes it


def test_init_codebooks_from_data_matches_jax_on_the_same_rows(monkeypatch):
    jcfg, pcfg = _pq_cfgs()
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 20, pcfg.head_dim)).astype(np.float32)
    idx = rng.permutation(60)[:pcfg.num_codewords]
    monkeypatch.setattr(jax.random, "choice",
                        lambda *a, **kw: jnp.asarray(idx))
    monkeypatch.setattr(pq, "_sample_rows",
                        lambda n, e, g: torch.as_tensor(idx))
    want = jpq.init_codebooks_from_data(jnp.asarray(x), jcfg,
                                        jax.random.PRNGKey(0))
    got = pq.init_codebooks_from_data(t(x), pcfg, torch.Generator())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
