"""The training kernels at the JAX kernels' whole contract, on the CPU.

Kernels 1, 2, 4 and 9 take every input the JAX kernels compute (any
codebook (M, E, d'), any number of books and max_score >= M, any head
dim and code values, any LoRA rank, d and F).  Here, on the same numpy
inputs from a seed:

  * (i) each plain version against its JAX Pallas kernel (interpret
    mode) at the edge shapes chip_smoke.py's phase 30 gives the CUDA
    kernels, cut to a few rows: kernel 1's codes equal up to the 1e-5
    tie rule, kernel 2's [t, need] equal, kernels 4 and 9 in f32 within
    1e-5 (the tolerance of test_torch_train_kernels.py and
    test_torch_kernels.py);
  * (ii) each wrapper on meta tensors at those shapes builds nothing and
    returns its output's shape;
  * (iii) the kernel audit's contract sweep of full-width qwen3-0.6b at
    LoRA r 64 and E 256 and gemma-7b at d' 4 refuses nothing, and its
    recorded call shapes carry the new M, E and rank;
  * at decode with a 256-word codebook (a reference fact, not a contract
    change): the cache keeps codes as int8, so a query code >= 128
    matches no cached code in JAX's fused decode kernel and in the port's
    plain version alike;
  * (iv) one train step of the qwen3 smoke config (one layer) at LoRA r
    64, E 256 and d' 2 (M 8 books of a 16-wide head): loss and trainable
    gradients against ``jax.grad`` of the JAX step, f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import lora as jlora
from repro.core import params as JP
from repro.core import pq as jpq
from repro.core import routed_ffn as jrf
from repro.core import sparse_attention as jsa
from repro.kernels.pq_quantize.ops import pq_assign as jpq_assign
from repro.kernels.routed_ffn.routed_ffn import grouped_ffn_kernel
from repro.kernels.sparse_attention.ops import sparse_mha_decode
from repro.kernels.sparse_attention.sparse_attention import \
    sparse_attention_kernel
from repro.kernels.topl_select.topl_select import topl_thresholds_kernel
from repro.train import state as JS
from repro.train.loss import lm_cross_entropy as jlm_cross_entropy
from repro_torch import configs, kernels
from repro_torch.analysis import kernel_audit
from repro_torch.core.params import from_numpy_state, leaves
from repro_torch.kernels.pq_quantize import ops as pq_ops
from repro_torch.kernels.routed_ffn import ops as rffn_ops
from repro_torch.kernels.sparse_attention import ops as sa_ops
from repro_torch.kernels.topl_select import ops as topl_ops
from repro_torch.launch import steps
from test_torch_model import (close, np_init_tree, perturb_lora, port_cfg,
                              smoke_cfg, t)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ (i) kernel 1
@pytest.mark.parametrize("m,e,dp", [(16, 256, 8), (32, 256, 8), (2, 16, 64),
                                    (40, 32, 8)])
def test_pq_assign_plain_matches_jax_kernel_at_the_edges(m, e, dp):
    rng = np.random.default_rng(m + e + dp)
    x = rng.standard_normal((2, 16, m * dp)).astype(np.float32)
    cb = rng.standard_normal((m, e, dp)).astype(np.float32)
    want = np.asarray(jpq_assign(jnp.asarray(x), jnp.asarray(cb), tile_n=16,
                                 interpret=True))
    got = pq_ops.pq_assign(t(x), t(cb)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (2, 16, m)
    xs = x.reshape(2, 16, m, dp)
    dist = (cb * cb).sum(-1) - 2.0 * np.einsum("...md,med->...me", xs, cb)
    srt = np.sort(dist, axis=-1)
    tie = (srt[..., 1] - srt[..., 0]) < 1e-5
    assert np.array_equal(got[~tie], want[~tie])
    assert want.max() >= 16 if e > 16 else True     # codes past 4 bits


# ------------------------------------------------ (i) kernel 2
@pytest.mark.parametrize("m,kind,window", [(40, "e16", None),
                                           (64, "wide", 6)])
def test_topl_thresholds_plain_matches_jax_kernel_at_the_edges(m, kind,
                                                               window):
    rng = np.random.default_rng(m)
    b, hq, hk, n = 1, 2, 1, 16
    rep = hq // hk
    cq = rng.integers(0, 16, (b * hq, n, m)).astype(np.int32)
    ck = rng.integers(0, 16, (b * hk, n, m)).astype(np.int32)
    if kind == "wide":                        # negatives and past 2^16
        cq, ck = cq * 4099 - 20000, ck * 4099 - 20000
    want = topl_thresholds_kernel(
        jnp.asarray(cq), jnp.asarray(np.repeat(ck, rep, axis=0)), l=5,
        max_score=m, causal=True, window=window, q_offset=0, tile_q=8,
        tile_k=8, interpret=True)
    got = topl_ops.topl_thresholds(
        t(cq), t(ck), l=5, max_score=m, causal=True, window=window,
        heads_per_batch=hq, rep=rep)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------ (i) kernel 4
@pytest.mark.parametrize("dh,m,e,window", [
    (20, 5, 16, None), (20, 5, 16, 6),       # dh 20: M 5 books of d' 4
    (256, 64, 16, None),                     # 64 books
    (320, 40, 256, 6),                       # past 256, codes in [0, 256)
    (512, 32, 1024, None),                   # codes in [0, 1024)
])
def test_sparse_attention_plain_matches_jax_kernel_at_the_edges(dh, m, e,
                                                                window):
    rng = np.random.default_rng(dh + m)
    b, hq, hk, n = 1, 2, 1, 16
    r = hq // hk
    q = rng.standard_normal((b * hq, n, dh)).astype(np.float32)
    k = rng.standard_normal((b * hk, n, dh)).astype(np.float32)
    v = rng.standard_normal((b * hk, n, dh)).astype(np.float32)
    # few distinct codes a book, so scores spread over 0..M
    cq = rng.integers(0, 3, (b * hq, n, m)).astype(np.int32) * (e // 3)
    ck = rng.integers(0, 3, (b * hk, n, m)).astype(np.int32) * (e // 3)
    thr = np.asarray(topl_thresholds_kernel(
        jnp.asarray(cq), jnp.asarray(np.repeat(ck, r, axis=0)), l=5,
        max_score=m, causal=True, window=window, q_offset=0, tile_q=8,
        tile_k=8, interpret=True))
    want = sparse_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cq),
        jnp.asarray(ck), jnp.asarray(thr), scale=dh ** -0.5, causal=True,
        window=window, q_offset=0,
        kv_map=lambda g: (g // hq) * hk + (g % hq) // r, tile_q=8, tile_k=8,
        interpret=True)
    got = sa_ops.sparse_attention(
        t(q), t(k), t(v), t(cq), t(ck), t(thr), scale=dh ** -0.5,
        causal=True, window=window, heads_per_batch=hq, rep=r)
    close(got, want)


# ------------------------------------------------ (i) kernel 9
@pytest.mark.parametrize("d,f,rank", [(64, 48, 64), (64, 48, 128),
                                      (40, 54, 16)])
def test_grouped_ffn_plain_matches_jax_kernel_at_the_edges(d, f, rank):
    g, ga = 4, 2
    lcfg = jlora.LoRAConfig(rank=rank, alpha=float(rank), enabled=True)
    rcfg = jrf.RoutedFFNConfig(d_model=d, d_ff=f * g, num_groups=g,
                               active_groups=ga, capacity_factor=1.25,
                               activation="silu", gated=True)
    p = np_init_tree(jrf.param_defs(rcfg, lcfg), rank)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)
    p = perturb_lora(p, np.random.default_rng(rank))
    lora = {k: p[k] for k in ("lora_inner", "lora_gate", "lora_outer")}
    x = np.random.default_rng(d).standard_normal((2, 20, d)).astype(
        np.float32)
    choice, gate, _ = jrf.route(jnp.asarray(x), jnp.asarray(p["router"]),
                                rcfg, need_aux=False)
    plan = jdispatch.make_plan(choice, gate, g,
                               jdispatch.capacity(20, g, ga, 1.25))
    want = grouped_ffn_kernel(
        jnp.asarray(x), plan.index, jnp.asarray(p["w_inner"]),
        jnp.asarray(p["w_outer"]), jnp.asarray(p["w_gate"]),
        jax.tree_util.tree_map(jnp.asarray, lora), lcfg.scale, act="silu",
        tile_c=16, tile_f=16, interpret=True)
    got = rffn_ops.grouped_ffn(
        t(x), t(plan.index), t(p["w_inner"]), t(p["w_outer"]),
        t(p["w_gate"]), jax.tree_util.tree_map(t, lora), lcfg.scale,
        act="silu")
    ok = np.asarray(plan.slot_ok)[..., None]
    close(np.where(ok, got.numpy(), 0.0), np.where(ok, want, 0.0))


def test_split_lora_leaves_keep_the_function():
    """Past rank 32 the bf16 kernel takes each LoRA pair as bf16 halves
    of rank 3r: x b' c' equals x b c up to the dropped lo x lo term,
    far inside what one bf16 rounding of each leaf would cost."""
    from repro_torch.kernels.routed_ffn import ref
    d, f, g, r = 40, 24, 3, 40
    rng = np.random.default_rng(40)
    n = lambda *sh: t(rng.standard_normal(sh).astype(np.float32) * 0.05)
    lora = {"lora_inner": {"b": n(d, r), "c": n(g, r, f)},
            "lora_gate": {"b": n(d, r), "c": n(g, r, f)},
            "lora_outer": {"b": n(g, f, r), "c": n(r, d)}}
    lo, rk = rffn_ops._lora_leaves(lora, True, torch.bfloat16, 8)
    assert rk == rffn_ops.kernel_rank(r, torch.bfloat16) == 3 * 40
    assert all(x.dtype == torch.bfloat16 and x.data_ptr() % 16 == 0
               for x in lo)
    split = {k: {"b": lo[2 * i].float(), "c": lo[2 * i + 1].float()}
             for i, k in enumerate(rffn_ops._LORA_KEYS)}
    once = {k: {m: v.to(torch.bfloat16).float() for m, v in p.items()}
            for k, p in lora.items()}
    x = t(rng.standard_normal((2, 10, d)).astype(np.float32))
    wi, wg = (n(g, d, f) * 20 for _ in range(2))
    wo = n(g, f, d) * 20
    index = t(rng.integers(0, 11, (2, g, 8)).astype(np.int32))
    want, got, rounded = (ref.grouped_ffn_ref(x, index, wi, wo, wg, lp, 1.0,
                                              "silu")
                          for lp in (lora, split, once))
    err = float((got - want).abs().max())
    assert err < 1e-5 * float(want.abs().max())
    assert err < 0.05 * float((rounded - want).abs().max())


# ------------------------------------------------ (ii) the wrappers on meta
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["pq (16, 256, 8)", "pq (40, 32, 8)",
                                  "topl M 64", "topl M 96", "attn dh 20",
                                  "attn dh 512 M 64", "ffn r128",
                                  "ffn d1000 F54", "ffn f32 r160"])
def test_wrappers_take_the_new_shapes_on_meta(case):
    """Each wrapper, handed meta tensors at a new edge shape, takes the
    card's path, returns its output's shape and builds nothing."""
    i32, f32 = torch.int32, torch.float32
    kind, _, rest = case.partition(" ")
    if kind == "pq":
        m, e, dp = eval(rest)
        out = pq_ops.pq_assign(_meta(64, 1024, m * dp), _meta(m, e, dp,
                                                              dtype=f32))
        assert out.shape == (64, 1024, m) and out.dtype == i32
    elif kind == "topl":
        m = int(rest.split()[-1])
        out = topl_ops.topl_thresholds(
            _meta(64, 1024, m, dtype=i32), _meta(32, 1024, m, dtype=i32),
            l=128, max_score=m, heads_per_batch=16, rep=2)
        assert out.shape == (64, 1024, 2) and out.dtype == i32
    elif kind == "attn":
        dh, m = (20, 5) if rest == "dh 20" else (512, 64)
        out = sa_ops.sparse_attention(
            _meta(64, 512, dh), _meta(32, 512, dh), _meta(32, 512, dh),
            _meta(64, 512, m, dtype=i32), _meta(32, 512, m, dtype=i32),
            _meta(64, 512, 2, dtype=i32), scale=dh ** -0.5,
            heads_per_batch=16, rep=2)
        assert out.shape == (64, 512, dh) and out.dtype == torch.bfloat16
    else:
        d, f, r, dt = {"r128": (1024, 384, 128, torch.bfloat16),
                       "d1000 F54": (1000, 54, 16, torch.bfloat16),
                       "f32 r160": (1024, 384, 160, f32)}[rest]
        g, c = 8, 640
        lora = {"lora_inner": {"b": _meta(d, r, dtype=f32),
                               "c": _meta(g, r, f, dtype=f32)},
                "lora_gate": {"b": _meta(d, r, dtype=f32),
                              "c": _meta(g, r, f, dtype=f32)},
                "lora_outer": {"b": _meta(g, f, r, dtype=f32),
                               "c": _meta(r, d, dtype=f32)}}
        out = rffn_ops.grouped_ffn(
            _meta(4, 1024, d, dtype=dt), _meta(4, g, c, dtype=i32),
            _meta(g, d, f, dtype=dt), _meta(g, f, d, dtype=dt),
            _meta(g, d, f, dtype=dt), lora, 1.0, act="silu")
        assert out.shape == (4, g, c, d) and out.dtype == dt
    assert kernels._lib is None                  # nothing was built


# ------------------------------------------------ decode at E 256
def test_decode_at_256_codewords_matches_jax():
    """JAX keeps the cache's codes as int8 and widens them with sign
    extension, so at E = 256 a query code >= 128 matches no cached code;
    the port's plain decode (kernel 6's, which the card holds the kernel
    to) does the same."""
    b, hq, hk, s, d = 2, 4, 2, 40, 16
    r = hq // hk
    rng = np.random.default_rng(256)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    pcfg = jpq.PQConfig(head_dim=d, code_dim=8, num_codewords=256)
    cb = jnp.asarray(rng.standard_normal((2, 256, 8)).astype(np.float32))
    scfg = jsa.SparseAttentionConfig(pq=pcfg)
    codes = jpq.assign(jnp.asarray(k), cb).astype(jnp.int8)
    valid = np.ones((b, s), bool)
    want = sparse_mha_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             codes, cb, scfg, d ** -0.5, jnp.asarray(valid),
                             tile_k=8, interpret=True, fuse=True)
    cqg = np.asarray(jpq.assign(jnp.asarray(q), cb)).reshape(b * hk, r, 2)
    ckg = np.asarray(codes).reshape(b * hk, s, 2)
    assert (cqg >= 128).any() and (ckg < 0).any()
    out = sa_ops.fused_sparse_decode_attention(
        t(q.reshape(b * hk, r, d)), t(k.reshape(b * hk, s, d)),
        t(v.reshape(b * hk, s, d)), t(cqg), t(ckg), t(valid),
        scale=d ** -0.5, l=jsa.top_l(s, scfg), max_score=2, sum_rows=False,
        heads_per_batch=hk)
    close(out.reshape(b, hq, 1, d), want)


# ------------------------------------------------ (iii) the audit's sweep
def test_contract_sweep_takes_the_new_settings():
    """The sweep traces each config's forward under CONTRACT_SPT (LoRA r
    64, E 256, d' 4) beside its defaults."""
    seen = {}
    for name in ("qwen3-0.6b", "gemma-7b"):
        got, bad = kernel_audit.config_launches(name,
                                                configs.get_config(name))
        assert bad == [], bad
        assert kernel_audit.launch_violations(got) == []
        seen[name] = {(ln.kernel, ln.args, ln.where.split(" ", 1)[1])
                      for ln in got}
    q, g = seen["qwen3-0.6b"], seen["gemma-7b"]
    assert ("pq_assign", (2, 16, 256, 8), "prefill E256") in q
    rk = rffn_ops.kernel_rank(64, torch.bfloat16)      # 64 split: 192
    assert ("grouped_ffn", (2, 1024, 384, rk), "prefill lora r64") in q
    assert ("pq_assign", (2, 64, 16, 4), "prefill d'4") in g
    assert ("topl_thresholds", (4, 64), "prefill d'4") in g
    assert ("sparse_attention", (2, 256, 64), "prefill d'4") in g


# ------------------------------------------------ (iv) a train step
def test_train_step_at_rank_64_e_256_dp_2_matches_jax():
    jcfg = dataclasses.replace(smoke_cfg(
        attn_impl="pallas", ffn_impl="pallas",
        lora=jlora.LoRAConfig(rank=64, alpha=64.0, enabled=True),
        pq_codewords=256, pq_code_dim=2), vocab_size=200, num_layers=1)
    defs = JS.model_defs(jcfg)
    train, frozen = JP.partition(np_init_tree(defs, 0),
                                 JP.trainable_mask(defs))
    train = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   train)
    frozen = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    frozen)
    train = perturb_lora(train, np.random.default_rng(1))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 200, (2, 16)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jfrozen = jax.tree_util.tree_map(jnp.asarray, frozen)

    def loss_fn(tr):                     # the JAX train step's loss
        params = JP.combine(tr, jfrozen)
        hidden, aux = JS.model_hidden(params, jcfg, jb, remat=True)
        lm, _ = jlm_cross_entropy(params, jcfg, hidden, jb["labels"], 8)
        return lm + jcfg.spt.lb_loss_weight * aux["lb_loss"] / jcfg.num_layers

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, train))
    zeros = lambda a: np.zeros(a.shape, np.float32)       # noqa: E731
    state = from_numpy_state({
        "step": np.zeros((), np.int32), "train": train, "frozen": frozen,
        "opt": {"m": jax.tree_util.tree_map(zeros, train),
                "v": jax.tree_util.tree_map(zeros, train)}}, "cpu")
    got_loss, _, got = steps.loss_and_grads(
        state, port_cfg(jcfg), {k: torch.as_tensor(v)
                                for k, v in batch.items()}, 8)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    want = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
    pairs = list(leaves(got))
    assert {p for p, _ in pairs} == set(want)
    assert any(p[-1] == "b" for p, _ in pairs)
    for path, g in pairs:
        w = want[path]
        scale = float(np.abs(w).max())
        if path[-1] == "codebooks":      # argmin: zero on both sides
            assert scale == 0.0 and not g.any()
            continue
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=str(path))
