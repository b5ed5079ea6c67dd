"""The port's train-path kernels against the JAX Pallas kernels they
replace (interpret mode on the CPU), on the same numpy inputs from a seed:

  * PQ assignment (kernel 1) — codes equal up to the margin rule: a code
    may differ only where the two nearest distances lie within 1e-5; at
    d_head 64, 80 and 128 with d' = 8, and d' = 5;
  * top-L thresholds (kernel 2) — [t, need] exactly equal, causal and
    windowed, q_offset != 0, nq != nk, GQA (the port indexes the kv head,
    JAX repeats the key codes per query head); M = 8, 10 and 16 books, and
    codes in [128, 256) and beyond 256;
  * the wrappers of kernels 1 and 2 take any codebook and any number of
    books, and refuse malformed input (max_score below M) before building;
  * thresholded sparse attention (kernel 4) — GQA, f32, atol=rtol 1e-5,
    at head dims 16, 64 and 80; its wrapper takes any dh (84 and 264
    shown on meta tensors) without building;
  * the ``sparse_mha`` and ``routed_ffn`` autograd Functions — outputs and
    gradients against ``jax.grad`` of the JAX custom_vjp ops, f32 to
    1e-5 (outputs) and 1e-4 (gradients: the backwards differentiate two
    references that sum in different orders).

On CPU tensors the port's wrappers take their plain versions; the CUDA
kernels are held to those on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lora as jlora
from repro.core import pq as jpq
from repro.core import routed_ffn as jrf
from repro.core import sparse_attention as jsa
from repro.kernels.pq_quantize.ops import pq_assign as jpq_assign
from repro.kernels.routed_ffn.ops import routed_ffn as jrouted_ffn
from repro.kernels.sparse_attention.ops import sparse_mha as jsparse_mha
from repro.kernels.sparse_attention.sparse_attention import \
    sparse_attention_kernel
from repro.kernels.topl_select.topl_select import topl_thresholds_kernel
from repro_torch import kernels
from repro_torch.core import lora
from repro_torch.core import pq
from repro_torch.core import routed_ffn as rf
from repro_torch.core import sparse_attention as sa
from repro_torch.kernels.pq_quantize import ops as pq_ops
from repro_torch.kernels.routed_ffn import ops as rffn_ops
from repro_torch.kernels.sparse_attention import ops as sa_ops
from repro_torch.kernels.topl_select import ops as topl_ops
from test_torch_model import close, np_init_tree, perturb_lora, t

GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread (the suite runs in several worker processes);
    autograd stays on, these tests take gradients."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ kernel 1: PQ assignment
@pytest.mark.parametrize("shape", [(2, 48, 32), (3, 40, 16)])
def test_pq_assign_plain_matches_jax_kernel(shape):
    rng = np.random.default_rng(shape[0])
    x = rng.standard_normal(shape).astype(np.float32)
    m = shape[-1] // 8
    cb = rng.standard_normal((m, 16, 8)).astype(np.float32)
    want = np.asarray(jpq_assign(jnp.asarray(x), jnp.asarray(cb), tile_n=16,
                                 interpret=True))
    got = pq_ops.pq_assign(t(x), t(cb)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    xs = x.reshape(*shape[:-1], m, 8)
    dist = (cb * cb).sum(-1) - 2.0 * np.einsum("...md,med->...me", xs, cb)
    srt = np.sort(dist, axis=-1)
    tie = (srt[..., 1] - srt[..., 0]) < 1e-5
    assert np.array_equal(got[~tie], want[~tie])


@pytest.mark.parametrize("dh,dp", [(64, 8), (80, 8), (128, 8), (40, 5)])
def test_pq_assign_plain_matches_jax_kernel_head_dims(dh, dp):
    """The paper's blocks' books (d_head 64 and 80 give M = 8 and 10 at
    d' = 8), qwen3's M = 16, and a d' = 5 codebook: codes equal up to the
    tie tolerance."""
    rng = np.random.default_rng(dh + dp)
    m = dh // dp
    x = rng.standard_normal((2, 24, dh)).astype(np.float32)
    cb = rng.standard_normal((m, 16, dp)).astype(np.float32)
    want = np.asarray(jpq_assign(jnp.asarray(x), jnp.asarray(cb), tile_n=8,
                                 interpret=True))
    got = pq_ops.pq_assign(t(x), t(cb)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (2, 24, m)
    xs = x.reshape(2, 24, m, dp)
    dist = (cb * cb).sum(-1) - 2.0 * np.einsum("...md,med->...me", xs, cb)
    srt = np.sort(dist, axis=-1)
    tie = (srt[..., 1] - srt[..., 0]) < 1e-5
    assert np.array_equal(got[~tie], want[~tie])


def _codes(rng, g, n, m=4, e=4):
    """Few books over few codewords: many equal scores, so the tie budget
    is exercised."""
    return rng.integers(0, e, (g, n, m)).astype(np.int32)


# ------------------------------------------------ kernel 2: thresholds
@pytest.mark.parametrize("nq,nk,causal,window,q_offset,rep", [
    (32, 32, True, None, 0, 2),
    (24, 56, True, 16, 32, 2),       # windowed, ragged offset, nq != nk
    (16, 40, False, None, 0, 1),
    (40, 64, True, None, 24, 4),
])
def test_topl_thresholds_plain_matches_jax_kernel(nq, nk, causal, window,
                                                  q_offset, rep):
    rng = np.random.default_rng(nq + nk)
    b, hq = 2, 4
    cq = _codes(rng, b * hq, nq)
    ck = _codes(rng, b * hq // rep, nk)
    l = jsa.top_l(nk, jsa.SparseAttentionConfig(
        pq=jpq.PQConfig(head_dim=32), top_fraction=0.25, min_l=4), window)
    ck_rep = np.repeat(ck.reshape(b, hq // rep, nk, 4), rep,
                       axis=1).reshape(b * hq, nk, 4)
    want = topl_thresholds_kernel(
        jnp.asarray(cq), jnp.asarray(ck_rep), l=l, max_score=4,
        causal=causal, window=window, q_offset=q_offset, tile_q=8, tile_k=8,
        interpret=True)
    got = topl_ops.topl_thresholds(
        t(cq), t(ck), l=l, max_score=4, causal=causal, window=window,
        q_offset=q_offset, heads_per_batch=hq, rep=rep)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,lo,hi", [
    (8, 0, 16), (10, 0, 16), (16, 0, 16),   # E = 16: the nibble-packed range
    (4, 128, 256),                          # byte codes with the top bit set
    (4, 0, 300),                            # codes >= 256: int32 compares
])
def test_topl_thresholds_plain_matches_jax_kernel_books(m, lo, hi):
    """[t, need] exactly equal at the paper's blocks' book counts (M = 8,
    10) and qwen3's (16) over E = 16 codewords, and for codes beyond the
    packed ranges the kernel chooses its body by: any int32 codes."""
    rng = np.random.default_rng(m + hi)
    b, hq, rep, nq, nk, window = 2, 4, 2, 24, 40, 16
    cq = rng.integers(lo, hi, (b * hq, nq, m)).astype(np.int32)
    ck = rng.integers(lo, hi, (b * hq // rep, nk, m)).astype(np.int32)
    ck_rep = np.repeat(ck.reshape(b, hq // rep, nk, m), rep,
                       axis=1).reshape(b * hq, nk, m)
    for causal, win, q_offset in ((True, None, 16), (True, window, 16),
                                  (False, None, 0)):
        want = topl_thresholds_kernel(
            jnp.asarray(cq), jnp.asarray(ck_rep), l=6, max_score=m,
            causal=causal, window=win, q_offset=q_offset, tile_q=8,
            tile_k=8, interpret=True)
        got = topl_ops.topl_thresholds(
            t(cq), t(ck), l=6, max_score=m, causal=causal, window=win,
            q_offset=q_offset, heads_per_batch=hq, rep=rep)
        assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------ kernels 1, 2: contracts
def _i32(*shape):
    return torch.empty(*shape, dtype=torch.int32, device="meta")


@pytest.mark.parametrize("m,max_score,ok", [
    (16, 16, True), (32, 32, True), (10, 32, True),
    (33, 33, True),                     # past 32 books: packed in chunks
    (16, 33, True),                     # max_score past M: empty buckets
    (16, 15, False),                    # scores above max_score
])
def test_topl_thresholds_contract(m, max_score, ok):
    """Kernel 2's wrapper takes any number of books and any max_score >=
    M, and refuses malformed input, before anything is built or launched
    (meta tensors stand in for CUDA ones)."""
    args = (_i32(8, 64, m), _i32(4, 64, m))
    kw = dict(l=8, max_score=max_score, heads_per_batch=4, rep=2)
    before = topl_ops.topl_thresholds.launches
    if ok:
        topl_ops.check_topl_args(*args, q_offset=0, **kw)
        assert topl_ops.topl_thresholds(*args, **kw).shape == (8, 64, 2)
    else:
        with pytest.raises(ValueError, match="books"):
            topl_ops.topl_thresholds(*args, **kw)
    assert topl_ops.topl_thresholds.launches == before
    assert kernels._lib is None                  # nothing was built


@pytest.mark.parametrize("m,e,dp", [
    (16, 16, 8), (8, 64, 8), (32, 32, 8),
    (2, 4, 33),                         # d' > 32
    (64, 16, 9),                        # M E d' > 8192 floats
    (128, 16, 1),                       # M E > 1024 codewords
])
def test_pq_assign_contract(m, e, dp):
    """Kernel 1's wrapper takes any codebook (M, E, d'), as the JAX kernel
    does: the general body stages it in E-tiles.  On meta tensors it
    returns the codes' shape before anything is built or launched."""
    x = _meta(4, 64, m * dp)
    cb = _meta(m, e, dp, dtype=torch.float32)
    before = pq_ops.pq_assign.launches
    pq_ops.check_pq_args(x, cb)
    codes = pq_ops.pq_assign(x, cb)
    assert codes.shape == (4, 64, m) and codes.dtype == torch.int32
    assert pq_ops.pq_assign.launches == before
    assert kernels._lib is None                  # nothing was built


# ------------------------------------------------ kernel 4: attention
@pytest.mark.parametrize("dh", [16, 64, 80])
@pytest.mark.parametrize("window,q_offset", [(None, 0), (12, 16)])
def test_sparse_attention_plain_matches_jax_kernel(window, q_offset, dh):
    rng = np.random.default_rng(7 + q_offset)
    b, hq, hk, nq, nk = 2, 4, 2, 24, 40
    r = hq // hk
    q = rng.standard_normal((b * hq, nq, dh)).astype(np.float32)
    k = rng.standard_normal((b * hk, nk, dh)).astype(np.float32)
    v = rng.standard_normal((b * hk, nk, dh)).astype(np.float32)
    cq, ck = _codes(rng, b * hq, nq), _codes(rng, b * hk, nk)
    ck_rep = np.repeat(ck.reshape(b, hk, nk, 4), r,
                       axis=1).reshape(b * hq, nk, 4)
    thr = np.asarray(topl_thresholds_kernel(
        jnp.asarray(cq), jnp.asarray(ck_rep), l=10, max_score=4, causal=True,
        window=window, q_offset=q_offset, interpret=True))
    want = sparse_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cq),
        jnp.asarray(ck), jnp.asarray(thr), scale=dh ** -0.5, causal=True,
        window=window, q_offset=q_offset,
        kv_map=lambda g: (g // hq) * hk + (g % hq) // r, tile_q=8, tile_k=8,
        interpret=True)
    got = sa_ops.sparse_attention(
        t(q), t(k), t(v), t(cq), t(ck), t(thr), scale=dh ** -0.5,
        causal=True, window=window, q_offset=q_offset, heads_per_batch=hq,
        rep=r)
    close(got, want)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dh", [80, 72, 256, 84, 264])
def test_sparse_attention_head_dim_contract(dh):
    """Kernel 4 takes any dh, as the JAX kernel does (84 and 264 run its
    any-shape body); on meta tensors (they take the kernel path without a
    card) it returns the output's shape before anything is built or
    launched."""
    g, gk, n, m = 8, 4, 64, 16
    i32 = torch.int32
    args = (_meta(g, n, dh), _meta(gk, n, dh), _meta(gk, n, dh),
            _meta(g, n, m, dtype=i32), _meta(gk, n, m, dtype=i32),
            _meta(g, n, 2, dtype=i32))
    before = sa_ops.sparse_attention.launches
    sa_ops.check_sparse_attention_args(*args, heads_per_batch=4, rep=2)
    out = sa_ops.sparse_attention(*args, scale=1.0, heads_per_batch=4, rep=2)
    assert out.shape == (g, n, dh) and out.dtype == torch.bfloat16
    assert sa_ops.sparse_attention.launches == before
    assert kernels._lib is None                  # nothing was built


# ------------------------------------------------ sparse_mha Function
def _sa_setup(gran, seed):
    rng = np.random.default_rng(seed)
    b, hq, hk, n, d = 1, 4, 2, 32, 16
    q = rng.standard_normal((b, hq, n, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, n, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, n, d)).astype(np.float32)
    cb = rng.standard_normal((2, 16, 8)).astype(np.float32)
    wts = rng.standard_normal((b, hq, n, d)).astype(np.float32)
    jcfg = jsa.SparseAttentionConfig(pq=jpq.PQConfig(head_dim=d),
                                     top_fraction=0.25, min_l=4, chunk_q=16,
                                     select_granularity=gran)
    pcfg = sa.SparseAttentionConfig(pq=pq.PQConfig(head_dim=d),
                                    top_fraction=0.25, min_l=4, chunk_q=16,
                                    select_granularity=gran)
    return (q, k, v, cb, wts), jcfg, pcfg


@pytest.mark.parametrize("gran", ["qhead", "kvgroup"])
def test_sparse_mha_function_matches_jax_grad(gran):
    (q, k, v, cb, wts), jcfg, pcfg = _sa_setup(gran, 3)
    scale = 16 ** -0.5

    def jloss(q, k, v, cb):
        out, _ = jsparse_mha(q, k, v, cb, jcfg, scale, interpret=True)
        return jnp.sum(out * wts), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v, cb)))
    leaves = [t(a).requires_grad_() for a in (q, k, v, cb)]
    out, aux = sa_ops.sparse_mha(*leaves, pcfg, scale)
    (out * t(wts)).sum().backward()
    assert aux["l"] == jsa.top_l(32, jcfg)
    close(out.detach(), jout)
    for got, want in zip(leaves[:3], jgrads[:3]):
        close(got.grad, want, GRAD_TOL)
    # argmin has no derivative: zeros on both sides (not None in the port)
    assert not leaves[3].grad.any() and not np.asarray(jgrads[3]).any()


def test_sparse_mha_function_qerr_aux_matches_jax():
    (q, k, v, cb, _), jcfg, pcfg = _sa_setup("qhead", 4)
    jcfg = jsa.SparseAttentionConfig(**{**jcfg.__dict__,
                                        "qerr_loss_weight": 0.1})
    pcfg = sa.SparseAttentionConfig(**{**pcfg.__dict__,
                                       "qerr_loss_weight": 0.1})
    _, jaux = jsparse_mha(*(jnp.asarray(a) for a in (q, k, v, cb)), jcfg,
                          0.25, interpret=True)
    cbt = t(cb).requires_grad_()
    _, aux = sa_ops.sparse_mha(t(q), t(k), t(v), cbt, pcfg, 0.25)
    close(aux["qerr"].detach(), jaux["qerr"])
    aux["qerr"].backward()
    jg = jax.grad(lambda c: jsparse_mha(
        *(jnp.asarray(a) for a in (q, k, v)), c, jcfg, 0.25,
        interpret=True)[1]["qerr"])(jnp.asarray(cb))
    close(cbt.grad, jg, GRAD_TOL)


# ------------------------------------------------ routed_ffn Function
def _torch_tree(tree, grad_keys=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _torch_tree(v, grad_keys)
        else:
            out[k] = t(v).requires_grad_(k in grad_keys or
                                         not k.startswith("w_"))
    return out


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
def test_routed_ffn_function_matches_jax_grad(gated, act):
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0)
    jcfg = jrf.RoutedFFNConfig(d_model=32, d_ff=96, num_groups=4,
                               active_groups=2, capacity_factor=0.5,
                               activation=act, gated=gated)
    pcfg = rf.RoutedFFNConfig(**jcfg.__dict__)
    plcfg = lora.LoRAConfig(**lcfg.__dict__)
    p = np_init_tree(jrf.param_defs(jcfg, lcfg), 1)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)
    p = perturb_lora(p, np.random.default_rng(2))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    wts = rng.standard_normal((2, 20, 32)).astype(np.float32)

    def jloss(x, p):
        out, aux = jrouted_ffn(x, p, jcfg, lcfg, interpret=True)
        return jnp.sum(out * wts) + 0.5 * aux["lb_loss"], (out, aux)

    (_, (jout, jaux)), (jgx, jgp) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p))
    assert float(jaux["dropped"]) > 0.0                 # capacity drops
    xt = t(x).requires_grad_()
    pt = _torch_tree(p)
    out, aux = rffn_ops.routed_ffn(xt, pt, pcfg, plcfg)
    ((out * t(wts)).sum() + 0.5 * aux["lb_loss"]).backward()
    close(out.detach(), jout)
    close(aux["lb_loss"].detach(), jaux["lb_loss"])
    close(aux["dropped"], jaux["dropped"])
    assert not aux["dropped"].requires_grad
    close(xt.grad, jgx, GRAD_TOL)

    def check(tree, jtree):
        for k, v in tree.items():
            if isinstance(v, dict):
                check(v, jtree[k])
            elif v.requires_grad:
                close(v.grad, jtree[k], GRAD_TOL)
            else:
                assert v.grad is None                    # frozen weights
    check(pt, jgp)


def test_routed_ffn_ragged_path_is_forward_only():
    lcfg = lora.LoRAConfig(rank=4, alpha=8.0)
    cfg = rf.RoutedFFNConfig(d_model=16, d_ff=32, num_groups=4,
                             active_groups=2)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.core.params import init_tree
    p = init_tree(rf.param_defs(cfg, lcfg), gen)
    x = torch.randn(2, 8, 16, generator=gen, requires_grad=True)
    lens = torch.tensor([8, 5])
    with pytest.raises(RuntimeError, match="forward-only"):
        rffn_ops.routed_ffn(x, p, cfg, lcfg, seq_lengths=lens)
    with torch.no_grad():
        out, _ = rffn_ops.routed_ffn(x, p, cfg, lcfg, seq_lengths=lens)
    want, _ = rf.routed_ffn(x.detach(), p, cfg, lcfg, seq_lengths=lens)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
