"""The port's plain versions of the four decode kernels of the paged and
two-pass serving paths against the JAX Pallas kernels they replace
(interpret mode on the CPU), in f32:

  * kernel 3, decode thresholds — [t, need] exactly equal;
  * kernel 5, two-pass decode attention from given [t, need] — 1e-5, and
    the two-pass tier (kernels 3 then 5) equal to the fused one (kernel
    6), for "qhead" and "kvgroup";
  * kernel 7, fused sparse decode through a page table — [t, need]
    exactly equal to JAX's over the gathered view, output 1e-5 — and bit
    for bit equal to kernel 6's plain version over gathered views;
  * kernel 8, dense decode through a page table — 1e-5.
The paged cases use a shuffled page table with -1 holes over a pool
larger than the view, at page/tile sizes (8, 8), (16, 16) and (16, 8)
(the tile is the JAX kernel's; the port's kernels do not tile by page).
Both sides get the same PQ codes.  The CUDA kernels are held to these
plain versions on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pq as jpq
from repro.core import sparse_attention as jsa
from repro.kernels.sparse_attention.sparse_attention import (
    dense_decode_attention_paged_kernel, fused_sparse_decode_attention_kernel,
    fused_sparse_decode_attention_paged_kernel,
    sparse_decode_attention_kernel)
from repro.kernels.topl_select.topl_select import \
    decode_topl_thresholds_kernel
from repro.serving import kv_pages as jkvp
from repro_torch.core import pq
from repro_torch.core import sparse_attention as sa
from repro_torch.kernels.sparse_attention import ops as sa_ops
from repro_torch.kernels.topl_select import ops as topl_ops
from repro_torch.serving import kv_pages
from test_torch_model import close, one_torch_thread, t  # noqa: F401

D, M, E = 16, 2, 16                       # head dim, PQ books, codewords


def _groups(gran, hq, hk):
    r = hq // hk
    sum_rows = gran == "kvgroup"
    return r, sum_rows, M * (r if sum_rows else 1)


def _contig_case(gran, hq, hk, seed):
    """B=3 slots over S=72 cache slots (no tile multiple): ragged
    validity with an all-invalid row; codes from JAX's assignment."""
    b, s = 3, 72
    r, sum_rows, max_score = _groups(gran, hq, hk)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b * hk, r, D)).astype(np.float32)
    k = rng.standard_normal((b * hk, s, D)).astype(np.float32)
    v = rng.standard_normal((b * hk, s, D)).astype(np.float32)
    cb = jnp.asarray(rng.standard_normal((M, E, D // M)).astype(np.float32))
    cq = np.asarray(jpq.assign(jnp.asarray(q), cb), np.int32)
    ck = np.asarray(jpq.assign(jnp.asarray(k), cb), np.int32)
    valid = np.arange(s)[None, :] < np.array([72, 41, 0])[:, None]
    scfg = jsa.SparseAttentionConfig(
        pq=jpq.PQConfig(head_dim=D, code_dim=D // M, num_codewords=E),
        select_granularity=gran)
    kw = dict(l=jsa.top_l(s, scfg), max_score=max_score, sum_rows=sum_rows,
              heads_per_batch=hk)
    return q, k, v, cq, ck, valid, kw


def _port(q, k, v, cq, ck, valid):
    return (t(q), t(k), t(v), t(cq), t(ck.astype(np.int8)), t(valid))


@pytest.mark.parametrize("gran", ["qhead", "kvgroup"])
@pytest.mark.parametrize("hq,hk", [(2, 2), (4, 2), (4, 1)])
def test_decode_thresholds_plain_matches_jax_kernel(gran, hq, hk):
    q, k, v, cq, ck, valid, kw = _contig_case(gran, hq, hk, hq * 10 + hk)
    want = decode_topl_thresholds_kernel(
        jnp.asarray(cq), jnp.asarray(ck), jnp.asarray(valid, jnp.int32),
        tile_k=24, interpret=True, **kw)
    _, _, _, pcq, pck, pvalid = _port(q, k, v, cq, ck, valid)
    got = topl_ops.decode_topl_thresholds(pcq, pck, pvalid, **kw)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gran", ["qhead", "kvgroup"])
def test_two_pass_plain_matches_jax_and_equals_fused(gran):
    q, k, v, cq, ck, valid, kw = _contig_case(gran, 4, 2, 7)
    scale = D ** -0.5
    hk = kw["heads_per_batch"]
    thr = decode_topl_thresholds_kernel(
        jnp.asarray(cq), jnp.asarray(ck), jnp.asarray(valid, jnp.int32),
        tile_k=24, interpret=True, **kw)
    want = sparse_decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cq),
        jnp.asarray(ck), thr, jnp.asarray(valid, jnp.int32), scale=scale,
        sum_rows=kw["sum_rows"], heads_per_batch=hk, tile_k=24,
        interpret=True)
    want_fused = fused_sparse_decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cq),
        jnp.asarray(ck), jnp.asarray(valid, jnp.int32), scale=scale,
        tile_k=24, interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(want_fused))
    pq_, pk, pv, pcq, pck, pvalid = _port(q, k, v, cq, ck, valid)
    got = sa_ops.sparse_decode_attention(
        pq_, pk, pv, pcq, pck, t(np.asarray(thr)), pvalid, scale=scale,
        sum_rows=kw["sum_rows"], heads_per_batch=hk)
    close(got, want)
    assert not got.reshape(3, hk, -1, D)[2].any()       # nothing selected
    # the port's two tiers: kernels 3 + 5 == kernel 6, bit for bit
    thr_p = topl_ops.decode_topl_thresholds(pcq, pck, pvalid, **kw)
    two = sa_ops.sparse_decode_attention(
        pq_, pk, pv, pcq, pck, thr_p, pvalid, scale=scale,
        sum_rows=kw["sum_rows"], heads_per_batch=hk)
    fused, thr_f = sa_ops.fused_sparse_decode_attention(
        pq_, pk, pv, pcq, pck, pvalid, scale=scale, return_thresholds=True,
        **kw)
    assert torch.equal(thr_p, thr_f)
    assert torch.equal(two, fused)


@pytest.mark.parametrize("gran", ["qhead", "kvgroup"])
def test_sparse_mha_decode_two_pass_equals_fused(gran):
    """The op the model calls: fuse=False (kernels 3, 5) and fuse=True
    (kernel 6) give the same output from the same cache."""
    rng = np.random.default_rng(11)
    b, hq, hk, s = 2, 4, 2, 40
    q = t(rng.standard_normal((b, hq, 1, D)).astype(np.float32))
    k = t(rng.standard_normal((b, hk, s, D)).astype(np.float32))
    v = t(rng.standard_normal((b, hk, s, D)).astype(np.float32))
    cb = t(rng.standard_normal((M, E, D // M)).astype(np.float32))
    codes = t(rng.integers(0, E, (b, hk, s, M)).astype(np.int8))
    valid = torch.arange(s)[None, :] < torch.tensor([40, 23])[:, None]
    scfg = sa.SparseAttentionConfig(
        pq=pq.PQConfig(head_dim=D, code_dim=D // M, num_codewords=E),
        select_granularity=gran)
    args = (q, k, v, codes, cb, scfg, D ** -0.5, valid)
    assert torch.equal(sa_ops.sparse_mha_decode(*args, fuse=False),
                       sa_ops.sparse_mha_decode(*args, fuse=True))


# ------------------------------------------------------------ paged
POOL, MP, B, HQ, HK = 9, 3, 2, 4, 2


def _paged_case(ps, seed):
    """A pool of 9 pages (more than the 2 x 3 the view addresses), a
    shuffled page table with -1 holes, validity = positions below each
    slot's length AND page occupancy; codes from JAX's assignment."""
    rng = np.random.default_rng(seed)
    r = HQ // HK
    q = rng.standard_normal((B * HK, r, D)).astype(np.float32)
    k_pool = rng.standard_normal((POOL, HK, ps, D)).astype(np.float32)
    v_pool = rng.standard_normal((POOL, HK, ps, D)).astype(np.float32)
    cb = jnp.asarray(rng.standard_normal((M, E, D // M)).astype(np.float32))
    cq = np.asarray(jpq.assign(jnp.asarray(q), cb), np.int32)
    codes_pool = np.asarray(jpq.assign(jnp.asarray(k_pool), cb), np.int8)
    ids = rng.permutation(POOL)[:B * MP].reshape(B, MP).astype(np.int32)
    ids[0, 2] = -1                                       # holes
    ids[1, 1:] = -1
    pos = np.array([2 * ps + 3, ps - 2])
    view = MP * ps
    valid = ((np.arange(view)[None, :] < pos[:, None])
             & np.asarray(jkvp.occupancy(jnp.asarray(ids), ps)))
    return q, k_pool, v_pool, cq, codes_pool, ids, valid


PAGE_TILES = [(8, 8), (16, 16), (16, 8)]


@pytest.mark.parametrize("gran", ["qhead", "kvgroup"])
@pytest.mark.parametrize("ps,tile", PAGE_TILES)
def test_paged_sparse_plain_matches_jax_kernel(ps, tile, gran):
    q, k_pool, v_pool, cq, codes_pool, ids, valid = _paged_case(ps, ps + tile)
    r, sum_rows, max_score = _groups(gran, HQ, HK)
    view = MP * ps
    scfg = jsa.SparseAttentionConfig(
        pq=jpq.PQConfig(head_dim=D, code_dim=D // M, num_codewords=E),
        top_fraction=0.25, min_l=4, select_granularity=gran)
    kw = dict(scale=D ** -0.5, l=jsa.top_l(view, scfg), max_score=max_score,
              sum_rows=sum_rows, heads_per_batch=HK)
    pt = jnp.asarray(ids)
    want = fused_sparse_decode_attention_paged_kernel(
        jnp.maximum(pt, 0), jnp.asarray(q), jnp.asarray(k_pool),
        jnp.asarray(v_pool), jnp.asarray(cq), jnp.asarray(codes_pool),
        jnp.asarray(valid, jnp.int32), tile_k=tile, interpret=True, **kw)
    ck_view = np.asarray(jkvp.gather_pages(jnp.asarray(codes_pool), pt))
    thr_want = decode_topl_thresholds_kernel(
        jnp.asarray(cq), jnp.asarray(ck_view.reshape(B * HK, view, M),
                                     jnp.int32),
        jnp.asarray(valid, jnp.int32), l=kw["l"], max_score=max_score,
        sum_rows=sum_rows, heads_per_batch=HK, tile_k=tile, interpret=True)
    args = (t(ids), t(q), t(k_pool), t(v_pool), t(cq), t(codes_pool),
            t(valid))
    got, thr = sa_ops.fused_sparse_decode_attention_paged(
        *args, return_thresholds=True, **kw)
    assert np.array_equal(thr.numpy(), np.asarray(thr_want))
    close(got, want)
    # kernel 7 == kernel 6 over the gathered views, bit for bit
    views = [kv_pages.gather_pages(x, t(ids)).reshape(B * HK, view, -1)
             for x in (t(k_pool), t(v_pool), t(codes_pool))]
    out6, thr6 = sa_ops.fused_sparse_decode_attention(
        t(q), *views[:2], t(cq), views[2], t(valid), return_thresholds=True,
        **kw)
    assert torch.equal(thr, thr6) and torch.equal(got, out6)


@pytest.mark.parametrize("ps,tile", PAGE_TILES)
def test_paged_dense_plain_matches_jax_kernel(ps, tile):
    q, k_pool, v_pool, _, _, ids, valid = _paged_case(ps, 3 * ps + tile)
    valid[1] = False                        # a slot with no valid row: 0
    pt = jnp.asarray(ids)
    want = dense_decode_attention_paged_kernel(
        jnp.maximum(pt, 0), jnp.asarray(q), jnp.asarray(k_pool),
        jnp.asarray(v_pool), jnp.asarray(valid, jnp.int32),
        scale=D ** -0.5, heads_per_batch=HK, tile_k=tile, interpret=True)
    got = sa_ops.dense_decode_attention_paged(
        t(ids), t(q), t(k_pool), t(v_pool), t(valid), scale=D ** -0.5,
        heads_per_batch=HK)
    close(got, want)
    assert not got.reshape(B, HK, -1, D)[1].any()
