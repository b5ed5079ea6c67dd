"""The decode split rule of a KV cache whose sequence splits over the
model axis (models/attention.py), on the CPU, n ranks simulated in one
process, against the unsharded references:

  * each rank's score histograms of its slots (kernel 3's summed
    histogram, its plain version) add up to the whole row's, and
    ``split_thresholds`` gives the whole row's [t, need] integer-equal to
    ``decode_topl_thresholds_ref`` on the whole cache and to JAX's
    ``decode_thresholds_ref``;
  * the ranks' selections under their [t, need_r] (kernel 5's rule,
    ``newest_ties``) are disjoint and their union is the whole cache's
    selection exactly;
  * kernel 5's plain version with each row's log-sum-exp, the parts
    weighted by ``part_weight`` and summed, gives
    ``sparse_decode_attention_ref`` on the whole cache and JAX's
    ``sparse_mha_decode`` within 1e-6 in f32;

for n in {2, 3, 4}, a contiguous cache and a wrapped SWA ring, "qhead"
and "kvgroup" selection, with rows whose valid slots lie on one rank
only (the other ranks hold no valid key), a row with no valid slot, and
top fraction 1 (every valid key, ties included).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pq as jpq
from repro.core import sparse_attention as jsa
from repro.kernels.topl_select.ref import decode_thresholds_ref
from repro_torch.core import pq
from repro_torch.core import sparse_attention as sa
from repro_torch.kernels.sparse_attention import ops as sa_ops
from repro_torch.kernels.sparse_attention.ref import (
    newest_ties, sparse_decode_attention_ref)
from repro_torch.kernels.topl_select import ops as topl_ops
from repro_torch.kernels.topl_select.ref import (decode_scores,
                                                 decode_topl_thresholds_ref)
from repro_torch.models.attention import part_weight, split_thresholds
from test_torch_model import one_torch_thread  # noqa: F401

B, HQ, HK, D, M, E = 4, 4, 2, 16, 2, 8
S = 24                                  # divides by 2, 3 and 4
WINDOW = S                              # the ring: S slots of a longer run


def _case(n, mask, gran, frac, seed):
    rng = np.random.default_rng(seed)
    # few codewords: many equal scores, so the tie rule decides
    cb = rng.standard_normal((M, E, D // M)).astype(np.float32)
    q = rng.standard_normal((B, HQ, 1, D)).astype(np.float32)
    k = rng.standard_normal((B, HK, S, D)).astype(np.float32)
    v = rng.standard_normal((B, HK, S, D)).astype(np.float32)
    if mask == "contiguous":        # rows at ragged depths
        depth = np.array([S, S // n - 1, 0, 2 * S // 3])
        slot_pos = np.where(np.arange(S)[None] < depth[:, None],
                            np.arange(S)[None], -1)
        pos = depth - 1
    else:                           # a wrapped ring: slot = pos % S
        pos = np.array([S + 5, 3 * S - 1, -1, 2 * S + S // n])
        slot_pos = np.full((B, S), -1)
        for b, p in enumerate(pos):
            for t in range(max(0, p - WINDOW + 1), p + 1):
                slot_pos[b, t % S] = t
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None]) & (
        slot_pos > pos[:, None] - WINDOW)
    scfg = sa.SparseAttentionConfig(
        pq=pq.PQConfig(head_dim=D, code_dim=D // M, num_codewords=E),
        top_fraction=frac, select_granularity=gran)
    return cb, q, k, v, valid, scfg


@pytest.mark.parametrize("frac", [0.25, 1.0])
@pytest.mark.parametrize("gran", ["qhead", "kvgroup"])
@pytest.mark.parametrize("mask", ["contiguous", "ring"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_split_decode_equals_whole(n, mask, gran, frac):
    cb, q, k, v, valid, scfg = _case(n, mask, gran, frac,
                                     seed=100 * n + len(mask) + len(gran))
    r, sl = HQ // HK, S // n
    sum_rows = gran == "kvgroup"
    l = sa.top_l(S, scfg, None)
    sel = dict(max_score=M * (r if sum_rows else 1), sum_rows=sum_rows,
               heads_per_batch=HK)
    scale = D ** -0.5
    tq, tcb = torch.as_tensor(q), torch.as_tensor(cb)
    codes_q = pq.assign(tq, tcb).reshape(B * HK, r, M)
    codes_k = pq.assign(torch.as_tensor(k), tcb).to(torch.int8)
    qg = tq.reshape(B * HK, r, D)
    kg = torch.as_tensor(k).reshape(B * HK, S, D)
    vg = torch.as_tensor(v).reshape(B * HK, S, D)
    ck = codes_k.reshape(B * HK, S, M)
    tv = torch.as_tensor(valid)

    # the whole cache: [t, need], the selection, the output
    thr = decode_topl_thresholds_ref(codes_q, ck, tv, l=l, **sel)
    chosen = newest_ties(decode_scores(codes_q, ck, tv, sum_rows=sum_rows,
                                       heads_per_batch=HK), thr)
    want = sparse_decode_attention_ref(qg, kg, vg, codes_q, ck, thr, tv,
                                       scale=scale, sum_rows=sum_rows,
                                       heads_per_batch=HK)
    jthr = decode_thresholds_ref(jnp.asarray(codes_q.numpy()),
                                 jnp.asarray(ck.numpy()),
                                 jnp.asarray(valid, jnp.int32), l=l,
                                 max_score=sel["max_score"],
                                 sum_rows=sum_rows)
    assert np.array_equal(np.asarray(jthr), thr.numpy())
    jcfg = jsa.SparseAttentionConfig(
        pq=jpq.PQConfig(head_dim=D, code_dim=D // M, num_codewords=E),
        top_fraction=frac, select_granularity=gran)
    jwant = jsa.sparse_mha_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(codes_k.numpy()), jnp.asarray(cb), jcfg, scale,
        jnp.asarray(valid))

    # each rank: its slots' histograms (kernel 3's plain version)
    parts = [slice(i * sl, (i + 1) * sl) for i in range(n)]
    local = [(ck[:, p].contiguous(), tv[:, p].contiguous()) for p in parts]
    hists = torch.stack([topl_ops.decode_topl_thresholds(
        codes_q, c, m, l=l, return_hist=True, **sel)[1] for c, m in local])
    assert hists.dtype == torch.int32
    outs, lses, sels = [], [], []
    for i, ((c, m), p) in enumerate(zip(local, parts)):
        whole, thr_r = split_thresholds(hists, l, i)
        assert torch.equal(whole, thr)
        sels.append(newest_ties(decode_scores(
            codes_q, c, m, sum_rows=sum_rows, heads_per_batch=HK), thr_r))
        o, lse = sa_ops.sparse_decode_attention(
            qg, kg[:, p].contiguous(), vg[:, p].contiguous(), codes_q, c,
            thr_r, m, scale=scale, sum_rows=sum_rows, heads_per_batch=HK,
            return_lse=True)
        assert lse.dtype == torch.float32 and lse.shape == (B * HK, r)
        outs.append(o)
        lses.append(lse)
    union = torch.cat(sels, dim=-1)
    assert torch.equal(union, chosen)
    lse_all = torch.stack(lses)
    got = sum(o.float() * part_weight(lse, lse_all)[..., None]
              for o, lse in zip(outs, lses))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got.reshape(B, HQ, 1, D).numpy(),
                               np.asarray(jwant), atol=1e-6, rtol=0)
    # the row with no valid slot: no rank selects, the output is 0
    assert not got.reshape(B, HK, r, D)[2].any()
    assert (lse_all.reshape(n, B, HK, r)[:, 2] == float("-inf")).all()
