"""The port's plain versions of its three CUDA kernels against the JAX
Pallas kernels they replace (interpret mode on the CPU), in f32 to
atol=rtol=1e-5 with integer [t, need] thresholds exactly equal:

  * fused sparse decode attention (kernel 6) — "qhead" and "kvgroup", GQA
    ratios 1, 2 and 4, ragged validity with an all-invalid row, a cache
    length that is not a tile multiple;
  * grouped routed FFN (kernel 9) — gated and not, LoRA on and off,
    capacity drops, capacity and hidden dims that are not tile multiples;
  * decode routed FFN (kernel 10) — gated and not, output gates, LoRA.

Both sides get the same codes, plans and choices; the LoRA c leaves (zero
at init) carry nonzero values.  The CUDA kernels themselves are held to
these plain versions on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import dispatch as jdispatch
from repro.core import lora as jlora
from repro.core import pq as jpq
from repro.core import routed_ffn as jrf
from repro.core import sparse_attention as jsa
from repro.kernels.routed_ffn.routed_ffn import (decode_ffn_kernel,
                                                 grouped_ffn_kernel)
from repro.kernels.sparse_attention.ops import sparse_mha_decode
from repro.kernels.topl_select.topl_select import \
    decode_topl_thresholds_kernel
from repro_torch.kernels.routed_ffn import ops as rffn_ops
from repro_torch.kernels.sparse_attention import ops as sa_ops
from test_torch_model import (close, np_init_tree,  # noqa: F401
                              one_torch_thread, perturb_lora, t)


# ------------------------------------------------ kernel 6: decode attention
@pytest.mark.parametrize("gran", ["qhead", "kvgroup"])
@pytest.mark.parametrize("hq,hk", [(2, 2), (4, 2), (4, 1)])
def test_fused_decode_plain_matches_jax_kernel(gran, hq, hk):
    b, s, d, tile = 3, 72, 16, 32          # S=72: no multiple of the tile
    r = hq // hk
    rng = np.random.default_rng(hq * 10 + hk + (gran == "kvgroup"))
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    pcfg = jpq.PQConfig(head_dim=d, code_dim=8, num_codewords=16)
    cb = jnp.asarray(rng.standard_normal((2, 16, 8)).astype(np.float32))
    scfg = jsa.SparseAttentionConfig(pq=pcfg, select_granularity=gran)
    codes = jpq.assign(jnp.asarray(k), cb).astype(jnp.int8)
    lens = np.array([72, 41, 0])                       # row 2: all invalid
    valid = np.arange(s)[None, :] < lens[:, None]
    want = sparse_mha_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             codes, cb, scfg, d ** -0.5, jnp.asarray(valid),
                             tile_k=tile, interpret=True, fuse=True)
    m = 2
    l = jsa.top_l(s, scfg)
    sum_rows = gran == "kvgroup"
    max_score = m * (r if sum_rows else 1)
    cqg = np.asarray(jpq.assign(jnp.asarray(q), cb)).reshape(b * hk, r, m)
    ckg = np.asarray(codes).reshape(b * hk, s, m)
    thr_want = decode_topl_thresholds_kernel(
        jnp.asarray(cqg), jnp.asarray(ckg, jnp.int32),
        jnp.asarray(valid, jnp.int32), l=l, max_score=max_score,
        sum_rows=sum_rows, heads_per_batch=hk, tile_k=tile, interpret=True)
    out, thr = sa_ops.fused_sparse_decode_attention(
        t(q.reshape(b * hk, r, d)), t(k.reshape(b * hk, s, d)),
        t(v.reshape(b * hk, s, d)), t(cqg), t(ckg), t(valid),
        scale=d ** -0.5, l=l, max_score=max_score, sum_rows=sum_rows,
        heads_per_batch=hk, return_thresholds=True)
    assert np.array_equal(thr.numpy(), np.asarray(thr_want))
    close(out.reshape(b, hq, 1, d), want)
    assert not out.reshape(b, hq, d)[2].any()           # nothing selected


# ------------------------------------------------ routed FFN helpers
def _ffn_setup(gated, lora_on, capf, act, gate_out=False, seed=0):
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0, enabled=lora_on)
    rcfg = jrf.RoutedFFNConfig(d_model=32, d_ff=96, num_groups=4,
                               active_groups=2, capacity_factor=capf,
                               activation=act, gated=gated,
                               gate_outputs=gate_out)
    p = np_init_tree(jrf.param_defs(rcfg, lcfg), seed)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)
    p = perturb_lora(p, np.random.default_rng(seed))
    lora_tree = ({k: p[k] for k in ("lora_inner", "lora_gate", "lora_outer")
                  if k in p} if lora_on else None)
    return rcfg, lcfg, p, lora_tree


def _torch_tree(tree):
    if tree is None:
        return None
    return {k: _torch_tree(v) if isinstance(v, dict) else t(v)
            for k, v in tree.items()}


def _jax_tree(tree):
    return None if tree is None else jax.tree_util.tree_map(jnp.asarray, tree)


# ------------------------------------------------ kernel 9: grouped FFN
@pytest.mark.parametrize("gated,lora_on,capf,act", [
    (True, True, 2.0, "silu"),      # C=24, F=24: both pad past the tiles
    (False, True, 0.5, "gelu"),     # capacity drops
    (True, False, 1.0, "relu"),
])
def test_grouped_ffn_plain_matches_jax_kernel(gated, lora_on, capf, act):
    rcfg, lcfg, p, lora_tree = _ffn_setup(gated, lora_on, capf, act)
    x = np.random.default_rng(1).standard_normal((2, 20, 32)).astype(
        np.float32)
    choice, gate, _ = jrf.route(jnp.asarray(x), jnp.asarray(p["router"]),
                                rcfg, need_aux=False)
    cap = jdispatch.capacity(20, 4, 2, capf)
    cap_dyn = jdispatch.capacity_dyn(jnp.asarray([20, 13]), 4, 2, capf)
    plan = jdispatch.make_plan(choice, gate, 4, cap, cap_dyn=cap_dyn)
    if capf < 1.0:
        assert float(plan.dropped) > 0.0
    wg = p["w_gate"] if gated else None
    want = grouped_ffn_kernel(
        jnp.asarray(x), plan.index, jnp.asarray(p["w_inner"]),
        jnp.asarray(p["w_outer"]), None if wg is None else jnp.asarray(wg),
        _jax_tree(lora_tree), lcfg.scale, act=act, tile_c=16, tile_f=16,
        interpret=True)
    got = rffn_ops.grouped_ffn(
        t(x), t(plan.index), t(p["w_inner"]), t(p["w_outer"]),
        None if wg is None else t(wg), _torch_tree(lora_tree), lcfg.scale,
        act=act)
    ok = np.asarray(plan.slot_ok)[..., None]             # empty slots: any
    close(np.where(ok, got.numpy(), 0.0), np.where(ok, want, 0.0))


# ------------------------------------------------ kernel 10: decode FFN
@pytest.mark.parametrize("gated,gate_out,act,lora_on", [
    (True, False, "silu", True),
    (False, True, "gelu", True),
    (True, True, "relu", False),
])
def test_decode_ffn_plain_matches_jax_kernel(gated, gate_out, act, lora_on):
    rcfg, lcfg, p, lora_tree = _ffn_setup(gated, lora_on, 1.0, act,
                                          gate_out=gate_out, seed=2)
    x = np.random.default_rng(3).standard_normal((3, 32)).astype(np.float32)
    choice, gate, _ = jrf.route(jnp.asarray(x)[:, None],
                                jnp.asarray(p["router"]), rcfg,
                                need_aux=False)
    choice, gate = choice[:, 0], gate[:, 0]
    wg = p["w_gate"] if gated else None
    want = decode_ffn_kernel(
        jnp.asarray(x), choice, gate, jnp.asarray(p["w_inner"]),
        jnp.asarray(p["w_outer"]), None if wg is None else jnp.asarray(wg),
        _jax_tree(lora_tree), lcfg.scale, act=act, tile_f=16,
        interpret=True)
    got = rffn_ops.decode_ffn(
        t(x), t(choice), t(gate), t(p["w_inner"]), t(p["w_outer"]),
        None if wg is None else t(wg), _torch_tree(lora_tree), lcfg.scale,
        act=act)
    close(got, want)
