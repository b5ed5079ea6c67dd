"""The port's paged KV layout against the JAX package's.

  * serving/kv_pages: allocator sequences (alloc, exhaustion, free,
    reuse, shared pages, ``alloc_rows_pages`` with -1 bucket-pad rows)
    give the same state and page tables; gather / scatter / occupancy and
    ``scatter_prefill_rows`` (with -1 overhang pages) give the same
    pools; ``kv_row_bytes`` the same bytes;
  * core/dispatch: ``use_fused_decode_attn``, ``use_paged_native_decode``
    and ``use_paged_kv`` return what the JAX functions return for every
    value of their switches, kill switch on and off;
  * the engine: the port's paged Engine.run against JAX's, sparse
    (kernel 7's plain version vs the Pallas kernel in interpret mode) and
    dense (kernel 8), on one workload that recycles slots, grows a slot
    across a page boundary inside a decode chunk, stalls admission on a
    pool smaller than the footprint and rejects a request larger than the
    pool: equal greedy streams (up to the near-tie replay rule of
    tests/test_sparse_decode.py), finish reasons, kv_pages_total,
    kv_pages_peak and admission_stalls;
  * within the port, paged streams equal contiguous streams on every
    decode tier: kernel-native, gathered views, two-pass, and
    REPRO_DISABLE_KERNELS=1.
f32 throughout; the same JAX params feed both engines.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.models import transformer as jtransformer
from repro.serving import kv_pages as jkvp
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.core import dispatch
from repro_torch.serving import kv_pages
from repro_torch.serving.engine import Engine, Request
from test_torch_model import (jax_params, one_torch_thread,  # noqa: F401
                              port_cfg, port_model, smoke_cfg, t)


def _same_state(got, want):
    for key in ("free", "top", "refs"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


# ------------------------------------------------------------ allocator
def test_allocator_sequences_match_jax():
    """One scripted sequence through both allocators, compared after
    every call."""
    js, ts = jkvp.init_state(6), kv_pages.init_state(6)
    jpt, tpt = jkvp.init_page_table(3, 4), kv_pages.init_page_table(3, 4)

    def check():
        _same_state(ts, js)
        assert np.array_equal(tpt.numpy(), np.asarray(jpt))

    want = np.array([[True, False, True], [False, True, True]])
    js, jpid, jok = jkvp.alloc_masked(js, jnp.asarray(want))
    ts, tpid, tok = kv_pages.alloc_masked(ts, t(want))
    assert np.array_equal(tpid.numpy(), np.asarray(jpid))
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    check()
    first = tpid[t(want)].tolist()
    # exhaustion: 2 pages left, 3 wanted -> the last fails with id -1
    js, jpid, jok = jkvp.alloc_masked(js, jnp.asarray([True, True, True]))
    ts, tpid, tok = kv_pages.alloc_masked(ts, t([True, True, True]))
    assert tpid.tolist() == np.asarray(jpid).tolist() and tpid[-1] == -1
    assert int(kv_pages.pages_in_use(ts)) == int(jkvp.pages_in_use(js)) == 6
    check()
    # map all six into slots 0 and 1, free slot 0's row, then reuse
    rows = np.full((2, 4), -1, np.int32)
    rows[0, :3] = first[:3]
    rows[1, :3] = [first[3], *tpid[:2].tolist()]
    jpt = jpt.at[:2].set(jnp.asarray(rows))
    tpt[:2] = t(rows)
    js, jpt = jkvp.free_slot_pages(js, jpt, jnp.int32(0))
    ts, tpt = kv_pages.free_slot_pages(ts, tpt, 0)
    check()
    assert int(kv_pages.pages_in_use(ts)) == 3
    js, jpt = jkvp.alloc_slot_pages(js, jpt, jnp.int32(2), jnp.int32(2))
    ts, tpt = kv_pages.alloc_slot_pages(ts, tpt, 2, 2)
    check()
    # group admission: row 1 is a bucket-pad dummy (-1): nothing allocated
    slots, npages = np.array([0, -1], np.int32), np.array([1, 3])
    js, jpt = jkvp.alloc_rows_pages(js, jpt, jnp.asarray(slots),
                                    jnp.asarray(npages))
    ts, tpt = kv_pages.alloc_rows_pages(ts, tpt, t(slots), t(npages))
    check()
    # a shared page survives its first unmapping (refcount 2 -> 1)
    shared = np.asarray(jpt)[2, :1]
    js = jkvp.add_ref(js, jnp.asarray(np.r_[shared, -1]))
    ts = kv_pages.add_ref(ts, t(np.r_[shared, -1]))
    check()
    assert int(kv_pages.pages_in_use(ts)) == 6
    for slot in (2, 1, 0):
        js, jpt = jkvp.free_slot_pages(js, jpt, jnp.int32(slot))
        ts, tpt = kv_pages.free_slot_pages(ts, tpt, slot)
        check()
    assert int(kv_pages.pages_in_use(ts)) == 1                # the shared one


# ------------------------------------------------------------ views
PS = 8


def _pools(rng):
    k = rng.standard_normal((5, 2, PS, 4)).astype(np.float32)
    sp = rng.integers(-1, 30, (5, PS)).astype(np.int32)
    return k, sp


def test_gather_scatter_occupancy_match_jax():
    rng = np.random.default_rng(0)
    k, sp = _pools(rng)
    pt = np.array([[3, 0, -1], [4, -1, -1]], np.int32)
    pos = np.array([PS + 2, 2 * PS + 1])                  # slot 1: no page
    val = rng.standard_normal((2, 2, 4)).astype(np.float32)
    jk = jkvp.scatter_row(jnp.asarray(k), jnp.asarray(pt), jnp.asarray(pos),
                          jnp.asarray(val), PS)
    tk = kv_pages.scatter_row(t(k), t(pt), t(pos), t(val), PS)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    jsp = jkvp.scatter_row(jnp.asarray(sp), jnp.asarray(pt),
                           jnp.asarray(pos), jnp.asarray(pos), PS)
    tsp = kv_pages.scatter_row(t(sp), t(pt), t(pos), t(pos).int(), PS)
    assert np.array_equal(tsp.numpy(), np.asarray(jsp))
    for got, want in ((tk, jk), (tsp, jsp)):
        assert np.array_equal(kv_pages.gather_pages(got, t(pt)).numpy(),
                              np.asarray(jkvp.gather_pages(want,
                                                           jnp.asarray(pt))))
    assert np.array_equal(kv_pages.occupancy(t(pt), PS).numpy(),
                          np.asarray(jkvp.occupancy(jnp.asarray(pt), PS)))


def test_scatter_prefill_rows_matches_jax():
    """Rows of L=13 (2 pages of 8, the 3 rows past L padded) into page
    tables with a -1 overhang page and an all -1 dummy row."""
    rng = np.random.default_rng(1)
    k, sp = _pools(rng)
    pts = np.array([[2, -1, 0], [-1, -1, -1], [1, 4, -1]], np.int32)
    seqs_k = rng.standard_normal((3, 2, 13, 4)).astype(np.float32)
    seqs_sp = rng.integers(0, 13, (3, 13)).astype(np.int32)
    for pool, seqs, pad in ((k, seqs_k, 0), (sp, seqs_sp, -1)):
        want = jkvp.scatter_prefill_rows(jnp.asarray(pool), jnp.asarray(pts),
                                         jnp.asarray(seqs), PS, pad)
        got = kv_pages.scatter_prefill_rows(t(pool), t(pts), t(seqs), PS,
                                            pad)
        assert np.array_equal(got.numpy(), np.asarray(want))
        one = jkvp.scatter_prefill(jnp.asarray(pool), jnp.asarray(pts[2]),
                                   jnp.asarray(seqs[2]), PS, pad)
        assert np.array_equal(kv_pages.scatter_prefill(
            t(pool), t(pts[2]), t(seqs[2]), PS, pad).numpy(), np.asarray(one))


@pytest.mark.parametrize("spt", [{}, {"sparse_mha": False}])
def test_kv_row_bytes_and_shape_math_match_jax(spt):
    jcfg = smoke_cfg(**spt)
    assert kv_pages.kv_row_bytes(port_cfg(jcfg)) == jkvp.kv_row_bytes(jcfg)
    assert (kv_pages.pool_pages(3, 50, 16), kv_pages.view_len(50, 16)) == (
        jkvp.pool_pages(3, 50, 16), jkvp.view_len(50, 16))


# ------------------------------------------------------------ dispatch
@pytest.mark.parametrize("disabled", [False, True])
def test_paged_and_two_pass_dispatch_match_jax(monkeypatch, disabled):
    monkeypatch.setenv("REPRO_DISABLE_KERNELS", "1" if disabled else "0")
    cases = [dict(attn_impl=a, decode_attn_fuse=f, kv_paged_native=n,
                  kv_layout=lay)
             for a in ("sparse_jnp", "pallas", "dense")
             for f in ("auto", "fused", "two_pass")
             for n in ("auto", "kernel", "gather")
             for lay in ("contiguous", "paged")]
    for spt in cases:
        jcfg = smoke_cfg(**spt)
        pcfg = port_cfg(jcfg)
        for name in ("use_fused_decode_attn", "use_paged_native_decode",
                     "use_paged_kv", "use_sparse_decode_kernel"):
            assert getattr(dispatch, name)(pcfg) == \
                getattr(jdispatch, name)(jcfg), (name, spt)
    assert dispatch.kernels_disabled() == disabled


# ------------------------------------------------------------ engine
MAX_LEN, SLOTS, CHUNK, PAGE = 32, 2, 4, 8
POOL = 3            # pages; the contiguous footprint is 2 x 4 = 8
# prompt lengths with 6 new tokens: worst-case pages 2, 3, 2, 2, 4 of 8
# rows — the 3-page request stalls until the pool is empty, the 4-page
# one is larger than the pool and is rejected; the 7-row prompt grows
# into its second page inside a decode chunk
PROMPTS = [7, 12, 5, 9, 20]
GEN = 6


def _workload():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 256, size=n).tolist() for n in PROMPTS]


def _paged_cfg(sparse):
    spt = dict(attn_impl="pallas", ffn_impl="pallas", kv_layout="paged",
               kv_page_size=PAGE)
    if not sparse:
        spt["sparse_mha"] = False
    return smoke_cfg(**spt)


def _replay_gap(jcfg, tree, ctx, a, b):
    """max logit - the lower of tokens a, b after ``ctx``, replayed
    through the JAX ragged prefill."""
    batch = {"tokens": jnp.asarray(np.asarray(ctx, np.int32)[None, :])}
    _, logits = jax.jit(lambda p, bt, n: jtransformer.lm_prefill_ragged(
        p, jcfg, bt, n, MAX_LEN))(tree, batch, jnp.asarray([len(ctx)]))
    lg = np.asarray(logits[0, -1], np.float32)
    return float(lg.max()) - min(float(lg[a]), float(lg[b]))


def _assert_streams(jcfg, tree, prompts, got, want):
    """Equal streams, except past a genuine logit near-tie (<= 1e-3) at
    the first divergence; the rest of such a row follows another prefix
    and is not compared."""
    for row, (prompt, g, w) in enumerate(zip(prompts, got, want)):
        if g == w:
            continue
        assert len(g) == len(w), (row, g, w)
        i = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        gap = _replay_gap(jcfg, tree, prompt + w[:i], g[i], w[i])
        assert gap <= 1e-3, (
            f"row {row} diverged at step {i} with a logit gap {gap:.3e}")


@pytest.fixture(scope="module", params=[True, False], ids=["sparse",
                                                            "dense"])
def jax_paged(request):
    """One JAX paged engine run of the workload."""
    jcfg = _paged_cfg(request.param)
    tree = jax_params(jcfg)
    eng = JEngine(jcfg, tree, max_len=MAX_LEN, num_slots=SLOTS,
                  decode_chunk=CHUNK, kv_pages=POOL)
    outs = eng.run([JRequest(uid=i, tokens=p, max_new_tokens=GEN)
                    for i, p in enumerate(_workload())])
    return jcfg, tree, outs, eng.last_stats


def _port_run(jcfg, tree, **spt):
    model = port_model(jcfg, tree)
    cfg = model.cfg.with_spt(**spt) if spt else model.cfg
    eng = Engine(cfg, model, max_len=MAX_LEN, num_slots=SLOTS,
                 decode_chunk=CHUNK, kv_pages=POOL, device="cpu")
    outs = eng.run([Request(uid=i, tokens=p, max_new_tokens=GEN)
                    for i, p in enumerate(_workload())])
    return outs, eng.last_stats


def test_paged_engine_matches_jax(jax_paged):
    jcfg, tree, want, jst = jax_paged
    got, st = _port_run(jcfg, tree)
    assert [c.finish_reason for c in got] == [c.finish_reason for c in want]
    assert [c.finish_reason for c in got] == ["length"] * 4 + ["rejected"]
    assert "KV pages" in got[4].detail and "KV pages" in want[4].detail
    _assert_streams(jcfg, tree, _workload(), [c.tokens for c in got],
                    [c.tokens for c in want])
    for key in ("page_size", "kv_pages_total", "kv_pages_peak",
                "admission_stalls", "admitted", "completed"):
        assert getattr(st, key) == getattr(jst, key), key
    assert st.kv_pages_total == POOL and 0 < st.kv_pages_peak <= POOL
    assert st.admission_stalls > 0 and st.prefill_batches >= 3


def test_page_growth_inside_a_decode_chunk():
    """A 7-row prompt plus its first token fill page 0 of 8 rows; the
    decode writes from position 8 on need page 1, which the chunk
    allocates on the device: the peak shows the second page."""
    jcfg = _paged_cfg(True)
    model = port_model(jcfg, jax_params(jcfg))
    eng = Engine(model.cfg, model, max_len=MAX_LEN, num_slots=1,
                 decode_chunk=CHUNK, device="cpu")
    out = eng.run([Request(uid=0, tokens=_workload()[0], max_new_tokens=GEN)])
    assert len(out[0].tokens) == GEN
    assert eng.last_stats.kv_pages_peak == 2
    assert eng.last_stats.kv_pages_total == SLOTS // 2 * (MAX_LEN // PAGE)


TIERS = {
    "native": ({}, False),
    "gathered": ({"kv_paged_native": "gather"}, False),
    "gathered-two-pass": ({"kv_paged_native": "gather",
                           "decode_attn_fuse": "two_pass"}, False),
    "kill-switch": ({}, True),
}


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("tier", list(TIERS))
def test_paged_streams_equal_contiguous_in_the_port(monkeypatch, sparse,
                                                    tier):
    """Paged (this tier) against the contiguous layout (fused kernels,
    or REPRO_DISABLE_KERNELS=1 with it), on the same model and
    requests."""
    spt, disable = TIERS[tier]
    if disable:
        monkeypatch.setenv("REPRO_DISABLE_KERNELS", "1")
    jcfg = _paged_cfg(sparse)
    tree = jax_params(jcfg)
    prompts = _workload()[:4]
    runs = {}
    for layout in ("contiguous", "paged"):
        model = port_model(jcfg, tree)
        cfg = model.cfg.with_spt(kv_layout=layout, **spt)
        eng = Engine(cfg, model, max_len=MAX_LEN, num_slots=SLOTS,
                     decode_chunk=CHUNK, device="cpu")
        runs[layout] = [c.tokens for c in eng.run(
            [Request(uid=i, tokens=p, max_new_tokens=GEN)
             for i, p in enumerate(prompts)])]
        assert eng._paged == (layout == "paged")
    assert runs["paged"] == runs["contiguous"]
    assert all(len(s) == GEN for s in runs["paged"])


def test_two_pass_contiguous_streams_equal_fused():
    """decode_attn_fuse="two_pass" on the contiguous layout (kernels 3
    and 5, plain on the CPU) gives the fused tier's streams."""
    jcfg = smoke_cfg(attn_impl="pallas", ffn_impl="pallas")
    tree = jax_params(jcfg)
    runs = []
    for fuse in ("fused", "two_pass"):
        model = port_model(jcfg, tree)
        eng = Engine(model.cfg.with_spt(decode_attn_fuse=fuse), model,
                     max_len=MAX_LEN, num_slots=SLOTS, decode_chunk=CHUNK,
                     device="cpu")
        runs.append([c.tokens for c in eng.run(
            [Request(uid=i, tokens=p, max_new_tokens=GEN)
             for i, p in enumerate(_workload()[:3])])])
    assert runs[0] == runs[1]


def test_paged_layout_is_a_no_op_for_windowed_stacks():
    """kv_layout="paged" on a stack with nothing to page (a SWA ring
    bounds every attention cache) keeps the contiguous engine, as in
    JAX."""
    jcfg = dataclasses.replace(_paged_cfg(True), window=8)
    model = port_model(jcfg, jax_params(jcfg))
    eng = Engine(model.cfg, model, max_len=MAX_LEN, num_slots=SLOTS,
                 device="cpu")
    assert not eng._paged and eng.kv_pages == eng.page_size == 0
