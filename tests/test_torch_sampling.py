"""Per-request sampling in the port's engine (temperature, top-k, top-p
inside the decode chunk, the first token at admission).

  * Against JAX, exactly: both engines' categorical draw is replaced, in
    the test only, by an argmax over the truncated logits plus one fixed
    numpy noise vector (JAX's ``jax.random.categorical`` is patched before
    its chunk is traced; the port's ``engine.categorical``).  Sampled
    streams of a mixed batch — greedy, temperature only, top-k, top-p,
    top-k with top-p, the run's default temperature — are then equal,
    first tokens included, on both KV layouts.
  * The port alone, with its own counter-based draw: top_k=1 and
    top_p=1e-6 equal greedy; the same seed gives the same streams; a
    request's stream is the same alone, beside other requests in another
    slot, and preempted and resumed (f32); every sampled token lies in
    the top-k set and the nucleus of its step, replayed through the
    model; the draw's frequencies over fixed logits pass a seeded
    chi-square test against the truncated softmax; a run with no sampled
    request, or with top-k alone, never sorts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from repro.serving import engine as jengine
from repro_torch.models import transformer
from repro_torch.serving import engine
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_server import engines

MAX_LEN = 48


def _mixed(mod, gen=8):
    """Greedy, temperature only, top-k, top-p, top-k with top-p, and the
    run's default temperature; the smoke model's logits spread ~0.16, so
    the temperatures are low enough for the logits to matter."""
    rng = np.random.default_rng(11)

    def prompt(n):
        return rng.integers(0, 256, n).tolist()

    R = mod.Request
    return [R(uid=0, tokens=prompt(9), max_new_tokens=gen, temperature=0.0),
            R(uid=1, tokens=prompt(12), max_new_tokens=gen, temperature=0.15),
            R(uid=2, tokens=prompt(6), max_new_tokens=gen, temperature=0.1,
              top_k=5),
            R(uid=3, tokens=prompt(10), max_new_tokens=gen, temperature=0.2,
              top_p=0.6),
            R(uid=4, tokens=prompt(7), max_new_tokens=gen, temperature=0.12,
              top_k=8, top_p=0.8),
            R(uid=5, tokens=prompt(11), max_new_tokens=gen - 2)]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_sampled_streams_match_jax_under_fixed_noise(layout, monkeypatch):
    noise = (0.3 * np.random.default_rng(7).gumbel(size=256)
             ).astype(np.float32)

    def jax_draw(key, logits, axis=-1, shape=None, replace=True):
        return jnp.argmax(logits + jnp.asarray(noise), axis=-1)

    def port_draw(logits, keys, n):
        return (logits + torch.from_numpy(noise)[None]).argmax(-1)

    monkeypatch.setattr(jax.random, "categorical", jax_draw)
    monkeypatch.setattr(engine, "categorical", port_draw)
    jeng, eng = engines(layout, max_len=MAX_LEN, num_slots=3,
                        decode_chunk=3)
    want = [c.tokens for c in jeng.run(_mixed(jengine), temperature=0.1,
                                       key=jax.random.PRNGKey(0))]
    got = [c.tokens for c in eng.run(_mixed(engine), temperature=0.1,
                                     seed=0)]
    assert got == want
    greedy = [c.tokens for c in eng.run(_mixed(engine))]
    assert got[0] == greedy[0]                      # temperature 0: argmax
    assert sum(g != s for g, s in zip(greedy[1:], got[1:])) >= 4
    assert eng.last_stats.completed == 6


def _port_engine(**kw):
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("decode_chunk", 3)
    return engines("contiguous", spt=dict(ffn_capacity_factor=8.0), **kw)[1]


def test_topk1_and_tiny_topp_equal_greedy():
    eng = _port_engine(num_slots=2)
    reqs = _mixed(engine)[1:4]
    greedy = [c.tokens for c in eng.run(reqs)]
    for kw in (dict(top_k=1), dict(top_p=1e-6)):
        trunc = [engine.Request(uid=r.uid, tokens=r.tokens,
                                max_new_tokens=r.max_new_tokens,
                                temperature=1.3, **kw) for r in reqs]
        assert [c.tokens for c in eng.run(trunc, seed=5)] == greedy, kw


def test_same_seed_same_streams():
    eng = _port_engine(num_slots=3)
    a = [c.tokens for c in eng.run(_mixed(engine), temperature=0.1, seed=5)]
    b = [c.tokens for c in eng.run(_mixed(engine), temperature=0.1, seed=5)]
    c = [c.tokens for c in eng.run(_mixed(engine), temperature=0.1, seed=6)]
    assert a == b
    assert a[0] == c[0] and a[1:] != c[1:]


def test_stream_independent_of_slot_batch_and_preemption():
    """uid 9's sampled stream: alone on one slot; third of four requests
    (another slot, other batch mates); and evicted mid-stream by a forced
    preemption, then resumed by recompute — equal in f32.  (The resume's
    prefill rebuilds the KV decode wrote: top-L is min_l = 16 in both at
    these lengths, and capacity factor 8 drops nothing.)"""
    target = engine.Request(uid=9, tokens=list(range(40, 52)),
                            max_new_tokens=10, temperature=0.15, top_k=20,
                            top_p=0.9)
    alone = _port_engine(num_slots=1).run([target], seed=3)[0].tokens
    mates = _mixed(engine)[1:4]
    eng = _port_engine(num_slots=4)
    batched = eng.run(mates[:2] + [target] + mates[2:], seed=3)[2].tokens
    assert alone == batched

    def evict(e, iteration):
        if iteration == 2:
            assert e.preempt(9)
    eng = _port_engine(num_slots=2, decode_chunk=2)
    out = eng.run([target, mates[0]], seed=3, on_iteration=evict)[0]
    assert out.preemptions == 1 and out.tokens == alone
    assert len(set(alone)) > 3


def test_sampled_tokens_lie_in_topk_and_nucleus():
    """Replay each request's prefix through the port's lm_prefill and
    lm_decode_step; every drawn token must be in the top-k set and in the
    nucleus (mass strictly before it < top_p, with 1e-5 slack)."""
    eng = _port_engine(num_slots=2)
    model, cfg = eng.model, eng.cfg
    reqs = [engine.Request(uid=i, tokens=list(range(3 * i, 3 * i + 9)),
                           max_new_tokens=6, temperature=0.1, **kw)
            for i, kw in enumerate([dict(top_p=0.5), dict(top_k=4),
                                    dict(top_k=6, top_p=0.7)])]
    out = eng.run(reqs, seed=11)
    for r, c in zip(reqs, out):
        caches, logits = transformer.lm_prefill(
            model, cfg, {"tokens": torch.tensor([r.tokens])}, MAX_LEN)
        for t, picked in enumerate(c.tokens):
            scaled = logits[0, -1].double().numpy() / r.temperature
            order = np.argsort(-scaled, kind="stable")
            keep = set(order.tolist())
            if r.top_k:
                keep &= set(order[:r.top_k].tolist())
            if r.top_p:
                e = np.exp(scaled[order] - scaled[order[0]])
                probs = e / e.sum()
                before = np.cumsum(probs) - probs
                keep &= set(order[before < r.top_p + 1e-5].tolist())
            assert picked in keep, (r.uid, t, picked)
            logits = transformer.lm_decode_step(
                model, cfg, caches, torch.tensor([picked]),
                torch.tensor([len(r.tokens) + t]))


def test_draw_frequencies_pass_chi_square():
    """4000 draws of sample_rows over fixed logits (token indices 0..3999
    of one request key): temperature 0.7 with top_k 9 and top_p 0.9 keeps
    a subset whose frequencies match the truncated softmax (chi-square p
    > 1e-3, seeded so the verdict is fixed); nothing outside it is
    drawn."""
    v, n = 16, 4000
    lg = torch.from_numpy(np.random.default_rng(2).normal(size=v)
                          .astype(np.float32))
    temp, top_k, top_p = 0.7, 9, 0.9
    draws = engine.sample_rows(
        lg[None].expand(n, v).contiguous(),
        torch.full((n,), engine.request_key(21, 4)), torch.arange(n),
        torch.full((n,), temp), torch.full((n,), top_k),
        torch.full((n,), top_p), top_k, True).numpy()
    scaled = lg.double().numpy() / temp
    order = np.argsort(-scaled)
    srt = scaled[order]
    probs = np.exp(srt - srt[0]) / np.exp(srt - srt[0]).sum()
    kept = order[:min(top_k, int(((np.cumsum(probs) - probs) < top_p)
                                 .sum()))]
    p = np.exp(scaled[kept] - scaled[kept].max())
    p /= p.sum()
    counts = np.array([(draws == k).sum() for k in kept])
    assert counts.sum() == n                         # nothing outside
    assert len(kept) >= 4
    assert scipy.stats.chisquare(counts, p * n).pvalue > 1e-3


def test_greedy_runs_never_sample_and_top_k_alone_never_sorts(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("sampling ran")
    eng = _port_engine(num_slots=3)
    reqs = _mixed(engine)
    with monkeypatch.context() as m:
        m.setattr(engine, "sample_rows", refuse)
        greedy = [c.tokens for c in eng.run(reqs, temperature=0.5)]  # no seed
        cold = [engine.Request(uid=r.uid, tokens=r.tokens,
                               max_new_tokens=r.max_new_tokens,
                               temperature=0.0) for r in reqs]
        assert [c.tokens for c in eng.run(cold, seed=4)] == greedy
    topk = [engine.Request(uid=r.uid, tokens=r.tokens, max_new_tokens=4,
                           temperature=0.1, top_k=3) for r in reqs]
    with monkeypatch.context() as m:
        m.setattr(torch, "sort", refuse)
        out = eng.run(topk, seed=4)
    assert [len(c.tokens) for c in out] == [4] * len(reqs)
