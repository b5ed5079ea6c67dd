"""The port's long-lived server (``Engine.serve``) against the JAX
package's, under a ManualClock so every schedule is a function of the
seed.

  * ``ManualClock`` / ``ArrivalSchedule``: the same Poisson times, trace
    order and due() pops as JAX's;
  * one trace with priorities, a TTFT deadline that sheds, an urgent
    (deadline) preemption, a priority preemption, a cancel while queued,
    a cancel mid-stream, a forced ``preempt`` and an oversized reject, on
    the contiguous and paged layouts: completions (tokens,
    finish_reason, detail, preemptions), the ServeStats integers and the
    snapshot's key set equal JAX's;
  * recompute resume is exact in f32: a preempted request's stream
    equals its solo run;
  * an EOS-heavy serve: ServeStats equal JAX's, ``decode_steps``
    included — the chunk runs past the step where EOS retired every slot
    (it cannot stop without a host sync), and counts only the steps in
    which some slot was active, as JAX's while_loop does;
  * the legacy ``generate``: greedy equals ``run`` and JAX's
    ``generate``, also past max_len (the rolling per-token path); sampled
    generate is seeded.
The chaos soak is in tests/test_torch_chaos.py.
JAX runs its plain paths (sparse_jnp attention, grouped FFN, jnp decode);
the port runs the kernel config, whose wrappers take their plain
versions on the CPU.  f32; the same JAX params feed both engines.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import engine as jengine
from repro_torch.serving import chaos, engine
from test_torch_model import (jax_params, one_torch_thread,  # noqa: F401
                              port_model, smoke_cfg)

MAX_LEN = 64
KERNELS = dict(attn_impl="pallas", ffn_impl="pallas")
STAT_INTS = ("submitted", "admitted", "completed", "rejections", "cancelled",
             "shed", "preemptions", "prefill_batches", "admission_stalls",
             "kv_pages_peak", "decode_steps", "decode_tokens",
             "prefill_tokens", "page_size", "kv_pages_total")


def engines(layout, spt=None, **kw):
    """(JAX engine, port engine) over the same f32 smoke params; spt:
    more SPTConfig switches."""
    jcfg = smoke_cfg(kv_layout=layout, kv_page_size=16, **(spt or {}))
    tree = jax_params(jcfg)
    model = port_model(jcfg, tree)
    cfg = model.cfg.with_spt(**KERNELS)
    kw.setdefault("max_len", MAX_LEN)
    return (jengine.Engine(jcfg, tree, **kw),
            engine.Engine(cfg, model, device="cpu", **kw))


def completions(out):
    return [(c.uid, c.tokens, c.finish_reason, c.detail, c.preemptions)
            for c in out]


def stat_ints(eng):
    return {k: getattr(eng.last_stats, k) for k in STAT_INTS}


# ------------------------------------------------- arrivals and the clock
def test_clock_and_arrival_schedules_match_jax():
    def trip(mod):
        clk = mod.ManualClock(dt=0.5)
        clk.advance()
        clk.advance()
        reqs = [mod.Request(uid=i, tokens=[1], max_new_tokens=1)
                for i in range(8)]
        sched = mod.ArrivalSchedule.poisson(reqs, rate_qps=2.0, seed=7)
        pops = []
        while not sched.exhausted:
            t = sched.next_time()
            pops.append((t, [r.uid for r in sched.due(t)]))
        tr = mod.ArrivalSchedule.from_trace(
            [(2.0, reqs[2]), (0.5, reqs[0]), (1.0, reqs[1])])
        first = [r.uid for r in tr.due(1.0)]
        burst = mod.ArrivalSchedule.burst(reqs[:3])
        return (clk(), pops, first, tr.next_time(),
                [r.uid for r in burst.due(0.0)], burst.exhausted)

    assert trip(engine) == trip(jengine)
    assert trip(engine)[1][0][0] > 0.0


# --------------------------------------------------------- the scheduler
def _trace(mod):
    """Three slots, eight submissions: uids 0, 1, 6 fill the slots at
    t=0; uid 2 (priority 2) evicts a priority-0 one; uid 3 (deadline 4 s)
    turns urgent and evicts a deadline-free peer; uid 4 (priority -1,
    deadline 1 s) sheds; uid 5 is cancelled while queued and uid 6
    mid-stream by the hook, which also forces one preemption; uid 7 is
    larger than max_len."""
    rng = np.random.default_rng(3)

    def prompt(n):
        return rng.integers(0, 256, n).tolist()

    R = mod.Request
    return [(0.0, R(uid=0, tokens=prompt(8), max_new_tokens=12)),
            (0.0, R(uid=1, tokens=prompt(10), max_new_tokens=10)),
            (0.0, R(uid=6, tokens=prompt(7), max_new_tokens=14)),
            (1.0, R(uid=2, tokens=prompt(6), max_new_tokens=4, priority=2)),
            (1.5, R(uid=3, tokens=prompt(8), max_new_tokens=4,
                    deadline_s=4.0)),
            (2.0, R(uid=4, tokens=prompt(8), max_new_tokens=6, priority=-1,
                    deadline_s=1.0)),
            (2.0, R(uid=5, tokens=prompt(5), max_new_tokens=6)),
            (2.5, R(uid=7, tokens=prompt(3), max_new_tokens=MAX_LEN))]


def _hook(log):
    def hook(eng, iteration):
        if iteration == 3:
            log.append(("cancel 5", eng.cancel(5)))
        if iteration == 4:
            log.append(("cancel 6", eng.cancel(6)))
        if iteration == 5:
            log.append(("preempt", eng.preempt()))
        assert not eng.cancel(99)                 # unknown uid: a no-op
    return hook


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_scheduler_matches_jax(layout):
    kw = dict(num_slots=3, decode_chunk=2)
    if layout == "paged":
        kw["kv_pages"] = 6
    jeng, eng = engines(layout, **kw)
    logs = {}
    outs = {}
    for name, mod, e in (("jax", jengine, jeng), ("port", engine, eng)):
        logs[name] = []
        outs[name] = completions(e.serve(
            mod.ArrivalSchedule.from_trace(_trace(mod)),
            clock=mod.ManualClock(), on_iteration=_hook(logs[name])))
    assert outs["port"] == outs["jax"]
    assert logs["port"] == logs["jax"] == [
        ("cancel 5", True), ("cancel 6", True), ("preempt", True)]
    assert stat_ints(eng) == stat_ints(jeng)
    assert (set(eng.last_stats.snapshot().flat())
            == set(jeng.last_stats.snapshot().flat()))
    assert list(eng.last_stats.as_dict()) == list(jeng.last_stats.as_dict())
    by_uid = {c[0]: c for c in outs["port"]}
    assert by_uid[4][2] == "shed" and "deadline" in by_uid[4][3]
    assert by_uid[5][2:4] == ("cancelled", "cancelled while queued")
    assert by_uid[6][2:4] == ("cancelled", "cancelled mid-stream")
    assert by_uid[7][2] == "rejected" and "max_len" in by_uid[7][3]
    assert by_uid[3][2] == "length" and by_uid[2][2] == "length"
    st = eng.last_stats
    assert st.preemptions >= 2 and st.shed == 1 and st.cancelled == 2
    assert sum(c[4] for c in outs["port"]) == st.preemptions
    if layout == "paged":
        assert 0 < st.kv_pages_peak <= 6


# ------------------------------------------------- resume and invariants
def test_preempted_stream_equals_its_solo_run():
    """A high-priority arrival on a full engine evicts the low-priority
    request; it re-admits by recompute and its f32 stream equals its
    solo run (and the high one's equals its own).  Recompute rebuilds the
    KV decode wrote because the prefill's top-L budget equals decode's
    here (min_l = 16 at these lengths) and capacity factor 8 drops no
    (token, group) pair."""
    _, eng = engines("paged", spt=dict(ffn_capacity_factor=8.0),
                     num_slots=1, decode_chunk=2)
    rng = np.random.default_rng(3)
    low = engine.Request(uid=0, tokens=rng.integers(0, 256, 8).tolist(),
                         max_new_tokens=8, priority=0)
    high = engine.Request(uid=1, tokens=rng.integers(0, 256, 6).tolist(),
                          max_new_tokens=4, priority=5)
    wd = chaos.Watchdog()
    out = eng.serve(engine.ArrivalSchedule.from_trace([(0.0, low),
                                                       (1.0, high)]),
                    clock=engine.ManualClock(), on_iteration=wd)
    solo_low = eng.run([low])[0]
    solo_high = eng.run([high])[0]
    assert out[0].preemptions >= 1 and out[0].finish_reason == "length"
    assert out[0].tokens == solo_low.tokens
    assert out[1].preemptions == 0 and out[1].tokens == solo_high.tokens
    assert wd.iterations > 0


# --------------------------------------------- EOS stats, legacy generate
def _reqs(mod, lens, gen, seed=1):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, tokens=rng.integers(0, 256, size=n).tolist(),
                        max_new_tokens=gen) for i, n in enumerate(lens)]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_eos_heavy_serve_stats_match_jax(layout):
    """An EOS id that retires rows early: the port's chunk runs past the
    step where every slot retired, yet ``decode_steps`` equals JAX's."""
    kw = dict(num_slots=2, decode_chunk=4)
    jeng, eng = engines(layout, **kw)
    lens = [9, 14, 6, 11, 8]
    greedy = [c.tokens for c in eng.run(_reqs(engine, lens, gen=12))]
    # the token that ends the most rows before their last step
    eos = collections.Counter(t for g in greedy for t in set(g[1:-1])
                              ).most_common(1)[0][0]
    want = jeng.run(_reqs(jengine, lens, gen=12), eos_id=eos)
    got = eng.run(_reqs(engine, lens, gen=12), eos_id=eos)
    assert ([(c.tokens, c.finish_reason) for c in got]
            == [(c.tokens, c.finish_reason) for c in want])
    assert sum(c.finish_reason == "eos" for c in got) >= 2
    assert stat_ints(eng) == stat_ints(jeng)
    assert eng.last_steps_run > eng.last_stats.decode_steps   # dead air ran


def test_generate_matches_run_and_jax():
    jeng, eng = engines("contiguous", num_slots=3, decode_chunk=4)
    rows = np.random.default_rng(5).integers(0, 256, (3, 10))
    got = eng.generate({"tokens": torch.as_tensor(rows)}, steps=7)
    want = jeng.generate({"tokens": jnp.asarray(rows, jnp.int32)}, steps=7)
    ran = eng.run([engine.Request(uid=i, tokens=r.tolist(), max_new_tokens=7)
                   for i, r in enumerate(rows)])
    assert got.tokens == want.tokens == [c.tokens for c in ran]
    assert got.steps == 7
    # past max_len: the rolling per-token path on both
    long_steps = MAX_LEN - 10 + 5
    got = eng.generate({"tokens": torch.as_tensor(rows)}, steps=long_steps)
    want = jeng.generate({"tokens": jnp.asarray(rows, jnp.int32)},
                         steps=long_steps)
    assert got.tokens == want.tokens
    # sampled: the per-token path, keyed by (seed, row, step)
    a = eng.generate({"tokens": torch.as_tensor(rows)}, steps=5,
                     temperature=0.1, seed=3)
    b = eng.generate({"tokens": torch.as_tensor(rows)}, steps=5,
                     temperature=0.1, seed=3)
    assert a.tokens == b.tokens != [c.tokens[:5] for c in ran]
