"""The port's serving telemetry against the JAX package's.

  * serving/telemetry.py: ``Reservoir`` (Algorithm R, fixed seeds),
    ``ServeStats.snapshot`` / ``as_dict`` and ``TelemetryRecorder``'s
    drains, aggregates and event records equal JAX's on the same inputs;
  * the engine's device counters: after the same greedy serve with
    telemetry "counters", ``device_aggregates()`` and the recorder's raw
    totals equal JAX's to 1e-6 relative, on both layouts; the port's own
    per-chunk drains equal a step-by-step replay through
    ``lm_prefill_ragged`` / ``lm_decode_step(return_counters=True)``;
  * streams are bit-identical across telemetry off / counters / trace
    (greedy and sampled), and "off" runs no counter code at all;
  * under a ManualClock, per-uid lifecycle timelines (event names, in
    order) equal JAX's for a run that preempts, sheds, cancels, rejects
    and retires; the port's Chrome trace passes both packages'
    ``validate_chrome_trace`` and has a lane for every uid.
JAX runs its plain paths, the port the kernel config (plain versions on
the CPU); f32, the same JAX params in both.
"""
import json

import numpy as np
import pytest
import torch

from repro.serving import engine as jengine
from repro.serving import telemetry as jtelemetry
from repro.serving import trace_export as jtrace
from repro_torch.models import attention, ffn, transformer
from repro_torch.serving import engine, telemetry, trace_export
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_server import engines

MAX_LEN, GEN, CHUNK = 48, 6, 4


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in lens]


def _pair(layout="contiguous", telemetry="counters", **kw):
    """JAX and port engines with telemetry on (the shared helper builds
    the configs; telemetry is a config switch on both)."""
    jeng, eng = engines(layout, max_len=MAX_LEN, decode_chunk=CHUNK, **kw)
    jeng = jengine.Engine(jeng.cfg.with_spt(telemetry=telemetry),
                          jeng.params, max_len=MAX_LEN, decode_chunk=CHUNK,
                          **kw)
    eng = engine.Engine(eng.cfg.with_spt(telemetry=telemetry), eng.model,
                        max_len=MAX_LEN, decode_chunk=CHUNK, device="cpu",
                        **kw)
    return jeng, eng


# ------------------------------------------------- host-side telemetry
def test_reservoir_stats_and_recorder_match_jax():
    xs = np.random.default_rng(3).random(3000)
    for cap, seed in ((64, 17), (2048, 29)):
        a, b = telemetry.Reservoir(cap, seed), jtelemetry.Reservoir(cap, seed)
        a.extend(xs)
        b.extend(xs)
        assert a.values == b.values and a.n_seen == b.n_seen
        assert a.mean == b.mean and a.percentile(99) == b.percentile(99)

    def filled(mod):
        st = mod.ServeStats(page_size=16, kv_pages_total=12)
        st.prefill_s, st.decode_s = 0.1234567, 2.5
        st.prefill_tokens, st.decode_tokens, st.decode_steps = 100, 50, 10
        st.admitted, st.completed, st.prefill_batches = 6, 6, 3
        st.ttft_samples.extend(xs[:300])
        st.ttft_s_sum, st.ttft_s_max = float(xs[:300].sum()), 0.99
        st.tpot_samples.extend(xs[300:2600])
        st.preemptions, st.rejections, st.cancelled, st.shed = 1, 2, 1, 1
        st.kv_pages_peak, st.admission_stalls = 9, 4
        st.device.update({"keep_rate": 0.5, "expert_load_imbalance": 1.2})
        return st
    assert filled(engine).as_dict() == filled(jengine).as_dict()
    assert list(filled(engine).as_dict()) == list(filled(jengine).as_dict())
    assert engine.ServeStats().as_dict() == jengine.ServeStats().as_dict()

    rng = np.random.default_rng(4)
    trees = [{"tel_attn_kept": rng.random((2, 3)),
              "tel_attn_elig": 2 + rng.random((2, 3)),
              "tel_expert_load": rng.random((2, 3, 8)),
              "tel_expert_drop": rng.random(2),
              "pages_allocated": np.array(3.0),
              "sampled_tokens": np.array(5.0),
              "decode_tokens": np.array(7.0)} for _ in range(3)]
    recs = []
    for mod in (telemetry, jtelemetry):
        rec = mod.TelemetryRecorder(mode="trace", time_origin=1.0)
        for tr in trees + [None]:
            rec.drain_counters(tr)
        rec.event(3, "submit", 2.0, prompt_len=4)
        rec.event(None, "tick", 2.5)
        rec.span("decode_chunk", 2.0, 2.5, 0, steps=4)
        rec.gauge("queue_depth", 2.5, 3)
        recs.append(rec)
    a, b = recs
    assert a.device_aggregates() == b.device_aggregates()
    assert a.expert_load_vector() == b.expert_load_vector()
    assert a.counter_drains == b.counter_drains == 3
    assert a.timeline(3) == b.timeline(3)
    assert a.recent_events() == b.recent_events()
    assert trace_export.chrome_trace(a) == jtrace.chrome_trace(b)


# ------------------------------------------------------ device counters
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_device_aggregates_match_jax(layout):
    jeng, eng = _pair(layout, num_slots=2)
    prompts = _prompts([8, 11, 6, 9, 13])
    jeng.run([jengine.Request(uid=i, tokens=p, max_new_tokens=GEN)
              for i, p in enumerate(prompts)])
    eng.run([engine.Request(uid=i, tokens=p, max_new_tokens=GEN)
             for i, p in enumerate(prompts)])
    want, got = jeng.last_stats.device, eng.last_stats.device
    assert set(got) == set(want)
    assert {"keep_rate", "expert_load_imbalance", "expert_tokens_routed",
            "counted_decode_tokens"} <= set(got)
    assert ("pages_allocated_in_loop" in got) == (layout == "paged")
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=0), k
    a, b = eng.last_recorder, jeng.last_recorder
    for k in ("attn_kept", "attn_elig", "expert_dropped", "pages_allocated",
              "counted_decode_tokens", "counter_drains"):
        assert getattr(a, k) == pytest.approx(getattr(b, k), rel=1e-6), k
    np.testing.assert_allclose(a.expert_load, b.expert_load, rtol=1e-6)
    assert eng.last_stats.decode_tokens == a.counted_decode_tokens


def test_counter_drains_match_a_stepwise_replay():
    """One slot, greedy: the chunk's accumulated counters equal a replay
    through lm_prefill_ragged / lm_decode_step with return_counters."""
    _, eng = _pair(num_slots=1)
    prompt = _prompts([8])[0]
    eng.run([engine.Request(uid=0, tokens=prompt, max_new_tokens=GEN)])
    rec = eng.last_recorder
    assert rec.counter_drains >= 2                   # prefill + chunks
    model, cfg = eng.model, eng.cfg
    toks = torch.tensor([prompt])
    _, logits, telp = transformer.lm_prefill_ragged(
        model, cfg, {"tokens": toks}, torch.tensor([8]), MAX_LEN,
        return_counters=True)
    assert set(telp) == {"tel_expert_load", "tel_expert_drop"}
    caches, lg = transformer.lm_prefill(model, cfg, {"tokens": toks},
                                        MAX_LEN)
    tok = lg[:, -1].argmax(-1)
    kept = elig = 0.0
    load = telp["tel_expert_load"].double().reshape(-1, 8).sum(0)
    for i in range(GEN - 1):
        pos = torch.tensor([8 + i])
        valid = torch.arange(MAX_LEN)[None] <= pos[:, None]
        lg, tel = transformer.lm_decode_step(
            model, cfg, caches, tok, pos, kv_valid=valid,
            return_counters=True)
        kept += float(tel["tel_attn_kept"].sum())
        elig += float(tel["tel_attn_elig"].sum())
        load = load + tel["tel_expert_load"].double().reshape(-1, 8).sum(0)
        tok = lg[:, -1].argmax(-1)
    assert rec.attn_kept == kept and rec.attn_elig == elig
    np.testing.assert_array_equal(rec.expert_load, load.numpy())
    assert rec.counted_decode_tokens == GEN - 1
    assert rec.sampled_tokens == 0.0 and rec.pages_allocated == 0.0


def test_streams_identical_across_telemetry_modes(monkeypatch):
    reqs = [engine.Request(uid=i, tokens=p, max_new_tokens=GEN,
                           temperature=0.1 if i % 2 else 0.0, top_k=6)
            for i, p in enumerate(_prompts([8, 11, 6, 9]))]
    outs, dicts = {}, {}
    for mode in ("off", "counters", "trace"):
        with monkeypatch.context() as m:
            if mode == "off":                 # no counter code may run
                def refuse(*a, **k):
                    raise AssertionError("counter work with telemetry off")
                m.setattr(attention, "_tel_decode_counters", refuse)
                m.setattr(ffn, "_tel_expert_load", refuse)
            _, eng = _pair(telemetry=mode, num_slots=2)
            outs[mode] = ([c.tokens for c in eng.run(reqs)],
                          [c.tokens for c in eng.run(reqs, seed=2)])
            dicts[mode] = eng.last_stats.as_dict()
            if mode == "off":
                assert eng.last_recorder is None
    assert outs["off"] == outs["counters"] == outs["trace"]
    assert set(dicts["off"]) <= set(engine.ServeStats.LEGACY_ORDER)
    assert {"keep_rate", "sampled_tokens"} <= set(dicts["counters"])
    assert dicts["trace"]["sampled_tokens"] == 2 * (GEN - 1)


# ------------------------------------------------- timelines and traces
def _traced(mod, eng):
    """uid 0 is force-preempted mid-stream and resumed, uid 1 sheds on a
    lapsed TTFT deadline, uid 2 is cancelled while queued, uid 3 retires,
    uid 99 (oversized, injected mid-run) is rejected."""
    pr = _prompts([8, 8, 8, 8])
    reqs = [mod.Request(uid=0, tokens=pr[0], max_new_tokens=10),
            mod.Request(uid=1, tokens=pr[1], max_new_tokens=4,
                        deadline_s=0.5),
            mod.Request(uid=2, tokens=pr[2], max_new_tokens=4),
            mod.Request(uid=3, tokens=pr[3], max_new_tokens=4)]

    def hook(e, iteration):
        if iteration == 2:
            assert e.preempt()
            assert e.cancel(2)
            e.submit(mod.Request(uid=99, tokens=[1] * 4,
                                 max_new_tokens=MAX_LEN + 1))
    out = eng.serve(mod.ArrivalSchedule.burst(reqs),
                    clock=mod.ManualClock(dt=1.0), on_iteration=hook)
    return {c.uid: c for c in out}


@pytest.fixture(scope="module")
def traced_runs():
    jeng, eng = _pair(telemetry="trace", num_slots=1)
    return (_traced(jengine, jeng), jeng.last_recorder,
            _traced(engine, eng), eng.last_recorder)


def test_timelines_match_jax(traced_runs):
    jby, jrec, by, rec = traced_runs
    assert {u: c.finish_reason for u, c in by.items()} == {
        0: "length", 1: "shed", 2: "cancelled", 3: "length", 99: "rejected"}
    assert [(c.tokens, c.finish_reason, c.preemptions) for c in by.values()] \
        == [(c.tokens, c.finish_reason, c.preemptions) for c in jby.values()]
    names = {u: [e["event"] for e in rec.timeline(u)] for u in by}
    assert names == {u: [e["event"] for e in jrec.timeline(u)] for u in jby}
    assert names[0][:4] == ["submit", "queued", "admitted", "first_token"]
    assert names[0].index("preempted") < names[0].index("resumed")
    assert names[1] == ["submit", "queued", "shed"]
    assert names[99] == ["submit", "rejected"]
    fields = {u: [sorted(e) for e in rec.timeline(u)] for u in by}
    assert fields == {u: [sorted(e) for e in jrec.timeline(u)] for u in jby}
    for u in by:
        ts = [e["t"] for e in rec.timeline(u)]
        assert ts == sorted(ts)
    assert rec.timeline(0)[-1]["n_gen"] == len(by[0].tokens)
    assert ([s.name for s in rec.spans] == [s.name for s in jrec.spans])


def test_chrome_trace_is_valid_and_covers_every_uid(traced_runs, tmp_path):
    _, _, by, rec = traced_runs
    path = tmp_path / "trace.json"
    trace = trace_export.write_trace(rec, str(path))
    on_disk = json.loads(path.read_text())
    for check in (trace_export.validate_chrome_trace,
                  jtrace.validate_chrome_trace):
        assert check(trace) == [] and check(on_disk) == []
    assert set(by) <= trace_export.trace_uids(on_disk)
    assert trace_export.trace_uids(on_disk) == jtrace.trace_uids(on_disk)
    names = {e["name"] for e in on_disk["traceEvents"]}
    assert {"decode_chunk", "prefill_batch", "queued", "generate",
            "queue_depth", "active_slots"} <= names
    jl = tmp_path / "events.jsonl"
    n = trace_export.write_events_jsonl(rec, str(jl))
    assert n == len(rec.events) == len(jl.read_text().splitlines())
    assert trace_export.validate_chrome_trace({"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 0, "name": "x", "ts": -1.0}]})
