"""The port's Engine.run against the JAX Engine.run: same f32 params, same
requests (ragged prompts, more requests than slots, an EOS id that ends
some rows early while the others run to their budget), greedy token
streams equal.  The only accepted difference is a
genuine logit near-tie: at the first divergence the context is replayed
through the JAX ragged prefill and both tokens must be within 1e-3 of the
max logit (the rule of tests/test_sparse_decode.py); the rest of that row
is then conditioned on a different prefix and not compared.

The port runs with the kernel config (attn_impl/ffn_impl "pallas", whose
wrappers take their plain versions on the CPU) and under
REPRO_DISABLE_KERNELS=1 (the core/ oracle paths).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import transformer as jtransformer
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.serving.engine import Engine, Request
from test_torch_model import (jax_params, one_torch_thread,  # noqa: F401
                              port_model, smoke_cfg)

PROMPTS = [9, 14, 5, 11, 7]       # 5 ragged requests over 2 slots
EOS = 160                         # occurs mid-stream in this workload
MAX_LEN = 32


def _workload():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, size=n).tolist() for n in PROMPTS]


@pytest.fixture(scope="module")
def jax_streams():
    """One JAX engine run of the workload."""
    jcfg = smoke_cfg(attn_impl="pallas", ffn_impl="pallas")
    tree = jax_params(jcfg)
    eng = JEngine(jcfg, tree, max_len=MAX_LEN, num_slots=2, decode_chunk=4)
    reqs = [JRequest(uid=i, tokens=p, max_new_tokens=6)
            for i, p in enumerate(_workload())]
    out = [(c.tokens, c.finish_reason) for c in eng.run(reqs, eos_id=EOS)]
    return jcfg, tree, out


def _replay_gap(jcfg, tree, ctx, a, b):
    batch = {"tokens": jnp.asarray(np.asarray(ctx, np.int32)[None, :])}
    _, logits = jax.jit(lambda p, bt, n: jtransformer.lm_prefill_ragged(
        p, jcfg, bt, n, MAX_LEN))(tree, batch, jnp.asarray([len(ctx)]))
    lg = np.asarray(logits[0, -1], np.float32)
    return float(lg.max()) - min(float(lg[a]), float(lg[b]))


@pytest.mark.parametrize("disable_kernels", [False, True])
def test_engine_greedy_streams_match_jax(jax_streams, monkeypatch,
                                         disable_kernels):
    jcfg, tree, want = jax_streams
    if disable_kernels:
        monkeypatch.setenv("REPRO_DISABLE_KERNELS", "1")
    model = port_model(jcfg, tree)
    eng = Engine(model.cfg, model, max_len=MAX_LEN, num_slots=2,
                 decode_chunk=4, device="cpu")
    prompts = _workload()
    outs = eng.run([Request(uid=i, tokens=p, max_new_tokens=6)
                    for i, p in enumerate(prompts)], eos_id=EOS)
    reasons = {r for _, r in want}
    assert reasons == {"eos", "length"}                  # both exits fire
    st = eng.last_stats
    assert st.completed == st.admitted == len(prompts)
    assert st.prefill_batches >= 3                       # slots recycled
    for row, (prompt, got, (exp, reason)) in enumerate(
            zip(prompts, outs, want)):
        if got.tokens == exp:
            assert got.finish_reason == reason
            continue
        i = next(j for j, (a, b) in enumerate(zip(got.tokens, exp))
                 if a != b)
        gap = _replay_gap(jcfg, tree, prompt + exp[:i], got.tokens[i], exp[i])
        assert gap <= 1e-3, (
            f"row {row} diverged at step {i} with a logit gap {gap:.3e} "
            f"(tokens {got.tokens[i]} vs {exp[i]})")


def test_engine_rejects_invalid_requests_and_serves_the_rest():
    jcfg = smoke_cfg(attn_impl="pallas", ffn_impl="pallas")
    model = port_model(jcfg, jax_params(jcfg))
    eng = Engine(model.cfg, model, max_len=MAX_LEN, num_slots=2,
                 decode_chunk=4, device="cpu")
    ok = _workload()[:2]
    reqs = [Request(uid=0, tokens=ok[0], max_new_tokens=3),
            Request(uid=0, tokens=ok[1], max_new_tokens=3),      # dup uid
            Request(uid=2, tokens=[1] * 30, max_new_tokens=3),   # too long
            Request(uid=3, tokens=ok[1], max_new_tokens=0),
            Request(uid=4, tokens=ok[1], max_new_tokens=3)]
    outs = eng.run(reqs)
    assert [c.finish_reason for c in outs] == [
        "length", "rejected", "rejected", "rejected", "length"]
    assert [len(c.tokens) for c in outs] == [3, 0, 0, 0, 3]
    assert all(c.detail for c in outs[1:4])
    assert eng.last_stats.admitted == eng.last_stats.completed == 2


def test_greedy_argmax_spans_the_padded_vocabulary():
    """vocab 200 is padded to 256 embedding rows (random like the rest):
    the JAX engine's greedy argmax runs over all 256 columns, so it can
    emit an id >= vocab_size; the port's streams must equal JAX's, and
    this workload does emit such ids, so the test shows the difference
    from an argmax over the real vocabulary."""
    import dataclasses
    jcfg = dataclasses.replace(smoke_cfg(attn_impl="pallas",
                                         ffn_impl="pallas"), vocab_size=200)
    assert jcfg.padded_vocab == 256
    tree = jax_params(jcfg)
    prompts = [p[:6] for p in _workload()[:3]]
    prompts = [[tok % 200 for tok in p] for p in prompts]
    jeng = JEngine(jcfg, tree, max_len=MAX_LEN, num_slots=3, decode_chunk=4)
    want = [c.tokens for c in jeng.run(
        [JRequest(uid=i, tokens=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])]
    model = port_model(jcfg, tree)
    eng = Engine(model.cfg, model, max_len=MAX_LEN, num_slots=3,
                 decode_chunk=4, device="cpu")
    got = [c.tokens for c in eng.run(
        [Request(uid=i, tokens=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])]
    for prompt, g, w in zip(prompts, got, want):
        if g == w:
            continue
        i = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        gap = _replay_gap(jcfg, tree, prompt + w[:i], g[i], w[i])
        assert gap <= 1e-3, (g, w, gap)
    assert max(max(w) for w in want) >= jcfg.vocab_size
