"""The port's chaos harness (serving/chaos.py) against the JAX
package's: a seeded ``ChaosMonkey`` soak (mid-stream and queued cancels,
forced and pressure preemptions, duplicate and oversized submissions,
page-pool hogs) over Poisson arrivals on a ManualClock, with the
``Watchdog`` checking every invariant after every scheduling iteration,
on the contiguous and paged layouts: no invariant failure, and the
completions and the report equal JAX's soak of the same seed.  A broken
allocator state trips the watchdog, which dumps the flight recorder.
JAX runs its plain paths, the port the kernel config (plain versions on
the CPU); f32, the same JAX params in both.
"""
import numpy as np
import pytest

from repro.serving import chaos as jchaos
from repro.serving import engine as jengine
from repro_torch.serving import chaos, engine
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_server import MAX_LEN, completions, engines


def _soak_requests(mod, n=24, seed=11):
    rng = np.random.default_rng(seed)
    return [mod.Request(
        uid=i, tokens=rng.integers(0, 256, size=int(rng.integers(4, 17))
                                   ).tolist(),
        max_new_tokens=int(rng.integers(2, 9)),
        priority=int(rng.integers(0, 3))) for i in range(n)]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chaos_soak_matches_jax(layout):
    jeng, eng = engines(layout, num_slots=4, decode_chunk=4,
                        kv_pages=8 if layout == "paged" else None)
    res = {}
    for name, mod, ch, e in (("jax", jengine, jchaos, jeng),
                             ("port", engine, chaos, eng)):
        monkey = ch.ChaosMonkey(11, cancel_p=0.15, preempt_p=0.2, dup_p=0.1,
                                oversized_p=0.1, hog_p=0.1,
                                force_preempt_at=3)
        wd = ch.Watchdog()
        out, report = ch.run_soak(e, _soak_requests(mod), seed=11,
                                  monkey=monkey, watchdog=wd)
        res[name] = (completions(out), report, wd.iterations)
    assert res["port"] == res["jax"]
    out, report, iterations = res["port"]
    assert eng._live is None and iterations == report["iterations"] > 8
    assert len(out) == eng.last_stats.submitted > 24
    assert sorted(c[0] for c in out if c[0] < 24 and c[2] != "rejected") \
        == list(range(24))                          # nothing lost or duped
    inj = report["injected"]
    assert inj["forced_preempt"] == 1 and inj["cancel"] >= 1
    assert report["rejections"] >= 1 and report["preemptions"] >= 2
    if layout == "paged":
        assert eng.last_stats.admission_stalls >= 1   # the hogs' pressure


def test_watchdog_trips_on_a_broken_allocator(capsys):
    """A page that appears from nowhere breaks page conservation: the
    watchdog raises at that iteration, dumps the metrics and recent
    events (telemetry trace), and the engine leaves its live state."""
    _, eng = engines("paged", num_slots=2, decode_chunk=2)
    eng = engine.Engine(eng.cfg.with_spt(telemetry="trace"), eng.model,
                        max_len=MAX_LEN, num_slots=2, decode_chunk=2,
                        device="cpu")

    def corrupt(e, iteration):
        if iteration == 2:
            e._live.astate["top"] += 1         # a page appears from nowhere
    reqs = _soak_requests(engine, n=3)
    with pytest.raises(AssertionError, match="page conservation"):
        eng.run(reqs, on_iteration=chaos.compose(corrupt, chaos.Watchdog()))
    assert "WATCHDOG DUMP" in capsys.readouterr().err
    assert eng._live is None
