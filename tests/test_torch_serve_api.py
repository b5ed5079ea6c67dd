"""The port's prefill scheduler and serve launcher, against the JAX
package's.

  * the prefill scheduler: ``prefill_batch`` in {1, 2, slots} x
    ``prefill_decode_ratio`` in {0, 0.5} give greedy streams equal to
    JAX's with the same knobs and to the port's serial admission, with
    JAX's prefill-batch counts;
  * the launcher ``repro_torch.launch.serve --device cpu --smoke`` with
    arrivals, priorities, deadlines, telemetry, a trace and sampling
    prints one JSON blob with the JAX launcher's keys.
JAX runs its plain paths, the port the kernel config (plain versions on
the CPU); f32, the same JAX params in both.
"""
import json

import numpy as np
import pytest

from repro.serving import engine as jengine
from repro.serving import telemetry as jtelemetry
from repro_torch.launch import serve
from repro_torch.serving import engine, trace_export
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_server import engines, stat_ints

MAX_LEN, SLOTS, GEN, CHUNK = 48, 3, 6, 4
LENS = [16, 5, 23, 9, 12, 7]


def _reqs(mod, lens, gen=GEN, seed=1):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, tokens=rng.integers(0, 256, size=n).tolist(),
                        max_new_tokens=gen) for i, n in enumerate(lens)]


@pytest.fixture(scope="module")
def serial_streams():
    _, eng = engines("contiguous", max_len=MAX_LEN, num_slots=SLOTS,
                     decode_chunk=CHUNK, prefill_batch=1)
    return [c.tokens for c in eng.run(_reqs(engine, LENS))]


@pytest.fixture(scope="module")
def jax_engine():
    """One JAX engine for every case: the scheduler knobs are host-side
    attributes, so its compiled prefill buckets and decode chunk serve
    all six cases."""
    return engines("contiguous", max_len=MAX_LEN, num_slots=SLOTS,
                   decode_chunk=CHUNK)[0]


@pytest.mark.parametrize("batch", [1, 2, SLOTS])
@pytest.mark.parametrize("ratio", [0.0, 0.5])
def test_prefill_scheduler_matches_jax(batch, ratio, serial_streams,
                                       jax_engine):
    _, eng = engines("contiguous", max_len=MAX_LEN, num_slots=SLOTS,
                     decode_chunk=CHUNK, prefill_batch=batch,
                     prefill_decode_ratio=ratio)
    jeng = jax_engine            # with this case's knobs, as JAX sets them
    knobs = jengine.Engine(jeng.cfg, jeng.params, max_len=MAX_LEN,
                           num_slots=SLOTS, prefill_batch=batch,
                           prefill_decode_ratio=ratio)
    jeng.prefill_batch = knobs.prefill_batch
    jeng.prefill_decode_ratio = knobs.prefill_decode_ratio
    want = jeng.run(_reqs(jengine, LENS))
    got = eng.run(_reqs(engine, LENS))
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.tokens for c in got] == serial_streams
    assert stat_ints(eng) == stat_ints(jeng)
    st = eng.last_stats
    assert st.prefill_batch_occupancy == jeng.last_stats.prefill_batch_occupancy
    assert st.admitted == st.completed == len(LENS)
    if batch == 1:
        assert st.prefill_batches == len(LENS)
    elif ratio == 0.0:
        assert st.prefill_batches < len(LENS)       # groups did batch


# ------------------------------------------------------------ launcher
JAX_TOP = {"arch", "requests", "slots", "generated_tokens", "warmup_wall_s",
           "steady_wall_s", "finish_reasons", "sample"}


def _jax_device_keys():
    """Every aggregate the JAX recorder can report (a drain of every
    counter it folds)."""
    rec = jtelemetry.TelemetryRecorder(mode="counters")
    rec.drain_counters({"tel_attn_kept": np.ones(2), "tel_attn_elig":
                        np.ones(2), "tel_expert_load": np.ones((1, 2)),
                        "tel_expert_drop": np.ones(1),
                        "pages_allocated": np.ones(()),
                        "sampled_tokens": np.ones(()),
                        "decode_tokens": np.ones(())})
    return set(rec.device_aggregates())


@pytest.mark.parametrize("flags", [
    ["--arrival-qps", "4", "--priorities", "--deadline-s", "2"],
    ["--telemetry", "trace", "--trace-out", "{tmp}/trace.json",
     "--metrics-out", "{tmp}/metrics.json"],
    ["--temperature", "0.8", "--top-p", "0.9", "--top-k", "20"],
    ["--kv-layout", "paged", "--page-size", "16", "--ragged", "--eos-id",
     "5", "--prefill-batch", "2", "--prefill-decode-ratio", "0.5",
     "--telemetry", "counters", "--decode-chunk", "4"],
], ids=["arrivals", "trace", "sampling", "paged-counters"])
def test_launcher_prints_the_jax_keys(flags, tmp_path, capsys):
    flags = [f.replace("{tmp}", str(tmp_path)) for f in flags]
    assert serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                       "--requests", "6", "--prompt-len", "12", "--gen", "5",
                       "--slots", "2", *flags]) == 0
    out = json.loads(capsys.readouterr().out)
    paged = "--kv-layout" in flags
    stats = set(jengine.ServeStats(kv_pages_total=int(paged)).as_dict())
    want = JAX_TOP | stats
    if "--trace-out" in flags:
        want |= {"trace_out", "trace_events"}
    if "--metrics-out" in flags:
        want |= {"metrics_out"}
    device = set(out) - want - {"device", "device_name"}
    assert device <= _jax_device_keys()
    assert bool(device) == ("--telemetry" in flags)
    assert want <= set(out)
    assert out["device"] == "cpu" and out["requests"] == 6
    assert out["admitted"] + out["shed"] == 6
    if "--trace-out" in flags:
        trace = json.loads((tmp_path / "trace.json").read_text())
        assert trace_export.validate_chrome_trace(trace) == []
        assert trace_export.trace_uids(trace) >= set(range(6))
        assert json.loads((tmp_path / "metrics.json").read_text())[
            "completed"] == 6
