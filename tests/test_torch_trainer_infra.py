"""The port's fine-tuning infrastructure against the JAX package's, on the
CPU: checkpoint/restart in ``Trainer`` (a run split 4 + 2 steps equals
the uninterrupted one exactly, and JAX's Trainer to f32 rounding), the
eager checkpoint of the straggler monitor, SIGTERM (only ever sent by a
child process to itself), the launcher's ``--ckpt``, and the modules
copied or ported beside them: ``train/straggler.py``,
``optim/compress.py``, ``launch/roofline.py`` (``active_params`` and
``model_flops`` equal to JAX's for every config) and the diagnostics
``sparse_attention._combined_score`` / ``select_topl`` /
``selection_recall``, ``lora.merge``, ``params.param_bytes`` and
``tree_paths``.  Training runs the qwen3 smoke config in f32 on its
oracle paths; every file is written under ``tmp_path``.
"""
import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import lora as jlora
from repro.core import params as jparams
from repro.core import pq as jpq
from repro.core import sparse_attention as jsa
from repro.data import pipeline as jpipeline
from repro.launch import roofline as jroofline
from repro.launch.dryrun import apply_variant as japply
from repro.optim import compress as jcompress
from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
from repro.train import state as JS
from repro.train import straggler as jstraggler
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.core import lora, params, pq
from repro_torch.core import sparse_attention as sa
from repro_torch.core.params import from_numpy_state
from repro_torch.data import pipeline
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import apply_variant
from repro_torch.launch import train as train_launcher
from repro_torch.optim import compress
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train import checkpoint, straggler
from repro_torch.train.state import model_defs
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_checkpoint import assert_same_tree
from test_torch_model import np_init_tree, port_cfg, t

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
STEPS = 6
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)
DCFG = dict(vocab_size=256, seq_len=32, global_batch=2, kind="random",
            seed=3)
LOSS_RTOL = 1e-5    # f32, 6 AdamW steps: JAX and the port sum in other orders


@pytest.fixture(autouse=True)
def keep_process_state():
    """Every Trainer installs a SIGTERM handler: put the previous one
    back; run torch on one thread and put the thread count back."""
    handler = signal.getsignal(signal.SIGTERM)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    signal.signal(signal.SIGTERM, handler)


def _jcfg():
    return dataclasses.replace(jconfigs.get_smoke("qwen3-0.6b"),
                               dtype=jnp.float32)


def _np_state(jcfg):
    """A JAX train state (init_state's layout) as numpy, from
    ``np_init_tree`` with the frozen leaves in f32 (as the f32 config
    computes); LoRA c leaves start at zero."""
    defs = JS.model_defs(jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  np_init_tree(defs, 0))
    train, frozen = jparams.partition(tree, jparams.trainable_mask(defs))
    zeros = lambda a: np.zeros(a.shape, np.float32)       # noqa: E731
    return {"step": np.zeros((), np.int32), "train": train, "frozen": frozen,
            "opt": {"m": jax.tree_util.tree_map(zeros, train),
                    "v": jax.tree_util.tree_map(zeros, train)}}


def _batches(mod):
    return list(mod.synthetic_dataset(mod.DataConfig(**DCFG), STEPS))


def _losses(report):
    return [m["loss"] for m in report["metrics"]]


@pytest.fixture(scope="module")
def runs():
    """The JAX Trainer and the port's over the same 6 batches from the
    same state, uninterrupted.  JAX's init_state, whose result the test
    replaces, is skipped; both trainers' SIGTERM handlers and the torch
    thread count are put back."""
    jcfg = _jcfg()
    st = _np_state(jcfg)
    handler = signal.getsignal(signal.SIGTERM)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JS, "init_state", lambda cfg, key: None)
            jtr = JTrainer(jcfg, JOptimizerConfig(**OCFG),
                           JTrainerConfig(total_steps=STEPS, log_interval=1))
        jtr.state = jax.tree_util.tree_map(jnp.asarray, st)
        jrep = jtr.run(iter(_batches(jpipeline)))
        tr = Trainer(port_cfg(jcfg), OptimizerConfig(**OCFG),
                     TrainerConfig(total_steps=STEPS, log_interval=1),
                     state=from_numpy_state(st, "cpu"))
        rep = tr.run(iter(_batches(pipeline)))
    finally:
        torch.set_num_threads(threads)
        signal.signal(signal.SIGTERM, handler)
    return {"jcfg": jcfg, "state": st, "jax": jrep, "port": rep,
            "final": tr.state}


def _split_run(runs, ckpt_dir, first=4):
    """The port's run stopped after ``first`` steps (checkpoints every 2)
    and resumed by a fresh Trainer: (first trainer, its report, second
    trainer, its report)."""
    cfg = port_cfg(runs["jcfg"])
    batches = _batches(pipeline)
    tcfg = dict(ckpt_dir=str(ckpt_dir), ckpt_interval=2, log_interval=1)
    a = Trainer(cfg, OptimizerConfig(**OCFG),
                TrainerConfig(total_steps=first, **tcfg),
                state=from_numpy_state(runs["state"], "cpu"))
    rep_a = a.run(iter(batches))
    b = Trainer(cfg, OptimizerConfig(**OCFG),
                TrainerConfig(total_steps=STEPS, **tcfg),
                state=from_numpy_state(runs["state"], "cpu"))
    rep_b = b.run(iter(batches[b.start_step:]))
    return a, rep_a, b, rep_b


# ------------------------------------------------------------ the Trainer
def test_port_trainer_matches_jax_trainer(runs):
    jm, m = runs["jax"]["metrics"], runs["port"]["metrics"]
    assert [r["step"] for r in m] == [r["step"] for r in jm] == list(
        range(1, STEPS + 1))
    for key in ("loss", "lm_loss", "grad_norm", "lr"):
        np.testing.assert_allclose([r[key] for r in m], [r[key] for r in jm],
                                   rtol=LOSS_RTOL, err_msg=key)
    for rep in (runs["jax"], runs["port"]):
        assert rep["final_step"] == STEPS and not rep["interrupted"]
        assert rep["straggler"]["steps"] == STEPS


def test_split_run_resumes_exactly(runs, tmp_path):
    """4 steps, checkpoints at 2 and 4, then a fresh Trainer on the same
    directory: start_step 4, the saved state bit for bit, and the
    uninterrupted run's losses exactly."""
    a, rep_a, b, rep_b = _split_run(runs, tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004", "step_00000006"]
    assert b.start_step == rep_a["final_step"] == 4
    restored = checkpoint.restore(str(tmp_path), step=4, device="cpu")
    assert_same_tree(restored, a.state)
    assert int(restored["step"]) == 4
    assert rep_b["final_step"] == STEPS
    assert rep_b["straggler"]["steps"] == STEPS - 4
    assert _losses(rep_a) + _losses(rep_b) == _losses(runs["port"])
    assert_same_tree(b.state, runs["final"])


def test_eager_checkpoint_fires_when_the_monitor_acts(runs, tmp_path,
                                                      monkeypatch):
    tr = Trainer(port_cfg(runs["jcfg"]), OptimizerConfig(**OCFG),
                 TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path),
                               ckpt_interval=100, log_interval=1),
                 state=from_numpy_state(runs["state"], "cpu"))
    monkeypatch.setattr(tr.monitor, "should_act",
                        lambda: len(tr.monitor.times) == 2)
    rep = tr.run(iter(_batches(pipeline)))
    assert {"step": 2, "action": "eager_checkpoint"} in tr.monitor.events
    assert rep["straggler"]["events"] == [{"step": 2,
                                           "action": "eager_checkpoint"}]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003"]


def test_sigterm_flag_stops_before_the_next_step(runs, tmp_path):
    """``_on_sigterm`` (the handler, called directly) ends the run before
    its next step; the final checkpoint is still written."""
    tr = Trainer(port_cfg(runs["jcfg"]), OptimizerConfig(**OCFG),
                 TrainerConfig(total_steps=STEPS, ckpt_dir=str(tmp_path),
                               log_interval=1),
                 state=from_numpy_state(runs["state"], "cpu"))
    assert signal.getsignal(signal.SIGTERM) == tr._on_sigterm
    calls = []

    def hook(step, metrics):
        calls.append(step)
        if step == 2:
            tr._on_sigterm(signal.SIGTERM, None)

    rep = tr.run(iter(_batches(pipeline)), step_hook=hook)
    assert calls == [1, 2] and rep["final_step"] == 2 and rep["interrupted"]
    assert checkpoint.latest_step(str(tmp_path)) == 2


CHILD = """
import dataclasses, json, os, signal, sys
import torch
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

cfg = dataclasses.replace(configs.get_smoke("qwen3-0.6b"),
                          dtype=torch.float32)
tr = Trainer(cfg, OptimizerConfig(**{ocfg}),
             TrainerConfig(total_steps={steps}, ckpt_dir=sys.argv[1],
                           ckpt_interval=2, log_interval=1),
             device="cpu")
assert tr.start_step == 0

def hook(step, metrics):
    if step == 3:
        os.kill(os.getpid(), signal.SIGTERM)     # this child, no other

rep = tr.run(pipeline.synthetic_dataset(pipeline.DataConfig(**{dcfg}),
                                        {steps}), step_hook=hook)
print(json.dumps(rep))
"""


def test_sigterm_in_a_child_leaves_a_checkpoint_to_resume(runs, tmp_path):
    """A child process restores the start state from a step-0 checkpoint
    written here, trains, signals itself SIGTERM after step 3 and exits
    cleanly with ``interrupted`` and its step-3 checkpoint; a Trainer
    here resumes from that and reaches the uninterrupted run's losses
    and state exactly."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3-0.6b"),
                              dtype=torch.float32)
    assert cfg == port_cfg(runs["jcfg"])
    checkpoint.save(from_numpy_state(runs["state"], "cpu"), 0,
                    str(tmp_path))
    code = CHILD.format(ocfg=OCFG, steps=STEPS, dcfg=DCFG)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["interrupted"] and rep["final_step"] == 3
    assert rep["straggler"]["steps"] == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000000", "step_00000002", "step_00000003"]
    resumed = Trainer(cfg, OptimizerConfig(**OCFG),
                      TrainerConfig(total_steps=STEPS,
                                    ckpt_dir=str(tmp_path), log_interval=1),
                      device="cpu")
    assert resumed.start_step == 3 and int(resumed.state["step"]) == 3
    tail = resumed.run(iter(_batches(pipeline)[3:]))
    assert _losses(rep) + _losses(tail) == _losses(runs["port"])
    assert_same_tree(resumed.state, runs["final"])


def test_launcher_ckpt_resumes(tmp_path, capsys):
    """``--ckpt`` run twice: the second run resumes at step 2 and takes
    the batches from there on, so its step 3 is the uninterrupted run's
    (JAX's launcher starts its stream over instead)."""
    args = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "32"]
    ckpt = ["--ckpt", str(tmp_path / "ckpt")]
    assert train_launcher.main([*args, *ckpt, "--steps", "2"]) == 0
    first = json.loads(capsys.readouterr().out)
    assert (first["start_step"], first["final_step"]) == (0, 2)
    assert checkpoint.latest_step(str(tmp_path / "ckpt")) == 2
    assert train_launcher.main([*args, *ckpt, "--steps", "3"]) == 0
    second = json.loads(capsys.readouterr().out)
    assert (second["start_step"], second["final_step"]) == (2, 3)
    assert second["straggler"]["steps"] == 1 and not second["interrupted"]
    assert checkpoint.latest_step(str(tmp_path / "ckpt")) == 3
    assert train_launcher.main([*args, "--steps", "3"]) == 0
    whole = json.loads(capsys.readouterr().out)
    assert second["last_metrics"] == whole["last_metrics"]
    assert whole["last_metrics"]["step"] == 3


# ------------------------------------------------------------ straggler
@pytest.mark.parametrize("scfg", [
    {}, dict(window=8, z_threshold=2.0, min_samples=4, act_density=0.25)],
    ids=["default", "small-window"])
def test_straggler_monitor_matches_jax(scfg):
    """The same step times through ``record`` (no clock, no sleep):
    flags, events, should_act and the summary step for step."""
    rng = np.random.default_rng(0)
    times = 1.0 + 0.01 * rng.standard_normal(40)
    times[[12, 20, 21, 22, 30, 31, 33]] *= 3.0
    jm = jstraggler.StepTimeMonitor(jstraggler.StragglerConfig(**scfg))
    m = straggler.StepTimeMonitor(straggler.StragglerConfig(**scfg))
    acted = 0
    for step, dt in enumerate(times.tolist()):
        assert m.record(step, dt) == jm.record(step, dt)
        assert m.should_act() == jm.should_act()
        acted += m.should_act()
    assert m.summary() == jm.summary()
    assert m.summary()["flagged"] > 0 and acted > 0


# ------------------------------------------------------------ compression
def _grad_tree(rng):
    tied = np.array([0.5, -2.0, 2.0, 0.5, -0.5, 1.0, -2.0, 0.0, 0.5, 1.0],
                    np.float32)
    return {"lora": {"b": rng.standard_normal((6, 4)).astype(np.float32),
                     "c": tied},
            "frozen": None}


def assert_same_packets(got, want):
    """Packet trees equal: None holes, tuple shapes, and each array's
    dtype and values."""
    if want is None or isinstance(want, tuple):
        assert got == want
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same_packets(got[k], want[k])
    else:
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scheme,frac", [("int8", 0.1), ("topk", 0.1),
                                         ("topk", 0.45), ("none", 0.1)])
def test_compression_matches_jax(scheme, frac):
    """Packets and round trips equal JAX's; under topk, magnitude ties
    (the c leaf: |2.0| x 3, |1.0| x 2, |0.5| x 4) keep the lower indices
    first, as ``jax.lax.top_k`` does."""
    tree = _grad_tree(np.random.default_rng(1))
    jc = jcompress.CompressionConfig(scheme, frac)
    c = compress.CompressionConfig(scheme, frac)
    jpk = jcompress.compress_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                                  jc)
    pk = compress.compress_tree(jax.tree_util.tree_map(t, tree), c)
    assert_same_packets(pk, jpk)
    if scheme == "topk":
        assert pk["lora"]["c"]["idx"].tolist() == [1, 2, 6, 5][:int(10 * frac)]
    assert_same_packets(compress.decompress_tree(pk, c),
                        jcompress.decompress_tree(jpk, jc))


# ------------------------------------------------------------ roofline
def _registry():
    return [*jconfigs.ARCH_NAMES, "opt-1024", "opt-2048", "opt-2560",
            "llama-2560", "llama-4096", "opt-2.7b", "llama-2.7b"]


def test_active_params_and_model_flops_equal_jax_for_every_config():
    names = _registry()
    assert set(configs.ARCH_NAMES) <= set(names)
    for name in names:
        jcfg, cfg = jconfigs.get_config(name), configs.get_config(name)
        assert roofline.active_params(cfg) == jroofline.active_params(jcfg)
        assert (roofline.model_flops(cfg, 4096)
                == jroofline.model_flops(jcfg, 4096))
        for variant in ("lora", "full"):
            assert (roofline.active_params(apply_variant(cfg, variant))
                    == jroofline.active_params(japply(jcfg, variant)))


@pytest.mark.parametrize("flops,hbm,coll", [(1e15, 1e9, 0.0),
                                            (1e12, 1e12, 0.0),
                                            (1e12, 1e9, 1e12)])
def test_roofline_terms_on_the_h100_datasheet(flops, hbm, coll):
    """JAX's terms with the H100 SXM peaks in place of the TPU's."""
    assert (roofline.PEAK_FLOPS, roofline.PEAK_FLOPS_F32,
            roofline.HBM_BW) == (989e12, 67e12, 3.35e12)
    r = roofline.Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
                          coll_by_kind={"all-reduce": int(coll)})
    jr = jroofline.Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
                            coll_by_kind={"all-reduce": int(coll)})
    terms = {"compute": flops / 989e12, "memory": hbm / 3.35e12,
             "collective": coll / roofline.NVLINK_BW}
    assert (r.t_compute, r.t_memory, r.t_collective) == tuple(
        terms.values())
    assert r.bottleneck == max(terms, key=terms.get)
    assert r.t_bound == max(terms.values())
    assert set(r.to_dict()) == set(jr.to_dict())


# ------------------------------------------------------------ diagnostics
def _scores(rng, shape, top):
    return rng.integers(0, top + 1, shape).astype(np.float32)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_select_topl_and_combined_score_match_jax(causal, window):
    """Integer scores with many ties, under causal / windowed masks whose
    rows hold fewer valid keys than L (masked entries tie at -1): the
    combined scores bit for bit, the indices and valid flags equal."""
    rng = np.random.default_rng(2)
    nq = nk = 12
    s = _scores(rng, (2, 3, nq, nk), 4)
    pos = np.arange(nk, dtype=np.int32)
    mask = np.asarray(jsa.attention_mask(jnp.asarray(pos), jnp.asarray(pos),
                                         causal, window))
    mask = np.broadcast_to(mask, s.shape)
    jc = jsa._combined_score(jnp.asarray(s), jnp.asarray(pos),
                             jnp.asarray(mask), nk)
    c = sa._combined_score(t(s), t(pos), t(mask), nk)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    for l in (1, 6, nk):
        jidx, jvalid = jsa.select_topl(jnp.asarray(s), l, jnp.asarray(mask))
        idx, valid = sa.select_topl(t(s), l, t(mask))
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("causal,window,gran", [
    (True, None, "qhead"), (True, 9, "qhead"), (False, None, "kvgroup")])
def test_selection_recall_matches_jax(causal, window, gran):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, 24, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 24, 16)).astype(np.float32)
    cb = rng.standard_normal((2, 8, 8)).astype(np.float32)
    jcfg = jsa.SparseAttentionConfig(
        pq=jpq.PQConfig(head_dim=16, code_dim=8, num_codewords=8),
        top_fraction=0.25, min_l=4, select_granularity=gran)
    cfg = sa.SparseAttentionConfig(
        pq=pq.PQConfig(head_dim=16, code_dim=8, num_codewords=8),
        top_fraction=0.25, min_l=4, select_granularity=gran)
    recall = jax.jit(jsa.selection_recall, static_argnums=(3, 4, 5))
    want = float(recall(jnp.asarray(q), jnp.asarray(k), jnp.asarray(cb),
                        jcfg, causal, window))
    got = sa.selection_recall(t(q), t(k), t(cb), cfg, causal, window)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert 0.0 < want < 1.0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("enabled", [True, False])
def test_lora_merge_matches_jax(enabled):
    rng = np.random.default_rng(4)
    p = {"w": rng.standard_normal((16, 24)).astype(np.float32),
         "lora": {"b": rng.standard_normal((16, 4)).astype(np.float32),
                  "c": rng.standard_normal((4, 24)).astype(np.float32)}}
    jcfg = jlora.LoRAConfig(rank=4, alpha=8.0, enabled=enabled)
    cfg = lora.LoRAConfig(rank=4, alpha=8.0, enabled=enabled)
    want = np.asarray(jlora.merge(jax.tree_util.tree_map(jnp.asarray, p),
                                  jcfg))
    got = lora.merge(jax.tree_util.tree_map(t, p), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if not enabled:
        np.testing.assert_array_equal(got.numpy(), p["w"])


def test_param_bytes_and_tree_paths_match_jax():
    for name in _registry():
        jdefs = JS.model_defs(jconfigs.get_config(name))
        defs = model_defs(configs.get_config(name))
        for only in (None, True, False):
            assert (params.param_bytes(defs, only)
                    == jparams.param_bytes(jdefs, only)), (name, only)
        assert params.tree_paths(defs) == jparams.tree_paths(jdefs)
    state = from_numpy_state(_np_state(_jcfg()), "cpu")
    assert params.tree_paths(state) == jparams.tree_paths(_np_state(_jcfg()))
