"""The port's fine-tune step against the JAX package's, on the qwen3 smoke
shape (2 layers, d_model 64) in f32 with attn_impl / ffn_impl "pallas"
(the JAX kernels in interpret mode; the port's wrappers take their plain
versions on CPU tensors) and a vocabulary of 200 padded to 256, so the
loss's log-sum-exp runs over padded columns.  Both start from one JAX
``init_state`` (LoRA c leaves perturbed from zero, frozen leaves in f32)
carried over by ``from_numpy_state``, on the same batches (each package's
copy of the seeded random stream):

  * loss and every trainable leaf's gradient equal
    ``jax.value_and_grad`` of the ``build_train_step`` loss;
  * the state after one ``build_train_step`` step (train leaves, AdamW
    moments) and its metrics equal JAX's;
  * a 5-step ``Trainer`` loss curve equals the JAX Trainer's;
  * REPRO_DISABLE_KERNELS=1 does not change the port's loss;
  * ``launch/train.py --smoke --device cpu`` runs.

Tolerances (f32, the two packages sum in different orders): losses and
metrics to rel 1e-5; gradients and moments to max-abs <= 1e-4 x the
leaf's largest entry; parameters after AdamW to 1e-6 absolute (the first
AdamW step moves each entry by about lr x sign(g), here 1e-3).
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import params as JP
from repro.data import pipeline as jpipeline
from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
from repro.optim.adamw import adamw_update as jadamw_update
from repro.train import state as JS
from repro.train.loss import lm_cross_entropy as jlm_cross_entropy
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.core.params import from_numpy_state, leaves
from repro_torch.data import pipeline
from repro_torch.launch import steps
from repro_torch.optim.adamw import OptimizerConfig, adamw_update
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_model import perturb_lora, port_cfg, smoke_cfg
from test_torch_model import keep_sigterm  # noqa: F401

STEPS, BATCH, SEQ, CHUNK = 5, 2, 32, 16
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg():
    return dataclasses.replace(
        smoke_cfg(attn_impl="pallas", ffn_impl="pallas"), vocab_size=200)


def _np_state(jcfg):
    """JAX init_state as numpy: frozen leaves in f32, LoRA c perturbed."""
    st = JS.init_state(jcfg, jax.random.PRNGKey(0))
    st = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32 if a.dtype != jnp.int32
                             else np.int32), st)
    st["train"] = perturb_lora(st["train"], np.random.default_rng(1))
    return st


def _data(mod):
    cfg = mod.DataConfig(vocab_size=200, seq_len=SEQ, global_batch=BATCH,
                         kind="random", seed=3)
    return list(mod.synthetic_dataset(cfg, STEPS))


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """One JAX run: value_and_grad of the step's loss on batch 0, and a
    5-step Trainer whose hook keeps the state and metrics after step 1."""
    jcfg = _jcfg()
    state = _np_state(jcfg)
    batches = _data(jpipeline)
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    frozen = _jax_tree(state["frozen"])

    def loss_fn(train):                  # build_train_step's loss_fn
        params = JP.combine(train, frozen)
        hidden, aux = JS.model_hidden(params, jcfg, b0, remat=True)
        lm, _ = jlm_cross_entropy(params, jcfg, hidden, b0["labels"], CHUNK)
        return lm + jcfg.spt.lb_loss_weight * aux["lb_loss"] / jcfg.num_layers

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        _jax_tree(state["train"]))
    trainer = JTrainer(jcfg, JOptimizerConfig(**OCFG),
                       JTrainerConfig(total_steps=STEPS, log_interval=1,
                                      loss_chunk=CHUNK))
    trainer.state = _jax_tree(state)
    after_one = {}

    def hook(step, metrics):
        if step == 1:
            after_one["state"] = jax.tree_util.tree_map(np.asarray,
                                                        trainer.state)
            after_one["metrics"] = metrics

    report = trainer.run(iter(batches), step_hook=hook)
    return {"cfg": jcfg, "state": state, "batches": batches,
            "loss": float(loss), "grads": jax.tree_util.tree_map(
                np.asarray, grads),
            "after_one": after_one,
            "curve": [m["loss"] for m in report["metrics"]]}


def _port_state(jr):
    return from_numpy_state(jr["state"], "cpu")


def _batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _leaf_close(got, want, tol):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=tol * max(float(np.abs(w).max()), 1e-30))


def _zip_leaves(port_tree, jax_tree):
    got = list(leaves(port_tree))
    want = {tuple(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    assert {p for p, _ in got} == set(want)
    return [(p, v, want[p]) for p, v in got]


def test_pipeline_copy_yields_the_jax_batches(jax_run):
    for a, b in zip(_data(pipeline), jax_run["batches"]):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_train_step_loss_and_grads_match_jax(jax_run):
    cfg = port_cfg(jax_run["cfg"])
    loss, metrics, grads = steps.loss_and_grads(
        _port_state(jax_run), cfg, _batch(jax_run["batches"][0]), CHUNK)
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=LOSS_TOL)
    pairs = _zip_leaves(grads, jax_run["grads"])
    assert len(pairs) == len(list(leaves(_port_state(jax_run)["train"])))
    for path, got, want in pairs:
        if path[-1] == "codebooks":      # argmin: zero on both sides
            assert not got.any() and not np.asarray(want).any()
            continue
        assert np.abs(want).max() > 0, path
        _leaf_close(got, want, GRAD_TOL)


def test_train_step_state_and_metrics_match_jax(jax_run):
    cfg = port_cfg(jax_run["cfg"])
    step = steps.build_train_step(cfg, OptimizerConfig(**OCFG), CHUNK)
    new, metrics = step(_port_state(jax_run), _batch(jax_run["batches"][0]))
    want = jax_run["after_one"]
    assert int(new["step"]) == int(want["state"]["step"]) == 1
    for path, got, w in _zip_leaves(new["train"], want["state"]["train"]):
        _leaf_close(got, w, PARAM_TOL / max(float(np.abs(w).max()), 1e-30))
    for key in ("m", "v"):
        for path, got, w in _zip_leaves(new["opt"][key],
                                        want["state"]["opt"][key]):
            if np.abs(w).max() > 0:
                _leaf_close(got, w, GRAD_TOL)
            else:
                assert not got.any(), path
    assert set(metrics) == set(want["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), want["metrics"][k],
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=k)


def test_trainer_loss_curve_matches_jax(jax_run):
    cfg = port_cfg(jax_run["cfg"])
    trainer = Trainer(cfg, OptimizerConfig(**OCFG),
                      TrainerConfig(total_steps=STEPS, log_interval=1,
                                    loss_chunk=CHUNK),
                      state=_port_state(jax_run))
    report = trainer.run(iter(_data(pipeline)))
    assert report["final_step"] == STEPS
    curve = [m["loss"] for m in report["metrics"]]
    np.testing.assert_allclose(curve, jax_run["curve"], rtol=LOSS_TOL)


def test_kill_switch_keeps_the_port_loss(jax_run, monkeypatch):
    cfg = port_cfg(jax_run["cfg"])
    batch = _batch(jax_run["batches"][0])
    on, _, g_on = steps.loss_and_grads(_port_state(jax_run), cfg, batch,
                                       CHUNK)
    monkeypatch.setenv("REPRO_DISABLE_KERNELS", "1")
    off, _, g_off = steps.loss_and_grads(_port_state(jax_run), cfg, batch,
                                         CHUNK)
    np.testing.assert_allclose(float(on), float(off), rtol=LOSS_TOL)
    for (_, a), (_, b) in zip(leaves(g_on), leaves(g_off)):
        if b.abs().max() > 0:
            _leaf_close(a, b, GRAD_TOL)


def test_adamw_matches_jax_and_counts_a_missing_gradient_as_zero():
    """JAX hands every trainable leaf a gradient (zeros where no path
    reaches it), so it is still decayed; the port's None means the same."""
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    grads = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": {"c": np.zeros(5, np.float32)}}
    opt = {k: jax.tree_util.tree_map(
        lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32),
        tree) for k in ("m", "v")}
    jp, jo, jm = jadamw_update(_jax_tree(tree), _jax_tree(grads),
                               _jax_tree(opt), jnp.asarray(3, jnp.int32),
                               JOptimizerConfig(**OCFG))
    tt = lambda tr: jax.tree_util.tree_map(torch.as_tensor, tr)
    pp, po, pm = adamw_update(tt(tree), {"a": torch.as_tensor(grads["a"]),
                                         "b": {"c": None}},
                              tt(opt), torch.tensor(3, dtype=torch.int32),
                              OptimizerConfig(**OCFG))
    for got, want in ((pp, jp), (po["m"], jo["m"]), (po["v"], jo["v"])):
        for _, g, w in _zip_leaves(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    assert not np.allclose(pp["b"]["c"].numpy(), tree["b"]["c"])  # decayed
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-6)


def test_train_launcher_runs_on_the_cpu():
    from repro_torch.launch import train
    out = io.StringIO()
    with redirect_stdout(out):
        assert train.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                           "cpu", "--steps", "2", "--batch", "2", "--seq",
                           "32"]) == 0
    rep = json.loads(out.getvalue())
    assert rep["final_step"] == 2 and rep["device"] == "cpu"
    assert np.isfinite(rep["last_metrics"]["loss"])
    assert rep["last_metrics"]["grad_norm"] > 0
