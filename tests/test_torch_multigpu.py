"""Data, tensor and sequence parallelism of the port over gloo worlds on the
CPU, against the JAX package's UNSHARDED functions.

The worlds (tests/torch_mesh_worker.py, spawned once per module and all
at once; ``file://`` rendezvous under tmp_path, 60 s collective timeout,
one torch thread per rank, every rank killed at the deadline):

  * (1, 1): ``core/ffn_shmap.routed_ffn_shmap`` against JAX's at a (1, 1)
    mesh, as tests/test_ffn_shmap.py calls it;
  * (1, 2), (2, 1), (2, 2): one train step of the tiny dense config (2
    layers, d 64, 4 heads on 2 kv heads of 16, d_ff 128 in 8 routed
    groups, vocab 256, f32, batch 4 x 32, attn_impl / ffn_impl "pallas":
    the kernels' plain versions) — loss, metrics, logits and every
    trainable gradient against ``jax.value_and_grad`` of the same loss
    on the whole batch; the thresholds and dispatch plans each rank made
    equal to the unsharded run's rows and heads; after one AdamW step the
    trainable leaves equal on every rank bit for bit; and at (1, 2) and
    (2, 2) ``routed_ffn_shmap`` against JAX's grouped path, whose
    ``lb_loss`` is pmean'd over the data shards as JAX's shard_map does;
  * (2, 1) also: the mamba2 smoke config (no attention block) against the
    port's own world-of-one result (held to JAX by tests/test_torch_ssd.py);
  * (1, 2) also: ``launch/train.py --mesh 1x2 --device cpu`` runs 2 steps,
    and the phi-3-vision smoke config (8 frontend rows ahead of the text)
    matches the port's world-of-one result;
  * (2, 2) also: two mesh axes flattened into one group.

Tolerances: f32, loss, logits and gradients to atol 2e-5 / rtol 2e-4;
integer outputs exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from repro.core import ffn_shmap as jshmap
from repro.core import lora as jlora
from repro.core import params as JP
from repro.core import routed_ffn as jrf
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models import transformer as jtransformer
from repro.train import state as JS
from repro.train.loss import lm_cross_entropy as jlm_cross_entropy
from repro_torch import configs
from repro_torch.core import params as P
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.routed_ffn import RoutedFFNConfig
from repro_torch.launch import steps
from repro_torch.train import state as S
from test_torch_model import np_init_tree, perturb_lora, port_cfg, smoke_cfg

ATOL, RTOL = 2e-5, 2e-4
BATCH, SEQ, CHUNK = 4, 32, 16
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
MESHES = [(1, 2), (2, 1), (2, 2)]
SHMAP_MESHES = [(1, 1), (1, 2), (2, 2)]
LB_W = 0.5                  # lb_loss weight in the shmap cases' loss


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _jcfg():
    return smoke_cfg(attn_impl="sparse_jnp", ffn_impl="grouped")


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _state_np(jcfg):
    """A numpy train state of the JAX layout: np_init_tree params in f32,
    LoRA c leaves perturbed from zero, zero moments."""
    defs = JS.model_defs(jcfg)
    params = _f32(np_init_tree(defs, 0))
    train, frozen = JP.partition(params, JP.trainable_mask(defs))
    train = perturb_lora(train, np.random.default_rng(1))
    zeros = jax.tree_util.tree_map(np.zeros_like, train)
    return {"step": np.int32(0), "train": train, "frozen": frozen,
            "opt": {"m": zeros, "v": zeros}}


def _batch(vocab, seed=3):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}


def _shmap_setup():
    lcfg = jlora.LoRAConfig(rank=4, alpha=4.0)
    rcfg = jrf.RoutedFFNConfig(d_model=32, d_ff=64, num_groups=4,
                               active_groups=2, capacity_factor=4.0,
                               gated=True, activation="gelu")
    params = _f32(np_init_tree(jrf.param_defs(rcfg, lcfg), 5))
    params = perturb_lora(params, np.random.default_rng(6))
    x = np.random.default_rng(7).standard_normal((4, 16, 32)).astype(
        np.float32)
    return lcfg, rcfg, params, x


def _jax_train_refs(jcfg, state, batch):
    """value_and_grad of build_train_step's loss on the whole batch, its
    metrics, and the logits."""
    frozen = jax.tree_util.tree_map(jnp.asarray, state["frozen"])
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(train):
        params = JP.combine(train, frozen)
        hidden, aux = JS.model_hidden(params, jcfg, b, remat=True)
        lm, stats = jlm_cross_entropy(params, jcfg, hidden, b["labels"],
                                      CHUNK)
        total = lm + jcfg.spt.lb_loss_weight * aux["lb_loss"] \
            / jcfg.num_layers
        return total, {"lm_loss": lm, **stats, "lb_loss": aux["lb_loss"],
                       "dropped": aux["dropped"]}

    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                        state["train"]))
    params = JP.combine(jax.tree_util.tree_map(jnp.asarray, state["train"]),
                        frozen)
    hidden, _ = JS.model_hidden(params, jcfg, b, remat=False)
    logits = jtransformer.logits_of(params, jcfg, hidden)
    flat = {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(grads)}
    return {"loss": float(loss), "grads": flat, "logits": np.asarray(logits),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _jax_shmap_refs(lcfg, rcfg, params, x):
    """Per mesh: y, lb_loss and the LoRA/router gradients of sum(y^2) +
    LB_W * lb.  (1, 1): JAX's routed_ffn_shmap; else the grouped path,
    lb_loss the mean of each data shard's."""
    p = jax.tree_util.tree_map(jnp.asarray, params)
    xj = jnp.asarray(x)
    mesh = jmake_mesh((1, 1), ("data", "model"))

    def shmap_loss(p):
        with mesh:
            y, aux = jshmap.routed_ffn_shmap(xj, p, rcfg, lcfg, mesh)
        return jnp.sum(y ** 2) + LB_W * aux["lb_loss"], (y, aux["lb_loss"])

    def grouped_loss(p, dp):
        y, _ = jrf.routed_ffn(xj, p, rcfg, lcfg, impl="grouped")
        lbs = [jrf.routed_ffn(xs, p, rcfg, lcfg, impl="grouped")[1]
               ["lb_loss"] for xs in jnp.split(xj, dp, axis=0)]
        lb = sum(lbs) / dp
        return jnp.sum(y ** 2) + LB_W * lb, (y, lb)

    out = {}
    for mesh_shape in SHMAP_MESHES:
        fn = (shmap_loss if mesh_shape == (1, 1) else
              (lambda p, dp=mesh_shape[0]: grouped_loss(p, dp)))
        (_, (y, lb)), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(p)
        flat = {".".join(str(k.key) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(g)}
        out[mesh_shape] = {"y": np.asarray(y), "lb": float(lb),
                           "grads": flat}
    return out


def _unsharded_port(cfg, state, batch):
    """The port's own loss_and_grads without a mesh, with the integer
    outputs it made."""
    st = P.from_numpy_state(state, "cpu")
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    with W.Recorder() as rec:
        loss, _, grads = steps.loss_and_grads(st, cfg, b, CHUNK)
    return {"loss": float(loss), "ints": rec.calls,
            "grads": {".".join(k): v.numpy() for k, v in P.leaves(grads)}}


def _ssd_setup():
    cfg = dataclasses.replace(configs.get_smoke("mamba2-780m"),
                              dtype=torch.float32)
    st = S.init_state(cfg, seed=0, device="cpu")
    state = {"step": np.int32(0), "train": _tree_to_np(st["train"]),
             "frozen": _tree_to_np(st["frozen"]),
             "opt": {"m": _tree_to_np(st["opt"]["m"]),
                     "v": _tree_to_np(st["opt"]["v"])}}
    state["train"] = perturb_lora(state["train"], np.random.default_rng(2))
    return cfg, state, _batch(cfg.vocab_size, seed=4)


def _vlm_setup():
    """The phi-3-vision smoke config in f32 (8 frontend rows before the
    text: 40 positions split over 2 ranks), its seeded state and batch."""
    cfg = dataclasses.replace(configs.get_smoke("phi-3-vision-4.2b"),
                              dtype=torch.float32).with_spt(
        attn_impl="pallas", ffn_impl="pallas")
    st = S.init_state(cfg, seed=1, device="cpu")
    state = {"step": np.int32(0), "train": _tree_to_np(st["train"]),
             "frozen": _tree_to_np(st["frozen"]),
             "opt": {"m": _tree_to_np(st["opt"]["m"]),
                     "v": _tree_to_np(st["opt"]["v"])}}
    state["train"] = perturb_lora(state["train"], np.random.default_rng(3))
    batch = _batch(cfg.vocab_size, seed=5)
    batch["frontend_embeds"] = np.random.default_rng(6).standard_normal(
        (BATCH, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return cfg, state, batch


def _tree_to_np(t):
    if isinstance(t, dict):
        return {k: _tree_to_np(v) for k, v in t.items()}
    return None if t is None else t.float().numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world, started together, and the references."""
    jcfg = _jcfg()
    cfg = port_cfg(jcfg).with_spt(attn_impl="pallas", ffn_impl="pallas")
    state, batch = _state_np(jcfg), _batch(jcfg.vocab_size)
    lcfg, rcfg, sparams, x = _shmap_setup()
    port_rcfg = RoutedFFNConfig(**dataclasses.asdict(rcfg))
    port_lcfg = LoRAConfig(**dataclasses.asdict(lcfg))
    ssd_cfg, ssd_state, ssd_batch = _ssd_setup()
    vlm_cfg, vlm_state, vlm_batch = _vlm_setup()

    def train(mesh, **kw):
        return ("train_case", dict(mesh_shape=mesh, cfg=cfg, state=state,
                                   batch=batch, chunk=CHUNK, ocfg=OCFG,
                                   **kw))

    def shmap(mesh):
        return ("shmap_case", dict(mesh_shape=mesh, rcfg=port_rcfg,
                                   lcfg=port_lcfg, params=sparams, x=x,
                                   lb_weight=LB_W))

    launcher = ("launcher_case", dict(argv=[
        "--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps",
        "2", "--batch", "2", "--seq", "32", "--mesh", "1x2"]))
    ssd = ("train_case", dict(mesh_shape=(2, 1), cfg=ssd_cfg,
                              state=ssd_state, batch=ssd_batch, chunk=CHUNK,
                              ocfg=OCFG, logits=False))
    vlm = ("train_case", dict(mesh_shape=(1, 2), cfg=vlm_cfg,
                              state=vlm_state, batch=vlm_batch, chunk=CHUNK,
                              ocfg=OCFG, logits=False))
    worlds = {(1, 1): [shmap((1, 1))],
              (1, 2): [train((1, 2)), shmap((1, 2)), launcher, vlm],
              (2, 1): [train((2, 1)), ssd],
              (2, 2): [train((2, 2)), shmap((2, 2)),
                       ("flat_axis_case", dict(mesh_shape=(2, 2)))]}
    started = W.start_worlds([(a * b, "world_cases", {"cases": cases})
                              for (a, b), cases in worlds.items()],
                             tmp_path_factory.mktemp("worlds"))
    try:            # the references while the worlds run
        refs = {"jax": _jax_train_refs(jcfg, state, batch),
                "jax_shmap": _jax_shmap_refs(lcfg, rcfg, sparams, x),
                "port": _unsharded_port(cfg, state, batch),
                "ssd_port": _unsharded_port(ssd_cfg, ssd_state, ssd_batch),
                "vlm_port": _unsharded_port(vlm_cfg, vlm_state, vlm_batch)}
    finally:
        got = W.join_worlds(started)
    by_mesh = dict(zip(worlds, got))
    return {**refs, "cfg": cfg,
        "train": {m: [r[0] for r in by_mesh[m]] for m in MESHES},
        "shmap": {m: [r[0 if m == (1, 1) else 1] for r in by_mesh[m]]
                  for m in SHMAP_MESHES},
        "ssd": [r[1] for r in by_mesh[(2, 1)]],
        "launcher": [r[2] for r in by_mesh[(1, 2)]],
        "vlm": [r[3] for r in by_mesh[(1, 2)]],
        "flat": [r[2] for r in by_mesh[(2, 2)]]}


def _rows(dp, b=BATCH):
    r, n = dp
    return slice(r * b // n, (r + 1) * b // n)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_train_step_matches_unsharded_jax(runs, mesh):
    ref = runs["jax"]
    for res in runs["train"][mesh]:
        _close(res["loss"], ref["loss"], "loss")
        for k in ("lm_loss", "nll_sum", "tokens", "accuracy", "lb_loss",
                  "dropped"):
            _close(res["metrics"][k], ref["metrics"][k], k)
        _close(res["logits"], ref["logits"][_rows(res["dp"])], "logits")
        assert res["grads"].keys() == ref["grads"].keys()
        for k, g in ref["grads"].items():
            _close(res["grads"][k], g, k)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_integer_outputs_equal_unsharded(runs, mesh):
    """Each rank's thresholds are the unsharded run's for its rows and
    heads, its dispatch plans those of its rows (the FFN routes the whole
    gathered sequence)."""
    ref = runs["port"]["ints"]
    hq = runs["cfg"].num_heads
    for res in runs["train"][mesh]:
        tr, tn = res["tp"]
        heads = slice(tr * hq // tn, (tr + 1) * hq // tn)
        assert [n for n, _ in res["ints"]] == [n for n, _ in ref]
        for (name, got), (_, want) in zip(res["ints"], ref):
            want = (W.rows_heads(want, BATCH, _rows(res["dp"]), heads)
                    if name == "topl_thresholds" else want[_rows(res["dp"])])
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_params_equal_on_every_rank_after_adamw(runs, mesh):
    first = runs["train"][mesh][0]["after"]
    for res in runs["train"][mesh][1:]:
        for k, v in first.items():
            assert np.array_equal(res["after"][k], v), k


@pytest.mark.parametrize("mesh", SHMAP_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ffn_shmap_matches_jax(runs, mesh):
    ref = runs["jax_shmap"][mesh]
    for res in runs["shmap"][mesh]:
        (dr, dn), (tr, tn) = res["dp"], res["tp"]
        s = ref["y"].shape[1] // tn
        _close(res["y"], ref["y"][_rows((dr, dn)), tr * s:(tr + 1) * s], "y")
        _close(res["lb"], ref["lb"], "lb_loss")
        assert res["dropped"] == 0.0
        for k, g in res["grads"].items():
            _close(g, ref["grads"][k], k)


def test_ssd_data_parallel_matches_world_of_one(runs):
    """mamba2 (no attention block) at (2, 1): data parallelism alone."""
    ref = runs["ssd_port"]
    for res in runs["ssd"]:
        _close(res["loss"], ref["loss"], "loss")
        for k, g in ref["grads"].items():
            _close(res["grads"][k], g, k)


def test_vlm_sequence_parallel_matches_world_of_one(runs):
    """phi-3-vision at (1, 2): the frontend rows ride on rank 0 through
    the vocabulary-split embedding and the sequence split covers them."""
    ref = runs["vlm_port"]
    for res in runs["vlm"]:
        assert res["tp"] == (res["tp"][0], 2)
        _close(res["loss"], ref["loss"], "loss")
        for k, g in ref["grads"].items():
            _close(res["grads"][k], g, k)


def test_train_launcher_runs_a_1x2_mesh(runs):
    import json
    first, second = runs["launcher"]
    assert first["rc"] == 0 and second["rc"] == 0
    assert second["out"] == ""                  # rank 0 alone prints
    blob = json.loads(first["out"])
    assert blob["mesh"] == "1x2" and blob["final_step"] == 2
    assert np.isfinite(blob["last_metrics"]["loss"])


def test_flattened_axes_form_one_group(runs):
    """Two mesh axes as one Axis (as ("pod", "data") split the batch):
    one group over all four ranks, each with its own index."""
    got = runs["flat"]
    assert sorted(r["rank"] for r in got) == [0, 1, 2, 3]
    assert all(r["size"] == 4 and r["sum"] == 6.0 for r in got)
