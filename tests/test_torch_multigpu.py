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
    the kernels' plain versions) and of the mixtral smoke config (4
    experts of 128 columns: split over data and model at (2, 2)), each
    rank holding only its stored parts (train/state.storage_specs) —
    loss, metrics, logits, the global norm and each rank's gradient
    parts against ``jax.value_and_grad`` of the same loss on the whole
    batch and the slices of its gradients; the stored shapes, and the
    parts ``init_state(..., mesh=)`` draws, equal to the slices of the
    world of one's; the thresholds and dispatch plans each rank made
    equal to the unsharded run's rows and heads; after one AdamW step
    (clip 0.1, so the norm's clip binds) each rank's parts of the
    trainable leaves and moments equal to the world of one's slices, the
    replicated leaves alike on every rank bit for bit; and at (1, 2) and
    (2, 2) ``routed_ffn_shmap`` against JAX's grouped path, whose
    ``lb_loss`` is pmean'd over the data shards as JAX's shard_map does;
  * (2, 1) also: the mamba2 smoke config (no attention block) against the
    port's own world-of-one result (held to JAX by tests/test_torch_ssd.py);
  * (1, 2) also: ``launch/train.py --mesh 1x2 --device cpu`` runs 2 steps,
    and the phi-3-vision smoke config (8 frontend rows ahead of the text)
    matches the port's world-of-one result;
  * (2, 2) also: two mesh axes flattened into one group, mixtral on 31
    positions (no sequence-parallel layout: the whole parameters
    gathered, computed alike on the model ranks) against the port's
    world of one, and the checkpoints: the world's parts saved whole
    restore in JAX's ``checkpoint.restore`` equal to the state, and a
    checkpoint JAX saved restores into every rank's parts equal to their
    slices.

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
from repro.train import checkpoint as jcheckpoint
from repro.train import state as JS
from repro.train.loss import lm_cross_entropy as jlm_cross_entropy
from repro_torch import configs
from repro_torch.core import params as P
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.routed_ffn import RoutedFFNConfig
from repro_torch.launch import steps
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.sharding import local_slice
from repro_torch.train import state as S
from test_torch_model import np_init_tree, perturb_lora, port_cfg, smoke_cfg

ATOL, RTOL = 2e-5, 2e-4
BATCH, SEQ, CHUNK = 4, 32, 16
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=0.1)
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


def _moe_jcfg():
    """The mixtral smoke config in f32 (4 experts, expert_ffn 128)."""
    from repro import configs as jconfigs
    return dataclasses.replace(jconfigs.get_smoke("mixtral-8x22b"),
                               dtype=jnp.float32)


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


def _jax_train_refs(jcfg, state, batch, logits=True):
    """value_and_grad of build_train_step's loss on the whole batch, its
    metrics, and (with ``logits``) the logits."""
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
    flat = {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(grads)}
    out = {"loss": float(loss), "grads": flat,
           "metrics": {k: float(v) for k, v in metrics.items()}}
    if logits:
        params = JP.combine(jax.tree_util.tree_map(jnp.asarray,
                                                   state["train"]), frozen)
        hidden, _ = JS.model_hidden(params, jcfg, b, remat=False)
        out["logits"] = np.asarray(jtransformer.logits_of(params, jcfg,
                                                          hidden))
    return out


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


def _unsharded_port(cfg, state, batch, chunk=CHUNK):
    """The port's own loss_and_grads without a mesh, with the integer
    outputs it made, the leaves and first moments after one train step,
    and the state ``init_state`` draws."""
    st = P.from_numpy_state(state, "cpu")
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    with W.Recorder() as rec:
        loss, _, grads = steps.loss_and_grads(st, cfg, b, chunk)
    new, _ = steps.build_train_step(cfg, OptimizerConfig(**OCFG),
                                    loss_chunk=chunk)(st, b)
    init = S.init_state(cfg, seed=0, device="cpu")
    return {"loss": float(loss), "ints": rec.calls,
            "grads": {".".join(k): v.numpy() for k, v in P.leaves(grads)},
            "after": W._tree_np(new["train"]),
            "after_m": W._tree_np(new["opt"]["m"]),
            "init": {part: W._tree_np(init[part])
                     for part in ("train", "frozen")}}


def _specs(cfg, mesh):
    """{part: {dotted path: storage placement}} at ``mesh``."""
    sizes = dict(zip(("data", "model"), mesh))
    specs = S.storage_specs(cfg, {"__sizes__": sizes})
    return {part: {".".join(k): v for k, v in P.leaves(specs[part])}
            for part in ("train", "frozen")}, sizes


def _part(whole, spec, sizes, coords):
    """A rank's slice of a whole numpy leaf (``sharding.local_slice``)."""
    return local_slice(torch.as_tensor(np.array(whole)), spec, sizes,
                       coords).numpy()


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


def _odd_batch(vocab, seed=12):
    """A batch of 31 positions, which no model extent above 1 divides:
    the step gathers the whole parameters and computes replicated."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (BATCH, 32)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}


def _moe_setup():
    """The mixtral smoke config in f32 (kernel configuration), its state
    (JAX's layout, LoRA C perturbed) and a batch."""
    jcfg = _moe_jcfg()
    cfg = port_cfg(jcfg).with_spt(attn_impl="pallas", ffn_impl="pallas")
    return jcfg, cfg, _state_np(jcfg), _batch(jcfg.vocab_size, seed=8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world, started together, and the references."""
    jcfg = _jcfg()
    cfg = port_cfg(jcfg).with_spt(attn_impl="pallas", ffn_impl="pallas")
    state, batch = _state_np(jcfg), _batch(jcfg.vocab_size)
    mjcfg, mcfg, mstate, mbatch = _moe_setup()
    lcfg, rcfg, sparams, x = _shmap_setup()
    port_rcfg = RoutedFFNConfig(**dataclasses.asdict(rcfg))
    port_lcfg = LoRAConfig(**dataclasses.asdict(lcfg))
    ssd_cfg, ssd_state, ssd_batch = _ssd_setup()
    vlm_cfg, vlm_state, vlm_batch = _vlm_setup()
    tmp = tmp_path_factory.mktemp("worlds")
    jax_ckpt = str(tmp / "jax_ckpt")
    jcheckpoint.save(state, 5, jax_ckpt)

    def train(mesh, **kw):
        return ("train_case", dict(mesh_shape=mesh, cfg=cfg, state=state,
                                   batch=batch, chunk=CHUNK, ocfg=OCFG,
                                   **kw))

    def moe(mesh):
        return ("train_case", dict(mesh_shape=mesh, cfg=mcfg, state=mstate,
                                   batch=mbatch, chunk=CHUNK, ocfg=OCFG,
                                   logits=False))

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
    obatch = _odd_batch(mjcfg.vocab_size)
    odd = ("train_case", dict(mesh_shape=(2, 2), cfg=mcfg, state=mstate,
                              batch=obatch, chunk=31, ocfg=OCFG,
                              logits=False))
    ckpt = ("ckpt_case", dict(mesh_shape=(2, 2), cfg=cfg, state=state,
                              save_dir=str(tmp / "world_ckpt"),
                              restore_dir=jax_ckpt))
    worlds = {(1, 1): [shmap((1, 1))],
              (1, 2): [train((1, 2)), shmap((1, 2)), launcher, vlm,
                       moe((1, 2))],
              (2, 1): [train((2, 1)), ssd, moe((2, 1))],
              (2, 2): [train((2, 2)), shmap((2, 2)),
                       ("flat_axis_case", dict(mesh_shape=(2, 2))),
                       moe((2, 2)), ckpt, odd]}
    started = W.start_worlds([(a * b, "world_cases", {"cases": cases})
                              for (a, b), cases in worlds.items()], tmp)
    try:            # the references while the worlds run
        refs = {"jax": _jax_train_refs(jcfg, state, batch),
                "jax_moe": _jax_train_refs(mjcfg, mstate, mbatch),
                "jax_shmap": _jax_shmap_refs(lcfg, rcfg, sparams, x),
                "port": _unsharded_port(cfg, state, batch),
                "moe_port": _unsharded_port(mcfg, mstate, mbatch),
                "odd_port": _unsharded_port(mcfg, mstate, obatch, 31),
                "ssd_port": _unsharded_port(ssd_cfg, ssd_state, ssd_batch),
                "vlm_port": _unsharded_port(vlm_cfg, vlm_state, vlm_batch)}
    finally:
        got = W.join_worlds(started)
    by_mesh = dict(zip(worlds, got))
    return {**refs, "cfg": cfg, "moe_cfg": mcfg, "state": state,
        "train": {m: [r[0] for r in by_mesh[m]] for m in MESHES},
        "moe": {m: [r[{(1, 2): 4, (2, 1): 2, (2, 2): 3}[m]]
                    for r in by_mesh[m]] for m in MESHES},
        "shmap": {m: [r[0 if m == (1, 1) else 1] for r in by_mesh[m]]
                  for m in SHMAP_MESHES},
        "ssd": [r[1] for r in by_mesh[(2, 1)]],
        "launcher": [r[2] for r in by_mesh[(1, 2)]],
        "vlm": [r[3] for r in by_mesh[(1, 2)]],
        "flat": [r[2] for r in by_mesh[(2, 2)]],
        "ckpt": [r[4] for r in by_mesh[(2, 2)]],
        "odd": [r[5] for r in by_mesh[(2, 2)]],
        "world_ckpt": str(tmp / "world_ckpt")}


def _rows(dp, b=BATCH):
    r, n = dp
    return slice(r * b // n, (r + 1) * b // n)


def _close_parts(res, cfg, mesh, got, want, what, part="train"):
    """Each leaf of this rank's ``got`` against its slice of the whole
    ``want`` (both {dotted path: array})."""
    specs, sizes = _specs(cfg, mesh)
    assert got.keys() == want.keys()
    for k, w in want.items():
        _close(got[k], _part(w, specs[part][k], sizes, res["coords"]),
               f"{what} {k}")


def _jax_norm(grads):
    return float(np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                             for g in grads.values())))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_train_step_matches_unsharded_jax(runs, mesh):
    """Loss, metrics and logits of every rank against JAX's unsharded
    step; each rank's gradient parts against the slices of JAX's."""
    ref = runs["jax"]
    for res in runs["train"][mesh]:
        _close(res["loss"], ref["loss"], "loss")
        for k in ("lm_loss", "nll_sum", "tokens", "accuracy", "lb_loss",
                  "dropped"):
            _close(res["metrics"][k], ref["metrics"][k], k)
        _close(res["logits"], ref["logits"][_rows(res["dp"])], "logits")
        _close_parts(res, runs["cfg"], mesh, res["grads"], ref["grads"],
                     "grad")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_train_step_matches_unsharded_jax(runs, mesh):
    """mixtral: the expert columns stored over data and model (ZeRO-3),
    gathered over data in the regions, their gradients reduce-scattered."""
    ref = runs["jax_moe"]
    for res in runs["moe"][mesh]:
        _close(res["loss"], ref["loss"], "loss")
        for k in ("lm_loss", "nll_sum", "tokens", "accuracy", "lb_loss",
                  "dropped"):
            _close(res["metrics"][k], ref["metrics"][k], k)
        _close_parts(res, runs["moe_cfg"], mesh, res["grads"],
                     ref["grads"], "grad")


@pytest.mark.parametrize("arch", ["dense", "moe"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_stored_shapes_are_the_local_shapes(runs, mesh, arch):
    """No rank holds a whole leaf that its placement splits: every stored
    leaf has ``local_shape`` of its placement; the embedding holds V/n
    rows, and at (2, 2) an expert leaf a quarter of its columns."""
    from repro_torch.sharding import local_shape
    cfg = runs["cfg" if arch == "dense" else "moe_cfg"]
    specs, sizes = _specs(cfg, mesh)
    whole = {part: {".".join(k): tuple(v.shape) for k, v in P.leaves(
        S.abstract_state(cfg)[part])} for part in ("train", "frozen")}
    res = runs["train" if arch == "dense" else "moe"][mesh][0]
    for part in ("train", "frozen"):
        assert res["stored"][part] == {
            k: local_shape(v, specs[part][k], sizes)
            for k, v in whole[part].items()}
    v, n = cfg.padded_vocab, mesh[1]
    assert res["stored"]["frozen"]["embed.embedding"][0] == v // n
    if arch == "moe":
        e, d, f = whole["frozen"]["units.b0_attn.ffn.wi"][1:]
        assert res["stored"]["frozen"]["units.b0_attn.ffn.wi"][1:] == (
            e, d, f // (mesh[0] * mesh[1]))


@pytest.mark.parametrize("arch", ["dense", "moe"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_init_state_on_a_mesh_is_the_slices(runs, mesh, arch):
    """``init_state(..., mesh=)`` gives each rank exactly its slices of
    the state a world of one draws from the seed."""
    cfg = runs["cfg" if arch == "dense" else "moe_cfg"]
    ref = runs["port" if arch == "dense" else "moe_port"]["init"]
    specs, sizes = _specs(cfg, mesh)
    for res in runs["train" if arch == "dense" else "moe"][mesh]:
        for part in ("train", "frozen"):
            assert res["init"][part].keys() == ref[part].keys()
            for k, w in ref[part].items():
                assert np.array_equal(res["init"][part][k], _part(
                    w, specs[part][k], sizes, res["coords"])), k


@pytest.mark.parametrize("arch", ["dense", "moe"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_global_norm_equals_unsharded(runs, mesh, arch):
    """Each element counts once: the norm of the ranks' parts (and the
    step's clip norm) equals the norm of JAX's whole gradients."""
    ref = _jax_norm(runs["jax" if arch == "dense" else "jax_moe"]["grads"])
    assert ref > OCFG["grad_clip"]            # the clip binds
    for res in runs["train" if arch == "dense" else "moe"][mesh]:
        _close(res["norm"], ref, "global norm")
        _close(res["grad_norm"], ref, "the step's grad_norm")


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
    """After one AdamW step every rank's parts of the trainable leaves
    equal the world of one's slices, and a leaf replicated over the
    ranks is equal on every rank bit for bit."""
    specs, sizes = _specs(runs["cfg"], mesh)
    ref = runs["port"]["after"]
    first = runs["train"][mesh][0]
    for res in runs["train"][mesh]:
        _close_parts(res, runs["cfg"], mesh, res["after"], ref, "after")
        for k, v in first["after"].items():
            if not any(e is not None for e in specs["train"][k]):
                assert np.array_equal(res["after"][k], v), k


@pytest.mark.parametrize("arch", ["dense", "moe"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_adamw_shards_equal_world_of_one(runs, mesh, arch):
    """AdamW on the parts: the leaves and first moments after one step,
    assembled, are the world of one's (the moments stored as their
    leaves)."""
    cfg = runs["cfg" if arch == "dense" else "moe_cfg"]
    ref = runs["port" if arch == "dense" else "moe_port"]
    for res in runs["train" if arch == "dense" else "moe"][mesh]:
        _close_parts(res, cfg, mesh, res["after"], ref["after"], "after")
        _close_parts(res, cfg, mesh, res["after_m"], ref["after_m"], "m")


def test_positions_the_model_extent_does_not_divide(runs):
    """mixtral at (2, 2) on 31 positions: no sequence-parallel layout, so
    the step gathers the whole parameters (experts over data and model
    included) and computes alike on both model ranks; the loss, each
    rank's gradient parts and its parts after AdamW equal the world of
    one's."""
    ref = runs["odd_port"]
    for res in runs["odd"]:
        assert res["tp"] == (res["tp"][0], 2)
        _close(res["loss"], ref["loss"], "loss")
        _close_parts(res, runs["moe_cfg"], (2, 2), res["grads"],
                     ref["grads"], "grad")
        _close_parts(res, runs["moe_cfg"], (2, 2), res["after"],
                     ref["after"], "after")


def test_world_checkpoint_restores_in_jax(runs):
    """A (2, 2) world's parts, saved whole, restore in JAX's
    ``checkpoint.restore`` equal to the state bit for bit."""
    got = jcheckpoint.restore(runs["world_ckpt"], 7)
    want = runs["state"]
    for part in ("train", "frozen"):
        flat = {".".join(str(k.key) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(
                    got[part])}
        ref = {".".join(str(k.key) for k in path): np.asarray(v)
               for path, v in jax.tree_util.tree_leaves_with_path(
                   want[part])}
        assert flat.keys() == ref.keys()
        for k, v in ref.items():
            assert np.array_equal(flat[k], v), k
    assert int(got["step"]) == 0


def test_jax_checkpoint_restores_into_2x2_parts(runs):
    """A checkpoint JAX saved restores into each rank's parts equal to
    their slices (the moments as their leaves)."""
    specs, sizes = _specs(runs["cfg"], (2, 2))
    state = runs["state"]
    for res, coords in zip(runs["ckpt"], ({"data": r // 2, "model": r % 2}
                                          for r in range(4))):
        assert res["step"] == 0
        for part, spec_part in (("train", "train"), ("frozen", "frozen")):
            whole = {".".join(str(k.key) for k in path): np.asarray(v)
                     for path, v in jax.tree_util.tree_leaves_with_path(
                         state[part])}
            assert res[part].keys() == whole.keys()
            for k, v in whole.items():
                assert np.array_equal(res[part][k], _part(
                    v, specs[spec_part][k], sizes, coords)), k
        for k, v in res["opt"]["m"].items():
            assert v.shape == res["train"][k].shape, k


@pytest.mark.parametrize("mesh", SHMAP_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ffn_shmap_matches_jax(runs, mesh):
    ref = runs["jax_shmap"][mesh]
    from repro_torch.core import routed_ffn as rf
    lcfg, rcfg, _, _ = _shmap_setup()
    sizes = dict(zip(("data", "model"), mesh))
    specs = {".".join(k): v for k, v in P.leaves(P.spec_tree(
        rf.param_defs(RoutedFFNConfig(**dataclasses.asdict(rcfg)),
                      LoRAConfig(**dataclasses.asdict(lcfg))),
        {"ffn": "model", "__sizes__": sizes}))}
    for res in runs["shmap"][mesh]:
        (dr, dn), (tr, tn) = res["dp"], res["tp"]
        s = ref["y"].shape[1] // tn
        _close(res["y"], ref["y"][_rows((dr, dn)), tr * s:(tr + 1) * s], "y")
        _close(res["lb"], ref["lb"], "lb_loss")
        assert res["dropped"] == 0.0
        for k, g in res["grads"].items():
            _close(g, _part(ref["grads"][k], specs[k], sizes,
                            res["coords"]), k)


def test_ssd_data_parallel_matches_world_of_one(runs):
    """mamba2 (no attention block) at (2, 1): data parallelism alone."""
    ref = runs["ssd_port"]
    for res in runs["ssd"]:
        _close(res["loss"], ref["loss"], "loss")
        assert res["grads"].keys() == ref["grads"].keys()
        for k, g in ref["grads"].items():
            _close(res["grads"][k], g, k)


def test_vlm_sequence_parallel_matches_world_of_one(runs):
    """phi-3-vision at (1, 2): the frontend rows ride on rank 0 through
    the vocabulary-split embedding and the sequence split covers them."""
    ref = runs["vlm_port"]
    cfg = _vlm_setup()[0]
    for res in runs["vlm"]:
        assert res["tp"] == (res["tp"][0], 2)
        _close(res["loss"], ref["loss"], "loss")
        _close_parts(res, cfg, (1, 2), res["grads"], ref["grads"], "grad")


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
