"""Serving under a (data, model) mesh, tensor parallelism for every block
kind, and resume under a world of two, over gloo worlds on the CPU.

The worlds (tests/torch_mesh_serve_worker.py through
tests/torch_mesh_worker.py's spawner: all started at once, ``file://``
rendezvous under tmp_path, 60 s collective timeout, one torch thread per
rank, every rank killed at the deadline) are (1, 2), (2, 1), (2, 2) and
(1, 4).  In f32 with the kernels' plain versions, each serves:

  * the tiny dense config (the qwen3 smoke: 2 layers, d 64, 4 heads on 2
    kv heads of 16, d_ff 128 in 8 routed groups): ``Engine.run`` of 6
    ragged requests over 4 slots on the contiguous layout and on a paged
    pool small enough to stall admissions (and sampled at temperature
    0.8, equal to the port's world of one).  The greedy streams equal the
    JAX package's unsharded ``Engine.run`` on the same params (computed
    once, here), a difference allowed only at a genuine logit near-tie
    (the replay rule of tests/test_sparse_decode.py); peak pages, stalls
    and the stats equal the port's world of one;
  * at (2, 2) (both axes split at once) also mixtral (MoE, a SWA ring),
    recurrentgemma (RG-LRU, one kv head; its width 64 is one gate block,
    and a copy at width 256 has 16) and mamba2 (SSD) smoke configs
    through ``Engine.run``, whisper through ``Engine.generate``: streams
    equal the port's world of one (which
    tests/test_torch_moe.py, test_torch_hybrid.py, test_torch_ssd.py and
    test_torch_encdec.py hold to JAX).

At (1, 4) the qwen3 smoke's 2 kv heads do not split over the 4 model
ranks: each rank's one query head lies inside a kv head, and the caches'
sequence splits over the ranks (S/4 slots each, as JAX's cache specs
place it).  The contiguous greedy streams equal JAX's unsharded
``Engine.run`` under the replay rule (with sparse MHA off, the port's
world of one's), and one train step's loss and
every trainable gradient part equal JAX's unsharded ``jax.grad``
(tests/test_torch_multigpu.py's step and tolerances).  At (1, 2) a smoke
copy with one kv head and a SWA ring of 16 slots, which its prompts and
streams wrap, serves streams equal to JAX's unsharded ``Engine.run``
under the same rule.

At (1, 2) one train step of each of those families matches the
port's world of one (loss and every trainable gradient to atol 2e-5 /
rtol 2e-4), and the trainable leaves after one AdamW step are equal on
both ranks bit for bit; ``launch/serve.py --mesh 1x2`` serves 2
requests.  At (2, 1) a Trainer stopped by its stop flag after step 2 and
resumed in a fresh Trainer matches the uninterrupted 4-step run.  Every
case checks that the caches and the inputs of the kernels' wrappers (or
the recurrences) on each rank carry the local head, column and slot
counts.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_serve_worker as SW
import torch_mesh_worker as W
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch.core import params as P
from repro_torch.launch import steps
from repro_torch.models.attention import seq_parts
from repro_torch.optim.adamw import OptimizerConfig, global_norm
from repro_torch.train import state as S
from test_torch_model import (jax_params, keep_sigterm,  # noqa: F401
                              one_torch_thread, perturb_lora, port_cfg,
                              smoke_cfg)
from repro.models import transformer as jtransformer
import test_torch_multigpu as MG

ATOL, RTOL = 2e-5, 2e-4
MESHES = [(1, 2), (2, 1), (2, 2)]
WIDE = (1, 4)                 # query heads inside a kv head, seq split
RING = dict(num_kv_heads=1, window=16)    # the (1, 2) ring copy
MAX_LEN, SLOTS, CHUNK = 32, 4, 3
PAGED = dict(kv_layout="paged", kv_page_size=8)
KV_PAGES = 8                          # < the 4 slots' 16: admissions stall
FAMILIES = ("mixtral-8x22b", "recurrentgemma-9b", "mamba2-780m")
# the RG-LRU's gates: the smoke's width 64 is one block (each rank
# gathers the conv output); at 256 they are 16 blocks, split over ranks
BLOCKS = "recurrentgemma-9b/lru256"
DENSE = ("dense", "paged", "sampled")


def _family_cfg(name):
    if name == BLOCKS:
        return SW.f32(dataclasses.replace(
            configs.get_smoke("recurrentgemma-9b"), lru_width=256))
    return SW.f32(configs.get_smoke(name))
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# the family train steps clip by a norm far below their gradients' norm,
# so a wrong global norm shows in the first moments
TRAIN_OCFG = dict(OCFG, grad_clip=1e-3)
BATCH, SEQ, LOSS_CHUNK = 4, 16, 16
GEN_STEPS = 5


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _engine_kw(**kw):
    return dict(max_len=MAX_LEN, num_slots=SLOTS, decode_chunk=CHUNK, **kw)


def _dense():
    jcfg = smoke_cfg(attn_impl="sparse_jnp", ffn_impl="grouped")
    cfg = port_cfg(jcfg).with_spt(attn_impl="pallas", ffn_impl="pallas")
    reqs = SW.requests(cfg.vocab_size, [9, 14, 5, 11, 7, 13], 5, seed=5)
    return jcfg, cfg, jax_params(jcfg), reqs


def _ring():
    """The qwen3 smoke with one kv head and a 16-slot SWA ring (JAX's and
    the port's config, its params, requests that wrap the ring)."""
    jcfg = dataclasses.replace(smoke_cfg(attn_impl="sparse_jnp",
                                         ffn_impl="grouped"), **RING)
    cfg = port_cfg(jcfg).with_spt(attn_impl="pallas", ffn_impl="pallas")
    reqs = SW.requests(cfg.vocab_size, [14, 14, 14, 14], 9, seed=13)
    return jcfg, cfg, jax_params(jcfg), reqs


def _jax_streams(jcfg, tree, reqs):
    """JAX's unsharded streams, every request in one admission group (a
    greedy row's stream does not depend on its batch mates; one prefill
    and one decode compile)."""
    eng = JEngine(jcfg, tree, max_len=MAX_LEN, num_slots=len(reqs),
                  decode_chunk=CHUNK)
    return [c.tokens for c in eng.run(
        [JRequest(uid=u, tokens=t, max_new_tokens=m) for u, t, m in reqs])]


def _tree_np(t):
    if isinstance(t, dict):
        return {k: _tree_np(v) for k, v in t.items()}
    return None if t is None else t.float().numpy()


def _train_setup(arch, seed):
    """An f32 smoke config of ``arch``, its seeded train state (numpy,
    LoRA C off zero) and a batch (whisper: with its frames)."""
    cfg = _family_cfg(arch)
    st = S.init_state(cfg, seed=seed, device="cpu")
    state = {"step": np.int32(0), "train": _tree_np(st["train"]),
             "frozen": _tree_np(st["frozen"]),
             "opt": {"m": _tree_np(st["opt"]["m"]),
                     "v": _tree_np(st["opt"]["v"])}}
    state["train"] = perturb_lora(state["train"],
                                  np.random.default_rng(seed + 1))
    rng = np.random.default_rng(seed + 2)
    tok = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
    if cfg.family == "audio":
        batch["frontend_embeds"] = rng.standard_normal(
            (BATCH, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return cfg, state, batch


def _port_train(cfg, state, batch):
    """The world of one's loss, gradients and their global norm, and its
    trainable leaves, first moments and grad_norm after one AdamW step
    (TRAIN_OCFG)."""
    st = P.from_numpy_state(state, "cpu")
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, _, grads = steps.loss_and_grads(st, cfg, b, LOSS_CHUNK)
    new, m = steps.build_train_step(cfg, OptimizerConfig(**TRAIN_OCFG),
                                    loss_chunk=LOSS_CHUNK)(st, b)

    def flat(tree):
        return {".".join(k): v.numpy() for k, v in P.leaves(tree)}
    return {"loss": float(loss), "grads": flat(grads),
            "norm": float(global_norm(grads)), "after": flat(new["train"]),
            "after_m": flat(new["opt"]["m"]),
            "grad_norm": float(m["grad_norm"])}


def _whisper_generate():
    cfg = SW.f32(configs.get_smoke("whisper-base"))
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (SLOTS, 4)),
             "frontend_embeds": rng.standard_normal(
                 (SLOTS, cfg.frontend_tokens, cfg.d_model)).astype(
                     np.float32)}
    return dict(cfg=cfg, engine_kw=_engine_kw(), generate=(batch, GEN_STEPS))


def _resume_setup(tmp_path):
    cfg = SW.f32(configs.get_smoke("qwen3-0.6b"))
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(4):
        tok = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(
            np.int32)
        batches.append({"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()})
    return dict(mesh_shape=(2, 1), cfg=cfg, ckpt_dir=str(tmp_path / "ckpt"),
                batches=batches, ocfg=OCFG)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world, started together, and the references computed while
    they run."""
    jcfg, cfg, tree, reqs = _dense()
    paged = cfg.with_spt(**PAGED, telemetry="counters")
    fam_reqs = SW.requests(256, [9, 14, 5, 11, 7, 6], 4, seed=3)
    serve = {"dense": dict(cfg=cfg, tree=tree, reqs=reqs,
                           engine_kw=_engine_kw()),
             "paged": dict(cfg=paged, tree=tree, reqs=reqs,
                           engine_kw=_engine_kw(kv_pages=KV_PAGES)),
             "sampled": dict(cfg=cfg, tree=tree, reqs=reqs,
                             engine_kw=_engine_kw(),
                             run_kw=dict(temperature=0.8, seed=7)),
             **{a: dict(cfg=_family_cfg(a), reqs=fam_reqs,
                        engine_kw=_engine_kw()) for a in (*FAMILIES, BLOCKS)},
             "whisper-base": _whisper_generate()}
    train = {a: _train_setup(a, i) for i, a in
             enumerate((*FAMILIES, BLOCKS, "whisper-base"))}
    rjcfg, rcfg, rtree, rreqs = _ring()
    ring = dict(cfg=rcfg, tree=rtree, reqs=rreqs, engine_kw=_engine_kw())
    mjcfg = MG._jcfg()
    mstate, mbatch = MG._state_np(mjcfg), MG._batch(mjcfg.vocab_size)
    dense_attn = dict(cfg=cfg.with_spt(sparse_mha=False), reqs=reqs,
                      engine_kw=_engine_kw())
    tmp = tmp_path_factory.mktemp("worlds")

    def world(mesh):
        # the dense serves in every world; the other families where both
        # axes split, (2, 2)
        cases = [("serve_case", dict(mesh_shape=mesh, **kw))
                 for name, kw in serve.items()
                 if name in DENSE or mesh == (2, 2)]
        if mesh == WIDE:
            return (4, "torch_mesh_serve_worker:cases", {"cases": [
                ("serve_case", dict(mesh_shape=mesh, **serve["dense"])),
                ("serve_case", dict(mesh_shape=mesh, **dense_attn)),
                ("train_shapes_case", dict(
                    mesh_shape=mesh, cfg=cfg, state=mstate, batch=mbatch,
                    chunk=MG.CHUNK, ocfg=MG.OCFG, logits=False))]})
        if mesh == (1, 2):
            cases.append(("serve_case", dict(mesh_shape=mesh, **ring)))
            cases += [("train_shapes_case", dict(
                mesh_shape=mesh, cfg=c, state=s, batch=b, chunk=LOSS_CHUNK,
                ocfg=TRAIN_OCFG, logits=False)) for c, s, b in train.values()]
            cases.append(("launcher_case", dict(argv=[
                "--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                "--requests", "2", "--slots", "2", "--prompt-len", "8",
                "--gen", "3", "--mesh", "1x2"])))
        if mesh == (2, 1):
            cases.append(("resume_case", _resume_setup(tmp)))
        return (mesh[0] * mesh[1], "torch_mesh_serve_worker:cases",
                {"cases": cases})

    started = W.start_worlds([world(m) for m in (*MESHES, WIDE)], tmp,
                             preload=["torch_mesh_serve_worker"])
    try:
        refs = {"serve": {k: SW.serve(**kw) for k, kw in serve.items()},
                "jax": _jax_streams(jcfg, tree, reqs),
                "jax_ring": _jax_streams(rjcfg, rtree, rreqs),
                "jax_train": MG._jax_train_refs(mjcfg, mstate, mbatch,
                                                logits=False),
                "dense_attn": SW.serve(**dense_attn),
                "train": {a: _port_train(*t) for a, t in train.items()}}
    finally:
        got = W.join_worlds(started)
    by_mesh = dict(zip((*MESHES, WIDE), got))
    names = list(serve)
    dense = [k for k in names if k in DENSE]
    out = {**refs, "jcfg": jcfg, "tree": tree, "reqs": reqs,
           "serve_cfg": {k: kw["cfg"] for k, kw in serve.items()},
           "serve_names": names, "train_names": list(train)}
    out["serve_mesh"] = {m: {k: [r[i] for r in by_mesh[m]] for i, k in
                             enumerate(names if m == (2, 2) else dense)}
                         for m in MESHES}
    n = len(dense)
    out["ring"] = [r[n] for r in by_mesh[(1, 2)]]
    out["train_mesh"] = {a: [r[n + 1 + i] for r in by_mesh[(1, 2)]]
                         for i, a in enumerate(train)}
    out["launcher"] = [r[n + 1 + len(train)] for r in by_mesh[(1, 2)]]
    out["resume"] = [r[n] for r in by_mesh[(2, 1)]]
    out["wide"] = [r[0] for r in by_mesh[WIDE]]
    out["wide_dense"] = [r[1] for r in by_mesh[WIDE]]
    out["wide_train"] = [r[2] for r in by_mesh[WIDE]]
    out["ring_cfg"], out["ring_jcfg"] = rcfg, rjcfg
    out["ring_tree"], out["ring_reqs"] = rtree, rreqs
    out["train_cfg"], out["train_mesh_cfg"] = cfg, mjcfg
    return out


def _assert_streams(got, want, reqs, jcfg, tree):
    """Greedy streams equal to JAX's, a difference allowed only at a
    genuine logit near-tie (``_replay`` within 1e-3)."""
    for row, ((g, _), exp, (_, prompt, _)) in enumerate(
            zip(got, want, reqs)):
        if g == exp:
            continue
        i = next(j for j, (a, b) in enumerate(zip(g, exp)) if a != b)
        gap = _replay(jcfg, tree, prompt + exp[:i], g[i], exp[i])
        assert gap <= 1e-3, (row, i, gap)


def _replay(jcfg, tree, ctx, a, b):
    """The logit gap of tokens a and b after ``ctx`` through JAX's ragged
    prefill (tests/test_sparse_decode.py's rule, at this max_len)."""
    import jax
    batch = {"tokens": jnp.asarray(np.asarray(ctx, np.int32)[None, :])}
    _, logits = jax.jit(lambda p, bt, n: jtransformer.lm_prefill_ragged(
        p, jcfg, bt, n, MAX_LEN))(tree, batch, jnp.asarray([len(ctx)]))
    lg = np.asarray(logits[0, -1], np.float32)
    return float(lg.max()) - min(float(lg[a]), float(lg[b]))


def _local_counts(cfg, res):
    """(slots, q heads, kv heads, FFN hidden per group) of this rank."""
    (_, dn), (_, tn) = res["dp"], res["tp"]
    f = cfg.d_ff // (cfg.spt.ffn_groups if cfg.num_experts == 0 else 1)
    hk = cfg.num_kv_heads
    return (SLOTS // dn, cfg.num_heads // tn,
            hk // tn if hk % tn == 0 else hk, f // tn)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_dense_serve_matches_unsharded_jax(runs, mesh, layout):
    want, ref = runs["jax"], runs["serve"][layout]
    for res in runs["serve_mesh"][mesh][layout]:
        assert res["stats"] == ref["stats"]
        assert res["steps_run"] == ref["steps_run"]
        _assert_streams(res["streams"], want, runs["reqs"], runs["jcfg"],
                        runs["tree"])
    if layout == "paged":
        assert ref["stats"]["admission_stalls"] > 0
        assert ref["stats"]["kv_pages_peak"] <= KV_PAGES


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sampled_streams_do_not_depend_on_the_rank(runs, mesh):
    """Each request draws from its own key (seed, uid), so a sampled
    serve under the mesh equals the world of one's."""
    ref = runs["serve"]["sampled"]
    assert ref["streams"] != runs["serve"]["dense"]["streams"]
    for res in runs["serve_mesh"][mesh]["sampled"]:
        assert res["streams"] == ref["streams"]
        assert res["stats"] == ref["stats"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_counters_reduced_over_data_equal_world_of_one(runs, mesh):
    """The paged serve runs with telemetry counters: the keep rate, the
    expert loads, the expert drop fraction and the counted tokens and
    pages equal the world of one's."""
    ref = runs["serve"]["paged"]["device"]
    assert {"keep_rate", "expert_load_imbalance", "expert_tokens_routed",
            "expert_dropped", "pages_allocated_in_loop",
            "counted_decode_tokens"} <= set(ref)
    for res in runs["serve_mesh"][mesh]["paged"]:
        got = res["device"]
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            assert got[k] == v, k


def _rules(mesh):
    import types
    from repro_torch.sharding import rules_for_mesh
    return rules_for_mesh(types.SimpleNamespace(
        mesh_dim_names=("data", "model"), mesh=np.zeros(mesh)))


def _want_caches(cfg, mesh, kv_pages=None):
    """``launch/steps.cache_local_shapes`` of the engine's caches."""
    from repro_torch.models import transformer
    caches = transformer.init_caches(cfg, SLOTS, MAX_LEN, "meta",
                                     kv_pages=kv_pages)
    return steps.cache_local_shapes(cfg, caches, _rules(mesh),
                                    kv_paged=kv_pages is not None)




@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_dense_serve_local_shapes(runs, mesh, layout):
    cfg = runs["serve_cfg"][layout]
    want = _want_caches(cfg, mesh, KV_PAGES if layout == "paged" else None)
    for res in runs["serve_mesh"][mesh][layout]:
        assert res["caches"] == want
        slots, hq, hk, f = _local_counts(_dense()[1], res)
        attn = res["caches"]["units"]["b0_attn"]
        if layout == "paged":                  # (U, P, Hk, ps, hd) pools
            assert attn["k"][1:3] == (KV_PAGES, hk)
            (q, pool), = res["shapes"]["sparse_mha_decode_paged"]
            assert q[:2] == (slots, hq) and pool[:2] == (KV_PAGES, hk)
        else:
            assert attn["k"][1:3] == (slots, hk)
            (q, k), = res["shapes"]["sparse_mha_decode"]
            assert q[:2] == (slots, hq) and k[:2] == (slots, hk)
        (x, w), = res["shapes"]["routed_ffn_decode"]
        assert x[0] == slots and w[-1] == f
        assert all(w[-1] == f for _, w in res["shapes"]["routed_ffn"])


def _split_decode_shapes(shapes, slots, cfg, s_local):
    """A decode over a sequence split over the model axis: kernels 3 and
    5 (their plain versions) on every query head (R of each of the Hk kv
    groups) and this rank's s_local slots; no whole-cache decode."""
    hk, r = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    assert "sparse_mha_decode" not in shapes
    (cq, ck), = shapes["decode_topl_thresholds"]
    assert cq[:2] == (slots * hk, r) and ck[:2] == (slots * hk, s_local)
    (q, k), = shapes["sparse_decode_attention"]
    assert q[:2] == (slots * hk, r) and k[:2] == (slots * hk, s_local)


@pytest.mark.parametrize("name", [*FAMILIES, BLOCKS, "whisper-base"])
def test_family_serve_matches_world_of_one(runs, name):
    """At (2, 2): slots over data and heads / columns / channels over
    model at once."""
    mesh = (2, 2)
    ref = runs["serve"][name]
    cfg = _family_cfg(name)
    for res in runs["serve_mesh"][mesh][name]:
        assert res["streams"] == ref["streams"]
        if "stats" in ref:
            assert res["stats"] == ref["stats"]
            assert res["steps_run"] == ref["steps_run"]
        (_, dn), (_, tn) = res["dp"], res["tp"]
        shapes = res["shapes"]
        if name != "whisper-base":
            want = _want_caches(cfg, mesh)
            got = res["caches"]
            if name == "mamba2-780m":      # the conv window: local x, B, C
                conv = got["units"]["b0_ssd"].pop("conv")
                want["units"]["b0_ssd"].pop("conv", None)
                assert conv[-1] == (cfg.d_inner // tn
                                    + 2 * cfg.ssm_state)
            assert got == want
        if name == "mamba2-780m":
            h = cfg.ssm_heads // tn
            assert res["caches"]["units"]["b0_ssd"]["h"][1:3] == (
                SLOTS // dn, h)
            assert {s[0][1] for s in shapes["ssd_step"]} == {h}
            assert {s[0][2] for s in shapes["ssd_scan"]} == {h}
            continue
        slots, hq, hk, f = _local_counts(cfg, res)
        if name == "whisper-base":
            slots = SLOTS // dn
        size = cfg.window or MAX_LEN
        if seq_parts(cfg.num_kv_heads, size, tn) > 1:
            # the one kv head's sequence split: every query head on S/n
            _split_decode_shapes(shapes, slots, cfg, size // tn)
        else:
            (q, k), = shapes["sparse_mha_decode"]
            assert q[:2] == (slots, hq) and k[:2] == (slots, hk)
        (x, w), = shapes["decode_ffn" if cfg.num_experts else
                         "routed_ffn_decode"]
        assert x[0] == slots and w[-1] == f
        if name.startswith("recurrentgemma-9b"):
            w_l = cfg.resolved_lru_width // tn
            rec = res["caches"]["units"]["b0_rec"]
            assert rec["h"][1:] == (slots, w_l)
            assert rec["conv"][1:] == (slots, cfg.conv_width - 1, w_l)
            assert {s[0][-1] for s in shapes["rglru_step"]} == {w_l}


@pytest.mark.parametrize("name", [*FAMILIES, BLOCKS, "whisper-base"])
def test_family_train_step_matches_world_of_one(runs, name):
    """At (1, 2): the sequence-parallel regions of the MoE, RG-LRU (one
    gate block and 16), SSD and encoder-decoder blocks give the world of
    one's loss and each rank the slices of its gradients that it stores;
    the gradients' global norm is the world of one's, and with it the
    clip (TRAIN_OCFG binds): after AdamW each rank's parts and first
    moments are the slices of the world of one's, the replicated leaves
    and the columns several ranks hold (a Pick's shared index set: the
    SSD's B and C) bit-equal on both ranks."""
    from repro_torch.sharding import Pick, local_slice
    ref = runs["train"][name]
    got = runs["train_mesh"][name]
    cfg = _family_cfg(name)
    sizes = {"data": 1, "model": 2}
    specs = {".".join(k): v for k, v in P.leaves(S.storage_specs(
        cfg, {"__sizes__": sizes})["train"])}
    for res in got:
        assert res["tp"][1] == 2
        _close(res["loss"], ref["loss"], "loss")
        assert res["grads"].keys() == ref["grads"].keys()
        for k, g in ref["grads"].items():
            _close(res["grads"][k], local_slice(
                torch.as_tensor(g), specs[k], sizes, res["coords"]), k)
        shapes = res["shapes"]
        if name == "mamba2-780m":
            assert {s[0][2] for s in shapes["ssd_scan"]} == {
                cfg.ssm_heads // 2}
        elif name.startswith("recurrentgemma-9b"):
            assert {s[0][-1] for s in shapes["rglru_scan"]} == {
                cfg.resolved_lru_width // 2}
        if name != "mamba2-780m":
            assert {s[0][1] for s in shapes["sparse_mha"]} == {
                cfg.num_heads // 2}
            key = "grouped_ffn" if cfg.num_experts else "routed_ffn"
            f = cfg.d_ff // (1 if cfg.num_experts else cfg.spt.ffn_groups)
            assert {s[1][-1] for s in shapes[key]} == {f // 2}
        assert ref["grad_norm"] > 10 * TRAIN_OCFG["grad_clip"]
        for key in ("norm", "grad_norm"):
            _close(res[key], ref[key], key)
        for key in ("after", "after_m"):
            assert res[key].keys() == ref[key].keys()
            for k, w in ref[key].items():
                _close(res[key][k], local_slice(
                    torch.as_tensor(w), specs[k], sizes, res["coords"]),
                    f"{key} {k}")
    picks = 0
    first, second = sorted(got, key=lambda res: res["coords"]["model"])
    for key in ("after", "after_m"):
        for k, v in first[key].items():
            other = second[key][k]
            spec = specs[k]
            if spec == (None,) * len(v.shape):    # a replicated leaf
                assert np.array_equal(other, v), k
            elif isinstance(spec, Pick):          # its shared columns
                i0, i1 = spec.index
                both = sorted(set(i0) & set(i1))
                assert both, k
                a = np.take(v, [i0.index(c) for c in both], axis=spec.dim)
                b = np.take(other, [i1.index(c) for c in both],
                            axis=spec.dim)
                assert np.array_equal(a, b), k
                picks += 1
    assert picks == (2 if name == "mamba2-780m" else 0)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_serve_stores_its_vocabulary_rows(runs, mesh):
    """Each rank of a serving mesh stores V/n rows of the embedding (and
    of an untied head's columns), n the model extent: no whole table."""
    for name, results in runs["serve_mesh"][mesh].items():
        cfg = runs["serve_cfg"][name]
        v = cfg.padded_vocab // mesh[1]
        for res in results:
            assert res["vocab"]["embed"] == (v, cfg.d_model), name
            if not cfg.tie_embeddings and cfg.family != "audio":
                assert res["vocab"]["head"] == (cfg.d_model, v), name


def test_serve_launcher_runs_a_1x2_mesh(runs):
    first, second = runs["launcher"]
    assert first["rc"] == 0 and second["rc"] == 0
    assert second["out"] == ""                  # rank 0 alone prints
    blob = json.loads(first["out"])
    assert blob["mesh"] == "1x2" and blob["completed"] == 2
    assert blob["generated_tokens"] == 6


def test_resume_under_a_world_of_two_matches_uninterrupted(runs):
    for res in runs["resume"]:
        assert res["stopped"] == (2, True)
        assert res["start"] == 2 and res["final"] == (4, 4)
        assert sorted(res["first"]) == [1, 2]
        assert sorted(res["second"]) == [3, 4]
        for step in (1, 2):
            assert res["first"][step] == res["full"][step]
        for step in (3, 4):
            _close(res["second"][step], res["full"][step], f"loss {step}")
        for k, v in res["full_after"].items():
            _close(res["resumed_after"][k], v, k)
    a, b = runs["resume"]
    for k, v in a["resumed_after"].items():
        assert np.array_equal(b["resumed_after"][k], v), k


def test_serving_helpers_cost_nothing_at_extent_one():
    """At extent 1 the serving helpers are the identity (no process
    group needed); a rank's stored part (``sharding.local_slice``, which
    builds a serving shard from a whole model) is its chunk of a placed
    dim, or its index set of a Pick (rank 1 of 2 here; no collective)."""
    from repro_torch.core import collectives as C
    from repro_torch.sharding import local_slice
    x = torch.arange(12.0).reshape(4, 3)
    assert C.model_sum(x, None) is x
    assert C.all_gather_flat(x.flatten(), None).shape == (1, 12)
    assert torch.equal(C.all_reduce_flat(x, None), x)
    assert C.zero_gather({"w": x}, ((("w",), 0),), None) == {"w": x}
    sizes, coords = {"model": 2}, {"model": 1}
    assert torch.equal(local_slice(x, ("model", None), sizes, coords), x[2:])
    assert local_slice(x, None, sizes, coords) is x
    assert torch.equal(local_slice(x, C.Pick(0, ((0, 2), (1, 3))), sizes,
                                   coords), x[[1, 3]])


def test_wide_serve_matches_unsharded_jax(runs):
    """(1, 4): each rank's one query head lies inside one of the 2 kv
    heads, and every cache holds all kv heads over its S/4 slots (JAX's
    cache specs); the streams equal JAX's unsharded ones (replay rule)."""
    cfg = runs["serve_cfg"]["dense"]
    want = _want_caches(cfg, WIDE)
    for res in runs["wide"]:
        assert res["tp"] == (res["tp"][0], 4)
        _assert_streams(res["streams"], runs["jax"], runs["reqs"],
                        runs["jcfg"], runs["tree"])
        assert res["stats"] == runs["serve"]["dense"]["stats"]
        assert res["caches"] == want
        attn = res["caches"]["units"]["b0_attn"]
        assert attn["k"][1:4] == (SLOTS, cfg.num_kv_heads, MAX_LEN // 4)
        assert attn["slot_pos"][1:] == (SLOTS, MAX_LEN)
        _split_decode_shapes(res["shapes"], SLOTS, cfg, MAX_LEN // 4)


def test_wide_dense_attention_matches_world_of_one(runs):
    """(1, 4) with sparse MHA off: each rank attends over every valid
    slot of its part of the sequence and the parts combine by their
    log-sum-exps; the streams equal the port's world of one's."""
    ref = runs["dense_attn"]
    for res in runs["wide_dense"]:
        assert res["streams"] == ref["streams"]
        assert res["stats"] == ref["stats"]
        k = res["caches"]["units"]["b0_attn"]["k"]
        assert k[1:4] == (SLOTS, 2, MAX_LEN // 4)


def test_wide_train_step_matches_unsharded_jax(runs):
    """(1, 4): one train step's loss and each rank's stored gradient
    parts (q and o over the heads, k and v over their columns: JAX's
    placement) against JAX's unsharded ``jax.grad``; each rank's region
    runs its one query head on its kv head."""
    ref, cfg = runs["jax_train"], runs["train_cfg"]
    for res in runs["wide_train"]:
        _close(res["loss"], ref["loss"], "loss")
        MG._close_parts(res, cfg, WIDE, res["grads"], ref["grads"], "grad")
        assert {(q[1], k[1]) for q, k in res["shapes"]["sparse_mha"]} == {
            (1, 1)}


def test_ring_serve_matches_unsharded_jax(runs):
    """(1, 2), one kv head, a 16-slot SWA ring that the prompts and the
    streams wrap: each rank holds 8 slots of the ring, the owner of a
    token's slot writes it, and the streams equal JAX's unsharded ones
    (replay rule)."""
    cfg = runs["ring_cfg"]
    want = _want_caches(cfg, (1, 2))
    assert all(len(t) + m > cfg.window for _, t, m in runs["ring_reqs"])
    for res in runs["ring"]:
        _assert_streams(res["streams"], runs["jax_ring"], runs["ring_reqs"],
                        runs["ring_jcfg"], runs["ring_tree"])
        assert res["caches"] == want
        attn = res["caches"]["units"]["b0_attn"]
        assert attn["k"][1:4] == (SLOTS, 1, cfg.window // 2)
        _split_decode_shapes(res["shapes"], SLOTS, cfg, cfg.window // 2)
