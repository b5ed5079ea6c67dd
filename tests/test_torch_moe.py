"""The port's MoE family against the JAX package's, on both MoE smoke
configs (grok-1-314b: GeGLU, no window; mixtral-8x22b: SwiGLU, window 32)
in f32, 2 layers, 4 experts top 2:

  * the registry: every arch the port registers (mixtral, grok, qwen3,
    gemma-7b, the two h2o-danube configs, recurrentgemma-9b) equals JAX's
    ``config()`` and ``smoke()`` field for field, and ``cell_supported``
    agrees;
  * ``moe_apply`` in train, prefill, decode and ragged ``seq_lengths``
    modes, against JAX's grouped path and its Pallas path (interpret
    mode), through the port's plain path and its kernel path (whose
    wrappers take their plain versions on CPU tensors): y to max-abs
    <= 1e-5 x max |y|, lb_loss to rel 1e-6, dropped, choices and plans
    exactly; gradients of x, the router and the LoRA leaves against
    ``jax.grad`` to 1e-4 x the leaf's largest entry; the telemetry
    counters;
  * the LM's ragged-prefill and decode logits (1e-4);
  * greedy ``Engine.run`` streams and ServeStats against JAX's Engine,
    sparse MHA on and off, contiguous and (grok) paged;
  * one train step: loss, grad norm, the first moments (the gradients)
    and the updated leaves;
  * the windowed-prefill repair: a SWA stack prefills at exact length
    and groups equal-length rows only, so the port's Engine gives JAX's
    completions and ServeStats (``prefill_batches`` included) on qwen3
    with window 8 and on mixtral (window 32) with prompts past it;
  * ``length_sensitive`` holds for MoE; kernel 10's width limit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import dispatch as jdispatch
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
from repro.data import pipeline as jpipeline
from repro_torch import configs, kernels
from repro_torch.core import dispatch
from repro_torch.core.params import (from_numpy_state, from_numpy_tree,
                                     leaves)
from repro_torch.data import pipeline
from repro_torch.kernels.routed_ffn import ops as rffn_ops
from repro_torch.models import moe, transformer
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.serving.engine import Engine, Request
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_model import (close, jax_params, np_init_tree,
                              perturb_lora, port_cfg, port_model, t)
from test_torch_model import (jax_trainer, keep_sigterm,  # noqa: F401
                              np_train_state)

MOE = ("grok-1-314b", "mixtral-8x22b")
REL = 1e-5          # y: max-abs <= REL x max |y|
GRAD_REL = 1e-4     # gradients: max-abs <= GRAD_REL x the leaf's max
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(arch, **spt):
    cfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32)
    return cfg.with_spt(**spt) if spt else cfg


def _rel_close(got, want, rel):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max()), 1e-30)
    assert float(np.abs(g - w).max()) <= rel * scale, (
        float(np.abs(g - w).max()), scale)


# ------------------------------------------------------------ registry
@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_registry_configs_match_jax(name):
    assert name in configs.ARCH_NAMES
    assert configs.get_config(name) == port_cfg(jconfigs.get_config(name))
    assert configs.get_smoke(name) == port_cfg(jconfigs.get_smoke(name))
    for shape in ("train_4k", "long_500k"):
        assert (configs.cell_supported(name, shape)
                == jconfigs.cell_supported(name, shape))


def test_spt_disabled_matches_jax():
    cfg = jconfigs.get_smoke("grok-1-314b")
    assert (port_cfg(dataclasses.replace(cfg, spt=cfg.spt.disabled()))
            == dataclasses.replace(port_cfg(cfg),
                                   spt=port_cfg(cfg).spt.disabled()))


def test_length_sensitive_holds_for_moe():
    """Right-padding changes MoE outputs (pad tokens take expert slots),
    so a dense-attention MoE stack is still length-sensitive."""
    for arch in MOE:
        jcfg = _jcfg(arch, sparse_mha=False, routed_ffn=False)
        assert jtransformer.length_sensitive(jcfg)
        assert transformer.length_sensitive(port_cfg(jcfg))


# ------------------------------------------------------------ the layer
def _moe_tree(jcfg):
    tree = np_init_tree(jmoe.moe_defs(jcfg), 0)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    return perturb_lora(tree, np.random.default_rng(1))


def _port_p(tree):
    return from_numpy_tree(tree, "cpu", {"bfloat16": torch.float32})


def _x(jcfg, b, s, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)


MODES = [("train", 40, None), ("prefill", 40, None), ("decode", 1, None),
         ("ragged", 40, [40, 17, 29])]


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("mode,s,lens", MODES,
                         ids=[m for m, _, _ in MODES])
@pytest.mark.parametrize("jax_impl", ["grouped", "pallas"])
def test_moe_apply_matches_jax(arch, mode, s, lens, jax_impl):
    """Capacity factor 0.5 makes the plan drop pairs, so dropped and the
    plans are held where they matter."""
    jcfg = dataclasses.replace(_jcfg(arch), moe_capacity_factor=0.5)
    tree = _moe_tree(jcfg)
    x = _x(jcfg, 3, s)
    sl = None if lens is None else np.asarray(lens, np.int32)
    mm = "prefill" if mode == "ragged" else mode
    yj, aj = jmoe.moe_apply(
        tree, jnp.asarray(x), jcfg.with_spt(ffn_impl=jax_impl), mode=mm,
        seq_lengths=None if sl is None else jnp.asarray(sl))
    p = _port_p(tree)
    for impl in ("grouped", "pallas"):
        cfg = port_cfg(jcfg).with_spt(ffn_impl=impl)
        with torch.no_grad():
            yt, at = moe.moe_apply(p, t(x), cfg, mode=mm,
                                   seq_lengths=None if sl is None else t(sl))
        _rel_close(yt, yj, REL)
        np.testing.assert_allclose(float(at["lb_loss"]), float(aj["lb_loss"]),
                                   rtol=1e-6)
        assert float(at["dropped"]) == float(aj["dropped"])
    if mode == "train":
        assert float(aj["lb_loss"]) > 0
    else:
        assert float(aj["lb_loss"]) == 0.0
    if mode in ("train", "ragged"):
        assert float(aj["dropped"]) > 0               # capacity binds
    # routing and plans, exactly
    cj, gj, _ = jmoe._route_experts(tree, jnp.asarray(x), jcfg)
    ct, gt, _ = moe._route_experts(p, t(x), port_cfg(jcfg))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    close(gt, gj, 1e-6)
    if mode != "decode":
        cap_dyn = (None if sl is None else jmoe._moe_cap_dyn(
            jcfg, jnp.asarray(sl)))
        cap = jdispatch.capacity(s, jcfg.num_experts,
                                 jcfg.experts_per_token,
                                 jcfg.moe_capacity_factor,
                                 pad=jcfg.spt.dispatch_pad)
        pj = jdispatch.make_plan(cj, gj, jcfg.num_experts, cap,
                                 cap_dyn=cap_dyn)
        pt = moe._plan(t(x), ct, gt, port_cfg(jcfg),
                       None if sl is None else t(sl))
        np.testing.assert_array_equal(pt.index.numpy(), np.asarray(pj.index))
        np.testing.assert_array_equal(pt.slot_ok.numpy(),
                                      np.asarray(pj.slot_ok))


def test_route_experts_breaks_ties_to_the_lower_index():
    jcfg = _jcfg("grok-1-314b")
    p = {"router": torch.zeros(jcfg.d_model, jcfg.num_experts)}
    choice, gate, _ = moe._route_experts(p, torch.ones(1, 2, jcfg.d_model),
                                         port_cfg(jcfg))
    cj, _, _ = jmoe._route_experts(
        {"router": jnp.zeros((jcfg.d_model, jcfg.num_experts))},
        jnp.ones((1, 2, jcfg.d_model)), jcfg)
    np.testing.assert_array_equal(choice.numpy(), np.asarray(cj))
    assert choice[0, 0].tolist() == [0, 1]
    np.testing.assert_array_equal(gate.numpy(), 0.5)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("impl", ["grouped", "pallas"])
def test_moe_grads_match_jax(arch, impl):
    """jax.grad of sum(y^2) + lb_loss (the JAX Pallas path's custom VJP
    differentiates its grouped reference, as the port's Function does)."""
    jcfg = _jcfg(arch)
    tree = _moe_tree(jcfg)
    x = _x(jcfg, 2, 24, seed=3)

    def jloss(pp, xx):
        y, aux = jmoe.moe_apply(pp, xx, jcfg.with_spt(ffn_impl=impl),
                                mode="train")
        return jnp.sum(y ** 2) + aux["lb_loss"]

    gp, gx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    p = _port_p(tree)
    trainable = [(path, v) for path, v in leaves(p)
                 if path[0] == "router" or path[0].startswith("lora")]
    for _, v in trainable:
        v.requires_grad_(True)
    xt = t(x).requires_grad_(True)
    y, aux = moe.moe_apply(p, xt, port_cfg(jcfg).with_spt(ffn_impl=impl),
                           mode="train")
    got = torch.autograd.grad((y ** 2).sum() + aux["lb_loss"],
                              [xt] + [v for _, v in trainable])
    _rel_close(got[0].numpy(), gx, GRAD_REL)
    for (path, _), g in zip(trainable, got[1:]):
        want = gp
        for k in path:
            want = want[k]
        assert np.abs(np.asarray(want)).max() > 0, path
        _rel_close(g.numpy(), want, GRAD_REL)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("mode,s,lens", [("prefill", 24, [24, 9]),
                                         ("decode", 1, None)])
def test_moe_telemetry_counters_match_jax(arch, mode, s, lens):
    jcfg = _jcfg(arch, telemetry="counters")
    tree = _moe_tree(jcfg)
    x = _x(jcfg, 2, s, seed=4)
    sl = None if lens is None else np.asarray(lens, np.int32)
    for impl in ("grouped", "pallas"):
        _, aj = jmoe.moe_apply(
            tree, jnp.asarray(x), jcfg.with_spt(ffn_impl=impl), mode=mode,
            seq_lengths=None if sl is None else jnp.asarray(sl))
        with torch.no_grad():
            _, at = moe.moe_apply(
                _port_p(tree), t(x), port_cfg(jcfg).with_spt(ffn_impl=impl),
                mode=mode, seq_lengths=None if sl is None else t(sl))
        np.testing.assert_array_equal(at["tel_expert_load"].numpy(),
                                      np.asarray(aj["tel_expert_load"]))
        assert at["tel_expert_load"].shape == (2, jcfg.num_experts)
        assert float(at["tel_expert_drop"]) == float(aj["tel_expert_drop"])


def test_moe_kill_switch_and_launch_counts(monkeypatch):
    """The kernel path's wrappers run (their plain versions, uncounted, on
    the CPU); REPRO_DISABLE_KERNELS=1 takes the plain path with the same
    result."""
    jcfg = _jcfg("grok-1-314b")
    p = _port_p(_moe_tree(jcfg))
    x = t(_x(jcfg, 2, 16, seed=5))
    cfg = port_cfg(jcfg).with_spt(ffn_impl="pallas")
    calls = []
    for name in ("grouped_ffn", "decode_ffn"):
        real = getattr(rffn_ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(rffn_ops, name, spy)
    with torch.no_grad():
        y1, _ = moe.moe_apply(p, x, cfg, mode="prefill")
        moe.moe_apply(p, x[:, :1], cfg, mode="decode")
        assert calls == ["grouped_ffn", "decode_ffn"]
        monkeypatch.setenv("REPRO_DISABLE_KERNELS", "1")
        assert not dispatch.use_routed_ffn_kernel(cfg)
        y2, _ = moe.moe_apply(p, x, cfg, mode="prefill")
    assert calls == ["grouped_ffn", "decode_ffn"]
    torch.testing.assert_close(y1, y2, rtol=1e-6, atol=1e-6)


def test_moe_ragged_kernel_path_is_forward_only():
    jcfg = _jcfg("grok-1-314b")
    p = _port_p(_moe_tree(jcfg))
    x = t(_x(jcfg, 2, 8)).requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        moe.moe_apply(p, x, port_cfg(jcfg).with_spt(ffn_impl="pallas"),
                      mode="prefill", seq_lengths=torch.tensor([8, 5]))


def test_decode_ffn_refuses_widths_past_its_shared_memory(monkeypatch):
    """Kernel 10 stages x as stored: bf16 takes d = 6144 (the MoE width),
    f32 refuses it with the limit stated, before anything is built."""
    assert rffn_ops.decode_ffn_max_d(16, 2) >= 6144
    assert rffn_ops.decode_ffn_max_d(16, 4) < 6144

    def meta(*shape, dtype):
        return torch.empty(*shape, dtype=dtype, device="meta")
    choice = meta(8, 2, dtype=torch.int32)
    gate = meta(8, 2, dtype=torch.float32)
    x, wi, wo = (meta(8, 6144, dtype=torch.float32),
                 meta(8, 6144, 64, dtype=torch.float32),
                 meta(8, 64, 6144, dtype=torch.float32))
    with pytest.raises(ValueError, match="takes d up to 6104"):
        rffn_ops.decode_ffn(x, choice, gate, wi, wo, act="relu")
    built = []
    monkeypatch.setattr(kernels, "library",
                        lambda: built.append(1) or (_ for _ in ()).throw(
                            RuntimeError("build")))
    # bf16 passes the contract: a meta tensor (a dry run) gets the
    # kernel's output and nothing is built
    y = rffn_ops.decode_ffn(x.to(torch.bfloat16), choice, gate,
                            wi.to(torch.bfloat16), wo.to(torch.bfloat16),
                            act="relu")
    assert y.is_meta and y.shape == (8, 6144) and y.dtype == torch.bfloat16
    assert built == [] and kernels._lib is None


# ------------------------------------------------------------ the model
def _prefill_batch(s):
    rng = np.random.default_rng(11)
    lens = np.array([s, s // 3, s - 5], np.int32)
    toks = np.zeros((3, s), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, 256, n)
    return toks, lens


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("spt", [
    dict(attn_impl="pallas", ffn_impl="pallas"),
    dict(attn_impl="sparse_jnp", ffn_impl="grouped")], ids=["kernel",
                                                             "oracle"])
def test_lm_prefill_ragged_and_decode_logits_match(arch, spt):
    jcfg = _jcfg(arch, **spt)
    tree = jax_params(jcfg)
    model = port_model(jcfg, tree)
    pcfg = model.cfg
    toks, lens = _prefill_batch(24)
    jc, jl = jax.jit(lambda p, b, n: jtransformer.lm_prefill_ragged(
        p, jcfg, b, n, 48))(tree, {"tokens": jnp.asarray(toks)},
                            jnp.asarray(lens))
    with torch.no_grad():
        tc, tl = transformer.lm_prefill_ragged(
            model, pcfg, {"tokens": t(toks, torch.long)}, t(lens), 48)
    close(tl, jl, LOGIT_TOL)
    jblk, tblk = jc["units"]["b0_attn"], tc["units"]["b0_attn"]
    np.testing.assert_array_equal(tblk["slot_pos"].numpy(),
                                  np.asarray(jblk["slot_pos"]))
    tc = {"units": {"b0_attn": {k: t(v) for k, v in jblk.items()}}}
    tok = np.asarray(jl[:, -1].argmax(-1), np.int32)
    _, jd = jax.jit(lambda p, c, tk, ps: jtransformer.lm_decode_step(
        p, jcfg, c, tk, ps))(tree, jc, jnp.asarray(tok), jnp.asarray(lens))
    with torch.no_grad():
        td = transformer.lm_decode_step(model, pcfg, tc, t(tok, torch.long),
                                        t(lens))
    close(td, jd, LOGIT_TOL)


# ------------------------------------------------------------ serving
def _replay_gap(jcfg, tree, ctx, a, b, max_len):
    batch = {"tokens": jnp.asarray(np.asarray(ctx, np.int32)[None, :])}
    _, logits = jax.jit(lambda p, bt, n: jtransformer.lm_prefill_ragged(
        p, jcfg, bt, n, max_len))(tree, batch, jnp.asarray([len(ctx)]))
    lg = np.asarray(logits[0, -1], np.float32)
    return float(lg.max()) - min(float(lg[a]), float(lg[b]))


STAT_KEYS = ("admitted", "completed", "prefill_batches", "prefill_tokens",
             "decode_tokens", "decode_steps", "preemptions", "rejections",
             "kv_pages_total", "kv_pages_peak", "admission_stalls",
             "page_size")


def _serve_both(jcfg, tree, prompts, gen, max_len, slots, chunk, **kw):
    """Greedy Engine.run of the prompts in both packages: (port
    completions, port stats, JAX completions, JAX stats)."""
    jeng = JEngine(jcfg, tree, max_len=max_len, num_slots=slots,
                   decode_chunk=chunk, **kw)
    want = jeng.run([JRequest(uid=i, tokens=p, max_new_tokens=gen)
                     for i, p in enumerate(prompts)])
    model = port_model(jcfg, tree)
    eng = Engine(model.cfg, model, max_len=max_len, num_slots=slots,
                 decode_chunk=chunk, device="cpu", **kw)
    with torch.no_grad():
        got = eng.run([Request(uid=i, tokens=p, max_new_tokens=gen)
                       for i, p in enumerate(prompts)])
    return got, eng.last_stats, want, jeng.last_stats


def _assert_served_alike(jcfg, tree, prompts, served, max_len):
    got, st, want, jst = served
    assert [c.finish_reason for c in got] == [c.finish_reason for c in want]
    for row, (prompt, g, w) in enumerate(zip(prompts, got, want)):
        if g.tokens == w.tokens:
            continue
        i = next(j for j, (a, b) in enumerate(zip(g.tokens, w.tokens))
                 if a != b)
        gap = _replay_gap(jcfg, tree, prompt + w.tokens[:i], g.tokens[i],
                          w.tokens[i], max_len)
        assert gap <= 1e-3, (row, i, gap)
    for key in STAT_KEYS:
        assert getattr(st, key) == getattr(jst, key), key


def _prompts(lens, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in lens]


SERVE_CASES = [("grok-1-314b", "contiguous", True),
               ("grok-1-314b", "contiguous", False),
               ("grok-1-314b", "paged", True),
               ("mixtral-8x22b", "contiguous", True),
               ("mixtral-8x22b", "contiguous", False)]


@pytest.mark.parametrize("arch,layout,sparse", SERVE_CASES,
                         ids=[f"{a}-{lay}-{'sparse' if s else 'dense'}"
                              for a, lay, s in SERVE_CASES])
def test_moe_engine_streams_and_stats_match_jax(arch, layout, sparse):
    jcfg = _jcfg(arch, attn_impl="pallas", ffn_impl="pallas",
                 sparse_mha=sparse, kv_layout=layout, kv_page_size=8)
    tree = jax_params(jcfg)
    prompts = _prompts([9, 14, 5, 11, 7, 14])
    served = _serve_both(jcfg, tree, prompts, 6, 32, 2, 4)
    _assert_served_alike(jcfg, tree, prompts, served, 32)
    assert served[1].prefill_batches >= 3
    if layout == "paged":
        assert served[1].kv_pages_total > 0


def test_moe_engine_telemetry_reads_every_expert():
    """Telemetry counters through a MoE serve: the drained expert loads
    (E of them) and the run's aggregates (expert_load_imbalance over E
    experts, tokens routed, drops) equal JAX's."""
    jcfg = _jcfg("grok-1-314b", attn_impl="pallas", ffn_impl="pallas",
                 telemetry="counters")
    tree = jax_params(jcfg)
    prompts = _prompts([9, 14, 5, 11])
    jeng = JEngine(jcfg, tree, max_len=32, num_slots=2, decode_chunk=4)
    jeng.run([JRequest(uid=i, tokens=p, max_new_tokens=5)
              for i, p in enumerate(prompts)])
    model = port_model(jcfg, tree)
    eng = Engine(model.cfg, model, max_len=32, num_slots=2, decode_chunk=4,
                 device="cpu")
    with torch.no_grad():
        eng.run([Request(uid=i, tokens=p, max_new_tokens=5)
                 for i, p in enumerate(prompts)])
    got, want = eng.last_recorder, jeng.last_recorder
    assert len(got.expert_load_vector()) == jcfg.num_experts
    assert got.expert_load_vector() == want.expert_load_vector()
    agg, jagg = got.device_aggregates(), want.device_aggregates()
    for key in ("expert_load_imbalance", "expert_tokens_routed",
                "expert_dropped"):
        assert agg[key] == jagg[key], key


# ------------------------------------------------------------ the repair
WINDOW_CASES = [("qwen3-0.6b", 8, [5, 9, 13, 13], 32),
                ("mixtral-8x22b", None, [20, 33, 40, 40], 64)]


@pytest.mark.parametrize("arch,window,lens,max_len", WINDOW_CASES,
                         ids=[c[0] for c in WINDOW_CASES])
def test_windowed_prefill_matches_jax(arch, window, lens, max_len):
    """A SWA stack prefills each group at its exact length and groups
    equal-length rows only: right-padding would push real K/V out of the
    window-sized ring (a 9-token prompt padded to 16 keeps positions
    8-15, of which only 8 is real).  Kernels off, f32, prefill_batch 4."""
    jcfg = _jcfg(arch)
    if window is not None:
        jcfg = dataclasses.replace(jcfg, window=window)
    tree = jax_params(jcfg)
    prompts = _prompts(lens, seed=6)
    served = _serve_both(jcfg, tree, prompts, 6, max_len, 4, 4,
                         prefill_batch=4)
    _assert_served_alike(jcfg, tree, prompts, served, max_len)
    # the two equal-length rows share a group; the others prefill alone
    assert served[1].prefill_batches == 3


# ------------------------------------------------------------ training
def test_moe_train_step_matches_jax():
    """One build_train_step step on the mixtral smoke config (window 32,
    sequences of 40 so it binds), kernel config: loss, grad norm and the
    updated train leaves against JAX's Trainer."""
    jcfg = _jcfg("mixtral-8x22b", attn_impl="pallas", ffn_impl="pallas")
    st = np_train_state(jcfg)
    st["train"] = perturb_lora(st["train"], np.random.default_rng(1))
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    dcfg = dict(vocab_size=256, seq_len=40, global_batch=2, kind="random",
                seed=3)
    jbatches = list(jpipeline.synthetic_dataset(
        jpipeline.DataConfig(**dcfg), 1))
    jtr = jax_trainer(jcfg, JOptimizerConfig(**ocfg),
                      JTrainerConfig(total_steps=1, log_interval=1), st)
    jrep = jtr.run(iter(jbatches))
    batches = list(pipeline.synthetic_dataset(pipeline.DataConfig(**dcfg), 1))
    tr = Trainer(port_cfg(jcfg), OptimizerConfig(**ocfg),
                 TrainerConfig(total_steps=1, log_interval=1),
                 state=from_numpy_state(st, "cpu"))
    rep = tr.run(iter(batches))
    jm, m = jrep["metrics"][-1], rep["metrics"][-1]
    for k in ("loss", "lm_loss", "lb_loss", "grad_norm", "dropped"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    def flat(tree):
        return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want, want_m = flat(jtr.state["train"]), flat(jtr.state["opt"]["m"])
    got = dict(leaves(tr.state["train"]))
    got_m = dict(leaves(tr.state["opt"]["m"]))
    assert set(got) == set(want) == set(got_m)
    assert any(p[-1] == "router" for p in got)
    for path, v in got.items():
        # the first moment is (1 - b1) g: the gradients, to GRAD_REL
        m = want_m[path]
        if np.abs(m).max() > 0:
            _rel_close(got_m[path].numpy(), m, GRAD_REL)
        # AdamW's first step moves an entry by lr g / (|g| + eps), which
        # turns f32 noise in a near-zero gradient into a visible change:
        # entries with |g| >= 1e-3 x the leaf's max to 1e-6, the rest
        # within the step's bound
        big = np.abs(m) >= 1e-3 * np.abs(m).max()
        diff = np.abs(v.detach().numpy() - want[path])
        assert float(diff[big].max(initial=0.0)) <= 1e-6, path
        assert float(diff.max()) <= 2 * ocfg["lr"], path
