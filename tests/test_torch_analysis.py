"""The port's analysis package (``src/repro_torch/analysis``): each rule
fires on a deliberately violating fixture and stays quiet on a good one,
so ``python -m repro_torch.analysis`` being green means the rules are
alive, not vacuous; the whole registry is clean at HEAD; and the audits
are held against the JAX package's: the distinct kernels each entrypoint
reaches equal JAX's ``pallas_calls`` in its read-only
``scripts/analysis_baselines.json``, and every JAX rule id maps to a port
rule or to a stated reason.

Fixtures: synthetic sources for the lint; tiny torch programs under
``op_audit.OpLog`` for the op, liveness and in-place rules; synthetic
ptxas lines, usage rows and sources for the kernel rules; an ``.item()``
inside the decode chunk and a module built per iteration for the guard.
Also the counterparts of the JAX tests that go through ``repro.analysis``
(test_liveness, test_routed_ffn_kernel, test_moe_kernel): the decode path
builds no dispatch buffer, a plain decode_ffn_impl overrides the kernel,
the kill switch reaches no kernel, pinned vs in-place, in-place cache
writes, kernel scratch counted exactly, the memory audits clean."""
import ast
import dataclasses
import json
import re
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.analysis import (JAX_RULES, baselines, donation,
                                  kernel_audit as ka, lint, liveness,
                                  op_audit as oa, registry, trace_guard as tg)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.op_audit import OpLog
from test_torch_model import keep_sigterm, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def rules(violations):
    return sorted({v.rule for v in violations})


def logged(fn, *args, **held):
    """Run ``fn(*args)`` under an OpLog with ``held`` as the arguments."""
    log = OpLog().hold(*held.values())
    with log:
        out = fn(*args)
    log.outputs(out)
    return log, out


# -------------------------------------------------------------- registry
def test_registry_rejects_duplicates_and_unknown_names():
    with pytest.raises(ValueError):
        registry.audit("lint")(lambda: [])
    with pytest.raises(KeyError):
        registry.run_audits(["no-such-audit"])


def test_run_audits_streams_reports():
    seen = []
    registry.run_audits(["lint"], report=lambda n, vs: seen.append(n))
    assert seen == ["lint"]


def test_cli_lists_every_layer_and_runs_one(capsys):
    assert cli.main(["--list"]) == 0
    listed = capsys.readouterr().out.split()
    assert sorted(listed) == ["donation", "kernels", "lint", "liveness",
                              "memory", "ops", "trace"]
    assert cli.main(["--only", "lint"]) == 0
    assert "clean" in capsys.readouterr().out
    assert cli.main(["--only", "nope"]) == 2


# ------------------------------------------------------------------ lint
def test_lint_cache_repeat_fires_in_models_and_serving_only():
    src = ("k2 = k_cache.repeat(1, 4, 1, 1)\n"
           "v2 = cache['v'].expand(2, 8, 64, 16)\n"
           "m = mask.repeat_interleave(4, dim=0)\n")
    for rel in ("models/foo.py", "serving/foo.py"):
        vs = lint.lint_source(src, rel)
        assert rules(vs) == ["lint.cache-repeat"] and len(vs) == 3
    assert lint.lint_source(src, "core/foo.py") == []
    # a mask or a position broadcast is not a cache
    assert lint.lint_source("p = pos.expand(4, 1)\nq = m.repeat(2)\n",
                            "models/foo.py") == []


def test_lint_host_sync_fires_in_hot_modules():
    src = ("import numpy as np\nimport torch\n"
           "n = int(count.item())\nl = t.tolist()\nh = t.cpu()\n"
           "a = t.numpy()\nb = np.asarray(dev)\ntorch.cuda.synchronize()\n")
    for rel in ("models/foo.py", "kernels/foo.py", "core/foo.py",
                "serving/telemetry.py"):
        vs = lint.lint_source(src, rel)
        assert rules(vs) == ["lint.host-sync"] and len(vs) == 6
    # the engine's host scheduler is exempt by design; launch/ is not hot
    assert lint.lint_source(src, "serving/engine.py") == []
    assert lint.lint_source(src, "launch/foo.py") == []


def test_lint_dispatch_routing():
    bad = ["import os\nflag = os.environ.get('REPRO_DISABLE_KERNELS')\n",
           "from repro_torch import kernels\nlib = kernels.library()\n",
           "err = lib.repro_decode_ffn(1, 2)\n",
           "import ctypes\n"]
    for src in bad:
        assert rules(lint.lint_source(src, "models/foo.py")) \
            == ["lint.dispatch-routing"]
    good = ('"""REPRO_DISABLE_KERNELS=1 sends this to the oracle."""\n'
            "from repro_torch.core import dispatch\n"
            "ok = dispatch.kernels_disabled()\n")
    assert lint.lint_source(good, "serving/foo.py") == []


def test_lint_paged_gather_fires_outside_the_fallback_tier():
    src = "view = kv_pages.gather_pages(pool, pt)\n"
    assert rules(lint.lint_source(src, "models/foo.py")) \
        == ["lint.paged-gather"]
    assert lint.lint_source(src, "models/paged_fallback.py") == []


def test_lint_kernel_wrapper_needs_the_counted_decorator():
    bad = ("from repro_torch import kernels\n"
           "def op(x):\n    return kernels.library().repro_op(x)\n"
           "def _launch(x):\n    return kernels.library().repro_op(x)\n"
           "def outer(x):\n    return _launch(x)\n")
    vs = lint.lint_source(bad, "kernels/foo/ops.py")
    assert rules(vs) == ["lint.kernel-wrapper"] and len(vs) == 2
    good = ("from repro_torch import kernels\n"
            "from repro_torch.kernels import cost\n"
            "@cost.counted('op')\n"
            "def op(x):\n    return kernels.library().repro_op(x)\n"
            "def user(x):\n    return op(x) + 1\n")
    assert lint.lint_source(good, "kernels/foo/ops.py") == []


EXEMPTIONS = sorted(list(lint.EXEMPT_SITES) + [(r, f, None)
                                                for r, f in lint.EXEMPT])


@pytest.mark.parametrize("rule,rel,owner", EXEMPTIONS)
def test_lint_exemption_is_live_and_reasoned(monkeypatch, rule, rel, owner):
    """Each exemption suppresses a real finding of its rule in its file
    (no stale entry), and states its reason."""
    reason = (lint.EXEMPT_SITES[(rule, rel, owner)] if owner
              else lint.EXEMPT[(rule, rel)])
    assert len(reason) > 40
    src = (lint.SRC_ROOT / rel).read_text()
    if owner:
        monkeypatch.delitem(lint.EXEMPT_SITES, (rule, rel, owner))
    else:
        monkeypatch.delitem(lint.EXEMPT, (rule, rel))
    hit = [v for v in lint.lint_source(src, rel) if v.rule == rule]
    assert hit, (rule, rel, owner)


def test_lint_repo_tree_clean():
    assert lint.run_lint() == []


# ------------------------------------------------------------ op rules
def test_dispatch_buffer_rule_fires_on_capacity_path():
    """The grouped capacity path at decode shape builds (B, G, C, d)
    buffers — the violating twin of the clean ops.routed_ffn_decode."""
    from repro_torch.core import lora as lora_mod
    from repro_torch.core import routed_ffn as rf
    from repro_torch.core.params import init_tree
    lcfg = lora_mod.LoRAConfig(rank=4, alpha=4.0, enabled=False)
    rcfg = rf.RoutedFFNConfig(d_model=64, d_ff=128, num_groups=8,
                              active_groups=2, capacity_factor=4.0,
                              gated=True, activation="gelu")
    p = init_tree(rf.param_defs(rcfg, lcfg),
                  torch.Generator().manual_seed(0))
    x = torch.randn(4, 1, 64).to(torch.bfloat16)
    log, _ = logged(lambda: rf.routed_ffn(x, p, rcfg, lcfg,
                                          impl="grouped")[0], p=p, x=x)
    assert rules(oa.dispatch_buffer_violations(log, 4, 8, "t")) \
        == ["ops.dispatch-buffer"]


def test_cache_repeat_rule_fires_on_gqa_expansion():
    q, k = torch.randn(2, 8, 1, 16), torch.randn(2, 2, 64, 16)

    def bad():
        kx = k.repeat_interleave(4, dim=1)    # (B, Hk, S, d) -> (B, Hq, ..)
        return q @ kx.transpose(-1, -2)
    log, _ = logged(bad, q=q, k=k)
    assert rules(oa.cache_repeat_violations(log, 8, 2, 64, "t")) \
        == ["ops.cache-repeat"]
    assert oa.cache_repeat_violations(log, 8, 8, 64, "t") == []


def test_paged_gather_rule_fires_on_a_gathered_view():
    from repro_torch.serving import kv_pages as kvp
    pool = torch.randn(16, 2, 8, 4)
    pt = torch.tensor([[0, 3, -1, -1], [5, 6, 7, -1]], dtype=torch.int32)
    log, _ = logged(lambda: kvp.gather_pages(pool, pt), pool=pool, pt=pt)
    assert rules(oa.paged_gather_violations(log, 2, 2, 32, 8, 4, "t")) \
        == ["ops.paged-gather"]
    log2, _ = logged(lambda: kvp.occupancy(pt, 8), pt=pt)
    assert oa.paged_gather_violations(log2, 2, 2, 32, 8, 4, "t") == []


def test_intermediate_budget_rule_fires_on_big_broadcast():
    x = torch.randn(4, 8)
    log, _ = logged(lambda: x[:, None, :] * torch.ones(4, 256, 8), x=x)
    budget = oa.auto_budget(x)
    assert budget == int(4 * 8 * 4 * 1.5)
    assert rules(oa.big_intermediate_violations(log, budget, "t")) \
        == ["ops.intermediate-budget"]
    assert oa.big_intermediate_violations(log, 10 ** 9, "t") == []


def test_host_sync_rule_fires_on_reads_outside_the_window():
    x = torch.arange(6.0)

    def loop():
        s = 0.0
        for i in range(3):
            s += (x * i).sum().item()        # a read every step
        return torch.tensor(s)
    log, _ = logged(loop, x=x)
    vs = oa.host_sync_violations(log, "t")
    assert rules(vs) == ["ops.host-sync"] and len(vs) == 3
    log2 = OpLog()
    with log2:
        y = x * 2
        with log2.sync_window():
            y.cpu().numpy()                  # one transfer, declared
        y.tolist()                           # one outside it
    vs = oa.host_sync_violations(log2, "t", windows=1)
    assert len(vs) == 1 and "tolist" in vs[0].detail
    assert rules(oa.host_sync_violations(log2, "t", windows=2)) \
        == ["ops.host-sync"]


def test_kernel_count_rules():
    from repro_torch.kernels.routed_ffn import ops
    x, w = torch.randn(2, 8), torch.randn(2, 8, 8)
    choice = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    log, _ = logged(lambda: ops.decode_ffn(x, choice, torch.ones(2, 2), w,
                                           w.transpose(1, 2).contiguous()),
                    x=x, w=w)
    assert log.kernel_calls() == {"decode_ffn": 1}
    assert oa.kernel_count_violations(log, "t", "some") == []
    assert rules(oa.kernel_count_violations(log, "t", "none")) \
        == ["ops.kernel-present"]
    assert oa.kernel_count_violations(log, "t", "exact",
                                      ("decode_ffn",)) == []
    assert rules(oa.kernel_count_violations(
        log, "t", "exact", ("decode_ffn", "grouped_ffn"))) \
        == ["ops.kernel-missing"]
    empty, _ = logged(lambda: x + 1, x=x)
    assert rules(oa.kernel_count_violations(empty, "t", "some")) \
        == ["ops.kernel-missing"]


def test_telemetry_cost_rule_fires_on_an_off_path_that_costs():
    run = oa.run_entry("engine.decode_chunk_telemetry", "cpu")
    ops = dict(run.info["ops"])
    assert ops["off"] == ops["default"] < ops["counters"]
    bad = dataclasses.replace(run, info={**run.info, "ops": {
        "default": ops["default"], "off": ops["default"] + 3,
        "counters": ops["default"] + 3}})
    assert rules(oa._telemetry_rules(bad)) == ["ops.telemetry-cost"]


# -------------------------------------------------------- kernel rules
PTXAS = """\
ptxas info    : Compiling entry function '_Z4kernPf' for 'sm_90a'
ptxas info    : Function properties for _Z4kernPf
    24 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 128 registers, 16 bytes smem, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5smallv' for 'sm_90a'
ptxas info    : Function properties for _Z5smallv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 372 bytes cmem[0]
"""


def test_parse_ptxas_reads_registers_smem_and_spills():
    rows = ka.parse_ptxas(PTXAS, "foo")
    assert [(r.function, r.registers, r.static_smem, r.spill)
            for r in rows] == [("_Z4kernPf", 128, 16, 20),
                               ("_Z5smallv", 32, 0, 0)]


def test_resource_rules_fire_on_synthetic_usage():
    row = ka.KernelUsage("foo", "kern<float>", 255, 200000, 700)
    threads = {"foo": {"kern": 512}}
    vs = ka.resource_violations([row], [], threads, budget={})
    assert rules(vs) == ["kernel.registers", "kernel.spill"]
    # kernel 4's bf16 body at dh 256, M 32 asks 193,536 B dynamic: with
    # 50,000 B static it no longer fits a block; the (64, 4) instance is
    # not what that shape runs, so it takes none of it
    dyn = [ka.Launch("sparse_attention", (2, 256, 32), "t")]
    big = ka.KernelUsage("foo", "sparse_attention_bf16_kernel<(int)256, "
                         "(int)8>", 200, 50000, 0)
    small = dataclasses.replace(big, function="sparse_attention_bf16_"
                                "kernel<(int)64, (int)4>")
    t = {"foo": {"sparse_attention_bf16_kernel": 128}}
    assert rules(ka.resource_violations([big], dyn, t, budget={})) \
        == ["kernel.smem"]
    assert ka.dynamic_of(small, dyn) == 0
    assert ka.resource_violations([small], dyn, t, budget={}) == []
    assert ka.resource_violations(
        [dataclasses.replace(row, static_smem=0, registers=64, spill=700)],
        [], threads, budget={("foo", "kern<float>"): 700}) == []
    assert rules(ka.resource_violations([], [], {})) == ["kernel.no-kernel"]


def test_launch_bounds_and_spill_budgets_cover_the_sources():
    threads = {s: ka.launch_threads(s) for s in (
        "decode_ffn", "grouped_ffn", "pq_assign", "sparse_attention",
        "topl_thresholds", "sparse_decode")}
    assert threads["decode_ffn"] == {"decode_ffn_hidden": 256,
                                     "decode_ffn_out_part": 256,
                                     "decode_ffn_out": 128}
    assert threads["sparse_attention"]["sparse_attention_bf16_kernel"] == 128
    assert threads["sparse_decode"]["attend_kernel"] == 128
    # the R = 16 decode attention instances' recorded spills
    r16 = [v for (src, fn), v in ka.SPILL_BUDGET.items()
           if fn.startswith("attend_kernel") and fn.endswith("(int)16>")
           and "(int)2" not in fn]
    assert min(r16) == 356 and max(r16) == 644


def test_dynamic_smem_restatements():
    from repro_torch.kernels.routed_ffn import ops as rffn_ops
    # kernel 10: the Python width limit and the launcher's hidden pass
    # agree: the widest d fits a block, eight more does not
    for elem in (2, 4):
        d = rffn_ops.decode_ffn_max_d(8 * 4, elem)
        assert ka.decode_ffn_smem(elem, 8, d, 4, 1024, 16)[0] \
            <= ka.SMEM_BLOCK
        assert ka.decode_ffn_smem(elem, 8, d + 8, 4, 1024, 16)[0] \
            > ka.SMEM_BLOCK
    # kernel 9: resident up to qwen3's widths, else the 132,352 B wide form
    assert ka.grouped_ffn_smem(2, 1024, 384, 16) < ka.SMEM_BLOCK
    assert ka.grouped_ffn_smem(2, 6144, 16384, 16) == 132352
    # the f32 body fits at qwen3's widths; at the MoE widths its launcher
    # refuses (no registry config runs them in f32)
    assert ka.grouped_ffn_smem(4, 1024, 384, 16) <= ka.SMEM_BLOCK
    assert ka.grouped_ffn_smem(4, 6144, 16384, 16) > ka.SMEM_BLOCK
    assert ka.sparse_attention_smem(4, 128, 16) == 0
    assert 0 < ka.sparse_attention_smem(2, 256, 32) <= ka.SMEM_BLOCK
    assert ka.pq_assign_smem(2, 16, 16, 8) == ka.pq_assign_smem(2, 32, 16, 8)
    assert ka.pq_assign_smem(4, 16, 64, 8) == 0          # general body


def test_accum_dtype_rule():
    bad = {"x.cu": 'asm("wgmma.mma_async.sync.aligned.m64n64k16.bf16.bf16'
                   '.bf16 ");\n',
           "y.cu": 'asm("mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16'
                   ' ");\n'}
    vs = ka.accum_dtype_violations(sources=bad)
    assert rules(vs) == ["kernel.accum-dtype"] and len(vs) == 2
    assert rules(ka.accum_dtype_violations(sources={"z.cu": "// none\n"})) \
        == ["kernel.no-kernel"]
    # HEAD: the two wgmma shapes of kernel 9 and kernel 4's mma, all f32
    srcs = {p.name: p.read_text() for p in ka.kernels.CSRC.glob("*.cu")}
    hits = sum(len(ka._MMA.findall(t)) for t in srcs.values())
    assert hits == 3 and ka.accum_dtype_violations() == []


def test_contract_rule_fires_on_a_refused_shape():
    # 32 query heads on one kv group: past the decode kernels' R <= 16
    cfg = dataclasses.replace(configs.get_smoke("qwen3-0.6b"), num_heads=32,
                              num_kv_heads=1)
    launches, vs = ka.config_launches("r32", cfg)
    assert rules(vs) == ["kernel.contract"]
    assert sorted(v.entry for v in vs) == ["r32 decode", "r32 decode two-pass"]
    launches, vs = ka.config_launches("qwen3-smoke",
                                      configs.get_smoke("qwen3-0.6b"))
    assert vs == [] and {ln.kernel for ln in launches} == {
        "pq_assign", "topl_thresholds", "sparse_attention", "grouped_ffn",
        "decode_ffn"}


# ---------------------------------------------------------- trace guard
def _tiny_engine(**spt):
    from repro_torch.serving.engine import Engine
    cfg = oa.tiny_cfg(**spt)
    return Engine(cfg, oa.tiny_model(cfg, "cpu"), max_len=32, num_slots=2,
                  decode_chunk=4, device="cpu")


def test_trace_guard_flags_a_read_inside_the_chunk():
    eng = _tiny_engine()
    orig = eng._chunk

    def chunk(*a, **kw):
        out = orig(*a, **kw)
        out[0][0][0].item()               # a host read inside the chunk
        return out
    eng._chunk = chunk
    with tg.guard_engine(eng, raise_on_violation=False) as guard:
        tg.serve_workload(eng, 256)
    vs = guard.violations()
    assert rules(vs) == ["trace.host-sync"]
    assert "item" in vs[0].detail
    with pytest.raises(RuntimeError, match="trace.host-sync"):
        with tg.guard_engine(eng):
            tg.serve_workload(eng, 256, seed=1)


def test_trace_guard_flags_a_module_built_per_iteration():
    eng = _tiny_engine()
    orig = eng._decode_once

    def decode_once():
        torch.nn.Identity()               # a module rebuilt per chunk
        return orig()
    eng._decode_once = decode_once
    with tg.guard_engine(eng, raise_on_violation=False) as guard:
        tg.serve_workload(eng, 256)
    assert rules(guard.violations()) == ["trace.rebuild"]
    assert guard.iterations and all(it.syncs <= it.chunks + it.groups
                                    for it in guard.iterations)


# ------------------------------------------------------------- liveness
def test_pinned_vs_inplace():
    """Counterpart of JAX's pinned-vs-donated: an argument updated in
    place adds nothing to the live set and reports its bytes as updated
    in place; the same update into a copy holds a second cache."""
    cache = torch.zeros(64, 16)
    row = torch.ones(16)

    def inplace():
        cache[3] = row
        return cache

    def copied():
        out = cache.clone()
        out[3] = row
        return out
    a, _ = logged(inplace, cache=cache, row=row)
    b, _ = logged(copied, cache=cache, row=row)
    assert a.inplace_bytes == cache.numel() * 4 and a.peak == 0
    assert b.inplace_bytes == 0 and b.peak >= cache.numel() * 4
    assert b.peak_live_bytes > a.peak_live_bytes


def test_inplace_cache_write_counts_once():
    """Counterpart of JAX's dynamic_update_slice aliasing: the engine's
    masked put writes the cache in its own storage; the bytes count once
    (as the argument) however many steps write it."""
    from repro_torch.serving import kv_pages as kvp
    cache = torch.zeros(4, 2, 32, 16)
    st = cache.untyped_storage()
    vals = torch.ones(4, 2, 16)
    keep = torch.tensor([True, True, False, True])

    def steps():
        for pos in range(5):
            kvp.put_masked(cache, (torch.arange(4), slice(None),
                                   torch.full((4,), pos)), vals, keep)
        return cache
    log, out = logged(steps, cache=cache, vals=vals, keep=keep)
    assert out.untyped_storage() is st
    assert log.inplace_bytes == cache.numel() * 4
    assert log.peak < cache.numel() * 4 // 4


def test_kernel_scratch_counts_exactly():
    """On the CPU the wrapper's plain version runs uncounted: its live
    bytes are its output and its scratch as kernels/cost.py states it."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.routed_ffn import ops
    x, w = torch.randn(4, 64), torch.randn(8, 64, 32)
    wo = torch.randn(8, 32, 64)
    choice = torch.tensor([[0, 1], [2, 3], [4, 5], [6, 7]],
                          dtype=torch.int32)
    gate = torch.ones(4, 2)
    log, y = logged(lambda: ops.decode_ffn(x, choice, gate, w, wo),
                    x=x, w=w, wo=wo, choice=choice, gate=gate)
    c = cost.decode_ffn(x, choice, gate, w, wo)
    assert c.scratch > 0
    assert log.peak == y.numel() * 4 + c.scratch
    assert any(ct.label.startswith("decode_ffn scratch")
               for ct in log.peak_top)


def test_liveness_rules(monkeypatch):
    def boom(name, device=None):
        raise RuntimeError("no run")
    monkeypatch.setattr(liveness, "memory_report", boom)
    assert rules(liveness.entry_violations("engine.decode_chunk")) \
        == ["liveness.trace-failure"]
    empty = liveness.MemoryReport("e", liveness.MemorySignature(0, 0, 0, 0),
                                  (), "", ())
    monkeypatch.setattr(liveness, "memory_report",
                        lambda name, device=None: empty)
    assert rules(liveness.entry_violations("engine.decode_chunk")) \
        == ["liveness.empty", "liveness.inplace-unused"]
    assert rules(liveness.entry_violations("ops.routed_ffn_decode")) \
        == ["liveness.empty"]


def test_memory_report_shows_waterfall_and_contributors():
    text = liveness.format_report(liveness.memory_report(
        "ops.routed_ffn_decode", "cpu"))
    assert "peak" in text and "decode_ffn scratch" in text
    assert liveness.waterfall([("a", 1), ("b", 4), ("c", 2)], 3) == "▂█▄"


# ------------------------------------------------------------ in place
def test_copied_rule_fires_on_a_rebuilt_or_copied_cache():
    run = oa.run_entry("engine.decode_chunk", "cpu")
    key = next(iter(run.before))
    moved = dataclasses.replace(run, after={**run.after, key: (0, 0)})
    assert rules(donation.copied_violations(moved, chunk=False)) \
        == ["donation.copied"]
    k = run.info["caches"]["units"]["b0_attn"]["k"]
    log, _ = logged(lambda: k[0].clone(), k=k)       # a layer's copy
    copy = dataclasses.replace(run, log=log)
    assert rules(donation.copied_violations(copy, chunk=True)) \
        == ["donation.copied"]


def test_grown_rule_fires_past_the_declared_temporaries():
    run = oa.run_entry("engine.decode_chunk", "cpu")
    assert donation.grown_violations(run, run.log.peak, "t") == []
    assert rules(donation.grown_violations(run, run.log.peak - 1, "t")) \
        == ["donation.grown"]


# ------------------------------------------------------------ baselines
def _sig(peak=100, inplace=10, ops=50, calls=1):
    return {"peak_live_bytes": peak, "inplace_bytes": inplace, "ops": ops,
            "kernel_calls": calls}


def test_memory_ratchet_fails_on_injected_regression():
    vs = baselines.diff_signatures({"e": _sig(peak=101, inplace=9)},
                                   {"e": _sig()})
    assert rules(vs) == ["memory.regression"] and len(vs) == 2


def test_memory_ratchet_flags_unrecorded_improvements():
    vs = baselines.diff_signatures({"e": _sig(peak=99, inplace=11)},
                                   {"e": _sig()})
    assert rules(vs) == ["memory.stale-baseline"] and len(vs) == 2


def test_memory_ratchet_flags_shape_drift_and_missing_entries():
    assert baselines.diff_signatures({"e": _sig(ops=54)},
                                     {"e": _sig()}) == []
    assert rules(baselines.diff_signatures(
        {"e": _sig(ops=56, calls=2)}, {"e": _sig()})) \
        == ["memory.signature-drift"]
    assert rules(baselines.diff_signatures({"a": _sig()}, {"b": _sig()})) \
        == ["memory.baseline-missing"]


def test_committed_baselines_parse_and_cover_registry():
    entries = baselines.load_baselines()
    assert set(entries) == set(liveness.MEMORY_ENTRYPOINTS)
    for sig in entries.values():
        assert set(sig) == set(baselines.FIELDS)


# ------------------------------------- counterparts of the JAX tests
@pytest.mark.parametrize("entry", ["ops.routed_ffn_decode",
                                   "models.moe_decode"])
def test_decode_path_builds_no_dispatch_buffer(entry):
    run = oa.run_entry(entry, "cpu")
    assert oa.dispatch_buffer_violations(
        run.log, run.info["batch"], run.info["groups"], entry) == []
    assert run.log.kernel_calls() == {"decode_ffn": 1}


def test_decode_ffn_impl_plain_overrides_the_kernel():
    """decode_ffn_impl="jnp" keeps decode on the grouped path while
    ffn_impl="pallas" keeps the train/prefill kernel on."""
    from repro_torch.core import dispatch
    from repro_torch.core.params import init_tree
    from repro_torch.models import ffn
    cfg = dataclasses.replace(oa.tiny_cfg(ffn_impl="pallas",
                                          decode_ffn_impl="jnp"),
                              num_layers=1)
    assert not dispatch.use_decode_ffn_kernel(cfg)
    assert dispatch.use_routed_ffn_kernel(cfg)
    p = init_tree(ffn.ffn_defs(cfg), torch.Generator().manual_seed(6))
    x = torch.randn(2, 1, 64, generator=torch.Generator().manual_seed(7))
    log, (y, _) = logged(lambda: ffn.ffn_apply(p, x, cfg, mode="decode"),
                         p=p, x=x)
    assert oa.kernel_count_violations(log, "t", "none") == []
    yg, _ = ffn.ffn_apply(p, x, cfg.with_spt(ffn_impl="grouped"),
                          mode="decode")
    torch.testing.assert_close(y, yg, rtol=0, atol=0)


def test_kill_switch_reaches_no_kernel():
    from repro_torch.core.params import init_tree
    from repro_torch.models import moe
    cfg = configs.get_smoke("grok-1-314b").with_spt(ffn_impl="pallas")
    p = init_tree(moe.moe_defs(cfg), torch.Generator().manual_seed(0))
    x = torch.randn(4, 1, cfg.d_model).to(cfg.dtype)
    with oa.kill_switch():
        log, _ = logged(lambda: moe.moe_apply(p, x, cfg, mode="decode")[0],
                        p=p, x=x)
    assert log.kernel_calls() == {}
    assert oa.entry_violations("engine.decode_chunk_kernels_off",
                               "cpu") == []
    assert oa.run_entry("engine.decode_chunk_kernels_off",
                        "cpu").log.kernel_calls() == {}


def test_memory_audits_clean_at_head():
    assert registry.run_audits(["liveness", "donation", "memory"]) == []
    for name in liveness.EXPECT_INPLACE:
        assert liveness.memory_report(name, "cpu").signature.inplace_bytes \
            > 0


def test_full_registry_clean_at_head():
    assert registry.run_audits() == []


# ---------------------------------------------------- held against JAX
JAX_BASELINES = json.loads(
    (ROOT / "scripts" / "analysis_baselines.json").read_text())["entries"]
HELD = ["engine.decode_chunk", "engine.decode_chunk_kernels_off",
        "engine.decode_chunk_paged", "engine.prefill_ragged",
        "ops.routed_ffn_decode", "ops.sparse_mha_decode",
        "models.moe_decode"]


@pytest.mark.parametrize("entry", HELD)
def test_distinct_kernels_equal_jax_pallas_calls(entry):
    want = JAX_BASELINES[entry]["pallas_calls"]
    got = oa.run_entry(entry, "cpu").log.kernel_set()
    assert len(got) == want, (entry, sorted(got))


def _rule_ids(files, prefixes):
    pat = re.compile(r"^(%s)\.[a-z][a-z-]*$" % "|".join(prefixes))
    ids = set()
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and pat.match(node.value)):
                ids.add(node.value)
    return ids


def test_every_jax_rule_maps_to_a_port_rule():
    jax_ids = _rule_ids(sorted((ROOT / "src" / "repro" / "analysis")
                               .glob("*.py")),
                        ("jaxpr", "pallas", "trace", "lint", "liveness",
                         "donation", "memory"))
    assert len(jax_ids) >= 25 and jax_ids == set(JAX_RULES)
    port_ids = _rule_ids(sorted(f for f in (ROOT / "src" / "repro_torch" /
                                            "analysis").glob("*.py")
                                if f.name != "__init__.py"),
                         ("ops", "kernel", "trace", "lint", "liveness",
                          "donation", "memory"))
    for jax_id, port in JAX_RULES.items():
        if port.startswith("JAX only:"):
            assert len(port) > 40, jax_id           # a stated reason
        else:
            assert port in port_ids, (jax_id, port)
