#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --only kernels   # phases 1-3 (build + kernels)

Phases (each raises on failure; nothing is caught):
  1. environment: torch/CUDA versions, card name and power limit;
  2. build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc);
  3. every kernel against its plain torch version at the serving path's
     full-width shapes (8 slots, S=4096 decode; a (8, 1024) prefill
     bucket): f32 to atol 1e-4, bf16 compared in f32 to atol=rtol 2e-2,
     the decode kernel's [t, need] thresholds exactly equal; times by CUDA
     events (L2 flushed between launches) beside the least time the card
     could take (bytes over 3.35 TB/s or operations over the peak rate);
  4. full-width qwen3-0.6b served in bf16 through Engine.run (16 requests,
     prompts of 128-2048 tokens, 64 new tokens, 8 slots, max_len 4096)
     with the launch counters zeroed just before and read just after;
  5. the same model cut to 4 layers, in f32: greedy streams with kernels
     on equal those of REPRO_DISABLE_KERNELS=1 up to logit near-ties
     (<= 1e-3, replayed through the port's ragged prefill);
  6. one JSON line of the kernels, then the result line.
Imports nothing of JAX or of the JAX package.
"""
import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, tensor / CUDA cores
BF16_TOL = 2e-2
F32_TOL = 1e-4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def time_ms(fn, reps: int) -> float:
    """Median device time of fn over reps launches, L2 flushed before
    each (the serving path finds its weights and caches cold).  The card
    spins ~0.5 ms before the start event, so the host has enqueued fn's
    few launches by the time the event fires and the interval holds
    device time only, not the host's issue time."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def close(got, want, tol):
    import torch
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if not torch.allclose(g, w, atol=tol, rtol=tol if tol > F32_TOL else 0):
        raise AssertionError(f"max abs err {err:.3e} beyond {tol}")
    return err


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(nbytes_moved: float, flops: float, dtype) -> tuple:
    name = str(dtype).split(".")[-1]
    t_bytes = nbytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 3
def check_decode_attention(torch, gen):
    """Kernel 6 at 8 slots x 8 kv heads x S=4096 (R=2, dh=128, M=16)."""
    from repro_torch.kernels.sparse_attention import ops, ref
    b, hk, r, dh, m, e = 8, 8, 2, 128, 16, 16
    rows = []
    cases = [("bfloat16", "qhead", 4096, False), ("float32", "qhead", 4096, False),
             ("bfloat16", "kvgroup", 4096, False),
             ("float32", "qhead", 4000, True), ("float32", "kvgroup", 4000, True)]
    for dtn, gran, s, dead_row in cases:
        dt = getattr(torch, dtn)
        g = b * hk
        q = torch.randn(g, r, dh, device="cuda", generator=gen).to(dt)
        k = torch.randn(g, s, dh, device="cuda", generator=gen).to(dt)
        v = torch.randn(g, s, dh, device="cuda", generator=gen).to(dt)
        cq = torch.randint(0, e, (g, r, m), device="cuda", generator=gen,
                           dtype=torch.int32)
        ck = torch.randint(0, e, (g, s, m), device="cuda", generator=gen,
                           dtype=torch.int8)
        lens = torch.randint(128, s + 1, (b,), device="cuda", generator=gen)
        valid = torch.arange(s, device="cuda")[None, :] < lens[:, None]
        if dead_row:
            valid[3] = False
        sum_rows = gran == "kvgroup"
        kw = dict(scale=dh ** -0.5, l=max(16, round(s * 0.125)),
                  max_score=m * (r if sum_rows else 1), sum_rows=sum_rows,
                  heads_per_batch=hk)
        out, thr = ops.fused_sparse_decode_attention(
            q, k, v, cq, ck, valid, return_thresholds=True, **kw)
        torch.cuda.synchronize()
        want, thr_ref = ref.fused_decode_ref(q, k, v, cq, ck, valid, **kw)
        if not torch.equal(thr, thr_ref):
            raise AssertionError(f"decode thresholds differ ({dtn}, {gran}, S={s})")
        err = close(out, want, BF16_TOL if dt == torch.bfloat16 else F32_TOL)
        print(f"  fused_sparse_decode_attention {dtn} {gran} S={s}"
              f"{' +dead row' if dead_row else ''}: max_abs_err {err:.3e}, "
              "[t, need] exact", flush=True)
        rows.append((dtn, gran, s, err))
        if (dtn, gran, s) == ("bfloat16", "qhead", 4096):
            main = dict(q=q, k=k, v=v, cq=cq, ck=ck, valid=valid, kw=kw, err=err)
    # timing at the main-path case (bf16, qhead, S=4096)
    q, k, v, cq, ck, valid, kw = (main[x] for x in
                                  ("q", "k", "v", "cq", "ck", "valid", "kw"))
    ms = time_ms(lambda: ops.fused_sparse_decode_attention(
        q, k, v, cq, ck, valid, **kw), 30)
    plain = time_ms(lambda: ref.fused_decode_ref(q, k, v, cq, ck, valid, **kw), 5)
    elig, _ = ref.select(cq, ck, valid, l=kw["l"], max_score=kw["max_score"],
                         sum_rows=False, heads_per_batch=hk)
    rows_read = int(elig.any(1).sum())          # K/V rows any head selected
    sel_pairs = int(elig.sum())
    moved = (nbytes(q, cq, ck, valid) + q.numel() * q.element_size()
             + 2 * rows_read * dh * k.element_size())
    flops = 4 * dh * sel_pairs                  # q.k and p.v per pair
    bms, by = bound(moved, flops, q.dtype)
    return {"name": "fused_sparse_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sparse_decode.cu",
            "replaces": "src/repro/kernels/sparse_attention/sparse_attention.py:400",
            "max_abs_err": main["err"], "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": "G=64 (8 slots x 8 kv heads), R=2, S=4096, dh=128, M=16, bf16"}


def _ffn_weights(torch, gen, g, d, f, r, dt):
    def w(*shape, fan):
        return (torch.randn(*shape, device="cuda", generator=gen) / fan ** 0.5).to(dt)

    def lo(*shape):
        return torch.randn(*shape, device="cuda", generator=gen) * 0.05
    weights = dict(w_inner=w(g, d, f, fan=d), w_gate=w(g, d, f, fan=d),
                   w_outer=w(g, f, d, fan=f))
    lora = {"lora_inner": {"b": lo(d, r), "c": lo(g, r, f)},
            "lora_gate": {"b": lo(d, r), "c": lo(g, r, f)},
            "lora_outer": {"b": lo(g, f, r), "c": lo(r, d)}}
    return weights, lora


def check_grouped_ffn(torch, gen):
    """Kernel 9 at a (8, 1024) prefill bucket of qwen3-0.6b widths."""
    from repro_torch.core import routed_ffn as rf
    from repro_torch.kernels.routed_ffn import ops, ref
    bp, s, d, dff, g, ga, r = 8, 1024, 1024, 3072, 8, 4, 16
    rcfg = rf.RoutedFFNConfig(d_model=d, d_ff=dff, num_groups=g,
                              active_groups=ga, capacity_factor=1.25,
                              activation="silu", gated=True)
    f = rcfg.group_dim
    out = None
    for dtn in ("bfloat16", "float32"):
        dt = getattr(torch, dtn)
        wts, lora = _ffn_weights(torch, gen, g, d, f, r, dt)
        x = torch.randn(bp, s, d, device="cuda", generator=gen).to(dt)
        router = torch.randn(d, g, device="cuda", generator=gen) / d ** 0.5
        lens = torch.randint(128, s + 1, (bp,), device="cuda", generator=gen)
        choice, gate, _ = rf.route(x, router, rcfg, need_aux=False)
        plan = rf.plan_for(x, choice, gate, rcfg, lens)
        args = (x, plan.index, wts["w_inner"], wts["w_outer"], wts["w_gate"],
                lora, 1.0)
        y = ops.grouped_ffn(*args, act="silu")
        torch.cuda.synchronize()
        want = ref.grouped_ffn_ref(*args, act="silu")
        ok = plan.slot_ok[..., None]            # empty slots are dropped
        err = close(torch.where(ok, y.float(), 0.0),
                    torch.where(ok, want.float(), 0.0),
                    BF16_TOL if dt == torch.bfloat16 else F32_TOL)
        print(f"  grouped_ffn {dtn} (8, 1024) bucket C={plan.index.shape[-1]}: "
              f"max_abs_err {err:.3e}", flush=True)
        if dtn == "bfloat16":
            ms = time_ms(lambda: ops.grouped_ffn(*args, act="silu"), 10)
            plain = time_ms(lambda: ref.grouped_ffn_ref(*args, act="silu"), 3)
            kept = int(plan.slot_ok.sum())
            flops = kept * (2 * d * f * 3 + 2 * r * (3 * d + 2 * f + d))
            moved = (nbytes(x, plan.index, y, *wts.values())
                     + sum(nbytes(*t.values()) for t in lora.values()))
            bms, by = bound(moved, flops, dt)
            out = {"name": "grouped_ffn", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/grouped_ffn.cu",
                   "replaces": "src/repro/kernels/routed_ffn/routed_ffn.py:187",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "bound_ms": bms, "bound_by": by, "library_ms": None,
                   "shape": f"x (8, 1024, 1024), index (8, 8, {plan.index.shape[-1]}), "
                            "F=384, SwiGLU, LoRA r=16, bf16"}
    return out


def check_decode_ffn(torch, gen):
    """Kernel 10 at 8 decode slots of qwen3-0.6b widths."""
    from repro_torch.core import routed_ffn as rf
    from repro_torch.kernels.routed_ffn import ops, ref
    b, d, dff, g, ga, r = 8, 1024, 3072, 8, 4, 16
    f = dff // g
    out = None
    for dtn, gated_out in (("bfloat16", False), ("float32", False),
                           ("float32", True)):
        dt = getattr(torch, dtn)
        rcfg = rf.RoutedFFNConfig(d_model=d, d_ff=dff, num_groups=g,
                                  active_groups=ga, activation="silu",
                                  gated=True, gate_outputs=gated_out)
        wts, lora = _ffn_weights(torch, gen, g, d, f, r, dt)
        x = torch.randn(b, d, device="cuda", generator=gen).to(dt)
        router = torch.randn(d, g, device="cuda", generator=gen) / d ** 0.5
        choice, gate, _ = rf.route(x[:, None], router, rcfg, need_aux=False)
        choice, gate = choice[:, 0].contiguous(), gate[:, 0].contiguous()
        args = (x, choice, gate, wts["w_inner"], wts["w_outer"],
                wts["w_gate"], lora, 1.0)
        y = ops.decode_ffn(*args, act="silu")
        torch.cuda.synchronize()
        want = ref.decode_ffn_ref(*args, act="silu")
        err = close(y, want, BF16_TOL if dt == torch.bfloat16 else F32_TOL)
        print(f"  decode_ffn {dtn}{' gated outputs' if gated_out else ''}: "
              f"max_abs_err {err:.3e}", flush=True)
        if dtn == "bfloat16":
            ms = time_ms(lambda: ops.decode_ffn(*args, act="silu"), 30)
            plain = time_ms(lambda: ref.decode_ffn_ref(*args, act="silu"), 5)
            blocks = int(torch.unique(choice).numel())   # touched groups
            per_block = 3 * d * f * x.element_size()
            lora_bytes = sum(nbytes(*t.values()) for t in lora.values())
            moved = (blocks * per_block + lora_bytes
                     + nbytes(x, choice, gate) + b * d * x.element_size())
            flops = b * ga * 2 * d * f * 3
            bms, by = bound(moved, flops, dt)
            out = {"name": "decode_ffn", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/decode_ffn.cu",
                   "replaces": "src/repro/kernels/routed_ffn/routed_ffn.py:344",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "bound_ms": bms, "bound_by": by, "library_ms": None,
                   "shape": f"x (8, 1024), G'=4 of G=8 ({blocks} blocks touched), "
                            "F=384, SwiGLU, LoRA r=16, bf16"}
    return out


# ------------------------------------------------------------ phases 4-5
def _perturbed_model(torch, cfg, seed):
    """Random full-width weights from a seed; LoRA c leaves (zero at
    init) get small values so the LoRA halves of the kernels do work."""
    from repro_torch.models import transformer
    model = transformer.LM.init(cfg, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".c"):
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * 0.01)
    return model


def _requests(n, lo, hi, gen_tokens, vocab, seed):
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(0, vocab, size=int(
        rng.integers(lo, hi + 1))).tolist(), max_new_tokens=gen_tokens)
        for i in range(n)]


def serve_full_width(torch):
    from repro_torch import configs, kernels
    from repro_torch.core.params import count_params
    from repro_torch.models.transformer import lm_defs
    from repro_torch.serving.engine import Engine
    cfg = configs.get_config("qwen3-0.6b").with_spt(attn_impl="pallas",
                                                    ffn_impl="pallas")
    model = _perturbed_model(torch, cfg, seed=0)
    eng = Engine(cfg, model, max_len=4096, num_slots=8, decode_chunk=16)
    eng.run(_requests(2, 16, 32, 4, cfg.vocab_size, seed=1))     # warm-up
    reqs = _requests(16, 128, 2048, 64, cfg.vocab_size, seed=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = kernels.wrappers()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    st = eng.last_stats
    for c in outs:
        if len(c.tokens) != 64 or not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"request {c.uid}: {len(c.tokens)} tokens "
                                 f"({c.finish_reason})")
    layers = cfg.num_layers
    want = {"fused_sparse_decode_attention": layers * st.decode_steps,
            "decode_ffn": layers * st.decode_steps,
            "grouped_ffn": layers * st.prefill_batches}
    if launches != want:
        raise AssertionError(f"launches {launches} != expected {want}")
    stats = {"params": count_params(lm_defs(cfg)),
             "requests": len(reqs), "wall_s": wall,
             "prefill_tok_s": st.prefill_tok_s, "decode_tok_s": st.decode_tok_s,
             "ttft_avg_s": st.ttft_avg_s, "ttft_max_s": st.ttft_s_max,
             "prefill_tokens": st.prefill_tokens, "decode_tokens": st.decode_tokens,
             "decode_steps": st.decode_steps, "prefill_batches": st.prefill_batches,
             "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print("  serve " + json.dumps(stats), flush=True)
    print("  launches " + json.dumps(launches), flush=True)
    decode_step_split(torch, eng.model, cfg)
    return launches


def decode_step_split(torch, model, cfg):
    """Device vs wall time of one full-width decode step (8 slots, 2048 of
    4096 cache slots live): how far the host holds the card back.  Device
    time is the profiler's sum of kernel times (CUDA events cannot hide
    the host here: a step issues more launches than the launch queue
    holds)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer
    caches = transformer.init_caches(cfg, 8, 4096, "cuda")
    tok = torch.zeros(8, dtype=torch.long, device="cuda")
    pos = torch.full((8,), 2047, device="cuda")
    valid = torch.arange(4096, device="cuda")[None, :] <= pos[:, None]

    def step():
        transformer.lm_decode_step(model, cfg, caches, tok, pos,
                                   kv_valid=valid)
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total", 0) / 3e3, e.count / 3,
             e.key) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    device = sum(r[0] for r in rows)
    if not rows:
        print(f"  decode step (8 slots, S=4096): wall {wall:.2f} ms; device "
              "time not measured (the profiler saw no device activity)",
              flush=True)
        return
    print(f"  decode step (8 slots, S=4096): device {device:.2f} ms in "
          f"{sum(r[1] for r in rows):.0f} kernels, wall {wall:.2f} ms, "
          f"device busy {device / wall:.0%}", flush=True)
    for ms, n, name in rows[:8]:
        print(f"    {ms:8.3f} ms  x{n:5.0f}  {name[:90]}", flush=True)


def agree_f32(torch):
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine
    cfg = dataclasses.replace(configs.get_config("qwen3-0.6b"), num_layers=4,
                              dtype=torch.float32).with_spt(
                                  attn_impl="pallas", ffn_impl="pallas")
    model = _perturbed_model(torch, cfg, seed=3)
    model.to(torch.float32)
    reqs = _requests(8, 64, 512, 16, cfg.vocab_size, seed=4)
    streams = {}
    for mode in ("kernels", "oracle"):
        if mode == "oracle":
            os.environ["REPRO_DISABLE_KERNELS"] = "1"
        eng = Engine(cfg, model, max_len=1024, num_slots=4, decode_chunk=8)
        streams[mode] = [c.tokens for c in eng.run(reqs)]
    flips = 0
    for req, got_k, got_o in zip(reqs, streams["kernels"], streams["oracle"]):
        if got_k == got_o:
            continue
        t = next(i for i, (a, b) in enumerate(zip(got_k, got_o)) if a != b)
        ctx = list(req.tokens) + got_o[:t]
        with torch.no_grad():
            _, logits = transformer.lm_prefill_ragged(
                model, cfg, {"tokens": torch.tensor([ctx], device="cuda")},
                torch.tensor([len(ctx)], device="cuda"), 1024)
        lg = logits[0, -1].float().cpu().numpy()
        gap = float(lg.max()) - min(float(lg[got_k[t]]), float(lg[got_o[t]]))
        if gap > 1e-3:
            raise AssertionError(f"request {req.uid} diverged at step {t} "
                                 f"with a logit gap {gap:.3e}")
        flips += 1
    del os.environ["REPRO_DISABLE_KERNELS"]
    print(f"  4-layer f32 greedy streams: kernels == REPRO_DISABLE_KERNELS=1 "
          f"for {len(reqs) - flips}/{len(reqs)} requests, {flips} replayed "
          "near-tie flips (<= 1e-3)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels",), default=None,
                    help="stop after the kernel checks (phases 1-3)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels

    # 1. environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; {card}",
          flush=True)
    # 2. build
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.library()
    print(f"[2] built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_decode_attention(torch, gen), check_grouped_ffn(torch, gen),
            check_decode_ffn(torch, gen)]
    for row in rows:
        print(f"[3] {row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) at "
              f"{row['shape']}; no single PyTorch call computes it, so "
              "library_ms is n/a", flush=True)
    launches = {r["name"]: 0 for r in rows}
    if args.only != "kernels":
        # 4. full-width serve
        t0 = time.perf_counter()
        print("[4] full-width qwen3-0.6b bf16 serve", flush=True)
        launches = serve_full_width(torch)
        # 5. card-side agreement
        t1 = time.perf_counter()
        print(f"[5] 4-layer f32 agreement (phase 4 took {t1 - t0:.1f} s)",
              flush=True)
        agree_f32(torch)
        print(f"[5] took {time.perf_counter() - t1:.1f} s", flush=True)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
