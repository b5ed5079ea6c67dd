#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --only kernels   # phases 1-3 (build + kernels)
    python3 chip_smoke.py --only train     # phases 1-3, 6-7

Phases (each raises on failure; nothing is caught):
  1. environment: torch/CUDA versions, card name and power limit;
  2. build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc);
  3. every kernel against its plain torch version at its path's
     full-width shapes — the training step's (batch 4 x 1024, 16/8 heads
     of 128, M = 16) for PQ assignment, top-L thresholds and sparse
     attention (plus small windowed / offset / non-causal cases), the
     serving path's (8 slots, S=4096 decode; a (8, 1024) prefill bucket)
     for the rest: f32 to atol 1e-4, bf16 compared in f32 to atol=rtol
     2e-2, thresholds exactly equal, PQ codes equal up to the margin rule;
     times by CUDA events (L2 flushed between launches) beside the least
     time the card could take (bytes over 3.35 TB/s or operations over
     the peak rate);
  4. full-width qwen3-0.6b served in bf16 through Engine.run (16 requests,
     prompts of 128-2048 tokens, 64 new tokens, 8 slots, max_len 4096)
     with the launch counters zeroed just before and read just after;
  5. the same model cut to 4 layers, in f32: greedy streams with kernels
     on equal those of REPRO_DISABLE_KERNELS=1 up to logit near-ties
     (<= 1e-3, replayed through the port's ragged prefill);
  6. full-width qwen3-0.6b fine-tuned in bf16 by Trainer.run: 3 steps of
     batch 4 x 1024 (seeded random tokens), counters zeroed just before
     and read just after, then one profiled step;
  7. the same model cut to 4 layers, in f32: each block's output and
     gradients from the same inputs, and the loss and gradients of one
     train step, with kernels on equal those of REPRO_DISABLE_KERNELS=1;
  8. one JSON line of the kernels (launches per path), then the result
     line.
Imports nothing of JAX or of the JAX package.
"""
import argparse
import dataclasses
import json
import math
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


# qwen3-0.6b's training step: batch 4 x 1024 tokens, 16 query / 8 kv
# heads of 128, M = 16 PQ books of d' = 8 over E = 16 codewords, L = 128
TB, TS, HQ, HK, DH, M_BOOKS, E_WORDS = 4, 1024, 16, 8, 128, 16, 16


def _codebooks(torch, gen):
    return torch.randn(M_BOOKS, E_WORDS, DH // M_BOOKS, device="cuda",
                       generator=gen)


def _distances(torch, x, cb):
    """(..., M, E) f32 distances of the plain PQ assignment."""
    xs = x.float().reshape(*x.shape[:-1], M_BOOKS, -1)
    c2 = (cb * cb).sum(-1)
    return c2 - 2.0 * torch.einsum("...md,med->...me", xs, cb)


def check_pq_assign(torch, gen):
    """Kernel 1 at the training step's q shape (G = 4 x 16, n = 1024,
    d = 128) and k shape (G = 4 x 8): codes equal up to the margin rule (a
    code may differ only where the plain version's two nearest distances
    lie within 1e-4 x the largest |distance| of that row)."""
    from repro_torch.kernels.pq_quantize import ops, ref
    out = None
    for dtn, heads in (("bfloat16", HQ), ("float32", HQ), ("bfloat16", HK)):
        dt = getattr(torch, dtn)
        x = torch.randn(TB * heads, TS, DH, device="cuda", generator=gen).to(dt)
        cb = _codebooks(torch, gen)
        got = ops.pq_assign(x, cb)
        torch.cuda.synchronize()
        want = ref.pq_assign_ref(x, cb)
        diff = got != want
        flips = int(diff.sum())
        if flips:
            dist = _distances(torch, x, cb)
            top2 = dist.topk(2, dim=-1, largest=False).values
            margin = top2[..., 1] - top2[..., 0]
            scale = dist.abs().amax(-1)
            if bool((margin[diff] > 1e-4 * scale[diff]).any()):
                raise AssertionError(f"pq_assign {dtn}: {flips} codes differ "
                                     "beyond the margin rule")
        print(f"  pq_assign {dtn} G={TB * heads}: {flips} of {want.numel()} "
              "codes differ (margin rule)", flush=True)
        if out is None:
            ms = time_ms(lambda: ops.pq_assign(x, cb), 30)
            plain = time_ms(lambda: ref.pq_assign_ref(x, cb), 5)
            m, e, dp = cb.shape
            moved = nbytes(x, cb, got)
            flops = x.numel() // DH * m * e * (2 * dp + 2)
            bms, by = bound(moved, flops, dt)
            out = {"name": "pq_assign", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/pq_assign.cu",
                   "replaces": "src/repro/kernels/pq_quantize/pq_quantize.py:38",
                   "max_abs_err": float(flips), "ms": ms, "plain_ms": plain,
                   "bound_ms": bms, "bound_by": by, "library_ms": None,
                   "shape": f"x ({TB * HQ}, {TS}, {DH}) bf16, codebooks "
                            f"({M_BOOKS}, {E_WORDS}, {DH // M_BOOKS}); "
                            "max_abs_err counts differing codes"}
    return out


def _train_codes(torch, gen, nq, nk, gq=TB * HQ, gk=TB * HK):
    cq = torch.randint(0, E_WORDS, (gq, nq, M_BOOKS), device="cuda",
                       generator=gen, dtype=torch.int32)
    ck = torch.randint(0, E_WORDS, (gk, nk, M_BOOKS), device="cuda",
                       generator=gen, dtype=torch.int32)
    return cq, ck


def _topl_cases():
    """(name, nq, nk, causal, window, q_offset): the training shape, then
    small windowed, ragged-offset and non-causal cases."""
    return [("train", TS, TS, True, None, 0),
            ("window", 256, 256, True, 64, 0),
            ("q_offset", 72, 200, True, None, 128),
            ("q_offset+window", 72, 200, True, 40, 128),
            ("non-causal", 64, 100, False, None, 0)]


def _top_l(n, window=None):
    horizon = n if window is None else min(n, window)
    return min(max(16, round(horizon * 0.125)), horizon)


def check_topl_thresholds(torch, gen):
    """Kernel 2: [t, need] exactly equal to the plain version."""
    from repro_torch.kernels.topl_select import ops, ref
    out = None
    for name, nq, nk, causal, window, q_off in _topl_cases():
        cq, ck = _train_codes(torch, gen, nq, nk)
        kw = dict(l=_top_l(nk, window), max_score=M_BOOKS, causal=causal,
                  window=window, q_offset=q_off, heads_per_batch=HQ,
                  rep=HQ // HK)
        thr = ops.topl_thresholds(cq, ck, **kw)
        torch.cuda.synchronize()
        if not torch.equal(thr, ref.thresholds_ref(cq, ck, **kw)):
            raise AssertionError(f"topl_thresholds {name}: [t, need] differ")
        print(f"  topl_thresholds {name} (nq={nq}, nk={nk}): [t, need] exact",
              flush=True)
        if out is None:
            ms = time_ms(lambda: ops.topl_thresholds(cq, ck, **kw), 30)
            plain = time_ms(lambda: ref.thresholds_ref(cq, ck, **kw), 3)
            pairs = cq.shape[0] * nq * (nq + 1) // 2        # causal, nq = nk
            bms, by = bound(nbytes(cq, ck, thr), pairs * M_BOOKS,
                            torch.float32)
            out = {"name": "topl_thresholds", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/topl_thresholds.cu",
                   "replaces": "src/repro/kernels/topl_select/topl_select.py:69",
                   "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
                   "bound_ms": bms, "bound_by": by, "library_ms": None,
                   "shape": f"codes_q ({TB * HQ}, {TS}, {M_BOOKS}), codes_k "
                            f"({TB * HK}, {TS}, {M_BOOKS}), causal, L=128; "
                            "bound: M int compares per admitted pair at the "
                            "f32 CUDA-core rate"}
    return out


def check_sparse_attention(torch, gen):
    """Kernel 4 against its plain version at the training shape (bf16 and
    f32) and the small windowed / offset / non-causal cases (f32)."""
    from repro_torch.kernels.sparse_attention import ops, ref
    from repro_torch.kernels.topl_select.ref import masked_scores, thresholds_ref
    out = None
    cases = [(n, "bfloat16") for n in _topl_cases()[:1]] + \
        [(n, "float32") for n in _topl_cases()]
    for (name, nq, nk, causal, window, q_off), dtn in cases:
        dt = getattr(torch, dtn)
        cq, ck = _train_codes(torch, gen, nq, nk)
        q = torch.randn(TB * HQ, nq, DH, device="cuda", generator=gen).to(dt)
        k = torch.randn(TB * HK, nk, DH, device="cuda", generator=gen).to(dt)
        v = torch.randn(TB * HK, nk, DH, device="cuda", generator=gen).to(dt)
        sel = dict(causal=causal, window=window, q_offset=q_off,
                   heads_per_batch=HQ, rep=HQ // HK)
        thr = thresholds_ref(cq, ck, l=_top_l(nk, window), max_score=M_BOOKS,
                             **sel)
        kw = dict(scale=DH ** -0.5, **sel)
        got = ops.sparse_attention(q, k, v, cq, ck, thr, **kw)
        torch.cuda.synchronize()
        want = ref.sparse_attention_ref(q, k, v, cq, ck, thr, **kw)
        err = close(got, want, BF16_TOL if dt == torch.bfloat16 else F32_TOL)
        print(f"  sparse_attention {dtn} {name} (nq={nq}, nk={nk}): "
              f"max_abs_err {err:.3e}", flush=True)
        if out is None:
            ms = time_ms(lambda: ops.sparse_attention(q, k, v, cq, ck, thr,
                                                      **kw), 20)
            plain = time_ms(lambda: ref.sparse_attention_ref(
                q, k, v, cq, ck, thr, **kw), 3)
            sm = masked_scores(cq, ck, **sel)
            kept = ref.newest_ties(sm, thr)                  # (G, nq, nk)
            rows = kept.reshape(TB * HK, HQ // HK * nq, nk).any(1)
            moved = (nbytes(q, cq, ck, thr) + q.numel() * q.element_size()
                     + 2 * int(rows.sum()) * DH * k.element_size())
            pairs = int(kept.sum())
            flops = 4 * DH * pairs
            bms, by = bound(moved, flops, dt)
            # yardstick only (the port never calls it): SDPA over the same
            # selection given as a precomputed boolean mask
            kv = torch.arange(TB * HQ, device="cuda") // (HQ // HK)
            mask = kept.reshape(TB, HQ, nq, nk)
            q4, k4, v4 = (t.reshape(TB, HQ, nq, DH) for t in
                          (q, k[kv], v[kv]))
            sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=DH ** -0.5), 20)
            out = {"name": "sparse_attention", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/sparse_attention.cu",
                   "replaces": "src/repro/kernels/sparse_attention/sparse_attention.py:115",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "bound_ms": bms, "bound_by": by, "library_ms": None,
                   "masked_sdpa_ms": sdpa, "kept_pairs": pairs,
                   "shape": f"q ({TB * HQ}, {nq}, {DH}), k/v ({TB * HK}, {nk}, "
                            f"{DH}) bf16, GQA 2, causal, L=128"}
    return out


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
        if len(c.tokens) != 64 or not all(0 <= t < cfg.padded_vocab for t in c.tokens):
            raise AssertionError(f"request {c.uid}: {len(c.tokens)} tokens "
                                 f"({c.finish_reason})")
    layers = cfg.num_layers
    # the ragged prefill takes the oracle attention (as in JAX), so the
    # train-path attention kernels stay idle here
    want = {"pq_assign": 0, "topl_thresholds": 0, "sparse_attention": 0,
            "fused_sparse_decode_attention": layers * st.decode_steps,
            "grouped_ffn": layers * st.prefill_batches,
            "decode_ffn": layers * st.decode_steps}
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


# ------------------------------------------------------------ phases 6-7
def _train_cfg(torch, **kw):
    from repro_torch import configs
    cfg = configs.get_config("qwen3-0.6b")
    if kw:
        cfg = dataclasses.replace(cfg, **kw)
    return cfg.with_spt(attn_impl="pallas", ffn_impl="pallas")


def _batches(cfg, batch, seq, steps, seed):
    from repro_torch.data.pipeline import DataConfig, pack_batches, random_stream
    return pack_batches(random_stream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        kind="random", seed=seed), steps))


def _c_leaves(state):
    from repro_torch.core.params import leaves
    return [(".".join(p), v) for p, v in leaves(state["train"]) if p[-1] == "c"]


def train_full_width(torch):
    """Three steps of Trainer.run on full-width qwen3-0.6b in bf16, batch
    4 x 1024 from the seeded random stream, with the launch counters zeroed
    just before and read just after; then one more step under the
    profiler for the device-busy share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    steps = 3
    cfg = _train_cfg(torch)
    trainer = Trainer(cfg, OptimizerConfig(lr=1e-3, total_steps=steps),
                      TrainerConfig(total_steps=steps, log_interval=1),
                      seed=0, device="cuda")
    if any(bool(v.any()) for _, v in _c_leaves(trainer.state)):
        raise AssertionError("LoRA c leaves are not zero at init")
    rows = []
    clock = [0.0]

    def hook(step, m):                 # metrics are host floats: synced
        now = time.perf_counter()
        rows.append({"step": step, "wall_s": now - clock[0],
                     "tok_s": TB * TS / (now - clock[0]), "loss": m["loss"],
                     "lm_loss": m["lm_loss"], "grad_norm": m["grad_norm"],
                     "lr": m["lr"], "lb_loss": m["lb_loss"],
                     "dropped": m["dropped"]})
        print("  step " + json.dumps(rows[-1]), flush=True)
        clock[0] = time.perf_counter()
        if step == 1:
            for name, v in _c_leaves(trainer.state):
                per_unit = v.reshape(v.shape[0], -1).abs().amax(1)
                if not bool((per_unit > 0).all()):
                    raise AssertionError(f"{name} still zero after step 1")

    wrappers = kernels.wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    clock[0] = time.perf_counter()
    trainer.run(_batches(cfg, TB, TS, steps, seed=0), step_hook=hook)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in rows:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["grad_norm"] > 0):
            raise AssertionError(f"step {r['step']}: loss {r['loss']}, "
                                 f"grad_norm {r['grad_norm']}")
    per_step = cfg.num_layers * steps
    want = {"pq_assign": 4 * per_step, "topl_thresholds": 2 * per_step,
            "sparse_attention": 2 * per_step, "grouped_ffn": 2 * per_step,
            "fused_sparse_decode_attention": 0, "decode_ffn": 0}
    if launches != want:
        raise AssertionError(f"train launches {launches} != expected {want}")
    print(f"  train peak memory {peak:.2f} GiB; launches "
          + json.dumps(launches), flush=True)

    batch = next(_batches(cfg, TB, TS, 1, seed=1))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.state, _ = trainer._step(trainer.state, batch)
        torch.cuda.synchronize()
    wall_prof = (time.perf_counter() - t0) * 1e3
    top = [(getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
           for e in prof.key_averages()]
    top = sorted((r for r in top if r[0] > 0), reverse=True)
    device = sum(r[0] for r in top)
    wall = rows[-1]["wall_s"] * 1e3
    print(f"  train step (4 x 1024, bf16): device {device:.1f} ms in "
          f"{sum(r[1] for r in top)} kernels; wall {wall:.1f} ms (step 3), "
          f"{wall_prof:.1f} ms (profiled step); device busy "
          f"{device / wall:.0%} of step 3", flush=True)
    for ms, n, name in top[:10]:
        print(f"    {ms:9.3f} ms  x{n:6d}  {name[:90]}", flush=True)
    for kern in ("pq_assign_kernel", "topl_thresholds_kernel",
                 "sparse_attention_kernel", "grouped_ffn_kernel"):
        hit = [(ms, n) for ms, n, name in top if kern in name]
        ms, n = sum(h[0] for h in hit), sum(h[1] for h in hit)
        print(f"    {kern}: {ms:.1f} ms in {n} launches "
              f"({ms / max(n, 1):.4f} ms each, profiler)", flush=True)
    return launches


def _grad_check(what, got, want, tol):
    """max |got - want| <= tol * max |want|; returns that ratio."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if scale == 0.0 or err > tol * scale:
        raise AssertionError(f"{what}: max abs diff {err:.3e} vs max "
                             f"{scale:.3e} (tolerance {tol} x max)")
    return err / scale


def _both_modes(fn):
    """fn() with kernels on, then under REPRO_DISABLE_KERNELS=1; checks that
    the first run launched kernels and the second none."""
    import torch
    from repro_torch import kernels
    out = []
    for off in (False, True):
        if off:
            os.environ["REPRO_DISABLE_KERNELS"] = "1"
        before = [w.launches for w in kernels.wrappers()]
        try:
            out.append(fn())
            torch.cuda.synchronize()
        finally:
            os.environ.pop("REPRO_DISABLE_KERNELS", None)
        ran = any(w.launches != b for w, b in zip(kernels.wrappers(), before))
        if ran == off:
            raise AssertionError("kernel launches do not follow the switch")
    return out


def train_agree_f32(torch):
    """Four full-width layers in f32, batch 2 x 512, kernels on against
    REPRO_DISABLE_KERNELS=1.  (a) Each block from the same input and
    output cotangent: its output to max-abs <= 1e-5 x max |out|, the
    gradient of its input and of every trainable leaf to <= 1e-4 x max
    |g|.  (b) The whole train step: loss to rel 1e-4 and the cosine of
    the two whole gradients (every leaf, flattened) >= 0.99.  Across
    layers a float-level difference can flip a discrete decision at a
    near-tie (a PQ code, a top-L member, a routed token), as greedy
    streams flip at logit near-ties; the gradient of random weights is a
    sum of many cancelling per-token terms, so a few flipped terms move
    it by per cents.  (b) prints the oracle's own move under 1e-6 noise
    on the embedding beside the kernels' move; (a) is the tight per-leaf
    check.  LoRA c leaves get small values first so that every LoRA
    gradient is non-zero."""
    from repro_torch.core.params import combine, leaves, unflatten
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import layers, transformer
    from repro_torch.train.state import init_state
    cfg = _train_cfg(torch, num_layers=4, dtype=torch.float32)
    state = init_state(cfg, seed=5, device="cuda")
    state["frozen"] = _map_tree(lambda t: t.float(), state["frozen"])
    gen = torch.Generator(device="cuda").manual_seed(6)
    for _, v in _c_leaves(state):
        v.copy_(torch.randn(v.shape, device="cuda", generator=gen) * 0.01)
    batch = next(_batches(cfg, 2, 512, 1, seed=7))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}

    # (a) block by block, teacher-forced by the oracle's hidden states
    paths, vals = zip(*leaves(state["train"]))
    train_vals = [v.detach().requires_grad_(True) for v in vals]
    params = combine(unflatten(paths, train_vals), state["frozen"])
    units = transformer._unit_trees(params, cfg)
    os.environ["REPRO_DISABLE_KERNELS"] = "1"
    with torch.no_grad():
        h = [layers.embed_lookup(params["embed"], batch["tokens"],
                                 cfg.scale_embed, cfg.d_model)]
        for unit in units[:-1]:
            h.append(transformer.block_apply(unit["b0_attn"], h[-1], cfg,
                                             mode="train")[0])
    del os.environ["REPRO_DISABLE_KERNELS"]
    worst = [0.0, 0.0]
    for u, unit in enumerate(units):
        cot = torch.randn(h[u].shape, device="cuda", generator=gen)

        def block():
            x = h[u].clone().requires_grad_(True)
            with torch.enable_grad():
                y, _, aux = transformer.block_apply(unit["b0_attn"], x, cfg,
                                                    mode="train")
                obj = (y * cot).sum() + aux["lb_loss"]
                g = torch.autograd.grad(obj, [x, *train_vals],
                                        allow_unused=True)
            return y.detach(), g
        (yk, gk), (yo, go) = _both_modes(block)
        worst[0] = max(worst[0], _grad_check(f"block {u} output", yk, yo,
                                             1e-5))
        for path, a, b in zip([("input",)] + list(paths), gk, go):
            if b is None or not b.abs().max() > 0:   # other units' leaves
                if a is not None and a.abs().max() > 0:
                    raise AssertionError(f"block {u} {path}: kernels give a "
                                         "gradient the oracle does not")
                continue
            worst[1] = max(worst[1], _grad_check(
                f"block {u} grad {'.'.join(path)}", a, b, 1e-4))
    print(f"  4 f32 blocks, same inputs: outputs within {worst[0]:.2e} x "
          f"max, gradients within {worst[1]:.2e} x max |g|", flush=True)

    # (b) the whole train step, beside the oracle's own sensitivity: the
    # oracle again with the embedding perturbed by 1e-6 (relative)
    (lk, _, gk), (lo, _, go) = _both_modes(
        lambda: loss_and_grads(state, cfg, batch))
    rel = abs(float(lk) - float(lo)) / abs(float(lo))
    if rel > 1e-4:
        raise AssertionError(f"loss {float(lk)} vs {float(lo)} (rel {rel:.2e})")
    emb = state["frozen"]["embed"]["embedding"]
    noisy = dict(state, frozen=dict(state["frozen"], embed={
        "embedding": emb * (1 + 1e-6 * torch.randn(emb.shape, device="cuda",
                                                   generator=gen))}))
    os.environ["REPRO_DISABLE_KERNELS"] = "1"
    _, _, gn = loss_and_grads(noisy, cfg, batch)
    del os.environ["REPRO_DISABLE_KERNELS"]
    flat = lambda g: torch.cat([a.flatten() for _, a in leaves(g)])
    fk, fo, fn = flat(gk), flat(go), flat(gn)
    cos = float(torch.dot(fk, fo) / (fk.norm() * fo.norm()))
    if cos < 0.99:
        raise AssertionError(f"gradient cosine {cos:.6f} < 0.99")
    d_k = float((fk - fo).norm() / fo.norm())
    d_n = float((fn - fo).norm() / fo.norm())
    print(f"  4-layer f32 train step: loss {float(lk):.6f} (kernels) vs "
          f"{float(lo):.6f} (REPRO_DISABLE_KERNELS=1), rel {rel:.2e}; whole "
          f"gradient cosine {cos:.6f}, |g_k - g_o| / |g_o| = {d_k:.2e}; the "
          f"oracle with 1e-6 noise on the embedding moves it {d_n:.2e}",
          flush=True)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels", "train"), default=None,
                    help="stop after the kernel checks (phases 1-3), or "
                         "skip the serving phases (4-5)")
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
    rows = [check_pq_assign(torch, gen), check_topl_thresholds(torch, gen),
            check_sparse_attention(torch, gen),
            check_decode_attention(torch, gen), check_grouped_ffn(torch, gen),
            check_decode_ffn(torch, gen)]
    for row in rows:
        print(f"[3] {row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) at "
              f"{row['shape']}; no single PyTorch call computes it, so "
              "library_ms is n/a", flush=True)
    paths = {"serve": {r["name"]: 0 for r in rows},
             "train": {r["name"]: 0 for r in rows}}
    if args.only is None:
        # 4. full-width serve
        t0 = time.perf_counter()
        print("[4] full-width qwen3-0.6b bf16 serve", flush=True)
        paths["serve"] = serve_full_width(torch)
        # 5. card-side agreement
        t1 = time.perf_counter()
        print(f"[5] 4-layer f32 serve agreement (phase 4 took {t1 - t0:.1f} s)",
              flush=True)
        agree_f32(torch)
        print(f"[5] took {time.perf_counter() - t1:.1f} s", flush=True)
    if args.only != "kernels":
        # 6. full-width fine-tune steps
        t0 = time.perf_counter()
        print("[6] full-width qwen3-0.6b bf16 train, 3 steps of 4 x 1024",
              flush=True)
        paths["train"] = train_full_width(torch)
        # 7. card-side agreement of the train step
        t1 = time.perf_counter()
        print(f"[7] 4-layer f32 train agreement (phase 6 took {t1 - t0:.1f} s)",
              flush=True)
        train_agree_f32(torch)
        print(f"[7] took {time.perf_counter() - t1:.1f} s", flush=True)
    for row in rows:
        by_path = {p: paths[p][row["name"]] for p in paths}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
