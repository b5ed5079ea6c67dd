#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py                  # every phase; needs one CUDA card
    python3 chip_smoke.py --only kernels   # phases 1-3 (build + kernels)
    python3 chip_smoke.py --only serve     # phases 1-6
    python3 chip_smoke.py --only train     # phases 1-3, 7-8
    python3 chip_smoke.py --only paper     # phases 1-3, 9-11
    python3 chip_smoke.py --only server    # phases 1-3, 12-13
    python3 chip_smoke.py --only moe       # phases 1-3, 14-15
    python3 chip_smoke.py --only hybrid    # phases 1-3, 16-18
    python3 chip_smoke.py --only families  # phases 1-3, 19-22
    python3 chip_smoke.py --only infra     # phases 1-3, 23
    python3 chip_smoke.py --only mesh      # phases 1-3, 24
    python3 chip_smoke.py --only meshserve # phases 1-3, 25
    python3 chip_smoke.py --only dryrun    # phases 1-3, 26
    python3 chip_smoke.py --only shard     # phases 1-3, 27
    python3 chip_smoke.py --only seqsplit  # phases 1-3, 28

Phases (each raises on failure; nothing is caught):
  1. environment: torch/CUDA versions, card name and power limit;
  2. build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc, with
     -Xptxas -v: each kernel's registers, static shared memory and spills
     are printed), and count the tensor-core instructions (HGMMA, HMMA) in
     the SASS of the routed-FFN and sparse-attention kernels (cuobjdump;
     kernel 9's and kernel 4's bf16 bodies must have them);
  3. every kernel against its plain torch version at its path's
     full-width shapes — the training step's (batch 4 x 1024, 16/8 heads
     of 128, M = 16) for PQ assignment, top-L thresholds and sparse
     attention (plus small windowed / offset / non-causal cases, and for
     sparse attention key counts below one tile, at dh 128, 80 and 64;
     PQ assignment also at d_head 64 and 80, E = 64, f32 and 1000 rows;
     top-L thresholds also at M = 8 and 10, codes in [128, 256) and
     beyond, nq = 100, rep 1 and 4; each launched twice
     bit-identically), the
     serving path's (8 slots x 8 kv heads, R = 2, S = 4096 decode; the
     paged view 32 pages of 128 over a shuffled 320-page pool, 2048 live
     slots; a (8, 1024) prefill bucket) for the rest, the routed-FFN
     kernels also at the train shape, at 1 slot and on small edge cases,
     the decode attention kernels (3, 5-8) also on edge cases (1 slot,
     R = 1 and 8, dh = 64 and 256, l >= live, rows with no valid slot),
     each launched twice with bit-identical outputs, and kernel 3 again
     after kernel 6 and 100 times back to back; the paper's shapes
     (kernels 1, 2, 4 at the OPT-2.7B and LLaMA-2.7B training steps,
     kernel 9 at the five blocks' widths, kernels 6 and 10 at OPT-2.7B's
     decode, and dh 80 / R = 1 decode edges of kernels 3, 5-8, timed at
     OPT-2.7B's serving width); kernels 9 and 10 at the MoE widths (d
     6144, F 16,384 SwiGLU and 32,768 GeGLU, 8 experts top 2: 8 decode
     slots and the 4 x 1024 training rows), kernel 10 in f32 at F 16,384
     and its f32 refusal at d 6144: f32 to atol 1e-4,
     bf16 compared in f32 to atol=rtol 2e-2, thresholds exactly equal, PQ
     codes equal up to the margin rule; the paged kernel bit-identical to
     the contiguous one over gathered views and the two-pass pair to the
     fused kernel; the decode kernels (3, 5-8) also at R = 16 query heads
     on one kv head of 256, M = 32, over a full 2,048-slot ring, under
     "qhead" and "kvgroup" (the 16-row instances), and at R = 12, timed
     at recurrentgemma-9b's serving width; kernels 1, 2 and 4 at its
     training step (M = 32, max_score 32, rep 16, kernel 4 in bf16 at dh
     256 with window 2048, and where the window binds in bf16 and f32),
     kernels 9 and 10 at its FFN widths (d 4096, F 1,536 GeGLU); kernels
     1, 2 and 4 non-causal at whisper-base's encoder (4 x 8 heads, 1500 x
     1500, dh 64, M 8) and cross-attention (448 x 1500), kernel 4 in bf16
     and f32, and at phi-3-vision's training step (4 x 1024, 32 heads of
     96, M 12); the decode kernels (3, 5-8) at dh 96 / M 12 / R = 1, timed
     at phi-3-vision's serving width (8 slots x 32 kv heads), and at
     whisper-base's decoder (dh 64, 68 live slots); kernels 9 and 10 at
     phi-3-vision's FFN (d 3072, F 1,024 SwiGLU) and whisper-base's (d
     512, F 256 GELU ungated); times by
     CUDA events (L2 flushed between launches)
     beside the least time the card could take (bytes over 3.35 TB/s or
     operations over the peak rate), and for kernels 9 and 10 a torch
     yardstick of the same function in bf16, for kernel 1 one in f32
     (baddbmm + argmin), at the qwen3 and at the paper's shapes;
  4. full-width qwen3-0.6b served in bf16 through Engine.run (16 requests,
     prompts of 128-2048 tokens, 64 new tokens, 8 slots, max_len 4096)
     with the launch counters zeroed just before and read just after;
  5. the same serve, depth cut to 4 layers, on the paged KV layout
     (pages of 128, a pool of 64 pages: a quarter of the contiguous
     footprint): sparse MHA through
     the page table (kernel 7), the two-pass tier over gathered views
     (kernels 3 and 5) and sparse MHA off (kernel 8, the dense
     baseline), counters zeroed just before each and read just after;
     and one paged decode step's device and wall time;
  6. the model cut to 4 layers, in f32: greedy streams of every decode
     tier — contiguous fused and two-pass, paged kernel-native and paged
     gathered two-pass (and paged dense) — equal those of
     REPRO_DISABLE_KERNELS=1 up to logit near-ties (<= 1e-3, replayed
     through the port's ragged prefill);
  7. full-width qwen3-0.6b fine-tuned in bf16 by Trainer.run: 3 steps of
     batch 4 x 1024 (seeded random tokens), counters zeroed just before
     and read just after, then one profiled step;
  8. the same model cut to 4 layers, in f32: each block's output and
     gradients from the same inputs, and the loss and gradients of one
     train step, with kernels on equal those of REPRO_DISABLE_KERNELS=1;
  9. the paper's five Table-2 blocks (opt-1024/2048/2560, llama-2560/
     4096) at full width, one layer, bf16: 3 steps of Trainer.run at 4 x
     1024 under apply_variant "spt" (kernels 1, 2, 4 and 9 exactly 4, 2,
     2 and 2 times per layer per step), then "lora" (no kernel);
  10. opt-2.7b and llama-2.7b (full width, 4 of 32 layers, bf16): 2
     steps of Trainer.run
     at 4 x 1024 and a profiled step each; opt-2.7b's lm_prefill at 4 x
     1024 (kernels 1, 2, 4, 9) and a serve of 8 requests (prompts
     128-1024, 32 new tokens, 8 slots, max_len 2048; kernels 6, 9, 10);
     counters zeroed just before each and read just after;
  11. an OPT-2560-width model cut to 2 layers, in f32, kernels on against
     REPRO_DISABLE_KERNELS=1: greedy streams (kernels 6 and 7),
     lm_prefill's logits and caches, one train step;
  12. full-width qwen3-0.6b (4 of 28 layers) in bf16 through the
     long-lived server,
     Engine.serve with telemetry "trace": 32 requests (prompts 128-2048,
     64 new tokens) arriving as a seeded Poisson process at 2 requests/s
     on the wall clock, half sampled (temperature 0.8 with top_k 50 or
     top_p 0.9), priorities 0-2, a quarter with a 6 s TTFT deadline, a
     seeded ChaosMonkey (cancels, forced preemptions, rejected
     submissions) and a Watchdog raising on any invariant failure; 8
     slots, max_len 4096, chunks of 16; contiguous (kernels 6, 9, 10),
     the same schedule with telemetry "off" and "counters" (decode tok/s
     of the three), then paged kernel-native on the 64-page pool (kernel
     7); counters zeroed just before each and read just after, launch
     counts exact (resume re-prefills counted), every request terminal,
     the Chrome trace valid with a lane for every uid;
  13. the model cut to 4 layers, in f32, under a ManualClock: one
     schedule with priorities, deadlines, a queued and a mid-stream
     cancel, a forced preemption and seeded sampling — kernels on equal
     REPRO_DISABLE_KERNELS=1 (finish reasons, preemptions, stats; tokens
     up to near-ties of the perturbed logits, or past a request's first
     PQ code or routed-group choice that differs, when that choice is a
     near-tie, <= 1e-4, on the kernel run's inputs), kernels 6, 9, 10
     held to their plain versions on every call's inputs, the same seed
     twice identical, the same with every key selected (top fraction 1),
     and each preempted request's stream equal to its unpreempted one;
  14. mixtral-8x22b (4 of 56 layers) and grok-1-314b (2 of 64) at full
     width in bf16, random weights from a seed: a burst Engine.run of 8
     requests (prompts 128-2048, mixtral's last one 4608 tokens so that
     its 4096 window wraps; 32 new tokens, 8 slots, max_len 8192, chunks
     of 16; kernels 6, 9, 10), grok also paged on a 96-page pool (kernel
     7), a decode step's split; Trainer.run at 4 x 1024 under "spt"
     (kernels 1, 2, 4, 9), 2 steps and, for mixtral, a profiled step;
     counters zeroed just before each and read just after, launch counts
     exact;
  15. both MoE configs at d 1024, F 2048, 2 layers (mixtral's window
     64), in f32, kernels on against REPRO_DISABLE_KERNELS=1: greedy
     streams up to near-ties, one train step's loss and gradient cosine;
  16. gemma-7b, h2o-danube-1.8b and h2o-danube-3-4b at full width, depth
     cut to 2 layers, bf16: a burst Engine.run of 8 requests (32 new
     tokens; the danube configs' last prompt 4,608 tokens, past their
     4,096 window; kernels 6, 9, 10) and one "spt" train step at 2 x
     1024 (kernels 1, 2, 4, 9), launch counts exact;
  17. recurrentgemma-9b at full width and depth (38 layers), bf16:
     Engine.serve of a burst of 8 requests (prompts 128-2048, the last
     3,072, 32 new tokens, max_len 4096; kernel 6 once per attention
     layer — 12 of 38 — per decode step, kernels 9 and 10 once per layer),
     a decode step's split, 2 "spt" train steps at 4 x 1024 (the 36 unit
     layers' kernels twice a step, the 2 tail layers' once) and a
     profiled step, then 2 "lora" steps (no kernel);
  18. recurrentgemma-9b cut to 5 layers (one unit and the tail) at d
     1024, 16 query heads of 256 on 1 kv head kept (R = 16), window 64,
     in f32, kernels on against REPRO_DISABLE_KERNELS=1: greedy streams
     up to near-ties, one train step's loss and gradient cosine;
  19. phi-3-vision-4.2b at full width, 4 of 32 layers, bf16: a
     burst Engine.run of 8 requests, each 576 frontend rows before a
     prompt of 128-1024 tokens, 32 new tokens, max_len 2048 (kernels 6,
     9, 10), a decode step's split, the same on the paged layout with a
     pool of 80 pages (kernel 7); 2 "spt" train steps at 4 x (576 + 448)
     positions (kernels 1, 2, 4, 9) and a profiled step, 2 "lora" steps
     (no kernel);
  20. mamba2-780m at full width and depth (48 layers), bf16: a burst
     Engine.run of 8 requests (prompts 128-2048, 32 new tokens, exact-
     length prefill groups), a decode step's split, 2 "spt" and 2 "lora"
     train steps at 4 x 1024: no SPT kernel launches on any of them;
  21. whisper-base (6 + 6 layers), bf16: Engine.generate of 8 rows of 1500
     frames, 4-token prompts, 64 new tokens on the per-token path
     (kernels 1, 2, 4, 9 in the prefill, 6 and 10 per decode call), the
     prefill's wall time and a decode step's split, the launcher's
     legacy-audio blob, 2 "spt" train steps at 4 x 448 decoder tokens
     over 1500 frames and a profiled step;
  22. f32 agreement, kernels on against REPRO_DISABLE_KERNELS=1:
     phi-3-vision at 4 layers (d 1536, dh 96, M 12, 576 frontend rows),
     mamba2-780m at 4 layers, whisper-base at 2 + 2 layers: greedy
     streams up to near-ties (phi-3: of the logits or of a choice, as
     in 13, and again with every key selected; whisper: of the logits,
     and again with every key selected; mamba2: identical, no launch),
     kernels 6, 9, 10 held to their plain versions, one train
     step's loss (rel 1e-4) and gradient cosine (>= 0.999);
  23. checkpoint/restart of full-width qwen3-0.6b (4 of 28 layers;
     bf16, spt, 4 x 1024):
     run A trains 6 steps uninterrupted (checkpoints every 2); run B, a
     child process of this script, the same run, sends itself SIGTERM
     after step 3 and must report interrupted with its step-3
     checkpoint (sha256 verified); run C, a fresh Trainer here, resumes
     from it: the restored state equals B's final state bit for bit,
     start_step is 3, C's launches of kernels 1, 2, 4 and 9 are exact for
     its 3 steps, the monitor counts them, and B's and C's losses agree
     with A's within 2e-2, under torch's deterministic algorithms
     (checkpoint bytes, save and restore times and step times before and
     after resume printed);
  24. multi-GPU fine-tuning on one card: kernels 1, 2 and 4 at
     qwen3-0.6b's local heads for model 2 and 4 (8/4 and 4/2 heads of
     128, 4 x 1024) and kernel 9 at each group's 192 and 96 columns,
     against their plain versions, timed beside bound and yardstick; an
     NCCL world of one (the launchers' init_distributed), mesh (1, 1),
     full-width qwen3-0.6b (14 of 28 layers) bf16 spt, 3
     steps of 4 x 1024
     under deterministic algorithms without the mesh, through the mesh
     path (losses equal bit for bit) and with grouped_shmap (within
     1e-3), launch counts exact; the process group destroyed at the end;
  25. serving under a mesh on one card: the decode kernels 3, 5, 6, 7 and
     8 at the shard shapes of model 2 and 4 (qwen3-0.6b's 8/4 and 4/2
     heads of 128, recurrentgemma-9b's 8/1 and 4/1 heads of 256 over its
     2,048-slot ring), bf16 and f32, and kernel 10 at each group's F / n
     columns (qwen3's 192 and 96, recurrentgemma's 768 and 384), each
     launched twice bit-identically, against its plain version, timed
     beside its bound; an NCCL world of one, mesh (1, 1): qwen3-0.6b at
     full width (4 of 28 layers, contiguous and paged on the 64-page
     pool) and recurrentgemma-9b (8 of 38 layers: two units and the
     tail) served through Engine.run (8 requests, prompts 128-1024, 32
     new tokens, 8 slots) without the mesh and through it — the
     streams, the launch counts and ServeStats' counters equal bit for
     bit, launch counts exact; then each of those models split over
     model 2 and 4 (paged: 2), every rank of the (1, n) mesh a thread on
     the card taking turns at the model-axis collectives, which sum the
     ranks' partial outputs: each rank's local head, kv head, column
     and channel counts; 4 requests served on every rank at once (bf16:
     the ranks' streams alike, launches n times one rank's exact count,
     ServeStats' counters equal to the unsharded serve's); in f32 with
     every key selected (contiguous cases), the logits of one ragged
     prefill and 8 decode steps equal the unsharded model's to a
     relative error of 1e-3, every rank's alike, and the same run
     summing rank 0's part alone is off by over 0.1 (at the served
     top-L fraction the error is shown);
  26. the dry run against the card: full-width qwen3-0.6b (CUT_DEPTH
     layers, bf16, the kernels on) — one train step at 4 x 1024 and one
     decode step at 8 slots x 4096 — traced on the meta device
     (launch/dryrun.py, target "cuda"), then run on the card under the
     same roofline counter after a warm-up: FLOPs, HBM bytes and kernel
     calls by name equal the trace's, the calls equal the launch
     counters, and the trace's predicted peak lies within 10 % of
     max_memory_allocated (both printed); the train step's profiled
     device time beside the count's t_bound (printed); kernel 9's h
     scratch rule as kernels/cost.py restates it equal to the built
     library's at every (dtype, d, F) kernel 9 launched at in the run;
  27. sharded storage of the state (its module comment);
  28. attention placed as JAX places it where the kv heads do not divide
     the model axis: qwen3-0.6b over model 16 and recurrentgemma-9b over
     model 2 with the caches' sequence split, every rank a thread (its
     module comment: the shards' bytes against the dry run, a bf16 serve
     with launches n x exact, and in f32 every split decode's [t, need],
     selections and combined output against the whole cache's);
  counters are zeroed just before each counted run and read just after,
  launch counts exact; then one JSON line of the ten kernels (launches
  per path; each with its times at the paper's, the MoE, the hybrid and
  the three families' shapes), then the result line.
Imports nothing of JAX or of the JAX package.
"""
import argparse
import contextlib
import dataclasses
import functools
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

BF16_TOL = 2e-2
F32_TOL = 1e-4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def sass_counts(lib_path) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in the SASS of each
    routed-FFN and train-path sparse-attention kernel of the built
    library."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if any(x in fn for x in ("grouped_ffn", "decode_ffn",
                                     "sparse_attention_")):
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn in counts:
            for op in ("HGMMA", "HMMA"):
                counts[fn][op] += op in line
    return counts


def ptxas_usage() -> list:
    """(source, kernel, registers, static shared bytes, spill bytes) of
    every kernel entry, from the ptxas -v logs the verbose build keeps
    (names demangled by cu++filt where the toolkit has it)."""
    import re
    import shutil
    from repro_torch import kernels
    rows = []
    for log in sorted(kernels.BUILD_DIR.glob("*.log")):
        fn = spill = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn, spill = m.group(1), 0
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and fn:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
            if m and fn:
                rows.append([log.stem, fn, int(m.group(1)),
                             int(m.group(2) or 0), spill])
                fn = None
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if rows and os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(r[1] for r in rows),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        for r, name in zip(rows, names):
            name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::", "",
                          name)
            r[1] = name[:name.index(">(") + 1] if ">(" in name else \
                name.split("(")[0]
    return rows


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


def close_scaled(got, want, tol):
    """The bf16 rule at widths where kernel 9's documented bf16 roundings
    (h, the LoRA leaves and the LoRA products s x B and s h B_O) sum over
    F = 16,384 and 32,768: max-abs <= tol x max |want| and a relative
    Frobenius error of at most 2^-7 (one bf16 ulp), in place of the
    per-element atol = rtol = tol, which those roundings exceed where a
    large LoRA term and the base term cancel to a small output.  Returns
    (max abs err, relative Frobenius error, elements past atol = rtol =
    tol)."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err, scale = float(diff.max()), float(w.abs().max())
    rel = float((g - w).norm() / w.norm())
    past = int((diff > tol + tol * w.abs()).sum())
    if err > tol * scale or rel > 2.0 ** -7:
        raise AssertionError(f"max abs err {err:.3e} vs {tol} x max |want| "
                             f"{scale:.3e}; relative Frobenius {rel:.3e}")
    return err, rel, past


# ------------------------------------------------------------ phase 3
def check_decode_attention(torch, gen):
    """Kernel 6 at 8 slots x 8 kv heads x S=4096 (R=2, dh=128, M=16)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.sparse_attention import ops, ref
    b, hk, r, dh, m, e = 8, 8, 2, 128, 16, 16
    rows = []
    cases = [("bfloat16", "qhead", 4096, False), ("float32", "qhead", 4096, False),
             ("bfloat16", "kvgroup", 4096, False),
             ("float32", "qhead", 4000, True), ("float32", "kvgroup", 4000, True),
             ("bfloat16", "qhead", 4000, True)]
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
        out, thr = _twice(torch, lambda: ops.fused_sparse_decode_attention(
            q, k, v, cq, ck, valid, return_thresholds=True, **kw),
            "fused_sparse_decode_attention")
        if dead_row and out[3 * hk:4 * hk].any():
            raise AssertionError("fused_sparse_decode_attention: a row with no "
                                 "valid slot is not 0")
        want, thr_ref = ref.fused_decode_ref(q, k, v, cq, ck, valid, **kw)
        if not torch.equal(thr, thr_ref):
            raise AssertionError(f"decode thresholds differ ({dtn}, {gran}, S={s})")
        err = close(out, want, BF16_TOL if dt == torch.bfloat16 else F32_TOL)
        print(f"  fused_sparse_decode_attention {dtn} {gran} S={s}"
              f"{' +dead row (0)' if dead_row else ''}: max_abs_err {err:.3e}, "
              "[t, need] exact, bit-identical twice", flush=True)
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
    bms, by = cost.fused_sparse_decode_attention(
        q, k, v, cq, ck, valid, **kw, rows_read=rows_read,
        pairs=int(elig.sum())).bound_ms()
    return {"name": "fused_sparse_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sparse_decode.cu",
            "replaces": "src/repro/kernels/sparse_attention/sparse_attention.py:400",
            "max_abs_err": main["err"], "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": "G=64 (8 slots x 8 kv heads), R=2, S=4096, dh=128, M=16, bf16"}


# The serving decode shapes of the paged and two-pass kernels: 8 slots x 8
# kv heads, R = 2 query rows per kv head, dh 128, M 16 books of E 16; the
# paged view is MP 32 pages of 128 (max_len 4096) over a pool larger
# than the view, 2048 live slots per row.
SB, SHK, SR, SDH, SM, SE = 8, 8, 2, 128, 16, 16
SPS, SMP, SLIVE, SPOOL = 128, 32, 2048, 320


def _decode_kw(gran, s):
    sum_rows = gran == "kvgroup"
    return dict(l=max(16, round(s * 0.125)),
                max_score=SM * (SR if sum_rows else 1), sum_rows=sum_rows,
                heads_per_batch=SHK)


def _rows_read(ref, cq, ck, valid, kw):
    """(K/V rows any query row of a group selects, selected pairs)."""
    elig, _ = ref.select(cq, ck, valid, **kw)
    return int(elig.any(1).sum()), int(elig.sum())


def check_two_pass(torch, gen):
    """Kernels 3 and 5 at the serving decode shape (G = 64, S = 4096,
    2048 live slots): kernel 3's [t, need] equal to the plain version's
    and to kernel 6's, kernel 5's output within tolerance of its plain
    version and bit-identical to kernel 6's (bf16 and f32, "qhead" and
    "kvgroup"); kernel 3's summed histograms equal the plain version's,
    kernel 5's log-sum-exp within F32_TOL of it (the outputs a sequence
    split over ranks takes), each also timed."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.sparse_attention import ops, ref
    from repro_torch.kernels.topl_select import ops as topl_ops
    from repro_torch.kernels.topl_select import ref as topl_ref
    g, s = SB * SHK, SMP * SPS
    rows = {}
    for dtn, gran in (("bfloat16", "qhead"), ("float32", "qhead"),
                      ("float32", "kvgroup"), ("bfloat16", "kvgroup")):
        dt = getattr(torch, dtn)
        q = torch.randn(g, SR, SDH, device="cuda", generator=gen).to(dt)
        k = torch.randn(g, s, SDH, device="cuda", generator=gen).to(dt)
        v = torch.randn(g, s, SDH, device="cuda", generator=gen).to(dt)
        cq = torch.randint(0, SE, (g, SR, SM), device="cuda", generator=gen,
                           dtype=torch.int32)
        ck = torch.randint(0, SE, (g, s, SM), device="cuda", generator=gen,
                           dtype=torch.int8)
        valid = (torch.arange(s, device="cuda") < SLIVE)[None].expand(
            SB, s).contiguous()
        kw = _decode_kw(gran, s)
        sel = dict(sum_rows=kw["sum_rows"], heads_per_batch=SHK)
        thr = topl_ops.decode_topl_thresholds(cq, ck, valid, **kw)
        out = _twice(torch, lambda: ops.sparse_decode_attention(
            q, k, v, cq, ck, thr, valid, scale=SDH ** -0.5, **sel),
            "sparse_decode_attention")
        out6, thr6 = ops.fused_sparse_decode_attention(
            q, k, v, cq, ck, valid, scale=SDH ** -0.5,
            return_thresholds=True, **kw)
        torch.cuda.synchronize()
        if not torch.equal(thr, topl_ref.decode_topl_thresholds_ref(
                cq, ck, valid, **kw)):
            raise AssertionError(f"decode_topl_thresholds {gran}: [t, need] "
                                 "differ from the plain version")
        if not torch.equal(thr, thr6):
            raise AssertionError(f"decode_topl_thresholds {gran}: [t, need] "
                                 "differ from kernel 6's")
        want = ref.sparse_decode_attention_ref(q, k, v, cq, ck, thr, valid,
                                               scale=SDH ** -0.5, **sel)
        err = close(out, want, BF16_TOL if dt == torch.bfloat16 else F32_TOL)
        if not torch.equal(out, out6):
            raise AssertionError(f"sparse_decode_attention {dtn} {gran}: "
                                 "differs from kernel 6")
        # kernel 3 right after kernel 6, then 100 launches back to back:
        # no launch may leave state that the next one reads
        after6 = topl_ops.decode_topl_thresholds(cq, ck, valid, **kw)
        runs = [topl_ops.decode_topl_thresholds(cq, ck, valid, **kw)
                for _ in range(100)]
        torch.cuda.synchronize()
        bad = sum(not torch.equal(x, thr) for x in [after6] + runs)
        if bad:
            raise AssertionError(f"decode_topl_thresholds {gran}: {bad} of 101 "
                                 "repeated launches differ")
        # the outputs a sequence split over ranks takes: kernel 3's summed
        # histograms, kernel 5's log-sum-exp a row
        thr_h, hist = topl_ops.decode_topl_thresholds(cq, ck, valid,
                                                      return_hist=True, **kw)
        out_l, lse = ops.sparse_decode_attention(
            q, k, v, cq, ck, thr, valid, scale=SDH ** -0.5, return_lse=True,
            **sel)
        _, plse = ref.sparse_decode_attention_ref(
            q, k, v, cq, ck, thr, valid, scale=SDH ** -0.5, return_lse=True,
            **sel)
        torch.cuda.synchronize()
        if not (torch.equal(thr_h, thr) and torch.equal(
                hist, topl_ref.decode_score_hist(
                    cq, ck, valid, max_score=kw["max_score"], **sel))):
            raise AssertionError(f"decode_topl_thresholds {gran}: the summed "
                                 "histograms differ from the plain version's")
        if not torch.equal(out_l, out):
            raise AssertionError(f"sparse_decode_attention {dtn} {gran}: the "
                                 "output beside the log-sum-exp differs")
        lse_err = close(lse, plse, F32_TOL)
        print(f"  two-pass {dtn} {gran}: [t, need] exact (plain, kernel 6, "
              f"after kernel 6 and 100 launches back to back); kernel 5 "
              f"max_abs_err {err:.3e}, bit-identical to kernel 6 and twice; "
              f"kernel 3's summed histograms exact, kernel 5's log-sum-exp "
              f"max_abs_err {lse_err:.3e}", flush=True)
        if (dtn, gran) != ("bfloat16", "qhead"):
            continue
        t3 = time_ms(lambda: topl_ops.decode_topl_thresholds(
            cq, ck, valid, **kw), 30)
        p3 = time_ms(lambda: topl_ref.decode_topl_thresholds_ref(
            cq, ck, valid, **kw), 5)
        live = int(valid.sum()) * SHK                 # valid (group, slot)s
        bms, by = cost.decode_topl_thresholds(cq, ck, valid, **kw,
                                              live=live).bound_ms()
        rows["decode_topl_thresholds"] = {
            "name": "decode_topl_thresholds", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sparse_decode_two_pass.cu",
            "replaces": "src/repro/kernels/topl_select/topl_select.py:161",
            "max_abs_err": 0.0, "ms": t3, "plain_ms": p3, "bound_ms": bms,
            "bound_by": by, "library_ms": None,
            "ms_with_hist": time_ms(lambda: topl_ops.decode_topl_thresholds(
                cq, ck, valid, return_hist=True, **kw), 30),
            "shape": f"codes_q ({g}, {SR}, {SM}), codes_k ({g}, {s}, {SM}) "
                     f"int8, {SLIVE} live slots; max_abs_err counts differing "
                     "[t, need]; bound: the live code rows once, or M int "
                     "compares per (live slot, row) at the f32 CUDA-core "
                     "rate; ms_with_hist: the same launch writing the summed "
                     "histograms (a split sequence's)"}
        t5 = time_ms(lambda: ops.sparse_decode_attention(
            q, k, v, cq, ck, thr, valid, scale=SDH ** -0.5, **sel), 30)
        p5 = time_ms(lambda: ref.sparse_decode_attention_ref(
            q, k, v, cq, ck, thr, valid, scale=SDH ** -0.5, **sel), 5)
        read, pairs = _rows_read(ref, cq, ck, valid, kw)
        bms, by = cost.sparse_decode_attention(
            q, k, v, cq, ck, thr, valid, scale=SDH ** -0.5, **sel, live=live,
            pairs=pairs, rows_read=read).bound_ms()
        rows["sparse_decode_attention"] = {
            "name": "sparse_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sparse_decode_two_pass.cu",
            "replaces": "src/repro/kernels/sparse_attention/sparse_attention.py:254",
            "max_abs_err": err, "ms": t5, "plain_ms": p5, "bound_ms": bms,
            "bound_by": by, "library_ms": None,
            "ms_with_lse": time_ms(lambda: ops.sparse_decode_attention(
                q, k, v, cq, ck, thr, valid, scale=SDH ** -0.5,
                return_lse=True, **sel), 30),
            "lse_max_abs_err": lse_err,
            "shape": f"G={g} (8 slots x 8 kv heads), R={SR}, S={s}, "
                     f"{SLIVE} live, dh={SDH}, M={SM}, bf16; ms_with_lse: "
                     "the same launch writing each row's log-sum-exp (a "
                     "split sequence's)"}
    return [rows["decode_topl_thresholds"], rows["sparse_decode_attention"]]


def _paged_inputs(torch, gen, dt):
    """Pools of SPOOL pages, a page table of shuffled ids with the pages
    past the live rows unallocated (-1), validity = the first SLIVE view
    slots AND page occupancy."""
    from repro_torch.serving import kv_pages
    g = SB * SHK
    q = torch.randn(g, SR, SDH, device="cuda", generator=gen).to(dt)
    k_pool = torch.randn(SPOOL, SHK, SPS, SDH, device="cuda",
                         generator=gen).to(dt)
    v_pool = torch.randn(SPOOL, SHK, SPS, SDH, device="cuda",
                         generator=gen).to(dt)
    cq = torch.randint(0, SE, (g, SR, SM), device="cuda", generator=gen,
                       dtype=torch.int32)
    codes = torch.randint(0, SE, (SPOOL, SHK, SPS, SM), device="cuda",
                          generator=gen, dtype=torch.int8)
    ids = torch.randperm(SPOOL, device="cuda", generator=gen)[:SB * SMP]
    held = torch.arange(SMP, device="cuda")[None] <= SLIVE // SPS
    pt = torch.where(held, ids.reshape(SB, SMP), -1).to(torch.int32)
    valid = ((torch.arange(SMP * SPS, device="cuda")[None] < SLIVE)
             & kv_pages.occupancy(pt, SPS))
    return q, k_pool, v_pool, cq, codes, pt, valid


def _views(pt, *pools):
    from repro_torch.serving import kv_pages
    return [kv_pages.gather_pages(p, pt).reshape(SB * SHK, SMP * SPS, -1)
            for p in pools]


def check_paged(torch, gen):
    """Kernels 7 and 8 at the paged serving decode shape.  Kernel 7: [t,
    need] equal to the plain version's, output within tolerance of it,
    and output and [t, need] bit-identical to kernel 6 over gathered
    views.  Kernel 8: within tolerance of its plain version.  Yardsticks
    the port never calls: kernel 6 over gathered views plus the gather
    (what paging saves), and scaled_dot_product_attention over the
    gathered view with a boolean mask beside the gather's own time (the
    two together compute kernel 8's function)."""
    from repro_torch import kernels
    from repro_torch.kernels import cost
    from repro_torch.kernels.sparse_attention import ops, ref
    g, view = SB * SHK, SMP * SPS
    out_rows = {}
    for dtn, gran in (("bfloat16", "qhead"), ("float32", "qhead"),
                      ("float32", "kvgroup"), ("bfloat16", "kvgroup")):
        dt = getattr(torch, dtn)
        q, k_pool, v_pool, cq, codes, pt, valid = _paged_inputs(torch, gen, dt)
        kw = dict(scale=SDH ** -0.5, **_decode_kw(gran, view))
        args = (pt, q, k_pool, v_pool, cq, codes, valid)
        out, thr = _twice(torch, lambda: ops.fused_sparse_decode_attention_paged(
            *args, return_thresholds=True, **kw),
            "fused_sparse_decode_attention_paged")
        kv = _views(pt, k_pool, v_pool, codes)
        out6, thr6 = ops.fused_sparse_decode_attention(
            q, kv[0], kv[1], cq, kv[2], valid, return_thresholds=True, **kw)
        torch.cuda.synchronize()
        want, thr_ref = ref.fused_decode_paged_ref(*args, **kw)
        if not torch.equal(thr, thr_ref):
            raise AssertionError(f"paged {dtn} {gran}: [t, need] differ")
        err = close(out, want, BF16_TOL if dt == torch.bfloat16 else F32_TOL)
        if not (torch.equal(out, out6) and torch.equal(thr, thr6)):
            raise AssertionError(f"paged {dtn} {gran}: differs from kernel 6 "
                                 "over gathered views")
        print(f"  fused_sparse_decode_attention_paged {dtn} {gran}: "
              f"max_abs_err {err:.3e}, [t, need] exact, bit-identical to "
              "kernel 6 over gathered views and twice", flush=True)
        if (dtn, gran) == ("bfloat16", "qhead"):
            ms = time_ms(lambda: ops.fused_sparse_decode_attention_paged(
                *args, **kw), 30)
            plain = time_ms(lambda: ref.fused_decode_paged_ref(*args, **kw), 5)
            gather = time_ms(lambda: _views(pt, k_pool, v_pool, codes),
                             10)
            k6 = time_ms(lambda: ops.fused_sparse_decode_attention(
                q, kv[0], kv[1], cq, kv[2], valid, **kw), 30)
            read, pairs = _rows_read(ref, cq, kv[2], valid,
                                     {k: v for k, v in kw.items()
                                      if k != "scale"})
            bms, by = cost.fused_sparse_decode_attention_paged(
                *args, **kw, live=int(valid.sum()) * SHK, pairs=pairs,
                rows_read=read).bound_ms()
            out_rows["sparse"] = {
                "name": "fused_sparse_decode_attention_paged", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/sparse_decode.cu",
                "replaces": "src/repro/kernels/sparse_attention/sparse_attention.py:510",
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bms, "bound_by": by, "library_ms": None,
                "gather_ms": gather, "kernel6_over_gathered_ms": k6,
                "shape": f"G={g}, R={SR}, page table ({SB}, {SMP}) of pages "
                         f"of {SPS} over a {SPOOL}-page pool, {SLIVE} live, "
                         f"dh={SDH}, M={SM}, bf16"}
    for dtn in ("bfloat16", "float32"):
        dt = getattr(torch, dtn)
        q, k_pool, v_pool, _, _, pt, valid = _paged_inputs(torch, gen, dt)
        args = (pt, q, k_pool, v_pool, valid)
        kw = dict(scale=SDH ** -0.5, heads_per_batch=SHK)
        out = _twice(torch, lambda: ops.dense_decode_attention_paged(*args, **kw),
                     "dense_decode_attention_paged")
        err = close(out, ref.dense_decode_paged_ref(*args, **kw),
                    BF16_TOL if dt == torch.bfloat16 else F32_TOL)
        rows_max = _list_rows(torch, valid, g)
        if rows_max <= kernels.DECODE_CHUNK * kernels.decode_stages(
                SDH, q.element_size()):
            raise AssertionError("dense case: no split lists more rows than "
                                 "the ring holds")
        print(f"  dense_decode_attention_paged {dtn}: max_abs_err {err:.3e}, "
              f"bit-identical twice; a split lists up to {rows_max} rows, "
              f"{kernels.DECODE_CHUNK} a ring stage", flush=True)
        if dtn != "bfloat16":
            continue
        ms = time_ms(lambda: ops.dense_decode_attention_paged(*args, **kw), 30)
        plain = time_ms(lambda: ref.dense_decode_paged_ref(*args, **kw), 5)
        gather = time_ms(lambda: _views(pt, k_pool, v_pool), 10)
        # yardstick: SDPA over the gathered view (kv heads repeated for
        # the R query rows), a boolean mask of the valid slots
        kv = _views(pt, k_pool, v_pool)
        k4, v4 = (x.reshape(SB, SHK, view, SDH).repeat_interleave(SR, 1)
                  for x in kv)
        q4 = q.reshape(SB, SHK * SR, 1, SDH)
        mask = valid[:, None, None, :]
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, scale=SDH ** -0.5), 30)
        bms, by = cost.dense_decode_attention_paged(
            *args, **kw, live=int(valid.sum()) * SHK).bound_ms()
        out_rows["dense"] = {
            "name": "dense_decode_attention_paged", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dense_decode_paged.cu",
            "replaces": "src/repro/kernels/sparse_attention/sparse_attention.py:630",
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "sdpa_over_gathered_ms": sdpa,
            "gather_ms": gather,
            "shape": f"G={g}, R={SR}, page table ({SB}, {SMP}) of pages of "
                     f"{SPS} over a {SPOOL}-page pool, {SLIVE} live, "
                     f"dh={SDH}, bf16; no single call computes it: the same "
                     "function through PyTorch is gather_ms + "
                     "sdpa_over_gathered_ms"}
    return [out_rows["sparse"], out_rows["dense"]]


def _list_rows(torch, valid, g):
    """The most valid slots any (kv group, split) of the decode plan holds:
    the longest list kernel 8's attention pass streams through its ring."""
    from repro_torch import kernels
    b, s = valid.shape
    ns, sp = kernels.decode_splits(g, s)
    pad = torch.zeros(b, ns * sp, dtype=torch.int32, device=valid.device)
    pad[:, :s] = valid.int()
    return int(pad.reshape(b, ns, sp).sum(-1).max())


# Edge cases of the decode attention pass (name, b, hk, R, dh, gran, l_all,
# dead, M[, (MP, live)]): 2048 live slots of a 32 x 128 paged view over a
# shuffled pool unless (MP, live) says otherwise.  l_all: l = the view
# length, so every valid slot is selected and kernel 7 must equal kernel
# 8 bit for bit; dead: the last slot has no valid key.  The dh = 80,
# R = 1 cases are OPT-2.7B's heads (M = 10 books of d' = 8); the last,
# at its serving width (8 slots x 32 heads), is timed.
DECODE_EDGES = [
    ("G=8 (1 slot, 32 splits a group)", 1, 8, 2, 128, "qhead", False, False,
     SM),
    ("R=1", 4, 8, 1, 128, "qhead", False, True, SM),
    ("R=8", 2, 8, 8, 128, "qhead", False, True, SM),
    ("R=8 kvgroup", 2, 8, 8, 128, "kvgroup", False, False, SM),
    ("dh=64", 4, 8, 2, 64, "qhead", False, True, SM),
    ("dh=256", 4, 8, 2, 256, "qhead", False, False, SM),
    ("l >= live", 8, 8, 2, 128, "qhead", True, True, SM),
    ("dh=80 R=1 M=10 l >= live", 4, 8, 1, 80, "qhead", True, True, 10),
    ("dh=80 R=1 M=10 (OPT-2.7B: 8 slots x 32 heads)", 8, 32, 1, 80, "qhead",
     False, False, 10),
]
# The 16-row instances (R = 9-16): recurrentgemma-9b's local attention (16
# query heads on 1 kv head of 256, M = 32) over its full 2048-slot ring (a
# 16 x 128 view, every slot live, as once the ring has wrapped), under
# both granularities (16 x 33 and 1 x 513 histogram buckets); the first,
# at its serving width (8 slots), is timed.  R = 12 pads to 16 rows.
HYBRID_RING = (16, 2048)
HYBRID_EDGES = [
    ("R=16 dh=256 M=32 (recurrentgemma-9b: 8 slots x 1 kv head)", 8, 1, 16,
     256, "qhead", False, False, 32, HYBRID_RING),
    ("R=16 dh=256 M=32 kvgroup", 8, 1, 16, 256, "kvgroup", False, True, 32,
     HYBRID_RING),
    ("R=16 dh=256 M=32 l >= live", 2, 1, 16, 256, "qhead", True, True, 32,
     HYBRID_RING),
    ("R=12 dh=128 M=16 kvgroup, half the view live", 2, 2, 12, 128,
     "kvgroup", False, True, 16),
]


def check_decode_edges(torch, gen, edges=DECODE_EDGES,
                       timed_edge=DECODE_EDGES[-1][0], tag="paper"):
    """Kernels 3, 5, 6, 7 and 8 on ``edges``, bf16 and f32: each within
    tolerance of its plain version and bit-identical across two launches,
    [t, need] exact, kernel 7 bit-identical to kernel 6 over gathered
    views, kernels 3 + 5 bit-identical to kernel 6, a dead slot's rows 0,
    and with l >= live kernel 7 bit-identical to kernel 8.  The bf16
    run of ``timed_edge`` times each of the five kernels beside its bound;
    returns {wrapper name: [case row]} of those, tagged ``tag``."""
    from repro_torch import kernels
    from repro_torch.kernels import cost
    from repro_torch.kernels.sparse_attention import ops, ref
    from repro_torch.kernels.topl_select import ops as topl_ops
    from repro_torch.serving import kv_pages
    ps, e = SPS, SE
    timed = {}
    for edge in edges:
        name, b, hk, r, dh, gran, l_all, dead, m = edge[:9]
        mp, live = edge[9] if len(edge) > 9 else (SMP, SLIVE)
        view = mp * ps
        for dtn in ("bfloat16", "float32"):
            dt = getattr(torch, dtn)
            tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
            g, pool = b * hk, b * mp + 64
            q = torch.randn(g, r, dh, device="cuda", generator=gen).to(dt)
            k_pool, v_pool = (torch.randn(pool, hk, ps, dh, device="cuda",
                                          generator=gen).to(dt)
                              for _ in range(2))
            cq = torch.randint(0, e, (g, r, m), device="cuda", generator=gen,
                               dtype=torch.int32)
            codes = torch.randint(0, e, (pool, hk, ps, m), device="cuda",
                                  generator=gen, dtype=torch.int8)
            ids = torch.randperm(pool, device="cuda", generator=gen)[:b * mp]
            held = torch.arange(mp, device="cuda")[None] <= live // ps
            pt = torch.where(held, ids.reshape(b, mp), -1).to(torch.int32)
            valid = ((torch.arange(view, device="cuda")[None] < live)
                     & kv_pages.occupancy(pt, ps))
            if dead:
                valid[b - 1] = False
            sum_rows = gran == "kvgroup"
            kw = dict(scale=dh ** -0.5,
                      l=view if l_all else max(16, round(view * 0.125)),
                      max_score=m * (r if sum_rows else 1), sum_rows=sum_rows,
                      heads_per_batch=hk)
            sel = {x: kw[x] for x in ("l", "max_score", "sum_rows",
                                      "heads_per_batch")}
            what = f"{name} {dtn}"
            args = (pt, q, k_pool, v_pool, cq, codes, valid)
            out7, thr7 = _twice(torch, lambda: ops.fused_sparse_decode_attention_paged(
                *args, return_thresholds=True, **kw), f"kernel 7, {what}")
            want, thr_ref = ref.fused_decode_paged_ref(*args, **kw)
            if not torch.equal(thr7, thr_ref):
                raise AssertionError(f"kernel 7, {what}: [t, need] differ")
            err7 = close(out7, want, tol)
            kv = [x.reshape(g, view, -1) for x in
                  (kv_pages.gather_pages(p, pt) for p in (k_pool, v_pool, codes))]
            out6, thr6 = _twice(torch, lambda: ops.fused_sparse_decode_attention(
                q, kv[0], kv[1], cq, kv[2], valid, return_thresholds=True,
                **kw), f"kernel 6, {what}")
            if not (torch.equal(out7, out6) and torch.equal(thr7, thr6)):
                raise AssertionError(f"kernel 7, {what}: differs from kernel 6 "
                                     "over gathered views")
            thr3 = topl_ops.decode_topl_thresholds(cq, kv[2], valid, **sel)
            out5 = _twice(torch, lambda: ops.sparse_decode_attention(
                q, kv[0], kv[1], cq, kv[2], thr3, valid, scale=kw["scale"],
                sum_rows=sum_rows, heads_per_batch=hk), f"kernel 5, {what}")
            if not (torch.equal(thr3, thr6) and torch.equal(out5, out6)):
                raise AssertionError(f"kernels 3 + 5, {what}: differ from "
                                     "kernel 6")
            dargs = (pt, q, k_pool, v_pool, valid)
            dkw = dict(scale=kw["scale"], heads_per_batch=hk)
            out8 = _twice(torch, lambda: ops.dense_decode_attention_paged(
                *dargs, **dkw), f"kernel 8, {what}")
            err8 = close(out8, ref.dense_decode_paged_ref(*dargs, **dkw), tol)
            if l_all and not torch.equal(out7, out8):
                raise AssertionError(f"{what}: kernel 7 selecting every valid "
                                     "slot differs from kernel 8")
            if dead and (out7[-hk:].any() or out8[-hk:].any()):
                raise AssertionError(f"{what}: a slot with no valid key "
                                     "does not output 0")
            ns, sp = kernels.decode_splits(g, view)
            print(f"  decode edge {what} (G={g}, {ns} splits of {sp} slots, "
                  f"{_list_rows(torch, valid, g)} rows the longest list): "
                  f"kernels 7/8 max_abs_err {err7:.3e}/{err8:.3e}; 5, 6, 7 "
                  "bit-identical"
                  f"{'; 7 == 8' if l_all else ''}"
                  f"{'; dead slot 0' if dead else ''}; each twice", flush=True)
            if name != timed_edge or dt != torch.bfloat16:
                continue
            read, pairs = _rows_read(ref, cq, kv[2], valid, sel)
            slots = int(valid.sum()) * hk             # live (group, slot)s
            data = dict(live=slots, pairs=pairs, rows_read=read)
            kv5 = (q, kv[0], kv[1], cq, kv[2], thr3, valid)
            kw5 = dict(scale=kw["scale"], sum_rows=sum_rows,
                       heads_per_batch=hk)
            case = (f"{name} (G={g}, R={r}, view {mp} x {ps}, {live} live, "
                    f"dh={dh}, M={m})")
            for wname, fn, c, err in (
                    ("fused_sparse_decode_attention_paged",
                     lambda: ops.fused_sparse_decode_attention_paged(
                         *args, **kw),
                     cost.fused_sparse_decode_attention_paged(
                         *args, **kw, **data), err7),
                    ("fused_sparse_decode_attention",
                     lambda: ops.fused_sparse_decode_attention(
                         q, kv[0], kv[1], cq, kv[2], valid, **kw),
                     cost.fused_sparse_decode_attention(
                         q, kv[0], kv[1], cq, kv[2], valid, **kw, **data),
                     err7),
                    ("decode_topl_thresholds",
                     lambda: topl_ops.decode_topl_thresholds(
                         cq, kv[2], valid, **sel),
                     cost.decode_topl_thresholds(cq, kv[2], valid, **sel,
                                                 live=slots), 0.0),
                    ("sparse_decode_attention",
                     lambda: ops.sparse_decode_attention(*kv5, **kw5),
                     cost.sparse_decode_attention(*kv5, **kw5, **data),
                     err7),
                    ("dense_decode_attention_paged",
                     lambda: ops.dense_decode_attention_paged(*dargs, **dkw),
                     cost.dense_decode_attention_paged(*dargs, **dkw,
                                                       live=slots), err8)):
                _paper_row(timed, wname, case, time_ms(fn, 30), c.bound_ms(),
                           err, tag=tag)
    return timed


# qwen3-0.6b's training step: batch 4 x 1024 tokens, 16 query / 8 kv
# heads of 128, M = 16 PQ books of d' = 8 over E = 16 codewords, L = 128
TB, TS, HQ, HK, DH, M_BOOKS, E_WORDS = 4, 1024, 16, 8, 128, 16, 16


def _codebooks(torch, gen, m=M_BOOKS, e=E_WORDS, dp=DH // M_BOOKS):
    return torch.randn(m, e, dp, device="cuda", generator=gen)


def _distances(torch, x, cb):
    """(..., M, E) f32 distances of the plain PQ assignment."""
    xs = x.float().reshape(*x.shape[:-1], cb.shape[0], -1)
    c2 = (cb * cb).sum(-1)
    return c2 - 2.0 * torch.einsum("...md,med->...me", xs, cb)


def pq_yardstick(torch, x, cb):
    """Kernel 1's function through PyTorch calls (a yardstick only; the
    port never makes them): f32 distances of every book by one
    torch.baddbmm, then argmin."""
    m, e, dp = cb.shape
    xs = x.reshape(-1, m, dp).float().transpose(0, 1)           # (M, n, d')
    c2 = (cb * cb).sum(-1)[:, None, :]                          # (M, 1, E)
    dist = torch.baddbmm(c2, xs, cb.transpose(1, 2), alpha=-2.0)
    return dist.argmin(-1).t()                                  # (n, M)


def _margin_flips(torch, got, x, cb, what):
    """Codes that differ from the plain version's; each must sit where the
    plain distances' two nearest lie within 1e-4 x the largest |distance|
    of that sub-vector (the margin rule)."""
    from repro_torch.kernels.pq_quantize import ref
    want = ref.pq_assign_ref(x, cb)
    diff = got != want
    flips = int(diff.sum())
    if flips:
        dist = _distances(torch, x, cb)
        top2 = dist.topk(2, dim=-1, largest=False).values
        margin = top2[..., 1] - top2[..., 0]
        scale = dist.abs().amax(-1)
        if bool((margin[diff] > 1e-4 * scale[diff]).any()):
            raise AssertionError(f"pq_assign {what}: {flips} codes differ "
                                 "beyond the margin rule")
    return flips, want.numel()


# Kernel 1's cases (name, dtype, groups, rows, d_head, E): the training
# step's q (bf16 and f32) and k at qwen3's d_head 128 (M = 16), the
# paper's blocks' 64 and 80 (M = 8, 10), E = 64 (the general body), and
# 1000 rows (a partial last tile).
def _pq_cases():
    return [("q", "bfloat16", TB * HQ, TS, DH, E_WORDS),
            ("q f32", "float32", TB * HQ, TS, DH, E_WORDS),
            ("k", "bfloat16", TB * HK, TS, DH, E_WORDS),
            ("q dh=64", "bfloat16", TB * HQ, TS, 64, E_WORDS),
            ("q dh=80", "bfloat16", TB * HQ, TS, 80, E_WORDS),
            ("q dh=80 f32", "float32", TB * HQ, TS, 80, E_WORDS),
            ("q dh=64 E=64", "bfloat16", TB * HQ, TS, 64, 64),
            ("1000 rows", "bfloat16", 1, 1000, DH, E_WORDS)]


def check_pq_assign(torch, gen):
    """Kernel 1 on every case of _pq_cases, each launched twice with
    bit-identical codes, equal to the plain version up to the margin rule;
    timed in bf16 at the q shape for M = 8, 10 and 16 (d_head 64, 80,
    128), beside the plain version and a torch yardstick."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.pq_quantize import ops, ref
    out, ms_books = None, {}
    for name, dtn, groups, n, dh, e in _pq_cases():
        dt = getattr(torch, dtn)
        x = torch.randn(groups, n, dh, device="cuda", generator=gen).to(dt)
        cb = _codebooks(torch, gen, dh // 8, e, 8)
        got = _twice(torch, lambda: ops.pq_assign(x, cb),
                     f"pq_assign {name}")
        flips, total = _margin_flips(torch, got, x, cb, name)
        print(f"  pq_assign {name} ({dtn}, x {tuple(x.shape)}, E={e}): "
              f"{flips} of {total} codes differ (margin rule); "
              "bit-identical twice", flush=True)
        if name in ("q", "q dh=64", "q dh=80"):
            ms_books[dh // 8] = time_ms(lambda: ops.pq_assign(x, cb), 30)
        if name != "q":
            continue
        plain = time_ms(lambda: ref.pq_assign_ref(x, cb), 5)
        yard = time_ms(lambda: pq_yardstick(torch, x, cb), 10)
        bms, by = cost.pq_assign(x, cb).bound_ms()
        out = {"name": "pq_assign", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/pq_assign.cu",
               "replaces": "src/repro/kernels/pq_quantize/pq_quantize.py:38",
               "max_abs_err": float(flips), "ms": ms_books[16],
               "plain_ms": plain, "bound_ms": bms, "bound_by": by,
               "library_ms": None, "torch_yardstick_ms": yard,
               "shape": f"x ({TB * HQ}, {TS}, {DH}) bf16, codebooks "
                        f"({M_BOOKS}, {E_WORDS}, {DH // M_BOOKS}); "
                        "max_abs_err counts differing codes; library_ms "
                        "n/a: no single PyTorch call assigns codes, the "
                        "yardstick is baddbmm + argmin in f32"}
    out["ms_by_books"] = ms_books
    print("  pq_assign bf16 at the q shape: " + ", ".join(
        f"M={m} {t:.4f} ms" for m, t in ms_books.items())
        + f"; torch yardstick {out['torch_yardstick_ms']:.4f} ms", flush=True)
    return out


def _train_codes(torch, gen, nq, nk, gq=TB * HQ, gk=TB * HK, m=M_BOOKS):
    cq = torch.randint(0, E_WORDS, (gq, nq, m), device="cuda",
                       generator=gen, dtype=torch.int32)
    ck = torch.randint(0, E_WORDS, (gk, nk, m), device="cuda",
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


# Kernel 2's cases beyond _topl_cases (name, nq, nk, causal, window,
# q_offset, books, codes, rep): the paper's blocks' books at the training
# shape; codes in [128, 256) (the byte body), >= 256 everywhere or in one
# key tile (the int32 body, alone and beside the packed ones); nq = 100
# (rows not a multiple of the 64-row tile); rep 1 and 4.
def _topl_more_cases():
    return [("train M=8", TS, TS, True, None, 0, 8, "e16", 2),
            ("train M=10", TS, TS, True, None, 0, 10, "e16", 2),
            ("codes in [128, 256)", TS, TS, True, None, 0, M_BOOKS, "byte", 2),
            ("codes >= 256", 256, 256, True, 64, 0, M_BOOKS, "wide", 2),
            ("one key tile >= 256", TS, TS, True, None, 0, M_BOOKS, "tile", 2),
            ("nq=100", 100, 100, True, None, 0, M_BOOKS, "e16", 2),
            ("rep 1", 512, 512, True, None, 0, M_BOOKS, "e16", 1),
            ("rep 4", 512, 512, True, 200, 0, M_BOOKS, "e16", 4)]


def _topl_codes(torch, gen, nq, nk, m, kind, rep):
    """Codes of E_WORDS values, spread over [128, 256) ("byte") or over
    negatives and values past 2^16 ("wide"); "tile": keys 512-575 shifted
    by 256."""
    cq, ck = _train_codes(torch, gen, nq, nk, TB * HQ, TB * HQ // rep, m)
    if kind == "byte":
        return 128 + 8 * cq, 128 + 8 * ck
    if kind == "wide":
        return cq * 4099 - 20000, ck * 4099 - 20000
    if kind == "tile":
        ck[:, 512:576] += 256
    return cq, ck


def _top_l(n, window=None):
    horizon = n if window is None else min(n, window)
    return min(max(16, round(horizon * 0.125)), horizon)


def check_topl_thresholds(torch, gen):
    """Kernel 2: [t, need] exactly equal to the plain version on every
    case, each launched twice with bit-identical outputs; timed at the
    training shape for M = 16, 8 and 10."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.topl_select import ops, ref
    cases = [c + (M_BOOKS, "e16", HQ // HK) for c in _topl_cases()]
    out, ms_books = None, {}
    for name, nq, nk, causal, window, q_off, m, kind, rep in \
            cases + _topl_more_cases():
        cq, ck = _topl_codes(torch, gen, nq, nk, m, kind, rep)
        kw = dict(l=_top_l(nk, window), max_score=m, causal=causal,
                  window=window, q_offset=q_off, heads_per_batch=HQ,
                  rep=rep)
        thr = _twice(torch, lambda: ops.topl_thresholds(cq, ck, **kw),
                     f"topl_thresholds {name}")
        if not torch.equal(thr, ref.thresholds_ref(cq, ck, **kw)):
            raise AssertionError(f"topl_thresholds {name}: [t, need] differ")
        print(f"  topl_thresholds {name} (nq={nq}, nk={nk}, M={m}, "
              f"rep {rep}): [t, need] exact; bit-identical twice", flush=True)
        if name in ("train", "train M=8", "train M=10"):
            ms_books[m] = time_ms(lambda: ops.topl_thresholds(cq, ck, **kw),
                                  30)
        if name != "train":
            continue
        plain = time_ms(lambda: ref.thresholds_ref(cq, ck, **kw), 3)
        bms, by = cost.topl_thresholds(cq, ck, **kw).bound_ms()
        out = {"name": "topl_thresholds", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/topl_thresholds.cu",
               "replaces": "src/repro/kernels/topl_select/topl_select.py:69",
               "max_abs_err": 0.0, "ms": ms_books[M_BOOKS],
               "plain_ms": plain, "bound_ms": bms, "bound_by": by,
               "library_ms": None,
               "shape": f"codes_q ({TB * HQ}, {TS}, {M_BOOKS}), codes_k "
                        f"({TB * HK}, {TS}, {M_BOOKS}), causal, L=128; "
                        "bound: M int compares per admitted pair at the "
                        "f32 CUDA-core rate"}
    out["ms_by_books"] = ms_books
    print("  topl_thresholds at the training shape: " + ", ".join(
        f"M={m} {t:.4f} ms" for m, t in sorted(ms_books.items())), flush=True)
    return out


# Kernel 4's cases: the training shape and the small cases of kernel 2,
# then key counts below one 64-key tile (causal with an offset, and
# non-causal); with q_offset, nq = 72 is not a multiple of the 64-row tile.
def _attn_cases():
    return _topl_cases() + [("nk < 64", 40, 48, True, None, 8),
                            ("non-causal nk < 64", 24, 40, False, None, 0)]


ATTN_HEAD_DIMS = (128, 80, 64)      # qwen3's, OPT-2560's, and a small one


def check_sparse_attention(torch, gen):
    """Kernel 4 against its plain version at dh 128, 80 and 64, bf16 and
    f32, on every case of _attn_cases, each launched twice with
    bit-identical outputs; timed in bf16 at the training shape (every dh)
    beside SDPA over the same selection given as a mask (dh 128)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.sparse_attention import ops, ref
    from repro_torch.kernels.topl_select.ref import masked_scores, thresholds_ref
    out, worst, ms_dh = None, {}, {}
    for dh in ATTN_HEAD_DIMS:
        for dtn in ("bfloat16", "float32"):
            dt = getattr(torch, dtn)
            errs = []
            for name, nq, nk, causal, window, q_off in _attn_cases():
                cq, ck = _train_codes(torch, gen, nq, nk)
                q = torch.randn(TB * HQ, nq, dh, device="cuda", generator=gen).to(dt)
                k = torch.randn(TB * HK, nk, dh, device="cuda", generator=gen).to(dt)
                v = torch.randn(TB * HK, nk, dh, device="cuda", generator=gen).to(dt)
                sel = dict(causal=causal, window=window, q_offset=q_off,
                           heads_per_batch=HQ, rep=HQ // HK)
                thr = thresholds_ref(cq, ck, l=_top_l(nk, window),
                                     max_score=M_BOOKS, **sel)
                kw = dict(scale=dh ** -0.5, **sel)
                got = _twice(torch, lambda: ops.sparse_attention(
                    q, k, v, cq, ck, thr, **kw),
                    f"sparse_attention {dtn} dh={dh} {name}")
                want = ref.sparse_attention_ref(q, k, v, cq, ck, thr, **kw)
                err = close(got, want,
                            BF16_TOL if dt == torch.bfloat16 else F32_TOL)
                errs.append(f"{name} {err:.2e}")
                worst[dtn] = max(worst.get(dtn, 0.0), err)
                if name != "train" or dt != torch.bfloat16:
                    continue
                ms_dh[dh] = time_ms(lambda: ops.sparse_attention(
                    q, k, v, cq, ck, thr, **kw), 20)
                if dh != DH:
                    continue
                plain = time_ms(lambda: ref.sparse_attention_ref(
                    q, k, v, cq, ck, thr, **kw), 3)
                sm = masked_scores(cq, ck, **sel)
                kept = ref.newest_ties(sm, thr)              # (G, nq, nk)
                rows = kept.reshape(TB * HK, HQ // HK * nq, nk).any(1)
                pairs = int(kept.sum())
                bms, by = cost.sparse_attention(
                    q, k, v, cq, ck, thr, **kw, pairs=pairs,
                    rows_read=int(rows.sum())).bound_ms()
                # yardstick only (the port never calls it): SDPA over the
                # same selection given as a precomputed boolean mask
                kv = torch.arange(TB * HQ, device="cuda") // (HQ // HK)
                mask = kept.reshape(TB, HQ, nq, nk)
                q4, k4, v4 = (x.reshape(TB, HQ, nq, dh) for x in
                              (q, k[kv], v[kv]))
                sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, scale=dh ** -0.5), 20)
                out = {"name": "sparse_attention", "route": "cuda",
                       "source": "src/repro_torch/kernels/csrc/sparse_attention.cu",
                       "replaces": "src/repro/kernels/sparse_attention/sparse_attention.py:115",
                       "max_abs_err": err, "ms": ms_dh[dh], "plain_ms": plain,
                       "bound_ms": bms, "bound_by": by, "library_ms": None,
                       "masked_sdpa_ms": sdpa, "kept_pairs": pairs,
                       "shape": f"q ({TB * HQ}, {nq}, {dh}), k/v ({TB * HK}, {nk}, "
                                f"{dh}) bf16, GQA 2, causal, L=128"}
            print(f"  sparse_attention {dtn} dh={dh}, max_abs_err by case: "
                  f"{'; '.join(errs)}; each bit-identical twice", flush=True)
    out["ms_by_head_dim"] = ms_dh
    out["max_abs_err_all"] = worst
    print(f"  sparse_attention bf16 at the training shape: "
          + ", ".join(f"dh={d} {t:.4f} ms" for d, t in ms_dh.items()),
          flush=True)
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


def _twice(torch, fn, what):
    """fn() launched twice on the same inputs: the outputs (a tensor or a
    tuple of them) must be bit-identical (no atomics, every sum in a fixed
    order)."""
    y = fn()
    y2 = fn()
    torch.cuda.synchronize()
    pairs = zip(y, y2) if isinstance(y, tuple) else [(y, y2)]
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{what}: two launches differ")
    return y


def _bf16_lora(torch, lora):
    return {k: {n: t.to(torch.bfloat16) for n, t in v.items()}
            for k, v in lora.items()}


def _torch_act(torch, act):
    fn = torch.nn.functional
    return {"silu": fn.silu, "relu": fn.relu, "gelu": fn.gelu}[act]


def grouped_ffn_yardstick(torch, x, index, wts, lora16, scale, act="silu"):
    """Kernel 9's function in bf16 through PyTorch calls (the port never
    calls it): gather the slots' rows, bmm over the groups (gated: act(gate)
    x up; ungated: act(up)), and the LoRA products.  Every slot is
    computed, as the function says; the output is (G, B*C, d)."""
    b, s, d = x.shape
    _, g, c = index.shape
    rows = index.clamp(max=s - 1).long().transpose(0, 1).reshape(g, b * c)
    xg = x[torch.arange(b, device=x.device).repeat_interleave(c)[None],
           rows]                                             # (G, B*C, d)

    def up_of(w, lr):
        return torch.bmm(xg, w) + scale * torch.bmm(xg @ lr["b"], lr["c"])
    up = up_of(wts["w_inner"], lora16["lora_inner"])
    fn = _torch_act(torch, act)
    h = (fn(up_of(wts["w_gate"], lora16["lora_gate"])) * up
         if "w_gate" in wts else fn(up))
    lo = lora16["lora_outer"]
    return torch.bmm(h, wts["w_outer"]) + scale * (torch.bmm(h, lo["b"])
                                                   @ lo["c"])


def _grouped_case(torch, gen, dtn, *, b, s, d, f, g, ga, r, capf, act,
                  gated, lens=None, choice=None, reverse=False,
                  scaled=False):
    """One kernel-9 case from seeded random inputs (r = 0: no LoRA):
    launched twice (bit-identical), every row finite, the kept slots
    within tolerance of the plain version (scaled: close_scaled's rule).
    reverse: each row's slots in reverse order, so the kept slots come
    last and a tile may start on an empty slot and still keep some.
    Returns the case's tensors."""
    from repro_torch.core import dispatch
    from repro_torch.core import routed_ffn as rf
    from repro_torch.kernels.routed_ffn import ops, ref
    dt = getattr(torch, dtn)
    rcfg = rf.RoutedFFNConfig(d_model=d, d_ff=f * g, num_groups=g,
                              active_groups=ga, capacity_factor=capf,
                              activation=act, gated=gated)
    wts, lora = _ffn_weights(torch, gen, g, d, f, max(r, 1), dt)
    if not gated:
        del wts["w_gate"], lora["lora_gate"]
    lora = lora if r else None
    x = torch.randn(b, s, d, device="cuda", generator=gen).to(dt)
    if choice is None:
        router = torch.randn(d, g, device="cuda", generator=gen) / d ** 0.5
        choice, gate, _ = rf.route(x, router, rcfg, need_aux=False)
    else:
        gate = torch.ones(choice.shape, device="cuda")
    plan = rf.plan_for(x, choice, gate, rcfg, lens)
    index, slot_ok = plan.index, plan.slot_ok
    if reverse:
        index, slot_ok = index.flip(-1).contiguous(), slot_ok.flip(-1)
    args = (x, index, wts["w_inner"], wts["w_outer"], wts.get("w_gate"),
            lora, 1.0)
    y = _twice(torch, lambda: ops.grouped_ffn(*args, act=act), "grouped_ffn")
    if not bool(torch.isfinite(y.float()).all()):
        raise AssertionError("grouped_ffn: a non-finite row")
    want = ref.grouped_ffn_ref(*args, act=act)
    ok = slot_ok[..., None]                     # empty slots are dropped
    pair = (torch.where(ok, y.float(), 0.0), torch.where(ok, want.float(), 0.0),
            BF16_TOL if dt == torch.bfloat16 else F32_TOL)
    stats = close_scaled(*pair) if scaled else None
    err = stats[0] if scaled else close(*pair)
    kept_rows = slot_ok.sum(-1)
    # 64-slot tiles that start on an empty slot and keep some slot
    c = index.shape[-1]
    tiles = torch.arange(0, c, 64, device="cuda")
    kept_in = torch.stack([slot_ok[..., t:t + 64].any(-1) for t in
                           tiles.tolist()], -1)
    split_tiles = int((kept_in & (index[..., tiles] == s)).sum())
    return dict(err=err, args=args, plan=plan, y=y, wts=wts, lora=lora,
                x=x, dropped=float(plan.dropped), split_tiles=split_tiles,
                empty_rows=int((kept_rows == 0).sum()), c=c, stats=stats)


def _grouped_bound(case):
    """Kernel 9's bound on a case's inputs (kernels/cost.py) for the
    capacity slots its plan keeps."""
    from repro_torch.kernels import cost
    return cost.grouped_ffn(*case["args"], kept=int(
        case["plan"].slot_ok.sum())).bound_ms()


def check_grouped_ffn(torch, gen):
    """Kernel 9 at a (8, 1024) prefill bucket and at the train step's 4 x
    1024 full rows (qwen3-0.6b widths, SwiGLU, LoRA r = 16), and on small
    edge cases, bf16 and f32: ungated ReLU without LoRA; C and F that are
    not tile multiples; a (b, g) row with no kept slot; capacity drops;
    LoRA ranks 12 (ungated) and 32; kept slots last in each row.  Each
    case launched twice with bit-identical outputs."""
    from repro_torch.kernels.routed_ffn import ops, ref
    d, g, ga, r, f = 1024, 8, 4, 16, 384
    out = None
    for dtn in ("bfloat16", "float32"):
        dt = getattr(torch, dtn)
        lens = torch.randint(128, 1025, (8,), device="cuda", generator=gen)
        bucket = _grouped_case(torch, gen, dtn, b=8, s=1024, d=d, f=f, g=g,
                               ga=ga, r=r, capf=1.25, act="silu", gated=True,
                               lens=lens)
        train = _grouped_case(torch, gen, dtn, b=4, s=1024, d=d, f=f, g=g,
                              ga=ga, r=r, capf=1.25, act="silu", gated=True)
        for label, cs in (("(8, 1024) bucket", bucket),
                          ("train 4 x 1024", train)):
            print(f"  grouped_ffn {dtn} {label} C={cs['c']}: max_abs_err "
                  f"{cs['err']:.3e}, two launches bit-identical", flush=True)
        # small edge cases
        ungated = _grouped_case(torch, gen, dtn, b=2, s=100, d=256, f=192,
                                g=4, ga=2, r=0, capf=1.0, act="relu",
                                gated=False)
        ragged = _grouped_case(torch, gen, dtn, b=2, s=90, d=200, f=200, g=4,
                               ga=2, r=16, capf=1.25, act="gelu", gated=True)
        # batch row 0 never chooses group 0: its (0, 0) row keeps no slot
        first = torch.randint(1, 4, (2, 80), device="cuda", generator=gen)
        ch = torch.stack([first, first % 3 + 1], -1)     # two distinct groups
        ch[1, :8, 0] = 0
        empty = _grouped_case(torch, gen, dtn, b=2, s=80, d=128, f=128, g=4,
                              ga=2, r=8, capf=1.0, act="silu", gated=True,
                              choice=ch.to(torch.int32))
        drops = _grouped_case(torch, gen, dtn, b=2, s=128, d=128, f=64, g=4,
                              ga=2, r=16, capf=0.5, act="silu", gated=True)
        # a LoRA rank the wrapper pads (12 -> 16) and the bf16 kernel's
        # largest (32), ungated with LoRA, and kept slots last in each row
        rank12 = _grouped_case(torch, gen, dtn, b=2, s=96, d=128, f=128,
                               g=4, ga=2, r=12, capf=1.25, act="gelu",
                               gated=False)
        rank32 = _grouped_case(torch, gen, dtn, b=2, s=160, d=256, f=192,
                               g=4, ga=2, r=32, capf=1.25, act="silu",
                               gated=True, reverse=True)
        if not (empty["empty_rows"] >= 1 and drops["dropped"] > 0
                and rank32["split_tiles"] >= 1):
            raise AssertionError("grouped_ffn edge cases: no empty row, no "
                                 "capacity drop or no tile that starts "
                                 "empty and keeps a slot")
        for label, cs in (("ungated relu, no LoRA", ungated),
                          ("d=F=200, C not a tile multiple", ragged),
                          (f"{empty['empty_rows']} (b, g) rows with no kept "
                           "slot", empty),
                          (f"capacity drops ({drops['dropped']:.2f})", drops),
                          ("ungated gelu, LoRA r=12 (padded to 16)", rank12),
                          (f"LoRA r=32, kept slots last "
                           f"({rank32['split_tiles']} tiles start empty and "
                           "keep slots)", rank32)):
            print(f"  grouped_ffn {dtn} {label} C={cs['c']}: max_abs_err "
                  f"{cs['err']:.3e}, bit-identical", flush=True)
        if dtn != "bfloat16":
            continue
        args = bucket["args"]
        ms = time_ms(lambda: ops.grouped_ffn(*args, act="silu"), 10)
        plain = time_ms(lambda: ref.grouped_ffn_ref(*args, act="silu"), 3)
        lora16 = _bf16_lora(torch, bucket["lora"])
        yard = time_ms(lambda: grouped_ffn_yardstick(
            torch, args[0], args[1], bucket["wts"], lora16, 1.0), 10)
        bms, by = _grouped_bound(bucket)
        targs = train["args"]
        tms = time_ms(lambda: ops.grouped_ffn(*targs, act="silu"), 10)
        tyard = time_ms(lambda: grouped_ffn_yardstick(
            torch, targs[0], targs[1], train["wts"],
            _bf16_lora(torch, train["lora"]), 1.0), 10)
        tbms, _ = _grouped_bound(train)
        out = {"name": "grouped_ffn", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/grouped_ffn.cu",
               "replaces": "src/repro/kernels/routed_ffn/routed_ffn.py:187",
               "max_abs_err": bucket["err"], "ms": ms, "plain_ms": plain,
               "bound_ms": bms, "bound_by": by, "library_ms": None,
               "torch_yardstick_ms": yard, "train_shape_ms": tms,
               "train_shape_bound_ms": tbms,
               "train_shape_yardstick_ms": tyard,
               "kept_slots": int(bucket["plan"].slot_ok.sum()),
               "shape": f"x (8, 1024, 1024), index (8, 8, {bucket['c']}), "
                        "F=384, SwiGLU, LoRA r=16, bf16; yardstick: gather + "
                        "bmm x 3 + silu*up + LoRA bmm in bf16; train shape: "
                        f"x (4, 1024, 1024), C={train['c']}"}
    return out


def decode_ffn_yardstick(torch, x, choice, gate, wts, lora16, scale,
                         act="silu"):
    """Kernel 10's function in bf16 through PyTorch calls (the port never
    calls it): each slot's chosen weight blocks gathered and contracted
    with bmm (gated or not), then the gated sum over G'."""
    b, ga = choice.shape
    ch = choice.long()
    xr = x[:, None, None, :].expand(b, ga, 1, -1).reshape(b * ga, 1, -1)

    def up_of(w, lr):
        u = torch.bmm(xr, w[ch].flatten(0, 1))
        xb = (x @ lr["b"])[:, None, None, :].expand(b, ga, 1, -1)
        return u + scale * torch.bmm(xb.reshape(b * ga, 1, -1),
                                     lr["c"][ch].flatten(0, 1))
    up = up_of(wts["w_inner"], lora16["lora_inner"])
    fn = _torch_act(torch, act)
    h = (fn(up_of(wts["w_gate"], lora16["lora_gate"])) * up
         if wts.get("w_gate") is not None else fn(up))
    lo = lora16["lora_outer"]
    wo = wts["w_outer"][ch].flatten(0, 1)
    y = torch.bmm(h, wo) + scale * (torch.bmm(h, lo["b"][ch].flatten(0, 1))
                                    @ lo["c"])
    return (gate.to(x.dtype)[..., None] * y.reshape(b, ga, -1)).sum(1)


def check_decode_ffn(torch, gen):
    """Kernel 10 at 8 decode slots of qwen3-0.6b widths (bf16, f32, f32
    with output gates), at 1 slot, at 8 slots that all choose the same
    groups, ungated ReLU without LoRA, and LoRA rank 6 with x off 16 bytes;
    each launched twice with bit-identical outputs."""
    from repro_torch.core import routed_ffn as rf
    from repro_torch.kernels import cost
    from repro_torch.kernels.routed_ffn import ops, ref
    d, dff, g, ga, r = 1024, 3072, 8, 4, 16
    f = dff // g
    out = None
    cases = [("bfloat16", 8, True, False, "router"),
             ("float32", 8, True, False, "router"),
             ("float32", 8, True, True, "router"),
             ("bfloat16", 1, True, False, "router"),
             ("float32", 1, True, False, "router"),
             ("bfloat16", 8, True, False, "same groups"),
             ("float32", 8, True, False, "same groups"),
             ("bfloat16", 8, False, False, "ungated relu, no LoRA"),
             ("float32", 8, False, False, "ungated relu, no LoRA"),
             ("bfloat16", 8, True, False, "LoRA r=6, x off 16 bytes"),
             ("float32", 8, True, False, "LoRA r=6, x off 16 bytes")]
    for dtn, b, gated, gated_out, how in cases:
        dt = getattr(torch, dtn)
        plain_relu = how.startswith("ungated")
        odd = how.startswith("LoRA r=6")
        act = "relu" if plain_relu else "silu"
        rcfg = rf.RoutedFFNConfig(d_model=d, d_ff=dff, num_groups=g,
                                  active_groups=ga, activation=act,
                                  gated=gated, gate_outputs=gated_out)
        wts, lora = _ffn_weights(torch, gen, g, d, f, 6 if odd else r, dt)
        if plain_relu:
            lora = None
        x = torch.randn(b, d, device="cuda", generator=gen).to(dt)
        if odd:                   # a view that starts one element in
            x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(b, d)
        router = torch.randn(d, g, device="cuda", generator=gen) / d ** 0.5
        choice, gate, _ = rf.route(x[:, None], router, rcfg, need_aux=False)
        choice, gate = choice[:, 0].contiguous(), gate[:, 0].contiguous()
        if how == "same groups":
            choice = choice[:1].expand(b, ga).contiguous()
        args = (x, choice, gate, wts["w_inner"], wts["w_outer"],
                wts["w_gate"] if gated else None, lora, 1.0)
        y = _twice(torch, lambda: ops.decode_ffn(*args, act=act), "decode_ffn")
        want = ref.decode_ffn_ref(*args, act=act)
        err = close(y, want, BF16_TOL if dt == torch.bfloat16 else F32_TOL)
        print(f"  decode_ffn {dtn} B={b} {how}"
              f"{', gated outputs' if gated_out else ''}: max_abs_err "
              f"{err:.3e}, bit-identical", flush=True)
        if (dtn, b, how, gated_out) != ("bfloat16", 8, "router", False):
            continue
        ms = time_ms(lambda: ops.decode_ffn(*args, act=act), 30)
        plain = time_ms(lambda: ref.decode_ffn_ref(*args, act=act), 5)
        lora16 = _bf16_lora(torch, lora)
        yard = time_ms(lambda: decode_ffn_yardstick(
            torch, x, choice, gate, wts, lora16, 1.0), 30)
        blocks = int(torch.unique(choice).numel())   # touched groups
        bms, by = cost.decode_ffn(*args, act=act, blocks=blocks).bound_ms()
        out = {"name": "decode_ffn", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/decode_ffn.cu",
               "replaces": "src/repro/kernels/routed_ffn/routed_ffn.py:344",
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": bms, "bound_by": by, "library_ms": None,
               "torch_yardstick_ms": yard,
               "shape": f"x (8, 1024), G'=4 of G=8 ({blocks} blocks touched), "
                        "F=384, SwiGLU, LoRA r=16, bf16; yardstick: each "
                        "slot's gathered weight blocks through bmm, bf16"}
    return out


# The paper's end-to-end models at their training step (batch 4 x 1024,
# L = 128): (label, heads, d_head) — OPT-2.7B 32 heads of 80 (M = 10),
# Sheared-LLaMA-2.7B 20 heads of 128 (M = 16); full MHA (R = 1) in both.
PAPER_TRAIN = [("OPT-2.7B", 32, 80), ("LLaMA-2.7B", 20, 128)]
# Kernel 9 at the paper blocks' widths (label, d, F = d_ff / 8, act,
# gated), at the training step's 4 x 1024 rows with LoRA r = 16.
PAPER_FFN = [("OPT-1024", 1024, 512, "relu", False),
             ("OPT-2048", 2048, 1024, "relu", False),
             ("OPT-2560", 2560, 1280, "relu", False),
             ("LLaMA-2560", 2560, 864, "silu", True),
             ("LLaMA-4096", 4096, 1376, "silu", True)]


def _paper_row(out, name, case, ms, bnd, err, yard=None, tag="paper"):
    """yard: a torch yardstick's ms for the same function (kernels 1, 9,
    10), else None."""
    beside = "" if yard is None else f", torch yardstick {yard:.4f} ms"
    print(f"  [{tag}] {name} {case}: {ms:.4f} ms, bound {bnd[0]:.4f} ms by "
          f"{bnd[1]}{beside}, max_abs_err {err:.3e}; bit-identical twice",
          flush=True)
    row = {"case": case, "ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1],
           "max_abs_err": err}
    if yard is not None:
        row["torch_yardstick_ms"] = yard
    out.setdefault(name, []).append(row)


def check_paper_shapes(torch, gen):
    """Kernels 1, 2 and 4 at the OPT-2.7B and LLaMA-2.7B training steps
    (R = 1, dh 80 / M = 10 and dh 128 / M = 16), kernel 9 at the five
    paper blocks' widths, and kernels 6 and 10 at OPT-2.7B's serving
    decode (8 slots x 32 heads, R = 1, dh 80, M = 10, S = 2048; d 2560,
    F 1280, ungated ReLU): each launched twice bit-identically, against
    its plain version (codes by the margin rule, [t, need] exactly), and
    timed by CUDA events beside its bound.  Returns {wrapper name: [case
    rows]}."""
    from repro_torch.core import routed_ffn as rf
    from repro_torch.kernels import cost
    from repro_torch.kernels.pq_quantize import ops as pq_ops
    from repro_torch.kernels.routed_ffn import ops as ffn_ops
    from repro_torch.kernels.routed_ffn import ref as ffn_ref
    from repro_torch.kernels.sparse_attention import ops as sa_ops
    from repro_torch.kernels.sparse_attention import ref as sa_ref
    from repro_torch.kernels.topl_select import ops as topl_ops
    from repro_torch.kernels.topl_select.ref import (masked_scores,
                                                     thresholds_ref)
    bf16 = torch.bfloat16
    out = {}
    for label, heads, dh in PAPER_TRAIN:
        g, m = TB * heads, dh // 8
        case = f"{label} train (G={g}, n={TS}, dh={dh}, M={m}, R=1)"
        x = torch.randn(g, TS, dh, device="cuda", generator=gen).to(bf16)
        cb = _codebooks(torch, gen, m, E_WORDS, 8)
        codes = _twice(torch, lambda: pq_ops.pq_assign(x, cb),
                       f"pq_assign {case}")
        flips, _ = _margin_flips(torch, codes, x, cb, case)
        ms = time_ms(lambda: pq_ops.pq_assign(x, cb), 30)
        yard = time_ms(lambda: pq_yardstick(torch, x, cb), 10)
        bnd = cost.pq_assign(x, cb).bound_ms()
        _paper_row(out, "pq_assign", case, ms, bnd, float(flips), yard)
        cq, ck = _train_codes(torch, gen, TS, TS, g, g, m)
        kw = dict(l=_top_l(TS), max_score=m, causal=True, window=None,
                  q_offset=0, heads_per_batch=heads, rep=1)
        thr = _twice(torch, lambda: topl_ops.topl_thresholds(cq, ck, **kw),
                     f"topl_thresholds {case}")
        if not torch.equal(thr, thresholds_ref(cq, ck, **kw)):
            raise AssertionError(f"topl_thresholds {case}: [t, need] differ")
        ms = time_ms(lambda: topl_ops.topl_thresholds(cq, ck, **kw), 30)
        bnd = cost.topl_thresholds(cq, ck, **kw).bound_ms()
        _paper_row(out, "topl_thresholds", case, ms, bnd, 0.0)
        q, k, v = (torch.randn(g, TS, dh, device="cuda", generator=gen).to(bf16)
                   for _ in range(3))
        sel = dict(causal=True, window=None, q_offset=0,
                   heads_per_batch=heads, rep=1)
        akw = dict(scale=dh ** -0.5, **sel)
        got = _twice(torch, lambda: sa_ops.sparse_attention(
            q, k, v, cq, ck, thr, **akw), f"sparse_attention {case}")
        err = close(got, sa_ref.sparse_attention_ref(q, k, v, cq, ck, thr,
                                                     **akw), BF16_TOL)
        ms = time_ms(lambda: sa_ops.sparse_attention(
            q, k, v, cq, ck, thr, **akw), 20)
        kept = sa_ref.newest_ties(masked_scores(cq, ck, **sel), thr)
        bnd = cost.sparse_attention(
            q, k, v, cq, ck, thr, **akw, pairs=int(kept.sum()),
            rows_read=int(kept.any(1).sum())).bound_ms()
        _paper_row(out, "sparse_attention", case, ms, bnd, err)
        del kept
    for label, d, f, act, gated in PAPER_FFN:
        cs = _grouped_case(torch, gen, "bfloat16", b=TB, s=TS, d=d, f=f, g=8,
                           ga=4, r=16, capf=1.25, act=act, gated=gated)
        args = cs["args"]
        ms = time_ms(lambda: ffn_ops.grouped_ffn(*args, act=act), 10)
        lora16 = _bf16_lora(torch, cs["lora"])
        yard = time_ms(lambda: grouped_ffn_yardstick(
            torch, cs["x"], cs["plan"].index, cs["wts"], lora16, 1.0,
            act=act), 10)
        bnd = _grouped_bound(cs)
        _paper_row(out, "grouped_ffn", f"{label} train (x (4, 1024, {d}), "
                   f"F={f}, {act}{' gated' if gated else ''}, C={cs['c']}, "
                   "LoRA r=16)", ms, bnd, cs["err"], yard)
    # the wide form's edges: d and F not multiples of its 64-column
    # slices, LoRA rank 32 with kept slots last and capacity drops, rank
    # 12 (padded to 16) ungated
    for what, kw in (("d=1032 F=520 silu gated, LoRA r=32, kept slots "
                      "last, capacity 0.5", dict(r=32, capf=0.5, act="silu",
                                                 gated=True, reverse=True)),
                     ("d=1032 F=520 gelu ungated, LoRA r=12",
                      dict(r=12, capf=1.25, act="gelu", gated=False))):
        cs = _grouped_case(torch, gen, "bfloat16", b=2, s=160, d=1032, f=520,
                           g=4, ga=2, **kw)
        print(f"  [paper] grouped_ffn wide form {what} (C={cs['c']}, "
              f"dropped {cs['dropped']:.2f}): max_abs_err {cs['err']:.3e}, "
              "bit-identical twice", flush=True)
    # OPT-2.7B serving decode: kernel 6, then kernel 10
    b, hk, dh, m, s = 8, 32, 80, 10, 2048
    g = b * hk
    q = torch.randn(g, 1, dh, device="cuda", generator=gen).to(bf16)
    k, v = (torch.randn(g, s, dh, device="cuda", generator=gen).to(bf16)
            for _ in range(2))
    cq = torch.randint(0, E_WORDS, (g, 1, m), device="cuda", generator=gen,
                       dtype=torch.int32)
    ck = torch.randint(0, E_WORDS, (g, s, m), device="cuda", generator=gen,
                       dtype=torch.int8)
    lens = torch.randint(128, s + 1, (b,), device="cuda", generator=gen)
    valid = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    kw = dict(scale=dh ** -0.5, l=_top_l(s), max_score=m, sum_rows=False,
              heads_per_batch=hk)
    case = f"OPT-2.7B decode (G={g}, R=1, S={s}, dh={dh}, M={m})"
    got, thr = _twice(torch, lambda: sa_ops.fused_sparse_decode_attention(
        q, k, v, cq, ck, valid, return_thresholds=True, **kw),
        f"fused_sparse_decode_attention {case}")
    want, thr_ref = sa_ref.fused_decode_ref(q, k, v, cq, ck, valid, **kw)
    if not torch.equal(thr, thr_ref):
        raise AssertionError(f"fused_sparse_decode_attention {case}: "
                             "[t, need] differ")
    err = close(got, want, BF16_TOL)
    ms = time_ms(lambda: sa_ops.fused_sparse_decode_attention(
        q, k, v, cq, ck, valid, **kw), 30)
    read, pairs = _rows_read(sa_ref, cq, ck, valid,
                             {x: kw[x] for x in kw if x != "scale"})
    bnd = cost.fused_sparse_decode_attention(
        q, k, v, cq, ck, valid, **kw, live=int(valid.sum()) * hk,
        pairs=pairs, rows_read=read).bound_ms()
    _paper_row(out, "fused_sparse_decode_attention", case, ms, bnd, err)
    d, f, ga, r = 2560, 1280, 4, 16
    rcfg = rf.RoutedFFNConfig(d_model=d, d_ff=8 * f, num_groups=8,
                              active_groups=ga, activation="relu",
                              gated=False)
    wts, lora = _ffn_weights(torch, gen, 8, d, f, r, bf16)
    del wts["w_gate"], lora["lora_gate"]
    x = torch.randn(b, d, device="cuda", generator=gen).to(bf16)
    router = torch.randn(d, 8, device="cuda", generator=gen) / d ** 0.5
    choice, gate, _ = rf.route(x[:, None], router, rcfg, need_aux=False)
    choice, gate = choice[:, 0].contiguous(), gate[:, 0].contiguous()
    args = (x, choice, gate, wts["w_inner"], wts["w_outer"], None, lora, 1.0)
    case = f"OPT-2.7B decode (x ({b}, {d}), F={f}, relu ungated, LoRA r={r})"
    y = _twice(torch, lambda: ffn_ops.decode_ffn(*args, act="relu"),
               f"decode_ffn {case}")
    err = close(y, ffn_ref.decode_ffn_ref(*args, act="relu"), BF16_TOL)
    ms = time_ms(lambda: ffn_ops.decode_ffn(*args, act="relu"), 30)
    lora16 = _bf16_lora(torch, lora)
    yard = time_ms(lambda: decode_ffn_yardstick(
        torch, x, choice, gate, wts, lora16, 1.0, act="relu"), 30)
    bnd = cost.decode_ffn(*args, act="relu", blocks=int(
        torch.unique(choice).numel())).bound_ms()
    _paper_row(out, "decode_ffn", case, ms, bnd, err, yard)
    return out


# The MoE widths (phase 3 rows and phase 14): (arch, d, F, act), 8
# experts, top 2, LoRA r = 16.
MOE_FFN = [("mixtral-8x22b", 6144, 16384, "silu"),
           ("grok-1-314b", 6144, 32768, "gelu")]


def check_moe_shapes(torch, gen):
    """Kernels 9 and 10 at expert granularity, at the MoE configs' widths
    (d 6144, F 16,384 SwiGLU and 32,768 GeGLU, 8 experts, top 2, LoRA r =
    16): kernel 10 at 8 decode slots routed by the softmax top-2 router,
    kernel 9 (its bf16 wide form) at the 4 x 1024 training rows with
    capacity factor 1.25; each launched twice bit-identically, against
    its plain version (kernel 9 by close_scaled's rule), timed beside its
    bound and the bf16 torch yardstick.  Kernel 10 in f32 also at d 1024 with F 16,384 (its output
    pass takes h in chunks there), and its f32 refusal at d 6144 (the
    limit ops.decode_ffn_max_d states).  Returns {wrapper name: [case
    rows]}."""
    from repro_torch import configs
    from repro_torch.kernels import cost
    from repro_torch.kernels.routed_ffn import ops as ffn_ops
    from repro_torch.kernels.routed_ffn import ref as ffn_ref
    from repro_torch.models import moe
    bf16 = torch.bfloat16
    out = {}
    for arch, d, f, act in MOE_FFN:
        cfg = configs.get_config(arch)
        e, k, r = cfg.num_experts, cfg.experts_per_token, 16
        wts, lora = _ffn_weights(torch, gen, e, d, f, r, bf16)
        b = 8
        x = torch.randn(b, d, device="cuda", generator=gen).to(bf16)
        router = torch.randn(d, e, device="cuda", generator=gen) / d ** 0.5
        choice, gate, _ = moe._route_experts({"router": router}, x[:, None],
                                             cfg)
        choice, gate = choice[:, 0].contiguous(), gate[:, 0].contiguous()
        args = (x, choice, gate, wts["w_inner"], wts["w_outer"],
                wts["w_gate"], lora, 1.0)
        blocks = int(torch.unique(choice).numel())
        case = (f"{arch} decode (x ({b}, {d}), top-{k} of {e} experts, "
                f"{blocks} touched, F={f}, {act} gated, LoRA r={r})")
        y = _twice(torch, lambda: ffn_ops.decode_ffn(*args, act=act),
                   f"decode_ffn {case}")
        err = close(y, ffn_ref.decode_ffn_ref(*args, act=act), BF16_TOL)
        ms = time_ms(lambda: ffn_ops.decode_ffn(*args, act=act), 20)
        plain = time_ms(lambda: ffn_ref.decode_ffn_ref(*args, act=act), 2)
        yard = time_ms(lambda: decode_ffn_yardstick(
            torch, x, choice, gate, wts, _bf16_lora(torch, lora), 1.0,
            act=act), 20)
        _paper_row(out, "decode_ffn", case, ms,
                   cost.decode_ffn(*args, act=act, blocks=blocks).bound_ms(),
                   err, yard, tag="moe")
        out["decode_ffn"][-1]["plain_ms"] = plain
        del y, args
        cs = _grouped_case(torch, gen, "bfloat16", b=TB, s=TS, d=d, f=f, g=e,
                           ga=k, r=r, capf=cfg.moe_capacity_factor, act=act,
                           gated=True, scaled=True)
        _, rel, past = cs["stats"]
        print(f"  [moe] grouped_ffn {arch}: relative Frobenius error "
              f"{rel:.3e}; {past} of {int(cs['plan'].slot_ok.sum()) * d} "
              f"kept outputs past atol = rtol = {BF16_TOL}", flush=True)
        gargs = cs["args"]
        ms = time_ms(lambda: ffn_ops.grouped_ffn(*gargs, act=act), 10)
        plain = time_ms(lambda: ffn_ref.grouped_ffn_ref(*gargs, act=act), 2)
        yard = time_ms(lambda: grouped_ffn_yardstick(
            torch, cs["x"], cs["plan"].index, cs["wts"],
            _bf16_lora(torch, cs["lora"]), 1.0, act=act), 10)
        bnd = _grouped_bound(cs)
        _paper_row(out, "grouped_ffn", f"{arch} train (x ({TB}, {TS}, {d}), "
                   f"F={f}, {act} gated, {e} experts top-{k}, C={cs['c']}, "
                   f"{int(cs['plan'].slot_ok.sum())} kept slots, LoRA "
                   f"r={r})", ms, bnd, cs["err"], yard, tag="moe")
        out["grouped_ffn"][-1].update(
            plain_ms=plain, rel_frobenius_err=rel, past_elementwise=past,
            rule=f"max-abs <= {BF16_TOL} x max |plain|, relative Frobenius "
                 "<= 2^-7")
        del cs, gargs, wts, lora
        _free(torch)
    # f32: h chunked in the output pass (F = 16,384 at d = 1024), and the
    # hidden pass's refusal past its shared memory (d = 6144)
    d, f, e = 1024, 16384, 8
    wts, lora = _ffn_weights(torch, gen, e, d, f, 16, torch.float32)
    x = torch.randn(8, d, device="cuda", generator=gen)
    choice = torch.stack([torch.randperm(e, device="cuda", generator=gen)[:2]
                          for _ in range(8)]).to(torch.int32)
    gate = torch.softmax(torch.randn(8, 2, device="cuda", generator=gen), -1)
    args = (x, choice, gate, wts["w_inner"], wts["w_outer"], wts["w_gate"],
            lora, 1.0)
    y = _twice(torch, lambda: ffn_ops.decode_ffn(*args, act="silu"),
               "decode_ffn f32 F=16384")
    err = close(y, ffn_ref.decode_ffn_ref(*args, act="silu"), F32_TOL)
    print(f"  [moe] decode_ffn f32 (x (8, {d}), F={f}: h in chunks): "
          f"max_abs_err {err:.3e}, bit-identical twice", flush=True)
    wide = torch.zeros(8, 6144, device="cuda")
    w6 = torch.zeros(2, 6144, 8, device="cuda")
    try:
        ffn_ops.decode_ffn(wide, choice % 2, gate, w6, w6.transpose(1, 2)
                           .contiguous(), act="relu")
    except ValueError as exc:
        print(f"  [moe] decode_ffn f32 at d=6144 refused: {exc}", flush=True)
    else:
        raise AssertionError("decode_ffn f32 at d=6144 was not refused")
    return out


# recurrentgemma-9b's training step (batch 4 x 1024) through its local
# attention: 16 query heads of 256 on 1 kv head (rep 16), M = 32 books,
# max_score 32 (kernel 2's SCORE_MAX), window 2048; and its FFN widths
# (d 4096, F = 12,288 / 8 groups = 1,536, GeGLU, LoRA r = 16).
HYB_HEADS, HYB_DH, HYB_M, HYB_WINDOW = 16, 256, 32, 2048
HYB_D, HYB_F = 4096, 1536


def check_hybrid_shapes(torch, gen):
    """Kernels 1, 2 and 4 at recurrentgemma-9b's training step (kernel 1
    on q and k, M = 32; kernel 2 at max_score 32 and rep 16; kernel 4 in
    bf16 at dh 256, rep 16, window 2048), kernel 4 also where the window
    binds (one row of 2,560 queries and keys, bf16 and f32), and kernels
    9 and 10 at its FFN widths (4 x 1024 training rows; 8 decode slots):
    each launched twice bit-identically, against its plain version
    (codes by the margin rule, [t, need] exactly), and timed by CUDA
    events beside its bound.  Returns {wrapper name: [case rows]}."""
    from repro_torch.core import routed_ffn as rf
    from repro_torch.kernels import cost
    from repro_torch.kernels.pq_quantize import ops as pq_ops
    from repro_torch.kernels.routed_ffn import ops as ffn_ops
    from repro_torch.kernels.routed_ffn import ref as ffn_ref
    from repro_torch.kernels.sparse_attention import ops as sa_ops
    from repro_torch.kernels.sparse_attention import ref as sa_ref
    from repro_torch.kernels.topl_select import ops as topl_ops
    from repro_torch.kernels.topl_select.ref import (masked_scores,
                                                     thresholds_ref)
    bf16 = torch.bfloat16
    out = {}
    hq, dh, m = HYB_HEADS, HYB_DH, HYB_M
    g, gk = TB * hq, TB
    cb = _codebooks(torch, gen, m, E_WORDS, 8)
    for what, groups in (("q", g), ("k", gk)):
        case = (f"recurrentgemma-9b train {what} (x ({groups}, {TS}, {dh}), "
                f"M={m})")
        x = torch.randn(groups, TS, dh, device="cuda", generator=gen).to(bf16)
        codes = _twice(torch, lambda: pq_ops.pq_assign(x, cb),
                       f"pq_assign {case}")
        flips, _ = _margin_flips(torch, codes, x, cb, case)
        ms = time_ms(lambda: pq_ops.pq_assign(x, cb), 30)
        yard = time_ms(lambda: pq_yardstick(torch, x, cb), 10)
        _paper_row(out, "pq_assign", case, ms, cost.pq_assign(x, cb).bound_ms(),
                   float(flips), yard, tag="hybrid")
    for label, b, n, dts in (("train", TB, TS, ("bfloat16",)),
                             ("window binds", 1, 2560,
                              ("bfloat16", "float32"))):
        gq, gkv = b * hq, b
        cq, ck = _train_codes(torch, gen, n, n, gq, gkv, m)
        sel = dict(causal=True, window=HYB_WINDOW, q_offset=0,
                   heads_per_batch=hq, rep=hq)
        kw = dict(l=_top_l(n, HYB_WINDOW), max_score=m, **sel)
        case = (f"recurrentgemma-9b {label} (G={gq}, n={n}, dh={dh}, M={m}, "
                f"R={hq}, window {HYB_WINDOW})")
        thr = _twice(torch, lambda: topl_ops.topl_thresholds(cq, ck, **kw),
                     f"topl_thresholds {case}")
        if not torch.equal(thr, thresholds_ref(cq, ck, **kw)):
            raise AssertionError(f"topl_thresholds {case}: [t, need] differ")
        sm = masked_scores(cq, ck, **sel)
        if label == "train":
            ms = time_ms(lambda: topl_ops.topl_thresholds(cq, ck, **kw), 30)
            _paper_row(out, "topl_thresholds", case, ms,
                       cost.topl_thresholds(cq, ck, **kw).bound_ms(), 0.0,
                       tag="hybrid")
        kept = sa_ref.newest_ties(sm, thr)
        del sm
        for dtn in dts:
            dt = getattr(torch, dtn)
            q = torch.randn(gq, n, dh, device="cuda", generator=gen).to(dt)
            k, v = (torch.randn(gkv, n, dh, device="cuda",
                                generator=gen).to(dt) for _ in range(2))
            akw = dict(scale=dh ** -0.5, **sel)
            got = _twice(torch, lambda: sa_ops.sparse_attention(
                q, k, v, cq, ck, thr, **akw), f"sparse_attention {dtn} {case}")
            err = close(got, sa_ref.sparse_attention_ref(
                q, k, v, cq, ck, thr, **akw),
                BF16_TOL if dt == bf16 else F32_TOL)
            if dt != bf16:
                print(f"  [hybrid] sparse_attention {dtn} {case}: max_abs_err "
                      f"{err:.3e}; bit-identical twice", flush=True)
                continue
            ms = time_ms(lambda: sa_ops.sparse_attention(
                q, k, v, cq, ck, thr, **akw), 20)
            rows = kept.reshape(gkv, hq * n, n).any(1)
            bnd = cost.sparse_attention(
                q, k, v, cq, ck, thr, **akw, pairs=int(kept.sum()),
                rows_read=int(rows.sum())).bound_ms()
            _paper_row(out, "sparse_attention", f"{case} {dtn}", ms, bnd,
                       err, tag="hybrid")
        del kept
    cs = _grouped_case(torch, gen, "bfloat16", b=TB, s=TS, d=HYB_D, f=HYB_F,
                       g=8, ga=4, r=16, capf=1.25, act="gelu", gated=True)
    args = cs["args"]
    ms = time_ms(lambda: ffn_ops.grouped_ffn(*args, act="gelu"), 10)
    lora16 = _bf16_lora(torch, cs["lora"])
    yard = time_ms(lambda: grouped_ffn_yardstick(
        torch, cs["x"], cs["plan"].index, cs["wts"], lora16, 1.0,
        act="gelu"), 10)
    _paper_row(out, "grouped_ffn", f"recurrentgemma-9b train (x (4, 1024, "
               f"{HYB_D}), F={HYB_F}, GeGLU, C={cs['c']}, LoRA r=16)", ms,
               _grouped_bound(cs), cs["err"],
               yard, tag="hybrid")
    b, d, f, ga, r = 8, HYB_D, HYB_F, 4, 16
    rcfg = rf.RoutedFFNConfig(d_model=d, d_ff=8 * f, num_groups=8,
                              active_groups=ga, activation="gelu",
                              gated=True)
    wts, lora = _ffn_weights(torch, gen, 8, d, f, r, bf16)
    x = torch.randn(b, d, device="cuda", generator=gen).to(bf16)
    router = torch.randn(d, 8, device="cuda", generator=gen) / d ** 0.5
    choice, gate, _ = rf.route(x[:, None], router, rcfg, need_aux=False)
    choice, gate = choice[:, 0].contiguous(), gate[:, 0].contiguous()
    args = (x, choice, gate, wts["w_inner"], wts["w_outer"], wts["w_gate"],
            lora, 1.0)
    case = f"recurrentgemma-9b decode (x ({b}, {d}), F={f}, GeGLU, LoRA r={r})"
    y = _twice(torch, lambda: ffn_ops.decode_ffn(*args, act="gelu"),
               f"decode_ffn {case}")
    err = close(y, ffn_ref.decode_ffn_ref(*args, act="gelu"), BF16_TOL)
    ms = time_ms(lambda: ffn_ops.decode_ffn(*args, act="gelu"), 30)
    lora16 = _bf16_lora(torch, lora)
    yard = time_ms(lambda: decode_ffn_yardstick(
        torch, x, choice, gate, wts, lora16, 1.0, act="gelu"), 30)
    bnd = cost.decode_ffn(*args, act="gelu", blocks=int(
        torch.unique(choice).numel())).bound_ms()
    _paper_row(out, "decode_ffn", case, ms, bnd, err, yard, tag="hybrid")
    return out


# The three families' new contract points: whisper-base's encoder (4 x 8
# heads, 1500 x 1500 frames, dh 64, M 8, non-causal) and its
# cross-attention (448 decoder rows over the 1500 frames, non-causal, nq
# != nk); phi-3-vision-4.2b's training step (4 x 1024 positions, 32 heads
# of 96, M 12, causal); their FFN widths (label, d, F = d_ff / 8, act,
# gated, training rows a batch row): phi-3 d 3072, F 1024 SwiGLU (kernel
# 9's wide form) at 1024 positions, whisper d 512, F 256 GELU ungated
# (its resident body) at the encoder's 1500 frames; and the decode
# kernels at phi-3's serving width (8 slots x 32 kv heads, R = 1, dh 96,
# M 12, a 32 x 128 view with 2048 live slots) and at whisper's decoder
# self-attention (8 slots x 8 heads, dh 64, M 8, 68 live slots of one
# page).
WH_HEADS, WH_DH, WH_FRAMES, WH_DEC = 8, 64, 1500, 448
PHI_HEADS, PHI_DH = 32, 96
FAMILY_ATTN = [  # (label, heads, dh, nq, nk, causal, dtypes)
    ("whisper-base encoder", WH_HEADS, WH_DH, WH_FRAMES, WH_FRAMES, False,
     ("bfloat16", "float32")),
    ("whisper-base cross", WH_HEADS, WH_DH, WH_DEC, WH_FRAMES, False,
     ("bfloat16", "float32")),
    ("phi-3-vision-4.2b train", PHI_HEADS, PHI_DH, TS, TS, True,
     ("bfloat16",)),
]
FAMILY_FFN = [("phi-3-vision-4.2b", 3072, 1024, "silu", True, TS),
              ("whisper-base", 512, 256, "gelu", False, WH_FRAMES)]
FAMILY_EDGES = [
    ("R=1 dh=96 M=12 (phi-3-vision-4.2b: 8 slots x 32 kv heads)", 8, 32, 1,
     96, "qhead", False, False, 12),
    ("R=1 dh=96 M=12 l >= live", 2, 8, 1, 96, "qhead", True, True, 12),
    ("R=1 dh=64 M=8, 68 live of one page (whisper-base decoder: 8 slots x "
     "8 heads)", 8, 8, 1, 64, "qhead", False, True, 8, (1, 68)),
]


def check_family_shapes(torch, gen):
    """Kernels 1, 2 and 4 on FAMILY_ATTN (kernel 1 on the queries, and on
    the keys where nq != nk; kernel 4 in each dtype listed), kernels 9
    and 10 at FAMILY_FFN (4 x rows training batches; 8 decode slots):
    each launched twice bit-identically, against its plain version
    (codes by the margin rule, [t, need] exactly), and timed by CUDA
    events beside its bound (kernels 1, 9 and 10 also beside their torch
    yardsticks).  Returns {wrapper name: [case rows]}."""
    from repro_torch.core import routed_ffn as rf
    from repro_torch.kernels import cost
    from repro_torch.kernels.pq_quantize import ops as pq_ops
    from repro_torch.kernels.routed_ffn import ops as ffn_ops
    from repro_torch.kernels.routed_ffn import ref as ffn_ref
    from repro_torch.kernels.sparse_attention import ops as sa_ops
    from repro_torch.kernels.sparse_attention import ref as sa_ref
    from repro_torch.kernels.topl_select import ops as topl_ops
    from repro_torch.kernels.topl_select.ref import (masked_scores,
                                                     thresholds_ref)
    bf16, tag = torch.bfloat16, "families"
    out = {}
    for label, heads, dh, nq, nk, causal, dts in FAMILY_ATTN:
        g, m = TB * heads, dh // 8
        cb = _codebooks(torch, gen, m, E_WORDS, 8)
        for what, n in (("q", nq), ("k", nk))[:1 if nq == nk else 2]:
            case = f"{label} {what} (x ({g}, {n}, {dh}), M={m})"
            x = torch.randn(g, n, dh, device="cuda", generator=gen).to(bf16)
            codes = _twice(torch, lambda: pq_ops.pq_assign(x, cb),
                           f"pq_assign {case}")
            flips, _ = _margin_flips(torch, codes, x, cb, case)
            ms = time_ms(lambda: pq_ops.pq_assign(x, cb), 30)
            yard = time_ms(lambda: pq_yardstick(torch, x, cb), 10)
            _paper_row(out, "pq_assign", case, ms,
                       cost.pq_assign(x, cb).bound_ms(), float(flips), yard,
                       tag=tag)
        cq, ck = _train_codes(torch, gen, nq, nk, g, g, m)
        sel = dict(causal=causal, window=None, q_offset=0,
                   heads_per_batch=heads, rep=1)
        kw = dict(l=_top_l(nk), max_score=m, **sel)
        case = (f"{label} (G={g}, nq={nq}, nk={nk}, dh={dh}, M={m}, R=1, "
                f"{'causal' if causal else 'non-causal'})")
        thr = _twice(torch, lambda: topl_ops.topl_thresholds(cq, ck, **kw),
                     f"topl_thresholds {case}")
        if not torch.equal(thr, thresholds_ref(cq, ck, **kw)):
            raise AssertionError(f"topl_thresholds {case}: [t, need] differ")
        sm = masked_scores(cq, ck, **sel)
        ms = time_ms(lambda: topl_ops.topl_thresholds(cq, ck, **kw), 30)
        _paper_row(out, "topl_thresholds", case, ms,
                   cost.topl_thresholds(cq, ck, **kw).bound_ms(), 0.0,
                   tag=tag)
        kept = sa_ref.newest_ties(sm, thr)
        del sm
        for dtn in dts:
            dt = getattr(torch, dtn)
            q = torch.randn(g, nq, dh, device="cuda", generator=gen).to(dt)
            k, v = (torch.randn(g, nk, dh, device="cuda",
                                generator=gen).to(dt) for _ in range(2))
            akw = dict(scale=dh ** -0.5, **sel)
            got = _twice(torch, lambda: sa_ops.sparse_attention(
                q, k, v, cq, ck, thr, **akw), f"sparse_attention {dtn} {case}")
            err = close(got, sa_ref.sparse_attention_ref(
                q, k, v, cq, ck, thr, **akw),
                BF16_TOL if dt == bf16 else F32_TOL)
            if dt != bf16:
                print(f"  [{tag}] sparse_attention {dtn} {case}: max_abs_err "
                      f"{err:.3e}; bit-identical twice", flush=True)
                continue
            ms = time_ms(lambda: sa_ops.sparse_attention(
                q, k, v, cq, ck, thr, **akw), 20)
            bnd = cost.sparse_attention(
                q, k, v, cq, ck, thr, **akw, pairs=int(kept.sum()),
                rows_read=int(kept.any(1).sum())).bound_ms()
            _paper_row(out, "sparse_attention", f"{case} {dtn}", ms, bnd,
                       err, tag=tag)
        del kept
    for label, d, f, act, gated, rows in FAMILY_FFN:
        cs = _grouped_case(torch, gen, "bfloat16", b=TB, s=rows, d=d, f=f,
                           g=8, ga=4, r=16, capf=1.25, act=act, gated=gated)
        args = cs["args"]
        ms = time_ms(lambda: ffn_ops.grouped_ffn(*args, act=act), 10)
        lora16 = _bf16_lora(torch, cs["lora"])
        yard = time_ms(lambda: grouped_ffn_yardstick(
            torch, cs["x"], cs["plan"].index, cs["wts"], lora16, 1.0,
            act=act), 10)
        form = "gated" if gated else "ungated"
        _paper_row(out, "grouped_ffn", f"{label} train (x ({TB}, {rows}, "
                   f"{d}), F={f}, {act} {form}, C={cs['c']}, LoRA r=16)", ms,
                   _grouped_bound(cs),
                   cs["err"], yard, tag=tag)
        b, ga, r = 8, 4, 16
        rcfg = rf.RoutedFFNConfig(d_model=d, d_ff=8 * f, num_groups=8,
                                  active_groups=ga, activation=act,
                                  gated=gated)
        wts, lora = _ffn_weights(torch, gen, 8, d, f, r, bf16)
        if not gated:
            del wts["w_gate"], lora["lora_gate"]
        x = torch.randn(b, d, device="cuda", generator=gen).to(bf16)
        router = torch.randn(d, 8, device="cuda", generator=gen) / d ** 0.5
        choice, gate, _ = rf.route(x[:, None], router, rcfg, need_aux=False)
        choice, gate = choice[:, 0].contiguous(), gate[:, 0].contiguous()
        args = (x, choice, gate, wts["w_inner"], wts["w_outer"],
                wts.get("w_gate"), lora, 1.0)
        case = f"{label} decode (x ({b}, {d}), F={f}, {act} {form}, LoRA r={r})"
        y = _twice(torch, lambda: ffn_ops.decode_ffn(*args, act=act),
                   f"decode_ffn {case}")
        err = close(y, ffn_ref.decode_ffn_ref(*args, act=act), BF16_TOL)
        ms = time_ms(lambda: ffn_ops.decode_ffn(*args, act=act), 30)
        lora16 = _bf16_lora(torch, lora)
        yard = time_ms(lambda: decode_ffn_yardstick(
            torch, x, choice, gate, wts, lora16, 1.0, act=act), 30)
        bnd = cost.decode_ffn(*args, act=act, blocks=int(
            torch.unique(choice).numel())).bound_ms()
        _paper_row(out, "decode_ffn", case, ms, bnd, err, yard, tag=tag)
    return out


# ------------------------------------------------------------ phases 4-6
def _perturbed_model(torch, cfg, seed):
    """Random full-width weights from a seed (an EncDecLM for the audio
    family); LoRA c leaves (zero at init) get small values so the LoRA
    halves of the kernels do work."""
    from repro_torch.models import encdec, transformer
    cls = encdec.EncDecLM if cfg.family == "audio" else transformer.LM
    model = cls.init(cfg, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".c"):
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * 0.01)
    return model


def _requests(n, lo, hi, gen_tokens, vocab, seed, frontend=None):
    """n requests with prompts of lo-hi tokens from numpy ``seed``; with
    ``frontend`` = (F, d), each also carries F standard-normal frontend
    rows from a second seeded stream (the prompts stay those of the
    seed)."""
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    reqs = [Request(uid=i, tokens=rng.integers(0, vocab, size=int(
        rng.integers(lo, hi + 1))).tolist(), max_new_tokens=gen_tokens)
        for i in range(n)]
    if frontend is not None:
        frng = np.random.default_rng(seed + 1000)
        for r in reqs:
            r.frontend_embeds = frng.standard_normal(frontend).astype(
                np.float32)
    return reqs


def _frontend(cfg):
    """(F, d) of a VLM's frontend rows, or None."""
    if not cfg.frontend or cfg.family == "audio":
        return None
    return (cfg.frontend_tokens, cfg.d_model)


SERVE_CFG = dict(attn_impl="pallas", ffn_impl="pallas")
PAGED = dict(kv_layout="paged", kv_page_size=128)
PAGED_POOL = 64          # pages of 128: a quarter of 8 slots x 4096 rows
# The serve loop is host-bound (a decode step's wall time grows with its
# launches, ~200 a layer), so the script's longest paths cut depth, at
# full width, to keep the whole run well inside its time limit: qwen3-0.6b
# 28 -> 7 layers in phases 26-28 (phase 4 keeps all 28), -> 14 in phase
# 24 and -> 4 in phase 5 (28 and 7 until phase 28 came) and in phase 12
# (7 until phase 27 came),
# opt-2.7b and llama-2.7b 32 -> 4 in phase 10, phi-3-vision-4.2b 32 -> 4
# in phase 19 (16 each until phase 25 came, 8 until its model shards
# came)
CUT_DEPTH = 7
PAGED_DEPTH = 4
SERVER_DEPTH = 4
PAPER_DEPTH = 4
PHI_DEPTH = 4
# serve workloads (requests, prompt lengths lo-hi from numpy seed 2, new
# tokens, max_len) on 8 slots, decode chunks of 16: phases 4-5, and the
# paper's OPT-2.7B in phase 10
PHASE4_WORK = dict(n=16, lo=128, hi=2048, gen=64, max_len=4096)
PAPER_WORK = dict(n=8, lo=128, hi=1024, gen=32, max_len=2048)


def _serve(torch, model, cfg, label, kv_pages=None, work=PHASE4_WORK,
           serve_api=False):
    """Engine.run of a workload (phase 4's by default: 16 requests,
    prompts 128-2048, 64 new tokens, 8 slots, max_len 4096) after a
    warm-up run — with ``serve_api``, Engine.serve of the same burst —
    the launch counters zeroed just before and read just after.  Checks
    that every request completes and that the decode and prefill kernels
    of the path launched as _want_serve_launches says; returns the
    launch counts and the stats."""
    from repro_torch import kernels
    from repro_torch.core.params import count_params
    from repro_torch.models.transformer import lm_defs
    from repro_torch.serving.engine import ArrivalSchedule, Engine
    eng = Engine(cfg, model, max_len=work["max_len"], num_slots=8,
                 decode_chunk=16, kv_pages=kv_pages)
    fe = _frontend(cfg)
    eng.run(_requests(2, 16, 32, 4, cfg.vocab_size, seed=1,
                      frontend=fe))                              # warm-up
    reqs = _requests(work["n"], work["lo"], work["hi"], work["gen"],
                     cfg.vocab_size, seed=2, frontend=fe)
    if work.get("long"):              # the last prompt replaced by a long one
        reqs[-1] = _requests(1, work["long"], work["long"], work["gen"],
                             cfg.vocab_size, seed=3, frontend=fe)[0]
        reqs[-1].uid = work["n"] - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = kernels.wrappers()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    outs = (eng.serve(ArrivalSchedule.burst(reqs)) if serve_api
            else eng.run(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    st = eng.last_stats
    for c in outs:
        if len(c.tokens) != work["gen"] or not all(
                0 <= t < cfg.padded_vocab for t in c.tokens):
            raise AssertionError(f"request {c.uid}: {len(c.tokens)} tokens "
                                 f"({c.finish_reason})")
    if eng.last_steps_run != st.decode_steps:     # no EOS: no dead steps
        raise AssertionError(f"{label}: {eng.last_steps_run} steps run, "
                             f"{st.decode_steps} with a slot active")
    want = _want_serve_launches(cfg, launches, eng.last_steps_run,
                                st.prefill_batches)
    if launches != want:
        raise AssertionError(f"{label} launches {launches} != expected {want}")
    if kv_pages is not None and not (0 < st.kv_pages_peak <= kv_pages
                                     and st.kv_pages_total == kv_pages):
        raise AssertionError(f"{label}: peak {st.kv_pages_peak} of "
                             f"{st.kv_pages_total} pages")
    stats = {"params": count_params(lm_defs(cfg)),
             "requests": len(reqs), "wall_s": wall,
             "prefill_tok_s": st.prefill_tok_s, "decode_tok_s": st.decode_tok_s,
             "ttft_avg_s": st.ttft_avg_s, "ttft_max_s": st.ttft_s_max,
             "prefill_tokens": st.prefill_tokens, "decode_tokens": st.decode_tokens,
             "decode_steps": st.decode_steps, "prefill_batches": st.prefill_batches,
             "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if kv_pages is not None:
        stats.update(page_size=st.page_size, kv_pages_total=st.kv_pages_total,
                     kv_pages_peak=st.kv_pages_peak,
                     admission_stalls=st.admission_stalls)
    print(f"  {label} " + json.dumps(stats), flush=True)
    print(f"  {label} ServeStats " + json.dumps(st.as_dict()), flush=True)
    print(f"  {label} launches " + json.dumps(launches), flush=True)
    return launches, stats


def _layer_kinds(cfg):
    """The block kind of every layer: the pattern units', then the
    tail's."""
    from repro_torch.models import transformer
    return (cfg.pattern * transformer.num_units(cfg)
            + transformer._tail_kinds(cfg))


def _want_serve_launches(cfg, launches, steps, prefill_batches,
                         split=False):
    """The launches a serve must make: each executed decode step runs its
    tier's decode kernels once per attention layer (kernels 3 and 5
    whatever the tier where the caches' sequence splits over the model
    axis: ``split``) and the decode FFN (routed or MoE) once per layer
    (every block kind has an FFN); each prefill batch (resume re-prefills
    included) the grouped FFN once per layer.
    The ragged prefill takes the oracle attention (as in JAX), so the
    train-path attention kernels stay idle.  An ``ssd`` block has neither
    attention nor an FFN: it launches nothing."""
    from repro_torch.core import dispatch
    kinds = _layer_kinds(cfg)
    layers = sum(k != "ssd" for k in kinds)          # layers with an FFN
    attn_layers = kinds.count("attn")
    if split:
        decode_attn = ["decode_topl_thresholds", "sparse_decode_attention"]
    elif (dispatch.use_paged_kv(cfg)
          and dispatch.use_paged_native_decode(cfg)):
        decode_attn = (["fused_sparse_decode_attention_paged"]
                       if cfg.spt.sparse_mha
                       else ["dense_decode_attention_paged"])
    elif dispatch.use_fused_decode_attn(cfg):
        decode_attn = ["fused_sparse_decode_attention"]
    else:
        decode_attn = ["decode_topl_thresholds", "sparse_decode_attention"]
    want = {name: 0 for name in launches}
    want.update({name: attn_layers * steps for name in decode_attn})
    want.update({"grouped_ffn": layers * prefill_batches,
                 "decode_ffn": layers * steps})
    return want


def serve_full_width(torch):
    from repro_torch import configs
    cfg = configs.get_config("qwen3-0.6b").with_spt(**SERVE_CFG)
    model = _perturbed_model(torch, cfg, seed=0)
    launches, _ = _serve(torch, model, cfg, "serve")
    decode_step_split(torch, model, cfg)
    return launches


def serve_paged(torch):
    """Phase 5: the phase-4 serve, depth cut to PAGED_DEPTH layers, on the
    paged layout with a 64-page pool: sparse MHA on through the page
    table (kernel 7); the two-pass tier over gathered views (kernels 3
    and 5); sparse MHA off (kernel 8, a model without PQ codebooks from
    the same seed)."""
    from repro_torch import configs
    _free(torch)
    base = dataclasses.replace(configs.get_config("qwen3-0.6b"),
                               num_layers=PAGED_DEPTH)
    base = base.with_spt(**SERVE_CFG, **PAGED)
    model = _perturbed_model(torch, base, seed=0)
    launches = {"serve_paged": _serve(torch, model, base, "paged serve",
                                      kv_pages=PAGED_POOL)[0]}
    decode_step_split(torch, model, base, paged=True)
    launches["serve_paged_two_pass"] = _serve(
        torch, model, base.with_spt(kv_paged_native="gather",
                                    decode_attn_fuse="two_pass"),
        "paged gathered two-pass serve", kv_pages=PAGED_POOL)[0]
    dense_cfg = base.with_spt(sparse_mha=False)
    dense = _perturbed_model(torch, dense_cfg, seed=0)
    launches["serve_paged_dense"] = _serve(torch, dense, dense_cfg,
                                           "paged dense serve",
                                           kv_pages=PAGED_POOL)[0]
    del model, dense
    _free(torch)
    return launches


def decode_step_split(torch, model, cfg, paged=False):
    """Device vs wall time of one full-width decode step (8 slots, 2048 of
    4096 cache slots live, or a full SWA ring where the window is
    shorter; paged: the live pages shuffled over a 256-page pool): how
    far the host holds the card back.  Device time is
    the profiler's sum of kernel times (CUDA events cannot hide the host
    here: a step issues more launches than the launch queue holds)."""
    from repro_torch.models import transformer
    from repro_torch.serving import kv_pages
    pos = torch.full((8,), 2047, device="cuda")
    tok = torch.zeros(8, dtype=torch.long, device="cuda")
    if paged:
        ps = cfg.spt.kv_page_size
        mp = 4096 // ps
        caches = transformer.init_caches(cfg, 8, 4096, "cuda", kv_pages=8 * mp)
        gen = torch.Generator(device="cuda").manual_seed(5)
        ids = torch.randperm(8 * mp, device="cuda", generator=gen)
        held = torch.arange(mp, device="cuda")[None] <= 2047 // ps
        pt = torch.where(held, ids.reshape(8, mp), -1).to(torch.int32)
        valid = ((torch.arange(4096, device="cuda")[None, :] <= pos[:, None])
                 & kv_pages.occupancy(pt, ps))
        label = "paged decode step (8 slots, view 32 x 128)"
    else:
        s = min(4096, cfg.window or 4096)
        caches = transformer.init_caches(cfg, 8, 4096, "cuda")
        pt = None
        valid = torch.arange(s, device="cuda")[None, :] <= pos[:, None]
        label = f"decode step (8 slots, S={s})"
        if cfg.window is not None:  # a ring derives validity from slot_pos
            for part in caches.values():
                for blk in part.values():
                    if "slot_pos" in blk:
                        sp = blk["slot_pos"]
                        sp.copy_(torch.where(valid, torch.arange(
                            s, device="cuda"), -1).expand_as(sp))

    def step():
        transformer.lm_decode_step(model, cfg, caches, tok, pos,
                                   kv_valid=valid, page_table=pt)
    _step_split(torch, label, step)


def _step_split(torch, label, step):
    """Wall time of step() (5 synced runs) beside the profiler's sum of
    its kernel times (3 runs), and its top kernels."""
    from torch.profiler import ProfilerActivity, profile
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
        print(f"  {label}: wall {wall:.2f} ms; device time not measured (the "
              "profiler saw no device activity)", flush=True)
        return
    print(f"  {label}: device {device:.2f} ms in "
          f"{sum(r[1] for r in rows):.0f} kernels, wall {wall:.2f} ms, "
          f"device busy {device / wall:.0%}", flush=True)
    for ms, n, name in rows[:8]:
        print(f"    {ms:8.3f} ms  x{n:5.0f}  {name[:90]}", flush=True)


# the decode tiers of phase 6: (config switches, kernels that must launch)
TIERS = {
    "contiguous fused": ({}, {"fused_sparse_decode_attention"}),
    "contiguous two-pass": ({"decode_attn_fuse": "two_pass"},
                            {"decode_topl_thresholds",
                             "sparse_decode_attention"}),
    "paged native": (PAGED, {"fused_sparse_decode_attention_paged"}),
    "paged gathered two-pass": (dict(PAGED, kv_paged_native="gather",
                                     decode_attn_fuse="two_pass"),
                                {"decode_topl_thresholds",
                                 "sparse_decode_attention"}),
}
DECODE_KERNELS = {"fused_sparse_decode_attention", "decode_topl_thresholds",
                  "sparse_decode_attention",
                  "fused_sparse_decode_attention_paged",
                  "dense_decode_attention_paged"}


def _streams(torch, model, cfg, reqs, kernels_on, max_len=1024):
    """Greedy streams of reqs (4 slots, chunks of 8), with the kernels or
    under REPRO_DISABLE_KERNELS=1; and the decode kernels that launched."""
    from repro_torch import kernels
    from repro_torch.serving.engine import Engine
    if not kernels_on:
        os.environ["REPRO_DISABLE_KERNELS"] = "1"
    try:
        before = {w.__name__: w.launches for w in kernels.wrappers()}
        eng = Engine(cfg, model, max_len=max_len, num_slots=4, decode_chunk=8)
        out = [c.tokens for c in eng.run(reqs)]
        torch.cuda.synchronize()
        ran = {w.__name__ for w in kernels.wrappers()
               if w.launches != before[w.__name__]}
    finally:
        os.environ.pop("REPRO_DISABLE_KERNELS", None)
    return out, ran & DECODE_KERNELS


# A discrete choice that float-order noise can flip: a PQ code (the nearest
# of E codewords, core.pq.assign) or a routed FFN's groups (the top G' by
# |logit|, routed_ffn.route).  A kernels-vs-oracle stream whose first
# divergent token is no logit near-tie passes only past such a flip: the
# first choice in which the request's row differs between the two runs,
# made no later than in the forward of that token, whose two candidates'
# scores on the kernel run's own inputs (squared distances, |logits|) lie
# within SELECT_TIE: F32_TOL, the error each kernel call is held to.
SELECT_TIE = F32_TOL
_CHOICES = []                  # the active _ChoiceLog (at most one)


class _ChoiceLog:
    """The PQ codes and routed groups of one serve, call by call, rows
    first (``calls``); the rows of the Engine forward under way (``rows``:
    per row None or (uid, index of the first token the row's choices
    feed), plus ``step`` inside a decode chunk); and, checked against the
    oracle's log ``want``, each request's first differing choice
    (``first``: uid -> (token index, margin on this run's inputs, kind)).
    Calls outside a forward, or while ``paused``, are not logged."""

    def __init__(self, want=None):
        self.want, self.calls, self.first = want, [], {}
        self.rows, self.step, self.paused = None, 0, 0

    def note(self, kind, choices, margin):
        """Log one call's choices; with ``want``, compare them with its
        call there and keep each newly differing request's first flip,
        ``margin(row, oracle's choices of the row, where they differ)``."""
        import torch
        if self.rows is None or self.paused:
            return
        ch = choices.reshape(choices.shape[0], -1).to(torch.int16)
        i = len(self.calls)
        self.calls.append((kind, tuple(ch.shape),
                           ch if self.want is None else None))
        if self.want is None:
            return
        if (i >= len(self.want.calls)
                or self.want.calls[i][:2] != (kind, tuple(ch.shape))):
            raise AssertionError(f"choice call {i} ({kind} {tuple(ch.shape)})"
                                 " has no counterpart in the oracle's run")
        other = self.want.calls[i][2]
        diff = ch != other
        for r in diff.any(-1).nonzero().flatten().tolist():
            row = self.rows[r] if r < len(self.rows) else None
            if row is None or row[0] in self.first:
                continue
            self.first[row[0]] = (row[1] + self.step,
                                  margin(r, other[r].long(), diff[r]), kind)


@contextlib.contextmanager
def _choices(torch, want=None):
    """While active, every PQ code assignment and routed-FFN group choice
    made inside an Engine forward is logged (a prefill group's rows are
    its requests, resumed ones from their next token on; a decode step's
    rows are the slots' requests).  Without ``want`` (the oracle's run)
    it yields the log; with it (the kernel run), a log checked against
    ``want`` whose ``first`` is what _judge_flip reads."""
    from repro_torch.core import pq, routed_ffn
    from repro_torch.kernels.routed_ffn import ops as rffn_ops
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine
    log = _ChoiceLog(want)
    assign, route = pq.assign, routed_ffn.route
    chunk, group = Engine._chunk, Engine._prefill_group
    decode_step = transformer.lm_decode_step

    def assign_(x, codebooks):
        codes = assign(x, codebooks)

        def margin(r, other, diff):
            d = pq.distances(x[r], codebooks).reshape(
                -1, codebooks.shape[1])
            mine = codes[r].reshape(-1, 1).long()
            gap = d.gather(1, other[:, None]) - d.gather(1, mine)
            return float(gap[:, 0][diff].max())
        log.note("PQ code", codes, margin)
        return codes

    def route_(x, router_w, *a, **k):
        out = route(x, router_w, *a, **k)
        mine = torch.sort(out[0].long(), dim=-1).values

        def margin(r, other, diff):
            score = (x[r].float() @ router_w.float()).abs()
            score = score.reshape(-1, score.shape[-1])
            own = mine[r].reshape(score.shape[0], -1)
            theirs = other.reshape(own.shape)
            gap = (score.gather(1, own).amin(1)
                   - score.gather(1, theirs).amin(1))
            return float(gap[diff.reshape(own.shape).any(1)].max())
        log.note("routed groups", mine, margin)
        return out

    def chunk_(self, steps, plan):
        st = self._live
        log.rows = [(it.req.uid, int(st.n_gen[b]))
                    if it is not None and st.active[b] else None
                    for b, it in ((b, st.slot_item[b]) for b in
                                  range(self._lo, self._lo + self._ns))]
        log.step = -1
        try:
            return chunk(self, steps, plan)
        finally:
            log.rows = None

    def group_(self, items, p, bpb):
        log.rows = ([(it.req.uid, len(it.done)) for it in items]
                    + [None] * (bpb - len(items)))
        log.step = 0
        try:
            return group(self, items, p, bpb)
        finally:
            log.rows = None

    def decode_step_(*a, **k):
        log.step += 1
        return decode_step(*a, **k)
    patches = [(pq, "assign", assign_), (routed_ffn, "route", route_),
               (rffn_ops, "route", route_), (Engine, "_chunk", chunk_),
               (Engine, "_prefill_group", group_),
               (transformer, "lm_decode_step", decode_step_)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    _CHOICES.append(log)
    try:
        yield log
    finally:
        _CHOICES.pop()
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def _judge_flip(gap, ties, uid, t, what):
    """How request uid's first divergence (at token t, the oracle's
    replayed logit gap ``gap``) is excused: "logit" when gap <= 1e-3;
    else "choice" when ``ties`` (a kernel run's _ChoiceLog.first) holds
    the request's first differing choice, fed into token t or an earlier
    one and within SELECT_TIE.  Anything else raises."""
    if gap <= 1e-3:
        return "logit"
    tie = (ties or {}).get(uid)
    if tie is not None and tie[0] <= t and tie[1] <= SELECT_TIE:
        return "choice"
    raise AssertionError(f"{what} diverged at token {t} with a logit gap "
                         f"{gap:.3e}; its first differing choice (token, "
                         f"margin, kind): {tie}")


def _flip_note(kinds, ties):
    """The accepted flips of a comparison, for its printed line."""
    n = sum(k == "choice" for k in kinds.values())
    note = (f"{len(kinds) - n} replayed logit near-tie flips (<= 1e-3), "
            f"{n} choice near-tie flips "
            f"(<= {SELECT_TIE:g} on the kernel run's inputs)")
    if ties is not None:
        firsts = ", ".join(f"{u}: token {t}, {k} margin {m:.3e}"
                           for u, (t, m, k) in sorted(ties.items()))
        note += f"; each request's first differing choice: {{{firsts}}}"
    return note


def _compare_streams(torch, model, cfg, reqs, name, got, want, max_len=1024,
                     ties=None):
    """got == want per request, except past a near-tie at the first
    divergence: of the logits (<= 1e-3), replayed through the oracle's
    ragged prefill, or of a choice (``ties``: _judge_flip)."""
    from repro_torch.models import transformer
    os.environ["REPRO_DISABLE_KERNELS"] = "1"
    kinds = {}
    try:
        for req, g, w in zip(reqs, got, want):
            if g == w:
                continue
            t = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
            ctx = list(req.tokens) + w[:t]
            batch = {"tokens": torch.tensor([ctx], device="cuda")}
            n = len(ctx)
            if req.frontend_embeds is not None:       # a VLM's rows first
                batch["frontend_embeds"] = torch.as_tensor(
                    req.frontend_embeds, device="cuda")[None]
                n += req.frontend_embeds.shape[0]
            with torch.no_grad():
                _, logits = transformer.lm_prefill_ragged(
                    model, cfg, batch, torch.tensor([n], device="cuda"),
                    max_len)
            lg = logits[0, -1].float().cpu().numpy()
            gap = float(lg.max()) - min(float(lg[g[t]]), float(lg[w[t]]))
            kinds[req.uid] = _judge_flip(gap, ties, req.uid, t,
                                         f"{name}: request {req.uid}")
    finally:
        os.environ.pop("REPRO_DISABLE_KERNELS", None)
    print(f"  f32 greedy streams, {name} == REPRO_DISABLE_KERNELS=1 "
          f"for {len(reqs) - len(kinds)}/{len(reqs)} requests, "
          f"{_flip_note(kinds, ties)}", flush=True)


def _gated_streams(torch, model, cfg, reqs, got, oracle, errs, ties,
                   name, max_len=1024):
    """A kernels-vs-oracle serve at the config's top-L: ``got`` (the
    kernels, every call of theirs held to its plain version: ``errs``,
    its choices checked against the oracle's: ``ties``) and ``oracle``
    equal up to the near-tie rules (_compare_streams); then the same with
    every key selected (top fraction 1), where no top-L choice can turn
    the kernels' float-order differences upstream into a logit gap, up
    to the logit rule alone."""
    print(f"  {name}: kernels 6, 9, 10 = their plain versions on the inputs "
          f"of each of their {len(errs)} calls (max abs err "
          f"{max(errs):.3e}, rule {F32_TOL})", flush=True)
    _compare_streams(torch, model, cfg, reqs,
                     f"{name}, top-L {cfg.spt.attn_top_fraction:g}", got,
                     oracle, max_len=max_len, ties=ties)
    top1 = cfg.with_spt(attn_top_fraction=1.0)
    got1, _ = _streams(torch, model, top1, reqs, True, max_len=max_len)
    oracle1, _ = _streams(torch, model, top1, reqs, False, max_len=max_len)
    _compare_streams(torch, model, top1, reqs, f"{name}, top-L 1", got1,
                     oracle1, max_len=max_len)


def _tier_agreement(torch, model, base, reqs, tiers):
    """Each decode tier's streams against the oracle's; each tier launches
    its decode kernels and no other, and the kernel tiers give the first
    tier's streams exactly (bit-identical kernels over a deterministic
    prefill)."""
    oracle, ran = _streams(torch, model, base, reqs, False)
    if ran:
        raise AssertionError(f"the oracle launched {ran}")
    first = None
    for name in tiers:
        spt, must = TIERS[name]
        got, ran = _streams(torch, model, base.with_spt(**spt), reqs, True)
        if ran != must:
            raise AssertionError(f"{name}: decode kernels {ran} != {must}")
        _compare_streams(torch, model, base, reqs, name, got, oracle)
        if first is None:
            first = got
        elif got != first:
            raise AssertionError(f"{name}: streams differ from the "
                                 f"{tiers[0]} tier's")
    print(f"  {', '.join(tiers[1:])} streams identical to {tiers[0]} for "
          f"all {len(reqs)} requests", flush=True)


def agree_f32(torch):
    """Phase 6: 4 layers in f32, 8 requests over 4 slots; every decode
    tier's greedy streams against REPRO_DISABLE_KERNELS=1 (contiguous,
    core/ oracles), and the dense baseline's paged kernel-native streams
    (kernel 8) against its own oracle.  Each tier must launch its decode
    kernels and no other decode kernel, and the sparse kernel tiers must
    give exactly the contiguous fused tier's streams (bit-identical
    kernels over a deterministic prefill)."""
    from repro_torch import configs
    base = dataclasses.replace(configs.get_config("qwen3-0.6b"), num_layers=4,
                               dtype=torch.float32).with_spt(**SERVE_CFG)
    reqs = _requests(8, 64, 512, 16, base.vocab_size, seed=4)
    model = _perturbed_model(torch, base, seed=3)
    model.to(torch.float32)
    _tier_agreement(torch, model, base, reqs, list(TIERS))
    dense_cfg = base.with_spt(sparse_mha=False)
    dense = _perturbed_model(torch, dense_cfg, seed=3)
    dense.to(torch.float32)
    d_oracle, _ = _streams(torch, dense, dense_cfg, reqs, False)
    got, ran = _streams(torch, dense, dense_cfg.with_spt(**PAGED), reqs, True)
    if ran != {"dense_decode_attention_paged"}:
        raise AssertionError(f"paged dense: decode kernels {ran}")
    _compare_streams(torch, dense, dense_cfg, reqs, "paged dense native", got,
                     d_oracle)


# ------------------------------------------------------------ phases 7-8
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


def _want_train_launches(cfg, names, steps):
    """Launches of a train run: a layer of a pattern unit runs its
    forward twice a step (the checkpointed unit is recomputed in
    backward), a tail layer once; each forward of an attention layer
    launches kernel 1 twice (q and k) and kernels 2 and 4 once with
    sparse MHA, each forward of a layer with an FFN (every kind but
    ``ssd``) kernel 9 once with the routed FFN or MoE; nothing else.  The
    encoder-decoder checkpoints every layer: an encoder layer's forward
    (one attention, one FFN) and a decoder layer's (self- and
    cross-attention, one FFN) run twice a step."""
    from repro_torch.models import transformer
    if cfg.family == "audio":
        attn = 2 * (cfg.encoder_layers + 2 * cfg.num_layers) * steps
        ffn_fwd = 2 * (cfg.encoder_layers + cfg.num_layers) * steps
    else:
        unit = cfg.pattern * transformer.num_units(cfg)
        tail = transformer._tail_kinds(cfg)
        attn = (2 * unit.count("attn") + tail.count("attn")) * steps
        ffn_fwd = (2 * sum(k != "ssd" for k in unit)
                   + sum(k != "ssd" for k in tail)) * steps
    want = {name: 0 for name in names}
    if cfg.spt.sparse_mha:
        want.update({"pq_assign": 2 * attn, "topl_thresholds": attn,
                     "sparse_attention": attn})
    if cfg.spt.routed_ffn or cfg.num_experts > 0:
        want["grouped_ffn"] = ffn_fwd
    return want


def _trainer_here(make):
    """make()'s Trainer, with the SIGTERM handler that its constructor
    installs taken out again: this script stays stoppable by SIGTERM
    (phase 23's run B, a child, keeps the Trainer's handler)."""
    import signal
    prev = signal.getsignal(signal.SIGTERM)
    trainer = make()
    signal.signal(signal.SIGTERM, prev)
    return trainer


def _train_run(torch, cfg, steps, label, profile=True, seed=0, batch=TB,
               seq=TS):
    """``steps`` steps of Trainer.run in bf16, batch ``batch`` x ``seq``
    tokens from the seeded random stream (with a frontend, after its
    seeded rows), the launch counters zeroed just before and read just
    after (checked against _want_train_launches); then, with
    ``profile``, one more step under the profiler for the device-busy
    share.  Returns (launches, per-step rows, peak GiB, trainer)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch import kernels
    from repro_torch.launch.train import with_frontend
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    trainer = _trainer_here(lambda: Trainer(
        cfg, OptimizerConfig(lr=1e-3, total_steps=steps),
        TrainerConfig(total_steps=steps, log_interval=1), seed=seed,
        device="cuda"))
    if any(bool(v.any()) for _, v in _c_leaves(trainer.state)):
        raise AssertionError("LoRA c leaves are not zero at init")
    rows = []
    clock = [0.0]

    # positions a step runs: a VLM's frontend rows run the decoder too
    pos = seq + (cfg.frontend_tokens if _frontend(cfg) else 0)

    def hook(step, m):                 # metrics are host floats: synced
        now = time.perf_counter()
        rows.append({"step": step, "wall_s": now - clock[0],
                     "tok_s": batch * pos / (now - clock[0]),
                     "loss": m["loss"],
                     "lm_loss": m["lm_loss"], "grad_norm": m["grad_norm"],
                     "lr": m["lr"], "lb_loss": m["lb_loss"],
                     "dropped": m["dropped"]})
        print(f"  {label} step " + json.dumps(rows[-1]), flush=True)
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
    trainer.run(with_frontend(_batches(cfg, batch, seq, steps, seed=0), cfg,
                              seed=10), step_hook=hook)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in rows:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["grad_norm"] > 0):
            raise AssertionError(f"step {r['step']}: loss {r['loss']}, "
                                 f"grad_norm {r['grad_norm']}")
    want = _want_train_launches(cfg, launches, steps)
    if launches != want:
        raise AssertionError(f"{label} launches {launches} != expected {want}")
    print(f"  {label} peak memory {peak:.2f} GiB; launches "
          + json.dumps(launches), flush=True)
    if not profile:
        return launches, rows, peak, trainer

    data = next(with_frontend(_batches(cfg, batch, seq, 1, seed=1), cfg,
                              seed=11))
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.state, _ = trainer._step(trainer.state, data)
        torch.cuda.synchronize()
    wall_prof = (time.perf_counter() - t0) * 1e3
    top = [(getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
           for e in prof.key_averages()]
    top = sorted((r for r in top if r[0] > 0), reverse=True)
    device = sum(r[0] for r in top)
    wall = rows[-1]["wall_s"] * 1e3
    print(f"  {label} step ({batch} x {pos}, bf16): device {device:.1f} ms in "
          f"{sum(r[1] for r in top)} kernels; wall {wall:.1f} ms (step "
          f"{steps}), {wall_prof:.1f} ms (profiled step); device busy "
          f"{device / wall:.0%} of step {steps}", flush=True)
    for ms, n, name in top[:10]:
        print(f"    {ms:9.3f} ms  x{n:6d}  {name[:90]}", flush=True)
    for kern in ("pq_assign_", "topl_thresholds_kernel",
                 "sparse_attention_bf16_kernel", "grouped_ffn"):
        hit = [(ms, n) for ms, n, name in top if kern in name]
        ms, n = sum(h[0] for h in hit), sum(h[1] for h in hit)
        print(f"    {kern}: {ms:.1f} ms in {n} launches "
              f"({ms / max(n, 1):.4f} ms each, profiler)", flush=True)
    return launches, rows, peak, trainer


def train_full_width(torch):
    """Phase 7: three steps of Trainer.run on full-width qwen3-0.6b in
    bf16, batch 4 x 1024, then one profiled step."""
    return _train_run(torch, _train_cfg(torch), 3, "train")[0]


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
    from repro_torch.models import transformer
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
        h = [transformer._embed_inputs(params, cfg, batch["tokens"])]
        for unit in units[:-1]:
            h.append(transformer.block_apply(unit["b0_attn"], h[-1], cfg,
                                             "attn", mode="train")[0])
    del os.environ["REPRO_DISABLE_KERNELS"]
    worst = [0.0, 0.0]
    for u, unit in enumerate(units):
        cot = torch.randn(h[u].shape, device="cuda", generator=gen)

        def block():
            x = h[u].clone().requires_grad_(True)
            with torch.enable_grad():
                y, _, aux = transformer.block_apply(unit["b0_attn"], x, cfg,
                                                    "attn", mode="train")
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

    # (b) the whole train step
    _step_agreement(torch, cfg, state, batch, gen, "4-layer f32 train step")


def _step_agreement(torch, cfg, state, batch, gen, label, min_cos=0.99):
    """The loss and whole gradient of one train step with kernels on
    against REPRO_DISABLE_KERNELS=1: loss to rel 1e-4, cosine of the two
    gradients (every trainable leaf, flattened) >= min_cos, printed
    beside the oracle's own move under 1e-6 (relative) noise on the
    embedding."""
    from repro_torch.core.params import leaves
    from repro_torch.launch.steps import loss_and_grads
    (lk, _, gk), (lo, _, go) = _both_modes(
        lambda: loss_and_grads(state, cfg, batch))
    rel = abs(float(lk) - float(lo)) / abs(float(lo))
    if rel > 1e-4:
        raise AssertionError(f"{label}: loss {float(lk)} vs {float(lo)} "
                             f"(rel {rel:.2e})")
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
    if cos < min_cos:
        raise AssertionError(f"{label}: gradient cosine {cos:.6f} < "
                             f"{min_cos}")
    d_k = float((fk - fo).norm() / fo.norm())
    d_n = float((fn - fo).norm() / fo.norm())
    print(f"  {label}: loss {float(lk):.6f} (kernels) vs "
          f"{float(lo):.6f} (REPRO_DISABLE_KERNELS=1), rel {rel:.2e}; whole "
          f"gradient cosine {cos:.6f}, |g_k - g_o| / |g_o| = {d_k:.2e}; the "
          f"oracle with 1e-6 noise on the embedding moves it {d_n:.2e}",
          flush=True)


# ------------------------------------------------------------ phases 9-11
PAPER_BLOCKS = ("opt-1024", "opt-2048", "opt-2560", "llama-2560",
                "llama-4096")


def _add(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def train_paper_blocks(torch):
    """Phase 9: each Table-2 block at full width, one layer (the paper's
    unit), its real vocabulary, bf16, random weights from a seed: three
    steps of Trainer.run at 4 x 1024 under apply_variant "spt" (kernels
    1, 2, 4 and 9: exactly 4, 2, 2 and 2 launches per layer per step),
    then "lora" (dense attention and FFN: no kernel).  Prints tok/s at
    step 3 and the peak memory of each; returns the summed launches."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import apply_variant
    total, table = {}, []
    for name in PAPER_BLOCKS:
        base = configs.get_config(name).with_spt(**SERVE_CFG)
        for variant in ("spt", "lora"):
            cfg = apply_variant(base, variant)
            launches, rows, peak, trainer = _train_run(
                torch, cfg, 3, f"{name} {variant}", profile=False)
            del trainer                 # the next run's peak is its own
            total = _add(total, launches)
            table.append({"block": name, "variant": variant,
                          "tok_s_step3": rows[-1]["tok_s"],
                          "step3_s": rows[-1]["wall_s"],
                          "loss_step3": rows[-1]["loss"],
                          "peak_gib": peak})
            _free(torch)
    for row in table:
        print("  [9] " + json.dumps(row), flush=True)
    return total


def prefill_paper(torch, model, cfg):
    """lm_prefill (through steps.build_prefill_step) of 4 x 1024 tokens,
    the counters zeroed just before and read just after: kernels 1, 2, 4
    and 9 launch exactly 2, 1, 1 and 1 times per layer; finite logits of
    (4, 1, V); every cache slot written."""
    from repro_torch import kernels
    from repro_torch.launch.steps import build_prefill_step
    toks = torch.as_tensor(next(_batches(cfg, TB, TS, 1, seed=2))["tokens"],
                           device="cuda")
    prefill = build_prefill_step(cfg, TS)
    wrappers = kernels.wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    caches, logits = prefill(model, {"tokens": toks})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    nl = cfg.num_layers
    want = {name: 0 for name in launches}
    want.update({"pq_assign": 2 * nl, "topl_thresholds": nl,
                 "sparse_attention": nl, "grouped_ffn": nl})
    if launches != want:
        raise AssertionError(f"lm_prefill launches {launches} != {want}")
    if logits.shape != (TB, 1, cfg.padded_vocab) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError(f"lm_prefill logits {tuple(logits.shape)}")
    sp = caches["units"]["b0_attn"]["slot_pos"]
    if not bool((sp == torch.arange(TS, device="cuda")).all()):
        raise AssertionError("lm_prefill: slot_pos is not 0..S-1")
    print(f"  {cfg.name} lm_prefill 4 x 1024: {wall * 1e3:.1f} ms, "
          f"{TB * TS / wall:.1f} tok/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
          + json.dumps(launches), flush=True)
    return launches


def paper_models(torch):
    """Phase 10: opt-2.7b and llama-2.7b (full width, depth cut to
    PAPER_DEPTH of 32 layers, bf16) each take 2 steps of Trainer.run at 4
    x 1024 (launches 4 / 2 / 2 / 2 of kernels 1 / 2 / 4 / 9 per layer
    per step) and one profiled step; opt-2.7b's
    trained weights then run lm_prefill at 4 x 1024 and serve 8 requests
    (prompts 128-1024, 32 new tokens, 8 slots, max_len 2048, chunks of 16)
    on the contiguous layout (kernels 6 and 10 once per layer per decode
    step, kernel 9 once per layer per prefill group).  Returns the
    launches by path."""
    from repro_torch import configs
    from repro_torch.core.params import combine
    from repro_torch.models import transformer
    paths = {}

    def cut(name):
        return dataclasses.replace(configs.get_config(name),
                                   num_layers=PAPER_DEPTH).with_spt(**SERVE_CFG)
    cfg = cut("opt-2.7b")
    paths["paper_train"], _, _, trainer = _train_run(torch, cfg, 2,
                                                     "opt-2.7b train")
    model = transformer.LM(cfg, combine(trainer.state["train"],
                                        trainer.state["frozen"]))
    del trainer
    _free(torch)
    paths["paper_prefill"] = prefill_paper(torch, model, cfg)
    paths["paper_serve"], _ = _serve(torch, model, cfg, "opt-2.7b serve",
                                     work=PAPER_WORK)
    del model
    _free(torch)
    cfg = cut("llama-2.7b")
    launches, _, _, trainer = _train_run(torch, cfg, 2, "llama-2.7b train")
    paths["paper_train"] = _add(paths["paper_train"], launches)
    del trainer
    _free(torch)
    return paths


def paper_agree_f32(torch):
    """Phase 11: an OPT-2560-width model (learned positions, LayerNorm,
    ungated ReLU, R = 1, dh 80, M = 10) cut to 2 layers, in f32, kernels
    on against REPRO_DISABLE_KERNELS=1: the greedy streams of the
    contiguous (kernel 6) and paged kernel-native (kernel 7) tiers, as
    phase 6 holds them; lm_prefill's logits, K and V of every layer to
    max-abs <= 1e-5 x max (phase 8's per-block tolerance), slot_pos
    equal and codes equal up to the margin rule; one train step's loss
    and gradient cosine, as phase 8 (b)."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.train.state import init_state
    base = dataclasses.replace(configs.get_config("opt-2.7b"), num_layers=2,
                               dtype=torch.float32).with_spt(**SERVE_CFG)
    reqs = _requests(8, 64, 512, 16, base.vocab_size, seed=4)
    model = _perturbed_model(torch, base, seed=3)
    model.to(torch.float32)
    _tier_agreement(torch, model, base, reqs,
                    ["contiguous fused", "paged native"])

    toks = torch.as_tensor(next(_batches(base, 2, 512, 1, seed=8))["tokens"],
                           device="cuda")
    (ck, lk), (co, lo) = _both_modes(
        lambda: transformer.lm_prefill(model, base, {"tokens": toks}, 512))
    worst = _grad_check("lm_prefill logits", lk.float(), lo.float(), 1e-5)
    blk_k, blk_o = ck["units"]["b0_attn"], co["units"]["b0_attn"]
    if not torch.equal(blk_k["slot_pos"], blk_o["slot_pos"]):
        raise AssertionError("lm_prefill slot_pos differ")
    flips = 0
    for u, unit in enumerate(model.units):
        for key in ("k", "v"):
            worst = max(worst, _grad_check(f"lm_prefill layer {u} {key}",
                                           blk_k[key][u], blk_o[key][u],
                                           1e-5))
        flips += _margin_flips(torch, blk_k["codes"][u], blk_o["k"][u],
                               unit["b0_attn"]["mixer"]["pq"]["codebooks"],
                               f"lm_prefill layer {u} cache codes")[0]
    print(f"  2-layer f32 OPT-2560 lm_prefill (2 x 512): logits, K and V "
          f"within {worst:.2e} x max of REPRO_DISABLE_KERNELS=1; slot_pos "
          f"equal; {flips} cache codes differ (margin rule)", flush=True)

    state = init_state(base, seed=5, device="cuda")
    state["frozen"] = _map_tree(lambda x: x.float(), state["frozen"])
    gen = torch.Generator(device="cuda").manual_seed(6)
    for _, v in _c_leaves(state):
        v.copy_(torch.randn(v.shape, device="cuda", generator=gen) * 0.01)
    batch = next(_batches(base, 2, 512, 1, seed=7))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    _step_agreement(torch, base, state, batch, gen,
                    "2-layer f32 OPT-2560 train step")


# ------------------------------------------------------------ phases 12-13
# phase 12's traffic: 32 requests, prompts 128-2048 (numpy seed 2), 64 new
# tokens, 8 slots, max_len 4096, chunks of 16, seeded Poisson arrivals at
# 2 requests/s on the wall clock; every fourth request has a TTFT deadline
SERVER_WORK = dict(n=32, lo=128, hi=2048, gen=64, max_len=4096, qps=2.0,
                   deadline_s=6.0)
SERVER_SEED = 12
TERMINAL = {"eos", "length", "rejected", "cancelled", "shed"}


def _server_mix(reqs, deadline_s):
    """Half the requests sampled (temperature 0.8 with top_k 50, or with
    top_p 0.9), half greedy; priorities 0, 1, 2 in turn; every fourth
    request with a TTFT deadline."""
    out = []
    for i, r in enumerate(reqs):
        samp = ({} if i % 2 == 0 else dict(temperature=0.8, top_k=50)
                if i % 4 == 1 else dict(temperature=0.8, top_p=0.9))
        out.append(dataclasses.replace(
            r, priority=i % 3, deadline_s=deadline_s if i % 4 == 0 else None,
            **samp))
    return out


def _server_run(torch, model, cfg, label, telemetry, kv_pages=None):
    """Phase 12's serve: Engine.serve over the seeded Poisson schedule,
    with a ChaosMonkey (cancels, forced preemptions, duplicate and
    oversized submissions; no page-pool hogs, whose max_len - 2 = 4094
    new tokens would decode for minutes at this width) and a Watchdog
    that raises on any invariant failure, after a warm-up run; the launch
    counters zeroed just before and read just after.  Checks every
    request terminal (each of the 32 uids exactly once outside the
    rejections, full-length ones with 64 tokens), the launch counts
    exact (resume re-prefills counted), and with telemetry "trace" the
    Chrome trace valid with a lane for every uid."""
    from repro_torch import kernels
    from repro_torch.serving import chaos, trace_export
    from repro_torch.serving.engine import ArrivalSchedule, Engine
    w = SERVER_WORK
    eng = Engine(cfg.with_spt(telemetry=telemetry), model,
                 max_len=w["max_len"], num_slots=8, decode_chunk=16,
                 kv_pages=kv_pages)
    eng.run(_requests(2, 16, 32, 4, cfg.vocab_size, seed=1),
            temperature=0.8, seed=1)                             # warm-up
    reqs = _server_mix(_requests(w["n"], w["lo"], w["hi"], w["gen"],
                                 cfg.vocab_size, seed=2), w["deadline_s"])
    monkey = chaos.ChaosMonkey(SERVER_SEED, hog_p=0.0)
    watchdog = chaos.Watchdog()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = kernels.wrappers()
    for x in wrappers:
        x.launches = 0
    t0 = time.perf_counter()
    outs = eng.serve(ArrivalSchedule.poisson(reqs, w["qps"], seed=2),
                     seed=SERVER_SEED,
                     on_iteration=chaos.compose(monkey, watchdog))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {x.__name__: x.launches for x in wrappers}
    st = eng.last_stats
    if len(outs) != st.submitted or any(c.finish_reason not in TERMINAL
                                        for c in outs):
        raise AssertionError(f"{label}: a request is not terminal")
    served = sorted(c.uid for c in outs if c.finish_reason != "rejected")
    if served != list(range(w["n"])):
        raise AssertionError(f"{label}: served uids {served}")
    for c in outs:
        if (c.finish_reason == "length" and len(c.tokens) != w["gen"]) or \
                not all(0 <= t < cfg.padded_vocab for t in c.tokens):
            raise AssertionError(f"{label}: request {c.uid}: "
                                 f"{len(c.tokens)} tokens ({c.finish_reason})")
    want = _want_serve_launches(cfg, launches, eng.last_steps_run,
                                st.prefill_batches)
    if launches != want:
        raise AssertionError(f"{label} launches {launches} != expected {want}")
    stats = {"telemetry": telemetry, "wall_s": wall,
             "decode_tok_s": st.decode_tok_s,
             "decode_ms_per_step": 1e3 * st.decode_s / eng.last_steps_run,
             "prefill_tok_s": st.prefill_tok_s,
             "ttft_p50_s": st.ttft_p50_s, "ttft_p99_s": st.ttft_p99_s,
             "tpot_p50_s": st.tpot_p50_s, "tpot_p99_s": st.tpot_p99_s,
             "submitted": st.submitted, "completed": st.completed,
             "preemptions": st.preemptions, "shed": st.shed,
             "cancelled": st.cancelled, "rejections": st.rejections,
             "keep_rate": st.device.get("keep_rate"),
             "decode_steps": st.decode_steps, "steps_run": eng.last_steps_run,
             "prefill_batches": st.prefill_batches,
             "injected": dict(monkey.counts),
             "watchdog_iterations": watchdog.iterations,
             "max_memory_allocated_gib":
                 torch.cuda.max_memory_allocated() / 2 ** 30}
    if kv_pages is not None:
        stats.update(kv_pages_total=st.kv_pages_total,
                     kv_pages_peak=st.kv_pages_peak,
                     admission_stalls=st.admission_stalls)
    if telemetry == "trace":
        trace = trace_export.chrome_trace(eng.last_recorder)
        errs = trace_export.validate_chrome_trace(trace)
        missing = {c.uid for c in outs} - trace_export.trace_uids(trace)
        if errs or missing:
            raise AssertionError(f"{label}: trace errors {errs[:3]}, uids "
                                 f"without a lane {sorted(missing)[:5]}")
        stats["trace_events"] = len(trace["traceEvents"])
    print(f"  {label} " + json.dumps(stats), flush=True)
    print(f"  {label} ServeStats " + json.dumps(st.as_dict()), flush=True)
    print(f"  {label} launches " + json.dumps(launches), flush=True)
    return launches, stats


def server_full_width(torch):
    """Phase 12: full-width qwen3-0.6b, depth cut to SERVER_DEPTH layers, in
    bf16 through Engine.serve with
    telemetry "trace", contiguous (kernels 6, 9, 10), then the same
    schedule with telemetry "off" and "counters" (decode tok/s of the
    three, and decode ms per executed step: the wall-clock schedules
    differ between runs, and a host-bound step costs the same whatever
    its active slots), then paged kernel-native on phase 5's 64-page
    pool (kernels 7, 9, 10)."""
    from repro_torch import configs
    _free(torch)
    base = dataclasses.replace(configs.get_config("qwen3-0.6b"),
                               num_layers=SERVER_DEPTH)
    cfg = base.with_spt(**SERVE_CFG)
    model = _perturbed_model(torch, cfg, seed=0)
    keys = ("decode_tok_s", "decode_ms_per_step")
    launches, stats = _server_run(torch, model, cfg, "server", "trace")
    launches = {"server": launches}
    rates = {"trace": {k: stats[k] for k in keys}}
    for mode in ("off", "counters"):
        stats = _server_run(torch, model, cfg, f"server ({mode})", mode)[1]
        rates[mode] = {k: stats[k] for k in keys}
    paged = base.with_spt(**SERVE_CFG, **PAGED)
    launches["server_paged"] = _server_run(
        torch, model, paged, "paged server", "trace", kv_pages=PAGED_POOL)[0]
    del model
    _free(torch)
    return launches, rates


def _replay_gap(torch, model, cfg, req, ctx, a, b, n, seed, max_len):
    """Where two streams of ``req`` first differ (tokens a and b after
    context ctx, the n-th generated token), the oracle's (kill switch on)
    logits of ctx — for a sampled request perturbed as its draw sees them:
    temperature-scaled, truncated, plus its Gumbel noise of (seed, uid,
    n) — and the gap between their max and the smaller of a's and b's."""
    from repro_torch.models import transformer
    from repro_torch.serving import engine
    with torch.no_grad():
        _, logits = transformer.lm_prefill_ragged(
            model, cfg, {"tokens": torch.tensor([ctx], device="cuda")},
            torch.tensor([len(ctx)], device="cuda"), max_len)
    lg = logits[0, -1:].float()
    temp = req.temperature or 0.0
    if temp > 0:
        dev = lg.device
        top_p = req.top_p if 0.0 < req.top_p < 1.0 else 0.0
        lg = engine.truncate(
            lg, torch.tensor([temp], device=dev),
            torch.tensor([req.top_k], device=dev),
            torch.tensor([req.top_p], device=dev), req.top_k, top_p > 0)
        lg = lg + engine.gumbel_noise(
            torch.tensor([engine.request_key(seed, req.uid)], device=dev),
            torch.tensor([n], device=dev), lg.shape[-1])
    lg = lg[0].cpu().numpy()
    return float(lg.max()) - min(float(lg[a]), float(lg[b]))


def _compare_sampled(torch, model, cfg, reqs, got, want, name, seed,
                     max_len=1024, ties=None):
    """got == want per uid, except past a near-tie at the first
    divergence: of the perturbed logits (<= 1e-3), replayed under the
    kill switch, or of a choice (``ties``: _judge_flip).  Returns the
    accepted flips' kinds by uid."""
    by_uid = {r.uid: r for r in reqs}
    os.environ["REPRO_DISABLE_KERNELS"] = "1"
    kinds = {}
    try:
        for uid in sorted(got):
            g, w = got[uid], want[uid]
            if g == w:
                continue
            t = next((i for i, (x, y) in enumerate(zip(g, w)) if x != y),
                     None)
            if t is None:
                raise AssertionError(f"{name}: uid {uid} lengths {len(g)} "
                                     f"vs {len(w)}")
            req = by_uid[uid]
            gap = _replay_gap(torch, model, cfg, req, list(req.tokens) + w[:t],
                              g[t], w[t], t, seed, max_len)
            kinds[uid] = _judge_flip(gap, ties, uid, t, f"{name}: uid {uid}")
    finally:
        os.environ.pop("REPRO_DISABLE_KERNELS", None)
    return kinds


@contextlib.contextmanager
def _held_to_plain(torch):
    """While it is active, every call of the decode attention op (kernel
    6, or 3 + 5 / 7 by the config), of kernel 9 and of kernel 10 is held
    to its plain version on the very same inputs (F32_TOL): a kernel's
    own error, apart from what its inputs carry in from upstream.  Yields
    the list of the calls' max abs errors.  The plain versions launch
    nothing, so the launch counters move as without it."""
    from repro_torch.core import sparse_attention as sa
    from repro_torch.kernels.routed_ffn import ops as rffn_ops
    from repro_torch.kernels.routed_ffn import ref as rffn_ref
    from repro_torch.kernels.sparse_attention import ops as sa_ops
    held = [(sa_ops, "sparse_mha_decode",
             lambda *a, fuse=True: sa.sparse_mha_decode(*a)),
            (rffn_ops, "grouped_ffn", rffn_ref.grouped_ffn_ref),
            (rffn_ops, "decode_ffn", rffn_ref.decode_ffn_ref)]
    errs, orig = [], [getattr(m, n) for m, n, _ in held]

    def hold(fn, plain):
        @functools.wraps(fn)     # the wrapper counts this global's launches
        def run(*a, **k):
            out = fn(*a, **k)
            for log in _CHOICES:            # the plain version's own choices
                log.paused += 1
            try:
                errs.append(close(out, plain(*a, **k), F32_TOL))
            finally:
                for log in _CHOICES:
                    log.paused -= 1
            return out
        return run
    for (mod, name, plain), fn in zip(held, orig):
        setattr(mod, name, hold(fn, plain))
    try:
        yield errs
    finally:
        for (mod, name, _), fn in zip(held, orig):
            launches = getattr(mod, name).__dict__.get("launches")
            if launches is not None:
                fn.launches = launches
            setattr(mod, name, fn)


def _agree_serve(torch, model, cfg, trace, kernels_on, seed):
    """One phase-13 serve under a ManualClock: the arrival trace, a hook
    that cancels the last queued request from iteration 3 on (once),
    force-preempts at iteration 4 and cancels the last occupied slot's
    request from iteration 5 on (once) — each a function of the schedule
    alone — and the Watchdog, with or without
    the kernels.  Returns (completions by uid, the hook's log, stats,
    decode-path kernels that launched)."""
    from repro_torch import kernels
    from repro_torch.serving import chaos
    from repro_torch.serving.engine import ArrivalSchedule, Engine, ManualClock
    log = []

    def hook(e, iteration):
        st = e._live
        done = {x[0] for x in log}
        if iteration >= 3 and st.queue and "cancel queued" not in done:
            uid = st.queue[-1].req.uid
            log.append(("cancel queued", uid, e.cancel(uid)))
        if iteration == 4:
            log.append(("preempt", e.preempt()))
        live = [it.req.uid for it in st.slot_item if it is not None]
        if iteration >= 5 and live and "cancel mid-stream" not in done:
            log.append(("cancel mid-stream", live[-1], e.cancel(live[-1])))
    if not kernels_on:
        os.environ["REPRO_DISABLE_KERNELS"] = "1"
    try:
        before = {w.__name__: w.launches for w in kernels.wrappers()}
        eng = Engine(cfg, model, max_len=1024, num_slots=4, decode_chunk=8)
        outs = eng.serve(ArrivalSchedule.from_trace(trace),
                         clock=ManualClock(dt=1.0), seed=seed,
                         on_iteration=chaos.compose(hook, chaos.Watchdog()))
        torch.cuda.synchronize()
        ran = {w.__name__ for w in kernels.wrappers()
               if w.launches != before[w.__name__]}
    finally:
        os.environ.pop("REPRO_DISABLE_KERNELS", None)
    st = eng.last_stats
    ints = {k: getattr(st, k) for k in (
        "submitted", "admitted", "completed", "cancelled", "shed",
        "preemptions", "prefill_batches", "decode_steps", "decode_tokens")}
    return ({c.uid: c for c in outs}, log, ints, ran)


def server_agree_f32(torch):
    """Phase 13: qwen3 cut to 4 layers, f32, ManualClock: one schedule
    (10 requests, prompts 64-512, 24 new tokens, 4 slots, arrivals every
    0.25 s, the clock 1 s an iteration; priorities, TTFT deadlines of 3
    s, half sampled, a queued and a mid-stream cancel and a forced
    preemption) under REPRO_DISABLE_KERNELS=1, with the kernels (kernels
    6, 9 and 10 held to their plain versions on the inputs of every call,
    the choices checked against the oracle's) and again with the kernels
    (identical): finish reasons, details, preemptions, the hook's log and
    the stats equal, tokens equal up to the near-tie rules (the perturbed
    logits replayed, or a choice flip: _judge_flip).  Then the schedule
    with top fraction 1 and capacity factor 8 (every valid key selected, no
    capacity drop: the resume's prefill recomputes the KV decode wrote,
    and a top-L choice cannot turn float-order noise into a logit gap),
    with the kernels and under the kill switch: the stats equal, tokens
    equal up to the replay rule on the perturbed logits; and each request
    preempted there served alone: its stream equals the preempted one
    (same rule)."""
    from repro_torch import configs
    from repro_torch.serving.engine import Engine
    base = dataclasses.replace(configs.get_config("qwen3-0.6b"), num_layers=4,
                               dtype=torch.float32).with_spt(**SERVE_CFG)
    model = _perturbed_model(torch, base, seed=3)
    model.to(torch.float32)
    reqs = _server_mix(_requests(10, 64, 512, 24, base.vocab_size, seed=4),
                       deadline_s=3.0)
    trace = [(0.25 * i, r) for i, r in enumerate(reqs)]
    seed = SERVER_SEED
    with _choices(torch) as choices:
        oracle = _agree_serve(torch, model, base, trace, False, seed)
    with _held_to_plain(torch) as errs, _choices(torch, choices) as ties:
        runs = [_agree_serve(torch, model, base, trace, True, seed)]
    runs += [_agree_serve(torch, model, base, trace, True, seed), oracle]
    (got, log, ints, ran), again, (want, log_o, ints_o, ran_o) = runs
    if ran != {"fused_sparse_decode_attention", "grouped_ffn",
               "decode_ffn"} or ran_o or not errs:
        raise AssertionError(f"kernels launched: {ran} (on), {ran_o} (off)")
    if ({u: (c.tokens, c.finish_reason, c.preemptions) for u, c in
         again[0].items()} != {u: (c.tokens, c.finish_reason, c.preemptions)
                               for u, c in got.items()}
            or again[1:3] != (log, ints)):
        raise AssertionError("the same seed gave another run")
    if (log != log_o or ints != ints_o
            or {u: (c.finish_reason, c.detail, c.preemptions)
                for u, c in got.items()}
            != {u: (c.finish_reason, c.detail, c.preemptions)
                for u, c in want.items()}):
        raise AssertionError(f"kernels vs oracle schedules differ: {log} "
                             f"{ints} vs {log_o} {ints_o}")
    if not (ints["preemptions"] >= 1 and ints["cancelled"] == 2
            and all(x[-1] for x in log) and len(log) == 3):
        raise AssertionError(f"phase 13 schedule missed an event: {log} "
                             f"{ints}")
    kinds = _compare_sampled(torch, model, base, reqs,
                             {u: c.tokens for u, c in got.items()},
                             {u: c.tokens for u, c in want.items()},
                             "kernels vs oracle", seed, ties=ties.first)
    reasons = sorted({c.finish_reason for c in got.values()})
    print(f"  f32 server schedule: {json.dumps(ints)}; hook {log}; finish "
          f"reasons {reasons}; the same seed again identical; kernels 6, "
          f"9, 10 = their plain versions on the inputs of each of their "
          f"{len(errs)} calls (max abs err {max(errs):.3e}, rule "
          f"{F32_TOL}); streams == REPRO_DISABLE_KERNELS=1 at top-L "
          f"{base.spt.attn_top_fraction:g} for {len(got) - len(kinds)}/"
          f"{len(got)} requests, {_flip_note(kinds, ties.first)}",
          flush=True)
    # recompute resume rebuilds a request's KV through the ragged prefill,
    # which equals what decode wrote only where both select the same keys
    # and no (token, group) pair overflows the routed FFN's capacity: top
    # fraction 1 keeps every valid key in both (a budget of 16 in both
    # also matches, but its selection turns float-order noise into 1e-2
    # logit gaps), and capacity 8 drops nothing.  The same makes the
    # kernels' streams comparable with the kill switch's: every valid key
    # selected on both sides, the streams equal up to the replay rule.
    exact = base.with_spt(attn_top_fraction=1.0, ffn_capacity_factor=8.0)
    got, log, ints, _ = _agree_serve(torch, model, exact, trace, True, seed)
    want, log_o, ints_o, _ = _agree_serve(torch, model, exact, trace, False,
                                          seed)
    if log != log_o or ints != ints_o:
        raise AssertionError(f"kernels vs oracle schedules differ at top-L "
                             f"1: {log} {ints} vs {log_o} {ints_o}")
    kinds = _compare_sampled(torch, model, exact, reqs,
                             {u: c.tokens for u, c in got.items()},
                             {u: c.tokens for u, c in want.items()},
                             "kernels vs oracle, top-L 1", seed)
    print(f"  top-L 1, capacity 8: streams == REPRO_DISABLE_KERNELS=1 for "
          f"{len(got) - len(kinds)}/{len(got)} requests, {len(kinds)} "
          "replayed near-tie flips (<= 1e-3 on the perturbed logits)",
          flush=True)
    by_uid = {r.uid: r for r in reqs}
    resumed = [u for u, c in got.items()
               if c.preemptions and c.finish_reason == "length"]
    if not resumed:
        raise AssertionError("no preempted request ran to its budget")
    solo = {}
    for u in resumed:
        eng = Engine(exact, model, max_len=1024, num_slots=4, decode_chunk=8)
        solo[u] = eng.run([by_uid[u]], seed=seed)[0].tokens
    kinds = _compare_sampled(torch, model, exact, reqs, solo,
                             {u: got[u].tokens for u in resumed},
                             "preempted vs alone", seed)
    print(f"  preempted requests {resumed}: streams equal their unpreempted "
          f"runs ({len(kinds)} replayed near-tie flips)", flush=True)


# ------------------------------------------------------------ phases 14-15
# phase 14: each MoE config at full width, its depth cut to fit the card
# (mixtral 56 -> 4 layers, ~21 GB of weights; grok 64 -> 2, ~23 GB);
# serving 8 requests (prompts 128-2048 from numpy seed 2, 32 new tokens,
# 8 slots, max_len 8192, chunks of 16) — mixtral's last prompt replaced by
# one of 4608 tokens so its 4096 window wraps — and grok paged on a pool
# of 96 pages of 128, under its 512-page footprint.
MOE_DEPTH = {"mixtral-8x22b": 4, "grok-1-314b": 2}
MOE_WORK = dict(n=8, lo=128, hi=2048, gen=32, max_len=8192)
MOE_LONG = 4608
MOE_POOL = 96


def moe_full_width(torch):
    """Phase 14: mixtral-8x22b (4 layers) and grok-1-314b (2 layers) at
    full width in bf16: a burst Engine.run (kernels 6, 9, 10; grok also
    paged, kernel 7) with its decode step split, then Trainer.run at 4 x
    1024 under "spt" (kernels 1, 2, 4, 9), 2 steps each and a profiled
    step for mixtral; counters zeroed just before each and read just
    after, launch counts exact.  Each model is freed before the next.
    Returns the launches by path."""
    from repro_torch import configs
    from repro_torch.models import transformer
    paths = {p: {} for p in ("moe_serve", "moe_serve_paged", "moe_train")}
    _free(torch)                  # what earlier phases left in the cache
    for name, layers in MOE_DEPTH.items():
        cfg = dataclasses.replace(configs.get_config(name),
                                  num_layers=layers).with_spt(**SERVE_CFG)
        model = _perturbed_model(torch, cfg, seed=0)
        work = dict(MOE_WORK, long=MOE_LONG) if cfg.window else MOE_WORK
        launches, _ = _serve(torch, model, cfg, f"{name} serve", work=work)
        paths["moe_serve"] = _add(paths["moe_serve"], launches)
        decode_step_split(torch, model, cfg)
        if transformer.paged_applicable(cfg):
            paged = cfg.with_spt(**PAGED)
            launches, _ = _serve(torch, model, paged, f"{name} paged serve",
                                 kv_pages=MOE_POOL, work=work)
            paths["moe_serve_paged"] = _add(paths["moe_serve_paged"],
                                            launches)
        del model
        _free(torch)
        launches, _, _, trainer = _train_run(
            torch, cfg, 2, f"{name} train", profile=cfg.window is not None)
        paths["moe_train"] = _add(paths["moe_train"], launches)
        del trainer
        _free(torch)
    return paths


def _moe_small(torch, name):
    """An MoE config at a cut width in f32: d 1024, F 2048, 8 heads of
    128 over 2 kv heads, 8 experts top 2, 2 layers, mixtral's window 64
    (so that its ring wraps)."""
    from repro_torch import configs
    cfg = dataclasses.replace(
        configs.get_config(name), num_layers=2, d_model=1024, num_heads=8,
        num_kv_heads=2, d_ff=2048, dtype=torch.float32,
        window=64 if configs.get_config(name).window else None)
    return cfg.with_spt(**SERVE_CFG)


def moe_agree_f32(torch):
    """Phase 15: both MoE configs at the cut width of _moe_small, kernels
    on against REPRO_DISABLE_KERNELS=1: greedy streams of 8 requests
    (prompts 64-512, 16 new tokens, 4 slots) equal up to the near-tie
    replay rule, the kernel run launching kernels 6, 9 and 10 and the
    oracle none; one train step (2 x 512) by phase 8's step rule."""
    from repro_torch import kernels
    from repro_torch.train.state import init_state
    for name in MOE_DEPTH:
        cfg = _moe_small(torch, name)
        reqs = _requests(8, 64, 512, 16, cfg.vocab_size, seed=4)
        model = _perturbed_model(torch, cfg, seed=3)
        model.to(torch.float32)
        before = {w.__name__: w.launches for w in kernels.wrappers()}
        oracle, ran = _streams(torch, model, cfg, reqs, False)
        got, ran_k = _streams(torch, model, cfg, reqs, True)
        moved = {w.__name__ for w in kernels.wrappers()
                 if w.launches != before[w.__name__]}
        if ran or ran_k != {"fused_sparse_decode_attention"} or not {
                "grouped_ffn", "decode_ffn"} <= moved:
            raise AssertionError(f"{name}: oracle ran {ran}, kernels "
                                 f"{sorted(moved)}")
        _compare_streams(torch, model, cfg, reqs, f"{name} f32", got, oracle)
        del model
        state = init_state(cfg, seed=5, device="cuda")
        state["frozen"] = _map_tree(lambda t: t.float(), state["frozen"])
        gen = torch.Generator(device="cuda").manual_seed(6)
        for _, v in _c_leaves(state):
            v.copy_(torch.randn(v.shape, device="cuda", generator=gen) * 0.01)
        batch = next(_batches(cfg, 2, 512, 1, seed=7))
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
        _step_agreement(torch, cfg, state, batch, gen,
                        f"2-layer f32 {name} train step")
        del state
        _free(torch)


# ------------------------------------------------------------ phases 16-18
# phase 16: the dense configs that had not run on the card, at full width
# with depth cut to 2 layers (depth adds no shape: their per-layer shapes
# are the point): gemma-7b (kernel 4's bf16 body at dh 256, M = 32 in
# kernels 1, 2 and 6, the 256,000-row tied and scaled embedding),
# h2o-danube-1.8b (dh 80, M = 10) and h2o-danube-3-4b (dh 120, M = 15),
# both with the 4,096 window: their last prompt is 4,608 tokens, so the
# ring wraps in prefill, and max_len 8192 takes decode past it.
DENSE_ARCHS = ("gemma-7b", "h2o-danube-1.8b", "h2o-danube-3-4b")
DENSE_DEPTH = 2
DENSE_WORK = dict(n=8, lo=128, hi=2048, gen=32, max_len=8192)


def dense_registry_full_width(torch):
    """Phase 16: each of DENSE_ARCHS at full width, 2 layers, bf16,
    random weights from a seed: a burst serve of 8 requests (32 new
    tokens; kernels 6, 9, 10) and one "spt" train step at 2 x 1024
    (kernels 1, 2, 4, 9) and a profiled step, counters zeroed just
    before each and read just after, launch counts exact.  Returns the
    launches by path."""
    from repro_torch import configs
    paths = {"dense_serve": {}, "dense_train": {}}
    _free(torch)
    for name in DENSE_ARCHS:
        cfg = dataclasses.replace(configs.get_config(name),
                                  num_layers=DENSE_DEPTH).with_spt(**SERVE_CFG)
        model = _perturbed_model(torch, cfg, seed=0)
        work = dict(DENSE_WORK, long=MOE_LONG) if cfg.window else DENSE_WORK
        launches, _ = _serve(torch, model, cfg, f"{name} serve", work=work)
        paths["dense_serve"] = _add(paths["dense_serve"], launches)
        del model
        _free(torch)
        launches, _, _, trainer = _train_run(torch, cfg, 1, f"{name} train",
                                             batch=2)
        paths["dense_train"] = _add(paths["dense_train"], launches)
        del trainer
        _free(torch)
    return paths


# phase 17: recurrentgemma-9b at full width and full depth (38 layers: 12
# units of (rec, rec, attn) and a tail of 2 rec blocks, ~8.5 B
# parameters): a burst of 8 requests through Engine.serve (prompts
# 128-2048 from numpy seed 2, the last one 3,072 tokens so that the 2,048
# window wraps in prefill; 32 new tokens, 8 slots, max_len 4096, chunks
# of 16), then "spt" and "lora" training at 4 x 1024.
HYBRID_WORK = dict(n=8, lo=128, hi=2048, gen=32, max_len=4096, long=3072)


def hybrid_full_width(torch):
    """Phase 17: recurrentgemma-9b (38 layers, bf16, random weights from
    a seed): Engine.serve of HYBRID_WORK (kernel 6 once per attention
    layer per decode step, 12 of 38; kernel 10 once per layer per step;
    kernel 9 once per layer per prefill group) and a decode step's split;
    then 2 steps of Trainer.run at 4 x 1024 under "spt" (kernels 1, 2, 4
    per attention-layer forward, kernel 9 per layer forward: the 36 unit
    layers twice a step, the 2 tail layers once) and a profiled step,
    and 2 under "lora" (no kernel).  Counters zeroed just before each
    and read just after, launch counts exact.  Returns the launches by
    path."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import apply_variant
    paths = {}
    _free(torch)
    cfg = configs.get_config("recurrentgemma-9b").with_spt(**SERVE_CFG)
    model = _perturbed_model(torch, cfg, seed=0)
    paths["hybrid_serve"], _ = _serve(torch, model, cfg,
                                      "recurrentgemma-9b serve",
                                      work=HYBRID_WORK, serve_api=True)
    decode_step_split(torch, model, cfg)
    del model
    _free(torch)
    paths["hybrid_train"], _, _, trainer = _train_run(
        torch, cfg, 2, "recurrentgemma-9b spt train")
    del trainer
    _free(torch)
    launches, _, _, trainer = _train_run(
        torch, apply_variant(cfg, "lora"), 2, "recurrentgemma-9b lora train",
        profile=False)
    if any(launches.values()):
        raise AssertionError(f"lora train launched {launches}")
    del trainer
    _free(torch)
    return paths


def _hybrid_small(torch):
    """recurrentgemma-9b cut to one unit plus the tail (5 layers) and
    d 1024 (lru width 1024: 16 gate blocks; F 2048), in f32, its 16
    query heads of 256 on 1 kv head kept (R = 16, M = 32), window 64 so
    that the ring wraps."""
    from repro_torch import configs
    cfg = dataclasses.replace(
        configs.get_config("recurrentgemma-9b"), num_layers=5, d_model=1024,
        lru_width=1024, d_ff=2048, window=64, dtype=torch.float32)
    return cfg.with_spt(**SERVE_CFG)


def hybrid_agree_f32(torch):
    """Phase 18: the _hybrid_small model, kernels on against
    REPRO_DISABLE_KERNELS=1: greedy streams of 8 requests (prompts
    64-512, 16 new tokens, 4 slots) equal up to the near-tie replay
    rule, the kernel run launching kernels 6, 9 and 10 and the oracle
    none; one train step (2 x 512) by phase 8's step rule (loss rel
    1e-4, gradient cosine >= 0.99)."""
    from repro_torch import kernels
    from repro_torch.train.state import init_state
    cfg = _hybrid_small(torch)
    reqs = _requests(8, 64, 512, 16, cfg.vocab_size, seed=4)
    model = _perturbed_model(torch, cfg, seed=3)
    model.to(torch.float32)
    before = {w.__name__: w.launches for w in kernels.wrappers()}
    oracle, ran = _streams(torch, model, cfg, reqs, False)
    got, ran_k = _streams(torch, model, cfg, reqs, True)
    moved = {w.__name__ for w in kernels.wrappers()
             if w.launches != before[w.__name__]}
    if ran or ran_k != {"fused_sparse_decode_attention"} or not {
            "grouped_ffn", "decode_ffn"} <= moved:
        raise AssertionError(f"recurrentgemma: oracle ran {ran}, kernels "
                             f"{sorted(moved)}")
    _compare_streams(torch, model, cfg, reqs, "5-layer recurrentgemma f32",
                     got, oracle)
    del model
    _free(torch)
    state = init_state(cfg, seed=5, device="cuda")
    state["frozen"] = _map_tree(lambda t: t.float(), state["frozen"])
    gen = torch.Generator(device="cuda").manual_seed(6)
    for _, v in _c_leaves(state):
        v.copy_(torch.randn(v.shape, device="cuda", generator=gen) * 0.01)
    batch = next(_batches(cfg, 2, 512, 1, seed=7))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    _step_agreement(torch, cfg, state, batch, gen,
                    "5-layer f32 recurrentgemma train step")
    del state
    _free(torch)


# ------------------------------------------------------------ phases 19-22
# phase 19: phi-3-vision-4.2b at full width, depth cut to PHI_DEPTH of its
# 32 layers: 8 requests, each with 576 frontend rows (numpy seed) before
# a prompt of 128-1024 tokens (numpy seed 2), 32 new tokens, 8 slots,
# max_len 2048, chunks of 16; contiguous, then paged on a pool of 80
# pages of 128 (the worst case of the 8 is 104 pages, so the image
# prefixes' pages make requests wait); then "spt" training at 4 x (576 +
# 448) positions and "lora".
PHI_WORK = dict(n=8, lo=128, hi=1024, gen=32, max_len=2048)
PHI_POOL = 80
# phase 20: mamba2-780m at full width and depth (48 layers): 8 requests of
# 128-2048 tokens, 32 new tokens, through exact-length prefill groups.
MAMBA_WORK = dict(n=8, lo=128, hi=2048, gen=32, max_len=4096)
# phase 21: whisper-base (6 + 6 layers): 8 rows of 1500 frames, 4-token
# decoder prompts, 64 new tokens through generate's per-token loop.
WH_ROWS, WH_PROMPT, WH_GEN = 8, 4, 64


def _no_launches(label, launches):
    if any(launches.values()):
        raise AssertionError(f"{label} launched {launches}")


def vlm_full_width(torch):
    """Phase 19: phi-3-vision-4.2b (full width, PHI_DEPTH of 32 layers,
    bf16, random weights from a seed): Engine.run of PHI_WORK with frontend rows, contiguous (kernel
    6 once per layer per decode step, kernel 10 once per layer per step,
    kernel 9 once per layer per prefill group) and a decode step's split,
    then paged on PHI_POOL pages (kernel 7); 2 steps of Trainer.run at 4
    x (576 + 448) under "spt" (kernels 1, 2, 4 and 9, twice per layer a
    step) and a profiled step, then 2 under "lora" (no kernel).
    Counters zeroed just before each and read just after, launch counts
    exact.  Returns the launches by path."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import apply_variant
    paths = {}
    _free(torch)
    cfg = dataclasses.replace(configs.get_config("phi-3-vision-4.2b"),
                              num_layers=PHI_DEPTH).with_spt(**SERVE_CFG)
    model = _perturbed_model(torch, cfg, seed=0)
    paths["vlm_serve"], _ = _serve(torch, model, cfg,
                                   "phi-3-vision-4.2b serve", work=PHI_WORK)
    decode_step_split(torch, model, cfg)
    pcfg = cfg.with_spt(**PAGED)
    paths["vlm_serve_paged"], _ = _serve(
        torch, model, pcfg, "phi-3-vision-4.2b paged serve",
        kv_pages=PHI_POOL, work=PHI_WORK)
    del model
    _free(torch)
    seq = TS - cfg.frontend_tokens
    paths["vlm_train"], _, _, trainer = _train_run(
        torch, cfg, 2, "phi-3-vision-4.2b spt train", seq=seq)
    del trainer
    _free(torch)
    launches, _, _, trainer = _train_run(
        torch, apply_variant(cfg, "lora"), 2,
        "phi-3-vision-4.2b lora train", profile=False, seq=seq)
    _no_launches("phi-3-vision-4.2b lora train", launches)
    del trainer
    _free(torch)
    return paths


def ssm_full_width(torch):
    """Phase 20: mamba2-780m (48 layers, bf16, random weights from a
    seed): Engine.run of MAMBA_WORK (exact-length prefill groups) and a
    decode step's split, 2 "spt" train steps at 4 x 1024 and a profiled
    step, 2 "lora" steps: no SPT kernel launches on any of them (no
    attention, no FFN).  Returns the launches by path."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import apply_variant
    paths = {}
    _free(torch)
    cfg = configs.get_config("mamba2-780m").with_spt(**SERVE_CFG)
    model = _perturbed_model(torch, cfg, seed=0)
    paths["ssm_serve"], stats = _serve(torch, model, cfg,
                                       "mamba2-780m serve", work=MAMBA_WORK)
    _no_launches("mamba2-780m serve", paths["ssm_serve"])
    decode_step_split(torch, model, cfg)
    del model
    _free(torch)
    for variant in ("spt", "lora"):
        launches, _, _, trainer = _train_run(
            torch, apply_variant(cfg, variant), 2,
            f"mamba2-780m {variant} train", profile=variant == "spt")
        _no_launches(f"mamba2-780m {variant} train", launches)
        paths["ssm_train"] = _add(paths.get("ssm_train", {}), launches)
        del trainer
        _free(torch)
    return paths


def _want_generate_launches(cfg, names, decode_calls):
    """Launches of one enc-dec generate: the prefill encodes the frames
    (each encoder layer: kernel 1 twice, kernels 2 and 4 once, kernel 9
    once) and prefills the decoder (each layer: self- and
    cross-attention, kernels 1, 2, 4 each; kernel 9 once); each of the
    decode calls runs the self-attention's decode kernel and kernel 10
    once per decoder layer.  Cross-attention decode and the cross cache's
    codes take the plain core/ paths, as in JAX: no launch."""
    from repro_torch.core import dispatch
    enc, dec = cfg.encoder_layers, cfg.num_layers
    attn = enc + 2 * dec
    want = {name: 0 for name in names}
    if cfg.spt.sparse_mha:
        decode = (["fused_sparse_decode_attention"]
                  if dispatch.use_fused_decode_attn(cfg)
                  else ["decode_topl_thresholds", "sparse_decode_attention"])
        want.update({"pq_assign": 2 * attn, "topl_thresholds": attn,
                     "sparse_attention": attn})
        want.update({name: dec * decode_calls for name in decode})
    if cfg.spt.routed_ffn:
        want.update({"grouped_ffn": enc + dec, "decode_ffn": dec * decode_calls})
    return want


def _audio_batch(torch, cfg, rows, prompt, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (rows, prompt),
                                    generator=gen, device="cuda"),
            "frontend_embeds": torch.randn(
                (rows, cfg.frontend_tokens, cfg.d_model), generator=gen,
                device="cuda").to(cfg.dtype)}


def audio_full_width(torch):
    """Phase 21: whisper-base (6 + 6 layers, bf16, random weights from a
    seed): Engine.generate of WH_ROWS rows of 1500 frames, WH_PROMPT-token
    prompts and WH_GEN new tokens on the per-token path (counters zeroed
    just before and read just after, held to _want_generate_launches), a
    decode step's split, the launcher's legacy-audio blob, then 2 "spt"
    train steps at 4 x 448 decoder tokens over 1500 frames and a profiled
    step.  Returns the launches by path."""
    import contextlib
    import io
    from repro_torch import configs, kernels
    from repro_torch.launch import serve
    from repro_torch.models import encdec
    from repro_torch.serving.engine import Engine
    paths = {}
    _free(torch)
    cfg = configs.get_config("whisper-base").with_spt(**SERVE_CFG)
    model = _perturbed_model(torch, cfg, seed=0)
    max_len = WH_PROMPT + WH_GEN + 8
    eng = Engine(cfg, model, max_len=max_len)
    eng.generate(_audio_batch(torch, cfg, 2, WH_PROMPT, 1), 4)   # warm-up
    batch = _audio_batch(torch, cfg, WH_ROWS, WH_PROMPT, 2)
    wrappers = kernels.wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    toks = eng.generate(batch, WH_GEN).tokens
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    want = _want_generate_launches(cfg, launches, WH_GEN - 1)
    if launches != want:
        raise AssertionError(f"whisper-base generate launches {launches} != "
                             f"expected {want}")
    if not (len(toks) == WH_ROWS and all(
            len(r) == WH_GEN and all(0 <= x < cfg.padded_vocab for x in r)
            for r in toks)):
        raise AssertionError("whisper-base generate: bad token rows")
    paths["audio_generate"] = launches
    print("  whisper-base generate " + json.dumps(
        {"rows": WH_ROWS, "frames": cfg.frontend_tokens,
         "new_tokens": WH_GEN, "wall_s": wall,
         "tok_s": WH_ROWS * WH_GEN / wall,
         "max_memory_allocated_gib": torch.cuda.max_memory_allocated()
         / 2 ** 30}), flush=True)
    print("  whisper-base generate launches " + json.dumps(launches),
          flush=True)
    # prefill alone, and one decode step at the prefill's caches
    t0 = time.perf_counter()
    caches, logits = encdec.encdec_prefill(model, cfg, batch, max_len)
    torch.cuda.synchronize()
    print(f"  whisper-base encdec_prefill ({WH_ROWS} x {cfg.frontend_tokens} "
          f"frames, {WH_PROMPT} tokens): wall {(time.perf_counter() - t0) * 1e3:.2f} ms",
          flush=True)
    tok = logits[:, -1].argmax(-1)
    pos = torch.tensor(WH_PROMPT, device="cuda")
    _step_split(torch, f"whisper-base decode step ({WH_ROWS} rows, cross "
                f"over {cfg.frontend_tokens} frames)",
                lambda: encdec.encdec_decode_step(model, cfg, caches, tok,
                                                  pos))
    del caches, model, eng
    _free(torch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "whisper-base", "--requests", str(WH_ROWS),
                    "--prompt-len", str(WH_PROMPT), "--gen", str(WH_GEN)])
    blob = json.loads(out.getvalue())
    keys = {"arch", "mode", "requests", "generated_tokens", "steady_wall_s",
            "tokens_per_s", "sample", "device", "device_name"}
    if set(blob) != keys or blob["mode"] != "legacy-audio":
        raise AssertionError(f"launcher blob {sorted(blob)}")
    print("  whisper-base launcher " + json.dumps(blob), flush=True)
    _free(torch)
    paths["audio_train"], _, _, trainer = _train_run(
        torch, cfg, 2, "whisper-base spt train", seq=WH_DEC)
    del trainer
    _free(torch)
    return paths


def _families_small(torch, name):
    """Phase 22's f32 configs: phi-3-vision cut to 4 layers at d 1536 (16
    heads of 96 kept at M 12, F 4096, the 576 frontend rows kept),
    mamba2-780m cut to 4 layers, whisper-base to 2 + 2 layers (full
    width)."""
    from repro_torch import configs
    cfg = configs.get_config(name)
    kw = {"phi-3-vision-4.2b": dict(num_layers=4, d_model=1536,
                                    num_heads=16, num_kv_heads=16,
                                    d_ff=4096),
          "mamba2-780m": dict(num_layers=4),
          "whisper-base": dict(num_layers=2, encoder_layers=2)}[name]
    return dataclasses.replace(cfg, dtype=torch.float32,
                               **kw).with_spt(**SERVE_CFG)


def _f32_model(torch, cfg):
    model = _perturbed_model(torch, cfg, seed=3)
    return model.to(torch.float32)


def _f32_state(torch, cfg):
    from repro_torch.train.state import init_state
    state = init_state(cfg, seed=5, device="cuda")
    state["frozen"] = _map_tree(lambda t: t.float(), state["frozen"])
    gen = torch.Generator(device="cuda").manual_seed(6)
    for _, v in _c_leaves(state):
        v.copy_(torch.randn(v.shape, device="cuda", generator=gen) * 0.01)
    return state, gen


def _f32_batch(torch, cfg, seq):
    from repro_torch.launch.train import with_frontend
    batch = next(with_frontend(_batches(cfg, 2, seq, 1, seed=7), cfg,
                               seed=8))
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def _audio_streams(torch, model, cfg, batch, steps):
    """generate() greedy tokens with the kernels and under
    REPRO_DISABLE_KERNELS=1 (checked by _both_modes)."""
    from repro_torch.serving.engine import Engine
    eng = Engine(cfg, model, max_len=batch["tokens"].shape[1] + steps + 8)
    return _both_modes(lambda: eng.generate(batch, steps).tokens)


def _compare_audio(torch, model, cfg, batch, got, want, label):
    """got == want per row except past a logit near-tie (<= 1e-3) at the
    first divergence, replayed through encdec_prefill with the kernels
    off."""
    from repro_torch.models import encdec
    os.environ["REPRO_DISABLE_KERNELS"] = "1"
    flips = 0
    try:
        for i, (g, w) in enumerate(zip(got, want)):
            if g == w:
                continue
            t = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
            ctx = batch["tokens"][i].tolist() + w[:t]
            _, logits = encdec.encdec_prefill(
                model, cfg, {"tokens": torch.tensor([ctx], device="cuda"),
                             "frontend_embeds":
                                 batch["frontend_embeds"][i:i + 1]},
                len(ctx) + 8)
            lg = logits[0, -1].float().cpu().numpy()
            gap = float(lg.max()) - min(float(lg[g[t]]), float(lg[w[t]]))
            if gap > 1e-3:
                raise AssertionError(f"{label}: row {i} diverged at step {t} "
                                     f"with a logit gap {gap:.3e}")
            flips += 1
    finally:
        os.environ.pop("REPRO_DISABLE_KERNELS", None)
    print(f"  f32 greedy streams, {label} == REPRO_DISABLE_KERNELS=1 for "
          f"{len(got) - flips}/{len(got)} rows, {flips} replayed near-tie "
          "flips (<= 1e-3)", flush=True)


def families_agree_f32(torch):
    """Phase 22, kernels on against REPRO_DISABLE_KERNELS=1 in f32:
    phi-3-vision (4 layers, d 1536): greedy streams of 8 requests
    (frontend rows, prompts 64-512, 16 new tokens, 4 slots) up to the
    near-tie replay rule (kernels 6, 9, 10 launch, the oracle none), one
    train step at 2 x (576 + 256) by the step rule with gradient cosine
    >= 0.999; mamba2-780m (4 layers): the same rules with and without
    the switch (it has nothing to turn off), no launch in either;
    whisper-base (2 +
    2 layers): generate of 4 rows over 1500 frames, 16 new tokens, up to
    the near-tie rule, and a train step at 2 x 256 by the step rule
    (cosine >= 0.999)."""
    from repro_torch import kernels
    from repro_torch.launch.steps import loss_and_grads
    # phi-3-vision
    cfg = _families_small(torch, "phi-3-vision-4.2b")
    reqs = _requests(8, 64, 512, 16, cfg.vocab_size, seed=4,
                     frontend=_frontend(cfg))
    model = _f32_model(torch, cfg)
    before = {w.__name__: w.launches for w in kernels.wrappers()}
    with _choices(torch) as log:
        oracle, ran = _streams(torch, model, cfg, reqs, False, max_len=2048)
    with _held_to_plain(torch) as errs, _choices(torch, log) as ties:
        got, ran_k = _streams(torch, model, cfg, reqs, True, max_len=2048)
    moved = {w.__name__ for w in kernels.wrappers()
             if w.launches != before[w.__name__]}
    if ran or ran_k != {"fused_sparse_decode_attention"} or not {
            "grouped_ffn", "decode_ffn"} <= moved:
        raise AssertionError(f"phi-3-vision: oracle ran {ran}, kernels "
                             f"{sorted(moved)}")
    _gated_streams(torch, model, cfg, reqs, got, oracle, errs, ties.first,
                   "4-layer phi-3-vision f32", max_len=2048)
    del model
    _free(torch)
    state, gen = _f32_state(torch, cfg)
    _step_agreement(torch, cfg, state, _f32_batch(torch, cfg, 256), gen,
                    "4-layer f32 phi-3-vision train step", min_cos=0.999)
    del state
    _free(torch)
    # mamba2: the switch has nothing to turn off; no launch either way
    cfg = _families_small(torch, "mamba2-780m")
    reqs = _requests(8, 64, 512, 16, cfg.vocab_size, seed=4)
    model = _f32_model(torch, cfg)
    before = [w.launches for w in kernels.wrappers()]
    oracle, _ = _streams(torch, model, cfg, reqs, False)
    got, _ = _streams(torch, model, cfg, reqs, True)
    _compare_streams(torch, model, cfg, reqs, "4-layer mamba2-780m f32", got,
                     oracle)
    del model
    _free(torch)
    state, _ = _f32_state(torch, cfg)
    batch = _f32_batch(torch, cfg, 512)
    lk, _, gk = loss_and_grads(state, cfg, batch)
    os.environ["REPRO_DISABLE_KERNELS"] = "1"
    try:
        lo, _, go = loss_and_grads(state, cfg, batch)
    finally:
        del os.environ["REPRO_DISABLE_KERNELS"]
    if [w.launches for w in kernels.wrappers()] != before:
        raise AssertionError("mamba2-780m: a kernel launched")
    from repro_torch.core.params import leaves
    fk, fo = (torch.cat([a.flatten() for _, a in leaves(g)]) for g in (gk, go))
    rel = abs(float(lk) - float(lo)) / abs(float(lo))
    cos = float(torch.dot(fk, fo) / (fk.norm() * fo.norm()))
    if rel > 1e-4 or cos < 0.999:
        raise AssertionError(f"mamba2-780m train step: loss rel {rel:.2e}, "
                             f"gradient cosine {cos:.6f}")
    print(f"  4-layer f32 mamba2-780m train step: loss {float(lk):.6f}, rel "
          f"{rel:.2e}, gradient cosine {cos:.6f} with and without "
          f"REPRO_DISABLE_KERNELS=1 (bit-identical: "
          f"{bool(torch.equal(fk, fo))}); no kernel launched", flush=True)
    del state
    _free(torch)
    # whisper-base
    cfg = _families_small(torch, "whisper-base")
    model = _f32_model(torch, cfg)
    batch = _audio_batch(torch, cfg, 4, WH_PROMPT, 9)
    before = {w.__name__: w.launches for w in kernels.wrappers()}
    with _held_to_plain(torch) as errs:
        got, oracle = _audio_streams(torch, model, cfg, batch, 16)
    moved = {w.__name__ for w in kernels.wrappers()
             if w.launches != before[w.__name__]}
    if not {"fused_sparse_decode_attention", "decode_ffn", "grouped_ffn",
            "sparse_attention"} <= moved:
        raise AssertionError(f"whisper-base: kernels {sorted(moved)}")
    print(f"  whisper-base: kernels 6, 9, 10 = their plain versions on the "
          f"inputs of each of their {len(errs)} calls (max abs err "
          f"{max(errs):.3e}, rule {F32_TOL})", flush=True)
    _compare_audio(torch, model, cfg, batch, got, oracle,
                   "2 + 2-layer whisper-base f32")
    top1 = cfg.with_spt(attn_top_fraction=1.0)
    got, oracle = _audio_streams(torch, model, top1, batch, 16)
    _compare_audio(torch, model, top1, batch, got, oracle,
                   "2 + 2-layer whisper-base f32, top-L 1")
    del model
    _free(torch)
    state, gen = _f32_state(torch, cfg)
    _step_agreement(torch, cfg, state, _f32_batch(torch, cfg, 256), gen,
                    "2 + 2-layer f32 whisper-base train step", min_cos=0.999)
    del state
    _free(torch)


# ------------------------------------------------------------ phase 24
# Multi-GPU fine-tuning on one card.  NCCL refuses two ranks on one
# device, so the card runs a world of one: the kernels at the shapes
# qwen3-0.6b's shards give them under model = 2 and 4 (each rank's 8/4
# and 4/2 heads of 128; each group's 192 and 96 hidden columns), then
# the mesh path (the launcher's process group, a (1, 1) mesh, the rules)
# at full width and depth, against the no-mesh Trainer.  Worlds of 2 and
# 4 run on the CPU over gloo (tests/test_torch_multigpu.py).
MESH_TP = (2, 4)
MESH_STEPS = 3
MESH_DEPTH = 14          # of qwen3's 28 layers (all 28 until phase 28 came)
MESH_LOSS_TOL = 1e-3


def check_mesh_shapes(torch, gen):
    """Kernels 1, 2 and 4 at qwen3-0.6b's local heads for model 2 and 4
    (16/8 heads over n ranks, dh 128, M 16, the 4 x 1024 training step,
    causal, rep 2), kernel 9 at each group's F / n columns (d 1024, 8
    groups, top 4, SwiGLU, LoRA r 16, 4 x 1024 rows): launched twice
    bit-identically, against the plain versions as phase 3 holds them,
    timed beside the bound and the yardstick (kernel 1: baddbmm + argmin;
    kernel 4: SDPA over the same selection as a mask; kernel 9: torch
    bf16).  Returns {wrapper name: [case rows]}."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.pq_quantize import ops as pq_ops
    from repro_torch.kernels.routed_ffn import ops as ffn_ops
    from repro_torch.kernels.sparse_attention import ops as sa_ops
    from repro_torch.kernels.sparse_attention import ref as sa_ref
    from repro_torch.kernels.topl_select import ops as topl_ops
    from repro_torch.kernels.topl_select.ref import (masked_scores,
                                                     thresholds_ref)
    bf16, tag, out = torch.bfloat16, "mesh", {}
    cb = _codebooks(torch, gen)
    for n in MESH_TP:
        hq, hk = HQ // n, HK // n
        label = f"model={n} ({hq}/{hk} heads)"
        for what, heads in (("q", hq), ("k", hk)):
            case = f"{label} {what} (x ({TB * heads}, {TS}, {DH}), M={M_BOOKS})"
            x = torch.randn(TB * heads, TS, DH, device="cuda",
                            generator=gen).to(bf16)
            codes = _twice(torch, lambda: pq_ops.pq_assign(x, cb),
                           f"pq_assign {case}")
            flips, _ = _margin_flips(torch, codes, x, cb, case)
            ms = time_ms(lambda: pq_ops.pq_assign(x, cb), 30)
            yard = time_ms(lambda: pq_yardstick(torch, x, cb), 10)
            _paper_row(out, "pq_assign", case, ms,
                       cost.pq_assign(x, cb).bound_ms(), float(flips), yard,
                       tag=tag)
        cq, ck = _train_codes(torch, gen, TS, TS, TB * hq, TB * hk)
        sel = dict(causal=True, window=None, q_offset=0, heads_per_batch=hq,
                   rep=hq // hk)
        kw = dict(l=_top_l(TS), max_score=M_BOOKS, **sel)
        case = f"{label} (G={TB * hq}, nq=nk={TS}, M={M_BOOKS}, causal)"
        thr = _twice(torch, lambda: topl_ops.topl_thresholds(cq, ck, **kw),
                     f"topl_thresholds {case}")
        if not torch.equal(thr, thresholds_ref(cq, ck, **kw)):
            raise AssertionError(f"topl_thresholds {case}: [t, need] differ")
        sm = masked_scores(cq, ck, **sel)
        ms = time_ms(lambda: topl_ops.topl_thresholds(cq, ck, **kw), 30)
        _paper_row(out, "topl_thresholds", case, ms,
                   cost.topl_thresholds(cq, ck, **kw).bound_ms(), 0.0,
                   tag=tag)
        kept = sa_ref.newest_ties(sm, thr)                  # (G, nq, nk)
        del sm
        q = torch.randn(TB * hq, TS, DH, device="cuda", generator=gen).to(bf16)
        k, v = (torch.randn(TB * hk, TS, DH, device="cuda",
                            generator=gen).to(bf16) for _ in range(2))
        akw = dict(scale=DH ** -0.5, **sel)
        got = _twice(torch, lambda: sa_ops.sparse_attention(
            q, k, v, cq, ck, thr, **akw), f"sparse_attention {case}")
        err = close(got, sa_ref.sparse_attention_ref(q, k, v, cq, ck, thr,
                                                     **akw), BF16_TOL)
        ms = time_ms(lambda: sa_ops.sparse_attention(q, k, v, cq, ck, thr,
                                                     **akw), 20)
        rows = kept.reshape(TB * hk, hq // hk * TS, TS).any(1)
        bnd = cost.sparse_attention(
            q, k, v, cq, ck, thr, **akw, pairs=int(kept.sum()),
            rows_read=int(rows.sum())).bound_ms()
        kv = torch.arange(TB * hq, device="cuda") // (hq // hk)
        q4, k4, v4 = (t.reshape(TB, hq, TS, DH) for t in (q, k[kv], v[kv]))
        mask = kept.reshape(TB, hq, TS, TS)
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, scale=DH ** -0.5), 20)
        _paper_row(out, "sparse_attention", f"{case} bf16", ms, bnd, err,
                   sdpa, tag=tag)
        del kept, mask, q4, k4, v4
        f = 3072 // 8 // n
        cs = _grouped_case(torch, gen, "bfloat16", b=TB, s=TS, d=1024, f=f,
                           g=8, ga=4, r=16, capf=1.25, act="silu",
                           gated=True)
        args = cs["args"]
        ms = time_ms(lambda: ffn_ops.grouped_ffn(*args, act="silu"), 10)
        lora16 = _bf16_lora(torch, cs["lora"])
        yard = time_ms(lambda: grouped_ffn_yardstick(
            torch, cs["x"], cs["plan"].index, cs["wts"], lora16, 1.0), 10)
        _paper_row(out, "grouped_ffn", f"model={n} train (x ({TB}, {TS}, "
                   f"1024), F={f} of 384, silu gated, C={cs['c']}, LoRA "
                   "r=16)", ms, _grouped_bound(cs),
                   cs["err"], yard, tag=tag)
    return out


def _mesh_run(torch, cfg, mesh, label, steps=MESH_STEPS, keep=False):
    """``steps`` steps of Trainer.run (under ``mesh`` when given) on the
    seeded 4 x 1024 stream, counters zeroed just before and read just
    after.  Returns (losses, launches, step seconds), and the trainer
    with ``keep``."""
    from repro_torch import kernels
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    trainer = _trainer_here(lambda: Trainer(
        cfg, OptimizerConfig(lr=1e-3, total_steps=steps),
        TrainerConfig(total_steps=steps, log_interval=1), seed=0,
        device="cuda", mesh=mesh))
    losses = []
    wrappers = kernels.wrappers()
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    trainer.run(_batches(cfg, TB, TS, steps, seed=0),
                step_hook=lambda step, m: losses.append(m["loss"]))
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    times = list(trainer.monitor.times)
    print(f"  {label}: losses {json.dumps(losses)}; step s "
          f"{json.dumps(times)}; launches {json.dumps(launches)}", flush=True)
    if keep:
        return losses, launches, times, trainer
    del trainer
    _free(torch)
    return losses, launches, times


def mesh_train(torch):
    """Phase 24's world of one: an NCCL process group of one rank (the
    launchers' init_distributed), a (1, 1) mesh, full-width qwen3-0.6b at
    MESH_DEPTH layers, spt, bf16, 4 x 1024, under deterministic algorithms:
    MESH_STEPS steps without the mesh, then through the mesh path with the
    default ffn_impl (losses bit for bit those of the run without it) and
    with "grouped_shmap" (core/ffn_shmap.py; losses within
    MESH_LOSS_TOL), launches exact (_want_train_launches).  The process
    group is destroyed at the end."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    cfg = _train_cfg(torch, num_layers=MESH_DEPTH)
    shmap_cfg = cfg.with_spt(ffn_impl="grouped_shmap")
    torch.use_deterministic_algorithms(True, warn_only=True)
    rank, world, dev = init_distributed("cuda")
    try:
        if (rank, world) != (0, 1) or dist.get_backend() != "nccl":
            raise AssertionError(f"rank {rank} of {world} on "
                                 f"{dist.get_backend()}, want NCCL 0 of 1")
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        base, _, t_base = _mesh_run(torch, cfg, None, "no mesh")
        got, launches, t_mesh = _mesh_run(torch, cfg, mesh, "mesh (1, 1)")
        shm, launches_shm, t_shm = _mesh_run(torch, shmap_cfg, mesh,
                                             "mesh (1, 1) grouped_shmap")
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
    if got != base:
        raise AssertionError(f"mesh losses {got} != no-mesh {base}")
    diff = max(abs(a - b) for a, b in zip(shm, base))
    if len(shm) != MESH_STEPS or not diff <= MESH_LOSS_TOL:
        raise AssertionError(f"grouped_shmap losses {shm} vs {base}: max "
                             f"diff {diff} beyond {MESH_LOSS_TOL}")
    for label, c, n in (("mesh", cfg, launches),
                        ("grouped_shmap", shmap_cfg, launches_shm)):
        want = _want_train_launches(c, n, MESH_STEPS)
        if n != want:
            raise AssertionError(f"{label} launches {n} != expected {want}")
    print(f"  mesh: the (1, 1) mesh's losses equal the no-mesh run's bit for "
          f"bit; grouped_shmap within {diff:.3e}; mean step s no mesh "
          f"{statistics.fmean(t_base):.4f}, mesh {statistics.fmean(t_mesh):.4f}"
          f", grouped_shmap {statistics.fmean(t_shm):.4f}; {card_line()}",
          flush=True)
    return {"mesh_train": launches, "mesh_train_shmap": launches_shm}


# Phase 25: the decode kernels at the shard shapes of serving under model
# 2 and 4 — qwen3-0.6b's 16/8 heads of 128 (M 16) over n ranks, and
# recurrentgemma-9b's 16 heads on its one kv head of 256 (M 32; the kv
# head stays whole on every rank) over its full 2,048-slot ring — at 8
# slots; kernel 10 at each group's F / n columns.
MESH_SERVE_EDGES = [
    ("qwen3-0.6b model=2: 8/4 heads", 8, 4, 2, 128, "qhead", False, False,
     SM),
    ("qwen3-0.6b model=4: 4/2 heads", 8, 2, 2, 128, "qhead", False, False,
     SM),
    ("recurrentgemma-9b model=2: 8/1 heads", 8, 1, 8, 256, "qhead", False,
     False, 32, HYBRID_RING),
    ("recurrentgemma-9b model=4: 4/1 heads", 8, 1, 4, 256, "qhead", False,
     False, 32, HYBRID_RING),
]
MESH_SERVE_FFN = [("qwen3-0.6b", 1024, 384, "silu"),
                  ("recurrentgemma-9b", 4096, 1536, "gelu")]
MESH_SERVE_WORK = dict(n=8, lo=128, hi=1024, gen=32, max_len=2048)
# depth of the world-of-one serves: phase 5's for qwen3-0.6b (4 of 28
# layers; 7 until phase 28 came), and recurrentgemma-9b's first 8 of 38
# (two units and the two-layer tail; 14 until the model shards came)
MESH_QWEN_DEPTH = PAGED_DEPTH
MESH_HYBRID_DEPTH = 8
# The model shards of each served case, every rank a thread on the one
# card (``_Ring``): the extents, a short bf16 serve (4 slots, chunks of
# 8) and, in f32 (contiguous cases), the teacher-forced logits of its 4
# prompts (one ragged prefill and SHARD_STEPS decode steps) against the
# unsharded model.  The logits' rule is f32's (bf16's rounding of the
# partial sums grows through a random model's layers, the hybrid's most)
# with top-L = every key: the per-head projections' GEMMs round
# differently at the local widths, and a PQ code or top-L choice that
# flips on that rounding moves a logit by far more than the rounding
# (the served fraction's error is printed beside).  A relative Frobenius
# error of at most SHARD_TOL, every rank's logits equal bit for bit, and
# the same run with the sums replaced by rank 0's part alone (a sharding
# fault) off by more than 100 x SHARD_TOL, so that the rule can see one.
SHARD_TP = {"mesh_serve": (2, 4), "mesh_serve_paged": (2,),
            "mesh_serve_hybrid": (2, 4)}
SHARD_WORK = dict(n=4, lo=64, hi=512, gen=12, max_len=1024)
SHARD_STEPS = 8
SHARD_TOL = 1e-3
RING_TIMEOUT_S = 300


def check_mesh_serve_shapes(torch, gen):
    """Kernels 3, 5, 6, 7 and 8 on MESH_SERVE_EDGES (check_decode_edges:
    bf16 and f32, twice bit-identically, against their plain versions,
    each edge timed in bf16), and kernel 10 at MESH_SERVE_FFN's F / n for
    n in MESH_TP (8 slots, 8 groups top 4, gated, LoRA r 16; bf16 and
    f32, twice bit-identically, the bf16 case timed beside its bound and
    the bf16 torch yardstick).  Returns {wrapper name: [case rows]}."""
    from repro_torch.core import routed_ffn as rf
    from repro_torch.kernels import cost
    from repro_torch.kernels.routed_ffn import ops, ref
    out = {}
    for edge in MESH_SERVE_EDGES:
        for name, cases in check_decode_edges(torch, gen, [edge], edge[0],
                                              tag="meshserve").items():
            out.setdefault(name, []).extend(cases)
    b, g, ga, r = 8, 8, 4, 16
    for label, d, f_group, act in MESH_SERVE_FFN:
        for n in MESH_TP:
            f = f_group // n
            for dtn in ("bfloat16", "float32"):
                dt = getattr(torch, dtn)
                rcfg = rf.RoutedFFNConfig(d_model=d, d_ff=f * g, num_groups=g,
                                          active_groups=ga, activation=act,
                                          gated=True)
                wts, lora = _ffn_weights(torch, gen, g, d, f, r, dt)
                x = torch.randn(b, d, device="cuda", generator=gen).to(dt)
                router = (torch.randn(d, g, device="cuda", generator=gen)
                          / d ** 0.5)
                choice, gate, _ = rf.route(x[:, None], router, rcfg,
                                           need_aux=False)
                choice, gate = choice[:, 0].contiguous(), gate[:, 0].contiguous()
                args = (x, choice, gate, wts["w_inner"], wts["w_outer"],
                        wts["w_gate"], lora, 1.0)
                case = (f"{label} model={n} (x ({b}, {d}), F={f} of "
                        f"{f_group}, G'={ga} of {g}, {act} gated, LoRA r={r})")
                y = _twice(torch, lambda: ops.decode_ffn(*args, act=act),
                           f"decode_ffn {case} {dtn}")
                err = close(y, ref.decode_ffn_ref(*args, act=act),
                            BF16_TOL if dt == torch.bfloat16 else F32_TOL)
                print(f"  decode_ffn {case} {dtn}: max_abs_err {err:.3e}, "
                      "bit-identical", flush=True)
                if dt != torch.bfloat16:
                    continue
                ms = time_ms(lambda: ops.decode_ffn(*args, act=act), 30)
                yard = time_ms(lambda: decode_ffn_yardstick(
                    torch, x, choice, gate, wts, _bf16_lora(torch, lora), 1.0,
                    act=act), 30)
                bnd = cost.decode_ffn(*args, act=act, blocks=int(
                    torch.unique(choice).numel())).bound_ms()
                _paper_row(out, "decode_ffn", case, ms, bnd, err, yard,
                           tag="meshserve")
    return out


_STAT_COUNTS = ("prefill_tokens", "decode_tokens", "decode_steps",
                "admitted", "completed", "prefill_batches", "preemptions",
                "rejections", "cancelled", "shed", "page_size",
                "kv_pages_total", "kv_pages_peak", "admission_stalls")


def _mesh_serve_run(torch, model, cfg, label, mesh, kv_pages=None):
    """Engine.run of MESH_SERVE_WORK on 8 slots (under ``mesh`` when
    given) after a warm-up, counters zeroed just before and read just
    after.  Returns (streams, launches, ServeStats' counters, wall s);
    launch counts exact."""
    from repro_torch import kernels
    from repro_torch.serving.engine import Engine
    work = MESH_SERVE_WORK
    eng = Engine(cfg, model, max_len=work["max_len"], num_slots=8,
                 decode_chunk=16, kv_pages=kv_pages, mesh=mesh)
    eng.run(_requests(2, 16, 32, 4, cfg.vocab_size, seed=1))     # warm-up
    reqs = _requests(work["n"], work["lo"], work["hi"], work["gen"],
                     cfg.vocab_size, seed=2)
    wrappers = kernels.wrappers()
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    st = eng.last_stats
    want = _want_serve_launches(cfg, launches, eng.last_steps_run,
                                st.prefill_batches)
    if launches != want:
        raise AssertionError(f"{label} launches {launches} != expected {want}")
    counts = {k: getattr(st, k) for k in _STAT_COUNTS}
    print(f"  {label}: {wall:.2f} s, decode {st.decode_tok_s:.1f} tok/s, "
          f"prefill {st.prefill_tok_s:.1f} tok/s; ServeStats counters "
          f"{json.dumps(counts)}; launches {json.dumps(launches)}",
          flush=True)
    return [(c.tokens, c.finish_reason) for c in outs], launches, counts, wall


class _Ring:
    """The model axis of ``n`` serving ranks on one card: each rank is a
    thread, and one runs at a time.  The turn passes in rank order at
    each collective, whose result the last rank takes once (the parts
    summed, or joined, in rank order) and every rank shares; so each
    rank's kernels see the shard shapes of a (1, n) mesh and the launch
    counters count every rank exactly.  ``fault``: a sum returns rank
    0's part alone (the negative control of the logits rule)."""

    def __init__(self, n):
        import threading
        self.n, self.turn, self.parts, self.out = n, 0, [None] * n, None
        self.cv, self.error, self.fault = threading.Condition(), None, False

    def wait(self, r):
        with self.cv:
            if not self.cv.wait_for(lambda: self.turn == r or self.error,
                                    timeout=RING_TIMEOUT_S):
                self.error = f"rank {r} waited {RING_TIMEOUT_S} s"
                self.cv.notify_all()
            if self.error:
                raise RuntimeError(f"model shard {r}: {self.error}")

    def done(self, r, error=None):
        with self.cv:
            if error is not None and self.error is None:
                self.error = f"rank {r} failed: {error!r}"
            self.turn = (r + 1) % self.n
            self.cv.notify_all()

    def exchange(self, r, x, combine):
        self.parts[r] = x
        if r == self.n - 1:
            self.out, self.parts = combine(self.parts), [None] * self.n
        self.done(r)
        self.wait(r)
        return self.out.clone()              # each rank its own tensor

    def sum(self, parts):
        out = parts[0].clone()
        if not self.fault:
            for x in parts[1:]:
                out += x
        return out


def _on_shards(torch, shards, work):
    """``work(r, shard)`` on every rank of the ShardedLMs ``shards`` (one
    _Ring), each in its thread, with the serving path's model-axis
    collectives (``model_sum``, ``region_sum``, ``gather``, and a split
    sequence's ``stack_ranks`` and ``model_scatter``) taken over the
    ring.  Returns the ranks' results; re-raises a rank's error."""
    import threading
    from repro_torch.core import collectives as C
    ring = shards[0].shard.ax.group
    out = [None] * ring.n

    def body(r):
        err = None
        try:
            ring.wait(r)
            with torch.no_grad():
                out[r] = work(r, shards[r])
        except BaseException as e:          # noqa: BLE001 (re-raised)
            err = out[r] = e
        finally:
            ring.done(r, err)

    def total(x, ax):
        return x if ax is None else ax.group.exchange(ax.rank, x, ring.sum)

    def joined(x, dim, ax):
        return x if ax is None else ax.group.exchange(
            ax.rank, x, lambda parts: torch.cat(parts, dim))

    def stacked(x, ax):
        return ax.group.exchange(ax.rank, x, torch.stack)

    def scattered(x, dim, ax):
        return ax.group.exchange(ax.rank, x, ring.sum).chunk(
            ax.size, dim)[ax.rank].contiguous()

    names = ("model_sum", "region_sum", "gather", "stack_ranks",
             "model_scatter")
    orig = {k: getattr(C, k) for k in names}
    C.model_sum, C.region_sum, C.gather = total, total, joined
    C.stack_ranks, C.model_scatter = stacked, scattered
    try:
        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(ring.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(RING_TIMEOUT_S * 2)
            if t.is_alive():
                raise AssertionError("a model shard's thread hangs")
    finally:
        for k in names:
            setattr(C, k, orig[k])
    for o in out:
        if isinstance(o, BaseException):
            raise o
    return out


def _teacher_logits(torch, model, cfg, prompts, feed, max_len):
    """f32 logits (1 + steps, B, V) of one ragged prefill of ``prompts``
    and a decode step for each column of ``feed`` (B, steps), fed its
    tokens; with ``feed`` an int, that many steps fed their own argmax.
    Returns (logits, feed)."""
    from repro_torch.models import transformer
    dev = model.device
    b, p = len(prompts), max(map(len, prompts))
    toks = torch.zeros((b, p), dtype=torch.long, device=dev)
    for i, t in enumerate(prompts):
        toks[i, :len(t)] = torch.tensor(t, device=dev)
    pos = torch.tensor([len(t) for t in prompts], device=dev)
    caches, logits = transformer.lm_prefill_ragged(
        model, cfg, {"tokens": toks}, pos, max_len)
    out = [logits[:, -1].float()]
    greedy = isinstance(feed, int)
    steps = feed if greedy else feed.shape[1]
    fed = []
    slot_ids = torch.arange(max_len, device=dev)[None]
    for t in range(steps):
        tok = out[-1].argmax(-1) if greedy else feed[:, t]
        fed.append(tok)
        lg = transformer.lm_decode_step(model, cfg, caches, tok, pos,
                                        kv_valid=slot_ids <= pos[:, None])
        out.append(lg[:, -1].float())
        pos = pos + 1
    return torch.stack(out), torch.stack(fed, 1)


def _logit_errors(got, want):
    d = (got - want).float()
    return float(d.abs().max()), float(d.norm() / want.float().norm())


def _shard_checks(torch, model, cfg, label, kv_pages):
    """The model shards of one served case at each extent of
    SHARD_TP[label].  bf16: each rank's local counts; SHARD_WORK served
    through Engine.run on every rank at once, counters zeroed just
    before and read just after: every rank's streams alike, the launches
    n times one rank's exact count, ServeStats' counters equal to the
    unsharded serve's.  Then (contiguous cases), with ``model`` cast to
    f32 in place, the teacher-forced logits against the unsharded
    model's, launches n times exact: with every key selected under the
    SHARD_TOL rule and its fault control, at the served top-L fraction
    shown.  Returns the serves' launches summed over the extents."""
    from repro_torch import kernels
    from repro_torch.core import collectives as C
    from repro_torch.models import attention, transformer
    from repro_torch.serving.engine import Engine
    w = SHARD_WORK
    reqs = _requests(w["n"], w["lo"], w["hi"], w["gen"], cfg.vocab_size,
                     seed=3)

    def split(n):           # the caches' sequence splits over model n
        return kv_pages is None and attention.seq_parts(
            cfg.num_kv_heads, attention.cache_size(w["max_len"], cfg.window),
            n) > 1

    def shards_of(m, c, n):
        ring = _Ring(n)
        return [transformer.ShardedLM(m, c, C.Axis(ring, n, r))
                for r in range(n)]

    def serve(m):
        eng = Engine(cfg, m, max_len=w["max_len"], num_slots=4,
                     decode_chunk=8, kv_pages=kv_pages)
        outs = eng.run(reqs)
        st = eng.last_stats
        return ([c.tokens for c in outs], eng.last_steps_run,
                {k: getattr(st, k) for k in _STAT_COUNTS})

    base = serve(model)
    wrappers = kernels.wrappers()
    total = {wr.__name__: 0 for wr in wrappers}
    for n in SHARD_TP[label]:
        shards = shards_of(model, cfg, n)
        lc = shards[0].cfg
        counts = (lc.num_heads, lc.num_kv_heads, lc.d_ff, lc.lru_width)
        want = (cfg.num_heads // n,
                cfg.num_kv_heads // n if cfg.num_kv_heads % n == 0
                else 1, cfg.d_ff // n,
                cfg.lru_width // n if "rec" in cfg.pattern else
                cfg.lru_width)
        if counts != want:
            raise AssertionError(f"{label} model={n}: local (heads, kv "
                                 f"heads, d_ff, lru) {counts} != {want}")
        torch.cuda.synchronize()
        for wr in wrappers:
            wr.launches = 0
        got = _on_shards(torch, shards, lambda r, sh: serve(sh))
        torch.cuda.synchronize()
        launches = {wr.__name__: wr.launches for wr in wrappers}
        streams, steps, stats = got[0]
        if any(g != got[0] for g in got[1:]):
            raise AssertionError(f"{label} model={n}: the ranks' serves "
                                 "differ")
        one = _want_serve_launches(cfg, launches, steps,
                                   stats["prefill_batches"], split(n))
        if launches != {k: n * v for k, v in one.items()}:
            raise AssertionError(f"{label} model={n}: launches {launches} "
                                 f"!= {n} x {one}")
        if stats != base[2]:
            raise AssertionError(f"{label} model={n}: ServeStats counters "
                                 f"{stats} != unsharded {base[2]}")
        same = sum(a == b for a, b in zip(streams, base[0]))
        print(f"  {label} model={n}, bf16: local (heads, kv heads, d_ff, "
              f"lru) {counts}; serve of {len(streams)} requests on every "
              f"rank alike, {same} streams = unsharded, ServeStats "
              f"counters equal, launches {n} x exact", flush=True)
        for k, v in launches.items():
            total[k] += v
        del shards
        _free(torch)
    if kv_pages is not None:         # the contiguous case's arithmetic
        return total
    model.to(torch.float32)
    prompts = [r.tokens for r in reqs]
    for frac in (1.0, cfg.spt.attn_top_fraction):
        # checked with every key selected; at the served fraction shown
        c32 = dataclasses.replace(cfg, dtype=torch.float32).with_spt(
            attn_top_fraction=frac)
        with torch.no_grad():
            ref, feed = _teacher_logits(torch, model, c32, prompts,
                                        SHARD_STEPS, w["max_len"])
        for n in SHARD_TP[label]:
            shards = shards_of(model, c32, n)
            ring = shards[0].shard.ax.group

            def logits(r, sh):
                return _teacher_logits(torch, sh, sh.cfg, prompts, feed,
                                       w["max_len"])[0]
            torch.cuda.synchronize()
            for wr in wrappers:
                wr.launches = 0
            lg = _on_shards(torch, shards, logits)
            torch.cuda.synchronize()
            launches = {wr.__name__: wr.launches for wr in wrappers}
            one = _want_serve_launches(c32, launches, SHARD_STEPS, 1,
                                       split(n))
            if launches != {k: n * v for k, v in one.items()}:
                raise AssertionError(f"{label} model={n} f32: launches "
                                     f"{launches} != {n} x {one}")
            if not all(torch.equal(x, lg[0]) for x in lg[1:]):
                raise AssertionError(f"{label} model={n}: the ranks' "
                                     "logits differ")
            err, rel = _logit_errors(lg[0], ref)
            rel0 = _logit_errors(lg[0][0], ref[0])[1]
            what = (f"{label} model={n}, f32, top-L {frac:g} of the keys: "
                    f"logits of 4 prompts (one ragged prefill + "
                    f"{SHARD_STEPS} decode steps, launches {n} x exact) vs "
                    f"unsharded: max abs err {err:.3e}, relative {rel:.3e} "
                    f"(prefill {rel0:.3e}), every rank's alike")
            if frac == 1.0:
                ring.fault = True
                bad = _logit_errors(_on_shards(torch, shards, logits)[0],
                                    ref)[1]
                if rel > SHARD_TOL or bad <= 100 * SHARD_TOL:
                    raise AssertionError(
                        f"{what}; rule <= {SHARD_TOL}, and with rank 0's "
                        f"partial sums alone {bad:.3e} must exceed "
                        f"{100 * SHARD_TOL}")
                what += (f" (rule <= {SHARD_TOL}); rank 0's partial sums "
                         f"alone {bad:.3e}")
            else:
                what += " (shown: discrete top-L selection, not held)"
            print("  " + what, flush=True)
            del shards, lg
            _free(torch)
    return total


def mesh_serve(torch):
    """Phase 25's world of one: an NCCL process group of one rank, a
    (1, 1) mesh; qwen3-0.6b (MESH_QWEN_DEPTH layers) contiguous and paged on
    PAGED_POOL pages, recurrentgemma-9b (MESH_HYBRID_DEPTH layers), each
    served without the mesh and through it: streams, launches and the
    ServeStats counters equal bit for bit; then each case's model shards
    (``_shard_checks``).  The process group is destroyed at the end.
    Returns the mesh runs' launches by path, the shards' under
    "mesh_serve_shards"."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.mesh import init_distributed, make_mesh
    qwen = dataclasses.replace(configs.get_config("qwen3-0.6b"),
                               num_layers=MESH_QWEN_DEPTH).with_spt(
                                   **SERVE_CFG)
    hyb = dataclasses.replace(configs.get_config("recurrentgemma-9b"),
                              num_layers=MESH_HYBRID_DEPTH).with_spt(
                                  **SERVE_CFG)
    cases = [("mesh_serve", qwen, None), ("mesh_serve_paged",
              qwen.with_spt(**PAGED), PAGED_POOL),
             ("mesh_serve_hybrid", hyb, None)]
    rank, world, _ = init_distributed("cuda")
    paths, walls, shard_launches = {}, {}, []
    try:
        if (rank, world) != (0, 1) or dist.get_backend() != "nccl":
            raise AssertionError(f"rank {rank} of {world} on "
                                 f"{dist.get_backend()}, want NCCL 0 of 1")
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        for path, cfg, pages in cases:
            _free(torch)
            model = _perturbed_model(torch, cfg, seed=0)
            base = _mesh_serve_run(torch, model, cfg, f"{path} no mesh",
                                   None, pages)
            got = _mesh_serve_run(torch, model, cfg, f"{path} mesh (1, 1)",
                                  mesh, pages)
            for what, a, b in zip(("streams", "launches", "ServeStats"),
                                  got[:3], base[:3]):
                if a != b:
                    raise AssertionError(f"{path}: the mesh run's {what} "
                                         "differ from the run without it")
            paths[path], walls[path] = got[1], (base[3], got[3])
            shard_launches.append(_shard_checks(torch, model, cfg, path,
                                                pages))
            del model
    finally:
        dist.destroy_process_group()
    _free(torch)
    print("  mesh serve: streams, launches and ServeStats counters equal the "
          "runs without the mesh bit for bit; wall s (no mesh, mesh) "
          f"{json.dumps(walls)}; {card_line()}", flush=True)
    paths["mesh_serve_shards"] = {k: sum(t[k] for t in shard_launches)
                                  for k in shard_launches[0]}
    return paths


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


# ------------------------------------------------------------ phase 23
# Checkpoint/restart of the full-width qwen3-0.6b fine-tune: run A trains
# INFRA_STEPS steps; run B, a child process, the same run, signals itself
# SIGTERM after step INFRA_STOP and leaves its final checkpoint; run C, a
# fresh Trainer here, resumes from B's directory to INFRA_STEPS.  The
# three runs use torch's deterministic algorithms (the oracle backward's
# index adds otherwise accumulate with atomics, and AdamW's first steps,
# lr x sign(g), turn their last-bit differences into loss differences of
# ~1e-2), so B's and C's losses can be held to A's: within
# INFRA_LOSS_TOL, the largest difference printed.  Depth cut to
# INFRA_DEPTH of 28 layers at full width since phase 24, 7 since phase
# 25, 4 since its model shards (the checks do not depend on depth; the
# launch counts follow the layers).
INFRA_STEPS, INFRA_STOP, INFRA_LOSS_TOL = 6, 3, 2e-2
INFRA_DEPTH = 4
INFRA_DIR = ROOT / "build" / "infra"


def _infra_cfg(torch):
    return _train_cfg(torch, num_layers=INFRA_DEPTH)


def _infra_trainer(torch, ckpt_dir, **kw):
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    return Trainer(_infra_cfg(torch),
                   OptimizerConfig(lr=1e-3, total_steps=INFRA_STEPS),
                   TrainerConfig(total_steps=INFRA_STEPS,
                                 ckpt_dir=str(ckpt_dir), ckpt_interval=2,
                                 keep_checkpoints=2, log_interval=1),
                   device="cuda", **kw)


def _infra_batches(torch, start=0):
    import itertools
    return itertools.islice(_batches(_infra_cfg(torch), TB, TS,
                                     INFRA_STEPS, seed=0), start, None)


def _state_digest(state) -> dict:
    """sha256 of each leaf's bytes as the checkpoint stores them (None
    holes as None), by leaf path."""
    import hashlib
    from repro_torch.train import checkpoint
    out = {}
    for path, v in checkpoint._walk(state):
        out[path] = (None if v is None else hashlib.sha256(
            checkpoint._to_numpy(v)[0].tobytes()).hexdigest())
    return out


def _timed_saves(trainer) -> list:
    """Wall seconds of each checkpoint the trainer writes (a step already
    published is skipped and not timed)."""
    import torch
    from repro_torch.train import checkpoint
    times, save = [], trainer._save

    def timed(step):
        published = checkpoint.latest_step(trainer.tcfg.ckpt_dir) == step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(step)
        if not published:
            times.append(time.perf_counter() - t0)
    trainer._save = timed
    return times


def _loss_hook(rows, label, stop_at=None):
    def hook(step, m):
        rows.append({"step": step, "loss": m["loss"],
                     "grad_norm": m["grad_norm"]})
        print(f"  {label} step {json.dumps(rows[-1])}", flush=True)
        if step == stop_at:
            import signal
            os.kill(os.getpid(), signal.SIGTERM)    # this process only
    return hook


def infra_child(torch, ckpt_dir) -> int:
    """Run B of phase 23, in a child process: the fine-tune of run A,
    which sends itself SIGTERM after step INFRA_STOP; writes its report,
    losses and the digest of its final state beside ``ckpt_dir``."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    trainer = _infra_trainer(torch, ckpt_dir, seed=0)
    saves = _timed_saves(trainer)
    rows = []
    report = trainer.run(_infra_batches(torch),
                         step_hook=_loss_hook(rows, "B", INFRA_STOP))
    torch.cuda.synchronize()
    Path(str(ckpt_dir) + ".json").write_text(json.dumps({
        "final_step": report["final_step"],
        "interrupted": report["interrupted"],
        "straggler": report["straggler"], "rows": rows, "saves_s": saves,
        "digest": _state_digest(trainer.state)}))
    return 0


def infra_resume(torch):
    """Phase 23: runs A, B (a child, SIGTERM after step INFRA_STOP) and
    C (resumed from B's checkpoint); C's launches of kernels 1, 2, 4 and 9
    are counted and held to _want_train_launches for the steps C ran."""
    import shutil
    from repro_torch import kernels
    from repro_torch.train import checkpoint
    shutil.rmtree(INFRA_DIR, ignore_errors=True)
    a_dir, b_dir = INFRA_DIR / "a", INFRA_DIR / "b"
    cfg = _infra_cfg(torch)
    torch.use_deterministic_algorithms(True, warn_only=True)
    # A: uninterrupted
    trainer = _trainer_here(lambda: _infra_trainer(torch, a_dir, seed=0))
    saves_a, rows_a = _timed_saves(trainer), []
    rep_a = trainer.run(_infra_batches(torch),
                        step_hook=_loss_hook(rows_a, "A"))
    if rep_a["final_step"] != INFRA_STEPS or rep_a["interrupted"]:
        raise AssertionError(f"run A: {rep_a['final_step']} steps, "
                             f"interrupted {rep_a['interrupted']}")
    # the monitor's step times: from before the step to its metrics on
    # the host (checkpoint writes excluded)
    steps_a = list(trainer.monitor.times)
    del trainer
    _free(torch)
    # B: a child process, interrupted by its own SIGTERM
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--infra-child", str(b_dir)], capture_output=True,
                         text=True, timeout=900)
    print(out.stdout, end="", flush=True)
    if out.returncode != 0:
        raise AssertionError(f"run B exited {out.returncode}: "
                             f"{out.stderr[-4000:]}")
    b_wall = time.perf_counter() - t0
    b = json.loads(Path(str(b_dir) + ".json").read_text())
    if not b["interrupted"] or b["final_step"] != INFRA_STOP:
        raise AssertionError(f"run B: interrupted {b['interrupted']} at "
                             f"step {b['final_step']}, want {INFRA_STOP}")
    if checkpoint.latest_step(str(b_dir)) != INFRA_STOP:
        raise AssertionError("run B left no checkpoint of its last step")
    step_dir = b_dir / f"step_{INFRA_STOP:08d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    if checkpoint._sha256(step_dir / "arrays.npz") != manifest["sha256"]:
        raise AssertionError("run B's checkpoint fails its sha256")
    ckpt_bytes = (step_dir / "arrays.npz").stat().st_size
    # C: resumed here from B's checkpoint
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = _trainer_here(lambda: _infra_trainer(torch, b_dir))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if trainer.start_step != INFRA_STOP:
        raise AssertionError(f"run C starts at {trainer.start_step}, "
                             f"want {INFRA_STOP}")
    digest = _state_digest(trainer.state)
    if digest != b["digest"]:
        bad = [p for p in digest if digest[p] != b["digest"].get(p)]
        raise AssertionError(f"run C restored {len(bad)} leaves that differ "
                             f"from run B's state, e.g. {bad[:3]}")
    saves_c, rows_c = _timed_saves(trainer), []
    wrappers = kernels.wrappers()
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    rep_c = trainer.run(_infra_batches(torch, INFRA_STOP),
                        step_hook=_loss_hook(rows_c, "C"))
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    ran = INFRA_STEPS - INFRA_STOP
    want = _want_train_launches(cfg, launches, ran)
    if launches != want:
        raise AssertionError(f"run C launches {launches} != expected {want}")
    if (rep_c["final_step"] != INFRA_STEPS
            or rep_c["straggler"]["steps"] != ran):
        raise AssertionError(f"run C: final step {rep_c['final_step']}, "
                             f"straggler steps {rep_c['straggler']['steps']}")
    loss_a = [r["loss"] for r in rows_a]
    resumed = [r["loss"] for r in b["rows"]] + [r["loss"] for r in rows_c]
    diff = max(abs(x - y) for x, y in zip(resumed, loss_a))
    gn_a = [r["grad_norm"] for r in rows_a]
    gn = [r["grad_norm"] for r in b["rows"] + rows_c]
    print(f"  infra: B + C losses equal A's bit for bit: {resumed == loss_a}; "
          f"grad norms: {gn == gn_a}", flush=True)
    if len(resumed) != INFRA_STEPS or not diff <= INFRA_LOSS_TOL:
        raise AssertionError(f"B + C losses {resumed} vs A's {loss_a}: max "
                             f"diff {diff} beyond {INFRA_LOSS_TOL}")
    steps_c = list(trainer.monitor.times)
    print(f"  infra: checkpoint {ckpt_bytes} bytes; saves "
          f"{json.dumps(saves_a + b['saves_s'] + saves_c)} s; restore "
          f"{restore_s:.3f} s; run B {b_wall:.1f} s as a child; step time "
          f"A {json.dumps(steps_a)} s, C after resume {json.dumps(steps_c)}"
          f" s; max loss diff B + C vs A {diff:.3e}; launches "
          f"{json.dumps(launches)}; {card_line()}", flush=True)
    del trainer
    _free(torch)
    torch.use_deterministic_algorithms(False)
    shutil.rmtree(INFRA_DIR, ignore_errors=True)
    return launches


# ------------------------------------------------------------ phase 26
DRY_TRAIN = (TB, TS)         # rows x tokens of phase 26's train step
DRY_DECODE = (8, 4096)       # slots x max_len of its decode step
DRY_PEAK_TOL = 0.10          # predicted peak vs max_memory_allocated
# the step's own growth (max_memory_allocated less the bytes allocated at
# its start) vs the trace's temporaries: the allocator rounds each block
# up to 512 B, which put the growth 0 B (decode) and 5,588 B (train) past
# the count on an H100; the warm-up step has made the stream's cuBLAS
# workspace already, so no workspace term enters
DRY_GROWTH_ABS = 256 * 1024
DRY_GROWTH_REL = 1e-3
_GROUPED_SHAPES = set()      # (dtype, d, F) of every kernel-9 launch


def record_grouped_shapes():
    """Wrap kernel 9's wrapper (in its module, where every caller looks it
    up) to note each launch's (dtype, d, F): phase 26 holds the h scratch
    rule kernels/cost.py restates to the built library's at every one.
    The wrapper counts ``grouped_ffn.launches`` on the module's global,
    which is then this wrapper, so launch counts stay exact."""
    import functools
    from repro_torch.kernels.routed_ffn import ops
    inner = ops.grouped_ffn

    @functools.wraps(inner)
    def grouped_ffn(x, index, w_inner, *args, **kw):
        if x.is_cuda:
            _GROUPED_SHAPES.add((x.dtype, x.shape[-1], w_inner.shape[-1]))
        return inner(x, index, w_inner, *args, **kw)
    ops.grouped_ffn = grouped_ffn


def _dry_free(torch):
    """Free what earlier phases left: their tensors, and the cuBLAS
    workspaces (32 MiB a stream that ran a GEMM; phase 25's threads leave
    six), which the allocator counts but no step of this phase owns.  The
    warm-up step allocates its stream's again."""
    _free(torch)
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    _free(torch)


def _dry_counted(torch, step, args, profile=False):
    """``step(*args)`` once on the card under a roofline counter
    (launch/dryrun.count), launch counters zeroed just before and read
    just after, the allocator's peak reset just before; with
    ``profile`` under the profiler too.  Returns (counter, launches,
    max_memory_allocated, bytes allocated at the start, device ms or
    None)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch import kernels
    from repro_torch.launch import dryrun
    wrappers = kernels.wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    for w in wrappers:
        w.launches = 0
    device = None
    if profile:
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            counter = dryrun.count(step, args)
            torch.cuda.synchronize()
        device = sum(getattr(e, "self_device_time_total", 0)
                     for e in prof.key_averages()) / 1e3
    else:
        counter = dryrun.count(step, args)
        torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers if w.launches}
    return (counter, launches, torch.cuda.max_memory_allocated(), start,
            device)


def _dry_compare(label, meta, card, launches, peak, start, card_line_):
    """The card's counts equal the meta trace's exactly (FLOPs, HBM
    bytes in all and by op, kernel calls by name), the kernel calls equal
    the launch counters, the trace's predicted peak is within
    DRY_PEAK_TOL of the allocator's, and the step's own growth within
    DRY_GROWTH_ABS or DRY_GROWTH_REL (the larger) of the trace's
    temporaries."""
    from repro_torch.launch import roofline
    for what in ("flops", "hbm_bytes", "bytes_by_op"):
        if getattr(meta, what) != getattr(card, what):
            raise AssertionError(f"{label}: {what} on the card "
                                 f"{getattr(card, what)} != trace "
                                 f"{getattr(meta, what)}")
    if meta.kernel_calls() != card.kernel_calls():
        raise AssertionError(f"{label}: kernel calls on the card "
                             f"{card.kernel_calls()} != trace "
                             f"{meta.kernel_calls()}")
    if card.kernel_calls() != launches:
        raise AssertionError(f"{label}: kernel calls {card.kernel_calls()} "
                             f"!= launches {launches}")
    mem = meta.memory()
    pred = mem["peak_bytes"]
    gap = (pred - peak) / peak
    temps, growth = mem["temp_size_in_bytes"], peak - start
    print(f"  {label}: FLOPs {card.flops}, HBM bytes {card.hbm_bytes} "
          f"({card.aten_ops} aten ops on the card, {meta.aten_ops} in the "
          f"trace), kernel calls {json.dumps(card.kernel_calls())} = "
          f"launches, equal to the meta trace; predicted peak {pred} B "
          f"(arguments {mem['argument_size_in_bytes']}, temporaries "
          f"{temps}) vs max_memory_allocated {peak} B "
          f"({start} B allocated at the start, "
          f"{start - mem['argument_size_in_bytes']} B of them not the "
          f"step's arguments): {gap:+.2%}; the step's growth {growth} B vs "
          f"the temporaries: {growth - temps:+d} B [{card_line_}]",
          flush=True)
    if abs(gap) > DRY_PEAK_TOL:
        raise AssertionError(f"{label}: predicted peak {pred} B off the "
                             f"card's {peak} B by {gap:+.2%}")
    if abs(growth - temps) > max(DRY_GROWTH_ABS, DRY_GROWTH_REL * temps):
        raise AssertionError(f"{label}: the step grew the allocator by "
                             f"{growth} B, the trace's temporaries are "
                             f"{temps} B")
    return roofline.analyze(meta)


def dryrun_check(torch):
    """Phase 26: full-width qwen3-0.6b (CUT_DEPTH layers, bf16, the
    kernels on) through one train step at DRY_TRAIN and one decode step
    at DRY_DECODE, each traced on the meta device (launch/dryrun.py,
    target "cuda"), then run on the card under the same counter after a
    warm-up: FLOPs, HBM bytes and kernel calls equal, calls equal to the
    launch counters, the predicted peak within DRY_PEAK_TOL of
    max_memory_allocated and the step's growth near the trace's
    temporaries; the train step's profiled device time beside
    the count's t_bound (printed, not gated); kernel 9's h scratch rule
    (kernels/cost.py) equal to the library's at every (dtype, d, F) it
    launched at.  Returns the launches by path."""
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import cost
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.train import state as S
    card = card_line()
    cfg = _train_cfg(torch, num_layers=CUT_DEPTH)
    out = {}
    # the train step
    rows, seq = DRY_TRAIN
    shape = ShapeSpec("dry_train", "train", seq, rows)
    t0 = time.perf_counter()
    meta = dryrun.trace_cell(cfg, shape, None)
    t_trace = time.perf_counter() - t0
    step = dryrun.cell_step(cfg, shape)
    _dry_free(torch)
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
               for b in _batches(cfg, rows, seq, 2, seed=26)]
    state = S.init_state(cfg, seed=0, device="cuda")
    state, _ = step(state, batches[0])               # warm-up
    counted, launches, peak, start, device_ms = _dry_counted(
        torch, step, (state, batches[1]), profile=True)
    rl = _dry_compare(f"train {rows} x {seq}", meta, counted, launches, peak,
                      start, card)
    print(f"  train step: the most HBM bytes by op (count) "
          f"{json.dumps(meta.top_bytes(6))}", flush=True)
    print(f"  train step: profiler device time {device_ms:.1f} ms vs the "
          f"count's t_bound {rl.t_bound * 1e3:.1f} ms ({rl.bottleneck}; "
          f"t_compute {rl.t_compute * 1e3:.1f} ms, t_memory "
          f"{rl.t_memory * 1e3:.1f} ms; datasheet constants) [{card}]; "
          f"trace took {t_trace:.1f} s", flush=True)
    out["dryrun_train"] = launches
    del state, batches, counted
    _dry_free(torch)
    # the decode step
    slots, max_len = DRY_DECODE
    shape = ShapeSpec("dry_decode", "decode", max_len, slots)
    t0 = time.perf_counter()
    meta = dryrun.trace_cell(cfg, shape, None)
    t_trace = time.perf_counter() - t0
    model = transformer.LM.init(cfg, seed=0, device="cuda")
    caches = transformer.init_caches(cfg, slots, max_len, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(26)
    token = torch.randint(0, cfg.vocab_size, (slots,), device="cuda",
                          generator=gen, dtype=torch.int32)
    step = dryrun.cell_step(cfg, shape, model)
    step(model, caches, token, torch.tensor(0, dtype=torch.int32,
                                            device="cuda"))   # warm-up
    counted, launches, peak, start, _ = _dry_counted(
        torch, step, (model, caches, token,
                      torch.tensor(1, dtype=torch.int32, device="cuda")))
    rl = _dry_compare(f"decode {slots} slots x {max_len}", meta, counted,
                      launches, peak, start, card)
    print(f"  decode step: t_bound {rl.t_bound * 1e3:.3f} ms "
          f"({rl.bottleneck}; datasheet constants); trace took "
          f"{t_trace:.1f} s", flush=True)
    out["dryrun_decode"] = launches
    del model, caches, counted
    _free(torch)
    # kernel 9's h scratch: the restated rule against the library's
    lib = kernels.library()
    shapes = sorted(_GROUPED_SHAPES, key=str)
    if not shapes:
        raise AssertionError("no kernel-9 launch was recorded")
    bad = [(str(dt), d, f) for dt, d, f in shapes
           if cost.grouped_ffn_h_elems(dt, d, f) != lib.repro_grouped_ffn_h_elems(
               {torch.float32: 0, torch.bfloat16: 1}[dt], d, f)]
    if bad:
        raise AssertionError(f"kernel 9's h scratch rule differs from the "
                             f"library's at {bad}")
    wide = sum(cost.grouped_ffn_h_elems(dt, d, f) > 0 for dt, d, f in shapes)
    print(f"  kernel 9's h scratch rule equals the library's at the "
          f"{len(shapes)} (dtype, d, F) launched ({wide} take the wide "
          f"form)", flush=True)
    return out


# ------------------------------------------------------------ phase 27
# Sharded storage of the state (train/state.storage_specs) on one card.
# (a) An NCCL world of one under a (1, 1) mesh, bf16, spt, 4 x 1024, under
# deterministic algorithms, for each model of SHARD_STATE (full width,
# depth cut): init_state(mesh=) equal to init_state() bit for bit;
# SHARD_STATE_STEPS Trainer steps through the sharded path with losses
# bit for bit those without the mesh, launches exact; for qwen3-0.6b a
# checkpoint of the trained state saved and restored through the sharded
# path (checkpoint.save / restore with the storage specs and the mesh)
# equal to it bit for bit.  (b) qwen3-0.6b's model shards of
# SHARD_SERVE_TP, every rank a thread (phase 25's _Ring), each built on
# the card from a whole model kept on the host: the card's allocated
# bytes rise by the sum of the ranks' stored bytes within SHARD_MEM_TOL,
# each rank's bytes equal the dry run's count (a dry (1, n) mesh), and
# the serve of SHARD_WORK (streams alike on every rank, launches n x one
# rank's exact count, ServeStats counters the unsharded serve's).
SHARD_STATE = {"qwen3-0.6b": CUT_DEPTH, "mixtral-8x22b": 2}
SHARD_STATE_STEPS = 2
SHARD_SERVE_TP = 2
SHARD_MEM_TOL = 0.01
SHARD_DIR = ROOT / "build" / "shard_ckpt"


def _same_state(torch, a, b) -> bool:
    """Every leaf (and hole) of two states equal bit for bit."""
    from repro_torch.train import checkpoint
    la, lb = checkpoint._walk(a), checkpoint._walk(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and x.dtype == y.dtype
                                      and torch.equal(x.cpu(), y.cpu()))
        for (_, x), (_, y) in zip(la, lb))


def shard_state(torch):
    """Phase 27(a) (module comment above).  Returns the sharded runs'
    launches under "shard_train"."""
    import shutil
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.train import checkpoint
    from repro_torch.train import state as S
    torch.use_deterministic_algorithms(True, warn_only=True)
    rank, world, _ = init_distributed("cuda")
    total = {}
    try:
        if (rank, world) != (0, 1) or dist.get_backend() != "nccl":
            raise AssertionError(f"rank {rank} of {world} on "
                                 f"{dist.get_backend()}, want NCCL 0 of 1")
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        for name, layers in SHARD_STATE.items():
            cfg = dataclasses.replace(configs.get_config(name),
                                      num_layers=layers).with_spt(
                                          **SERVE_CFG)
            _free(torch)
            whole = S.init_state(cfg, 0, "cuda")
            parts = S.init_state(cfg, 0, "cuda", mesh=mesh)
            if not _same_state(torch, whole, parts):
                raise AssertionError(f"{name}: init_state(mesh=) differs "
                                     "from init_state()")
            del whole, parts
            _free(torch)
            label = f"{name} ({layers} layers)"
            base, _, t_base = _mesh_run(torch, cfg, None, f"{label} no mesh",
                                        steps=SHARD_STATE_STEPS)
            got, launches, t_mesh, trainer = _mesh_run(
                torch, cfg, mesh, f"{label} sharded (1, 1)",
                steps=SHARD_STATE_STEPS, keep=True)
            if got != base:
                raise AssertionError(f"{label}: sharded losses {got} != "
                                     f"{base}")
            want = _want_train_launches(cfg, launches, SHARD_STATE_STEPS)
            if launches != want:
                raise AssertionError(f"{label}: launches {launches} != "
                                     f"expected {want}")
            total = _add(total, launches)
            what = ""
            if name == "qwen3-0.6b":
                shutil.rmtree(SHARD_DIR, ignore_errors=True)
                t0 = time.perf_counter()
                checkpoint.save(trainer.state, SHARD_STATE_STEPS,
                                str(SHARD_DIR), specs=trainer.specs,
                                mesh=mesh, stacked=trainer.stacked)
                t1 = time.perf_counter()
                back = checkpoint.restore(str(SHARD_DIR), device="cuda",
                                          specs=trainer.specs, mesh=mesh,
                                          stacked=trainer.stacked)
                t2 = time.perf_counter()
                if not _same_state(torch, back, trainer.state):
                    raise AssertionError(f"{label}: the restored state "
                                         "differs")
                size = sum(f.stat().st_size for f in SHARD_DIR.rglob("*")
                           if f.is_file())
                what = (f"; checkpoint {size} B saved in {t1 - t0:.2f} s, "
                        f"restored in {t2 - t1:.2f} s, bit for bit")
                del back
                shutil.rmtree(SHARD_DIR, ignore_errors=True)
            print(f"  {label}: init_state(mesh=) = init_state() bit for "
                  f"bit; sharded losses = unsharded bit for bit, launches "
                  f"exact; mean step s no mesh "
                  f"{statistics.fmean(t_base):.4f}, sharded "
                  f"{statistics.fmean(t_mesh):.4f}{what}; {card_line()}",
                  flush=True)
            del trainer
            _free(torch)
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
    return {"shard_train": total}


def shard_serve(torch):
    """Phase 27(b) (module comment above).  Returns the shards' launches
    under "shard_serve"."""
    from repro_torch import configs, kernels
    from repro_torch.core import collectives as C
    from repro_torch.core import params as P
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine
    from repro_torch.train import state as S
    n, w = SHARD_SERVE_TP, SHARD_WORK
    cfg = dataclasses.replace(configs.get_config("qwen3-0.6b"),
                              num_layers=CUT_DEPTH).with_spt(**SERVE_CFG)
    reqs = _requests(w["n"], w["lo"], w["hi"], w["gen"], cfg.vocab_size,
                     seed=3)

    def serve(m):
        eng = Engine(cfg, m, max_len=w["max_len"], num_slots=4,
                     decode_chunk=8)
        outs = eng.run(reqs)
        st = eng.last_stats
        return ([c.tokens for c in outs], eng.last_steps_run,
                {k: getattr(st, k) for k in _STAT_COUNTS})

    _free(torch)
    model = _perturbed_model(torch, cfg, seed=0)
    base = serve(model)
    model = model.to("cpu")                  # the whole model on the host
    _free(torch)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ring = _Ring(n)
    shards = [transformer.ShardedLM(model, cfg, C.Axis(ring, n, r),
                                    device="cuda") for r in range(n)]
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - before
    stored = [roofline.storage_bytes(sh) for sh in shards]
    with make_dry_mesh((1, n), ("data", "model")) as mesh:
        dry = roofline.storage_bytes(dryrun.abstract_model(cfg, mesh))
    whole = P.param_bytes(S.model_defs(cfg))
    if abs(rise - sum(stored)) > SHARD_MEM_TOL * sum(stored):
        raise AssertionError(f"model={n}: the card's bytes rose {rise}, the "
                             f"ranks store {stored}")
    if any(b != dry for b in stored):
        raise AssertionError(f"model={n}: ranks store {stored} B, the dry "
                             f"run counts {dry} B a rank")
    wrappers = kernels.wrappers()
    torch.cuda.synchronize()
    for wr in wrappers:
        wr.launches = 0
    got = _on_shards(torch, shards, lambda r, sh: serve(sh))
    torch.cuda.synchronize()
    launches = {wr.__name__: wr.launches for wr in wrappers}
    streams, steps, stats = got[0]
    if any(g != got[0] for g in got[1:]):
        raise AssertionError(f"model={n}: the ranks' serves differ")
    one = _want_serve_launches(cfg, launches, steps, stats["prefill_batches"])
    if launches != {k: n * v for k, v in one.items()}:
        raise AssertionError(f"model={n}: launches {launches} != {n} x {one}")
    if stats != base[2]:
        raise AssertionError(f"model={n}: ServeStats counters {stats} != "
                             f"unsharded {base[2]}")
    same = sum(a == b for a, b in zip(streams, base[0]))
    print(f"  qwen3-0.6b ({CUT_DEPTH} layers) model={n} shards built on the "
          f"card from the host: allocated +{rise} B against the ranks' "
          f"{stored} B (whole model {whole} B), each = the dry run's {dry} "
          f"B; serve of {len(streams)} requests alike on every rank, {same} "
          f"streams = unsharded, ServeStats counters equal, launches {n} x "
          f"exact; {card_line()}", flush=True)
    del shards, model
    _free(torch)
    return {"shard_serve": launches}

# ------------------------------------------------------------ phase 28
# Attention placed as JAX places it where the kv heads do not divide the
# model axis (models/attention.py), on one card, every rank a thread
# (phase 25's _Ring).  SEQ_SPLIT: qwen3-0.6b at full width (CUT_DEPTH
# layers) over model 16 — one query head a rank, inside kv head r // 2,
# every cache's 4,096 slots split 16 ways (256 a rank) — and
# recurrentgemma-9b at full width (3 layers: rec, rec, attn) over model
# 2, its 2,048-slot ring split in two (1,024 a rank) and wrapped by the
# prompts.  (a) The shards built on the card from the host model (bf16):
# the allocated bytes rise by the ranks' stored bytes (within
# SHARD_MEM_TOL), each rank's equal to the dry run's (a dry (1, n)
# mesh), and the caches of its slots by exactly the dry run's cache
# bytes a rank; a burst serve on every rank at once (streams alike,
# launches n x one rank's exact count with kernels 3 and 5 on every
# split attention layer's decode, ServeStats counters the unsharded
# serve's; the streams equal to the unsharded serve's are reported).
# (b) In f32, at the default top-L and at top fraction 1: one ragged
# prefill and SEQ_SPLIT_STEPS teacher-forced decode steps on the shards;
# every decode over a split sequence (each layer, step and rank) is
# recorded, and on its inputs: each rank's kernel 3 histograms equal
# their plain version's exactly, kernel 5's output and log-sum-exp are
# within F32_TOL of their plain version's; the whole row's [t, need]
# from the ranks' summed histograms equals kernel 3's on the whole
# cache (the ranks' parts joined) exactly; the union of the ranks'
# selections equals the whole cache's selection exactly; the parts
# combined by their log-sum-exps equal kernel 5 on the whole cache
# within F32_TOL; the logits against the unsharded model's by phase 25's
# SHARD_TOL rule at top fraction 1 (shown at the default).
SEQ_SPLIT = [("qwen3-0.6b", CUT_DEPTH, 16,
              dict(n=4, lo=3072, hi=4032, gen=8, max_len=4096)),
             ("recurrentgemma-9b", 3, 2,
              dict(n=4, lo=2112, hi=2560, gen=8, max_len=4096))]
SEQ_SPLIT_STEPS = 2


class _SplitLog:
    """Records every ``attention.decode_seq_split`` call of the ranks'
    threads (bound by ``bind``): its inputs, cloned (the caches change in
    place), and its output, by rank in call order."""

    def __init__(self, torch):
        import threading
        self.torch, self.calls, self.rank = torch, {}, {}
        self._ident = threading.get_ident

    def bind(self, r):
        self.rank[self._ident()] = r
        self.calls[r] = []

    def __enter__(self):
        from repro_torch.models import attention
        self._orig = orig = attention.decode_seq_split

        @functools.wraps(orig)
        def rec(p, cfg, q, cache, valid, ax, scatter, kernel=None):
            out = orig(p, cfg, q, cache, valid, ax, scatter, kernel)
            self.calls[self.rank[self._ident()]].append(dict(
                cb=p["pq"]["codebooks"], cfg=cfg, q=q.clone(),
                k=cache["k"].clone(), v=cache["v"].clone(),
                codes=cache["codes"].clone(), valid=valid.clone(),
                out=out[0].clone(), scatter=scatter))
            return out
        attention.decode_seq_split = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention
        attention.decode_seq_split = self._orig


def _split_call_checks(torch, ranks):
    """The checks of one decode over a split sequence (``ranks``: every
    rank's record of the call, in rank order).  Returns (largest error
    of kernel 5 against its plain version, of the combined output
    against kernel 5 on the whole cache, selected (row, slot) pairs)."""
    from repro_torch.core import pq
    from repro_torch.core import sparse_attention as sa
    from repro_torch.kernels.sparse_attention import ops, ref
    from repro_torch.kernels.topl_select import ops as topl_ops
    from repro_torch.kernels.topl_select import ref as topl_ref
    from repro_torch.models import attention
    c0 = ranks[0]
    cfg, q = c0["cfg"], c0["q"]
    b, hq, _, d = q.shape
    _, hk, sl, _ = c0["k"].shape
    n, r = len(ranks), hq // hk
    sc = attention._sa_config(cfg)
    sum_rows = sc.select_granularity == "kvgroup"
    l = sa.top_l(n * sl, sc, None)
    m = sc.pq.num_books
    sel = dict(max_score=m * (r if sum_rows else 1), sum_rows=sum_rows,
               heads_per_batch=hk)
    cq = pq.assign(q, c0["cb"]).reshape(b * hk, r, m)
    qg = q.reshape(b * hk, r, d)

    def grouped(t):
        return t.reshape(b * hk, t.shape[2], t.shape[3])
    ck = [grouped(c["codes"]) for c in ranks]
    kk = [grouped(c["k"]) for c in ranks]
    vv = [grouped(c["v"]) for c in ranks]
    va = [c["valid"][:, i * sl:(i + 1) * sl].contiguous()
          for i, c in enumerate(ranks)]
    hists = []
    for i in range(n):
        _, h = topl_ops.decode_topl_thresholds(cq, ck[i], va[i], l=l,
                                               return_hist=True, **sel)
        if not torch.equal(h, topl_ref.decode_score_hist(cq, ck[i], va[i],
                                                         **sel)):
            raise AssertionError("kernel 3's histograms differ from the "
                                 "plain version's")
        hists.append(h)
    hists = torch.stack(hists)
    ck_w, va_w = torch.cat(ck, 1), c0["valid"]
    k_w, v_w = torch.cat(kk, 1), torch.cat(vv, 1)
    thr_w = topl_ops.decode_topl_thresholds(cq, ck_w, va_w, l=l, **sel)
    kw5 = dict(scale=d ** -0.5, sum_rows=sum_rows, heads_per_batch=hk)
    want = ops.sparse_decode_attention(qg, k_w, v_w, cq, ck_w, thr_w, va_w,
                                       **kw5)
    chosen = ref.newest_ties(topl_ref.decode_scores(
        cq, ck_w, va_w, sum_rows=sum_rows, heads_per_batch=hk), thr_w)
    sels, outs, lses, err5 = [], [], [], 0.0
    for i in range(n):
        whole, thr_r = attention.split_thresholds(hists, l, i)
        if not torch.equal(whole, thr_w):
            raise AssertionError("[t, need] from the summed histograms "
                                 "differ from kernel 3's on the whole cache")
        args = (qg, kk[i], vv[i], cq, ck[i], thr_r, va[i])
        o, lse = ops.sparse_decode_attention(*args, **kw5, return_lse=True)
        po, plse = ref.sparse_decode_attention_ref(*args, **kw5,
                                                   return_lse=True)
        err5 = max(err5, close(o, po, F32_TOL))
        fin = torch.isfinite(plse)
        if not torch.equal(fin, torch.isfinite(lse)) or (
                fin.any() and float((lse[fin] - plse[fin]).abs().max())
                > F32_TOL):
            raise AssertionError("kernel 5's log-sum-exp differs from the "
                                 "plain version's")
        sels.append(ref.newest_ties(topl_ref.decode_scores(
            cq, ck[i], va[i], sum_rows=sum_rows, heads_per_batch=hk), thr_r))
        outs.append(o)
        lses.append(lse)
    if not torch.equal(torch.cat(sels, -1), chosen):
        raise AssertionError("the union of the ranks' selections differs "
                             "from the whole cache's")
    lse_all = torch.stack(lses)
    got = sum(o.float() * attention.part_weight(x, lse_all)[..., None]
              for o, x in zip(outs, lses))
    err = close(got, want, F32_TOL)
    # each rank's recorded output: its heads' rows (or all) of the whole
    flat = want.reshape(b, hq, d)
    for i, c in enumerate(ranks):
        mine = (flat[:, i * hq // n:(i + 1) * hq // n] if c["scatter"]
                else flat)
        err = max(err, close(c["out"][:, :, 0], mine, F32_TOL))
    return err5, err, int(chosen.sum())


def _seq_split_case(torch, name, layers, n, w):
    """Phase 28 for one model (module comment above).  Returns the bf16
    serve's launches."""
    from repro_torch import configs, kernels
    from repro_torch.core import collectives as C
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.models import attention, transformer
    from repro_torch.serving.engine import Engine, abstract_decode_caches
    cfg = dataclasses.replace(configs.get_config(name),
                              num_layers=layers).with_spt(**SERVE_CFG)
    size = attention.cache_size(w["max_len"], cfg.window)
    if attention.seq_parts(cfg.num_kv_heads, size, n) != n:
        raise AssertionError(f"{name} model={n}: its caches do not split")
    reqs = _requests(w["n"], w["lo"], w["hi"], w["gen"], cfg.vocab_size,
                     seed=4)
    label = f"{name} ({layers} layers) model={n}"

    def serve(m):
        eng = Engine(cfg, m, max_len=w["max_len"], num_slots=4,
                     decode_chunk=8)
        outs = eng.run(reqs)
        st = eng.last_stats
        return ([c.tokens for c in outs], eng.last_steps_run,
                {k: getattr(st, k) for k in _STAT_COUNTS})

    t0 = time.perf_counter()
    _free(torch)
    model = _perturbed_model(torch, cfg, seed=0)
    base = serve(model)
    model = model.to("cpu")                  # the whole model on the host
    _free(torch)
    # (a) the shards on the card, their caches, the bf16 serve
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ring = _Ring(n)
    shards = [transformer.ShardedLM(model, cfg, C.Axis(ring, n, r),
                                    device="cuda") for r in range(n)]
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - before
    stored = [roofline.storage_bytes(sh) for sh in shards]
    before = torch.cuda.memory_allocated()
    caches = [transformer.init_caches(sh.cfg, 4, w["max_len"], "cuda",
                                      shard=sh.shard) for sh in shards]
    torch.cuda.synchronize()
    rise_c = torch.cuda.memory_allocated() - before
    with make_dry_mesh((1, n), ("data", "model")) as mesh:
        dm = dryrun.abstract_model(cfg, mesh)
        dry = roofline.storage_bytes(dm)
        dry_c = roofline.storage_bytes(abstract_decode_caches(
            dm.cfg, 4, w["max_len"], shard=dm.shard))
    del caches
    if abs(rise - sum(stored)) > SHARD_MEM_TOL * sum(stored):
        raise AssertionError(f"{label}: the card's bytes rose {rise}, the "
                             f"ranks store {stored}")
    if any(x != dry for x in stored) or rise_c != n * dry_c:
        raise AssertionError(f"{label}: ranks store {stored} B and caches "
                             f"of {rise_c} B in all; the dry run counts "
                             f"{dry} B and {dry_c} B a rank")
    k_local = shards[0].shard.attn_sh
    wrappers = kernels.wrappers()
    torch.cuda.synchronize()
    for wr in wrappers:
        wr.launches = 0
    got = _on_shards(torch, shards, lambda r, sh: serve(sh))
    torch.cuda.synchronize()
    launches = {wr.__name__: wr.launches for wr in wrappers}
    streams, steps, stats = got[0]
    if any(g != got[0] for g in got[1:]):
        raise AssertionError(f"{label}: the ranks' serves differ")
    one = _want_serve_launches(cfg, launches, steps,
                               stats["prefill_batches"], split=True)
    if launches != {k: n * v for k, v in one.items()}:
        raise AssertionError(f"{label}: launches {launches} != {n} x {one}")
    if stats != base[2]:
        raise AssertionError(f"{label}: ServeStats counters {stats} != "
                             f"unsharded {base[2]}")
    same = sum(a == b for a, b in zip(streams, base[0]))
    print(f"  {label}, bf16: {shards[0].cfg.num_heads} query head(s) a rank "
          f"inside kv head {k_local.kv_head}, caches of {size // n} of "
          f"{size} slots a rank; shards built from the host: allocated "
          f"+{rise} B against the ranks' {stored[0]} B each (= the dry "
          f"run's {dry} B), caches +{rise_c} B (= {n} x the dry run's "
          f"{dry_c} B); serve of {len(streams)} requests (prompts "
          f"{w['lo']}-{w['hi']}) alike on every rank, {same} bf16 streams "
          f"= unsharded, ServeStats counters equal, launches {n} x exact "
          f"(kernels 3 and 5 on the split layers); {card_line()}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    del shards
    _free(torch)
    # (b) f32: every split decode call checked, the logits
    model = model.to("cuda").to(torch.float32)
    prompts = [r_.tokens for r_ in reqs]
    for frac in (1.0, cfg.spt.attn_top_fraction):
        c32 = dataclasses.replace(cfg, dtype=torch.float32).with_spt(
            attn_top_fraction=frac)
        with torch.no_grad():
            ref_lg, feed = _teacher_logits(torch, model, c32, prompts,
                                           SEQ_SPLIT_STEPS, w["max_len"])
        ring = _Ring(n)
        shards = [transformer.ShardedLM(model, c32, C.Axis(ring, n, r))
                  for r in range(n)]
        with _SplitLog(torch) as log:
            def logits(r, sh):
                log.bind(r)
                return _teacher_logits(torch, sh, sh.cfg, prompts, feed,
                                       w["max_len"])[0]
            lg = _on_shards(torch, shards, logits)
        calls = [log.calls[r] for r in range(n)]
        want_calls = SEQ_SPLIT_STEPS * _layer_kinds(cfg).count("attn")
        if any(len(c) != want_calls for c in calls):
            raise AssertionError(f"{label}: split decodes "
                                 f"{[len(c) for c in calls]} a rank, want "
                                 f"{want_calls}")
        e5 = e = 0.0
        pairs = 0
        for i in range(want_calls):
            a, b_, p_ = _split_call_checks(torch, [c[i] for c in calls])
            e5, e, pairs = max(e5, a), max(e, b_), pairs + p_
        del log, calls
        if not all(torch.equal(x, lg[0]) for x in lg[1:]):
            raise AssertionError(f"{label}: the ranks' logits differ")
        err, rel = _logit_errors(lg[0], ref_lg)
        what = (f"{label}, f32, top-L {frac:g}: {want_calls} split decodes "
                f"x {n} ranks — kernel 3's histograms exact, kernel 5 within "
                f"{e5:.3e} of its plain version; whole [t, need] = kernel 3 "
                f"on the whole cache and the union of the selections "
                f"({pairs} pairs) = its selection, exactly; combined output "
                f"vs kernel 5 on the whole cache max abs err {e:.3e} (rule "
                f"{F32_TOL}); logits vs unsharded max abs {err:.3e}, "
                f"relative {rel:.3e}; {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        if frac == 1.0 and rel > SHARD_TOL:
            raise AssertionError(f"{what}; rule <= {SHARD_TOL}")
        print("  " + what + (f" (rule <= {SHARD_TOL})" if frac == 1.0 else
                             " (shown: discrete top-L, not held)"),
              flush=True)
        del shards, lg
        _free(torch)
    del model
    _free(torch)
    return launches


def seq_split_serve(torch):
    """Phase 28 (module comment above).  Returns the bf16 serves'
    launches under "seqsplit_serve"."""
    total = {}
    for name, layers, n, w in SEQ_SPLIT:
        total = _add(total, _seq_split_case(torch, name, layers, n, w))
    return {"seqsplit_serve": total}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels", "serve", "train", "paper",
                                       "server", "moe", "hybrid",
                                       "families", "infra", "mesh",
                                       "meshserve", "dryrun", "shard",
                                       "seqsplit"),
                    default=None,
                    help="stop after the kernel checks (phases 1-3), or "
                         "run the serving phases (1-6), the qwen3 training "
                         "phases (1-3, 7-8), the paper's models (1-3, "
                         "9-11), the long-lived server (1-3, 12-13), the "
                         "MoE family (1-3, 14-15), the dense registry and "
                         "the hybrid family (1-3, 16-18), the VLM, SSM "
                         "and audio families (1-3, 19-22), checkpoint/"
                         "restart (1-3, 23), multi-GPU fine-tuning "
                         "(1-3, 24), serving under a mesh (1-3, 25), "
                         "the dry run against the card (1-3, 26), the "
                         "sharded storage of the state (1-3, 27) or "
                         "attention split as JAX splits it (1-3, 28) "
                         "alone")
    ap.add_argument("--infra-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    if args.infra_child:                 # run B of phase 23
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return infra_child(torch, args.infra_child)

    # 1. environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; {card}",
          flush=True)
    # 2. build
    t0 = time.perf_counter()
    lib_path = kernels.build(verbose=True)
    kernels.library()
    print(f"[2] built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    usage = ptxas_usage()
    for src, fn, regs, smem, spill in usage:
        print(f"[2] ptxas {src}: {fn}: {regs} registers, {smem} bytes static "
              f"smem, {spill} bytes spilled", flush=True)
    sass = sass_counts(lib_path)
    for fn, n in sass.items():
        print(f"[2] SASS {fn}: {n['HGMMA']} HGMMA, {n['HMMA']} HMMA", flush=True)
    if not any("wgmma" in fn and n["HGMMA"] for fn, n in sass.items()):
        raise AssertionError("grouped_ffn's bf16 body has no HGMMA in its SASS")
    bodies = [n for fn, n in sass.items() if "sparse_attention_bf16" in fn]
    if not bodies or not all(n["HMMA"] + n["HGMMA"] for n in bodies):
        raise AssertionError("sparse_attention's bf16 body has no HMMA or "
                             "HGMMA in its SASS")
    if args.only in (None, "dryrun"):
        record_grouped_shapes()
    # 3. kernels against their plain versions, in the order of the TPU
    # kernels they replace
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    thr3, attn5 = check_two_pass(torch, gen)
    paged7, dense8 = check_paged(torch, gen)
    paper = check_decode_edges(torch, gen)
    rows = [check_pq_assign(torch, gen), check_topl_thresholds(torch, gen),
            thr3, check_sparse_attention(torch, gen), attn5,
            check_decode_attention(torch, gen), paged7, dense8,
            check_grouped_ffn(torch, gen), check_decode_ffn(torch, gen)]
    if [r["name"] for r in rows] != [w.__name__ for w in kernels.wrappers()]:
        raise AssertionError("phase 3 does not cover every kernel wrapper")
    for name, cases in check_paper_shapes(torch, gen).items():
        paper.setdefault(name, []).extend(cases)
    moe_shapes = check_moe_shapes(torch, gen)
    # the hybrid shapes draw from a generator of their own, so the
    # earlier checks keep their inputs
    hgen = torch.Generator(device="cuda").manual_seed(21)
    hybrid = check_decode_edges(torch, hgen, HYBRID_EDGES,
                                HYBRID_EDGES[0][0], tag="hybrid")
    for name, cases in check_hybrid_shapes(torch, hgen).items():
        hybrid.setdefault(name, []).extend(cases)
    fgen = torch.Generator(device="cuda").manual_seed(22)
    families = check_decode_edges(torch, fgen, FAMILY_EDGES,
                                  FAMILY_EDGES[0][0], tag="families")
    for name, cases in check_family_shapes(torch, fgen).items():
        families.setdefault(name, []).extend(cases)
    for row in rows:   # the paper's, MoE, hybrid and the families' shapes
        row["paper_shapes"] = paper[row["name"]]
        if row["name"] in moe_shapes:
            row["moe_shapes"] = moe_shapes[row["name"]]
        row["hybrid_shapes"] = hybrid.get(row["name"], [])
        row["family_shapes"] = families.get(row["name"], [])
    for row in rows[:2]:                # the bodies of kernels 1 and 2
        row["ptxas"] = [f"{fn}: {regs} registers, {smem} B static smem, "
                        f"{spill} B spilled"
                        for src, fn, regs, smem, spill in usage
                        if src == Path(row["source"]).stem]
    for row in rows:
        lib = ("no single PyTorch call computes it, so library_ms is n/a"
               if row["library_ms"] is None
               else f"library {row['library_ms']:.4f} ms")
        print(f"[3] {row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) at "
              f"{row['shape']}; {lib}", flush=True)
    print(f"[3] took {time.perf_counter() - t0:.1f} s", flush=True)
    paths = {p: {r["name"]: 0 for r in rows}
             for p in ("serve", "serve_paged", "serve_paged_two_pass",
                       "serve_paged_dense", "train", "paper_blocks",
                       "paper_train", "paper_prefill", "paper_serve",
                       "server", "server_paged", "moe_serve",
                       "moe_serve_paged", "moe_train", "dense_serve",
                       "dense_train", "hybrid_serve", "hybrid_train",
                       "vlm_serve", "vlm_serve_paged", "vlm_train",
                       "ssm_serve", "ssm_train", "audio_generate",
                       "audio_train", "infra_train", "mesh_train",
                       "mesh_train_shmap", "mesh_serve",
                       "mesh_serve_paged", "mesh_serve_hybrid",
                       "mesh_serve_shards", "dryrun_train",
                       "dryrun_decode", "shard_train", "shard_serve",
                       "seqsplit_serve")}
    if args.only in (None, "serve"):
        # 4. full-width serve
        t0 = time.perf_counter()
        print("[4] full-width qwen3-0.6b bf16 serve", flush=True)
        paths["serve"] = serve_full_width(torch)
        # 5. the same on the paged layout, sparse and dense, depth cut
        t1 = time.perf_counter()
        print(f"[5] paged serves at {PAGED_DEPTH} layers, pool {PAGED_POOL} "
              f"pages of 128 (phase 4 took {t1 - t0:.1f} s)", flush=True)
        paths.update(serve_paged(torch))
        # 6. card-side agreement of every decode tier
        t2 = time.perf_counter()
        print(f"[6] 4-layer f32 serve agreement (phase 5 took {t2 - t1:.1f} s)",
              flush=True)
        agree_f32(torch)
        print(f"[6] took {time.perf_counter() - t2:.1f} s", flush=True)
    if args.only in (None, "train"):
        # 7. full-width fine-tune steps
        t0 = time.perf_counter()
        print("[7] full-width qwen3-0.6b bf16 train, 3 steps of 4 x 1024",
              flush=True)
        paths["train"] = train_full_width(torch)
        # 8. card-side agreement of the train step
        t1 = time.perf_counter()
        print(f"[8] 4-layer f32 train agreement (phase 7 took {t1 - t0:.1f} s)",
              flush=True)
        train_agree_f32(torch)
        print(f"[8] took {time.perf_counter() - t1:.1f} s", flush=True)
    if args.only in (None, "paper"):
        # 9. the paper's Table-2 blocks, spt and lora
        t0 = time.perf_counter()
        print("[9] paper blocks at full width, 1 layer, 3 steps of 4 x 1024, "
              "spt then lora", flush=True)
        paths["paper_blocks"] = train_paper_blocks(torch)
        # 10. opt-2.7b and llama-2.7b, depth cut: train, prefill, serve
        t1 = time.perf_counter()
        print(f"[10] opt-2.7b and llama-2.7b at full width, {PAPER_DEPTH} "
              f"layers (phase 9 took {t1 - t0:.1f} s)", flush=True)
        paths.update(paper_models(torch))
        # 11. card-side agreement at the OPT-2560 width
        t2 = time.perf_counter()
        print(f"[11] 2-layer f32 OPT-2560 agreement (phase 10 took "
              f"{t2 - t1:.1f} s)", flush=True)
        paper_agree_f32(torch)
        print(f"[11] took {time.perf_counter() - t2:.1f} s", flush=True)
    if args.only in (None, "server"):
        # 12. the long-lived server at full width, contiguous and paged
        t0 = time.perf_counter()
        print(f"[12] full-width qwen3-0.6b ({SERVER_DEPTH} layers) bf16 "
              f"Engine.serve: 32 requests, Poisson arrivals at 2/s, chaos "
              f"and watchdog", flush=True)
        server_paths, rates = server_full_width(torch)
        paths.update(server_paths)
        # 13. card-side agreement of the server schedule
        t1 = time.perf_counter()
        print("[12] decode by telemetry mode: " + json.dumps(rates),
              flush=True)
        print(f"[13] 4-layer f32 server agreement (phase 12 took "
              f"{t1 - t0:.1f} s)", flush=True)
        server_agree_f32(torch)
        print(f"[13] took {time.perf_counter() - t1:.1f} s", flush=True)
    if args.only in (None, "moe"):
        # 14. the MoE family at full width, depth cut: serve and train
        t0 = time.perf_counter()
        print("[14] mixtral-8x22b (4 layers) and grok-1-314b (2 layers) at "
              "full width, bf16: serve and train", flush=True)
        paths.update(moe_full_width(torch))
        # 15. card-side agreement at a cut width
        t1 = time.perf_counter()
        print(f"[15] 2-layer f32 MoE agreement at d 1024 (phase 14 took "
              f"{t1 - t0:.1f} s)", flush=True)
        moe_agree_f32(torch)
        print(f"[15] took {time.perf_counter() - t1:.1f} s", flush=True)
    if args.only in (None, "hybrid"):
        # 16. the dense registry at full width, depth cut: serve and train
        t0 = time.perf_counter()
        print(f"[16] gemma-7b, h2o-danube-1.8b, h2o-danube-3-4b at full "
              f"width, {DENSE_DEPTH} layers, bf16: serve and train",
              flush=True)
        paths.update(dense_registry_full_width(torch))
        # 17. recurrentgemma-9b at full width and depth: serve and train
        t1 = time.perf_counter()
        print(f"[17] recurrentgemma-9b (38 layers) at full width, bf16: "
              f"Engine.serve, spt and lora train (phase 16 took "
              f"{t1 - t0:.1f} s)", flush=True)
        paths.update(hybrid_full_width(torch))
        # 18. card-side agreement at a cut width
        t2 = time.perf_counter()
        print(f"[18] 5-layer f32 recurrentgemma agreement at d 1024, R 16 "
              f"(phase 17 took {t2 - t1:.1f} s)", flush=True)
        hybrid_agree_f32(torch)
        print(f"[18] took {time.perf_counter() - t2:.1f} s", flush=True)
    if args.only in (None, "families"):
        # 19. phi-3-vision-4.2b at full width, depth cut: serve and train
        t0 = time.perf_counter()
        print(f"[19] phi-3-vision-4.2b ({PHI_DEPTH} layers) at full width, "
              f"bf16: 576 frontend rows a request; serve, paged serve, spt "
              f"and lora train", flush=True)
        paths.update(vlm_full_width(torch))
        # 20. mamba2-780m at full width and depth: serve and train
        t1 = time.perf_counter()
        print(f"[20] mamba2-780m (48 layers) at full width, bf16: serve, "
              f"spt and lora train (phase 19 took {t1 - t0:.1f} s)",
              flush=True)
        paths.update(ssm_full_width(torch))
        # 21. whisper-base: generate, the launcher, train
        t2 = time.perf_counter()
        print(f"[21] whisper-base (6 + 6 layers), bf16: generate over 1500 "
              f"frames, the launcher, spt train (phase 20 took "
              f"{t2 - t1:.1f} s)", flush=True)
        paths.update(audio_full_width(torch))
        # 22. card-side agreement of the three families
        t3 = time.perf_counter()
        print(f"[22] f32 agreement: phi-3-vision 4 layers, mamba2 4 layers, "
              f"whisper-base 2 + 2 (phase 21 took {t3 - t2:.1f} s)",
              flush=True)
        families_agree_f32(torch)
        print(f"[22] took {time.perf_counter() - t3:.1f} s", flush=True)
    if args.only in (None, "infra"):
        # 23. checkpoint/restart: SIGTERM in a child, resumed here
        t0 = time.perf_counter()
        print(f"[23] full-width qwen3-0.6b ({INFRA_DEPTH} layers) bf16 "
              f"fine-tune, {INFRA_STEPS} "
              f"steps of {TB} x {TS}: A uninterrupted, B a child stopped "
              f"by SIGTERM after step {INFRA_STOP}, C resumed from B's "
              f"checkpoint", flush=True)
        paths["infra_train"] = infra_resume(torch)
        print(f"[23] took {time.perf_counter() - t0:.1f} s", flush=True)
    if args.only in (None, "mesh"):
        # 24. multi-GPU fine-tuning on one card: shard shapes, a world of one
        t0 = time.perf_counter()
        print(f"[24] kernels at qwen3-0.6b's shard shapes (model "
              f"{' and '.join(map(str, MESH_TP))}); an NCCL world of one, "
              f"mesh (1, 1), full-width qwen3-0.6b ({MESH_DEPTH} layers) bf16, "
              f"{MESH_STEPS} steps "
              f"of {TB} x {TS}: no mesh, mesh, mesh with grouped_shmap",
              flush=True)
        mesh_shapes = check_mesh_shapes(
            torch, torch.Generator(device="cuda").manual_seed(24))
        for row in rows:
            row["mesh_shapes"] = mesh_shapes.get(row["name"], [])
        paths.update(mesh_train(torch))
        print(f"[24] took {time.perf_counter() - t0:.1f} s", flush=True)
    if args.only in (None, "meshserve"):
        # 25. serving under a mesh on one card: shard shapes, a world of one
        t0 = time.perf_counter()
        print(f"[25] decode kernels at the shard shapes of model "
              f"{' and '.join(map(str, MESH_TP))} (qwen3-0.6b, "
              f"recurrentgemma-9b); an NCCL world of one, mesh (1, 1): "
              f"qwen3-0.6b ({MESH_QWEN_DEPTH} layers, contiguous and paged) and "
              f"recurrentgemma-9b ({MESH_HYBRID_DEPTH} layers) served "
              f"without and through the mesh, then split over model "
              f"{' and '.join(map(str, MESH_TP))}, a thread a rank",
              flush=True)
        serve_shapes = check_mesh_serve_shapes(
            torch, torch.Generator(device="cuda").manual_seed(25))
        for row in rows:
            row["mesh_serve_shapes"] = serve_shapes.get(row["name"], [])
        paths.update(mesh_serve(torch))
        print(f"[25] took {time.perf_counter() - t0:.1f} s", flush=True)
    if args.only in (None, "dryrun"):
        # 26. the dry run's counts against the card's
        t0 = time.perf_counter()
        print(f"[26] the dry run against the card: full-width qwen3-0.6b "
              f"({CUT_DEPTH} layers) bf16, a train step at {DRY_TRAIN[0]} x "
              f"{DRY_TRAIN[1]} and a decode step at {DRY_DECODE[0]} slots x "
              f"{DRY_DECODE[1]}, traced on meta and run on the card",
              flush=True)
        for name, got in dryrun_check(torch).items():
            paths[name].update(got)
        print(f"[26] took {time.perf_counter() - t0:.1f} s", flush=True)
    if args.only in (None, "shard"):
        # 27. sharded storage of the state: a world of one, model shards
        t0 = time.perf_counter()
        models = " and ".join(f"{k} ({v} layers)"
                              for k, v in SHARD_STATE.items())
        print(f"[27] sharded storage of the state: an NCCL world of one, "
              f"mesh (1, 1), bf16 {models}"
              f": init, {SHARD_STATE_STEPS} steps and a checkpoint through "
              f"the sharded path; qwen3-0.6b's model shards of "
              f"{SHARD_SERVE_TP} built on the card from the host",
              flush=True)
        paths.update(shard_state(torch))
        t1 = time.perf_counter()
        print(f"[27] (a) took {t1 - t0:.1f} s", flush=True)
        paths.update(shard_serve(torch))
        print(f"[27] took {time.perf_counter() - t0:.1f} s", flush=True)
    if args.only in (None, "seqsplit"):
        # 28. attention where the kv heads do not divide the model axis
        t0 = time.perf_counter()
        cases = ", ".join(f"{name} ({layers} layers) over model {n}"
                          for name, layers, n, _ in SEQ_SPLIT)
        print(f"[28] query heads inside a kv head and the caches' sequence "
              f"split over model: {cases}, a thread a rank; the shards' "
              f"bytes against the dry run, a bf16 serve, f32 checks of "
              f"every split decode", flush=True)
        paths.update(seq_split_serve(torch))
        print(f"[28] took {time.perf_counter() - t0:.1f} s", flush=True)
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
