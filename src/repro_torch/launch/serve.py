"""Serving launcher of the port: continuous batching over decode slots.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --smoke --device cpu --requests 8 --prompt-len 24 --gen 6 \\
        --slots 2 --arrival-qps 4 --priorities --deadline-s 2 \\
        --temperature 0.8 --top-p 0.9 --telemetry trace --trace-out t.json

Random weights from a seed (no checkpoint ships with the repo), the
config's kernels (attn_impl / ffn_impl "pallas" = the CUDA kernels,
switchable per path), on the contiguous or the paged KV layout.  Greedy
unless ``--temperature`` > 0 (then seeded by ``--sample-seed``, with
``--top-k`` / ``--top-p`` truncation).  ``--arrival-qps`` serves through
the long-lived loop (``Engine.serve``) with seeded Poisson arrivals
instead of one burst.  A short warm-up run comes first; the timed run
prints one JSON blob with the JAX launcher's keys.  A frontend config
(phi-3-vision) gives every request seeded frontend rows; the enc-dec
audio family (whisper-base) is served through ``Engine.generate``'s
per-token loop over a fixed batch with seeded frame embeddings, and its
blob has ``"mode": "legacy-audio"``, as in JAX.  Runs on the card unless
``--device cpu``.

``--mesh DATAxMODEL`` serves under a (data, model) mesh of the world
(launch/mesh.py; torchrun's environment, one process per rank, or a
world of one): the slots split over ``data``, the heads, hidden columns
and vocabulary over ``model`` (serving/engine.py); each rank draws only
its part of the seeded model (``engine.init_model``), every rank serves
the same requests and rank 0 prints the blob.

    PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.serve \
        --arch qwen3-0.6b --smoke --device cpu --requests 4 --slots 2 \
        --prompt-len 16 --gen 4 --mesh 1x2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.models import transformer
from repro_torch.serving.engine import (ArrivalSchedule, Engine, Request,
                                      init_model)


def build_requests(vocab: int, num: int, prompt_len: int, gen: int,
                   ragged: bool, seed: int = 1, top_k: int = 0,
                   top_p: float = 0.0, frontend_tokens: int = 0,
                   d_model: int = 0):
    """``num`` prompts of ``prompt_len`` tokens, or of ragged lengths in
    [max(4, prompt_len/2), prompt_len] with ``ragged``; with
    ``frontend_tokens``, each request also carries (frontend_tokens,
    d_model) standard-normal frontend rows."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(num):
        ln = (int(rng.integers(max(4, prompt_len // 2), prompt_len + 1))
              if ragged else prompt_len)
        toks = rng.integers(0, vocab, size=ln).tolist()
        fe = (rng.standard_normal((frontend_tokens, d_model)).astype(
            np.float32) if frontend_tokens else None)
        reqs.append(Request(uid=i, tokens=toks, max_new_tokens=gen,
                            frontend_embeds=fe, top_k=top_k, top_p=top_p))
    return reqs


def with_slo(reqs, priorities: bool, deadline_s):
    """The phased priority workload: with ``priorities`` the first half
    of the requests is background (priority 0) and the second half
    interactive (priority 1); ``deadline_s`` is the TTFT deadline of the
    interactive half (of every request without ``priorities``)."""
    half = len(reqs) // 2
    return [dataclasses.replace(
        r, priority=(0 if priorities and i < half
                     else 1 if priorities else r.priority),
        deadline_s=deadline_s if (not priorities or i >= half) else None)
        for i, r in enumerate(reqs)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="any name configs.get_config takes")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--slots", type=int, default=8,
                    help="decode slots (batch width); requests beyond this "
                         "queue and stream in as slots free up")
    ap.add_argument("--max-len", type=int, default=None,
                    help="cache length per slot (default: a frontend's rows "
                         "+ prompt-len + gen)")
    ap.add_argument("--decode-chunk", type=int, default=16,
                    help="decode steps per chunk (one host sync each)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="token id that retires a slot early")
    ap.add_argument("--ragged", action="store_true",
                    help="draw ragged prompt lengths in [L/2, L]")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k sampling truncation inside the decode chunk "
                         "(0 = off; needs --temperature > 0)")
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling inside the decode chunk (keep the "
                         "smallest probability mass >= p; 0 = off; needs "
                         "--temperature > 0)")
    ap.add_argument("--sample-seed", type=int, default=3,
                    help="seed of the sampler's draws (with --temperature)")
    ap.add_argument("--decode-impl", default="auto",
                    choices=("auto", "kernel", "jnp"),
                    help="sparse-MHA decode path: CUDA kernel vs the plain "
                         "torch path (auto follows the kernel config; "
                         "REPRO_DISABLE_KERNELS=1 forces the plain path)")
    ap.add_argument("--ffn-impl", default=None,
                    choices=("pallas", "grouped", "dense"),
                    help="routed-FFN prefill path: 'pallas' = the grouped-FFN "
                         "CUDA kernel (the default), 'grouped' = the plain "
                         "capacity path, 'dense' = the per-token oracle")
    ap.add_argument("--decode-ffn-impl", default="auto",
                    choices=("auto", "kernel", "jnp"),
                    help="routed-FFN decode path at (B, 1, d): block-gather "
                         "CUDA kernel vs the grouped plain path (auto "
                         "follows --ffn-impl)")
    ap.add_argument("--kv-layout", default="contiguous",
                    choices=("contiguous", "paged"),
                    help="serving KV-cache layout: 'paged' shares a pool of "
                         "fixed-size pages across slots (admission waits for "
                         "pages, not just a free slot)")
    ap.add_argument("--page-size", type=int, default=128,
                    help="rows per KV page (paged layout)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="page-pool size (default: the contiguous footprint "
                         "slots*ceil(max_len/page_size); set lower to serve "
                         "under a fixed KV-memory budget)")
    ap.add_argument("--prefill-batch", type=int, default=None,
                    help="max queued requests per ragged prefill call "
                         "(default: --slots; 1 = serial admission)")
    ap.add_argument("--prefill-decode-ratio", type=float, default=0.0,
                    help="overlap knob: with decodes in flight, admit at "
                         "most ratio * decode_chunk * active_slots prompt "
                         "tokens per scheduling iteration (0 = fill all "
                         "free slots before each chunk)")
    ap.add_argument("--arrival-qps", type=float, default=None,
                    help="serve through the long-lived loop with seeded "
                         "Poisson arrivals at this offered rate instead of "
                         "one burst (stats add p50/p99 TTFT/TPOT, "
                         "preemptions, shed)")
    ap.add_argument("--priorities", action="store_true",
                    help="phased priority workload: first half background "
                         "(priority 0), second half interactive (priority "
                         "1); under pressure backgrounds are preempted and "
                         "re-admitted by recompute")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="TTFT deadline of the interactive requests (all "
                         "requests without --priorities): a queued request "
                         "past it is shed, one past half of it may preempt "
                         "deadline-free peers")
    ap.add_argument("--telemetry", default="off",
                    choices=("off", "counters", "trace"),
                    help="'counters' accumulates sparsity/expert/page "
                         "counters on the device, drained once per chunk; "
                         "'trace' adds per-request lifecycle timelines and "
                         "scheduler spans; outputs are identical across all "
                         "three")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto-loadable Chrome trace.json of the "
                         "timed run here (implies --telemetry trace)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final metrics snapshot (counters/"
                         "gauges/histograms) as JSON here")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL: slots over data, heads and hidden "
                         "columns over model; the world (torchrun) must "
                         "have DATA*MODEL processes; 1x1 runs without a "
                         "process group")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        dp, tp = (int(x) for x in args.mesh.split("x"))
    except ValueError:
        ap.error(f"--mesh takes DATAxMODEL, got {args.mesh!r}")
    if (dp, tp) == (1, 1):
        return _serve(args, None, 0)
    started = not dist.is_initialized()
    rank, world, device = init_distributed(args.device)
    try:
        if dp * tp != world:
            ap.error(f"--mesh {args.mesh} needs {dp * tp} processes, the "
                     f"world has {world}")
        args.device = str(device)
        return _serve(args, make_mesh((dp, tp), ("data", "model"),
                                      device=device), rank)
    finally:
        if started:
            dist.destroy_process_group()


def _serve(args, mesh, rank: int) -> int:
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    telemetry = "trace" if args.trace_out else args.telemetry
    cfg = cfg.with_spt(attn_impl="pallas",
                       ffn_impl=args.ffn_impl or "pallas",
                       decode_attn_impl=args.decode_impl,
                       decode_ffn_impl=args.decode_ffn_impl,
                       kv_layout=args.kv_layout,
                       kv_page_size=args.page_size, telemetry=telemetry)
    device = transformer.resolve_device(args.device)
    audio = cfg.family == "audio"
    model = init_model(cfg, seed=0, device=device, mesh=mesh)
    frontend = cfg.frontend_tokens if cfg.frontend and not audio else 0
    max_len = args.max_len or frontend + args.prompt_len + args.gen
    engine = Engine(cfg, model, max_len=max_len, num_slots=args.slots,
                    eos_id=args.eos_id, decode_chunk=args.decode_chunk,
                    kv_pages=args.kv_pages,
                    prefill_batch=args.prefill_batch,
                    prefill_decode_ratio=args.prefill_decode_ratio,
                    device=device, mesh=mesh)
    seed = args.sample_seed if args.temperature > 0 else None
    if audio:
        return _serve_audio_legacy(cfg, engine, args, seed, device, rank)
    reqs = build_requests(cfg.vocab_size, args.requests, args.prompt_len,
                          args.gen, args.ragged, top_k=args.top_k,
                          top_p=args.top_p, frontend_tokens=frontend,
                          d_model=cfg.d_model)
    # warm-up (deadlines and priorities come after it, as in JAX)
    t0 = time.perf_counter()
    engine.run(reqs[:1], temperature=args.temperature, seed=seed)
    warmup_wall_s = time.perf_counter() - t0
    if args.priorities or args.deadline_s is not None:
        reqs = with_slo(reqs, args.priorities, args.deadline_s)
    t0 = time.perf_counter()
    if args.arrival_qps is not None:
        outs = engine.serve(
            ArrivalSchedule.poisson(reqs, args.arrival_qps, seed=0),
            temperature=args.temperature, seed=seed)
    else:
        outs = engine.run(reqs, temperature=args.temperature, seed=seed)
    wall = time.perf_counter() - t0
    stats = engine.last_stats
    out = {"arch": cfg.name, **_device_keys(device),
           "requests": args.requests, "slots": args.slots,
           "generated_tokens": sum(len(c.tokens) for c in outs),
           "warmup_wall_s": round(warmup_wall_s, 2),
           "steady_wall_s": round(wall, 2), **stats.as_dict(),
           "finish_reasons": sorted({c.finish_reason for c in outs}),
           "sample": outs[0].tokens[:8]}
    if args.trace_out and not rank:
        from repro_torch.serving import trace_export
        trace = trace_export.write_trace(engine.last_recorder,
                                         args.trace_out)
        out["trace_out"] = args.trace_out
        out["trace_events"] = len(trace["traceEvents"])
    if rank:
        return 0
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(stats.snapshot().as_dict(), f, indent=1)
        out["metrics_out"] = args.metrics_out
    if mesh is not None:
        out["mesh"] = args.mesh
    print(json.dumps(out, indent=1))
    return 0


def _device_keys(device) -> dict:
    return {"device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu")}


def _serve_audio_legacy(cfg, engine, args, seed, device, rank=0) -> int:
    """The enc-dec audio family: continuous batching does not cover it, so
    the fixed batch of ``--requests`` prompts (seeded tokens and frame
    embeddings) goes through ``generate``'s per-token loop, once to warm
    up and once timed (generate syncs on its host-side token lists)."""
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (args.requests, args.prompt_len),
                                     generator=gen, device=device),
             "frontend_embeds": torch.randn(
                 (args.requests, cfg.frontend_tokens, cfg.d_model),
                 generator=gen, device=device).to(torch.bfloat16)}
    engine.generate(batch, steps=args.gen, temperature=args.temperature,
                    seed=seed)                                    # warm-up
    t0 = time.perf_counter()
    result = engine.generate(batch, steps=args.gen,
                             temperature=args.temperature, seed=seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = args.requests * args.gen
    if rank:
        return 0
    print(json.dumps({
        "arch": cfg.name, "mode": "legacy-audio", **_device_keys(device),
        "requests": args.requests, "generated_tokens": toks,
        "steady_wall_s": round(dt, 2), "tokens_per_s": round(toks / dt, 1),
        "sample": result.tokens[0][:8]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
