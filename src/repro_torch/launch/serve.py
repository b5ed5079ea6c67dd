"""Serving launcher of the port: continuous batching over decode slots.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b

Random weights from a seed (no checkpoint ships with the repo), greedy
decoding, the config's kernels (attn_impl / ffn_impl "pallas" = the CUDA
kernels), on the contiguous or the paged KV layout (``--kv-layout paged
--page-size N [--kv-pages P]``).  A short warm-up run comes first; the timed run prints one JSON
blob of its stats.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.serving.engine import Engine, Request


def build_requests(vocab: int, num: int, prompt_len: int, gen: int,
                   seed: int = 1):
    """Prompts of ragged lengths in [prompt_len/2, prompt_len]."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(
        0, vocab, size=int(rng.integers(max(1, prompt_len // 2),
                                        prompt_len + 1))).tolist(),
        max_new_tokens=gen) for i in range(num)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=None,
                    help="cache length per slot (default prompt-len + gen)")
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    cfg = cfg.with_spt(attn_impl="pallas", ffn_impl="pallas",
                       kv_layout=args.kv_layout,
                       kv_page_size=args.page_size)
    device = transformer.resolve_device(args.device)
    model = transformer.LM.init(cfg, seed=0, device=device)
    max_len = args.max_len or args.prompt_len + args.gen
    engine = Engine(cfg, model, max_len=max_len, num_slots=args.slots,
                    kv_pages=args.kv_pages, device=device)
    reqs = build_requests(cfg.vocab_size, args.requests, args.prompt_len,
                          args.gen)
    engine.run(reqs[:1])                                     # warm-up
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    wall = time.perf_counter() - t0
    out = {"arch": cfg.name, "device": str(device),
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
           "requests": args.requests, "slots": args.slots,
           "generated_tokens": sum(len(c.tokens) for c in outs),
           "wall_s": wall, **engine.last_stats.as_dict(),
           "finish_reasons": sorted({c.finish_reason for c in outs}),
           "sample": outs[0].tokens[:8]}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
