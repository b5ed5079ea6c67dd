"""Continuous-batching serving example on the PyTorch port: ragged prompts
stream through a small pool of decode slots, with the SPT sparse-MHA
decode path (top-L selection over the PQ-coded KV cache) and EOS-based
early exit (examples/serve_batch.py on ``repro_torch``), with the port's
kernel paths selected (attn_impl and ffn_impl "pallas", as its launchers
select them).

    PYTHONPATH=src python examples/torch_serve_batch.py --requests 8 --slots 4
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
"""
import argparse
import json

import torch

from repro_torch import configs
from repro_torch.core.params import init_tree
from repro_torch.launch.serve import build_requests
from repro_torch.models import transformer
from repro_torch.serving.engine import Engine
from repro_torch.train.state import model_defs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = transformer.resolve_device(args.device)

    cfg = configs.get_smoke(args.arch).with_spt(attn_impl="pallas",
                                                ffn_impl="pallas")
    params = init_tree(model_defs(cfg),
                       torch.Generator(device=device).manual_seed(0))
    model = transformer.LM(cfg, params, device=device)
    frontend = cfg.frontend_tokens if cfg.frontend else 0
    engine = Engine(cfg, model,
                    max_len=frontend + args.prompt_len + args.gen + 8,
                    num_slots=args.slots, eos_id=args.eos_id, device=device)

    requests = build_requests(cfg.vocab_size, args.requests, args.prompt_len,
                              args.gen, ragged=True,
                              frontend_tokens=frontend, d_model=cfg.d_model)

    out = engine.run(requests, temperature=args.temperature, seed=3)
    print(json.dumps({
        "arch": cfg.name, "requests": args.requests, "slots": args.slots,
        **engine.last_stats.as_dict(),
        "completions": [{"uid": c.uid, "prompt_len": c.prompt_len,
                         "reason": c.finish_reason, "tokens": c.tokens[:10]}
                        for c in out],
    }, indent=1))


if __name__ == "__main__":
    main()
