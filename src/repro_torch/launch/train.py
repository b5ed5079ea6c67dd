"""Training launcher of the port: LoRA fine-tuning with the paper's sparse
MHA and routed FFN, on one device or over a (data, model) mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-2560 \\
        --variant lora --steps 3 --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 200 --ckpt runs/qwen3     # resumes from runs/qwen3 if it
                                          # holds a checkpoint
    torchrun --nproc_per_node 4 -m repro_torch.launch.train \
        --arch qwen3-0.6b --mesh 2x2 --batch 8 --seq 1024

--arch takes any name ``configs.get_config`` takes (the assigned
architectures, the paper's blocks, opt-2.7b, llama-2.7b); --variant picks
the paper's baseline (``launch/dryrun.apply_variant``).  A frontend
config gets seeded standard-normal frontend rows in every batch: a VLM
prepends them to the --seq text tokens, the enc-dec audio family encodes
them (--seq is then the decoder's length).

Random weights from a seed (no checkpoint ships with the repo), synthetic
data from the port's pipeline, the config's kernels (attn_impl / ffn_impl
"pallas" = the CUDA kernels).  ``--ckpt DIR`` checkpoints every 50 steps
(``TrainerConfig.ckpt_interval``) and at the end, in JAX's layout (either
package restores it); a run resumes from the newest step in DIR and
takes the batches from there on (JAX's launcher starts its stream over),
and SIGTERM ends it cleanly after the step in flight.  Prints one JSON
blob (rank 0 alone).  Runs on the card unless ``--device cpu``.

``--mesh DATAxMODEL`` (default 1x1) lays the world out as a (data, model)
mesh (launch/mesh.py): data parallelism over ``data`` (each rank takes its
rows of --batch), and for stacks of attention blocks tensor and sequence
parallelism over ``model`` (models/transformer.py); each rank stores only
its part of the parameters, gradients and moments (train/state.py), and
a checkpoint is written whole.  Under torchrun the
world is its processes (one card each, NCCL; gloo with --device cpu),
without it a world of one; a mesh whose product is not the world size is
refused.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, synthetic_dataset
from repro_torch.launch.dryrun import VARIANTS, apply_variant
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def with_frontend(data, cfg, seed: int):
    """The batches of ``data``, each with (B, frontend_tokens, d_model)
    float32 standard-normal ``frontend_embeds`` from a numpy seed when
    the config has a frontend (a VLM's patches, the audio family's
    frames); unchanged otherwise."""
    rng = np.random.default_rng(seed)
    for batch in data:
        if cfg.frontend:
            b = np.asarray(batch["tokens"]).shape[0]
            batch = {**batch, "frontend_embeds": rng.standard_normal(
                (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)}
        yield batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--variant", default="spt", choices=VARIANTS)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: resume from it, save to it")
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 2x2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        dp, tp = (int(x) for x in args.mesh.split("x"))
    except ValueError:
        ap.error(f"--mesh takes DATAxMODEL, got {args.mesh!r}")
    if args.batch % dp:
        ap.error(f"--batch {args.batch} does not split over {dp} data ranks")

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    cfg = apply_variant(cfg, args.variant).with_spt(attn_impl="pallas",
                                                    ffn_impl="pallas")
    started = not dist.is_initialized()
    rank, world, device = init_distributed(args.device)
    try:
        if dp * tp != world:
            ap.error(f"--mesh {args.mesh} needs {dp * tp} processes, the "
                     f"world has {world}")
        return _run(args, cfg, make_mesh((dp, tp), ("data", "model"),
                                         device=device), rank, device)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, cfg, mesh, rank: int, device) -> int:
    ocfg = OptimizerConfig(lr=args.lr, total_steps=args.steps)
    tcfg = TrainerConfig(total_steps=args.steps, log_interval=1,
                         ckpt_dir=args.ckpt)
    trainer = Trainer(cfg, ocfg, tcfg, device=device, mesh=mesh)
    # a resumed run takes the batches the uninterrupted run would have
    data = synthetic_dataset(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch), steps=args.steps)
    data = itertools.islice(with_frontend(data, cfg, seed=2),
                            trainer.start_step, None)
    t0 = time.perf_counter()
    report = trainer.run(data)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps_run = report["final_step"] - trainer.start_step
    if rank:
        return 0
    print(json.dumps({
        "arch": cfg.name, "variant": args.variant, "mesh": args.mesh,
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "start_step": trainer.start_step,
        "final_step": report["final_step"], "wall_s": wall,
        "tokens_per_s": steps_run * args.batch * args.seq / wall,
        "first_metrics": report["metrics"][0] if report["metrics"] else None,
        "last_metrics": report["metrics"][-1] if report["metrics"] else None,
        "straggler": report["straggler"],
        "interrupted": report["interrupted"]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
