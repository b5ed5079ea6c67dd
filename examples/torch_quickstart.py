"""Quickstart on the PyTorch port: build a small SPT model, run the Model
Adapter workflow, fine-tune a few steps, and compare Full / LoRA / SPT step
costs (examples/quickstart.py on ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py            # a card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

JAX's configuration with the port's kernel paths selected (attn_impl and
ffn_impl "pallas", as the port's launchers select them): on the card the
CUDA kernels, on the CPU their plain versions.  On the card each variant's
step time is a CUDA-event time, printed beside the card's name and power
limit (nvidia-smi); on the CPU a wall time.
"""
import argparse
import subprocess
import time

import torch

from repro_torch import configs
from repro_torch.core import adapter
from repro_torch.core.params import count_params, init_tree
from repro_torch.data.pipeline import DataConfig, synthetic_dataset
from repro_torch.launch.dryrun import apply_variant
from repro_torch.models import transformer
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.state import model_defs
from repro_torch.train.trainer import Trainer, TrainerConfig


KERNELS = dict(attn_impl="pallas", ffn_impl="pallas")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def step_ms(trainer, batches, device) -> float:
    """Mean ms of a step over ``batches``: CUDA events on a card."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.run(iter(batches))
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / len(batches)
    t0 = time.perf_counter()
    trainer.run(iter(batches))
    return (time.perf_counter() - t0) / len(batches) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30,
                    help="fine-tune steps of the walkthrough")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = transformer.resolve_device(args.device)

    cfg = configs.get_smoke("qwen3-0.6b").with_spt(**KERNELS)
    print(f"arch: {cfg.name} (reduced)  layers={cfg.num_layers} "
          f"d={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads}")

    # --- the paper's Model Adapter workflow: dense -> SPT ------------
    dense_cfg = apply_variant(cfg, "full")
    dense_params = init_tree(transformer.lm_defs(dense_cfg),
                             torch.Generator(device=device).manual_seed(0))
    spt_params = adapter.adapt(dense_params, dense_cfg, cfg,
                               torch.Generator(device=device).manual_seed(1))
    print(adapter.upgrade_report(dense_params, spt_params)[:400], "...")

    # --- parameter accounting ----------------------------------------
    defs = model_defs(cfg)
    total = count_params(defs)
    trainable = count_params(defs, only_trainable=True)
    print(f"params: total={total/1e6:.2f}M  trainable (LoRA/router/PQ)="
          f"{trainable/1e6:.3f}M  ({100*trainable/total:.2f}%)")

    # --- short fine-tune on the synthetic corpus ---------------------
    steps = args.steps
    data = synthetic_dataset(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8),
        steps=steps + 1)
    trainer = Trainer(cfg, OptimizerConfig(lr=3e-3, total_steps=steps),
                      TrainerConfig(total_steps=steps, log_interval=10),
                      device=device)
    report = trainer.run(data)
    for m in report["metrics"]:
        print(f"  step {m['step']:>3}  loss={m['loss']:.3f} "
              f"acc={m['accuracy']:.3f}")

    # --- Full vs LoRA vs SPT one-step time ----------------------------
    where = (f"CUDA events; {card_line()}" if device.type == "cuda"
             else "CPU wall")
    for variant in ("full", "lora", "spt"):
        vcfg = apply_variant(cfg, variant)
        t = Trainer(vcfg, OptimizerConfig(), TrainerConfig(total_steps=3),
                    device=device)
        d = synthetic_dataset(
            DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                       global_batch=8), steps=4)
        batches = list(d)
        t.run(iter(batches[:1]))        # warm-up (kernel build, allocator)
        ms = step_ms(t, batches[1:3], device)
        print(f"  {variant:>5}: {ms:.0f} ms/step ({where})")


if __name__ == "__main__":
    main()
