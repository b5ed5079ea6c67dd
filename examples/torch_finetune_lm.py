"""End-to-end driver on the PyTorch port (examples/finetune_lm.py on
``repro_torch``): fine-tune a ~100M-param LM with SPT for a few hundred
steps on the synthetic corpus, with checkpoint/restart.

    PYTHONPATH=src python examples/torch_finetune_lm.py --steps 300
    PYTHONPATH=src python examples/torch_finetune_lm.py --steps 40 \\
        --resume-demo --ckpt build/ckpt

The model is a 12-layer qwen3-family config (~100M params with its
embedding table) running sparse MHA + routed FFN + LoRA — the paper's full
pipeline, on the port's kernel paths (attn_impl and ffn_impl "pallas", as
its launchers select them).  Without ``--ckpt`` the checkpoints go to a fresh temporary
directory.
"""
import argparse
import dataclasses
import json
import tempfile

from repro_torch import configs
from repro_torch.core.params import count_params
from repro_torch.data.pipeline import DataConfig, synthetic_dataset
from repro_torch.models import transformer
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.state import model_defs
from repro_torch.train.trainer import Trainer, TrainerConfig


def model_100m() -> configs.ModelConfig:
    return dataclasses.replace(
        configs.get_config("qwen3-0.6b"), name="qwen3-100m",
        num_layers=12, d_model=512, num_heads=8, num_kv_heads=4,
        head_dim=64, d_ff=1536, vocab_size=32000,
    ).with_spt(attn_min_l=16, chunk_q=128, attn_impl="pallas",
               ffn_impl="pallas")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume-demo", action="store_true",
                    help="kill/restart mid-run to exercise restart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = transformer.resolve_device(args.device)

    cfg = model_100m()
    print(f"{cfg.name}: {count_params(model_defs(cfg))/1e6:.1f}M params, "
          f"{count_params(model_defs(cfg), True)/1e6:.2f}M trainable")
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="spt_ckpt_")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)

    if args.resume_demo:
        half = args.steps // 2
        t1 = Trainer(cfg, ocfg, TrainerConfig(
            total_steps=half, ckpt_dir=ckpt, ckpt_interval=25),
            device=device)
        t1.run(synthetic_dataset(dcfg, steps=half + 1))
        print(f"-- simulated preemption at step {half}; restarting --")

    trainer = Trainer(cfg, ocfg, TrainerConfig(
        total_steps=args.steps, ckpt_dir=ckpt, ckpt_interval=50),
        device=device)
    print(f"starting from step {trainer.start_step} (ckpt dir {ckpt})")
    report = trainer.run(synthetic_dataset(dcfg, steps=args.steps + 1))
    print(json.dumps({"final_step": report["final_step"],
                      "first": report["metrics"][0] if report["metrics"] else None,
                      "last": report["metrics"][-1] if report["metrics"] else None,
                      "straggler": report["straggler"]}, indent=1))


if __name__ == "__main__":
    main()
