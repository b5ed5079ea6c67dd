"""Sparsity-strength sweep on the PyTorch port (paper Figure 10 analogue;
examples/sparsity_tradeoff.py on ``repro_torch``): fine-tune the same
small LM at several sparse-MHA / routed-FFN strengths and report loss, on
the port's kernel paths (attn_impl and ffn_impl "pallas", as its launchers
select them).

    PYTHONPATH=src python examples/torch_sparsity_tradeoff.py --steps 120
    PYTHONPATH=src python examples/torch_sparsity_tradeoff.py --device cpu
"""
import argparse
import dataclasses
import json

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, synthetic_dataset
from repro_torch.models import transformer
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = transformer.resolve_device(args.device)

    base = configs.get_smoke("qwen3-0.6b")
    base = dataclasses.replace(base, num_layers=4, d_model=128,
                               num_heads=4, num_kv_heads=2, head_dim=32,
                               d_ff=256, vocab_size=512).with_spt(
                                   attn_impl="pallas", ffn_impl="pallas")
    rows = []
    grid = [
        ("dense (LoRA)", dict(sparse_mha=False, routed_ffn=False)),
        ("mha 1/4", dict(attn_top_fraction=0.25, routed_ffn=False)),
        ("mha 1/8", dict(attn_top_fraction=0.125, routed_ffn=False)),
        ("ffn 3/4", dict(sparse_mha=False, ffn_active_groups=6)),
        ("ffn 1/2", dict(sparse_mha=False, ffn_active_groups=4)),
        ("spt (1/8 + 1/2)", dict(attn_top_fraction=0.125,
                                 ffn_active_groups=4)),
    ]
    for name, spt_kw in grid:
        cfg = base.with_spt(**spt_kw)
        data = synthetic_dataset(
            DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                       global_batch=8, seed=7), steps=args.steps + 1)
        t = Trainer(cfg, OptimizerConfig(lr=3e-3, total_steps=args.steps),
                    TrainerConfig(total_steps=args.steps, log_interval=20),
                    device=device)
        rep = t.run(data)
        last = rep["metrics"][-1]
        rows.append({"setting": name, "loss": round(last["loss"], 4),
                     "ppl": round(2.718281828 ** last["lm_loss"], 2),
                     "acc": round(last["accuracy"], 4)})
        print(rows[-1])
    print(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
