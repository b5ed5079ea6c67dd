#!/usr/bin/env python3
"""Which bf16 roundings of kernel 9 (the grouped routed FFN's tensor-core
body, csrc/grouped_ffn.cu) put its outputs past chip_smoke.py's
per-element rule (|y - y_plain| <= 2e-2 + 2e-2 |y_plain| on kept slots).

It emulates the kernel's arithmetic in f32 on the CPU (bf16 operands,
f32 sums, as wgmma takes them) at the widths and the seeded inputs of
chip_smoke.py's kernel-9 cases (x, W ~ N(0, 1 / fan) in bf16, LoRA
factors 0.05 N(0, 1) in f32, scale 1, SwiGLU, 8 groups, top 4, capacity
1.25, 4 rows of 1024), drawn with torch's CPU generator, and counts the
outputs past the rule under each set of roundings:

  once    the LoRA factors, U = s x B, V = s h B_O and h each rounded to
          bf16 once (the body up to rank 32);
  split   the factors as bf16 halves (routed_ffn/ops.py, _split_pairs),
          U, V and h rounded once;
  halves  the factors, U, V and h all as bf16 halves (the GEN instances
          of the wide form past rank 32);
the output rounded to bf16 in every case, as the plain version's is.

    python3 scripts/torch_ffn_rounding.py [--d 1024 --f 384] [--ranks 16
        64 128] [--seeds 1 2 3]

One JSON line a (d, F, rank, seed): outputs past the rule and the
largest error under each.  Imports nothing of JAX.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def bf(t):
    return t.to(torch.bfloat16).float()


def halves(t):
    """t as bf16 hi + lo, summed back in f32."""
    hi = bf(t)
    return hi + bf(t - hi)


def case(d, f, r, seed, g=8, ga=4, rows=4, seq=1024):
    from repro_torch.core import routed_ffn as rf
    from repro_torch.core.routed_ffn import ACTIVATIONS
    gen = torch.Generator().manual_seed(seed)

    def w(*shape, fan):
        return bf(torch.randn(*shape, generator=gen) / fan ** 0.5)

    def lo(*shape):
        return torch.randn(*shape, generator=gen) * 0.05
    wi, wg, wo = w(g, d, f, fan=d), w(g, d, f, fan=d), w(g, f, d, fan=f)
    lora = {"i": (lo(d, r), lo(g, r, f)), "g": (lo(d, r), lo(g, r, f)),
            "o": (lo(g, f, r), lo(r, d))}
    x = bf(torch.randn(rows, seq, d, generator=gen))
    cfg = rf.RoutedFFNConfig(d_model=d, d_ff=f * g, num_groups=g,
                             active_groups=ga, capacity_factor=1.25,
                             activation="silu", gated=True)
    router = torch.randn(d, g, generator=gen) / d ** 0.5
    choice, gate, _ = rf.route(x, router, cfg, need_aux=False)
    plan = rf.plan_for(x, choice, gate, cfg, None)
    idx = plan.index.long().clamp(max=seq - 1).reshape(rows, -1)
    xg = x.gather(1, idx[..., None].expand(rows, idx.shape[1], d))
    xg = xg.reshape(rows, g, -1, d)
    act = ACTIVATIONS["silu"]

    def forward(leaf, inter):
        def up(wt, key):
            b, c = (leaf(t) for t in lora[key])
            u = inter(torch.einsum("bgcd,dr->bgcr", xg, b))
            return (torch.einsum("bgcd,gdf->bgcf", xg, wt)
                    + torch.einsum("bgcr,grf->bgcf", u, c))
        h = inter(act(up(wg, "g")) * up(wi, "i"))
        b, c = (leaf(t) for t in lora["o"])
        v = inter(torch.einsum("bgcf,gfr->bgcr", h, b))
        return bf(torch.einsum("bgcf,gfd->bgcd", h, wo)
                  + torch.einsum("bgcr,rd->bgcd", v, c))

    def exact(t):
        return t
    want = forward(exact, exact)
    ok = plan.slot_ok[..., None]
    out = {}
    for name, leaf, inter in (("once", bf, bf), ("split", halves, bf),
                              ("halves", halves, halves)):
        diff = torch.where(ok, (forward(leaf, inter) - want).abs(), 0.0)
        past = (diff > 0.02 + 0.02 * want.abs()) & ok
        out[name] = {"past": int(past.sum()), "max_abs_err": float(diff.max())}
    return {"d": d, "F": f, "rank": r, "seed": seed,
            "outputs": int(ok.sum()) * d, **out}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--f", type=int, default=384)
    ap.add_argument("--ranks", type=int, nargs="+", default=[16, 64, 128])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    for r in args.ranks:
        for seed in args.seeds:
            print(json.dumps(case(args.d, args.f, r, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
