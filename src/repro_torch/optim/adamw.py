"""AdamW over the trainable subtree only (LoRA + router + codebooks).

The JAX package's ``adamw_update`` written in torch: f32 moments,
global-norm clipping, bias correction and decoupled weight decay on every
trainable leaf, the codebooks included.  A leaf whose gradient is None
(no path from the loss reaches it) counts as a zero gradient, as JAX
hands it zeros: its moments decay and weight decay still applies.  No
``torch.optim``; the update is functional (new trees) under no_grad.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.params import leaves, unflatten


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01   # paper: "weight decay is enabled"
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"     # cosine | linear | constant


def adamw_init(train_params: Any) -> dict:
    pairs = list(leaves(train_params))
    paths = [path for path, _ in pairs]
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for _, p in pairs]
    return {"m": unflatten(paths, zeros),
            "v": unflatten(paths, [z.clone() for z in zeros])}


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (None leaves add
    nothing)."""
    sq = [x.float().square().sum() for _, x in leaves(tree)]
    if not sq:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(sq[1:], sq[0]))


@torch.no_grad()
def adamw_update(train_params: Any, grads: Any, opt_state: dict,
                 step, cfg: OptimizerConfig,
                 lr: Optional[torch.Tensor] = None) -> Tuple[Any, dict, dict]:
    """One AdamW step.  grads: the train tree's paths, a missing or None
    leaf meaning zero; an empty tree (nothing trainable) stays empty.
    Returns (new_params, new_opt, {grad_norm, lr})."""
    from repro_torch.optim.schedule import lr_at
    pairs = list(leaves(train_params))
    paths = [path for path, _ in pairs]
    ps = [p for _, p in pairs]
    dev = ps[0].device if ps else torch.as_tensor(step).device
    gnorm = global_norm(grads).to(dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    scale = (torch.minimum(one, cfg.grad_clip / (gnorm + 1e-12))
             if cfg.grad_clip > 0 else one)
    lr_t = (lr_at(cfg, step) if lr is None
            else torch.as_tensor(lr, dtype=torch.float32)).to(dev)
    t = (torch.as_tensor(step).to(dev) + 1).float()
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=dev), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=dev), t)
    g_of, m_of, v_of = (dict(leaves(x)) for x in
                        (grads, opt_state["m"], opt_state["v"]))
    new_p, new_m, new_v = [], [], []
    for path, p in zip(paths, ps):
        m, v = m_of[path], v_of[path]
        g = g_of.get(path)
        g = (torch.zeros_like(m) if g is None else g.float()) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        step_ = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        pf = pf - lr_t * (step_ + cfg.weight_decay * pf)
        new_p.append(pf.to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (unflatten(paths, new_p),
            {"m": unflatten(paths, new_m), "v": unflatten(paths, new_v)},
            {"grad_norm": gnorm, "lr": lr_t})
