"""Learning-rate schedules (warmup + cosine/linear decay), in f32 as the
JAX package computes them."""
from __future__ import annotations

import math

import torch


def lr_at(cfg, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a scalar tensor; a
    state's counter is already on the host): a 0-d f32 tensor on the
    CPU."""
    s = torch.as_tensor(step, dtype=torch.float32).cpu()
    warm = torch.clamp((s + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones(())
    return cfg.lr * warm * decay
