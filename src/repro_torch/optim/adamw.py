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

from repro_torch.core import collectives as C
from repro_torch.core.params import leaves, unflatten
from repro_torch.sharding.context import Pick, current_rules, entry_axes
from repro_torch.sharding.rules import mesh_coords, mesh_sizes


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
def global_norm(tree: Any, specs: Any = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (None leaves add
    nothing).  With ``specs`` (the tree's storage placements under the
    active mesh, train/state.storage_specs) each leaf is this rank's part
    and every element of the model counts once: a rank adds the squares
    it owns (``_owned_squares``) and the sum is all-reduced over the
    model and data axes."""
    pairs = list(leaves(tree))
    if specs is None:
        sq = [x.float().square().sum() for _, x in pairs]
    else:
        mesh = current_rules()["__mesh__"]
        sizes, coords = mesh_sizes(mesh), mesh_coords(mesh)
        spec_of = dict(leaves(specs))
        sq = [_owned_squares(x, spec_of[path], sizes, coords)
              for path, x in pairs]
    if not sq:
        return torch.zeros((), dtype=torch.float32)
    total = sum(sq[1:], sq[0])
    if specs is not None:
        C.all_reduce_(total, C.model_axis())
        C.all_reduce_(total, C.batch_axis())
    return torch.sqrt(total)


def _owned_squares(x: torch.Tensor, spec, sizes, coords) -> torch.Tensor:
    """The sum of squares of the elements of this rank's part ``x`` that
    it owns: all of a part split over every axis of extent > 1; nothing
    off index 0 of an axis the leaf is replicated over; of a Pick's
    columns those no lower model rank holds."""
    split = ({"model"} if isinstance(spec, Pick) else
             {a for e in spec for a in entry_axes(e)})
    if any(n > 1 and a not in split and coords.get(a, 0)
           for a, n in sizes.items()):
        return x.new_zeros((), dtype=torch.float32)
    if isinstance(spec, Pick):
        r = coords.get("model", 0)
        lower = {c for q in range(r) for c in spec.index[q]}
        own = [i for i, c in enumerate(spec.index[r]) if c not in lower]
        x = x.index_select(spec.dim, torch.as_tensor(own, device=x.device))
    return x.float().square().sum()


@torch.no_grad()
def adamw_update(train_params: Any, grads: Any, opt_state: dict,
                 step, cfg: OptimizerConfig,
                 lr: Optional[torch.Tensor] = None,
                 specs: Any = None) -> Tuple[Any, dict, dict]:
    """One AdamW step.  grads: the train tree's paths, a missing or None
    leaf meaning zero; an empty tree (nothing trainable) stays empty.
    Under a mesh each leaf, gradient and moment is this rank's part
    (``specs``: the train tree's storage placements), updated in place of
    the whole, the clip by the norm of the whole (``global_norm``).
    Returns (new_params, new_opt, {grad_norm, lr})."""
    from repro_torch.optim.schedule import lr_at
    pairs = list(leaves(train_params))
    paths = [path for path, _ in pairs]
    ps = [p for _, p in pairs]
    dev = ps[0].device if ps else torch.as_tensor(step).device
    gnorm = global_norm(grads, specs).to(dev)
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
