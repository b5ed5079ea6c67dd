"""Public routed-FFN ops.

``routed_ffn`` (train / prefill): route + capacity plan in plain torch,
then the grouped-FFN CUDA kernel runs the grouped products (LoRA
included) with the token gather inside the kernel, so the (B, G, C, d)
dispatch buffer never exists in device memory; the combine scatter-add
stays in torch, as it stays jnp in JAX.  Under autograd it runs in a
``torch.autograd.Function`` whose backward differentiates the reference
grouped path (``core.routed_ffn.routed_ffn(impl="grouped")``): the same
routing plan, so the same function — the JAX custom_vjp's contract.  The
ragged ``seq_lengths`` form is serving-only: it bypasses the Function and
raises under grad instead of dropping the capacity override.

``routed_ffn_decode`` (x of shape (B, 1, d)): no plan at all — the top-G'
choices index the weight blocks inside the decode kernel.  Inference-only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.core import dispatch, lora
from repro_torch.core.params import leaves, unflatten
from repro_torch.core.routed_ffn import RoutedFFNConfig, plan_for, route
from repro_torch.core.routed_ffn import routed_ffn as routed_ffn_core
from repro_torch.kernels import cost
from repro_torch.kernels.routed_ffn.ref import decode_ffn_ref, grouped_ffn_ref

_LORA_KEYS = ("lora_inner", "lora_gate", "lora_outer")


# The rank axis of each LoRA leaf, in launcher order: inner b (d, r),
# inner c (G, r, F), gate b and c alike, outer b (G, F, r), outer c (r, d).
_RANK_AXIS = (-1, -2, -1, -2, -1, -2)


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """t, or a copy of it in storage of its own when its data does not
    start on 16 bytes (the kernels load rows as 16-byte vectors; a
    contiguous view may start inside its storage)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


# Past this rank the bf16 grouped kernel takes each LoRA pair (b, c) split
# into bf16 halves (``_split_pairs``).
SPLIT_RANK = 32


def kernel_rank(r: int, dtype) -> int:
    """The LoRA rank kernel 9 runs at for a rank-r adapter in x's dtype:
    r padded to 8 in bf16, three times that past SPLIT_RANK (the split
    leaves), r itself in f32."""
    if dtype != torch.bfloat16:
        return r
    r8 = r + -r % 8
    return 3 * r8 if r8 > SPLIT_RANK else r8


def _split_pairs(ts):
    """Each LoRA pair (b, c) as rank-3r bf16 leaves b' = [b_hi | b_lo |
    b_hi], c' = [c_hi ; c_hi ; c_lo] (hi = bf16(v), lo = bf16(v - hi)):
    x b' c' = x (b_hi + b_lo) c_hi + x b_hi c_lo, x b c up to the x b_lo
    c_lo term (~2^-16 of it).  The LoRA term grows with the rank, and past
    rank 32 one bf16 rounding of each leaf alone puts outputs past the
    per-element 2e-2 rule (scripts/torch_ffn_rounding.py: at d 1024 / F
    384, rank 128, 32-37 of 16.8M kept outputs, none with the leaves as
    halves)."""
    out = []
    for i in range(0, 6, 2):
        b, c = ts[i], ts[i + 1]
        if b is None:
            out += [None, None]
            continue
        bh, ch = b.to(torch.bfloat16), c.to(torch.bfloat16)
        bl = (b - bh.float()).to(torch.bfloat16)
        cl = (c - ch.float()).to(torch.bfloat16)
        out += [torch.cat([bh, bl, bh], _RANK_AXIS[i]),
                torch.cat([ch, ch, cl], _RANK_AXIS[i + 1])]
    return out


def _lora_leaves(lora_params, gated: bool, dtype=torch.float32,
                 multiple: int = 1):
    """The six LoRA leaves in launcher order (None = absent), in ``dtype``
    (the bf16 grouped kernel takes them rounded to bf16; past rank
    SPLIT_RANK split into bf16 halves, ``_split_pairs``), with the rank
    padded by zeros to a multiple of ``multiple`` (the kernels read rank
    rows as 16-byte vectors; a zero rank adds nothing to the function),
    16-byte aligned, and the rank the kernel runs at.  Keep the returned
    tensors alive until the launch is enqueued."""
    if lora_params is None:
        return [None] * 6, 0
    ts = [lora_params["lora_inner"]["b"], lora_params["lora_inner"]["c"]]
    if gated:
        ts += [lora_params["lora_gate"]["b"], lora_params["lora_gate"]["c"]]
    else:
        ts += [None, None]
    ts += [lora_params["lora_outer"]["b"], lora_params["lora_outer"]["c"]]
    for t in ts:
        if t is not None and (t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise TypeError("LoRA leaves must be contiguous float32")
    r = ts[0].shape[-1]
    pad = -r % multiple
    if pad:
        ts = [None if t is None else
              torch.nn.functional.pad(t, (0, 0) * (-ax - 1) + (0, pad))
              for t, ax in zip(ts, _RANK_AXIS)]
    if dtype == torch.bfloat16 and r + pad > SPLIT_RANK:
        return [_aligned(t) for t in _split_pairs(ts)], 3 * (r + pad)
    if dtype != torch.float32:
        ts = [None if t is None else t.to(dtype) for t in ts]
    return [_aligned(t) for t in ts], r + pad


def _ptrs(ts):
    return [None if t is None else t.data_ptr() for t in ts]


def _check_weights(name, x, w_inner, w_outer, w_gate):
    ws = [w_inner, w_outer] + ([w_gate] if w_gate is not None else [])
    kernels.require_cuda(name, x, *ws)
    if any(w.dtype != x.dtype for w in ws):
        raise TypeError(f"{name}: weights must have x's dtype {x.dtype}")


@cost.counted("grouped_ffn")
def grouped_ffn(x: torch.Tensor, index: torch.Tensor, w_inner: torch.Tensor,
                w_outer: torch.Tensor, w_gate: Optional[torch.Tensor] = None,
                lora_params: Optional[dict] = None, lora_scale: float = 1.0,
                *, act: str = "relu") -> torch.Tensor:
    """x: (B, S, d); index: (B, G, C) int32 plan (S = empty slot);
    w_inner/w_gate: (G, d, F); w_outer: (G, F, d).  Returns y (B, G, C, d)
    in x's dtype; empty slots hold finite rows that ``dispatch.combine``
    drops.  Any order of the index is computed right (a 64-slot tile
    that keeps no slot is skipped).  Any d, F and LoRA rank.  CPU tensors
    take the plain version; CUDA tensors launch the kernel
    (csrc/grouped_ffn.cu: bf16 on the tensor cores — x and h resident in
    shared memory where they fit, else two passes through an h scratch;
    f32 on the CUDA cores); meta tensors get the output's shape."""
    if kernels.target(x) == "cpu":
        return grouped_ffn_ref(x, index, w_inner, w_outer, w_gate,
                               lora_params, lora_scale, act).contiguous()
    name = "grouped_ffn"
    _check_weights(name, x, w_inner, w_outer, w_gate)
    kernels.require_cuda(name, x, index)
    b, s, d = x.shape
    _, g, c = index.shape
    f = w_inner.shape[-1]
    if (index.dtype != torch.int32 or w_inner.shape != (g, d, f)
            or w_outer.shape != (g, f, d)):
        raise ValueError(f"{name}: inconsistent shapes or index dtype")
    bf16 = x.dtype == torch.bfloat16    # the tensor-core body's contract
    if bf16:
        x, w_inner, w_outer, w_gate = map(_aligned,
                                          (x, w_inner, w_outer, w_gate))
    lo, r = _lora_leaves(lora_params, w_gate is not None, x.dtype,
                         8 if bf16 else 1)
    y = torch.empty((b, g, c, d), dtype=x.dtype, device=x.device)
    lib = None if x.is_meta else kernels.library()
    # the bf16 body's wide form (x and h tiles past shared memory) keeps h
    # (B, G, C, F) in device memory between its two kernels; a dry run
    # takes the library's rule from its restatement in kernels/cost.py
    h_elems = (cost.grouped_ffn_h_elems(x.dtype, d, f, r) if lib is None
               else lib.repro_grouped_ffn_h_elems(kernels.dtype_code(x), d,
                                                  f, r))
    h = (torch.empty(b * g * c * h_elems, dtype=x.dtype, device=x.device)
         if h_elems else None)
    if lib is None:
        return y
    err = lib.repro_grouped_ffn(
        kernels.dtype_code(x), x.data_ptr(), index.data_ptr(),
        w_inner.data_ptr(), None if w_gate is None else w_gate.data_ptr(),
        w_outer.data_ptr(), *_ptrs(lo), None if h is None else h.data_ptr(),
        y.data_ptr(), b, s, d, g, c, f, r, float(lora_scale),
        kernels.act_code(act), kernels.stream_ptr())
    kernels.check(err, name)
    grouped_ffn.launches += 1
    return y


grouped_ffn.launches = 0


def decode_ffn_max_d(slots: int, elem_bytes: int) -> int:
    """The widest d kernel 10 takes for ``slots`` (slot, choice) pairs and
    x of ``elem_bytes``: its hidden pass stages 8 pairs' x rows (as f32
    where that fits, else as stored) beside 36,864 bytes of sums and LoRA
    rows in a block's 232,448 bytes of shared memory (csrc/decode_ffn.cu,
    launch).  bf16 takes d up to ~12,200, f32 up to ~6,100; the output
    pass chunks h, so F is free."""
    room = 232448 - 36864 - 4 * ((slots + 4) & ~3)
    return room // (8 * elem_bytes) // 8 * 8


@cost.counted("decode_ffn")
def decode_ffn(x: torch.Tensor, choice: torch.Tensor, gate: torch.Tensor,
               w_inner: torch.Tensor, w_outer: torch.Tensor,
               w_gate: Optional[torch.Tensor] = None,
               lora_params: Optional[dict] = None, lora_scale: float = 1.0,
               *, act: str = "relu") -> torch.Tensor:
    """x: (B, d); choice: (B, G') int32; gate: (B, G') f32.  Returns y
    (B, d) in x's dtype.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (csrc/decode_ffn.cu: group-major, each chosen
    group's weights read once, every sum in a fixed order; d up to
    ``decode_ffn_max_d``); meta tensors get the output's shape."""
    if kernels.target(x) == "cpu":
        return decode_ffn_ref(x, choice, gate, w_inner, w_outer, w_gate,
                              lora_params, lora_scale, act).contiguous()
    name = "decode_ffn"
    _check_weights(name, x, w_inner, w_outer, w_gate)
    kernels.require_cuda(name, x, choice, gate)
    b, d = x.shape
    ga = choice.shape[1]
    f = w_inner.shape[-1]
    if (choice.dtype != torch.int32 or gate.dtype != torch.float32
            or gate.shape != choice.shape or w_inner.shape[1] != d):
        raise ValueError(f"{name}: inconsistent shapes or dtypes")
    if d % 8 or f % 8:
        raise ValueError(f"{name}: d={d} and F={f} must be multiples of 8 "
                         "(16-byte weight rows)")
    limit = decode_ffn_max_d(b * ga, x.element_size())
    if d > limit:
        raise ValueError(f"{name}: {x.dtype} x takes d up to {limit} at "
                         f"{b * ga} (slot, choice) pairs, got d={d}")
    x, w_inner, w_outer, w_gate = map(_aligned, (x, w_inner, w_outer, w_gate))
    lo, r = _lora_leaves(lora_params, w_gate is not None, multiple=4)
    if r > 64:
        raise ValueError(f"{name}: the kernel takes a LoRA rank of at most "
                         f"64, got {r}")
    g = w_inner.shape[0]
    # h (B*G', F), pass 2's h W_O (B*G', d) and its column blocks' shares
    # of h B_O (d / 64, B*G', r): csrc/decode_ffn.cu, Scratch
    bga = b * ga
    scratch = torch.empty(bga * (f + d) + -(-d // 64) * bga * r,
                          dtype=torch.float32, device=x.device)
    y = torch.empty((b, d), dtype=x.dtype, device=x.device)
    if x.is_meta:
        return y
    err = kernels.library().repro_decode_ffn(
        kernels.dtype_code(x), x.data_ptr(), choice.data_ptr(),
        gate.data_ptr(), w_inner.data_ptr(),
        None if w_gate is None else w_gate.data_ptr(), w_outer.data_ptr(),
        *_ptrs(lo), scratch.data_ptr(), y.data_ptr(), b, d, g, ga, f, r,
        float(lora_scale), kernels.act_code(act), kernels.stream_ptr())
    kernels.check(err, name)
    decode_ffn.launches += 1
    return y


decode_ffn.launches = 0


def _lora_tree(p, lora_cfg) -> Optional[dict]:
    if lora_cfg.enabled and "lora_inner" in p:
        return {k: p[k] for k in _LORA_KEYS if k in p}
    return None


def _gate_w(p, cfg: RoutedFFNConfig):
    return p["w_gate"] if cfg.gated else None


def _forward(x: torch.Tensor, p, cfg: RoutedFFNConfig,
             lora_cfg: lora.LoRAConfig, need_aux: bool,
             seq_lengths: Optional[torch.Tensor] = None):
    """Route, plan, the grouped kernel, combine: (out, lb_loss, dropped)."""
    s = x.shape[1]
    choice, gate_w, probs = route(x, p["router"], cfg, need_aux=need_aux)
    plan = plan_for(x, choice, gate_w, cfg, seq_lengths)
    y = grouped_ffn(x.contiguous(), plan.index, p["w_inner"], p["w_outer"],
                    _gate_w(p, cfg), _lora_tree(p, lora_cfg), lora_cfg.scale,
                    act=cfg.activation)
    out = dispatch.combine(y, plan, s)
    lb = (dispatch.load_balance_loss(probs, choice, cfg.num_groups)
          if need_aux else torch.zeros((), dtype=torch.float32,
                                       device=x.device))
    return out, lb, plan.dropped


class _KernelForward(torch.autograd.Function):
    """Kernel forward, reference backward (JAX: the custom_vjp of the
    routed FFN and of MoE).  ``fwd(x, p)`` -> (out, lb_loss, dropped)
    runs the kernel; ``ref(x, p)`` -> (out, lb_loss) is the reference
    that computes the same function on the same routing plan, and the
    backward differentiates it.  The leaves of ``p`` are separate tensor
    arguments so that autograd sees each; ``dropped`` is not
    differentiable."""

    @staticmethod
    def forward(ctx, x, fwd, ref, paths, *values):
        out, lb, dropped = fwd(x, unflatten(paths, values))
        ctx.save_for_backward(x, *values)
        ctx.args = (ref, paths)
        ctx.mark_non_differentiable(dropped)
        return out, lb, dropped

    @staticmethod
    def backward(ctx, g_out, g_lb, _g_dropped):
        x, *values = ctx.saved_tensors
        ref, paths = ctx.args
        want = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[4:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(w)
                      for t, w in zip([x, *values], want)]
            out, lb = ref(inputs[0], unflatten(paths, inputs[1:]))
            outs, cts = [out], [g_out]
            if lb.requires_grad:
                outs.append(lb)
                cts.append(g_lb)
            wrt = [t for t, w in zip(inputs, want) if w]
            got = iter(torch.autograd.grad(outs, wrt, cts, allow_unused=True))
        grads = [next(got) if w else None for w in want]
        grads = [torch.zeros_like(t) if w and gr is None else gr
                 for t, w, gr in zip([x, *values], want, grads)]
        return (grads[0], None, None, None, *grads[1:])


def kernel_forward(x: torch.Tensor, p, fwd, ref):
    """(out, lb_loss, dropped) of ``fwd`` with ``ref``'s gradients
    (``_KernelForward``)."""
    paths, values = zip(*leaves(p))
    return _KernelForward.apply(x, fwd, ref, paths, *values)


def routed_ffn(x: torch.Tensor, p, cfg: RoutedFFNConfig,
               lora_cfg: lora.LoRAConfig, *, need_aux: bool = True,
               seq_lengths: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Drop-in for core.routed_ffn.routed_ffn (grouped semantics) through
    the grouped-FFN kernel.  seq_lengths gives right-padded ragged prefill
    rows their exact-length dispatch capacity (forward only)."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    if seq_lengths is not None:
        if torch.is_grad_enabled() and (
                x.requires_grad or any(t.requires_grad
                                       for _, t in leaves(p))):
            raise RuntimeError("routed_ffn: the ragged seq_lengths path "
                               "is forward-only (serving)")
        out, lb, dropped = _forward(x, p, cfg, lora_cfg, need_aux,
                                    seq_lengths)
    else:
        def ref(x_, p_):
            out_, aux_ = routed_ffn_core(x_, p_, cfg, lora_cfg,
                                         impl="grouped", need_aux=need_aux)
            return out_, aux_["lb_loss"]
        out, lb, dropped = kernel_forward(
            x, p, lambda x_, p_: _forward(x_, p_, cfg, lora_cfg, need_aux),
            ref)
    aux = {"lb_loss": lb, "dropped": dropped}
    return (out[0] if squeeze else out), aux


def routed_ffn_decode(x: torch.Tensor, p, cfg: RoutedFFNConfig,
                      lora_cfg: lora.LoRAConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode-shaped routed FFN: x (B, 1, d) (or (B, d)) -> same shape.
    Aux is zeros (no load-balance term at serving time)."""
    squeeze = x.dim() == 2
    x3 = x[:, None] if squeeze else x
    choice, gate_w, _ = route(x3, p["router"], cfg, need_aux=False)
    y = decode_ffn(x3[:, 0].contiguous(), choice[:, 0].contiguous(),
                   gate_w[:, 0].contiguous(), p["w_inner"], p["w_outer"],
                   _gate_w(p, cfg), _lora_tree(p, lora_cfg), lora_cfg.scale,
                   act=cfg.activation)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"lb_loss": zero, "dropped": zero}
    return (y if squeeze else y[:, None]), aux
