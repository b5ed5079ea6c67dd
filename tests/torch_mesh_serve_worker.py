"""Workers of tests/test_torch_multigpu_serve.py, spawned in gloo worlds by
tests/torch_mesh_worker.py's ``start_worlds`` ("torch_mesh_serve_worker:
<name>").  Imports torch and the port only, never JAX.

``serve_case`` builds the engine over this rank's mesh from the whole
model (every rank the same), serves a burst (``Engine.run``) or a fixed
batch (``Engine.generate``), and returns the streams, the stats, the
cache shapes of this rank and the shapes of what reached the kernels'
wrappers (``Shapes``).  ``train_shapes_case`` is torch_mesh_worker's
``train_case`` with the shapes recorded; ``resume_case`` stops a Trainer
after step 2 by its stop flag and resumes it in a fresh Trainer.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

import torch_mesh_worker as W


# ------------------------------------------------------------ recording
class Shapes:
    """Records, per wrapper of the kernels (their plain versions on the
    CPU) and per recurrent scan, the distinct shapes of the inputs that
    carry the head, column or slot counts."""

    def __init__(self):
        from repro_torch.kernels.routed_ffn import ops as rffn_ops
        from repro_torch.kernels.sparse_attention import ops as sa_ops
        from repro_torch.kernels.topl_select import ops as topl_ops
        from repro_torch.models import rglru, ssd
        self.seen = set()
        pick = {
            (sa_ops, "sparse_mha"): lambda a: (a[0], a[1]),
            (sa_ops, "sparse_mha_decode"): lambda a: (a[0], a[1]),
            (sa_ops, "sparse_mha_decode_paged"): lambda a: (a[0], a[1]),
            (sa_ops, "dense_mha_decode_paged"): lambda a: (a[0], a[1]),
            (topl_ops, "decode_topl_thresholds"): lambda a: (a[0], a[1]),
            (sa_ops, "sparse_decode_attention"): lambda a: (a[0], a[1]),
            (rffn_ops, "routed_ffn"): lambda a: (a[0], a[1]["w_inner"]),
            (rffn_ops, "routed_ffn_decode"):
                lambda a: (a[0], a[1]["w_inner"]),
            (rffn_ops, "grouped_ffn"): lambda a: (a[0], a[2]),
            (rffn_ops, "decode_ffn"): lambda a: (a[0], a[3]),
            (rglru, "rglru_scan"): lambda a: (a[1],),
            (rglru, "rglru_step"): lambda a: (a[1], a[2]),
            (ssd, "ssd_scan"): lambda a: (a[0], a[1]),
            (ssd, "ssd_step"): lambda a: (a[0], a[5]),
        }
        self._mods = list(pick.items())
        self._orig = [getattr(m, n) for (m, n), _ in self._mods]

    def __enter__(self):
        for ((mod, name), sel), orig in zip(self._mods, self._orig):
            setattr(mod, name, self._wrap(name, orig, sel))
        return self

    def _wrap(self, name, orig, sel):
        @functools.wraps(orig)
        def rec(*a, **k):
            self.seen.add((name, tuple(tuple(t.shape) for t in sel(a))))
            return orig(*a, **k)
        return rec

    def __exit__(self, *exc):
        for ((mod, name), _), orig in zip(self._mods, self._orig):
            setattr(mod, name, orig)

    def by_name(self):
        out = {}
        for name, shapes in sorted(self.seen):
            out.setdefault(name, []).append(shapes)
        return out


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


# --------------------------------------------------------------- models
def family_model(cfg, seed: int = 0):
    """The port's seeded model of ``cfg`` on the CPU (``init_tree``) with
    every leaf in f32 (the base weights are drawn in bf16), its LoRA C
    leaves moved off zero (seeded) so the adapters' partial sums are
    exercised."""
    import torch
    from repro_torch.models import encdec, transformer
    cls = encdec.EncDecLM if cfg.family == "audio" else transformer.LM
    model = cls.init(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in sorted(model.named_parameters()):
            if t.is_floating_point():
                t.data = t.data.float()
            if name.endswith("lora.c") or (".lora_" in name
                                           and name.endswith(".c")):
                t.copy_(0.05 * torch.randn(t.shape, generator=gen))
    return model


def _model(cfg, tree, seed):
    from repro_torch.core.params import from_numpy_tree
    from repro_torch.models import transformer
    if tree is None:
        return family_model(cfg, seed)
    return transformer.LM(cfg, from_numpy_tree(tree, "cpu"), device="cpu")


STAT_KEYS = ("prefill_tokens", "decode_tokens", "decode_steps", "admitted",
             "completed", "prefill_batches", "preemptions", "rejections",
             "cancelled", "shed", "page_size", "kv_pages_total",
             "kv_pages_peak", "admission_stalls")


def serve(cfg, tree=None, seed=0, mesh=None, reqs=(), engine_kw=None,
          run_kw=None, generate=None):
    """One engine over ``mesh`` (None: no mesh): ``Engine.run`` of
    ``reqs`` [(uid, tokens, max_new), ...] or, with ``generate`` (batch
    of numpy arrays, steps), ``Engine.generate``."""
    import torch
    from repro_torch.serving.engine import Engine, Request
    model = _model(cfg, tree, seed)
    eng = Engine(cfg, model, device="cpu", mesh=mesh, **(engine_kw or {}))
    caches = {}

    def grab(e, i):
        if not caches:
            caches.update(_shapes(e._live.caches))
    with Shapes() as rec:
        if generate is not None:
            batch, steps = generate
            out = {"streams": eng.generate(
                {k: torch.as_tensor(v) for k, v in batch.items()},
                steps).tokens}
        else:
            res = eng.run([Request(uid=u, tokens=list(t), max_new_tokens=m)
                           for u, t, m in reqs], on_iteration=grab,
                          **(run_kw or {}))
            st = eng.last_stats
            out = {"streams": [(c.tokens, c.finish_reason) for c in res],
                   "stats": {k: getattr(st, k) for k in STAT_KEYS},
                   "device": dict(st.device),
                   "steps_run": eng.last_steps_run, "caches": caches}
    out["shapes"] = rec.by_name()
    out["vocab"] = {k: tuple(getattr(eng.model, k)[w].shape)
                    for k, w in (("embed", "embedding"), ("head", "w"))
                    if getattr(eng.model, k, None) is not None}
    return out


# -------------------------------------------------------------- workers
def serve_case(rank, world, mesh_shape, **kw):
    mesh, _ = W._mesh(mesh_shape)
    from repro_torch.core import collectives as C
    out = serve(mesh=mesh, **kw)
    dp, tp = C.mesh_axis(mesh, "data"), C.mesh_axis(mesh, "model")
    out["dp"] = (dp.rank, dp.size) if dp else (0, 1)
    out["tp"] = (tp.rank, tp.size) if tp else (0, 1)
    return out


def train_shapes_case(rank, world, **kw):
    with Shapes() as rec:
        out = W.train_case(rank, world, **kw)
    out["shapes"] = rec.by_name()
    return out


def launcher_case(rank, world, argv):
    """launch/serve.py's main in this world; rank 0's JSON blob."""
    import contextlib
    import io
    from repro_torch.launch import serve as serve_launcher
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_launcher.main(argv)
    return {"rc": rc, "out": buf.getvalue()}


def resume_case(rank, world, mesh_shape, cfg, ckpt_dir, batches, ocfg):
    """Under the mesh: 4 Trainer steps uninterrupted (no checkpoint), then
    a Trainer over ``ckpt_dir`` whose stop flag is raised after step 2
    (it checkpoints and stops), and a fresh Trainer that resumes there
    and runs to step 4.  Losses per step and the final trainable leaves
    of both runs."""
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    mesh, rules = W._mesh(mesh_shape)
    ocfg = OptimizerConfig(**ocfg)

    def trainer(ckpt):
        return Trainer(cfg, ocfg, TrainerConfig(
            total_steps=4, ckpt_dir=ckpt, ckpt_interval=100,
            log_interval=1, loss_chunk=16), seed=0, device="cpu",
            mesh=mesh, rules=rules)

    def losses(tr):
        return {m["step"]: m["loss"] for m in tr.metrics_log}

    full = trainer(None)
    full_report = full.run(iter(batches))
    first = trainer(ckpt_dir)

    def stop_at_two(step, metrics):
        if step == 2:
            first._stop = True
    first_report = first.run(iter(batches), step_hook=stop_at_two)
    second = trainer(ckpt_dir)
    start = second.start_step
    second_report = second.run(iter(batches[start:]))
    return {"full": losses(full), "first": losses(first),
            "second": losses(second), "start": start,
            "stopped": (first_report["final_step"],
                        first_report["interrupted"]),
            "final": (full_report["final_step"],
                      second_report["final_step"]),
            "full_after": W._tree_np(full.state["train"]),
            "resumed_after": W._tree_np(second.state["train"])}


def cases(rank, world, cases):
    """Several cases in one world, in order: [(fn name, kwargs), ...]."""
    return [globals()[name](rank, world, **kw) for name, kw in cases]


def f32(cfg, **spt):
    """``cfg`` in f32 with the kernel configuration (the plain versions
    on the CPU)."""
    import torch
    return dataclasses.replace(cfg, dtype=torch.float32).with_spt(
        attn_impl="pallas", ffn_impl="pallas", **spt)


def requests(vocab: int, lengths, max_new: int, seed: int):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=n).tolist(), max_new)
            for i, n in enumerate(lengths)]
