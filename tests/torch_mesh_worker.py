"""Spawned gloo worlds for tests/test_torch_multigpu.py (imports torch and
the port only, so each child starts fast and never touches JAX).

``start_worlds(specs, tmp_path)`` starts every world's processes at once
(the ``spawn`` start method); each joins its world's gloo group through a
``file://`` store under ``tmp_path`` (60 s collective timeout), runs its
worker on one torch thread and saves the result; the parent joins every
child by one deadline (``join_worlds``), kills them all and raises when
it passes, and returns the results by world and rank.
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import io
import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np

TIMEOUT_S = 120.0


def _worker(fn_name):
    """A worker by name: one of this module's, or "module:name"."""
    if ":" not in fn_name:
        return globals()[fn_name]
    import importlib
    mod, name = fn_name.split(":")
    return getattr(importlib.import_module(mod), name)


def _entry(rank, world, init_file, fn_name, kw, out_path):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        result = {"ok": _worker(fn_name)(rank, world, **kw)}
        dist.destroy_process_group()
    except BaseException:          # the parent reports it
        result = {"error": traceback.format_exc()}
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def start_worlds(specs, tmp_path, preload=()):
    """Start every world of ``specs`` — [(world size, worker name,
    kwargs), ...] — at once, each rank in its own process running
    ``worker(rank, world, **kwargs)`` (a name of this module's, or
    "module:name"; ``preload`` adds modules the fork server imports);
    ``join_worlds`` collects them."""
    ctx = mp.get_context("forkserver")
    # the server imports these once; each rank forks from it, warm
    ctx.set_forkserver_preload(["torch", "torch._dynamo", "torch_mesh_worker",
                                "repro_torch.launch.steps",
                                "repro_torch.launch.train", *preload])
    runs = []
    for w, (world, fn_name, kw) in enumerate(specs):
        tag = os.path.join(str(tmp_path),
                           f"w{w}_{fn_name.split(':')[-1]}")
        outs = [f"{tag}.r{r}.pkl" for r in range(world)]
        procs = [ctx.Process(target=_entry, args=(r, world, f"{tag}.init",
                                                  fn_name, kw, outs[r]))
                 for r in range(world)]
        runs.append((fn_name, procs, outs))
    for _, procs, _ in runs:
        for p in procs:
            p.start()
    return runs, time.monotonic()


def join_worlds(started, timeout_s: float = TIMEOUT_S):
    """Each started world's results by rank.  Every process is joined by
    one deadline (``timeout_s`` after the start), then killed."""
    runs, t0 = started
    deadline = t0 + timeout_s
    try:
        for _, procs, _ in runs:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        late = [name for name, procs, _ in runs
                if any(p.is_alive() for p in procs)]
        if late:
            raise TimeoutError(f"worlds {late} still running after "
                               f"{timeout_s} s")
    finally:
        for _, procs, _ in runs:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
    results = []
    for name, procs, outs in runs:
        got = []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                raise RuntimeError(f"{name}: rank {r} exited "
                                   f"{procs[r].exitcode} without a result")
            with open(path, "rb") as f:
                res = pickle.load(f)
            if "error" in res:
                raise RuntimeError(f"{name} rank {r}:\n{res['error']}")
            got.append(res["ok"])
        results.append(got)
    return results


# ------------------------------------------------------------ recording
class Recorder:
    """Records the integer outputs of a run: each call's [t, need]
    thresholds (kernel 2's op, (B * Hq, nq, 2)) and dispatch plan index
    ((B, G, C)), in call order."""

    def __init__(self):
        from repro_torch.core import dispatch
        from repro_torch.kernels.sparse_attention import ops as sa_ops
        self.calls = []
        self._mods = [(sa_ops, "topl_thresholds"), (dispatch, "make_plan")]
        self._orig = [getattr(m, n) for m, n in self._mods]

    def __enter__(self):
        for (mod, name), orig in zip(self._mods, self._orig):
            setattr(mod, name, self._wrap(name, orig))
        return self

    def _wrap(self, name, orig):
        @functools.wraps(orig)
        def rec(*a, **k):
            out = orig(*a, **k)
            val = out if name == "topl_thresholds" else out.index
            self.calls.append((name, val.detach().cpu().numpy().copy()))
            return out
        return rec

    def __exit__(self, *exc):
        for (mod, name), orig in zip(self._mods, self._orig):
            setattr(mod, name, orig)


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch_bf16() else t).numpy().copy()


def torch_bf16():
    import torch
    return torch.bfloat16


def _tree_np(tree):
    from repro_torch.core.params import leaves
    return {".".join(p): _np(v) for p, v in leaves(tree)}


def _mesh(shape):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import rules_for_mesh
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    return mesh, rules_for_mesh(mesh)


# -------------------------------------------------------------- workers
def train_case(rank, world, mesh_shape, cfg, state, batch, chunk, ocfg,
               logits=True):
    """One train step's pieces on this rank's rows and stored parts under
    the mesh (the whole ``state`` cut to them by ``local_state``): the
    loss, metrics and gradients of ``loss_and_grads``, their global norm,
    the integer outputs it made, the logits of the rows (sequence and
    vocabulary gathered), the trainable leaves and moments after one
    ``build_train_step`` (AdamW), the shapes of the stored leaves, the
    parts ``init_state(..., mesh=)`` draws, and this rank's mesh
    coordinates."""
    import torch
    from repro_torch.core import collectives as C
    from repro_torch.core import params as P
    from repro_torch.data.pipeline import rank_rows
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import OptimizerConfig, global_norm
    from repro_torch.sharding import axis_rules, mesh_coords
    from repro_torch.train import state as S
    mesh, rules = _mesh(mesh_shape)
    st = S.local_state(P.from_numpy_state(state, "cpu"), cfg, mesh)
    out = {"coords": mesh_coords(mesh),
           "stored": {part: {k: tuple(v.shape) for k, v in
                             _tree_np(st[part]).items()}
                      for part in ("train", "frozen")},
           "init": {part: _tree_np(tree) for part, tree in S.init_state(
               cfg, seed=0, device="cpu", mesh=mesh).items()
               if part in ("train", "frozen")}}
    with axis_rules(rules):
        dp = C.batch_axis()
        b = rank_rows(batch, dp.rank, dp.size) if dp else batch
        b = {k: torch.as_tensor(v) for k, v in b.items()}
        with Recorder() as rec:
            loss, metrics, grads = steps.loss_and_grads(st, cfg, b, chunk)
        specs = S.storage_specs(cfg, rules)
        out.update(loss=float(loss), grads=_tree_np(grads), ints=rec.calls,
                   norm=float(global_norm(grads, specs["train"])),
                   metrics={k: float(v) for k, v in metrics.items()},
                   dp=(dp.rank, dp.size) if dp else (0, 1))
        tp = C.model_axis()
        out["tp"] = (tp.rank, tp.size) if tp else (0, 1)
        if logits:
            with torch.no_grad():
                params = S.full_params(st)
                hidden, _ = S.model_hidden(params, cfg, b)
                hidden = C.gather_seq(hidden, transformer.seq_parallel(cfg,
                                                                       b))
                lg = transformer.logits_of(params, cfg, hidden)
                if lg.shape[-1] != cfg.padded_vocab:
                    lg = C.gather(lg, lg.dim() - 1, tp)
                out["logits"] = _np(lg)
        new, m = steps.build_train_step(cfg, OptimizerConfig(**ocfg),
                                        loss_chunk=chunk)(st, b)
        out["after"] = _tree_np(new["train"])
        out["after_m"] = _tree_np(new["opt"]["m"])
        out["grad_norm"] = float(m["grad_norm"])
    return out


def ckpt_case(rank, world, mesh_shape, cfg, state, save_dir, restore_dir):
    """This rank's parts of ``state`` saved whole under ``save_dir``
    (step 7), and its parts of the checkpoint in ``restore_dir``."""
    from repro_torch.core import params as P
    from repro_torch.train import checkpoint
    from repro_torch.train import state as S
    mesh, rules = _mesh(mesh_shape)
    specs = S.storage_specs(cfg, rules)
    st = S.local_state(P.from_numpy_state(state, "cpu"), cfg, mesh)
    stacked = S.stacked_leaves(cfg)
    checkpoint.save(st, 7, save_dir, specs=specs, mesh=mesh, stacked=stacked)
    got = checkpoint.restore(restore_dir, device="cpu", specs=specs,
                             mesh=mesh, stacked=stacked)
    return {part: _tree_np(got[part]) for part in ("train", "frozen")} | {
        "opt": {k: _tree_np(v) for k, v in got["opt"].items()},
        "step": int(got["step"])}


def shmap_case(rank, world, mesh_shape, rcfg, lcfg, params, x, lb_weight):
    """core/ffn_shmap.routed_ffn_shmap on this rank's rows and sequence
    chunk of x and its stored parts of the params (the rules'
    placements): y's chunk, lb_loss, dropped, and the gradients of this
    rank's parts of sum(y^2) + lb_weight * lb_loss summed over the data
    ranks."""
    import torch
    from repro_torch.core import collectives as C
    from repro_torch.core import ffn_shmap
    from repro_torch.core import params as P
    from repro_torch.sharding import axis_rules
    from repro_torch.core import routed_ffn as rf
    from repro_torch.sharding import local_slice, mesh_coords, mesh_sizes
    mesh, rules = _mesh(mesh_shape)
    specs = dict(P.leaves(P.spec_tree(rf.param_defs(rcfg, lcfg), rules)))
    coords = mesh_coords(mesh)
    p = P.unflatten(*zip(*[
        (k, local_slice(v, specs[k], mesh_sizes(mesh), coords))
        for k, v in P.leaves(P.from_numpy_tree(params, "cpu"))]))
    pairs = [(k, v) for k, v in P.leaves(p)
             if "router" in k or any("lora" in s for s in k)]
    vals = [v.requires_grad_(True) for _, v in pairs]
    with axis_rules(rules):
        dp, tp = C.batch_axis(), C.model_axis()
        xl = torch.as_tensor(x)
        if dp:
            xl = xl.chunk(dp.size, 0)[dp.rank]
        if tp:
            xl = xl.chunk(tp.size, 1)[tp.rank]
        y, aux = ffn_shmap.routed_ffn_shmap(xl.contiguous(), p, rcfg, lcfg,
                                            mesh)
        loss = (y.float() ** 2).sum() + lb_weight * aux["lb_loss"]
        grads = torch.autograd.grad(loss, vals, allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else C.all_reduce_(g, dp)
                 for v, g in zip(vals, grads)]
    return {"y": _np(y), "lb": float(aux["lb_loss"]),
            "dropped": float(aux["dropped"]),
            "grads": {".".join(k): _np(g) for (k, _), g in zip(pairs, grads)},
            "coords": coords,
            "dp": (dp.rank, dp.size) if dp else (0, 1),
            "tp": (tp.rank, tp.size) if tp else (0, 1)}


def flat_axis_case(rank, world, mesh_shape):
    """The product of every mesh axis as one Axis (the group that
    ``mesh_axis`` builds for ("pod", "data")-like products): this rank's
    index along it, its size and an all-reduce of the ranks over it."""
    import torch
    from repro_torch.core import collectives as C
    mesh, _ = _mesh(mesh_shape)
    ax = C.mesh_axis(mesh, ("data", "model"))
    total = C.all_reduce_(torch.tensor([float(rank)]), ax)
    return {"rank": ax.rank, "size": ax.size, "sum": float(total)}


def launcher_case(rank, world, argv):
    """launch/train.py's main in this world; rank 0's JSON blob."""
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    return {"rc": rc, "out": buf.getvalue()}


def world_cases(rank, world, cases):
    """Several cases in one world, in order: [(fn name, kwargs), ...]."""
    return [globals()[name](rank, world, **kw) for name, kw in cases]


def rows_heads(x: np.ndarray, b: int, rows, heads):
    """(B * H, ...) -> the (rows, heads) block, flattened the same way."""
    h = x.shape[0] // b
    y = x.reshape(b, h, *x.shape[1:])[rows][:, heads]
    return y.reshape(-1, *x.shape[1:])
