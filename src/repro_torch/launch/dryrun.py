"""Dry run (the JAX package's ``launch/dryrun.py``): for every (arch x
input-shape) cell and the production mesh — (data 16, model 16) single
pod, (pod 2, data 16, model 16) multi-pod — trace the port's own train,
prefill or decode step once, at rank 0's shapes, on the meta device,
inside a fake process group of the mesh's size (``launch/mesh.make_dry_mesh``),
and report that rank's memory and the roofline terms
(``launch/roofline.py``), counted from the ops the port runs and the
kernels it calls (``kernels/cost.py``) against the H100's datasheet
constants.  Nothing is allocated on any device, so it runs on a machine
without a card; what it predicts is the card's path (``target``).

The storage it reports is the port's own: a rank's parts of the train
state (train/state.storage_specs), and a serving rank its part of the
model (``transformer.ShardedLM``) and the caches of its slots.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun

``apply_variant`` (the paper's baselines as configs) lives here too, as
in the JAX package; the launchers share it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch import configs, kernels
from repro_torch.configs.base import SHAPES_BY_NAME, ModelConfig, ShapeSpec
from repro_torch.configs.shapes import abstract_inputs, input_specs
from repro_torch.core import collectives as C
from repro_torch.core import params as P
from repro_torch.core.lora import LoRAConfig
from repro_torch.launch import roofline, steps
from repro_torch.launch.mesh import make_dry_production_mesh, mesh_num_devices
from repro_torch.models import encdec, transformer
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.serving import engine
from repro_torch.sharding import axis_rules, rules_for_mesh
from repro_torch.train import state as S

VARIANTS = ("spt", "lora", "full")


def apply_variant(cfg: ModelConfig, variant: str) -> ModelConfig:
    """spt: the config as given (sparse MHA, routed FFN, LoRA); lora:
    dense attention and FFN with LoRA; full: dense, LoRA off (the base
    weights are frozen leaves, so nothing is trainable — as in JAX)."""
    if variant == "spt":
        return cfg
    if variant == "lora":
        return cfg.with_spt(sparse_mha=False, routed_ffn=False)
    if variant == "full":
        return cfg.with_spt(sparse_mha=False, routed_ffn=False,
                            lora=LoRAConfig(enabled=False))
    raise ValueError(variant)


# ------------------------------------------------------------- counting
def count(step: Callable, args: Sequence, target: str = "cuda",
          counter: Optional[roofline.Counter] = None) -> roofline.Counter:
    """Run ``step(*args)`` once under a roofline counter (a new one, or
    ``counter``): ``args`` held as the arguments, the results counted as
    the outputs.  Meta tensors stand for ``target``'s path
    (``kernels.meta_target``)."""
    counter = (roofline.Counter() if counter is None else counter).hold(*args)
    with kernels.meta_target(target), counter:
        out = step(*args)
    return counter.outputs(out)


def abstract_model(cfg: ModelConfig, mesh=None):
    """The model on the meta device: an ``LM`` (``EncDecLM`` for the
    audio family), and under ``mesh`` where it splits this rank's part of
    it (``ShardedLM`` / ``ShardedEncDec`` of the local meta tree, as
    ``engine.init_model`` builds it)."""
    audio = cfg.family == "audio"
    axes = engine.serving_axes(cfg, mesh)
    if axes is None:
        return (encdec.EncDecLM if audio else transformer.LM)(
            cfg, P.abstract_tree(S.model_defs(cfg)), device="meta")
    shard = transformer.serve_shard(cfg, *axes)
    params = P.abstract_tree(S.model_defs(cfg), S.model_storage_specs(
        cfg, shard.sizes), shard.sizes)
    return (encdec.ShardedEncDec if audio else
            transformer.ShardedLM).from_local(params, cfg, *axes)


def cell_step(cfg: ModelConfig, shape: ShapeSpec, model=None,
              loss_chunk: int = 512) -> Callable:
    """The step function of a cell: the train step (``state, batch``), the
    prefill (``model, batch``) or the decode step (``model, caches,
    token, pos``), the last two at ``model``'s config."""
    if shape.kind == "train":
        return steps.build_train_step(cfg, OptimizerConfig(),
                                      loss_chunk=loss_chunk)
    mcfg = getattr(model, "cfg", cfg)
    if shape.kind == "prefill":
        return steps.build_prefill_step(mcfg, max_len=shape.seq_len)
    if shape.kind == "decode":
        return steps.build_decode_step(mcfg)
    raise ValueError(shape.kind)


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               loss_chunk: int = 512, target: str = "cuda",
               counter: Optional[roofline.Counter] = None
               ) -> roofline.Counter:
    """Trace one step of the cell on the meta device at rank 0's shapes
    (JAX: ``lower_cell``).  The train step takes the abstract state rank
    0 stores (``train/state.abstract_state(cfg, rules)``) and its rows of
    the batch; prefill and decode the model rank 0 stores
    (``abstract_model``), the decode caches of its slots
    (``steps.cache_local_shapes``) and its tokens.  mesh: a
    ``make_dry_mesh`` (or None: one device).  counter: the counter to run
    under (default a new ``roofline.Counter``).  Returns the counter
    (``roofline.analyze``, ``Counter.memory``)."""
    rules = rules_for_mesh(mesh) if mesh is not None else None
    with axis_rules(rules):
        dp = C.mesh_axis(mesh, C.BATCH_AXES)
        data = dp.size if dp is not None else 1
        specs = input_specs(cfg, shape)
        if shape.kind == "train":
            args = (S.abstract_state(cfg, rules), abstract_inputs(specs,
                                                                  data))
            step = cell_step(cfg, shape, loss_chunk=loss_chunk)
        else:
            model = abstract_model(cfg, mesh)
            step = cell_step(cfg, shape, model)
            if shape.kind == "prefill":
                args = (model, abstract_inputs(specs, data))
            else:
                ins = abstract_inputs(specs, data, replicate=True)
                caches = engine.abstract_decode_caches(
                    model.cfg, ins["token"].shape[0], shape.seq_len,
                    shard=getattr(model, "shard", None))
                args = (model, caches, ins["token"], ins["pos"])
        return count(step, args, target, counter)


def _unit_config(cfg: ModelConfig, units: int) -> ModelConfig:
    """A copy of cfg with exactly `units` pattern units (no tail)."""
    kw = {"num_layers": units * len(cfg.pattern)}
    if cfg.family == "audio":
        kw["encoder_layers"] = units
    return dataclasses.replace(cfg, **kw)


def _analysis_cfg(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """The query chunk of the analysis traces (JAX: bigger chunks, fewer
    unrolled loop iterations; ssm_chunk is left alone: SSD FLOPs scale
    with the chunk size)."""
    return cfg.with_spt(chunk_q=min(2048, shape.seq_len))


def exact_roofline(cfg: ModelConfig, shape: ShapeSpec, mesh,
                   verbose: bool = False,
                   target: str = "cuda") -> Dict[str, Any]:
    """JAX's loop-aware accounting: trace 1-unit and 2-unit copies of the
    model and extrapolate linearly, F(U units) = F1 + (U - 1) (F2 - F1),
    tail layers (num_layers % pattern) counted fractionally.  (The port
    counts every loop iteration, so for a config without tail layers the
    extrapolation equals a trace at full depth.)"""
    acfg = _analysis_cfg(cfg, shape)
    units_equiv = cfg.num_layers / len(cfg.pattern)
    rl = {u: roofline.analyze(trace_cell(_unit_config(acfg, u), shape, mesh,
                                         loss_chunk=2048, target=target))
          for u in (1, 2)}
    per_unit = {
        "flops": rl[2].flops - rl[1].flops,
        "hbm_bytes": rl[2].hbm_bytes - rl[1].hbm_bytes,
        "coll_bytes": rl[2].coll_bytes - rl[1].coll_bytes,
    }
    total = roofline.Roofline(
        flops=rl[1].flops + per_unit["flops"] * (units_equiv - 1),
        hbm_bytes=rl[1].hbm_bytes + per_unit["hbm_bytes"] * (units_equiv - 1),
        coll_bytes=max(0.0, rl[1].coll_bytes
                       + per_unit["coll_bytes"] * (units_equiv - 1)),
        coll_by_kind={k: int(v + (rl[2].coll_by_kind.get(k, 0) - v)
                             * (units_equiv - 1))
                      for k, v in rl[1].coll_by_kind.items()})
    if verbose:
        print(f"  per unit: {per_unit}")
    return {"per_unit": per_unit, "one_unit": rl[1].to_dict(),
            "roofline_exact": total.to_dict()}


def parse_overrides(pairs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for pair in pairs or []:
        k, _, v = pair.partition("=")
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
            continue
        for cast in (int, float):
            try:
                out[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            out[k] = v
    return out


def _model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    if shape.kind == "train":
        return roofline.model_flops(cfg, shape.global_batch * shape.seq_len)
    if shape.kind == "prefill":              # forward only: 2 N D
        return roofline.model_flops(
            cfg, shape.global_batch * shape.seq_len) / 3.0
    return 2.0 * roofline.active_params(cfg) * shape.global_batch


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "spt", verbose: bool = True,
             cfg_override: Optional[ModelConfig] = None,
             spt_overrides: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    """One cell's record with JAX's keys: memory under
    ``memory_analysis`` (the arguments, outputs, temporaries — the peak
    of live bytes beyond the arguments — and aliases, plus
    ``peak_bytes``), ``roofline_scanned`` (the full-depth trace's count;
    the port counts every loop iteration, so it equals the exact count),
    the model FLOPs, and on the single pod ``exact_roofline``'s keys and
    ``useful_flops_ratio``.  ``trace_s`` stands for JAX's ``lower_s`` and
    ``compile_s``."""
    shape = SHAPES_BY_NAME[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, why = configs.cell_supported(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    cfg = cfg_override or apply_variant(configs.get_config(arch), variant)
    if spt_overrides:
        cfg = cfg.with_spt(**spt_overrides)
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "variant": variant, "mesh": mesh_name}
    t0 = time.time()
    try:
        with make_dry_production_mesh(multi_pod=multi_pod) as mesh:
            chips = mesh_num_devices(mesh)
            result["chips"] = chips
            counter = trace_cell(cfg, shape, mesh)
            rl = roofline.analyze(counter)
            mem = counter.memory()
            mf = _model_flops(cfg, shape)
            result.update({
                "status": "ok",
                "trace_s": round(time.time() - t0, 2),
                "roofline_scanned": rl.to_dict(),
                "kernels": counter.kernel_calls(),
                "hbm_bytes_by_op": counter.top_bytes(),
                "model_flops_total": mf,
                "model_flops_per_chip": mf / chips,
                "memory_analysis": mem,
            })
            if verbose:
                print(f"  memory_analysis: {mem}")
                print(f"  roofline: flops/dev={rl.flops:.3e} "
                      f"bytes/dev={rl.hbm_bytes:.3e} "
                      f"coll/dev={rl.coll_bytes:.3e} -> {rl.bottleneck}")
            if not multi_pod:   # the roofline table is single-pod only
                try:
                    result.update(exact_roofline(cfg, shape, mesh))
                    ex = result["roofline_exact"]
                    result["useful_flops_ratio"] = (
                        (mf / chips) / ex["flops"] if ex["flops"] else None)
                    if verbose:
                        print(f"  roofline(exact): compute="
                              f"{ex['t_compute'] * 1e3:.2f}ms memory="
                              f"{ex['t_memory'] * 1e3:.2f}ms collective="
                              f"{ex['t_collective'] * 1e3:.2f}ms -> "
                              f"{ex['bottleneck']}-bound useful="
                              f"{result['useful_flops_ratio']}")
                except Exception as e:
                    result["roofline_exact_error"] = repr(e)
            result["total_s"] = round(time.time() - t0, 2)
    except Exception as e:
        result.update({"status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()})
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES_BY_NAME) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="spt", choices=list(VARIANTS))
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) cell")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="SPTConfig override, e.g. --set attn_impl=pallas")
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    args = ap.parse_args()
    overrides = parse_overrides(args.overrides)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = list(configs.ARCH_NAMES) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES_BY_NAME) if (args.all or not args.shape) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
                if args.variant != "spt":
                    tag += f"_{args.variant}"
                if args.tag:
                    tag += f"_{args.tag}"
                print(f"[dryrun] {tag}", flush=True)
                res = run_cell(arch, shape, mp, args.variant,
                               spt_overrides=overrides)
                if overrides:
                    res["spt_overrides"] = overrides
                (outdir / f"{tag}.json").write_text(json.dumps(res, indent=1))
                print(f"  -> {res['status']}" +
                      (f" ({res.get('reason', res.get('error', ''))})"
                       if res["status"] != "ok" else ""), flush=True)
                failures += res["status"] == "error"
    return 1 if failures else 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(main())
