"""The dry run (launch/dryrun.py) and its counter (launch/roofline.py,
kernels/cost.py, core/collectives.py) on the CPU:

  * against JAX: the port's argument bytes equal JAX's
    ``memory_analysis()`` at mesh (1, 1) for the qwen3 smoke train,
    prefill and decode cells (JAX's ``lower_cell`` in one subprocess with
    4 host devices, its meshes built with Auto axes: on jax 0.9.0 the
    package's own ``make_mesh`` gives Explicit axes, which its
    ``shard()`` refuses), and the output bytes JAX's for the decode
    caches and logits and for the train state; at (2, 2), each rank
    storing its parts, JAX's too, for the qwen3 and mixtral smoke train
    and decode cells, and the bytes the port's own constructors give one
    rank, and at (1, 4), where the kv heads do not split and the caches'
    sequence does, the same;
  * the trace follows the real path: meta traces with target "cpu"
    equal real CPU runs under the counter exactly in FLOPs, HBM bytes,
    kernel calls and peak bytes (three configs x train, prefill,
    decode), and the kernel calls equal the launches the model's layers
    make;
  * ``exact_roofline``'s extrapolation equals a trace at full depth;
  * each kernel's cost function equals a count written out here, and
    kernels 4 and 5 count the top-L budget their thresholds were made
    with; neither the kernels nor core import the launch package;
  * every collective goes through core/collectives.py, and a (1, 2)
    train step's collective bytes by kind equal the count from the
    rules;
  * ``run_cell`` gives JAX's keys under the single-pod dry mesh and
    leaves no process group running;
  * the device-agnostic one-hot equals torch's, the step counter lives
    on the host.
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.shapes import (abstract_inputs, input_specs,
                                        materialize)
from repro_torch.core import dispatch
from repro_torch.core.params import ParamDef, leaves
from repro_torch.kernels import cost
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.launch.mesh import make_dry_mesh
from repro_torch.models import attention, ffn, transformer
from repro_torch.serving import engine
from repro_torch.sharding import local_shape, rules_for_mesh
from repro_torch.train import state as S
from test_torch_model import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SMOKE = configs.get_smoke("qwen3-0.6b")
KERNELS = SMOKE.with_spt(attn_impl="pallas", ffn_impl="pallas")
TRAIN = ShapeSpec("t", "train", 64, 4)
PREFILL = ShapeSpec("p", "prefill", 64, 4)
DECODE = ShapeSpec("d", "decode", 128, 4)
JAX_DEADLINE_S = 240

# JAX's lower_cell on the same cells: meshes with Auto axes (see the
# module docstring), memory_analysis() and the leaf bytes of the outputs
JAX_SCRIPT = r'''
import json, math, os
import jax
from jax.sharding import AxisType
from repro import configs
from repro.configs.base import ShapeSpec
from repro.launch import dryrun
Q, M = "qwen3-0.6b", "mixtral-8x22b"
cells = [(Q, "train", (1, 1), ShapeSpec("t", "train", 64, 4)),
         (Q, "prefill", (1, 1), ShapeSpec("p", "prefill", 64, 4)),
         (Q, "decode", (1, 1), ShapeSpec("d", "decode", 128, 4)),
         (Q, "train", (2, 2), ShapeSpec("t", "train", 64, 4)),
         (Q, "decode", (2, 2), ShapeSpec("d", "decode", 128, 4)),
         (M, "train", (2, 2), ShapeSpec("t", "train", 64, 4)),
         (M, "decode", (2, 2), ShapeSpec("d", "decode", 128, 4)),
         (Q, "train", (1, 4), ShapeSpec("t", "train", 64, 4)),
         (Q, "decode", (1, 4), ShapeSpec("d", "decode", 128, 4)),
         (M, "train", (1, 4), ShapeSpec("t", "train", 64, 4)),
         (M, "decode", (1, 4), ShapeSpec("d", "decode", 128, 4))]
nbytes = lambda t: sum(math.prod(l.shape) * l.dtype.itemsize
                       for l in jax.tree_util.tree_leaves(t))
out = []
for arch, kind, shape, spec in cells:
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    lowered = dryrun.lower_cell(configs.get_smoke(arch), spec, mesh)
    ma = lowered.compile().memory_analysis()
    info = lowered.out_info
    out.append({"arch": arch, "kind": kind, "mesh": list(shape),
                "argument": int(ma.argument_size_in_bytes),
                "output": int(ma.output_size_in_bytes),
                "out_leaf_bytes": nbytes(info[0] if kind == "train"
                                         else info)})
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def jax_cells():
    """JAX's numbers, from a subprocess started at the module's first
    test (it runs while the port's tests do) and waited for, with a
    deadline, by the test that reads them."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    box = {}

    def result():
        if "cells" not in box:
            try:
                out, err = proc.communicate(timeout=JAX_DEADLINE_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise AssertionError("JAX's lower_cell passed its deadline")
            assert proc.returncode == 0, err[-3000:]
            rows = json.loads(out.strip().splitlines()[-1])
            box["cells"] = {(r["kind"], tuple(r["mesh"])): r for r in rows
                            if r["arch"] == "qwen3-0.6b"}
            box["cells"].update({(r["arch"], r["kind"], tuple(r["mesh"])): r
                                 for r in rows})
        return box["cells"]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_jax_reference_starts(jax_cells):
    """Start JAX's subprocess first; the comparisons come last."""
    assert callable(jax_cells)


# ------------------------------------------------------------ kernel costs
def M(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


I32, I8, F32, BOOL = torch.int32, torch.int8, torch.float32, torch.bool


def _lora(d, g, f, r, gated=True):
    out = {"lora_inner": {"b": M(d, r, dtype=F32), "c": M(g, r, f, dtype=F32)},
           "lora_outer": {"b": M(g, f, r, dtype=F32), "c": M(r, d, dtype=F32)}}
    if gated:
        out["lora_gate"] = {"b": M(d, r, dtype=F32),
                            "c": M(g, r, f, dtype=F32)}
    return out


# (kernel, arguments, keywords, {type: ops}, bytes, scratch), each count
# written out by hand; the decode cases cut S = 300 (or a 3 x 128 paged
# view) into 3 splits of 128 for G = 16 kv groups
COST_CASES = [
    ("pq_assign", lambda: (M(4, 100, 64), M(8, 16, 8, dtype=F32)), {},
     # 400 rows x 8 books x 16 codewords x (2 d' + 2)
     {"bf16": 400 * 8 * 16 * 18}, 400 * 64 * 2 + 8 * 16 * 8 * 4 + 400 * 8 * 4,
     0),
    ("pq_assign", lambda: (M(2, 3, 50, 80, dtype=F32),
                           M(10, 16, 8, dtype=F32)), {},
     {"f32": 300 * 10 * 16 * 18}, 300 * 80 * 4 + 10 * 16 * 8 * 4
     + 300 * 10 * 4, 0),
    ("topl_thresholds",
     lambda: (M(8, 10, 4, dtype=I32), M(4, 10, 4, dtype=I32)),
     dict(l=4, max_score=4, heads_per_batch=4, rep=2),
     # causal: row i admits i + 1 keys, 55 a group
     {"int": 8 * 55 * 4}, 8 * 10 * 4 * 4 + 4 * 10 * 4 * 4 + 8 * 10 * 2 * 4, 0),
    ("topl_thresholds",
     lambda: (M(2, 4, 3, dtype=I32), M(2, 10, 3, dtype=I32)),
     dict(l=2, max_score=3, window=3, q_offset=5),
     # positions 5-8, window 3: 3 keys a row
     {"int": 2 * 4 * 3 * 3},
     2 * 4 * 3 * 4 + 2 * 10 * 3 * 4 + 2 * 4 * 2 * 4, 0),
    ("decode_topl_thresholds",
     lambda: (M(16, 2, 8, dtype=I32), M(16, 300, 8, dtype=I8),
              M(2, 300, dtype=BOOL)),
     dict(l=40, max_score=8, sum_rows=False, heads_per_batch=8),
     # every one of the 16 x 300 slots live: R x M compares, M code bytes
     {"int": 4800 * 2 * 8}, 16 * 2 * 8 * 4 + 600 + 16 * 2 * 2 * 4 + 4800 * 8,
     16 * 3 * 2 * 9 * 4),
    ("decode_topl_thresholds",
     lambda: (M(16, 2, 8, dtype=I32), M(16, 300, 8, dtype=I8),
              M(2, 300, dtype=BOOL)),
     dict(l=40, max_score=16, sum_rows=True, heads_per_batch=8, live=1000),
     {"int": 1000 * 2 * 8}, 16 * 2 * 8 * 4 + 600 + 16 * 1 * 2 * 4 + 1000 * 8,
     16 * 3 * 1 * 17 * 4),
    ("sparse_attention",
     lambda: (M(4, 8, 16), M(2, 8, 16), M(2, 8, 16), M(4, 8, 4, dtype=I32),
              M(2, 8, 4, dtype=I32), M(4, 8, 2, dtype=I32)),
     dict(scale=0.25, heads_per_batch=4, rep=2, l=3),
     # min(3, i + 1) keys for rows 0-7: 21 a query group
     {"bf16": 4 * 16 * 4 * 21}, 1024 + 512 + 256 + 256 + 1024
     + 2 * (2 * 8) * 16 * 2, 0),
    ("sparse_attention",
     lambda: (M(4, 8, 16, dtype=F32), M(2, 8, 16, dtype=F32),
              M(2, 8, 16, dtype=F32), M(4, 8, 4, dtype=I32),
              M(2, 8, 4, dtype=I32), M(4, 8, 2, dtype=I32)),
     dict(scale=0.25, heads_per_batch=4, rep=2, pairs=50, rows_read=10),
     {"f32": 4 * 16 * 50}, 2048 + 512 + 256 + 256 + 2048 + 2 * 10 * 16 * 4, 0),
    ("sparse_decode_attention",
     lambda: (M(16, 2, 32), M(16, 300, 32), M(16, 300, 32),
              M(16, 2, 8, dtype=I32), M(16, 300, 8, dtype=I8),
              M(16, 2, 2, dtype=I32), M(2, 300, dtype=BOOL)),
     dict(scale=0.2, sum_rows=False, heads_per_batch=8, l=40),
     # 16 x 2 rows select 40 slots each; at most 80 K/V rows a group
     {"bf16": 4 * 32 * 1280}, 2048 + 1024 + 256 + 600 + 4800 * 8 + 2048
     + 2 * 1280 * 32 * 2, 16 * 3 * 2 * 4 + 16 * 3 * 2 * 34 * 4),
    ("sparse_decode_attention",
     lambda: (M(16, 2, 32, dtype=F32), M(16, 300, 32, dtype=F32),
              M(16, 300, 32, dtype=F32), M(16, 2, 8, dtype=I32),
              M(16, 300, 8, dtype=I8), M(16, 1, 2, dtype=I32),
              M(2, 300, dtype=BOOL)),
     dict(scale=0.2, sum_rows=True, heads_per_batch=8, live=600, pairs=100,
          rows_read=90),
     # the shared selection: each of its 100 pairs serves R = 2 rows
     {"f32": 4 * 32 * 100 * 2}, 4096 + 1024 + 128 + 600 + 600 * 8 + 4096
     + 2 * 90 * 32 * 4, 16 * 3 * 1 * 4 + 16 * 3 * 2 * 34 * 4),
    ("fused_sparse_decode_attention",
     lambda: (M(16, 2, 32), M(16, 300, 32), M(16, 300, 32),
              M(16, 2, 8, dtype=I32), M(16, 300, 8, dtype=I8),
              M(2, 300, dtype=BOOL)),
     dict(scale=0.2, l=40, max_score=8, sum_rows=False, heads_per_batch=8),
     {"bf16": 4 * 32 * 1280}, 2048 + 1024 + 600 + 4800 * 8 + 2048
     + 2 * 1280 * 32 * 2, 16 * 3 * 2 * 9 * 4 + 16 * 3 * 2 * 34 * 4),
    ("fused_sparse_decode_attention",
     lambda: (M(16, 2, 32), M(16, 300, 32), M(16, 300, 32),
              M(16, 2, 8, dtype=I32), M(16, 300, 8, dtype=I8),
              M(2, 300, dtype=BOOL)),
     dict(scale=0.2, l=40, max_score=16, sum_rows=True, heads_per_batch=8,
          return_thresholds=True),
     # one shared row of 40 slots a group, R = 2 rows attend; [t, need] out
     {"bf16": 4 * 32 * 640 * 2}, 2048 + 1024 + 600 + 4800 * 8 + 2048
     + 2 * 640 * 32 * 2 + 16 * 2 * 4, 16 * 3 * 17 * 4 + 16 * 3 * 2 * 34 * 4),
    ("fused_sparse_decode_attention_paged",
     lambda: (M(2, 3, dtype=I32), M(16, 2, 32), M(10, 8, 128, 32),
              M(10, 8, 128, 32), M(16, 2, 8, dtype=I32),
              M(10, 8, 128, 8, dtype=I8), M(2, 384, dtype=BOOL)),
     dict(scale=0.2, l=48, max_score=8, sum_rows=False, heads_per_batch=8),
     {"bf16": 4 * 32 * 1536}, 2048 + 1024 + 24 + 768 + 2048 + 6144 * 8
     + 2 * 1536 * 32 * 2, 24 + 16 * 3 * 2 * 9 * 4 + 16 * 3 * 2 * 34 * 4),
    ("fused_sparse_decode_attention_paged",
     lambda: (M(2, 3, dtype=I32), M(16, 2, 32, dtype=F32),
              M(10, 8, 128, 32, dtype=F32), M(10, 8, 128, 32, dtype=F32),
              M(16, 2, 8, dtype=I32), M(10, 8, 128, 8, dtype=I8),
              M(2, 384, dtype=BOOL)),
     dict(scale=0.2, l=48, max_score=8, sum_rows=False, heads_per_batch=8,
          return_thresholds=True, live=1000, pairs=500, rows_read=300),
     {"f32": 4 * 32 * 500}, 4096 + 1024 + 24 + 768 + 4096 + 1000 * 8
     + 2 * 300 * 32 * 4 + 256, 24 + 16 * 3 * 2 * 9 * 4 + 16 * 3 * 2 * 34 * 4),
    ("dense_decode_attention_paged",
     lambda: (M(2, 3, dtype=I32), M(16, 2, 32), M(10, 8, 128, 32),
              M(10, 8, 128, 32), M(2, 384, dtype=BOOL)),
     dict(scale=0.2, heads_per_batch=8),
     {"bf16": 4 * 32 * 2 * 6144}, 2048 + 24 + 768 + 2048 + 2 * 6144 * 32 * 2,
     24 + 16 * 3 * 2 * 34 * 4),
    ("dense_decode_attention_paged",
     lambda: (M(2, 3, dtype=I32), M(16, 2, 32, dtype=F32),
              M(10, 8, 128, 32, dtype=F32), M(10, 8, 128, 32, dtype=F32),
              M(2, 384, dtype=BOOL)),
     dict(scale=0.2, heads_per_batch=8, live=700),
     {"f32": 4 * 32 * 2 * 700}, 4096 + 24 + 768 + 4096 + 2 * 700 * 32 * 4,
     24 + 16 * 3 * 2 * 34 * 4),
    ("grouped_ffn",
     lambda: (M(2, 16, 64), M(2, 4, 8, dtype=I32), M(4, 64, 32), M(4, 32, 64),
              M(4, 64, 32), _lora(64, 4, 32, 8), 1.0),
     dict(act="silu"),
     # 64 slots x (3 products + LoRA 2 r (3 d + 2 F + d)); the bf16 kernel
     # takes the LoRA leaves as bf16 copies
     {"bf16": 64 * (2 * 64 * 32 * 3 + 2 * 8 * (3 * 64 + 2 * 32 + 64))},
     2 * 16 * 64 * 2 + 256 + 3 * 4 * 64 * 32 * 2 + 4608 * 4
     + 2 * 4 * 8 * 64 * 2,
     4608 * 2),
    ("grouped_ffn",
     lambda: (M(1, 10, 48, dtype=F32), M(1, 2, 16, dtype=I32),
              M(2, 48, 24, dtype=F32), M(2, 24, 48, dtype=F32)),
     dict(act="relu", kept=20),
     {"f32": 20 * 2 * 48 * 24 * 2}, 1920 + 128 + 2 * 2 * 48 * 24 * 4
     + 1 * 2 * 16 * 48 * 4, 0),
    ("decode_ffn",
     lambda: (M(4, 64), M(4, 2, dtype=I32), M(4, 2, dtype=F32), M(8, 64, 32),
              M(8, 32, 64), M(8, 64, 32), _lora(64, 8, 32, 6), 1.0),
     dict(act="silu"),
     # every group chosen (min(8, 4 x 2)); the rank padded 6 -> 8
     {"bf16": 4 * 2 * 2 * 64 * 32 * 3}, 8 * 3 * 64 * 32 * 2 + 5760 * 4 + 512
     + 32 + 32 + 512, (8 * (32 + 64) + 8 * 8) * 4 + 5760 // 6 * 8 * 4),
    ("decode_ffn",
     lambda: (M(2, 64, dtype=F32), M(2, 3, dtype=I32), M(2, 3, dtype=F32),
              M(8, 64, 32, dtype=F32), M(8, 32, 64, dtype=F32)),
     dict(act="relu", blocks=3),
     {"f32": 2 * 3 * 2 * 64 * 32 * 2}, 3 * 2 * 64 * 32 * 4 + 512 + 24 + 24
     + 512, 6 * (32 + 64) * 4),
]


@pytest.mark.parametrize("case", range(len(COST_CASES)))
def test_kernel_cost(case):
    name, args, kw, ops, nbytes, scratch = COST_CASES[case]
    got = getattr(cost, name)(*args(), **kw)
    assert got == cost.Cost(ops, nbytes, scratch)


def test_cost_functions_cover_every_wrapper():
    """One cost function a kernel wrapper, under its name, and each
    wrapper counted (``cost.counted``)."""
    from repro_torch import kernels
    names = [w.__name__ for w in kernels.wrappers()]
    assert sorted({c[0] for c in COST_CASES}) == sorted(names)
    for w in kernels.wrappers():
        assert callable(getattr(cost, w.__name__))
        assert hasattr(w, "__wrapped__") and w.launches >= 0


def test_thresholds_carry_their_budget():
    """Kernels 4 and 5 take no budget: under a counter their count reads
    the one kernel 2 or 3 made the thresholds with, and counts every
    admitted key (slot) for thresholds of unknown origin."""
    import inspect
    from repro_torch.kernels.sparse_attention import ops as sa_ops
    from repro_torch.kernels.topl_select import ops as topl_ops
    for w in (sa_ops.sparse_attention, sa_ops.sparse_decode_attention):
        assert "l" not in inspect.signature(w).parameters
    g = torch.Generator().manual_seed(0)
    cq = torch.randint(0, 16, (4, 8, 4), generator=g, dtype=torch.int32)
    ck = torch.randint(0, 16, (2, 8, 4), generator=g, dtype=torch.int32)
    q, k, v = (torch.randn(n, 8, 16, generator=g) for n in (4, 2, 2))
    kw = dict(heads_per_batch=4, rep=2)
    with roofline.Counter() as c:
        thr = topl_ops.topl_thresholds(cq, ck, l=3, max_score=4, **kw)
        sa_ops.sparse_attention(q, k, v, cq, ck, thr, scale=0.25, **kw)
        sa_ops.sparse_attention(q, k, v, cq, ck, thr.clone(), scale=0.25,
                                **kw)
    # min(3, i + 1) keys for rows 0-7: 21 a query group; then all 36
    assert c.kernels["sparse_attention"]["ops"] == {
        "f32": 4 * 16 * 4 * 21 + 4 * 16 * 4 * 36}
    cq = torch.randint(0, 16, (16, 2, 8), generator=g, dtype=torch.int32)
    ck = torch.randint(0, 16, (16, 300, 8), generator=g, dtype=torch.int8)
    q = torch.randn(16, 2, 32, generator=g)
    k, v = (torch.randn(16, 300, 32, generator=g) for _ in range(2))
    valid = torch.ones(2, 300, dtype=torch.bool)
    kw = dict(sum_rows=False, heads_per_batch=8)
    with roofline.Counter() as c:
        thr = topl_ops.decode_topl_thresholds(cq, ck, valid, l=40,
                                              max_score=8, **kw)
        sa_ops.sparse_decode_attention(q, k, v, cq, ck, thr, valid,
                                       scale=0.2, **kw)
        sa_ops.sparse_decode_attention(q, k, v, cq, ck, thr.clone(), valid,
                                       scale=0.2, **kw)
    # 16 x 2 rows select 40 slots each; then all 300
    assert c.kernels["sparse_decode_attention"]["ops"] == {
        "f32": 4 * 32 * 32 * 40 + 4 * 32 * 32 * 300}
    assert cost.budget_of(thr) == 40
    plain = topl_ops.decode_topl_thresholds(cq, ck, valid, l=40, max_score=8,
                                            **kw)   # with no counter on
    assert cost.budget_of(plain) is None


def test_kernels_and_core_import_no_launch():
    """The counter's hook lives in kernels/cost.py: neither the kernels
    nor core import the launch package, which imports them."""
    src = ROOT / "src" / "repro_torch"
    imp = re.compile(r"^\s*(from repro_torch\.launch\b|from repro_torch "
                     r"import .*\blaunch\b|import repro_torch\.launch\b)")
    found = [f"{f.relative_to(src)}:{i}"
             for d in ("kernels", "core") for f in (src / d).rglob("*.py")
             for i, line in enumerate(f.read_text().splitlines(), 1)
             if imp.search(line)]
    assert not found


def test_grouped_ffn_h_elems():
    """Kernel 9's bf16 body keeps x and h resident up to d 1024 / F 384;
    past its shared memory it needs an h scratch of F a slot; f32 never."""
    assert cost.grouped_ffn_h_elems(torch.bfloat16, 1024, 384) == 0
    assert cost.grouped_ffn_h_elems(torch.bfloat16, 1024, 512) == 512
    assert cost.grouped_ffn_h_elems(torch.bfloat16, 4096, 1536) == 1536
    assert cost.grouped_ffn_h_elems(torch.float32, 4096, 1536) == 0


# ------------------------------------------------- the trace follows the path
VARIANTS = {"kernels": KERNELS, "spt": SMOKE,
            "lora": dryrun.apply_variant(SMOKE, "lora")}
# kernel calls of a cell: a layer's forward runs twice in a train step
# (the checkpointed unit is recomputed), the attention assigns q's and
# k's codes; the default impls and "lora" call no kernel
WANT_CALLS = {
    "train": {"pq_assign": 8, "topl_thresholds": 4, "sparse_attention": 4,
              "grouped_ffn": 4},
    "prefill": {"pq_assign": 4, "topl_thresholds": 2, "sparse_attention": 2,
                "grouped_ffn": 2},
    "decode": {"fused_sparse_decode_attention": 2, "decode_ffn": 2},
}


def _real_args(cfg, shape):
    ins = materialize(input_specs(cfg, shape),
                      torch.Generator().manual_seed(0), cfg.vocab_size)
    if shape.kind == "train":
        return (S.init_state(cfg, 0, "cpu"), ins)
    model = transformer.LM.init(cfg, 0, "cpu")
    if shape.kind == "prefill":
        return (model, ins)
    caches = transformer.init_caches(cfg, shape.global_batch, shape.seq_len,
                                     "cpu")
    return (model, caches, ins["token"], ins["pos"])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("shape", [TRAIN, PREFILL, DECODE],
                         ids=lambda s: s.kind)
def test_meta_trace_equals_cpu_run(variant, shape):
    cfg = VARIANTS[variant]
    meta = dryrun.trace_cell(cfg, shape, None, target="cpu")
    args = _real_args(cfg, shape)
    real = dryrun.count(dryrun.cell_step(
        cfg, shape, None if shape.kind == "train" else args[0]), args, "cpu")
    assert (meta.flops, meta.hbm_bytes) == (real.flops, real.hbm_bytes)
    assert meta.kernels == real.kernels
    assert meta.memory() == real.memory()
    assert meta.memory()["peak_bytes"] > meta.memory()[
        "argument_size_in_bytes"]
    want = WANT_CALLS[shape.kind] if variant == "kernels" else {}
    assert real.kernel_calls() == dict(sorted(want.items()))


def test_counter_changes_nothing():
    """A step under the counter computes what it computes without one."""
    torch.manual_seed(0)
    args = _real_args(KERNELS, PREFILL)
    step = dryrun.cell_step(KERNELS, PREFILL, args[0])
    want = step(*args)
    got = []
    dryrun.count(lambda *a: got.append(step(*a)) or got[-1], args, "cpu")
    assert torch.equal(want[1], got[0][1])
    pairs = list(zip(leaves(want[0]), leaves(got[0][0])))
    assert pairs and all(pa == pb and torch.equal(a, b)
                         for (pa, a), (pb, b) in pairs)


@pytest.mark.parametrize("shape", [TRAIN, PREFILL, DECODE],
                         ids=lambda s: s.kind)
def test_exact_roofline_extrapolates(shape):
    """1 and 2 units extrapolated to 4 equal a trace of the 4-layer
    model (no tail layers) at the analysis chunking."""
    cfg = dataclasses.replace(KERNELS, num_layers=4)
    ex = dryrun.exact_roofline(cfg, shape, None)["roofline_exact"]
    full = roofline.analyze(dryrun.trace_cell(
        dryrun._analysis_cfg(cfg, shape), shape, None, loss_chunk=2048))
    assert (ex["flops"], ex["hbm_bytes"], ex["coll_bytes"]) == (
        full.flops, full.hbm_bytes, full.coll_bytes)


# ------------------------------------------------------------ collectives
def test_collectives_only_in_collectives_py():
    src = ROOT / "src" / "repro_torch"
    files = [*(src / "models").glob("*.py"), *(src / "core").glob("*.py"),
             *(src / "optim").glob("*.py"), src / "launch" / "steps.py",
             src / "train" / "loss.py"]
    call = re.compile(r"\bdist\.(all_reduce|all_gather\w*|reduce_scatter\w*"
                      r"|broadcast|all_to_all\w*)\s*\(")
    found = [f"{f.name}:{i}" for f in files if f.name != "collectives.py"
             for i, line in enumerate(f.read_text().splitlines(), 1)
             if call.search(line)]
    assert not found
    text = (src / "core" / "collectives.py").read_text()
    assert len(call.findall(text)) == 3           # inside _issue's callers


def _region_leaves(defs, specs):
    """(bytes of the trainable leaves stored split over "model", bytes of
    those stored whole): the gradients of the whole ones leave the region
    by an all-reduce, the split ones' need none."""
    sliced = whole = 0

    def walk(d, sp):
        nonlocal sliced, whole
        if isinstance(d, ParamDef):
            if d.trainable:
                n = math.prod(d.shape) * d.dtype.itemsize
                if sp is not None and "model" in [
                        a for e in sp for a in ((e,) if isinstance(e, str)
                                                else tuple(e or ()))]:
                    sliced += n
                else:
                    whole += n
            return
        for k in d:
            walk(d[k], None if sp is None else sp[k])
    walk(defs, specs)
    return sliced, whole


def test_mesh_collective_bytes():
    """A train step under a dry (1, 2) mesh: the collectives' result
    bytes by kind equal the count from the rules (JAX's convention)."""
    cfg, n = KERNELS, 2
    b, s, d = TRAIN.global_batch, TRAIN.seq_len, cfg.d_model
    whole = b * s * d * 2                    # a (B, S, d) bf16 activation
    chunk = whole // n
    units = cfg.num_layers                   # one attention block a unit
    attn = _region_leaves(attention.attn_defs(cfg),
                          attention.tp_specs(cfg, n))
    assert ffn.tp_plan(cfg, n) is not None
    mlp = _region_leaves(ffn.ffn_defs(cfg), ffn.tp_specs(cfg, n))
    rows = b * s
    want = {
        # the regions' entries in the forward and in the checkpoint's
        # recompute, the loss's gather of the hidden states, the exits'
        # backward (a sliced trainable leaf is stored as its slice: its
        # gradient needs no gather)
        "all-gather": whole * (2 * units * 2 + 1 + 2 * units),
        # the exits (the recompute stops after the attention's: the FFN's
        # output is not saved for backward), the embedding's vocabulary
        # split, the entries' backward, the loss gather's backward
        "reduce-scatter": chunk * (units * 2 + units + 1 + 2 * units + 1),
        # the vocabulary-split loss: max, sum of exponentials, target
        # (f32 a row) and argmax (int64 a row); the whole trainable
        # leaves' gradients; the global norm's sum of squares (f32)
        "all-reduce": rows * (4 + 4 + 4 + 8) + units * (attn[1] + mlp[1])
        + 4,
    }
    with make_dry_mesh((1, n), ("data", "model")) as mesh:
        counter = dryrun.trace_cell(cfg, TRAIN, mesh)
    assert counter.coll_by_kind == want
    assert not dist.is_initialized()


def test_dry_mesh_refuses_a_running_group(tmp_path):
    with make_dry_mesh((2, 2), ("data", "model")):
        with pytest.raises(RuntimeError, match="process group"):
            with make_dry_mesh((1, 1), ("data", "model")):
                pass
    assert not dist.is_initialized()


# --------------------------------------------------------------- run_cell
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes", "peak_bytes"}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_run_cell(shape):
    res = dryrun.run_cell("qwen3-0.6b", shape, False, verbose=False,
                          cfg_override=SMOKE)
    assert res["status"] == "ok", res.get("traceback")
    assert {"arch", "shape", "variant", "mesh", "chips", "trace_s",
            "roofline_scanned", "model_flops_total", "model_flops_per_chip",
            "memory_analysis", "per_unit", "one_unit", "roofline_exact",
            "useful_flops_ratio"} <= set(res)
    assert res["chips"] == 256 and set(res["memory_analysis"]) == MEMORY_KEYS
    assert {"flops", "hbm_bytes", "coll_bytes", "coll_by_kind", "t_compute",
            "t_memory", "t_collective", "bottleneck", "t_bound",
            "peak_memory"} <= set(res["roofline_scanned"])
    json.dumps(res)
    assert not dist.is_initialized()


def test_run_cell_skips_as_jax():
    res = dryrun.run_cell("qwen3-0.6b", "long_500k", False, verbose=False)
    assert res["status"] == "skipped" and res["reason"]


def test_parse_overrides():
    assert dryrun.parse_overrides(["attn_impl=pallas", "chunk_q=128",
                                   "attn_top_fraction=0.25",
                                   "sparse_mha=false"]) == {
        "attn_impl": "pallas", "chunk_q": 128, "attn_top_fraction": 0.25,
        "sparse_mha": False}


# ------------------------------------------------------- repairs on meta
def test_one_hot_equals_torch():
    x = torch.randint(0, 13, (5, 7, 3))
    for dtype in (torch.int64, torch.float32, torch.bfloat16):
        assert torch.equal(dispatch.one_hot(x, 13, dtype),
                           torch.nn.functional.one_hot(x, 13).to(dtype))
    assert torch.equal(dispatch.one_hot(x.int(), 13),
                       torch.nn.functional.one_hot(x, 13))


def test_step_counter_on_the_host():
    st = S.init_state(SMOKE, 0, "cpu")
    ab = S.abstract_state(SMOKE)
    assert st["step"].device.type == ab["step"].device.type == "cpu"
    assert all(t.is_meta for t in roofline.tensors_of(ab["frozen"]))
    assert S.state_device(ab).type == "meta"
    assert roofline.storage_bytes(st) == roofline.storage_bytes(ab)


# ---------------------------------------------------------------- vs JAX
def _train_out_bytes(cfg, mesh_data=1):
    """The port's train step on meta: (argument bytes, the new state's
    bytes)."""
    args = (S.abstract_state(cfg),
            abstract_inputs(input_specs(cfg, TRAIN), mesh_data))
    box = []
    step = dryrun.cell_step(cfg, TRAIN)
    counter = dryrun.count(lambda *a: box.append(step(*a)) or box[-1], args)
    return counter.memory()["argument_size_in_bytes"], roofline.storage_bytes(
        box[0][0])


def test_against_jax_mesh_1x1(jax_cells):
    jx = jax_cells()
    args, state_out = _train_out_bytes(SMOKE)
    assert args == jx[("train", (1, 1))]["argument"]
    assert state_out == jx[("train", (1, 1))]["out_leaf_bytes"]
    for kind, shape in (("prefill", PREFILL), ("decode", DECODE)):
        with make_dry_mesh((1, 1), ("data", "model")) as mesh:
            mem = dryrun.trace_cell(SMOKE, shape, mesh).memory()
        assert mem["argument_size_in_bytes"] == jx[(kind, (1, 1))]["argument"]
        assert mem["output_size_in_bytes"] == jx[(kind, (1, 1))][
            "out_leaf_bytes"]
        print(f"{kind} (1, 1): port {mem}, JAX {jx[(kind, (1, 1))]}")


def _against_jax_mesh(jax_cells, arch, shape):
    jx = jax_cells()
    cfg = configs.get_smoke(arch)
    data = shape[0]
    with make_dry_mesh(shape, ("data", "model")) as mesh:
        rules = rules_for_mesh(mesh)
        train = dryrun.trace_cell(cfg, TRAIN, mesh).memory()
        decode = dryrun.trace_cell(cfg, DECODE, mesh).memory()
        state = S.init_state(cfg, 0, "cpu", mesh=mesh)
        model = engine.init_model(cfg, 0, "cpu", mesh=mesh)
        slots = DECODE.global_batch // data
        caches = transformer.init_caches(model.cfg, slots, DECODE.seq_len,
                                         "cpu", shard=model.shard)
        local = {p: tuple(v.shape) for p, v in leaves(
            engine.abstract_decode_caches(model.cfg, slots, DECODE.seq_len,
                                          shard=model.shard))}
        # JAX's cache placements (``cache_specs``), each rank's shapes
        whole = engine.abstract_decode_caches(cfg, DECODE.global_batch,
                                              DECODE.seq_len)
        want = {p: local_shape(t.shape, sp, rules["__sizes__"])
                for (p, t), (_, sp) in zip(
                    leaves(whole), leaves(steps.cache_specs(cfg, whole,
                                                            rules)))}
    rows = TRAIN.global_batch // data * TRAIN.seq_len * 4 * 2  # tokens, labels
    assert train["argument_size_in_bytes"] == roofline.storage_bytes(
        state) + rows
    dec = roofline.storage_bytes(model, caches) + slots * 4 + 4
    assert decode["argument_size_in_bytes"] == dec
    assert local == want            # JAX's cache layout
    assert local == dict(leaves(steps.cache_local_shapes(cfg, whole, rules)))
    for kind, port in (("train", train), ("decode", decode)):
        j = jx[(arch, kind, shape)]["argument"]
        print(f"{arch} {kind} {shape}: port {port['argument_size_in_bytes']}"
              f" B a rank, JAX {j} B, ratio "
              f"{port['argument_size_in_bytes'] / j:.3f}")
        assert port["argument_size_in_bytes"] == j
    return local


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b"])
def test_against_jax_mesh_2x2(jax_cells, arch):
    """At (2, 2) each rank stores its parts (train/state.storage_specs;
    the serving model's, ``engine.init_model``) and the caches of its
    slots: the trace's argument bytes equal what the port's constructors
    give one rank, and JAX's ``memory_analysis()`` exactly, for the train
    and the decode cell (mixtral's experts over data and model); the
    caches are laid out as JAX's ``cache_specs`` place them."""
    _against_jax_mesh(jax_cells, arch, (2, 2))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b"])
def test_against_jax_mesh_1x4(jax_cells, arch):
    """At (1, 4) the 2 kv heads do not split over the 4 model ranks: the
    query heads split inside them, k and v are stored over their columns
    and the caches' sequence over the ranks, as JAX places them; the
    argument bytes a rank equal JAX's ``memory_analysis()`` exactly, for
    the train and the decode cell."""
    local = _against_jax_mesh(jax_cells, arch, (1, 4))
    cfg = configs.get_smoke(arch)
    size = min(DECODE.seq_len, cfg.window or DECODE.seq_len)
    assert local[("units", "b0_attn", "k")][2:4] == (2, size // 4)
    assert local[("units", "b0_attn", "slot_pos")][2] == size


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b"])
def test_peak_does_not_wait_for_the_cycle_collector(arch):
    """A (2, 2) train step's traced peak is the same with Python's cycle
    collector off: no storage of the step is held by a reference cycle
    (a region's leaves, the ZeRO-3 gathered expert columns among them,
    are freed when the region's entry returns, not when the collector
    runs)."""
    import gc
    cfg = configs.get_smoke(arch)
    peaks = []
    for collector in (True, False):
        gc.collect()
        if not collector:
            gc.disable()
        try:
            with make_dry_mesh((2, 2), ("data", "model")) as mesh:
                peaks.append(dryrun.trace_cell(cfg, TRAIN, mesh).memory()[
                    "peak_bytes"])
        finally:
            gc.enable()
    assert peaks[0] == peaks[1]
