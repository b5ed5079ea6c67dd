"""Layer 2: resource audits of the CUDA kernels against Hopper's limits
(the JAX package's ``analysis/pallas_audit.py``; there is no Pallas, so
it has a new name).

JAX bounds a kernel's VMEM from its BlockSpecs; on the H100 the
counterparts are a block's shared memory and registers, read from the
build.  Rules (stable ids):

  kernel.smem        (JAX: pallas.vmem-budget) static + dynamic shared
                     memory of a kernel function past 232,448 bytes a block
  kernel.registers   registers x threads a block (its ``__launch_bounds__``)
                     past the 65,536 of an SM
  kernel.spill       spilled bytes past the budget recorded for the kernel
                     function (``SPILL_BUDGET``; none recorded = 0)
  kernel.contract    (JAX: pallas.tile-divisibility) a wrapper refuses a
                     shape that a registry config gives it (every config
                     of ``configs``, traced one unit deep on the meta
                     device with the card's path: the forward of a
                     training batch, and the decode step on the fused and
                     the two-pass tiers)
  kernel.accum-dtype (JAX: jaxpr.accum-dtype) an inline ``wgmma`` /
                     ``mma`` instruction in csrc/ that does not accumulate
                     in f32
  kernel.no-kernel   (JAX: pallas.no-kernel) the audit saw no kernel
                     function (no ptxas log, no source): it went vacuous

Where the numbers come from: registers, static shared memory and spills
from the ptxas ``-v`` logs that ``kernels.build(verbose=True)`` keeps
(``ptxas_usage``); threads from the ``__launch_bounds__`` in the sources;
dynamic shared memory from the launchers' own formulas, restated here
(``pq_assign_smem`` ... ``decode_ffn_smem``; ``instance_smem`` picks the
template instance a shape runs) at every registry config's shapes on the
CPU and held on the card to the library's ``extern "C"`` queries
(``repro_*_smem``: ``smem_query_violations``).  The decode attention
kernels (3, 5-8) use static shared memory only (their ring is
``DECODE_RING_BYTES``, ``decode_stages``), which ptxas reports.

JAX's ``pallas.scalar-prefetch`` does not transfer: a CUDA kernel takes
its page table or plan as a plain pointer argument.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import configs, kernels
from repro_torch.analysis.registry import Violation, audit
from repro_torch.core.lora import LoRAConfig
from repro_torch.launch import roofline

SMEM_BLOCK = 232448          # bytes of shared memory a block may use
REGS_SM = 65536              # 32-bit registers an SM holds

# Spilled bytes of every kernel function that spills, by (source, function)
# as ptxas names them: the build of the recorded sources (chip_smoke.py
# phase 2, NVIDIA H100 80GB HBM3; PERF.md section 6's resource table).
# The R = 16 decode attention instances spill 356-644 bytes.
SPILL_BUDGET: Dict[Tuple[str, str], int] = {
    ("decode_ffn", "decode_ffn_out_part<__nv_bfloat16, (bool)0>"): 8,
    ("decode_ffn", "decode_ffn_out_part<__nv_bfloat16, (bool)1>"): 24,
    ("decode_ffn", "decode_ffn_out_part<float, (bool)1>"): 20,
    ("dense_decode_paged",
     "attend_kernel<__nv_bfloat16, Paged, (int)2, (int)16>"): 28,
    ("dense_decode_paged", "attend_kernel<float, Paged, (int)2, (int)16>"):
        80,
    # the main path's instance spills what it did before the GEN instances
    # (the per-tile choice of compare) came; those, and the 64-book packed
    # threshold kernel, hold a few more live values
    ("sparse_attention",
     "sparse_attention_bf16_kernel<(int)128, (int)4, (bool)0>"): 24,
    ("sparse_attention",
     "sparse_attention_bf16_kernel<(int)256, (int)8, (bool)1>"): 4,
    ("sparse_attention",
     "sparse_attention_bf16_kernel<(int)64, (int)8, (bool)1>"): 32,
    ("sparse_attention",
     "sparse_attention_bf16_kernel<(int)64, (int)4, (bool)1>"): 16,
    ("topl_thresholds", "topl_thresholds_kernel<(int)64>"): 12,
    ("sparse_attention", "sparse_attention_f32_kernel<(int)2, (bool)1>"): 12,
    ("sparse_attention", "sparse_attention_f32_kernel<(int)1, (bool)1>"): 8,
    ("sparse_decode", "attend_kernel<__nv_bfloat16, Paged, (int)0, (int)16>"):
        516,
    ("sparse_decode", "attend_kernel<float, Paged, (int)0, (int)16>"): 644,
    ("sparse_decode", "hist_kernel<Paged, (int)16>"): 4,
    ("sparse_decode", "attend_kernel<__nv_bfloat16, Contig, (int)0, (int)16>"):
        356,
    ("sparse_decode", "attend_kernel<float, Contig, (int)0, (int)16>"): 564,
    ("sparse_decode_two_pass",
     "attend_kernel<__nv_bfloat16, Contig, (int)1, (int)16>"): 452,
    ("sparse_decode_two_pass",
     "attend_kernel<float, Contig, (int)1, (int)16>"): 644,
    ("sparse_decode_two_pass", "tie_kernel<Contig, (int)16>"): 16,
}


@dataclasses.dataclass(frozen=True)
class KernelUsage:
    """One kernel function of the build, as ptxas reports it."""
    source: str          # csrc stem
    function: str        # demangled
    registers: int
    static_smem: int
    spill: int

    @property
    def base(self) -> str:
        """The kernel's name without namespace or template arguments."""
        return self.function.split("<")[0].split("(")[0].split("::")[-1]


def short_name(demangled: str) -> str:
    """A demangled kernel entry without its return type, the anonymous
    namespace and its parameter list: "attend_kernel<float, Paged, (int)0,
    (int)16>" (the names ``SPILL_BUDGET`` keys on)."""
    name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::", "",
                  demangled.strip())
    return (name[:name.index(">(") + 1] if ">(" in name
            else name.split("(")[0])


# ---------------------------------------------------------- the build
def parse_ptxas(text: str, source: str) -> List[KernelUsage]:
    """The (mangled) kernel entries of one ptxas -v log."""
    rows, fn, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and fn:
            rows.append(KernelUsage(source, fn, int(m.group(1)),
                                    int(m.group(2) or 0), spill))
            fn = None
    return rows


def ptxas_usage(build_dir: Optional[Path] = None) -> List[KernelUsage]:
    """Every kernel entry of the verbose build's logs
    (``build/repro_torch/<source>.log``), names demangled by cu++filt
    where the toolkit has it."""
    build_dir = kernels.BUILD_DIR if build_dir is None else build_dir
    rows: List[KernelUsage] = []
    for log in sorted(Path(build_dir).glob("*.log")):
        rows += parse_ptxas(log.read_text(), log.stem)
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if rows and os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(r.function
                                                       for r in rows),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        rows = [dataclasses.replace(r, function=short_name(n))
                for r, n in zip(rows, names)]
    return rows


def _constants(text: str) -> Dict[str, int]:
    """``constexpr int NAME = expr;`` values of a source in order (a later
    definition of a name replaces an earlier one; expressions of earlier
    constants, C's integer division)."""
    env: Dict[str, int] = {}
    for m in re.finditer(r"constexpr\s+int\s+([^;(]+);", text):
        for part in m.group(1).split(","):
            if "=" not in part:
                continue
            name, expr = (s.strip() for s in part.split("=", 1))
            try:
                env[name] = int(eval(expr.replace("/", "//"),
                                     {"__builtins__": {}}, dict(env)))
            except Exception:
                pass
    return env


def launch_threads(source: str, csrc: Optional[Path] = None
                   ) -> Dict[str, int]:
    """{kernel function: threads a block} from the ``__launch_bounds__``
    of ``csrc/<source>.cu`` and the headers it includes, each bound read
    with the constants defined above it."""
    csrc = kernels.CSRC if csrc is None else csrc
    text = (csrc / f"{source}.cu").read_text()
    for inc in re.findall(r'#include "(\S+)"', text):
        if (csrc / inc).exists():
            text = (csrc / inc).read_text() + "\n" + text
    out: Dict[str, int] = {}
    for m in re.finditer(r"__launch_bounds__\(([^,)]+)[^)]*\)\s*(\w+)",
                         text):
        env = _constants(text[:m.start()])
        try:
            out.setdefault(m.group(2), int(eval(
                m.group(1).replace("/", "//"), {"__builtins__": {}}, env)))
        except Exception:
            pass
    return out


# ------------------------------------------------- dynamic shared memory
def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pq_assign_smem(elem: int, m: int, e: int, dp: int) -> int:
    """csrc/pq_assign.cu, fast_smem_bytes: the main-path body's attribute,
    set at M_FAST = 32 books (TR = 64 rows a tile); 0 off that path."""
    if not (e == 16 and dp == 8 and m <= 32):
        return 0
    m = 32
    return m * 16 * 9 * 4 + 2 * 64 * (m * 8 * elem + 16) + 64 * (m + 1) * 4


def topl_thresholds_smem(m: int) -> int:
    """csrc/topl_thresholds.cu: the packed body's histogram ((M + 1) x 128
    ints, up to 64 books), else the general body's histogram, transposed
    row codes and key tile at its rows and keys (any_tiles)."""
    if m <= 64:
        return (m + 1) * 128 * 4
    rb, bk = topl_any_tiles(m)
    return _topl_any_bytes(m, rb, bk)


def _topl_any_bytes(m: int, rb: int, bk: int) -> int:
    return ((m + 1) * rb + m * rb + bk * m) * 4


def topl_any_tiles(m: int) -> Tuple[int, int]:
    """The general body's rows a block and keys a tile: 128 and 32,
    halved (rows to 32, keys, then rows) until they fit a block."""
    rb, bk = 128, 32
    while _topl_any_bytes(m, rb, bk) > SMEM_BLOCK and rb > 32:
        rb >>= 1
    while _topl_any_bytes(m, rb, bk) > SMEM_BLOCK and bk > 1:
        bk >>= 1
    while _topl_any_bytes(m, rb, bk) > SMEM_BLOCK and rb > 1:
        rb >>= 1
    return rb, bk


def _sa_bf16_bytes(dh: int, m: int) -> int:
    """bf16_smem_bytes (BQ = BK = 64, 2 stages, 4 warps; CW = 4 code words
    up to 16 books, else 8)."""
    row = ((dh + 15) & ~15) + 8
    stage = 2 * 64 * row * 2 + 64 * m * 4
    return 64 * row * 2 + 2 * stage + 4 * 64 * (4 if m <= 16 else 8) * 4


def sparse_attention_body(elem: int, dh: int, m: int) -> str:
    """body_of: "f32" (dh a multiple of 8 up to 256, M <= 32), "bf16"
    (dh a multiple of 8 up to 256 where its shared memory fits) or "any"."""
    if dh % 8 == 0 and dh <= 256:
        if elem == 4 and m <= 32:
            return "f32"
        if elem == 2 and _sa_bf16_bytes(dh, m) <= SMEM_BLOCK:
            return "bf16"
    return "any"


def _sa_any_warps(dh: int) -> int:
    w = 8
    while w > 1 and w * (2 * dh + 32) * 4 > SMEM_BLOCK:
        w >>= 1
    return w


def sparse_attention_smem(elem: int, dh: int, m: int) -> int:
    """csrc/sparse_attention.cu: the bf16 body's (bf16_smem_bytes), the
    any-shape body's (8 warps, fewer past a block, each 2 dh + 32
    floats), none for the f32 body."""
    body = sparse_attention_body(elem, dh, m)
    if body == "bf16":
        return _sa_bf16_bytes(dh, m)
    if body == "any":
        return _sa_any_warps(dh) * (2 * dh + 32) * 4
    return 0


WIDE_SMEM = 1024 + 8192 + 3 * (8192 + 4 * 64 * 128) + 64 * 4
DECODE_FFN_REST = 4 * (8 * 8 * 32 + 8 * 8 * 32 + 8 * 2 * 64 + 2 * 64 * 32)


def grouped_ffn_smem(elem: int, d: int, f: int, r: int) -> int:
    """csrc/grouped_ffn.cu: the bf16 resident body (x and h tiles, a
    3-stage ring of 16 KB) or its wide form where that does not fit; the
    f32 body at the largest row tile (8 x 4, 2, 1 rows) that fits."""
    if elem == 2:
        from repro_torch.kernels.cost import grouped_ffn_resident
        resident = (1024 + (_cdiv(d, 64) + 2 * _cdiv(f, 128)) * 8192
                    + 3 * 16384 + 64 * 4)
        return resident if grouped_ffn_resident(d, f, r) else WIDE_SMEM
    return _f32_bytes(8 * max(1, _f32_rows(d, f, r)), d, f, r)


def _f32_bytes(tc: int, d: int, f: int, r: int) -> int:
    """The f32 grouped body's shared memory at a tile of ``tc`` rows."""
    return 4 * (32 * 128 + tc * d + tc * f + 3 * tc * r) + 4 * tc


def _f32_rows(d: int, f: int, r: int) -> int:
    """The f32 grouped body's row tile (8 x 4, 2, 1) at (d, F, r), 0 where
    none fits (its launcher refuses)."""
    for rt in (4, 2, 1):
        if _f32_bytes(8 * rt, d, f, r) <= SMEM_BLOCK:
            return rt
    return 0


def decode_ffn_smem(elem: int, b: int, d: int, ga: int, f: int,
                    r: int) -> Tuple[int, int, int]:
    """csrc/decode_ffn.cu, smem_of: (hidden pass, output part pass,
    combine) of B slots x G' choices (8 pairs a weight pass, x staged as
    f32 where it fits; the output pass chunks h by 2048 past the block)."""
    lst = 4 * ((b * ga + 4) & ~3)
    x_f32 = lst + 4 * 8 * d + DECODE_FFN_REST <= SMEM_BLOCK
    b1 = lst + (4 if x_f32 else elem) * 8 * d + DECODE_FFN_REST

    def part(fc):
        return lst + 4 * (8 * fc + 8 * 8 * 64)
    b3 = part(2048 if part(f) > SMEM_BLOCK else f)
    b4 = 4 * (ga * r * (1 + _cdiv(d, 64)) + r * 128)
    return b1, b3, b4


@dataclasses.dataclass(frozen=True)
class Launch:
    """The shape a wrapper was called at: the arguments its launcher's
    shared memory depends on (elem = x's bytes an element)."""
    kernel: str
    args: Tuple[int, ...]
    where: str

    def smem(self, part: int = 0) -> int:
        a = self.args
        if self.kernel == "pq_assign":
            return pq_assign_smem(*a)
        if self.kernel == "topl_thresholds":
            return topl_thresholds_smem(a[1])
        if self.kernel == "sparse_attention":
            return sparse_attention_smem(*a)
        if self.kernel == "grouped_ffn":
            return grouped_ffn_smem(*a)
        if self.kernel == "decode_ffn":
            return decode_ffn_smem(*a)[part]
        return 0


def _rank(lora_params, multiple: int) -> int:
    if not lora_params:
        return 0
    r = lora_params["lora_inner"]["b"].shape[-1]
    return r + -r % multiple


def launch_of(name: str, args, kw, where: str) -> Optional[Launch]:
    """The launcher shape of one wrapper call (None for the kernels with
    static shared memory only)."""
    if name == "pq_assign":
        x, cb = args[0], args[1]
        return Launch(name, (x.element_size(), *cb.shape), where)
    if name == "topl_thresholds":
        return Launch(name, (4, args[0].shape[-1]), where)
    if name == "sparse_attention":
        q, cq = args[0], args[3]
        return Launch(name, (q.element_size(), q.shape[-1], cq.shape[-1]),
                      where)
    if name in ("grouped_ffn", "decode_ffn"):
        x, w_inner = args[0], args[2 if name == "grouped_ffn" else 3]
        names = ("w_gate", "lora_params")
        rest = dict(zip(names, args[4 if name == "grouped_ffn" else 5:]))
        rest.update({k: v for k, v in kw.items() if k in names})
        bf16 = x.dtype == torch.bfloat16
        if name == "grouped_ffn":
            from repro_torch.kernels.routed_ffn.ops import kernel_rank
            r = kernel_rank(_rank(rest.get("lora_params"), 1), x.dtype)
            return Launch(name, (x.element_size(), x.shape[-1],
                                 w_inner.shape[-1], r), where)
        r = _rank(rest.get("lora_params"), 4)
        return Launch(name, (x.element_size(), x.shape[0], x.shape[1],
                             args[1].shape[1], w_inner.shape[-1], r), where)
    return None


class _Launches(roofline.Counter):
    """Records every kernel wrapper's call shape (``launches``)."""

    def __init__(self, where: str):
        super().__init__()
        self.where = where
        self.launches: List[Launch] = []

    def kernel(self, name, cost, fn, args, kw):
        ln = launch_of(name, args, kw, self.where)
        if ln is not None:
            self.launches.append(ln)
        return super().kernel(name, cost, fn, args, kw)


# ------------------------------------------------ the registry's shapes
def registry_names() -> Tuple[str, ...]:
    from repro_torch.configs import paper_blocks
    return (configs.ARCH_NAMES + tuple(paper_blocks.blocks())
            + ("opt-2.7b", "llama-2.7b"))


# a forward over a training-shaped batch (lm_prefill: the train step's
# kernels 1, 2, 4 and 9 at the same shapes; its backward runs none) and a
# decode step
FORWARD = configs.ShapeSpec("audit_forward", "prefill", 512, 2)
DECODE = configs.ShapeSpec("audit_decode", "decode", 1024, 8)
# SPT settings users choose beside the defaults, traced through the
# forward (the training kernels 1, 2, 4 and 9, which take the JAX
# kernels' whole contract): LoRA rank 64, an 8-bit codebook (E = 256),
# d' = 4 (M = d_head / 4 books).  The decode kernels' whole contract is
# ROADMAP's next slice, so the decode steps run at the defaults.
CONTRACT_SPT = (("lora r64", {"lora": LoRAConfig(rank=64, alpha=64.0,
                                                  enabled=True)}),
                ("E256", {"pq_codewords": 256}),
                ("d'4", {"pq_code_dim": 4}))
_SWEEP: Dict[str, Tuple[List[Launch], List[Violation]]] = {}


def config_launches(name: str, cfg) -> Tuple[List[Launch], List[Violation]]:
    """``cfg`` one unit deep with the kernel paths on, traced on the meta
    device along the card's path: the forward of a 2 x 512 training
    batch and a decode step at 8 slots x 1024 on the fused and the
    two-pass tiers, and the forward again under each of CONTRACT_SPT.
    Returns the wrappers' call shapes and a ``kernel.contract``
    violation for every refusal."""
    from repro_torch.launch import dryrun
    cfg = dryrun._unit_config(cfg, 1).with_spt(attn_impl="pallas",
                                                ffn_impl="pallas")
    got: List[Launch] = []
    bad: List[Violation] = []
    runs = [(FORWARD, {}, ""), (DECODE, {}, ""),
            (DECODE, {"decode_attn_fuse": "two_pass"}, " two-pass")]
    runs += [(FORWARD, spt, f" {label}") for label, spt in CONTRACT_SPT]
    for shape, spt, tag in runs:
        where = f"{name} {shape.kind}{tag}"
        rec = _Launches(where)
        try:
            dryrun.trace_cell(cfg.with_spt(**spt), shape, None,
                              target="cuda", counter=rec)
        except (ValueError, TypeError) as e:
            bad.append(Violation("kernel.contract", where,
                                 f"{type(e).__name__}: {e}"))
        got += rec.launches
    return got, bad


def registry_sweep(names: Optional[Sequence[str]] = None
                   ) -> Tuple[List[Launch], List[Violation]]:
    """``config_launches`` of every registry config (memoized per
    name)."""
    launches: List[Launch] = []
    out: List[Violation] = []
    for name in names or registry_names():
        if name not in _SWEEP:
            _SWEEP[name] = config_launches(name, configs.get_config(name))
        launches += _SWEEP[name][0]
        out += _SWEEP[name][1]
    return launches, out


# ---------------------------------------------------------- rule bodies
def resource_violations(rows: Sequence[KernelUsage],
                        launches: Sequence[Launch],
                        threads: Dict[str, Dict[str, int]],
                        budget: Optional[Dict] = None) -> List[Violation]:
    """kernel.smem, kernel.registers and kernel.spill over the build's
    kernel functions; ``launches`` give the dynamic shared memory of
    those that take it, ``threads`` {source: {function: threads}}."""
    budget = SPILL_BUDGET if budget is None else budget
    if not rows:
        return [Violation("kernel.no-kernel", "build",
                          "no kernel function in the ptxas logs — the "
                          "audit is vacuous (build without -Xptxas -v?)")]
    out = []
    for r in rows:
        entry = f"{r.source}: {r.function}"
        dyn = dynamic_of(r, launches)
        if r.static_smem + dyn > SMEM_BLOCK:
            out.append(Violation(
                "kernel.smem", entry,
                f"{r.static_smem} B static + {dyn} B dynamic shared memory "
                f"> {SMEM_BLOCK} B a block"))
        t = threads.get(r.source, {}).get(r.base)
        if t is None:
            out.append(Violation("kernel.registers", entry,
                                 "no __launch_bounds__ found for it"))
        elif r.registers * t > REGS_SM:
            out.append(Violation(
                "kernel.registers", entry,
                f"{r.registers} registers x {t} threads = "
                f"{r.registers * t} > {REGS_SM}"))
        allowed = budget.get((r.source, r.function), 0)
        if r.spill > allowed:
            out.append(Violation(
                "kernel.spill", entry,
                f"spills {r.spill} B, budget {allowed} B (record a new "
                "budget in kernel_audit.SPILL_BUDGET only with a reason)"))
    return out


_ELEM = {"float": 4, "__nv_bfloat16": 2}


def _template_args(function: str) -> List[str]:
    inner = function[function.index("<") + 1:function.rindex(">")] \
        if "<" in function else ""
    return [a.strip() for a in inner.split(",") if a.strip()]


def _int_arg(a: str) -> int:
    return int(a.replace("(int)", "").replace("(bool)", ""))


def instance_smem(row: KernelUsage, ln: "Launch") -> Optional[int]:
    """The dynamic shared memory the launch ``ln`` (a registry call
    shape) asks for ``row``'s template instance, or None where that
    launch does not run this instance (another element type, tile, body
    or pass form; or a shape its wrapper or launcher refuses)."""
    args, base = _template_args(row.function), row.base
    a = ln.args[1:]
    if base == "pq_assign_fast_kernel" and ln.kernel == "pq_assign":
        return pq_assign_smem(_ELEM[args[0]], *a)
    if base.startswith("topl_thresholds") and ln.kernel == "topl_thresholds":
        m = a[0]
        if base == "topl_thresholds_any_kernel":
            return topl_thresholds_smem(m) if m > 64 else None
        mb = next(b for b in (8, 16, 32, 64, m) if m <= b)
        return topl_thresholds_smem(m) if mb == _int_arg(args[0]) else None
    if base == "sparse_attention_bf16_kernel" and ln.kernel == \
            "sparse_attention" and ln.args[0] == 2:
        dh, m = a
        if sparse_attention_body(2, dh, m) != "bf16":
            return None
        dp = (dh + 15) & ~15
        db = 64 if dp <= 64 else 128 if dp <= 128 else 256
        if (db, 4 if m <= 16 else 8) != tuple(map(_int_arg, args[:2])):
            return None                 # either GEN instance: the same smem
        return sparse_attention_smem(2, dh, m)
    if base == "sparse_attention_any_kernel" and ln.kernel == \
            "sparse_attention":
        dh, m = a
        if (sparse_attention_body(ln.args[0], dh, m) != "any"
                or _ELEM[args[0]] != ln.args[0]):
            return None
        return sparse_attention_smem(ln.args[0], dh, m)
    if ln.kernel == "grouped_ffn":
        d, f, r = a
        if base == "grouped_ffn_kernel":             # the f32 body
            rt = _f32_rows(d, f, r)
            return (grouped_ffn_smem(4, d, f, r)
                    if rt and rt == _int_arg(args[0]) else None)
        if base.startswith("grouped_ffn_") and ln.args[0] == 2:
            wide = grouped_ffn_smem(2, d, f, r) == WIDE_SMEM
            return (grouped_ffn_smem(2, d, f, r)
                    if ("wide" in base) == wide else None)
        return None
    if base.startswith("decode_ffn") and ln.kernel == "decode_ffn":
        from repro_torch.kernels.routed_ffn.ops import decode_ffn_max_d
        elem = _ELEM[args[0]]
        b, d, ga, f, r = a
        if d > decode_ffn_max_d(b * ga, elem):     # the wrapper refuses
            return None
        b1, b3, b4 = decode_ffn_smem(elem, b, d, ga, f, r)
        lst = 4 * ((b * ga + 4) & ~3)
        if base == "decode_ffn_hidden":
            x_f32 = lst + 4 * 8 * d + DECODE_FFN_REST <= SMEM_BLOCK
            return b1 if (args[1] == "float") == x_f32 or elem == 4 \
                else None
        if base == "decode_ffn_out_part":
            chunked = lst + 4 * (8 * f + 8 * 8 * 64) > SMEM_BLOCK
            return b3 if chunked == (_int_arg(args[1]) == 1) else None
        if base == "decode_ffn_out":
            return b4
    return None


def dynamic_of(row: KernelUsage, launches: Sequence["Launch"]) -> int:
    """The most dynamic shared memory any registry launch asks of
    ``row``'s instance, its bf16 call shapes taken in the instance's
    element type where its wrapper takes them (0: static only, or no
    registry shape runs it)."""
    sizes = []
    for ln in launches:
        elem = _ELEM.get(next(iter(_template_args(row.function)), ""), 2)
        for cand in {ln, dataclasses.replace(ln, args=(elem,) + ln.args[1:])}:
            v = instance_smem(row, cand)
            if v is not None:
                sizes.append(v)
    return max(sizes, default=0)


def launch_violations(launches: Sequence[Launch]) -> List[Violation]:
    """Without a build (the CPU): every launch's dynamic shared memory
    within a block's 232,448 bytes."""
    out = []
    for ln in launches:
        parts = (0, 1, 2) if ln.kernel == "decode_ffn" else (0,)
        for p in parts:
            if ln.smem(p) > SMEM_BLOCK:
                out.append(Violation(
                    "kernel.smem", f"{ln.kernel} @ {ln.where}",
                    f"{ln.smem(p)} B dynamic shared memory at {ln.args} > "
                    f"{SMEM_BLOCK} B"))
    return out


def smem_query_violations(launches: Sequence[Launch], lib) -> List[Violation]:
    """On the card: each Python restatement equals the library's own
    ``repro_*_smem`` query at every distinct launch shape, in bf16 and in
    f32 where the wrapper and launcher take it."""
    from repro_torch.kernels.routed_ffn.ops import decode_ffn_max_d
    shapes = set(launches) | {dataclasses.replace(ln, args=(4,) + ln.args[1:])
                              for ln in launches}
    out = []
    for ln in sorted(shapes, key=lambda x: (x.kernel, x.args)):
        a = ln.args
        if ((ln.kernel == "decode_ffn"
             and a[2] > decode_ffn_max_d(a[1] * a[3], a[0]))
                or (ln.kernel == "grouped_ffn" and a[0] == 4
                    and not _f32_rows(a[1], a[2], a[3]))):
            continue                  # refused by the wrapper or launcher
        code = 1 if ln.args[0] == 2 else 0
        a = ln.args[1:]
        if ln.kernel == "decode_ffn":
            got = [lib.repro_decode_ffn_smem(code, *a, p) for p in range(3)]
            want = list(decode_ffn_smem(*ln.args))
        elif ln.kernel == "topl_thresholds":
            if ln.args[0] != 4:
                continue              # int32 codes only
            got = [lib.repro_topl_thresholds_smem(*a)]
            want = [ln.smem()]
        else:
            fn = getattr(lib, f"repro_{ln.kernel}_smem")
            got, want = [fn(code, *a)], [ln.smem()]
        if got != want:
            out.append(Violation(
                "kernel.smem", f"{ln.kernel} @ {ln.where}",
                f"the library asks for {got} B at {ln.args}, the audit's "
                f"restatement says {want}"))
    return out


_MMA = re.compile(r'"\s*((?:wgmma\.mma_async|mma\.sync)[\w.]*)')


def accum_dtype_violations(csrc: Optional[Path] = None,
                           sources: Optional[Dict[str, str]] = None
                           ) -> List[Violation]:
    """Every inline ``wgmma.mma_async...`` / ``mma.sync...`` instruction
    string in the kernel sources names an f32 accumulator: its type
    suffixes start with ``.f32`` (``.f32.bf16.bf16`` for wgmma,
    ``.f32.bf16.bf16.f32`` for mma)."""
    if sources is None:
        csrc = kernels.CSRC if csrc is None else csrc
        sources = {p.name: p.read_text()
                   for p in sorted(csrc.iterdir())
                   if p.suffix in (".cu", ".cuh")}
    out, seen = [], 0
    for name, text in sources.items():
        for i, line in enumerate(text.splitlines(), 1):
            for m in _MMA.finditer(line):
                seen += 1
                parts = m.group(1).split(".")
                types = [p for p in parts if re.fullmatch(
                    r"(f|bf|s|u|e4m|e5m|tf)\d+\w*", p)]
                if not types or types[0] != "f32":
                    out.append(Violation(
                        "kernel.accum-dtype", f"{name}:{i}",
                        f"{m.group(1)} accumulates in "
                        f"{types[0] if types else '?'}, not f32"))
    if not seen:
        out.append(Violation("kernel.no-kernel", "csrc",
                             "no wgmma / mma instruction found in the "
                             "sources — the accumulator scan is vacuous"))
    return out


def audit_build(build_dir: Optional[Path] = None, lib=None
                ) -> Tuple[List[KernelUsage], List[Violation]]:
    """The card's audit of a verbose build (chip_smoke.py phase 29 (a),
    ``--device cuda``): every kernel function's resources against
    Hopper's limits at the registry's shapes, and (``lib``) the launchers'
    own shared-memory queries against the restatements."""
    rows = ptxas_usage(build_dir)
    launches, out = registry_sweep()
    sources = sorted({r.source for r in rows})
    threads = {s: launch_threads(s) for s in sources}
    out += resource_violations(rows, launches, threads)
    if lib is not None:
        out += smem_query_violations(launches, lib)
    return rows, out + accum_dtype_violations()


@audit("kernels")
def _kernel_audit() -> List[Violation]:
    from repro_torch.analysis import op_audit
    if op_audit.DEVICE == "cuda":        # the CLI built it verbose first
        return audit_build(lib=kernels.library())[1]
    launches, out = registry_sweep()
    return out + launch_violations(launches) + accum_dtype_violations()
