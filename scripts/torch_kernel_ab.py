#!/usr/bin/env python3
"""A/B timing of two builds of the PyTorch port's kernels on one CUDA
card.  Either the train-path kernels, PQ assignment (kernel 1,
csrc/pq_assign.cu), top-L thresholds (kernel 2, csrc/topl_thresholds.cu),
the thresholded attention (kernel 4, csrc/sparse_attention.cu) and the
grouped FFN (kernel 9, csrc/grouped_ffn.cu), this tree's against another
tree's:

    python3 scripts/torch_kernel_ab.py --base DIR [--rounds 3]

or the grouped routed FFN's two bf16 forms (kernel 9, csrc/grouped_ffn.cu)
at qwen3-0.6b's widths, where the library picks the resident body: this
tree's build against a copy of the source whose launcher always takes the
wide form (h through device memory), built into build/kernel_ab/:

    python3 scripts/torch_kernel_ab.py --ffn-forms [--rounds 3]

DIR holds another checkout of the repository (for example a parent commit
unpacked by ``git archive`` into the ignored ``build/`` directory).  Its
four sources, with its csrc/common.cuh, are built by nvcc into
build/kernel_ab/ and bound by ctypes with the C signatures this tree uses
(a base older than the kernels' whole contract: the two signatures it
had, ``BASE_SIGNATURES``).  Both builds are checked first on every case:
[t, need] equal to the plain version, PQ codes equal to it up to
chip_smoke.py's margin rule, attention and FFN outputs within its bf16
rule.  Then
every case is timed in turns, base, this, this, base, in each round (CUDA
events, L2 flushed: chip_smoke.time_ms), and one JSON line gives the
medians beside the card's name and power limit.  Cases: the training
step's shapes of chip_smoke.py phase 3 (q (64, 1024, d_head) bf16; codes
of 64 query / 32 kv groups, 1024 x 1024 causal, L = 128) at d_head 128,
64 and 80 (M = 16, 8, 10 books); kernel 4 at the first (bf16, its codes
from 16 codewords, passed as the train path passes them) and kernel 9 as
below.  Kernel 9's cases: the train step's 4 x 1024 rows and the (8,
1024) prefill bucket at d 1024, F 384, SwiGLU, LoRA r = 16, each form held
to the plain version on the kept slots first.
Imports nothing of JAX.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402  (the repository's timing helpers)

ENTRIES = ("repro_pq_assign", "repro_topl_thresholds",
           "repro_sparse_attention", "repro_grouped_ffn",
           "repro_grouped_ffn_h_elems")
SOURCES = ("pq_assign.cu", "topl_thresholds.cu", "sparse_attention.cu",
           "grouped_ffn.cu")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the two signatures before the kernels' whole contract (no code bound,
# no LoRA rank in the h scratch query)
BASE_SIGNATURES = {
    "repro_sparse_attention": [_I] + [_P] * 7 + [_I] * 7 + [_F] + [_I] * 3
                              + [_P],
    "repro_grouped_ffn_h_elems": [_I] * 3}


def bind(path, entries=ENTRIES, base=False):
    """The library at ``path`` with its launchers' C signatures: a base
    whose kernel 4 takes no code bound has BASE_SIGNATURES."""
    from repro_torch import kernels
    lib = ctypes.CDLL(str(path))
    old = base and "code_bound" not in (
        Path(path).parent / "base_sparse_attention.cu").read_text()
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes = (BASE_SIGNATURES[name] if old and name in
                       BASE_SIGNATURES else kernels.SIGNATURES[name])
        fn.restype = ctypes.c_int
    lib.old_signatures = old
    return lib


def build_base(base: Path) -> Path:
    from repro_torch import kernels
    csrc = base / "src" / "repro_torch" / "kernels" / "csrc"
    out = ROOT / "build" / "kernel_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libbase.so"
    (out / "base_sparse_attention.cu").write_text(
        (csrc / "sparse_attention.cu").read_text())
    procs = [subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-c",
                               "-I", str(csrc), "-o", str(out / f"{s}.o"),
                               str(csrc / s)]) for s in SOURCES]
    if any(p.wait() for p in procs):
        raise RuntimeError("the base's kernels did not build")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(lib), *(str(out / f"{s}.o") for s in SOURCES)],
                   check=True)
    return lib


def pq_call(lib, x, cb, out):
    from repro_torch import kernels
    m, e, dp = cb.shape
    kernels.check(lib.repro_pq_assign(
        kernels.dtype_code(x), x.data_ptr(), cb.data_ptr(), out.data_ptr(),
        x.numel() // x.shape[-1], m, e, dp, kernels.stream_ptr()),
        "pq_assign")
    return out


def topl_call(lib, cq, ck, thr, kw):
    from repro_torch import kernels
    g, nq, m = cq.shape
    kernels.check(lib.repro_topl_thresholds(
        cq.data_ptr(), ck.data_ptr(), thr.data_ptr(), g, nq, ck.shape[1], m,
        kw["heads_per_batch"], kw["rep"], kw["l"], kw["max_score"],
        int(kw["causal"]), 0, 0, kernels.stream_ptr()), "topl_thresholds")
    return thr


def attn_call(lib, args, out):
    """Kernel 4 through ``lib`` as ops.sparse_attention launches it on the
    train path (the code bound passed where the library takes one)."""
    from repro_torch import kernels
    q, k, v, cq, ck, thr, kw = args
    g, nq, dh = q.shape
    bound = [] if lib.old_signatures else [cs.E_WORDS]
    kernels.check(lib.repro_sparse_attention(
        kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        cq.data_ptr(), ck.data_ptr(), thr.data_ptr(), out.data_ptr(), g, nq,
        k.shape[1], dh, cq.shape[-1], kw["heads_per_batch"], kw["rep"],
        float(kw["scale"]), int(kw["causal"]), 0, 0, *bound,
        kernels.stream_ptr()), "sparse_attention")
    return out


def cases(torch, gen):
    """(kernel, case, run(lib), check(output) -> differing codes) at the
    training shapes."""
    from repro_torch.kernels.topl_select import ref
    out = []
    for dh in (cs.DH, 64, 80):
        m = dh // 8
        x = torch.randn(cs.TB * cs.HQ, cs.TS, dh, device="cuda",
                        generator=gen).to(torch.bfloat16)
        cb = cs._codebooks(torch, gen, m, cs.E_WORDS, 8)
        codes = torch.empty(*x.shape[:-1], m, dtype=torch.int32, device="cuda")

        def check(got, x=x, cb=cb, m=m):
            flips, _ = cs._margin_flips(torch, got, x, cb, f"M={m}")
            return flips
        out.append(("pq_assign", f"M={m}",
                    lambda lib, x=x, cb=cb, codes=codes: pq_call(
                        lib, x, cb, codes), check))
    for m in (cs.M_BOOKS, 8, 10):
        cq, ck = cs._train_codes(torch, gen, cs.TS, cs.TS, m=m)
        kw = dict(l=cs._top_l(cs.TS), max_score=m, causal=True, window=None,
                  q_offset=0, heads_per_batch=cs.HQ, rep=cs.HQ // cs.HK)
        thr = torch.empty(*cq.shape[:-1], 2, dtype=torch.int32, device="cuda")
        want = ref.thresholds_ref(cq, ck, **kw)

        def check(got, want=want, m=m):
            if not torch.equal(got, want):
                raise AssertionError(f"topl_thresholds M={m}: [t, need] differ")
            return 0
        out.append(("topl_thresholds", f"M={m}",
                    lambda lib, cq=cq, ck=ck, thr=thr, kw=kw: topl_call(
                        lib, cq, ck, thr, kw), check))
    from repro_torch.kernels.sparse_attention import ref as sa_ref
    cq, ck = cs._train_codes(torch, gen, cs.TS, cs.TS)
    q = torch.randn(cs.TB * cs.HQ, cs.TS, cs.DH, device="cuda",
                    generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(cs.TB * cs.HK, cs.TS, cs.DH, device="cuda",
                        generator=gen).to(torch.bfloat16) for _ in range(2))
    sel = dict(causal=True, window=None, q_offset=0, heads_per_batch=cs.HQ,
               rep=cs.HQ // cs.HK)
    thr = ref.thresholds_ref(cq, ck, l=cs._top_l(cs.TS),
                             max_score=cs.M_BOOKS, **sel)
    kw = dict(scale=cs.DH ** -0.5, **sel)
    want = sa_ref.sparse_attention_ref(q, k, v, cq, ck, thr, **kw)
    y = torch.empty_like(q)

    def check(got, want=want):
        cs.close(got, want, cs.BF16_TOL)
        return 0
    out.append(("sparse_attention", f"dh={cs.DH}",
                lambda lib, a=(q, k, v, cq, ck, thr, kw), y=y: attn_call(
                    lib, a, y), check))
    return out + ffn_cases(torch, gen)


FFN_ENTRIES = ("repro_grouped_ffn", "repro_grouped_ffn_h_elems")
RESIDENT_TEST = "return smem_bytes(d, F) <= 232448 &&"


def build_wide() -> Path:
    """This tree's csrc/grouped_ffn.cu with the resident body's test
    answering no, so every bf16 shape takes the wide form."""
    from repro_torch import kernels
    src = (kernels.CSRC / "grouped_ffn.cu").read_text()
    if src.count(RESIDENT_TEST) != 1:
        raise RuntimeError("grouped_ffn.cu: the resident-body test moved")
    out = ROOT / "build" / "kernel_ab"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "grouped_ffn_wide.cu"
    cu.write_text(src.replace(RESIDENT_TEST, "return false &&"))
    lib = out / "libwide.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I",
                    str(kernels.CSRC), "-o", str(lib), str(cu)], check=True)
    return lib


def ffn_call(lib, args):
    """Kernel 9 through ``lib`` as ops.grouped_ffn launches it."""
    from repro_torch import kernels
    from repro_torch.kernels.routed_ffn import ops
    x, index, wi, wo, wg, lora, scale = args
    b, s, d = x.shape
    _, g, c = index.shape
    f = wi.shape[-1]
    lo, r = ops._lora_leaves(lora, wg is not None, x.dtype, 8)
    n = lib.repro_grouped_ffn_h_elems(kernels.dtype_code(x), d, f,
                                      *([] if lib.old_signatures else [r]))
    h = x.new_empty(b * g * c * n) if n else None
    y = x.new_empty((b, g, c, d))
    kernels.check(lib.repro_grouped_ffn(
        kernels.dtype_code(x), x.data_ptr(), index.data_ptr(), wi.data_ptr(),
        wg.data_ptr(), wo.data_ptr(), *ops._ptrs(lo),
        None if h is None else h.data_ptr(), y.data_ptr(), b, s, d, g, c, f,
        r, float(scale), kernels.act_code("silu"), kernels.stream_ptr()),
        "grouped_ffn")
    return y


def ffn_cases(torch, gen):
    """(kernel, case, run(lib), check(output) -> 0) at qwen3's widths."""
    from repro_torch.kernels.routed_ffn import ref
    out = []
    for label, b, lens in (("train 4 x 1024", 4, None),
                           ("(8, 1024) bucket", 8, torch.randint(
                               128, 1025, (8,), device="cuda",
                               generator=gen))):
        case = cs._grouped_case(torch, gen, "bfloat16", b=b, s=cs.TS, d=1024,
                                f=384, g=8, ga=4, r=16, capf=1.25, act="silu",
                                gated=True, lens=lens)
        args = case["args"]
        ok = case["plan"].slot_ok[..., None]
        want = torch.where(ok, ref.grouped_ffn_ref(*args, act="silu").float(),
                           0.0)

        def check(got, ok=ok, want=want):
            cs.close(torch.where(ok, got.float(), 0.0), want, cs.BF16_TOL)
            return 0
        out.append(("grouped_ffn", label,
                    lambda lib, args=args: ffn_call(lib, args), check))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path,
                    help="checkout whose kernels 1, 2, 4 and 9 are the "
                         "baseline")
    ap.add_argument("--ffn-forms", action="store_true",
                    help="kernel 9: resident body (base) against the wide "
                         "form (this) at qwen3's widths")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    if (args.base is None) == (not args.ffn_forms):
        ap.error("give exactly one of --base and --ffn-forms")
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.ffn_forms:
        libs = {"base": bind(kernels.build(), FFN_ENTRIES),
                "this": bind(build_wide(), FFN_ENTRIES)}
        todo = ffn_cases(torch, gen)
    else:
        libs = {"base": bind(build_base(args.base.resolve()), base=True),
                "this": bind(kernels.build())}
        todo = cases(torch, gen)
    flips = {}
    for kernel, case, run, check in todo:
        for side, lib in libs.items():
            got = run(lib).clone()
            torch.cuda.synchronize()
            flips[f"{kernel} {case} {side}"] = check(got)
    times = {(k, c, side): [] for k, c, _, _ in todo for side in libs}
    for _ in range(args.rounds):
        for kernel, case, run, _ in todo:
            for side in ("base", "this", "this", "base"):
                times[(kernel, case, side)].append(
                    cs.time_ms(lambda: run(libs[side]), args.reps))
    rows = []
    for kernel, case, _, _ in todo:
        b = statistics.median(times[(kernel, case, "base")])
        t = statistics.median(times[(kernel, case, "this")])
        rows.append({"kernel": kernel, "case": case, "base_ms": b,
                     "this_ms": t, "speedup": b / t,
                     "base_all": times[(kernel, case, "base")],
                     "this_all": times[(kernel, case, "this")]})
        print(f"{kernel} {case}: base {b:.4f} ms, this {t:.4f} ms "
              f"({b / t:.2f}x)", flush=True)
    print(json.dumps({"card": cs.card_line(),
                      "base": ("resident body" if args.ffn_forms
                               else str(args.base)),
                      "rounds": args.rounds, "flips": flips, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
