"""Hand-written Hopper (sm_90a) kernels of the port, and their loader.

Each kernel directory mirrors the JAX package's:
  ref.py — the plain torch version of the kernel's function (the CPU tests
           use it, and ``chip_smoke.py`` holds the kernel against it)
  ops.py — the public wrapper: a CPU tensor takes the plain version, a
           CUDA tensor launches the CUDA kernel or raises (never a silent
           fallback), a meta tensor (a dry run) takes the path of the
           device it stands for (``target``): the plain version, or
           outputs and scratch of the CUDA branch's shapes with nothing
           launched; each launching
           wrapper counts its launches in a plain integer attribute
           ``launches``, and records its cost (``cost.py``) into an active
           roofline counter.
The CUDA C++ sources live in ``csrc/``.  Nothing is built at import:
``library()`` compiles them on first use with nvcc (one object per source,
all started together, then one shared library linked into
``build/repro_torch/`` at the repository root) and binds it with ctypes.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the exported launchers (csrc/*.cu); each returns the
# cudaError_t of its launch.
SIGNATURES = {
    "repro_fused_sparse_decode": ([_I] + [_P] * 10 + [_I] * 9
                                  + [_F] + [_I] * 3 + [_P]),
    "repro_grouped_ffn": [_I] + [_P] * 13 + [_I] * 7 + [_F, _I, _P],
    "repro_grouped_ffn_h_elems": [_I] * 4,
    "repro_decode_ffn": [_I] + [_P] * 14 + [_I] * 6 + [_F, _I, _P],
    "repro_pq_assign": [_I] + [_P] * 3 + [ctypes.c_longlong] + [_I] * 3
                       + [_P],
    "repro_topl_thresholds": [_P] * 3 + [_I] * 11 + [_P],
    "repro_sparse_attention": [_I] + [_P] * 7 + [_I] * 7 + [_F] + [_I] * 4
                              + [_P],
    "repro_fused_sparse_decode_paged": ([_I] + [_P] * 11 + [_I] * 10
                                        + [_F] + [_I] * 3 + [_P]),
    "repro_decode_thresholds": [_P] * 7 + [_I] * 10 + [_P],
    "repro_sparse_decode_attention": ([_I] + [_P] * 11 + [_I] * 7
                                      + [_F] + [_I] * 3 + [_P]),
    "repro_dense_decode_paged": [_I] + [_P] * 7 + [_I] * 6 + [_F] + [_I] * 3
                                + [_P],
    # the dynamic shared memory each launcher asks for (analysis/
    # kernel_audit.py holds its Python restatements to these)
    "repro_pq_assign_smem": [_I] * 4,
    "repro_topl_thresholds_smem": [_I],
    "repro_sparse_attention_smem": [_I] * 3,
    "repro_grouped_ffn_smem": [_I] * 4,
    "repro_decode_ffn_smem": [_I] * 7,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# The device a meta tensor stands for (a dry run's target, launch/
# dryrun.py): "cuda" unless a trace asks for the CPU's path.
_META_TARGET = "cuda"


def target(t) -> str:
    """The path a tensor takes where the port's code depends on the
    device: "cpu" for a CPU tensor, "cuda" for a card's, and for a meta
    tensor the device it stands for (``meta_target``), so that a dry run
    traces the path that device really runs."""
    kind = t.device.type
    return _META_TARGET if kind == "meta" else kind


@contextlib.contextmanager
def meta_target(device: str):
    """Meta tensors stand for ``device`` ("cuda" or "cpu") inside."""
    global _META_TARGET
    if device not in ("cuda", "cpu"):
        raise ValueError(f"a dry run targets cuda or cpu, not {device!r}")
    prev, _META_TARGET = _META_TARGET, device
    try:
        yield
    finally:
        _META_TARGET = prev


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return nvcc


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into one shared library (skipped when a library
    built from the same sources and flags exists) and return its path.
    verbose: print nvcc's output, with ptxas's registers and shared memory
    of every kernel (-Xptxas -v), and keep it as build/.../<source>.log."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode() + f.read_bytes())
    lib_path = BUILD_DIR / f"libreprotorch_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, obj, p in procs:
        out, _ = p.communicate()
        text = out.decode(errors="replace")
        if verbose:
            obj.with_suffix(".log").write_text(text)
        if verbose or p.returncode:
            print(text, flush=True)
        if p.returncode:
            errors.append(src.name)
    if errors:
        raise RuntimeError(f"nvcc failed on {errors}")
    tmp = lib_path.with_suffix(".tmp")
    subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                    *(str(o) for _, o, _ in procs)], check=True)
    tmp.replace(lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The built kernel library, compiled on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a launcher returned a nonzero cudaError_t."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")


def dtype_code(t) -> int:
    """The launchers' element-type code of a float tensor."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return codes[t.dtype]


def require_cuda(name: str, *tensors) -> None:
    """The CUDA path's input contract: every tensor on one card and
    contiguous (the kernels compute their own offsets)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous inputs")


def require_aligned(name: str, *tensors) -> None:
    """Row-vector loads need 16-byte aligned data (a contiguous view may
    start inside its storage)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: needs 16-byte aligned inputs")


_arrive = {}


def arrival_counters(n: int, device):
    """(>= n,) int32 zeros on ``device``: the per-kv-group arrival counts
    of the decode threshold kernel (the last block of a group to finish
    reduces it).  Every launch leaves them zero, so one buffer serves all
    launches in stream order."""
    import torch
    buf = _arrive.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _arrive[device] = buf
    return buf


DECODE_TILE = 128             # slots per tile of the decode kernels
DECODE_BLOCKS = 1056         # ~8 blocks per SM of the H100's 132
DECODE_CHUNK = 32            # list rows a ring stage of the attention pass
DECODE_RING_BYTES = 49152    # a 3-stage ring when it fits, else 2 stages


DECODE_R_MAX = 16            # query heads per kv head of the decode kernels
DECODE_M_MAX = 32            # PQ books they score
DECODE_D_MAX = 256           # head dim (a multiple of 8)


def decode_hist_room(r: int) -> int:
    """Histogram buckets, R_out x (max_score + 1), that the decode passes
    hold for r query rows per kv head: 8 x 33 in the R <= 8 instances,
    16 x 33 in the 16-row ones (csrc/decode_attention.cuh, hist_room)."""
    return 264 if r <= 8 else DECODE_R_MAX * (DECODE_M_MAX + 1)


def check_decode_args(name: str, r: int, *, dh: Optional[int] = None,
                      m: Optional[int] = None, buckets: int = 0) -> None:
    """The decode kernels' (3, 5-8) contract on R query rows per kv head,
    the head dim, the PQ books and the histogram buckets, checked before
    anything is built or launched (the launchers refuse the same shapes
    with cudaErrorInvalidValue)."""
    if not 1 <= r <= DECODE_R_MAX:
        raise ValueError(f"{name}: takes 1 to {DECODE_R_MAX} query heads "
                         f"per kv head, got R = {r}")
    if dh is not None and (dh % 8 or not 8 <= dh <= DECODE_D_MAX):
        raise ValueError(f"{name}: head dim {dh} is not a multiple of 8 in "
                         f"[8, {DECODE_D_MAX}]")
    if m is not None and not 1 <= m <= DECODE_M_MAX:
        raise ValueError(f"{name}: takes 1 to {DECODE_M_MAX} PQ books, got "
                         f"M = {m}")
    if buckets > decode_hist_room(r):
        raise ValueError(f"{name}: {buckets} histogram buckets (R_out x "
                         f"(max_score + 1)) past the {decode_hist_room(r)} "
                         f"the kernels hold at R = {r}")


def decode_splits(g: int, s: int):
    """(ns, sp): the decode kernels cut the S-slot cache of each of the g
    kv groups into ns splits of sp slots (a tile multiple) so that g * ns
    blocks fill the card.  Every decode kernel over the same (g, s) uses
    the same splits, which keeps the tiers bit-identical."""
    tiles = -(-s // DECODE_TILE)
    ns = max(1, min(tiles, -(-DECODE_BLOCKS // g)))
    sp = -(-tiles // ns) * DECODE_TILE
    return -(-s // sp), sp


def decode_stages(dh: int, elem_bytes: int) -> int:
    """Ring stages of the decode attention pass for K and V rows of dh
    elements of elem_bytes: 3 when three stages of DECODE_CHUNK rows fit
    DECODE_RING_BYTES (bf16 up to dh = 128), else 2 (at most 128 KB, f32
    at dh = 256).  The stage count moves no sum, only how many chunks are
    in flight."""
    stage = DECODE_CHUNK * 2 * dh * elem_bytes
    return 3 if 3 * stage <= DECODE_RING_BYTES else 2


def act_code(act: str) -> int:
    return {"relu": 0, "gelu": 1, "silu": 2}[act]


def stream_ptr() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def wrappers():
    """The launching wrappers of every ported kernel, in the order of the
    TPU kernels they replace (their ``launches`` counters are what a run
    reads to show it went through the kernels)."""
    from repro_torch.kernels.pq_quantize import ops as pq_ops
    from repro_torch.kernels.routed_ffn import ops as rffn_ops
    from repro_torch.kernels.sparse_attention import ops as sa_ops
    from repro_torch.kernels.topl_select import ops as topl_ops
    return [pq_ops.pq_assign, topl_ops.topl_thresholds,
            topl_ops.decode_topl_thresholds, sa_ops.sparse_attention,
            sa_ops.sparse_decode_attention,
            sa_ops.fused_sparse_decode_attention,
            sa_ops.fused_sparse_decode_attention_paged,
            sa_ops.dense_decode_attention_paged, rffn_ops.grouped_ffn,
            rffn_ops.decode_ffn]
