"""Hand-written Hopper (sm_90a) kernels of the port, and their loader.

Each kernel directory mirrors the JAX package's:
  ref.py — the plain torch version of the kernel's function (the CPU tests
           use it, and ``chip_smoke.py`` holds the kernel against it)
  ops.py — the public wrapper: a CPU tensor takes the plain version, a
           CUDA tensor launches the CUDA kernel or raises (never a silent
           fallback); each launching wrapper counts its launches in a
           plain integer attribute ``launches``.
The CUDA C++ sources live in ``csrc/``.  Nothing is built at import:
``library()`` compiles them on first use with nvcc (one object per source,
all started together, then one shared library linked into
``build/repro_torch/`` at the repository root) and binds it with ctypes.
"""
from __future__ import annotations

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
                                  + [_F, _I, _I, _P]),
    "repro_grouped_ffn": [_I] + [_P] * 12 + [_I] * 7 + [_F, _I, _P],
    "repro_decode_ffn": [_I] + [_P] * 14 + [_I] * 5 + [_F, _I, _P],
    "repro_pq_assign": [_I] + [_P] * 3 + [ctypes.c_longlong] + [_I] * 3
                       + [_P],
    "repro_topl_thresholds": [_P] * 3 + [_I] * 11 + [_P],
    "repro_sparse_attention": [_I] + [_P] * 7 + [_I] * 7 + [_F] + [_I] * 3
                              + [_P],
    "repro_fused_sparse_decode_paged": ([_I] + [_P] * 11 + [_I] * 10
                                        + [_F, _I, _I, _P]),
    "repro_decode_thresholds": [_P] * 5 + [_I] * 10 + [_P],
    "repro_sparse_decode_attention": ([_I] + [_P] * 10 + [_I] * 7
                                      + [_F, _I, _I, _P]),
    "repro_dense_decode_paged": [_I] + [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return nvcc


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into one shared library (skipped when a library
    built from the same sources and flags exists) and return its path."""
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
    for src, _, p in procs:
        out, _ = p.communicate()
        if verbose or p.returncode:
            print(out.decode(errors="replace"), flush=True)
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


DECODE_TILE = 128             # slots per tile of the decode kernels
DECODE_BLOCKS = 528          # ~4 blocks per SM of the H100's 132


def decode_splits(g: int, s: int):
    """(ns, sp): the decode kernels cut the S-slot cache of each of the g
    kv groups into ns splits of sp slots (a tile multiple) so that g * ns
    blocks fill the card.  Every decode kernel over the same (g, s) uses
    the same splits, which keeps the tiers bit-identical."""
    tiles = -(-s // DECODE_TILE)
    ns = max(1, min(tiles, -(-DECODE_BLOCKS // g)))
    sp = -(-tiles // ns) * DECODE_TILE
    return -(-s // sp), sp


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
