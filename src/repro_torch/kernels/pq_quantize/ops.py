"""Public PQ assignment op (train/prefill sparse MHA, paper §5.1).

Codes are integer outputs with no gradient; the op is non-differentiable
by construction, as in the JAX package (the codebooks train through the
quantization-error loss on the plain path).
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import cost
from repro_torch.kernels.pq_quantize.ref import pq_assign_ref

CODE_DIM_MAX = 32       # d' the kernel takes
CODEBOOK_MAX = 8192     # M * E * d' floats it stages in shared memory
NORMS_MAX = 1024        # M * E squared norms it stages


def check_pq_args(x: torch.Tensor, codebooks: torch.Tensor) -> None:
    """Kernel 1's input contract, checked before anything is built or
    launched: x (..., n, M d'), float32 codebooks (M, E, d') within the
    limits the kernel stages in shared memory."""
    name = "pq_assign"
    m, e, dp = codebooks.shape
    if x.shape[-1] != m * dp or codebooks.dtype != torch.float32:
        raise ValueError(f"{name}: x {tuple(x.shape)} vs float32 codebooks "
                         f"{tuple(codebooks.shape)}")
    if dp > CODE_DIM_MAX or m * e > NORMS_MAX or m * e * dp > CODEBOOK_MAX:
        raise ValueError(f"{name}: codebooks {tuple(codebooks.shape)} beyond "
                         f"the staged limits (d' <= {CODE_DIM_MAX}, M * E <= "
                         f"{NORMS_MAX}, M * E * d' <= {CODEBOOK_MAX})")


@cost.counted("pq_assign")
def pq_assign(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """x: (..., n, d) float32 or bfloat16; codebooks: (M, E, d') float32.
    Returns (..., n, M) int32 codes.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (csrc/pq_assign.cu); meta tensors get
    the codes' shape."""
    if kernels.target(x) == "cpu":
        lead = x.shape[:-2]
        out = pq_assign_ref(x.reshape(-1, *x.shape[-2:]), codebooks)
        return out.reshape(*lead, *out.shape[-2:]).contiguous()
    name = "pq_assign"
    kernels.require_cuda(name, x, codebooks)
    check_pq_args(x, codebooks)
    m, e, dp = codebooks.shape
    rows = x.numel() // x.shape[-1]
    codes = torch.empty((*x.shape[:-1], m), dtype=torch.int32,
                        device=x.device)
    if x.is_meta:
        return codes
    err = kernels.library().repro_pq_assign(
        kernels.dtype_code(x), x.data_ptr(), codebooks.data_ptr(),
        codes.data_ptr(), rows, m, e, dp, kernels.stream_ptr())
    kernels.check(err, name)
    pq_assign.launches += 1
    return codes


pq_assign.launches = 0
