"""Plain torch version of the PQ assignment kernel's function: the core
oracle ``core.pq.assign`` (f32 ``||c||^2 - 2 x.c``, first index wins a
tie).  The CPU tests hold it to the JAX kernel; ``chip_smoke.py`` holds
the CUDA kernel (csrc/pq_assign.cu) to it.
"""
from __future__ import annotations

import torch

from repro_torch.core import pq


def pq_assign_ref(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """x: (G, n, d) -> (G, n, M) int32."""
    return pq.assign(x, codebooks)
