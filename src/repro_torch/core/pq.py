"""Product quantization (PQ) for sparse-MHA candidate selection (paper §4.1,
§5.1).  A head vector x in R^d is cut into M sub-vectors of size d' = d/M;
sub-vector m takes the index of its nearest codeword (L2) in codebook C^m
of E codewords.  The query/key similarity is the integer number of shared
codewords (paper Eq. 6): s(q, k) = sum_m 1[t_q^m == t_k^m] in {0..M}.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.core.dispatch import one_hot
from repro_torch.core.params import ParamDef


@dataclasses.dataclass(frozen=True)
class PQConfig:
    head_dim: int
    code_dim: int = 8           # d'
    num_codewords: int = 16     # E
    update_interval: int = 20

    @property
    def num_books(self) -> int:  # M
        if self.head_dim % self.code_dim:
            raise ValueError(f"head_dim {self.head_dim} not divisible by "
                             f"code_dim {self.code_dim}")
        return self.head_dim // self.code_dim


def param_defs(cfg: PQConfig) -> dict:
    """Codebooks shared by Q and K of one attention layer: (M, E, d')."""
    return {"codebooks": ParamDef(
        (cfg.num_books, cfg.num_codewords, cfg.code_dim), torch.float32,
        ("codebook", "codeword", "code_dim"), init="normal:1.0",
        trainable=True)}


def distances(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """``assign``'s distances ||c||^2 - 2 x.c of each sub-vector to each
    codeword, (..., n, M, E) float32, summed in its order."""
    m, e, dp = codebooks.shape
    *lead, n, d = x.shape
    if d != m * dp:
        raise ValueError(f"x {tuple(x.shape)} vs codebooks "
                         f"{tuple(codebooks.shape)}")
    xs = x.reshape(*lead, n, m, dp).float()
    cb = codebooks.float()
    dots = xs[..., 0:1] * cb[..., 0]                       # (..., n, M, E)
    c2 = cb[..., 0] * cb[..., 0]                           # (M, E)
    for j in range(1, dp):
        dots = dots + xs[..., j:j + 1] * cb[..., j]
        c2 = c2 + cb[..., j] * cb[..., j]
    return c2 - 2.0 * dots


def assign(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Nearest codeword per sub-vector, in the JAX form ||c||^2 - 2 x.c
    (||x||^2 is constant over the argmin) computed in float32.

    The sums over d' run in a fixed order, one rounded multiply and one
    rounded add per term (j = 0 .. d'-1), so the codes are the same on
    any device.  JAX's einsum, and the PQ assignment CUDA kernel (fused
    multiply-adds), sum in other orders, so their codes can differ from
    these only where two distances tie within rounding.

    x: (..., n, d) with d = M * d'; codebooks: (M, E, d')
    returns codes (..., n, M) int32 in [0, E)
    """
    return distances(x, codebooks).argmin(-1).to(torch.int32)


def quantization_error(x: torch.Tensor, codebooks: torch.Tensor,
                       codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared distance between vectors and their codewords (the DKM
    error of the ``qerr`` aux loss), f32.  x: (..., n, d)."""
    m, e, dp = codebooks.shape
    *lead, n, d = x.shape
    if codes is None:
        codes = assign(x, codebooks)
    xs = x.reshape(*lead, n, m, dp).float()
    books = torch.arange(m, device=x.device)
    sel = codebooks.float()[books, codes.long()]            # (..., n, M, d')
    return ((xs - sel) ** 2).sum(-1).mean()


def match_scores(codes_q: torch.Tensor, codes_k: torch.Tensor,
                 num_codewords: int) -> torch.Tensor:
    """Integer similarity as a one-hot inner product (exact: 0/1 products
    summing to <= M).  codes_q (..., nq, M), codes_k (..., nk, M) ->
    (..., nq, nk) float32 counts.  On the card the one-hots are bf16, whose
    product with f32 accumulation is exact for these small integers."""
    dt = (torch.bfloat16 if kernels.target(codes_q) == "cuda"
          else torch.float32)
    e = num_codewords
    oh_q = one_hot(codes_q, e, dt)
    oh_k = one_hot(codes_k, e, dt)
    oh_q = oh_q.flatten(-2)                                 # (..., nq, M*E)
    oh_k = oh_k.flatten(-2)                                 # (..., nk, M*E)
    return torch.matmul(oh_q, oh_k.transpose(-1, -2)).float()


def ema_update(codebooks: torch.Tensor, x: torch.Tensor,
               codes: Optional[torch.Tensor] = None,
               ema: float = 0.05) -> torch.Tensor:
    """One EMA k-means step: each codeword moves toward the mean of its
    assigned sub-vectors (codewords nobody chose stay put).  The caller
    applies it every ``update_interval`` steps (paper §5.1)."""
    m, e, dp = codebooks.shape
    xs = x.reshape(-1, m, dp).float()                       # (N, M, d')
    if codes is None:
        codes = assign(x.reshape(-1, m * dp), codebooks)
    oh = one_hot(codes.reshape(-1, m), e, torch.float32)    # (N, M, E)
    counts = oh.sum(0)                                      # (M, E)
    sums = torch.einsum("nme,nmd->med", oh, xs)
    means = sums / torch.clamp(counts[..., None], min=1.0)
    upd = torch.where(counts[..., None] > 0, means, codebooks)
    return (1.0 - ema) * codebooks + ema * upd


def _sample_rows(n: int, e: int, generator: torch.Generator) -> torch.Tensor:
    """e row indices of n: without replacement when n >= e (JAX's
    ``random.choice(replace=n < e)``), drawn from ``generator``."""
    dev = generator.device
    if n < e:
        return torch.randint(0, n, (e,), generator=generator, device=dev)
    return torch.randperm(n, generator=generator, device=dev)[:e]


def init_codebooks_from_data(x: torch.Tensor, cfg: PQConfig,
                             generator: torch.Generator) -> torch.Tensor:
    """k-means++-lite init: a random sample of x's sub-vectors as the
    codewords, (M, E, d') f32.  The draw comes from a torch Generator, so
    it picks other rows than JAX's key does; the contract is the same."""
    m, e, dp = cfg.num_books, cfg.num_codewords, cfg.code_dim
    xs = x.reshape(-1, m, dp).float()
    idx = _sample_rows(xs.shape[0], e, generator).to(xs.device)
    return xs[idx].transpose(0, 1).contiguous()
