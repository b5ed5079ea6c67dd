"""Data pipeline: deterministic synthetic corpora + packing (numpy only).

A copy of the JAX package's ``data/pipeline.py`` (which imports no JAX),
kept in the port so that it imports nothing of the JAX package.  Two
sources, deterministic by seed:
  * ``markov_stream`` — a low-entropy token Markov chain that models can
    learn (the stand-in for Wikitext-103);
  * ``random_stream`` — i.i.d. uniform tokens (the paper's "Random" set).
Packing yields {tokens, labels} with labels[t] = tokens[t+1].  Under
data parallelism every rank draws the same seeded stream and takes its
rows of each global batch (``rank_rows``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    kind: str = "markov"          # markov | random
    seed: int = 0
    branching: int = 4            # markov out-degree (lower = easier)


def markov_stream(cfg: DataConfig, steps: int) -> Iterator[np.ndarray]:
    """Yields (global_batch, seq_len + 1) int32 token blocks."""
    rng = np.random.default_rng(cfg.seed)
    v = cfg.vocab_size
    nexts = rng.integers(0, v, size=(v, cfg.branching), dtype=np.int64)
    probs = rng.dirichlet(np.ones(cfg.branching) * 0.5, size=v)
    state = rng.integers(0, v, size=cfg.global_batch)
    for _ in range(steps):
        out = np.empty((cfg.global_batch, cfg.seq_len + 1), dtype=np.int32)
        for t in range(cfg.seq_len + 1):
            out[:, t] = state
            choice = (rng.random(cfg.global_batch)[:, None]
                      > np.cumsum(probs[state], axis=1)).sum(axis=1)
            choice = np.minimum(choice, cfg.branching - 1)
            state = nexts[state, choice]
        yield out


def random_stream(cfg: DataConfig, steps: int) -> Iterator[np.ndarray]:
    rng = np.random.default_rng(cfg.seed)
    for _ in range(steps):
        yield rng.integers(0, cfg.vocab_size,
                           size=(cfg.global_batch, cfg.seq_len + 1),
                           dtype=np.int32)


def pack_batches(blocks: Iterator[np.ndarray]
                 ) -> Iterator[Dict[str, np.ndarray]]:
    for block in blocks:
        tokens = block[:, :-1]
        labels = block[:, 1:].copy()
        yield {"tokens": tokens, "labels": labels}


def synthetic_dataset(cfg: DataConfig, steps: int
                      ) -> Iterator[Dict[str, np.ndarray]]:
    src = markov_stream if cfg.kind == "markov" else random_stream
    return pack_batches(src(cfg, steps))


def rank_rows(batch: Dict[str, np.ndarray], rank: int, size: int
              ) -> Dict[str, np.ndarray]:
    """Data rank ``rank``'s rows of a global batch: the row block
    [rank * B / size, (rank + 1) * B / size) of every input, as JAX's
    batch spec ("batch", None) places them over the data axes."""
    out = {}
    for k, v in batch.items():
        b = np.shape(v)[0]
        if b % size:
            raise ValueError(f"a global batch of {b} rows does not split "
                             f"over {size} data ranks")
        out[k] = v[rank * (b // size):(rank + 1) * (b // size)]
    return out
