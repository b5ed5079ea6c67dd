"""input_specs(): (shape, dtype) stand-ins for every model input of an
(arch x shape) cell, with no allocation; ``materialize`` draws concrete
inputs for them.

train/prefill  -> a token batch (+ the stub frontend embeddings)
decode         -> one new token per sequence and a position
Family rules: for ``audio`` (encoder-decoder) the sequence length is the
decoder's and the encoder frames are separate; for a ``vlm`` the
frontend rows and the text share the sequence length, so the text is
max(1, seq_len - frontend_tokens) tokens.
``abstract_inputs`` gives them as meta tensors at one rank's rows, for a
dry run (launch/dryrun.py).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _i32(*shape) -> TensorSpec:
    return TensorSpec(tuple(shape), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                batch_override: int = 0) -> Dict[str, TensorSpec]:
    b = batch_override or shape.global_batch
    s = shape.seq_len
    d = cfg.d_model
    fe = cfg.frontend_tokens
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, TensorSpec] = {}
        if cfg.family == "audio":        # enc-dec: seq applies to decoder
            specs["frontend_embeds"] = TensorSpec((b, fe, d), torch.bfloat16)
            specs["tokens"] = _i32(b, s)
        elif cfg.frontend:               # vlm: patches + text share seq_len
            specs["frontend_embeds"] = TensorSpec((b, fe, d), torch.bfloat16)
            specs["tokens"] = _i32(b, max(1, s - fe))
        else:
            specs["tokens"] = _i32(b, s)
        if shape.kind == "train":
            specs["labels"] = _i32(*specs["tokens"].shape)
        return specs
    if shape.kind == "decode":
        return {"token": _i32(b), "pos": _i32()}
    raise ValueError(shape.kind)


def materialize(specs: Dict[str, TensorSpec], generator: torch.Generator,
                vocab: int) -> Dict[str, torch.Tensor]:
    """Random concrete inputs matching the specs on the generator's
    device: token ids in [0, vocab), ``pos`` 0, floats standard normal
    cast to the spec's dtype.  Inputs are drawn in sorted-name order, so
    the generator's seed fixes them all."""
    dev = generator.device
    out = {}
    for name in sorted(specs):
        spec = specs[name]
        if not spec.dtype.is_floating_point:
            if name == "pos":
                out[name] = torch.zeros(spec.shape, dtype=spec.dtype,
                                        device=dev)
            else:
                out[name] = torch.randint(0, vocab, spec.shape,
                                          generator=generator, device=dev,
                                          dtype=spec.dtype)
        else:
            out[name] = torch.randn(spec.shape, generator=generator,
                                    device=dev).to(spec.dtype)
    return out


def abstract_inputs(specs: Dict[str, TensorSpec], data: int = 1,
                    replicate: bool = False) -> Dict[str, torch.Tensor]:
    """The inputs of ``specs`` as meta tensors (shapes, no data) as one
    rank of a mesh with ``data`` data ranks is given them: the rows (dim
    0) of every batch input divided over the data ranks (train/prefill,
    ``data/pipeline.rank_rows``; a decode batch's slots, the serving
    engine's), ``pos`` whole.  Rows that do not divide raise, as
    ``rank_rows`` does, unless ``replicate`` (the engine keeps slots that
    do not divide on every rank)."""
    out = {}
    for name, spec in specs.items():
        shape = tuple(spec.shape)
        if shape and data > 1:
            if shape[0] % data == 0:
                shape = (shape[0] // data,) + shape[1:]
            elif not replicate:
                raise ValueError(f"{name}: {shape[0]} rows do not split "
                                 f"over {data} data ranks")
        out[name] = torch.empty(shape, dtype=spec.dtype, device="meta")
    return out
