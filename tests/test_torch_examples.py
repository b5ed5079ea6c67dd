"""The four examples of the PyTorch port (``examples/torch_*.py``), each
run in process through its ``main(argv)`` with ``--device cpu`` at its
smallest arguments: the JAX example's output keys and finite losses.
Quickstart and finetune_lm also show falling losses: their corpus is
replaced by one seeded batch repeated, so two logged points a few steps
apart compare the same batch (on a fresh batch each step the fall of ten
steps at these sizes is inside the batches' spread)."""
import dataclasses
import importlib.util
import itertools
import json
import math
import re
from pathlib import Path

import pytest

from repro_torch import configs
from repro_torch.data import pipeline
from test_torch_model import keep_sigterm, one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def repeated_batch(cfg, steps):
    """The example's corpus cut to its first batch, repeated."""
    return itertools.repeat(next(pipeline.synthetic_dataset(cfg, 1)), steps)


def last_json(text):
    """The JSON document that ends ``text`` (pretty-printed)."""
    start = max(text.rfind("\n{"), text.rfind("\n["))
    return json.loads(text[start + 1:])


def test_quickstart(capsys, monkeypatch):
    mod = load("torch_quickstart")
    monkeypatch.setattr(mod, "synthetic_dataset", repeated_batch)
    mod.main(["--device", "cpu", "--steps", "10"])
    out = capsys.readouterr().out
    assert "[UPGRADE]" in out and "params: total=" in out
    losses = [float(m) for m in re.findall(r"step +\d+ +loss=([\d.]+)",
                                           out)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    ms = re.findall(r"^ +(full|lora|spt): (\d+) ms/step \(CPU wall\)", out,
                    re.M)
    assert [v for v, _ in ms] == ["full", "lora", "spt"]


def test_serve_batch(capsys):
    load("torch_serve_batch").main(["--device", "cpu"])
    blob = last_json(capsys.readouterr().out)
    for key in ("arch", "requests", "slots", "completions", "prefill_tok_s",
                "decode_tok_s", "ttft_p50_s", "tpot_p50_s", "admitted"):
        assert key in blob, key
    assert blob["completed"] == blob["requests"] == 8
    assert [c["uid"] for c in blob["completions"]] == list(range(8))
    for c in blob["completions"]:
        assert set(c) == {"uid", "prompt_len", "reason", "tokens"}
        assert c["reason"] == "length" and len(c["tokens"]) == 10


def test_finetune_lm_resumes(capsys, tmp_path, monkeypatch):
    """JAX's flags and keys on a tiny override of its 12-layer model: the
    preempted half is checkpointed, the restart resumes from it."""
    mod = load("torch_finetune_lm")
    full = mod.model_100m()
    assert (full.num_layers, full.d_model, full.vocab_size) == (12, 512,
                                                                32000)
    assert (full.spt.attn_impl, full.spt.ffn_impl) == ("pallas", "pallas")
    monkeypatch.setattr(mod, "synthetic_dataset", repeated_batch)
    monkeypatch.setattr(mod, "model_100m", lambda: dataclasses.replace(
        configs.get_smoke("qwen3-0.6b"), name="qwen3-tiny").with_spt(
            attn_min_l=16, chunk_q=128, attn_impl="pallas",
            ffn_impl="pallas"))
    mod.main(["--device", "cpu", "--steps", "40", "--batch", "2", "--seq",
              "32", "--resume-demo", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "simulated preemption at step 20" in out
    assert "starting from step 20" in out
    blob = last_json(out)
    assert set(blob) == {"final_step", "first", "last", "straggler"}
    assert blob["final_step"] == 40
    first, last = blob["first"], blob["last"]
    assert (first["step"], last["step"]) == (30, 40)
    assert math.isfinite(first["loss"]) and math.isfinite(last["loss"])
    assert last["loss"] < first["loss"]
    assert blob["straggler"]["steps"] == 20


def test_sparsity_tradeoff(capsys):
    load("torch_sparsity_tradeoff").main(["--device", "cpu", "--steps",
                                          "1"])
    rows = last_json(capsys.readouterr().out)
    assert [r["setting"] for r in rows] == [
        "dense (LoRA)", "mha 1/4", "mha 1/8", "ffn 3/4", "ffn 1/2",
        "spt (1/8 + 1/2)"]
    for r in rows:
        assert set(r) == {"setting", "loss", "ppl", "acc"}
        assert math.isfinite(r["loss"]) and r["ppl"] > 1


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_batch",
                                  "torch_finetune_lm",
                                  "torch_sparsity_tradeoff"])
def test_examples_default_to_the_card(name):
    """``--device`` defaults to cuda, as the launchers do: without a card
    the example raises before it does any work."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA|cuda"):
        load(name).main(["--steps", "1"] if name != "torch_serve_batch"
                        else [])
