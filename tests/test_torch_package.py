"""Package rules of the PyTorch port: no JAX or JAX-package import in
``src/repro_torch`` or ``chip_smoke.py``; config field names equal the
JAX package's; entry points run on CUDA unless asked for the CPU (and
raise without a card); every kernel module imports without nvcc and
builds nothing at import; weights load from the JAX tree layout."""
import ast
import dataclasses
import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.configs import shapes as jshapes
from repro.core import lora as jlora
from repro.data.pipeline import DataConfig as JDataConfig
from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
from repro.train.state import model_defs as jmodel_defs
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs, kernels
from repro_torch.configs import base, shapes
from repro_torch.core import lora
from repro_torch.core.params import from_numpy_tree
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.state import model_defs
from repro_torch.train.trainer import TrainerConfig
from repro_torch.models import transformer
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    """The package (its analysis layer too), chip_smoke.py, the port's
    examples and its scripts."""
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("torch_*.py"))
             + sorted((ROOT / "scripts").glob("torch_*.py")))
    assert len(files) > 20
    assert {f.name for f in files} >= {
        "op_audit.py", "kernel_audit.py", "torch_quickstart.py",
        "torch_serve_batch.py", "torch_finetune_lm.py",
        "torch_sparsity_tradeoff.py", "torch_update_baselines.py",
        "torch_kernel_ab.py"}
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] == "jax" or m == "repro"
           or m.startswith("repro.")]
    assert not bad


def test_every_port_module_imports_with_jax_and_repro_blocked():
    """Each module of the package imports in a fresh interpreter where
    ``import jax`` and ``import repro`` fail."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert {'repro_torch.serving.kv_pages',\n"
        "        'repro_torch.models.paged_fallback'} <= set(names)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ,
                                         "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 32


@pytest.mark.parametrize("port_cls,jax_cls", [
    (base.ModelConfig, jbase.ModelConfig),
    (base.SPTConfig, jbase.SPTConfig),
    (lora.LoRAConfig, jlora.LoRAConfig),
    (OptimizerConfig, JOptimizerConfig),
    (TrainerConfig, JTrainerConfig),
    (DataConfig, JDataConfig),
])
def test_config_field_names_match_jax(port_cls, jax_cls):
    names = lambda c: [f.name for f in dataclasses.fields(c)]
    assert names(port_cls) == names(jax_cls)


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.LM.init(cfg)
    model = transformer.LM.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, model)
    assert Engine(cfg, model, device="cpu").device.type == "cpu"
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen3-0.6b", "--smoke"])


def test_kernel_modules_import_without_nvcc_and_build_nothing():
    pkg = importlib.import_module("repro_torch.kernels")
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   "repro_torch.kernels.")]
    for name in names:
        importlib.import_module(name)
    assert {"repro_torch.kernels.sparse_attention.ops",
            "repro_torch.kernels.routed_ffn.ops",
            "repro_torch.kernels.pq_quantize.ops",
            "repro_torch.kernels.topl_select.ops"} <= set(names)
    assert kernels._lib is None                          # nothing built
    assert sorted(p.name for p in kernels.CSRC.glob("*.cu")) == [
        "decode_ffn.cu", "dense_decode_paged.cu", "grouped_ffn.cu",
        "pq_assign.cu", "sparse_attention.cu", "sparse_decode.cu",
        "sparse_decode_two_pass.cu", "topl_thresholds.cu"]
    assert [w.__name__ for w in kernels.wrappers()] == [
        "pq_assign", "topl_thresholds", "decode_topl_thresholds",
        "sparse_attention", "sparse_decode_attention",
        "fused_sparse_decode_attention",
        "fused_sparse_decode_attention_paged",
        "dense_decode_attention_paged", "grouped_ffn", "decode_ffn"]
    assert set(kernels.SIGNATURES) == {
        "repro_" + n for n in ("pq_assign", "topl_thresholds",
                               "decode_thresholds", "sparse_attention",
                               "sparse_decode_attention",
                               "fused_sparse_decode",
                               "fused_sparse_decode_paged",
                               "dense_decode_paged", "grouped_ffn",
                               "grouped_ffn_h_elems", "decode_ffn",
                               "pq_assign_smem", "topl_thresholds_smem",
                               "sparse_attention_smem", "grouped_ffn_smem",
                               "decode_ffn_smem")}


def test_cpu_tensors_take_the_plain_versions_without_counting():
    from repro_torch.kernels.routed_ffn import ops
    before = [w.launches for w in kernels.wrappers()]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, generator=g)
    w_in, w_out = torch.randn(2, 8, 4, generator=g), torch.randn(2, 4, 8,
                                                                 generator=g)
    choice = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    gate = torch.ones(2, 2)
    y = ops.decode_ffn(x, choice, gate, w_in, w_out, act="relu")
    want = sum(torch.relu(x @ w_in[i]) @ w_out[i] for i in range(2))
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    assert [w.launches for w in kernels.wrappers()] == before


def test_from_numpy_tree_loads_bf16_and_sets_frozen_flags():
    cfg = configs.get_smoke("qwen3-0.6b")
    defs = transformer.lm_defs(cfg)
    rng = np.random.default_rng(0)

    def make(d):
        if isinstance(d, dict):
            return {k: make(v) for k, v in d.items()}
        a = rng.standard_normal(d.shape).astype(np.float32)
        return (np.asarray(jnp.asarray(a, jnp.bfloat16))
                if d.dtype == torch.bfloat16 else a)
    tree = make(defs)
    model = transformer.LM(cfg, from_numpy_tree(tree, "cpu"), device="cpu")
    emb = model.embed["embedding"]
    assert emb.dtype == torch.bfloat16 and not emb.requires_grad
    np.testing.assert_array_equal(
        emb.float().numpy(), np.asarray(tree["embed"]["embedding"], np.float32))
    wq = model.units[1]["b0_attn"]["mixer"]["wq"]
    assert not wq["w"].requires_grad and wq["lora"]["b"].requires_grad
    np.testing.assert_array_equal(
        wq["lora"]["b"].detach().numpy(),
        tree["units"]["b0_attn"]["mixer"]["wq"]["lora"]["b"][1])
    f32 = from_numpy_tree(tree, "cpu", {"bfloat16": torch.float32})
    assert f32["embed"]["embedding"].dtype == torch.float32


# ------------------------------------------------------------ registry
def test_registry_holds_the_jax_packages_ten_archs():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert len(configs.ARCH_NAMES) == 10
    assert configs.SHAPES == tuple(base.ShapeSpec(*dataclasses.astuple(s))
                                   for s in jconfigs.SHAPES)


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_every_arch_is_admitted_and_has_defs(name):
    """_check_supported admits every assigned arch; its param defs (the
    encoder-decoder's for audio) hold the JAX package's leaf shapes."""
    cfg = configs.get_smoke(name)
    transformer._check_supported(cfg)
    got = {p: tuple(d.shape) for p, d in _def_leaves(model_defs(cfg))}
    want = {p: tuple(d.shape) for p, d in _def_leaves(
        jmodel_defs(jconfigs.get_smoke(name)))}
    assert got == want


def _def_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _def_leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_input_specs_match_jax(name):
    """(shape, dtype) of every input of every shape cell equals JAX's
    ShapeDtypeStruct, the family rules included (audio: decoder tokens
    and separate frames; vlm: text = seq - frontend rows)."""
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    for spec, jspec in zip(configs.SHAPES, jconfigs.SHAPES):
        got = shapes.input_specs(cfg, spec, batch_override=2)
        want = jshapes.input_specs(jcfg, jspec, batch_override=2)
        assert set(got) == set(want)
        for k, s in got.items():
            assert s.shape == tuple(want[k].shape), (k, s.shape)
            assert str(s.dtype).split(".")[-1] == str(want[k].dtype), k
