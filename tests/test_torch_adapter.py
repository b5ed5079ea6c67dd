"""The port's Model Adapter (``core/adapter.py``) against the JAX
package's, on the h2o-danube-1.8b smoke config without its window (the
setting of tests/test_substrate.py's adapter test):

  * at identity settings (top_fraction 1, every group active, capacity 8,
    LoRA C zero) the adapted model's hidden states equal the dense
    model's, in f32 (1e-5);
  * from the same dense tree, every copied leaf and the re-blocked FFN
    weights equal JAX's bit for bit, the fresh leaves have JAX's shapes
    and dtypes, and the tree has JAX's paths in JAX's order;
  * ``upgrade_report`` gives JAX's lines.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import adapter as jadapter
from repro.launch.dryrun import apply_variant as japply_variant
from repro.models import transformer as jtransformer
from repro_torch.core import adapter
from repro_torch.core.params import from_numpy_tree, leaves
from repro_torch.models import transformer
from test_torch_model import np_init_tree, port_cfg


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(n)


def _cfgs(dtype=jnp.bfloat16):
    base = dataclasses.replace(jconfigs.get_smoke("h2o-danube-1.8b"),
                               window=None, dtype=dtype)
    spt = base.with_spt(attn_top_fraction=1.0, attn_min_l=1,
                        ffn_active_groups=base.spt.ffn_groups,
                        ffn_capacity_factor=8.0)
    return japply_variant(base, "full"), spt


def _dense_tree(jdense):
    return np_init_tree(jtransformer.lm_defs(jdense), 0)


def _paths(tree):
    return [tuple(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_adapter_preserves_function_at_identity_settings():
    jdense, jspt = _cfgs(jnp.float32)
    dense_cfg, spt_cfg = port_cfg(jdense), port_cfg(jspt)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  _dense_tree(jdense))
    dense = from_numpy_tree(tree, "cpu")
    adapted = adapter.adapt(dense, dense_cfg, spt_cfg,
                            torch.Generator().manual_seed(1))
    adapted = jax.tree_util.tree_map(
        lambda v: v.float() if v.is_floating_point() else v, adapted)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, 256, (2, 16)))
    h_dense, _ = transformer.lm_hidden(dense, dense_cfg, {"tokens": tokens},
                                       remat=False)
    h_spt, _ = transformer.lm_hidden(adapted, spt_cfg, {"tokens": tokens},
                                     remat=False)
    assert "router" in adapted["units"]["b0_attn"]["ffn"]
    np.testing.assert_allclose(h_spt.numpy(), h_dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_adapted_tree_matches_jax_bit_for_bit():
    jdense, jspt = _cfgs()
    jtree = _dense_tree(jdense)
    want = jadapter.adapt(jtree, jdense, jspt, jax.random.PRNGKey(1))
    dense = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jtree), "cpu")
    got = adapter.adapt(dense, port_cfg(jdense), port_cfg(jspt),
                        torch.Generator().manual_seed(1))
    assert [p for p, _ in leaves(got)] == _paths(want)
    fresh = ("router", "lora_inner", "lora_outer", "lora_gate", "pq",
             "lora")
    flat_want = dict(zip(_paths(want), jax.tree_util.tree_leaves(want)))
    n_exact = 0
    for path, v in leaves(got):
        w = np.asarray(flat_want[path])
        assert tuple(v.shape) == w.shape, path
        assert str(v.dtype).split(".")[-1] == w.dtype.name, path
        if not any(k in fresh for k in path):
            np.testing.assert_array_equal(v.float().numpy(),
                                          w.astype(np.float32),
                                          err_msg=str(path))
            n_exact += 1
    ffn = got["units"]["b0_attn"]["ffn"]
    for key in ("w_inner", "w_outer", "w_gate"):
        np.testing.assert_array_equal(
            ffn[key].float().numpy(),
            np.asarray(want["units"]["b0_attn"]["ffn"][key], np.float32))
        assert ffn[key].is_contiguous()
    assert n_exact > 6


def test_upgrade_report_matches_jax():
    jdense, jspt = _cfgs()
    jtree = _dense_tree(jdense)
    want = jadapter.upgrade_report(
        jtree, jadapter.adapt(jtree, jdense, jspt, jax.random.PRNGKey(1)))
    dense = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jtree), "cpu")
    got = adapter.upgrade_report(dense, adapter.adapt(
        dense, port_cfg(jdense), port_cfg(jspt),
        torch.Generator().manual_seed(1)))
    assert got == want
    assert "[UPGRADE] units.b0_attn.ffn FFN -> RoutedFFN" in got.splitlines()
