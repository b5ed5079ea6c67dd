"""The port's sharding logic against the JAX package's, pure logic (no
process group but the launchers' world of one):

  * every leaf's logical axes (``ParamDef.axes``) equal JAX's, for every
    assigned architecture and the paper's models;
  * ``rules_for_mesh``, ``spec_tree``, ``state_specs``, ``batch_specs``
    and ``cache_specs`` equal JAX's (``PartitionSpec`` read as a tuple) at
    meshes (16, 16), (2, 16, 16), (1, 2) and (2, 2), stand-in mesh objects
    on both sides (JAX's ``rules_for_mesh`` reads ``axis_names`` and
    ``devices.shape`` only, the port's ``mesh_dim_names`` and ``mesh``);
  * the four cases of tests/test_sharding_and_roofline.py, in the port;
  * ``shard`` checks the annotation's rank; the launchers refuse meshes
    they cannot run.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import paper_blocks as jpaper
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.shapes import input_specs as jinput_specs
from repro.launch import steps as jsteps
from repro.models import encdec as jencdec
from repro.models import transformer as jtransformer
from repro.sharding import rules_for_mesh as jrules_for_mesh
from repro.train import state as JS
from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.shapes import input_specs
from repro_torch.core import params as P
from repro_torch.core.params import ParamDef, spec_tree, stack_defs
from repro_torch.launch import steps
from repro_torch.models import encdec, transformer
from repro_torch.sharding import axis_rules, rules_for_mesh, shard, spec_for
from repro_torch.sharding.rules import RULES as RULES_TABLE
from repro_torch.train import state as S

NAMES = (list(jconfigs.ARCH_NAMES) + list(jpaper.blocks())
         + ["opt-2.7b", "llama-2.7b"])
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((1, 2), ("data", "model")), ((2, 2), ("data", "model"))]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _tuples(tree):
    """A JAX PartitionSpec tree (None holes kept) as {path: tuple}."""
    return {p: (None if s is None else tuple(s)) for p, s in _leaves(tree)}


def _meshes(shape, names):
    return (types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(shape)),
            types.SimpleNamespace(mesh_dim_names=names,
                                  mesh=torch.empty(shape)))


@pytest.mark.parametrize("name", NAMES)
def test_param_axes_match_jax(name):
    want = {p: d.axes for p, d in _leaves(JS.model_defs(
        jconfigs.get_config(name)))}
    got = {p: d.axes for p, d in _leaves(S.model_defs(
        configs.get_config(name)))}
    assert got == want


def _caches(name):
    """(JAX abstract decode caches, the port's on the meta device)."""
    jcfg, cfg = jconfigs.get_config(name), configs.get_config(name)
    b, n = 32, 64
    if cfg.family == "audio":
        return (jax.eval_shape(lambda: jencdec.init_dec_caches(jcfg, b, n,
                                                               48)),
                encdec.init_dec_caches(cfg, b, n, 48, device="meta"))
    return (jax.eval_shape(lambda: jtransformer.init_caches(jcfg, b, n)),
            transformer.init_caches(cfg, b, n, device="meta"))


@pytest.mark.parametrize("shape,names", MESHES,
                         ids=lambda m: "x".join(map(str, m))
                         if isinstance(m[0], int) else "-".join(m))
def test_specs_match_jax(shape, names):
    jmesh, mesh = _meshes(shape, names)
    jrules, rules = jrules_for_mesh(jmesh), rules_for_mesh(mesh)
    assert {k: v for k, v in rules.items() if k != "__mesh__"} == \
        {k: v for k, v in jrules.items() if k != "__mesh__"}
    for name in NAMES:
        jcfg, cfg = jconfigs.get_config(name), configs.get_config(name)
        assert _tuples(S.param_specs(cfg, rules)) == \
            _tuples(JS.param_specs(jcfg, jrules)), name
        assert _tuples(S.state_specs(cfg, rules)) == \
            _tuples(JS.state_specs(jcfg, jrules)), name
        shp = ("train_4k", "train", 4096, 256)
        got = steps.batch_specs(cfg, input_specs(cfg, ShapeSpec(*shp)),
                                rules)
        want = jsteps.batch_specs(jcfg, jinput_specs(jcfg, JShapeSpec(*shp)),
                                  jrules)
        assert _tuples(got) == _tuples(want), name
        st, bt, st2, metrics = steps.train_shardings(
            cfg, mesh, rules, input_specs(cfg, ShapeSpec(*shp)))
        assert st is st2 and bt == got and metrics == ()
    for name in ("qwen3-0.6b", "recurrentgemma-9b", "mamba2-780m",
                 "whisper-base"):
        jc, c = _caches(name)
        jcfg, cfg = jconfigs.get_config(name), configs.get_config(name)
        assert _tuples(steps.cache_specs(cfg, c, rules)) == \
            _tuples(jsteps.cache_specs(jcfg, jc, jrules)), name


def _stored_differences(name, mesh):
    """{leaf path: (the port's stored shape, JAX's)} of ``name``'s state
    on ``mesh`` (data, model) where the two differ."""
    from repro_torch.sharding import local_shape
    cfg = configs.get_config(name)
    sizes = {"data": mesh[0], "model": mesh[1]}
    rules = {**RULES_ALL, "__sizes__": sizes}
    mine = dict(P.leaves(S.model_storage_specs(cfg, sizes)))
    theirs = dict(P.leaves(S.param_specs(cfg, rules)))
    out = {}
    for path, t in P.leaves(P.abstract_tree(S.model_defs(cfg))):
        a = local_shape(t.shape, mine[path], sizes)
        b = local_shape(t.shape, theirs[path], sizes)
        if a != b:
            out[path] = (a, b)
    return cfg, out


@pytest.mark.parametrize("mesh", [(2, 2), (16, 16)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_storage_specs_against_jax(name, mesh):
    """The port stores each leaf as JAX's ``state_specs`` place it, except
    where train/state.storage_specs says it does not: the SSD mixer's
    leaves, an attention or FFN whose ``tp_plan`` does not split (kept
    whole), a one-block RG-LRU gate (split on its columns).  Query heads
    split inside a kv head (one kv head among them) store k and v as JAX
    does."""
    from repro_torch.models import attention, ffn, rglru
    cfg, diff = _stored_differences(name, mesh)
    n = mesh[1]
    for path, (mine, theirs) in diff.items():
        if any(k.endswith("_ssd") for k in path):
            continue
        if "mixer" in path and any(k.endswith("_rec") for k in path):
            assert path[-1] in ("w_a", "w_i") and rglru._gate_blocks(cfg) == 1
            continue
        if "ffn" in path:
            assert ffn.tp_plan(cfg, n) is None, path
            continue
        # an attention: whole where its heads do not split
        assert attention.tp_plan(cfg, n) is None, path
        assert all(a >= b for a, b in zip(mine, theirs)), path


# ------------------- tests/test_sharding_and_roofline.py's four, ported
RULES_ALL = dict(RULES_TABLE)
RULES = {"heads": "model", "ffn": "model", "embed": None,
         "batch": ("pod", "data"),
         "__sizes__": {"model": 16, "data": 16, "pod": 2}}


def test_spec_tree_divisibility_fallback():
    defs = {
        "ok": ParamDef((64, 32), axes=("embed", "heads")),     # 32 % 16 == 0
        "bad": ParamDef((64, 24), axes=("embed", "heads")),    # 24 % 16 != 0
    }
    specs = spec_tree(defs, RULES)
    assert specs["ok"] == (None, "model")
    assert specs["bad"] == (None, None)


def test_spec_tree_axis_used_once():
    defs = {"w": ParamDef((32, 32), axes=("heads", "ffn"))}
    # both logical axes map to "model"; only the first dim may take it
    assert spec_tree(defs, RULES)["w"] == ("model", None)


def test_stacked_defs_get_layer_axis():
    defs = stack_defs({"w": ParamDef((8, 32), axes=(None, "ffn"))}, 4)
    assert defs["w"].shape == (4, 8, 32)
    assert spec_tree(defs, RULES)["w"] == (None, None, "model")


def test_spec_for_batch_multi_axis():
    assert spec_for((64, 128), ("batch", None), RULES) == \
        (("pod", "data"), None)
    # batch not divisible by pod*data => replicated
    assert spec_for((7, 128), ("batch", None), RULES) == (None, None)


# ---------------------------------------------------------------- guards
def test_param_def_axes_rank_checked():
    with pytest.raises(ValueError, match="rank mismatch"):
        ParamDef((4, 4), axes=("embed",))


def test_shard_checks_rank_under_rules():
    x = torch.zeros(2, 3)
    assert shard(x, "batch") is x                     # no rules: no check
    with axis_rules(RULES):
        assert shard(x, "batch", None) is x
        with pytest.raises(ValueError, match="2 axes|1 axes"):
            shard(x, "batch")


def test_train_launcher_refuses_a_mesh_larger_than_the_world(capsys):
    from repro_torch.launch import train
    with pytest.raises(SystemExit) as err:
        train.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                    "--steps", "1", "--batch", "2", "--seq", "16",
                    "--mesh", "2x2"])
    assert err.value.code == 2
    assert "needs 4 processes, the world has 1" in capsys.readouterr().err


def test_serve_launcher_takes_1x1_only(capsys):
    """In a world of one the serve launcher takes a 1x1 mesh only: a
    larger one is refused, as the train launcher refuses it (a world of
    two serving --mesh 1x2: tests/test_torch_multigpu_serve.py)."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as err:
        serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                    "--mesh", "1x2"])
    assert err.value.code == 2
    assert "needs 2 processes, the world has 1" in capsys.readouterr().err


def test_rules_reach_another_thread():
    """On a CUDA device autograd runs the backward (a checkpoint's
    recompute, a kernel op's reference backward) on a thread of its own:
    it must see the rules of the step that waits for it."""
    import threading
    from repro_torch.sharding import current_rules
    seen = []
    with axis_rules(RULES):
        t = threading.Thread(target=lambda: seen.append(current_rules()))
        t.start()
        t.join()
    assert seen == [RULES] and current_rules() is None


def test_one_kv_head_differs_from_jax_by_the_gate_alone():
    """recurrentgemma's smoke at (1, 4): its one kv head's ``wk`` / ``wv``
    are stored as JAX stores them (over their head_dim columns), so a
    rank's state (parameters and AdamW moments) differs from what JAX's
    placement gives it only in the one-block RG-LRU gate's ``w_a`` /
    ``w_i``, split on their output columns (train/state.storage_specs'
    list): 98,304 B less."""
    import math
    from repro_torch.sharding import local_shape
    cfg = configs.get_smoke("recurrentgemma-9b")
    sizes = {"data": 1, "model": 4}
    mine = S.storage_specs(cfg, {"__sizes__": sizes})
    theirs = S.state_specs(cfg, {**RULES_ALL, "__sizes__": sizes})
    whole = S.abstract_state(cfg)
    whole["opt"] = {"m": whole["train"], "v": whole["train"]}

    def nbytes(t, spec):
        return math.prod(local_shape(t.shape, spec, sizes)) * t.element_size()
    total, names = 0, set()
    for part in ("train", "frozen", "opt"):
        m, j = dict(P.leaves(mine[part])), dict(P.leaves(theirs[part]))
        for path, t in P.leaves(whole[part]):
            d = nbytes(t, m[path]) - nbytes(t, j[path])
            if d:
                total += d
                names.add(path[-1])
    assert names == {"w_a", "w_i"}
    assert total == -98304
