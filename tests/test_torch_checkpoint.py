"""The port's checkpoints (src/repro_torch/train/checkpoint.py) against
the JAX package's, on the CPU.

The train state of the 2-layer qwen3 smoke config (bf16 frozen weights,
f32 LoRA leaves and moments, an int32 step, None holes where the
partition left them) is laid out as JAX's ``init_state`` lays it out.
Both packages write the same layout (``step_%08d`` directories published
by rename, one ``arrays.npz`` keyed by dotted leaf path, a manifest with
each leaf's logical dtype and shape and the npz's sha256), so each
restores the other's checkpoints; every comparison is bit for bit.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import params as jparams
from repro.train import checkpoint as jcheckpoint
from repro.train import state as JS
from repro_torch.core.params import from_numpy_state
from repro_torch.train import checkpoint
from test_torch_model import np_init_tree


@pytest.fixture(scope="module")
def np_state():
    """A JAX train state of the qwen3 smoke config as numpy arrays, laid
    out as ``init_state`` lays it out (JAX's partition, f32 moments of the
    trainable leaves, an int32 step; bf16 leaves as ml_dtypes arrays,
    None holes kept), its values from ``np_init_tree``."""
    defs = JS.model_defs(jconfigs.get_smoke("qwen3-0.6b"))
    train, frozen = jparams.partition(np_init_tree(defs, 0),
                                      jparams.trainable_mask(defs))
    zeros = lambda a: np.zeros(a.shape, np.float32)       # noqa: E731
    return {"step": np.zeros((), np.int32), "train": train, "frozen": frozen,
            "opt": {"m": jax.tree_util.tree_map(zeros, train),
                    "v": jax.tree_util.tree_map(zeros, train)}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _bits(x) -> np.ndarray:
    """The raw bytes of a leaf (torch or numpy) as a flat uint8 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _logical(x) -> str:
    return (str(x.dtype).removeprefix("torch.")
            if isinstance(x, torch.Tensor) else str(x.dtype))


def assert_same_tree(got, want):
    """Same dict structure, None at the same positions, each leaf of the
    same logical dtype and shape with the same bytes."""
    if want is None or got is None:
        assert got is None and want is None
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            assert_same_tree(got[k], want[k])
        return
    assert _logical(got) == _logical(want)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _manifest(path) -> dict:
    meta = json.loads((pathlib.Path(path) / "manifest.json").read_text())
    meta.pop("sha256")
    return meta


def test_round_trip_keeps_the_newest_steps_bit_for_bit(np_state, tmp_path):
    state = from_numpy_state(np_state, "cpu")
    kinds = {None if v is None else v.dtype for v in _leaves(state)}
    assert kinds == {None, torch.bfloat16, torch.float32, torch.int32}
    for step in (1, 2, 3, 4):
        state["step"] = torch.tensor(step, dtype=torch.int32)
        checkpoint.save(state, step, str(tmp_path), keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000004"]
    assert checkpoint.latest_step(str(tmp_path)) == 4
    assert_same_tree(checkpoint.restore(str(tmp_path), device="cpu"), state)
    older = checkpoint.restore(str(tmp_path), step=3, device="cpu")
    assert int(older["step"]) == 3
    # a published step is never rewritten
    again = checkpoint.save({"step": torch.tensor(0)}, 4, str(tmp_path))
    assert again == str(tmp_path / "step_00000004")
    assert_same_tree(checkpoint.restore(str(tmp_path), device="cpu"), state)


def test_corrupt_npz_raises_ioerror(np_state, tmp_path):
    state = from_numpy_state(np_state, "cpu")
    path = pathlib.Path(checkpoint.save(state, 1, str(tmp_path)))
    raw = bytearray((path / "arrays.npz").read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (path / "arrays.npz").write_bytes(bytes(raw))
    with pytest.raises(IOError, match="sha mismatch"):
        checkpoint.restore(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "empty"), device="cpu")


def test_orphaned_tmp_directories_are_removed(tmp_path):
    orphan = tmp_path / "step_00000007.tmp-99999"
    orphan.mkdir()
    (orphan / "arrays.npz").write_bytes(b"partial")
    assert checkpoint.latest_step(str(tmp_path)) is None
    checkpoint.save({"step": torch.tensor(1, dtype=torch.int32),
                     "x": torch.ones(3)}, 1, str(tmp_path))
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000001"]


def test_jax_checkpoint_restores_in_the_port(np_state, tmp_path):
    """JAX's save of its state restores in the port equal, bit for bit,
    to ``from_numpy_state`` of that state."""
    jcheckpoint.save(jax.tree_util.tree_map(jnp.asarray, np_state), 5,
                     str(tmp_path))
    got = checkpoint.restore(str(tmp_path), device="cpu")
    assert_same_tree(got, from_numpy_state(np_state, "cpu"))


def test_port_checkpoint_restores_in_jax(np_state, tmp_path):
    """The port's save restores in JAX's ``checkpoint.restore`` to the
    same arrays, and both packages write the same manifest (leaf paths,
    keys, logical dtypes, shapes) for one state."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    checkpoint.save(from_numpy_state(np_state, "cpu"), 5, str(port_dir))
    jcheckpoint.save(jax.tree_util.tree_map(jnp.asarray, np_state), 5,
                     str(jax_dir))
    assert (_manifest(port_dir / "step_00000005")
            == _manifest(jax_dir / "step_00000005"))
    got = jcheckpoint.restore(str(port_dir))
    got = jax.tree_util.tree_map(np.asarray, got)
    assert_same_tree(got, np_state)
    assert "bfloat16" in {v.dtype.name for v in _leaves(got) if v is not None}
