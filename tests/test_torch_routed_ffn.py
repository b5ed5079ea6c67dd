"""What the routed-FFN CUDA kernels rely on, checked on the CPU.

  * The grouped kernel (kernel 9) skips a 64-slot tile that keeps no
    slot.  Such tiles are each row's trailing tiles because the capacity
    plan packs each (b, g) row's kept slots as a prefix, with S after
    them.  The port's ``make_plan`` is held to JAX's (same index, slot
    mask and combine weights) and to that invariant, with ragged per-row
    capacities and with capacity drops.
  * The wrappers pad the LoRA rank with zeros to the kernels' 16-byte
    rows, which leaves the function unchanged, and copy data that does
    not start on 16 bytes.
  * Kernel 9's wrapper takes any d, F and LoRA rank, and kernel 10's
    raises, before any build or launch, on what its kernel does not take
    (meta tensors stand in for CUDA ones: they take the kernel path
    without a card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro_torch import kernels
from repro_torch.core import dispatch
from repro_torch.kernels.routed_ffn import ops as rffn_ops
from test_torch_model import one_torch_thread, t  # noqa: F401


def _choices(rng, b, s, g, k):
    """(B, S, K) distinct group choices per token, with skew towards the
    low groups so that some rows overflow their capacity."""
    w = np.linspace(2.0, 0.5, g)
    return np.stack([np.stack([rng.choice(g, size=k, replace=False,
                                          p=w / w.sum()) for _ in range(s)])
                     for _ in range(b)]).astype(np.int32)


@pytest.mark.parametrize("capf,lengths", [
    (1.25, None),                   # full rows
    (1.25, [40, 17, 3]),            # ragged rows: per-row capacities
    (0.5, None),                    # capacity drops
    (0.5, [40, 9, 25]),             # ragged and dropping
])
def test_make_plan_packs_kept_slots_first(capf, lengths):
    b, s, g, k = 3, 40, 4, 2
    rng = np.random.default_rng(7)
    choice = _choices(rng, b, s, g, k)
    gate = rng.random((b, s, k)).astype(np.float32)
    cap = jdispatch.capacity(s, g, k, capf)
    cap_dyn = None if lengths is None else np.asarray(lengths, np.int32)
    want = jdispatch.make_plan(
        jnp.asarray(choice), jnp.asarray(gate), g, cap,
        cap_dyn=None if cap_dyn is None else jdispatch.capacity_dyn(
            jnp.asarray(cap_dyn), g, k, capf))
    got = dispatch.make_plan(
        t(choice), t(gate), g, cap,
        cap_dyn=None if cap_dyn is None else dispatch.capacity_dyn(
            t(cap_dyn), g, k, capf))
    index = got.index.numpy()
    np.testing.assert_array_equal(index, np.asarray(want.index))
    np.testing.assert_array_equal(got.slot_ok.numpy(),
                                  np.asarray(want.slot_ok))
    np.testing.assert_allclose(got.combine_w.numpy(),
                               np.asarray(want.combine_w), rtol=0, atol=0)
    if capf < 1.0:
        assert float(got.dropped) > 0.0
    # each (b, g) row: kept slots first, then only S (empty)
    kept = got.slot_ok.numpy()
    n_kept = kept.sum(-1)
    slots = np.arange(cap)
    np.testing.assert_array_equal(kept, slots < n_kept[..., None])
    assert (index[~kept] == s).all() and (index[kept] < s).all()
    # so a tile (of any size) keeps no slot iff its first index is S
    for tile in (8, 16, 64):
        for c0 in range(0, cap, tile):
            empty = ~kept[..., c0:c0 + tile].any(-1)
            np.testing.assert_array_equal(empty, index[..., c0] == s)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _lora(d, f, g, r):
    f32 = torch.float32
    return {"lora_inner": {"b": _meta(d, r, dtype=f32),
                           "c": _meta(g, r, f, dtype=f32)},
            "lora_gate": {"b": _meta(d, r, dtype=f32),
                          "c": _meta(g, r, f, dtype=f32)},
            "lora_outer": {"b": _meta(g, f, r, dtype=f32),
                           "c": _meta(r, d, dtype=f32)}}


@pytest.mark.parametrize("d,f,r", [
    (60, 64, 16),                            # d not in 16-byte rows
    (64, 36, 16),                            # F not in 16-byte rows
    (64, 64, 40),                            # rank above 32
])
def test_grouped_ffn_bf16_raises_on_what_the_kernel_does_not_take(d, f, r):
    """Kernel 9's bf16 body takes all three (predicated tail loads; past
    rank 32 the wide form with split LoRA factors), as the JAX kernel
    does: on meta tensors the wrapper returns y's shape and builds and
    launches nothing."""
    g, c = 4, 16
    x, wi, wg = _meta(2, 32, d), _meta(g, d, f), _meta(g, d, f)
    wo = _meta(g, f, d)
    index = _meta(2, g, c, dtype=torch.int32)
    before = rffn_ops.grouped_ffn.launches
    y = rffn_ops.grouped_ffn(x, index, wi, wo, wg, _lora(d, f, g, r), 1.0,
                             act="silu")
    assert y.shape == (2, g, c, d) and y.dtype == torch.bfloat16
    assert rffn_ops.grouped_ffn.launches == before
    assert kernels._lib is None                  # nothing was built


@pytest.mark.parametrize("d,f,r,match", [
    (60, 64, 16, "multiples of 8"),
    (64, 64, 68, "rank"),
])
def test_decode_ffn_raises_on_what_the_kernel_does_not_take(d, f, r, match):
    g, ga, b = 4, 2, 3
    x, wi, wg, wo = _meta(b, d), _meta(g, d, f), _meta(g, d, f), _meta(g, f, d)
    choice = _meta(b, ga, dtype=torch.int32)
    gate = _meta(b, ga, dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        rffn_ops.decode_ffn(x, choice, gate, wi, wo, wg, _lora(d, f, g, r),
                            1.0, act="silu")
    assert kernels._lib is None


def _lora_f32(rng, d, f, g, r):
    def n(*shape):
        return t(rng.standard_normal(shape).astype(np.float32) * 0.1)
    return {"lora_inner": {"b": n(d, r), "c": n(g, r, f)},
            "lora_gate": {"b": n(d, r), "c": n(g, r, f)},
            "lora_outer": {"b": n(g, f, r), "c": n(r, d)}}


@pytest.mark.parametrize("r,multiple", [(4, 8), (12, 8), (6, 4), (16, 8)])
def test_lora_rank_padding_keeps_the_function(r, multiple):
    from repro_torch.kernels.routed_ffn import ref
    b, s, d, f, g, c, ga = 2, 12, 16, 24, 3, 8, 2
    rng = np.random.default_rng(r)
    lora = _lora_f32(rng, d, f, g, r)
    lo, rp = rffn_ops._lora_leaves(lora, True, multiple=multiple)
    assert rp % multiple == 0 and r <= rp < r + multiple
    src = [lora[k][n] for k in rffn_ops._LORA_KEYS for n in ("b", "c")]
    for got, want, ax in zip(lo, src, rffn_ops._RANK_AXIS):
        assert got.shape[ax] == rp and got.data_ptr() % 16 == 0
        np.testing.assert_array_equal(got.narrow(ax, 0, r).numpy(),
                                      want.numpy())
        assert not got.narrow(ax, r, rp - r).any()
    padded = {k: {"b": lo[2 * i], "c": lo[2 * i + 1]}
              for i, k in enumerate(rffn_ops._LORA_KEYS)}
    x = t(rng.standard_normal((b, s, d)).astype(np.float32))
    wi, wg = (t(rng.standard_normal((g, d, f)).astype(np.float32))
              for _ in range(2))
    wo = t(rng.standard_normal((g, f, d)).astype(np.float32))
    index = t(rng.integers(0, s + 1, (b, g, c)).astype(np.int32))
    want = ref.grouped_ffn_ref(x, index, wi, wo, wg, lora, 0.5, "silu")
    got = ref.grouped_ffn_ref(x, index, wi, wo, wg, padded, 0.5, "silu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    choice = t(np.stack([rng.choice(g, ga, replace=False)
                         for _ in range(b)]).astype(np.int32))
    gate = t(rng.random((b, ga)).astype(np.float32))
    want = ref.decode_ffn_ref(x[:, 0], choice, gate, wi, wo, wg, lora, 0.5,
                              "silu")
    got = ref.decode_ffn_ref(x[:, 0], choice, gate, wi, wo, wg, padded, 0.5,
                             "silu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_aligned_copies_only_data_off_16_bytes():
    base = torch.arange(20, dtype=torch.float32)
    view = base[1:17]                            # starts 4 bytes in
    assert view.data_ptr() % 16 == 4
    got = rffn_ops._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    assert rffn_ops._aligned(base) is base
    assert rffn_ops._aligned(None) is None
