"""Kernel checks of the PyTorch port that need the card: each CUDA
kernel is built by nvcc and launched, so they skip where no CUDA device
is visible.  On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

``chip_smoke.py`` phase 3 holds every kernel to its plain version in
full; these are the regression checks of faults found on the card.
"""
import pytest
import torch

from repro_torch.core import routed_ffn as rf


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


# The paper blocks' routed-FFN widths (d, F = d_ff / 8, act, gated): the
# bf16 body once refused every one of them (its x and h tiles exceeded a
# block's shared memory past qwen3's d = 1024, F = 384).
PAPER_FFN = [(1024, 512, "relu", False), (2048, 1024, "relu", False),
             (2560, 1280, "relu", False), (2560, 864, "silu", True),
             (4096, 1376, "silu", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,f,act,gated", PAPER_FFN)
def test_grouped_ffn_takes_the_paper_widths(card, d, f, act, gated):
    from repro_torch.kernels.routed_ffn import ops, ref
    g, r, bf16 = 8, 16, torch.bfloat16
    rcfg = rf.RoutedFFNConfig(d_model=d, d_ff=f * g, num_groups=g,
                              active_groups=4, activation=act, gated=gated)

    def w(*shape, fan):
        return (torch.randn(*shape, device="cuda", generator=card)
                / fan ** 0.5).to(bf16)

    def lo(*shape):
        return torch.randn(*shape, device="cuda", generator=card) * 0.05
    lora = {"lora_inner": {"b": lo(d, r), "c": lo(g, r, f)},
            "lora_outer": {"b": lo(g, f, r), "c": lo(r, d)}}
    if gated:
        lora["lora_gate"] = {"b": lo(d, r), "c": lo(g, r, f)}
    x = torch.randn(2, 256, d, device="cuda", generator=card).to(bf16)
    router = torch.randn(d, g, device="cuda", generator=card) / d ** 0.5
    choice, gate, _ = rf.route(x, router, rcfg, need_aux=False)
    plan = rf.plan_for(x, choice, gate, rcfg, None)
    args = (x, plan.index, w(g, d, f, fan=d), w(g, f, d, fan=f),
            w(g, d, f, fan=d) if gated else None, lora, 1.0)
    got = ops.grouped_ffn(*args, act=act)
    want = ref.grouped_ffn_ref(*args, act=act)
    ok = plan.slot_ok[..., None]
    torch.testing.assert_close(torch.where(ok, got.float(), 0.0),
                               torch.where(ok, want.float(), 0.0),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("gran", ["qhead", "kvgroup"])
def test_decode_kernels_take_sixteen_query_heads(card, gran):
    """recurrentgemma-9b's MQA (16 query heads on 1 kv head of 256, M =
    32) once failed to launch: the decode kernels held at most 8 query
    rows and 264 histogram buckets.  Kernel 6 and the two-pass pair at R
    = 16 against the plain version."""
    from repro_torch.kernels.sparse_attention import ops, ref
    from repro_torch.kernels.topl_select import ops as topl_ops
    b, r, dh, m, s = 4, 16, 256, 32, 2048
    q = torch.randn(b, r, dh, device="cuda", generator=card).to(torch.bfloat16)
    k, v = (torch.randn(b, s, dh, device="cuda", generator=card)
            .to(torch.bfloat16) for _ in range(2))
    cq = torch.randint(0, 16, (b, r, m), device="cuda", generator=card,
                       dtype=torch.int32)
    ck = torch.randint(0, 16, (b, s, m), device="cuda", generator=card,
                       dtype=torch.int8)
    valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
    sum_rows = gran == "kvgroup"
    kw = dict(scale=dh ** -0.5, l=256, max_score=m * (r if sum_rows else 1),
              sum_rows=sum_rows, heads_per_batch=1)
    got, thr = ops.fused_sparse_decode_attention(
        q, k, v, cq, ck, valid, return_thresholds=True, **kw)
    want, thr_ref = ref.fused_decode_ref(q, k, v, cq, ck, valid, **kw)
    assert torch.equal(thr, thr_ref)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    sel = {x: kw[x] for x in ("l", "max_score", "sum_rows",
                              "heads_per_batch")}
    thr3 = topl_ops.decode_topl_thresholds(cq, ck, valid, **sel)
    two = ops.sparse_decode_attention(q, k, v, cq, ck, thr3, valid,
                                      scale=kw["scale"], sum_rows=sum_rows,
                                      heads_per_batch=1)
    assert torch.equal(thr3, thr) and torch.equal(two, got)
