"""The wide route of the flash-attention ops: ``csrc/flash_fwd_wide.cu``,
``csrc/flash_bwd_wide.cu`` (dQ and delta) and ``csrc/flash_bwd_dkv_wide.cu``,
which take bf16/fp16 at head dims that are multiples of 8 in 129-256 with
scale > 0; and the head dims off the 16 grid on both TMA routes (72 and
40 on the Hopper kernels, 136 on the wide ones, those off the 8 grid, such
as 100, through ``stage_head_dim``'s zero-padded copy).

This file imports no JAX, so its card tests run on the card's machine,
which has none: ``python -m pytest --noconftest tests/test_torch_attention_wide.py -q``.
The plain versions these kernels are held to are held to the Pallas
kernels in ``tests/test_torch_attention.py`` (``causal_130_hd256``,
``gqa_noncausal_ragged_72x136_hd144``, ``cross_length_causal_160x96_hd136``,
``gqa_2to1_causal_130_hd100``). Here, without a card: the route's bounds,
its wrappers' refusals, the kernels its backward calls and the staged
copy's widths; on the card (``cuda`` marker): the kernels against the plain
versions, and the ops' launches through autograd.
"""
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as tatt


def _empty(shape, dtype):
    """A tensor of ``shape`` and ``dtype`` without its memory (stride 0)."""
    return torch.empty((1,) * len(shape), dtype=dtype).expand(shape)


@pytest.mark.parametrize(
    "hd,dtype,scale,route",
    [(128, torch.bfloat16, 0.1, "hopper"), (136, torch.bfloat16, 0.1, "hopper_wide"),
     (144, torch.bfloat16, 0.1, "hopper_wide"), (144, torch.float16, 0.1, "hopper_wide"),
     (256, torch.float16, 0.1, "hopper_wide"), (256, torch.float32, 0.1, "general"),
     (248, torch.bfloat16, 0.1, "hopper_wide"), (192, torch.bfloat16, 0.0, "general"),
     (129, torch.bfloat16, 0.1, "hopper_wide"), (100, torch.bfloat16, 0.1, "hopper"),
     (72, torch.float16, -0.1, "general")],
    ids=["hd128_hopper", "hd136_wide", "hd144_bf16", "hd144_fp16", "hd256_fp16",
         "hd256_fp32_general", "hd248_off_grid", "scale_zero_general", "hd129_wide",
         "hd100_hopper_staged", "fp16_hd72_negative_scale_general"],
)
def test_wide_route_bounds(hd, dtype, scale, route):
    """The wide route starts past the Hopper route's 128 (129, staged to
    136 and run at D = 192) and ends at 256; head dims off the 16 grid take
    the TMA routes too; fp32 and ``scale <= 0`` stay general."""
    x = _empty((1, 2, 8, hd), dtype)
    assert tatt._kernel_route(x, x, scale) == route


def test_wide_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The wide wrappers never run the plain version: a CPU tensor raises
    and counts no launch."""
    q = torch.zeros(1, 2, 16, 256, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 16)
    wrappers = (tatt.flash_forward_wide_cuda, tatt.flash_bwd_dq_wide_cuda,
                tatt.flash_bwd_dkv_wide_cuda)
    before = [w.launches for w in wrappers]
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_forward_wide_cuda(q, q, q, True, 0.0625)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_bwd_dq_wide_cuda(q, q, q, q, lse, q, True, 0.0625)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_bwd_dkv_wide_cuda(q, q, q, q, lse, lse, True, 0.0625)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_backward_wide_cuda(q, q, q, q, lse, q, True, 0.0625)
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("entry", ["flash_backward_wide_cuda", "backward_by_route",
                                   "routed_backward"])
def test_wide_backward_calls_the_wide_dq_then_the_wide_dkv(monkeypatch, entry):
    """The wide route's backward is the wide dQ kernel (dQ and delta) and
    then the wide dK/dV kernel, which reads that delta; it never calls the
    general dQ. The launch wrappers are replaced by recorders, and the input
    check by a no-op, so the calls show without a card."""
    calls = []
    q = torch.zeros(1, 2, 16, 256, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 16, 256, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 16)
    delta = torch.full((1, 2, 16), 3.0)

    def wide_dq(*args):
        calls.append("wide_dq")
        return torch.ones_like(q), delta

    def wide_dkv(q_, k_, v_, do, lse_, delta_, causal, scale):
        calls.append("wide_dkv")
        assert delta_ is delta and causal and scale == 0.0625
        return torch.ones_like(k), torch.ones_like(k)

    def general_dq(*args):
        raise AssertionError("the wide route called the general dQ kernel")

    monkeypatch.setattr(tatt, "_check_kernel_inputs", lambda *args: None)
    monkeypatch.setattr(tatt, "flash_bwd_dq_wide_cuda", wide_dq)
    monkeypatch.setattr(tatt, "flash_bwd_dkv_wide_cuda", wide_dkv)
    monkeypatch.setattr(tatt, "flash_general_dq_cuda", general_dq)
    backward = {"flash_backward_wide_cuda": tatt.flash_backward_wide_cuda,
                "backward_by_route": tatt._BACKWARD_BY_ROUTE["hopper_wide"],
                "routed_backward": tatt._flash_bwd_cuda}[entry]
    dq, dk, dv = backward(q, k, k, q, lse, q, True, 0.0625)
    assert calls == ["wide_dq", "wide_dkv"]
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


@pytest.mark.parametrize("hd,route,width", [(100, "hopper", 104), (129, "hopper_wide", 136),
                                             (7, "hopper", 8)])
def test_off_grid_head_dims_are_staged_through_one_padded_copy(monkeypatch, hd, route, width):
    """The ops' CUDA kernels at a head dim off the 8 grid: the route's
    forward and backward run once each at the next multiple of 8 (q, k, v,
    o and do zero-padded), o, dq, dk and dv come back at the caller's head
    dim, the caller's scale is passed through, and each op counts one use
    of ``stage_head_dim``. The route's wrappers are replaced by recorders
    (the plain versions behind them), so the calls show without a card."""
    calls = []

    def fwd(q, k, v, causal, scale):
        calls.append(("fwd", q.shape[-1], k.shape[-1], v.shape[-1], scale))
        return tatt.flash_attention_plain(q, k, v, causal, scale)

    def bwd(q, k, v, o, lse, do, causal, scale):
        calls.append(("bwd", q.shape[-1], o.shape[-1], do.shape[-1], scale))
        return tatt.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)

    monkeypatch.setitem(tatt._FORWARD_BY_ROUTE, route, fwd)
    monkeypatch.setitem(tatt._BACKWARD_BY_ROUTE, route, bwd)
    rng = np.random.default_rng(42)
    q, do = (torch.tensor(rng.standard_normal((1, 4, 24, hd)), dtype=torch.bfloat16)
             for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((1, 2, 24, hd)), dtype=torch.bfloat16)
            for _ in range(2))
    scale = hd**-0.5
    uses = tatt.stage_head_dim.uses
    o, lse = tatt._flash_fwd_cuda(q, k, v, True, scale)
    dq, dk, dv = tatt._flash_bwd_cuda(q, k, v, o, lse, do, True, scale)
    assert calls == [("fwd", width, width, width, scale), ("bwd", width, width, width, scale)]
    assert o.shape == dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert tatt.stage_head_dim.uses == uses + 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run chip_smoke.py on one)")
    return torch.device("cuda")


def _card_inputs(qs, ks, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(s).astype(np.float32), device=device).to(dtype)
                 for s in (qs, ks, ks, qs))


# (id, q shape, kv shape, causal, dtype): both widths of the kernels
# (D = 192 holds head dims 144-192, D = 256 208-256), GQA, ragged and
# cross lengths, the edges of their 128-row q and 64-key tiles.
WIDE_SHAPES = [
    ("causal_130_hd256", (1, 2, 130, 256), (1, 2, 130, 256), True, torch.bfloat16),
    ("gqa_noncausal_ragged_72x136_hd144", (1, 4, 72, 144), (1, 2, 136, 144), False,
     torch.bfloat16),
    ("fp16_gqa_causal_257_hd192", (1, 2, 257, 192), (1, 1, 257, 192), True, torch.float16),
    ("cross_length_causal_64x200_hd208", (1, 2, 64, 208), (1, 2, 200, 208), True,
     torch.bfloat16),
    # hd 136: off the 16 grid, the narrowest width D = 192 holds directly.
    ("cross_length_noncausal_320x96_hd136", (1, 2, 320, 136), (1, 2, 96, 136), False,
     torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,qs,ks,causal,dtype", WIDE_SHAPES, ids=[s[0] for s in WIDE_SHAPES])
def test_wide_kernels_match_plain_on_card(cuda_device, name, qs, ks, causal, dtype):
    """The wide forward, and the backward (the wide dQ, then the wide
    dK/dV), against the plain versions in fp32 on the same 16-bit inputs,
    o and lse: o within 2e-2 (one 16-bit rounding plus P rounded for P V),
    lse within 2e-3, gradients within 2% of the largest value (P and dS
    rounded as A operands), the dQ kernel's delta within 1e-4 of
    rowsum(dO * O) (fp32 sums in another order); dQ run again is bitwise
    the same (no atomics); keys past every query get exactly zero."""
    q, k, v, do = _card_inputs(qs, ks, dtype, cuda_device, 40)
    scale = qs[-1] ** -0.5
    assert tatt._kernel_route(q, k, scale) == "hopper_wide"
    o, lse = tatt.flash_forward_wide_cuda(q, k, v, causal, scale)
    o_ref, lse_ref = tatt.flash_attention_plain(q.float(), k.float(), v.float(), causal, scale)
    torch.testing.assert_close(o.float(), o_ref, rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=2e-3)
    got = tatt.flash_backward_wide_cuda(q, k, v, o, lse, do, causal, scale)
    ref = tatt.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                         do.float(), causal, scale)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == dtype
        assert (g.float() - r).abs().max().item() <= 2e-2 * r.abs().max().item()
    if causal and ks[2] > qs[2]:
        for g in got[1:]:
            assert not g[:, :, qs[2]:].count_nonzero()
    runs = [tatt.flash_bwd_dq_wide_cuda(q, k, v, o, lse, do, causal, scale) for _ in range(2)]
    assert torch.equal(runs[0][0], got[0])
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    delta_ref = (do.float() * o.float()).sum(-1)
    assert (runs[0][1] - delta_ref).abs().max().item() <= 1e-4 * delta_ref.abs().max().item()


@pytest.mark.cuda
def test_flash_attention_takes_the_wide_route_on_card(cuda_device):
    """bf16 at head dim 256 trains through the wide kernels: one wide
    forward, one wide dQ and one wide dK/dV, and no Hopper or general
    kernel."""
    q, k, v, do = _card_inputs((1, 4, 96, 256), (1, 2, 96, 256), torch.bfloat16, cuda_device, 41)
    for t in (q, k, v):
        t.requires_grad_(True)
    counters = (tatt.flash_forward_wide_cuda, tatt.flash_bwd_dq_wide_cuda,
                tatt.flash_bwd_dkv_wide_cuda, tatt.flash_general_dq_cuda, tatt.flash_attention,
                tatt.flash_bwd_dq_cuda, tatt.flash_bwd_dkv_cuda, tatt.flash_general_forward_cuda,
                tatt.flash_general_dkv_cuda)
    before = [c.launches for c in counters]
    torch.autograd.grad(tatt.flash_attention(q, k, v), (q, k, v), do)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 0, 0, 0, 0, 0]


# (id, q shape, kv shape, causal, dtype, route): head dims off the 16 grid
# through the ops on the card; hd 100 and 129 through stage_head_dim.
OFF_GRID_SHAPES = [
    ("hd72_causal_129", (1, 2, 129, 72), (1, 2, 129, 72), True, torch.bfloat16, "hopper"),
    ("fp16_hd72_noncausal_300x500", (1, 4, 300, 72), (1, 2, 500, 72), False, torch.float16,
     "hopper"),
    ("hd40_gqa_4to1_ragged_193x77", (1, 4, 193, 40), (1, 1, 77, 40), False, torch.bfloat16,
     "hopper"),
    ("hd136_cross_length_causal_320x96", (1, 2, 320, 136), (1, 2, 96, 136), True,
     torch.bfloat16, "hopper_wide"),
    ("hd100_gqa_causal_200", (2, 8, 200, 100), (2, 2, 200, 100), True, torch.bfloat16, "hopper"),
    ("hd129_causal_70", (1, 2, 70, 129), (1, 2, 70, 129), True, torch.bfloat16, "hopper_wide"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,qs,ks,causal,dtype,route", OFF_GRID_SHAPES,
                         ids=[s[0] for s in OFF_GRID_SHAPES])
def test_off_grid_head_dims_run_on_the_tma_kernels_on_card(cuda_device, name, qs, ks, causal,
                                                           dtype, route):
    """Head dims off the 16 grid through ``flash_attention`` on the card:
    the route's forward, dQ and dK/dV kernels once each and no general
    kernel; those off the 8 grid through one staged copy an op. o within
    2e-2 of the plain version, gradients within 2% of the largest value
    (the tolerances of ``test_wide_kernels_match_plain_on_card``)."""
    q, k, v, do = _card_inputs(qs, ks, dtype, cuda_device, 43)
    scale = qs[-1] ** -0.5
    assert tatt._kernel_route(q, k, scale) == route
    counters = (tatt.flash_attention, tatt.flash_bwd_dq_cuda, tatt.flash_bwd_dkv_cuda,
                tatt.flash_forward_wide_cuda, tatt.flash_bwd_dq_wide_cuda,
                tatt.flash_bwd_dkv_wide_cuda, tatt.flash_general_forward_cuda,
                tatt.flash_general_dq_cuda, tatt.flash_general_dkv_cuda)
    before = [c.launches for c in counters]
    uses = tatt.stage_head_dim.uses
    for t in (q, k, v):
        t.requires_grad_(True)
    o = tatt.flash_attention(q, k, v, causal, scale)
    got = torch.autograd.grad(o, (q, k, v), do)
    one = [1, 1, 1, 0, 0, 0] if route == "hopper" else [0, 0, 0, 1, 1, 1]
    assert [c.launches - b for c, b in zip(counters, before)] == one + [0, 0, 0]
    assert tatt.stage_head_dim.uses - uses == (2 if qs[-1] % 8 else 0)
    q, k, v = (t.detach() for t in (q, k, v))
    o_ref, lse_ref = tatt.flash_attention_plain(q.float(), k.float(), v.float(), causal, scale)
    torch.testing.assert_close(o.detach().float(), o_ref, rtol=0, atol=2e-2)
    ref = tatt.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.detach().float(),
                                         lse_ref, do.float(), causal, scale)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == dtype
        assert (g.float() - r).abs().max().item() <= 2e-2 * r.abs().max().item()
