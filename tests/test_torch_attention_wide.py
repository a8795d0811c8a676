"""The wide route of the flash-attention ops: ``csrc/flash_fwd_wide.cu``,
``csrc/flash_bwd_wide.cu`` (dQ and delta) and ``csrc/flash_bwd_dkv_wide.cu``,
which take bf16/fp16 at head dims that are multiples of 16 in 144-256 with
scale > 0.

This file imports no JAX, so its card tests run on the card's machine,
which has none: ``python -m pytest --noconftest tests/test_torch_attention_wide.py -q``.
The plain versions these kernels are held to are held to the Pallas
kernels in ``tests/test_torch_attention.py`` (``causal_130_hd256``,
``gqa_noncausal_ragged_72x136_hd144``). Here, without a card: the route's
bounds, its wrappers' refusals and the kernels its backward calls; on the
card (``cuda`` marker): the kernels against the plain versions, and the
ops' launches through autograd.
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
    [(128, torch.bfloat16, 0.1, "hopper"), (136, torch.bfloat16, 0.1, "general"),
     (144, torch.bfloat16, 0.1, "hopper_wide"), (144, torch.float16, 0.1, "hopper_wide"),
     (256, torch.float16, 0.1, "hopper_wide"), (256, torch.float32, 0.1, "general"),
     (248, torch.bfloat16, 0.1, "general"), (192, torch.bfloat16, 0.0, "general")],
    ids=["hd128_hopper", "hd136_general", "hd144_bf16", "hd144_fp16", "hd256_fp16",
         "hd256_fp32_general", "hd248_off_grid", "scale_zero_general"],
)
def test_wide_route_bounds(hd, dtype, scale, route):
    """The wide route starts at the first multiple of 16 past the Hopper
    route's 128 and ends at 256; fp32, head dims off the 16 grid and
    ``scale <= 0`` stay general."""
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
