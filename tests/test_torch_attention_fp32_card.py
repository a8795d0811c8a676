"""The fp32 attention route ("hopper_fp32": ``csrc/flash_fwd_fp32.cu``,
``csrc/flash_bwd_dq_fp32.cu`` and ``csrc/flash_bwd_dkv_fp32.cu``) without
JAX: which inputs take it, the dK/dV kernel's block plan, its backward's
order of kernels, its wrappers' refusal of CPU tensors, and (``cuda``
marker; skipped without a card) the kernels against their plain versions
on the card, with the tolerances
``chip_smoke.py`` holds them to. On the card:
``python3 -m pytest --noconftest tests/test_torch_attention_fp32_card.py -q``.
``tests/test_torch_attention_fp32.py`` holds an emulation of the kernels'
arithmetic to the Pallas kernels.
"""
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as tatt

# o and lse absolute; dQ, dK and dV relative to the largest value (fp32
# products through the split: chip_smoke.py's FP32_DKV_REL_TOL); the dQ
# kernel's Δ relative to the largest |rowsum(dO∘O)| (fp32 sums in another
# order: chip_smoke.py's DELTA_REL_TOL).
O_TOL = 2e-4
LSE_TOL = 2e-4
DKV_REL_TOL = 1e-4
DELTA_REL_TOL = 1e-4


def _inputs(qs, ks, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in (qs, ks, ks, qs)]


# (id, q shape, kv shape, causal): GQA 4:1, a causal cross length whose
# keys past every query get exactly zero, ragged lengths, head dims 4 and 128.
SHAPES = [
    ("gqa_4to1_causal_96_hd32", (1, 4, 96, 32), (1, 1, 96, 32), True),
    ("cross_length_causal_64x200_hd64", (1, 2, 64, 64), (1, 2, 200, 64), True),
    ("gqa_4to1_noncausal_ragged_193x77_hd128", (1, 4, 193, 128), (1, 1, 77, 128), False),
    ("causal_65_hd4", (1, 2, 65, 4), (1, 2, 65, 4), True),
    ("causal_70_hd128", (1, 2, 70, 128), (1, 2, 70, 128), True),
]


def _empty(shape, dtype):
    return torch.empty((1,) * len(shape), dtype=dtype).expand(shape)


# (id, dtype, head dim, scale, route)
ROUTES = [
    ("fp32_hd4", torch.float32, 4, 0.5, "hopper_fp32"),
    ("fp32_hd64", torch.float32, 64, 0.125, "hopper_fp32"),
    ("fp32_hd100", torch.float32, 100, 0.1, "hopper_fp32"),
    ("fp32_hd128", torch.float32, 128, 0.088, "hopper_fp32"),
    ("fp32_hd130", torch.float32, 130, 0.088, "general"),
    ("fp32_hd6_off_grain", torch.float32, 6, 0.4, "general"),
    ("fp32_hd256", torch.float32, 256, 0.0625, "general"),
    ("fp32_negative_scale", torch.float32, 64, -0.125, "general"),
    ("fp32_zero_scale", torch.float32, 64, 0.0, "general"),
    ("bf16_hd64", torch.bfloat16, 64, 0.125, "hopper"),
    ("fp16_hd100", torch.float16, 100, 0.1, "hopper"),
    ("bf16_hd256", torch.bfloat16, 256, 0.0625, "hopper_wide"),
    ("bf16_negative_scale", torch.bfloat16, 64, -0.125, "general"),
]


@pytest.mark.parametrize("name,dtype,hd,scale,route", ROUTES, ids=[r[0] for r in ROUTES])
def test_fp32_route(name, dtype, hd, scale, route):
    """fp32 with scale > 0 at head dims up to 128 on the 4 grid takes the
    fp32 kernels, never staged; the rest of fp32 and scale <= 0 stay
    general; bf16/fp16 are unchanged."""
    x = _empty((1, 4, 8, hd), dtype)
    kv = _empty((1, 2, 8, hd), dtype)
    assert tatt._kernel_route(x, kv, scale) == route
    if dtype == torch.float32:
        assert not tatt._staged(x, kv, scale)


@pytest.mark.parametrize(
    "shape,causal,want",
    [((2, 8, 2, 1024, 1024, 64), True, (10, 128)), ((4, 8, 4, 512, 512, 64), True, (6, 128)),
     ((1, 16, 16, 2048, 2048, 128), True, (64, 512)),
     ((1, 4, 1, 193, 77, 128), False, (1, 56)), ((1, 2, 2, 64, 200, 64), True, (1, 4)),
     ((12, 18, 18, 2048, 2048, 64), True, (32, 3456))],
    ids=["headline_gqa", "fp32_model", "mha_hd128", "ragged_gqa", "keys_past_queries",
         "many_tiles"],
)
def test_fp32_dkv_plan(shape, causal, want):
    """The dK/dV kernel cuts each key tile's steps (one q head of the group
    over one step of queries) into parts of at most steps_per_block: the
    least that fits one wave of 132 SMs, else one block a tile."""
    b, H, KV, q_len, k_len, hd = shape
    per_block, blocks = tatt.fp32_dkv_plan(b, H, KV, q_len, k_len, hd, causal, 132)
    assert (per_block, blocks) == want
    block_k, block_q = (128, 64) if hd <= 64 else (64, 32)
    n_q = -(-q_len // block_q)
    steps = [H // KV * max(0, n_q - (t * block_k // block_q if causal else 0))
             for t in range(-(-k_len // block_k))]
    # Every part holds at most per_block steps, and no smaller bound fits.
    assert blocks == b * KV * sum(max(1, -(-n // per_block)) for n in steps)
    if per_block > 1 and blocks <= 132:
        assert b * KV * sum(max(1, -(-n // (per_block - 1))) for n in steps) > 132


def test_fp32_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The fp32 wrappers never quietly run the plain version."""
    q = torch.zeros(1, 2, 16, 64)
    lse = torch.zeros(1, 2, 16)
    wrappers = (tatt.flash_forward_fp32_cuda, tatt.flash_bwd_dq_fp32_cuda,
                tatt.flash_bwd_dkv_fp32_cuda, tatt.flash_general_dq_cuda)
    before = [w.launches for w in wrappers]
    for call in (lambda: tatt.flash_forward_fp32_cuda(q, q, q, True, 0.125),
                 lambda: tatt.flash_bwd_dq_fp32_cuda(q, q, q, q, lse, q, True, 0.125),
                 lambda: tatt.flash_bwd_dkv_fp32_cuda(q, q, q, q, lse, lse, True, 0.125),
                 lambda: tatt.flash_backward_fp32_cuda(q, q, q, q, lse, q, True, 0.125)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("entry", ["flash_backward_fp32_cuda", "backward_by_route",
                                   "routed_backward"])
def test_fp32_backward_calls_the_fp32_dq_then_the_fp32_dkv(monkeypatch, entry):
    """The fp32 route's backward is the fp32 dQ kernel (dQ and Δ) and then
    the fp32 dK/dV kernel, which reads that Δ; it never calls the general
    dQ. The launch wrappers are replaced by recorders, and the input check
    by a no-op, so the calls show without a card."""
    calls = []
    q = torch.zeros(1, 4, 16, 64)
    k = torch.zeros(1, 2, 16, 64)
    lse = torch.zeros(1, 4, 16)
    delta = torch.full((1, 4, 16), 3.0)

    def fp32_dq(q_, k_, v_, o, lse_, do, causal, scale):
        calls.append("fp32_dq")
        assert causal and scale == 0.125
        return torch.ones_like(q), delta

    def fp32_dkv(q_, k_, v_, do, lse_, delta_, causal, scale):
        calls.append("fp32_dkv")
        assert delta_ is delta and causal and scale == 0.125
        return torch.ones_like(k), torch.ones_like(k)

    def general_dq(*args):
        raise AssertionError("the fp32 route called the general dQ kernel")

    monkeypatch.setattr(tatt, "_check_kernel_inputs", lambda *args: None)
    monkeypatch.setattr(tatt, "flash_bwd_dq_fp32_cuda", fp32_dq)
    monkeypatch.setattr(tatt, "flash_bwd_dkv_fp32_cuda", fp32_dkv)
    monkeypatch.setattr(tatt, "flash_general_dq_cuda", general_dq)
    backward = {"flash_backward_fp32_cuda": tatt.flash_backward_fp32_cuda,
                "backward_by_route": tatt._BACKWARD_BY_ROUTE["hopper_fp32"],
                "routed_backward": tatt._flash_bwd_cuda}[entry]
    dq, dk, dv = backward(q, k, k, q, lse, q, True, 0.125)
    assert calls == ["fp32_dq", "fp32_dkv"]
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run chip_smoke.py on one)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,qs,ks,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_fp32_kernels_match_plain_on_card(cuda_device, name, qs, ks, causal):
    """The fp32 forward, dQ and dK/dV kernels against the plain versions in
    fp32 on the same inputs (TF32 off): o and lse within 2e-4, dQ, dK and
    dV within 1e-4 of the largest value, the dQ kernel's Δ within 1e-4 of
    the largest |rowsum(dO∘O)|, dQ and dK/dV bitwise repeatable."""
    assert not torch.backends.cuda.matmul.allow_tf32
    q, k, v, do = (torch.tensor(a, device=cuda_device) for a in _inputs(qs, ks, seed=53))
    scale = qs[-1] ** -0.5
    o, lse = tatt.flash_forward_fp32_cuda(q, k, v, causal, scale)
    o_ref, lse_ref = tatt.flash_attention_plain(q, k, v, causal, scale)
    assert (o - o_ref).abs().max().item() <= O_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    dq_runs = [tatt.flash_bwd_dq_fp32_cuda(q, k, v, o, lse, do, causal, scale)
               for _ in range(2)]
    dq, delta = dq_runs[0]
    delta_ref = (do * o).sum(-1)
    assert (delta - delta_ref).abs().max().item() <= DELTA_REL_TOL * delta_ref.abs().max().item()
    runs = [tatt.flash_bwd_dkv_fp32_cuda(q, k, v, do, lse, delta, causal, scale)
            for _ in range(2)]
    refs = tatt.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    for got, ref in zip((dq, *runs[0]), refs):
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= DKV_REL_TOL * ref.abs().max().item()
    assert all(torch.equal(a, b) for a, b in zip(*dq_runs))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("qs,ks", [((1, 4, 96, 64), (1, 2, 96, 64)),
                                   ((1, 4, 70, 128), (1, 1, 70, 128))],
                         ids=["gqa_2to1_96_hd64", "gqa_4to1_70_hd128"])
def test_flash_attention_takes_the_fp32_route_on_card(cuda_device, qs, ks):
    """fp32 at head dims 64 and 128 trains through the fp32 forward, dQ and
    dK/dV, and no other kernel (no general dQ); the gradients match the
    plain backward within 1e-4 of the largest value."""
    q, k, v, do = (torch.tensor(a, device=cuda_device) for a in _inputs(qs, ks, seed=54))
    for t in (q, k, v):
        t.requires_grad_(True)
    counters = (tatt.flash_forward_fp32_cuda, tatt.flash_bwd_dq_fp32_cuda,
                tatt.flash_bwd_dkv_fp32_cuda, tatt.flash_general_forward_cuda,
                tatt.flash_general_dq_cuda, tatt.flash_general_dkv_cuda, tatt.flash_attention,
                tatt.flash_bwd_dq_cuda, tatt.flash_bwd_dkv_cuda)
    before = [c.launches for c in counters]
    grads = torch.autograd.grad(tatt.flash_attention(q, k, v), (q, k, v), do)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 0, 0, 0, 0, 0]
    scale = qs[-1] ** -0.5
    with torch.no_grad():
        o, lse = tatt.flash_attention_plain(q, k, v, True, scale)
        refs = tatt.flash_attention_bwd_plain(q, k, v, o, lse, do, True, scale)
    for got, ref in zip(grads, refs):
        assert (got - ref).abs().max().item() <= DKV_REL_TOL * ref.abs().max().item()
