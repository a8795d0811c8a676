"""ray_tpu_torch.ops.attention against ray_tpu.ops.attention.

The port's plain flash forward is held to the Pallas kernel itself
(``_flash_forward(..., interpret=True)``) on ``o`` AND ``lse``, at the
shapes ``tests/test_models.py`` uses for the kernel. Inputs come from a
numpy seed and go through both packages. Both sides compute in fp32 (the
JAX side under ``default_matmul_precision("highest")``), so the tolerance
is fp32 summation-order noise on O(1) values: 2e-5.

The plain backward is held to the Pallas backward kernels in the same
way (``_flash_backward(..., interpret=True)``, dq, dk and dv), on the
same o and lse, at the same shapes: fp32 sums over up to 320 keys or
queries of O(1) terms, so 1e-4. (The shapes only the general kernels
take are in ``tests/test_torch_attention_general.py``.)
``flash_attention`` (the custom op ``ray_tpu_torch::flash_fwd`` with its
autograd) is checked with ``torch.autograd.gradcheck`` in float64.

The CUDA kernels themselves only run on the card: the tests that need one
are marked ``cuda`` and skip without it; ``chip_smoke.py`` is their full
check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu_torch.ops import attention as tatt

TOL = 2e-5
BWD_TOL = 1e-4
# The Pallas kernels in interpret mode, jitted: one compiled program cached
# by shape instead of an op-by-op run of the grid (the same computation,
# several times faster).
_flash_forward = jax.jit(jatt._flash_forward, static_argnums=(3, 4, 5, 6, 7))
_flash_backward = jax.jit(jatt._flash_backward, static_argnums=(6, 7, 8, 9, 10))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread while this file runs, then the old count.
    Its ops are small; under several test workers on a few cores, torch's
    default of one thread a core made them wait on each other and on the
    other workers (the float64 gradcheck took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (id, q shape, kv shape, causal, pallas block_q, block_k)
SHAPES = [
    ("causal_128", (2, 4, 128, 64), (2, 4, 128, 64), True, 64, 64),
    ("noncausal_ragged_96x160", (2, 2, 96, 64), (2, 2, 160, 64), False, 64, 64),
    ("gqa_8to2_causal", (2, 8, 128, 64), (2, 2, 128, 64), True, 64, 64),
    ("gqa_8to2_noncausal_ragged", (1, 4, 96, 64), (1, 2, 160, 64), False, 64, 64),
    ("bq_gt_bk_ragged_192", (1, 2, 192, 32), (1, 2, 192, 32), True, 128, 64),
    ("cross_length_320x128", (1, 2, 320, 32), (1, 2, 128, 32), True, 64, 64),
    ("cross_length_320x96", (1, 2, 320, 32), (1, 2, 96, 32), True, 64, 64),
    # The Hopper kernels' 128-row q and 128-key tiles: one past a tile, a
    # ragged GQA 4:1 pair of lengths, and one short of two tiles.
    ("causal_129_hd128", (1, 2, 129, 128), (1, 2, 129, 128), True, 64, 64),
    ("gqa_4to1_noncausal_ragged_200x328_hd128", (1, 4, 200, 128), (1, 1, 328, 128), False,
     64, 64),
    ("causal_255_hd64", (1, 2, 255, 64), (1, 2, 255, 64), True, 64, 64),
    # The dQ kernel's pairs of 128-row q tiles (a pair plus a single) and
    # 64-key tiles (one key past a tile).
    ("causal_257_hd128", (1, 2, 257, 128), (1, 2, 257, 128), True, 64, 64),
    ("noncausal_65x65_hd128", (1, 2, 65, 128), (1, 2, 65, 128), False, 64, 64),
]


def _inputs(qs, ks, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(qs).astype(np.float32),
            rng.standard_normal(ks).astype(np.float32),
            rng.standard_normal(ks).astype(np.float32))


def _pallas(q, k, v, causal, scale, bq, bk):
    with jax.default_matmul_precision("highest"):
        o, lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal, scale, bq, bk, True)
        return np.asarray(o), np.asarray(lse)


@pytest.mark.parametrize("name,qs,ks,causal,bq,bk", SHAPES, ids=[s[0] for s in SHAPES])
def test_plain_matches_pallas_interpret(name, qs, ks, causal, bq, bk):
    q, k, v = _inputs(qs, ks)
    scale = qs[-1] ** -0.5
    o_ref, lse_ref = _pallas(q, k, v, causal, scale, bq, bk)
    o, lse = tatt.flash_attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                        causal, scale)
    assert o.shape == qs and lse.shape == qs[:3] and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), o_ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=0, atol=TOL)


def test_future_keys_do_not_leak():
    """Changing keys/values at positions >= 100 leaves rows < 100 exactly
    unchanged (the kernel's top-left causal convention)."""
    q, k, v = (torch.tensor(a) for a in _inputs((2, 4, 128, 64), (2, 4, 128, 64), seed=3))
    o1, _ = tatt.flash_attention_plain(q, k, v, True, 0.125)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 100:] += 1.0
    v2[:, :, 100:] += 1.0
    o2, _ = tatt.flash_attention_plain(q, k2, v2, True, 0.125)
    assert torch.equal(o1[:, :, :100], o2[:, :, :100])
    assert not torch.equal(o1[:, :, 100:], o2[:, :, 100:])


@pytest.mark.parametrize(
    "qs,ks,causal",
    [((2, 4, 32, 16), (2, 4, 32, 16), True),
     ((2, 4, 32, 16), (2, 4, 32, 16), False),
     ((1, 8, 24, 16), (1, 2, 24, 16), True),
     ((1, 2, 16, 16), (1, 2, 40, 16), True)],  # bottom-right mask when k_len > q_len
    ids=["causal", "noncausal", "gqa", "cross_length"],
)
def test_reference_attention_matches_jax(qs, ks, causal):
    q, k, v = _inputs(qs, ks, seed=1)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jatt.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v), causal=causal))
    out = tatt.reference_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)


def test_conventions_agree_at_equal_lengths():
    """Top-left (kernel) and bottom-right (oracle) causal masks coincide
    when q_len == k_len — the case every model path is in."""
    q, k, v = (torch.tensor(a) for a in _inputs((1, 4, 48, 32), (1, 2, 48, 32), seed=2))
    o, _ = tatt.flash_attention_plain(q, k, v, True, 32**-0.5)
    ref = tatt.reference_attention(q, k, v, causal=True)
    torch.testing.assert_close(o, ref, rtol=0, atol=TOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v = (torch.tensor(a) for a in _inputs((1, 4, 40, 32), (1, 2, 40, 32), seed=4))
    before = tatt.flash_attention.launches
    o = tatt.flash_attention(q, k, v)
    assert torch.equal(o, tatt.flash_attention_plain(q, k, v, True, 32**-0.5)[0])
    assert tatt.flash_attention.launches == before
    # bf16 in → bf16 out, like the kernel.
    ob = tatt.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert ob.dtype == torch.bfloat16


def test_kernel_path_rejects_non_cuda_inputs():
    """The kernel wrapper never quietly runs the plain version."""
    q = torch.zeros(1, 2, 16, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_forward_cuda(q, q, q, True, 0.25)


def _pallas_bwd(q, k, v, do, causal, scale, bq, bk):
    """The Pallas forward then backward kernels (interpret mode): o, lse and
    (dq, dk, dv)."""
    with jax.default_matmul_precision("highest"):
        args = [jnp.asarray(a) for a in (q, k, v)]
        o, lse = _flash_forward(*args, causal, scale, bq, bk, True)
        grads = _flash_backward(*args, o, lse, jnp.asarray(do), causal, scale, bq, bk, True)
        return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name,qs,ks,causal,bq,bk", SHAPES, ids=[s[0] for s in SHAPES])
def test_plain_bwd_matches_pallas_interpret(name, qs, ks, causal, bq, bk):
    q, k, v = _inputs(qs, ks, seed=10)
    do = np.random.default_rng(11).standard_normal(qs).astype(np.float32)
    scale = qs[-1] ** -0.5
    o, lse, ref = _pallas_bwd(q, k, v, do, causal, scale, bq, bk)
    got = tatt.flash_attention_bwd_plain(*(torch.tensor(a) for a in (q, k, v, o, lse, do)),
                                         causal, scale)
    for g, r, shape in zip(got, ref, (qs, ks, ks)):
        assert tuple(g.shape) == shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=BWD_TOL)


@pytest.mark.parametrize(
    "qs,ks,causal",
    [((1, 2, 12, 16), (1, 2, 12, 16), True),
     ((1, 4, 10, 16), (1, 2, 10, 16), True),
     ((1, 2, 11, 16), (1, 1, 7, 16), True),
     ((1, 4, 9, 16), (1, 2, 13, 16), False)],
    ids=["causal", "gqa", "cross_length", "gqa_noncausal_ragged"],
)
def test_flash_attention_gradcheck_float64(qs, ks, causal):
    """The custom op's backward (the plain backward on CPU) is the
    derivative of its forward, by finite differences in float64."""
    q, k, v = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
               for a in _inputs(qs, ks, seed=12))
    assert torch.autograd.gradcheck(lambda q, k, v: tatt.flash_attention(q, k, v, causal, 0.3),
                                    (q, k, v))


def test_flash_attention_grads_match_autograd_through_plain():
    """A transposed, non-contiguous upstream grad (as ``attention_block``
    gives) reaches the same gradients as autograd through the plain
    forward; the CPU backward counts no kernel launch."""
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in _inputs((2, 4, 24, 32), (2, 2, 24, 32), seed=13))
    w = torch.tensor(np.random.default_rng(14).standard_normal((2, 24, 4, 32)).astype(np.float32))
    before = (tatt.flash_bwd_dq_cuda.launches, tatt.flash_bwd_dkv_cuda.launches)
    (tatt.flash_attention(q, k, v).transpose(1, 2) * w).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    o = tatt.flash_attention_plain(q, k, v, True, 32**-0.5)[0]
    (o.transpose(1, 2) * w).sum().backward()
    for g, t in zip(got, (q, k, v)):
        torch.testing.assert_close(g, t.grad, rtol=0, atol=1e-5)
    assert (tatt.flash_bwd_dq_cuda.launches, tatt.flash_bwd_dkv_cuda.launches) == before


def test_backward_kernel_path_rejects_non_cuda_inputs():
    """The backward wrapper never quietly runs the plain version."""
    q = torch.zeros(1, 2, 16, 16, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_backward_cuda(q, q, q, q, lse, q, True, 0.25)


def test_dq_kernel_path_rejects_non_cuda_inputs():
    """The dQ wrapper never quietly runs the plain version and counts no
    launch."""
    q = torch.zeros(1, 2, 16, 16, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 16)
    before = tatt.flash_bwd_dq_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_bwd_dq_cuda(q, q, q, q, lse, q, True, 0.25)
    assert tatt.flash_bwd_dq_cuda.launches == before


def _empty(shape, dtype):
    """A tensor of ``shape`` and ``dtype`` without its memory (stride 0)."""
    return torch.empty((1,) * len(shape), dtype=dtype).expand(shape)


# (id, dtype, q shape, kv shape, scale, route)
ROUTES = [
    ("bf16_hd128", torch.bfloat16, (12, 18, 2048, 128), (12, 18, 2048, 128), 0.088, "hopper"),
    ("fp16_hd64_gqa", torch.float16, (2, 8, 128, 64), (2, 2, 128, 64), 0.125, "hopper"),
    ("bf16_hd16", torch.bfloat16, (1, 2, 48, 16), (1, 1, 48, 16), 0.25, "hopper"),
    # b·H = 65,600: the Hopper kernels schedule on a one-dimensional grid.
    ("bf16_bh65600", torch.bfloat16, (4100, 16, 16, 64), (4100, 16, 16, 64), 0.125, "hopper"),
    ("fp32_hd64", torch.float32, (2, 8, 1024, 64), (2, 4, 1024, 64), 0.125, "general"),
    ("bf16_hd256", torch.bfloat16, (1, 16, 2048, 256), (1, 16, 2048, 256), 0.0625, "general"),
    ("fp16_hd72", torch.float16, (1, 4, 300, 72), (1, 2, 500, 72), 0.118, "general"),
    ("bf16_hd24", torch.bfloat16, (1, 2, 8, 24), (1, 2, 8, 24), 0.2, "general"),
    ("bf16_hd144", torch.bfloat16, (1, 2, 8, 144), (1, 2, 8, 144), 0.08, "general"),
    ("bf16_negative_scale", torch.bfloat16, (1, 2, 8, 64), (1, 2, 8, 64), -0.125, "general"),
    ("fp32_hd1", torch.float32, (1, 2, 8, 1), (1, 2, 8, 1), 1.0, "general"),
]


@pytest.mark.parametrize("name,dtype,qs,ks,scale,route", ROUTES, ids=[r[0] for r in ROUTES])
def test_kernel_route(name, dtype, qs, ks, scale, route):
    """The route is a pure function of shape, dtype and scale: it reads no
    data and needs no card."""
    assert tatt._kernel_route(_empty(qs, dtype), _empty(ks, dtype), scale) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_route_raises_above_head_dim_256(dtype):
    """Neither route takes a head dim above 256 (a settled difference: the
    reference's Pallas kernels take any head dim)."""
    q = _empty((1, 2, 8, 264), dtype)
    with pytest.raises(ValueError, match="head_dim 264"):
        tatt._kernel_route(q, q, 0.0625)
    assert tatt._kernel_route(_empty((1, 2, 8, 256), dtype), _empty((1, 2, 8, 256), dtype),
                              0.0625) == "general"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run chip_smoke.py on one)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,qs,ks,causal,bq,bk", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernel_matches_plain_on_card(cuda_device, name, qs, ks, causal, bq, bk):
    """bf16 kernel vs the plain version in fp32 on the same bf16 inputs:
    one bf16 rounding of o plus P rounded to bf16 for P V (2e-2 on o)."""
    q, k, v = (torch.tensor(a, device=cuda_device).bfloat16() for a in _inputs(qs, ks))
    scale = qs[-1] ** -0.5
    o, lse = tatt.flash_forward_cuda(q, k, v, causal, scale)
    o_ref, lse_ref = tatt.flash_attention_plain(q.float(), k.float(), v.float(), causal, scale)
    torch.testing.assert_close(o.float(), o_ref, rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name,qs,ks,causal,bq,bk", SHAPES, ids=[s[0] for s in SHAPES])
def test_bwd_kernels_match_plain_on_card(cuda_device, name, qs, ks, causal, bq, bk):
    """bf16 dQ and dK/dV kernels vs the plain backward in fp32 on the same
    bf16 inputs, o and lse: P and dS rounded to bf16 as the A operand of
    their products, plus the bf16 rounding of the outputs (2e-2 of the
    largest value; chip_smoke.py measured <= 0.5%)."""
    q, k, v = (torch.tensor(a, device=cuda_device).bfloat16() for a in _inputs(qs, ks, seed=10))
    do = torch.tensor(np.random.default_rng(11).standard_normal(qs).astype(np.float32),
                      device=cuda_device).bfloat16()
    scale = qs[-1] ** -0.5
    o, lse = tatt.flash_forward_cuda(q, k, v, causal, scale)
    got = tatt.flash_backward_cuda(q, k, v, o, lse, do, causal, scale)
    ref = tatt.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                         do.float(), causal, scale)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.bfloat16
        assert (g.float() - r).abs().max().item() <= 2e-2 * r.abs().max().item()
