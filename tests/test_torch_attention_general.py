"""The flash-attention custom ops and their general route
(``csrc/flash_general.cu``) against ``ray_tpu.ops.attention``: the shapes
and types only the general kernels take on the card (head dim 72 or 256,
fp32 and bf16 inputs), and ``torch.library.opcheck`` of both ops.

The plain versions are held to the Pallas kernels in interpret mode, as in
``tests/test_torch_attention.py`` and with its tolerances: 2e-5 (forward)
and 1e-4 (backward) on fp32 values. bf16 outputs may differ by the one
bf16 rounding of two nearly equal fp32 values: one ulp, 2^-7 relative.
The general kernels themselves only run on the card (``cuda`` marker);
``chip_smoke.py`` is their full check.
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
    """One torch intra-op thread while this file runs, then the old count
    (small ops; several test workers share a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(qs, ks, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(qs).astype(np.float32),
            rng.standard_normal(ks).astype(np.float32),
            rng.standard_normal(ks).astype(np.float32))


# Shapes only the general kernels take on the card (head dim 72 or 256),
# in fp32 and bf16: (id, q shape, kv shape, causal, dtype).
GENERAL_SHAPES = [
    ("hd256_causal_48", (1, 2, 48, 256), (1, 2, 48, 256), True, "float32"),
    ("hd72_gqa_noncausal_ragged_40x56", (1, 4, 40, 72), (1, 2, 56, 72), False, "float32"),
    ("hd256_cross_length_72x40", (1, 2, 72, 256), (1, 2, 40, 256), True, "float32"),
    ("bf16_hd72_causal_40", (1, 2, 40, 72), (1, 2, 40, 72), True, "bfloat16"),
    ("bf16_hd256_gqa_causal_40", (1, 4, 40, 256), (1, 2, 40, 256), True, "bfloat16"),
    ("bf16_hd64_cross_length_70x24", (1, 2, 70, 64), (1, 2, 24, 64), True, "bfloat16"),
]
# One bf16 rounding of fp32 values that agree to TOL: one ulp, 2^-7 relative.
BF16_RTOL = 2.0**-7


def _as(arrays, dtype):
    """The same values in both packages, rounded to ``dtype`` on each side."""
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _assert_close(got, want, atol, dtype):
    rtol = BF16_RTOL if dtype == "bfloat16" else 0
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name,qs,ks,causal,dtype", GENERAL_SHAPES,
                         ids=[s[0] for s in GENERAL_SHAPES])
def test_plain_matches_pallas_interpret_general_shapes(name, qs, ks, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _as(_inputs(qs, ks, seed=20), dtype)
    scale = qs[-1] ** -0.5
    with jax.default_matmul_precision("highest"):
        o_ref, lse_ref = _flash_forward(jq, jk, jv, causal, scale, 64, 64, True)
    o, lse = tatt.flash_attention_plain(tq, tk, tv, causal, scale)
    _assert_close(o, o_ref, TOL, dtype)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("name,qs,ks,causal,dtype", GENERAL_SHAPES,
                         ids=[s[0] for s in GENERAL_SHAPES])
def test_plain_bwd_matches_pallas_interpret_general_shapes(name, qs, ks, causal, dtype):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _as(
        (*_inputs(qs, ks, seed=21),
         np.random.default_rng(22).standard_normal(qs).astype(np.float32)), dtype)
    scale = qs[-1] ** -0.5
    with jax.default_matmul_precision("highest"):
        o, lse = _flash_forward(jq, jk, jv, causal, scale, 64, 64, True)
        ref = _flash_backward(jq, jk, jv, o, lse, jdo, causal, scale, 64, 64, True)
    o_t = torch.tensor(np.asarray(o, np.float32)).to(tq.dtype)
    got = tatt.flash_attention_bwd_plain(tq, tk, tv, o_t, torch.tensor(np.asarray(lse)), tdo,
                                         causal, scale)
    for g, r, shape in zip(got, ref, (qs, ks, ks)):
        assert tuple(g.shape) == shape
        _assert_close(g, r, BWD_TOL, dtype)


@pytest.mark.parametrize(
    "qs,ks,causal",
    [((1, 4, 10, 16), (1, 2, 10, 16), True), ((1, 2, 9, 24), (1, 2, 13, 24), False)],
    ids=["gqa_causal", "noncausal_ragged"],
)
def test_custom_ops_pass_opcheck(qs, ks, causal):
    """Both custom ops against ``torch.library.opcheck`` on CPU tensors:
    schema, fake (meta) shapes, autograd registration and AOT dispatch."""
    q, k, v = (torch.tensor(a, requires_grad=True) for a in _inputs(qs, ks, seed=23))
    torch.library.opcheck(torch.ops.ray_tpu_torch.flash_fwd.default, (q, k, v, causal, 0.3))
    o, lse = tatt.flash_fwd(q.detach(), k.detach(), v.detach(), causal, 0.3)
    do = torch.tensor(np.random.default_rng(24).standard_normal(qs).astype(np.float32))
    torch.library.opcheck(torch.ops.ray_tpu_torch.flash_bwd.default,
                          (q.detach(), k.detach(), v.detach(), o, lse, do, causal, 0.3))


def test_custom_op_lse_carries_no_gradient():
    """``lse`` is an output of the forward op but not differentiable; the
    op's backward is ``flash_bwd`` on the saved (q, k, v, o, lse)."""
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in _inputs((1, 2, 8, 16), (1, 2, 8, 16), seed=25))
    o, lse = tatt.flash_fwd(q, k, v, True, 0.25)
    assert o.requires_grad and not lse.requires_grad
    do = torch.ones_like(o)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = tatt.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(), lse, do,
                                          True, 0.25)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run chip_smoke.py on one)")
    return torch.device("cuda")


def _card_inputs(qs, ks, dtype, device, seed):
    q, k, v = (torch.tensor(a, device=device).to(dtype) for a in _inputs(qs, ks, seed=seed))
    do = torch.tensor(np.random.default_rng(seed + 1).standard_normal(qs).astype(np.float32),
                      device=device).to(dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("name,qs,ks,causal,dtype", GENERAL_SHAPES,
                         ids=[s[0] for s in GENERAL_SHAPES])
def test_general_kernels_match_plain_on_card(cuda_device, name, qs, ks, causal, dtype):
    """The general forward, dQ and dK/dV kernels vs the plain versions on
    the same inputs (fp32 arithmetic on both sides; one rounding of the
    outputs): o within 2e-4 (fp32) or 1e-2 of max(1, |o|) (bf16), lse
    within 2e-4, gradients within 2% of the largest value."""
    q, k, v, do = _card_inputs(qs, ks, getattr(torch, dtype), cuda_device, 30)
    scale = qs[-1] ** -0.5
    o, lse = tatt.flash_general_forward_cuda(q, k, v, causal, scale)
    o_ref, lse_ref = tatt.flash_attention_plain(q.float(), k.float(), v.float(), causal, scale)
    tol = 2e-4 if dtype == "float32" else 1e-2
    assert ((o.float() - o_ref).abs() / o_ref.abs().clamp_min(1)).max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= 2e-4
    got = tatt.flash_general_backward_cuda(q, k, v, o, lse, do, causal, scale)
    ref = tatt.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                         do.float(), causal, scale)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == q.dtype
        assert (g.float() - r).abs().max().item() <= 2e-2 * r.abs().max().item()


@pytest.mark.cuda
def test_flash_attention_routes_fp32_to_general_and_raises_above_256(cuda_device):
    """fp32 inputs train through the general kernels (no plain version on
    the card); head dim 264 raises."""
    q, k, v, do = _card_inputs((1, 4, 40, 64), (1, 2, 40, 64), torch.float32, cuda_device, 31)
    for t in (q, k, v):
        t.requires_grad_(True)
    before = (tatt.flash_general_forward_cuda.launches, tatt.flash_general_dq_cuda.launches,
              tatt.flash_general_dkv_cuda.launches, tatt.flash_attention.launches)
    torch.autograd.grad(tatt.flash_attention(q, k, v), (q, k, v), do)
    after = (tatt.flash_general_forward_cuda.launches, tatt.flash_general_dq_cuda.launches,
             tatt.flash_general_dkv_cuda.launches, tatt.flash_attention.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 0]
    big = torch.zeros(1, 2, 8, 264, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim 264"):
        tatt.flash_attention(big, big, big)
