"""ray_tpu_torch.ops.attention against ray_tpu.ops.attention.

The port's plain flash forward is held to the Pallas kernel itself
(``_flash_forward(..., interpret=True)``) on ``o`` AND ``lse``, at the
shapes ``tests/test_models.py`` uses for the kernel. Inputs come from a
numpy seed and go through both packages. Both sides compute in fp32 (the
JAX side under ``default_matmul_precision("highest")``), so the tolerance
is fp32 summation-order noise on O(1) values: 2e-5.

The CUDA kernel itself only runs on the card: ``test_kernel_matches_plain_on_card``
is marked ``cuda`` and skips without one; ``chip_smoke.py`` is its full check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu_torch.ops import attention as tatt

TOL = 2e-5

# (id, q shape, kv shape, causal, pallas block_q, block_k)
SHAPES = [
    ("causal_128", (2, 4, 128, 64), (2, 4, 128, 64), True, 64, 64),
    ("noncausal_ragged_96x160", (2, 2, 96, 64), (2, 2, 160, 64), False, 64, 64),
    ("gqa_8to2_causal", (2, 8, 128, 64), (2, 2, 128, 64), True, 64, 64),
    ("gqa_8to2_noncausal_ragged", (1, 4, 96, 64), (1, 2, 160, 64), False, 64, 64),
    ("bq_gt_bk_ragged_192", (1, 2, 192, 32), (1, 2, 192, 32), True, 128, 64),
    ("cross_length_320x128", (1, 2, 320, 32), (1, 2, 128, 32), True, 64, 64),
    ("cross_length_320x96", (1, 2, 320, 32), (1, 2, 96, 32), True, 64, 64),
]


def _inputs(qs, ks, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(qs).astype(np.float32),
            rng.standard_normal(ks).astype(np.float32),
            rng.standard_normal(ks).astype(np.float32))


def _pallas(q, k, v, causal, scale, bq, bk):
    with jax.default_matmul_precision("highest"):
        o, lse = jatt._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
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
