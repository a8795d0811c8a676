"""The fp32 attention route ("hopper_fp32": ``csrc/flash_fwd_fp32.cu``,
``csrc/flash_bwd_dq_fp32.cu`` and ``csrc/flash_bwd_dkv_fp32.cu``) against
``ray_tpu.ops.attention``.

Its kernels compute fp32 products on bf16 tensor cores by a three-way
split (``csrc/flash_fp32.cuh``): every operand x = b0 + b1 + b2 in bf16,
P and dS split the same way in registers, and a product a·b taken as the
six leading terms a1b1 + a0b2 + a2b0 + a0b1 + a1b0 + a0b0 with fp32
accumulation. The kernels only run on the card (``cuda`` marker;
``chip_smoke.py`` is their full check), so here a plain-PyTorch emulation
of that arithmetic, with the same splits, is held to the Pallas kernels in
interpret mode at fp32 ("highest" matmul precision), within the card
tolerances ``chip_smoke.py`` holds the kernels to: 2e-4 on o and lse,
1e-4 of the largest value on dQ, dK and dV, and 1e-4 of the largest |Δ| on
the dQ kernel's Δ = rowsum(dO∘O). The same emulation with one bf16
rounding of each operand (only a0·b0) must read at least 10x the split's
error, so the card check can tell the two apart. The routes, the dK/dV
kernel's block plan and the card tests are in the JAX-free
``tests/test_torch_attention_fp32_card.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu_torch.ops import attention as tatt
from test_torch_attention_fp32_card import (DELTA_REL_TOL, DKV_REL_TOL, LSE_TOL, O_TOL, SHAPES,
                                            _inputs)

# One Pallas block over each whole sequence (no ragged blocks in interpret
# mode); jitted so each shape compiles once.
BLOCK = 512
_flash_forward = jax.jit(jatt._flash_forward, static_argnums=(3, 4, 5, 6, 7))
_flash_backward = jax.jit(jatt._flash_backward, static_argnums=(6, 7, 8, 9, 10))
# The six (A part, B part) products of the split, smallest first.
TERMS = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread while this file runs, then the old count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def split3(x: torch.Tensor):
    """x's three bf16 parts, as fp32: b0 = bf16(x), b1 = bf16(x - b0),
    b2 = bf16(x - b0 - b1) (both differences exact in fp32)."""
    b0 = x.to(torch.bfloat16).float()
    r = x - b0
    b1 = r.to(torch.bfloat16).float()
    return b0, b1, (r - b1).to(torch.bfloat16).float()


def split_matmul(a, b, terms=TERMS):
    """a @ b as the kernels take it: the sum, in ``terms``' order, of the
    products of a's and b's bf16 parts, each exact and summed in fp32."""
    pa, pb = split3(a), split3(b)
    out = None
    for i, j in terms:
        p = torch.matmul(pa[i], pb[j])
        out = p if out is None else out + p
    return out


def _mask(s, causal):
    if causal:
        q_ids = torch.arange(s.shape[-2])[:, None]
        k_ids = torch.arange(s.shape[-1])[None, :]
        s = s.masked_fill(q_ids < k_ids, tatt.DEFAULT_MASK_VALUE)
    return s


def emulated_forward(q, k, v, causal, scale, terms=TERMS):
    """The fp32 forward kernel's arithmetic → (o, lse): S = Q Kᵀ split,
    the fp32 softmax, P (unnormalised, in [0, 1]) split against V's
    parts, then divided by l. GQA by a grouped view."""
    b, H, ql, hd = q.shape
    KV = k.shape[1]
    qg = q.reshape(b, KV, H // KV, ql, hd)
    s = _mask(split_matmul(qg, k[:, :, None].transpose(-1, -2), terms) * scale, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = split_matmul(p, v[:, :, None], terms) / l
    return o.reshape(b, H, ql, hd), (m + torch.log(l))[..., 0].reshape(b, H, ql)


def emulated_dkv(q, k, v, o, lse, do, causal, scale, terms=TERMS):
    """The fp32 dK/dV kernel's arithmetic → (dk, dv), kv-head shaped:
    P = exp(scale·S − lse) with S split, dP = dO Vᵀ split, dS = P (dP − Δ)
    with Δ = rowsum(dO∘O), then dV = Pᵀ dO and
    dK = scale·dSᵀ Q with Pᵀ and dSᵀ split; summed over each group (Δ is
    the fp32 dQ kernel's, ``emulated_dq``)."""
    b, H, ql, hd = q.shape
    KV = k.shape[1]
    g = H // KV
    qg, dog = (t.reshape(b, KV, g, ql, hd) for t in (q, do))
    delta = (dog * o.reshape(b, KV, g, ql, hd)).sum(-1, keepdim=True)
    kt, vt = k[:, :, None].transpose(-1, -2), v[:, :, None].transpose(-1, -2)
    s = _mask(split_matmul(qg, kt, terms) * scale, causal)
    p = torch.exp(s - lse.reshape(b, KV, g, ql, 1))
    ds = p * (split_matmul(dog, vt, terms) - delta)
    dv = split_matmul(p.transpose(-1, -2), dog, terms).sum(2)
    dk = split_matmul(ds.transpose(-1, -2), qg, terms).sum(2) * scale
    return dk, dv


def emulated_dq(q, k, v, o, lse, do, causal, scale, terms=TERMS):
    """The fp32 dQ kernel's arithmetic → (dq, delta): Δ = rowsum(dO∘O) in
    fp32 (its split pass over dO), P = exp(scale·S − lse) with S = Q Kᵀ
    split, dP = dO Vᵀ split, dS = P (dP − Δ) in fp32, then dQ = scale·dS K
    with dS split against K's parts. GQA by a grouped view."""
    b, H, ql, hd = q.shape
    KV = k.shape[1]
    g = H // KV
    qg, dog = (t.reshape(b, KV, g, ql, hd) for t in (q, do))
    delta = (dog * o.reshape(b, KV, g, ql, hd)).sum(-1, keepdim=True)
    kt, vt = k[:, :, None].transpose(-1, -2), v[:, :, None].transpose(-1, -2)
    s = _mask(split_matmul(qg, kt, terms) * scale, causal)
    p = torch.exp(s - lse.reshape(b, KV, g, ql, 1))
    ds = p * (split_matmul(dog, vt, terms) - delta)
    dq = split_matmul(ds, k[:, :, None], terms) * scale
    return dq.reshape(b, H, ql, hd), delta.reshape(b, H, ql)


def _pallas(arrays, causal, scale):
    """(o, lse, dq, dk, dv, Δ) of the Pallas kernels in interpret mode;
    Δ = rowsum(dO∘O) of the JAX side's o and dO, as ``_flash_backward``
    computes it."""
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    with jax.default_matmul_precision("highest"):
        o, lse = _flash_forward(jq, jk, jv, causal, scale, BLOCK, BLOCK, True)
        dq, dk, dv = _flash_backward(jq, jk, jv, o, lse, jdo, causal, scale, BLOCK, BLOCK, True)
    delta = jnp.sum(jdo.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    return [torch.tensor(np.asarray(x, np.float32)) for x in (o, lse, dq, dk, dv, delta)]


@pytest.mark.parametrize("name,qs,ks,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_split_forward_matches_pallas_interpret(name, qs, ks, causal):
    arrays = _inputs(qs, ks, seed=50)
    scale = qs[-1] ** -0.5
    o_ref, lse_ref, *_ = _pallas(arrays, causal, scale)
    q, k, v, _ = (torch.tensor(a) for a in arrays)
    o, lse = emulated_forward(q, k, v, causal, scale)
    o_err = (o - o_ref).abs().max().item()
    assert o_err <= O_TOL and (lse - lse_ref).abs().max().item() <= LSE_TOL
    o1, _ = emulated_forward(q, k, v, causal, scale, terms=((0, 0),))
    assert (o1 - o_ref).abs().max().item() >= 10 * max(o_err, 1e-7)


@pytest.mark.parametrize("name,qs,ks,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_split_dkv_matches_pallas_interpret(name, qs, ks, causal):
    arrays = _inputs(qs, ks, seed=51)
    scale = qs[-1] ** -0.5
    o, lse, _, dk_ref, dv_ref, _ = _pallas(arrays, causal, scale)
    q, k, v, do = (torch.tensor(a) for a in arrays)
    errs, errs1 = [], []
    for terms, out in ((TERMS, errs), (((0, 0),), errs1)):
        dk, dv = emulated_dkv(q, k, v, o, lse, do, causal, scale, terms)
        for got, ref in ((dk, dk_ref), (dv, dv_ref)):
            assert got.shape == ref.shape == ks
            out.append((got - ref).abs().max().item() / ref.abs().max().item())
        if causal and ks[2] > qs[2]:
            assert not dk[:, :, qs[2]:].count_nonzero() and not dv[:, :, qs[2]:].count_nonzero()
    assert max(errs) <= DKV_REL_TOL, errs
    assert min(errs1) >= 10 * max(max(errs), 1e-7), (errs, errs1)


@pytest.mark.parametrize("name,qs,ks,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_split_dq_matches_pallas_interpret(name, qs, ks, causal):
    """The fp32 dQ kernel's arithmetic (``emulated_dq``) and
    ``flash_attention_bwd_plain``'s dq against the Pallas ``_flash_backward``'s
    dq (interpret mode, "highest" precision), each within ``DKV_REL_TOL``
    (1e-4) of the largest value: at these shapes the emulation reads
    <= 8e-7 and plain fp32 <= 1.1e-6, so 1e-4 is the card's tolerance, not
    a margin for these. Δ against rowsum(dO∘O) of the JAX side's o and dO within
    ``DELTA_REL_TOL`` (1e-4) of the largest |Δ|: both are fp32 sums of the
    same hd products in another order (~1e-7). One bf16 rounding of each
    operand (only a0·b0) must read at least 10x the split's error."""
    arrays = _inputs(qs, ks, seed=55)
    scale = qs[-1] ** -0.5
    o, lse, dq_ref, _, _, delta_ref = _pallas(arrays, causal, scale)
    q, k, v, do = (torch.tensor(a) for a in arrays)

    def rel(got):
        assert got.shape == dq_ref.shape == qs
        return (got - dq_ref).abs().max().item() / dq_ref.abs().max().item()

    dq, delta = emulated_dq(q, k, v, o, lse, do, causal, scale)
    err = rel(dq)
    assert err <= DKV_REL_TOL, err
    plain_dq = tatt.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)[0]
    assert rel(plain_dq) <= DKV_REL_TOL
    delta_err = (delta - delta_ref).abs().max().item() / delta_ref.abs().max().item()
    assert delta.shape == delta_ref.shape == qs[:3] and delta_err <= DELTA_REL_TOL, delta_err
    dq1, _ = emulated_dq(q, k, v, o, lse, do, causal, scale, terms=((0, 0),))
    assert rel(dq1) >= 10 * max(err, 1e-7), (err, rel(dq1))


def test_split3_parts_sum_to_fp32():
    """The three parts hold x to within 2^-24 of |x| (a 24-bit mantissa
    plus the rounding of the last part), and each part is a bf16 value."""
    x = torch.tensor(np.random.default_rng(52).standard_normal(4096).astype(np.float32) * 30)
    parts = split3(x)
    for p in parts:
        assert torch.equal(p, p.to(torch.bfloat16).float())
    err = (x.double() - sum(p.double() for p in parts)).abs()
    assert (err <= x.double().abs() * 2.0**-24).all()
