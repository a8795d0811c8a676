"""Attention op: the Hopper flash-attention forward kernel and its plain version.

Counterpart of ``ray_tpu/ops/attention.py``. Layouts are the JAX
package's: q is ``[batch, q_heads, seq, head_dim]``, k/v are
``[batch, kv_heads, seq, head_dim]`` with ``q_heads % kv_heads == 0``.
GQA is native: the kernel indexes the shared kv head of each q-head group
and never materialises repeated K/V.

- ``flash_attention``: a CUDA tensor goes to the hand-written ``sm_90a``
  kernel in ``csrc/flash_fwd.cu`` (built at first launch); a CPU tensor
  goes to ``flash_attention_plain``. A CUDA input the kernel cannot take
  raises; nothing falls back to the plain version on the card.
- ``flash_attention_plain``: the same function in plain PyTorch, with the
  kernel's TOP-LEFT causal convention (``q_id >= k_id``, as
  ``_flash_fwd_kernel`` masks) and its fp32 ``lse``.
- ``reference_attention``: a faithful port of the JAX oracle, with the
  BOTTOM-RIGHT ``tril(k=k_len-q_len)`` mask. The two conventions agree
  whenever ``q_len == k_len``, which holds on every model path; only the
  tests use this function.

Forward only: the autograd Function and the backward kernels
(``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``) come with training.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_KERNEL_DTYPES = (torch.bfloat16, torch.float16)


def reference_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Oracle: ``ray_tpu.ops.attention.reference_attention``."""
    *_, q_len, head_dim = q.shape
    if k.shape[1] != q.shape[1]:  # GQA: expand kv heads for the oracle
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    k_len = k.shape[-2]
    scale = scale if scale is not None else head_dim**-0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    logits = logits * scale
    if causal:
        mask = torch.ones(q_len, k_len, dtype=torch.bool, device=q.device).tril(k_len - q_len)
        logits = torch.where(mask, logits, torch.full_like(logits, DEFAULT_MASK_VALUE))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch → (o in q's dtype, fp32 lse
    ``[b, H, q_len]``). Scores are fp32 (inputs upcast, then scaled), the
    causal mask is top-left, and ``l`` is clamped at 1e-30 as in
    ``_flash_fwd_kernel``. GQA by a grouped view, without repeating K/V."""
    b, H, q_len, hd = q.shape
    KV, k_len = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(b, KV, G, q_len, hd)
    kf = k.float()[:, :, None]  # [b, KV, 1, k_len, hd]
    vf = v.float()[:, :, None]
    s = torch.matmul(qg, kf.transpose(-1, -2)) * scale  # [b, KV, G, q_len, k_len]
    if causal:
        q_ids = torch.arange(q_len, device=q.device)[:, None]
        k_ids = torch.arange(k_len, device=q.device)[None, :]
        s = s.masked_fill(q_ids < k_ids, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, vf) / l
    lse = (m + torch.log(l))[..., 0]
    return o.reshape(b, H, q_len, hd).to(q.dtype), lse.reshape(b, H, q_len)


def _check_kernel_inputs(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"flash_attention: q, k, v must share one CUDA device "
            f"(got {q.device}, {k.device}, {v.device})"
        )
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes bf16 or fp16 q/k/v of one dtype "
            f"(got {q.dtype}, {k.dtype}, {v.dtype})"
        )
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    b, H, q_len, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    if hd % 16 or hd > 128:
        raise ValueError(f"flash_attention kernel: head_dim {hd} must be a multiple of 16, <= 128")
    if b * H > 65535:
        raise ValueError(f"flash_attention kernel: batch*heads {b * H} > 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must be 16-byte aligned")


def _kernel_lib():
    from ray_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def flash_forward_cuda(q, k, v, causal: bool, scale: float):
    """Launch the ``sm_90a`` kernel → (o, lse). Raises on any input it
    cannot take and on a launch error; never runs the plain version."""
    _check_kernel_inputs(q, k, v)
    b, H, q_len, hd = q.shape
    KV, k_len = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, H, q_len), dtype=torch.float32, device=q.device)
    if q_len == 0:
        return o, lse
    if k_len == 0:
        raise ValueError("flash_attention kernel: k_len must be > 0")
    fn = _kernel_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, H, KV, q_len, k_len, hd, float(scale), int(bool(causal)),
        int(q.dtype == torch.bfloat16), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return o, lse


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Flash attention forward → o ``[b, H, q_len, hd]`` in q's dtype.

    CUDA tensors run the hand-written kernel (``flash_attention.launches``
    counts its launches); CPU tensors run ``flash_attention_plain``."""
    s = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, s)[0]
    return flash_forward_cuda(q, k, v, causal, s)[0]


flash_attention.launches = 0
