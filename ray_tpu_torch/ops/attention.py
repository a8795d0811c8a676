"""Attention op: the Hopper flash-attention kernels and their plain versions.

Counterpart of ``ray_tpu/ops/attention.py``. Layouts are the JAX
package's: q is ``[batch, q_heads, seq, head_dim]``, k/v are
``[batch, kv_heads, seq, head_dim]`` with ``q_heads % kv_heads == 0``.
GQA is native: the kernels index the shared kv head of each q-head group
and never materialise repeated K/V.

- ``flash_attention``: differentiable (``FlashAttention``, the port of the
  JAX ``custom_vjp``). On CUDA tensors its forward runs the hand-written
  ``sm_90a`` kernel in ``csrc/flash_fwd.cu`` and its backward the dQ
  kernel in ``csrc/flash_bwd.cu`` and the dK/dV kernel in
  ``csrc/flash_bwd_dkv.cu`` (each built at first launch); on CPU
  tensors both run the plain versions. A CUDA input the kernels cannot
  take raises; nothing falls back to the plain version on the card.
- ``flash_attention_plain`` / ``flash_attention_bwd_plain``: the kernels'
  functions in plain PyTorch, with the kernels' TOP-LEFT causal
  convention (``q_id >= k_id``, as ``_flash_fwd_kernel`` and the backward
  kernels mask) and the fp32 ``lse``.
- ``reference_attention``: a faithful port of the JAX oracle, with the
  BOTTOM-RIGHT ``tril(k=k_len-q_len)`` mask. The two conventions agree
  whenever ``q_len == k_len``, which holds on every model path; only the
  tests use this function.
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


def _compute_dtype(q: torch.Tensor) -> torch.dtype:
    """fp32, or fp64 for fp64 inputs (so ``gradcheck`` can run)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _masked_scores(qg, kf, causal: bool, scale: float):
    """``scale · Q Kᵀ`` on the grouped view, with the kernels' top-left
    causal mask (``q_id >= k_id`` kept) set to the finite mask value."""
    s = torch.matmul(qg, kf.transpose(-1, -2)) * scale
    if causal:
        q_len, k_len = s.shape[-2], s.shape[-1]
        q_ids = torch.arange(q_len, device=s.device)[:, None]
        k_ids = torch.arange(k_len, device=s.device)[None, :]
        s = s.masked_fill(q_ids < k_ids, DEFAULT_MASK_VALUE)
    return s


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch → (o in q's dtype, fp32 lse
    ``[b, H, q_len]``). Scores are fp32 (inputs upcast, then scaled), the
    causal mask is top-left, and ``l`` is clamped at 1e-30 as in
    ``_flash_fwd_kernel``. GQA by a grouped view, without repeating K/V.
    fp64 inputs compute, and return ``lse``, in fp64."""
    b, H, q_len, hd = q.shape
    KV, k_len = k.shape[1], k.shape[2]
    G = H // KV
    ct = _compute_dtype(q)
    qg = q.to(ct).reshape(b, KV, G, q_len, hd)
    kf = k.to(ct)[:, :, None]  # [b, KV, 1, k_len, hd]
    vf = v.to(ct)[:, :, None]
    s = _masked_scores(qg, kf, causal, scale)  # [b, KV, G, q_len, k_len]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, vf) / l
    lse = (m + torch.log(l))[..., 0]
    return o.reshape(b, H, q_len, hd).to(q.dtype), lse.reshape(b, H, q_len)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool, scale: float):
    """The backward kernels' function in plain PyTorch → (dq, dk, dv) in
    the inputs' dtypes, dk/dv kv-head shaped ``[b, KV, k_len, hd]``.

    Computed in fp32 (fp64 for fp64 inputs) from the forward's ``o`` and
    ``lse``, as ``_flash_backward`` does: Δ = rowsum(dO∘O), P = exp(S −
    lse) under the top-left mask, dS = P∘(dO·Vᵀ − Δ), dQ = scale·dS·K,
    dK = scale·dSᵀ·Q, dV = Pᵀ·dO; GQA by a grouped view, dK/dV summed
    over each kv head's group of q heads."""
    b, H, q_len, hd = q.shape
    KV, k_len = k.shape[1], k.shape[2]
    G = H // KV
    ct = _compute_dtype(q)
    qg = q.to(ct).reshape(b, KV, G, q_len, hd)
    dog = do.to(ct).reshape(b, KV, G, q_len, hd)
    kf = k.to(ct)[:, :, None]
    vf = v.to(ct)[:, :, None]
    delta = (dog * o.to(ct).reshape(b, KV, G, q_len, hd)).sum(-1, keepdim=True)
    p = torch.exp(_masked_scores(qg, kf, causal, scale)
                  - lse.to(ct).reshape(b, KV, G, q_len, 1))
    ds = p * (torch.matmul(dog, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qg).sum(2) * scale
    dv = torch.matmul(p.transpose(-1, -2), dog).sum(2)
    return dq.reshape(b, H, q_len, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _kernel_fn(lib_name: str, fn_name: str, n_ptrs: int):
    """The C entry point ``fn_name`` of ``csrc/<lib_name>.cu``: ``n_ptrs``
    pointers, then (batch, heads, kv_heads, q_len, k_len, head_dim, scale,
    causal, is_bf16, stream)."""
    from ray_tpu_torch.ops import _build

    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def flash_forward_cuda(q, k, v, causal: bool, scale: float):
    """Launch the ``sm_90a`` kernel → (o, lse). Raises on any input it
    cannot take and on a launch error; never runs the plain version."""
    _check_kernel_inputs(q, k, v)
    if not scale > 0:
        raise ValueError(f"flash_attention kernel: scale must be > 0, got {scale}")
    b, H, q_len, hd = q.shape
    KV, k_len = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, H, q_len), dtype=torch.float32, device=q.device)
    if q_len == 0:
        return o, lse
    if k_len == 0:
        raise ValueError("flash_attention kernel: k_len must be > 0")
    fn = _kernel_fn("flash_fwd", "flash_fwd", 5)
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


def _check_bwd_inputs(q, k, v, like_q: dict, rows: dict):
    """q/k/v as the forward takes them; ``like_q`` tensors of q's shape and
    dtype and fp32 ``rows`` of ``[b, H, q_len]``, all contiguous and 16-byte
    aligned on q's device."""
    _check_kernel_inputs(q, k, v)
    for name, t in like_q.items():
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"flash backward: {name}{tuple(t.shape)}/{t.dtype} must match "
                             f"q{tuple(q.shape)}/{q.dtype}")
    for name, t in rows.items():
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"flash backward: {name} must be fp32 {tuple(q.shape[:3])}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in {**like_q, **rows}.items():
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash backward: {name} must be a contiguous, 16-byte aligned "
                             f"tensor on {q.device}")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash backward kernels: q_len and k_len must be > 0")


def _bwd_shape_args(q, k, causal: bool, scale: float):
    """The shape arguments both backward entry points take after their
    pointers."""
    b, H, q_len, hd = q.shape
    KV, k_len = k.shape[1], k.shape[2]
    return (b, H, KV, q_len, k_len, hd, float(scale), int(bool(causal)),
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)


def flash_bwd_dq_cuda(q, k, v, o, lse, do, causal: bool, scale: float):
    """Launch the ``sm_90a`` dQ kernel → (dq in q's shape and dtype, delta =
    rowsum(dO∘O) fp32 ``[b, H, q_len]``, which the dK/dV kernel reads);
    counts its launches in ``flash_bwd_dq_cuda.launches``."""
    _check_bwd_inputs(q, k, v, {"o": o, "do": do}, {"lse": lse})
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    ptrs = (q, k, v, o, do, lse, dq, delta)
    err = _kernel_fn("flash_bwd", "flash_bwd_dq", len(ptrs))(
        *(t.data_ptr() for t in ptrs), *_bwd_shape_args(q, k, causal, scale))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: cudaError {err}")
    flash_bwd_dq_cuda.launches += 1
    return dq, delta


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Launch the ``sm_90a`` dK/dV kernel → (dk, dv), kv-head shaped;
    counts its launches in ``flash_bwd_dkv_cuda.launches``. ``delta`` is
    the one ``flash_bwd_dq_cuda`` returns."""
    _check_bwd_inputs(q, k, v, {"do": do}, {"lse": lse, "delta": delta})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs = (q, k, v, do, lse, delta, dk, dv)
    err = _kernel_fn("flash_bwd_dkv", "flash_bwd_dkv", len(ptrs))(
        *(t.data_ptr() for t in ptrs), *_bwd_shape_args(q, k, causal, scale))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: cudaError {err}")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dq_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0


def flash_backward_cuda(q, k, v, o, lse, do, causal: bool, scale: float):
    """The backward on the card → (dq, dk, dv), dk/dv kv-head shaped: the
    dQ kernel (which also computes Δ = rowsum(dO∘O)), then the dK/dV
    kernel. Raises on any input the kernels cannot take and on a launch
    error; never runs the plain version."""
    _check_kernel_inputs(q, k, v)
    if q.shape[2] == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, delta = flash_bwd_dq_cuda(q, k, v, o, lse, do, causal, scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward (the port of the JAX
    ``custom_vjp``): saves ``(q, k, v, o, lse)``; the kernels on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, causal, scale)
        else:
            o, lse = flash_forward_cuda(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # The grad arrives as a transposed view ([b, s, H, hd] → [b, H, s, hd]).
        do = do.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        else:
            dq, dk, dv = flash_backward_cuda(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Flash attention → o ``[b, H, q_len, hd]`` in q's dtype, differentiable.

    CUDA tensors run the hand-written kernels (``flash_attention.launches``
    counts forward launches, ``flash_bwd_dq_cuda.launches`` and
    ``flash_bwd_dkv_cuda.launches`` backward ones); CPU tensors run the
    plain versions."""
    s = scale if scale is not None else q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, causal, s)


flash_attention.launches = 0
