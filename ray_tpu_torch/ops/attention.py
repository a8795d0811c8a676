"""Attention op: the Hopper flash-attention kernels and their plain versions.

Counterpart of ``ray_tpu/ops/attention.py``. Layouts are the JAX
package's: q is ``[batch, q_heads, seq, head_dim]``, k/v are
``[batch, kv_heads, seq, head_dim]`` with ``q_heads % kv_heads == 0``.
GQA is native: the kernels index the shared kv head of each q-head group
and never materialise repeated K/V.

- ``flash_attention``: differentiable, through the custom ops
  ``ray_tpu_torch::flash_fwd`` → (o, lse) and ``ray_tpu_torch::flash_bwd``
  → (dq, dk, dv) (the port of the JAX ``custom_vjp``; as ops they are
  opaque to the dispatcher, so a selective checkpoint policy can save
  their outputs). On CUDA tensors each op runs hand-written ``sm_90a``
  kernels (built at first launch) on one of four routes, chosen by
  ``_kernel_route`` from dtype, head dim and scale:
  - "hopper" (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu`` for dQ,
    ``csrc/flash_bwd_dkv.cu`` for dK/dV): bf16/fp16, head dim up to 128,
    scale > 0;
  - "hopper_wide" (``csrc/flash_fwd_wide.cu``, ``csrc/flash_bwd_wide.cu``
    for dQ, ``csrc/flash_bwd_dkv_wide.cu`` for dK/dV): bf16/fp16, head dim
    129-256, scale > 0;
  - "hopper_fp32" (``csrc/flash_fwd_fp32.cu``, ``csrc/flash_bwd_dq_fp32.cu``
    for dQ, ``csrc/flash_bwd_dkv_fp32.cu`` for dK/dV): fp32, head dim up to
    128 and a multiple of 4, scale > 0; bf16 wgmma on a three-way bf16
    split of every operand (fp32-accurate);
  - "general" (``csrc/flash_general.cu``, SIMT): ``scale <= 0`` at any
    dtype, and fp32 at head dims off the 4 grid or in 129-256.
  The TMA kernels of the first two take head dims that are multiples of 8
  (a TMA row is a multiple of 16 bytes) and zero-fill the columns up to
  their tile width; any other head dim goes through one zero-padded copy
  to the next multiple of 8 (``stage_head_dim``); fp32 is never staged. On
  CPU tensors the ops
  run the plain versions. A CUDA input no route takes raises; nothing
  falls back to the plain version on the card.
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
import functools
from typing import Optional, Tuple

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_KERNEL_DTYPES = (torch.bfloat16, torch.float16)
# The routes whose kernels are built on TMA and wgmma over 16-bit inputs
# (16-byte aligned): the head dims each takes, and the grain of the head
# dims their tensor maps take (rows of a multiple of 16 bytes), below which
# the ops stage. The wide route starts where the Hopper tiles (D <= 128)
# end, at D = 192.
_TMA_ROUTES = ("hopper", "hopper_wide")
HOPPER_MAX_HEAD_DIM = 128
WIDE_MIN_HEAD_DIM = HOPPER_MAX_HEAD_DIM + 1
TMA_HEAD_DIM_GRAIN = 8
# The fp32 route's kernels load fp32 tiles by TMA too (16-byte aligned, rows
# of a multiple of 16 bytes: head dims a multiple of 4, up to the Hopper
# tiles' 128); they are never staged.
FP32_HEAD_DIM_GRAIN = 4
_ALIGNED_ROUTES = _TMA_ROUTES + ("hopper_fp32",)
# The general kernels' element types, by the code their entry points take.
_GENERAL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
GENERAL_MAX_HEAD_DIM = 256


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


def _kernel_route(q, k, scale: float) -> str:
    """Which kernels take these inputs on the card. For bf16/fp16 q and k
    of one dtype and ``scale > 0``: ``"hopper"`` up to head dim 128 (the
    TMA/``wgmma`` kernels of ``csrc/flash_fwd.cu``, ``flash_bwd.cu`` and
    ``flash_bwd_dkv.cu``) and ``"hopper_wide"`` in 129-256
    (``csrc/flash_fwd_wide.cu``, ``flash_bwd_wide.cu`` and
    ``flash_bwd_dkv_wide.cu``), a head dim off the 8 grid through one
    zero-padded copy (``stage_head_dim``). For fp32 q and k with ``scale >
    0`` and a head dim up to 128 that is a multiple of
    ``FP32_HEAD_DIM_GRAIN``: ``"hopper_fp32"`` (``csrc/flash_fwd_fp32.cu``,
    ``flash_bwd_dq_fp32.cu``, ``flash_bwd_dkv_fp32.cu``). ``"general"``
    (``csrc/flash_general.cu``) for the rest: ``scale <= 0``, and fp32 off
    the 4 grid or in 129-256. A pure
    function of shape, dtype and scale: it is not a fallback, and every
    route raises on a failed build or launch. Raises above head dim 256,
    which no route takes (the reference's Pallas kernels take any head
    dim)."""
    hd = q.shape[-1]
    if hd > GENERAL_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernels: head_dim {hd} > {GENERAL_MAX_HEAD_DIM}")
    if q.dtype in _KERNEL_DTYPES and k.dtype == q.dtype and scale > 0:
        return "hopper" if hd <= HOPPER_MAX_HEAD_DIM else "hopper_wide"
    if (q.dtype == torch.float32 and k.dtype == q.dtype and scale > 0
            and hd <= HOPPER_MAX_HEAD_DIM and hd % FP32_HEAD_DIM_GRAIN == 0):
        return "hopper_fp32"
    return "general"


def _check_kernel_inputs(q, k, v, route: str = "hopper"):
    """q/k/v as the ``route``'s kernels take them: one CUDA device, one
    dtype (bf16/fp16 for "hopper" and "hopper_wide"; fp32 for
    "hopper_fp32"; fp32, bf16 or fp16 for "general"), GQA-compatible 4-D
    shapes, the route's head dims, contiguous (and 16-byte aligned for the
    TMA loads of the Hopper routes)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"flash_attention: q, k, v must share one CUDA device "
            f"(got {q.device}, {k.device}, {v.device})"
        )
    dtypes = (_KERNEL_DTYPES if route in _TMA_ROUTES else
              (torch.float32,) if route == "hopper_fp32" else tuple(_GENERAL_DTYPES))
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention {route} kernels take q/k/v of one dtype in {dtypes} "
            f"(got {q.dtype}, {k.dtype}, {v.dtype})"
        )
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    b, H, q_len, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    if route == "hopper" and (hd % TMA_HEAD_DIM_GRAIN or hd > HOPPER_MAX_HEAD_DIM):
        raise ValueError(f"flash_attention kernel: head_dim {hd} must be a multiple of "
                         f"{TMA_HEAD_DIM_GRAIN}, <= {HOPPER_MAX_HEAD_DIM}")
    if route == "hopper_wide" and (hd % TMA_HEAD_DIM_GRAIN
                                   or not WIDE_MIN_HEAD_DIM <= hd <= GENERAL_MAX_HEAD_DIM):
        raise ValueError(f"flash_attention wide kernels: head_dim {hd} must be a multiple of "
                         f"{TMA_HEAD_DIM_GRAIN} in [{WIDE_MIN_HEAD_DIM}, {GENERAL_MAX_HEAD_DIM}]")
    if route == "hopper_fp32" and (hd % FP32_HEAD_DIM_GRAIN or hd > HOPPER_MAX_HEAD_DIM):
        raise ValueError(f"flash_attention fp32 kernels: head_dim {hd} must be a multiple of "
                         f"{FP32_HEAD_DIM_GRAIN}, <= {HOPPER_MAX_HEAD_DIM}")
    if not 0 < hd <= GENERAL_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention general kernels: head_dim {hd} must be in "
                         f"[1, {GENERAL_MAX_HEAD_DIM}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be contiguous")
        if route in _ALIGNED_ROUTES and t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must be 16-byte aligned")


def _kernel_fn(lib_name: str, fn_name: str, n_ptrs: int, n_flags: int = 1):
    """The C entry point ``fn_name`` of ``csrc/<lib_name>.cu``: ``n_ptrs``
    pointers, then (batch, heads, kv_heads, q_len, k_len, head_dim, scale,
    causal, flags, stream); the one flag is ``is_bf16`` for the Hopper
    kernels, the ``_GENERAL_DTYPES`` code for the general ones and unused
    (0) by the fp32 forward; the fp32 dK/dV kernel takes two, its
    ``fp32_dkv_plan``."""
    from ray_tpu_torch.ops import _build

    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int] + [ctypes.c_int] * n_flags + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _shape_args(q, k, causal: bool, scale: float, *flags: int):
    """The shape arguments every entry point takes after its pointers."""
    b, H, q_len, hd = q.shape
    KV, k_len = k.shape[1], k.shape[2]
    return (b, H, KV, q_len, k_len, hd, float(scale), int(bool(causal)), *flags,
            torch.cuda.current_stream(q.device).cuda_stream)


def _launch(lib_name: str, fn_name: str, ptrs, shape_args):
    # The kernels' libraries carry their own CUDA runtime: in a host thread
    # where torch has not made the card current, their first launch fails
    # (cudaErrorInvalidValue). set_device does it (a device guard does not);
    # the caller's current device is put back after the launch.
    device, prev = ptrs[0].device, torch.cuda.current_device()
    torch.cuda.set_device(device)
    try:
        fn = _kernel_fn(lib_name, fn_name, len(ptrs), len(shape_args) - 9)
        err = fn(*(t.data_ptr() for t in ptrs), *shape_args)
    finally:
        if prev != device.index:
            torch.cuda.set_device(prev)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {err}")


def _fwd_outputs(q, k):
    if k.shape[2] == 0 and q.shape[2]:
        raise ValueError("flash_attention kernel: k_len must be > 0")
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return torch.empty_like(q), lse


def flash_forward_cuda(q, k, v, causal: bool, scale: float):
    """Launch the ``sm_90a`` forward kernel → (o, lse); counts its launches
    in ``flash_attention.launches``. Raises on any input it cannot take and
    on a launch error; never runs the plain version."""
    _check_kernel_inputs(q, k, v)
    if not scale > 0:
        raise ValueError(f"flash_attention kernel: scale must be > 0, got {scale}")
    o, lse = _fwd_outputs(q, k)
    if q.shape[2] == 0:
        return o, lse
    _launch("flash_fwd", "flash_fwd", (q, k, v, o, lse),
            _shape_args(q, k, causal, scale, int(q.dtype == torch.bfloat16)))
    flash_attention.launches += 1
    return o, lse


def _check_bwd_inputs(q, k, v, like_q: dict, rows: dict, route: str = "hopper"):
    """q/k/v as the forward takes them; ``like_q`` tensors of q's shape and
    dtype and fp32 ``rows`` of ``[b, H, q_len]``, all contiguous (and
    16-byte aligned for the Hopper routes' kernels, fp32 included) on q's
    device."""
    _check_kernel_inputs(q, k, v, route)
    for name, t in like_q.items():
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"flash backward: {name}{tuple(t.shape)}/{t.dtype} must match "
                             f"q{tuple(q.shape)}/{q.dtype}")
    for name, t in rows.items():
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"flash backward: {name} must be fp32 {tuple(q.shape[:3])}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in {**like_q, **rows}.items():
        if t.device != q.device or not t.is_contiguous() or (
                route in _ALIGNED_ROUTES and t.data_ptr() % 16):
            raise ValueError(f"flash backward: {name} must be a contiguous "
                             f"{'16-byte aligned ' if route in _ALIGNED_ROUTES else ''}tensor on "
                             f"{q.device}")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash backward kernels: q_len and k_len must be > 0")


def flash_bwd_dq_cuda(q, k, v, o, lse, do, causal: bool, scale: float):
    """Launch the ``sm_90a`` dQ kernel → (dq in q's shape and dtype, delta =
    rowsum(dO∘O) fp32 ``[b, H, q_len]``, which the dK/dV kernel reads);
    counts its launches in ``flash_bwd_dq_cuda.launches``."""
    _check_bwd_inputs(q, k, v, {"o": o, "do": do}, {"lse": lse})
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_bwd", "flash_bwd_dq", (q, k, v, o, do, lse, dq, delta),
            _shape_args(q, k, causal, scale, int(q.dtype == torch.bfloat16)))
    flash_bwd_dq_cuda.launches += 1
    return dq, delta


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Launch the ``sm_90a`` dK/dV kernel → (dk, dv), kv-head shaped;
    counts its launches in ``flash_bwd_dkv_cuda.launches``. ``delta`` is
    the one ``flash_bwd_dq_cuda`` returns."""
    _check_bwd_inputs(q, k, v, {"do": do}, {"lse": lse, "delta": delta})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", "flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
            _shape_args(q, k, causal, scale, int(q.dtype == torch.bfloat16)))
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


def flash_backward_cuda(q, k, v, o, lse, do, causal: bool, scale: float):
    """The backward on the card through the Hopper kernels → (dq, dk, dv),
    dk/dv kv-head shaped: the dQ kernel (which also computes Δ =
    rowsum(dO∘O)), then the dK/dV kernel. Raises on any input the kernels
    cannot take and on a launch error; never runs the plain version."""
    _check_kernel_inputs(q, k, v)
    if q.shape[2] == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, delta = flash_bwd_dq_cuda(q, k, v, o, lse, do, causal, scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def flash_general_forward_cuda(q, k, v, causal: bool, scale: float):
    """Launch the general forward kernel (``csrc/flash_general.cu``) → (o,
    lse): fp32, bf16 or fp16, any head dim up to 256, any scale; counts its
    launches in ``flash_general_forward_cuda.launches``."""
    _check_kernel_inputs(q, k, v, "general")
    o, lse = _fwd_outputs(q, k)
    if q.shape[2] == 0:
        return o, lse
    _launch("flash_general", "flash_general_fwd", (q, k, v, o, lse),
            _shape_args(q, k, causal, scale, _GENERAL_DTYPES[q.dtype]))
    flash_general_forward_cuda.launches += 1
    return o, lse


def flash_general_dq_cuda(q, k, v, o, lse, do, causal: bool, scale: float):
    """Launch the general dQ kernel → (dq, delta), as ``flash_bwd_dq_cuda``;
    counts its launches in ``flash_general_dq_cuda.launches``."""
    _check_bwd_inputs(q, k, v, {"o": o, "do": do}, {"lse": lse}, "general")
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_general", "flash_general_dq", (q, k, v, o, do, lse, dq, delta),
            _shape_args(q, k, causal, scale, _GENERAL_DTYPES[q.dtype]))
    flash_general_dq_cuda.launches += 1
    return dq, delta


def flash_general_dkv_cuda(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Launch the general dK/dV kernel → (dk, dv), as
    ``flash_bwd_dkv_cuda``; counts its launches in
    ``flash_general_dkv_cuda.launches``."""
    _check_bwd_inputs(q, k, v, {"do": do}, {"lse": lse, "delta": delta}, "general")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_general", "flash_general_dkv", (q, k, v, do, lse, delta, dk, dv),
            _shape_args(q, k, causal, scale, _GENERAL_DTYPES[q.dtype]))
    flash_general_dkv_cuda.launches += 1
    return dk, dv


def flash_general_backward_cuda(q, k, v, o, lse, do, causal: bool, scale: float):
    """The backward on the card through the general kernels → (dq, dk, dv),
    as ``flash_backward_cuda``."""
    _check_kernel_inputs(q, k, v, "general")
    if q.shape[2] == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, delta = flash_general_dq_cuda(q, k, v, o, lse, do, causal, scale)
    dk, dv = flash_general_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def flash_forward_wide_cuda(q, k, v, causal: bool, scale: float):
    """Launch the wide forward kernel (``csrc/flash_fwd_wide.cu``) → (o,
    lse): bf16/fp16, head dim a multiple of 8 in 129-256, scale > 0;
    counts its launches in ``flash_forward_wide_cuda.launches``."""
    _check_kernel_inputs(q, k, v, "hopper_wide")
    if not scale > 0:
        raise ValueError(f"flash_attention wide kernel: scale must be > 0, got {scale}")
    o, lse = _fwd_outputs(q, k)
    if q.shape[2] == 0:
        return o, lse
    _launch("flash_fwd_wide", "flash_fwd_wide", (q, k, v, o, lse),
            _shape_args(q, k, causal, scale, int(q.dtype == torch.bfloat16)))
    flash_forward_wide_cuda.launches += 1
    return o, lse


def flash_bwd_dq_wide_cuda(q, k, v, o, lse, do, causal: bool, scale: float):
    """Launch the wide dQ kernel (``csrc/flash_bwd_wide.cu``) → (dq, delta),
    as ``flash_bwd_dq_cuda``: bf16/fp16, head dim a multiple of 8 in
    129-256; counts its launches in ``flash_bwd_dq_wide_cuda.launches``."""
    _check_bwd_inputs(q, k, v, {"o": o, "do": do}, {"lse": lse}, "hopper_wide")
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_bwd_wide", "flash_bwd_dq_wide", (q, k, v, o, do, lse, dq, delta),
            _shape_args(q, k, causal, scale, int(q.dtype == torch.bfloat16)))
    flash_bwd_dq_wide_cuda.launches += 1
    return dq, delta


def flash_bwd_dkv_wide_cuda(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Launch the wide dK/dV kernel (``csrc/flash_bwd_dkv_wide.cu``) → (dk,
    dv), kv-head shaped, as ``flash_bwd_dkv_cuda``; counts its launches in
    ``flash_bwd_dkv_wide_cuda.launches``. ``delta`` is the one
    ``flash_bwd_dq_wide_cuda`` returns."""
    _check_bwd_inputs(q, k, v, {"do": do}, {"lse": lse, "delta": delta}, "hopper_wide")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv_wide", "flash_bwd_dkv_wide", (q, k, v, do, lse, delta, dk, dv),
            _shape_args(q, k, causal, scale, int(q.dtype == torch.bfloat16)))
    flash_bwd_dkv_wide_cuda.launches += 1
    return dk, dv


def flash_backward_wide_cuda(q, k, v, o, lse, do, causal: bool, scale: float):
    """The backward on the card at wide heads → (dq, dk, dv), as
    ``flash_backward_cuda``: the wide dQ kernel (dQ and Δ), then the wide
    dK/dV kernel."""
    _check_kernel_inputs(q, k, v, "hopper_wide")
    if q.shape[2] == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, delta = flash_bwd_dq_wide_cuda(q, k, v, o, lse, do, causal, scale)
    dk, dv = flash_bwd_dkv_wide_cuda(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def _fp32_parts(q, rows: int):
    """Scratch for the fp32 kernels' split inputs: three bf16 planes of
    ``rows`` rows of the head dim rounded up to 8 (``csrc/flash_fp32.cuh``)."""
    return torch.empty(3 * rows * (-(-q.shape[-1] // 8) * 8), dtype=torch.bfloat16,
                       device=q.device)


def flash_forward_fp32_cuda(q, k, v, causal: bool, scale: float):
    """Launch the fp32 forward kernel (``csrc/flash_fwd_fp32.cu``) → (o,
    lse): fp32, head dim a multiple of 4 up to 128, scale > 0, on the
    tensor cores through a three-way bf16 split; counts its launches in
    ``flash_forward_fp32_cuda.launches``."""
    _check_kernel_inputs(q, k, v, "hopper_fp32")
    if not scale > 0:
        raise ValueError(f"flash_attention fp32 kernel: scale must be > 0, got {scale}")
    o, lse = _fwd_outputs(q, k)
    if q.shape[2] == 0:
        return o, lse
    b, H, q_len, _ = q.shape
    parts = _fp32_parts(q, b * H * q_len + 2 * b * k.shape[1] * k.shape[2])
    _launch("flash_fwd_fp32", "flash_fwd_fp32", (q, k, v, o, lse, parts),
            _shape_args(q, k, causal, scale, 0))
    flash_forward_fp32_cuda.launches += 1
    return o, lse


def flash_bwd_dq_fp32_cuda(q, k, v, o, lse, do, causal: bool, scale: float):
    """Launch the fp32 dQ kernel (``csrc/flash_bwd_dq_fp32.cu``) → (dq,
    delta = rowsum(dO∘O) fp32 ``[b, H, q_len]``, which the fp32 dK/dV
    kernel reads), as ``flash_bwd_dq_cuda``: fp32, head dim a multiple of 4
    up to 128, scale > 0, on the tensor cores through a three-way bf16
    split (k's and v's parts in scratch allocated here); counts its
    launches in ``flash_bwd_dq_fp32_cuda.launches``."""
    _check_bwd_inputs(q, k, v, {"o": o, "do": do}, {"lse": lse}, "hopper_fp32")
    if not scale > 0:
        raise ValueError(f"flash_attention fp32 kernel: scale must be > 0, got {scale}")
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    parts = _fp32_parts(q, 2 * k.shape[0] * k.shape[1] * k.shape[2])
    _launch("flash_bwd_dq_fp32", "flash_bwd_dq_fp32", (q, k, v, o, do, lse, dq, delta, parts),
            _shape_args(q, k, causal, scale, 0))
    flash_bwd_dq_fp32_cuda.launches += 1
    return dq, delta


def _fp32_dkv_tiles(hd: int):
    """The fp32 dK/dV kernel's tile: (keys a block, queries a step)."""
    return (128, 64) if hd <= 64 else (64, 32)


@functools.lru_cache(maxsize=256)
def fp32_dkv_plan(b: int, H: int, KV: int, q_len: int, k_len: int, hd: int, causal: bool,
                  sms: int) -> Tuple[int, int]:
    """The fp32 dK/dV kernel's blocks → (steps_per_block, blocks). A key
    tile's work is its steps (a step: one q head of the kv head's group
    over the tile's queries of a step's size, the causal diagonal on); the
    kernel cuts each tile's steps into parts of at most ``steps_per_block``,
    one block each. This picks the least ``steps_per_block`` whose blocks
    fit one wave of ``sms`` SMs, and otherwise one block a tile. At
    [2, 8/2, 1024, 64] causal: 32 tiles of 64 down to 8 steps; 10 steps a
    block in 128 blocks. The kernel refuses a ``blocks`` that is not its
    own count for ``steps_per_block``."""
    block_k, block_q = _fp32_dkv_tiles(hd)
    n_q = -(-q_len // block_q)
    group = H // KV
    steps = [group * max(0, n_q - (t * block_k // block_q if causal else 0))
             for t in range(-(-k_len // block_k))]

    def blocks(per_block: int) -> int:
        return b * KV * sum(max(1, -(-n // per_block)) for n in steps)

    lo, hi = 1, max(max(steps), 1)
    if blocks(hi) > sms:
        return hi, blocks(hi)
    while lo < hi:  # blocks() does not grow with per_block
        mid = (lo + hi) // 2
        if blocks(mid) <= sms:
            hi = mid
        else:
            lo = mid + 1
    return lo, blocks(lo)


def flash_bwd_dkv_fp32_cuda(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Launch the fp32 dK/dV kernel (``csrc/flash_bwd_dkv_fp32.cu``) → (dk,
    dv), kv-head shaped, as ``flash_bwd_dkv_cuda``: fp32, head dim a
    multiple of 4 up to 128, scale > 0; ``delta`` is the one
    ``flash_bwd_dq_fp32_cuda`` returns. Where ``fp32_dkv_plan`` cuts a key
    tile into several blocks, their sums go through an fp32 scratch
    allocated here. Counts its launches in
    ``flash_bwd_dkv_fp32_cuda.launches``."""
    _check_bwd_inputs(q, k, v, {"do": do}, {"lse": lse, "delta": delta}, "hopper_fp32")
    if not scale > 0:
        raise ValueError(f"flash_attention fp32 kernel: scale must be > 0, got {scale}")
    b, H, q_len, hd = q.shape
    KV, k_len = k.shape[1], k.shape[2]
    per_block, blocks = fp32_dkv_plan(
        b, H, KV, q_len, k_len, hd, bool(causal),
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    block_k = _fp32_dkv_tiles(hd)[0]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    sums = (torch.empty((2, blocks, block_k, hd), dtype=torch.float32, device=q.device)
            if blocks > -(-k_len // block_k) * b * KV else dk.new_empty(0))
    _launch("flash_bwd_dkv_fp32", "flash_bwd_dkv_fp32", (q, k, v, do, lse, delta, dk, dv, sums),
            _shape_args(q, k, causal, scale, per_block, blocks))
    flash_bwd_dkv_fp32_cuda.launches += 1
    return dk, dv


def flash_backward_fp32_cuda(q, k, v, o, lse, do, causal: bool, scale: float):
    """The backward on the card at fp32 → (dq, dk, dv), as
    ``flash_backward_cuda``: the fp32 dQ kernel (dQ and Δ), then the fp32
    dK/dV kernel."""
    _check_kernel_inputs(q, k, v, "hopper_fp32")
    if q.shape[2] == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, delta = flash_bwd_dq_fp32_cuda(q, k, v, o, lse, do, causal, scale)
    dk, dv = flash_bwd_dkv_fp32_cuda(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


for _wrapper in (flash_bwd_dq_cuda, flash_bwd_dkv_cuda, flash_general_forward_cuda,
                 flash_general_dq_cuda, flash_general_dkv_cuda, flash_forward_wide_cuda,
                 flash_bwd_dq_wide_cuda, flash_bwd_dkv_wide_cuda, flash_forward_fp32_cuda,
                 flash_bwd_dq_fp32_cuda, flash_bwd_dkv_fp32_cuda):
    _wrapper.launches = 0


def tma_head_dim(hd: int) -> int:
    """The head dim the TMA kernels run ``hd`` at: ``hd`` rounded up to a
    multiple of ``TMA_HEAD_DIM_GRAIN``."""
    return -(-hd // TMA_HEAD_DIM_GRAIN) * TMA_HEAD_DIM_GRAIN


def stage_head_dim(fn, q, k, v, *rest, causal: bool, scale: float):
    """``fn`` at ``tma_head_dim`` of q's head dim, for the TMA kernels,
    whose tensor maps take only rows of a multiple of 16 bytes. ``fn`` is
    a forward, ``(q, k, v, causal, scale) → (o, lse)``, or a backward,
    ``(q, k, v, o, lse, do, causal, scale) → (dq, dk, dv)`` (``rest`` is
    then ``(o, lse, do)``). q, k, v, o and do are zero-padded; o, dq, dk
    and dv come back at the caller's head dim. lse is ``fn``'s own, and so
    is the backward's Δ = rowsum(dO∘O): zero columns add nothing to Q·Kᵀ,
    dO·Vᵀ or dO∘O. The caller's ``scale`` is passed through. Pure: the
    copies are data movement, and ``fn`` still raises on what it cannot
    take."""
    hd = q.shape[-1]
    width = tma_head_dim(hd)

    def pad(t):
        return torch.nn.functional.pad(t, (0, width - hd))

    if rest:
        o, lse, do = rest
        return tuple(t[..., :hd].contiguous()
                     for t in fn(pad(q), pad(k), pad(v), pad(o), lse, pad(do), causal, scale))
    o, lse = fn(pad(q), pad(k), pad(v), causal, scale)
    return o[..., :hd].contiguous(), lse


# Calls of the ops on the card that went through stage_head_dim.
stage_head_dim.uses = 0


# ---------------------------------------------------------------------------
# The custom ops: opaque to the dispatcher, so that a selective checkpoint
# policy (models/transformer.py) can save their outputs and skip a launch.
# They are defined through a ``torch.library.Library`` with one kernel per
# dispatch key, not ``torch.library.custom_op``: that decorator runs every
# backend function under ``torch._compile``'s dynamo-disable wrapper, which
# imports ``torch._dynamo`` (some 850 modules, seconds) at the op's first
# call in each process, and a fresh serve replica would pay that on its
# first request.
# ---------------------------------------------------------------------------

_lib = torch.library.Library("ray_tpu_torch", "DEF")
_lib.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, float scale) -> (Tensor, Tensor)")
_lib.define("flash_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, "
            "bool causal, float scale) -> (Tensor, Tensor, Tensor)")


def _flash_fwd_cpu(q, k, v, causal, scale):
    """(o, lse) of flash attention: the plain version on CPU tensors."""
    return flash_attention_plain(q, k, v, causal, scale)


_FORWARD_BY_ROUTE = {"hopper": flash_forward_cuda, "hopper_wide": flash_forward_wide_cuda,
                     "hopper_fp32": flash_forward_fp32_cuda,
                     "general": flash_general_forward_cuda}
_BACKWARD_BY_ROUTE = {"hopper": flash_backward_cuda, "hopper_wide": flash_backward_wide_cuda,
                      "hopper_fp32": flash_backward_fp32_cuda,
                      "general": flash_general_backward_cuda}


def _staged(q, k, scale) -> bool:
    """Whether the op runs through ``stage_head_dim``: a TMA route at a
    head dim off its tensor maps' grain."""
    hd = q.shape[-1]
    return _kernel_route(q, k, scale) in _TMA_ROUTES and tma_head_dim(hd) != hd


def _flash_fwd_cuda(q, k, v, causal, scale):
    fwd = _FORWARD_BY_ROUTE[_kernel_route(q, k, scale)]
    if _staged(q, k, scale):
        stage_head_dim.uses += 1
        return stage_head_dim(fwd, q, k, v, causal=causal, scale=scale)
    return fwd(q, k, v, causal, scale)


def _flash_fwd_fake(q, k, v, causal, scale):
    lse_dtype = torch.float64 if q.dtype == torch.float64 else torch.float32
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=lse_dtype)


def _flash_bwd_cpu(q, k, v, o, lse, do, causal, scale):
    """(dq, dk, dv) of flash attention: the plain version on CPU tensors."""
    return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale):
    bwd = _BACKWARD_BY_ROUTE[_kernel_route(q, k, scale)]
    if _staged(q, k, scale):
        stage_head_dim.uses += 1
        return stage_head_dim(bwd, q, k, v, o, lse, do, causal=causal, scale=scale)
    return bwd(q, k, v, o, lse, do, causal, scale)


def _flash_bwd_fake(q, k, v, o, lse, do, causal, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_fwd_setup_context(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.scale = causal, scale
    ctx.mark_non_differentiable(lse)


def _flash_fwd_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    # The grad arrives as a transposed view ([b, s, H, hd] → [b, H, s, hd]).
    dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


for _name, _cpu, _cuda, _fake in (("flash_fwd", _flash_fwd_cpu, _flash_fwd_cuda, _flash_fwd_fake),
                                  ("flash_bwd", _flash_bwd_cpu, _flash_bwd_cuda, _flash_bwd_fake)):
    _lib.impl(_name, _cpu, "CPU")
    _lib.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"ray_tpu_torch::{_name}", _fake, lib=_lib)
torch.library.register_autograd("ray_tpu_torch::flash_fwd", _flash_fwd_backward,
                                setup_context=_flash_fwd_setup_context, lib=_lib)

flash_fwd = torch.ops.ray_tpu_torch.flash_fwd.default
flash_bwd = torch.ops.ray_tpu_torch.flash_bwd.default


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Flash attention → o ``[b, H, q_len, hd]`` in q's dtype, differentiable
    (the port of the JAX ``custom_vjp``: ``flash_fwd`` saves ``(q, k, v, o,
    lse)`` and its backward is ``flash_bwd``).

    CUDA tensors run the kernels of ``_kernel_route``: Hopper launches are
    counted in ``flash_attention.launches`` (forward),
    ``flash_bwd_dq_cuda.launches`` and ``flash_bwd_dkv_cuda.launches``,
    wide ones in ``flash_forward_wide_cuda.launches``,
    ``flash_bwd_dq_wide_cuda.launches`` and
    ``flash_bwd_dkv_wide_cuda.launches``, fp32 ones in
    ``flash_forward_fp32_cuda.launches``,
    ``flash_bwd_dq_fp32_cuda.launches`` and
    ``flash_bwd_dkv_fp32_cuda.launches``, general
    ones in ``flash_general_{forward,dq,dkv}_cuda.launches``; calls through the
    zero-padded copy of ``stage_head_dim`` in ``stage_head_dim.uses``. CPU
    tensors run the plain versions."""
    s = scale if scale is not None else q.shape[-1] ** -0.5
    return flash_fwd(q, k, v, bool(causal), float(s))[0]


flash_attention.launches = 0


def make_flash_attn_fn(mesh, causal: bool = True):
    """Flash attention on one rank's shard of a ``parallel.mesh.Mesh``:
    the counterpart of ``ray_tpu/ops/attention.py:make_flash_attn_fn``
    (:545-610). There the inputs are global arrays and a ``shard_map``
    cuts each device's ``[b/(dp·fsdp), h/tp, s, hd]`` block, with the
    reference's two tp cases (kv heads expanded to MHA when tp does not
    divide them, :587-592; every head on every tp rank when tp does not
    divide the q heads, :593-595). Here each rank already holds its block,
    cut by ``models/transformer.py:sharded_attention_block``, which also
    takes both tp cases; so this calls ``flash_attention`` on it, the
    sequence whole (sp > 1 uses ring or Ulysses instead). ``mesh`` is the
    reference's argument; the local block needs nothing of it. GQA-native
    (``supports_gqa``)."""

    def attn(q, k, v):
        return flash_attention(q, k, v, causal, None)

    attn.supports_gqa = True  # the kernels index the shared kv head natively
    return attn
