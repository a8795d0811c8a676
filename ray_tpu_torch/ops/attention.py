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
  kernels (built at first launch) on one of two routes, chosen by
  ``_kernel_route`` from dtype, head dim and scale: the Hopper kernels
  (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu`` for dQ,
  ``csrc/flash_bwd_dkv.cu`` for dK/dV; bf16/fp16, head dim a multiple of
  16 up to 128) or the general ones (``csrc/flash_general.cu``; fp32,
  bf16 or fp16, head dim up to 256). On CPU tensors the ops run the plain
  versions. A CUDA input neither route takes raises; nothing falls back
  to the plain version on the card.
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
    """Which kernels take these inputs on the card: ``"hopper"`` (the TMA/
    ``wgmma`` kernels of ``csrc/flash_fwd.cu``, ``flash_bwd.cu`` and
    ``flash_bwd_dkv.cu``) for bf16/fp16 q and k of one dtype, a head dim
    that is a multiple of 16 up to 128, and ``scale > 0``; ``"general"``
    (``csrc/flash_general.cu``) for every other input. A pure function of
    shape, dtype and scale: it is not a fallback, and either route raises
    on a failed build or launch. Raises above head dim 256, which neither
    route takes (the reference's Pallas kernels take any head dim)."""
    hd = q.shape[-1]
    if hd > GENERAL_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernels: head_dim {hd} > {GENERAL_MAX_HEAD_DIM}")
    if (q.dtype in _KERNEL_DTYPES and k.dtype == q.dtype and hd % 16 == 0 and hd <= 128
            and scale > 0):
        return "hopper"
    return "general"


def _check_kernel_inputs(q, k, v, route: str = "hopper"):
    """q/k/v as the ``route``'s kernels take them: one CUDA device, one
    dtype (bf16/fp16 for "hopper"; fp32, bf16 or fp16 for "general"),
    GQA-compatible 4-D shapes, the route's head dims, contiguous (and
    16-byte aligned for the Hopper kernels' TMA loads)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"flash_attention: q, k, v must share one CUDA device "
            f"(got {q.device}, {k.device}, {v.device})"
        )
    dtypes = _KERNEL_DTYPES if route == "hopper" else tuple(_GENERAL_DTYPES)
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
    if route == "hopper" and (hd % 16 or hd > 128):
        raise ValueError(f"flash_attention kernel: head_dim {hd} must be a multiple of 16, <= 128")
    if not 0 < hd <= GENERAL_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention general kernels: head_dim {hd} must be in "
                         f"[1, {GENERAL_MAX_HEAD_DIM}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be contiguous")
        if route == "hopper" and t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must be 16-byte aligned")


def _kernel_fn(lib_name: str, fn_name: str, n_ptrs: int):
    """The C entry point ``fn_name`` of ``csrc/<lib_name>.cu``: ``n_ptrs``
    pointers, then (batch, heads, kv_heads, q_len, k_len, head_dim, scale,
    causal, dtype flag, stream); the flag is ``is_bf16`` for the Hopper
    kernels and the ``_GENERAL_DTYPES`` code for the general ones."""
    from ray_tpu_torch.ops import _build

    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _shape_args(q, k, causal: bool, scale: float, dtype_flag: int):
    """The shape arguments every entry point takes after its pointers."""
    b, H, q_len, hd = q.shape
    KV, k_len = k.shape[1], k.shape[2]
    return (b, H, KV, q_len, k_len, hd, float(scale), int(bool(causal)), dtype_flag,
            torch.cuda.current_stream(q.device).cuda_stream)


def _launch(lib_name: str, fn_name: str, ptrs, shape_args):
    err = _kernel_fn(lib_name, fn_name, len(ptrs))(*(t.data_ptr() for t in ptrs), *shape_args)
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
    16-byte aligned for the Hopper kernels) on q's device."""
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
                route == "hopper" and t.data_ptr() % 16):
            raise ValueError(f"flash backward: {name} must be a contiguous "
                             f"{'16-byte aligned ' if route == 'hopper' else ''}tensor on "
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


for _wrapper in (flash_bwd_dq_cuda, flash_bwd_dkv_cuda, flash_general_forward_cuda,
                 flash_general_dq_cuda, flash_general_dkv_cuda):
    _wrapper.launches = 0


# ---------------------------------------------------------------------------
# The custom ops: opaque to the dispatcher, so that a selective checkpoint
# policy (models/transformer.py) can save their outputs and skip a launch.
# ---------------------------------------------------------------------------


@torch.library.custom_op(
    "ray_tpu_torch::flash_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float scale) -> (Tensor, Tensor)")
def flash_fwd(q, k, v, causal, scale):
    """(o, lse) of flash attention: the plain version on CPU tensors."""
    return flash_attention_plain(q, k, v, causal, scale)


@flash_fwd.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, causal, scale):
    if _kernel_route(q, k, scale) == "hopper":
        return flash_forward_cuda(q, k, v, causal, scale)
    return flash_general_forward_cuda(q, k, v, causal, scale)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal, scale):
    lse_dtype = torch.float64 if q.dtype == torch.float64 else torch.float32
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=lse_dtype)


@torch.library.custom_op(
    "ray_tpu_torch::flash_bwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, bool causal, "
           "float scale) -> (Tensor, Tensor, Tensor)")
def flash_bwd(q, k, v, o, lse, do, causal, scale):
    """(dq, dk, dv) of flash attention: the plain version on CPU tensors."""
    return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)


@flash_bwd.register_kernel("cuda")
def _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale):
    if _kernel_route(q, k, scale) == "hopper":
        return flash_backward_cuda(q, k, v, o, lse, do, causal, scale)
    return flash_general_backward_cuda(q, k, v, o, lse, do, causal, scale)


@flash_bwd.register_fake
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


flash_fwd.register_autograd(_flash_fwd_backward, setup_context=_flash_fwd_setup_context)


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Flash attention → o ``[b, H, q_len, hd]`` in q's dtype, differentiable
    (the port of the JAX ``custom_vjp``: ``flash_fwd`` saves ``(q, k, v, o,
    lse)`` and its backward is ``flash_bwd``).

    CUDA tensors run the kernels of ``_kernel_route``: Hopper launches are
    counted in ``flash_attention.launches`` (forward),
    ``flash_bwd_dq_cuda.launches`` and ``flash_bwd_dkv_cuda.launches``,
    general ones in ``flash_general_{forward,dq,dkv}_cuda.launches``. CPU
    tensors run the plain versions."""
    s = scale if scale is not None else q.shape[-1] ** -0.5
    return flash_fwd(q, k, v, bool(causal), float(s))[0]


flash_attention.launches = 0
