"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py                 # every phase (one card)
    python3 chip_smoke.py --kernels-only  # build + kernel phases only
    python3 chip_smoke.py --profile       # also torch.profiler breakdowns

Phases, in order; any failure raises and the process exits non-zero:
  1. the card (the nvidia-smi name and power limit on a line of their
     own), torch and CUDA versions;
  2. build every kernel library in ``ray_tpu_torch/ops/csrc`` (one nvcc
     per source, all started together), with ptxas's registers, shared
     memory and spills, and each library's count of wgmma (``HGMMA``),
     TMA-load (``UTMALDG``) and ``mma.sync`` (``HMMA``) instructions: every
     Hopper kernel (``HOPPER_KERNELS``) must have the first two and none of
     the third (``flash_general`` is SIMT: its counts are printed only);
  3. kernel phase: each Hopper kernel's wrapper on the card against its
     plain PyTorch version at the shapes the main paths give it (and the
     CPU test shapes, and the edges of the kernels' tiles), with times, the
     bound and a library yardstick; the dQ kernel's delta against
     rowsum(dO * O) in torch; dQ and dK/dV run again must agree bitwise
     (no atomics); inputs no kernel takes (head dim 264, a non-contiguous
     dO, a bf16 lse) raise;
  4. general-kernel phase: the three kernels of ``csrc/flash_general.cu``
     against their plain versions at fp32 GQA, bf16 head dim 256, fp16
     head dim 72 cross-length and b*H = 65,600 (where the Hopper kernels
     run too), with times, bounds, plain and SDPA times;
  5. training phase: ``make_train_step`` on the 750M flagship config of
     ``bench.py`` (full width, full depth, remat, batch 12 x 2048, random
     weights and tokens from seeds) under each remat policy ("full",
     "dots", "attn") for 2 warm-up and 8 timed steps from the same
     weights; every step launches flash_fwd 20 times under "full" and
     "dots" (forward + recompute) and 10 under "attn", each backward
     kernel 10 times and no general kernel; the loss falls, and each
     policy's losses match "full"'s;
  6. fp32 training: a 2-layer fp32 model trains a few steps through the
     general kernels (and no Hopper kernel), and its loss and gradients
     match the same model through plain attention;
  7. full-width gradient check: loss and every gradient of the 750M model
     through the kernels against the same model through plain attention;
  8. serving phase: ``LLMEngine`` serving llama7b (bf16, full width, random
     weights from a seed) through the paged engine, then a shared-prefix
     pass and a chunked-prefill pass; the forward kernel's launch counter
     must equal 32 x the full-prompt prefills (no general kernel runs),
     and full-width prefill
     logits through the kernel must match the same forward through the
     plain version.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a
card the script fails before printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

# Published dense peaks (NVIDIA data sheets): bf16/fp16 tensor-core FLOP/s,
# device-memory bytes/s and fp32 (non-tensor) FLOP/s, by the name torch
# reports.
_PEAKS = (
    ("H100 PCIe", 756e12, 2.0e12, 51e12),
    ("H100 NVL", 835e12, 3.9e12, 60e12),
    ("H200", 989e12, 4.8e12, 67e12),
    ("H100", 989e12, 3.35e12, 67e12),
)

# Kernel tolerances, kernel (bf16 in, bf16 out, P rounded to bf16 for the
# P V product) against the plain version computed in fp32 from the same
# bf16 inputs: o carries one bf16 rounding of values |o| < 4 (half an ulp
# <= 2^-8) plus the rounding of P; lse is fp32 on both sides and differs
# only in summation order.
O_TOL = 2e-2
LSE_TOL = 2e-3
# Full-width (32-layer, bf16) prefill logits, kernel vs plain attention:
# the per-layer difference above is carried through 32 bf16 layers.
LOGITS_REL_TOL = 5e-2
LOGITS_TOP1_MIN = 0.9
# Backward kernels (bf16 in and out; P and dS rounded to bf16 as the A
# operand of their products) against the plain backward in fp32 on the
# same bf16 inputs, o and lse: max |d - plain| / max |plain| per output.
# An emulation of those roundings in fp32 on the CPU gave <= 0.5% at
# [1, 2, S, 128] for S up to 2048, mostly the final bf16 rounding of
# values up to ~5 (the card gives <= 0.5% too); 2e-2 leaves a 4x margin.
GRAD_REL_TOL = 2e-2
# Full-width (10-layer, bf16) training loss and gradients, kernels vs plain
# attention: the per-layer differences above pass through 10 bf16 layers
# and their remat recompute. Loss relative, global grad norm relative,
# and every parameter's gradient by cosine.
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GNORM_REL_TOL = 2e-2
TRAIN_GRAD_COS_MIN = 0.99

TRAIN_SHAPE_LABEL = "train [12, 18, 2048, 128]"
GQA_SHAPE_LABEL = "gqa 32q/8kv S=2048"
# The edges of the forward's 128-row q and 128-key tiles, of the dK/dV
# kernel's 128-key blocks and of the dQ kernel's pairs of 128-row q tiles
# and 64-key tiles: (label, b, H, KV, q_len, k_len, hd, causal, dtype,
# timed), as in the phases below.
EDGE_SHAPES = [
    ("causal 129 hd128", 1, 2, 2, 129, 129, 128, True, torch.bfloat16, False),
    ("gqa 4:1 noncausal ragged 200x328 hd128", 1, 4, 1, 200, 328, 128, False, torch.bfloat16,
     False),
    ("causal 255 hd64", 1, 2, 2, 255, 255, 64, True, torch.bfloat16, False),
    # head_dim 80: the second 64-column box is mostly past hd (zero-filled).
    ("hd80 gqa 2:1 causal 130", 1, 4, 2, 130, 130, 80, True, torch.bfloat16, False),
    # A pair of 128-row q tiles plus a single; one key past a 64-key tile.
    ("causal 257 hd128", 1, 2, 2, 257, 257, 128, True, torch.bfloat16, False),
    ("noncausal 65x65 hd128", 1, 2, 2, 65, 65, 128, False, torch.bfloat16, False),
]
# Every kernel is built around TMA and wgmma: its SASS must hold both, and
# no mma.sync.
HOPPER_KERNELS = ("flash_fwd", "flash_bwd", "flash_bwd_dkv")
# The dQ kernel's delta against rowsum(dO * O) in torch: fp32 sums of hd
# products in another order, relative to the largest |delta|.
DELTA_REL_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def sass_counts(path: str) -> dict:
    """``HGMMA`` (wgmma), ``UTMALDG`` (TMA load) and ``HMMA`` (mma.sync)
    instructions in a built library's SASS, read with the toolkit's
    ``cuobjdump``."""
    from ray_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG", "HMMA")}


def peaks(name: str, fp32: bool = False):
    """(FLOP/s, bytes/s): the tensor-core bf16/fp16 rate, or with ``fp32``
    the fp32 FMA rate."""
    for key, flops, bw, flops32 in _PEAKS:
        if key in name:
            return (flops32 if fp32 else flops), bw
    raise RuntimeError(f"no published peaks for card {name!r}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call. The calls are enqueued behind a GPU spin
    (~10 ms) so the events bracket back-to-back device work, not the
    host's launch rate (which bounds small shapes otherwise)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Per attention kernel: FLOPs per kept (query, key) pair per head_dim
# element, q-side and kv-side 16-bit tensors read or written once, and
# fp32 rows ([b*H, q_len]) read or written once.
_ATTN_WORK = {
    "fwd": (4, 2, 2, 1),  # S, P V; q, o; k, v; lse
    "dq": (6, 4, 2, 2),   # S, dP, dQ; q, o, do, dq; k, v; lse, delta
    "dkv": (8, 2, 4, 2),  # S, dP, dV, dK; q, do; k, v, dk, dv; lse, delta
}


def attention_bound_ms(b, H, KV, q_len, k_len, hd, causal, elem_bytes, card, kind="fwd"):
    """Least time for the work: max(bytes / memory rate, FLOPs / peak), the
    peak of the inputs' type (fp32 FMAs for 4-byte elements, the tensor
    cores for bf16/fp16). FLOPs: the kernel's products, 2*hd each, per
    (query, key) pair this causal mask keeps; bytes: each input and output
    once (``_ATTN_WORK``)."""
    flops_peak, bw = peaks(card, fp32=elem_bytes == 4)
    per_pair, n_q, n_kv, n_rows = _ATTN_WORK[kind]
    if causal:
        pairs = sum(min(i + 1, k_len) for i in range(q_len))
    else:
        pairs = q_len * k_len
    flops = per_pair * hd * pairs * b * H
    nbytes = (elem_bytes * hd * (n_q * b * H * q_len + n_kv * b * KV * k_len)
              + 4 * n_rows * b * H * q_len)
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_phase(card: str) -> dict:
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # (label, b, H, KV, q_len, k_len, hd, causal, dtype, timed)
    slice_shapes = [
        (f"slice S={s}", 1, 32, 32, s, s, 128, True, torch.bfloat16, True)
        for s in (16, 32, 64, 128, 256, 512, 1024)
    ]
    other_shapes = [
        (TRAIN_SHAPE_LABEL, 12, 18, 18, 2048, 2048, 128, True, torch.bfloat16, True),
        (GQA_SHAPE_LABEL, 2, 32, 8, 2048, 2048, 128, True, torch.bfloat16, True),
        ("causal 128 hd64", 2, 4, 4, 128, 128, 64, True, torch.bfloat16, False),
        ("noncausal ragged 96x160 hd64", 1, 4, 2, 96, 160, 64, False, torch.bfloat16, False),
        ("gqa 8:2 causal hd64", 2, 8, 2, 128, 128, 64, True, torch.bfloat16, False),
        ("gqa 8:2 noncausal hd64", 2, 8, 2, 128, 128, 64, False, torch.bfloat16, False),
        ("ragged causal 192 hd32", 1, 2, 2, 192, 192, 32, True, torch.bfloat16, False),
        ("cross-length causal 320x128 hd32", 1, 2, 2, 320, 128, 32, True, torch.bfloat16, False),
        ("cross-length causal 320x96 hd32", 1, 2, 2, 320, 96, 32, True, torch.bfloat16, False),
        ("hd16 causal 48", 1, 2, 1, 48, 48, 16, True, torch.bfloat16, False),
        ("hd48 noncausal 70x33", 1, 3, 1, 70, 33, 48, False, torch.bfloat16, False),
        ("fp16 causal 256 hd128", 1, 8, 8, 256, 256, 128, True, torch.float16, False),
    ] + EDGE_SHAPES
    rows = []
    max_err = 0.0
    for label, b, H, KV, ql, kl, hd, causal, dtype, timed in slice_shapes + other_shapes:
        q = rand(b, H, ql, hd, dtype=dtype)
        k = rand(b, KV, kl, hd, dtype=dtype)
        v = rand(b, KV, kl, hd, dtype=dtype)
        scale = hd**-0.5
        o, lse = att.flash_forward_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = att.flash_attention_plain(q.float(), k.float(), v.float(), causal, scale)
        err_o = (o.float() - o_ref).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
        ok = finite and err_o <= O_TOL and err_lse <= LSE_TOL
        row = {"shape": label, "o_err": err_o, "lse_err": err_lse, "o_tol": O_TOL,
               "lse_tol": LSE_TOL, "launches": att.flash_attention.launches}
        if timed:
            row["ms"] = time_ms(lambda: att.flash_forward_cuda(q, k, v, causal, scale))
            row["plain_ms"] = time_ms(lambda: att.flash_attention_plain(q, k, v, causal, scale), iters=5)
            row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale, enable_gqa=H != KV))
            row["bound_ms"], row["bound_by"] = attention_bound_ms(
                b, H, KV, ql, kl, hd, causal, q.element_size(), card)
        log(f"[kernel] flash_fwd {label}: " + json.dumps(row))
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain version at {label}: {row}")
        max_err = max(max_err, err_o)
        rows.append(row)
    # Future keys must not leak into earlier rows: exact equality.
    q, k, v = rand(2, 4, 128, 64), rand(2, 4, 128, 64), rand(2, 4, 128, 64)
    o1, _ = att.flash_forward_cuda(q, k, v, True, 0.125)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 100:] += 1.0
    v2[:, :, 100:] += 1.0
    o2, _ = att.flash_forward_cuda(q, k2, v2, True, 0.125)
    if not torch.equal(o1[:, :, :100], o2[:, :, :100]):
        raise AssertionError("flash_fwd: future keys changed earlier rows")
    log("[kernel] flash_fwd causal no-leak check: exact")
    # A CUDA input no kernel takes raises; it never falls back. (fp32, head
    # dims off the Hopper grid and scale <= 0 take the general route.)
    for bad in (lambda: att.flash_attention(*(rand(1, 2, 8, 264) for _ in range(3))),
                lambda: att.flash_forward_cuda(q, k, v, True, -0.125)):
        try:
            bad()
        except (TypeError, ValueError) as e:
            log(f"[kernel] rejected as expected: {e}")
        else:
            raise AssertionError("flash_attention accepted an input the kernel cannot take")
    head = next(r for r in rows if r["shape"] == "slice S=1024")
    train = next(r for r in rows if r["shape"] == TRAIN_SHAPE_LABEL)
    return {"rows": rows, "max_err": max_err, "head": head, "train": train}


def sdpa_backward_ms(q, k, v, do, causal, scale):
    """Library yardstick for the backward: SDPA forward+backward minus SDPA
    forward, each timed on its own (the backward alone cannot be called)."""
    import torch.nn.functional as F

    gqa = q.shape[1] != k.shape[1]
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=scale, enable_gqa=gqa)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal, scale=scale,
                                           enable_gqa=gqa)
        torch.autograd.grad(o, (qr, kr, vr), do)

    return time_ms(fwd_bwd) - time_ms(fwd)


def bwd_kernel_phase(card: str) -> dict:
    """dQ and dK/dV kernels against ``flash_attention_bwd_plain`` (fp32 on
    the same bf16 inputs, o and lse from the forward kernel)."""
    from ray_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # (label, b, H, KV, q_len, k_len, hd, causal, dtype, timed)
    shapes = [
        (f"slice S={s}", 1, 18, 18, s, s, 128, True, torch.bfloat16, False)
        for s in (128, 512, 2048)
    ] + [
        (TRAIN_SHAPE_LABEL, 12, 18, 18, 2048, 2048, 128, True, torch.bfloat16, True),
        ("causal 128 hd64", 2, 4, 4, 128, 128, 64, True, torch.bfloat16, False),
        ("noncausal ragged 96x160 hd64", 2, 2, 2, 96, 160, 64, False, torch.bfloat16, False),
        ("gqa 8:2 causal hd64", 2, 8, 2, 128, 128, 64, True, torch.bfloat16, False),
        ("gqa 4:2 noncausal ragged 96x160 hd64", 1, 4, 2, 96, 160, 64, False, torch.bfloat16,
         False),
        ("bq>bk ragged causal 192 hd32", 1, 2, 2, 192, 192, 32, True, torch.bfloat16, False),
        ("cross-length causal 320x128 hd32", 1, 2, 2, 320, 128, 32, True, torch.bfloat16, False),
        ("cross-length causal 320x96 hd32", 1, 2, 2, 320, 96, 32, True, torch.bfloat16, False),
        ("cross-length causal 64x200 hd32", 1, 2, 2, 64, 200, 32, True, torch.bfloat16, False),
        ("hd16 gqa 2:1 causal 48", 1, 2, 1, 48, 48, 16, True, torch.bfloat16, False),
        ("hd48 noncausal 70x33", 1, 3, 1, 70, 33, 48, False, torch.bfloat16, False),
        ("fp16 causal 256 hd128", 1, 8, 8, 256, 256, 128, True, torch.float16, False),
        (GQA_SHAPE_LABEL, 2, 32, 8, 2048, 2048, 128, True, torch.bfloat16, True),
    ] + EDGE_SHAPES
    rows = []
    max_abs = {"dq": 0.0, "dkv": 0.0, "delta": 0.0}
    for label, b, H, KV, ql, kl, hd, causal, dtype, timed in shapes:
        q, do = rand(b, H, ql, hd, dtype=dtype), rand(b, H, ql, hd, dtype=dtype)
        k, v = rand(b, KV, kl, hd, dtype=dtype), rand(b, KV, kl, hd, dtype=dtype)
        scale = hd**-0.5
        o, lse = att.flash_forward_cuda(q, k, v, causal, scale)
        dq, dk, dv = att.flash_backward_cuda(q, k, v, o, lse, do, causal, scale)
        # dQ run again (twice at the timed shapes) for its delta: dQ sums in
        # a fixed order (no atomics), so every run is bitwise the same.
        dq_runs = [att.flash_bwd_dq_cuda(q, k, v, o, lse, do, causal, scale)
                   for _ in range(2 if timed else 1)]
        torch.cuda.synchronize()
        ref = att.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                            do.float(), causal, scale)
        delta = dq_runs[0][1]
        delta_ref = (do.float() * o.float()).sum(-1)
        delta_err = (delta - delta_ref).abs().max().item()
        delta_rel = delta_err / max(delta_ref.abs().max().item(), 1e-30)
        row = {"shape": label, "rel_tol": GRAD_REL_TOL, "delta_abs_err": delta_err,
               "delta_rel_err": delta_rel, "delta_rel_tol": DELTA_REL_TOL,
               "dq_bitwise_repeatable": all(torch.equal(r[0], dq) and torch.equal(r[1], delta)
                                            for r in dq_runs)}
        ok = row["dq_bitwise_repeatable"] and delta_rel <= DELTA_REL_TOL
        max_abs["delta"] = max(max_abs["delta"], delta_err)
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            err = (got.float() - want).abs().max().item()
            rel = err / max(want.abs().max().item(), 1e-30)
            row[f"{name}_abs_err"], row[f"{name}_rel_err"] = err, rel
            ok = ok and bool(torch.isfinite(got).all()) and got.shape == want.shape and (
                rel <= GRAD_REL_TOL)
            key = "dq" if name == "dq" else "dkv"
            max_abs[key] = max(max_abs[key], err)
        if timed:
            dkv_args = (q, k, v, do, lse, delta)
            # dK/dV sums in a fixed order (no atomics): bitwise repeatable.
            runs = [att.flash_bwd_dkv_cuda(*dkv_args, causal, scale) for _ in range(2)]
            row["dkv_bitwise_repeatable"] = all(
                torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
            ok = ok and row["dkv_bitwise_repeatable"] and all(
                torch.equal(a, b) for a, b in zip(runs[0], (dk, dv)))
            row["dq_ms"] = time_ms(lambda: att.flash_bwd_dq_cuda(q, k, v, o, lse, do, causal,
                                                                 scale))
            row["dkv_ms"] = time_ms(lambda: att.flash_bwd_dkv_cuda(*dkv_args, causal, scale))
            # What the dQ kernel's delta replaced: the torch expression.
            row["delta_torch_ms"] = time_ms(lambda: (do.float() * o.float()).sum(-1))
            row["plain_ms"] = time_ms(lambda: att.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal, scale), iters=3, warmup=1)
            row["library_ms"] = sdpa_backward_ms(q, k, v, do, causal, scale)
            for kind in ("dq", "dkv"):
                row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = attention_bound_ms(
                    b, H, KV, ql, kl, hd, causal, q.element_size(), card, kind)
        log(f"[kernel] flash_bwd {label}: " + json.dumps(row))
        if not ok:
            raise AssertionError(f"flash_bwd disagrees with its plain version at {label}: {row}")
        rows.append(row)
    # Keys that no query reaches (causal, k_len > q_len) get exactly zero.
    q, k, v, do = rand(1, 2, 64, 32), rand(1, 2, 200, 32), rand(1, 2, 200, 32), rand(1, 2, 64, 32)
    o, lse = att.flash_forward_cuda(q, k, v, True, 0.125)
    _, dk, dv = att.flash_backward_cuda(q, k, v, o, lse, do, True, 0.125)
    if not (torch.equal(dk[:, :, 64:], torch.zeros_like(dk[:, :, 64:]))
            and torch.equal(dv[:, :, 64:], torch.zeros_like(dv[:, :, 64:]))):
        raise AssertionError("flash_bwd: keys past every query got a gradient")
    log("[kernel] flash_bwd unreached keys: exactly zero")
    # A CUDA input no kernel takes raises, through the routed backward op;
    # it never falls back.
    q, k, v = rand(1, 2, 64, 32), rand(1, 2, 64, 32), rand(1, 2, 64, 32)
    o, lse = att.flash_forward_cuda(q, k, v, True, 0.125)
    bad_inputs = (
        ("non-contiguous do", lambda: att.flash_bwd(
            q, k, v, o, lse, torch.empty_like(o).transpose(2, 3).contiguous().transpose(2, 3),
            True, 0.125)),
        ("bf16 lse", lambda: att.flash_bwd(q, k, v, o, lse.bfloat16(), o, True, 0.125)),
        ("head_dim 264", lambda: att.flash_bwd(
            *(rand(1, 2, 8, 264) for _ in range(4)), torch.zeros(1, 2, 8, device=dev),
            rand(1, 2, 8, 264), True, 0.125)),
    )
    for what, bad in bad_inputs:
        try:
            bad()
        except (TypeError, ValueError) as e:
            log(f"[kernel] flash_bwd rejected {what} as expected: {e}")
        else:
            raise AssertionError(f"flash_bwd accepted {what}")
    train = next(r for r in rows if r["shape"] == TRAIN_SHAPE_LABEL)
    gqa = next(r for r in rows if r["shape"] == GQA_SHAPE_LABEL)
    return {"rows": rows, "max_abs": max_abs, "train": train, "gqa": gqa}


# The general kernels against their plain versions on the same inputs: both
# sides compute in fp32 and round the output once, so o differs by half an
# ulp of its type plus fp32 summation noise. fp32: 2e-4 absolute on o and
# lse; bf16/fp16: o within 1e-2 of max(1, |o|) (half a bf16 ulp is 2^-9 of
# |o|), lse (fp32) within 2e-4; gradients within 2% of the largest value.
GENERAL_O_TOL_FP32 = 2e-4
GENERAL_O_TOL_16 = 1e-2
GENERAL_LSE_TOL = 2e-4
GENERAL_HEAD_LABEL = "bf16 [1, 16/16, 2048, 256] causal"
# (label, b, H, KV, q_len, k_len, hd, causal, dtype, route): the head shape
# of Gemma-7B's public config is the headline; at b*H = 65,600 the Hopper
# kernels run too (their grid is one-dimensional).
GENERAL_SHAPES = [
    ("fp32 gqa [2, 8/2, 1024, 64] causal", 2, 8, 2, 1024, 1024, 64, True, torch.float32,
     "general"),
    (GENERAL_HEAD_LABEL, 1, 16, 16, 2048, 2048, 256, True, torch.bfloat16, "general"),
    ("fp16 [1, 4/2, 300, 72] x k_len 500 noncausal", 1, 4, 2, 300, 500, 72, False,
     torch.float16, "general"),
    ("bf16 [4100, 16/16, 16, 64] causal (b*H 65600)", 4100, 16, 16, 16, 16, 64, True,
     torch.bfloat16, "hopper"),
]


def library_ms(fn):
    """A library call's time, or None where the library refuses the input."""
    try:
        return fn()
    except RuntimeError as e:
        log(f"[kernel] library yardstick refused: {str(e).splitlines()[0][:160]}")
        return None


def _fwd_errors(o, lse, o_ref, lse_ref):
    """(o error as the tolerance reads it, o max abs error, lse max abs error)."""
    diff = (o.float() - o_ref).abs()
    o_err = diff if o.dtype == torch.float32 else diff / o_ref.abs().clamp_min(1.0)
    return o_err.max().item(), diff.max().item(), (lse - lse_ref).abs().max().item()


def general_kernel_phase(card: str) -> dict:
    """The general forward, dQ and dK/dV kernels against
    ``flash_attention_plain`` / ``flash_attention_bwd_plain`` at
    ``GENERAL_SHAPES``, with times, bounds (fp32 FMA peak for fp32 inputs,
    tensor-core peak for bf16/fp16), plain and SDPA times; the route each
    shape takes; and the Hopper kernels at b*H = 65,600."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    rows = []
    max_abs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for label, b, H, KV, ql, kl, hd, causal, dtype, route in GENERAL_SHAPES:
        q, do = rand(b, H, ql, hd, dtype=dtype), rand(b, H, ql, hd, dtype=dtype)
        k, v = rand(b, KV, kl, hd, dtype=dtype), rand(b, KV, kl, hd, dtype=dtype)
        scale = hd**-0.5
        got_route = att._kernel_route(q, k, scale)
        o, lse = att.flash_general_forward_cuda(q, k, v, causal, scale)
        grads = att.flash_general_backward_cuda(q, k, v, o, lse, do, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = att.flash_attention_plain(q.float(), k.float(), v.float(), causal, scale)
        ref = att.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                            do.float(), causal, scale)
        o_tol = GENERAL_O_TOL_FP32 if dtype == torch.float32 else GENERAL_O_TOL_16
        o_err, o_abs, lse_err = _fwd_errors(o, lse, o_ref, lse_ref)
        row = {"shape": label, "dtype": str(dtype).split(".")[-1], "route": got_route,
               "o_err": o_err, "o_abs_err": o_abs, "o_tol": o_tol, "lse_err": lse_err,
               "lse_tol": GENERAL_LSE_TOL, "grad_rel_tol": GRAD_REL_TOL}
        ok = (got_route == route and bool(torch.isfinite(o).all())
              and bool(torch.isfinite(lse).all()) and o_err <= o_tol
              and lse_err <= GENERAL_LSE_TOL)
        max_abs["fwd"] = max(max_abs["fwd"], o_abs)
        for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
            err = (got.float() - want).abs().max().item()
            row[f"{name}_abs_err"] = err
            row[f"{name}_rel_err"] = err / max(want.abs().max().item(), 1e-30)
            ok = ok and bool(torch.isfinite(got).all()) and got.shape == want.shape and (
                row[f"{name}_rel_err"] <= GRAD_REL_TOL)
            key = "dq" if name == "dq" else "dkv"
            max_abs[key] = max(max_abs[key], err)
        delta = att.flash_general_dq_cuda(q, k, v, o, lse, do, causal, scale)[1]
        row["fwd_ms"] = time_ms(lambda: att.flash_general_forward_cuda(q, k, v, causal, scale))
        row["dq_ms"] = time_ms(lambda: att.flash_general_dq_cuda(q, k, v, o, lse, do, causal,
                                                                 scale))
        row["dkv_ms"] = time_ms(lambda: att.flash_general_dkv_cuda(q, k, v, do, lse, delta,
                                                                   causal, scale))
        row["plain_fwd_ms"] = time_ms(lambda: att.flash_attention_plain(q, k, v, causal, scale),
                                      iters=3, warmup=1)
        row["plain_bwd_ms"] = time_ms(lambda: att.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal, scale), iters=3, warmup=1)
        row["library_fwd_ms"] = library_ms(lambda: time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale, enable_gqa=H != KV)))
        row["library_bwd_ms"] = library_ms(lambda: sdpa_backward_ms(q, k, v, do, causal, scale))
        for kind in ("fwd", "dq", "dkv"):
            row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = attention_bound_ms(
                b, H, KV, ql, kl, hd, causal, q.element_size(), card, kind)
        if route == "hopper":
            o_h, lse_h = att.flash_forward_cuda(q, k, v, causal, scale)
            grads_h = att.flash_backward_cuda(q, k, v, o_h, lse_h, do, causal, scale)
            torch.cuda.synchronize()
            h_err, h_abs, h_lse = _fwd_errors(o_h, lse_h, o_ref, lse_ref)
            ref_h = att.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o_h.float(),
                                                  lse_h, do.float(), causal, scale)
            h_rel = [(g.float() - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                     for g, w in zip(grads_h, ref_h)]
            row["hopper"] = {"o_err": h_err, "o_abs_err": h_abs, "o_tol": O_TOL,
                             "lse_err": h_lse, "lse_tol": LSE_TOL, "grad_rel_errs": h_rel,
                             "fwd_ms": time_ms(lambda: att.flash_forward_cuda(q, k, v, causal,
                                                                              scale))}
            ok = ok and h_err <= O_TOL and h_lse <= LSE_TOL and max(h_rel) <= GRAD_REL_TOL
        log(f"[kernel] flash_general {label} on {card}: " + json.dumps(row))
        if not ok:
            raise AssertionError(f"flash_general disagrees with its plain version at {label}: "
                                 f"{row}")
        rows.append(row)
        del q, k, v, do, o, lse, grads, o_ref, lse_ref, ref
        torch.cuda.empty_cache()
    head = next(r for r in rows if r["shape"] == GENERAL_HEAD_LABEL)
    return {"rows": rows, "max_abs": max_abs, "head": head}


def profile_pass(eng, prompts, n_new, label: str, card: str) -> dict:
    """One ``generate_batch`` profiled (see ``profile_step``)."""
    return profile_step(lambda: eng.generate_batch(prompts, n_new), label, card)


def train_config(remat_policy: str = "full"):
    """The 750M flagship config of ``bench.py:67-77``: full width, full depth."""
    from ray_tpu_torch.models import transformer as tf

    return tf.TransformerConfig(vocab_size=32000, d_model=2304, n_layers=10, n_heads=18,
                                n_kv_heads=18, d_ff=5760, max_seq_len=2048,
                                dtype=torch.bfloat16, remat=True, remat_policy=remat_policy)


def _counted():
    """Every kernel wrapper's launch counter, by the key the phases use."""
    from ray_tpu_torch.ops import attention as att

    return {"fwd": att.flash_attention, "dq": att.flash_bwd_dq_cuda,
            "dkv": att.flash_bwd_dkv_cuda, "general_fwd": att.flash_general_forward_cuda,
            "general_dq": att.flash_general_dq_cuda, "general_dkv": att.flash_general_dkv_cuda}


def launch_counts():
    return {key: fn.launches for key, fn in _counted().items()}


def reset_launch_counts():
    for fn in _counted().values():
        fn.launches = 0


def no_general(per_step: dict) -> dict:
    """``per_step`` Hopper launches and no general ones."""
    return {**per_step, "general_fwd": 0, "general_dq": 0, "general_dkv": 0}


def profile_step(fn, label: str, card: str) -> dict:
    """``fn`` timed on the host clock with the profiler off, then again
    under torch.profiler for the device-busy time (sum of kernel self
    device time; one stream) and the top kernels. The idle share is
    1 - busy / unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Device events only; user annotations (Optimizer.step, ...) span
    # kernels already counted and would count their time twice.
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    out = {
        "pass": label, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "top_kernels": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                         "share": e.self_device_time_total / max(busy_us, 1e-9),
                         "count": e.count} for e in top],
        # The port's own kernels, wherever they rank.
        "flash_kernels": {e.key.split("<")[0].split("::")[-1]: {
            "ms": e.self_device_time_total / 1e3, "count": e.count,
            "share": e.self_device_time_total / max(busy_us, 1e-9)}
            for e in events if "flash_" in e.key},
    }
    log(f"[profile] {label} on {card}: " + json.dumps(out))
    return out


# Each selective policy's losses against "full"'s, step by step, relative:
# the policies compute the same numbers (a saved product is the one the
# recompute would give), so only a change in summation order could move them.
POLICY_LOSS_REL_TOL = 1e-3


def training_phase(card: str, smi: str, policy: str = "full", profile: bool = False) -> dict:
    """``make_train_step`` on the 750M config under remat ``policy``, batch
    12 x 2048, 2 warm-up and 8 timed steps, with the exact launch counts of
    every step (20/10/10 Hopper launches under "full" and "dots", 10/10/10
    under "attn", no general launch)."""
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.parallel import make_optimizer, make_train_state, make_train_step
    from ray_tpu_torch.parallel.train_step import param_leaves

    dev = torch.device("cuda")
    cfg = train_config(policy)
    batch_size, seq, warmup, steps = 12, 2048, 2, 8
    torch.cuda.empty_cache()
    opt = make_optimizer(lr=3e-4, warmup=10)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                                         device=dev, optimizer=opt)
    n_params = sum(p.numel() for p in param_leaves(params))
    if n_params != tf.num_params(cfg):
        raise AssertionError(f"params {n_params} != num_params {tf.num_params(cfg)}")
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq + 1), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    batch = {"tokens": tokens}
    step = make_train_step(cfg, opt)
    per_step = no_general({"fwd": (1 if policy == "attn" else 2) * cfg.n_layers,
                           "dq": cfg.n_layers, "dkv": cfg.n_layers})
    losses, gnorms, step_s = [], [], []
    reset_launch_counts()
    for i in range(warmup + steps):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # both wait for the step
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(gnorm)
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after}
        if got != per_step:
            raise AssertionError(f"step {i}: launches {got} != {per_step}")
        log(f"[train] {policy} step {i}: loss {loss:.6f} grad_norm {gnorm:.6f} "
            f"{step_s[-1] * 1e3:.1f} ms launches {got}")
    launches = launch_counts()
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    timed = step_s[warmup:]
    mean_s = sum(timed) / len(timed)
    flops_peak, _ = peaks(card)
    tokens_per_step = batch_size * seq
    result = {
        "config": "750M flagship (bench.py): vocab 32000, d_model 2304, 10 layers, 18 heads, "
                  f"18 kv heads, d_ff 5760, bf16 compute, fp32 params + AdamW, remat {policy}",
        "remat_policy": policy,
        "params": n_params, "batch": batch_size, "seq": seq, "steps_timed": steps,
        "step_ms_mean": mean_s * 1e3, "step_ms_min": min(timed) * 1e3,
        "step_ms_max": max(timed) * 1e3,
        "tokens_per_s": tokens_per_step / mean_s,
        "mfu": tf.flops_per_token(cfg, seq) * tokens_per_step / mean_s / flops_peak,
        "flops_per_token": tf.flops_per_token(cfg, seq),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses, "grad_norms": gnorms, "launches": launches,
        "launches_per_step": per_step, "card": smi,
    }
    log(f"[train] {policy} on {card}: " + json.dumps(result))
    if profile:
        result["profile"] = profile_step(lambda: step(params, opt_state, batch),
                                         f"train step ({policy})", card)
    del params, opt_state, batch, step
    torch.cuda.empty_cache()
    return result


def grad_check_phase(card: str) -> dict:
    """Loss and every gradient of the 750M model on one 1 x 2048 batch,
    through the kernels and through plain attention under autograd."""
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.parallel.train_step import global_norm, param_leaves

    dev = torch.device("cuda")
    cfg = train_config()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(2), device=dev)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2049), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))

    def plain_attn(q, k, v):
        return att.flash_attention_plain(q, k, v, True, q.shape[-1] ** -0.5)[0]

    plain_attn.supports_gqa = True

    def loss_and_grads(attn_fn):
        loss = tf.loss_fn(params, {"tokens": tokens}, cfg, attn_fn)
        grads = torch.autograd.grad(loss, leaves)
        return loss.item(), grads

    reset_launch_counts()
    lk, gk = loss_and_grads(None)
    counts = launch_counts()
    lp, gp = loss_and_grads(plain_attn)
    if launch_counts() != counts or counts["dq"] != cfg.n_layers:
        raise AssertionError(f"kernel launches {counts}, then {launch_counts()} under plain")

    nk, np_ = global_norm(gk).item(), global_norm(gp).item()
    cos = [torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
           for a, b in zip(gk, gp)]
    finite = all(bool(torch.isfinite(g).all()) for g in gk) and math.isfinite(lk)
    result = {"loss_kernel": lk, "loss_plain": lp, "loss_rel_err": abs(lk - lp) / abs(lp),
              "grad_norm_kernel": nk, "grad_norm_plain": np_,
              "grad_norm_rel_err": abs(nk - np_) / np_, "grad_cos_min": min(cos),
              "loss_rel_tol": TRAIN_LOSS_REL_TOL, "grad_norm_rel_tol": TRAIN_GNORM_REL_TOL,
              "grad_cos_min_allowed": TRAIN_GRAD_COS_MIN, "launches": counts}
    log(f"[gradcheck] 750M, 1 x 2048, kernels vs plain attention on {card}: "
        + json.dumps(result))
    if not (finite and result["loss_rel_err"] <= TRAIN_LOSS_REL_TOL
            and result["grad_norm_rel_err"] <= TRAIN_GNORM_REL_TOL
            and result["grad_cos_min"] >= TRAIN_GRAD_COS_MIN):
        raise AssertionError(f"full-width gradients disagree: {result}")
    del params, leaves, gk, gp
    torch.cuda.empty_cache()
    return result


# fp32 model, kernels (general route) vs plain attention: fp32 on both sides
# (TF32 off), sums in another order through 2 layers; relative errors of
# ~1e-6 are expected, so 1e-5 on the loss and 1e-3 of each gradient's
# largest value.
FP32_LOSS_REL_TOL = 1e-5
FP32_GRAD_REL_TOL = 1e-3


def fp32_training_phase(card: str) -> dict:
    """A 2-layer fp32 model (d_model 512, 8 q / 4 kv heads, remat "full")
    trains 3 steps through ``make_train_step``: every step launches each
    general kernel (forward 2 x 2, dQ 2, dK/dV 2) and no Hopper kernel. Then
    its loss and every gradient through the kernels against the same model
    through plain attention."""
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.parallel import make_optimizer, make_train_state, make_train_step
    from ray_tpu_torch.parallel.train_step import param_leaves

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 matmuls must run in fp32 (TF32 is on)")
    dev = torch.device("cuda")
    cfg = tf.TransformerConfig(vocab_size=32000, d_model=512, n_layers=2, n_heads=8,
                               n_kv_heads=4, d_ff=1536, max_seq_len=512, dtype=torch.float32,
                               remat=True)
    opt = make_optimizer(lr=3e-4, warmup=2)
    params, opt_state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(10),
                                         device=dev, optimizer=opt)
    tokens = torch.randint(0, cfg.vocab_size, (4, 513), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(11))
    step = make_train_step(cfg, opt)
    L, steps = cfg.n_layers, 3
    reset_launch_counts()
    losses = []
    for _ in range(steps):
        params, opt_state, m = step(params, opt_state, {"tokens": tokens})
        losses.append(float(m["loss"]))
    launches = launch_counts()
    want = {"fwd": 0, "dq": 0, "dkv": 0, "general_fwd": 2 * L * steps, "general_dq": L * steps,
            "general_dkv": L * steps}
    if launches != want:
        raise AssertionError(f"fp32 training launches {launches} != {want}")

    def plain_attn(q, k, v):
        return att.flash_attention_plain(q, k, v, True, q.shape[-1] ** -0.5)[0]

    plain_attn.supports_gqa = True
    leaves = param_leaves(params)

    def loss_and_grads(attn_fn):
        loss = tf.loss_fn(params, {"tokens": tokens}, cfg, attn_fn)
        return loss.item(), torch.autograd.grad(loss, leaves)

    lk, gk = loss_and_grads(None)
    lp, gp = loss_and_grads(plain_attn)
    rel = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30) for a, b in zip(gk, gp)]
    result = {"config": "fp32, vocab 32000, d_model 512, 2 layers, 8 q / 4 kv heads (head dim "
                        "64), d_ff 1536, batch 4 x 512, remat full",
              "losses": losses, "launches": launches, "loss_kernel": lk, "loss_plain": lp,
              "loss_rel_err": abs(lk - lp) / abs(lp), "grad_rel_err_max": max(rel),
              "loss_rel_tol": FP32_LOSS_REL_TOL, "grad_rel_tol": FP32_GRAD_REL_TOL}
    log(f"[train fp32] general route on {card}: " + json.dumps(result))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and result["loss_rel_err"] <= FP32_LOSS_REL_TOL
            and max(rel) <= FP32_GRAD_REL_TOL):
        raise AssertionError(f"fp32 training through the general kernels: {result}")
    del params, opt_state, leaves, gk, gp
    torch.cuda.empty_cache()
    return result


def slice_phase(card: str, profile: bool = False) -> dict:
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.models.paged import PagedConfig
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    dev = torch.device("cuda")
    cfg = tf.TransformerConfig.llama7b(max_seq_len=2048, dtype=torch.bfloat16, remat=False)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                            dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params["layers"].values()) + sum(
        params[n].numel() for n in ("embed", "final_norm", "lm_head"))
    log(f"[slice] llama7b params: {n_params / 1e9:.3f} B bf16 on {card} "
        f"({time.perf_counter() - t0:.2f} s)")
    pcfg = PagedConfig(block_size=16, num_blocks=513, max_batch=16, max_blocks_per_seq=64)
    rng = torch.Generator().manual_seed(1)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    def check_outputs(outs, n_new):
        for o in outs:
            if len(o) != n_new or not all(0 <= t < cfg.vocab_size for t in o):
                raise AssertionError(f"bad output: len {len(o)}, ids {o[:8]}...")

    result = {}
    # --- main pass: full-prompt prefills through the kernel -------------
    n_new = 32
    lens = [16, 40, 100, 200, 333, 500, 650, 700, 24, 300]
    prompts = [prompt(n) for n in lens]
    eng = LLMEngine(params, cfg, pcfg, device=dev, decode_window=4, overlap=True)
    eng.generate_batch([prompt(16)], 2)  # first-call set-up (kernel build, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = dict(eng.stats)
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts, n_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["fwd"]
    full = eng.stats["full_prefills"] - base["full_prefills"]
    check_outputs(outs, n_new)
    if full < len(prompts) or counts != no_general({"fwd": cfg.n_layers * full, "dq": 0,
                                                    "dkv": 0}):
        raise AssertionError(f"launches {counts}: expected {cfg.n_layers} x {full} full "
                             "prefills and no general launch")
    lat = eng.recorder.latency_summary()
    result["main"] = {
        "requests": len(prompts), "new_tokens": n_new, "prompt_lens": lens,
        "seconds": dt, "tok_s": sum(len(o) for o in outs) / dt,
        "ttft_ms_p50": lat["ttft_ms"]["p50"], "ttft_ms_p99": lat["ttft_ms"]["p99"],
        "tpot_ms_p50": lat["tpot_ms"]["p50"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "full_prefills": full, "flash_fwd_launches": launches,
        "preemptions": eng.stats["preemptions"] - base["preemptions"],
    }
    log(f"[slice] main pass on {card}: " + json.dumps(result["main"]))
    ref_outs = dict(zip(map(tuple, prompts), outs))
    if profile:
        # Prefill only (one new token each finishes at the prefill flush),
        # then decode-heavy (short prompts, 32 new tokens, 10 slots).
        result["profile"] = [
            profile_pass(eng, prompts, 1, "prefill", card),
            profile_pass(eng, [prompt(16) for _ in range(10)], n_new, "decode", card),
        ]
    del eng
    torch.cuda.empty_cache()

    # --- shared-prefix pass: hits run the chunk program -----------------
    shared = prompt(256)
    pre_prompts = [shared + prompt(32) for _ in range(8)]
    eng = LLMEngine(params, cfg, pcfg, device=dev, enable_prefix_cache=True)
    att.flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = [eng.generate_batch([pre_prompts[0]], n_new)[0]]
    outs += eng.generate_batch(pre_prompts[1:], n_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_outputs(outs, n_new)
    full = eng.stats["full_prefills"]
    if eng.stats["prefix_hit_tokens"] <= 0 or att.flash_attention.launches != cfg.n_layers * full:
        raise AssertionError(f"prefix pass: stats {eng.stats}, launches {att.flash_attention.launches}")
    result["prefix"] = {"requests": len(pre_prompts), "seconds": dt,
                        "tok_s": sum(len(o) for o in outs) / dt,
                        "prefix_hit_tokens": eng.stats["prefix_hit_tokens"],
                        "full_prefills": full, "flash_fwd_launches": att.flash_attention.launches}
    log(f"[slice] prefix pass on {card}: " + json.dumps(result["prefix"]))
    del eng
    torch.cuda.empty_cache()

    # --- chunked-prefill pass -------------------------------------------
    chunk_prompts = [prompts[7], prompts[6], prompts[0]]  # 700, 650, 16 tokens
    eng = LLMEngine(params, cfg, pcfg, device=dev, prefill_chunk=128)
    att.flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate_batch(chunk_prompts, n_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_outputs(outs, n_new)
    full = eng.stats["full_prefills"]
    if eng.stats["prefill_chunks"] <= 0 or att.flash_attention.launches != cfg.n_layers * full:
        raise AssertionError(f"chunk pass: stats {eng.stats}, launches {att.flash_attention.launches}")
    # bf16 through two attention paths (kernel vs fp32 einsum chunks):
    # report token agreement with the full-prefill run, do not demand it.
    agree = [sum(a == b for a, b in zip(o, ref_outs[tuple(p)])) / n_new
             for o, p in zip(outs, chunk_prompts)]
    result["chunk"] = {"requests": len(chunk_prompts), "seconds": dt,
                       "prefill_chunks": eng.stats["prefill_chunks"], "full_prefills": full,
                       "flash_fwd_launches": att.flash_attention.launches,
                       "token_agreement_with_full_prefill": agree}
    log(f"[slice] chunk pass on {card}: " + json.dumps(result["chunk"]))
    del eng
    torch.cuda.empty_cache()

    # --- full-width prefill logits: kernel vs plain attention -----------
    toks = torch.tensor([prompts[4][:256]], device=dev)

    def plain_attn(q, k, v):
        return att.flash_attention_plain(q, k, v, True, q.shape[-1] ** -0.5)[0]

    plain_attn.supports_gqa = True
    with torch.no_grad():
        lk = tf.forward(params, toks, cfg)
        lp = tf.forward(params, toks, cfg, attn_fn=plain_attn)
    if not (torch.isfinite(lk).all() and lk.shape == (1, 256, cfg.vocab_size)):
        raise AssertionError("kernel prefill logits are not finite / of the expected shape")
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    top1 = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    result["logits"] = {"rel_max_err": rel, "rel_tol": LOGITS_REL_TOL, "top1_agree": top1,
                        "top1_min": LOGITS_TOP1_MIN}
    log(f"[slice] prefill logits kernel vs plain: " + json.dumps(result["logits"]))
    if rel > LOGITS_REL_TOL or top1 < LOGITS_TOP1_MIN:
        raise AssertionError(f"full-width prefill logits disagree: {result['logits']}")
    return result


def kernel_row(name, source, replaces, launches, max_abs_err, ms, plain_ms, bound, library_ms,
               shape, smi, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
            "shape": shape, "card": smi, **extra}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true", help="build + kernel phases only")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a training step, a prefill and a decode pass")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on the card",
              file=sys.stderr)
        return 1
    from ray_tpu_torch.ops import _build

    card = torch.cuda.get_device_name(0)
    smi = card_line()
    print(smi, flush=True)
    log(f"[versions] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    sass = {}
    for name, info in _build.build_all().items():
        log(f"[build] {name}.cu: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling", "warning",
                                        "setmaxnreg", "wgmma")):
                log(f"[build]   {line.strip()}")
        sass[name] = sass_counts(info["path"])
        log(f"[build]   SASS of {name}: " + json.dumps(sass[name]))
    log(f"[build] all kernel libraries: {time.perf_counter() - t0:.2f} s wall")
    for name in HOPPER_KERNELS:
        if not (sass[name]["HGMMA"] and sass[name]["UTMALDG"]) or sass[name]["HMMA"]:
            raise AssertionError(f"{name}: wgmma and TMA loads but no mma.sync expected in its "
                                 f"SASS: {sass[name]}")
    kern = kernel_phase(card)
    bwd = bwd_kernel_phase(card)
    gen = general_kernel_phase(card)
    torch.cuda.empty_cache()
    launches = {key: None for key in _counted()}
    serving_launches = general_launches = None
    by_policy = {}
    if not args.kernels_only:
        runs = {policy: training_phase(card, smi, policy, profile=args.profile)
                for policy in ("full", "dots", "attn")}
        full_losses = runs["full"]["losses"]
        for policy, run in runs.items():
            diff = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], full_losses))
            by_policy[policy] = {
                key: run[key] for key in ("step_ms_mean", "step_ms_min", "step_ms_max",
                                          "tokens_per_s", "mfu", "peak_mem_gb",
                                          "launches_per_step")}
            by_policy[policy]["loss_max_rel_diff_vs_full"] = diff
            if diff > POLICY_LOSS_REL_TOL:
                raise AssertionError(f"{policy} losses {run['losses']} differ from full's "
                                     f"{full_losses} by {diff} > {POLICY_LOSS_REL_TOL}")
        log(f"[train] remat policies on {smi}: " + json.dumps(by_policy))
        launches = runs["full"]["launches"]
        general_launches = fp32_training_phase(card)["launches"]
        grad_check_phase(card)
        sl = slice_phase(card, profile=args.profile)
        serving_launches = sl["main"]["flash_fwd_launches"]
    head, ftrain, btrain, bgqa = kern["head"], kern["train"], bwd["train"], bwd["gqa"]
    ghead = gen["head"]
    general_note = ("launches: the fp32 training run (the general route's main path); "
                    "plain_ms and library_ms of dq and dkv cover the whole backward")
    general_rows = [
        kernel_row(f"flash_general_{kind}", "ray_tpu_torch/ops/csrc/flash_general.cu",
                   f"ray_tpu/ops/attention.py:{line}",
                   None if general_launches is None else general_launches[f"general_{kind}"],
                   gen["max_abs"][kind], ghead[f"{kind}_ms"],
                   ghead["plain_fwd_ms" if kind == "fwd" else "plain_bwd_ms"],
                   (ghead[f"{kind}_bound_ms"], ghead[f"{kind}_bound_by"]),
                   ghead["library_fwd_ms" if kind == "fwd" else "library_bwd_ms"],
                   ghead["shape"], smi, sass=sass["flash_general"], note=general_note,
                   shapes=[{"shape": r["shape"], "ms": r[f"{kind}_ms"],
                            "bound_ms": r[f"{kind}_bound_ms"],
                            "plain_ms": r["plain_fwd_ms" if kind == "fwd" else "plain_bwd_ms"],
                            "library_ms": r["library_fwd_ms" if kind == "fwd"
                                            else "library_bwd_ms"]} for r in gen["rows"]])
        for kind, line in (("fwd", 56), ("dq", 201), ("dkv", 262))]
    by_policy_launches = {policy: row["launches_per_step"] for policy, row in by_policy.items()}
    kernels = [
        kernel_row("flash_fwd", "ray_tpu_torch/ops/csrc/flash_fwd.cu",
                   "ray_tpu/ops/attention.py:56", launches["fwd"], kern["max_err"],
                   ftrain["ms"], ftrain["plain_ms"], (ftrain["bound_ms"], ftrain["bound_by"]),
                   ftrain["library_ms"], ftrain["shape"], smi,
                   serving_launches=serving_launches, serving_shape=head["shape"],
                   serving_ms=head["ms"], serving_plain_ms=head["plain_ms"],
                   serving_bound_ms=head["bound_ms"], serving_library_ms=head["library_ms"],
                   launches_per_step_by_policy=by_policy_launches, sass=sass["flash_fwd"]),
        kernel_row("flash_bwd_dq", "ray_tpu_torch/ops/csrc/flash_bwd.cu",
                   "ray_tpu/ops/attention.py:201", launches["dq"], bwd["max_abs"]["dq"],
                   btrain["dq_ms"], btrain["plain_ms"],
                   (btrain["dq_bound_ms"], btrain["dq_bound_by"]), btrain["library_ms"],
                   btrain["shape"], smi, sass=sass["flash_bwd"],
                   bitwise_repeatable=btrain["dq_bitwise_repeatable"]
                   and bgqa["dq_bitwise_repeatable"],
                   delta_max_abs_err=bwd["max_abs"]["delta"],
                   delta_torch_ms=btrain["delta_torch_ms"],
                   gqa_shape=bgqa["shape"], gqa_ms=bgqa["dq_ms"],
                   gqa_bound_ms=bgqa["dq_bound_ms"], gqa_plain_ms=bgqa["plain_ms"],
                   gqa_library_ms=bgqa["library_ms"],
                   note="plain_ms and library_ms cover the whole backward (dq, dk, dv); "
                        "the kernel also computes delta, which delta_torch_ms timed in torch"),
        kernel_row("flash_bwd_dkv", "ray_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
                   "ray_tpu/ops/attention.py:262", launches["dkv"], bwd["max_abs"]["dkv"],
                   btrain["dkv_ms"], btrain["plain_ms"],
                   (btrain["dkv_bound_ms"], btrain["dkv_bound_by"]), btrain["library_ms"],
                   btrain["shape"], smi, sass=sass["flash_bwd_dkv"],
                   bitwise_repeatable=btrain["dkv_bitwise_repeatable"]
                   and bgqa["dkv_bitwise_repeatable"],
                   gqa_shape=bgqa["shape"], gqa_ms=bgqa["dkv_ms"],
                   gqa_bound_ms=bgqa["dkv_bound_ms"], gqa_plain_ms=bgqa["plain_ms"],
                   gqa_library_ms=bgqa["library_ms"],
                   note="plain_ms and library_ms cover the whole backward (dq, dk, dv)"),
    ] + general_rows
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
