"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py                 # every phase (one card)
    python3 chip_smoke.py --kernels-only  # build + kernel phase only
    python3 chip_smoke.py --profile       # also torch.profiler breakdowns

Phases, in order; any failure raises and the process exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every kernel of the serving path from ``ray_tpu_torch/ops/csrc``;
  3. kernel phase: each kernel's wrapper on the card against its plain
     PyTorch version at the shapes the main path gives it (and the CPU
     test shapes), with times, the bound and a library yardstick;
  4. slice phase: ``LLMEngine`` serving llama7b (bf16, full width, random
     weights from a seed) through the paged engine, then a shared-prefix
     pass and a chunked-prefill pass; the kernel's launch counter must
     equal 32 x the full-prompt prefills, and full-width prefill logits
     through the kernel must match the same forward through the plain
     version.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a
card the script fails before printing any result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

# Published dense peaks (NVIDIA data sheets): bf16/fp16 tensor-core FLOP/s
# and device-memory bytes/s, by the name torch reports.
_PEAKS = (
    ("H100 PCIe", 756e12, 2.0e12),
    ("H100 NVL", 835e12, 3.9e12),
    ("H200", 989e12, 4.8e12),
    ("H100", 989e12, 3.35e12),
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def peaks(name: str):
    for key, flops, bw in _PEAKS:
        if key in name:
            return flops, bw
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


def attention_bound_ms(b, H, KV, q_len, k_len, hd, causal, elem_bytes, card):
    """Least time for the work: max(bytes / memory rate, FLOPs / bf16 peak).
    Bytes: q, o, k, v once each plus the fp32 lse. FLOPs: 2 products of
    2*hd per (query, key) pair this causal mask keeps."""
    flops_peak, bw = peaks(card)
    if causal:
        pairs = sum(min(i + 1, k_len) for i in range(q_len))
    else:
        pairs = q_len * k_len
    flops = 4.0 * hd * pairs * b * H
    nbytes = elem_bytes * hd * (2 * b * H * q_len + 2 * b * KV * k_len) + 4 * b * H * q_len
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
        ("gqa 32q/8kv S=2048", 2, 32, 8, 2048, 2048, 128, True, torch.bfloat16, True),
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
    ]
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
    # A CUDA input the kernel cannot take raises; it never falls back.
    for bad in (lambda: att.flash_attention(q.float(), k.float(), v.float()),
                lambda: att.flash_attention(rand(1, 2, 8, 24), rand(1, 2, 8, 24), rand(1, 2, 8, 24))):
        try:
            bad()
        except (TypeError, ValueError) as e:
            log(f"[kernel] rejected as expected: {e}")
        else:
            raise AssertionError("flash_attention accepted an input the kernel cannot take")
    head = next(r for r in rows if r["shape"] == "slice S=1024")
    return {"rows": rows, "max_err": max_err, "head": head}


def profile_pass(eng, prompts, n_new, label: str, card: str) -> dict:
    """One generate_batch timed on the host clock with the profiler off,
    then the same work again under torch.profiler for the device-busy time
    (sum of kernel self device time; one stream) and the top kernels. The
    idle share is 1 - busy / unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate_batch(prompts, n_new)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.generate_batch(prompts, n_new)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    out = {
        "pass": label, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "top_kernels": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                         "share": e.self_device_time_total / max(busy_us, 1e-9),
                         "count": e.count} for e in top],
    }
    log(f"[profile] {label} on {card}: " + json.dumps(out))
    return out


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
    att.flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts, n_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = att.flash_attention.launches
    full = eng.stats["full_prefills"] - base["full_prefills"]
    check_outputs(outs, n_new)
    if full < len(prompts) or launches != cfg.n_layers * full:
        raise AssertionError(f"launches {launches} != {cfg.n_layers} x {full} full prefills")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true", help="build + kernel phase only")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a prefill and a decode pass")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on the card",
              file=sys.stderr)
        return 1
    from ray_tpu_torch.ops import _build

    card = torch.cuda.get_device_name(0)
    smi = card_line()
    log(f"[card] {smi}")
    log(f"[versions] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    info = _build.build("flash_fwd")
    log(f"[build] flash_fwd.cu: {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build]   {line.strip()}")
    kern = kernel_phase(card)
    launches = None
    if not args.kernels_only:
        sl = slice_phase(card, profile=args.profile)
        launches = sl["main"]["flash_fwd_launches"]
    head = kern["head"]
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:56",
        "launches": launches,
        "max_abs_err": kern["max_err"],
        "max_err": kern["max_err"],
        "ms": head["ms"],
        "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": head["shape"],
        "card": smi,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
