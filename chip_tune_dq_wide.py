"""Time variants of the wide dQ kernel (``ray_tpu_torch/ops/csrc/flash_bwd_wide.cu``)
against each other on one card, in turns.

    python3 chip_tune_dq_wide.py                 # every variant in VARIANTS
    python3 chip_tune_dq_wide.py committed k3v3  # some of them
    python3 chip_tune_dq_wide.py committed old=path/to/flash_bwd_wide.cu  # another source

Each variant is the committed source with a few text substitutions, built
with the port's nvcc flags into a temporary directory and called through
ctypes: other K and V ring depths, or a part of the kernel left out to show
what bounds it. ``no_kv_loads`` issues no TMA load of K or V (the producer
only arrives on their barriers); ``no_mma`` issues no wgmma; ``no_sync``
leaves out the two named barriers of the consumers' dS hand-over;
``mma_only`` keeps the products and their waits but no loads and no dS;
``s_dp_only`` and ``dq_only`` keep only S and dP, or only dQ's product, of
``mma_only``. Their dQ is wrong by design, so they are timed only. The
script prints each variant's ptxas lines and SASS counts, holds the others
to the plain backward at three shapes, times every variant at the timed
shapes four times in alternating order, with SDPA's whole backward and the
bound as yardsticks, and ends with one JSON line. Exits non-zero if a
variant does not build or disagrees with the plain version.
"""
from __future__ import annotations

import json
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke
from chip_tune_dq import build, entry
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as att

SOURCE = "flash_bwd_wide.cu"


def _stages(k: int, v: int) -> list:
    """K and V ring depths at D = 256 (D = 192 keeps the committed ones)."""
    return [("static constexpr int kStagesK = D == 256 ? 4 : 5;",
             f"static constexpr int kStagesK = D == 256 ? {k} : 5;"),
            ("static constexpr int kStagesV = D == 256 ? 2 : 3;",
             f"static constexpr int kStagesV = D == 256 ? {v} : 3;")]


def _off(statement: str) -> tuple:
    """The statement that starts with ``statement`` is not executed."""
    return statement, "if (0) " + statement


_NO_LOADS = [("hopper::mbar_arrive_expect_tx(l.full_k(n), T::kBytes);",
              "hopper::mbar_arrive(l.full_k(n));"),
             ("hopper::mbar_arrive_expect_tx(l.full_v(n), T::kBytes);",
              "hopper::mbar_arrive(l.full_v(n));"),
             _off("hopper::tma_load_3d(l.k(n) + b * T::kBoxBytes"),
             _off("hopper::tma_load_3d(l.v(n) + b * T::kBoxBytes")]
_NO_DS = [_off("form_half<kBf16, kC, D>(own,"), ("hand_over<kC, D>(own, l, tid);", ";")]
_NO_X_MMA = _off("hopper::wgmma_rs<kBlockK, kBf16, 0>(x,")
_NO_DQ_MMA = _off("hopper::wgmma_rs<N, kBf16, 1>(acc,")

# (old, new) substitutions of the committed source, each matching once.
VARIANTS = {
    "committed": [],
    "k3v3": _stages(3, 3),
    "k5v1": _stages(5, 1),
    "no_kv_loads": _NO_LOADS,
    "no_mma": [_NO_X_MMA, _NO_DQ_MMA],
    "no_sync": [("hopper::named_bar_sync(kBarHalves, 256);", ";"),
                ("hopper::named_bar_sync(kBarPacked, 256);", ";")],
    "mma_only": _NO_LOADS + _NO_DS,
    "s_dp_only": _NO_LOADS + _NO_DS + [_NO_DQ_MMA],
    "dq_only": _NO_LOADS + _NO_DS + [_NO_X_MMA],
}
TIMED_ONLY = {"no_kv_loads", "no_mma", "no_sync", "mma_only", "s_dp_only", "dq_only"}
# (label, b, H, KV, q_len, k_len, hd, causal, dtype, timed)
SHAPES = [
    ("bf16 [1, 16/16, 2048, 256] causal", 1, 16, 16, 2048, 2048, 256, True, torch.bfloat16,
     True),
    ("wide train [12, 9, 2048, 256] causal", 12, 9, 9, 2048, 2048, 256, True, torch.bfloat16,
     True),
    ("bf16 [1, 16/16, 2048, 192] causal", 1, 16, 16, 2048, 2048, 192, True, torch.bfloat16,
     True),
    ("causal 130 hd256", 1, 2, 2, 130, 130, 256, True, torch.bfloat16, False),
    ("fp16 gqa 2:1 causal 257 hd192", 1, 2, 1, 257, 257, 192, True, torch.float16, False),
    ("gqa 3:1 noncausal 65x150 hd176", 1, 3, 1, 65, 150, 176, False, torch.bfloat16, False),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tune_dq_wide: no CUDA device", file=sys.stderr)
        return 1
    wanted = sys.argv[1:] or list(VARIANTS)
    variants = {**VARIANTS, **dict(w.split("=", 1) for w in wanted if "=" in w)}
    wanted = [w.split("=", 1)[0] for w in wanted]
    card = torch.cuda.get_device_name(0)
    print(chip_smoke.card_line(), flush=True)
    failed = []
    with tempfile.TemporaryDirectory() as root:
        with ThreadPoolExecutor(len(wanted) + 1) as pool:
            fwd = pool.submit(_build.build, "flash_fwd_wide")
            built = list(pool.map(lambda n: build(n, variants[n], root, SOURCE), wanted))
            fwd.result()
        fns = {}
        for name, path, info in built:
            print(f"[build] {name}:\n{info}", flush=True)
            if path:
                fns[name] = entry(path, "flash_bwd_dq_wide")
            else:
                failed.append(name)
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(5)
        results = {}
        for label, b, H, KV, ql, kl, hd, causal, dtype, timed in SHAPES:
            def rand(*shape):
                return torch.randn(*shape, generator=gen, device=dev).to(dtype)

            q, do = rand(b, H, ql, hd), rand(b, H, ql, hd)
            k, v = rand(b, KV, kl, hd), rand(b, KV, kl, hd)
            scale = hd**-0.5
            o, lse = att.flash_forward_wide_cuda(q, k, v, causal, scale)
            dq_ref = att.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                                                   lse, do.float(), causal, scale)[0]
            stream = torch.cuda.current_stream().cuda_stream

            def run(fn):
                dq = torch.empty_like(q)
                delta = torch.empty(q.shape[:3], device=dev)
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                         lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), b, H, KV, ql, kl, hd,
                         scale, int(causal), int(dtype == torch.bfloat16), stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
                return dq

            row = results[label] = {}
            for name, fn in fns.items():
                dq = run(fn)
                torch.cuda.synchronize()
                rel = ((dq.float() - dq_ref).abs().max() / dq_ref.abs().max()).item()
                row[name] = {"rel_err": rel, "ms": []}
                if name not in TIMED_ONLY and not rel <= chip_smoke.GRAD_REL_TOL:
                    failed.append(f"{name} at {label}")
            if timed:
                for turn in range(4):
                    for name in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
                        row[name]["ms"].append(chip_smoke.time_ms(lambda: run(fns[name])))
                row["sdpa_backward_ms"] = chip_smoke.sdpa_backward_ms(q, k, v, do, causal, scale)
                row["bound_ms"] = chip_smoke.attention_bound_ms(b, H, KV, ql, kl, hd, causal,
                                                                q.element_size(), card, "dq")[0]
            print(f"[tune] {label}: " + json.dumps(row), flush=True)
            del q, do, k, v, o, lse, dq_ref
            torch.cuda.empty_cache()
    print(json.dumps({"card": chip_smoke.card_line(), "failed": failed, "results": results}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
