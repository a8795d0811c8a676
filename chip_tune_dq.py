"""Time variants of the dQ kernel (``ray_tpu_torch/ops/csrc/flash_bwd.cu``)
against each other on one card, in turns.

    python3 chip_tune_dq.py                 # every variant in VARIANTS
    python3 chip_tune_dq.py committed kv33  # some of them

Each variant is the committed source with a few text substitutions (ring
depths, consumer turn-taking, Δ left out), built with the port's nvcc
flags into a temporary directory and called through ctypes. The script
prints each variant's ptxas lines and SASS counts, holds each to the plain
backward at four shapes (the variant that leaves Δ out is timed only: its
dQ is wrong by design), times every variant at the training and the GQA
shape four times in alternating order, with the torch Δ expression and
SDPA's whole backward as yardsticks, and ends with one JSON line. Exits
non-zero if a variant does not build or disagrees with the plain version.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as att

CSRC = _build.CSRC_DIR


def _stages(k: int, v: int) -> list:
    return [("constexpr int kStagesK = 4;", f"constexpr int kStagesK = {k};"),
            ("constexpr int kStagesV = 2;", f"constexpr int kStagesV = {v};")]


# The forward's turn-taking (named barriers 3 and 4): each consumer issues
# its products only on its turn; the first consumer's skipped tiles count
# as turns too.
_TURNS = [
    ("    uint8_t* const dq_smem = base_ptr + S::kdQ + c * TD::kBytes;\n",
     "    uint8_t* const dq_smem = base_ptr + S::kdQ + c * TD::kBytes;\n"
     "    auto my_turn = [&] { hopper::named_bar_sync(3 + c, 256); };\n"
     "    auto pass_turn = [&] { hopper::named_bar_arrive(4 - c, 256); };\n"
     "    if (c == 1) pass_turn();\n"),
    ("        issue_s_dp<kBf16, D>(sc, dp, dq_a, ddo_a, TK::k_major(sK(T), 0), TK::k_major(sV(T), 0));\n",
     "        my_turn();\n"
     "        issue_s_dp<kBf16, D>(sc, dp, dq_a, ddo_a, TK::k_major(sK(T), 0), TK::k_major(sV(T), 0));\n"
     "        pass_turn();\n"),
    ("        issue_dq<kBf16, D>(acc, df, TK::mn_major(sK(n - 1)));\n",
     "        issue_dq<kBf16, D>(acc, df, TK::mn_major(sK(n - 1)));\n        pass_turn();\n"),
    ("        issue_s_dp<kBf16, D>(sc, dp, dq_a, ddo_a, TK::k_major(sK(n), 0), TK::k_major(sV(n), 0));\n",
     "        my_turn();\n"
     "        issue_s_dp<kBf16, D>(sc, dp, dq_a, ddo_a, TK::k_major(sK(n), 0), TK::k_major(sV(n), 0));\n"),
    ("        issue_dq<kBf16, D>(acc, df, TK::mn_major(sK(n)));\n",
     "        my_turn();\n        issue_dq<kBf16, D>(acc, df, TK::mn_major(sK(n)));\n        pass_turn();\n"),
    ("        release(empty_v(n));\n      }\n      T += n_tiles;",
     "        release(empty_v(n));\n        my_turn();\n        pass_turn();\n      }\n      T += n_tiles;"),
]

VARIANTS = {
    "committed": [],
    "kv33": _stages(3, 3),
    "kv22": _stages(2, 2),
    "kv51": _stages(5, 1),
    "turns": _TURNS,
    "kv33_turns": _stages(3, 3) + _TURNS,
    "no_delta": [("row_delta<kBf16, D>(dl, base_ptr + S::kdO, base_ptr + S::kO, r_local, tg);",
                  "dl[0] = dl[1] = 0.f;")],
}
TIMED_ONLY = {"no_delta"}


def build(name: str, subs, root: str, source: str = "flash_bwd.cu"):
    """→ (name, library path or None, ptxas lines and SASS counts, or the
    compiler's output). ``subs``: (old, new) substitutions of the committed
    ``csrc/<source>``, each matching once, or the path of another source
    of the same entry points."""
    d = os.path.join(root, name)
    os.makedirs(d)
    with open(subs if isinstance(subs, str) else os.path.join(CSRC, source)) as f:
        src = f.read()
    for old, new in [] if isinstance(subs, str) else subs:
        if src.count(old) != 1:
            return name, None, f"substitution does not match once: {old!r}"
        src = src.replace(old, new)
    for header in ("hopper.cuh", "flash_common.cuh"):
        shutil.copy(os.path.join(CSRC, header), d)
    with open(os.path.join(d, source), "w") as f:
        f.write(src)
    out = os.path.join(d, "libkernel.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                           os.path.join(d, source)], capture_output=True, text=True)
    if proc.returncode:
        return name, None, proc.stdout + proc.stderr
    info = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if re.search(r"registers|spill|warning|serialized", line)]
    info.append(json.dumps(chip_smoke.sass_counts(out)))
    return name, out, "\n".join(info)


def entry(path: str, fn_name: str = "flash_bwd_dq"):
    """The dQ entry point ``fn_name`` of a built variant (the signature of
    ``flash_bwd_dq`` and ``flash_bwd_dq_wide``)."""
    fn = getattr(ctypes.CDLL(path), fn_name)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tune_dq: no CUDA device", file=sys.stderr)
        return 1
    wanted = sys.argv[1:] or list(VARIANTS)
    print(chip_smoke.card_line(), flush=True)
    failed = []
    with tempfile.TemporaryDirectory() as root:
        with ThreadPoolExecutor(len(wanted)) as pool:
            built = list(pool.map(lambda n: build(n, VARIANTS[n], root), wanted))
        fns = {}
        for name, path, info in built:
            print(f"[build] {name}:\n{info}", flush=True)
            if path:
                fns[name] = entry(path)
            else:
                failed.append(name)
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(5)
        shapes = [("train", 12, 18, 18, 2048, 2048, 128, True),
                  ("gqa", 2, 32, 8, 2048, 2048, 128, True),
                  ("causal 257", 1, 2, 2, 257, 257, 128, True),
                  ("noncausal 65x65", 1, 2, 2, 65, 65, 128, False)]
        results = {}
        for label, b, H, KV, ql, kl, hd, causal in shapes:
            def rand(*shape):
                return torch.randn(*shape, generator=gen, device=dev).bfloat16()

            q, do, k, v = rand(b, H, ql, hd), rand(b, H, ql, hd), rand(b, KV, kl, hd), rand(b, KV, kl, hd)
            scale = hd**-0.5
            o, lse = att.flash_forward_cuda(q, k, v, causal, scale)
            dq_ref = att.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                                                   lse, do.float(), causal, scale)[0]
            stream = torch.cuda.current_stream().cuda_stream

            def run(fn):
                dq = torch.empty_like(q)
                delta = torch.empty(q.shape[:3], device=dev)
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                         lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), b, H, KV, ql, kl, hd,
                         scale, int(causal), 1, stream)
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
            if label in ("train", "gqa"):
                for turn in range(4):
                    for name in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
                        row[name]["ms"].append(chip_smoke.time_ms(lambda: run(fns[name])))
                row["delta_torch_ms"] = chip_smoke.time_ms(lambda: (do.float() * o.float()).sum(-1))
                row["sdpa_backward_ms"] = chip_smoke.sdpa_backward_ms(q, k, v, do, causal, scale)
            print(f"[tune] {label}: " + json.dumps(row), flush=True)
    print(json.dumps({"card": chip_smoke.card_line(), "failed": failed, "results": results}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
