"""Compare the attention kernels of two checkouts on one card, in turns.

    git archive <commit> | tar -x -C .chip_archive/base   # a git-ignored directory
    python3 chip_ab.py .chip_archive/base                 # base, this tree, this tree, base

Runs ``chip_smoke.py --kernels-only`` from the base checkout and from this
one, alternated (base, change, change, base), so both sides share the card,
its power limit and its neighbours. Reads every timed ``[kernel]`` row
(forward ``ms``; backward ``dq_ms``, ``dkv_ms``; the general kernels'
``fwd_ms``, ``dq_ms``, ``dkv_ms``; the Hopper and wide kernels' ``fwd_ms``,
``dq_ms``, ``dkv_ms`` at the general phase's shapes) and prints, per kernel and
shape, both runs of each side and the change's mean over the base's, and
the whole table as one JSON object on the last line. Exits non-zero if any
run fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def run(checkout: str) -> tuple:
    """One ``chip_smoke.py --kernels-only`` → (card line, {(kernel, shape): ms})."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--kernels-only"], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"chip_smoke.py failed in {checkout}:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    return lines[0], parse(lines)


def parse(lines) -> dict:
    """{(kernel, shape): ms} from the timed ``[kernel]`` rows of a run."""
    times = {}
    for line in lines:
        for prefix, keys in (("[kernel] flash_fwd ", {"ms": "fwd"}),
                             ("[kernel] flash_bwd ", {"dq_ms": "dq", "dkv_ms": "dkv"}),
                             ("[kernel] flash_general ", {"fwd_ms": "general_fwd",
                                                          "dq_ms": "general_dq",
                                                          "dkv_ms": "general_dkv"}),
                             ("[kernel] flash_wide ", {"fwd_ms": "wide_fwd",
                                                       "dq_ms": "wide_dq",
                                                       "dkv_ms": "wide_dkv"}),
                             ("[kernel] flash_hopper ", {"fwd_ms": "fwd", "dq_ms": "dq",
                                                         "dkv_ms": "dkv"})):
            if line.startswith(prefix) and ": {" in line:
                shape, row = line[len(prefix):].split(": ", 1)
                row = json.loads(row)
                for key, kernel in keys.items():
                    if key in row:
                        times[(kernel, shape)] = row[key]
    return times


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    base = os.path.abspath(sys.argv[1])
    order = [("base", base), ("change", HERE), ("change", HERE), ("base", base)]
    runs = {"base": [], "change": []}
    card = None
    for side, checkout in order:
        card, times = run(checkout)
        runs[side].append(times)
        print(f"[ab] {side} run {len(runs[side])} done ({checkout})", flush=True)
    table = []
    for key in sorted(set(runs["change"][0]) | set(runs["base"][0])):
        b = [r.get(key) for r in runs["base"]]
        c = [r.get(key) for r in runs["change"]]
        row = {"kernel": key[0], "shape": key[1], "base_ms": b, "change_ms": c}
        if None not in b and None not in c:
            row["change_over_base"] = sum(c) / sum(b)
        table.append(row)
        print(f"[ab] {key[0]:>11} {key[1]:<28} base {b} change {c} "
              f"ratio {row.get('change_over_base')}", flush=True)
    print(json.dumps({"card": card, "order": [s for s, _ in order], "rows": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
