"""Latency summaries for the engine's flight recorder.

The port's own copy of ``percentile`` and ``summarize_latencies`` from
``ray_tpu/serve/metrics.py``; the metric registry and its flush pipeline
need the ray_tpu runtime and are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def summarize_latencies(values_by_field: Dict[str, List[float]]) -> Dict[str, Dict[str, float]]:
    """{field: {p50, p95, p99, count}} over raw (unsorted) samples."""
    out: Dict[str, Dict[str, float]] = {}
    for field, raw in values_by_field.items():
        vals = sorted(raw)
        out[field] = {
            "p50": percentile(vals, 0.50),
            "p95": percentile(vals, 0.95),
            "p99": percentile(vals, 0.99),
            "count": len(vals),
        }
    return out
