"""Move a JAX parameter tree into the port.

``params_from_jax`` takes the reference's parameter pytree as nested
dicts of numpy arrays (the caller does ``jax.device_get`` on the JAX
side; this module imports no JAX) and returns the port's dict of tensors:
the same names, the same ``[L, ...]``-stacked layouts, no transposes.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any], device="cuda", dtype: Optional[torch.dtype] = None):
    """Nested dicts of array-likes → nested dicts of tensors on ``device``
    (cast to ``dtype`` when given, else each array's own dtype)."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, Mapping):
            out[name] = params_from_jax(value, device, dtype)
            continue
        arr = np.asarray(value)
        if arr.dtype.kind not in "fiu":
            # bfloat16 arrives as an ml_dtypes scalar type numpy cannot
            # hand to torch; widen it losslessly to float32 first.
            arr = arr.astype(np.float32)
        t = torch.tensor(arr)  # a copy: the source may be read-only
        out[name] = t.to(device=device, dtype=dtype or t.dtype)
    return out
