"""Parameter conversion into the port's layout.

`params_from_jax` takes a vidi_tpu parameter tree (nested dicts of numpy
arrays, or of anything `numpy.asarray` accepts) and returns the port's
parameters: the same keys, torch tensors, and every scanned `layers` dict
of stacked [L, ...] leaves (quantized dicts included) unstacked into a list
of L per-layer dicts. The
tests use it to run both packages on the same weights. Loading a released
HF checkpoint (safetensors) comes later.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vidi_tpu_torch.infer.quantize import QUANT4_KEY, QUANT_KEY, tree_leaves


def _tensor(x, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)  # ml_dtypes bfloat16: torch has no numpy bf16
    t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, dtype: Optional[torch.dtype] = None,
                    device="cpu"):
    """vidi_tpu parameter tree -> port parameters (see module docstring).
    `dtype` casts floating leaves (None keeps each leaf's own precision,
    with bfloat16 leaves arriving as float32). Quantized leaves ({qi8 |
    qi4 int8, scale fp32}) keep their int8 values and fp32 scales whatever
    `dtype` asks."""
    if isinstance(tree, dict):
        if QUANT_KEY in tree or QUANT4_KEY in tree:
            return {k: _tensor(v, None, device) for k, v in tree.items()}
        out = {}
        for key, val in tree.items():
            if key == "layers" and isinstance(val, dict):
                n = len(np.asarray(next(tree_leaves(val))))
                out[key] = [params_from_jax(_take(val, i), dtype, device)
                            for i in range(n)]
            else:
                out[key] = params_from_jax(val, dtype, device)
        return out
    return _tensor(tree, dtype, device)


def _take(tree, i: int):
    """Layer i of a tree of stacked [L, ...] leaves."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
