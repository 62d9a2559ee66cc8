"""K7: RMSNorm with fp32 statistics (csrc/fused_rmsnorm.cu).

Replaces the Pallas kernel `vidi_tpu.ops.pallas.fused_rmsnorm.fused_rms_norm`:
x [..., D] * rsqrt(mean(x^2) + eps) * (w [+ 1]) in fp32, cast to x's dtype.
As in the JAX package, no model path calls it (the decoder's norms are
`ops/norms.py`); `chip_smoke.py` checks it against its plain version and
times it beside `torch.nn.functional.rms_norm`. On a CPU tensor the
wrapper runs `fused_rms_norm_plain`; on a CUDA tensor it launches the
kernel or raises.

Two passes on the card (`route`): rows whose starts are 16-byte aligned
and that fit a lane's registers take the vector pass (one warp a row, the
row read once, 16-byte loads and stores); any other row takes the scalar
pass (one block a row, read twice). `launches` counts both.
"""
from __future__ import annotations

import torch

from vidi_tpu_torch.ops.cuda import _lib

launches = 0  # kernel launches since the last reset (chip_smoke reads this)
VEC_BYTES = 16        # one vector load
MAX_LANE_VALUES = 128  # values of its row a lane of the vector pass holds


def fused_rms_norm(x, weight, eps: float = 1e-6, plus_one: bool = True):
    """x [..., D], weight [D] -> [..., D] in x's dtype."""
    if x.device.type == "cpu":
        return fused_rms_norm_plain(x, weight, eps, plus_one)
    return _launch(x, weight, eps, plus_one)


def fused_rms_norm_plain(x, weight, eps: float = 1e-6, plus_one: bool = True):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    w = weight.float()
    if plus_one:  # the Gemma convention: the weight is stored as scale - 1
        w = w + 1.0
    return (y * w).to(x.dtype)


def route(d: int, x_size: int, w_size: int, x_ptr: int, w_ptr: int, out_ptr: int) -> str:
    """"vec" or "scalar" for rows of d elements of x_size bytes and a weight of
    w_size-byte elements at these addresses: the vector pass wants whole
    16-byte vectors, at most MAX_LANE_VALUES values a lane (D <= 4096), and
    aligned starts."""
    per_vec = VEC_BYTES // x_size
    if d % per_vec or -(-(d // per_vec) // 32) * per_vec > MAX_LANE_VALUES:
        return "scalar"
    if x_ptr % VEC_BYTES or out_ptr % VEC_BYTES or w_ptr % min(VEC_BYTES, w_size * per_vec):
        return "scalar"
    return "vec"


def _launch(x, weight, eps, plus_one):
    global launches
    for name, t in (("x", x), ("weight", weight)):
        if not t.is_cuda or t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"fused_rms_norm {name}: expected a CUDA bf16 / fp32 "
                            f"tensor, got {t.dtype} on {t.device}")
    d = x.shape[-1]
    if weight.shape != (d,) or weight.device != x.device:
        raise ValueError(f"fused_rms_norm: weight {tuple(weight.shape)} on "
                         f"{weight.device} for D = {d} on {x.device}")
    x2 = x if x.is_contiguous() else x.contiguous()
    w = weight if weight.is_contiguous() else weight.contiguous()
    out = torch.empty_like(x2)
    vec = route(d, x2.element_size(), w.element_size(), x2.data_ptr(), w.data_ptr(),
                out.data_ptr()) == "vec"
    _lib.call("vidi_rms_norm", x.device, x2.data_ptr(), w.data_ptr(), out.data_ptr(),
              x2.numel() // d, d, x.dtype == torch.bfloat16, w.dtype == torch.bfloat16,
              bool(plus_one), vec, float(eps))
    launches += 1
    return out
