"""K7: RMSNorm with fp32 statistics (csrc/fused_rmsnorm.cu).

Replaces the Pallas kernel `vidi_tpu.ops.pallas.fused_rmsnorm.fused_rms_norm`:
x [..., D] * rsqrt(mean(x^2) + eps) * (w [+ 1]) in fp32, cast to x's dtype.
As in the JAX package, no model path calls it (the decoder's norms are
`ops/norms.py`); `chip_smoke.py` checks it against its plain version and
times it beside `torch.nn.functional.rms_norm`. On a CPU tensor the
wrapper runs `fused_rms_norm_plain`; on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from vidi_tpu_torch.ops.cuda import _lib

launches = 0  # kernel launches since the last reset (chip_smoke reads this)


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


def _launch(x, weight, eps, plus_one):
    global launches
    for name, t in (("x", x), ("weight", weight)):
        if not t.is_cuda or t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"fused_rms_norm {name}: expected a CUDA bf16 / fp32 "
                            f"tensor, got {t.dtype} on {t.device}")
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"fused_rms_norm: weight {tuple(weight.shape)} for D = {d}")
    x2 = x.reshape(-1, d).contiguous()
    w = weight.contiguous()
    out = torch.empty_like(x2)
    with torch.cuda.device(x.device):
        err = _lib.library().vidi_rms_norm(
            x2.data_ptr(), w.data_ptr(), out.data_ptr(), x2.shape[0], d,
            int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            int(plus_one), float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(err, "fused_rms_norm")
    launches += 1
    return out.reshape(x.shape)
