"""K6: W8A8 int8 matmuls (csrc/quant_matmul.cu on the shared int8 core of
csrc/int8_gemm.cuh).

Replaces the Pallas kernels of `vidi_tpu.ops.pallas.quant_matmul`:

- `quant_matmul(x, wq, wscale, bias)`: per-row int8 quantize of x, int8 x
  int8 -> int32, x sx x sw (per column), cast to x's dtype, then + bias in
  the bias's dtype (outside the kernel, as in JAX). It is
  `infer.quantize.dynamic_qdense`, which every W8A8 product of the decoder
  reaches through `qdot`.
- `quant_gated_mlp(x, gate_w, up_w, down_w, hidden_act)`: one shared
  quantize of x, the gate and up products each rescaled and cast,
  act(gate) * up in x's dtype, then `quant_matmul` for the down projection.
  The decoder's W8A8 FFN (`models/decoder.mlp`).

Both reproduce the jnp W8A8 path, the numerics of record. The plain
versions compute the int8 products in float64, exact below 2^53 (the int32
sums reach 2.3e8 at K = 14,336, past fp32's 2^24), then round to fp32 as
the int32 -> fp32 convert does. Each wrapper takes its plain version for a
CPU tensor and launches the kernel, or raises, for a CUDA tensor; `launches`
counts the calls that launched, per function.
"""
from __future__ import annotations

import torch

from vidi_tpu_torch.infer.quantize import QUANT_KEY, quantize_act
from vidi_tpu_torch.ops.basic import gelu_tanh
from vidi_tpu_torch.ops.cuda import _lib

launches = {"quant_matmul": 0, "quant_gated_mlp": 0}
ACTIVATIONS = {"gelu_tanh": 0, "gelu": 1, "quick_gelu": 2, "silu": 3}  # csrc/int8_gemm.cuh


def int8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [..., K] int8 @ wq [K, N] int8 -> the exact int32 sums as fp32."""
    return (xq.double() @ wq.double()).float()


def _col_scale(scale: torch.Tensor) -> torch.Tensor:
    return scale.reshape(scale.shape[-1]).float()


def quant_matmul(x, wq, wscale, bias=None):
    """x [..., K] @ wq int8 [K, N] with per-column scales [N] (or [1, N]) ->
    [..., N] in x's dtype, + bias."""
    out = quant_matmul_plain(x, wq, wscale) if x.device.type == "cpu" \
        else _launch_matmul(x, wq, wscale)
    return out if bias is None else out + bias


def quant_matmul_plain(x, wq, wscale, bias=None):
    xq, sx = quantize_act(x)
    y = (int8_dot(xq, wq) * sx * _col_scale(wscale)).to(x.dtype)
    return y if bias is None else y + bias


def _act(x, hidden_act: str):
    return gelu_tanh(x) if hidden_act == "gelu_tanh" else torch.nn.functional.silu(x)


def quant_gated_mlp(x, gate_w, up_w, down_w, hidden_act: str):
    """act(x @ gate) * (x @ up) @ down with {qi8, scale} weights, all W8A8;
    `hidden_act` is "gelu_tanh" (Gemma2) or anything else for silu."""
    if x.device.type == "cpu":
        return quant_gated_mlp_plain(x, gate_w, up_w, down_w, hidden_act)
    h = _launch_gated(x, gate_w, up_w, hidden_act)
    return quant_matmul(h, down_w[QUANT_KEY], down_w["scale"])


def quant_gated_mlp_plain(x, gate_w, up_w, down_w, hidden_act: str):
    xq, sx = quantize_act(x)
    g = (int8_dot(xq, gate_w[QUANT_KEY]) * sx * _col_scale(gate_w["scale"])).to(x.dtype)
    u = (int8_dot(xq, up_w[QUANT_KEY]) * sx * _col_scale(up_w["scale"])).to(x.dtype)
    return quant_matmul_plain(_act(g, hidden_act) * u, down_w[QUANT_KEY], down_w["scale"])


def check_int8_weight(w, scale, k: int, name: str) -> int:
    """Raise unless w is a contiguous CUDA int8 [k, N] with N % 4 == 0 and
    scale holds N fp32 values; -> N."""
    if not (w.is_cuda and w.dtype == torch.int8 and w.dim() == 2 and w.is_contiguous()):
        raise TypeError(f"{name}: expected a contiguous CUDA int8 matrix, got "
                        f"{w.dtype} {tuple(w.shape)} on {w.device}")
    n = w.shape[1]
    if w.shape[0] != k or n % 4:
        raise ValueError(f"{name}: expected [{k}, N] with N % 4 == 0, got {tuple(w.shape)}")
    if scale.dtype != torch.float32 or scale.numel() != n or not scale.is_contiguous():
        raise ValueError(f"{name}: scale must hold {n} contiguous fp32 values, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    return n


def rows(x, name: str):
    """x [..., K] on the card -> (contiguous [M, K], K); the kernels take
    bf16 or fp32 with K % 16 == 0 (16-byte int8 row loads)."""
    if not x.is_cuda or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: expected a CUDA bf16 / fp32 tensor, got "
                        f"{x.dtype} on {x.device}")
    k = x.shape[-1]
    if k % 16:
        raise ValueError(f"{name}: the contraction dim must be a multiple of 16, got {k}")
    x2 = x.reshape(-1, k).contiguous()
    if x2.shape[0] == 0:
        raise ValueError(f"{name}: no rows")
    return x2, k


def scratch(m: int, k: int, device):
    """Per-row int8 copy and scales of an [m, k] operand."""
    return (torch.empty((m, k), dtype=torch.int8, device=device),
            torch.empty((m,), dtype=torch.float32, device=device))


def _launch_matmul(x, wq, wscale):
    x2, k = rows(x, "quant_matmul x")
    n = check_int8_weight(wq, wscale, k, "quant_matmul wq")
    m = x2.shape[0]
    xq, sx = scratch(m, k, x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib.library().vidi_quant_matmul(
            x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), wq.data_ptr(),
            wscale.data_ptr(), out.data_ptr(), m, n, k, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(err, "quant_matmul")
    launches["quant_matmul"] += 1
    return out.reshape(*x.shape[:-1], n)


def _launch_gated(x, gate_w, up_w, hidden_act):
    x2, k = rows(x, "quant_gated_mlp x")
    n = check_int8_weight(gate_w[QUANT_KEY], gate_w["scale"], k, "quant_gated_mlp gate_w")
    if check_int8_weight(up_w[QUANT_KEY], up_w["scale"], k, "quant_gated_mlp up_w") != n:
        raise ValueError("quant_gated_mlp: gate and up widths differ")
    m = x2.shape[0]
    xq, sx = scratch(m, k, x.device)
    h = torch.empty((m, n), dtype=x.dtype, device=x.device)
    act = ACTIVATIONS["gelu_tanh" if hidden_act == "gelu_tanh" else "silu"]
    with torch.cuda.device(x.device):
        err = _lib.library().vidi_quant_gated(
            x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), gate_w[QUANT_KEY].data_ptr(),
            gate_w["scale"].data_ptr(), up_w[QUANT_KEY].data_ptr(), up_w["scale"].data_ptr(),
            h.data_ptr(), m, n, k, act, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(err, "quant_gated_mlp")
    launches["quant_gated_mlp"] += 1
    return h.reshape(*x.shape[:-1], n)
