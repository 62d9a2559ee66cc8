"""Small shared building blocks for the encoder towers (port of
vidi_tpu/ops/basic.py)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b), w [in, out], or an int8 dict from infer/quantize.py: then
    the product is W8A8 (`dynamic_qdense`, K6 on a CUDA tensor)."""
    if isinstance(w, dict):
        from vidi_tpu_torch.infer.quantize import dynamic_qdense
        return dynamic_qdense(x, w, b)
    y = x @ w
    if b is not None:
        y = y + b
    return y


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an fp32 result from bf16 operands (the JAX
    `preferred_element_type=float32` dot of the logits). On the card it is
    `_MatmulF32`: cuBLAS products of the bf16 operands that write fp32, with
    and without autograd. The CPU build has no such op (`aten::mm.dtype`),
    so on the CPU it upcasts: the same products, since bf16 values are exact
    in fp32."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        y = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed and written in fp32 from bf16 operands (cuBLAS)."""
    return torch.mm(a, b, out_dtype=torch.float32)


# Columns of dw made a product at a time: dw's fp32 sums of a 256,000-token
# vocabulary would otherwise take twice the bf16 gradient's memory at once.
DW_COLS = 32768


class _MatmulF32(torch.autograd.Function):
    """x2d @ w in fp32 from bf16 operands on the card, and its gradient as
    the reference computes it: JAX differentiates the mixed dot into two
    dots of the fp32 cotangent against the bf16 operands at the chip's
    default precision, then casts each to its operand's dtype. Here the
    cotangent is rounded to bf16 once and each product accumulates in fp32
    (`out_dtype`) before that cast; dw is made DW_COLS columns at a time,
    each column's sums as in one product. Only the bf16 operands are saved,
    and only the gradients asked for are computed."""

    @staticmethod
    def forward(ctx, x2d, w):
        ctx.save_for_backward(x2d, w)
        return _mm_f32(x2d, w)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        g = g.to(x2d.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g, w.T).to(x2d.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.empty_like(w)  # w's layout: embed.T is a transposed view
            by_rows = w.stride(0) == 1 and w.shape[1] > 1
            for j in range(0, w.shape[1], DW_COLS):
                part = g[:, j:j + DW_COLS]
                if by_rows:  # dw.T's rows are contiguous: write them whole
                    dw.T[j:j + DW_COLS] = _mm_f32(part.T, x2d)
                else:
                    dw[:, j:j + DW_COLS] = _mm_f32(x2d.T, part)
        return dx, dw


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
        scale: Optional[float] = None, use_flash: bool = False) -> torch.Tensor:
    """Full-head attention for the encoder towers (no mask, non-causal).
    q [B,T,d], k/v [B,S,d]. `use_flash` routes to the K2 tower kernel, which
    streams K/V tiles and so takes any sequence length."""
    b, t, d = q.shape
    s = k.shape[1]
    hd = d // num_heads
    if scale is None:
        scale = hd**-0.5
    qh = q.reshape(b, t, num_heads, hd)
    kh = k.reshape(b, s, num_heads, hd)
    vh = v.reshape(b, s, num_heads, hd)
    if use_flash:
        from vidi_tpu_torch.ops.cuda.tower_attention import tower_attention
        return tower_attention(qh, kh, vh, scale).reshape(b, t, d)
    logits = torch.einsum("bthd,bshd->bhts", qh.float(), kh.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs.float(), vh.float()).to(q.dtype)
    return out.reshape(b, t, d)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu_pytorch_tanh (SigLIP / Gemma2)."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) -- CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


def tower_act(x: torch.Tensor, hidden_act: str) -> torch.Tensor:
    if hidden_act == "quick_gelu":
        return quick_gelu(x)
    if hidden_act == "gelu_tanh":
        return gelu_tanh(x)
    return gelu_exact(x)
