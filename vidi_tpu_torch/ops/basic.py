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


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b), w [in, out]."""
    y = x @ w
    if b is not None:
        y = y + b
    return y


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an fp32 result from bf16 operands (the JAX
    `preferred_element_type=float32` dot): cuBLAS writes fp32 directly on
    the card. That op has no autograd formula and the CPU has no such op,
    so under autograd, and on the CPU, it upcasts: the same products, since
    bf16 values are exact in fp32."""
    if x.dtype == torch.float32:
        return x @ w
    needs_grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.is_cuda and not needs_grad:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


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
