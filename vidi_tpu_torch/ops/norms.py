"""RMS normalization ops (port of vidi_tpu/ops/norms.py).

Statistics in fp32, result cast back to the input dtype.
"""
from __future__ import annotations

import torch


def _normed(x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps)


def rms_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Weightless RMS norm, computed in fp32 and cast back."""
    return _normed(x, eps).to(x.dtype)


def scaled_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """weight * rms_norm(x) -- the mm-adapter RMSNorm (the product is taken
    in the promoted dtype of weight and x, then cast to x's dtype)."""
    return (weight * rms_norm(x, eps)).to(x.dtype)


def gemma_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style (1 + w) * rms_norm(x), fp32 internals."""
    return (_normed(x, eps) * (1.0 + weight.float())).to(x.dtype)


def mistral_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Llama/Mistral-style w * rms_norm(x)."""
    return (weight.float() * _normed(x, eps)).to(x.dtype)
