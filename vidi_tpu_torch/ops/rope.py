"""Rotary position embeddings, HF rotate-half layout (port of
vidi_tpu/ops/rope.py). Tables are computed in fp32."""
from __future__ import annotations

from typing import Tuple

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape positions.shape + [head_dim]."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device) / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B,T,H,D]; cos/sin [B,T,D] or [T,D]."""
    if cos.dim() == x.dim() - 1:  # add the head axis
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    xf = x.float()
    return (xf * cos.float() + _rotate_half(xf) * sin.float()).to(x.dtype)
