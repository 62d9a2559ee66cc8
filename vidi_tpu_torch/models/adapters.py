"""Multimodal adapters, v1.5 (9B) generation (port of
vidi_tpu/models/adapters.py): Conv2DPool (pad 27->28, optional bilinear
budget resize, space_to_depth), the token-budget rule, the "mlp2x_gelu"
projector, the fractional-sinusoid position MLP and the audio pool conv
(k = s = pool, no bias) as a reshaped matmul.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vidi_tpu_torch.ops.norms import rms_norm

Params = Dict[str, torch.Tensor]


def space_to_depth(x: torch.Tensor, m: int = 2) -> torch.Tensor:
    """[N,H,W,C] -> [N,H/m,W/m,C*m*m], channel index c*m*m + i*m + j."""
    n, h, w, c = x.shape
    if h % m or w % m:
        raise ValueError(f"space_to_depth: {h}x{w} not divisible by {m}")
    x = x.reshape(n, h // m, m, w // m, m, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, h // m, w // m, c * m * m)


def resize_by_tokens(num_frames: int, padded_side: int,
                     max_tokens: int) -> Tuple[int, int]:
    """Token-budget spatial size (host-side)."""
    ratio = math.sqrt(max_tokens / (num_frames * padded_side * padded_side))
    temp = int(padded_side * ratio)
    new = max(10, temp - temp % 2)
    return new, new


def budget_hw(num_frames: int, pool_size: int, side: int = 27,
              max_tokens_base: int = 60000) -> Tuple[int, int]:
    """Pooled-input spatial size for a video of `num_frames`: the padded
    (side+1) grid, downscaled when the video is over the token budget."""
    padded = side + 1
    n_tokens = num_frames * padded * padded
    max_tokens = max_tokens_base * pool_size * pool_size
    if n_tokens > max_tokens:
        return resize_by_tokens(num_frames, padded, max_tokens)
    return padded, padded


def conv2d_pool(feats: torch.Tensor, hw: Tuple[int, int],
                merge: int = 2) -> torch.Tensor:
    """[N,S,S,C] -> pad right/bottom by 1, optional bilinear resize
    (half-pixel centres, no antialias), space_to_depth merge."""
    n, s, _, c = feats.shape
    x = F.pad(feats, (0, 0, 0, 1, 0, 1))
    if hw[0] != s + 1 or hw[1] != s + 1:
        x = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(hw),
                          mode="bilinear", align_corners=False,
                          antialias=False).permute(0, 2, 3, 1).to(feats.dtype)
    return space_to_depth(x, merge)


def mlp_projector(params: Params, x: torch.Tensor, depth: int = 2) -> torch.Tensor:
    for i in range(depth):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < depth - 1:
            x = F.gelu(x)
    return x


def _fractional_sinusoid(p: torch.Tensor, d: int) -> torch.Tensor:
    """Interleaved sin/cos table, pe[..., 0::2] = sin, pe[..., 1::2] = cos;
    p of any shape -> [*p.shape, d]."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=p.device)
                    * (-math.log(10000.0) / d))
    ang = p.float()[..., None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(*p.shape, d)


def pos_mlp(params: Params, frac: torch.Tensor, d: int) -> torch.Tensor:
    """The fp32 pos-embed MLP at fractional anchor positions of any shape."""
    h = _fractional_sinusoid(frac, d) @ params["w0"] + params["b0"]
    return F.gelu(h) @ params["w1"] + params["b1"]


def jitter(p: torch.Tensor, noise: torch.Tensor, top) -> torch.Tensor:
    """Training position noise: p + clip(0.45 * noise, +-0.45), clamped to
    [0, top]; `noise` holds standard-normal draws of p's shape."""
    noise = torch.clamp(noise.to(p.device, torch.float32) * 0.45, -0.45, 0.45)
    return torch.minimum(torch.clamp(p + noise, min=0.0), torch.as_tensor(top))


def pos_embed(params: Params, length: int, n_anchors: int, d: int, *,
              device, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Positional table [length, d]. Positions arange(length) are
    normalized onto [0, n_anchors - 1]; with `noise` ([length] standard-normal
    draws, training) they are jittered first when length > 1."""
    p = torch.arange(length, dtype=torch.float32, device=device)
    if noise is not None and length > 1:
        p = jitter(p, noise, float(length - 1))
    p = p / max(length - 1, 1) * (n_anchors - 1)
    return pos_mlp(params, p, d)


def add_pos(x: torch.Tensor, pe: torch.Tensor, axis: int,
            eps: float = 1e-5) -> torch.Tensor:
    """x + rms_norm(pe) broadcast along `axis`."""
    pe = rms_norm(pe, eps).to(x.dtype)
    shape = [1] * (x.dim() - 1) + [pe.shape[-1]]
    shape[axis] = pe.shape[0]
    return x + pe.reshape(shape)


def audio_pool(params: Params, x: torch.Tensor, pool: int) -> torch.Tensor:
    """[B,T,d_in] -> [B,T//pool,d_out]; trailing remainder dropped. The
    conv weight is [O,I,K]; the product accumulates in fp32."""
    b, t, c = x.shape
    t_out = t // pool
    xr = x[:, : t_out * pool].reshape(b, t_out, pool, c)
    w = params["w"]
    out = torch.einsum("btkc,ock->bto", xr.float(), w.float())
    return out.to(x.dtype)


# --- random init (shapes and scales of the JAX init) -------------------------

def _nrm(gen, shape, scale, dtype, device):
    return torch.randn(shape, generator=gen, device=device, dtype=dtype) * scale


def init_mlp_projector(gen, d_in, d_out, depth, dtype, device) -> Params:
    dims = [d_in] + [d_out] * depth
    params = {}
    for i in range(depth):
        params[f"w{i}"] = _nrm(gen, (dims[i], dims[i + 1]), dims[i]**-0.5,
                               dtype, device)
        params[f"b{i}"] = torch.zeros((dims[i + 1],), dtype=dtype, device=device)
    return params


def init_pos_embed(gen, d, device) -> Params:
    """fp32 MLP regardless of the model dtype."""
    f32 = torch.float32
    return {"w0": _nrm(gen, (d, d), d**-0.5, f32, device),
            "b0": torch.zeros((d,), dtype=f32, device=device),
            "w1": _nrm(gen, (d, d), d**-0.5, f32, device),
            "b1": torch.zeros((d,), dtype=f32, device=device)}


def init_audio_pool(gen, d_in, d_out, pool, dtype, device) -> Params:
    return {"w": _nrm(gen, (d_out, d_in, pool), (d_in * pool)**-0.5, dtype, device)}


def init_rms_norm(d, std, dtype, device) -> Params:
    return {"weight": torch.full((d,), std, dtype=dtype, device=device)}
