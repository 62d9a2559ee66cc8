"""Whisper audio encoder (port of vidi_tpu/models/whisper.py).

mel [B, n_mels, 3000] -> conv1(k3,s1,p1)+gelu -> conv2(k3,s2,p1)+gelu ->
+ sinusoidal positions -> pre-norm layers (k_proj has no bias) -> final
layer norm -> [B, 1500, d]. Exact (erf) GELU throughout. Layers with int8
weights run K5's fused pieces.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from vidi_tpu_torch.core.config import AudioConfig
from vidi_tpu_torch.infer.quantize import is_quantized
from vidi_tpu_torch.ops.basic import dense, gelu_exact, layer_norm, mha
from vidi_tpu_torch.ops.cuda import fused_tower_layer as ftl

Params = Dict


def sinusoidal_positions(length: int, d: int) -> np.ndarray:
    """Whisper's sinusoid table: [sin | cos] halves (not interleaved)."""
    half = d // 2
    log_timescale = np.log(10000.0) / (half - 1)
    inv = np.exp(-log_timescale * np.arange(half, dtype=np.float32))
    ang = np.arange(length, dtype=np.float32)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


def init_params(cfg: AudioConfig, dtype, device, gen: torch.Generator) -> Params:
    """Random init with the JAX init's shapes and scales."""
    d, ff = cfg.d_model, cfg.ffn_dim

    def nrm(shape, scale):
        return (torch.randn(shape, generator=gen, device=device, dtype=dtype)
                * scale)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    layers = [{
        "ln1_scale": const((d,), 1.0), "ln1_bias": const((d,), 0.0),
        "q_w": nrm((d, d), d**-0.5), "q_b": const((d,), 0.0),
        "k_w": nrm((d, d), d**-0.5),
        "v_w": nrm((d, d), d**-0.5), "v_b": const((d,), 0.0),
        "o_w": nrm((d, d), d**-0.5), "o_b": const((d,), 0.0),
        "ln2_scale": const((d,), 1.0), "ln2_bias": const((d,), 0.0),
        "fc1_w": nrm((d, ff), d**-0.5), "fc1_b": const((ff,), 0.0),
        "fc2_w": nrm((ff, d), ff**-0.5), "fc2_b": const((d,), 0.0),
    } for _ in range(cfg.num_layers)]
    return {
        "conv1_w": nrm((d, cfg.num_mel_bins, 3), 0.02),  # [O, I, K]
        "conv1_b": const((d,), 0.0),
        "conv2_w": nrm((d, d, 3), 0.02),
        "conv2_b": const((d,), 0.0),
        "pos_embed": torch.as_tensor(
            sinusoidal_positions(cfg.max_source_positions, d)).to(device, dtype),
        "final_ln_scale": const((d,), 1.0),
        "final_ln_bias": const((d,), 0.0),
        "layers": layers,
    }


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: int) -> torch.Tensor:
    """x [B,T,C_in], w [O,I,K] (HF conv layout), padding 1 -> [B,T',O]."""
    out = F.conv1d(x.transpose(1, 2), w, stride=stride, padding=1)
    return out.transpose(1, 2) + b


def _encoder_layer(x, lp, num_heads, use_flash=False):
    if is_quantized(lp["q_w"]):
        # int8 tower: K5 (k_proj has no bias: ln_qkv adds zeros)
        q, k, v = ftl.ln_qkv(x, lp, eps=1e-5)
        attn = mha(q, k, v, num_heads, use_flash=use_flash)
        x = ftl.o_residual(attn, x, lp)
        return ftl.ln_ffn(x, lp, eps=1e-5, hidden_act="gelu")
    res = x
    h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps=1e-5)
    q = dense(h, lp["q_w"], lp["q_b"])
    k = dense(h, lp["k_w"])
    v = dense(h, lp["v_w"], lp["v_b"])
    h = dense(mha(q, k, v, num_heads, use_flash=use_flash), lp["o_w"], lp["o_b"])
    x = res + h
    res = x
    h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps=1e-5)
    h = dense(gelu_exact(dense(h, lp["fc1_w"], lp["fc1_b"])),
              lp["fc2_w"], lp["fc2_b"])
    return res + h


def forward(params: Params, mel: torch.Tensor, cfg: AudioConfig,
            use_flash: bool = False) -> torch.Tensor:
    """mel [B, n_mels, 3000] -> [B, 1500, d]."""
    x = mel.transpose(1, 2).to(params["conv1_w"].dtype)  # [B, T, n_mels]
    x = gelu_exact(_conv1d(x, params["conv1_w"], params["conv1_b"], 1))
    x = gelu_exact(_conv1d(x, params["conv2_w"], params["conv2_b"], 2))
    x = x + params["pos_embed"][: x.shape[1]].to(x.dtype)
    for lp in params["layers"]:
        x = _encoder_layer(x, lp, cfg.num_heads, use_flash)
    return layer_norm(x, params["final_ln_scale"], params["final_ln_bias"],
                      eps=1e-5)
