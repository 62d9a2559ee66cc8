"""K5: the int8 encoder-tower layer (csrc/fused_tower_layer.cu on the shared
int8 core of csrc/int8_gemm.cuh).

Replaces the Pallas kernels of `vidi_tpu.ops.pallas.fused_tower_layer`,
three pieces per SigLIP / Whisper layer whose matmul weights are {qi8,
scale} dicts (`infer.quantize.quantize_tower_layer`):

  ln_qkv      x -> LN1 (fp32) -> cast -> per-row int8 once -> q, k, v
  o_residual  residual + (int8(attn) @ o_w + o_b)
  ln_ffn      x + fc2(int8(act(fc1(int8(LN2(x))) + b1)) + b2)

Each product is rescaled (x sx x sw), gets its fp32 bias and is cast ONCE
(`_qdot` of the JAX module: no extra rounding per projection); the
activation runs in the activation dtype and the residual add too. These
are the Pallas kernels' numerics, and in fp32 also the jnp path's. Exact
gelu is `erf`'s. The plain versions repeat them in PyTorch with exact
float64 int8 products. Each wrapper takes its plain version for a CPU
tensor and launches the kernel, or raises, for a CUDA tensor; `launches`
counts the calls that launched, per function. No environment switch and
no lane rule: on the card every int8 tower layer runs here. The kernels
read each weight through its K-major copy (`quant_matmul.kmajor`).
"""
from __future__ import annotations

import torch

from vidi_tpu_torch.infer.quantize import QUANT_KEY, quantize_act
from vidi_tpu_torch.ops.basic import layer_norm, tower_act
from vidi_tpu_torch.ops.cuda import _lib
from vidi_tpu_torch.ops.cuda.quant_matmul import (ACTIVATIONS, check_int8_weight,
                                                  int8_dot, kmajor, rows, scratch)

launches = {"ln_qkv": 0, "o_residual": 0, "ln_ffn": 0}


def _qdot_plain(hq, sx, w, bias, dtype):
    """int8 product + rescale + fp32 bias, then one cast."""
    y = int8_dot(hq, w[QUANT_KEY]) * sx * w["scale"].reshape(-1).float()
    return (y + bias.float()).to(dtype)


def _bias(lp, key, d, device):
    """The layer's bias as fp32, zeros where it has none (Whisper's k)."""
    b = lp.get(key)
    return torch.zeros(d, dtype=torch.float32, device=device) if b is None else b.float()


def ln_qkv(x, lp, eps: float):
    """x [..., T, d] -> (q, k, v): LN1 + one shared quantize + three int8 dots."""
    if x.device.type == "cpu":
        return ln_qkv_plain(x, lp, eps)
    return _launch_ln_qkv(x, lp, eps)


def ln_qkv_plain(x, lp, eps: float):
    d = x.shape[-1]
    hq, sx = quantize_act(layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps))
    return tuple(_qdot_plain(hq, sx, lp[w], _bias(lp, b, d, x.device), x.dtype)
                 for w, b in (("q_w", "q_b"), ("k_w", "k_b"), ("v_w", "v_b")))


def o_residual(attn, residual, lp):
    """residual + attn @ o_w (int8, per-row quantized attn) + o_b."""
    if attn.device.type == "cpu":
        return o_residual_plain(attn, residual, lp)
    return _launch_o_residual(attn, residual, lp)


def o_residual_plain(attn, residual, lp):
    aq, sx = quantize_act(attn)
    return residual + _qdot_plain(aq, sx, lp["o_w"], lp["o_b"], attn.dtype)


def ln_ffn(x, lp, eps: float, hidden_act: str):
    """x + FFN(LN2(x)), both products int8, the hidden requantized per row."""
    if x.device.type == "cpu":
        return ln_ffn_plain(x, lp, eps, hidden_act)
    return _launch_ln_ffn(x, lp, eps, hidden_act)


def ln_ffn_plain(x, lp, eps: float, hidden_act: str):
    hq, sx = quantize_act(layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps))
    a = tower_act(_qdot_plain(hq, sx, lp["fc1_w"], lp["fc1_b"], x.dtype), hidden_act)
    aq, sx2 = quantize_act(a)
    return x + _qdot_plain(aq, sx2, lp["fc2_w"], lp["fc2_b"], x.dtype)


def _f32(t):
    return t.float().contiguous()


def _weight(lp, key, k):
    """-> (the K-major copy [N, k] of lp[key]'s int8 matrix, its scales, N)."""
    w = lp[key]
    n = check_int8_weight(w[QUANT_KEY], w["scale"], k, f"fused_tower_layer {key}")
    return kmajor(w[QUANT_KEY]), w["scale"], n


def _launch_ln_qkv(x, lp, eps):
    x2, d = rows(x, "ln_qkv x")
    m = x2.shape[0]
    ws = [_weight(lp, key, d) for key in ("q_w", "k_w", "v_w")]
    if any(n != d for _, _, n in ws):
        raise ValueError("ln_qkv: q/k/v weights must be [d, d]")
    biases = [_bias(lp, key, d, x.device).contiguous() for key in ("q_b", "k_b", "v_b")]
    ln_s, ln_b = _f32(lp["ln1_scale"]), _f32(lp["ln1_bias"])
    xq, sx = scratch(m, d, x.device)
    outs = [torch.empty((m, d), dtype=x.dtype, device=x.device) for _ in range(3)]
    _lib.call("vidi_ln_qkv", x.device, x2.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
              xq.data_ptr(), sx.data_ptr(), *(w.data_ptr() for w, _, _ in ws),
              *(s.data_ptr() for _, s, _ in ws), *(b.data_ptr() for b in biases),
              *(o.data_ptr() for o in outs), m, d, x.dtype == torch.bfloat16, float(eps))
    launches["ln_qkv"] += 1
    return tuple(o.reshape(x.shape) for o in outs)


def _launch_o_residual(attn, residual, lp):
    a2, d = rows(attn, "o_residual attn")
    if residual.shape != attn.shape or residual.dtype != attn.dtype:
        raise ValueError(f"o_residual: residual {tuple(residual.shape)} {residual.dtype} "
                         f"vs attn {tuple(attn.shape)} {attn.dtype}")
    res2 = residual.reshape(-1, d).contiguous()
    m = a2.shape[0]
    w, s, n = _weight(lp, "o_w", d)
    if n != d:
        raise ValueError("o_residual: o_w must be [d, d]")
    bias = _f32(lp["o_b"])
    xq, sx = scratch(m, d, attn.device)
    out = torch.empty((m, d), dtype=attn.dtype, device=attn.device)
    _lib.call("vidi_o_residual", attn.device, a2.data_ptr(), res2.data_ptr(), xq.data_ptr(),
              sx.data_ptr(), w.data_ptr(), s.data_ptr(), bias.data_ptr(), out.data_ptr(), m, d,
              attn.dtype == torch.bfloat16)
    launches["o_residual"] += 1
    return out.reshape(attn.shape)


def _launch_ln_ffn(x, lp, eps, hidden_act):
    x2, d = rows(x, "ln_ffn x")
    m = x2.shape[0]
    w1, s1, ff = _weight(lp, "fc1_w", d)
    w2, s2, n2 = _weight(lp, "fc2_w", ff)
    if n2 != d or ff % 16:
        raise ValueError(f"ln_ffn: fc1 [d, ff] / fc2 [ff, d] with ff % 16 == 0, got "
                         f"ff = {ff} and fc2's width {n2} for d = {d}")
    b1, b2 = _f32(lp["fc1_b"]), _f32(lp["fc2_b"])
    ln_s, ln_b = _f32(lp["ln2_scale"]), _f32(lp["ln2_bias"])
    xq, sx = scratch(m, d, x.device)
    hq, hsx = scratch(m, ff, x.device)
    hidden = torch.empty((m, ff), dtype=x.dtype, device=x.device)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    _lib.call("vidi_ln_ffn", x.device, x2.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
              xq.data_ptr(), sx.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
              hidden.data_ptr(), hq.data_ptr(), hsx.data_ptr(), w2.data_ptr(), s2.data_ptr(),
              b2.data_ptr(), out.data_ptr(), m, d, ff, ACTIVATIONS[hidden_act],
              x.dtype == torch.bfloat16, float(eps))
    launches["ln_ffn"] += 1
    return out.reshape(x.shape)
