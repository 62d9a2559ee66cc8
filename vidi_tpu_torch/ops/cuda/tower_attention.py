"""K2: encoder-tower attention (csrc/tower_attention.cu).

Replaces the Pallas kernels of `vidi_tpu.ops.pallas.tower_attention`
(`tower_attention` and its packed / fullwidth / generic layouts): maskless,
non-causal multi-head attention, q [B,T,H,D] and k/v [B,S,H,D] -> [B,T,H,D].
One layout serves every geometry: the kernel reads the [B,T,H*D] projection
outputs in place through strides. Reached from `ops.basic.mha(use_flash=
True)` for SigLIP (T=729, D=72) and Whisper (T=1500, D=64).

`tower_attention` is a `torch.autograd.Function` whose backward recomputes
the attention with `tower_attention_plain` under autograd, as the JAX
custom_vjp's `_ta_bwd` does: there is no backward kernel to port. On a CPU
tensor the forward runs `tower_attention_plain`; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from vidi_tpu_torch.ops.cuda import _lib

HEAD_DIMS = (64, 72)  # Whisper, SigLIP: the instantiations in csrc/tower_attention.cu
launches = 0  # kernel launches since the last reset (chip_smoke reads this)


def tower_attention(q, k, v, scale: float):
    """q [B,T,H,D], k/v [B,S,H,D] -> softmax(q k^T * scale) v, [B,T,H,D]."""
    return _TowerAttention.apply(q, k, v, scale)


class _TowerAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if q.device.type == "cpu":
            return tower_attention_plain(q, k, v, scale)
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
            out = tower_attention_plain(q, k, v, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
        return dq, dk, dv, None


def tower_attention_plain(q, k, v, scale: float):
    """Plain PyTorch version (the numerics of `ops.basic.mha`): fp32 logits
    and softmax, probabilities cast to v's dtype, fp32 P @ V."""
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs.float(), v.float())
    return out.to(q.dtype)


def _launch(q, k, v, scale):
    global launches
    for name, x in (("q", q), ("k", k), ("v", v)):
        _lib.check_operand(x, f"tower_attention {name}", 4, q.dtype)
    b, t, h, d = q.shape
    s = k.shape[1]
    if k.shape != (b, s, h, d) or v.shape != k.shape:
        raise ValueError(f"tower_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"tower_attention: the kernel is built for head dims "
                         f"{HEAD_DIMS}, got {d}")
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lib = _lib.library()
    with torch.cuda.device(q.device):
        err = lib.vidi_tower_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, s, h, d, int(q.dtype == torch.bfloat16),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _lib.check(err, "tower_attention")
    launches += 1
    return out
