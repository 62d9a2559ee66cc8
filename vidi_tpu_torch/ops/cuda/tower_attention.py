"""K2: encoder-tower attention (csrc/tower_attention.cu).

Replaces the Pallas kernels of `vidi_tpu.ops.pallas.tower_attention`
(`tower_attention` and its packed / fullwidth / generic layouts): maskless,
non-causal multi-head attention, q [B,T,H,D] and k/v [B,S,H,D] -> [B,T,H,D].
One layout serves every geometry: the kernel reads the [B,T,H*D] projection
outputs in place through strides. Reached from `ops.basic.mha(use_flash=
True)` for SigLIP (T=729, D=72), CLIP (T=257, D=64) and Whisper (T=1500,
D=64), and any other head dim up to 256: the kernels are compiled for K1's
widths (`flash_attention.WIDTHS`) and run a head dim at the least width
that holds it; a D that is no multiple of 8 is copied once into
zero-padded operands (counted in `pad_copies`).

`tower_attention` is a `torch.autograd.Function` whose backward recomputes
the attention with `tower_attention_plain` under autograd, as the JAX
custom_vjp's `_ta_bwd` does: there is no backward kernel to port. On a CPU
tensor the forward runs `tower_attention_plain`; on a CUDA tensor it
launches the kernel or raises: bf16 the Hopper kernel of
csrc/flash_forward_sm90.cuh (16-byte aligned rows, `tma_strides`), fp32
the SIMT template (`route`).
"""
from __future__ import annotations

import torch

from vidi_tpu_torch.ops.cuda import _lib
from vidi_tpu_torch.ops.cuda.flash_attention import (HEAD_ALIGN, head_width, padded_heads,
                                                     tma_strides)

launches = 0  # kernel launches since the last reset (chip_smoke reads this)
pad_copies = 0  # operands copied into a zero-padded head dim (D % 8 != 0)


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


def route(dtype: torch.dtype) -> str:
    """The C entry K2 launches for operands of `dtype`: bf16 -> the sm90
    kernel, fp32 -> the SIMT template. Nothing else is taken."""
    if dtype == torch.bfloat16:
        return "vidi_tower_attention_sm90"
    if dtype == torch.float32:
        return "vidi_tower_attention"
    raise TypeError(f"tower_attention: no kernel for {dtype}")


def _launch(q, k, v, scale):
    global launches, pad_copies
    d = q.shape[-1]
    if d % HEAD_ALIGN:  # rows TMA cannot address: one zero-padded copy each
        q, k, v = padded_heads("tower_attention", q, k, v)
        pad_copies += 3
        return _launch(q, k, v, scale)[..., :d]
    for name, x in (("q", q), ("k", k), ("v", v)):
        _lib.check_operand(x, f"tower_attention {name}", 4, q.dtype)
    b, t, h, d = q.shape
    s = k.shape[1]
    if k.shape != (b, s, h, d) or v.shape != k.shape:
        raise ValueError(f"tower_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    w = head_width(d, name="tower_attention")
    entry = route(q.dtype)
    strides = [x.stride()[:3] for x in (q, k, v)]
    if q.dtype == torch.bfloat16:
        strides = [tma_strides(f"tower_attention {name}", x.shape, x.stride(),
                               x.data_ptr(), x.element_size())[:3]
                   for name, x in (("q", q), ("k", k), ("v", v))]
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lib = _lib.library()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, s, h, w, d, *strides[0], *strides[1], *strides[2],
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _lib.check(err, "tower_attention")
    launches += 1
    return out
