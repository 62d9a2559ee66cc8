"""K4: flash attention backward (csrc/flash_attention_bwd.cu).

Replaces the Pallas backward of `vidi_tpu.ops.pallas.flash_attention`
(`_bwd_rule`: `_dq_kernel` and `_dkv_kernel`). It is the backward of K1's
autograd Function (`ops/cuda/flash_attention.py`). Layouts as in K1: q / dO
[B,T,Hq,D], k/v [B,S,Hk,D], lse [B,Hq,T] fp32; returns (dq, dk, dv) in the
input dtype. The masks follow the forward: kv_mask, causal and window by
absolute index, segment ids; rows with no visible key (sentinel lse) give
no gradient.

di = sum(out * dO) over D is one torch reduction in the wrapper, as JAX
computes it outside Pallas. The kernel reads q / k / v through strides and
dO contiguous: the wrapper copies a non-contiguous dO (the gradients the
model hands it are contiguous, so that is a no-op there).

On a CPU tensor the wrapper runs `flash_attention_bwd_plain`; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from vidi_tpu_torch.ops.cuda import _lib
from vidi_tpu_torch.ops.cuda.flash_attention import (_kv_split, check_qkv,
                                                     int32_rows, visible_mask)

launches = 0  # kernel launches since the last reset (chip_smoke reads this)


def flash_attention_bwd(q, k, v, kv_mask, out, lse, do, sm_scale: float,
                        causal: bool = False, window: Optional[int] = None,
                        softcap: Optional[float] = None, *, q_segs=None,
                        kv_segs=None):
    """-> (dq [B,T,Hq,D], dk [B,S,Hk,D], dv [B,S,Hk,D]) of K1's `out`
    given its upstream gradient `do`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, kv_mask, out, lse, do, sm_scale,
                                         causal, window, softcap, q_segs=q_segs,
                                         kv_segs=kv_segs)
    return _launch(q, k, v, kv_mask, out, lse, do, sm_scale, causal, window,
                   softcap, q_segs, kv_segs)


def flash_attention_bwd_plain(q, k, v, kv_mask, out, lse, do, sm_scale: float,
                              causal: bool = False, window: Optional[int] = None,
                              softcap: Optional[float] = None, *, q_segs=None,
                              kv_segs=None):
    """Plain PyTorch version: the fp32 formulas of `_bwd_rule` over the
    whole [T,S] score block (p recomputed from lse and not rounded)."""
    b, t, hq, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = hq // hk
    qg = q.reshape(b, t, hk, g, d).float()
    kf, vf = k.float(), v.float()
    raw = torch.einsum("bthgd,bshd->bhgts", qg, kf) * sm_scale
    if softcap is not None:
        th = torch.tanh(raw / softcap)
        z = th * softcap
    else:
        z = raw
    mask = visible_mask(b, t, s, kv_mask, causal, window, q_segs, kv_segs,
                        q.device)[:, None, None]
    p = torch.where(mask, torch.exp(z - lse.float().reshape(b, hk, g, t, 1)), 0.0)
    dog = do.reshape(b, t, hk, g, d).float()
    di = (out.float() * do.float()).sum(-1).reshape(b, t, hk, g)
    dv = torch.einsum("bhgts,bthgd->bshd", p, dog)
    dp = torch.einsum("bthgd,bshd->bhgts", dog, vf)
    dz = p * (dp - di.permute(0, 2, 3, 1)[..., None])
    if softcap is not None:
        dz = dz * (1.0 - th * th)
    dz = torch.where(mask, dz, 0.0)
    dq = torch.einsum("bhgts,bshd->bthgd", dz, kf) * sm_scale
    dk = torch.einsum("bhgts,bthgd->bshd", dz, qg) * sm_scale
    return (dq.reshape(b, t, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _launch(q, k, v, kv_mask, out, lse, do, sm_scale, causal, window, softcap,
            q_segs, kv_segs):
    global launches
    check_qkv(q, k, v, window, "flash_attention_bwd")
    b, t, hq, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    do = do.contiguous()
    for name, x in (("out", out), ("do", do)):
        _lib.check_operand(x, f"flash_attention_bwd {name}", 4, q.dtype)
        if x.shape != q.shape:
            raise ValueError(f"flash_attention_bwd: {name} {tuple(x.shape)} "
                             f"differs from q {tuple(q.shape)}")
    if lse.shape != (b, hq, t) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be fp32 {(b, hq, t)}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    lse = lse.contiguous()
    di = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()  # [B,Hq,T]
    mask = int32_rows(kv_mask, (b, s), q.device, "flash_attention_bwd")
    qs = int32_rows(q_segs, (b, t), q.device, "flash_attention_bwd")
    ks = int32_rows(kv_segs, (b, s), q.device, "flash_attention_bwd")
    dq = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, hk, d), dtype=v.dtype, device=q.device)
    n_split, kv_split = _kv_split(b, t, s, hq, q.device)
    dq_part = (torch.empty((n_split, b, t, hq, d), dtype=torch.float32,
                           device=q.device) if n_split > 1 else None)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = _lib.library()
    with torch.cuda.device(q.device):
        err = lib.vidi_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), ptr(mask), ptr(qs), ptr(ks),
            dq.data_ptr(), ptr(dq_part), dk.data_ptr(), dv.data_ptr(),
            b, t, s, hq, hk, d, int(q.dtype == torch.bfloat16),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(sm_scale), int(causal), int(window or 0), float(softcap or 0.0),
            n_split, kv_split, torch.cuda.current_stream(q.device).cuda_stream)
    _lib.check(err, "flash_attention_bwd")
    launches += 1
    return dq, dk, dv
