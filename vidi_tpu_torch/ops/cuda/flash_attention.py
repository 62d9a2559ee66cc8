"""K1: flash attention forward (csrc/flash_attention.cu).

Replaces the Pallas kernel `vidi_tpu.ops.pallas.flash_attention.
flash_attention` (forward: `_flash_forward` / `_fwd_kernel`) for the Dattn
T2T prefill (causal, Gemma2 sliding window, softcap, kv_mask) and the
text->stream cross attention (non-causal, kv_mask). Layout as in JAX:
q [B,T,Hq,D], k/v [B,S,Hk,D] (any strides with a contiguous last dim, so a
transposed cache view is read in place), kv_mask [B,S]. Returns
(out [B,T,Hq,D], lse [B,Hq,T] fp32).

Semantics of the TPU kernel, which differ from `ops.attention`: causal and
window compare absolute indices (row t sees key s iff s <= t and t - s <
window), which equals the position rule for right-padded contiguous
prompts; rows with no visible key give zeros and lse = 0.7 * f32max.

`flash_attention` is a `torch.autograd.Function` (the counterpart of the
JAX `custom_vjp`): the forward saves q, k, v, the masks, the output and lse,
and the backward is K4 (`flash_attention_bwd`). On a CPU tensor the
Function runs `flash_attention_plain` forward and `flash_attention_bwd_plain`
backward; on a CUDA tensor it launches the kernels or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from vidi_tpu_torch.ops.cuda import _lib

EMPTY_ROW_LSE = 0.7 * torch.finfo(torch.float32).max
Q_TILE, KV_TILE = 16, 64  # the kernel's block tile (csrc/flash_attention.cu)
MIN_SPLIT_KEYS = 512      # fewest keys worth one block of a KV split
HEAD_DIMS = (128, 256)    # the instantiations in csrc/flash_attention.cu
launches = 0  # kernel launches since the last reset (chip_smoke reads this)


def flash_attention(q, k, v, kv_mask, sm_scale: float, causal: bool = False,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, *,
                    q_segs=None, kv_segs=None):
    """-> (out [B,T,Hq,D], lse [B,Hq,T] fp32). `q_segs`/`kv_segs` ([B,T] /
    [B,S] int, 0 = pad) restrict attention to equal segment ids (sample
    packing); both or neither."""
    if (q_segs is None) != (kv_segs is None):
        raise ValueError("pass both q_segs and kv_segs, or neither")
    return _FlashAttention.apply(q, k, v, kv_mask, q_segs, kv_segs, sm_scale,
                                 causal, window, softcap)


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K4 backward; lse carries no gradient (as in JAX, where
    only `out` leaves the custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, q_segs, kv_segs, sm_scale, causal,
                window, softcap):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, kv_mask, sm_scale, causal,
                                             window, softcap, q_segs=q_segs,
                                             kv_segs=kv_segs)
        else:
            out, lse = _launch(q, k, v, kv_mask, sm_scale, causal, window,
                               softcap, q_segs, kv_segs)
        ctx.save_for_backward(q, k, v, kv_mask, q_segs, kv_segs, out, lse)
        ctx.args = (sm_scale, causal, window, softcap)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        from vidi_tpu_torch.ops.cuda.flash_attention_bwd import flash_attention_bwd
        q, k, v, kv_mask, q_segs, kv_segs, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, out, lse, dout,
                                         *ctx.args, q_segs=q_segs, kv_segs=kv_segs)
        return dq, dk, dv, None, None, None, None, None, None, None


def visible_mask(b: int, t: int, s: int, kv_mask, causal: bool,
                 window: Optional[int], q_segs, kv_segs, device) -> torch.Tensor:
    """[B,T,S] bool: which keys each row sees under the kernels' rules
    (causal and window by absolute index)."""
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(s, device=device)[None, :]
    mask = torch.ones((b, t, s), dtype=torch.bool, device=device)
    if kv_mask is not None:
        mask = mask & (kv_mask != 0)[:, None, :]
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (rows - cols < window)
    if q_segs is not None:
        mask = mask & (q_segs[:, :, None] == kv_segs[:, None, :])
    return mask


def flash_attention_plain(q, k, v, kv_mask, sm_scale: float,
                          causal: bool = False, window: Optional[int] = None,
                          softcap: Optional[float] = None, *,
                          q_segs=None, kv_segs=None):
    """Plain PyTorch version with the kernel's semantics: fp32 scores,
    unnormalised probabilities cast to v's dtype for P @ V (as the TPU
    kernel does), zeros + sentinel lse for rows with no visible key."""
    b, t, hq, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = hq // hk
    qg = q.reshape(b, t, hk, g, d).float()
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * sm_scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    mask = visible_mask(b, t, s, kv_mask, causal, window, q_segs, kv_segs,
                        q.device)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype).float(), v.float())
    l_t = l[..., 0].permute(0, 3, 1, 2)[..., None]  # [B,T,Hk,G,1]
    out = torch.where(l_t == 0, torch.zeros_like(acc), acc / l_t)
    lse = torch.where(l[..., 0] == 0, torch.full_like(l[..., 0], EMPTY_ROW_LSE),
                      m[..., 0] + torch.log(l[..., 0]))
    return (out.reshape(b, t, hq, d).to(q.dtype),
            lse.reshape(b, hq, t))


def _kv_split(b, t, s, hq, device):
    """(n_split, keys per split): split S across blocks when the query tiles
    alone would give fewer than four blocks per SM (the cross attention of
    64 text rows against 23,520 video keys gives 64 blocks on 132 SMs)."""
    blocks = b * hq * -(-t // Q_TILE)
    target = 4 * torch.cuda.get_device_properties(device).multi_processor_count
    n_split = max(1, min(-(-target // blocks), s // MIN_SPLIT_KEYS))
    kv_split = -(-s // n_split)
    kv_split = -(-kv_split // KV_TILE) * KV_TILE
    return -(-s // kv_split), kv_split


def int32_rows(x, shape, device, name: str):
    """A [B,T] / [B,S] mask or segment-id tensor as the contiguous int32
    rows the kernels read (None stays None)."""
    if x is None:
        return None
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected {shape}, got {tuple(x.shape)}")
    return x.to(device=device, dtype=torch.int32).contiguous()


def check_qkv(q, k, v, window, name: str):
    """Raise unless q/k/v and the window are what K1 and K4 take."""
    for label, x in (("q", q), ("k", k), ("v", v)):
        _lib.check_operand(x, f"{name} {label}", 4, q.dtype)
    b, t, hq, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    if k.shape != (b, s, hk, d) or v.shape != k.shape or hq % hk:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernel is built for head dims "
                         f"{HEAD_DIMS}, got {d}")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive, got {window}")


def _launch(q, k, v, kv_mask, sm_scale, causal, window, softcap, q_segs,
            kv_segs):
    global launches
    check_qkv(q, k, v, window, "flash_attention")
    b, t, hq, d = q.shape
    s, hk = k.shape[1], k.shape[2]

    mask = int32_rows(kv_mask, (b, s), q.device, "flash_attention")
    qs = int32_rows(q_segs, (b, t), q.device, "flash_attention")
    ks = int32_rows(kv_segs, (b, s), q.device, "flash_attention")
    out = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    n_split, kv_split = _kv_split(b, t, s, hq, q.device)
    part = [None, None, None]
    if n_split > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        part = [torch.empty((b, hq, t, n_split), **f32),
                torch.empty((b, hq, t, n_split), **f32),
                torch.empty((b, hq, t, n_split, d), **f32)]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = _lib.library()
    with torch.cuda.device(q.device):
        err = lib.vidi_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(mask), ptr(qs), ptr(ks),
            out.data_ptr(), lse.data_ptr(), b, t, s, hq, hk, d,
            int(q.dtype == torch.bfloat16),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(sm_scale), int(causal), int(window or 0), float(softcap or 0.0),
            n_split, kv_split, *map(ptr, part),
            torch.cuda.current_stream(q.device).cuda_stream)
    _lib.check(err, "flash_attention")
    launches += 1
    return out, lse
