"""K3: decode attention, one query token against a KV cache
(csrc/decode_attention.cu).

Replaces the Pallas kernel `vidi_tpu.ops.pallas.decode_attention.
decode_attention`: q [B,Hq,D] against the cache-native k/v [B,Hk,S,D], GQA
group rows sharing a KV head, kv_mask [B,S], softcap, and the Gemma2
sliding window through `q_pos` [B] (key s visible iff q_pos - s < window;
causality rides on kv_mask). Global layers pass `window=None`: the JAX
caller's `-(1 << 30)` q_pos sentinel existed only because its layer scan
made the sliding flag a traced value. Rows with no visible key give zeros.

The kernel splits S into chunks of `CHUNK` keys across blocks and merges
the partial softmax states in a second pass; the wrapper allocates the
partials. On a CPU tensor the wrapper runs `decode_attention_plain`; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from vidi_tpu_torch.ops.cuda import _lib

CHUNK = 256  # keys per block in the split pass
HEAD_DIMS, GROUP = (128, 256), 2  # the instantiations in csrc/decode_attention.cu
launches = 0  # kernel launches since the last reset (chip_smoke reads this)


def decode_attention(q, k, v, kv_mask, sm_scale: float,
                     softcap: Optional[float] = None,
                     window: Optional[int] = None, q_pos=None):
    """q [B,Hq,D], k/v [B,Hk,S,D], kv_mask [B,S] or None, q_pos [B] (needed
    with `window`) -> [B,Hq,D]."""
    if window is not None and q_pos is None:
        raise ValueError("decode_attention: window needs q_pos")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_mask, sm_scale, softcap,
                                      window, q_pos)
    return _launch(q, k, v, kv_mask, sm_scale, softcap, window, q_pos)


def decode_attention_plain(q, k, v, kv_mask, sm_scale: float,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None, q_pos=None):
    """Plain PyTorch version with the kernel's semantics: fp32 scores,
    unnormalised probabilities cast to v's dtype for P @ V, zeros for rows
    with no visible key."""
    b, hq, d = q.shape
    hk, s = k.shape[1], k.shape[2]
    g = hq // hk
    qg = q.reshape(b, hk, g, d).float()
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * sm_scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    valid = torch.ones((b, s), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        valid = valid & (kv_mask != 0)
    if window is not None:
        cols = torch.arange(s, device=q.device)[None, :]
        valid = valid & (q_pos.to(q.device)[:, None] - cols < window)
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    out = torch.where(l == 0, torch.zeros_like(acc), acc / l)
    return out.reshape(b, hq, d).to(q.dtype)


def _launch(q, k, v, kv_mask, sm_scale, softcap, window, q_pos):
    global launches
    _lib.check_operand(q, "decode_attention q", 3)
    _lib.check_operand(k, "decode_attention k", 4, q.dtype)
    _lib.check_operand(v, "decode_attention v", 4, q.dtype)
    b, hq, d = q.shape
    hk, s = k.shape[1], k.shape[2]
    if k.shape != (b, hk, s, d) or v.shape != k.shape or hq % hk:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d not in HEAD_DIMS or hq // hk != GROUP:
        raise ValueError(f"decode_attention: the kernel is built for head dims "
                         f"{HEAD_DIMS} and {GROUP} query heads per KV head, got "
                         f"{d} and {hq // hk}")
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window must be positive, got {window}")
    mask = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, s):
            raise ValueError(f"decode_attention: kv_mask {tuple(kv_mask.shape)}")
        mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    qpos = None
    if window is not None:
        qpos = q_pos.to(device=q.device, dtype=torch.int32).contiguous()
    n_split = -(-s // CHUNK)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((b, hq, n_split), **f32)
    part_l = torch.empty((b, hq, n_split), **f32)
    part_acc = torch.empty((b, hq, n_split, d), **f32)
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = _lib.library()
    with torch.cuda.device(q.device):
        err = lib.vidi_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(mask), ptr(qpos),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            out.data_ptr(), b, hq, hk, s, d, int(q.dtype == torch.bfloat16),
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(sm_scale), float(softcap or 0.0), int(window or 0),
            n_split, CHUNK, torch.cuda.current_stream(q.device).cuda_stream)
    _lib.check(err, "decode_attention")
    launches += 1
    return out
