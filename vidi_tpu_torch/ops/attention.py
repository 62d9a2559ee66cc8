"""Reference attention ops for the Dattn decoder (port of
vidi_tpu/ops/attention.py) -- the numerics of record that the CUDA kernels
are held against.

- `self_attention`: causal, optional sliding window + logit softcap (the
  Gemma2 T2T path), masks by positions.
- `cross_attention`: non-causal, KV-masked (the T2V / T2A path).
- `quantized_cache_cross_attention`: the same over per-token int8 caches.

GQA groups query heads over KV heads without repeating K/V. Softmax math
is fp32; probabilities are cast to the value dtype before P @ V, which
accumulates in fp32 (as `preferred_element_type=float32` does in JAX).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38  # XLA's mask value; finite, so no inf - inf


def _soft_cap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return torch.tanh(logits / cap) * cap


def _grouped_logits(q: torch.Tensor, k: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q [B,T,Hq,D] x k [B,S,Hk,D] -> logits [B,Hk,G,T,S] (fp32)."""
    b, t, hq, d = q.shape
    hk = k.shape[2]
    if hq % hk:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hk}")
    qg = q.reshape(b, t, hk, hq // hk, d)
    return torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float()) * scale


def _attend(logits: torch.Tensor, v: torch.Tensor, out_dtype) -> torch.Tensor:
    """softmax(logits) [B,Hk,G,T,S] @ v [B,S,Hk,D] -> [B,T,Hq,D]."""
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype).float(), v.float())
    b, t, hk, g, d = out.shape
    return out.reshape(b, t, hk * g, d).to(out_dtype)


def self_attention(q, k, v, *, q_positions, kv_positions, kv_valid,
                   scale: float, sliding_window: Optional[int] = None,
                   softcap: Optional[float] = None, q_segment_ids=None,
                   kv_segment_ids=None) -> torch.Tensor:
    """Causal (optionally sliding-window) self attention over a KV set.
    q [B,T,Hq,D]; k/v [B,S,Hk,D]; positions [B,T] / [B,S]; kv_valid [B,S]
    bool or None; segment ids [B,T] / [B,S] for sample packing."""
    logits = _soft_cap(_grouped_logits(q, k, scale), softcap)
    mask = kv_positions[:, None, :] <= q_positions[:, :, None]  # [B,T,S]
    if sliding_window is not None:
        mask = mask & ((q_positions[:, :, None] - kv_positions[:, None, :])
                       < sliding_window)
    if q_segment_ids is not None:
        mask = mask & (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    return _attend(logits, v, q.dtype)


def cross_attention(q, k, v, *, kv_valid, scale: float,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Non-causal text -> modality cross attention with a KV validity mask."""
    logits = _soft_cap(_grouped_logits(q, k, scale), softcap)
    if kv_valid is not None:
        logits = logits.masked_fill(~kv_valid[:, None, None, None, :], NEG_INF)
    return _attend(logits, v, q.dtype)


def quantized_cache_cross_attention(q, kq, vq, *, kv_valid, scale: float,
                                    softcap: Optional[float] = None,
                                    return_lse: bool = False):
    """Cross attention over per-token int8 KV caches: q [B,T,Hq,D]; kq / vq
    {qi8 [B,Hk,S,D] int8, scale [B,Hk,S,1] fp32} (decode-native); kv_valid
    [B,S] bool. The k scale folds into the logits (q . (k s) == (q . k) s)
    and the v scale into the probabilities, so the int8 values enter the
    products as they are (int8 -> float is exact). Eager PyTorch converts
    the int8 cache to fp32 on every call, where XLA fused the convert into
    the dot's operand read. With `return_lse`, (out, lse [B,T,Hq] fp32):
    the rows' log-sum-exp over the visible keys, -inf for a row with none
    (a shard of a seq-cut cache then weighs nothing in the merge); out is
    the same bits either way."""
    ki, ks = kq["qi8"], kq["scale"]
    vi, vs = vq["qi8"], vq["scale"]
    b, t, hq, d = q.shape
    hk = ki.shape[1]
    qg = q.reshape(b, t, hk, hq // hk, d)
    logits = torch.einsum("bthgd,bhsd->bhgts", qg.float(), ki.float())
    logits = _soft_cap(logits * (ks[..., 0][:, :, None, None, :] * scale), softcap)
    if kv_valid is not None:
        logits = logits.masked_fill(~kv_valid[:, None, None, None, :], NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    probs = torch.exp(logits - m)
    l = probs.sum(dim=-1, keepdim=True)
    probs = probs / l
    probs = probs * vs[..., 0][:, :, None, None, :]
    out = torch.einsum("bhgts,bhsd->bthgd", probs.to(q.dtype).float(), vi.float())
    out = out.reshape(b, t, hq, d).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(l))[..., 0]  # [B,Hk,G,T]
    if kv_valid is not None:
        lse = lse.masked_fill(~kv_valid.any(dim=-1)[:, None, None, None], float("-inf"))
    return out, lse.permute(0, 3, 1, 2).reshape(b, t, hq)
