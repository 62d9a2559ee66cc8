"""K4: flash attention backward (csrc/flash_attention_bwd.cu).

Replaces the Pallas backward of `vidi_tpu.ops.pallas.flash_attention`
(`_bwd_rule`: `_dq_kernel` and `_dkv_kernel`). It is the backward of K1's
autograd Function (`ops/cuda/flash_attention.py`). Layouts as in K1: q / dO
[B,T,Hq,D], k/v [B,S,Hk,D], lse [B,Hq,T] fp32; returns (dq, dk, dv) in the
input dtype. The masks follow the forward: kv_mask, causal and window by
absolute index, segment ids; rows with no visible key (sentinel lse) give
no gradient.

di = sum(out * dO) over D is one torch reduction in the wrapper, as JAX
computes it outside Pallas.

Two routes on the card, by dtype (`route`), as K1 has:
- bf16 takes the two Hopper kernels of csrc/flash_backward_sm90.cuh, a dq
  kernel (128 GQA-packed query rows a block, K / V streamed by TMA, S split
  by `sm90_bwd_plan` to fill one wave, the fp32 partials summed in a second
  pass) and a dk / dv kernel (64 keys a block, the group's query rows
  streamed by TMA). q k^T and dO v^T are exact products of the bf16
  operands with fp32 sums, as on the TPU; p and dz are rounded to bf16 as
  the operands of the three gradient products (the TPU forms those in
  fp32), as the sm90 forward rounds P. chip_smoke.py holds dq, dk and dv
  within 4 bf16 ulps of max|plain|. Every operand must be 16-byte aligned
  for TMA (`tma_operand_strides`), else the wrapper raises.
- fp32 takes the SIMT template: every product and sum fp32 and p not
  rounded, for the card-vs-CPU checks.
No route uses atomics: two runs give bit-equal gradients.

On a CPU tensor the wrapper runs `flash_attention_bwd_plain`; on a CUDA
tensor it launches the kernels or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from vidi_tpu_torch.ops.cuda import _lib
from vidi_tpu_torch.ops.cuda.flash_attention import (SM90_MIN_SPLIT_KEYS, SM90_ROWS, _kv_split,
                                                     check_qkv, int32_rows, mask_bytes,
                                                     sm90_blocks, sm90_group, tma_strides,
                                                     visible_mask)

launches = 0  # kernel launches since the last reset (chip_smoke reads this)
# the same launches by C entry (`route`): which route each call took
route_launches = {"vidi_flash_attention_bwd_sm90": 0, "vidi_flash_attention_bwd": 0}
# the sm90 kernels (csrc/flash_backward_sm90.cuh): keys per tile of the dq
# kernel by head dim; keys per block and packed query rows per streamed
# tile of the dk / dv kernel
SM90_BWD_DQ_KEYS = {128: 64, 256: 32}
SM90_BWD_KV_KEYS = 64
SM90_BWD_KV_ROWS = 64


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
    b, t = q.shape[:2]
    mask = visible_mask(b, t, k.shape[1], kv_mask, causal, window, q_segs, kv_segs,
                        q.device)
    di = (out.float() * do.float()).sum(-1).transpose(1, 2)  # [B,Hq,T]
    return backward_with_mask(q, k, v, do, lse, di, mask, sm_scale, softcap)


def backward_with_mask(q, k, v, do, lse, di, mask, sm_scale: float,
                       softcap: Optional[float] = None):
    """The plain formulas with the visibility given as a [B,T,S] bool mask
    and lse, di as [B,Hq,T]: the body of `flash_attention_bwd_plain`, which
    the chip checks also call with a mask or an lse / di that a faulty
    kernel would use."""
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
    mask = mask[:, None, None]
    p = torch.where(mask, torch.exp(z - lse.float().reshape(b, hk, g, t, 1)), 0.0)
    dog = do.reshape(b, t, hk, g, d).float()
    dv = torch.einsum("bhgts,bthgd->bshd", p, dog)
    dp = torch.einsum("bthgd,bshd->bhgts", dog, vf)
    dz = p * (dp - di.float().reshape(b, hk, g, t, 1))
    if softcap is not None:
        dz = dz * (1.0 - th * th)
    dz = torch.where(mask, dz, 0.0)
    dq = torch.einsum("bhgts,bshd->bthgd", dz, kf) * sm_scale
    dk = torch.einsum("bhgts,bthgd->bshd", dz, qg) * sm_scale
    return (dq.reshape(b, t, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def route(dtype: torch.dtype) -> str:
    """The C entry K4 launches for operands of `dtype`: bf16 -> the sm90
    kernels, fp32 -> the SIMT template. Nothing else is taken."""
    if dtype == torch.bfloat16:
        return "vidi_flash_attention_bwd_sm90"
    if dtype == torch.float32:
        return "vidi_flash_attention_bwd"
    raise TypeError(f"flash_attention_bwd: no kernel for {dtype}")


def sm90_bwd_plan(b: int, t: int, s: int, hq: int, hk: int, sms: int) -> int:
    """Splits of S of the sm90 dq kernel: as many as fit in one wave of one
    block per SM (`sms` SMs), none below SM90_MIN_SPLIT_KEYS keys. Split i
    takes key tiles i, i + n_split, ... of each block's range, so a masked
    tail of S is shared by all of them. The training slice's T2V (32 blocks
    of 128 packed rows) splits 4 ways on 132 SMs."""
    return max(1, min(sms // sm90_blocks(b, t, hq, hk), s // SM90_MIN_SPLIT_KEYS))


def sm90_bwd_group(hq: int, hk: int) -> int:
    """g = hq // hk: raises unless g divides both kernels' row tiles."""
    g = sm90_group(hq, hk)
    if SM90_BWD_KV_ROWS % g:
        raise ValueError(f"flash_attention_bwd: {g} query heads per KV head do not "
                         f"divide the {SM90_BWD_KV_ROWS}-row tile")
    return g


def dkv_rows(t: int, hq: int, hk: int) -> torch.Tensor:
    """[tiles, 64, 2] (t, query head offset within the KV head's group) of
    each packed row of each query tile the dk / dv kernel streams, as it
    gathers lse and di for them: row r of tile x is query x * (64 // g) +
    r // g of head r % g. Rows with t >= T carry no gradient."""
    g = sm90_bwd_group(hq, hk)
    r = torch.arange(SM90_BWD_KV_ROWS)
    tiles = torch.arange(-(-t * g // SM90_BWD_KV_ROWS))[:, None]
    return torch.stack((tiles * (SM90_BWD_KV_ROWS // g) + r // g,
                        (r % g).expand(tiles.shape[0], -1)), dim=-1)


def _seg_meet(q_segs, kv_segs, rows: slice, keys) -> bool:
    """Whether the segment ids of `rows` and of the keys `keys` (a bool
    index of the unmasked ones) can be equal: their [min, max] ranges
    overlap, the kernels' test."""
    q, kseg = q_segs[rows], kv_segs[keys]
    return bool(kseg.min() <= q.max() and q.min() <= kseg.max())


def sm90_bwd_dq_tiles(b, t, s, hq, hk, d, n_split, causal, window,
                      kv_mask=None, q_segs=None, kv_segs=None):
    """The key tiles the sm90 dq kernel computes, by its rules: each block's
    keys clipped to the causal / window band of its rows and dealt to the
    splits in turn, a tile skipped when all its keys are masked or its
    segment ids cannot meet the rows'.
    -> [(batch, KV head, split, first t, end t, first key, end key)]."""
    g = sm90_bwd_group(hq, hk)
    rows_t, keys = SM90_ROWS // g, SM90_BWD_DQ_KEYS[d]
    live = []
    for bi in range(b):
        for x in range(-(-t // rows_t)):
            t0, t1 = x * rows_t, min(t, (x + 1) * rows_t)
            begin, end = 0, s
            if causal:
                end = min(end, t0 + rows_t, t)
            if window:
                begin = max(begin, t0 - window + 1)
            for j, s0 in enumerate(range(begin, end, keys)):
                s1 = min(s0 + keys, end)
                ok = (torch.ones(s1 - s0, dtype=torch.bool) if kv_mask is None
                      else kv_mask[bi, s0:s1].bool().cpu())
                if not ok.any():
                    continue
                if q_segs is not None and not _seg_meet(
                        q_segs[bi].cpu(), kv_segs[bi, s0:s1].cpu(), slice(t0, t1), ok):
                    continue
                live += [(bi, h, j % n_split, t0, t1, s0, s1) for h in range(hk)]
    return live


def sm90_bwd_dkv_tiles(b, t, s, hq, hk, causal, window, kv_mask=None,
                       q_segs=None, kv_segs=None):
    """The query tiles the sm90 dk / dv kernel computes, by its rules: each
    block's rows clipped to the causal / window band of its 64 keys, none
    when every key is masked, a tile skipped when its segment ids cannot
    meet the keys'. -> [(batch, KV head, first t, end t, first key, end key)]."""
    g = sm90_bwd_group(hq, hk)
    rows_t, keys = SM90_BWD_KV_ROWS // g, SM90_BWD_KV_KEYS
    live = []
    for bi in range(b):
        for k0 in range(0, s, keys):
            k1 = min(k0 + keys, s)
            ok = (torch.ones(k1 - k0, dtype=torch.bool) if kv_mask is None
                  else kv_mask[bi, k0:k1].bool().cpu())
            if not ok.any():
                continue
            t_lo = k0 if causal else 0
            t_hi = min(t, k1 - 1 + window) if window else t
            if t_hi <= t_lo:
                continue
            for x in range(t_lo // rows_t, (t_hi - 1) // rows_t + 1):
                t0, t1 = x * rows_t, min(t, (x + 1) * rows_t)
                if q_segs is not None and not _seg_meet(
                        q_segs[bi].cpu(), kv_segs[bi, k0:k1].cpu(), slice(t0, t1), ok):
                    continue
                live += [(bi, h, t0, t1, k0, k1) for h in range(hk)]
    return live


def tma_operand_strides(q, k, v, do) -> list:
    """The (batch, length, head) element strides of q, k, v and dO that the
    sm90 kernels' tensor maps are given: raises unless each is 16-byte
    aligned (`tma_strides`)."""
    return [tma_strides(f"flash_attention_bwd {label}", x.shape, x.stride(),
                        x.data_ptr(), x.element_size())[:3]
            for label, x in (("q", q), ("k", k), ("v", v), ("do", do))]


def _launch(q, k, v, kv_mask, out, lse, do, sm_scale, causal, window, softcap,
            q_segs, kv_segs):
    global launches
    check_qkv(q, k, v, window, "flash_attention_bwd")
    entry = route(q.dtype)
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
    di = (out.float() * do).sum(-1).transpose(1, 2).contiguous()  # [B,Hq,T]
    qs = int32_rows(q_segs, (b, t), q.device, "flash_attention_bwd")
    ks = int32_rows(kv_segs, (b, s), q.device, "flash_attention_bwd")
    if q.dtype == torch.bfloat16:
        strides = tma_operand_strides(q, k, v, do)
        sm90_bwd_group(hq, hk)
        mask = mask_bytes(kv_mask, (b, s), q.device, "flash_attention_bwd")
        n_split, kv_split = sm90_bwd_plan(b, t, s, hq, hk, _lib.sm_count(q.device)), 0
    else:
        strides = [x.stride()[:3] for x in (q, k, v)]
        mask = int32_rows(kv_mask, (b, s), q.device, "flash_attention_bwd")
        n_split, kv_split = _kv_split(b, t, s, hq, q.device)
    dq = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, hk, d), dtype=v.dtype, device=q.device)
    dq_part = (torch.empty((n_split, b, t, hq, d), dtype=torch.float32,
                           device=q.device) if n_split > 1 else None)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    _lib.call(entry, q.device,
              q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), di.data_ptr(), ptr(mask), ptr(qs), ptr(ks),
              dq.data_ptr(), ptr(dq_part), dk.data_ptr(), dv.data_ptr(),
              b, t, s, hq, hk, d, *(x for st in strides for x in st),
              float(sm_scale), int(causal), int(window or 0), float(softcap or 0.0),
              n_split, kv_split)
    launches += 1
    route_launches[entry] += 1
    return dq, dk, dv
