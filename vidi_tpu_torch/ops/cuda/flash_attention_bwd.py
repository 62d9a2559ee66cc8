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

Head dims and groups as K1 takes them: each route is compiled for the
widths WIDTHS and runs a head dim at the least that holds it, a D that is
no multiple of 8 goes through one zero-padded copy of each operand
(`pad_copies`), and a group g that does not divide a kernel's row tile
computes its leftover rows without storing them (`dkv_rows`,
`dkv_stored`); a group wider than the dk / dv kernel's 64-row tile runs as
slices of at most 64 query heads: each slice's dk / dv comes back from its
kernel in the operands' dtype, and the slices are summed in fp32 by
PyTorch and rounded once more.

On a CPU tensor the wrapper runs `flash_attention_bwd_plain`; on a CUDA
tensor it launches the kernels or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from vidi_tpu_torch.ops.cuda import _lib
from vidi_tpu_torch.ops.cuda.flash_attention import (HEAD_ALIGN, SM90_MIN_SPLIT_KEYS, SM90_ROWS,
                                                     _kv_split, check_qkv, group_slices,
                                                     head_width, int32_rows, mask_bytes,
                                                     packed_rows, padded_heads, sm90_blocks,
                                                     tma_strides, visible_mask)

launches = 0  # kernel launches since the last reset (chip_smoke reads this)
pad_copies = 0  # operands copied into a zero-padded head dim (D % 8 != 0)
# the same launches by C entry (`route`): which route each call took
route_launches = {"vidi_flash_attention_bwd_sm90": 0, "vidi_flash_attention_bwd": 0}
# the compiled widths by route (csrc/flash_attention_bwd.cu): the sm90
# kernels' 64-column chunks split between two warpgroups start at 128
WIDTHS = {"vidi_flash_attention_bwd_sm90": (128, 256),
          "vidi_flash_attention_bwd": (64, 128, 256)}
# the sm90 kernels (csrc/flash_backward_sm90.cuh): keys per tile of the dq
# kernel by compiled width; keys per block and packed query rows per
# streamed tile of the dk / dv kernel
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


def dkv_rows(t: int, hq: int, hk: int) -> torch.Tensor:
    """[tiles, 64, 2] (t, query head offset within the KV head's group) of
    each packed row of each query tile the dk / dv kernel streams, as it
    gathers lse and di for them: row r of tile x is query x * (64 // g) +
    r // g of head r % g. Rows with t >= T and the 64 % g rows left over
    carry no gradient (`dkv_stored`)."""
    return packed_rows(t, hq // hk, SM90_BWD_KV_ROWS)[0]


def dkv_stored(t: int, hq: int, hk: int) -> torch.Tensor:
    """[tiles, 64] bool: the rows of `dkv_rows` that carry a gradient."""
    return packed_rows(t, hq // hk, SM90_BWD_KV_ROWS)[1]


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
    rows_t, keys = SM90_ROWS // (hq // hk), SM90_BWD_DQ_KEYS[head_width(d, WIDTHS[route(torch.bfloat16)])]
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
    rows_t, keys = SM90_BWD_KV_ROWS // (hq // hk), SM90_BWD_KV_KEYS
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


def _sliced(q, k, v, kv_mask, out, lse, do, *args):
    """The backward of a group wider than the dk / dv kernel's row tile: one
    call a slice of at most SM90_BWD_KV_ROWS query heads of a KV head
    (`group_slices`), dq joined; each KV head's dk / dv are the slices'
    (rounded to the operands' dtype by their kernels) summed in fp32 and
    rounded again."""
    hq, hk = q.shape[2], k.shape[2]
    dq, dk, dv = [], [[] for _ in range(hk)], [[] for _ in range(hk)]
    for h, h0, h1 in group_slices(hq, hk, SM90_BWD_KV_ROWS):
        a, b_, c = _launch(q[:, :, h0:h1], k[:, :, h:h + 1], v[:, :, h:h + 1], kv_mask,
                           out[:, :, h0:h1], lse[:, h0:h1], do[:, :, h0:h1], *args)
        dq.append(a)
        dk[h].append(b_.float())
        dv[h].append(c.float())
    return (torch.cat(dq, 2), torch.cat([sum(x) for x in dk], 2).to(k.dtype),
            torch.cat([sum(x) for x in dv], 2).to(v.dtype))


def _launch(q, k, v, kv_mask, out, lse, do, sm_scale, causal, window, softcap,
            q_segs, kv_segs):
    global launches, pad_copies
    d = q.shape[-1]
    if d % HEAD_ALIGN:  # rows TMA cannot address: one zero-padded copy each
        q, k, v, out, do = padded_heads("flash_attention_bwd", q, k, v, out, do)
        pad_copies += 5
        grads = _launch(q, k, v, kv_mask, out, lse, do, sm_scale, causal, window, softcap,
                        q_segs, kv_segs)
        return tuple(x[..., :d] for x in grads)
    check_qkv(q, k, v, window, "flash_attention_bwd")
    entry = route(q.dtype)
    b, t, hq, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16 and hq // hk > SM90_BWD_KV_ROWS:
        return _sliced(q, k, v, kv_mask, out, lse, do, sm_scale, causal, window, softcap,
                       q_segs, kv_segs)
    w = head_width(d, WIDTHS[entry], "flash_attention_bwd")
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
        mask = mask_bytes(kv_mask, (b, s), q.device, "flash_attention_bwd")
        n_split, kv_split = sm90_bwd_plan(b, t, s, hq, hk, _lib.sm_count(q.device)), 0
    else:
        strides = [x.stride()[:3] for x in (q, k, v)]
        mask = int32_rows(kv_mask, (b, s), q.device, "flash_attention_bwd")
        n_split, kv_split = _kv_split(b, t, s, hq, q.device)
    dq = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, hk, d), dtype=v.dtype, device=q.device)
    dq_part = (torch.empty((n_split, b, t, hq, w), dtype=torch.float32,
                           device=q.device) if n_split > 1 else None)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    _lib.call(entry, q.device,
              q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), di.data_ptr(), ptr(mask), ptr(qs), ptr(ks),
              dq.data_ptr(), ptr(dq_part), dk.data_ptr(), dv.data_ptr(),
              b, t, s, hq, hk, w, d, *(x for st in strides for x in st),
              float(sm_scale), int(causal), int(window or 0), float(softcap or 0.0),
              n_split, kv_split)
    launches += 1
    route_launches[entry] += 1
    return dq, dk, dv
