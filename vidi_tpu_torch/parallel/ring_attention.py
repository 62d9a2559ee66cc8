"""Ring attention over the mesh's seq axis (port of
vidi_tpu/parallel/ring_attention.py), and the "gspmd" plan of the same
cross attention.

The modality KV stays cut over "seq": each rank holds a contiguous slice
of the stream's keys, and the text queries (short) are replicated over the
seq group. Non-causal (the Dattn T2V / T2A pattern).

- `ring_cross_attention`: the (k, v, mask) shards rotate around the seq
  group (`dist.batch_isend_irecv` to rank + 1, from rank - 1); each rank
  computes the flash partial (out, lse) of every shard as it visits
  (`_local_attn_lse`: K1 on the card with `use_flash`) and merges them with
  their log-sum-exp weights (`_combine`). The partials are merged in shard
  order, so every rank's output is the same bits (JAX merges in visit
  order and takes the mean over the ring). No rank ever holds more than one
  shard of the stream.
- `gspmd_cross_attention`: what XLA emits for a softmax reduced over a
  sharded axis: each rank's partial on its own shard, one all-gather of the
  (out, lse) partials, the same merge.
- `merge_gathered`: that all-gather and merge without autograd, for
  inference's reads of seq-cut caches (`sharding.seq_merge`).

Both are `torch.autograd.Function`s (P2P ops have no gradient). Their
backward is the flash backward of each shard against the final merged
`out` and `lse` (K4 on the card with `use_flash`: p = exp(s - lse) and
di = rowsum(out * dO) are those of the whole row, so each shard's dq /
dk / dv are its exact share), which needs no gradient through lse. The
ring rotates the shards again, each rank adding its dk / dv to
accumulators that travel with the shard and come home after a full turn;
the gspmd plan sums dO over the group and computes its own shard's. Each
rank's output feeds a replicated computation, so its backward carries its
share of dO; with the train step's loss / seq seed the sums above make
every shard's gradient whole.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from vidi_tpu_torch.core.mesh import Mesh


def _local_attn_lse(q, k, v, kv_mask, sm_scale: float, softcap: Optional[float],
                    use_flash: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out [B,T,H,D] normalized, lse [B,T,H] fp32; -inf for rows with no
    visible key). `use_flash`: K1 (its plain version on a CPU tensor), whose
    empty-row sentinel lse becomes -inf; else the reference math."""
    if use_flash:
        from vidi_tpu_torch.ops.cuda.flash_attention import EMPTY_ROW_LSE, flash_attention
        out, lse = flash_attention(q, k, v, kv_mask, sm_scale, False, None, softcap)
        lse = torch.where(lse >= EMPTY_ROW_LSE, float("-inf"), lse)
        return out, lse.transpose(1, 2)
    from vidi_tpu_torch.ops.attention import NEG_INF, _grouped_logits, _soft_cap

    logits = _soft_cap(_grouped_logits(q, k, sm_scale), softcap)  # [B,Hk,G,T,S]
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask.bool()[:, None, None, None, :], NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m > NEG_INF / 2, m, torch.zeros_like(m))
    p = torch.exp(logits - m_safe)  # masked entries: exp(NEG_INF) == 0 exactly
    l = p.sum(dim=-1, keepdim=True)
    b, hk, g, t, _ = logits.shape
    out = torch.einsum("bhgts,bshd->bthgd", p / torch.clamp(l, min=1e-30), v.float())
    out = out.reshape(b, t, hk * g, -1).to(q.dtype)
    lse = torch.where(l[..., 0] > 0, m_safe[..., 0] + torch.log(torch.clamp(l[..., 0], min=1e-30)),
                      torch.full_like(l[..., 0], float("-inf")))  # [B,Hk,G,T]
    return out, lse.permute(0, 3, 1, 2).reshape(b, t, hk * g)


def _combine(out_a, lse_a, out_b, lse_b):
    """Merge two normalized attention partials by their log-sum-exp weights."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    wa = torch.where(torch.isfinite(lse_a), torch.exp(lse_a - m_safe), torch.zeros_like(m))
    wb = torch.where(torch.isfinite(lse_b), torch.exp(lse_b - m_safe), torch.zeros_like(m))
    l = wa + wb
    l_safe = torch.clamp(l, min=1e-30)
    out = (out_a.float() * (wa / l_safe)[..., None]
           + out_b.float() * (wb / l_safe)[..., None])
    lse = torch.where(l > 0, m_safe + torch.log(l_safe), torch.full_like(l, float("-inf")))
    return out.to(out_a.dtype), lse


def merge(partials: List[Tuple[torch.Tensor, torch.Tensor]]):
    """The shards' partials (out, lse) merged in shard order, in fp32 until
    the one rounding of the output -> (out in the partials' dtype, lse)."""
    out, lse = partials[0]
    dtype = out.dtype
    out = out.float()
    for o, l in partials[1:]:
        out, lse = _combine(out, lse, o, l)
    return out.to(dtype), lse


def _gather_merge(out, lse, group, n: int):
    """The group's partials (out [B,T,H,D], lse [B,T,H]) all-gathered and
    merged in group order -> (out, lse)."""
    from vidi_tpu_torch.parallel.sharding import all_gather_dim
    outs = all_gather_dim(out[None], 0, group, n)
    lses = all_gather_dim(lse[None], 0, group, n)
    return merge(list(zip(outs.unbind(0), lses.unbind(0))))


@torch.no_grad()
def merge_gathered(out, lse, group, n: int) -> torch.Tensor:
    """Inference's merge, without autograd: this rank's partial (out
    [B,T,H,D], lse [B,T,H] fp32, -inf where its shard has no visible key)
    all-gathered over `group` (n ranks) and merged in shard order -> the
    output over every shard, the same bits on every rank."""
    return _gather_merge(out, lse, group, n)[0]


def shard_grads(q, k, v, kv_mask, out, lse, dout, sm_scale: float,
                softcap: Optional[float], use_flash: bool):
    """One shard's (dq, dk, dv) of the merged attention: the flash backward
    of the shard against the final `out` and `lse` [B,T,H] (K4 with
    `use_flash`, else its plain version)."""
    from vidi_tpu_torch.ops.cuda.flash_attention import EMPTY_ROW_LSE
    from vidi_tpu_torch.ops.cuda import flash_attention_bwd as k4

    lse = torch.where(torch.isfinite(lse), lse, torch.full_like(lse, EMPTY_ROW_LSE))
    lse = lse.transpose(1, 2).contiguous()  # [B,H,T], as K1 gives it
    bwd = k4.flash_attention_bwd if use_flash else k4.flash_attention_bwd_plain
    return bwd(q, k, v, kv_mask, out, lse, dout, sm_scale, False, None, softcap)


def _global_rank(group, i: int) -> int:
    return i if group is dist.group.WORLD else dist.get_global_rank(group, i)


def _rotate(tensors, group, n: int, rank: int):
    """Each tensor sent to group rank + 1 and replaced by the one from rank
    - 1 (masks travel as uint8)."""
    nxt, prv = (_global_rank(group, (rank + i) % n) for i in (1, -1))
    recv = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, recv):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mask, group, sm_scale, softcap, use_flash):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        partials = [None] * n
        k_, v_, m_ = k, v, mask
        for step in range(n):
            partials[(r - step) % n] = _local_attn_lse(q, k_, v_, m_.bool(), sm_scale,
                                                       softcap, use_flash)
            if step < n - 1:
                k_, v_, m_ = _rotate([k_, v_, m_], group, n, r)
        out, lse = merge(partials)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.args = (group, sm_scale, softcap, use_flash)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        group, sm_scale, softcap, use_flash = ctx.args
        n, r = dist.get_world_size(group), dist.get_rank(group)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_, v_, m_ = k, v, mask
        for step in range(n):
            gq, gk, gv = shard_grads(q, k_, v_, m_.bool(), out, lse, dout, sm_scale,
                                     softcap, use_flash)
            dq += gq.float()
            dk += gk.float()
            dv += gv.float()
            # the accumulators travel with their shard; after the last
            # step one more turn brings them home
            if step < n - 1:
                k_, v_, m_, dk, dv = _rotate([k_, v_, m_, dk, dv], group, n, r)
            else:
                dk, dv = _rotate([dk, dv], group, n, r)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def ring_cross_attention_local(q, k, v, kv_mask, *, group, sm_scale: float,
                               softcap: Optional[float] = None,
                               use_flash: bool = False) -> torch.Tensor:
    """q [B,T,Hq,D] (the same on every rank of `group`), k / v [B,S/n,Hk,D]
    this rank's KV shard, kv_mask [B,S/n] -> the full attention output
    [B,T,Hq,D], the same on every rank. A ring of one sends nothing."""
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    if group is None or dist.get_world_size(group) == 1:
        if use_flash:
            from vidi_tpu_torch.ops.cuda.flash_attention import flash_attention
            return flash_attention(q, k, v, kv_mask, sm_scale, False, None, softcap)[0]
        from vidi_tpu_torch.ops.attention import cross_attention
        return cross_attention(q, k, v, kv_valid=kv_mask, scale=sm_scale, softcap=softcap)
    return _Ring.apply(q, k, v, kv_mask.to(torch.uint8), group, sm_scale, softcap,
                       use_flash)


def ring_cross_attention(q, k, v, kv_mask, mesh: Mesh, *, sm_scale: float,
                         softcap: Optional[float] = None,
                         use_flash: bool = False) -> torch.Tensor:
    """The entry point: this rank's batch rows (cut over "data" already),
    q replicated over "seq", k / v / kv_mask this rank's slice of the
    stream -> the output, replicated over "seq"."""
    return ring_cross_attention_local(q, k, v, kv_mask, group=mesh.group(("seq",)),
                                      sm_scale=sm_scale, softcap=softcap,
                                      use_flash=use_flash)


class _GatherCombine(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mask, group, sm_scale, softcap, use_flash):
        o, l = _local_attn_lse(q, k, v, mask, sm_scale, softcap, use_flash)
        out, lse = _gather_merge(o, l, group, dist.get_world_size(group))
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.args = (group, sm_scale, softcap, use_flash)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        group, sm_scale, softcap, use_flash = ctx.args
        dout = dout.to(torch.float32, copy=True)  # autograd's tensor stays as it is
        dist.all_reduce(dout, group=group)
        dq, dk, dv = shard_grads(q, k, v, mask, out, lse, dout.to(out.dtype), sm_scale,
                                 softcap, use_flash)
        return dq, dk, dv, None, None, None, None, None


def gspmd_cross_attention(q, k, v, kv_mask, mesh: Mesh, *, sm_scale: float,
                          softcap: Optional[float] = None,
                          use_flash: bool = False) -> torch.Tensor:
    """The "gspmd" plan: the partial of this rank's shard, one all-gather of
    the partials over "seq", the merge. Layouts as
    `ring_cross_attention`."""
    group = mesh.group(("seq",))
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    if group is None:
        return ring_cross_attention_local(q, k, v, kv_mask, group=None, sm_scale=sm_scale,
                                          softcap=softcap, use_flash=use_flash)
    return _GatherCombine.apply(q, k, v, kv_mask.bool(), group, sm_scale, softcap,
                                use_flash)
