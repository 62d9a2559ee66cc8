"""Ulysses sequence parallelism: explicit all-to-all reshards (port of
vidi_tpu/parallel/ulysses.py).

The all-to-alls are `dist.all_to_all_single` inside a
`torch.autograd.Function` (`_AllToAll`), whose backward is the inverse
reshard. Layouts follow the model: [B, S, H, D] with S or H cut over the
seq group.

`ulysses_cross_attention_sharded` is the Dattn T2V / T2A form: the text
queries are replicated over the seq group, the stream's k / v cut over it.
Each rank takes its Hq / n query heads, reshards k / v from stream slices
to head slices over the full stream (one all-to-all each), attends (K1 with
`use_flash`), and the head slices are all-gathered before `o_w` (GSPMD does
that gather implicitly in JAX). The gather's backward sums each rank's
share of dO for a head slice (reduce-scatter), as the replicated output's
adjoint.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from vidi_tpu_torch.core.mesh import Mesh


def _seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    b, s, h, d = x.shape
    inp = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)  # out[i]: rank i's slice of S
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    b, s, h, d = x.shape
    inp = x.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)  # out[i]: rank i's heads
    return out.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


class _AllToAll(torch.autograd.Function):
    """seq -> heads (or heads -> seq with `inverse`); the backward is the
    other reshard."""

    @staticmethod
    def forward(ctx, x, group, n, inverse):
        ctx.args = (group, n, inverse)
        return (_heads_to_seq if inverse else _seq_to_heads)(x, group, n)

    @staticmethod
    def backward(ctx, g):
        group, n, inverse = ctx.args
        return (_seq_to_heads if inverse else _heads_to_seq)(g, group, n), None, None, None


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S/n, H, D] (seq-sharded view) -> [B, S, H/n, D] (head-sharded view):
    the all-to-all form of the reference's SeqAllToAll4D(scatter_idx=2,
    gather_idx=1)."""
    return _AllToAll.apply(x, group, dist.get_world_size(group), False)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S, H/n, D] -> [B, S/n, H, D]: the inverse reshard."""
    return _AllToAll.apply(x, group, dist.get_world_size(group), True)


def expand_kv(k: torch.Tensor, v: torch.Tensor, num_kv_heads: int, sp_size: int):
    """GQA head replication when sp_size > num_kv_heads: each KV head
    repeated in place so every seq rank gets at least one (query head h
    still reads expanded head h // (Hq / (Hk * rep)), the original h // G)."""
    if sp_size <= num_kv_heads:
        return k, v
    if sp_size % num_kv_heads:
        raise ValueError(f"seq {sp_size} is no multiple of {num_kv_heads} KV heads")
    rep = sp_size // num_kv_heads
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


def ulysses_attention(q, k, v, group,
                      attn_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                                        torch.Tensor]) -> torch.Tensor:
    """q / k / v seq-sharded [B, S/n, H, D]: reshard to heads, run `attn_fn`
    on full-length q / k / v with H/n heads ([B, T, H/n, D] out), reshard
    back."""
    out = attn_fn(seq_to_heads(q, group), seq_to_heads(k, group), seq_to_heads(v, group))
    return heads_to_seq(out, group)


def ulysses_cross_attention_sharded(q, k, v, kv_mask, mesh: Mesh, *, sm_scale: float,
                                    softcap: Optional[float] = None,
                                    use_flash: bool = False) -> torch.Tensor:
    """q [B,T,Hq,D] replicated over "seq", k / v [B,S/n,Hk,D] and
    kv_mask [B,S/n] this rank's stream slice -> the output [B,T,Hq,D],
    replicated over "seq"."""
    from vidi_tpu_torch.parallel.sharding import all_gather_dim, all_gather_grad

    group = mesh.group(("seq",))
    n = mesh.shape["seq"]
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    if n > k.shape[2]:
        k, v = expand_kv(k, v, k.shape[2], n)
    r = mesh.coord("seq")
    hq = q.shape[2]
    qh = q[:, :, r * (hq // n):(r + 1) * (hq // n)]
    kh, vh = seq_to_heads(k, group), seq_to_heads(v, group)
    mask = all_gather_dim(kv_mask.to(torch.uint8), 1, group, n).bool()
    if use_flash:
        from vidi_tpu_torch.ops.cuda.flash_attention import flash_attention
        out = flash_attention(qh, kh, vh, mask, sm_scale, False, None, softcap)[0]
    else:
        from vidi_tpu_torch.ops.attention import cross_attention
        out = cross_attention(qh, kh, vh, kv_valid=mask, scale=sm_scale, softcap=softcap)
    return all_gather_grad(out, 2, group, n)
