"""K3: decode attention, one query token against a KV cache
(csrc/decode_attention.cu, csrc/decode_attention_sm90.cuh).

Replaces the Pallas kernel `vidi_tpu.ops.pallas.decode_attention.
decode_attention`: q [B,Hq,D] against the cache-native k/v [B,Hk,S,D], the
G = Hq / Hk rows of a GQA group sharing a KV head (2 for Gemma2, 4 for
Mistral-7B, any G), kv_mask [B,S], softcap, and the Gemma2
sliding window through `q_pos` [B] (key s visible iff q_pos - s < window;
causality rides on kv_mask). Global layers pass `window=None`: the JAX
caller's `-(1 << 30)` q_pos sentinel existed only because its layer scan
made the sliding flag a traced value. Rows with no visible key give zeros.
With `return_lse` each row's log-sum-exp comes back too (K1's units and
empty-row sentinel): a decode read of a cache cut over the mesh's seq axis
merges the shards' outputs by it (`parallel.sharding.seq_merge`). The
Pallas kernel has no such output; no other call asks for it.

Two routes, by dtype (`route`):
- bf16: the Hopper kernel. `decode_plan` splits S so that the blocks fill
  the card, the splits taking its tiles in turn; each block streams its
  visible K/V tiles through a ring of bulk asynchronous copies, and the
  last block of each (batch, KV head) merges the splits' partial softmax
  states in split order: one launch a call. The operands must be what the
  kernel reads (`check_shapes`, `block_strides`): the wrapper raises on
  anything else.
- fp32: the SIMT kernels (CHUNK keys a block, then a merge pass), for the
  fp32 checks that hold the card against the CPU.

Head dims and groups: both routes are compiled for row groups of GROUPS
and the widths WIDTHS, and take any G and any D up to 256. A head dim runs
at the least width that holds it (the sm90 kernel still copies D-element
rows; a lane whose columns lie past D holds zeros); a D that is no
multiple of 8 is copied once into zero-padded operands (`pad_copies`). A
KV head's G rows are cut into `decode_groups`: G in GROUPS is one group
(the kernels' exact build, the shipped shapes), another G <= 8 one group
of the next size in GROUPS whose rows past G are computed and not stored,
a G above 8 groups of at most 8 rows, each reading the KV head's tiles.

The kernels read a bool / uint8 kv_mask and an int32 / int64 q_pos as they
come (`mask_operand`, `qpos_operand`); the partials and the merge counters
live in a workspace kept per (device, stream) (`WORKSPACE`), so a call
allocates only its output. On a CPU tensor the wrapper runs
`decode_attention_plain`; on a CUDA tensor it launches the kernel or
raises. `decode_attention_schedule` restates the bf16 kernel's schedule in
plain PyTorch for the tests.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Optional

import torch

from vidi_tpu_torch.ops.cuda import _lib
from vidi_tpu_torch.ops.cuda.flash_attention import (EMPTY_ROW_LSE, HEAD_ALIGN, head_width,
                                                     padded_heads)

GROUPS = (1, 2, 4, 8)  # the row groups compiled in csrc/decode_attention*.cu
# the compiled widths by route (a lane holds D / 32 elements: 4 or 8 on the
# sm90 kernel's 16-byte loads, an even count on the SIMT kernel's)
WIDTHS = {"vidi_decode_attention_sm90": (128, 256), "vidi_decode_attention": (64, 128, 256)}
CHUNK = 256  # keys per block of the fp32 SIMT kernel
# The sm90 kernel (csrc/decode_attention_sm90.cuh): keys a ring stage holds
# at G <= 2 (32 KB of K and V at either head dim; `sm90_tile`), blocks
# resident on an SM (a 96 KB ring each), keys a block takes at most (its
# mask bytes sit in shared memory), consumer warps of a block.
SM90_TILE = {128: 64, 256: 32}
SM90_BLOCKS_PER_SM = 2
SM90_MAX_CHUNK = 4096
SM90_CONSUMERS = 4
BULK_ALIGN = 16  # bytes: a bulk copy's source starts on 16 bytes
MASK_VALUE = -0.7 * torch.finfo(torch.float32).max  # the Pallas kernel's
launches = 0  # kernel launches since the last reset (chip_smoke reads this)
pad_copies = 0  # operands copied into a zero-padded head dim (D % 8 != 0)


def decode_groups(g: int) -> tuple:
    """(kg, rg, n_groups): a KV head's g query rows cut into n_groups groups
    of rg rows, each computed by a kernel built for kg >= rg rows (GROUPS):
    the fewest groups of at most 8 rows, of near equal size. G = 6 is one
    group of 6 on the kg = 8 build, G = 12 two of 6."""
    n_groups = -(-g // GROUPS[-1])
    rg = -(-g // n_groups)
    return next(k for k in GROUPS if k >= rg), rg, n_groups


def sm90_tile(d: int, g: int) -> int:
    """Keys a ring stage of the sm90 kernel holds (its `Cfg::kTile`) for
    head dim d and g rows a KV head: a warp's tile // SM90_CONSUMERS keys
    times the kg rows of its build (`decode_groups`) must fit the 32 lanes
    of one reduce, so kg >= 4 takes 128 // kg keys (32 at 4, 16 at 8) and
    as many more stages."""
    w = head_width(d, WIDTHS["vidi_decode_attention_sm90"], "decode_attention")
    return min(SM90_TILE[w], SM90_CONSUMERS * 32 // decode_groups(g)[0])


def decode_attention(q, k, v, kv_mask, sm_scale: float,
                     softcap: Optional[float] = None,
                     window: Optional[int] = None, q_pos=None, *,
                     return_lse: bool = False):
    """q [B,Hq,D], k/v [B,Hk,S,D], kv_mask [B,S] or None, q_pos [B] (needed
    with `window`) -> out [B,Hq,D]; with `return_lse`, (out, lse [B,Hq]
    fp32): each row's log-sum-exp of its scaled, softcapped scores over
    the visible keys (K1's units), EMPTY_ROW_LSE for a row with none. The
    out is the same bits either way."""
    if window is not None and q_pos is None:
        raise ValueError("decode_attention: window needs q_pos")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_mask, sm_scale, softcap,
                                      window, q_pos, return_lse=return_lse)
    return _launch(q, k, v, kv_mask, sm_scale, softcap, window, q_pos, return_lse)


def visible_keys(b: int, s: int, kv_mask, window, q_pos, device):
    """[B,S] bool: the keys each row's query sees (mask and window)."""
    valid = torch.ones((b, s), dtype=torch.bool, device=device)
    if kv_mask is not None:
        valid = valid & (kv_mask.to(device) != 0)
    if window is not None:
        cols = torch.arange(s, device=device)[None, :]
        valid = valid & (q_pos.to(device)[:, None] - cols < window)
    return valid


def _lse(m, l):
    """m + log(l) of merged softmax states, EMPTY_ROW_LSE where l is 0."""
    return torch.where(l == 0, torch.full_like(l, EMPTY_ROW_LSE), m + torch.log(l))


def decode_attention_plain(q, k, v, kv_mask, sm_scale: float,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None, q_pos=None, *,
                           return_lse: bool = False):
    """Plain PyTorch version with the kernel's semantics: fp32 scores,
    unnormalised probabilities cast to v's dtype for P @ V, zeros for rows
    with no visible key; with `return_lse` also the rows' lse [B,Hq]."""
    b, hq, d = q.shape
    hk, s = k.shape[1], k.shape[2]
    g = hq // hk
    qg = q.reshape(b, hk, g, d).float()
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * sm_scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    valid = visible_keys(b, s, kv_mask, window, q_pos, q.device)
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    out = torch.where(l == 0, torch.zeros_like(acc), acc / l)
    out = out.reshape(b, hq, d).to(q.dtype)
    if not return_lse:
        return out
    return out, _lse(m[..., 0], l[..., 0]).reshape(b, hq)


def route(dtype: torch.dtype) -> str:
    """The C entry K3 launches for operands of `dtype`: bf16 -> the sm90
    kernel, fp32 -> the SIMT kernels. Nothing else is taken."""
    if dtype == torch.bfloat16:
        return "vidi_decode_attention_sm90"
    if dtype == torch.float32:
        return "vidi_decode_attention"
    raise TypeError(f"decode_attention: no kernel for {dtype}")


@functools.lru_cache(maxsize=None)
def decode_plan(b: int, hk: int, s: int, d: int, sms: int, *, g: int) -> tuple:
    """(tile, chunk, n_split) of the sm90 kernel on `sms` SMs for g query
    rows a KV head: `tile` keys a ring stage (`sm90_tile`); n_split splits
    of S that take its tiles in turn (split i: tiles i, i + n_split, ...),
    as many as give B * Hk * n_groups * n_split blocks (`decode_groups`) up
    to one wave of SM90_BLOCKS_PER_SM blocks an SM, each at least one tile;
    `chunk` the keys a split takes at most (whole tiles, at most
    SM90_MAX_CHUNK). Taking tiles in turn spreads a masked tail or the keys
    before a window over every split. The 9B's image cache (8 KV heads,
    23,520 keys) splits 33 ways, its audio cache (1,200 keys) 33 ways, a
    160-key text cache 5 ways; the 7B's image cache (8 KV heads of 128,
    7,680 keys, g = 4) 33 ways."""
    tile = sm90_tile(d, g)
    tiles = -(-s // tile)
    heads = b * hk * decode_groups(g)[2]
    n_split = max(1, min(-(-SM90_BLOCKS_PER_SM * sms // heads), tiles))
    n_split = max(n_split, -(-tiles // (SM90_MAX_CHUNK // tile)))
    return tile, -(-tiles // n_split) * tile, n_split


def split_tiles(split: int, s: int, plan: tuple) -> range:
    """The tiles of S that split `split` of `plan` takes, in its order."""
    tile, _, n_split = plan
    return range(split, -(-s // tile), n_split)


def check_shapes(q_shape, k_shape, v_shape) -> None:
    """Raise unless q [B,Hq,D] and k / v [B,Hk,S,D] are shapes the kernels
    take: the same B and D, Hq a multiple of Hk (any G), D a multiple of
    HEAD_ALIGN (the wrapper pads any other first) up to MAX_HEAD_DIM."""
    b, hq, d = q_shape
    hk = k_shape[1]
    if len(k_shape) != 4 or k_shape[0] != b or k_shape[3] != d or v_shape != k_shape or hq % hk:
        raise ValueError(f"decode_attention: q {tuple(q_shape)} k {tuple(k_shape)} "
                         f"v {tuple(v_shape)}: Hq must be a multiple of Hk")
    head_width(d, name="decode_attention")
    if d % HEAD_ALIGN:
        raise ValueError(f"decode_attention: head dim D = {d} is no multiple of {HEAD_ALIGN}")


def block_strides(name: str, shape, strides, ptr: int, elem_size: int) -> tuple:
    """(batch, KV head) strides of a k / v [B,Hk,S,D] that the sm90 kernel
    copies in bulk: raises unless each (b, hk) block of S rows is one
    contiguous run (stride(2) == D, stride(3) == 1) whose start lies on 16
    bytes. A dim of length one is never stepped along (stride 0)."""
    _, _, s, d = shape
    if strides[3] != 1 or (s > 1 and strides[2] != d):
        raise ValueError(f"{name}: each (b, hk) row block must be contiguous "
                         f"(strides {tuple(strides)} for shape {tuple(shape)})")
    if ptr % BULK_ALIGN:
        raise ValueError(f"{name}: data pointer {ptr:#x} not {BULK_ALIGN}-byte aligned")
    out = []
    for i in (0, 1):
        if shape[i] == 1:
            out.append(0)
        elif strides[i] * elem_size % BULK_ALIGN:
            raise ValueError(f"{name}: stride {strides[i]} of dim {i} does not keep "
                             f"the row blocks {BULK_ALIGN}-byte aligned")
        else:
            out.append(strides[i])
    return tuple(out)


def mask_operand(kv_mask, b: int, s: int, device):
    """(mask, row stride) as the kernels read kv_mask [B,S]: a bool or uint8
    mask on `device` with contiguous rows passes as it is (no copy, no
    launch); another one is converted. None stays None."""
    if kv_mask is None:
        return None, 0
    if kv_mask.shape != (b, s):
        raise ValueError(f"decode_attention: kv_mask {tuple(kv_mask.shape)}, "
                         f"expected {(b, s)}")
    if (kv_mask.dtype not in (torch.bool, torch.uint8) or kv_mask.device != device
            or (s > 1 and kv_mask.stride(1) != 1)):
        kv_mask = (kv_mask != 0).to(device).contiguous()
    return kv_mask, kv_mask.stride(0)


def qpos_operand(q_pos, b: int, device):
    """(q_pos, is int64, stride) as the kernels read q_pos [B]: int32 or
    int64 on `device` passes as it is; another one is converted."""
    if q_pos is None:
        return None, 0, 0
    if q_pos.shape != (b,):
        raise ValueError(f"decode_attention: q_pos {tuple(q_pos.shape)}, expected {(b,)}")
    if q_pos.dtype not in (torch.int32, torch.int64) or q_pos.device != device:
        q_pos = q_pos.to(device=device, dtype=torch.int64)
    return q_pos, int(q_pos.dtype == torch.int64), q_pos.stride(0)


class Workspace:
    """The kernels' partial softmax states ([rows] m and l, [rows, D] acc)
    and the sm90 kernel's merge counters ([B * Hk]), kept per (device,
    stream) and grown when a call needs more; `ptrs` holds their addresses.
    The counters are zeroed once, when allocated; the sm90 kernel leaves
    them at 0 after each call."""

    def __init__(self):
        self.buffers = {}

    def get(self, device, stream: int, rows: int, d: int, heads: int) -> dict:
        ws = self.buffers.get((device, stream))
        if ws is None or ws["rows"] < rows or ws["acc_n"] < rows * d or ws["heads"] < heads:
            ws = self.buffers[(device, stream)] = self._grow(device, ws or {}, rows, d, heads)
        return ws

    @staticmethod
    def _grow(device, ws: dict, rows: int, d: int, heads: int) -> dict:
        f32 = dict(dtype=torch.float32, device=device)
        if ws.get("rows", 0) < rows:
            ws["m"], ws["l"], ws["rows"] = torch.empty(rows, **f32), torch.empty(rows, **f32), rows
        if ws.get("acc_n", 0) < rows * d:
            ws["acc"], ws["acc_n"] = torch.empty(rows * d, **f32), rows * d
        if ws.get("heads", 0) < heads:
            ws["counters"] = torch.zeros(heads, dtype=torch.int32, device=device)
            ws["heads"] = heads
        ws["ptrs"] = tuple(ws[n].data_ptr() for n in ("m", "l", "acc", "counters"))
        return ws


WORKSPACE = Workspace()


def _merge(states):
    """Merge online-softmax states (m, l, acc) in the order given, as the
    kernel does: factors exp(m_i - max m), zero where every m is -inf."""
    mx = torch.stack([m for m, _, _ in states]).amax(dim=0)
    l, acc = torch.zeros_like(states[0][1]), torch.zeros_like(states[0][2])
    for m, li, ai in states:
        f = torch.where(mx == float("-inf"), torch.zeros_like(m), torch.exp(m - mx))
        l = l + li * f
        acc = acc + ai * f[..., None]
    return mx, l, acc


def decode_attention_schedule(q, k, v, kv_mask, sm_scale: float,
                              softcap: Optional[float] = None,
                              window: Optional[int] = None, q_pos=None, *,
                              plan: tuple, return_lse: bool = False):
    """The sm90 kernel's schedule in plain PyTorch (tested against
    `decode_attention_plain`, never run on a path): for each row and split
    of `plan` = (tile, chunk, n_split), the split's tiles in order
    (`split_tiles`), a tile with no visible key skipped, each of
    SM90_CONSUMERS warps running online softmax over its tile //
    SM90_CONSUMERS keys of every tile (scores, softcap, MASK_VALUE for
    hidden keys, running max, p rounded to v's dtype for P @ V, l in fp32);
    the warps merged per split, the splits in split order; with
    `return_lse` the merged rows' m + log(l) too. Each row group of
    `decode_groups` runs on its own, as the kernel's blocks do."""
    b, hq, d = q.shape
    hk = k.shape[1]
    _, rg, n_groups = decode_groups(hq // hk)
    if n_groups > 1:  # the groups' rows are the q heads hk * g + grp * rg ..
        g = hq // hk
        parts = []
        for grp in range(n_groups):
            heads = torch.tensor([h * g + j for h in range(hk)
                                  for j in range(grp * rg, min(g, (grp + 1) * rg))])
            parts.append((heads, decode_attention_schedule(
                q[:, heads], k, v, kv_mask, sm_scale, softcap, window, q_pos, plan=plan,
                return_lse=True)))
        out = torch.empty_like(q)
        lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
        for heads, (o, ls) in parts:
            out[:, heads], lse[:, heads] = o, ls
        return (out, lse) if return_lse else out
    tile, _, n_split = plan
    hk, s = k.shape[1], k.shape[2]
    g = hq // hk
    kpw = tile // SM90_CONSUMERS
    qf = q.reshape(b, hk, g, d).float()
    seen = visible_keys(b, s, kv_mask, window, q_pos, q.device)
    out = torch.zeros((b, hk, g, d), dtype=torch.float32, device=q.device)
    lse = torch.zeros((b, hk, g), dtype=torch.float32, device=q.device)
    for bi in range(b):
        parts = []
        for sp in range(n_split):
            warps = [(torch.full((hk, g), float("-inf"), device=q.device),
                      torch.zeros((hk, g), device=q.device),
                      torch.zeros((hk, g, d), device=q.device))
                     for _ in range(SM90_CONSUMERS)]
            for t in split_tiles(sp, s, plan):
                t0 = t * tile
                if not bool(seen[bi, t0:min(s, t0 + tile)].any()):
                    continue  # not computed
                for w in range(SM90_CONSUMERS):
                    k0, k1 = t0 + w * kpw, min(s, t0 + (w + 1) * kpw)
                    if k0 >= k1:
                        continue  # the ragged tile's end: no key for this warp
                    m, l, acc = warps[w]
                    sc = torch.einsum("hgd,hkd->hgk", qf[bi], k[bi, :, k0:k1].float())
                    sc = sc * sm_scale
                    if softcap is not None:
                        sc = torch.tanh(sc / softcap) * softcap
                    val = seen[bi, k0:k1]
                    sc = torch.where(val, sc, torch.full_like(sc, MASK_VALUE))
                    m_new = torch.maximum(m, sc.amax(dim=-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.where(val, torch.exp(sc - m_new[..., None]),
                                    torch.zeros_like(sc))
                    pv = torch.einsum("hgk,hkd->hgd", p.to(v.dtype).float(),
                                      v[bi, :, k0:k1].float())
                    warps[w] = (m_new, l * alpha + p.sum(dim=-1),
                                acc * alpha[..., None] + pv)
            parts.append(_merge(warps))
        mx, l, acc = _merge(parts)
        out[bi] = torch.where(l[..., None] == 0, torch.zeros_like(acc), acc / l[..., None])
        lse[bi] = _lse(mx, l)
    out = out.reshape(b, hq, d).to(q.dtype)
    return (out, lse.reshape(b, hq)) if return_lse else out


def same_device(q, k, v) -> tuple:
    """(device, dtype) of q / k / v: raises unless they share one CUDA
    device and one dtype."""
    dev, dtype = q.device, q.dtype
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"decode_attention: expected a CUDA tensor for q, k and v on "
                         f"one device, got {dev}, {k.device}, {v.device}")
    if k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"decode_attention: q {dtype}, k {k.dtype}, v {v.dtype}")
    return dev, dtype


# The C entries' arguments, packed into one block (csrc/decode_attention.cu,
# `DecodeArgs`): q, k, v, kv_mask, q_pos, part_m, part_l, part_acc, counters,
# out, lse (pointers; lse 0 when not asked for); B, Hq, Hk, S, the compiled
# width, q_pos is int64; the strides of q (batch, head), k and v (batch,
# head, key), the mask's rows and q_pos; scale, softcap; the head dim and
# the row groups (kg, rg, n_groups); window, n_split, chunk.
ARGS = struct.Struct("<11Q6i10q2f4i3i")
ARGS_BYTES = 232  # sizeof(DecodeArgs)


def _call(entry: str, dev, stream: int, values: tuple) -> None:
    """One ctypes call of `entry` with `values` packed (`ARGS`) on `stream`
    of `dev`; raises on a launch error. The block is the call's own: the
    ctypes call lets other threads run, and one that packed a shared
    block meanwhile (another virtual rank, the daemon's decode-ahead)
    would hand this launch its arguments."""
    args = ctypes.create_string_buffer(ARGS_BYTES)
    ARGS.pack_into(args, 0, *values)
    fn = getattr(_lib.library(), entry)
    if dev.index == torch._C._cuda_getDevice():
        err = fn(args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(args, stream)
    if err:
        _lib.check(err, entry)


def _layout(q, k, v) -> tuple:
    """Check q / k / v's devices, dtypes, shapes and strides and plan the
    call: (entry, b, hq, hk, s, d, width, row groups, q strides, k strides,
    v strides, chunk, n_split). The pointers' alignment is checked by the
    caller, per call."""
    dev, dtype = same_device(q, k, v)
    entry = route(dtype)
    q_shape, k_shape = q.shape, k.shape
    if q.dim() != 3:
        raise ValueError(f"decode_attention: q {tuple(q_shape)}, expected [B, Hq, D]")
    check_shapes(q_shape, k_shape, v.shape)
    b, hq, d = q_shape
    hk, s = k_shape[1], k_shape[2]
    w = head_width(d, WIDTHS[entry], "decode_attention")
    groups = decode_groups(hq // hk)
    q_st = q.stride()
    if q_st[2] != 1 or q_st[0] % 2 or q_st[1] % 2:
        raise ValueError(f"decode_attention q: last dim must be contiguous with even "
                         f"strides, got {q_st}")
    if dtype == torch.bfloat16:
        # strides checked at an aligned address; the real ones per call
        ks = block_strides("decode_attention k", k_shape, k.stride(), 0, 2)
        vs = block_strides("decode_attention v", k_shape, v.stride(), 0, 2)
        ks, vs = (*ks, d), (*vs, d)  # rows D apart (a length-one S included)
        _, chunk, n_split = decode_plan(b, hk, s, d, _lib.sm_count(dev), g=hq // hk)
    else:
        _lib.check_operand(k, "decode_attention k", 4, dtype)
        _lib.check_operand(v, "decode_attention v", 4, dtype)
        ks, vs = k.stride()[:3], v.stride()[:3]
        chunk, n_split = CHUNK, -(-s // CHUNK)
    return entry, b, hq, hk, s, d, w, groups, q_st[:2], ks, vs, chunk, n_split


_LAYOUTS = {}  # _layout's result by the metadata it reads


def _launch(q, k, v, kv_mask, sm_scale, softcap, window, q_pos, return_lse=False):
    """Check the operands, plan and launch. Decode makes 126 of these calls a
    step, so host time counts: a layout checked once (same devices, dtypes,
    shapes and strides) is looked up, and only the pointers are checked."""
    global launches, pad_copies
    d = q.shape[-1]
    if d % HEAD_ALIGN:  # rows a bulk copy cannot address: one zero-padded copy each
        q, k, v = padded_heads("decode_attention", q, k, v)
        pad_copies += 3
        res = _launch(q, k, v, kv_mask, sm_scale, softcap, window, q_pos, return_lse)
        return (res[0][..., :d], res[1]) if return_lse else res[..., :d]
    dev = q.device
    key = (dev, q.dtype, k.dtype, v.dtype, k.device, v.device, q.shape, k.shape, v.shape,
           q.stride(), k.stride(), v.stride())
    lay = _LAYOUTS.get(key)
    if lay is None:
        lay = _LAYOUTS[key] = _layout(q, k, v)
    entry, b, hq, hk, s, d, w, (kg, rg, n_groups), q_st, ks, vs, chunk, n_split = lay
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window must be positive, got {window}")
    q_ptr, k_ptr, v_ptr = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if q_ptr % (2 * q.element_size()):
        raise ValueError("decode_attention q: data pointer not aligned to an element pair")
    if entry == "vidi_decode_attention_sm90":
        if k_ptr % BULK_ALIGN or v_ptr % BULK_ALIGN:
            raise ValueError(f"decode_attention k / v: data pointers {k_ptr:#x} / {v_ptr:#x} "
                             f"not {BULK_ALIGN}-byte aligned")
    elif k_ptr % (2 * k.element_size()) or v_ptr % (2 * v.element_size()):
        raise ValueError("decode_attention k / v: data pointer not aligned to an element pair")
    mask, mask_sb = mask_operand(kv_mask, b, s, dev)
    qpos, qpos64, qpos_s = qpos_operand(q_pos if window is not None else None, b, dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ws = WORKSPACE.get(dev, stream, b * hk * n_groups * kg * n_split, w, b * hk * n_groups)
    out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, hq), dtype=torch.float32, device=dev) if return_lse else None
    _call(entry, dev, stream, (
        q_ptr, k_ptr, v_ptr, 0 if mask is None else mask.data_ptr(),
        0 if qpos is None else qpos.data_ptr(), *ws["ptrs"], out.data_ptr(),
        0 if lse is None else lse.data_ptr(),
        b, hq, hk, s, w, qpos64, *q_st, *ks, *vs, mask_sb, qpos_s,
        float(sm_scale), float(softcap or 0.0), d, kg, rg, n_groups, int(window or 0),
        n_split, chunk))
    launches += 1
    return out if lse is None else (out, lse)
