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

Two routes on the card, by dtype (`route`): bf16 takes the Hopper kernel
(csrc/flash_forward_sm90.cuh: wgmma products, TMA loads, GQA groups packed
into 128-row query tiles), which needs 16-byte aligned rows
(`tma_strides`) and raises otherwise; fp32 takes the SIMT template, which
computes in full fp32 for the card-vs-CPU checks. Both skip the key tiles
outside a block's causal / window band and, with segment ids, the tiles
whose ids cannot meet the block's rows' (`segments_meet`, the Pallas
kernel's `_seg_overlap`); `sm90_fwd_tiles` mirrors the bf16 kernel's walk.

Head dims and groups: as the TPU kernel, K1 takes any head dim D up to
MAX_HEAD_DIM and any group g = Hq / Hk. Both routes are compiled for the
widths WIDTHS and run a head dim at the least width that holds it
(`head_width`), reading the operands in place: the columns past D are
zeros and are not stored. A D that is no multiple of 8 (rows TMA cannot
address) is copied once into zero-padded operands (`padded_heads`, counted
in `pad_copies`) and the output sliced. The sm90 kernel packs 128 // g
queries of a group into its 128-row tile (`sm90_rows`); the 128 % g rows
left over are computed and not stored (`sm90_stored`); a group wider than
the tile runs as slices of at most 128 query heads (`group_slices`). A D
above MAX_HEAD_DIM raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from vidi_tpu_torch.ops.cuda import _lib

EMPTY_ROW_LSE = 0.7 * torch.finfo(torch.float32).max
Q_TILE, KV_TILE = 16, 64  # the SIMT kernel's block tile (csrc/attention_common.cuh)
MIN_SPLIT_KEYS = 512      # fewest keys worth one SIMT block of a KV split
# the compiled widths of K1 and K2, both routes (csrc/flash_attention.cu,
# csrc/tower_attention.cu): a head dim runs at the least one that holds it
WIDTHS = (64, 72, 128, 256)
MAX_HEAD_DIM = 256  # the widest head dim any kernel takes
HEAD_ALIGN = 8  # elements: rows of a multiple of 8 bf16 are 16-byte aligned
# the sm90 kernel (csrc/flash_forward_sm90.cuh): query rows per block, keys
# per K/V tile by compiled width, fewest keys worth one block of a KV split
SM90_ROWS = 128
SM90_KEY_TILE = {64: 128, 72: 128, 128: 128, 256: 64}
SM90_MIN_SPLIT_KEYS = 256
SM90_LIVE_TILES = 8192  # key tiles a packed block's live-tile mask holds (kLiveWords x 32)
TMA_ALIGN = 16  # bytes: TMA wants 16-byte aligned row starts and strides
launches = 0  # kernel launches since the last reset (chip_smoke reads this)
pad_copies = 0  # operands copied into a zero-padded head dim (D % 8 != 0)


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
    mask = visible_mask(q.shape[0], q.shape[1], k.shape[1], kv_mask, causal, window,
                        q_segs, kv_segs, q.device)
    return attention_with_mask(q, k, v, mask, sm_scale, softcap)


def attention_with_mask(q, k, v, mask, sm_scale: float,
                        softcap: Optional[float] = None):
    """The arithmetic of `flash_attention_plain` with the visible pairs
    given as a [B,T,S] bool mask: its body, which the tests and the chip
    checks also call with the mask of a kernel that skipped a tile."""
    b, t, hq, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = hq // hk
    qg = q.reshape(b, t, hk, g, d).float()
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * sm_scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
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


def head_width(d: int, widths=WIDTHS, name: str = "flash_attention") -> int:
    """The compiled width a head dim `d` runs at: the least of `widths`
    that holds it. Raises above MAX_HEAD_DIM."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} is outside the kernels' 1..{MAX_HEAD_DIM}")
    return next(w for w in widths if w >= d)


def padded_heads(name: str, *xs) -> tuple:
    """Each of `xs` copied once into a zero-padded last dim of the next
    multiple of HEAD_ALIGN (the rows the kernels address); raises above
    MAX_HEAD_DIM. The zero columns add nothing to q . k and come out as
    zero columns of the output, which the caller slices off."""
    d = xs[0].shape[-1]
    head_width(d, name=name)
    pad = -d % HEAD_ALIGN
    return tuple(torch.nn.functional.pad(x, (0, pad)) for x in xs)


def group_slices(hq: int, hk: int, most: int) -> list:
    """[(KV head, first query head, end query head)]: each KV head's g =
    hq // hk query heads cut into the fewest slices of at most `most`
    heads, of near equal size (a group wider than a kernel's row tile runs
    as one call a slice)."""
    g = hq // hk
    n = -(-g // most)
    size = -(-g // n)
    return [(h, h * g + j, h * g + min(g, j + size))
            for h in range(hk) for j in range(0, g, size)]


def route(dtype: torch.dtype) -> str:
    """The C entry K1 launches for operands of `dtype`: bf16 -> the sm90
    kernel, fp32 -> the SIMT template. Nothing else is taken."""
    if dtype == torch.bfloat16:
        return "vidi_flash_attention_fwd_sm90"
    if dtype == torch.float32:
        return "vidi_flash_attention_fwd"
    raise TypeError(f"flash_attention: no kernel for {dtype}")


def sm90_blocks(b: int, t: int, hq: int, hk: int) -> int:
    """(batch, KV head, 128-row tile) blocks of the sm90 kernel before any
    split of S: a KV head's g = hq // hk query heads share its rows, 128 //
    g queries a tile."""
    return b * hk * -(-t // (SM90_ROWS // (hq // hk)))


def sm90_plan(b: int, t: int, s: int, hq: int, hk: int, d: int, sms: int):
    """(n_split, keys per split) of the sm90 kernel: as many splits of S as
    fit in one wave of one block per SM (`sms` SMs), none below
    SM90_MIN_SPLIT_KEYS keys, each split a whole number of key tiles. The
    9B's T2V cross attention (16 blocks) splits 8 ways on 132 SMs."""
    n_split = max(1, min(sms // sm90_blocks(b, t, hq, hk), s // SM90_MIN_SPLIT_KEYS))
    tile = SM90_KEY_TILE[head_width(d)]
    kv_split = -(-(-(-s // n_split)) // tile) * tile
    return -(-s // kv_split), kv_split


def packed_rows(t: int, g: int, tile: int) -> tuple:
    """The rows of a kernel that packs a group's g query heads into row
    tiles of `tile` rows: tile x holds queries x * (tile // g) onwards, row r
    query x * (tile // g) + r // g of head r % g. -> (rows [tiles, tile, 2]
    of (t, head offset), stored [tiles, tile] bool): a row is stored iff its
    t < T and it is not one of the tile % g rows left over past the
    tile's queries (those compute the next tile's first query again)."""
    per = tile // g
    r = torch.arange(tile)
    tiles = torch.arange(-(-t // per))[:, None]
    rows = torch.stack((tiles * per + r // g, (r % g).expand(tiles.shape[0], -1)), dim=-1)
    return rows, (rows[..., 0] < t) & (r < per * g)


def sm90_rows(t: int, hq: int, hk: int) -> torch.Tensor:
    """[tiles, 128, 2] (t, query head offset within the KV head's group) of
    each row of each query tile, as the sm90 kernel reads them: row r of
    tile x is query x * (128 // g) + r // g of head r % g (g = hq // hk).
    Rows with t >= T and the 128 % g rows left over are computed and not
    stored (`sm90_stored`)."""
    return packed_rows(t, hq // hk, SM90_ROWS)[0]


def sm90_stored(t: int, hq: int, hk: int) -> torch.Tensor:
    """[tiles, 128] bool: which rows of `sm90_rows` the kernel stores."""
    return packed_rows(t, hq // hk, SM90_ROWS)[1]


def segments_meet(q_ids, k_ids, k_ok) -> bool:
    """The kernels' segment test of one (row block, key tile) pair: the
    [min, max] ranges of the nonzero ids of the rows (`q_ids`) and of the
    keys that `k_ok` admits (in range, kv_mask set) meet, as the Pallas
    kernel's `_seg_overlap` tests them, or both hold padding (id 0), which
    the mask lets see each other. Where kv_mask hides the padding, as it
    does for packed rows, this is `_seg_overlap` exactly."""
    k_ids = k_ids[k_ok]
    qn, kn = q_ids[q_ids != 0], k_ids[k_ids != 0]
    if len(qn) and len(kn) and kn.min() <= qn.max() and qn.min() <= kn.max():
        return True
    return bool((q_ids == 0).any() and (k_ids == 0).any())


def sm90_fwd_tiles(b, t, s, hq, hk, d, sms, causal, window, kv_mask=None,
                   q_segs=None, kv_segs=None):
    """The key tiles the sm90 kernel computes, by its walk: blocks of
    128 packed rows (`sm90_rows`), S split by `sm90_plan` on `sms` SMs into
    ranges of whole tiles (SM90_KEY_TILE keys), each block's range clipped
    to the causal / window band of its rows, and, with segment ids, a tile
    skipped unless `segments_meet`.
    -> [(batch, KV head, split, first t, end t, first key, end key)]."""
    rows_t, keys = SM90_ROWS // (hq // hk), SM90_KEY_TILE[head_width(d)]
    n_split, kv_split = sm90_plan(b, t, s, hq, hk, d, sms)
    ok = (torch.ones((b, s), dtype=torch.bool) if kv_mask is None
          else (kv_mask != 0).cpu())
    if q_segs is not None:
        q_segs, kv_segs = q_segs.cpu(), kv_segs.cpu()
    live = []
    for bi in range(b):
        for t0 in range(0, t, rows_t):
            t1 = min(t, t0 + rows_t)
            for split in range(n_split):
                begin, end = split * kv_split, min(s, (split + 1) * kv_split)
                if causal:
                    end = min(end, t, t0 + rows_t)
                if window:
                    begin = max(begin, t0 - window + 1)
                for s0 in range(begin, end, keys):
                    s1 = min(s0 + keys, end)
                    if q_segs is None or segments_meet(q_segs[bi, t0:t1], kv_segs[bi, s0:s1],
                                                       ok[bi, s0:s1]):
                        live += [(bi, h, split, t0, t1, s0, s1) for h in range(hk)]
    return live


def tma_strides(name: str, shape, strides, ptr: int, elem_size: int) -> tuple:
    """The element strides a TMA tensor map is given for an operand of
    `shape` / `strides` at address `ptr`: raises unless its last dim is
    contiguous and its start and every stride of a dim longer than one are
    multiples of 16 bytes. A dim of length one is never stepped along, so it
    gets the stride of a contiguous tensor."""
    if strides[-1] != 1:
        raise ValueError(f"{name}: last dim not contiguous (strides {tuple(strides)})")
    if ptr % TMA_ALIGN:
        raise ValueError(f"{name}: data pointer {ptr:#x} not {TMA_ALIGN}-byte aligned")
    out = list(strides)
    for i in range(len(shape) - 2, -1, -1):
        if shape[i] == 1:
            out[i] = out[i + 1] * shape[i + 1]
        if out[i] * elem_size % TMA_ALIGN:
            raise ValueError(f"{name}: stride {strides[i]} of dim {i} is not a "
                             f"multiple of {TMA_ALIGN} bytes (shape {tuple(shape)})")
    return tuple(out)


def int32_rows(x, shape, device, name: str):
    """A [B,T] / [B,S] mask or segment-id tensor as the contiguous int32
    rows the kernels read (None stays None)."""
    if x is None:
        return None
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected {shape}, got {tuple(x.shape)}")
    return x.to(device=device, dtype=torch.int32).contiguous()


def mask_bytes(kv_mask, shape, device, name: str):
    """A [B,S] kv_mask as the contiguous bool bytes the forward kernels read
    (None stays None); a contiguous bool mask on the device passes as it is,
    with no copy or launch."""
    if kv_mask is None:
        return None
    if tuple(kv_mask.shape) != shape:
        raise ValueError(f"{name}: kv_mask expected {shape}, got {tuple(kv_mask.shape)}")
    if kv_mask.dtype != torch.bool:
        kv_mask = kv_mask != 0
    return kv_mask.to(device).contiguous()


def check_qkv(q, k, v, window, name: str):
    """Raise unless q/k/v and the window are what K1 and K4 take: shapes
    that agree, a head dim that is a multiple of HEAD_ALIGN (the wrappers
    pad any other first) up to MAX_HEAD_DIM."""
    for label, x in (("q", q), ("k", k), ("v", v)):
        _lib.check_operand(x, f"{name} {label}", 4, q.dtype)
    b, t, hq, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    if k.shape != (b, s, hk, d) or v.shape != k.shape or hq % hk:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    head_width(d, name=name)
    if d % HEAD_ALIGN:
        raise ValueError(f"{name}: head dim {d} is no multiple of {HEAD_ALIGN}")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive, got {window}")


def _launch(q, k, v, kv_mask, sm_scale, causal, window, softcap, q_segs,
            kv_segs):
    global launches, pad_copies
    d = q.shape[-1]
    if d % HEAD_ALIGN:  # rows TMA cannot address: one zero-padded copy each
        q, k, v = padded_heads("flash_attention", q, k, v)
        pad_copies += 3
        out, lse = _launch(q, k, v, kv_mask, sm_scale, causal, window, softcap, q_segs,
                           kv_segs)
        return out[..., :d], lse
    check_qkv(q, k, v, window, "flash_attention")
    b, t, hq, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16 and hq // hk > SM90_ROWS:  # one call a slice of heads
        parts = [_launch(q[:, :, h0:h1], k[:, :, h:h + 1], v[:, :, h:h + 1], kv_mask,
                         sm_scale, causal, window, softcap, q_segs, kv_segs)
                 for h, h0, h1 in group_slices(hq, hk, SM90_ROWS)]
        return torch.cat([o for o, _ in parts], 2), torch.cat([lse for _, lse in parts], 1)
    w = head_width(d)

    mask = mask_bytes(kv_mask, (b, s), q.device, "flash_attention")
    qs = int32_rows(q_segs, (b, t), q.device, "flash_attention")
    ks = int32_rows(kv_segs, (b, s), q.device, "flash_attention")
    entry = route(q.dtype)
    out = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    strides = [x.stride()[:3] for x in (q, k, v)]
    if q.dtype == torch.bfloat16:
        strides = [tma_strides(f"flash_attention {label}", x.shape, x.stride(),
                               x.data_ptr(), x.element_size())[:3]
                   for label, x in (("q", q), ("k", k), ("v", v))]
        n_split, kv_split = sm90_plan(b, t, s, hq, hk, d, _lib.sm_count(q.device))
        if qs is not None and -(-min(kv_split, s) // SM90_KEY_TILE[w]) > SM90_LIVE_TILES:
            raise ValueError(f"flash_attention: {min(kv_split, s)} keys a block with segment "
                             f"ids exceed the kernel's {SM90_LIVE_TILES} live-tile marks")
    else:
        n_split, kv_split = _kv_split(b, t, s, hq, q.device)
    part = [None, None, None]
    if n_split > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        part = [torch.empty((b, hq, t, n_split), **f32),
                torch.empty((b, hq, t, n_split), **f32),
                torch.empty((b, hq, t, n_split, w), **f32)]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = _lib.library()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(mask), ptr(qs), ptr(ks),
            out.data_ptr(), lse.data_ptr(), b, t, s, hq, hk, w, d,
            *strides[0], *strides[1], *strides[2],
            float(sm_scale), int(causal), int(window or 0), float(softcap or 0.0),
            n_split, kv_split, *map(ptr, part),
            torch.cuda.current_stream(q.device).cuda_stream)
    _lib.check(err, "flash_attention")
    launches += 1
    return out, lse
