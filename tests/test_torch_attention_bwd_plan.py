"""The host side of K4's bf16 route (csrc/flash_backward_sm90.cuh), which
runs without a card: the routing by dtype, the TMA alignment check on the
backward's operands, the dq kernel's split plan, the packed-row map the
dk / dv kernel gathers lse and di by, and the tile-skip rules of both
kernels (`sm90_bwd_dq_tiles`, `sm90_bwd_dkv_tiles` mirror the kernels),
checked against `visible_mask`.

Shapes: the training slice of Vidi1.5-9B (256 text rows, 16 query / 8 KV
heads of 256; 23,520 image keys, 1,200 audio keys) and the 1.5B
configuration (12 / 6 heads of 128), on an H100's 132 SMs; small shapes for
the tile rules.
"""
import numpy as np
import pytest
import torch

from vidi_tpu_torch.ops.cuda import flash_attention as k1
from vidi_tpu_torch.ops.cuda import flash_attention_bwd as k4

SMS = 132  # H100 SXM
# (name, b, t, s, hq, hk, d, n_split on 132 SMs)
PLANS = [
    ("9b train t2v", 1, 256, 23520, 16, 8, 256, 4),
    ("9b train t2a", 1, 256, 1200, 16, 8, 256, 4),
    ("9b train t2t", 1, 256, 256, 16, 8, 256, 1),
    ("1.5b train t2v", 1, 256, 23520, 12, 6, 128, 5),
    ("9b serve t2v", 1, 128, 23520, 16, 8, 256, 8),
    ("two samples t2a", 2, 256, 1200, 16, 8, 256, 2),
]


def test_route_by_dtype():
    assert k4.route(torch.bfloat16) == "vidi_flash_attention_bwd_sm90"
    assert k4.route(torch.float32) == "vidi_flash_attention_bwd"
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(TypeError):
            k4.route(dtype)


def _operands(t=256, s=1200, hq=16, hk=8, d=256):
    """q, k, v, dO as the training slice hands them: q from a fused
    projection, k / v views of [B,S,Hk*D] projections, dO contiguous."""
    qkv = torch.empty(1, t, (hq + 2 * hk) * d, dtype=torch.bfloat16)
    kv = torch.empty(1, s, 2 * hk * d, dtype=torch.bfloat16)
    return (qkv[..., :hq * d].reshape(1, t, hq, d), kv[..., :hk * d].reshape(1, s, hk, d),
            kv[..., hk * d:].reshape(1, s, hk, d), torch.empty(1, t, hq, d, dtype=torch.bfloat16))


def test_alignment_passes_the_slice_operands():
    q, k, v, do = _operands()
    strides = k4.tma_operand_strides(q, k, v, do)
    assert strides == [q.stride()[:3], k.stride()[:3], v.stride()[:3], do.stride()[:3]]


@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
@pytest.mark.parametrize("offset", [1, 4])
def test_alignment_raises_on_a_misaligned_operand(which, offset):
    ops = dict(zip(("q", "k", "v", "do"), _operands()))
    x = ops[which]
    buf = torch.empty(x.numel() + offset, dtype=x.dtype)
    ops[which] = buf[offset:].reshape(x.shape)  # starts 2 * offset bytes off 16
    with pytest.raises(ValueError, match=f"flash_attention_bwd {which}: data pointer"):
        k4.tma_operand_strides(*ops.values())


@pytest.mark.parametrize("which", ["q", "k", "do"])
def test_alignment_raises_on_a_misaligned_stride(which):
    ops = dict(zip(("q", "k", "v", "do"), _operands()))
    x = ops[which]
    wide = torch.empty(*x.shape[:-2], x.shape[-2] * x.shape[-1] + 4, dtype=x.dtype)
    ops[which] = wide[..., :x.shape[-2] * x.shape[-1]].reshape(x.shape)  # row stride + 8 bytes
    with pytest.raises(ValueError, match="not a multiple of 16 bytes"):
        k4.tma_operand_strides(*ops.values())


@pytest.mark.parametrize("name,b,t,s,hq,hk,d,want", PLANS, ids=[p[0] for p in PLANS])
def test_split_plan_fills_one_wave(name, b, t, s, hq, hk, d, want):
    n_split = k4.sm90_bwd_plan(b, t, s, hq, hk, SMS)
    assert n_split == want
    blocks = k1.sm90_blocks(b, t, hq, hk)
    assert blocks * n_split <= max(SMS, blocks)  # one wave of one block per SM
    limited = n_split >= s // k1.SM90_MIN_SPLIT_KEYS
    assert blocks * (n_split + 1) > SMS or limited  # and no room for one more split


@pytest.mark.parametrize("name,b,t,s,hq,hk,d,want", PLANS[:4], ids=[p[0] for p in PLANS[:4]])
def test_split_plan_covers_each_key_once(name, b, t, s, hq, hk, d, want):
    """Split i takes the key tiles i, i + n_split, ... of each block's range:
    over the splits every key of the range is taken once, and the splits'
    tile counts differ by at most one."""
    tiles = k4.sm90_bwd_dq_tiles(b, t, s, hq, hk, d, want, False, None)
    for t0 in range(0, t, k1.SM90_ROWS // (hq // hk)):
        mine = [x for x in tiles if x[1] == 0 and x[3] == t0]
        covered = torch.zeros(s, dtype=torch.int64)
        for x in mine:
            covered[x[5]:x[6]] += 1
        assert bool((covered == 1).all())
        counts = np.bincount([x[2] for x in mine], minlength=want)
        assert counts.max() - counts.min() <= 1


@pytest.mark.parametrize("t,hq,hk", [(256, 16, 8), (256, 12, 6), (37, 8, 1), (100, 4, 4),
                                     (50, 8, 2)])
def test_dkv_packed_row_map_is_a_bijection(t, hq, hk):
    """Every (t, query head of the KV head's group) is one packed row of one
    streamed tile; rows past T are the last tile's padding."""
    g = hq // hk
    rows = k4.dkv_rows(t, hq, hk).reshape(-1, 2)
    live = rows[rows[:, 0] < t]
    assert len(rows) - len(live) < k4.SM90_BWD_KV_ROWS
    assert torch.equal((live[:, 0] * g + live[:, 1]).sort().values, torch.arange(t * g))


def test_dkv_group_must_divide_the_tile():
    """A group that does not divide the 64-row tile (g = 3) needs not: a
    streamed tile packs 21 queries, its row left over carries no gradient,
    and every (t, head) is one packed row of one tile."""
    t, hq, hk = 64, 24, 8
    rows, stored = k4.dkv_rows(t, hq, hk), k4.dkv_stored(t, hq, hk)
    live = rows[stored]
    assert torch.equal((live[:, 0] * 3 + live[:, 1]).sort().values, torch.arange(t * 3))
    assert not stored[:, 63:].any() and bool(stored[:-1, :63].all())


def _segs(b, n, cuts, seed):
    """[b, n] int32 segment ids: contiguous runs split at `cuts`, 0 = pad
    after the last run."""
    out = torch.zeros((b, n), dtype=torch.int32)
    for bi in range(b):
        edges = [0, *cuts, n - 5 - 3 * bi]
        for i in range(len(edges) - 1):
            out[bi, edges[i]:edges[i + 1]] = i + 1 + seed
    return out


# (name, b, t, s, d, causal, window, masked tail, segments)
SKIPS = [
    ("causal", 1, 200, 200, 256, True, None, 0, False),
    ("causal window 48", 1, 200, 200, 256, True, 48, 0, False),
    ("causal window 48 d128", 1, 200, 200, 128, True, 48, 0, False),
    ("cross, masked tail", 1, 70, 700, 256, False, None, 230, False),
    ("cross, masked tail d128", 2, 70, 700, 128, False, None, 150, False),
    ("packed, 3 segments", 2, 200, 200, 256, True, None, 0, True),
    ("packed window 64", 1, 200, 200, 128, True, 64, 0, True),
]


def _covered(shape, tiles, g, time_range):
    """[B, T, Hq, S] bool: the (row, head, key) pairs that live tiles compute."""
    b, t, hq, s = shape
    out = torch.zeros(shape, dtype=torch.bool)
    for x in tiles:
        bi, h, (t0, t1), (s0, s1) = x[0], x[1], time_range(x), (x[-2], x[-1])
        out[bi, t0:t1, h * g:(h + 1) * g, s0:s1] = True
    return out


@pytest.mark.parametrize("name,b,t,s,d,causal,window,tail,segs", SKIPS,
                         ids=[c[0] for c in SKIPS])
def test_tile_skips_leave_out_only_invisible_pairs(name, b, t, s, d, causal, window, tail,
                                                    segs):
    """Both kernels skip tiles (band clipping, all keys masked, segments
    that cannot meet); every pair visible_mask makes visible lies in a tile
    each kernel computes, and the rules do skip something in every case."""
    hq, hk = 8, 4
    g = hq // hk
    kv_mask = torch.ones((b, s), dtype=torch.bool)
    if tail:
        kv_mask[:, s - tail:] = False
    q_segs = kv_segs = None
    if segs:
        q_segs = kv_segs = _segs(b, t, [60, 61, 130], 0)
    vis = k1.visible_mask(b, t, s, kv_mask, causal, window, q_segs, kv_segs, "cpu")
    want = vis[:, :, None, :].expand(b, t, hq, s)
    n_split = k4.sm90_bwd_plan(b, t, s, hq, hk, SMS)
    dq = k4.sm90_bwd_dq_tiles(b, t, s, hq, hk, d, n_split, causal, window, kv_mask,
                              q_segs, kv_segs)
    dkv = k4.sm90_bwd_dkv_tiles(b, t, s, hq, hk, causal, window, kv_mask, q_segs, kv_segs)
    for tiles, time_range in ((dq, lambda x: (x[3], x[4])), (dkv, lambda x: (x[2], x[3]))):
        got = _covered((b, t, hq, s), tiles, g, time_range)
        assert not bool((want & ~got).any()), "a visible pair lies in a skipped tile"
        assert bool((got & ~want).any() or not got.all()) and not bool(got.all())


def test_backward_with_mask_is_the_plain_backward():
    """The plain backward's body with the mask, lse and di handed in (the
    chip checks' planted faults call it so) gives the plain version's
    gradients."""
    rng = np.random.default_rng(0)
    b, t, s, hq, hk, d = 1, 12, 20, 4, 2, 16
    q, do, out = (torch.from_numpy(rng.standard_normal((b, t, hq, d)).astype(np.float32))
                  for _ in range(3))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, hk, d)).astype(np.float32))
            for _ in range(2))
    kv_mask = torch.ones((b, s), dtype=torch.bool)
    kv_mask[:, 15:] = False
    _, lse = k1.flash_attention_plain(q, k, v, kv_mask, 0.25, True, None, 5.0)
    want = k4.flash_attention_bwd_plain(q, k, v, kv_mask, out, lse, do, 0.25, True, None, 5.0)
    mask = k1.visible_mask(b, t, s, kv_mask, True, None, None, None, "cpu")
    di = (out * do).sum(-1).transpose(1, 2)
    got = k4.backward_with_mask(q, k, v, do, lse, di, mask, 0.25, 5.0)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
