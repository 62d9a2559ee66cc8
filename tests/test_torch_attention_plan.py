"""The host side of K1 / K2's bf16 kernel (csrc/flash_forward_sm90.cuh),
which runs without a card: the split plan of S, the GQA-packed row map,
the routing by dtype, the TMA alignment check, and K4's own split plan,
which must stay as it was when K1's changed.

Shapes: Vidi1.5-9B's text side (16 query / 8 KV heads of 256; a 128-row
prompt, 23,520 image keys, 1,200 audio keys; training batches of 256 rows),
the 1.5B configuration (12 / 6 heads of 128), Vidi-7B's Mistral (32 / 8
heads of 128: G = 4; 7,680 image keys) and CLIP ViT-L/14 (257 tokens, 16
heads of 64), SigLIP-so400m (4 frames of
729 tokens, 16 heads of 72) and Whisper-large-v3 (1,500 tokens, 20 heads of
64), on an H100's 132 SMs.
"""
import pytest
import torch

from vidi_tpu_torch.ops.cuda import flash_attention as k1
from vidi_tpu_torch.ops.cuda import tower_attention as k2

SMS = 132  # H100 SXM
# (name, b, t, s, hq, hk, d)
SHAPES = [
    ("9b t2v", 1, 128, 23520, 16, 8, 256),
    ("9b t2a", 1, 128, 1200, 16, 8, 256),
    ("9b t2t", 1, 128, 128, 16, 8, 256),
    ("9b train t2v", 1, 256, 23520, 16, 8, 256),
    ("1.5b t2v", 1, 128, 23520, 12, 6, 128),
    ("7b t2v", 1, 128, 7680, 32, 8, 128),
    ("7b t2a", 1, 128, 1200, 32, 8, 128),
    ("7b t2t", 1, 128, 128, 32, 8, 128),
    ("clip", 8, 257, 257, 16, 16, 64),
    ("siglip", 4, 729, 729, 16, 16, 72),
    ("whisper", 1, 1500, 1500, 20, 20, 64),
]


@pytest.mark.parametrize("name,b,t,s,hq,hk,d", SHAPES, ids=[x[0] for x in SHAPES])
def test_plan_covers_keys_once_and_fills_one_wave(name, b, t, s, hq, hk, d):
    n_split, kv_split = k1.sm90_plan(b, t, s, hq, hk, d, SMS)
    covered = torch.zeros(s, dtype=torch.int64)
    for i in range(n_split):
        lo, hi = i * kv_split, min(s, (i + 1) * kv_split)
        assert lo < hi  # no empty split
        covered[lo:hi] += 1
    assert bool((covered == 1).all())
    if n_split > 1:
        assert kv_split % k1.SM90_KEY_TILE[d] == 0
        assert kv_split >= k1.SM90_MIN_SPLIT_KEYS
    blocks = k1.sm90_blocks(b, t, hq, hk)
    assert blocks * n_split <= max(SMS, blocks)  # one wave of one block per SM
    # the blocks reach the SMs: one more split would not fit in the wave,
    # unless S is too short to split further
    limited = n_split >= s // k1.SM90_MIN_SPLIT_KEYS
    assert blocks * (n_split + 1) > SMS or limited


def test_plan_values_at_the_slice_shapes():
    assert k1.sm90_plan(1, 128, 23520, 16, 8, 256, SMS) == (8, 2944)  # 16 blocks x 8
    assert k1.sm90_plan(1, 128, 1200, 16, 8, 256, SMS) == (4, 320)
    assert k1.sm90_plan(1, 128, 128, 16, 8, 256, SMS) == (1, 128)
    assert k1.sm90_blocks(4, 729, 16, 16) == 384  # SigLIP: no split needed
    assert k1.sm90_blocks(1, 1500, 20, 20) == 240  # Whisper


@pytest.mark.parametrize("t,hq,hk", [(128, 16, 8), (256, 16, 8), (128, 12, 6),
                                     (37, 8, 1), (729, 16, 16), (1500, 20, 20),
                                     (128, 32, 8), (37, 32, 8), (257, 16, 16)])
def test_gqa_row_map_is_a_bijection(t, hq, hk):
    """Every (t, query head of the KV head's group) is computed by exactly
    one row of one tile; rows past T are the tile's padding."""
    g = hq // hk
    rows = k1.sm90_rows(t, hq, hk).reshape(-1, 2)
    live = rows[rows[:, 0] < t]
    assert len(rows) - len(live) < k1.SM90_ROWS  # padding only in the last tile
    keys = live[:, 0] * g + live[:, 1]
    assert torch.equal(keys.sort().values, torch.arange(t * g))
    assert bool(((live[:, 1] >= 0) & (live[:, 1] < g)).all())


def test_gqa_group_must_divide_the_tile():
    """A group that does not divide the 128-row tile (g = 3) needs not: a
    tile packs 42 queries, its 2 rows left over are computed and never
    stored, and every (t, head) is stored by exactly one row."""
    t, hq, hk = 128, 24, 8
    rows, stored = k1.sm90_rows(t, hq, hk), k1.sm90_stored(t, hq, hk)
    live = rows[stored]
    assert torch.equal((live[:, 0] * 3 + live[:, 1]).sort().values, torch.arange(t * 3))
    assert not stored[:, 126:].any() and bool(stored[:-1, :126].all())


@pytest.mark.parametrize("module,sm90,simt", [
    (k1, "vidi_flash_attention_fwd_sm90", "vidi_flash_attention_fwd"),
    (k2, "vidi_tower_attention_sm90", "vidi_tower_attention"),
], ids=["K1", "K2"])
def test_route_by_dtype(module, sm90, simt):
    assert module.route(torch.bfloat16) == sm90
    assert module.route(torch.float32) == simt
    with pytest.raises(TypeError):
        module.route(torch.float16)


def _view_cases():
    """The operands the slices give the kernels, as views."""
    siglip = torch.empty(4, 729, 1152, dtype=torch.bfloat16)      # one projection
    fused = torch.empty(4, 729, 3 * 1152, dtype=torch.bfloat16)   # q | k | v side by side
    kv = torch.empty(1, 23520, 8 * 256, dtype=torch.bfloat16)     # split_heads input
    whisper = torch.empty(1, 1500, 1280, dtype=torch.bfloat16)
    cache = torch.empty(2, 1, 8, 23520, 256, dtype=torch.bfloat16)  # [L,B,Hk,S,D]
    return {
        "siglip heads at 144-byte offsets": siglip.reshape(4, 729, 16, 72),
        "siglip k from a fused projection": fused[..., 1152:2304].reshape(4, 729, 16, 72),
        "9b split_heads k/v, stride Hk*D": kv.reshape(1, 23520, 8, 256),
        "whisper heads": whisper.reshape(1, 1500, 20, 64),
        "a cache layer read through a transpose": cache[1].transpose(1, 2),
    }


@pytest.mark.parametrize("name", list(_view_cases()))
def test_alignment_passes_the_slice_views(name):
    x = _view_cases()[name]
    strides = k1.tma_strides(name, x.shape, x.stride(), x.data_ptr(), x.element_size())
    assert all(got == want for got, want, n in zip(strides, x.stride(), x.shape) if n > 1)


def test_alignment_gives_length_one_dims_a_contiguous_stride():
    # batch 1 with an odd stride: never stepped along, so not held against it
    assert k1.tma_strides("x", (1, 729, 16, 72), (3, 1152, 72, 1), 4096, 2) == \
        (729 * 1152, 1152, 72, 1)


@pytest.mark.parametrize("offset", [1, 2, 4, 7, 12])
def test_alignment_raises_on_a_misaligned_pointer(offset):
    x = torch.empty(2, 729, 16 * 72 + 16, dtype=torch.bfloat16)
    view = x[..., offset:offset + 1152].reshape(2, 729, 16, 72)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        k1.tma_strides("q", view.shape, view.stride(), view.data_ptr(),
                       view.element_size())
    aligned = x[..., 8:8 + 1152].reshape(2, 729, 16, 72)  # 8 elements: 16 bytes
    k1.tma_strides("q", aligned.shape, aligned.stride(), aligned.data_ptr(), 2)


@pytest.mark.parametrize("dim,stride", [(0, 729 * 1152 + 4), (1, 1156), (2, 76)])
def test_alignment_raises_on_a_misaligned_stride(dim, stride):
    strides = [729 * 1152, 1152, 72, 1]
    strides[dim] = stride
    with pytest.raises(ValueError, match="not a multiple of 16 bytes"):
        k1.tma_strides("k", (2, 729, 16, 72), tuple(strides), 4096, 2)


def test_alignment_raises_on_a_strided_last_dim():
    with pytest.raises(ValueError, match="last dim"):
        k1.tma_strides("v", (1, 8, 2, 64), (1024, 128, 1, 2), 4096, 2)


class _Props:
    multi_processor_count = SMS


# K4's split plan (`_kv_split`, shared with the SIMT forward) at the
# training and serving shapes, the values K4 is built and measured with:
# b, t, s, hq -> (n_split, kv_split)
K4_PLANS = [
    ((1, 256, 256, 16), (1, 256)),      # training T2T
    ((1, 256, 23520, 16), (3, 7872)),   # training T2V
    ((1, 256, 1200, 16), (2, 640)),     # training T2A
    ((1, 128, 23520, 16), (5, 4736)),   # serving T2V (the SIMT forward's fp32 route)
    ((1, 128, 1200, 16), (2, 640)),
    ((1, 256, 23520, 12), (3, 7872)),   # the 1.5B configuration
]


@pytest.mark.parametrize("args,want", K4_PLANS, ids=[str(a) for a, _ in K4_PLANS])
def test_k4_split_plan_unchanged(monkeypatch, args, want):
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    assert k1._kv_split(*args, torch.device("cuda", 0)) == want
