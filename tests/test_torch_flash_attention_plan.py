"""K1's segment tile skip, on the CPU: the key tiles the bf16 kernel's walk
computes (`sm90_fwd_tiles`, the mirror of csrc/flash_forward_sm90.cuh)
against the Pallas kernel's own rule, `vidi_tpu.ops.pallas.flash_attention.
_seg_overlap` (a plain jnp function), and the plain version with every pair
outside the computed tiles masked against the plain version itself.

Packings are drawn with hypothesis (seeded, no example database): 1-6
segments of random lengths and a padding tail, B = 1-2, G = Hq / Hk in
{1, 2, 4}, D in {128, 256} (64 or 128 keys a tile), causal with and
without a sliding window. The skip must remove only pairs the mask already
hides, so the masked plain version is compared bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_init  # noqa: F401  (one intra-op thread)
from vidi_tpu.ops.pallas.flash_attention import _seg_overlap
from vidi_tpu_torch.ops.cuda import flash_attention as k1

SMS = 132  # H100 SXM
SETTINGS = settings(max_examples=25, deadline=None, derandomize=True, database=None)


@st.composite
def packings(draw):
    """(b, t, g, d, window, segment ids [b, t] int32 with 0 = padding)."""
    b = draw(st.integers(1, 2))
    t = draw(st.integers(40, 700))
    g = draw(st.sampled_from([1, 2, 3, 4, 6]))
    d = draw(st.sampled_from([16, 96, 128, 256]))
    window = draw(st.sampled_from([None, 4096, 100, 300]))
    segs = np.zeros((b, t), np.int32)
    for bi in range(b):
        n = draw(st.integers(1, 6))
        pad = draw(st.integers(0, t // 4))
        cuts = sorted(draw(st.lists(st.integers(1, t - pad - 1), min_size=n - 1,
                                    max_size=n - 1, unique=True))) if t - pad > n else []
        edges = [0, *cuts, t - pad]
        for i in range(len(edges) - 1):
            segs[bi, edges[i]:edges[i + 1]] = i + 1
    return b, t, g, d, window, torch.from_numpy(segs)


def _jax_live(segs, band):
    """The band tiles (bi, t0, t1, s0, s1) for which the Pallas kernel's
    `_seg_overlap` holds on the tile's row and key ids."""
    out = set()
    for bi, t0, t1, s0, s1 in band:
        q = jnp.asarray(segs[bi, t0:t1].numpy())[:, None]
        k = jnp.asarray(segs[bi, s0:s1].numpy())[None, :]
        if bool(_seg_overlap(q, k)):
            out.add((bi, t0, t1, s0, s1))
    return out


def _tiles(tiles):
    return {(x[0], x[3], x[4], x[5], x[6]) for x in tiles}


@SETTINGS
@given(packings())
def test_fwd_tiles_keep_the_tiles_of_jax_seg_overlap(case):
    """With kv_mask hiding the padding, as packed rows have it
    (`pack_rows`' text_mask), the walk computes exactly the band tiles
    for which `_seg_overlap` holds; without a kv_mask it also keeps the
    tiles where padding rows meet padding keys, which the mask shows."""
    b, t, g, d, window, segs = case
    hk = 2
    walk = dict(b=b, t=t, s=t, hq=g * hk, hk=hk, d=d, sms=SMS, causal=True, window=window)
    band = _tiles(k1.sm90_fwd_tiles(**walk))
    jax_live = _jax_live(segs, band)
    live = k1.sm90_fwd_tiles(**walk, kv_mask=segs != 0, q_segs=segs, kv_segs=segs)
    assert len(live) == hk * len(_tiles(live))  # every KV head walks the same tiles
    assert _tiles(live) == jax_live
    unmasked = _tiles(k1.sm90_fwd_tiles(**walk, q_segs=segs, kv_segs=segs))
    pads = {x for x in band
            if (segs[x[0], x[1]:x[2]] == 0).any() and (segs[x[0], x[3]:x[4]] == 0).any()}
    assert unmasked == jax_live | pads


def _live_pairs(shape, tiles):
    """[B, T, S] bool: the (row, key) pairs inside the given tiles."""
    out = torch.zeros(shape, dtype=torch.bool)
    for bi, t0, t1, s0, s1 in tiles:
        out[bi, t0:t1, s0:s1] = True
    return out


def _simt_tiles(b, t, window, kv_mask, segs):
    """The fp32 SIMT route's computed tiles (16 rows of one head, 64 keys;
    csrc/attention_common.cuh): its band, then `segments_meet`."""
    ok = torch.ones((b, t), dtype=torch.bool) if kv_mask is None else kv_mask
    out = set()
    for bi in range(b):
        for t0 in range(0, t, k1.Q_TILE):
            t1 = min(t, t0 + k1.Q_TILE)
            begin = 0 if window is None else max(0, t0 - window + 1)
            for s0 in range(begin, t1, k1.KV_TILE):
                s1 = min(s0 + k1.KV_TILE, t1)
                if k1.segments_meet(segs[bi, t0:t1], segs[bi, s0:s1], ok[bi, s0:s1]):
                    out.add((bi, t0, t1, s0, s1))
    return out


@SETTINGS
@given(packings(), st.sampled_from(["none", "pads", "random"]))
def test_skipped_tiles_hold_only_hidden_pairs(case, mask_kind):
    """The plain version with every pair outside the computed tiles masked
    equals the plain version bit for bit, for the bf16 walk and the fp32
    route's tiles, with no kv_mask, the padding masked, or random keys
    masked."""
    b, t, g, d, window, segs = case
    hk = 2
    rng = np.random.default_rng(t)
    kv_mask = {"none": None, "pads": segs != 0,
               "random": torch.from_numpy(rng.random((b, t)) < 0.8)}[mask_kind]
    dh = 16  # the rule does not read the head dim's values; small for speed
    q = torch.from_numpy(rng.standard_normal((b, t, g * hk, dh)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, t, hk, dh)).astype(np.float32))
            for _ in range(2))
    args = dict(sm_scale=dh**-0.5, softcap=30.0)
    want = k1.flash_attention_plain(q, k, v, kv_mask, causal=True, window=window,
                                    q_segs=segs, kv_segs=segs, **args)
    vis = k1.visible_mask(b, t, t, kv_mask, True, window, segs, segs, "cpu")
    sm90 = k1.sm90_fwd_tiles(b, t, t, g * hk, hk, d, SMS, True, window, kv_mask, segs, segs)
    for tiles in (_tiles(sm90), _simt_tiles(b, t, window, kv_mask, segs)):
        got = k1.attention_with_mask(q, k, v, vis & _live_pairs((b, t, t), tiles), **args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_packed_9b_row_computes_745_of_2080_tiles():
    """The 9B's packed row (T = 4,096; segments of 1,500 / 1,400 / 1,100
    tokens and 96 of padding; 16 / 8 heads of 256: 64 t a block, 64 keys a
    tile; causal, window 4096): 745 of the band's 2,080 tiles a KV head."""
    segs = torch.zeros((1, 4096), dtype=torch.int32)
    segs[0, :1500], segs[0, 1500:2900], segs[0, 2900:4000] = 1, 2, 3
    walk = dict(b=1, t=4096, s=4096, hq=16, hk=8, d=256, sms=SMS, causal=True, window=4096)
    band = k1.sm90_fwd_tiles(**walk)
    live = k1.sm90_fwd_tiles(**walk, kv_mask=segs != 0, q_segs=segs, kv_segs=segs)
    assert (len(band) // 8, len(live) // 8) == (2080, 745)
    assert _tiles(live) == _jax_live(segs, _tiles(band))


@pytest.mark.parametrize("q_ids,k_ids,k_ok,want", [
    ([1, 1, 2], [2, 3], [True, True], True),     # ranges [1, 2] and [2, 3] meet
    ([1, 1], [2, 3], [True, True], False),
    ([2, 2], [1, 3], [True, True], True),        # ranges meet, no shared id
    ([1, 0], [0, 0], [True, True], True),        # padding meets padding
    ([1, 0], [0, 0], [False, False], False),     # ... unless kv_mask hides it
    ([3, 3], [3, 0], [False, True], False),      # a masked key's id does not count
    ([0, 0], [1, 2], [True, True], False),
])
def test_segments_meet(q_ids, k_ids, k_ok, want):
    assert k1.segments_meet(torch.tensor(q_ids), torch.tensor(k_ids),
                            torch.tensor(k_ok)) is want
