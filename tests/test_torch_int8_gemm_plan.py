"""The host side of K6's int8 GEMM (csrc/int8_gemm.cuh), of K5's persistent
one (csrc/int8_gemm_pp.cuh) and of K7, which runs without a card: how a
product is cut into blocks and how the persistent schedule hands tiles to
blocks and consumers, the operand checks, the K-major weight cache and the
towers' K-major storage, K5's fp32 parameters made once a layer, the
exactness that lets the kernel sum a product's k-steps in any order, K7's
routing, and the generated wgmma header.

Shapes: Vidi1.5-9B's W8A8 prefill (the image stream's k / v projection
[23,520 x 3584] . [3584 x 2048], a 735-row update chunk through the folded
o [2048 x 3584], gate / up [3584 x 14336], down [14336 x 3584]),
SigLIP-so400m's layer (2,916 rows, d 1152, ff 4352) and Whisper-large-v3's
(1,500 rows, d 1280, ff 5120).
"""
import gc
import importlib.util
import weakref
from pathlib import Path

import pytest
import torch

from vidi_tpu_torch.infer import quantize as qz
from vidi_tpu_torch.ops.cuda import fused_rmsnorm as k7
from vidi_tpu_torch.ops.cuda import fused_tower_layer as k5
from vidi_tpu_torch.ops.cuda import quant_matmul as k6

ROOT = Path(__file__).resolve().parents[1]
# (name, m, n, k, gated)
SHAPES = [
    ("9b k/v", 23520, 2048, 3584, False),
    ("9b folded o", 735, 3584, 2048, False),
    ("9b down", 735, 3584, 14336, False),
    ("9b gate+up", 735, 14336, 3584, True),
    ("siglip qkv / o", 2916, 1152, 1152, False),
    ("siglip fc1", 2916, 4352, 1152, False),
    ("siglip fc2", 2916, 1152, 4352, False),
    ("whisper qkv / o", 1500, 1280, 1280, False),
    ("whisper fc1", 1500, 5120, 1280, False),
    ("whisper fc2", 1500, 1280, 5120, False),
    ("ragged", 300, 1008, 1200, False),
    ("ragged gated", 300, 1008, 1200, True),
    ("one tile", 40, 32, 64, False),
]


@pytest.mark.parametrize("name,m,n,k,gated", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_covers_every_output_tile_once(name, m, n, k, gated):
    plan = k6.gemm_plan(m, n, k, gated)
    gx, gy = plan.grid
    origins, area = set(), 0
    for bx in range(gx):
        for by in range(gy):
            m0, n0 = plan.origin(bx, by)
            assert (m0, n0) not in origins  # no tile computed twice
            origins.add((m0, n0))
            rows = max(0, min(m, m0 + k6.TILE_M) - m0)
            cols = max(0, min(n, n0 + plan.cols) - n0)
            area += rows * cols  # a block past M or N stores nothing
    assert area == m * n
    inside = [o for o in origins if o[0] < m and o[1] < n]
    assert len(inside) == plan.tiles_m * plan.tiles_n
    # the grid is a whole number of clusters along M, less than one past the tiles
    assert plan.grid_m % k6.CLUSTER_M == 0
    assert 0 <= plan.grid_m - plan.tiles_m < k6.CLUSTER_M
    # blocks are numbered along the dimension with fewer of them first
    assert gx == min(plan.grid_m, plan.tiles_n) or plan.grid_m == plan.tiles_n


@pytest.mark.parametrize("name,m,n,k,gated", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_k_steps_are_whole_and_reach_k(name, m, n, k, gated):
    plan = k6.gemm_plan(m, n, k, gated)
    assert (plan.steps - 1) * k6.TILE_K < k <= plan.steps * k6.TILE_K
    assert plan.cols == (k6.TILE_N // 2 if gated else k6.TILE_N)


def test_plan_values_at_the_slice_shapes():
    kv = k6.gemm_plan(23520, 2048, 3584)
    assert (kv.tiles_m, kv.tiles_n, kv.steps, kv.grid, kv.m_fast) == (184, 8, 28, (8, 184), False)
    gated = k6.gemm_plan(735, 14336, 3584, gated=True)
    assert (gated.tiles_m, gated.tiles_n, gated.grid, gated.m_fast) == (6, 112, (6, 112), True)
    down = k6.gemm_plan(735, 3584, 14336)
    assert (down.tiles_m * down.tiles_n, down.steps) == (84, 112)
    siglip = k6.gemm_plan(2916, 1152, 1152)
    assert (siglip.tiles_m, siglip.grid_m) == (23, 24)  # one block only feeds its cluster


# K5's launches, one tower layer each: (name, rows, d, ff)
TOWERS = [("siglip", 2916, 1152, 4352), ("whisper", 1500, 1280, 5120),
          ("ragged", 300, 1008, 1200)]
PIECES = [(t, piece, sms) for t in TOWERS for piece in ("qkv", "o", "fc1", "fc2")
          for sms in (132, 114, 7)]


@pytest.mark.parametrize("tower,piece,sms", PIECES,
                         ids=[f"{t[0]}-{p}-{s}sm" for t, p, s in PIECES])
def test_tower_plan_covers_every_tile_once_split_between_consumers(tower, piece, sms):
    """Every output tile of every product of the launch is computed once, by
    one consumer of one block; the two consumers of a block take its tiles
    in turn, and together take all of them."""
    _, m, d, ff = tower
    plan = k5.piece_plans(m, d, ff, sms)[piece]
    n = {"qkv": d, "o": d, "fc1": ff, "fc2": d}[piece]
    assert (plan.m, plan.n, plan.n_mats) == (m, n, 3 if piece == "qkv" else 1)
    assert plan.blocks == min(sms, plan.total)
    seen, area = set(), {}
    for b in range(plan.blocks):
        mine = plan.block_tiles(b)
        parts = [plan.consumer_tiles(b, c) for c in range(k5.PP_CONSUMERS)]
        assert sorted(t for p in parts for t in p) == sorted(mine)  # the split is exhaustive
        assert all(mine[j] in parts[j % k5.PP_CONSUMERS] for j in range(len(mine)))
        for z, m0, n0 in mine:
            assert (z, m0, n0) not in seen  # no tile computed twice
            seen.add((z, m0, n0))
            assert 0 <= m0 < m and 0 <= n0 < n and 0 <= z < plan.n_mats
            area[z] = area.get(z, 0) + (min(m, m0 + k5.PP_TILE_M) - m0) * \
                (min(n, n0 + k5.PP_TILE_N) - n0)
    assert len(seen) == plan.total
    assert area == {z: m * n for z in range(plan.n_mats)}  # every output value, once
    counts = [len(plan.block_tiles(b)) for b in range(plan.blocks)]
    assert max(counts) - min(counts) <= 1  # the blocks' loads differ by one tile at most


@pytest.mark.parametrize("tower,piece,sms", PIECES[::3],
                         ids=[f"{t[0]}-{p}" for t, p, _ in PIECES[::3]])
def test_tower_plan_k_steps_are_whole_and_reach_k(tower, piece, sms):
    _, m, d, ff = tower
    plan = k5.piece_plans(m, d, ff, sms)[piece]
    k = ff if piece == "fc2" else d
    assert (plan.steps - 1) * k6.TILE_K < k <= plan.steps * k6.TILE_K
    assert k % 16 == 0  # TMA reads whole 16-byte pieces of each row


def test_tower_plan_values_at_the_slice_shapes():
    """SigLIP's and Whisper's launches on 132 SMs: none ragged along N."""
    sig = k5.piece_plans(2916, 1152, 4352)
    assert [(p.tiles_m, p.tiles_n, p.total, p.steps, p.blocks) for p in sig.values()] == [
        (23, 9, 621, 9, 132), (23, 9, 207, 9, 132), (23, 34, 782, 9, 132),
        (23, 9, 207, 34, 132)]
    wh = k5.piece_plans(1500, 1280, 5120)
    assert [(p.tiles_m, p.tiles_n, p.total, p.steps, p.blocks) for p in wh.values()] == [
        (12, 10, 360, 10, 132), (12, 10, 120, 10, 120), (12, 40, 480, 10, 132),
        (12, 10, 120, 40, 120)]


def _tower_layer(d=64, ff=96, k_bias=True, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen)

    lp = {"ln1_scale": 1 + r(d), "ln1_bias": r(d), "ln2_scale": 1 + r(d), "ln2_bias": r(d),
          "q_w": r(d, d), "q_b": r(d), "k_w": r(d, d), "v_w": r(d, d), "v_b": r(d),
          "o_w": r(d, d), "o_b": r(d), "fc1_w": r(d, ff), "fc1_b": r(ff),
          "fc2_w": r(ff, d), "fc2_b": r(d)}
    if k_bias:
        lp["k_b"] = r(d)
    return lp


@pytest.mark.parametrize("key", ["q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w"])
def test_tower_weight_is_its_own_kmajor_form(key, monkeypatch):
    """quantize_tower_layer stores each int8 matrix K-major: kmajor() hands
    back its transpose, the same storage, with no copy and no cache entry;
    the codes and scales are quantize_weight's; the operand check takes it."""
    cache = k6.KMajorCache()
    monkeypatch.setattr(k6, "KMAJOR", cache)
    raw = _tower_layer(seed=1)
    lp = qz.quantize_tower_layer(raw)
    w = lp[key]
    want = qz.quantize_weight(torch.nn.functional.pad(raw[key], (0, 32)) if key == "fc1_w"
                              else torch.nn.functional.pad(raw[key], (0, 0, 0, 32))
                              if key == "fc2_w" else raw[key])
    assert torch.equal(w["qi8"], want["qi8"]) and torch.equal(w["scale"], want["scale"])
    assert not w["qi8"].is_contiguous() and w["qi8"].t().is_contiguous()
    wt = k6.kmajor(w["qi8"])
    assert wt.is_contiguous() and wt.data_ptr() == w["qi8"].data_ptr()
    assert torch.equal(wt, w["qi8"].t())
    assert (cache.misses, cache.hits, len(cache.entries)) == (0, 0, 0)
    with pytest.raises(TypeError):  # the CPU tensor, after the layout passed
        k6.check_int8_weight(w["qi8"], w["scale"].reshape(-1), w["qi8"].shape[0], key,
                             kmajor_stored=True)
    with pytest.raises(TypeError):  # K6's check keeps refusing a transposed view
        k6.check_int8_weight(w["qi8"], w["scale"].reshape(-1), w["qi8"].shape[0], key)


@pytest.mark.parametrize("k_bias", [True, False], ids=["siglip-like", "whisper-like"])
def test_tower_fp32_parameters_made_once_a_layer(k_bias):
    """K5's weights are checked and its fp32 LayerNorm parameters and biases
    made at quantize time, once a piece; they equal the plain versions'
    values (zeros for an absent bias) and are served again on every call; a
    replaced or edited parameter is prepared anew, and a dropped layer
    leaves PREPARED."""
    lp = qz.quantize_tower_layer({k: v.to(torch.bfloat16) if v.dim() == 1 else v
                                  for k, v in _tower_layer(k_bias=k_bias, seed=2).items()})
    assert k5.takes(lp)
    keys = [(id(lp[w]["qi8"]), piece) for w, piece in
            (("q_w", "ln_qkv"), ("o_w", "o_residual"), ("fc1_w", "ln_ffn"))]
    recs = {piece: k5.PREPARED[key][0] for key, piece in
            zip(keys, ("ln_qkv", "o_residual", "ln_ffn"))}
    for piece, rec in recs.items():
        assert k5.prepare(lp, piece) is rec and k5.prepare(lp, piece) is rec  # nothing a call
    assert recs["ln_qkv"].dims == ((64, 64),) * 3
    assert recs["ln_ffn"].dims == ((64, 128), (128, 64))  # ff 96 padded to 128
    f32 = {**recs["ln_qkv"].f32, **recs["o_residual"].f32, **recs["ln_ffn"].f32}
    for k in ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "q_b", "v_b", "o_b",
              "fc1_b", "fc2_b"):
        assert f32[k].dtype == torch.float32 and f32[k].is_contiguous()
        assert torch.equal(f32[k], lp[k].float())
    assert torch.equal(f32["k_b"], lp["k_b"].float() if k_bias else torch.zeros(64))
    for rec, wkey in ((recs["ln_qkv"], "q_w"), (recs["o_residual"], "o_w")):
        assert rec.kmajor[0].data_ptr() == lp[wkey]["qi8"].data_ptr()  # stored K-major
    lp["o_b"] = lp["o_b"] * 2  # replaced
    again = k5.prepare(lp, "o_residual")
    assert again is not recs["o_residual"] and torch.equal(again.f32["o_b"], lp["o_b"].float())
    lp["ln1_scale"].add_(1)  # edited in place
    third = k5.prepare(lp, "ln_qkv")
    assert third is not recs["ln_qkv"]
    assert torch.equal(third.f32["ln1_scale"], lp["ln1_scale"].float())
    assert k5.prepare(lp, "ln_qkv") is third
    lp["v_w"] = dict(lp["v_w"])  # the same codes in a new dict: still the same tensors
    assert k5.prepare(lp, "ln_qkv") is third
    lp["v_w"]["qi8"] = lp["v_w"]["qi8"].clone()  # another tensor: checked anew
    assert k5.prepare(lp, "ln_qkv") is not third
    del lp, recs, f32, again, third, rec
    gc.collect()
    assert not any(key in k5.PREPARED for key in keys)


def test_tower_layer_without_its_bias_or_with_a_bad_weight_is_refused():
    lp = qz.quantize_tower_layer(_tower_layer(seed=3))
    assert not k5.takes({k: v for k, v in lp.items() if k != "o_b"})
    assert k5.takes({k: v for k, v in lp.items() if k != "k_b"})  # Whisper's k: zeros
    bad = dict(lp, o_w={"qi8": lp["o_w"]["qi8"][:, :40], "scale": lp["o_w"]["scale"]})
    with pytest.raises(ValueError):  # N % 16 != 0
        k5.prepare(bad, "o_residual")


def _weight(k, n, dtype=torch.int8):
    return torch.zeros((k, n), dtype=dtype), torch.ones((n,), dtype=torch.float32)


@pytest.mark.parametrize("case,error", [
    ("bf16 codes", TypeError), ("transposed view", TypeError), ("rank 3", TypeError),
    ("wrong k", ValueError), ("n not a multiple of 16", ValueError),
    ("scale of another length", ValueError), ("fp64 scale", ValueError),
    ("cpu weight", TypeError)])
def test_check_int8_weight_raises(case, error):
    w, s = _weight(64, 32)
    if case == "bf16 codes":
        w = w.to(torch.bfloat16)
    elif case == "transposed view":
        w = _weight(32, 64)[0].t()
    elif case == "rank 3":
        w = w[None]
    elif case == "wrong k":
        w = _weight(48, 32)[0]
    elif case == "n not a multiple of 16":
        w, s = _weight(64, 24)
    elif case == "scale of another length":
        s = s[:16]
    elif case == "fp64 scale":
        s = s.double()
    with pytest.raises(error):
        k6.check_int8_weight(w, s, 64, "w")


@pytest.mark.parametrize("case,error", [
    ("fp16", TypeError), ("k not a multiple of 16", ValueError), ("no rows", ValueError),
    ("cpu tensor", TypeError)])
def test_rows_raises(case, error):
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    if case == "fp16":
        x = x.half()
    elif case == "k not a multiple of 16":
        x = x[:, :40]
    elif case == "no rows":
        x = x[:0]
    with pytest.raises(error):
        k6.rows(x, "x")


def test_wrappers_take_the_plain_version_on_the_cpu_only_by_device():
    """A CPU tensor runs the plain version; the launch path raises on it."""
    x = torch.randn(4, 64)
    w, s = torch.randint(-127, 128, (64, 32), dtype=torch.int8), torch.rand(32) + 0.5
    assert torch.equal(k6.quant_matmul(x, w, s), k6.quant_matmul_plain(x, w, s))
    with pytest.raises(TypeError):
        k6._launch_matmul(x, w, s)


def _codes(k, n, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen)


def test_kmajor_cache_hit_returns_the_same_copy():
    cache = k6.KMajorCache()
    w = _codes(48, 32, 0)
    first = cache.get(w)
    assert torch.equal(first, w.t()) and first.is_contiguous()
    assert cache.get(w) is first
    assert (cache.hits, cache.misses, cache.bytes) == (1, 1, w.numel())


def test_kmajor_cache_misses_after_an_in_place_edit():
    cache = k6.KMajorCache()
    w = _codes(48, 32, 1)
    stale = cache.get(w)
    w.neg_()
    fresh = cache.get(w)
    assert fresh is not stale and torch.equal(fresh, w.t())
    assert (cache.hits, cache.misses, cache.bytes) == (0, 2, w.numel())


def test_kmajor_cache_holds_its_weight_so_its_memory_is_not_reused():
    """The cache holds its weights weakly: a freed weight's entry goes with
    it, so a tensor that takes its memory (or its id) is copied anew."""
    cache = k6.KMajorCache()
    w = _codes(48, 32, 2)
    cache.get(w)
    del w
    assert not cache.entries and cache.bytes == 0
    others = [_codes(48, 32, 10 + i) for i in range(8)]  # may take the freed block
    assert all(torch.equal(cache.get(o), o.t()) for o in others)
    assert cache.misses == 9 and cache.hits == 0


def test_kmajor_cache_drops_a_deleted_weights_entry_and_bytes():
    """No clear(): deleting a weight frees its entry and its copy's bytes,
    and leaves the other entries as they were."""
    cache = k6.KMajorCache()
    keep, gone = _codes(64, 16, 40), _codes(64, 32, 41)
    cache.get(keep)
    copy = cache.get(gone)
    assert cache.bytes == keep.numel() + gone.numel()
    ref = weakref.ref(copy)
    del gone, copy
    assert list(cache.entries) == [id(keep)] and cache.bytes == keep.numel()
    assert ref() is None  # the copy itself is freed
    assert cache.get(keep) is cache.entries[id(keep)][2] and cache.hits == 1


def test_kmajor_cache_in_place_edit_still_invalidates_under_the_weak_rule():
    cache = k6.KMajorCache()
    w = _codes(48, 32, 42)
    first = cache.get(w)
    w.add_(1)
    second = cache.get(w)
    assert second is not first and torch.equal(second, w.t())
    assert len(cache.entries) == 1 and cache.bytes == w.numel()
    del w  # the finalizer of the replaced entry was detached: one drop, no error
    assert not cache.entries and cache.bytes == 0


def test_kmajor_cache_is_empty_after_a_tiny_int8_model_is_dropped(monkeypatch):
    """A tiny int8 model (text and towers) loaded, every int8 weight put
    through the K-major copy the card's route reads, then dropped: the cache
    is empty without clear()."""
    from vidi_tpu_torch.infer.loader import load_model

    cache = k6.KMajorCache()
    monkeypatch.setattr(k6, "KMAJOR", cache)
    params, _, _ = load_model(random_weights="tiny", dtype=torch.float32, device="cpu",
                              load_8bit=True, load_8bit_towers=True)

    def int8_weights(tree):
        if isinstance(tree, dict):
            if isinstance(tree.get("qi8"), torch.Tensor):
                yield tree["qi8"]
            else:
                for v in tree.values():
                    yield from int8_weights(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from int8_weights(v)

    n = towers = 0
    for w in int8_weights(params):
        assert torch.equal(k6.kmajor(w), w.t())
        if w.is_contiguous():  # a text weight: one copy, used twice
            assert k6.kmajor(w) is cache.entries[id(w)][2]
            n += 1
        else:  # a tower weight, stored K-major: its own storage, no entry
            assert k6.kmajor(w).data_ptr() == w.data_ptr() and id(w) not in cache.entries
            towers += 1
    del w
    assert n > 0 and towers > 0
    assert len(cache.entries) == n and cache.hits == n and cache.misses == n
    del params
    gc.collect()
    assert not cache.entries and cache.bytes == 0


def test_kmajor_cache_never_serves_another_tensors_copy():
    """An entry left under the key of a tensor that is gone (its id taken by
    a new tensor) is not a hit: the entry names the tensor it was made for."""
    cache = k6.KMajorCache()
    a, b = _codes(48, 32, 3), _codes(48, 32, 4)
    cache.get(a)
    cache.entries[id(b)] = cache.entries.pop(id(a))  # b "took a's place"
    assert torch.equal(cache.get(b), b.t())
    assert cache.misses == 2 and cache.bytes == b.numel()


def test_kmajor_cache_evicts_least_recently_used_by_bytes():
    w = [_codes(64, 16, 20 + i) for i in range(4)]  # 1024 bytes each
    cache = k6.KMajorCache(limit_bytes=3 * 1024)
    for t in w[:3]:
        cache.get(t)
    cache.get(w[0])            # w[1] is now the least recently used
    cache.get(w[3])            # over the limit: w[1] goes
    assert cache.bytes == 3 * 1024 and id(w[1]) not in cache.entries
    assert all(id(t) in cache.entries for t in (w[0], w[2], w[3]))
    big = _codes(64, 64, 30)   # larger than the whole cache: copied, not kept
    assert torch.equal(cache.get(big), big.t())
    assert id(big) not in cache.entries and cache.bytes == 3 * 1024
    cache.clear()
    assert (cache.bytes, len(cache.entries), cache.hits, cache.misses) == (0, 0, 0, 0)


@pytest.mark.parametrize("parts", [1, 2, 3, 7, 28, 112])
def test_int32_partial_sums_over_any_split_of_k_add_to_int8_dot(parts):
    """The kernel adds a product's k-steps of 128 into int32 sums in whatever
    order its ring delivers them: any split of K = 14,336 into whole k-steps
    gives the sums `int8_dot` gives (exact integers, past fp32's 2^24)."""
    k, steps = 14336, 112
    gen = torch.Generator().manual_seed(parts)
    # codes of one sign, so the sums reach ~1e8
    xq = torch.randint(64, 128, (6, k), dtype=torch.int8, generator=gen)
    wq = torch.randint(64, 128, (k, 24), dtype=torch.int8, generator=gen)
    cuts = sorted(torch.randperm(steps - 1, generator=gen)[:parts - 1].add(1).tolist())
    bounds = [0] + [c * k6.TILE_K for c in cuts] + [k]
    total = torch.zeros((6, 24), dtype=torch.int32)
    for a, b in zip(bounds[:-1], bounds[1:]):
        total += xq[:, a:b].int() @ wq[a:b].int()
    assert int(total.max()) > 2**24
    assert torch.equal(total.float(), k6.int8_dot(xq, wq))
    assert torch.equal(total.double(), xq.double() @ wq.double())


ALIGNED = 4096  # a 16-byte aligned address


@pytest.mark.parametrize("d,x_size,w_size,x_off,w_off,want", [
    (3584, 2, 2, 0, 0, "vec"),       # the 9B's width, bf16
    (2304, 2, 2, 0, 0, "vec"),       # Gemma2-2B's: 9 vectors a lane, not 8 x threads
    (3584, 4, 4, 0, 0, "vec"),       # fp32: 28 vectors a lane
    (3584, 2, 4, 0, 0, "vec"),       # fp32 weight beside bf16 rows
    (3584, 4, 2, 0, 8, "vec"),       # 4 bf16 weights a vector: 8-byte aligned will do
    (64, 2, 2, 0, 0, "vec"),
    (3580, 2, 2, 0, 0, "scalar"),    # rows not whole vectors
    (3584, 2, 2, 8, 0, "scalar"),    # a view that starts off a 16-byte boundary
    (3584, 2, 2, 0, 8, "scalar"),    # the weight does
    (8192, 2, 2, 0, 0, "scalar"),    # more than a lane's 128 values
    (4100, 4, 4, 0, 0, "scalar"),
])
def test_rms_norm_route(d, x_size, w_size, x_off, w_off, want):
    assert k7.route(d, x_size, w_size, ALIGNED + x_off, ALIGNED + w_off, ALIGNED) == want


def test_rms_norm_route_looks_at_the_output_too():
    assert k7.route(3584, 2, 2, ALIGNED, ALIGNED, ALIGNED + 8) == "scalar"


def test_wgmma_header_is_what_the_generator_writes():
    spec = importlib.util.spec_from_file_location("gen_wgmma", ROOT / "scripts" / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert gen.OUT.read_text() == gen.render()
    assert "m64n256k32.s32.s8.s8" in gen.render()
