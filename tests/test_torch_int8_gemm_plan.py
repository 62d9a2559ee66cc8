"""The host side of K6 / K5's int8 GEMM (csrc/int8_gemm.cuh) and of K7,
which runs without a card: how a product is cut into blocks, the operand
checks, the K-major weight cache, the exactness that lets the kernel sum a
product's k-steps in any order, K7's routing, and the generated wgmma
header.

Shapes: Vidi1.5-9B's W8A8 prefill (the image stream's k / v projection
[23,520 x 3584] . [3584 x 2048], a 735-row update chunk through the folded
o [2048 x 3584], gate / up [3584 x 14336], down [14336 x 3584]),
SigLIP-so400m's layer (2,916 rows, d 1152, ff 4352) and Whisper-large-v3's
(1,500 rows, d 1280, ff 5120).
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from vidi_tpu_torch.ops.cuda import fused_rmsnorm as k7
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
    cache = k6.KMajorCache()
    w = _codes(48, 32, 2)
    ptr = w.data_ptr()
    cache.get(w)
    del w
    others = [_codes(48, 32, 10 + i) for i in range(8)]  # would take a freed block
    assert all(o.data_ptr() != ptr for o in others)
    assert all(torch.equal(cache.get(o), o.t()) for o in others)


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
