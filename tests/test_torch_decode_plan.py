"""The host side of K3's bf16 kernel (csrc/decode_attention_sm90.cuh), which
runs without a card: the split plan, a plain mirror of the kernel's
schedule (tile skips, per-warp online softmax, merge in split order) held
against `decode_attention_plain`, the routing by dtype, the operand checks,
the mask / q_pos operands and the workspace.

Shapes: Vidi1.5-9B's decode caches (16 query / 8 KV heads of 256; 23,520
image keys, 1,200 audio keys, a 160-key text cache), the 1.5B
configuration's (12 / 6 heads of 128) and Vidi-7B's (32 / 8 heads of 128,
G = 4; 7,680 image keys, 1,200 audio keys, a 160-key text cache), on an
H100's 132 SMs.

Tolerance of the mirror: atol = rtol = 2e-5 in fp32 (the same masked
softmax, summed tile by tile and merged warp by warp and split by split).
"""
import ctypes

import numpy as np
import pytest
import torch

from vidi_tpu_torch.ops.cuda import _lib
from vidi_tpu_torch.ops.cuda import decode_attention as k3

SMS = 132  # H100 SXM
TOL = dict(atol=2e-5, rtol=2e-5)
# (name, b, hk, s, d, g)
SHAPES = [
    ("9b image", 1, 8, 23520, 256, 2),
    ("9b audio", 1, 8, 1200, 256, 2),
    ("9b text", 1, 8, 160, 256, 2),
    ("1.5b image", 1, 6, 23520, 128, 2),
    ("1.5b audio", 1, 6, 1200, 128, 2),
    ("1.5b text", 1, 6, 160, 128, 2),
    ("9b batch 8", 8, 8, 23520, 256, 2),
    ("9b batch 64", 64, 8, 23520, 256, 2),
    ("7b image", 1, 8, 7680, 128, 4),
    ("7b audio", 1, 8, 1200, 128, 4),
    ("7b text", 1, 8, 160, 128, 4),
    ("7b batch 8", 8, 8, 7680, 128, 4),
] + [(f"ragged S={s} D={d}", 1, 8, s, d, 2) for s in (1, 31, 160, 1199, 23520)
     for d in (128, 256)] + [(f"ragged S={s} D={d} G={g}", 1, 8, s, d, g)
                             for s in (1, 31, 1199) for d in (128, 256) for g in (1, 4, 8)]


@pytest.mark.parametrize("name,b,hk,s,d,g", SHAPES, ids=[x[0] for x in SHAPES])
def test_plan_covers_keys_once_and_fills_one_wave(name, b, hk, s, d, g):
    plan = tile, chunk, n_split = k3.decode_plan(b, hk, s, d, SMS, g=g)
    assert tile == k3.sm90_tile(d, g) and tile % 16 == 0
    assert tile // k3.SM90_CONSUMERS * g <= 32  # a warp's scores fit one reduce
    assert chunk % tile == 0 and chunk <= k3.SM90_MAX_CHUNK
    covered = torch.zeros(s, dtype=torch.int64)
    for i in range(n_split):
        tiles = k3.split_tiles(i, s, plan)
        assert 0 < len(tiles) <= chunk // tile  # no empty split; its mask fits
        for t in tiles:
            covered[t * tile:(t + 1) * tile] += 1
    assert bool((covered == 1).all())
    blocks = b * hk * n_split
    # one wave at least, unless every split is one tile already
    assert blocks >= SMS or n_split == -(-s // tile)
    # and no more than a wave of SM90_BLOCKS_PER_SM blocks an SM, unless
    # the heads alone exceed it or the chunk's limit forces more splits
    assert n_split <= max(1, -(-k3.SM90_BLOCKS_PER_SM * SMS // (b * hk)),
                          -(-s // k3.SM90_MAX_CHUNK))


def test_plan_values_at_the_slice_shapes():
    assert k3.decode_plan(1, 8, 23520, 256, SMS, g=2) == (32, 736, 33)  # 264 blocks
    assert k3.decode_plan(1, 8, 1200, 256, SMS, g=2) == (32, 64, 33)
    assert k3.decode_plan(1, 8, 160, 256, SMS, g=2) == (32, 32, 5)
    assert k3.decode_plan(1, 6, 23520, 128, SMS, g=2) == (64, 576, 44)
    assert k3.decode_plan(64, 8, 23520, 256, SMS, g=2) == (32, 3936, 6)  # mask bytes bound the chunk
    # Vidi-7B (G = 4, D = 128): 32-key tiles, a 64-key tile's 16 keys a
    # warp times 4 rows would not fit one 32-lane reduce
    assert k3.sm90_tile(128, 4) == 32 and k3.sm90_tile(128, 8) == 16
    assert k3.decode_plan(1, 8, 7680, 128, SMS, g=4) == (32, 256, 33)
    assert k3.decode_plan(1, 8, 1200, 128, SMS, g=4) == (32, 64, 33)
    assert k3.decode_plan(1, 8, 160, 128, SMS, g=4) == (32, 32, 5)
    # the image cache's masked tail (the last 4,704 keys) spreads over the
    # splits: each holds 17 or 18 of the 588 tiles with a visible key
    plan = k3.decode_plan(1, 8, 23520, 256, SMS, g=2)
    seen = [sum(t < 18816 // 32 for t in k3.split_tiles(i, 23520, plan)) for i in range(33)]
    assert (min(seen), max(seen)) == (17, 18)


def _case(b, hk, s, d, seed, p_valid=0.7, g=2):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(3.0 * rng.standard_normal((b, g * hk, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hk, s, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hk, s, d)).astype(np.float32))
    mask = torch.from_numpy(rng.random((b, s)) < p_valid)
    return q, k, v, mask


def _ragged(q, k, v, mask):
    return mask, None, None


def _masked_chunks(q, k, v, mask):
    """Keys [160, 480) and everything past 700 hidden: whole chunks and
    whole tiles with no visible key."""
    mask = mask.clone()
    mask[:, 160:480] = False
    mask[:, 700:] = False
    return mask, None, None


def _window(q, k, v, mask):
    """A causal text cache with a window of 100 that binds: row 0 at the
    end of the cache, row 1 half way."""
    s = k.shape[2]
    q_pos = torch.tensor([s - 1, s // 2])
    causal = torch.arange(s)[None, :] <= q_pos[:, None]
    return mask & causal, 100, q_pos


def _empty_row(q, k, v, mask):
    mask = mask.clone()
    mask[1] = False
    return mask, None, None


# (name, b, hk, s, d, sms, setup, softcap, g): small SM counts give several
# splits at these short caches
MIRROR_CASES = [
    ("ragged S", 1, 2, 1199, 256, 8, _ragged, 50.0, 2),
    ("ragged S D=128", 2, 2, 999, 128, 8, _ragged, None, 2),
    ("masked chunks", 1, 2, 1000, 256, 8, _masked_chunks, 50.0, 2),
    ("window", 2, 2, 600, 128, 6, _window, 50.0, 2),
    ("empty row", 2, 2, 300, 256, 6, _empty_row, None, 2),
    # Vidi-7B's decoder: 4 query heads a KV head at D = 128, no softcap
    ("7b ragged S", 1, 2, 1199, 128, 8, _ragged, None, 4),
    ("7b masked chunks", 1, 2, 1000, 128, 8, _masked_chunks, None, 4),
    ("7b window", 2, 2, 600, 128, 6, _window, None, 4),
    ("7b empty row", 2, 2, 300, 128, 6, _empty_row, None, 4),
    ("G=8 window D=256", 2, 1, 600, 256, 6, _window, 50.0, 8),
    ("G=1 ragged S", 1, 2, 999, 128, 8, _ragged, None, 1),
]


@pytest.mark.parametrize("name,b,hk,s,d,sms,setup,softcap,g", MIRROR_CASES,
                         ids=[x[0] for x in MIRROR_CASES])
def test_schedule_mirror_matches_plain(name, b, hk, s, d, sms, setup, softcap, g):
    q, k, v, mask = _case(b, hk, s, d, seed=s, g=g)
    mask, window, q_pos = setup(q, k, v, mask)
    plan = k3.decode_plan(b, hk, s, d, sms, g=g)
    assert plan[2] > 1  # the merge across splits is exercised
    args = (q, k, v, mask, d**-0.5, softcap, window, q_pos)
    got = k3.decode_attention_schedule(*args, plan=plan)
    want = k3.decode_attention_plain(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    if name.endswith("empty row"):
        assert not got[1].any() and got[0].abs().sum() > 0


def test_schedule_mirror_skips_tiles_it_cannot_see():
    """NaN in every key and value the mask hides, from whole hidden tiles:
    the mirror never reads them, as the kernel never copies them."""
    q, k, v, mask = _case(1, 2, 640, 256, seed=3)
    mask[:, 64:] = False
    k[:, :, 64:] = float("nan")
    v[:, :, 64:] = float("nan")
    plan = k3.decode_plan(1, 2, 640, 256, 8, g=2)
    got = k3.decode_attention_schedule(q, k, v, mask, 0.0625, 50.0, plan=plan)
    want = k3.decode_attention_plain(q[:, :, :], k[:, :, :64], v[:, :, :64],
                                     mask[:, :64], 0.0625, 50.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_route_by_dtype():
    assert k3.route(torch.bfloat16) == "vidi_decode_attention_sm90"
    assert k3.route(torch.float32) == "vidi_decode_attention"
    with pytest.raises(TypeError):
        k3.route(torch.float16)


def test_operand_check_passes_a_cache_layer_view():
    cache = torch.empty(3, 2, 8, 160, 256, dtype=torch.bfloat16)  # [L,B,Hk,S,D]
    x = cache[1]
    assert k3.block_strides("k", x.shape, x.stride(), x.data_ptr(), 2) == \
        (8 * 160 * 256, 160 * 256)
    one = cache[1, :1]  # batch 1: never stepped along
    assert k3.block_strides("k", one.shape, one.stride(), one.data_ptr(), 2)[0] == 0


@pytest.mark.parametrize("fault,match", [
    ("rows not contiguous", "row block must be contiguous"),
    ("misaligned start", "not 16-byte aligned"),
    ("misaligned head stride", "16-byte aligned"),
    ("D = 64", None),
    ("G = 3", None),
    ("D = 264", "outside the kernels' 1..256"),
    ("Hq % Hk", "multiple of Hk"),
])
def test_operand_check_raises(fault, match):
    """The layouts the kernels cannot read raise; D = 64 and G = 3, which
    the kernels once refused, pass `check_shapes` (any D up to 256, any G);
    D > 256 and a group that does not divide raise."""
    if fault == "rows not contiguous":  # a [B,S,Hk,D] cache read through a transpose
        x = torch.empty(1, 160, 8, 256, dtype=torch.bfloat16).transpose(1, 2)
        call = lambda: k3.block_strides("k", x.shape, x.stride(), x.data_ptr(), 2)  # noqa: E731
    elif fault == "misaligned start":
        x = torch.empty(1 * 8 * 160 * 256 + 4, dtype=torch.bfloat16)[4:].view(1, 8, 160, 256)
        call = lambda: k3.block_strides("k", x.shape, x.stride(), x.data_ptr(), 2)  # noqa: E731
    elif fault == "misaligned head stride":
        x = torch.empty(1, 8, 160 * 256 + 4, dtype=torch.bfloat16)[..., :160 * 256]
        x = x.view(1, 8, 160, 256) if x.is_contiguous() else x.unflatten(2, (160, 256))
        call = lambda: k3.block_strides("k", x.shape, x.stride(), x.data_ptr(), 2)  # noqa: E731
    elif fault == "D = 64":
        call = lambda: k3.check_shapes((1, 16, 64), (1, 8, 160, 64), (1, 8, 160, 64))  # noqa: E731
    elif fault == "G = 3":  # 24 query heads over 8: one group of 3 on the kg = 4 build
        call = lambda: k3.check_shapes((1, 24, 256), (1, 8, 160, 256), (1, 8, 160, 256))  # noqa: E731
    elif fault == "D = 264":
        call = lambda: k3.check_shapes((1, 16, 264), (1, 8, 160, 264), (1, 8, 160, 264))  # noqa: E731
    else:  # 20 query heads over 8
        call = lambda: k3.check_shapes((1, 20, 128), (1, 8, 160, 128), (1, 8, 160, 128))  # noqa: E731
    if match is None:
        assert call() is None
        return
    with pytest.raises(ValueError, match=match):
        call()


def test_mask_and_qpos_pass_as_they_come():
    cpu = torch.device("cpu")
    for mask in (torch.ones(2, 40, dtype=torch.bool), torch.ones(2, 40, dtype=torch.uint8),
                 torch.ones(2, 48, dtype=torch.bool)[:, :40]):
        got, stride = k3.mask_operand(mask, 2, 40, cpu)
        assert got is mask and stride == mask.stride(0)
    got, _ = k3.mask_operand(torch.ones(2, 40, dtype=torch.int32), 2, 40, cpu)
    assert got.dtype == torch.bool  # another dtype is converted
    for q_pos, is64 in ((torch.tensor([5, 9]), 1), (torch.tensor([5, 9], dtype=torch.int32), 0)):
        got, flag, stride = k3.qpos_operand(q_pos, 2, cpu)
        assert got is q_pos and flag == is64 and stride == 1
    positions = torch.tensor([[5], [9]])  # decode_step's q_positions[:, 0]
    assert k3.qpos_operand(positions[:, 0], 2, cpu)[0] is not None
    with pytest.raises(ValueError):
        k3.mask_operand(torch.ones(2, 41, dtype=torch.bool), 2, 40, cpu)


def test_workspace_grows_and_keeps_its_buffers():
    ws = k3.Workspace()
    cpu = torch.device("cpu")
    a = dict(ws.get(cpu, 7, 64, 256, 8))
    b = ws.get(cpu, 7, 32, 256, 8)  # smaller: the same buffers
    assert all(b[n] is a[n] for n in a)
    c = ws.get(cpu, 7, 512, 256, 16)  # larger: grown, counters zeroed
    assert c["m"].numel() >= 512 and c["acc"].numel() >= 512 * 256
    assert c["counters"].numel() >= 16 and not c["counters"].any()
    assert ws.get(cpu, 8, 64, 256, 8)["m"] is not c["m"]  # another stream


def test_packed_arguments_are_each_calls_own(monkeypatch):
    """Threads that launch K3 at once (virtual ranks, decode-ahead) each
    hand the C entry the block they packed, though the ctypes call lets the
    others run between the pack and the read."""
    import threading
    import time

    seen, local = [], threading.local()

    def entry(buf, stream):
        time.sleep(0.002)  # the other threads pack meanwhile
        seen.append(k3.ARGS.unpack_from(buf) == local.values)
        return 0

    monkeypatch.setattr(k3._lib, "library", lambda: type("L", (), {"e": staticmethod(entry)}))
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)

    def launch(i):
        for j in range(20):
            local.values = (i, j, *range(9), *range(6), *range(10), 0.5, 1.5, *range(4), 1, 2, 3)
            k3._call("e", torch.device("cuda", 0), 0, local.values)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert len(seen) == 80 and all(seen)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_passes_the_operands_as_they_come(monkeypatch, dtype):
    """The wrapper's launch, with the C call recorded instead of made: one
    call of the dtype's entry with the arguments the packed block holds,
    the bool mask and int64 q_pos by their own pointers, the plan's split,
    the workspace reused from call to call (only the output is new)."""
    calls = []
    monkeypatch.setattr(k3._lib, "check_operand", lambda *a, **kw: None)
    monkeypatch.setattr(k3, "same_device", lambda q, k, v: (q.device, q.dtype))
    monkeypatch.setattr(k3._lib, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(k3, "_call", lambda entry, dev, stream, values:
                        calls.append((entry, stream, values)))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda idx: 12345,
                        raising=False)  # a CPU build has no CUDA streams
    monkeypatch.setattr(k3, "WORKSPACE", k3.Workspace())
    monkeypatch.setattr(k3, "_LAYOUTS", {})
    cache = torch.zeros(2, 1, 8, 160, 256, dtype=dtype)
    q = torch.zeros(1, 16, 256, dtype=dtype)
    mask = torch.ones(1, 160, dtype=torch.bool)
    q_pos = torch.tensor([120])
    before = k3.launches
    for _ in range(2):
        k3._launch(q, cache[1, :, :, :], cache[0], mask, 0.0625, 50.0, 4096, q_pos)
    assert k3.launches == before + 2
    (entry, stream, args), (_, _, args2) = calls
    assert entry == k3.route(dtype) and stream == 12345
    assert _lib._SIGNATURES[entry] == [ctypes.c_void_p, ctypes.c_void_p]
    assert len(k3.ARGS.pack(*args)) == k3.ARGS.size  # the block the C entry reads
    assert args[3] == mask.data_ptr() and args[4] == q_pos.data_ptr()
    assert args[10] == 0  # no lse asked for: a null pointer
    assert args[16] == 1  # q_pos read as int64
    assert args[5:9] == args2[5:9]  # the same workspace
    n_split, chunk = args[-2:]
    if dtype == torch.bfloat16:
        assert (chunk, n_split) == k3.decode_plan(1, 8, 160, 256, SMS, g=2)[1:]
        assert args[19] == 0 and args[21] == 256  # batch stride 0, rows D apart
    else:
        assert (chunk, n_split) == (k3.CHUNK, 1)
