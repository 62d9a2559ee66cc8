"""Head dims and GQA groups beyond the shipped ones (ops/cuda: every
D % 8 == 0 up to 256 in place, a zero-padded copy for any other D, any
G = Hq / Hk): the kernels' plain versions against the Pallas kernels in
interpret mode at those shapes, the host-side mirrors of the sm90 kernels'
walks there, and the tiny configurations end to end on the kernels' route.

Tolerances, fp32, as the per-kernel test files state them: K1 out / lse,
K3 and K2 atol = rtol = 2e-5 (the same masked softmax summed tile by tile
against whole rows); K4 1e-5 of each gradient's largest magnitude; the K3
schedule mirror against the plain K3 2e-5; the tiny models' prefill
hidden states atol = rtol = 2e-4 (four layers of three attentions and
FFNs compound the ops' fp32 differences, as tests/test_torch_dattn.py
states), their greedy tokens identical.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vidi_tpu.ops.pallas.decode_attention as da
from vidi_tpu.core.config import DattnConfig
from vidi_tpu.infer import generate as jgen
from vidi_tpu.ops.pallas import flash_attention as fa
from vidi_tpu.ops.pallas import tower_attention as ta
from vidi_tpu_torch.infer import generate as tgen
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.ops.cuda import decode_attention as k3
from vidi_tpu_torch.ops.cuda import flash_attention as k1
from vidi_tpu_torch.ops.cuda import flash_attention_bwd as k4
from vidi_tpu_torch.ops.cuda import tower_attention as k2
from torch_init import port_init  # noqa: E402

fa.INTERPRET = True  # CPU test mesh: run the Pallas kernels interpreted
da.INTERPRET = True
ta.INTERPRET = True

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_REL = 1e-5
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)
SMS = 132  # H100 SXM
HEADS_KV = 2


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _qkv(t, s, g, d, seed, q_gain=3.0):
    rng = np.random.default_rng(seed)
    q = (q_gain * rng.standard_normal((2, t, g * HEADS_KV, d))).astype(np.float32)
    k, v, do = (rng.standard_normal(shape).astype(np.float32)
                for shape in ((2, s, HEADS_KV, d), (2, s, HEADS_KV, d), (2, t, g * HEADS_KV, d)))
    return q, k, v, do


# (D, G) of the tiny text layer, a width between the compiled ones with an
# odd group, and Codestral's G = 6 at 128; K1 and K4 each take one of a
# causal sliding T2T with a cap and a masked cross attention at each shape,
# so that every shape sees both
K1_CASES = [(16, 2, "t2t"), (96, 3, "t2v"), (128, 6, "t2t")]
K4_CASES = [(16, 2, "t2v"), (96, 3, "t2t"), (128, 6, "t2v")]
K1_KINDS = {"t2t": dict(t=100, s=100, causal=True, window=16, softcap=30.0),
            "t2v": dict(t=64, s=200, causal=False, window=None, softcap=None)}


def _k1_args(d, g, kind):
    kw = K1_KINDS[kind]
    q, k, v, do = _qkv(kw["t"], kw["s"], g, d, seed=d + g)
    mask = np.ones((2, kw["s"]), np.int32)
    mask[1, kw["s"] - 13:] = 0
    return q, k, v, do, mask, d**-0.5, kw["causal"], kw["window"], kw["softcap"]


@pytest.mark.parametrize("d,g,kind", K1_CASES)
def test_k1_plain_matches_pallas(d, g, kind):
    q, k, v, _, mask, scale, causal, window, cap = _k1_args(d, g, kind)
    want, want_lse = fa._flash_forward(_j(q), _j(k), _j(v), _j(mask), scale, causal, window,
                                       cap, 128, 128, None, None)
    got, got_lse = k1.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask), scale, causal,
                                            window, cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], **TOL)


@pytest.mark.parametrize("d,g,kind", K4_CASES)
def test_k4_plain_matches_pallas(d, g, kind):
    q, k, v, do, mask, scale, causal, window, cap = _k1_args(d, g, kind)

    def f(q_, k_, v_):
        return fa.flash_attention(q_, k_, v_, _j(mask), scale, causal, window, cap, 128, 128)

    _, vjp = jax.vjp(f, _j(q), _j(k), _j(v))
    want = vjp(_j(do))
    out, lse = k1.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask), scale, causal, window,
                                        cap)
    got = k4.flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(mask), out, lse, _t(do), scale,
                                       causal, window, cap)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b)
        err, top = float(np.abs(a.numpy() - b).max()), float(np.abs(b).max())
        assert err <= GRAD_REL * top, f"{name}: max |err| {err:.3e} over {GRAD_REL} x {top:.3e}"


@pytest.mark.parametrize("d", [16, 96])
@pytest.mark.parametrize("g", [3, 6, 12])
def test_k3_plain_matches_pallas(g, d):
    s = 256
    rng = np.random.default_rng(g * d)
    q = (2.0 * rng.standard_normal((2, g * HEADS_KV, d))).astype(np.float32)
    k, v = (rng.standard_normal((2, HEADS_KV, s, d)).astype(np.float32) for _ in range(2))
    mask = rng.random((2, s)) > 0.3
    q_pos = np.array([s - 1, s // 2], np.int32)
    window, cap = (64, None) if g == 6 else (None, 30.0)
    want = da.decode_attention(_j(q), _j(k), _j(v), _j(mask), d**-0.5, softcap=cap,
                               window=window, q_pos=_j(q_pos), block_k=128)
    got = k3.decode_attention_plain(_t(q), _t(k), _t(v), _t(mask), d**-0.5, cap, window,
                                    _t(q_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [16, 80])
def test_k2_plain_matches_pallas(d):
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((2, 37, 4, d)).astype(np.float32) for _ in range(3))
    want = ta.tower_attention(_j(q), _j(k), _j(v), d**-0.5)
    got = k2.tower_attention_plain(_t(q), _t(k), _t(v), d**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---- the host-side mirrors ------------------------------------------------

@pytest.mark.parametrize("rows_of,stored_of,tile", [
    (k1.sm90_rows, k1.sm90_stored, k1.SM90_ROWS),
    (k4.dkv_rows, k4.dkv_stored, k4.SM90_BWD_KV_ROWS)], ids=["K1 / K4 dq", "K4 dk / dv"])
@pytest.mark.parametrize("t,g", [(128, 3), (100, 5), (192, 6), (128, 12), (37, 48)])
def test_packed_rows_store_every_row_once(rows_of, stored_of, tile, t, g):
    """A group that does not divide the row tile: each tile packs tile // g
    queries; every (t, head) with t < T is stored by exactly one row, and
    the tile % g rows left over are never stored."""
    rows, stored = rows_of(t, g * 8, 8), stored_of(t, g * 8, 8)
    live = rows[stored]
    assert torch.equal((live[:, 0] * g + live[:, 1]).sort().values, torch.arange(t * g))
    per = tile // g
    assert not stored[:, per * g:].any()
    assert bool((rows[:, per * g:, 0] == rows[:, :1, 0] + per).all())  # the next tile's query


@pytest.mark.parametrize("g", [3, 6, 12])
def test_decode_schedule_matches_plain_at_odd_groups(g):
    """The sm90 K3 schedule with a group that is no power of two (one group
    of g rows on the next build) or wider than 8 (two row groups of 6),
    against the plain K3: the rows are computed apart and merged in split
    order, as the kernel's blocks do."""
    rng = np.random.default_rng(g)
    b, hk, s, d = 2, 2, 600, 96
    q = torch.from_numpy(3.0 * rng.standard_normal((b, g * hk, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, hk, s, d)).astype(np.float32))
            for _ in range(2))
    mask = torch.from_numpy(rng.random((b, s)) < 0.7)
    plan = k3.decode_plan(b, hk, s, d, 6, g=g)
    assert plan[2] > 1  # the merge across splits is exercised
    args = (q, k, v, mask, d**-0.5, 50.0, 100, torch.tensor([s - 1, s // 2]))
    got = k3.decode_attention_schedule(*args, plan=plan, return_lse=True)
    want = k3.decode_attention_plain(*args, return_lse=True)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), **TOL)


@pytest.mark.parametrize("g,want", [(1, (1, 1, 1)), (2, (2, 2, 1)), (3, (4, 3, 1)),
                                    (4, (4, 4, 1)), (6, (8, 6, 1)), (8, (8, 8, 1)),
                                    (9, (8, 5, 2)), (12, (8, 6, 2)), (32, (8, 8, 4))])
def test_decode_row_groups(g, want):
    """(kg, rg, n_groups): the shipped groups run as themselves, any other
    G <= 8 as one group on the next build, a wider G as the fewest groups
    of at most 8 rows."""
    assert k3.decode_groups(g) == want
    kg, rg, n = want
    assert rg <= kg and n * rg >= g > (n - 1) * rg
    assert k3.sm90_tile(128, g) == min(64, 128 // kg)


def test_head_width_by_kernel_and_route():
    """A head dim runs at the least compiled width that holds it; above
    256 every kernel raises."""
    k1_widths = {8: 64, 16: 64, 64: 64, 72: 72, 80: 128, 96: 128, 104: 128, 128: 128,
                 136: 256, 256: 256}
    for d, w in k1_widths.items():
        assert k1.head_width(d) == w
    bwd = k4.WIDTHS
    assert [k1.head_width(d, bwd["vidi_flash_attention_bwd_sm90"]) for d in (16, 96, 200)] == \
        [128, 128, 256]
    assert [k1.head_width(d, bwd["vidi_flash_attention_bwd"]) for d in (16, 96, 200)] == \
        [64, 128, 256]
    dec = k3.WIDTHS
    assert [k1.head_width(d, dec["vidi_decode_attention_sm90"]) for d in (16, 128)] == [128, 128]
    assert [k1.head_width(d, dec["vidi_decode_attention"]) for d in (16, 80)] == [64, 128]
    for d in (264, 512):
        with pytest.raises(ValueError, match="outside the kernels' 1..256"):
            k1.head_width(d)
    with pytest.raises(ValueError, match="1..256"):
        k3.check_shapes((1, 4, 264), (1, 2, 16, 264), (1, 2, 16, 264))


def test_padded_copy_of_a_head_dim_off_the_grid():
    """D = 20: each operand copied once into 24 columns, zeros past 20;
    the plain K1 / K3 / K2 on the copies, sliced, equal them on the
    originals (the zero columns add nothing to q . k)."""
    rng = np.random.default_rng(20)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 30, 4, 20), (2, 40, 2, 20), (2, 40, 2, 20)))
    qp, kp, vp = k1.padded_heads("test", q, k, v)
    assert qp.shape == (2, 30, 4, 24) and kp.shape == (2, 40, 2, 24)
    assert torch.equal(qp[..., :20], q) and not qp[..., 20:].any()
    args = dict(sm_scale=20**-0.5, causal=False, window=None, softcap=30.0)
    out, lse = k1.flash_attention_plain(q, k, v, None, **args)
    outp, lsep = k1.flash_attention_plain(qp, kp, vp, None, **args)
    assert torch.equal(outp[..., :20], out) and not outp[..., 20:].any()
    np.testing.assert_allclose(lsep.numpy(), lse.numpy(), rtol=1e-6, atol=0)
    got = k2.tower_attention_plain(*(x[:, :, :2] for x in (qp, kp, vp)), 20**-0.5)
    np.testing.assert_allclose(got[..., :20].numpy(),
                               k2.tower_attention_plain(q[:, :, :2], k[:, :, :2], v[:, :, :2],
                                                        20**-0.5).numpy(), **TOL)
    qd, kd, vd = q[:, 0], k.transpose(1, 2), v.transpose(1, 2)
    got = k3.decode_attention_plain(*k1.padded_heads("test", qd, kd, vd), None, 20**-0.5)
    np.testing.assert_allclose(got[..., :20].numpy(),
                               k3.decode_attention_plain(qd, kd, vd, None, 20**-0.5).numpy(),
                               **TOL)


def test_group_slices_cover_each_head_once():
    """A group wider than a kernel's row tile runs as slices of at most
    `most` query heads of one KV head each."""
    for hq, hk, most in ((320, 2, 128), (200, 1, 64), (96, 8, 64)):
        sl = k1.group_slices(hq, hk, most)
        heads = [h for _, h0, h1 in sl for h in range(h0, h1)]
        assert heads == list(range(hq))
        assert all(h1 - h0 <= most and h0 // (hq // hk) == kv for kv, h0, h1 in sl)


# ---- the tiny configurations on the kernels' route -------------------------

@pytest.fixture(scope="module", params=["gemma2", "mistral"])
def tiny(request):
    cfg = DattnConfig.tiny(request.param)
    jp = port_init(cfg, 0)
    return cfg, jp, params_from_jax(jax.device_get(jp))


def test_tiny_model_on_the_kernels_matches_jax(tiny):
    """The tiny gemma2 and mistral models with use_flash / use_flash_decode
    (K1 and K3 at head dim 16, G = 2: the wrappers' plain versions on the
    CPU) against vidi_tpu's tiny with its Pallas kernels interpreted: the
    prompt rows' prefill hidden states and the greedy tokens."""
    cfg, jp, tp = tiny
    rng = np.random.default_rng(5)
    d = cfg.text.hidden_size
    ids = rng.integers(3, 259, (2, 16)).astype(np.int32)
    mask = np.zeros((2, 16), bool)
    mask[0, :13], mask[1, :9] = True, True
    ids = ids * mask
    img = (0.5 * rng.standard_normal((2, 48, d))).astype(np.float32)
    aud = (0.5 * rng.standard_normal((2, 20, d))).astype(np.float32)
    img_mask, aud_mask = np.ones((2, 48), bool), np.ones((2, 20), bool)
    img_mask[1, 36:], aud_mask[1, 15:] = False, False
    jm = [_j(x) for x in (img, img_mask, aud, aud_mask)]
    tm = [_t(x) for x in (img, img_mask, aud, aud_mask)]
    kw = dict(max_new_tokens=6, mm_chunks=2)
    want_h, _, _ = jgen._prefill(jp, cfg, _j(ids), _j(mask), *jm, use_flash=True,
                                 quantize_caches=False, media_caches=None, **kw)
    got_h, _, _ = tgen._prefill(tp, cfg, _t(ids).long(), _t(mask), *tm, use_flash=True, **kw)
    np.testing.assert_allclose(got_h.numpy()[mask], np.asarray(want_h)[mask], **MODEL_TOL)
    want = jgen.generate(jp, cfg, _j(ids), _j(mask), *jm, eos_id=2, use_flash=True,
                         use_flash_decode=True, **kw)
    got = tgen.generate(tp, cfg, _t(ids).long(), _t(mask), *tm, eos_id=2, use_flash=True,
                        use_flash_decode=True, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flash_cli_faults_do_what_they_say():
    """The flash train CLI's planted faults (chip_smoke.FLASH_CLI_FAULTS),
    run against stand-in launches on the CPU: K1's two query heads of each
    KV group swapped, K1 called without its window, K2's heads rolled by
    one; everything else passed through."""
    import types

    cs = _chip_smoke()
    q, k = torch.arange(2 * 3 * 4 * 2.0).reshape(2, 3, 4, 2), torch.zeros(2, 5, 2, 2)
    calls = []
    k1 = types.SimpleNamespace(_launch=lambda *a: (calls.append(a) or a[0].clone(), "lse"))
    k2 = types.SimpleNamespace(_launch=lambda *a: a[0].clone())
    for fault, code in cs.FLASH_CLI_FAULTS.items():
        ns = {"k1": types.SimpleNamespace(**vars(k1)), "k2": types.SimpleNamespace(**vars(k2))}
        exec(code, ns)
        a = (q, k, k, None, 0.25, True, 16, 50.0, None, None)
        out, lse = ns["k1"]._launch(*a)
        assert lse == "lse"
        if fault == "K1 group's heads swapped":
            assert torch.equal(out, q[:, :, [1, 0, 3, 2]])
        else:
            assert torch.equal(out, q)
        window = calls[-1][6]
        assert window == (None if fault == "K1 window ignored" else 16)
        assert calls[-1][:6] + calls[-1][7:] == a[:6] + a[7:]
        want = q.roll(1, dims=2) if fault == "K2 heads rolled" else q
        assert torch.equal(ns["k2"]._launch(q, q, q, 0.25), want)
        compile(cs.flash_cli(fault), fault, "exec")
