"""Port ops (vidi_tpu_torch.ops) against their vidi_tpu counterparts on the
CPU in fp32. Inputs come from numpy with a fixed seed and go to both.

Tolerance: atol = rtol = 1e-5. Both sides compute in fp32 with the same
formulas; only the summation order of reductions and matmuls differs
(XLA vs ATen), which moves results by a few ulp.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.ops import attention as jattn
from vidi_tpu.ops import basic as jbasic
from vidi_tpu.ops import norms as jnorms
from vidi_tpu.ops import preprocess as jpre
from vidi_tpu.ops import rope as jrope
from vidi_tpu_torch.ops import attention as tattn
from vidi_tpu_torch.ops import basic as tbasic
from vidi_tpu_torch.ops import norms as tnorms
from vidi_tpu_torch.ops import preprocess as tpre
from vidi_tpu_torch.ops import rope as trope

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("name,eps", [
    ("rms_norm", 1e-5), ("scaled_rms_norm", 1e-5),
    ("gemma_rms_norm", 1e-6), ("mistral_rms_norm", 1e-5)])
def test_norms_match(name, eps):
    x, w = _rand(3, 5, 64), _rand(64, seed=1)
    args = () if name == "rms_norm" else (w,)
    want = getattr(jnorms, name)(jnp.asarray(x), *map(jnp.asarray, args), eps)
    got = getattr(tnorms, name)(torch.from_numpy(x), *map(torch.from_numpy, args), eps)
    _close(got, want)


@pytest.mark.parametrize("pos_shape", [(7,), (2, 7)])
def test_rope_matches(pos_shape):
    pos = np.arange(np.prod(pos_shape)).reshape(pos_shape).astype(np.int32) * 3
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    _close(tc, jc)
    _close(ts, js)
    if len(pos_shape) == 2:  # tables [B,T,D] against x [B,T,H,D]
        x = _rand(2, 7, 3, 16)
        _close(trope.apply_rope(torch.from_numpy(x), tc, ts),
               jrope.apply_rope(jnp.asarray(x), jc, js))


def test_layer_norm_and_dense_match():
    x, s, b = _rand(2, 5, 32), _rand(32, seed=1), _rand(32, seed=2)
    w = _rand(32, 48, seed=3)
    tx = torch.from_numpy(x)
    _close(tbasic.layer_norm(tx, torch.from_numpy(s), torch.from_numpy(b)),
           jbasic.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    _close(tbasic.dense(tx, torch.from_numpy(w), torch.from_numpy(_rand(48, seed=4))),
           jbasic.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(_rand(48, seed=4))))
    _close(tbasic.matmul_f32(tx, torch.from_numpy(w)), jnp.asarray(x) @ jnp.asarray(w))


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu_exact", "quick_gelu"])
def test_activations_match(act):
    x = _rand(4, 33) * 3
    _close(tbasic.tower_act(torch.from_numpy(x), act if act != "gelu_exact" else "gelu"),
           getattr(jbasic, act)(jnp.asarray(x)))


@pytest.mark.parametrize("use_flash", [False, True])
def test_mha_matches(use_flash):
    """use_flash on a CPU tensor runs the K2 kernel's plain version."""
    q, k, v = (_rand(2, 9, 48, seed=i) for i in range(3))
    want = jbasic.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 3)
    got = tbasic.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                     3, use_flash=use_flash)
    _close(got, want)


@pytest.mark.parametrize("window,softcap,segs", [
    (None, None, False), (4, 50.0, False), (None, 30.0, True)])
def test_self_attention_matches(window, softcap, segs):
    b, t, hq, hk, d = 2, 11, 4, 2, 16
    q, k, v = _rand(b, t, hq, d), _rand(b, t, hk, d, seed=1), _rand(b, t, hk, d, seed=2)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    valid = np.ones((b, t), bool)
    valid[1, 8:] = False
    seg = np.array([[1] * 5 + [2] * 6, [1] * 8 + [0] * 3], np.int32)
    kw = dict(scale=0.25, sliding_window=window, softcap=softcap)
    want = jattn.self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=jnp.asarray(pos),
        kv_positions=jnp.asarray(pos), kv_valid=jnp.asarray(valid),
        q_segment_ids=jnp.asarray(seg) if segs else None,
        kv_segment_ids=jnp.asarray(seg) if segs else None, **kw)
    got = tattn.self_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(pos), kv_positions=torch.from_numpy(pos),
        kv_valid=torch.from_numpy(valid),
        q_segment_ids=torch.from_numpy(seg) if segs else None,
        kv_segment_ids=torch.from_numpy(seg) if segs else None, **kw)
    _close(got, want)


@pytest.mark.parametrize("softcap,empty_row", [(None, False), (50.0, True)])
def test_cross_attention_matches(softcap, empty_row):
    """Including a sample whose mask is all False: both sides average V."""
    b, t, s, hq, hk, d = 2, 5, 23, 4, 2, 16
    q, k, v = _rand(b, t, hq, d), _rand(b, s, hk, d, seed=1), _rand(b, s, hk, d, seed=2)
    valid = np.ones((b, s), bool)
    valid[0, 17:] = False
    if empty_row:
        valid[1] = False
    want = jattn.cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 kv_valid=jnp.asarray(valid), scale=0.25,
                                 softcap=softcap)
    got = tattn.cross_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), kv_valid=torch.from_numpy(valid),
                                scale=0.25, softcap=softcap)
    _close(got, want)


@pytest.mark.parametrize("mean,std", [(0.5, 0.5), ((0.48, 0.45, 0.40), (0.27, 0.26, 0.28))])
def test_normalize_uint8_matches(mean, std):
    x = np.random.default_rng(0).integers(0, 256, (2, 6, 6, 3), dtype=np.uint8)
    _close(tpre.normalize_uint8(torch.from_numpy(x), mean, std),
           jpre.normalize_uint8(jnp.asarray(x), mean, std))
    _close(tpre.preprocess_uint8(torch.from_numpy(x), 6, mean, std),
           jpre.preprocess_uint8(jnp.asarray(x), 6, mean, std))


def test_device_resize_matches():
    """Frames not at the tower's size are resized on the device (bicubic,
    antialiased) before the normalize: within 1e-4 of JAX's normalized
    output (tests/test_torch_media_stream.py holds the resize at more
    shapes)."""
    x = np.random.default_rng(1).integers(0, 256, (2, 8, 11, 3), dtype=np.uint8)
    _close(tpre.preprocess_uint8(torch.from_numpy(x), 6, 0.5, 0.5),
           jpre.preprocess_uint8(jnp.asarray(x), 6, 0.5, 0.5))


# The bf16 gradients of the logits: both sides cast one fp32 product to bf16,
# summed in another order, so an element at a rounding boundary may land one
# bf16 ulp (at most 2^-7 of its value) away.
BF16_GRAD_TOL = dict(atol=1e-5, rtol=2**-7)


@pytest.mark.parametrize("arch", ["gemma2", "mistral"])  # tied embed, softcap 30 / untied lm_head
def test_lm_logits_and_grads_match_jax(arch):
    """`decoder.lm_logits` on bf16 hidden rows and weights (`matmul_f32`'s
    CPU route, the fp32 upcast) against JAX's `jax.vjp` of its own
    `lm_logits` (`jnp.dot(..., preferred_element_type=float32)`): the fp32
    logits and both bf16 gradients for one fp32 cotangent."""
    import jax

    from vidi_tpu.core.config import TextConfig as JTextConfig
    from vidi_tpu.models import decoder as jdec
    from vidi_tpu_torch.core.config import TextConfig
    from vidi_tpu_torch.models import decoder as tdec

    jcfg, tcfg = JTextConfig.tiny(arch), TextConfig.tiny(arch)
    d, v = tcfg.hidden_size, tcfg.vocab_size
    key = "embed" if tcfg.tie_word_embeddings else "lm_head"
    h, g = _rand(2, 5, d, seed=1), _rand(2, 5, v, seed=2)
    w = 0.05 * _rand(*((v, d) if key == "embed" else (d, v)), seed=3)
    hj, wj = jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want, vjp = jax.vjp(lambda a, b: jdec.lm_logits({key: b}, a, jcfg), hj, wj)
    dh_want, dw_want = vjp(jnp.asarray(g))
    ht = torch.from_numpy(h).bfloat16().requires_grad_(True)
    wt = torch.from_numpy(w).bfloat16().requires_grad_(True)
    got = tdec.lm_logits({key: wt}, ht, tcfg)
    dh, dw = torch.autograd.grad(got, (ht, wt), torch.from_numpy(g))
    assert got.dtype == torch.float32 and (dh.dtype, dw.dtype) == (torch.bfloat16,) * 2
    _close(got, want)
    _close(dh.float(), dh_want.astype(jnp.float32), BF16_GRAD_TOL)
    _close(dw.float(), dw_want.astype(jnp.float32), BF16_GRAD_TOL)


def _frob_rel(got, want) -> float:
    return float(torch.linalg.vector_norm(got.float() - want) / torch.linalg.vector_norm(want))


def test_logits_card_route_emulated_within_its_limit():
    """The card's backward of the logits (`basic._MatmulF32`: the fp32
    cotangent rounded to bf16 once, each product summed in fp32, then cast
    to bf16), emulated with fp32 products at [256, 512] . [512, 16,000]:
    dx and dw within the 4e-3 relative Frobenius limit that chip_smoke.py
    holds the card to (LOGITS_GRAD_REL), against the fp32 upcast's fp32
    gradients; the cotangent rounded to float8_e4m3fn reads above it."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((256, 512)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(0.05 * rng.standard_normal((512, 16000)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((256, 16000)).astype(np.float32))
    xf, wf = x.float(), w.float()
    want = {"dx": g @ wf.T, "dw": xf.T @ g}

    def card(cot):  # the Function's arithmetic, with fp32 products of bf16 values
        c = cot.bfloat16().float()
        return {"dx": (c @ wf.T).bfloat16(), "dw": (xf.T @ c).bfloat16()}
    got, fault = card(g), card(g.to(torch.float8_e4m3fn).float())
    for name in want:
        assert _frob_rel(got[name], want[name]) <= 4e-3
        assert _frob_rel(fault[name], want[name]) > 4e-3


@pytest.mark.parametrize("layout", ["lm_head", "embed.T"])
@pytest.mark.parametrize("needs", ["x and w", "x", "w"])
def test_logits_function_arithmetic_on_cpu(monkeypatch, needs, layout):
    """`basic._MatmulF32` (the card's logits product) run on the CPU with
    its cuBLAS product `_mm_f32` stood in by fp32 products of the bf16
    values, and dw made 1,000 columns at a time (the last part-filled), for
    an untied lm_head [d, V] and a tied embedding's view embed.T (dw then
    written along its rows): the logits equal the fp32 upcast's, dx and dw
    equal the card route's arithmetic (the cotangent rounded to bf16, fp32
    sums, one cast) within one bf16 rounding, and only the gradients asked
    for are made."""
    from vidi_tpu_torch.ops import basic

    monkeypatch.setattr(basic, "_mm_f32", lambda a, b: a.float() @ b.float())
    monkeypatch.setattr(basic, "DW_COLS", 1000)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(0.05 * rng.standard_normal((128, 3500)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((64, 3500)).astype(np.float32))
    xf, wf, c = x.float(), w.float(), g.bfloat16().float()
    want = {"x": (c @ wf.T).bfloat16(), "w": (xf.T @ c).bfloat16()}
    w_in = w.clone() if layout == "lm_head" else w.T.contiguous().T
    ins = {"x": x.clone().requires_grad_("x" in needs.split()),
           "w": w_in.requires_grad_("w" in needs.split())}
    y = basic._MatmulF32.apply(ins["x"], ins["w"])
    assert y.dtype == torch.float32 and torch.equal(y, xf @ wf)
    asked = [k for k in ins if ins[k].requires_grad]
    grads = torch.autograd.grad(y, [ins[k] for k in asked], g)
    for k, got in zip(asked, grads):
        assert got.dtype == torch.bfloat16 and got.shape == ins[k].shape
        _close(got.float(), want[k].float(), BF16_GRAD_TOL)

    made = []
    monkeypatch.setattr(basic, "_mm_f32", lambda a, b: made.append(
        (tuple(a.shape), tuple(b.shape))) or a.float() @ b.float())
    y = basic._MatmulF32.apply(ins["x"], ins["w"])
    torch.autograd.grad(y, [ins[k] for k in asked], g)
    parts = [1000, 1000, 1000, 500]
    products = {"x": [((64, 3500), (3500, 128))],
                "w": ([((128, 64), (64, n)) for n in parts] if layout == "lm_head"
                      else [((n, 64), (64, 128)) for n in parts])}
    assert made == [((64, 128), (128, 3500))] + sum((products[k] for k in asked), [])
