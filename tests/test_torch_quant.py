"""The port's int8 / int4 quantization (vidi_tpu_torch/infer/quantize.py)
against vidi_tpu/infer/quantize.py on the same numpy inputs, on the CPU.

Quantized values are held bit-equal (int8 codes, packed int4 bytes) and the
scales equal: both packages take amax over fp32 values, divide by 127 (7)
and round half to even. Products are compared in fp32 within 1e-5
relative: the int8 codes agree exactly, and the rest is a few fp32
roundings in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidi_tpu.infer import quantize as jq
from vidi_tpu.ops import attention as jattn
from vidi_tpu_torch.infer import quantize as tq
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.ops import attention as tattn

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(jax.device_get(x))


def _rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    # rows of very different magnitude, so per-row and per-column scales matter
    gains = np.exp(rng.uniform(-3, 1, shape[:-1] + (1,)))
    return (rng.standard_normal(shape) * gains * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_is_bit_equal(dtype):
    w = _rand(0, (3, 96, 40))
    w[1, :, 5] = 0.0  # a zero column takes scale 1
    jw = jq.quantize_weight(jnp.asarray(w, getattr(jnp, dtype)))
    tw = tq.quantize_weight(torch.from_numpy(w).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(tw["qi8"].numpy(), _np(jw["qi8"]))
    np.testing.assert_array_equal(tw["scale"].numpy(), _np(jw["scale"]))
    assert tw["scale"].shape == (3, 1, 40) and tw["qi8"].dtype == torch.int8
    np.testing.assert_array_equal(
        tq.dequantize_weight(tw, torch.float32).numpy(),
        _np(jq.dequantize_weight(jw, jnp.float32)))


def test_quantize_weight4_packs_bit_equal():
    w = _rand(1, (2, 128, 24))
    jw = jq.quantize_weight4(jnp.asarray(w))
    tw = tq.quantize_weight4(torch.from_numpy(w))
    np.testing.assert_array_equal(tw["qi4"].numpy(), _np(jw["qi4"]))
    np.testing.assert_array_equal(tw["scale"].numpy(), _np(jw["scale"]))
    assert tw["qi4"].shape == (2, 64, 24) and tw["scale"].shape == (2, 2, 1, 24)
    np.testing.assert_array_equal(
        tq.dequantize_weight4(tw, torch.float32).numpy(),
        _np(jq.dequantize_weight4(jw, jnp.float32)))
    # a contraction dim the group does not tile falls back to int8
    odd = _rand(2, (40, 8))
    assert set(tq.quantize_weight4(torch.from_numpy(odd))) == {"qi8", "scale"}


def test_quantize_embedding_and_cache_are_bit_equal():
    e = _rand(3, (50, 32))
    je, te = jq.quantize_embedding(jnp.asarray(e)), tq.quantize_embedding(torch.from_numpy(e))
    np.testing.assert_array_equal(te["qi8"].numpy(), _np(je["qi8"]))
    np.testing.assert_array_equal(te["scale"].numpy(), _np(je["scale"]))
    assert te["scale"].shape == (50, 1)
    ids = np.array([[3, 49, 0], [7, 7, 12]])
    np.testing.assert_array_equal(
        tq.embed_lookup(te, torch.from_numpy(ids), torch.float32).numpy(),
        _np(jq.embed_lookup(je, jnp.asarray(ids), jnp.float32)))
    h = _rand(4, (5, 32))
    np.testing.assert_allclose(tq.tied_logits(torch.from_numpy(h), te).numpy(),
                               _np(jq.tied_logits(jnp.asarray(h), je)), **TOL)

    c = _rand(5, (2, 3, 17, 16))
    jc, tc = jq.quantize_cache(jnp.asarray(c)), tq.quantize_cache(torch.from_numpy(c))
    np.testing.assert_array_equal(tc["qi8"].numpy(), _np(jc["qi8"]))
    np.testing.assert_array_equal(tc["scale"].numpy(), _np(jc["scale"]))
    assert tc["scale"].shape == (2, 3, 17, 1)
    np.testing.assert_array_equal(tq.dequantize_cache(tc, torch.float32).numpy(),
                                  _np(jq.dequantize_cache(jc, jnp.float32)))


def test_quantize_act_is_bit_equal():
    x = _rand(6, (4, 9, 64))
    x[0, 2] = 0.0
    jx, js = jq.quantize_act(jnp.asarray(x))
    tx, ts = tq.quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(tx.numpy(), _np(jx))
    np.testing.assert_array_equal(ts.numpy(), _np(js))


@pytest.fixture
def w8a8(monkeypatch):
    def set_threshold(n):
        monkeypatch.setattr(jq, "w8a8_min_tokens", n)
        monkeypatch.setattr(tq, "w8a8_min_tokens", n)
    return set_threshold


@pytest.mark.parametrize("route", ["weight-only", "w8a8", "int4"])
def test_qdot_matches(route, w8a8):
    x = _rand(7, (2, 12, 128))
    w = _rand(8, (128, 48), 0.1)
    if route == "int4":
        jw, tw = jq.quantize_weight4(jnp.asarray(w)), tq.quantize_weight4(torch.from_numpy(w))
    else:
        jw, tw = jq.quantize_weight(jnp.asarray(w)), tq.quantize_weight(torch.from_numpy(w))
    w8a8(24 if route == "w8a8" else None)
    want = _np(jq.qdot(jnp.asarray(x), jw))
    got = tq.qdot(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if route == "w8a8":  # below the threshold the product is weight-only
        w8a8(25)
        np.testing.assert_allclose(tq.qdot(torch.from_numpy(x), tw).numpy(),
                                   _np(jq.qdot(jnp.asarray(x), jw)), **TOL)
        assert not np.allclose(tq.qdot(torch.from_numpy(x), tw).numpy(), got, rtol=0, atol=0)


def test_dynamic_qdense_with_bias():
    x = _rand(9, (30, 64))
    w = _rand(10, (64, 32), 0.1)
    b = _rand(11, (32,))
    jw, tw = jq.quantize_weight(jnp.asarray(w)), tq.quantize_weight(torch.from_numpy(w))
    want = _np(jq.dynamic_qdense(jnp.asarray(x), jw, jnp.asarray(b)))
    got = tq.dynamic_qdense(torch.from_numpy(x), tw, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_quantized_cache_cross_attention_matches():
    rng = np.random.default_rng(12)
    b, t, hq, hk, s, d = 2, 3, 4, 2, 19, 16
    q = (rng.standard_normal((b, t, hq, d)) * 3).astype(np.float32)
    k = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[1, 11:] = False
    jk, jv = jq.quantize_cache(jnp.asarray(k)), jq.quantize_cache(jnp.asarray(v))
    tk, tv = tq.quantize_cache(torch.from_numpy(k)), tq.quantize_cache(torch.from_numpy(v))
    for cap in (None, 5.0):
        want = _np(jattn.quantized_cache_cross_attention(
            jnp.asarray(q), jk, jv, kv_valid=jnp.asarray(valid), scale=0.25, softcap=cap))
        got = tattn.quantized_cache_cross_attention(
            torch.from_numpy(q), tk, tv, kv_valid=torch.from_numpy(valid), scale=0.25,
            softcap=cap)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_quantize_params_and_convert_keep_int8_and_fp32_scales():
    """quantize_params on a JAX tree, carried through params_from_jax with
    dtype=bf16: int8 stays int8, scales stay fp32, the stacked layers
    unstack per layer; the port's own quantize_params on the converted
    float tree gives the same codes, the tower FFN padded to 128."""
    from vidi_tpu.core.config import DattnConfig
    from vidi_tpu.models import dattn as jdattn

    cfg = DattnConfig.tiny()
    jp = jdattn.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    modules = ("text", "vision", "audio")
    jqp = jq.quantize_params(jp, modules=modules)
    conv = params_from_jax(jax.device_get(jqp), dtype=torch.bfloat16)
    lp = conv["text"]["layers"][1]
    assert len(conv["text"]["layers"]) == cfg.text.num_layers
    assert lp["q_w"]["qi8"].dtype == torch.int8 and lp["q_w"]["scale"].dtype == torch.float32
    assert lp["q_w"]["scale"].shape == (1, cfg.text.num_heads * cfg.text.head_dim)
    assert lp["input_ln"].dtype == torch.bfloat16
    np.testing.assert_array_equal(lp["q_w"]["qi8"].numpy(),
                                  _np(jqp["text"]["layers"]["q_w"]["qi8"][1]))
    vl = conv["vision"]["layers"][0]
    assert vl["fc1_w"]["qi8"].shape == (cfg.vision.hidden_size, 128)
    assert vl["fc1_b"].shape == (128,) and not vl["fc1_b"][cfg.vision.intermediate_size:].any()

    tqp = tq.quantize_params(params_from_jax(jax.device_get(jp)), modules=modules)
    for mod in modules:
        for i, layer in enumerate(tqp[mod]["layers"]):
            for key, val in layer.items():
                want = jqp[mod]["layers"][key]
                if isinstance(val, dict):
                    np.testing.assert_array_equal(val["qi8"].numpy(), _np(want["qi8"][i]))
                    np.testing.assert_array_equal(val["scale"].numpy(), _np(want["scale"][i]))
                else:
                    np.testing.assert_array_equal(val.numpy(), _np(want[i]))
    assert tq.quantized_bytes(tqp) == sum(
        x.size * x.dtype.itemsize for x in jax.tree.leaves(jqp))


def test_quantize_text_params_int4_and_embedding():
    from vidi_tpu.core.config import TextConfig
    from vidi_tpu.models import decoder as jdec

    cfg = dataclasses.replace(TextConfig.tiny(), intermediate_size=128)
    jp = jdec.init_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    jqp = jq.quantize_text_params(jp, quantize_embed=True, bits=4)
    tqp = tq.quantize_text_params(params_from_jax(jax.device_get(jp)),
                                  quantize_embed=True, bits=4)
    np.testing.assert_array_equal(tqp["embed"]["qi8"].numpy(), _np(jqp["embed"]["qi8"]))
    got = tqp["layers"][2]["down_w"]
    np.testing.assert_array_equal(got["qi4"].numpy(), _np(jqp["layers"]["down_w"]["qi4"][2]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  _np(jqp["layers"]["down_w"]["scale"][2]))


@pytest.mark.parametrize("quantized", [False, True])
def test_untied_lm_logits_match(quantized):
    """An untied lm_head (as Mistral's), float or int8 (`_quantized_logits`
    in JAX), with the final softcap."""
    from vidi_tpu.core.config import TextConfig
    from vidi_tpu.models import decoder as jdec
    from vidi_tpu_torch.models import decoder as tdec

    cfg = dataclasses.replace(TextConfig.tiny(), tie_word_embeddings=False, final_softcap=5.0)
    jp = jdec.init_params(jax.random.PRNGKey(2), cfg, jnp.float32)
    if quantized:
        jp = jq.quantize_text_params(jp)
    tp = params_from_jax(jax.device_get(jp))
    assert tq.is_quantized(tp["lm_head"]) == quantized
    h = _rand(13, (3, cfg.hidden_size))
    np.testing.assert_allclose(tdec.lm_logits(tp, torch.from_numpy(h), cfg).numpy(),
                               _np(jdec.lm_logits(jp, jnp.asarray(h), cfg)), **TOL)
