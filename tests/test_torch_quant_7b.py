"""The quantized Vidi-7B in the port against vidi_tpu, fp32 on the CPU: a
tiny Mistral / CLIP / v1 model at the 7B's grouping (8 query heads over 2
KV heads: G = 4) and its tower's quick_gelu, on the same weights.

Both packages start from one float tree (the port's init, stacked into
vidi_tpu's layout) and each quantizes its own copy as its loader does:
vidi_tpu's `quantize_params`, the port's per-layer quantizers of
`load_model` and its untied `lm_head`. Two cases:

- "int8": `load_8bit` + `load_8bit_towers`, W8A8 from W8A8_MIN rows, int8
  modality caches;
- "int4": `load_4bit`, the untied lm_head group-wise int4 as well.

Held, each with its tolerance:
- every text layer's codes and scales and the lm_head's: bit-equal;
- the int8 CLIP tower (D = 128, quick_gelu, eps 1e-5, a class token): K5's
  plain version against JAX's fused layer in interpret mode, as
  tests/test_torch_quant_model.py holds SigLIP and Whisper: INT8_REL = 1e-2
  relative (Frobenius) error, for the reason given there (a LayerNorm
  output within fp32 rounding of an int8 boundary takes the neighbouring
  code, which moves its row by 1/127 of the row's largest value);
- the v1 media features of each model's own encode: int8 towers (the tiny
  tower, D = 32, takes JAX's jnp route) INT8_REL as above (the audio reads
  1.1e-3: a few codes re-rounded), the rest atol = rtol = 2e-4;
- prefill hidden states, the caches (int8 ones dequantized) and the step-0
  logits: int4, atol = rtol = 2e-4 (the tolerance of tests/test_torch_dattn.py
  and tests/test_torch_quant_model.py); int8, INT8_REL. W8A8 from 16 rows
  quantizes the text prompt's activations too, and the two frameworks'
  fp32 products differ in summation order (2.5e-7 relative on the
  weight-only route), so a row now and then takes the neighbouring code at
  a rounding tie: the port reads 2.7e-3 against JAX op by op, where JAX's
  own jitted and op-by-op runs differ by 5.6e-3;
- greedy tokens and `ask`'s parsed answer and generated ids: identical.

The prefill's JAX side runs op by op (`jax.disable_jit`), generate and
`ask` jitted, as in tests/test_torch_quant_model.py.
"""
import contextlib
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidi_tpu.core.config import DattnConfig, VisionConfig
from vidi_tpu.infer import generate as jgen
from vidi_tpu.infer import pipeline as jpipe
from vidi_tpu.infer import quantize as jq
from vidi_tpu.models import dattn as jdattn
from vidi_tpu.models import decoder as jdecoder
from vidi_tpu.models import siglip as jsiglip
from vidi_tpu.ops.pallas import fused_tower_layer as jftl
from vidi_tpu_torch.infer import generate as tgen
from vidi_tpu_torch.infer import loader as tloader
from vidi_tpu_torch.infer import pipeline as tpipe
from vidi_tpu_torch.infer import quantize as tq
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.models import dattn as tdattn
from vidi_tpu_torch.models import decoder as tdecoder
from vidi_tpu_torch.models import siglip as tsiglip
from torch_init import stacked  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from make_example import make_video  # noqa: E402
from test_torch_pipeline import _RecordingTokenizer  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
INT8_REL = 1e-2  # the int8 tower against the fused route; see the docstring
W8A8_MIN = 16
_MISTRAL = DattnConfig.tiny("mistral")
CFG = dataclasses.replace(_MISTRAL, text=dataclasses.replace(_MISTRAL.text, num_heads=8))
MODES = {"int8": dict(load_8bit=True, load_8bit_towers=True),
         "int4": dict(load_4bit=True)}
N_FRAMES, N_WINDOWS = 6, 1  # the 6 s clip at 1 fps
QUERY = "a moving gradient"


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@contextlib.contextmanager
def _w8a8(mode: str):
    """W8A8 from W8A8_MIN rows in both packages on the int8 case."""
    saved = jq.w8a8_min_tokens, tq.w8a8_min_tokens
    if mode == "int8":
        jq.w8a8_min_tokens = tq.w8a8_min_tokens = W8A8_MIN
    try:
        yield
    finally:
        jq.w8a8_min_tokens, tq.w8a8_min_tokens = saved


def _jax_quantized(tree, mode: str):
    if mode == "int8":
        return jq.quantize_params(tree, modules=("text", "vision", "audio"))
    return jq.quantize_params(tree, modules=("text",), bits=4)


def _port_quantized(tp, mode: str):
    """The port's tree quantized as `load_model` quantizes it: each layer
    by the loader's text / tower function, then the untied lm_head."""
    text_fn, tower_fn = tloader._quantizers(**{"load_8bit": False, "load_8bit_towers": False,
                                               "load_4bit": False, **MODES[mode]})
    for module, fn in (("text", text_fn), ("vision", tower_fn), ("audio", tower_fn)):
        if fn is not None:
            tp[module]["layers"] = [fn(lp) for lp in tp[module]["layers"]]
    tloader._quantize_lm_head(tp, text_fn, MODES[mode].get("load_4bit", False))
    return tp


@pytest.fixture(scope="module")
def models():
    """{mode: (vidi_tpu's quantized tree, the port's)} from one float tree."""
    floats = stacked(tdattn.init_params(CFG, torch.float32, "cpu", 0))
    return {mode: (_jax_quantized(jax.tree.map(jnp.asarray, floats), mode),
                   _port_quantized(params_from_jax(floats), mode)) for mode in MODES}


def _codes(w):
    return {k: np.asarray(v) for k, v in w.items()}


@pytest.mark.parametrize("mode", list(MODES))
def test_quantized_text_weights_and_lm_head_bit_equal(models, mode):
    jp, tp = models[mode]
    key = tq.QUANT4_KEY if mode == "int4" else tq.QUANT_KEY
    head = tp["text"]["lm_head"]
    assert key in head and head[key].dtype == torch.int8
    for k, want in _codes(jp["text"]["lm_head"]).items():
        np.testing.assert_array_equal(head[k].numpy(), want, err_msg=f"lm_head {k}")
    for i, lp in enumerate(tp["text"]["layers"]):
        for name in tq._TEXT_QUANT_KEYS:
            for k, want in _codes(jp["text"]["layers"][name]).items():
                np.testing.assert_array_equal(lp[name][k].numpy(), want[i],
                                              err_msg=f"layer {i} {name} {k}")
    towers = tq.is_quantized(tp["vision"]["layers"][0]["fc1_w"])
    assert towers == (mode == "int8")


def test_int8_clip_tower_matches_fused_route(monkeypatch):
    """CLIP at D = 128 (the fused route's tiling), ff 256, quick_gelu, eps
    1e-5, 4 x 4 patches and the class token: K5's plain version against
    JAX's fused layer in interpret mode."""
    monkeypatch.setattr(jftl, "INTERPRET", True)
    cfg = dataclasses.replace(VisionConfig.tiny("clip"), hidden_size=128, intermediate_size=256,
                              num_heads=2, image_size=56)
    assert cfg.hidden_act == "quick_gelu" and cfg.layer_norm_eps == 1e-5
    floats = stacked(tsiglip.init_params(cfg, torch.float32, "cpu",
                                         torch.Generator().manual_seed(5)))
    jp = jq.quantize_tower_params(jax.tree.map(jnp.asarray, floats))
    assert jftl.use_fused(jax.tree.map(lambda a: a[0], jp["layers"]))
    tp = params_from_jax(floats)
    tp = {**tp, "layers": [tq.quantize_tower_layer(lp) for lp in tp["layers"]]}
    x = np.random.default_rng(6).uniform(-1, 1, (2, 56, 56, 3)).astype(np.float32)
    want = jsiglip.forward_features(jp, jnp.asarray(x), cfg)
    got = tsiglip.forward_features(tp, _t(x), cfg).numpy()
    assert got.shape == (2, 16, 128)  # the class token dropped
    err = _rel_err(got, want)
    assert err <= INT8_REL, f"relative error {err:.3e} over {INT8_REL}"


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("media") / "clip.mp4")
    make_video(path, seconds=6.0)
    return path


@pytest.fixture(scope="module")
def media(models, clip):
    """{mode: (jax features, port features)} of the clip's frames and mel
    windows (decoded once on the host), each package encoding with its own
    quantized model as `ask` does (mm_chunks=4; JAX's compiles are then
    shared with `ask`'s)."""
    host = jpipe.decode_media_host(clip, CFG)
    out = {}
    for mode, (jp, tp) in models.items():
        out[mode] = (jpipe.encode_media_arrays(jp, CFG, *host, mm_chunks=4),
                     tpipe.encode_media_arrays(tp, CFG, *host, mm_chunks=4))
    return out


@pytest.fixture(scope="module")
def prompt():
    """Two right-padded prompts of 27 and 19 tokens in a 32 bucket (past the
    tiny config's 16-key window)."""
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 259, (2, 32)).astype(np.int32)
    mask = np.zeros((2, 32), bool)
    mask[0, :27], mask[1, :19] = True, True
    return ids * mask, mask


def _rows2(feats):
    return tuple(jnp.repeat(x, 2, axis=0) for x in feats)


@pytest.mark.parametrize("mode", list(MODES))
def test_media_encode_matches(media, mode):
    j, t = media[mode]
    assert t[0].shape == (1, N_FRAMES * CFG.mm_image_pool_size**2, CFG.text.hidden_size)
    assert t[2].shape[1] == 300 * N_WINDOWS
    for name, got, want in zip(("img", "img_mask", "aud", "aud_mask"), t, j):
        if mode == "int8" and name in ("img", "aud"):  # int8 towers
            err = _rel_err(got.numpy(), want)
            assert err <= INT8_REL, f"{name}: relative error {err:.3e} over {INT8_REL}"
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **TOL)


@pytest.fixture(scope="module")
def prefill(models, media, prompt):
    """{mode: ((jax hidden, caches, step-0 logits), (the port's))}: one
    forward over both prompts and the media (int8 caches on the int8 case),
    and the logits at each row's last prompt token."""
    ids, mask = prompt
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    last = mask.sum(axis=1) - 1
    out = {}
    for mode, (jp, tp) in models.items():
        j_media = _rows2(media[mode][0])
        quant = mode == "int8"
        with _w8a8(mode), jax.disable_jit():
            jh, jc = jdattn.forward(
                jp, CFG, jdecoder.embed_tokens(jp["text"], jnp.asarray(ids), CFG.text),
                jnp.asarray(mask), jnp.asarray(pos), *j_media, mm_chunks=3,
                return_caches=True, quantize_caches=quant)
            jl = jdecoder.lm_logits(jp["text"], jh[np.arange(2), last], CFG.text)
        with _w8a8(mode):
            th, tc = tdattn.forward(
                tp, CFG, tdecoder.embed_tokens(tp["text"], _t(ids).long(), CFG.text),
                _t(mask), _t(pos).long(), *(_t(x) for x in j_media), mm_chunks=3,
                return_caches=True, quantize_caches=quant)
            tl = tdecoder.lm_logits(tp["text"], th[torch.arange(2), _t(last)], CFG.text)
        out[mode] = (jh, jc, jl), (th, tc, tl)
    return out


def _close(got, want, mode: str, name: str) -> None:
    """int4: atol = rtol = 2e-4; int8: INT8_REL (see the module docstring)."""
    if mode == "int4":
        np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **TOL)
    else:
        err = _rel_err(got, want)
        assert err <= INT8_REL, f"{name}: relative error {err:.3e} over {INT8_REL}"


@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_hidden_caches_and_step0_logits_match(prefill, mode):
    (jh, jc, jl), (th, tc, tl) = prefill[mode]
    _close(th.numpy(), jh, mode, "hidden")
    for name in jc._fields:
        got, want = getattr(tc, name), getattr(jc, name)
        if mode == "int8" and not name.startswith("text"):
            assert got["qi8"].dtype == torch.int8 and got["scale"].shape[-1] == 1
            got, want = tq.dequantize_cache(got, torch.float32), jq.dequantize_cache(
                want, jnp.float32)
        _close(got.numpy(), want, mode, name)
    assert tl.shape == (2, CFG.text.vocab_size)
    _close(tl.numpy(), jl, mode, "step-0 logits")


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_tokens_identical(models, media, prompt, mode):
    jp, tp = models[mode]
    ids, mask = prompt
    j_media = _rows2(media[mode][0])
    kw = dict(max_new_tokens=8, eos_id=2, mm_chunks=3, quantize_caches=mode == "int8")
    with _w8a8(mode):
        want = jgen.generate(jp, CFG, jnp.asarray(ids), jnp.asarray(mask), *j_media, **kw)
        got = tgen.generate(tp, CFG, _t(ids).long(), _t(mask), *(_t(x) for x in j_media), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


@pytest.mark.parametrize("mode", list(MODES))
def test_ask_gives_the_same_answer(clip, models, mode):
    jp, tp = models[mode]
    kw = dict(max_new_tokens=12, mm_chunks=4, use_flash=False,
              quantize_caches=mode == "int8")
    jtok, ttok = _RecordingTokenizer(), _RecordingTokenizer()
    with _w8a8(mode):
        want = jpipe.ask(QUERY, clip, jp, CFG, jtok, **kw)
        got = tpipe.ask(QUERY, clip, tp, CFG, ttok, **kw)
    assert got == want
    assert ttok.decoded == jtok.decoded and any(ttok.decoded)
