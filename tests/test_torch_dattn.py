"""The Dattn model of the port against vidi_tpu at the tiny configuration:
media encode, prefill `forward` (hidden states and all six caches),
`decode_step` logits, and greedy `generate` tokens, on the same weights
(params_from_jax) and the same numpy inputs, fp32 on the CPU.

Tolerance: atol = rtol = 2e-4 on hidden states, caches and logits (four
decoder layers, each with three attentions and FFNs over the streams,
compound the ops' fp32 differences). Generated tokens must be identical.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.infer import generate as jgen
from vidi_tpu.models import adapters as jadapters
from vidi_tpu.models import dattn as jdattn
from vidi_tpu.models import decoder as jdecoder
from vidi_tpu_torch.infer import generate as tgen
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.models import adapters as tadapters
from vidi_tpu_torch.models import dattn as tdattn
from vidi_tpu_torch.models import decoder as tdecoder
from torch_init import port_init  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
CFG = DattnConfig.tiny()
N_FRAMES, MEL_LEN = 5, 4000


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def model():
    jp = port_init(CFG, 0)
    return jp, params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def media(model):
    """(jax features, port features) for a 5-frame uint8 clip and 2 audio
    windows, encoded by each package with its own code."""
    jp, tp = model
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (1, N_FRAMES, 42, 42, 3), dtype=np.uint8)
    mels = rng.standard_normal((1, 2, 128, 3000)).astype(np.float32)
    hw = jadapters.budget_hw(N_FRAMES, 2, CFG.vision.num_patches_per_side)
    counts, sizes = np.array([N_FRAMES]), np.array([MEL_LEN])
    j_img = jdattn.encode_video_images(jp, CFG, jnp.asarray(frames),
                                       jnp.asarray(counts), hw, mm_chunks=2)
    j_aud = jdattn.encode_video_audios(jp, CFG, jnp.asarray(mels),
                                       jnp.asarray(sizes), mm_chunks=2)
    t_img = tdattn.encode_video_images(tp, CFG, _t(frames), _t(counts), hw,
                                       mm_chunks=2)
    t_aud = tdattn.encode_video_audios(tp, CFG, _t(mels), _t(sizes), mm_chunks=2)
    return (*j_img, *j_aud), (*t_img, *t_aud)


@pytest.fixture(scope="module")
def prompt():
    """Two right-padded prompts of 13 and 9 tokens in a 16 bucket."""
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 259, (2, 16)).astype(np.int32)
    mask = np.zeros((2, 16), bool)
    mask[0, :13], mask[1, :9] = True, True
    return ids * mask, mask


def _media2(feats):
    """Batch-1 media features repeated for the two prompt rows."""
    img, img_mask, aud, aud_mask = feats
    rep = (lambda x: jnp.repeat(x, 2, axis=0)) if isinstance(img, jax.Array) \
        else (lambda x: x.repeat_interleave(2, dim=0))
    return rep(img), rep(img_mask), rep(aud), rep(aud_mask)


def test_media_encode_matches(media):
    for got, want in zip(media[1], media[0]):
        _close(got, want)


def test_budget_hw_and_resize_pool_match():
    for n in (1, 120, 400, 3600):
        assert tadapters.budget_hw(n, 2) == jadapters.budget_hw(n, 2)
    feats = np.random.default_rng(2).standard_normal((2, 13, 13, 8)).astype(np.float32)
    for hw in ((14, 14), (10, 10)):  # padded grid as is, and budget-resized
        _close(tadapters.conv2d_pool(_t(feats), hw),
               jadapters.conv2d_pool(jnp.asarray(feats), hw), dict(atol=1e-5, rtol=1e-5))


def test_fold_o_w_matches(model):
    jp, tp = model
    want = jdattn._fold_o_w(jp["text"]["layers"]["o_w"][1], CFG.text)
    _close(tdattn._fold_o_w(tp["text"]["layers"][1]["o_w"], CFG.text), want,
           dict(atol=0, rtol=0))


def _forward_inputs(model, media, prompt):
    """Prefill inputs for both packages; both take the JAX-encoded media."""
    jp, tp = model
    ids, mask = prompt
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    j_media = _media2(media[0])
    j_in = (jdecoder.embed_tokens(jp["text"], jnp.asarray(ids), CFG.text),
            jnp.asarray(mask), jnp.asarray(pos), *j_media)
    t_in = (tdecoder.embed_tokens(tp["text"], _t(ids).long(), CFG.text),
            _t(mask), _t(pos).long(), *(_t(x) for x in j_media))
    return j_in, t_in


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_hidden_and_caches_match(model, media, prompt, use_flash):
    """use_flash=True runs the kernels' plain versions on the CPU; their
    window rule is by index, so padded query rows (and the text-cache slots
    they fill) may differ there and only real rows are compared."""
    jp, tp = model
    j_in, t_in = _forward_inputs(model, media, prompt)
    want_h, want_c = jdattn.forward(jp, CFG, *j_in, mm_chunks=3, return_caches=True)
    got_h, got_c = tdattn.forward(tp, CFG, *t_in, mm_chunks=3, return_caches=True,
                                  use_flash=use_flash)
    mask = prompt[1]
    rows = np.broadcast_to(mask[..., None], want_h.shape) if use_flash else \
        np.ones(want_h.shape, bool)
    np.testing.assert_allclose(got_h.numpy()[rows], np.asarray(want_h)[rows], **TOL)
    for name in want_c._fields:
        want, got = np.asarray(getattr(want_c, name)), getattr(got_c, name).numpy()
        if use_flash and name.startswith("text"):
            keep = np.broadcast_to(mask[None, :, None, :, None], want.shape)
            want, got = want[keep], got[keep]
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_decode_step_matches(model, media, prompt, use_flash):
    jp, tp = model
    j_in, t_in = _forward_inputs(model, media, prompt)
    _, caches = jdattn.forward(jp, CFG, *j_in, return_caches=True)
    pad = lambda c: jnp.pad(c, ((0, 0),) * 3 + ((0, 4), (0, 0)))  # noqa: E731
    caches = caches._replace(text_k=pad(caches.text_k), text_v=pad(caches.text_v))
    t_caches = tdattn.Caches(*(_t(c) for c in caches))
    cur_len = prompt[1].sum(axis=1).astype(np.int32)
    tok = np.array([[77], [78]], np.int32)
    img_mask, aud_mask = j_in[4], j_in[6]
    want, want_c = jdattn.decode_step(
        jp, CFG, jdecoder.embed_tokens(jp["text"], jnp.asarray(tok), CFG.text),
        jnp.asarray(cur_len), caches, img_mask=img_mask, aud_mask=aud_mask)
    got, got_c = tdattn.decode_step(
        tp, CFG, tdecoder.embed_tokens(tp["text"], _t(tok).long(), CFG.text),
        _t(cur_len).long(), t_caches, img_mask=t_in[4], aud_mask=t_in[6],
        use_flash=use_flash)
    _close(got, want)
    assert got_c.text_k is t_caches.text_k  # written in place
    _close(got_c.text_k, want_c.text_k)
    _close(got_c.text_v, want_c.text_v)


@pytest.mark.parametrize("use_flash", [False, True])
def test_generate_tokens_identical(model, media, prompt, use_flash):
    jp, tp = model
    ids, mask = prompt
    j_img, j_img_mask, j_aud, j_aud_mask = _media2(media[0])
    want = jgen.generate(jp, CFG, jnp.asarray(ids), jnp.asarray(mask), j_img,
                         j_img_mask, j_aud, j_aud_mask, max_new_tokens=8, eos_id=2)
    t_media = [_t(x) for x in (j_img, j_img_mask, j_aud, j_aud_mask)]
    got = tgen.generate(tp, CFG, _t(ids).long(), _t(mask), *t_media,
                        max_new_tokens=8, eos_id=2, use_flash=use_flash,
                        use_flash_decode=use_flash)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.decode_steps == 7


def test_generate_stops_at_keyword(model, media, prompt):
    """A stop sequence made of row 0's first two tokens ends row 0 there:
    every later token of that row is eos, as in vidi_tpu."""
    jp, tp = model
    ids, mask = prompt
    t_media = [_t(x) for x in _media2(media[0])]
    free = tgen.generate(tp, CFG, _t(ids).long(), _t(mask), *t_media,
                         max_new_tokens=6, eos_id=2)
    stop = tuple(int(x) for x in free.tokens[0, :2])
    got = tgen.generate(tp, CFG, _t(ids).long(), _t(mask), *t_media,
                        max_new_tokens=6, eos_id=2, stop_sequences=(stop,))
    assert got.tokens[0, :2].tolist() == list(stop)
    assert (got.tokens[0, 2:] == 2).all()
