"""The long-video path of the port against vidi_tpu at the tiny configuration
in fp32 on the CPU, same weights (params_from_jax) and numpy inputs: media
caches prefilled once (`media_prefill`) and chunk by chunk
(`stream_chunk_caches`, `media_prefill_chunked`), the text prefill of
several query rows against batch-1 caches (`text_prefill_with_caches`), and
`generate(media_caches=)`; plus the cached branch of `_xattn_block`: T > 1
query tokens, the fold of rows onto a shared cache, and its routes.

Tolerance: atol = rtol = 2e-5 on caches and hidden states (fp32, the same
ops in another summation order); int8 cache codes equal, with the JAX side
run op by op (`jax.disable_jit`) as tests/test_torch_quant_model.py runs
it: under jit XLA fuses the projections and rounds a value lying at an
int8 rounding boundary the other way now and then; the port's chunked
caches against its own `media_prefill` within 1e-6 (the same arithmetic,
products of other row counts); greedy tokens identical.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.infer import generate as jgen
from vidi_tpu.models import dattn as jdattn
from vidi_tpu.models import decoder as jdecoder
from vidi_tpu_torch.infer import generate as tgen
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.models import dattn as tdattn
from vidi_tpu_torch.models import decoder as tdecoder
from vidi_tpu_torch.ops.cuda import decode_attention as k3
from vidi_tpu_torch.ops.cuda import flash_attention as k1
from torch_init import port_init  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
CFG = DattnConfig.tiny()
D = CFG.text.hidden_size
S_IMG, S_AUD = 37, 20   # stream tokens: a 5-token tail at chunk_tokens=16
ROWS, T = 3, 12         # query rows and their padded prompt length


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL, err_msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=err_msg, **tol)


def _close_cache(got, want, name, tol=TOL):
    """A bf16-layout cache, or an int8 one (codes equal, scales close)."""
    if isinstance(want, dict):
        np.testing.assert_array_equal(got["qi8"].numpy(), np.asarray(want["qi8"]),
                                      err_msg=name)
        _close(got["scale"], want["scale"], tol, name)
    else:
        _close(got, want, tol, name)


def _jax_side(quantize: bool):
    """JAX op by op where int8 codes are compared (see the docstring)."""
    return jax.disable_jit() if quantize else contextlib.nullcontext()


def _media_fields(c):
    return {n: getattr(c, n) for n in ("img_k", "img_v", "aud_k", "aud_v")}


@pytest.fixture(scope="module")
def model():
    jp = port_init(CFG, 5)
    return jp, params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def streams():
    """Batch-1 raw adapter outputs (scale of the encoders' normed tokens)
    and masks: the last 9 image tokens (a frame) and 6 audio tokens hidden."""
    rng = np.random.default_rng(11)
    img = (rng.standard_normal((1, S_IMG, D)) * 0.5).astype(np.float32)
    aud = (rng.standard_normal((1, S_AUD, D)) * 0.5).astype(np.float32)
    return img, np.arange(S_IMG)[None] < S_IMG - 9, aud, np.arange(S_AUD)[None] < S_AUD - 6


@pytest.fixture(scope="module")
def prompts():
    """ROWS right-padded prompts of 12, 9 and 5 tokens."""
    rng = np.random.default_rng(12)
    ids = rng.integers(3, CFG.text.vocab_size, (ROWS, T)).astype(np.int32)
    mask = np.zeros((ROWS, T), bool)
    for r, n in enumerate((12, 9, 5)):
        mask[r, :n] = True
    return ids * mask, mask


@pytest.mark.parametrize("quantize", [False, True])
def test_media_prefill_matches(model, streams, quantize):
    jp, tp = model
    with _jax_side(quantize):
        want = jdattn.media_prefill(jp, CFG, *(jnp.asarray(x) for x in streams),
                                    mm_chunks=3, quantize_caches=quantize)
    got = tdattn.media_prefill(tp, CFG, *(_t(x) for x in streams), mm_chunks=3,
                               quantize_caches=quantize)
    assert got.text_k is None and got.text_v is None
    for name, w in _media_fields(want).items():
        _close_cache(getattr(got, name), w, name)


@pytest.mark.parametrize("quantize", [False, True])
def test_stream_chunk_caches_matches(model, streams, quantize):
    jp, tp = model
    chunk = streams[0][:, :16]
    with _jax_side(quantize):
        want = jdattn.stream_chunk_caches(jp, CFG, jnp.asarray(chunk),
                                          quantize_caches=quantize)
    got = tdattn.stream_chunk_caches(tp, CFG, _t(chunk), quantize_caches=quantize)
    for g, w, name in zip(got, want, ("k", "v")):
        _close_cache(g, w, name)


@pytest.mark.parametrize("quantize", [False, True])
def test_media_prefill_chunked_matches(model, streams, quantize):
    """chunk_tokens=16 on S = 37 image tokens: two whole chunks and a padded
    tail of 5; the audio stream (20) a chunk and a tail of 4."""
    jp, tp = model
    img, _, aud, _ = streams
    with _jax_side(quantize):
        want = jdattn.media_prefill_chunked(jp, CFG, jnp.asarray(img), jnp.asarray(aud),
                                            chunk_tokens=16, quantize_caches=quantize)
    got = tdattn.media_prefill_chunked(tp, CFG, _t(img), _t(aud), chunk_tokens=16,
                                       quantize_caches=quantize)
    assert got.text_k is None
    for name, w in _media_fields(want).items():
        g = getattr(got, name)
        assert (g["qi8"] if quantize else g).shape[3] == (S_IMG if "img" in name else S_AUD)
        _close_cache(g, w, name)


@pytest.mark.parametrize("chunk_tokens", [1, 16, 37, 64])
def test_chunked_caches_do_not_depend_on_the_chunk(model, streams, chunk_tokens):
    _, tp = model
    img, img_mask, aud, aud_mask = (_t(x) for x in streams)
    want = tdattn.media_prefill(tp, CFG, img, img_mask, aud, aud_mask)
    got = tdattn.media_prefill_chunked(tp, CFG, img, aud, chunk_tokens=chunk_tokens)
    for name, w in _media_fields(want).items():
        _close(getattr(got, name), w, dict(atol=1e-6, rtol=1e-6), name)


def _prefill_inputs(params, prompts, jax_side: bool):
    ids, mask = prompts
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    if jax_side:
        emb = jdecoder.embed_tokens(params["text"], jnp.asarray(ids), CFG.text)
        return emb, jnp.asarray(mask), jnp.asarray(pos)
    emb = tdecoder.embed_tokens(params["text"], _t(ids).long(), CFG.text)
    return emb, _t(mask), _t(pos).long()


@pytest.fixture(scope="module")
def shared(model, streams):
    """JAX's batch-1 media caches, and the same as port tensors."""
    jp, _ = model
    media = jdattn.media_prefill(jp, CFG, *(jnp.asarray(x) for x in streams))
    return media, tdattn.Caches(*(None if c is None else _t(c) for c in media))


@pytest.mark.parametrize("use_flash", [False, True])
def test_text_prefill_with_caches_matches(model, streams, prompts, shared, use_flash):
    """Three rows on batch-1 caches. use_flash=True runs the kernels' plain
    versions (the folded rows through K1's); their window rule is by index,
    so only real prompt rows (and their text-cache slots) are compared
    there."""
    jp, tp = model
    _, img_mask, _, aud_mask = streams
    want_h, want_c = jdattn.text_prefill_with_caches(
        jp, CFG, *_prefill_inputs(jp, prompts, True), shared[0],
        img_mask=jnp.asarray(img_mask), aud_mask=jnp.asarray(aud_mask))
    got_h, got_c = tdattn.text_prefill_with_caches(
        tp, CFG, *_prefill_inputs(tp, prompts, False), shared[1],
        img_mask=_t(img_mask), aud_mask=_t(aud_mask), use_flash=use_flash)
    mask = prompts[1] if use_flash else np.ones_like(prompts[1])
    rows = np.broadcast_to(mask[..., None], want_h.shape)
    np.testing.assert_allclose(got_h.numpy()[rows], np.asarray(want_h)[rows], **TOL)
    keep = np.broadcast_to(mask[None, :, None, :, None], want_c.text_k.shape)
    for name in ("text_k", "text_v"):
        assert getattr(got_c, name).shape == (CFG.text.num_layers, ROWS,
                                              *getattr(want_c, name).shape[2:])
        np.testing.assert_allclose(getattr(got_c, name).numpy()[keep],
                                   np.asarray(getattr(want_c, name))[keep],
                                   err_msg=name, **TOL)
    for name, c in _media_fields(got_c).items():
        assert c is getattr(shared[1], name)  # passed through, batch 1


def test_text_prefill_matches_forward_with_broadcast_media(model, streams, prompts):
    """The port's shared-cache prefill against its own full forward with the
    media repeated for every row (the plain path redoes the stream per row)."""
    _, tp = model
    img, img_mask, aud, aud_mask = (_t(x) for x in streams)
    inputs = _prefill_inputs(tp, prompts, False)
    media = tdattn.media_prefill(tp, CFG, img, img_mask, aud, aud_mask)
    got_h, got_c = tdattn.text_prefill_with_caches(tp, CFG, *inputs, media,
                                                   img_mask=img_mask, aud_mask=aud_mask)
    rep = lambda x: x.expand(ROWS, *x.shape[1:])  # noqa: E731
    want_h, want_c = tdattn.forward(tp, CFG, *inputs, img=rep(img), img_mask=rep(img_mask),
                                    aud=rep(aud), aud_mask=rep(aud_mask),
                                    return_caches=True)
    _close(got_h, want_h.numpy())
    _close(got_c.text_k, want_c.text_k.numpy())
    _close(got_c.text_v, want_c.text_v.numpy())
    assert got_c.img_k.shape[1] == 1 and got_c.text_k.shape[1] == ROWS


@pytest.mark.parametrize("quantize,rows", [(False, 1), (False, 3), (True, 1), (True, 3)])
def test_generate_with_media_caches_tokens_identical(model, streams, prompts, quantize,
                                                     rows):
    jp, tp = model
    _, img_mask, _, aud_mask = streams
    ids, mask = (x[:rows] for x in prompts)
    media = jdattn.media_prefill(jp, CFG, *(jnp.asarray(x) for x in streams),
                                 quantize_caches=quantize)
    want = jgen.generate(jp, CFG, jnp.asarray(ids), jnp.asarray(mask),
                         img_mask=jnp.asarray(img_mask), aud_mask=jnp.asarray(aud_mask),
                         max_new_tokens=8, eos_id=2, media_caches=media)
    t_media = tdattn.media_prefill(tp, CFG, *(_t(x) for x in streams),
                                   quantize_caches=quantize)
    got = tgen.generate(tp, CFG, _t(ids).long(), _t(mask), img_mask=_t(img_mask),
                        aud_mask=_t(aud_mask), max_new_tokens=8, eos_id=2,
                        media_caches=t_media)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


def test_generate_refuses_media_with_media_caches(model, streams, prompts, shared):
    _, tp = model
    img, img_mask, _, aud_mask = (_t(x) for x in streams)
    with pytest.raises(ValueError, match="media_caches"):
        tgen.generate(tp, CFG, _t(prompts[0]).long(), _t(prompts[1]), img=img,
                      img_mask=img_mask, aud_mask=aud_mask, max_new_tokens=2,
                      media_caches=shared[1])


def test_generate_refuses_quantize_caches_with_media_caches(model, streams, prompts,
                                                            shared):
    _, tp = model
    _, img_mask, _, aud_mask = (_t(x) for x in streams)
    with pytest.raises(ValueError, match="quantize_caches"):
        tgen.generate(tp, CFG, _t(prompts[0]).long(), _t(prompts[1]), img_mask=img_mask,
                      aud_mask=aud_mask, max_new_tokens=2, quantize_caches=True,
                      media_caches=shared[1])


def _cached_block(tp, shared, q, use_flash, layer=1):
    """The cached branch of `_xattn_block` on layer `layer`'s image cache."""
    mask = _t(np.arange(S_IMG)[None] < S_IMG - 9)
    kv = (tdattn._layer_slice(shared[1].img_k, layer),
          tdattn._layer_slice(shared[1].img_v, layer))
    return tdattn._xattn_block(tp["text"]["layers"][layer], q, None, mask, CFG.text, 1,
                               kv=kv, use_flash=use_flash)[0]


def _queries(b, t, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, t, CFG.text.num_heads, CFG.text.head_dim)
    return _t(rng.standard_normal(shape).astype(np.float32))


def test_cached_branch_reads_every_query_token(model, shared):
    """T = 4 query tokens against a cache with use_flash (the kernels' plain
    versions on the CPU) give what `cross_attention` gives: every token is
    read, not only the first."""
    _, tp = model
    q = _queries(1, 4)
    want = _cached_block(tp, shared, q, use_flash=False)
    got = _cached_block(tp, shared, q, use_flash=True)
    assert got.shape == (1, 4, D)
    _close(got, want.numpy())


@pytest.mark.parametrize("t", [1, 4])
def test_folded_rows_equal_rows_one_by_one(model, shared, t):
    """Three query rows on the batch-1 cache, folded, give each row's own
    result, on both routes."""
    _, tp = model
    q = _queries(3, t, seed=t)
    for use_flash in (False, True):
        got = _cached_block(tp, shared, q, use_flash)
        want = torch.cat([_cached_block(tp, shared, q[r:r + 1], use_flash) for r in range(3)])
        _close(got, want.numpy(), err_msg=f"use_flash={use_flash}")


def test_folded_rows_route_to_k1_and_one_row_to_k3(model, shared, monkeypatch):
    """use_flash: a decode step of 3 rows on a batch-1 cache folds to one
    row of 3 query tokens and takes K1 on the transposed cache view (no
    copy); one row's decode step takes K3 on the cache as it is; a prefill
    of one row takes K1."""
    _, tp = model
    calls = []

    def spy(name, fn):
        def run(q, k, *args, **kw):
            calls.append((name, tuple(q.shape), k))
            return fn(q, k, *args, **kw)
        return run

    monkeypatch.setattr(k1, "flash_attention", spy("K1", k1.flash_attention))
    monkeypatch.setattr(k3, "decode_attention", spy("K3", k3.decode_attention))
    cache_k = tdattn._layer_slice(shared[1].img_k, 1)
    h, hd = CFG.text.num_heads, CFG.text.head_dim
    for b, t, route, q_shape in ((3, 1, "K1", (1, 3, h, hd)), (1, 1, "K3", (1, h, hd)),
                                 (1, 4, "K1", (1, 4, h, hd))):
        calls.clear()
        _cached_block(tp, shared, _queries(b, t), use_flash=True)
        (name, shape, k), = calls
        assert (name, shape) == (route, q_shape)
        assert k.data_ptr() == cache_k.data_ptr()
        want = cache_k.transpose(1, 2) if route == "K1" else cache_k
        assert k.shape == want.shape and k.stride() == want.stride()
