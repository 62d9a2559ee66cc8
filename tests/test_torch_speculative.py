"""Speculative decoding in the port against vidi_tpu at the tiny
configuration in fp32 on the CPU, same weights (params_from_jax) and numpy
inputs, use_flash=False on both sides: `verify_step` (per-row media, shared
batch-1 media caches folded across the rows, int8 caches; and the port's
own verify pass against W sequential decode steps), greedy
`speculative_generate` with the n-gram draft and a tiny draft model, and
`ask` / the CLI with the n-gram draft.

Tolerances: logits and text caches atol = rtol = 2e-4 (those of
tests/test_torch_dattn.py, the same layers). Greedy speculative decoding
is deterministic: tokens, lengths, target passes, drafted and accepted
counts must be identical to vidi_tpu's, and the tokens equal to the port's
greedy `generate`'s.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.infer import generate as jgen
from vidi_tpu.infer import pipeline as jpipe
from vidi_tpu.media.text import ByteTokenizer
from vidi_tpu.models import dattn as jdattn
from vidi_tpu.models import decoder as jdecoder
from vidi_tpu_torch.infer import generate as tgen
from vidi_tpu_torch.infer import pipeline as tpipe
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.models import dattn as tdattn
from vidi_tpu_torch.models import decoder as tdecoder
from torch_init import port_init  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from make_example import make_video  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
CFG = DattnConfig.tiny()
D = CFG.text.hidden_size
B, T = 2, 10          # query rows and their padded prompt length
W = 4                 # verify window
MAX_NEW = 8
S_IMG, S_AUD = 12, 7


def _t(x):
    return torch.from_numpy(np.array(x))


def _embed_scaled(jp):
    """At init the tied embedding makes a token predict itself; scaled by
    0.05, the layers shape the logits and greedy output varies."""
    jp["text"]["embed"] = jp["text"]["embed"] * 0.05
    return jp


@pytest.fixture(scope="module")
def model():
    jp = _embed_scaled(port_init(CFG, 0))
    return jp, params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def draft():
    """A two-layer text-only draft sharing the vocabulary (narrower, no
    GQA groups of 2), as vidi_tpu's tests make it."""
    text = dataclasses.replace(CFG.text, num_layers=2, hidden_size=32, num_heads=2,
                               num_kv_heads=1, head_dim=8, intermediate_size=64)
    dcfg = dataclasses.replace(CFG, text=text)
    jp = _embed_scaled(port_init(dcfg, 9))
    jp = {"text": jp["text"]}
    return (jp, dcfg), (params_from_jax(jax.device_get(jp)), dcfg)


@pytest.fixture(scope="module")
def inputs():
    """B right-padded prompts of 6 and 10 tokens (each with a repeat, for
    the n-gram draft) and per-row media: the last 4 image tokens of row 1
    and 2 audio tokens of row 0 masked."""
    rng = np.random.default_rng(5)
    ids = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), bool)
    for r, n in enumerate((6, 10)):
        half = rng.integers(3, CFG.text.vocab_size, n // 2)
        ids[r, :n] = np.concatenate([half, half])
        mask[r, :n] = True
    img = (rng.standard_normal((B, S_IMG, D)) * 0.1).astype(np.float32)
    aud = (rng.standard_normal((B, S_AUD, D)) * 0.1).astype(np.float32)
    img_mask = np.ones((B, S_IMG), bool)
    img_mask[1, -4:] = False
    aud_mask = np.ones((B, S_AUD), bool)
    aud_mask[0, -2:] = False
    return ids, mask, img, img_mask, aud, aud_mask


@pytest.fixture(scope="module")
def eos(model, inputs):
    """An eos the greedy output reaches: row 0's fourth token, so that
    commits get capped at eos inside a window."""
    jp, _ = model
    out = jgen.generate(jp, CFG, *(jnp.asarray(x) for x in inputs), max_new_tokens=MAX_NEW,
                        eos_id=-1)
    return int(np.asarray(out.tokens)[0, 3])


def _jax_caches(jp, inputs, kind: str):
    """vidi_tpu's prefill caches for `inputs`, text caches grown by W + 2
    slots -> (jax caches, port caches, the media masks as (jax, port))."""
    ids, mask, img, img_mask, aud, aud_mask = inputs
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    emb = jdecoder.embed_tokens(jp["text"], jnp.asarray(ids), CFG.text)
    if kind == "media_caches":  # row 0's media, batch 1, shared by both rows
        img_mask, aud_mask = img_mask[:1], aud_mask[:1]
        media = jdattn.media_prefill(jp, CFG, jnp.asarray(img[:1]), jnp.asarray(img_mask),
                                     jnp.asarray(aud[:1]), jnp.asarray(aud_mask))
        _, caches = jdattn.text_prefill_with_caches(
            jp, CFG, emb, jnp.asarray(mask), jnp.asarray(pos), media,
            img_mask=jnp.asarray(img_mask), aud_mask=jnp.asarray(aud_mask))
    else:
        _, caches = jdattn.forward(jp, CFG, emb, jnp.asarray(mask), jnp.asarray(pos),
                                   img=jnp.asarray(img), img_mask=jnp.asarray(img_mask),
                                   aud=jnp.asarray(aud), aud_mask=jnp.asarray(aud_mask),
                                   return_caches=True, quantize_caches=kind == "int8")
    pad = ((0, 0), (0, 0), (0, 0), (0, W + 2), (0, 0))
    caches = caches._replace(text_k=jnp.pad(caches.text_k, pad),
                             text_v=jnp.pad(caches.text_v, pad))

    def port(c):
        if c is None:
            return None
        if isinstance(c, dict):
            return {k: _t(v) for k, v in c.items()}
        return _t(c)

    masks = ((jnp.asarray(img_mask), jnp.asarray(aud_mask)), (_t(img_mask), _t(aud_mask)))
    return caches, tdattn.Caches(*(port(c) for c in caches)), masks


def _window(seed=1):
    return np.random.default_rng(seed).integers(3, CFG.text.vocab_size, (B, W)).astype(np.int32)


@pytest.mark.parametrize("kind", ["per_row", "media_caches", "int8"])
def test_verify_step_matches(model, inputs, kind):
    jp, tp = model
    jc, tc, ((jim, jam), (tim, tam)) = _jax_caches(jp, inputs, kind)
    lens = inputs[1].sum(axis=1).astype(np.int32)
    window = _window()
    want, want_c = jdattn.verify_step(
        jp, CFG, jdecoder.embed_tokens(jp["text"], jnp.asarray(window), CFG.text),
        jnp.asarray(lens), jc, img_mask=jim, aud_mask=jam)
    got, got_c = tdattn.verify_step(
        tp, CFG, tdecoder.embed_tokens(tp["text"], _t(window).long(), CFG.text),
        _t(lens).long(), tc, img_mask=tim, aud_mask=tam)
    assert got.shape == (B, W, CFG.text.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("text_k", "text_v"):
        for r in range(B):
            n = lens[r] + W
            np.testing.assert_allclose(getattr(got_c, name)[:, r, :, :n].numpy(),
                                       np.asarray(getattr(want_c, name))[:, r, :, :n],
                                       err_msg=f"{name} row {r}", **TOL)


def test_verify_step_equals_sequential_decode_steps(model, inputs):
    """The port's verify pass against W of its own decode steps on copies
    of the same caches: logits and the written text-cache slots."""
    jp, tp = model
    _, tc, (_, (tim, tam)) = _jax_caches(jp, inputs, "per_row")
    seq = tc._replace(text_k=tc.text_k.clone(), text_v=tc.text_v.clone())
    lens = _t(inputs[1].sum(axis=1)).long()
    window = _t(_window(2)).long()
    got, got_c = tdattn.verify_step(
        tp, CFG, tdecoder.embed_tokens(tp["text"], window, CFG.text), lens, tc,
        img_mask=tim, aud_mask=tam)
    for i in range(W):
        want, seq = tdattn.decode_step(
            tp, CFG, tdecoder.embed_tokens(tp["text"], window[:, i:i + 1], CFG.text),
            lens + i, seq, img_mask=tim, aud_mask=tam)
        np.testing.assert_allclose(got[:, i].numpy(), want.numpy(), err_msg=f"token {i}",
                                   **TOL)
    for name in ("text_k", "text_v"):
        np.testing.assert_allclose(getattr(got_c, name).numpy(), getattr(seq, name).numpy(),
                                   err_msg=name, **TOL)


def _run_both(model, draft, inputs, eos, *, drafter: str, k: int, media: str):
    """(vidi_tpu's result, the port's, the port's greedy generate) on the
    same inputs."""
    jp, tp = model
    ids, mask, img, img_mask, aud, aud_mask = inputs
    (jd, jdcfg), (td, tdcfg) = draft if drafter == "model" else ((None, None), (None, None))
    jkw = dict(max_new_tokens=MAX_NEW, eos_id=eos, quantize_caches=media == "int8")
    jx = [jnp.asarray(ids), jnp.asarray(mask)]
    tx = [_t(ids).long(), _t(mask)]
    if media == "media_caches":
        jmedia = jdattn.media_prefill(jp, CFG, jnp.asarray(img[:1]), jnp.asarray(img_mask[:1]),
                                      jnp.asarray(aud[:1]), jnp.asarray(aud_mask[:1]))
        tmedia = tdattn.media_prefill(tp, CFG, _t(img[:1]), _t(img_mask[:1]),
                                      _t(aud[:1]), _t(aud_mask[:1]))
        jkw.update(img_mask=jnp.asarray(img_mask[:1]), aud_mask=jnp.asarray(aud_mask[:1]),
                   media_caches=jmedia)
        tkw = dict(jkw, img_mask=_t(img_mask[:1]), aud_mask=_t(aud_mask[:1]),
                   media_caches=tmedia)
    else:
        jx += [jnp.asarray(x) for x in (img, img_mask, aud, aud_mask)]
        tx += [_t(x) for x in (img, img_mask, aud, aud_mask)]
        tkw = dict(jkw)
    want = jgen.speculative_generate(jp, CFG, jd, jdcfg, *jx, spec_k=k, **jkw)
    got = tgen.speculative_generate(tp, CFG, td, tdcfg, *tx, spec_k=k, **tkw)
    greedy = tgen.generate(tp, CFG, *tx, **tkw)
    return want, got, greedy


@pytest.mark.parametrize("drafter,k,media", [
    ("ngram", 1, "per_row"), ("ngram", 4, "per_row"), ("model", 1, "per_row"),
    ("model", 4, "per_row"), ("ngram", 4, "int8"), ("model", 2, "int8"),
    ("ngram", 4, "media_caches"), ("model", 2, "media_caches")])
def test_greedy_speculative_matches(model, draft, inputs, eos, drafter, k, media):
    want, got, greedy = _run_both(model, draft, inputs, eos, drafter=drafter, k=k,
                                  media=media)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.n_target_steps == int(want.n_target_steps)
    np.testing.assert_array_equal(got.n_drafted.numpy(), np.asarray(want.n_drafted))
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    assert torch.equal(got.tokens, greedy.tokens)
    assert int(got.lengths[0]) <= 4  # row 0 stops at the eos


def test_ngram_draft_saves_target_passes(model, draft, inputs, eos):
    """On the repeating tiny output the n-gram draft is accepted: fewer
    verify passes than tokens emitted."""
    _, got, _ = _run_both(model, draft, inputs, eos, drafter="ngram", k=4, media="per_row")
    assert int(got.n_accepted.sum()) > 0
    assert got.n_target_steps < int(got.lengths.max()) - 1


class _RecordingTokenizer(ByteTokenizer):
    """Keeps every id sequence `ask` decodes."""

    def __init__(self):
        super().__init__()
        self.decoded = []

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        self.decoded.append([int(t) for t in ids])
        return super().decode(ids, skip_special_tokens)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("media") / "clip.mp4")
    make_video(path, seconds=4.0)
    return path


def test_ask_with_the_ngram_draft(clip, model, capsys):
    """ask(draft="ngram") decodes the same tokens as vidi_tpu's, and prints
    its acceptance on stderr."""
    jp, tp = model
    kw = dict(max_new_tokens=8, mm_chunks=4, use_flash=False, draft="ngram", spec_k=3)
    jtok, ttok = _RecordingTokenizer(), _RecordingTokenizer()
    want = jpipe.ask("a moving gradient", clip, jp, CFG, jtok, **kw)
    capsys.readouterr()
    got = tpipe.ask("a moving gradient", clip, tp, CFG, ttok, **kw)
    assert got == want
    assert ttok.decoded == jtok.decoded and any(ttok.decoded)
    assert "speculative:" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [["--spec-ngram"],
                                   ["--draft-random-weights", "tiny", "--spec-k", "2"]],
                         ids=["ngram", "draft_model"])
def test_cli_speculative(clip, capsys, extra):
    tpipe.main(["--video-path", clip, "--query", "a moving gradient", "--random-weights",
                "tiny", "--device", "cpu", "--dtype", "float32", "--max-new-tokens", "8",
                *extra])
    out = capsys.readouterr()
    assert out.out.strip()
    assert "speculative:" in out.err
