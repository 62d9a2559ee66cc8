"""Beam search in the port against vidi_tpu at the tiny configuration in
fp32 on the CPU, same weights (params_from_jax) and numpy inputs,
use_flash=False on both sides: `beam_generate` with 1 and 4 beams over two
queries, a length penalty, per-row media, shared batch-1 media caches and
int8 caches; `ask` with two beams; and the CLI's `--num-beams`.

Beam tokens and lengths must be identical to vidi_tpu's (the port takes
its top K from a stable descending sort, ties to the lower index as
jax.lax.top_k breaks them), and one beam must give greedy `generate`'s
tokens.
"""
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
from vidi_tpu_torch.infer import generate as tgen
from vidi_tpu_torch.infer import pipeline as tpipe
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.models import dattn as tdattn
from torch_init import port_init  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from make_example import make_video  # noqa: E402

CFG = DattnConfig.tiny()
D = CFG.text.hidden_size
B, T = 2, 8
MAX_NEW = 8
S_IMG, S_AUD = 12, 7


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def model():
    """The tiny model with its embedding scaled by 0.01: at init the tied
    embedding makes a token predict itself; scaled down, the layers shape
    the logits, greedy output varies and the beams part ways."""
    jp = port_init(CFG, 1)
    jp["text"]["embed"] = jp["text"]["embed"] * 0.01
    return jp, params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def inputs():
    """Two right-padded prompts of 5 and 8 tokens and per-row media: the
    last 4 image tokens of row 1 and 2 audio tokens of row 0 masked."""
    rng = np.random.default_rng(7)
    ids = rng.integers(3, CFG.text.vocab_size, (B, T)).astype(np.int32)
    mask = np.zeros((B, T), bool)
    mask[0, :5] = True
    mask[1, :] = True
    ids = ids * mask
    img = (rng.standard_normal((B, S_IMG, D)) * 0.1).astype(np.float32)
    aud = (rng.standard_normal((B, S_AUD, D)) * 0.1).astype(np.float32)
    img_mask = np.ones((B, S_IMG), bool)
    img_mask[1, -4:] = False
    aud_mask = np.ones((B, S_AUD), bool)
    aud_mask[0, -2:] = False
    return ids, mask, img, img_mask, aud, aud_mask


@pytest.fixture(scope="module")
def eos(model, inputs):
    """An eos that beams reach before the end: the fifth token of row 0's
    greedy output, so that finished beams are frozen while others go on."""
    jp, _ = model
    out = jgen.generate(jp, CFG, *(jnp.asarray(x) for x in inputs), max_new_tokens=MAX_NEW,
                        eos_id=-1)
    return int(np.asarray(out.tokens)[0, 4])


def _args(model, inputs, eos, media: str, num_beams: int, length_penalty: float):
    """(vidi_tpu's args, kwargs), (the port's args, kwargs)."""
    jp, tp = model
    ids, mask, img, img_mask, aud, aud_mask = inputs
    kw = dict(max_new_tokens=MAX_NEW, eos_id=eos, num_beams=num_beams,
              length_penalty=length_penalty, quantize_caches=media == "int8")
    if media == "media_caches":
        jm = jdattn.media_prefill(jp, CFG, jnp.asarray(img[:1]), jnp.asarray(img_mask[:1]),
                                  jnp.asarray(aud[:1]), jnp.asarray(aud_mask[:1]))
        tm = tdattn.media_prefill(tp, CFG, _t(img[:1]), _t(img_mask[:1]), _t(aud[:1]),
                                  _t(aud_mask[:1]))
        jkw = dict(kw, img_mask=jnp.asarray(img_mask[:1]),
                   aud_mask=jnp.asarray(aud_mask[:1]), media_caches=jm)
        tkw = dict(kw, img_mask=_t(img_mask[:1]), aud_mask=_t(aud_mask[:1]), media_caches=tm)
        return ((jp, CFG, jnp.asarray(ids), jnp.asarray(mask)), jkw), \
            ((tp, CFG, _t(ids).long(), _t(mask)), tkw)
    return ((jp, CFG, *(jnp.asarray(x) for x in inputs)), kw), \
        ((tp, CFG, _t(ids).long(), *(_t(x) for x in inputs[1:])), kw)


# length_penalty 3.0 picks another of row 0's finished beams than 1.0 does
@pytest.mark.parametrize("num_beams,length_penalty,media", [
    (1, 1.0, "per_row"), (4, 1.0, "per_row"), (4, 3.0, "per_row"), (4, 1.0, "media_caches"),
    (4, 1.0, "int8"), (1, 1.0, "media_caches")])
def test_beam_generate_matches(model, inputs, eos, num_beams, length_penalty, media):
    (ja, jkw), (ta, tkw) = _args(model, inputs, eos, media, num_beams, length_penalty)
    want = jgen.beam_generate(*ja, **jkw)
    got = tgen.beam_generate(*ta, **tkw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    if num_beams == 1:
        greedy_kw = {k: v for k, v in tkw.items() if k not in ("num_beams", "length_penalty")}
        greedy = tgen.generate(*ta, **greedy_kw)
        assert torch.equal(got.tokens, greedy.tokens)
        assert torch.equal(got.lengths, greedy.lengths)


def test_beams_differ_from_greedy(model, inputs, eos):
    """Four beams find an output greedy does not (else the beam checks
    above would be greedy's again): at least one query's best beam is not
    its greedy tokens."""
    (_, _), (ta, tkw) = _args(model, inputs, eos, "per_row", 4, 1.0)
    beams = tgen.beam_generate(*ta, **tkw)
    greedy_kw = {k: v for k, v in tkw.items() if k not in ("num_beams", "length_penalty")}
    greedy = tgen.generate(*ta, **greedy_kw)
    assert not torch.equal(beams.tokens, greedy.tokens)


def test_beam_reorders_text_caches_in_place(model, inputs, eos, monkeypatch):
    """The text caches are gathered into one spare pair of buffers and the
    two swapped: every step writes into one of two allocations."""
    (_, _), (ta, tkw) = _args(model, inputs, eos, "per_row", 4, 1.0)
    seen = set()
    real = tgen._reorder

    def reorder(caches, spare, parent):
        out, nxt = real(caches, spare, parent)
        seen.update({out.text_k.data_ptr(), nxt[0].data_ptr()})
        return out, nxt

    monkeypatch.setattr(tgen, "_reorder", reorder)
    res = tgen.beam_generate(*ta, **tkw)
    assert res.decode_steps > 2 and len(seen) == 2


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


def test_ask_with_beams(clip, model, capsys):
    """ask(num_beams=2) decodes the same tokens as vidi_tpu's; a draft
    given with beams is ignored with a warning."""
    jp, tp = model
    kw = dict(max_new_tokens=8, mm_chunks=4, use_flash=False, num_beams=2)
    jtok, ttok = _RecordingTokenizer(), _RecordingTokenizer()
    want = jpipe.ask("a moving gradient", clip, jp, CFG, jtok, **kw)
    capsys.readouterr()
    got = tpipe.ask("a moving gradient", clip, tp, CFG, ttok, draft="ngram", **kw)
    assert got == want
    assert ttok.decoded == jtok.decoded and any(ttok.decoded)
    assert "draft is IGNORED" in capsys.readouterr().err


def test_cli_num_beams(clip, capsys, monkeypatch):
    seen = []
    real = tpipe.beam_generate

    def beam_generate(*a, **kw):
        seen.append(kw["num_beams"])
        return real(*a, **kw)

    monkeypatch.setattr(tpipe, "beam_generate", beam_generate)
    tpipe.main(["--video-path", clip, "--query", "a moving gradient", "--random-weights",
                "tiny", "--device", "cpu", "--dtype", "float32", "--max-new-tokens", "8",
                "--num-beams", "2"])
    assert capsys.readouterr().out.strip()
    assert seen == [2]
