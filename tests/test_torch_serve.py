"""The serving daemon: the port's `infer/serve.serve_loop` against vidi_tpu's
on the same request streams, with the same tiny random weights
(params_from_jax), fp32 and use_flash=False on both sides, on two clips
made by scripts/make_example.make_video (6 s and 3 s, 128 px: sizes the
native decoder takes).

Each case holds the responses equal field by field, the generated token
ids equal (recorded by the tokenizer: with random weights and the byte
tokenizer most texts decode to ""), and the stats equal apart from wall_s
and queries_per_s. Also: `_stack_media` against the reference's output
(bf16-layout and int8 caches), its ValueError on mixed modalities, the
identity filter of misfits, sampling (one seed twice bit-equal, top_k 1 =
greedy), the linger window, and `main` on the CPU.
"""
import dataclasses
import json
import os
import queue
import sys
import time
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.infer import pipeline as jpipe
from vidi_tpu.infer import serve as jserve
from vidi_tpu.media.text import ByteTokenizer
from vidi_tpu.models import dattn as jdattn
from vidi_tpu_torch.infer import pipeline as tpipe
from vidi_tpu_torch.infer import serve as tserve
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.models import dattn as tdattn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from make_example import make_video  # noqa: E402
from torch_init import port_init  # noqa: E402

CFG = DattnConfig.tiny()
NEW = 8
SPLITS = 4
QUERIES = ("a moving gradient", "the opening shot", "a red square")
VOLATILE = ("wall_s", "queries_per_s")


class _RecordingTokenizer(ByteTokenizer):
    """Keeps every id sequence the loop decodes: the generated tokens."""

    def __init__(self):
        super().__init__()
        self.decoded = []

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        self.decoded.append([int(t) for t in ids])
        return super().decode(ids, skip_special_tokens)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_media")
    a, b = str(d / "clip_a.mp4"), str(d / "clip_b.mp4")
    make_video(a, seconds=6.0)
    make_video(b, seconds=3.0)
    return a, b


def _init(cfg, seed):
    """(vidi_tpu's parameters, the port's): the port's init in vidi_tpu's
    layout (tests/torch_init.py)."""
    jp = port_init(cfg, seed)
    return jp, params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def model():
    return _init(CFG, 5)


@pytest.fixture(scope="module")
def draft():
    t = dataclasses.replace(CFG.text, num_layers=2, hidden_size=32, num_heads=2,
                            num_kv_heads=1, head_dim=8, intermediate_size=64)
    dcfg = dataclasses.replace(CFG, text=t)
    jd, td = _init(dcfg, 9)
    return (jd, dcfg), (td, dcfg)


@pytest.fixture(scope="module", autouse=True)
def reference_encodes():
    """vidi_tpu's encode_media memoized for the module by (weights, clip,
    options): the reference's loop encodes the same two clips in every
    case, op by op (~2 s a call), and its features are a function of
    those alone. The port's loop encodes every time."""
    real, memo = jpipe.encode_media, {}

    def encode(params, cfg, path, **kw):
        key = (id(params), cfg, path, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = real(params, cfg, path, **kw)
        return memo[key]

    jpipe.encode_media = encode
    yield
    jpipe.encode_media = real


def _queue(items):
    q = queue.Queue()
    for r in items:
        q.put(r)
    q.put(None)
    return q


def _serve(mod, params, reqs, **kw):
    tok = _RecordingTokenizer()
    out = []
    stats = mod.serve_loop(params, CFG, tok, _queue(reqs), out.append,
                           max_new_tokens=NEW, mm_splits=SPLITS, **kw)
    return out, stats, tok.decoded


def _both(model, reqs, jkw=None, **kw):
    """The same requests through both loops -> (port run, reference run),
    held equal: responses field by field, token ids, stats."""
    jp, tp = model
    want = _serve(jserve, jp, reqs, **{**kw, **(jkw or {})})
    got = _serve(tserve, tp, reqs, **kw)
    assert got[0] == want[0]
    assert got[2] == want[2]
    assert {k: v for k, v in got[1].items() if k not in VOLATILE} == \
        {k: v for k, v in want[1].items() if k not in VOLATILE}
    return got


def _req(i, video, query=QUERIES[0], **extra):
    return {"id": f"q{i}", "video": video, "query": query, **extra}


def test_grouping_cache_hits_and_bad_requests(model, clips):
    a, b = clips
    reqs = [{"_bad_line": "not json", "_err": "Expecting value: line 1 column 1"},
            _req(0, a, QUERIES[0]), _req(1, a, QUERIES[1]),
            {"id": "noquery", "video": a}, 123,
            _req(2, b, QUERIES[2]),
            _req(3, a, QUERIES[2]),
            _req(4, a, "which colour is the square?", task="vqa",
                 options=["red", "green", "blue", "white"]),
            _req(5, "/nonexistent/clip.mp4")]
    out, stats, ids = _both(model, reqs, batch_queries=2, media_cache=2)
    assert stats["served"] == 5 and stats["errors"] == 4
    assert stats["generate_calls"] == 3
    # a miss per video (the missing file included), then a's second group hits
    assert (stats["media_cache_misses"], stats["media_cache_hits"]) == (3, 1)
    by_id = {o["id"]: o for o in out}
    assert [by_id[f"q{i}"]["cached_media"] for i in range(5)] == \
        [False, False, False, True, True]
    assert "media: " in by_id["q5"]["error"]
    assert len(ids) == 5 and any(ids)  # the answers came from real tokens


@pytest.mark.parametrize("case", ["eviction", "batch_videos", "quantize_kv",
                                  "spec_ngram", "chunked_prefill"])
def test_loop_options_match(model, clips, case):
    a, b = clips
    if case == "eviction":
        _, stats, _ = _both(model, [_req(0, a), _req(1, b), _req(2, a, QUERIES[1])],
                            batch_queries=1, media_cache=1)
        assert (stats["media_cache_misses"], stats["media_cache_hits"]) == (3, 0)
    elif case == "batch_videos":
        _, stats, _ = _both(model, [_req(0, a), _req(1, b, QUERIES[1])], batch_videos=2)
        assert stats["generate_calls"] == 1 and stats["served"] == 2
    elif case == "quantize_kv":
        _both(model, [_req(0, a), _req(1, a, QUERIES[1])], quantize_kv=True)
    elif case == "spec_ngram":
        _both(model, [_req(0, a), _req(1, a, QUERIES[1])], spec_ngram=True, spec_k=3)
    else:
        _both(model, [_req(0, a)], chunked_prefill_tokens=1)


def test_cross_video_answers_equal_unbatched(model, clips):
    """The port's stacked run (caches padded along S) answers as its
    unbatched run; a multi-query video is never bundled."""
    _, tp = model
    a, b = clips
    reqs = [_req(0, a), _req(1, b, QUERIES[1])]
    base = _serve(tserve, tp, reqs)
    got = _serve(tserve, tp, reqs, batch_videos=2)
    assert (base[1]["generate_calls"], got[1]["generate_calls"]) == (2, 1)
    assert got[0] == base[0] and got[2] == base[2]
    three = _serve(tserve, tp, [_req(0, a), _req(1, a, QUERIES[1]), _req(2, b)],
                   batch_videos=2)
    assert three[1]["generate_calls"] == 2 and three[1]["served"] == 3


def test_model_draft_matches(model, clips, draft):
    a, _ = clips
    jd, td = draft
    _, stats, _ = _both(model, [_req(0, a), _req(1, a, QUERIES[1])], jkw={"draft": jd},
                        draft=td, spec_k=3)
    assert stats["served"] == 2 and stats["errors"] == 0
    _, tp = model
    plain = _serve(tserve, tp, [_req(0, a), _req(1, a, QUERIES[1])])
    spec = _serve(tserve, tp, [_req(0, a), _req(1, a, QUERIES[1])], draft=td, spec_k=3)
    assert spec[0] == plain[0] and spec[2] == plain[2]


def test_decode_ahead_matches(model, clips):
    a, b = clips
    reqs = [_req(0, a), _req(1, b, QUERIES[1])]
    _, stats, _ = _both(model, reqs, batch_queries=1, decode_ahead=True)
    assert stats["overlapped_decodes"] == 1
    _, tp = model
    off = _serve(tserve, tp, reqs, batch_queries=1)
    on = _serve(tserve, tp, reqs, batch_queries=1, decode_ahead=True)
    assert off[1]["overlapped_decodes"] == 0
    assert on[0] == off[0] and on[2] == off[2]


def test_mixed_modality_bundle_requeues(model, clips, monkeypatch):
    """batch_videos: a video without audio cannot stack with one that has
    it; it is requeued (an identity filter: its entries hold tensors) and
    served alone from the LRU."""
    a, b = clips
    for mod in (jpipe, tpipe):
        real = mod.encode_media

        def no_audio(params, cfg, path, _real=real, **kw):
            img, im, aud, am = _real(params, cfg, path, **kw)
            return (img, im, None, None) if path == b else (img, im, aud, am)

        monkeypatch.setattr(mod, "encode_media", no_audio)
    out, stats, _ = _both(model, [_req(0, a), _req(1, b, QUERIES[1])], batch_videos=2)
    assert stats["served"] == 2 and stats["errors"] == 0
    assert stats["generate_calls"] == 2 and stats["media_cache_hits"] == 1
    assert all("text" in o for o in out)


def _caches(gen, s_img, s_aud, quantized):
    """A random media-only Caches [L,1,Hk,S,D] as numpy leaves."""
    def leaf(s):
        if quantized:
            return {"qi8": gen.integers(-127, 128, (2, 1, 2, s, 8)).astype(np.int8),
                    "scale": gen.random((2, 1, 2, s, 1)).astype(np.float32)}
        return gen.standard_normal((2, 1, 2, s, 8)).astype(np.float32)
    return {"img_k": leaf(s_img), "img_v": leaf(s_img), "aud_k": leaf(s_aud),
            "aud_v": leaf(s_aud)}


def _tree(x, fn):
    return {k: fn(v) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def _stack_both(entries):
    """entries [(img_mask np, aud_mask np, caches dict np)] through both
    `_stack_media` -> (port output, reference output)."""
    tw = [(torch.as_tensor(im), torch.as_tensor(am),
           tdattn.Caches(None, None, *(_tree(c[k], torch.as_tensor)
                                       for k in ("img_k", "img_v", "aud_k", "aud_v"))))
          for im, am, c in entries]
    jw = [(jnp.asarray(im), jnp.asarray(am),
           jdattn.Caches(None, None, *(_tree(c[k], jnp.asarray)
                                       for k in ("img_k", "img_v", "aud_k", "aud_v"))))
          for im, am, c in entries]
    return tserve._stack_media(tw), jserve._stack_media(jw)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_layout", "int8"])
def test_stack_media_matches_reference(quantized):
    gen = np.random.default_rng(0)
    entries = []
    for s_img, s_aud in ((12, 5), (7, 9)):
        im = gen.random((1, s_img)) > 0.2
        am = gen.random((1, s_aud)) > 0.2
        entries.append((im, am, _caches(gen, s_img, s_aud, quantized)))
    (t_im, t_am, t_media), (j_im, j_am, j_media) = _stack_both(entries)
    np.testing.assert_array_equal(t_im.numpy(), np.asarray(j_im))
    np.testing.assert_array_equal(t_am.numpy(), np.asarray(j_am))
    assert t_im.shape == (2, 12) and t_am.shape == (2, 9)
    for k in ("img_k", "img_v", "aud_k", "aud_v"):
        t, j = getattr(t_media, k), getattr(j_media, k)
        if quantized:
            for part in ("qi8", "scale"):
                assert t[part].dtype == torch.as_tensor(np.asarray(j[part])).dtype
                np.testing.assert_array_equal(t[part].numpy(), np.asarray(j[part]))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if quantized:  # padded scales are 1, padded codes 0
        assert (t_media.img_k["scale"][:, 1, :, 7:] == 1).all()
        assert (t_media.img_k["qi8"][:, 1, :, 7:] == 0).all()


def test_stack_media_rejects_mixed_modalities():
    gen = np.random.default_rng(1)
    c = _caches(gen, 4, 3, False)
    with_aud = (torch.ones(1, 4, dtype=torch.bool), torch.ones(1, 3, dtype=torch.bool),
                tdattn.Caches(None, None, *(torch.as_tensor(c[k]) for k in
                                            ("img_k", "img_v", "aud_k", "aud_v"))))
    no_aud = (torch.ones(1, 4, dtype=torch.bool), None,
              tdattn.Caches(None, None, torch.as_tensor(c["img_k"]),
                            torch.as_tensor(c["img_v"]), None, None))
    with pytest.raises(ValueError, match="mixes present and absent"):
        tserve._stack_media([with_aud, no_aud])


def test_misfit_filter_is_by_identity():
    """Entries hold tensors: `in` would compare them elementwise (and raise
    on a tie of the groups); `_drop` compares identities."""
    group = [{"id": "x"}]
    t = torch.zeros(2, 3)
    ok = [(group, 1.0, t, t.clone()), (group, 1.0, t.clone(), t), (group, 1.0, t, t)]
    with pytest.raises(RuntimeError):
        _ = ok[2] in [ok[1]]
    assert [id(o) for o in tserve._drop(ok, [ok[1]])] == [id(ok[0]), id(ok[2])]


def test_sampling_is_reproducible(model, clips):
    _, tp = model
    a, _ = clips
    reqs = [_req(0, a), _req(1, a, QUERIES[1])]
    kw = dict(temperature=0.8, top_k=20, top_p=0.9, seed=11)
    one, two = _serve(tserve, tp, reqs, **kw), _serve(tserve, tp, reqs, **kw)
    assert one[0] == two[0] and one[2] == two[2]
    greedy = _serve(tserve, tp, reqs)
    top1 = _serve(tserve, tp, reqs, temperature=0.8, top_k=1, seed=11)
    assert top1[2] == greedy[2]


def test_linger_is_one_bounded_window(model, clips):
    """Each straggler shrinks the remaining linger wait (the timeouts
    passed to Queue.get strictly decrease within a window)."""
    _, tp = model
    a, _ = clips

    class TrickleQueue:
        def __init__(self, items):
            self.items = deque(items)
            self.timeouts = []

        def get(self, timeout=None):
            if timeout is None:
                return self.items.popleft() if self.items else None
            self.timeouts.append(timeout)
            time.sleep(0.05)
            if self.items:
                return self.items.popleft()
            raise queue.Empty

        def get_nowait(self):
            raise queue.Empty

    q = TrickleQueue([_req(i, a) for i in range(4)])
    stats = tserve.serve_loop(tp, CFG, ByteTokenizer(), q, [].append,
                              max_new_tokens=2, mm_splits=SPLITS, batch_queries=2,
                              linger_s=0.3)
    assert stats["served"] == 4
    ts = q.timeouts
    assert len(ts) >= 3 and all(t <= 0.3 + 1e-6 for t in ts)
    windows, cur = [], [ts[0]]
    for t in ts[1:]:
        if t < cur[-1]:
            cur.append(t)
        else:
            windows.append(cur)
            cur = [t]
    windows.append(cur)
    assert any(len(w) >= 3 for w in windows), ts
    for w in windows:
        assert all(y < x for x, y in zip(w, w[1:])), ts


def test_main_file_in_file_out(tmp_path, clips):
    a, _ = clips
    req, resp = tmp_path / "req.jsonl", tmp_path / "resp.jsonl"
    req.write_text(json.dumps(_req(0, a)) + "\nnot json\n123\n\n"
                   + json.dumps({"id": "nv", "query": "x"}) + "\n")
    stats = tserve.main(["--random-weights", "tiny", "--device", "cpu", "--dtype",
                         "float32", "--in", str(req), "--out", str(resp),
                         "--max-new-tokens", "4", "--mm-splits", "4"])
    lines = [json.loads(x) for x in resp.read_text().splitlines()]
    assert len(lines) == 4
    by_id = {o["id"]: o for o in lines}
    assert "text" in by_id["q0"] and by_id["q0"]["video_s"] > 0
    assert "error" in by_id[None] and "error" in by_id["nv"]
    assert stats["served"] == 1 and stats["errors"] == 3


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_main_defaults_to_cuda():
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tserve.main(["--random-weights", "tiny", "--in", os.devnull])
