"""The slice as a whole: the port's `ask` against vidi_tpu's `ask` on a clip
made by scripts/make_example.make_video, with the same tiny random weights
(params_from_jax) and use_flash=False on both sides; plus the port's CLI on
the CPU.

The parsed answers must be equal strings; the host-decoded arrays must be
identical and the encoded media features within atol = rtol = 2e-4 (the
tolerance of tests/test_torch_dattn.py, same layers).
"""
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.infer import pipeline as jpipe
from vidi_tpu.media.text import ByteTokenizer
from vidi_tpu_torch.infer import pipeline as tpipe
from vidi_tpu_torch.infer.convert import params_from_jax
from torch_init import port_init  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from make_example import make_video  # noqa: E402

CFG = DattnConfig.tiny()
QUERY = "a moving gradient"


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("media") / "clip.mp4")
    make_video(path, seconds=6.0)
    return path


@pytest.fixture(scope="module")
def model():
    jp = port_init(CFG, 3)
    return jp, params_from_jax(jax.device_get(jp))


class _RecordingTokenizer(ByteTokenizer):
    """Keeps every id sequence `ask` decodes: the generated tokens, which
    random weights rarely turn into a time range the parser would keep."""

    def __init__(self):
        super().__init__()
        self.decoded = []

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        self.decoded.append([int(t) for t in ids])
        return super().decode(ids, skip_special_tokens)


def test_ask_gives_the_same_answer(clip, model):
    jp, tp = model
    kw = dict(max_new_tokens=16, mm_chunks=4, use_flash=False)
    jtok, ttok = _RecordingTokenizer(), _RecordingTokenizer()
    want = jpipe.ask(QUERY, clip, jp, CFG, jtok, **kw)
    got = tpipe.ask(QUERY, clip, tp, CFG, ttok, **kw)
    assert got == want
    assert ttok.decoded == jtok.decoded
    assert ttok.decoded and any(ttok.decoded)  # the answer came from real tokens


def test_host_decode_and_media_encode_match(clip, model):
    jp, tp = model
    want = jpipe.decode_media_host(clip, CFG)
    got = tpipe.decode_media_host(clip, CFG)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    j_feats = jpipe.encode_media_arrays(jp, CFG, *want, mm_chunks=4)
    t_feats = tpipe.encode_media_arrays(tp, CFG, *got, mm_chunks=4)
    for g, w in zip(t_feats, j_feats):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4)


def test_prompt_and_parse_helpers_match():
    tok = ByteTokenizer()
    np.testing.assert_array_equal(tpipe.build_prompt_ids(QUERY + ".", tok),
                                  jpipe.build_prompt_ids(QUERY + ".", tok))
    ids = [np.arange(5), np.arange(70)]
    for g, w in zip(tpipe.build_prompt_batch(ids), jpipe.build_prompt_batch(ids)):
        np.testing.assert_array_equal(g, w)
    text = "0.125-0.250, and 0.500-0.875"
    assert tpipe.parse_task_output(text, "tr", 3725.0) == \
        jpipe.parse_task_output(text, "tr", 3725.0)
    assert tpipe.pick_eos(CFG, tok) == jpipe.pick_eos(CFG, tok)


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "vidi_tpu_torch.infer.pipeline", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)


def test_cli_runs_on_cpu(clip):
    res = _cli("--video-path", clip, "--query", QUERY, "--random-weights", "tiny",
               "--device", "cpu", "--dtype", "float32", "--max-new-tokens", "8")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1]


def test_cli_cuda_without_a_card_raises(clip):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    res = _cli("--video-path", clip, "--query", QUERY, "--random-weights", "tiny",
               "--device", "cuda")
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
