"""The streamed encode of the port against vidi_tpu, fp32 on the CPU with the
same tiny random weights (params_from_jax): the device bicubic resize
(`ops/preprocess.resize_bicubic`, `preprocess_uint8`), `encode_media_streaming`
on a clip made by scripts/make_example.make_video (host resize and
`device_resize`), `encode_frame_stream` fed the same frames in chunks of
any size, the audio thread's error, `encode_media`'s flags, and `ask` and
the CLI with `--stream-chunk` / `--device-resize`.

Tolerances: the resize within 1e-2 on the 0-255 scale and 1e-4 normalized
(the same antialiased a = -0.5 cubic in fp32, summed in another order);
media features within atol = rtol = 2e-4 (tests/test_torch_pipeline.py's,
the same layers); the port's streamed features against its own whole-clip
encode within 1e-5 (the same arithmetic on chunks of other sizes); answers
equal strings, generated ids equal.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.infer import pipeline as jpipe
from vidi_tpu.media.text import ByteTokenizer
from vidi_tpu.ops import preprocess as jpre
from vidi_tpu_torch.infer import pipeline as tpipe
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.media import video as tvideo
from vidi_tpu_torch.ops import preprocess as tpre

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from make_example import make_video  # noqa: E402
from torch_init import port_init  # noqa: E402

CFG = DattnConfig.tiny()
QUERY = "a moving gradient"
FEATS = dict(atol=2e-4, rtol=2e-4)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("media") / "clip.mp4")
    make_video(path, seconds=6.0)
    return path


@pytest.fixture(scope="module")
def model():
    jp = port_init(CFG, 7)
    return jp, params_from_jax(jax.device_get(jp))


@pytest.mark.parametrize("h,w,size", [(360, 640, 384), (480, 854, 384), (384, 500, 384),
                                      (200, 300, 384), (30, 20, 42)])
def test_resize_bicubic_matches(h, w, size):
    """Downscales of common decode resolutions, and upscales (200x300 and
    30x20 to the tower's side)."""
    x = np.random.default_rng(h + w).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    got = tpre.resize_bicubic(torch.from_numpy(x), size)
    want = jpre.resize_bicubic(jnp.asarray(x, jnp.float32), size)
    assert got.shape == (2, size, size, 3) and got.dtype == torch.float32
    assert float(got.min()) >= 0.0 and float(got.max()) <= 255.0
    _close(got, want, atol=1e-2, rtol=0)
    mean, std = (0.48, 0.45, 0.40), (0.27, 0.26, 0.28)
    _close(tpre.preprocess_uint8(torch.from_numpy(x), size, mean, std),
           jpre.preprocess_uint8(jnp.asarray(x), size, mean, std), atol=1e-4, rtol=0)


@pytest.mark.parametrize("device_resize", [False, True])
def test_encode_media_streaming_matches(clip, model, device_resize):
    """Chunks of 4 of the clip's 6 frames (a short tail) against vidi_tpu's
    streamed encode; with the host resize also against the port's
    whole-clip encode of the same frames."""
    jp, tp = model
    kw = dict(chunk_frames=4, mm_chunks=4, device_resize=device_resize)
    want = jpipe.encode_media_streaming(jp, CFG, clip, **kw)
    got = tpipe.encode_media_streaming(tp, CFG, clip, **kw)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, **FEATS)
    if not device_resize:
        whole = tpipe.encode_media_arrays(tp, CFG, *tpipe.decode_media_host(clip, CFG),
                                          mm_chunks=4)
        for g, w in zip(got, whole):
            _close(g, w.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("device_resize", [False, True])
def test_encode_frame_stream_does_not_depend_on_the_chunk(model, device_resize):
    """The same 9 frames (decoded at 30x50) in chunks of 1, 7 and 9 give
    the same features; as uint8 at the tower's size, the whole-clip encode's."""
    _, tp = model
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (9, 30, 50, 3), dtype=np.uint8)
    mels = rng.standard_normal((2, 128, 3000)).astype(np.float32)

    def run(size):
        chunks = (frames[a:a + size] for a in range(0, len(frames), size))
        return tpipe.encode_frame_stream(tp, CFG, chunks, len(frames), mels, 5000,
                                         mm_chunks=2, device_resize=device_resize)

    want = run(9)
    for size in (1, 7):
        for g, w in zip(run(size), want):
            _close(g, w.numpy(), atol=1e-5, rtol=1e-5)
    if not device_resize:
        from vidi_tpu_torch.media.images import resize_frames_uint8
        whole = tpipe.encode_media_arrays(
            tp, CFG, resize_frames_uint8(frames, CFG.vision.image_size), mels, 5000,
            mm_chunks=2)
        for g, w in zip(want, whole):
            _close(g, w.numpy(), atol=1e-5, rtol=1e-5)


def test_encode_frame_stream_checks_the_frame_count(model):
    _, tp = model
    frames = np.zeros((3, 42, 42, 3), np.uint8)
    mels = np.zeros((1, 128, 3000), np.float32)
    with pytest.raises(ValueError, match="3 frames, not 4"):
        tpipe.encode_frame_stream(tp, CFG, [frames], 4, mels, 3000)


def test_audio_thread_error_is_reraised(clip, model, monkeypatch):
    _, tp = model

    def broken(*args, **kwargs):
        raise RuntimeError("no audio stream")

    monkeypatch.setattr(tvideo, "load_audio", broken)
    with pytest.raises(RuntimeError, match="no audio stream"):
        tpipe.encode_media_streaming(tp, CFG, clip, chunk_frames=4)


def test_encode_media_selects_the_path(clip, model):
    _, tp = model
    with pytest.raises(ValueError, match="stream_chunk"):
        tpipe.encode_media(tp, CFG, clip, device_resize=True)
    streamed = tpipe.encode_media(tp, CFG, clip, mm_chunks=4, stream_chunk=5)
    whole = tpipe.encode_media(tp, CFG, clip, mm_chunks=4)
    for g, w in zip(streamed, whole):
        _close(g, w.numpy(), atol=1e-5, rtol=1e-5)


class _RecordingTokenizer(ByteTokenizer):
    """Keeps every id sequence `ask` decodes (random weights rarely give a
    time range the parser keeps)."""

    def __init__(self):
        super().__init__()
        self.decoded = []

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        self.decoded.append([int(t) for t in ids])
        return super().decode(ids, skip_special_tokens)


@pytest.mark.parametrize("device_resize", [False, True])
def test_ask_streamed_gives_the_same_answer(clip, model, device_resize):
    jp, tp = model
    kw = dict(max_new_tokens=12, mm_chunks=4, use_flash=False, stream_chunk=4,
              device_resize=device_resize)
    jtok, ttok = _RecordingTokenizer(), _RecordingTokenizer()
    want = jpipe.ask(QUERY, clip, jp, CFG, jtok, **kw)
    got = tpipe.ask(QUERY, clip, tp, CFG, ttok, **kw)
    assert got == want
    assert ttok.decoded == jtok.decoded and any(ttok.decoded)


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "vidi_tpu_torch.infer.pipeline", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=180)


def test_cli_stream_flags(clip):
    """--stream-chunk with --device-resize prints what `ask` gives with the
    same options on load_model's weights; --device-resize alone exits with
    the error."""
    from vidi_tpu_torch.infer.loader import load_model

    base = ["--video-path", clip, "--query", QUERY, "--random-weights", "tiny",
            "--device", "cpu", "--dtype", "float32", "--max-new-tokens", "8"]
    res = _cli(*base, "--stream-chunk", "4", "--device-resize")
    assert res.returncode == 0, res.stderr
    params, cfg, tok = load_model(random_weights="tiny", dtype=torch.float32,
                                  device="cpu")
    want = tpipe.ask(QUERY, clip, params, cfg, tok, max_new_tokens=8, stream_chunk=4,
                     device_resize=True)
    assert res.stdout.strip().splitlines()[-1] == (want or "(no parsed output)")
    res = _cli(*base, "--device-resize")
    assert res.returncode != 0 and "device_resize needs stream_chunk" in res.stderr


def test_unloadable_native_decoder_falls_back_to_cv2(clip, tmp_path, monkeypatch):
    """A native decoder built against libav libraries that are not
    installed is skipped: probe, frames and audio come from cv2 and
    the silence fallback, as where no native library exists."""
    broken = tmp_path / "libvidi_media.so"
    broken.write_bytes(b"not a shared object")
    monkeypatch.setattr(tvideo, "_NATIVE_PATHS", [str(broken)])
    monkeypatch.setattr(tvideo, "_native", None)
    assert tvideo._load_native() is False
    duration, _, n_frames, w, h = tvideo.probe(clip)
    assert duration > 5 and n_frames > 0 and (w, h) == (128, 128)
    frames = tvideo.load_video(clip, fps=1.0)
    assert len(frames) == 6 and frames[0].shape == (128, 128, 3)
    assert not tvideo.load_audio(clip, 16000).any()


# Widths the native frame decoder overruns its rows at (width % 16 >= 8:
# "double free or corruption" on 56 and 120 px clips), square and not;
# 64 px is one it takes. Each decodes in a subprocess, so an abort fails
# the test instead of ending the run.
_DECODE_CHILD = """
import sys
import numpy as np
from vidi_tpu_torch.media import video as V
path, out = sys.argv[1], sys.argv[2]
whole = np.stack(V.load_video(path, fps=5.0))
streamed = np.concatenate(list(V.stream_video(path, fps=5.0, chunk=3)))
np.savez(out, whole=whole, streamed=streamed, native=bool(V._load_native()))
"""


@pytest.mark.parametrize("w, h", [(56, 56), (120, 120), (200, 72), (72, 120), (64, 64)])
def test_load_video_never_aborts_and_matches_cv2(tmp_path, w, h):
    import cv2

    path = str(tmp_path / f"clip_{w}x{h}.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5, (w, h))
    rng = np.random.default_rng(w * 1000 + h)
    for _ in range(8):
        writer.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    writer.release()
    out = str(tmp_path / "frames.npz")
    res = subprocess.run([sys.executable, "-c", _DECODE_CHILD, path, out], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, (res.returncode, res.stderr[-2000:])
    got = np.load(out)
    assert got["whole"].shape == (8, h, w, 3)
    np.testing.assert_array_equal(got["streamed"], got["whole"])
    cap = cv2.VideoCapture(path)
    want = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        want.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if tvideo.native_frames_safe(w) and got["native"]:
        # the library decodes this width (it converts YUV to RGB itself)
        return
    np.testing.assert_array_equal(got["whole"], np.stack(want))


def test_native_frames_safe_rule():
    assert [w for w in (48, 56, 64, 100, 120, 200, 384, 426, 640, 854, 1280, 1920)
            if not tvideo.native_frames_safe(w)] == [56, 120, 200, 426]
