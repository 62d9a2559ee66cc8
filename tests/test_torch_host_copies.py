"""The port's copies of vidi_tpu's host modules against their originals.

vidi_tpu_torch imports nothing of vidi_tpu, so it keeps its own copies of
the jax-free host code (media, training data, utils, constants). Each copy
is held to its original line by line: the only differences allowed are the
renamed imports and the parts named in EXCEPTIONS, each of which must still
be there (an exception that no longer matches fails too). Then the copies of
the audio features, the image processors and the text splicing run on the
same seeded inputs as the originals and must give equal outputs.
"""
import difflib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from vidi_tpu.core.config import AudioConfig as JaxAudioConfig
from vidi_tpu.media import audio as jax_audio
from vidi_tpu.media import images as jax_images
from vidi_tpu.media import text as jax_text
from vidi_tpu_torch.core.config import AudioConfig
from vidi_tpu_torch.media import audio, images, text

ROOT = Path(__file__).resolve().parents[1]
COPIES = ("media/text.py", "media/audio.py", "media/images.py", "media/video.py",
          "train/data.py", "train/prefetch.py", "train/packing.py", "train/samplers.py",
          "train/tb.py", "utils.py", "constants.py")
# file -> [(opcode, a text the changed lines contain, why)]: the differences
# left on purpose, beyond the package name in imports
EXCEPTIONS = {
    "media/audio.py": [
        ("replace", "melspec_jax", "the docstring's mention of the jax transform"),
        ("delete", "def melspec_jax", "the on-device jax mel transform, which nothing calls"),
    ],
    "media/video.py": [
        ("replace", "except OSError", "a native decoder that cannot load (built against "
                                      "libav that is not installed) is skipped: cv2 decodes"),
        ("replace", "native_frames_safe", "the docstring's mention of the width rule"),
        ("insert", "def native_frames_safe", "the native frame decode overruns its rows "
                                             "at width % 16 >= 8 (ROADMAP Q3.11)"),
        ("replace", "if lib and native_frames_safe(w)", "load_video: cv2 for such widths"),
        ("replace", 'hasattr(lib, "vm_stream_open") and native_frames_safe(w)',
         "stream_video: cv2 for such widths"),
    ],
    "train/tb.py": [
        ("replace", "Tensorboard scalar reporting", "the docstring's first line names "
                                                    "the train CLI"),
    ],
    "train/data.py": [
        ("insert", "import torch", "the port's batches become torch tensors"),
        ("insert", "def to_device", "the port's own addition: numpy batch -> tensors"),
    ],
    "utils.py": [
        ("delete", "profile_trace", "the docstring's entry for the jax profiler"),
        ("delete", "import contextlib", "only profile_trace used it"),
        ("delete", "def profile_trace", "jax's profiler; chip_smoke.py --profile stands in"),
    ],
}


def _lines(path: Path):
    # the one rename allowed everywhere: the package of an import
    return [line.replace("vidi_tpu_torch", "vidi_tpu") for line in path.read_text().splitlines()]


@pytest.mark.parametrize("name", COPIES)
def test_copy_matches_its_original_line_by_line(name):
    orig, copy = _lines(ROOT / "vidi_tpu" / name), _lines(ROOT / "vidi_tpu_torch" / name)
    unused = list(EXCEPTIONS.get(name, []))
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(a=orig, b=copy, autojunk=False).get_opcodes():
        if op == "equal":
            continue
        changed = "\n".join(orig[i1:i2] + copy[j1:j2])
        hit = next((e for e in unused if e[0] == op and e[1] in changed), None)
        assert hit is not None, (f"vidi_tpu_torch/{name} drifted from vidi_tpu/{name}:\n"
                                 f"{op} {orig[i1:i2]} -> {copy[j1:j2]}")
        unused.remove(hit)
    assert not unused, f"{name}: exceptions that no longer match: {unused}"


def _waves(seed):
    rng = np.random.default_rng(seed)
    cfg = AudioConfig()
    # a window and a half, and a clip shorter than one window
    return [rng.uniform(-1, 1, int(1.5 * cfg.n_samples)).astype(np.float32),
            rng.uniform(-1, 1, cfg.n_samples // 3).astype(np.float32)]


@pytest.mark.parametrize("which", [0, 1])
def test_process_audio_equals_the_original(which):
    wave = _waves(3)[which]
    got, got_len = audio.process_audio(wave, AudioConfig())
    want, want_len = jax_audio.process_audio(wave, JaxAudioConfig())
    assert got_len == want_len
    np.testing.assert_array_equal(got, want)


def _frames(seed, n=3, shape=(90, 120)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*shape, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("fn,size", [("preprocess_frames_resize", 64),
                                     ("preprocess_frames_pad", 64),
                                     ("preprocess_frames_crop", 48),
                                     ("resize_frames_uint8", 64)])
def test_image_processors_equal_the_originals(fn, size):
    frames = _frames(4)
    np.testing.assert_array_equal(getattr(images, fn)(frames, size),
                                  getattr(jax_images, fn)(frames, size))


def test_anyres_image_equals_the_original():
    img = Image.fromarray(_frames(5, 1, (200, 300))[0])
    grid = [(64, 128), (128, 64), (128, 128)]
    got = images.process_anyres_image(img, 64, grid)
    want = jax_images.process_anyres_image(img, 64, grid)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


CONVS = [
    [{"from": "human", "value": "what happens here? <image>"},
     {"from": "gpt", "value": "a red car drives past."}],
    [{"from": "human", "value": "<image>\nfind the dog"},
     {"from": "gpt", "value": "0.10-0.35"},
     {"from": "human", "value": "and the cat?"},
     {"from": "gpt", "value": "none"}],
]


@pytest.mark.parametrize("conv", CONVS, ids=["one turn", "two turns"])
@pytest.mark.parametrize("arch", ["gemma2", "mistral"])
def test_text_splicing_equals_the_original(conv, arch):
    tok, jtok = text.ByteTokenizer(), jax_text.ByteTokenizer()
    norm = text.normalize_mm_turn(conv)
    assert norm == jax_text.normalize_mm_turn(conv)
    prompt = text.preprocess_chat(norm, tok, arch)
    assert prompt == jax_text.preprocess_chat(norm, jtok, arch)
    assert text.tokenizer_image_token(prompt, tok) == jax_text.tokenizer_image_token(prompt, jtok)
    got = text.preprocess_conv(norm, tok, True, arch=arch)
    want = jax_text.preprocess_conv(norm, jtok, True, arch=arch)
    for key in ("input_ids", "labels"):
        np.testing.assert_array_equal(got[key], want[key])
