"""The int8 serving slice of the port against vidi_tpu, on the CPU in fp32:
int8 SigLIP / Whisper towers (K5's plain version against the JAX fused
route, run in interpret mode), then the tiny Dattn with int8 text and
towers, W8A8 prefill and int8 modality caches (prefill hidden states,
caches, greedy tokens), `ask` with the same flags, and the CLI flags.

The towers are held to 1e-2 in relative (Frobenius) error: the two
frameworks sum a LayerNorm's mean in another order, and an LN output that
lands within that fp32 rounding of an int8 rounding boundary takes the
neighbouring code, which moves its q / k / v row by one step of 1/127 of
the row's largest value; attention spreads it (SigLIP read 3.8e-3, Whisper
1.6e-7). The Dattn side runs JAX op by op (`jax.disable_jit`), the
composition the port runs: under jit, XLA fuses the dequantize-fold-
requantize of `_fold_o_w` and rounds two of the tiny model's 2,048 folded
codes (and one scale's last bit) the other way, and the W8A8 activations
downstream then re-round. Op by op, every cache code agrees, and hidden
states and dequantized caches are held to 2e-4 (the bf16 slice's
tolerance, tests/test_torch_dattn.py). Greedy tokens, from JAX's jitted
`generate`, must be identical.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidi_tpu.core.config import AudioConfig, DattnConfig, VisionConfig
from vidi_tpu.infer import generate as jgen
from vidi_tpu.infer import pipeline as jpipe
from vidi_tpu.infer import quantize as jq
from vidi_tpu.media.text import ByteTokenizer
from vidi_tpu.models import adapters as jadapters
from vidi_tpu.models import dattn as jdattn
from vidi_tpu.models import decoder as jdecoder
from vidi_tpu.models import siglip as jsiglip
from vidi_tpu.models import whisper as jwhisper
from vidi_tpu.ops.pallas import fused_tower_layer as jftl
from vidi_tpu_torch.infer import generate as tgen
from vidi_tpu_torch.infer import pipeline as tpipe
from vidi_tpu_torch.infer import quantize as tq
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.infer.loader import load_model
from vidi_tpu_torch.models import dattn as tdattn
from vidi_tpu_torch.models import decoder as tdecoder
from vidi_tpu_torch.models import siglip as tsiglip
from vidi_tpu_torch.models import whisper as twhisper

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from make_example import make_video  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
INT8_REL = 1e-2  # towers only; see the module docstring
CFG = DattnConfig.tiny()
MODULES = ("text", "vision", "audio")
# W8A8 for the audio stream's k/v (2 x 600 rows) and its diagonal-update
# chunks (2 x 200); weight-only for the image stream (2 x 20 rows, chunks of
# <= 14), the 2 x 16 text rows and decode
W8A8_MIN = 64
QUERY = "a moving gradient"


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close_int8(got, want, name=""):
    err = _rel_err(got, want)
    assert err <= INT8_REL, f"{name}: relative error {err:.3e} over {INT8_REL}"


@pytest.fixture
def w8a8(monkeypatch):
    monkeypatch.setattr(jq, "w8a8_min_tokens", W8A8_MIN)
    monkeypatch.setattr(tq, "w8a8_min_tokens", W8A8_MIN)


@pytest.fixture
def fused_interpret(monkeypatch):
    monkeypatch.setattr(jftl, "INTERPRET", True)


def test_int8_siglip_matches_fused_route(fused_interpret):
    cfg = VisionConfig(hidden_size=256, intermediate_size=456, num_layers=3, num_heads=4,
                       patch_size=16, image_size=64, select_layer=-2)
    jp = jq.quantize_tower_params(jsiglip.init_params(jax.random.key(1), cfg, jnp.float32))
    assert jftl.use_fused(jax.tree.map(lambda a: a[0], jp["layers"]))
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jsiglip.forward_features(jp, jnp.asarray(x), cfg)
    got = tsiglip.forward_features(params_from_jax(jax.device_get(jp)), _t(x), cfg)
    _close_int8(got.numpy(), want, "siglip")


def test_int8_whisper_matches_fused_route(fused_interpret):
    cfg = AudioConfig(d_model=256, ffn_dim=512, num_layers=2, num_heads=4,
                      num_mel_bins=32, max_source_positions=64)
    jp = jq.quantize_tower_params(jwhisper.init_params(jax.random.key(3), cfg, jnp.float32))
    mel = np.random.default_rng(4).standard_normal((2, 32, 128)).astype(np.float32)
    want = jwhisper.forward(jp, jnp.asarray(mel), cfg)
    got = twhisper.forward(params_from_jax(jax.device_get(jp)), _t(mel), cfg)
    _close_int8(got.numpy(), want, "whisper")


@pytest.fixture(scope="module")
def model():
    jp = jq.quantize_params(jdattn.init_params(jax.random.PRNGKey(0), CFG, jnp.float32),
                            modules=MODULES)
    return jp, params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def inputs(model):
    """Media features (each package encodes with its own int8 towers) and two
    right-padded prompts of 13 and 9 tokens, both rows sharing the clip."""
    jp, tp = model
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (1, 5, 42, 42, 3), dtype=np.uint8)
    mels = rng.standard_normal((1, 2, 128, 3000)).astype(np.float32)
    hw = jadapters.budget_hw(5, 2, CFG.vision.num_patches_per_side)
    counts, sizes = np.array([5]), np.array([4000])
    with jax.disable_jit():
        j_media = (*jdattn.encode_video_images(jp, CFG, jnp.asarray(frames),
                                               jnp.asarray(counts), hw, mm_chunks=2),
                   *jdattn.encode_video_audios(jp, CFG, jnp.asarray(mels),
                                               jnp.asarray(sizes), mm_chunks=2))
    t_media = (*tdattn.encode_video_images(tp, CFG, _t(frames), _t(counts), hw,
                                           mm_chunks=2),
               *tdattn.encode_video_audios(tp, CFG, _t(mels), _t(sizes), mm_chunks=2))
    ids = rng.integers(3, 259, (2, 16)).astype(np.int32)
    mask = np.zeros((2, 16), bool)
    mask[0, :13], mask[1, :9] = True, True
    j_media = tuple(jnp.repeat(x, 2, axis=0) for x in j_media)
    return j_media, t_media, ids * mask, mask


def test_int8_media_encode_matches(inputs):
    j_media, t_media = inputs[:2]
    for got, want in zip(t_media, j_media):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:1], **TOL)


def test_int8_prefill_hidden_and_caches_match(model, inputs, w8a8):
    jp, tp = model
    j_media, _, ids, mask = inputs
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    with jax.disable_jit():
        want_h, want_c = jdattn.forward(
            jp, CFG, jdecoder.embed_tokens(jp["text"], jnp.asarray(ids), CFG.text),
            jnp.asarray(mask), jnp.asarray(pos), *j_media, mm_chunks=3,
            return_caches=True, quantize_caches=True)
    got_h, got_c = tdattn.forward(
        tp, CFG, tdecoder.embed_tokens(tp["text"], _t(ids).long(), CFG.text),
        _t(mask), _t(pos).long(), *(_t(x) for x in j_media), mm_chunks=3,
        return_caches=True, quantize_caches=True)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    for name in ("img_k", "img_v", "aud_k", "aud_v"):
        got, want = getattr(got_c, name), getattr(want_c, name)
        assert got["qi8"].dtype == torch.int8 and got["scale"].shape[-1] == 1
        np.testing.assert_allclose(tq.dequantize_cache(got, torch.float32).numpy(),
                                   np.asarray(jq.dequantize_cache(want, jnp.float32)),
                                   err_msg=name, **TOL)
    for name in ("text_k", "text_v"):
        np.testing.assert_allclose(getattr(got_c, name).numpy(),
                                   np.asarray(getattr(want_c, name)), err_msg=name, **TOL)


def test_w8a8_routes_the_audio_stream_only(model, inputs, w8a8, monkeypatch):
    """At W8A8_MIN the audio stream's products and chunks take K6's W8A8
    functions and nothing else does."""
    from vidi_tpu_torch.ops.cuda import quant_matmul as tqm

    rows = {"quant_matmul": [], "quant_gated_mlp": []}
    for name in rows:
        real = getattr(tqm, name)

        def spy(x, *a, _real=real, _name=name, **kw):
            rows[_name].append(x.numel() // x.shape[-1])
            return _real(x, *a, **kw)
        monkeypatch.setattr(tqm, name, spy)
    _, tp = model
    _, t_media, ids, mask = inputs
    t_media = [x.repeat_interleave(2, dim=0) for x in t_media]
    tgen.generate(tp, CFG, _t(ids).long(), _t(mask), *t_media, max_new_tokens=2,
                  eos_id=-1, mm_chunks=3, quantize_caches=True)
    n = CFG.text.num_layers
    # per layer: audio k, v (1200 rows) and the folded o of 3 chunks of 400
    # (the gated MLP's down projection runs inside quant_gated_mlp)
    assert sorted(rows["quant_matmul"]) == sorted([1200] * 2 * n + [400] * 3 * n)
    assert rows["quant_gated_mlp"] == [400] * 3 * n


def test_int8_generate_tokens_identical(model, inputs, w8a8):
    jp, tp = model
    j_media, _, ids, mask = inputs
    want = jgen.generate(jp, CFG, jnp.asarray(ids), jnp.asarray(mask), *j_media,
                         max_new_tokens=8, eos_id=2, mm_chunks=3, quantize_caches=True)
    got = tgen.generate(tp, CFG, _t(ids).long(), _t(mask), *(_t(x) for x in j_media),
                        max_new_tokens=8, eos_id=2, mm_chunks=3, quantize_caches=True)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("media") / "clip.mp4")
    make_video(path, seconds=6.0)
    return path


class _RecordingTokenizer(ByteTokenizer):
    def __init__(self):
        super().__init__()
        self.decoded = []

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        self.decoded.append([int(t) for t in ids])
        return super().decode(ids, skip_special_tokens)


def test_int8_ask_gives_the_same_answer(clip, model, monkeypatch):
    monkeypatch.setattr(jq, "w8a8_min_tokens", 16)
    monkeypatch.setattr(tq, "w8a8_min_tokens", 16)
    jp, tp = model
    kw = dict(max_new_tokens=16, mm_chunks=4, use_flash=False, quantize_caches=True)
    jtok, ttok = _RecordingTokenizer(), _RecordingTokenizer()
    want = jpipe.ask(QUERY, clip, jp, CFG, jtok, **kw)
    got = tpipe.ask(QUERY, clip, tp, CFG, ttok, **kw)
    assert got == want
    assert ttok.decoded == jtok.decoded and any(ttok.decoded)


def test_int8_cli_flags(clip, monkeypatch):
    """The CLI with every int8 flag on the CPU prints what `ask` gives on
    load_model with the same options."""
    flags = ["--load-8bit", "--load-8bit-towers", "--quantize-kv", "--w8a8-prefill", "16"]
    res = subprocess.run(
        [sys.executable, "-m", "vidi_tpu_torch.infer.pipeline", "--video-path", clip,
         "--query", QUERY, "--random-weights", "tiny", "--device", "cpu", "--dtype",
         "float32", "--max-new-tokens", "8", *flags],
        cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    monkeypatch.setattr(tq, "w8a8_min_tokens", 16)
    params, cfg, tok = load_model(random_weights="tiny", dtype=torch.float32,
                                  device="cpu", load_8bit=True, load_8bit_towers=True)
    assert params["text"]["layers"][0]["q_w"]["qi8"].dtype == torch.int8
    assert params["vision"]["layers"][0]["fc1_w"]["qi8"].shape[-1] == 128
    want = tpipe.ask(QUERY, clip, params, cfg, tok, max_new_tokens=8,
                     quantize_caches=True)
    assert res.stdout.strip().splitlines()[-1] == (want or "(no parsed output)")


def test_load_4bit_text():
    params, _, _ = load_model(random_weights="tiny", dtype=torch.float32, device="cpu",
                              load_4bit=True)
    ref, _, _ = load_model(random_weights="tiny", dtype=torch.float32, device="cpu")
    got = params["text"]["layers"][3]["down_w"]
    want = tq.quantize_weight4(ref["text"]["layers"][3]["down_w"])
    assert torch.equal(got["qi4"], want["qi4"]) and torch.equal(got["scale"], want["scale"])
    assert not tq.is_quantized(params["vision"]["layers"][0]["q_w"])
