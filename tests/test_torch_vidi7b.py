"""Vidi-7B in the port against vidi_tpu: the Mistral decoder, the CLIP
tower and the v1 adapters, at `DattnConfig.tiny("mistral")` (4 query heads
over 2 KV heads: G = 2) and a G = 4 variant of it (8 over 2, the 7B's
grouping), on the same weights (`params_from_jax`) and the same numpy
inputs, fp32 on the CPU.

- the v1 pool (`conv2d_pool_v1`, `bilinear_align_corners`) at
  tests/test_vidi7b.py's sizes: atol = rtol = 1e-5;
- the CLIP tower's `forward_features`: 2e-4; uint8 frames normalized with
  CLIP's processor statistics, not SigLIP's;
- `encode_video_images` / `encode_video_audios` in v1, `forward` hidden
  states and all six caches, `decode_step` logits: 2e-4 (the tolerance of
  tests/test_torch_dattn.py, same layers); greedy `generate` tokens
  identical on the reference route and on the kernels' route (whose K1 /
  K3 wrappers run their plain versions on CPU tensors);
- the mm_version text functions on the same strings: equal outputs;
- `ask` on a `make_video` clip: the same answer and the same generated ids;
  a tiny 7B checkpoint written by each package and read by the other;
  the CLI with --random-weights tiny7b;
- training (a G = 4 variant with 126 px CLIP frames and pool 4, where the
  v1 side 4 differs from the budget rule's 10 // 4): `draw_pos_noise`'s
  h / w draws at the v1 side and a train step with them; the loss and
  every gradient without noise, the towers frozen (test_torch_train_step's
  limits), and the
  loss with JAX's draws (1e-5 relative) against vidi_tpu's; the train CLI
  on a tiny 7B checkpoint through --model_path.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.infer import export as jexport
from vidi_tpu.infer import generate as jgen
from vidi_tpu.infer import loader as jloader
from vidi_tpu.infer import pipeline as jpipe
from vidi_tpu.infer import tasks as jtasks
from vidi_tpu.media.text import ByteTokenizer
from vidi_tpu.models import adapters as jadapters
from vidi_tpu.models import dattn as jdattn
from vidi_tpu.models import decoder as jdecoder
from vidi_tpu.models import siglip as jsiglip
from vidi_tpu_torch.core.config import DattnConfig as TConfig
from vidi_tpu_torch.infer import export as texport
from vidi_tpu_torch.infer import generate as tgen
from vidi_tpu_torch.infer import loader as tloader
from vidi_tpu_torch.infer import pipeline as tpipe
from vidi_tpu_torch.infer import tasks as ttasks
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.models import adapters as tadapters
from vidi_tpu_torch.models import dattn as tdattn
from vidi_tpu_torch.models import decoder as tdecoder
from vidi_tpu_torch.models import siglip as tsiglip
from vidi_tpu_torch.ops import preprocess as tpre
from torch_init import stacked  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from make_example import make_video  # noqa: E402
from test_torch_pipeline import _RecordingTokenizer  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
POOL_TOL = dict(atol=1e-5, rtol=1e-5)
CFG2 = DattnConfig.tiny("mistral")
CFG4 = dataclasses.replace(CFG2, text=dataclasses.replace(CFG2.text, num_heads=8))
CFGS = {"G=2": CFG2, "G=4": CFG4}
N_FRAMES, MEL_LEN = 3, 4000
QUERY = "a moving gradient"


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=msg, **tol)


@pytest.fixture(scope="module")
def models():
    """{"G=2" | "G=4": (jax params, port params)}: the port's init in
    vidi_tpu's layout (`init_both`), on the device once."""
    out = {}
    for name, cfg in CFGS.items():
        jp, tp = init_both(cfg)
        out[name] = (jax.tree.map(jnp.asarray, jp), tp)
    return out


@pytest.fixture(scope="module")
def media(models):
    """(jax features, port features) of a 3-frame uint8 clip and 2 audio
    windows, each package encoding with its own code (the towers and the
    adapters do not depend on G)."""
    jp, tp = models["G=2"]
    rng = np.random.default_rng(0)
    s = CFG2.vision.image_size
    frames = rng.integers(0, 256, (1, N_FRAMES, s, s, 3), dtype=np.uint8)
    mels = rng.standard_normal((1, 2, CFG2.audio.num_mel_bins, 3000)).astype(np.float32)
    counts, sizes = np.array([N_FRAMES]), np.array([MEL_LEN])
    hw = (0, 0)  # v1 pools to a fixed side: no token budget
    j = (*jdattn.encode_video_images(jp, CFG2, jnp.asarray(frames), jnp.asarray(counts), hw,
                                     mm_chunks=2),
         *jdattn.encode_video_audios(jp, CFG2, jnp.asarray(mels), jnp.asarray(sizes),
                                     mm_chunks=2))
    t = (*tdattn.encode_video_images(tp, CFG2, _t(frames), _t(counts), hw, mm_chunks=2),
         *tdattn.encode_video_audios(tp, CFG2, _t(mels), _t(sizes), mm_chunks=2))
    return j, t


@pytest.fixture(scope="module")
def prompt():
    """Two right-padded prompts of 27 and 19 tokens in a 32 bucket: longer
    than the tiny config's 16-key window, so the window binds."""
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 259, (2, 32)).astype(np.int32)
    mask = np.zeros((2, 32), bool)
    mask[0, :27], mask[1, :19] = True, True
    return ids * mask, mask


def _media2(feats):
    img, img_mask, aud, aud_mask = feats
    rep = (lambda x: jnp.repeat(x, 2, axis=0)) if isinstance(img, jax.Array) \
        else (lambda x: x.repeat_interleave(2, dim=0))
    return rep(img), rep(img_mask), rep(aud), rep(aud_mask)


# --- the v1 pool and the CLIP tower --------------------------------------------

POOL_SIZES = [(16, 8), (27, 14), (7, 3)]


@pytest.mark.parametrize("s_in,s_out", POOL_SIZES)
def test_conv2d_pool_v1_matches(s_in, s_out):
    d, k = 12, math.ceil(s_in / s_out)
    rng = np.random.default_rng(s_in)
    x = rng.standard_normal((3, s_in, s_in, d)).astype(np.float32)
    w = (rng.standard_normal((d, d, k, k)) * (d * k * k) ** -0.5).astype(np.float32)
    want = jadapters.conv2d_pool_v1({"w": jnp.asarray(w)}, jnp.asarray(x), s_out)
    got = tadapters.conv2d_pool_v1({"w": _t(w)}, _t(x), s_out)
    assert got.shape == (3, s_out, s_out, d)
    _close(got, want, POOL_TOL)


@pytest.mark.parametrize("s_in,s_out", POOL_SIZES)
def test_bilinear_align_corners_matches(s_in, s_out):
    x = np.random.default_rng(s_out).standard_normal((2, s_in, s_in + 1, 5)).astype(np.float32)
    for hw in ((s_out, s_out), (s_out, s_in + 1)):
        _close(tadapters.bilinear_align_corners(_t(x), hw),
               jadapters.bilinear_align_corners(jnp.asarray(x), hw), POOL_TOL)
    np.testing.assert_array_equal(
        tadapters._align_corners_matrix(s_out, s_in).numpy(),
        np.asarray(jadapters._align_corners_matrix(s_out, s_in)))


def test_clip_forward_features_matches(models):
    jp, tp = models["G=2"]
    vcfg = CFG2.vision
    imgs = np.random.default_rng(2).standard_normal(
        (2, vcfg.image_size, vcfg.image_size, 3)).astype(np.float32)
    want = jsiglip.forward_features(jp["vision"], jnp.asarray(imgs), vcfg)
    got = tsiglip.forward_features(tp["vision"], _t(imgs), vcfg)
    assert got.shape == (2, vcfg.num_patches, vcfg.hidden_size)  # class token dropped
    _close(got, want)
    assert "patch_b" not in tp["vision"] and tp["vision"]["pos_embed"].shape[0] == \
        vcfg.num_patches + 1


def test_uint8_clip_frames_take_clip_stats(models):
    """uint8 frames through `_frame_tokens` equal float frames normalized
    with CLIP's processor statistics, and differ from SigLIP's (0.5 / 0.5)."""
    _, tp = models["G=2"]
    s = CFG2.vision.image_size
    frames = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, s, s, 3),
                                                                dtype=np.uint8))
    got = tdattn._frame_tokens(tp, frames, CFG2, (0, 0), False)
    for (mean, std), same in ((tpre.tower_stats("clip"), True),
                              (tpre.tower_stats("siglip"), False)):
        x = tpre.normalize_uint8(frames, mean, std)
        want = tdattn._frame_tokens(tp, x, CFG2, (0, 0), False)
        assert torch.allclose(got, want, atol=1e-6) == same
    from vidi_tpu_torch.media import images
    for arch in ("clip", "siglip"):  # the device-side copy of the statistics
        assert tpre.tower_stats(arch) == images.tower_stats(arch)


def test_init_tree_matches_reference():
    """The port's random init has the reference's tree, shapes and dtypes
    (Mistral: ones for norms, no FFN norms, an untied lm_head; CLIP: a class
    token and a pre-LayerNorm; v1: a conv pool, the audio pool keeping
    d_aud)."""
    for cfg in CFGS.values():
        want = jax.tree_util.tree_map(lambda a: tuple(a.shape), params_from_jax(
            jax.device_get(jdattn.init_params(jax.random.PRNGKey(0), cfg, jnp.float32))))
        tp = tdattn.init_params(cfg, torch.float32, torch.device("cpu"), seed=0)
        got = jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
        assert got == want
        assert bool((tp["text"]["layers"][0]["input_ln"] == 1).all())
        assert bool((tp["text"]["final_ln"] == 1).all())


# --- the model -----------------------------------------------------------------

def test_encode_v1_media_matches(media):
    j, t = media
    assert t[0].shape == (1, N_FRAMES * CFG2.mm_image_pool_size**2, CFG2.text.hidden_size)
    for name, got, want in zip(("img", "img_mask", "aud", "aud_mask"), t, j):
        _close(got, want, msg=name)


def _forward_inputs(model, media, prompt, cfg):
    jp, tp = model
    ids, mask = prompt
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    j_media = _media2(media[0])
    j_in = (jdecoder.embed_tokens(jp["text"], jnp.asarray(ids), cfg.text),
            jnp.asarray(mask), jnp.asarray(pos), *j_media)
    t_in = (tdecoder.embed_tokens(tp["text"], _t(ids).long(), cfg.text),
            _t(mask), _t(pos).long(), *(_t(x) for x in j_media))
    return j_in, t_in


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("g", list(CFGS))
def test_forward_hidden_and_caches_match(models, media, prompt, g, use_flash):
    """use_flash=True runs the kernels' plain versions on the CPU; their
    window rule is by index, so padded query rows (and the text-cache slots
    they fill) may differ there and only real rows are compared."""
    cfg = CFGS[g]
    jp, tp = models[g]
    j_in, t_in = _forward_inputs(models[g], media, prompt, cfg)
    want_h, want_c = jdattn.forward(jp, cfg, *j_in, mm_chunks=3, return_caches=True)
    got_h, got_c = tdattn.forward(tp, cfg, *t_in, mm_chunks=3, return_caches=True,
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


@pytest.mark.parametrize("g", list(CFGS))
def test_decode_step_and_folded_o_w_match(models, media, prompt, g):
    """One decode step on both routes (K3's plain version at G = 2 / 4,
    every Mistral layer sliding), and o_proj folded over the group."""
    cfg = CFGS[g]
    jp, tp = models[g]
    np.testing.assert_array_equal(
        tdattn._fold_o_w(tp["text"]["layers"][1]["o_w"], cfg.text).numpy(),
        np.asarray(jdattn._fold_o_w(jp["text"]["layers"]["o_w"][1], cfg.text)))
    j_in, t_in = _forward_inputs(models[g], media, prompt, cfg)
    _, caches = jdattn.forward(jp, cfg, *j_in, return_caches=True)
    pad = lambda c: jnp.pad(c, ((0, 0),) * 3 + ((0, 4), (0, 0)))  # noqa: E731
    caches = caches._replace(text_k=pad(caches.text_k), text_v=pad(caches.text_v))
    cur_len = prompt[1].sum(axis=1).astype(np.int32)
    tok = np.array([[77], [78]], np.int32)
    want, _ = jdattn.decode_step(
        jp, cfg, jdecoder.embed_tokens(jp["text"], jnp.asarray(tok), cfg.text),
        jnp.asarray(cur_len), caches, img_mask=j_in[4], aud_mask=j_in[6])
    for use_flash in (False, True):
        t_caches = tdattn.Caches(*(_t(c) for c in caches))
        got, _ = tdattn.decode_step(
            tp, cfg, tdecoder.embed_tokens(tp["text"], _t(tok).long(), cfg.text),
            _t(cur_len).long(), t_caches, img_mask=t_in[4], aud_mask=t_in[6],
            use_flash=use_flash)
        _close(got, want, msg=f"use_flash={use_flash}")


@pytest.mark.parametrize("g", list(CFGS))
def test_generate_tokens_identical_on_both_routes(models, media, prompt, g):
    cfg = CFGS[g]
    jp, tp = models[g]
    ids, mask = prompt
    j_media = _media2(media[0])
    want = jgen.generate(jp, cfg, jnp.asarray(ids), jnp.asarray(mask), *j_media,
                         max_new_tokens=8, eos_id=2)
    t_media = [_t(x) for x in j_media]
    for use_flash in (False, True):
        got = tgen.generate(tp, cfg, _t(ids).long(), _t(mask), *t_media,
                            max_new_tokens=8, eos_id=2, use_flash=use_flash,
                            use_flash_decode=use_flash)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
        np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


# --- the mm_version text functions ---------------------------------------------

TEXTS = ["0.125-0.250, and 0.500-0.875", "12.5-30.25 and 40-55.0, .. -..-1",
         "0.000-0.250 Intro\n0.250-1.000: Main part\n..-.. junk", "no ranges here", ""]
HELPERS = {
    "build_task_prompt": lambda m, v: [
        m.build_task_prompt(t, "a red car.", mm_version=v, length=123.456,
                            options=["x", "y"])
        for t in ("tr", "stg", "chapter", "highlight", "qa", "mcq", "character")],
    "format_spans": lambda m, v: [m.format_spans([(0.1, 0.25), (0.5, 0.99)], 3725.0, v)],
    "parse_time_ranges": lambda m, v: [m.parse_time_ranges(x, v) for x in TEXTS],
    "parse_chapters": lambda m, v: [m.parse_chapters(x, 100.0, v) for x in TEXTS],
    "parse_highlights": lambda m, v: [m.parse_highlights(x, 100.0, v) for x in TEXTS],
    "parse_task_output": lambda m, v: [
        m.parse_task_output(x, task, 200.0, v) for x in TEXTS
        for task in ("tr", "chapter", "highlight", "mcq", "qa")],
}
MODULES = {"build_task_prompt": (jtasks, ttasks), "parse_chapters": (jtasks, ttasks),
           "parse_highlights": (jtasks, ttasks)}


@pytest.mark.parametrize("name", list(HELPERS))
def test_mm_version_helpers_match(name):
    jm, tm = MODULES.get(name, (jpipe, tpipe))
    for version in ("v1", "v1.5"):
        assert HELPERS[name](tm, version) == HELPERS[name](jm, version), version


def test_build_prompt_ids_match():
    tok = ByteTokenizer()
    for version in ("v1", "v1.5"):
        for task in ("tr", "mcq"):
            np.testing.assert_array_equal(
                tpipe.build_prompt_ids(QUERY + ".", tok, version, 61.0, task, ["a", "b"]),
                jpipe.build_prompt_ids(QUERY + ".", tok, version, 61.0, task, ["a", "b"]))
    # v1: the Mistral template and the stated length; the port's keyword
    # form (task=, options=) keeps working
    v1 = tpipe.build_prompt_ids(QUERY, tok, "v1", 61.0)
    assert "61.00" in tok.decode(v1)
    assert list(v1) != list(tpipe.build_prompt_ids(QUERY, tok, "v1.5", 61.0))
    np.testing.assert_array_equal(tpipe.build_prompt_ids(QUERY, tok, task="tr"),
                                  jpipe.build_prompt_ids(QUERY, tok))
    assert tpipe.format_spans([(0.1, 0.25)], 100.0, "v1") == "00:00:10.00-00:00:25.00"


# --- the slice: ask, checkpoints and the CLI -----------------------------------

@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("media") / "clip.mp4")
    make_video(path, seconds=6.0)
    return path


@pytest.mark.parametrize("g", list(CFGS))
def test_ask_gives_the_same_answer(clip, models, g):
    """Both routes of the port against vidi_tpu's ask: the same answer and
    the same generated ids (random weights rarely print a range)."""
    cfg = CFGS[g]
    jp, tp = models[g]
    kw = dict(max_new_tokens=12, mm_chunks=4, use_flash=False)
    jtok = _RecordingTokenizer()
    want = jpipe.ask(QUERY, clip, jp, cfg, jtok, **kw)
    for flash in (False, True):
        ttok = _RecordingTokenizer()
        got = tpipe.ask(QUERY, clip, tp, cfg, ttok, **dict(kw, use_flash=flash),
                        use_flash_decode=flash)
        assert got == want
        assert ttok.decoded == jtok.decoded and any(ttok.decoded)


@pytest.fixture(scope="module")
def exported(tmp_path_factory, models):
    root = tmp_path_factory.mktemp("exported7b")
    jp, tp = models["G=2"]
    jexport.save_pretrained(jax.device_get(jp), CFG2, str(root / "ref"))
    texport.save_pretrained(tp, TConfig.tiny("mistral"), str(root / "port"))
    return str(root / "ref"), str(root / "port")


def test_checkpoints_load_both_ways(exported, models, clip):
    """vidi_tpu's export read by the port and the port's read by vidi_tpu:
    the same leaves, bit-equal, and ask gives the same answer from each."""
    ref_dir, port_dir = exported
    jp0, tp0 = models["G=2"]
    tp, tcfg, _ = tloader.load_model(model_path=ref_dir, dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(TConfig.tiny("mistral"))
    got = jax.tree_util.tree_leaves_with_path(tp)
    want = dict(jax.tree_util.tree_leaves_with_path(tp0))
    assert len(got) == len(want)
    for path, leaf in got:
        assert torch.equal(leaf, want[path]), jax.tree_util.keystr(path)
    jp, jcfg, _ = jloader.load_model(model_path=port_dir, dtype=jnp.float32)
    assert jcfg == CFG2
    for (path, leaf), (_, ref) in zip(jax.tree_util.tree_leaves_with_path(jp),
                                      jax.tree_util.tree_leaves_with_path(jp0)):
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(ref),
                                      err_msg=jax.tree_util.keystr(path))
    kw = dict(max_new_tokens=8, mm_chunks=4, use_flash=False)
    jtok, ttok = _RecordingTokenizer(), _RecordingTokenizer()
    assert tpipe.ask(QUERY, clip, tp, tcfg, ttok, **kw) == \
        jpipe.ask(QUERY, clip, jp, jcfg, jtok, **kw)
    assert ttok.decoded == jtok.decoded


def test_cli_runs_tiny7b_on_cpu(clip):
    res = subprocess.run(
        [sys.executable, "-m", "vidi_tpu_torch.infer.pipeline", "--video-path", clip,
         "--query", QUERY, "--random-weights", "tiny7b", "--device", "cpu",
         "--dtype", "float32", "--max-new-tokens", "8", "--mm-splits", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1]


# --- training (ROADMAP Q1.19) ----------------------------------------------------
# v1 pools every frame to a fixed side (mm_image_pool_size), while the v1.5
# rule sizes a frame's tokens from the budget: hw // pool. With 9 x 9 CLIP
# patches (126 px) and pool 4 the two differ (4 against 10 // 4 = 2), as
# they do for the 7B (8 against 17 // 8 = 2), so a position-noise draw of
# the wrong length cannot broadcast.
CFG_TRAIN = dataclasses.replace(CFG4, vision=dataclasses.replace(CFG4.vision, image_size=126),
                                mm_image_pool_size=4, loss_thres=0.1)
TRAIN_TOL, TRAIN_FLOOR = 1e-4, 1e-7  # test_torch_train_step's leaf limits


def _train_batch():
    from vidi_tpu.train.data import synthetic_batch
    batch = synthetic_batch(CFG_TRAIN, b=2, t=16, n_frames=2, n_windows=1, seed=5)
    batch["frame_counts"][1] = 1
    batch["text_mask"][1, 12:] = False
    batch["labels"][1, 12:] = -100
    return batch


def _jax_loss(params, batch, hw, rng):
    """vidi_tpu's training loss (train_step.loss_fn's video branch, the
    towers frozen by stop_gradient), with `rng` None for no position noise
    (its loss_fn always draws)."""
    from vidi_tpu.train.losses import shifted_cross_entropy
    cfg = CFG_TRAIN
    params = {k: jax.tree.map(jax.lax.stop_gradient, v) if k in ("vision", "audio") else v
              for k, v in params.items()}
    rngs = jax.random.split(rng, 3) if rng is not None else (None,) * 3
    img, im = jdattn.encode_video_images(params, cfg, batch["images"], batch["frame_counts"],
                                         hw, pos_rng=rngs[0])
    aud, am = jdattn.encode_video_audios(params, cfg, batch["mels"], batch["audio_sizes"],
                                         pos_rng=rngs[1])
    mask = batch["text_mask"]
    pos = jnp.maximum(jnp.cumsum(mask, axis=1) - 1, 0).astype(jnp.int32)
    emb = jdecoder.embed_tokens(params["text"], batch["input_ids"], cfg.text)
    h, _ = jdattn.forward(params, cfg, emb, mask, pos, img=img, img_mask=im, aud=aud,
                          aud_mask=am)
    return shifted_cross_entropy(jdecoder.lm_logits(params["text"], h, cfg.text),
                                 batch["labels"], cfg.loss_thres)


def _port_cfg():
    base = TConfig.tiny("mistral")
    return dataclasses.replace(base, text=dataclasses.replace(base.text, num_heads=8),
                               vision=dataclasses.replace(base.vision, image_size=126),
                               mm_image_pool_size=4, loss_thres=0.1)


def init_both(cfg, seed: int = 0):
    """(vidi_tpu parameters, the port's) holding the same weights: the
    port's init, stacked into vidi_tpu's layout (numpy leaves, [L, ...]
    layers) and read back through params_from_jax. It takes a fraction of a
    second where vidi_tpu's init takes seconds to compile."""
    jp = stacked(tdattn.init_params(cfg, torch.float32, "cpu", seed))
    return jp, params_from_jax(jp)


def test_v1_train_step_with_position_noise():
    """draw_pos_noise draws the image h / w noise at the length of the v1
    table (mm_image_pool_size), and a train step runs with it; without noise
    the loss and every gradient match vidi_tpu's; fed JAX's draws, the noisy
    loss matches too."""
    from vidi_tpu.train.train_step import make_batch_hw
    from vidi_tpu_torch.train import optimizer as topt
    from vidi_tpu_torch.train import train_step as tstep
    from vidi_tpu_torch.train.data import to_device

    cfg = _port_cfg()
    jp, tp = init_both(CFG_TRAIN)
    batch = _train_batch()
    hw = make_batch_hw(CFG_TRAIN, int(batch["frame_counts"].sum()))
    noise = tdattn.draw_pos_noise(cfg, 2, 2, 1, hw, torch.Generator().manual_seed(0))
    tx = topt.make_optimizer(tp, topt.TrainHParams(total_steps=4))
    p = jax.tree.map(torch.clone, tp)
    _, _, loss = tstep.train_step(p, tstep.opt_init(tx, p), to_device(batch, "cpu"), noise,
                                  cfg=cfg, tx=tx, hw=hw, mm_chunks=2, frozen=("vision", "audio"))
    assert torch.isfinite(loss)
    assert noise["img_h"].shape == noise["img_w"].shape == (4,)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    nkey = jax.random.PRNGKey(3)
    (want_loss, want), want_noisy = jax.jit(lambda q: (
        jax.value_and_grad(lambda r: _jax_loss(r, jb, hw, None))(q),
        _jax_loss(q, jb, hw, nkey)))(jp)
    leaves = list(topt.leaves(tp))
    for _, _, x in leaves:
        x.requires_grad_(True)
    try:
        got_loss = tstep.loss_fn(tp, cfg, to_device(batch, "cpu"), None, hw=hw, mm_chunks=2,
                                 frozen=("vision", "audio"))
        got = torch.autograd.grad(got_loss, [x for _, _, x in leaves], allow_unused=True)
    finally:
        for _, _, x in leaves:
            x.requires_grad_(False)
    assert abs(float(got_loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for (key, path, _), g in zip(leaves, got):
        node, layer = want, None
        for k in path:
            layer, node = (k, node) if isinstance(k, int) else (layer, node[k])
        w = np.asarray(node if layer is None else node[layer])
        if g is None:  # the frozen towers: JAX's gradient is zero
            assert path[0] in ("vision", "audio") and not w.any(), key
            continue
        err = float(np.abs(g.numpy() - w).max())
        assert err <= TRAIN_TOL * float(np.abs(w).max()) + TRAIN_FLOOR, (key, err)

    rngs = jax.random.split(nkey, 3)
    img = jax.random.split(rngs[0], 3)
    n_aud = CFG_TRAIN.audio.max_source_positions // CFG_TRAIN.mm_audio_pool_size
    draws = {"img_h": jax.random.normal(img[0], (4,)), "img_w": jax.random.normal(img[1], (4,)),
             "img_t": jax.random.normal(img[2], (2, 2)),
             "aud_t": jax.random.normal(rngs[1], (2, n_aud))}
    want_noisy = float(want_noisy)
    got_noisy = float(tstep.loss_fn(tp, cfg, to_device(batch, "cpu"),
                                    {k: _t(v) for k, v in draws.items()}, hw=hw, mm_chunks=2,
                                    frozen=("vision", "audio")))
    assert abs(got_noisy - want_noisy) <= 1e-5 * abs(want_noisy)
    assert got_noisy != float(got_loss.detach())


def test_train_cli_trains_a_tiny7b_checkpoint(tmp_path):
    """A tiny 7B-shaped checkpoint (save_pretrained) through the train CLI's
    --model_path: two steps with position noise, the v1 model and its
    config kept in the export."""
    from vidi_tpu_torch.train import train as tcli

    cfg = dataclasses.replace(_port_cfg(), loss_thres=None)
    texport.save_pretrained(tdattn.init_params(cfg, torch.float32, "cpu", 0), cfg,
                            str(tmp_path / "ckpt"))
    out = tmp_path / "run"
    tcli.main(["--model_path", str(tmp_path / "ckpt"), "--data_path", "synthetic",
               "--max_steps", "2", "--output_dir", str(out), "--device", "cpu",
               "--dtype", "float32", "--use_flash", "--export_hf", str(tmp_path / "hf")])
    lines = [json.loads(x) for x in open(out / "metrics.jsonl")]
    assert [m["step"] for m in lines] == [0, 1] and all(np.isfinite(m["loss"]) for m in lines)
    # tokens a step: 64 text + 4 frames x the v1 side 4 x 4 (hw // pool would
    # count 2 x 2 a frame: 80)
    assert abs(lines[0]["tokens_per_sec"] * lines[0]["step_time_s"] - 128) < 1
    _, cfg2, _ = tloader.load_model(str(tmp_path / "hf"), dtype=torch.float32, device="cpu")
    assert cfg2.mm_version == "v1" and cfg2.mm_image_pool_size == 4
    assert cfg2.text.arch == "mistral" and cfg2.vision.image_size == 126
