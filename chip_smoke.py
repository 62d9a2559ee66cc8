"""GPU smoke run of the PyTorch port (vidi_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

1. Builds the hand-written CUDA kernels (K1 flash_attention, K2
   tower_attention, K3 decode_attention) from vidi_tpu_torch/csrc with nvcc.
2. Runs each kernel at the shapes the Vidi1.5-9B slice gives it (and K1 / K3
   at the 1.5B configuration's head dim 128) against its plain PyTorch
   version on the same inputs, and times both with CUDA events. Queries are
   scaled up so that logits reach tens and the softcap of 50 binds. A bf16
   output must lie within ULPS bf16 ulps of the plain output's largest
   magnitude; each case also runs planted faults (the plain version with the
   cap, mask, window or causality dropped) and fails unless every fault
   lands outside that limit.
3. Checks a small fp32 model end to end: the card (kernels) against the CPU
   (plain PyTorch).
4. Drives the slice: load_model(random_weights="9b") at full width, a
   synthetic 120 s clip (120 frames 384x384, 16 kHz audio), one media
   encode, then three temporal-retrieval queries through prompt ->
   generate(max_new_tokens=32) -> decode -> parse, counting kernel launches,
   and one query with use_flash_decode=True (K3).
5. With --profile, profiles the slice's encode, one prefill and eight decode
   steps on each decode route with torch.profiler.
6. Holds the K3 decode route's step-0 logits against the default route's,
   and a planted fault (K3 without its kv_mask) against the same limits.

Exits non-zero on any failure (no CUDA device, a kernel that does not build,
launch or agree, a planted fault the checks cannot see, a wrong output). The
line before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

SEED = 0
# Both sides compute in fp32 and round the probabilities and the output to
# bf16; they round P against different running maxima and sum in different
# orders, so an output element may land one bf16 ulp away. The limit is four
# ulps of the largest output magnitude.
ULPS = 4
# lse: fp32 log-sum-exp of the same fp32 logits in another summation order
# (the fp32 ulp at the |lse| ~ 40 of these cases is 3.8e-6).
LSE_ATOL = 1e-3
# Query scale-up for the kernel cases: logits of standard deviation ~12, so
# softmax rows are peaked and the softcap of 50 bends the largest logits.
Q_GAIN = 12.0
KV_TILE = 64  # keys per tile in csrc/*.cu: K2's ragged-edge fault drops the last partial one

# Ragged masks of the kernel cases: the last 24 frames of the image cache
# and the last Whisper window of the audio cache are padding, as for a 96 s
# clip batched with a 120 s one.
IMG_S, IMG_VALID = 23520, 23520 - 24 * 196
AUD_S, AUD_VALID = 1200, 900

K1_SRC = "vidi_tpu_torch/csrc/flash_attention.cu"
K2_SRC = "vidi_tpu_torch/csrc/tower_attention.cu"
K3_SRC = "vidi_tpu_torch/csrc/decode_attention.cu"

QUERIES = ("a red car driving past", "someone opens a door",
           "a dog runs across the grass")
PROFILE_DECODE_STEPS = 8


def _time_ms(fn, reps: int = 10) -> float:
    """Median device time of `fn` in ms over `reps` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bf16_ulp(x: float) -> float:
    """Spacing of bf16 numbers (8 significant bits) at magnitude x > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _check(name: str, got, want, faults: dict) -> float:
    """got vs want within ULPS bf16 ulps of max|want|; every planted fault
    (label -> the output of a known wrong kernel) must land outside it."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    top = float(want.abs().max())
    limit = ULPS * _bf16_ulp(top)
    err = float((got - want).abs().max())
    seen = {lab: float((f.float() - want).abs().max()) for lab, f in faults.items()}
    print(f"  {name}: max_abs_err={err:.3e}, limit {limit:.3e} ({ULPS} bf16 ulps "
          f"of max|want| {top:.3f}) {'ok' if err <= limit else 'FAIL'}; planted "
          "faults: " + ", ".join(f"{lab} {e:.3e}" for lab, e in seen.items()))
    if not err <= limit:
        raise AssertionError(f"{name}: max_abs_err {err:.3e} over {limit:.3e}")
    blind = [lab for lab, e in seen.items() if not e > limit]
    if blind:
        raise AssertionError(f"{name}: the limit does not reject the planted "
                             f"faults {blind}")
    return err


def _randn(gen, shape, dev, gain: float = 1.0, dtype=torch.bfloat16):
    x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    return (gain * x).to(dtype)


def _kv_mask(s: int, n_valid: int, dev):
    mask = torch.ones((1, s), dtype=torch.bool, device=dev)
    mask[:, n_valid:] = False
    return mask


def _faults(plain, args: dict, names) -> dict:
    """Outputs of the plain version with one feature dropped each: the
    readings of a kernel that forgot it."""
    drop = {"causal": ("no causal mask", {"causal": False}),
            "window": ("no window", {"window": None}),
            "mask": ("no kv_mask", {"kv_mask": None}),
            "cap": ("no softcap", {"softcap": None}) if args["softcap"]
            else ("softcap 50 applied", {"softcap": 50.0})}
    out = {}
    for n in names:
        label, kw = drop[n]
        res = plain(**{**args, **kw})
        out[label] = res[0] if isinstance(res, tuple) else res
    return out


def _prompt_lengths() -> tuple:
    """(real tokens, padded length) of the first query's TR prompt: the T
    that prefill gives K1 and the text-cache length that decode gives K3."""
    from vidi_tpu_torch import ByteTokenizer
    from vidi_tpu_torch.infer import pipeline as P

    ids = P.build_prompt_ids(QUERIES[0], ByteTokenizer())
    return len(ids), P.build_prompt_batch([ids])[0].shape[1]


def kernel_phases(dev) -> dict:
    """Each kernel against its plain version at the shapes the slice gives
    it (Vidi1.5-9B: 16 query / 8 KV heads of 256, softcap 50; 120 frames ->
    23,520 image tokens; 4 Whisper windows -> 1,200 audio tokens; the 1.5B
    configuration: 12 / 6 heads of 128), plus a sliding window short enough
    to bind and one case with the softcap off."""
    from vidi_tpu_torch.ops.cuda import decode_attention as k3
    from vidi_tpu_torch.ops.cuda import flash_attention as k1
    from vidi_tpu_torch.ops.cuda import tower_attention as k2

    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {}
    n_real, t = _prompt_lengths()

    # K1: T2T prefill (causal, window, cap; right-padded prompt) and the
    # T2V / T2A cross attention (ragged kv_mask)
    errs, cases = [], []
    for label, hq, hk, d, s, causal, window, cap, n_valid, faults in (
            (f"9b t2t T=S={t} causal window=4096 cap=50", 16, 8, 256, t, True,
             4096, 50.0, n_real, ("causal", "mask", "cap")),
            (f"9b t2t T=S={t} causal window=48 cap=50", 16, 8, 256, t, True,
             48, 50.0, n_real, ("window", "cap")),
            (f"9b t2v T={t} S={IMG_S} mask cap=50", 16, 8, 256, IMG_S, False,
             None, 50.0, IMG_VALID, ("mask", "cap")),
            (f"9b t2a T={t} S={AUD_S} mask cap=50", 16, 8, 256, AUD_S, False,
             None, 50.0, AUD_VALID, ("mask", "cap")),
            (f"9b t2a T={t} S={AUD_S} mask no cap", 16, 8, 256, AUD_S, False,
             None, None, AUD_VALID, ("mask", "cap")),
            (f"1.5b t2t T=S={t} causal window=4096 cap=50", 12, 6, 128, t, True,
             4096, 50.0, n_real, ("causal", "cap")),
            (f"1.5b t2v T={t} S={IMG_S} mask cap=50", 12, 6, 128, IMG_S, False,
             None, 50.0, IMG_VALID, ("mask", "cap"))):
        args = dict(q=_randn(gen, (1, t, hq, d), dev, Q_GAIN),
                    k=_randn(gen, (1, s, hk, d), dev),
                    v=_randn(gen, (1, s, hk, d), dev),
                    kv_mask=_kv_mask(s, n_valid, dev), sm_scale=d**-0.5,
                    causal=causal, window=window, softcap=cap)
        out, lse = k1.flash_attention(**args)
        ref, ref_lse = k1.flash_attention_plain(**args)
        errs.append(_check(f"K1 {label}", out, ref,
                           _faults(k1.flash_attention_plain, args, faults)))
        live = ref_lse < k1.EMPTY_ROW_LSE
        lse_err = float((lse[live] - ref_lse[live]).abs().max())
        print(f"  K1 {label} lse: max_abs_err={lse_err:.3e} (limit {LSE_ATOL})")
        if not (lse_err <= LSE_ATOL and torch.equal(lse[~live], ref_lse[~live])):
            raise AssertionError(f"K1 {label}: lse disagrees")
        ms = _time_ms(lambda: k1.flash_attention(**args))
        plain_ms = _time_ms(lambda: k1.flash_attention_plain(**args))
        print(f"  K1 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        cases.append({"shape": label, "ms": ms, "plain_ms": plain_ms})
    # the summary time is the 9B T2V case's, most of K1's time in the slice
    res["flash_attention"] = dict(
        src=K1_SRC, replaces="vidi_tpu/ops/pallas/flash_attention.py:396",
        max_abs_err=max(errs), cases=cases, **_times(cases, "9b t2v"))

    # K2: SigLIP (4 frames per encode chunk) and Whisper (1 window per chunk)
    errs, cases = [], []
    for label, b, n, h, dh in (("siglip B=4 T=729 H=16 D=72", 4, 729, 16, 72),
                               ("whisper B=1 T=1500 H=20 D=64", 1, 1500, 20, 64)):
        q = _randn(gen, (b, n, h, dh), dev, Q_GAIN)
        k, v = _randn(gen, (b, n, h, dh), dev), _randn(gen, (b, n, h, dh), dev)
        scale = dh**-0.5
        out = k2.tower_attention(q, k, v, scale)
        ref = k2.tower_attention_plain(q, k, v, scale)
        keep = n // KV_TILE * KV_TILE
        errs.append(_check(f"K2 {label}", out, ref, {
            f"keys past {keep} dropped": k2.tower_attention_plain(
                q, k[:, :keep], v[:, :keep], scale)}))
        ms = _time_ms(lambda: k2.tower_attention(q, k, v, scale))
        plain_ms = _time_ms(lambda: k2.tower_attention_plain(q, k, v, scale))
        print(f"  K2 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        cases.append({"shape": label, "ms": ms, "plain_ms": plain_ms})
    res["tower_attention"] = dict(
        src=K2_SRC, replaces="vidi_tpu/ops/pallas/tower_attention.py:179",
        max_abs_err=max(errs), cases=cases, **_times(cases, "siglip"))

    # K3: one decode step against a [L,B,Hk,S,D] cache's layer view: the
    # image and audio caches (global), the text cache grown by 32 decode
    # slots (window 4096 on sliding layers), and a binding window
    errs, cases = [], []
    for label, hq, hk, d, s, n_valid, window, q_pos, faults in (
            (f"9b image cache S={IMG_S} global", 16, 8, 256, IMG_S, IMG_VALID,
             None, None, ("mask", "cap")),
            (f"9b image cache S={IMG_S} window=4096", 16, 8, 256, IMG_S,
             IMG_S - 301, 4096, IMG_S - 302, ("window", "cap")),
            (f"9b audio cache S={AUD_S} global", 16, 8, 256, AUD_S, AUD_VALID,
             None, None, ("mask", "cap")),
            (f"9b text cache S={t + 32} window=4096", 16, 8, 256, t + 32,
             n_real + 6, 4096, n_real + 5, ("mask", "cap")),
            (f"1.5b image cache S={IMG_S} global", 12, 6, 128, IMG_S, IMG_VALID,
             None, None, ("mask", "cap"))):
        cache_k = _randn(gen, (2, 1, hk, s, d), dev)
        cache_v = _randn(gen, (2, 1, hk, s, d), dev)
        if q_pos is not None:
            q_pos = torch.tensor([q_pos], dtype=torch.int32, device=dev)
        args = dict(q=_randn(gen, (1, hq, d), dev, Q_GAIN), k=cache_k[1],
                    v=cache_v[1], kv_mask=_kv_mask(s, n_valid, dev),
                    sm_scale=d**-0.5, softcap=50.0, window=window, q_pos=q_pos)
        out = k3.decode_attention(**args)
        ref = k3.decode_attention_plain(**args)
        errs.append(_check(f"K3 {label}", out, ref,
                           _faults(k3.decode_attention_plain, args, faults)))
        ms = _time_ms(lambda: k3.decode_attention(**args))
        plain_ms = _time_ms(lambda: k3.decode_attention_plain(**args))
        print(f"  K3 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        cases.append({"shape": label, "ms": ms, "plain_ms": plain_ms})
    res["decode_attention"] = dict(
        src=K3_SRC, replaces="vidi_tpu/ops/pallas/decode_attention.py:80",
        max_abs_err=max(errs), cases=cases, **_times(cases, "9b image cache"))
    return res


def _times(cases, prefix: str) -> dict:
    """ms / plain_ms of the first case whose label starts with `prefix`."""
    c = next(c for c in cases if c["shape"].startswith(prefix))
    return {"ms": c["ms"], "plain_ms": c["plain_ms"]}


def _small_config():
    """A few-layer Dattn whose head dims are the 9B's kernel shapes (decoder
    256, SigLIP 72, Whisper 64), small enough to run on the CPU too."""
    import dataclasses

    from vidi_tpu_torch import AudioConfig, DattnConfig, TextConfig, VisionConfig
    return dataclasses.replace(
        DattnConfig.tiny(),
        text=dataclasses.replace(TextConfig.tiny(), hidden_size=256, num_heads=4,
                                 num_kv_heads=2, head_dim=256, num_layers=2,
                                 query_scale=256.0**-0.5),
        vision=dataclasses.replace(VisionConfig.tiny(), hidden_size=144,
                                   num_heads=2, num_layers=3),
        audio=dataclasses.replace(AudioConfig.tiny(), d_model=128, num_heads=2))


def reference_check(dev) -> None:
    """End to end at a small size in fp32: the port on the card (kernels)
    against the port on the CPU (plain PyTorch, the parity-tested path),
    same weights and inputs. Tokens must be identical; prefill hidden
    states within atol = rtol = 1e-3 (fp32, different summation orders)."""
    from vidi_tpu_torch.infer import generate as gen
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.models import dattn

    cfg = _small_config()
    params = dattn.init_params(cfg, torch.float32, torch.device("cpu"), SEED)
    to_dev = lambda t: t.to(dev)  # noqa: E731
    gparams = _tree_map(to_dev, params)
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (6, 42, 42, 3), dtype=np.uint8)
    mels = rng.standard_normal((2, 128, 3000)).astype(np.float32)
    ids = rng.integers(3, 259, (2, 20))
    mask = np.zeros((2, 20), bool)
    mask[0, :17], mask[1, :11] = True, True
    outs = {}
    for name, p, d, flash in (("cpu", params, torch.device("cpu"), False),
                              ("cuda", gparams, dev, True)):
        media = P.encode_media_arrays(p, cfg, frames, mels, 7000, mm_chunks=2,
                                      use_flash=flash)
        media = [m.repeat_interleave(2, dim=0) for m in media]
        pr = torch.as_tensor(ids * mask).to(d)
        pm = torch.as_tensor(mask).to(d)
        h, _, _ = gen._prefill(p, cfg, pr, pm, *media, max_new_tokens=8,
                               mm_chunks=2, use_flash=flash)
        res = gen.generate(p, cfg, pr, pm, *media, max_new_tokens=8, eos_id=2,
                           mm_chunks=2, use_flash=flash, use_flash_decode=flash)
        outs[name] = (h[pm].cpu(), res.tokens.cpu())  # real prompt rows
    err = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    ok = torch.allclose(outs["cuda"][0], outs["cpu"][0], atol=1e-3, rtol=1e-3)
    same = torch.equal(outs["cuda"][1], outs["cpu"][1])
    print(f"  small fp32 model, card (kernels) vs cpu (plain): hidden max_abs_err="
          f"{err:.3e} (atol=rtol=1e-3) {'ok' if ok else 'FAIL'}; tokens "
          f"{'identical' if same else 'DIFFER'}: {outs['cuda'][1].tolist()}")
    if not (ok and same):
        raise AssertionError("small-model reference check failed")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _synthetic_clip(seconds: int, size: int, sample_rate: int):
    """uint8 frames at 1 fps and a 16 kHz waveform (tones + noise), from SEED."""
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (seconds, size, size, 3), dtype=np.uint8)
    t = np.arange(seconds * sample_rate, dtype=np.float32) / sample_rate
    wave = (0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 97.0 * t)
            + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    return frames, wave


def load_slice(dev):
    """Vidi1.5-9B at full width on random weights, and the synthetic 120 s
    clip's frames and mel windows: the set-up every later phase shares."""
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.infer.loader import load_model

    t0 = time.perf_counter()
    params, cfg, tok = load_model(random_weights="9b", dtype=torch.bfloat16,
                                  device=dev, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  load_model(random_weights='9b'): {n_params / 1e9:.3f} B params, "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    seconds = 120
    frames, wave = _synthetic_clip(seconds, cfg.vision.image_size,
                                   cfg.audio.sampling_rate)
    mels, audio_len = P.process_audio(wave, cfg.audio)
    return types.SimpleNamespace(dev=dev, params=params, cfg=cfg, tok=tok,
                                 seconds=seconds, frames=frames, mels=mels,
                                 audio_len=audio_len, media=None)


def _encode(sl):
    from vidi_tpu_torch.infer import pipeline as P
    return P.encode_media_arrays(sl.params, sl.cfg, sl.frames, sl.mels,
                                 sl.audio_len, mm_chunks=32, use_flash=True)


def _prefill(sl, query: str):
    """Prefill of one TR query -> (h, caches, lens, embedding of token 0)."""
    from vidi_tpu_torch.infer import generate as gen
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.models import decoder

    prompt, mask = P.build_prompt_batch([P.build_prompt_ids(query, sl.tok)])
    pr = torch.as_tensor(prompt).long().to(sl.dev)
    pm = torch.as_tensor(mask).to(sl.dev)
    h, caches, lens = gen._prefill(sl.params, sl.cfg, pr, pm, *sl.media,
                                   max_new_tokens=32, mm_chunks=32, use_flash=True)
    tcfg = sl.cfg.text
    tok0 = decoder.lm_logits(sl.params["text"], h[:, int(lens[0]) - 1], tcfg).argmax(-1)
    return h, caches, lens, decoder.embed_tokens(sl.params["text"], tok0[:, None], tcfg)


def _decode_step(sl, emb, lens, caches, flash: bool):
    from vidi_tpu_torch.models import dattn
    return dattn.decode_step(sl.params, sl.cfg, emb, lens, caches,
                             img_mask=sl.media[1], aud_mask=sl.media[3],
                             use_flash=flash)[0]


def slice_phase(sl) -> dict:
    """One media encode, three TR queries on the default decode route, one
    on the K3 route, with every kernel's launch count read around them."""
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.infer.generate import generate
    from vidi_tpu_torch.ops.cuda import decode_attention as k3
    from vidi_tpu_torch.ops.cuda import flash_attention as k1
    from vidi_tpu_torch.ops.cuda import tower_attention as k2

    cfg, tok, dev, seconds = sl.cfg, sl.tok, sl.dev, sl.seconds
    eos = P.pick_eos(cfg, tok)

    k1.launches = k2.launches = k3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sl.media = img, img_mask, aud, aud_mask = _encode(sl)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    print(f"  encode: {seconds} frames {sl.frames.shape[1]}x{sl.frames.shape[2]} + "
          f"{sl.mels.shape[0]} audio windows -> img {tuple(img.shape)} "
          f"({int(img_mask.sum())} valid), aud {tuple(aud.shape)} "
          f"({int(aud_mask.sum())} valid) in {encode_s:.3f} s")
    for name, x in (("img", img), ("aud", aud)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"non-finite {name} features")
    side = P.budget_hw(seconds, cfg.mm_image_pool_size,
                       cfg.vision.num_patches_per_side)[0] // cfg.mm_image_pool_size
    if img.shape != (1, seconds * side * side, cfg.text.hidden_size) or \
            aud.shape != (1, sl.mels.shape[0] * 300, cfg.text.hidden_size):
        raise AssertionError("unexpected media feature shapes")

    def query(q, flash_decode):
        ids = P.build_prompt_ids(q, tok)
        prompt, mask = P.build_prompt_batch([ids])
        res = generate(sl.params, cfg, torch.as_tensor(prompt).long().to(dev),
                       torch.as_tensor(mask).to(dev), *sl.media,
                       max_new_tokens=32, eos_id=eos, mm_chunks=32, use_flash=True,
                       use_flash_decode=flash_decode)
        toks = res.tokens[0, : int(res.lengths[0])].cpu()
        if not ((toks >= 0) & (toks < cfg.text.vocab_size)).all():
            raise AssertionError("generated ids outside the vocabulary")
        text = tok.decode(toks.numpy(), skip_special_tokens=True).strip()
        answer = P.parse_task_output(text, "tr", float(seconds))
        rate = res.decode_steps / res.decode_s
        print(f"  query {q!r}: prompt {len(ids)} tok (padded {prompt.shape[1]}), "
              f"prefill {res.prefill_s:.3f} s, decode {res.decode_steps} steps "
              f"{res.decode_s:.3f} s = {rate:.2f} tok/s "
              f"({'K3' if flash_decode else 'plain'} decode route), "
              f"answer {answer!r}")
        return res, rate

    runs = [query(q, False) for q in QUERIES]
    k3_res, k3_rate = query(QUERIES[0], True)
    torch.cuda.synchronize()
    launches = {"flash_attention": k1.launches, "tower_attention": k2.launches,
                "decode_attention": k3.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  kernel launches in the slice: {launches}")
    print(f"  peak device memory (max_memory_allocated): {peak:.2f} GiB")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    if not torch.equal(k3_res.tokens[:, :1], runs[0][0].tokens[:, :1]):
        raise AssertionError("the first token must not depend on the decode route")
    plain_rate = statistics.mean(r for _, r in runs)
    print(f"  decode tok/s: plain route {plain_rate:.2f}, K3 route {k3_rate:.2f}")
    return launches


def profile_phase(sl, top: int = 12) -> None:
    """torch.profiler over the slice's encode, one prefill and
    PROFILE_DECODE_STEPS decode steps on each route. Each region runs once
    to warm up, once timed with the profiler off (wall time) and once under
    the profiler (device time summed over kernels); the idle share is
    1 - device time / wall time (one stream, kernels run one at a time)."""
    from torch.profiler import ProfilerActivity, profile

    def region(name, fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # device-side events only: the CPU ops that launched them carry the
        # same device time again
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        dev_us = sum(e.self_device_time_total for e in events)
        print(f"  == {name}: wall {wall * 1e3:.1f} ms, device {dev_us / 1e3:.1f} ms, "
              f"idle share {1 - dev_us / 1e6 / wall:.3f}")
        events.sort(key=lambda e: -e.self_device_time_total)
        for e in events[:top]:
            us = e.self_device_time_total
            print(f"     {us / 1e3:9.2f} ms {100 * us / max(dev_us, 1):5.1f}%  "
                  f"x{e.count:<6d} {e.key[:90]}")
        return out

    region("encode", lambda: _encode(sl))
    _, caches, lens, emb = region("prefill", lambda: _prefill(sl, QUERIES[0]))
    from vidi_tpu_torch.models import decoder
    for flash in (False, True):
        def steps():
            cur, e = lens.clone(), emb
            for _ in range(PROFILE_DECODE_STEPS):
                logits = _decode_step(sl, e, cur, caches, flash)
                e = decoder.embed_tokens(sl.params["text"], logits.argmax(-1)[:, None],
                                         sl.cfg.text)
                cur = cur + 1
            return logits
        region(f"decode {'K3' if flash else 'plain'} route x{PROFILE_DECODE_STEPS}",
               steps)


# Step-0 logits of the two decode routes. Both run bf16 activations through
# 42 random-weight layers and round attention outputs to bf16 at different
# points, so the difference grows layer by layer. The limits sit between the
# sound reading and a planted fault's (K3 ignoring its kv_mask): on an H100
# 80GB HBM3 the K3 route read 4.0e-2 and cosine 0.999979, the fault 0.296
# and 0.998998. Both readings are printed, and the fault must fail them.
LOGIT_REL = 1e-1   # max |difference| / max |logit|
LOGIT_COS = 0.9999  # least cosine similarity over the vocabulary


def _logit_gap(got, want) -> tuple:
    if not torch.isfinite(got).all():
        return math.inf, -1.0
    rel = float((got - want).abs().max()) / float(want.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(got.float(), want.float(),
                                                      dim=-1).min())
    return rel, cos


def decode_route_check(sl) -> None:
    """The K3 route's step-0 logits against the default route's on one
    prefill; a planted fault (K3 without its kv_mask) must fail the limits."""
    from vidi_tpu_torch.ops.cuda import decode_attention as k3

    _, caches, lens, emb = _prefill(sl, QUERIES[0])
    plain = _decode_step(sl, emb, lens, caches, False)
    readings = {"K3 route": _logit_gap(_decode_step(sl, emb, lens, caches, True), plain)}
    real = k3.decode_attention
    k3.decode_attention = lambda q, k, v, kv_mask, *a, **kw: real(q, k, v, None, *a, **kw)
    try:
        readings["planted fault, K3 without kv_mask"] = _logit_gap(
            _decode_step(sl, emb, lens, caches, True), plain)
    finally:
        k3.decode_attention = real
    for name, (rel, cos) in readings.items():
        print(f"  decode step 0 logits, {name} vs plain route: max_abs_err = "
              f"{rel:.3e} of max|logit| (limit {LOGIT_REL}), cosine {cos:.6f} "
              f"(limit {LOGIT_COS})")
    passes = {n: rel <= LOGIT_REL and cos >= LOGIT_COS for n, (rel, cos) in readings.items()}
    if not passes["K3 route"]:
        raise AssertionError("decode routes disagree on the step-0 logits")
    if passes["planted fault, K3 without kv_mask"]:
        raise AssertionError("the step-0 logit limits do not reject the planted fault")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the slice's phases with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    from vidi_tpu_torch.ops.cuda import _lib
    t0 = time.perf_counter()
    _lib.library()
    print(f"kernels: {_lib.library_path().name} ready in "
          f"{time.perf_counter() - t0:.1f} s (nvcc build "
          f"{'%.1f s' % _lib.build_seconds if _lib.build_seconds else 'cached'})")

    print("kernel phases:")
    kern = kernel_phases(dev)
    print("reference check:")
    reference_check(dev)
    print("slice (Vidi1.5-9B, random weights):")
    sl = load_slice(dev)
    launches = slice_phase(sl)
    if args.profile:
        print("profile:")
        profile_phase(sl)
    print("decode routes:")
    decode_route_check(sl)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": r["src"],
         "replaces": r["replaces"], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "cases": r["cases"]}
        for name, r in kern.items()]}))
    print(smi)  # name, power.limit as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
