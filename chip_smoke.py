"""GPU smoke run of the PyTorch port (vidi_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

1. Builds the hand-written CUDA kernels (K1 flash_attention, K2
   tower_attention, K3 decode_attention, K4 flash_attention_bwd) from
   vidi_tpu_torch/csrc with nvcc.
2. Runs each kernel at the shapes the Vidi1.5-9B slices give it (and K1 /
   K3 / K4 at the 1.5B configuration's head dim 128) against its plain
   PyTorch version on the same inputs, and times both with CUDA events.
   Queries are scaled up so that logits reach tens and the softcap of 50
   binds. A bf16 output must lie within ULPS bf16 ulps of the plain
   output's largest magnitude; each case also runs planted faults (the
   plain version with the cap, mask, window, causality, segments, di or the
   cap's derivative dropped) and fails unless every fault lands outside
   that limit.
3. Checks small fp32 models end to end, the card (kernels) against the CPU
   (plain PyTorch): a prefill + greedy decode, and two training steps.
4. Drives the serving slice: load_model(random_weights="9b") at full width,
   a synthetic 120 s clip (120 frames 384x384, 16 kHz audio), one media
   encode, then three temporal-retrieval queries through prompt ->
   generate(max_new_tokens=32) -> decode -> parse, counting kernel launches,
   and one query with use_flash_decode=True (K3). It holds the K3 decode
   route's step-0 logits against the default route's, and a planted fault
   (K3 without its kv_mask) against the same limits.
5. Frees the serving model and drives the training slice: Vidi1.5-9B at
   full width with TRAIN_LAYERS text layers (bf16, towers frozen, remat,
   use_flash), four train_steps on synthetic batches of 256 text tokens,
   120 frames and 4 Whisper windows, counting K1 / K2 / K4 launches. It
   then holds the gradients of a few leaves on the kernel route against the
   plain-attention route, and a planted fault (K4 without di) against the
   same limits.
6. With --profile, profiles the serving slice's encode, one prefill and
   eight decode steps on each decode route, and one training step, with
   torch.profiler.

Exits non-zero on any failure (no CUDA device, a kernel that does not build,
launch or agree, a planted fault the checks cannot see, a wrong output). The
line before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import gc
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
K4_SRC = "vidi_tpu_torch/csrc/flash_attention_bwd.cu"
TRAIN_T = 256  # text rows of the training slice's batch

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


def _k4_faults(k4, args: dict, names) -> dict:
    """(dq, dk, dv) of the plain backward with one step dropped each: the
    readings of a K4 that forgot it."""
    def no_cap_derivative():
        # the plain formulas with dz = p (dp - di), the (1 - tanh^2) factor gone
        q, k, v, do = (args[n].float() for n in ("q", "k", "v", "do"))
        b, t, hq, d = q.shape
        hk = k.shape[2]
        g = hq // hk
        qg, dog = q.reshape(b, t, hk, g, d), do.reshape(b, t, hk, g, d)
        raw = torch.einsum("bthgd,bshd->bhgts", qg, k) * args["sm_scale"]
        z = torch.tanh(raw / args["softcap"]) * args["softcap"]
        mask = k1_visible(args)[:, None, None]
        p = torch.where(mask, torch.exp(z - args["lse"].reshape(b, hk, g, t, 1)), 0.0)
        di = (args["out"].float() * do).sum(-1).reshape(b, t, hk, g)
        dp = torch.einsum("bthgd,bshd->bhgts", dog, v)
        dz = torch.where(mask, p * (dp - di.permute(0, 2, 3, 1)[..., None]), 0.0)
        scale = args["sm_scale"]
        return (torch.einsum("bhgts,bshd->bthgd", dz, k).reshape(b, t, hq, d) * scale,
                torch.einsum("bhgts,bthgd->bshd", dz, qg) * scale,
                torch.einsum("bhgts,bthgd->bshd", p, dog))

    def k1_visible(a):
        from vidi_tpu_torch.ops.cuda.flash_attention import visible_mask
        b, t = a["q"].shape[:2]
        return visible_mask(b, t, a["k"].shape[1], a["kv_mask"], a["causal"],
                            a["window"], a["q_segs"], a["kv_segs"], a["q"].device)

    plain = k4.flash_attention_bwd_plain
    drop = {
        "cap": ("no softcap derivative", no_cap_derivative),
        "di": ("di dropped", lambda: plain(**{**args, "out": torch.zeros_like(args["out"])})),
        "mask": ("p and dz not masked by kv_mask",
                 lambda: plain(**{**args, "kv_mask": None})),
        "causal": ("no causal mask", lambda: plain(**{**args, "causal": False})),
        "window": ("no window", lambda: plain(**{**args, "window": None})),
        "segs": ("segments ignored", lambda: plain(**{**args, "q_segs": None,
                                                      "kv_segs": None})),
    }
    return {drop[n][0]: drop[n][1]() for n in names}


def k4_phase(dev) -> dict:
    """K4 (flash attention backward) against its plain version at the
    training slice's shapes (Vidi1.5-9B, T = 256 text rows; 120 frames ->
    23,520 image keys; 4 Whisper windows -> 1,200 audio keys; the 1.5B at
    head dim 128). q is scaled by Q_GAIN so the cap binds, dO ~ N(0, 1) on
    valid rows and 0 on padded ones; out and lse come from K1. dq, dk and
    dv must each lie within ULPS bf16 ulps of the plain output's largest
    magnitude, and every planted fault outside."""
    from vidi_tpu_torch.ops.cuda import flash_attention as k1
    from vidi_tpu_torch.ops.cuda import flash_attention_bwd as k4

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    t, n_valid = TRAIN_T, TRAIN_T - 20
    packed = torch.zeros((1, t), dtype=torch.int32, device=dev)
    packed[0, :90], packed[0, 90:170], packed[0, 170:n_valid] = 1, 2, 3
    errs, cases = [], []
    for label, hq, hk, d, s, causal, window, n_keys, segs, faults in (
            (f"9b t2t T=S={t} causal window=4096 cap=50", 16, 8, 256, t, True,
             4096, n_valid, None, ("causal", "di", "cap")),
            (f"9b t2t T=S={t} causal window=48 cap=50", 16, 8, 256, t, True,
             48, n_valid, None, ("window", "di", "cap")),
            (f"9b t2v T={t} S={IMG_S} mask cap=50", 16, 8, 256, IMG_S, False,
             None, IMG_VALID, None, ("mask", "di", "cap")),
            (f"9b t2a T={t} S={AUD_S} mask cap=50", 16, 8, 256, AUD_S, False,
             None, AUD_VALID, None, ("mask", "di", "cap")),
            (f"9b packed t2t T=S={t} 3 segments cap=50", 16, 8, 256, t, True,
             4096, n_valid, packed, ("segs", "di", "cap")),
            (f"1.5b t2v T={t} S={IMG_S} mask cap=50", 12, 6, 128, IMG_S, False,
             None, IMG_VALID, None, ("mask", "di", "cap"))):
        q = _randn(gen, (1, t, hq, d), dev, Q_GAIN)
        k, v = _randn(gen, (1, s, hk, d), dev), _randn(gen, (1, s, hk, d), dev)
        kv_mask = _kv_mask(s, n_keys, dev)
        fwd = dict(sm_scale=d**-0.5, causal=causal, window=window, softcap=50.0,
                   q_segs=segs, kv_segs=segs)
        out, lse = k1.flash_attention(q, k, v, kv_mask, **fwd)
        rows = n_valid if causal else t  # T2T rows past the prompt are padding
        do = _randn(gen, (1, t, hq, d), dev)
        do[:, rows:] = 0
        args = dict(q=q, k=k, v=v, kv_mask=kv_mask, out=out, lse=lse, do=do, **fwd)
        got = k4.flash_attention_bwd(**args)
        want = k4.flash_attention_bwd_plain(**args)
        bad = _k4_faults(k4, args, faults)
        for i, name in enumerate(("dq", "dk", "dv")):
            # dv = p^T dO depends on neither di nor the softcap derivative
            errs.append(_check(f"K4 {label} {name}", got[i], want[i], {
                lab: f[i] for lab, f in bad.items()
                if name != "dv" or lab not in ("di dropped", "no softcap derivative")}))
        del bad
        ms = _time_ms(lambda: k4.flash_attention_bwd(**args))
        plain_ms = _time_ms(lambda: k4.flash_attention_bwd_plain(**args))
        print(f"  K4 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        cases.append({"shape": label, "ms": ms, "plain_ms": plain_ms})
    return dict(src=K4_SRC, replaces="vidi_tpu/ops/pallas/flash_attention.py:420",
                max_abs_err=max(errs), cases=cases, **_times(cases, "9b t2v"))


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


def _region(name, fn, top: int = 12):
    """Run `fn` once to warm up, once timed with the profiler off (wall
    time) and once under torch.profiler (device time summed over kernels);
    the idle share is 1 - device time / wall time (one stream, kernels run
    one at a time)."""
    from torch.profiler import ProfilerActivity, profile

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


def profile_phase(sl) -> None:
    """torch.profiler over the slice's encode, one prefill and
    PROFILE_DECODE_STEPS decode steps on each route (see `_region`)."""
    _region("encode", lambda: _encode(sl))
    _, caches, lens, emb = _region("prefill", lambda: _prefill(sl, QUERIES[0]))
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
        _region(f"decode {'K3' if flash else 'plain'} route x{PROFILE_DECODE_STEPS}",
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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 8  # text depth of the training slice: fp32 Adam moments of the
                  # 42-layer text stack (9.3 B trainable) would need ~112 GB
TRAIN_STEPS = 4
TRAIN_FRAMES, TRAIN_WINDOWS = 120, 4  # -> 23,520 image and 1,200 audio tokens
TRAIN_FROZEN = ("vision", "audio")   # TrainHParams defaults: towers frozen
# training reference check: a small fp32 model, card (kernels) vs CPU
# (plain), two steps (step 0's learning rate is 0). Both sum in fp32 in
# different orders; after one AdamW step of lr 1e-3 (|update| ~ lr per
# element) a wrong gradient sign moves a weight by ~2e-3.
REF_LOSS_REL = 1e-4
REF_PARAM_ATOL = 1e-5


def _train_batch(cfg, step: int, b: int, t: int, n_frames: int, n_windows: int,
                 ragged: bool = False):
    """synthetic_batch(seed=step) -> (numpy batch, hw, tokens counted as the
    training CLI counts them); `ragged` gives row 1 fewer frames, audio
    and text."""
    from vidi_tpu_torch.train.data import synthetic_batch
    from vidi_tpu_torch.train.train_step import make_batch_hw

    batch = synthetic_batch(cfg, b=b, t=t, n_frames=n_frames, n_windows=n_windows,
                            seed=step)
    if ragged:
        batch["frame_counts"][1] = n_frames - 1
        batch["audio_sizes"][1] = cfg.audio.nb_max_frames * 2 // 3
        batch["text_mask"][1, t - 5:] = False
        batch["labels"][1, t - 5:] = -100
    hw = make_batch_hw(cfg, max(int(batch["frame_counts"].sum()), 1))
    n_tokens = int(batch["text_mask"].sum()) + int(
        batch["frame_counts"].sum()) * (hw[0] // cfg.mm_image_pool_size) ** 2
    return batch, hw, n_tokens


def _noise(cfg, batch, hw, step: int) -> dict:
    """Position-noise draws from a CPU generator seeded with the step (the
    same numbers whatever device then holds them)."""
    from vidi_tpu_torch.models.dattn import draw_pos_noise

    b, n = batch["images"].shape[:2]
    return draw_pos_noise(cfg, b, n, batch["mels"].shape[1], hw,
                          torch.Generator().manual_seed(SEED + step))


def training_reference_check(dev) -> None:
    """Two train_steps of a small fp32 model on the card (K1, K2, K4) and on
    the CPU (their plain versions), same weights, batches and noise: losses
    within REF_LOSS_REL, parameters after the second step within
    REF_PARAM_ATOL."""
    import dataclasses

    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.ops.cuda import flash_attention_bwd as k4
    from vidi_tpu_torch.train import data, optimizer, train_step

    cfg = dataclasses.replace(_small_config(), loss_thres=0.1)
    cpu = torch.device("cpu")
    params = dattn.init_params(cfg, torch.float32, cpu, SEED)
    hp = optimizer.TrainHParams(total_steps=4, learning_rate=1e-3, mm_rand_lr=2e-3)
    runs, k4_before = {}, k4.launches
    for name, d in (("cpu", cpu), ("cuda", dev)):
        p = _tree_map(lambda x: x.to(d, copy=True), params)
        tx = optimizer.make_optimizer(p, hp)
        state = train_step.opt_init(tx, p)
        losses = []
        for step in range(2):
            batch, hw, _ = _train_batch(cfg, step, b=2, t=20, n_frames=3, n_windows=1,
                                        ragged=True)
            noise = {k: v.to(d) for k, v in _noise(cfg, batch, hw, step).items()}
            p, state, loss = train_step.train_step(
                p, state, data.to_device(batch, d), noise, cfg=cfg, tx=tx, hw=hw,
                mm_chunks=2, remat=True, use_flash=True, frozen=TRAIN_FROZEN)
            losses.append(float(loss))
        runs[name] = (losses, p)
    (l_cpu, p_cpu), (l_gpu, p_gpu) = runs["cpu"], runs["cuda"]
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_gpu))
    err = max(float((a - b.cpu()).abs().max())
              for a, b in zip(_leaves(p_cpu), _leaves(p_gpu)))
    moved = max(float((a - b).abs().max()) for a, b in zip(_leaves(p_cpu),
                                                            _leaves(params)))
    ok = loss_rel <= REF_LOSS_REL and err <= REF_PARAM_ATOL
    print(f"  small fp32 model, 2 train_steps, card (K1/K2/K4) vs cpu (plain): "
          f"losses {l_gpu} vs {l_cpu} (rel {loss_rel:.2e}, limit {REF_LOSS_REL}); "
          f"params max_abs_err {err:.3e} (limit {REF_PARAM_ATOL}; largest move "
          f"{moved:.3e}) {'ok' if ok else 'FAIL'}")
    if not (ok and moved > 10 * REF_PARAM_ATOL):
        raise AssertionError("training reference check failed")
    if k4.launches == k4_before:
        raise AssertionError("the card's training step never launched K4")


def load_training_slice(dev):
    """Vidi1.5-9B at full width with TRAIN_LAYERS text layers, bf16 random
    weights on the card, and its optimizer state."""
    import dataclasses

    from vidi_tpu_torch import DattnConfig
    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.train import optimizer, train_step

    base = DattnConfig.vidi15_9b()
    cfg = dataclasses.replace(base, text=dataclasses.replace(base.text,
                                                            num_layers=TRAIN_LAYERS))
    t0 = time.perf_counter()
    params = dattn.init_params(cfg, torch.bfloat16, dev, SEED)
    hp = optimizer.TrainHParams(total_steps=TRAIN_STEPS)
    tx = optimizer.make_optimizer(params, hp)
    state = train_step.opt_init(tx, params)
    torch.cuda.synchronize()
    n_all = sum(x.numel() for x in _leaves(params))
    n_train = sum(x.numel() for x in state["mu"].values())
    print(f"  Vidi1.5-9B, {TRAIN_LAYERS} text layers: {n_all / 1e9:.3f} B params, "
          f"{n_train / 1e9:.3f} B trainable; params + fp32 moments "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB in "
          f"{time.perf_counter() - t0:.2f} s")
    return types.SimpleNamespace(dev=dev, cfg=cfg, params=params, tx=tx, state=state)


def _train_step(tr, step: int):
    from vidi_tpu_torch.train import data, train_step

    batch, hw, n_tokens = _train_batch(tr.cfg, step, b=1, t=TRAIN_T,
                                       n_frames=TRAIN_FRAMES, n_windows=TRAIN_WINDOWS)
    batch = data.to_device(batch, tr.dev)
    noise = {k: v.to(tr.dev) for k, v in _noise(tr.cfg, batch, hw, step).items()}

    def run():
        _, _, loss = train_step.train_step(
            tr.params, tr.state, batch, noise, cfg=tr.cfg, tx=tr.tx, hw=hw,
            mm_chunks=4, remat=True, use_flash=True, frozen=TRAIN_FROZEN)
        return loss
    return run, n_tokens


def training_phase(tr) -> dict:
    """TRAIN_STEPS train_steps of the slice, with the K1 / K2 / K4 launch
    counts read around them."""
    from vidi_tpu_torch.ops.cuda import flash_attention as k1
    from vidi_tpu_torch.ops.cuda import flash_attention_bwd as k4
    from vidi_tpu_torch.ops.cuda import tower_attention as k2

    text_w = tr.params["text"]["layers"][0]["q_w"]
    watch = {"text layer 0 q_w": text_w, "mm img_projector w0":
             tr.params["mm"]["img_projector"]["w0"],
             "vision patch_w": tr.params["vision"]["patch_w"],
             "audio conv1_w": tr.params["audio"]["conv1_w"]}
    before = {k: v.clone() for k, v in watch.items()}
    k1.launches = k2.launches = k4.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for step in range(TRAIN_STEPS):
        run, n_tokens = _train_step(tr, step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(run())
        dt = time.perf_counter() - t0
        losses.append(loss)
        changed = {k: not torch.equal(v, before[k]) for k, v in watch.items()}
        print(f"  step {step}: loss {loss:.4f}, {dt:.3f} s, {n_tokens / dt:.1f} tok/s "
              f"({n_tokens} tokens), max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; changed: "
              + ", ".join(k for k, c in changed.items() if c))
        if step == 1 and not (changed["text layer 0 q_w"] and changed["mm img_projector w0"]):
            raise AssertionError("a trainable tensor did not change after step 1")
    launches = {"flash_attention": k1.launches, "tower_attention": k2.launches,
                "flash_attention_bwd": k4.launches}
    print(f"  kernel launches in {TRAIN_STEPS} training steps: {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if changed["vision patch_w"] or changed["audio conv1_w"]:
        raise AssertionError("a frozen tower tensor changed")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the training path was never launched: "
                             f"{launches}")
    return launches


def profile_training(tr) -> None:
    run, _ = _train_step(tr, 0)
    _region("train step (Vidi1.5-9B, 8 text layers)", run)


# Gradient routes: the loss and the gradients of a few leaves on the kernel
# route (K1 forward, K4 backward) against the plain route (plain attention
# under autograd) on the slice's first batch. Both run bf16 activations
# through 8 random-weight layers with bf16 rounding at different points.
# The limits sit between the sound reading and a planted fault's (K4 with
# di dropped).
GRAD_REL = 0.1    # max |difference| / max |plain gradient|, per leaf
GRAD_COS = 0.999  # least cosine similarity, per leaf
ROUTE_LEAVES = (("mm", "img_projector", "w0"), ("mm", "img_projector", "w1"),
                ("text", "layers", 0, "q_w"), ("text", "layers", 0, "k_w"),
                ("text", "layers", 0, "v_w"), ("text", "layers", 0, "o_w"),
                ("text", "embed"))


def _route_grads(tr, use_flash: bool):
    """(loss, [grad of each ROUTE_LEAVES leaf]); only those leaves take
    gradients, so no full gradient tree is held."""
    from vidi_tpu_torch.train import data, train_step

    batch, hw, _ = _train_batch(tr.cfg, 0, b=1, t=TRAIN_T, n_frames=TRAIN_FRAMES,
                                n_windows=TRAIN_WINDOWS)
    noise = {k: v.to(tr.dev) for k, v in _noise(tr.cfg, batch, hw, 0).items()}
    leaves = []
    for path in ROUTE_LEAVES:
        node = tr.params
        for key in path:
            node = node[key]
        leaves.append(node.requires_grad_(True))
    try:
        with torch.enable_grad():
            loss = train_step.loss_fn(tr.params, tr.cfg, data.to_device(batch, tr.dev),
                                      noise, hw=hw, mm_chunks=4, remat=True,
                                      use_flash=use_flash, frozen=TRAIN_FROZEN)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for x in leaves:
            x.requires_grad_(False)
    return float(loss.detach()), grads


def gradient_route_check(tr) -> None:
    from vidi_tpu_torch.ops.cuda import flash_attention_bwd as k4

    loss_p, plain = _route_grads(tr, False)
    routes = {"kernel route": _route_grads(tr, True)}
    real = k4.flash_attention_bwd
    k4.flash_attention_bwd = lambda q, k, v, m, out, *a, **kw: real(
        q, k, v, m, torch.zeros_like(out), *a, **kw)
    try:
        routes["planted fault, K4 with di dropped"] = _route_grads(tr, True)
    finally:
        k4.flash_attention_bwd = real
    passes = {}
    for name, (loss, grads) in routes.items():
        worst_rel, worst_cos = 0.0, 1.0
        print(f"  {name}: loss {loss:.5f} vs plain route {loss_p:.5f} "
              f"(gap {abs(loss - loss_p):.3e})")
        for path, g, w in zip(ROUTE_LEAVES, grads, plain):
            g, w = g.float().flatten(), w.float().flatten()
            rel = float((g - w).abs().max()) / float(w.abs().max())
            cos = float(torch.nn.functional.cosine_similarity(g, w, dim=0))
            if not math.isfinite(rel):
                rel, cos = math.inf, -1.0
            worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
            print(f"    {'.'.join(map(str, path))}: max_abs_err {rel:.3e} of max|grad| "
                  f"(limit {GRAD_REL}), cosine {cos:.6f} (limit {GRAD_COS})")
            del g, w
        passes[name] = worst_rel <= GRAD_REL and worst_cos >= GRAD_COS
    if not passes["kernel route"]:
        raise AssertionError("the kernel and plain routes disagree on the gradients")
    if passes["planted fault, K4 with di dropped"]:
        raise AssertionError("the gradient limits do not reject the planted fault")


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
    print("K4 phase:")
    kern["flash_attention_bwd"] = k4_phase(dev)
    print("reference check:")
    reference_check(dev)
    print("training reference check:")
    training_reference_check(dev)
    print("slice (Vidi1.5-9B, random weights):")
    sl = load_slice(dev)
    serve = slice_phase(sl)
    if args.profile:
        print("profile:")
        profile_phase(sl)
    print("decode routes:")
    decode_route_check(sl)
    del sl
    gc.collect()
    torch.cuda.empty_cache()

    print(f"training slice (Vidi1.5-9B, {TRAIN_LAYERS} text layers, random weights):")
    tr = load_training_slice(dev)
    train = training_phase(tr)
    if args.profile:
        print("training profile:")
        profile_training(tr)
    print("gradient routes:")
    gradient_route_check(tr)

    # launches: the serving path's count for K1-K3, the training path's for
    # K4; launches_by_path gives both
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": r["src"],
         "replaces": r["replaces"], "launches": serve.get(name, train.get(name)),
         "launches_by_path": {"serve": serve.get(name, 0), "train": train.get(name, 0)},
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
