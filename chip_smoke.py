"""GPU smoke run of the PyTorch port (vidi_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

1. Builds the hand-written CUDA kernels (K1 flash_attention, K2
   tower_attention, K3 decode_attention, K4 flash_attention_bwd, K5 the
   int8 tower layer's ln_qkv / o_residual / ln_ffn, K6 quant_matmul and
   quant_gated_mlp with the byte transpose behind their K-major weight
   copies, K7 fused_rms_norm) from vidi_tpu_torch/csrc with one nvcc per
   source, all started together.
2. Runs each kernel at the shapes the Vidi1.5-9B slices give it (and K1 /
   K3 / K4 at the 1.5B configuration's head dim 128) against its plain
   PyTorch version on the same inputs, and times both with CUDA events,
   beside the least time the card could take (bytes over 3.35 TB/s or
   operations over the peak of their type) and, where one PyTorch call
   computes the same function, that call's time. For K1-K4 queries are
   scaled up so that logits reach tens and the softcap of 50 binds; a bf16
   output must lie within ULPS bf16 ulps of the plain output's largest
   magnitude. K5 must lie within INT8_REL relative error of its plain
   versions (the int8 codes agree; see INT8_REL); K6 must equal its plain
   versions bit for bit (exact int32 sums, the same roundings), at the
   prefill's shapes, a ragged one in bf16 and fp32 and a row too long for
   the vector row pass, and prints TOP/s, its share of the bound, its time
   with the K-major cache cold, and torch._int_mm's time for the product
   alone. K7 is held like K1-K4, on its vector pass (bf16, fp32, a width
   that is not a whole number of vectors a lane) and its scalar pass (an
   unaligned width, an unaligned view), with its device time and the
   wrapper's host time beside torch's rms_norm.
   Each case also runs planted faults (the plain version with the cap, mask,
   window, causality, segments, di, the cap's derivative, a per-row scale,
   the hidden's requantize, a bias, the residual, the zero ff padding, the
   exact gelu or a product's last k-step dropped; gate and up swapped; a
   stale K-major copy served after the weight was edited in place, or after
   it was freed and another took its place; K1 with its GQA groups packed
   wrong; K2 at D = 72
   with its depth padding not zeroed, or without the keys past its last
   whole key tile; K4 with each GQA row's lse and di taken from the other
   head, one dq split dropped, or the band's tile skip off by one tile)
   and fails unless every fault lands outside the limit.
   K1 / K2 / K4 take bf16 through the sm90 kernels (wgmma, TMA) and fp32
   through the SIMT templates: one fp32 case each holds the SIMT route.
   Each K1 / K2 / K4 case prints its TFLOP/s and its share of the bound;
   K4's two runs must be bit-equal, and its capless T2A case is timed
   against SDPA's backward.
3. Checks small fp32 models end to end, the card (kernels) against the CPU
   (plain PyTorch): a prefill + greedy decode in bf16-layout fp32 and on
   the int8 route, and two training steps.
4. Drives the serving slice: load_model(random_weights="9b") at full width,
   a synthetic 120 s clip (120 frames 384x384, 16 kHz audio), one media
   encode, then three temporal-retrieval queries through prompt ->
   generate(max_new_tokens=32) -> decode -> parse, counting kernel launches,
   and one query with use_flash_decode=True (K3). It holds the K3 decode
   route's step-0 logits against the default route's, and a planted fault
   (K3 without its kv_mask) against the same limits.
5. Frees it and drives the int8 serving slice: the same model loaded with
   load_8bit=True, load_8bit_towers=True (int8 text and towers), W8A8
   prefill from 512 rows, int8 image / audio caches: one encode (K2, K5),
   three TR queries (K1, K6), launch counts (the K-major copies among
   them) held to the ones reckoned from the code, then the step-0 logits
   with K5 / K6 against their plain
   versions, and every K5 / K6 call of one encode and prefill against its
   plain version on the same inputs, each with a planted fault (K5 without
   the FFN requantize) that the per-call limit must reject.
6. Frees it and drives the training slice: Vidi1.5-9B at full width with
   TRAIN_LAYERS text layers (bf16, towers frozen, remat, use_flash), four
   train_steps on synthetic batches of 256 text tokens, 120 frames and 4
   Whisper windows, counting K1 / K2 / K4 launches. It then holds the
   gradients of a few leaves on the kernel route against the
   plain-attention route, and a planted fault (K4 without di) against the
   same limits.
7. With --profile, profiles both serving slices' encode, one prefill and
   eight decode steps (each decode route of the bf16 one), and one training
   step, with torch.profiler.

Exits non-zero on any failure (no CUDA device, a kernel that does not build,
launch or agree, a planted fault the checks cannot see, a launch count off
the reckoned one, a wrong output). The line before the last is a JSON
object with one entry per kernel function; the last line is {"ok": true,
"device": {"platform": "gpu", "kind": ..., "count": ...}}.
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


def _time_ms(fn, reps: int = 20) -> float:
    """Time of one call of `fn` in ms: CUDA events around `reps` calls
    launched back to back after a warm-up call, over `reps`. The card
    queues a call's kernels while the host prepares the next, so this reads
    the device time of a call, or its host time where that is longer."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _call_ms(fn, reps: int = 10) -> float:
    """Median time in ms of one call of `fn` from an idle card, host launch
    work included (CUDA events around each call): how the kernel table was
    timed before the back-to-back `_time_ms`, kept for K1 / K2 so that their
    rows compare like for like with the earlier times."""
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


# The H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W): the
# least time a kernel's work can take is the larger of its bytes over the
# memory rate and its operations over the peak rate of their type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def _bound(ops: float, nbytes: float, kind: str) -> dict:
    """bound_ms / bound_by for `ops` operations of type `kind` and `nbytes`
    bytes that must cross device memory (each input read once, each output
    written once)."""
    t_ops, t_bytes = ops / PEAK_OPS_S[kind], nbytes / HBM_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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


def _kv_mask(s: int, n_valid, dev):
    """[1, s] bool: keys [0, n_valid) valid, or [first, end) for a pair."""
    first, end = n_valid if isinstance(n_valid, tuple) else (0, n_valid)
    mask = torch.zeros((1, s), dtype=torch.bool, device=dev)
    mask[:, first:end] = True
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


def _gqa_wrong(plain, args: dict):
    """The plain K1 with the GQA groups packed wrong: query head h reads KV
    head h % Hk instead of h // (Hq / Hk)."""
    hq, hk = args["q"].shape[2], args["k"].shape[2]
    heads = torch.arange(hq, device=args["k"].device) % hk
    return plain(**{**args, "k": args["k"][:, :, heads], "v": args["v"][:, :, heads]})[0]


def _pad_not_zeroed(q, k, v, scale):
    """The plain K2 at D = 72 whose scores also take the next head's first 8
    columns (zeros after the last head): the sm90 kernel's depth padding
    72..79 loaded instead of zeroed."""
    def widen(x):
        nxt = torch.zeros_like(x[..., :8])
        nxt[:, :, :-1] = x[:, :, 1:, :8]
        return torch.cat((x, nxt), dim=-1).float()
    logits = torch.einsum("bthd,bshd->bhts", widen(q), widen(k)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs.float(), v.float()).to(q.dtype)


def _rate(label: str, ops: float, ms: float, bound: dict, unit: str = "TFLOP/s") -> dict:
    """10^12 operations a second (`unit`: TFLOP/s, or TOP/s for int8) and
    share of the bound of one timed case, printed and kept."""
    out = {"tflops": ops / ms / 1e9, "bound_share": bound["bound_ms"] / ms}
    print(f"  {label}: {out['tflops']:.1f} {unit}, {out['bound_share']:.3f} of the "
          f"{bound['bound_by']} bound")
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
    # T2V / T2A cross attention (ragged kv_mask); bf16 takes the sm90 kernel,
    # the fp32 case the SIMT template
    errs, cases = [], []
    for label, hq, hk, d, s, causal, window, cap, n_valid, faults, dtype in (
            (f"9b t2t T=S={t} causal window=4096 cap=50", 16, 8, 256, t, True,
             4096, 50.0, n_real, ("causal", "mask", "cap", "gqa"), torch.bfloat16),
            (f"9b t2t T=S={t} causal window=48 cap=50", 16, 8, 256, t, True,
             48, 50.0, n_real, ("window", "cap"), torch.bfloat16),
            # keys 0..7 masked: causal rows 0..7 see no key (zeros, sentinel lse)
            (f"9b t2t T=S={t} causal keys 8.. cap=50, 8 empty rows", 16, 8, 256, t,
             True, 4096, 50.0, (8, n_real), ("mask", "cap"), torch.bfloat16),
            (f"9b t2v T={t} S={IMG_S} mask cap=50", 16, 8, 256, IMG_S, False,
             None, 50.0, IMG_VALID, ("mask", "cap", "gqa"), torch.bfloat16),
            (f"9b t2a T={t} S={AUD_S} mask cap=50", 16, 8, 256, AUD_S, False,
             None, 50.0, AUD_VALID, ("mask", "cap"), torch.bfloat16),
            (f"9b t2a T={t} S={AUD_S} mask no cap", 16, 8, 256, AUD_S, False,
             None, None, AUD_VALID, ("mask", "cap"), torch.bfloat16),
            (f"1.5b t2t T=S={t} causal window=4096 cap=50", 12, 6, 128, t, True,
             4096, 50.0, n_real, ("causal", "cap"), torch.bfloat16),
            (f"1.5b t2v T={t} S={IMG_S} mask cap=50", 12, 6, 128, IMG_S, False,
             None, 50.0, IMG_VALID, ("mask", "cap"), torch.bfloat16),
            (f"fp32 9b t2a T={t} S={AUD_S} mask cap=50", 16, 8, 256, AUD_S, False,
             None, 50.0, AUD_VALID, ("mask", "cap"), torch.float32)):
        args = dict(q=_randn(gen, (1, t, hq, d), dev, Q_GAIN, dtype),
                    k=_randn(gen, (1, s, hk, d), dev, dtype=dtype),
                    v=_randn(gen, (1, s, hk, d), dev, dtype=dtype),
                    kv_mask=_kv_mask(s, n_valid, dev), sm_scale=d**-0.5,
                    causal=causal, window=window, softcap=cap)
        out, lse = k1.flash_attention(**args)
        ref, ref_lse = k1.flash_attention_plain(**args)
        planted = _faults(k1.flash_attention_plain, args, [f for f in faults if f != "gqa"])
        if "gqa" in faults:
            planted["GQA heads packed wrong"] = _gqa_wrong(k1.flash_attention_plain, args)
        errs.append(_check(f"K1 {label}", out, ref, planted))
        live = ref_lse < k1.EMPTY_ROW_LSE  # [B, Hq, T]; empty rows: zeros, sentinel lse
        lse_err = float((lse[live] - ref_lse[live]).abs().max())
        empty_equal = (torch.equal(lse[~live], ref_lse[~live]) and
                       torch.equal(out.transpose(1, 2)[~live], ref.transpose(1, 2)[~live]))
        print(f"  K1 {label} lse: max_abs_err={lse_err:.3e} (limit {LSE_ATOL}); "
              f"{int((~live).sum())} empty rows {'bit-equal' if empty_equal else 'DIFFER'}")
        if not (lse_err <= LSE_ATOL and empty_equal):
            raise AssertionError(f"K1 {label}: lse or empty rows disagree")
        ms = _time_ms(lambda: k1.flash_attention(**args))
        plain_ms = _time_ms(lambda: k1.flash_attention_plain(**args))
        pairs = int(k1.visible_mask(1, t, s, args["kv_mask"], causal, window, None, None,
                                    dev).sum())
        ops = 4 * hq * d * pairs
        bound = _bound(ops, _nbytes(args["q"], args["k"], args["v"], out, lse,
                                    args["kv_mask"]), "bf16" if dtype == torch.bfloat16 else "fp32")
        lib_ms = None
        if cap is None:  # one PyTorch call computes the capless function
            lib_ms = _time_ms(lambda: _sdpa(args["q"], args["k"], args["v"], d**-0.5,
                                            args["kv_mask"]))
        call_ms = _call_ms(lambda: k1.flash_attention(**args))
        print(f"  K1 {label}: kernel {ms:.4f} ms (one call from idle {call_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}), library {lib_ms} ms")
        cases.append({"shape": label, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, **bound,
                      "library_ms": lib_ms, **_rate(f"K1 {label}", ops, ms, bound)})
    # the summary time is the 9B T2V case's, most of K1's time in the slice
    res["flash_attention"] = dict(
        src=K1_SRC, replaces="vidi_tpu/ops/pallas/flash_attention.py:396",
        max_abs_err=max(errs), cases=cases, **_times(cases, "9b t2v"))

    # K2: SigLIP (4 frames per encode chunk) and Whisper (1 window per chunk);
    # the ragged-edge fault drops the keys past the last whole tile of the
    # route's kernel (sm90 for bf16, SIMT for fp32)
    errs, cases = [], []
    for label, b, n, h, dh, dtype in (
            ("siglip B=4 T=729 H=16 D=72", 4, 729, 16, 72, torch.bfloat16),
            ("whisper B=1 T=1500 H=20 D=64", 1, 1500, 20, 64, torch.bfloat16),
            ("fp32 whisper B=1 T=1500 H=20 D=64", 1, 1500, 20, 64, torch.float32)):
        q = _randn(gen, (b, n, h, dh), dev, Q_GAIN, dtype)
        k = _randn(gen, (b, n, h, dh), dev, dtype=dtype)
        v = _randn(gen, (b, n, h, dh), dev, dtype=dtype)
        scale = dh**-0.5
        out = k2.tower_attention(q, k, v, scale)
        ref = k2.tower_attention_plain(q, k, v, scale)
        tile = k1.SM90_KEY_TILE[dh] if dtype == torch.bfloat16 else k1.KV_TILE
        keep = n // tile * tile
        planted = {f"keys past {keep} dropped": k2.tower_attention_plain(
            q, k[:, :keep], v[:, :keep], scale)}
        if dh % 16:
            planted["padding columns not zeroed"] = _pad_not_zeroed(q, k, v, scale)
        errs.append(_check(f"K2 {label}", out, ref, planted))
        ms = _time_ms(lambda: k2.tower_attention(q, k, v, scale))
        plain_ms = _time_ms(lambda: k2.tower_attention_plain(q, k, v, scale))
        ops = 4 * b * h * n * n * dh
        bound = _bound(ops, _nbytes(q, k, v, out),
                       "bf16" if dtype == torch.bfloat16 else "fp32")
        lib_ms = _time_ms(lambda: _sdpa(q, k, v, scale, None))
        call_ms = _call_ms(lambda: k2.tower_attention(q, k, v, scale))
        print(f"  K2 {label}: kernel {ms:.4f} ms (one call from idle {call_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}), SDPA {lib_ms:.4f} ms")
        cases.append({"shape": label, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, **bound,
                      "library_ms": lib_ms, **_rate(f"K2 {label}", ops, ms, bound)})
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
        visible = args["kv_mask"][0].clone()
        if window is not None:
            visible &= int(q_pos[0]) - torch.arange(s, device=dev) < window
        bound = _bound(4 * hq * d * int(visible.sum()),
                       _nbytes(args["q"], args["k"], args["v"], out, args["kv_mask"]), "bf16")
        print(f"  K3 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        cases.append({"shape": label, "ms": ms, "plain_ms": plain_ms, **bound,
                      "library_ms": None})
    res["decode_attention"] = dict(
        src=K3_SRC, replaces="vidi_tpu/ops/pallas/decode_attention.py:80",
        max_abs_err=max(errs), cases=cases, **_times(cases, "9b image cache"))
    return res


def _k4_faults(k4, args: dict, names) -> dict:
    """(dq, dk, dv) of the plain backward with one step dropped each: the
    readings of a K4 that forgot it."""
    from vidi_tpu_torch.ops.cuda.flash_attention import visible_mask

    b, t, hq, d = args["q"].shape
    s, hk = args["k"].shape[1], args["k"].shape[2]
    g = hq // hk
    vis = visible_mask(b, t, s, args["kv_mask"], args["causal"], args["window"],
                       args["q_segs"], args["kv_segs"], args["q"].device)
    di = (args["out"].float() * args["do"].float()).sum(-1).transpose(1, 2)  # [B,Hq,T]

    def masked(mask, lse=None, di_=None):
        return k4.backward_with_mask(args["q"], args["k"], args["v"], args["do"],
                                     args["lse"] if lse is None else lse,
                                     di if di_ is None else di_, mask, args["sm_scale"],
                                     args["softcap"])

    def no_cap_derivative():
        # the plain formulas with dz = p (dp - di), the (1 - tanh^2) factor gone
        q, k, v, do = (args[n].float() for n in ("q", "k", "v", "do"))
        qg, dog = q.reshape(b, t, hk, g, d), do.reshape(b, t, hk, g, d)
        raw = torch.einsum("bthgd,bshd->bhgts", qg, k) * args["sm_scale"]
        z = torch.tanh(raw / args["softcap"]) * args["softcap"]
        mask = vis[:, None, None]
        p = torch.where(mask, torch.exp(z - args["lse"].reshape(b, hk, g, t, 1)), 0.0)
        dp = torch.einsum("bthgd,bshd->bhgts", dog, v)
        dz = torch.where(mask, p * (dp - di.reshape(b, hk, g, t, 1)), 0.0)
        scale = args["sm_scale"]
        return (torch.einsum("bhgts,bshd->bthgd", dz, k).reshape(b, t, hq, d) * scale,
                torch.einsum("bhgts,bthgd->bshd", dz, qg) * scale,
                torch.einsum("bhgts,bthgd->bshd", p, dog))

    def gqa_wrong():
        # each packed row gathers lse and di of the other head of its group
        heads = torch.arange(hq, device=vis.device)
        other = heads // g * g + (heads % g + 1) % g
        return masked(vis, args["lse"][:, other], di[:, other])

    def without(regions):
        mask = vis.clone()
        for bi, t0, t1, s0, s1 in regions:
            mask[bi, t0:t1, s0:s1] = False
        return mask

    def split_dropped():
        # the dq kernel's split 1 (key tiles 1, 1 + n_split, ...) never summed
        n_split = k4.sm90_bwd_plan(b, t, s, hq, hk, torch.cuda.get_device_properties(
            args["q"].device).multi_processor_count)
        tiles = k4.sm90_bwd_dq_tiles(b, t, s, hq, hk, d, n_split, args["causal"],
                                     args["window"], args["kv_mask"], args["q_segs"],
                                     args["kv_segs"])
        dq = masked(without({(x[0], *x[3:]) for x in tiles if x[2] == 1 % n_split}))[0]
        return dq, None, None

    def band_off_by_one():
        # dq: each row block's last key tile of the band skipped; dk / dv:
        # each key block's first query tile of the band skipped
        tiles = k4.sm90_bwd_dq_tiles(b, t, s, hq, hk, d, 1, args["causal"], args["window"],
                                     args["kv_mask"], args["q_segs"], args["kv_segs"])
        last = {}
        for bi, _, _, t0, t1, s0, s1 in tiles:
            last[(bi, t0)] = max(last.get((bi, t0), (0, 0, 0)), (s0, s1, t1))
        dq = masked(without({(bi, t0, t1, s0, s1) for (bi, t0), (s0, s1, t1) in last.items()}))[0]
        first = {}
        for bi, _, t0, t1, k0, k1 in k4.sm90_bwd_dkv_tiles(
                b, t, s, hq, hk, args["causal"], args["window"], args["kv_mask"],
                args["q_segs"], args["kv_segs"]):
            first.setdefault((bi, k0, k1), (t0, t1))
        _, dk, dv = masked(without({(bi, t0, t1, k0, k1)
                                    for (bi, k0, k1), (t0, t1) in first.items()}))
        return dq, dk, dv

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
        "gqa": ("GQA rows gathered with the other head's lse and di", gqa_wrong),
        "split": ("a dq split's partial dropped", split_dropped),
        "band": ("the band's tile skip off by one tile", band_off_by_one),
    }
    return {drop[n][0]: drop[n][1]() for n in names}


# Planted faults a gradient does not depend on: dv = p^T dO needs neither di
# nor the cap's derivative, and the dq splits do not touch dk / dv.
K4_BLIND = {"dv": ("di dropped", "no softcap derivative", "a dq split's partial dropped"),
            "dk": ("a dq split's partial dropped",), "dq": ()}


def _past_s_unmasked(k4, args: dict):
    """The plain backward of a K4 that let the keys past S through, as TMA
    reads them: zero K / V rows, visible to every row. Their scores are 0,
    but dz . 0 adds nothing to dq and no dk / dv row past S is stored, so
    this fault changes no output: it is shown to lie within the limit, not
    planted."""
    s = args["k"].shape[1]
    pad = -s % k4.SM90_BWD_KV_KEYS
    zeros = torch.zeros_like(args["k"][:, :pad])
    mask = args["kv_mask"]
    mask = torch.cat((mask, torch.ones_like(mask[:, :pad])), dim=1)
    dq, dk, dv = k4.flash_attention_bwd_plain(**{
        **args, "k": torch.cat((args["k"], zeros), 1), "v": torch.cat((args["v"], zeros), 1),
        "kv_mask": mask, "kv_segs": None if args["kv_segs"] is None else torch.cat(
            (args["kv_segs"], args["kv_segs"][:, -1:].expand(-1, pad)), 1)})
    return dq, dk[:, :s], dv[:, :s]


def _sdpa_bwd_ms(args: dict):
    """Time of torch's scaled_dot_product_attention backward (autograd
    through one call with the kv_mask and enable_gqa) on the case's inputs:
    the one library call that computes K4's function when there is no cap
    and every row sees a key. The port never calls it."""
    q, k, v = (args[n].detach().transpose(1, 2).requires_grad_(True) for n in ("q", "k", "v"))
    out = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=args["kv_mask"][:, None, None, :], scale=args["sm_scale"],
        enable_gqa=True)
    do = args["do"].transpose(1, 2)
    return _time_ms(lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True))


def k4_phase(dev) -> dict:
    """K4 (flash attention backward) against its plain version at the
    training slice's shapes (Vidi1.5-9B, T = 256 text rows; 120 frames ->
    23,520 image keys; 4 Whisper windows -> 1,200 audio keys; the 1.5B at
    head dim 128). q is scaled by Q_GAIN so the cap binds, dO ~ N(0, 1) on
    valid rows and 0 on padded ones; out and lse come from K1. dq, dk and
    dv must each lie within ULPS bf16 ulps of the plain output's largest
    magnitude, and every planted fault outside; two runs must be bit-equal.
    bf16 cases take the sm90 kernels, the fp32 case the SIMT template; each
    case's launches are read per route."""
    from vidi_tpu_torch.ops.cuda import flash_attention as k1
    from vidi_tpu_torch.ops.cuda import flash_attention_bwd as k4

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    t, n_valid = TRAIN_T, TRAIN_T - 20
    packed = torch.zeros((1, t), dtype=torch.int32, device=dev)
    packed[0, :90], packed[0, 90:170], packed[0, 170:n_valid] = 1, 2, 3
    errs, cases = [], []
    bf16, f32 = torch.bfloat16, torch.float32
    for label, hq, hk, d, s, causal, window, cap, n_keys, segs, faults, dtype in (
            (f"9b t2t T=S={t} causal window=4096 cap=50", 16, 8, 256, t, True,
             4096, 50.0, n_valid, None, ("causal", "di", "cap", "band"), bf16),
            (f"9b t2t T=S={t} causal window=48 cap=50", 16, 8, 256, t, True,
             48, 50.0, n_valid, None, ("window", "di", "cap"), bf16),
            (f"9b t2v T={t} S={IMG_S} mask cap=50", 16, 8, 256, IMG_S, False,
             None, 50.0, IMG_VALID, None, ("mask", "di", "cap", "gqa", "split"), bf16),
            (f"9b t2a T={t} S={AUD_S} mask cap=50", 16, 8, 256, AUD_S, False,
             None, 50.0, AUD_VALID, None, ("mask", "di", "cap", "gqa", "split"), bf16),
            (f"9b t2a T={t} S={AUD_S} mask no cap", 16, 8, 256, AUD_S, False,
             None, None, AUD_VALID, None, ("mask", "di"), bf16),
            (f"9b packed t2t T=S={t} 3 segments cap=50", 16, 8, 256, t, True,
             4096, 50.0, n_valid, packed, ("segs", "di", "cap", "band"), bf16),
            (f"1.5b t2v T={t} S={IMG_S} mask cap=50", 12, 6, 128, IMG_S, False,
             None, 50.0, IMG_VALID, None, ("mask", "di", "cap", "gqa", "split"), bf16),
            (f"fp32 9b t2a T={t} S={AUD_S} mask cap=50", 16, 8, 256, AUD_S, False,
             None, 50.0, AUD_VALID, None, ("mask", "di", "cap"), f32)):
        q = _randn(gen, (1, t, hq, d), dev, Q_GAIN, dtype)
        k = _randn(gen, (1, s, hk, d), dev, dtype=dtype)
        v = _randn(gen, (1, s, hk, d), dev, dtype=dtype)
        kv_mask = _kv_mask(s, n_keys, dev)
        fwd = dict(sm_scale=d**-0.5, causal=causal, window=window, softcap=cap,
                   q_segs=segs, kv_segs=segs)
        out, lse = k1.flash_attention(q, k, v, kv_mask, **fwd)
        rows = n_valid if causal else t  # T2T rows past the prompt are padding
        do = _randn(gen, (1, t, hq, d), dev, dtype=dtype)
        do[:, rows:] = 0
        args = dict(q=q, k=k, v=v, kv_mask=kv_mask, out=out, lse=lse, do=do, **fwd)
        route = k4.route(dtype)
        before = dict(k4.route_launches)
        got = k4.flash_attention_bwd(**args)
        again = k4.flash_attention_bwd(**args)
        ran = {r: k4.route_launches[r] - before[r] for r in before}
        if ran != {r: 2 * (r == route) for r in ran}:
            raise AssertionError(f"K4 {label}: launches by route {ran}, expected {route}")
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"  K4 {label}: route {route}, two runs {'bit-equal' if equal else 'DIFFER'}")
        if not equal:
            raise AssertionError(f"K4 {label}: two runs differ")
        want = k4.flash_attention_bwd_plain(**args)
        bad = _k4_faults(k4, args, faults)
        past = _past_s_unmasked(k4, args) if s % 64 and dtype == bf16 else None
        for i, name in enumerate(("dq", "dk", "dv")):
            errs.append(_check(f"K4 {label} {name}", got[i], want[i], {
                lab: f[i] for lab, f in bad.items()
                if lab not in K4_BLIND[name] and f[i] is not None}))
            if past is not None:
                gap = float((past[i].float() - want[i].float()).abs().max())
                print(f"    keys past S unmasked (TMA's zero rows) would read {gap:.3e}: "
                      "no change, not a plantable fault")
        del bad, past
        ms = _time_ms(lambda: k4.flash_attention_bwd(**args))
        plain_ms = _time_ms(lambda: k4.flash_attention_bwd_plain(**args))
        # five D-long products per visible (row, key) pair: the recomputed
        # scores, dP, dq, dk and dv
        pairs = int(k1.visible_mask(1, t, s, kv_mask, causal, window, segs, segs,
                                    dev).sum())
        ops = 10 * hq * d * pairs
        bound = _bound(ops, _nbytes(q, k, v, kv_mask, out, lse, do, *got),
                       "bf16" if dtype == bf16 else "fp32")
        lib_ms = _sdpa_bwd_ms(args) if cap is None else None
        print(f"  K4 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), SDPA backward {lib_ms} ms")
        cases.append({"shape": label, "ms": ms, "plain_ms": plain_ms, **bound,
                      "library_ms": lib_ms, **_rate(f"K4 {label}", ops, ms, bound)})
        if dtype == bf16 and not ms < plain_ms:
            raise AssertionError(f"K4 {label}: kernel {ms:.4f} ms not faster than plain "
                                 f"{plain_ms:.4f} ms")
    return dict(src=K4_SRC, replaces="vidi_tpu/ops/pallas/flash_attention.py:420",
                max_abs_err=max(errs), cases=cases, **_times(cases, "9b t2v"))


# ---------------------------------------------------------------------------
# K5 / K6 / K7
# ---------------------------------------------------------------------------

# K5 / K6 against their plain versions: relative error ||got - want|| /
# ||want|| over the output. The int8 codes and the int32 sums agree exactly
# and the epilogues round at the same points; what is left is a LayerNorm's
# fp32 mean summed in another order (and torch's tanh / erf against the
# kernel's), which moves a bf16 value by an ulp now and then, and when that
# value is its row's amax or sits at an int8 rounding boundary, a row or a
# code re-rounds. Every planted fault must land above the limit.
INT8_REL = 1e-3
K5_SRC = "vidi_tpu_torch/csrc/fused_tower_layer.cu"
K6_SRC = "vidi_tpu_torch/csrc/quant_matmul.cu"
K7_SRC = "vidi_tpu_torch/csrc/fused_rmsnorm.cu"
SIGLIP_T, WHISPER_T = 729, 1500
IMG_CHUNK_ROWS = 735  # 23,520 image tokens / mm_chunks 32: one diagonal-update chunk


def _flat(out):
    return torch.cat([o.float().flatten() for o in out]) if isinstance(out, tuple) \
        else out.float().flatten()


def _check_rel(name: str, got, want, faults: dict, limit: float = INT8_REL,
               exact: bool = False) -> tuple:
    """got vs want within `limit` relative (Frobenius) error, or with `exact`
    bit for bit; every planted fault (label -> the output of a known wrong
    kernel) must land outside `limit`. -> (relative error, max abs error)."""
    torch.cuda.synchronize()
    got, want = _flat(got), _flat(want)
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             "or non-finite output")
    norm = float(want.norm())
    err = float((got - want).norm()) / norm
    seen = {lab: float((_flat(f) - want).norm()) / norm for lab, f in faults.items()}
    print(f"  {name}: relative error {err:.3e} (limit {'bit-equal' if exact else f'{limit:.1e}'}) "
          f"{'ok' if err <= limit else 'FAIL'}, max_abs_err "
          f"{float((got - want).abs().max()):.3e}; planted faults: "
          + ", ".join(f"{lab} {e:.3e}" for lab, e in seen.items()))
    if not err <= limit:
        raise AssertionError(f"{name}: relative error {err:.3e} over {limit:.1e}")
    if exact and not torch.equal(got, want):
        raise AssertionError(f"{name}: not bit-equal to the plain version")
    blind = [lab for lab, e in seen.items() if not e > limit]
    if blind:
        raise AssertionError(f"{name}: the limit does not reject the planted faults {blind}")
    return err, float((got - want).abs().max())


def _per_tensor_act(x):
    """The planted 'per-tensor scale' fault: one amax for the whole tensor."""
    xf = x.float()
    amax = xf.abs().amax()
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.expand(*x.shape[:-1], 1)


class _swap:
    """Set module attributes for the length of a `with` block."""

    def __init__(self, mod, **attrs):
        self.mod, self.attrs, self.saved = mod, attrs, {}

    def __enter__(self):
        for k, v in self.attrs.items():
            self.saved[k] = getattr(self.mod, k)
            setattr(self.mod, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.mod, k, v)


def _int8_layer(gen, dev, d: int, ff: int, k_bias: bool = True):
    """One int8 tower layer (d, ff padded to 128) from random fp32 weights of
    std 1/sqrt(fan-in), biases N(0, 0.5), LN scale 1 + N(0, 0.1)."""
    from vidi_tpu_torch.infer import quantize as qz

    def w(*shape):
        return _randn(gen, shape, dev, shape[0] ** -0.5, torch.float32)

    def b(n, scale=0.5):
        return _randn(gen, (n,), dev, scale, torch.float32)

    lp = {"ln1_scale": 1 + b(d, 0.1), "ln1_bias": b(d, 0.1),
          "ln2_scale": 1 + b(d, 0.1), "ln2_bias": b(d, 0.1),
          "q_w": w(d, d), "q_b": b(d), "k_w": w(d, d), "v_w": w(d, d), "v_b": b(d),
          "o_w": w(d, d), "o_b": b(d), "fc1_w": w(d, ff), "fc1_b": b(ff),
          "fc2_w": w(ff, d), "fc2_b": b(d)}
    if k_bias:
        lp["k_b"] = b(d)
    lp = qz.quantize_tower_layer(lp)
    return {k: v if isinstance(v, dict) else v.to(torch.bfloat16) for k, v in lp.items()}


def _rows(gen, shape, dev):
    """bf16 activations, each row scaled by a gain in [e^-2, e]: per-row scales
    then differ from a per-tensor one."""
    gains = torch.exp(torch.rand(shape[:-1] + (1,), generator=gen, device=dev) * 3 - 2)
    return (_randn(gen, shape, dev, 1.0, torch.float32) * gains).to(torch.bfloat16)


def _int8_case(name, run, plain, faults, ops, nbytes, kind="int8", exact=False):
    err, abs_err = _check_rel(name, run(), plain(), {k: f() for k, f in faults.items()},
                              exact=exact)
    ms, plain_ms = _time_ms(run), _time_ms(plain)
    bound = _bound(ops, nbytes, kind)
    print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    return {"shape": name, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None,
            "rel_err": err, "max_abs_err": abs_err, **_rate(name, ops, ms, bound, "TOP/s")}


def _qbytes(w) -> int:
    return _nbytes(w["qi8"], w["scale"])


def _ffn_no_requant(x, lp, eps: float, hidden_act: str):
    """The planted 'no requantize of the FFN hidden' fault: K5's ln_ffn with
    fc2 taking the activation as it is, against the dequantized weight."""
    from vidi_tpu_torch.infer import quantize as qz
    from vidi_tpu_torch.ops.basic import layer_norm, tower_act
    from vidi_tpu_torch.ops.cuda import fused_tower_layer as k5

    hq, sx = qz.quantize_act(layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps))
    a = tower_act(k5._qdot_plain(hq, sx, lp["fc1_w"], lp["fc1_b"], x.dtype), hidden_act)
    w2 = qz.dequantize_weight(lp["fc2_w"], torch.float32)
    return x + (a.float() @ w2 + lp["fc2_b"].float()).to(x.dtype)


def k5_phase(dev) -> dict:
    """K5's three pieces at SigLIP-so400m's encode chunk (4 frames x 729
    patches, d 1152, ff 4304 padded to 4352, gelu_tanh, eps 1e-6) and
    Whisper-large-v3's window (1500 x 1280, ff 5120, exact gelu, eps 1e-5,
    no k bias) against their plain versions, with planted faults."""
    from vidi_tpu_torch.ops.cuda import fused_tower_layer as k5

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    res = {n: {"cases": []} for n in ("ln_qkv", "o_residual", "ln_ffn")}
    for label, b, t, d, ff, act, eps, k_bias in (
            (f"siglip [4, {SIGLIP_T}, 1152] ff 4304->4352", 4, SIGLIP_T, 1152, 4304,
             "gelu_tanh", 1e-6, True),
            (f"whisper [1, {WHISPER_T}, 1280] ff 5120", 1, WHISPER_T, 1280, 5120, "gelu",
             1e-5, False)):
        lp = _int8_layer(gen, dev, d, ff, k_bias)
        ffp = lp["fc1_w"]["qi8"].shape[1]
        x, attn = _rows(gen, (b, t, d), dev), _rows(gen, (b, t, d), dev)
        m = b * t
        no_bias = {k: torch.zeros_like(v) if k.endswith("_b") else v for k, v in lp.items()}
        per_tensor = lambda f: lambda: _with(k5, quantize_act=_per_tensor_act)(f)  # noqa: E731

        qkv_w = [lp[k] for k in ("q_w", "k_w", "v_w")]
        res["ln_qkv"]["cases"].append(_int8_case(
            f"K5 ln_qkv {label}", lambda: k5.ln_qkv(x, lp, eps),
            lambda: k5.ln_qkv_plain(x, lp, eps),
            {"per-tensor scale": per_tensor(lambda: k5.ln_qkv_plain(x, lp, eps)),
             "bias dropped": lambda: k5.ln_qkv_plain(x, no_bias, eps)},
            3 * 2 * m * d * d, _nbytes(x, x, x, x) + sum(_qbytes(w) for w in qkv_w)))
        res["o_residual"]["cases"].append(_int8_case(
            f"K5 o_residual {label}", lambda: k5.o_residual(attn, x, lp),
            lambda: k5.o_residual_plain(attn, x, lp),
            {"per-tensor scale": per_tensor(lambda: k5.o_residual_plain(attn, x, lp)),
             "bias dropped": lambda: k5.o_residual_plain(attn, x, no_bias),
             "residual dropped": lambda: k5.o_residual_plain(attn, torch.zeros_like(x), lp)},
            2 * m * d * d, _nbytes(attn, x, x) + _qbytes(lp["o_w"])))
        faults = {"per-tensor scale": per_tensor(lambda: k5.ln_ffn_plain(x, lp, eps, act)),
                  "no requantize of the FFN hidden":
                      lambda: _ffn_no_requant(x, lp, eps, act),
                  "bias dropped": lambda: k5.ln_ffn_plain(x, no_bias, eps, act),
                  "residual dropped": lambda: k5.ln_ffn_plain(x, lp, eps, act) - x}
        if ffp != ff:
            def padding_nonzero():
                bad = dict(lp, fc1_w=dict(lp["fc1_w"]), fc2_w=dict(lp["fc2_w"]))
                bad["fc1_w"]["qi8"] = lp["fc1_w"]["qi8"].clone()
                bad["fc2_w"]["qi8"] = lp["fc2_w"]["qi8"].clone()
                bad["fc1_w"]["qi8"][:, ff:] = 64
                bad["fc2_w"]["qi8"][ff:] = 64
                return k5.ln_ffn_plain(x, bad, eps, act)
            faults["non-zero ff padding"] = padding_nonzero
        if act == "gelu":
            faults["tanh gelu for the exact one"] = \
                lambda: k5.ln_ffn_plain(x, lp, eps, "gelu_tanh")
        res["ln_ffn"]["cases"].append(_int8_case(
            f"K5 ln_ffn {label}", lambda: k5.ln_ffn(x, lp, eps, act),
            lambda: k5.ln_ffn_plain(x, lp, eps, act), faults,
            2 * 2 * m * d * ffp, _nbytes(x, x) + _qbytes(lp["fc1_w"]) + _qbytes(lp["fc2_w"])))
        del lp
    for n, r in res.items():
        r.update(src=K5_SRC, replaces=K5_REPLACES[n], kernel="K5",
                 max_abs_err=max(c["max_abs_err"] for c in r["cases"]),
                 **_times(r["cases"], f"K5 {n} siglip"))
    return res


K5_REPLACES = {"ln_qkv": "vidi_tpu/ops/pallas/fused_tower_layer.py:189",
               "o_residual": "vidi_tpu/ops/pallas/fused_tower_layer.py:218",
               "ln_ffn": "vidi_tpu/ops/pallas/fused_tower_layer.py:239"}


def _with(mod, **attrs):
    """f -> f() run with `attrs` swapped into `mod`."""
    def run(f):
        with _swap(mod, **attrs):
            return f()
    return run


def _int_mm_ms(x, w) -> tuple:
    """(ms, None) of torch._int_mm on x's int8 codes and the weight, the
    product alone (no quantize, rescale or epilogue): a yardstick that the
    port never calls; (None, why) where that private call refuses the shape."""
    from vidi_tpu_torch.infer import quantize as qz

    xq = qz.quantize_act(x)[0]
    try:
        torch._int_mm(xq, w["qi8"])
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return _time_ms(lambda: torch._int_mm(xq, w["qi8"])), None


def _cold(k6, fn):
    """fn with the K-major cache emptied first: every call makes its copies."""
    def run():
        k6.KMAJOR.clear()
        return fn()
    return run  # (the cold timing's clear; no model is dropped through it)


def _last_step_dropped(k6, x, w):
    """The planted 'last k-step dropped' fault: quant_matmul whose product
    stops one 128-wide k-step short (a ring that loses its last stage)."""
    from vidi_tpu_torch.infer import quantize as qz

    xq, sx = qz.quantize_act(x)
    k = x.shape[-1]
    k -= k % 128 or 128
    y = k6.int8_dot(xq[..., :k], w["qi8"][:k]) * sx * w["scale"].reshape(-1).float()
    return y.to(x.dtype)


def _kmajor_faults(k6, x, make_weight) -> None:
    """The K-major cache's two traps, each against the fault it must not
    show. (1) A weight edited in place after its copy was cached: the cache
    sees the new `_version` and copies anew; with the invalidation bypassed
    the kernel reads the stale copy. (2) A temporary weight (the folded
    o_proj of every `_xattn_block` call) freed, and its address taken by the
    next one: the cache refers to its weights weakly, so the freed weight's
    entry leaves with it and the next weight is copied anew; a cache keyed by
    the address alone would serve the first weight's copy to the second."""
    w = make_weight()
    k6.quant_matmul(x, w["qi8"], w["scale"])
    stale = k6.KMAJOR.entries[id(w["qi8"])][2]
    w["qi8"].neg_()
    _check_rel("K6 K-major cache, weight edited in place",
               k6.quant_matmul(x, w["qi8"], w["scale"]),
               k6.quant_matmul_plain(x, w["qi8"], w["scale"]),
               {"stale copy served": k6._launch_matmul(x, w["qi8"], w["scale"], wt=stale)},
               exact=True)

    first = make_weight()
    ptr = first["qi8"].data_ptr()
    k6.quant_matmul(x, first["qi8"], first["scale"])
    key = id(first["qi8"])
    old_copy = k6.KMAJOR.entries[key][2]
    held = k6.KMAJOR.bytes
    del first  # no clear(): the entry and its bytes must leave with the weight
    if key in k6.KMAJOR.entries or k6.KMAJOR.bytes != held - old_copy.numel():
        raise AssertionError("the K-major cache kept a freed weight's entry")
    second = make_weight()
    reused = second["qi8"].data_ptr() == ptr
    print(f"  K6 K-major cache: weight freed, its entry left with it ({held} -> "
          f"{k6.KMAJOR.bytes} bytes of copies); the next weight "
          f"{'took its address' if reused else 'got another address'}")
    _check_rel("K6 K-major cache, temporary weight freed and replaced",
               k6.quant_matmul(x, second["qi8"], second["scale"]),
               k6.quant_matmul_plain(x, second["qi8"], second["scale"]),
               {"the freed weight's copy served": k6._launch_matmul(
                   x, second["qi8"], second["scale"], wt=old_copy)}, exact=True)


def k6_phase(dev) -> dict:
    """K6 at the int8 prefill's W8A8 shapes (Gemma2-9B: the image stream's
    k / v projection, one diagonal-update chunk's folded o, and its gated
    MLP, whose down projection is a quant_matmul call), a ragged shape (no
    dimension a multiple of the tile) in bf16 and fp32, and a row longer
    than the vector row pass holds, each bit-equal to its plain version,
    with planted faults; times with the K-major cache warm and cold, and
    torch._int_mm's for the product alone."""
    from vidi_tpu_torch.infer import quantize as qz
    from vidi_tpu_torch.ops.cuda import quant_matmul as k6

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    def wq(k, n):
        return qz.quantize_weight(_randn(gen, (k, n), dev, k ** -0.5, torch.float32))

    res = {"quant_matmul": {"cases": []}, "quant_gated_mlp": {"cases": []}}
    for label, m, k, n, dtype in (
            (f"k/v [{IMG_S}, 3584] . [3584, 2048]", IMG_S, 3584, 2048, torch.bfloat16),
            (f"folded o [{IMG_CHUNK_ROWS}, 2048] . [2048, 3584]", IMG_CHUNK_ROWS, 2048, 3584,
             torch.bfloat16),
            (f"down [{IMG_CHUNK_ROWS}, 14336] . [14336, 3584]", IMG_CHUNK_ROWS, 14336, 3584,
             torch.bfloat16),
            ("ragged [300, 1200] . [1200, 1008]", 300, 1200, 1008, torch.bfloat16),
            ("fp32 ragged [300, 1200] . [1200, 1008]", 300, 1200, 1008, torch.float32),
            ("long row [64, 16384] . [16384, 64] (scalar row pass)", 64, 16384, 64,
             torch.bfloat16)):
        w = wq(k, n)
        x = _rows(gen, (m, k), dev).to(dtype)
        args = (x, w["qi8"], w["scale"])
        plan = k6.gemm_plan(m, n, k)
        case = _int8_case(
            f"K6 quant_matmul {label}", lambda: k6.quant_matmul(*args),
            lambda: k6.quant_matmul_plain(*args),
            {"per-tensor scale": lambda: _with(k6, quantize_act=_per_tensor_act)(
                lambda: k6.quant_matmul_plain(*args)),
             "activations not quantized": lambda: (
                 x.float() @ qz.dequantize_weight(w, torch.float32)).to(x.dtype),
             "last k-step dropped": lambda: _last_step_dropped(k6, x, w)},
            2 * m * k * n, _nbytes(x) + _qbytes(w) + m * n * x.element_size(), exact=True)
        case["cold_ms"] = _time_ms(_cold(k6, lambda: k6.quant_matmul(*args)))
        case["int_mm_ms"], why = _int_mm_ms(x, w)
        print(f"  K6 quant_matmul {label}: {plan.tiles_m} x {plan.tiles_n} tiles on a grid of "
              f"{plan.grid}, {plan.steps} k-steps; K-major cache cold {case['cold_ms']:.4f} ms; "
              f"torch._int_mm (product only) "
              + (f"{case['int_mm_ms']:.4f} ms" if why is None else f"none ({why})"))
        res["quant_matmul"]["cases"].append(case)
    _kmajor_faults(k6, _rows(gen, (IMG_CHUNK_ROWS, 2048), dev), lambda: wq(2048, 3584))

    d, ff = 3584, 14336
    gate, up, down = wq(d, ff), wq(d, ff), wq(ff, d)
    for act, dtype in (("gelu_tanh", torch.bfloat16), ("silu", torch.bfloat16),
                       ("gelu_tanh", torch.float32)):
        other = "silu" if act == "gelu_tanh" else "gelu_tanh"
        x = _rows(gen, (IMG_CHUNK_ROWS, d), dev).to(dtype)

        def no_requant(act=act, x=x):
            g = k6.quant_matmul_plain(x, gate["qi8"], gate["scale"])
            u = k6.quant_matmul_plain(x, up["qi8"], up["scale"])
            h = k6._act(g, act) * u
            return (h.float() @ qz.dequantize_weight(down, torch.float32)).to(x.dtype)

        run = lambda act=act, x=x: k6.quant_gated_mlp(x, gate, up, down, act)  # noqa: E731
        name = (f"K6 quant_gated_mlp {'fp32 ' if dtype == torch.float32 else ''}"
                f"[{IMG_CHUNK_ROWS}, 3584] ff 14336 {act}")
        case = _int8_case(
            name, run,
            lambda act=act, x=x: k6.quant_gated_mlp_plain(x, gate, up, down, act),
            {"per-tensor scale": lambda act=act, x=x: _with(k6, quantize_act=_per_tensor_act)(
                lambda: k6.quant_gated_mlp_plain(x, gate, up, down, act)),
             f"{other} for {act}": lambda x=x: k6.quant_gated_mlp_plain(x, gate, up, down, other),
             "gate and up swapped": lambda act=act, x=x: k6.quant_gated_mlp_plain(
                 x, up, gate, down, act),
             "no requantize of the hidden": no_requant},
            3 * 2 * IMG_CHUNK_ROWS * d * ff,
            2 * _nbytes(x) + _qbytes(gate) + _qbytes(up) + _qbytes(down), exact=True)
        case["cold_ms"] = _time_ms(_cold(k6, run))
        print(f"  {name}: K-major cache cold {case['cold_ms']:.4f} ms (three copies of 51 MB)")
        res["quant_gated_mlp"]["cases"].append(case)
    res["quant_matmul"].update(src=K6_SRC, kernel="K6",
                               replaces="vidi_tpu/ops/pallas/quant_matmul.py:145",
                               **_times(res["quant_matmul"]["cases"], "K6 quant_matmul k/v"))
    res["quant_gated_mlp"].update(src=K6_SRC, kernel="K6",
                                  replaces="vidi_tpu/ops/pallas/quant_matmul.py:75",
                                  **_times(res["quant_gated_mlp"]["cases"],
                                           "K6 quant_gated_mlp"))
    for r in res.values():
        r["max_abs_err"] = max(c["max_abs_err"] for c in r["cases"])
    return res


def _host_us(fn, reps: int = 200) -> float:
    """Host time of one call of `fn` in microseconds: the host clock around
    `reps` calls that only enqueue work (no synchronise in between)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / reps


def _device_us(fn, reps: int = 10) -> float:
    """Device time of one call of `fn` in microseconds: torch.profiler's
    kernel times summed over `reps` calls, over `reps`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / reps


def k7_phase(dev) -> dict:
    """K7 (off every path) at the decoder's norm shapes, the image stream's
    [23,520, 3584] and a 128-token prompt's [128, 3584] in bf16, at
    Gemma2-2B's width 2304 (not a whole number of vectors a lane), in fp32,
    and on the scalar pass (a width that is not a multiple of 8, and a view
    that starts off a 16-byte boundary), against its plain version (ULPS
    bf16 ulps), with torch's rms_norm as the library yardstick and a planted
    fault (the + 1 dropped). Each case reads its time back to back, its
    device time (profiler) and the wrapper's host time a call."""
    from vidi_tpu_torch.ops.cuda import fused_rmsnorm as k7

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    cases, errs = [], []
    for rows, d, dtype, wdtype, offset in (
            (IMG_S, 3584, torch.bfloat16, torch.bfloat16, 0),
            (128, 3584, torch.bfloat16, torch.bfloat16, 0),
            (IMG_S, 2304, torch.bfloat16, torch.bfloat16, 0),
            (4096, 3584, torch.float32, torch.float32, 0),
            (4096, 3584, torch.bfloat16, torch.float32, 0),
            (4096, 3580, torch.bfloat16, torch.bfloat16, 0),
            (4096, 3584, torch.bfloat16, torch.bfloat16, 4)):
        w = _randn(gen, (d,), dev, 0.1, wdtype)
        w1 = (w.float() + 1.0).to(dtype)
        # `offset` elements into a larger buffer: a contiguous view that is
        # not 16-byte aligned
        x = _randn(gen, (rows * d + offset,), dev, dtype=dtype)[offset:].reshape(rows, d)
        route = k7.route(d, x.element_size(), w.element_size(), x.data_ptr(), w.data_ptr(), 0)
        label = (f"K7 fused_rms_norm [{rows}, {d}] {str(dtype).split('.')[1]}"
                 + (f" w {str(wdtype).split('.')[1]}" if wdtype != dtype else "")
                 + (f" offset {offset}" if offset else "") + f" ({route} pass)")
        if route != ("scalar" if d % 8 or offset else "vec"):
            raise AssertionError(f"{label}: unexpected route")
        run = lambda: k7.fused_rms_norm(x, w, 1e-6)  # noqa: E731
        lib = lambda: torch.nn.functional.rms_norm(x, (d,), w1, 1e-6)  # noqa: E731
        errs.append(_check(label, run(), k7.fused_rms_norm_plain(x, w, 1e-6),
                           {"plus_one dropped": k7.fused_rms_norm_plain(x, w, 1e-6, False)}))
        ms, plain_ms = _time_ms(run), _time_ms(lambda: k7.fused_rms_norm_plain(x, w, 1e-6))
        lib_ms = _time_ms(lib)
        bound = _bound(3 * x.numel(), 2 * _nbytes(x) + _nbytes(w), "fp32")
        extra = {"device_us": _device_us(run), "library_device_us": _device_us(lib),
                 "host_us": _host_us(run), "library_host_us": _host_us(lib)}
        print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), rms_norm {lib_ms:.4f} ms; "
              f"device time {extra['device_us']:.1f} us (rms_norm "
              f"{extra['library_device_us']:.1f}), host time a call {extra['host_us']:.1f} us "
              f"(rms_norm {extra['library_host_us']:.1f}); {bound['bound_ms'] / ms:.3f} of the "
              "bound")
        cases.append({"shape": label, "ms": ms, "plain_ms": plain_ms, **bound,
                      "library_ms": lib_ms, **extra})
    return {"fused_rms_norm": dict(
        src=K7_SRC, kernel="K7", replaces="vidi_tpu/ops/pallas/fused_rmsnorm.py:33",
        max_abs_err=max(errs), cases=cases, **_times(cases, f"K7 fused_rms_norm [{IMG_S}"))}


def _times(cases, prefix: str) -> dict:
    """ms / plain_ms / bound / library time of the first case whose label
    starts with `prefix`."""
    c = next(c for c in cases if c["shape"].startswith(prefix))
    return {k: c[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}


def _sdpa(q, k, v, scale, kv_mask):
    """torch's scaled_dot_product_attention on [B,T,H,D] operands (the
    yardstick of a kernel that computes the same function; the port never
    calls it)."""
    mask = None if kv_mask is None else kv_mask[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        scale=scale, enable_gqa=q.shape[2] != k.shape[2])


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


def load_slice(dev, int8: bool = False):
    """Vidi1.5-9B at full width on random weights (with `int8`: int8 text
    and towers), and the synthetic 120 s clip's frames and mel windows: the
    set-up every later phase shares."""
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.infer.loader import load_model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cfg, tok = load_model(random_weights="9b", dtype=torch.bfloat16,
                                  device=dev, seed=SEED, load_8bit=int8,
                                  load_8bit_towers=int8)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    flags = ", load_8bit=True, load_8bit_towers=True" if int8 else ""
    print(f"  load_model(random_weights='9b'{flags}): {n_params / 1e9:.3f} B values, "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while loading)")
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


def _prefill(sl, query: str, quantize_caches: bool = False):
    """Prefill of one TR query -> (h, caches, lens, embedding of token 0)."""
    from vidi_tpu_torch.infer import generate as gen
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.models import decoder

    prompt, mask = P.build_prompt_batch([P.build_prompt_ids(query, sl.tok)])
    pr = torch.as_tensor(prompt).long().to(sl.dev)
    pm = torch.as_tensor(mask).to(sl.dev)
    h, caches, lens = gen._prefill(sl.params, sl.cfg, pr, pm, *sl.media,
                                   max_new_tokens=32, mm_chunks=32, use_flash=True,
                                   quantize_caches=quantize_caches)
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
    one at a time). Prints the `top` kernels by device time and every
    kernel of the port (K1-K7) below them."""
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
    # the top kernels, then every kernel of the port's own below them
    for e in events[:top] + [e for e in events[top:] if "vidi" in e.key]:
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
# The int8 serving slice
# ---------------------------------------------------------------------------

W8A8_MIN_TOKENS = 512  # the CLI's --w8a8-prefill 512
# the small int8 model, card (K5 / K6 / K1 / K2) vs CPU (plain versions):
# fp32 both, but a LayerNorm or attention sum in another order can move a
# value across an int8 rounding boundary and re-round one code (one step of
# 1/127 of its row's largest value), which later layers carry on
INT8_REF_REL = 2e-2
INT8_MODULES = ("text", "vision", "audio")


def int8_reference_check(dev) -> None:
    """The small fp32 model on the int8 route (int8 text and towers, W8A8
    above 16 rows, int8 caches): the card (kernels) against the CPU (plain
    versions), same weights and inputs. Prefill hidden states within
    INT8_REF_REL relative error; greedy tokens identical."""
    from vidi_tpu_torch.infer import generate as gen
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.infer import quantize as qz
    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.ops.cuda import fused_tower_layer as k5
    from vidi_tpu_torch.ops.cuda import quant_matmul as k6

    cfg = _small_config()
    params = qz.quantize_params(dattn.init_params(cfg, torch.float32, torch.device("cpu"),
                                                  SEED), modules=INT8_MODULES)
    gparams = _tree_map(lambda t: t.to(dev), params)
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (6, 42, 42, 3), dtype=np.uint8)
    mels = rng.standard_normal((2, 128, 3000)).astype(np.float32)
    ids = rng.integers(3, 259, (2, 20))
    mask = np.zeros((2, 20), bool)
    mask[0, :17], mask[1, :11] = True, True
    before = k5.launches["ln_ffn"], k6.launches["quant_gated_mlp"]
    outs = {}
    qz.w8a8_min_tokens = 16
    try:
        for name, p, d, flash in (("cpu", params, torch.device("cpu"), False),
                                  ("cuda", gparams, dev, True)):
            media = P.encode_media_arrays(p, cfg, frames, mels, 7000, mm_chunks=2,
                                          use_flash=flash)
            media = [m.repeat_interleave(2, dim=0) for m in media]
            pr = torch.as_tensor(ids * mask).to(d)
            pm = torch.as_tensor(mask).to(d)
            h, _, _ = gen._prefill(p, cfg, pr, pm, *media, max_new_tokens=8, mm_chunks=2,
                                   use_flash=flash, quantize_caches=True)
            res = gen.generate(p, cfg, pr, pm, *media, max_new_tokens=8, eos_id=2,
                               mm_chunks=2, use_flash=flash, quantize_caches=True)
            outs[name] = (h[pm].cpu(), res.tokens.cpu())
    finally:
        qz.w8a8_min_tokens = None
    got, want = outs["cuda"][0], outs["cpu"][0]
    err = float((got - want).norm() / want.norm())
    same = torch.equal(outs["cuda"][1], outs["cpu"][1])
    print(f"  small fp32 int8 model, card (kernels) vs cpu (plain): hidden relative "
          f"error {err:.3e} (limit {INT8_REF_REL}), max_abs_err "
          f"{float((got - want).abs().max()):.3e}; tokens "
          f"{'identical' if same else 'DIFFER'}: {outs['cuda'][1].tolist()}")
    if not (err <= INT8_REF_REL and same):
        raise AssertionError("small int8 model reference check failed")
    if (k5.launches["ln_ffn"], k6.launches["quant_gated_mlp"]) == before:
        raise AssertionError("the card's int8 run never launched K5 / K6")


def _int8_counters():
    from vidi_tpu_torch.ops.cuda import flash_attention as k1
    from vidi_tpu_torch.ops.cuda import fused_tower_layer as k5
    from vidi_tpu_torch.ops.cuda import quant_matmul as k6
    from vidi_tpu_torch.ops.cuda import tower_attention as k2
    return k1, k2, k5, k6


def _read_int8_counts() -> dict:
    k1, k2, k5, k6 = _int8_counters()
    return {"flash_attention": k1.launches, "tower_attention": k2.launches,
            **k5.launches, **k6.launches}


def _reset_int8_counts() -> None:
    k1, k2, k5, k6 = _int8_counters()
    k1.launches = k2.launches = 0
    for d in (k5.launches, k6.launches):
        for k in d:
            d[k] = 0


def _chunk_rows(n: int, chunks: int):
    """Rows of each chunk `dattn._xattn_block` updates a stream of n tokens in."""
    if chunks <= 1 or n <= chunks:
        return [n]
    size = -(-n // chunks)
    return [min(size, n - a) for a in range(0, n, size)]


def _map_chunks(n: int, chunks: int) -> int:
    """How many calls `dattn.chunked_map` makes over n frames / windows."""
    if chunks <= 1 or n <= 1:
        return 1
    size = -(-n // min(chunks, n))
    return -(-n // size)


def reckon_kmajor_copies(params, cfg, n_frames: int, n_windows: int, streams,
                         n_queries: int, w8a8: int, limit: int, mm_chunks: int = 32) -> int:
    """K-major copies (byte transposes) in one encode and n_queries prefills:
    the weights the code hands K5 and K6, in its order, replayed through the
    cache's rule (a copy per weight not held; least recently used out once
    the copies' bytes pass `limit`; an entry leaves when its weight dies).
    Each tower walks all its layers once per frame / window chunk; each
    decoder layer hands K6 its k / v weights per W8A8 stream and, per W8A8
    update chunk, a folded o_proj made anew by every `_xattn_block` call,
    then gate, up and down; the folded o_proj dies when the call returns."""
    import collections

    def size(w):
        return w["qi8"].numel()

    seq = []
    vis_layers = cfg.vision.num_layers + 1 + cfg.vision.select_layer
    for tower, layers, chunks in (
            ("vision", params["vision"]["layers"][:vis_layers], _map_chunks(n_frames, mm_chunks)),
            ("audio", params["audio"]["layers"], _map_chunks(n_windows, mm_chunks))):
        for _ in range(chunks):
            for i, lp in enumerate(layers):
                seq += [((tower, i, k), size(lp[k]))
                        for k in ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w")]
    g = cfg.text.num_heads // cfg.text.num_kv_heads
    for q in range(n_queries):
        for i, lp in enumerate(params["text"]["layers"]):
            for s, rows in enumerate(streams):
                if rows >= w8a8:
                    seq += [(("text", i, k), size(lp[k])) for k in ("k_w", "v_w")]
                for c in _chunk_rows(rows, mm_chunks):
                    if c >= w8a8:
                        seq.append((("folded o", q, i, s), size(lp["o_w"]) // g))
                        seq += [(("text", i, k), size(lp[k]))
                                for k in ("gate_w", "up_w", "down_w")]
                seq.append((("folded o", q, i, s), None))  # freed: its entry goes
    held, used, copies = collections.OrderedDict(), 0, 0
    for key, nbytes in seq:
        if nbytes is None:
            used -= held.pop(key, 0)
            continue
        if key in held:
            held.move_to_end(key)
            continue
        copies += 1
        if nbytes <= limit:
            held[key] = nbytes
            used += nbytes
            while used > limit:
                used -= held.popitem(last=False)[1]
    return copies


def reckon_int8_launches(cfg, n_frames: int, n_windows: int, streams, prompt_rows: int,
                         n_queries: int, w8a8: int, mm_chunks: int = 32) -> dict:
    """Each kernel's launches in one encode and n_queries prefills, from the
    code's structure: every SigLIP / Whisper layer call runs K2 and K5's
    three pieces once per frame / window chunk; every decoder layer runs K1
    three times (T2T, T2V, T2A); a stream of at least `w8a8` rows takes two
    quant_matmul calls for its k / v, and each diagonal-update chunk of at
    least `w8a8` rows a quant_matmul (folded o) and a quant_gated_mlp, whose
    down projection is one more quant_matmul. Decode runs none of them."""
    assert prompt_rows < w8a8, "the text prefill must stay weight-only"
    vis_layers = cfg.vision.num_layers + 1 + cfg.vision.select_layer
    tower = (vis_layers * _map_chunks(n_frames, mm_chunks)
             + cfg.audio.num_layers * _map_chunks(n_windows, mm_chunks))
    qm = gated = 0
    for rows in streams:
        qm += 2 * (rows >= w8a8)
        for c in _chunk_rows(rows, mm_chunks):
            qm += 2 * (c >= w8a8)
            gated += c >= w8a8
    layers = cfg.text.num_layers
    return {"flash_attention": 3 * layers * n_queries, "tower_attention": tower,
            "ln_qkv": tower, "o_residual": tower, "ln_ffn": tower,
            "quant_matmul": layers * qm * n_queries,
            "quant_gated_mlp": layers * gated * n_queries}


def _param_bytes(params) -> dict:
    """Parameter bytes by kind: int8 text layers (codes + scales), the
    embedding, int8 towers, everything else."""
    text = sum(_nbytes(*_leaves(lp)) for lp in params["text"]["layers"])
    towers = sum(_nbytes(*_leaves(lp)) for t in ("vision", "audio")
                 for lp in params[t]["layers"])
    embed = _nbytes(*_leaves(params["text"]["embed"]))
    total = _nbytes(*_leaves(params))
    return {"text_layers": text, "embed": embed, "tower_layers": towers,
            "other": total - text - towers - embed, "total": total}


def int8_slice_phase(sl) -> dict:
    """The int8 serving slice: one media encode (int8 towers: K2 + K5) and
    three TR queries x 32 new tokens with W8A8 prefill (K1 + K6) and int8
    image / audio caches, with every kernel's launches read around them and
    held to the reckoned counts."""
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.infer import quantize as qz
    from vidi_tpu_torch.infer.generate import generate
    from vidi_tpu_torch.ops.cuda import quant_matmul as k6

    cfg, tok, dev, seconds = sl.cfg, sl.tok, sl.dev, sl.seconds
    eos = P.pick_eos(cfg, tok)
    sizes = _param_bytes(sl.params)
    print("  parameter bytes: " + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in sizes.items()))
    k6.KMAJOR.clear()
    _reset_int8_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sl.media = img, img_mask, aud, aud_mask = _encode(sl)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    print(f"  encode (int8 towers): img {tuple(img.shape)}, aud {tuple(aud.shape)} in "
          f"{encode_s:.3f} s")
    for name, x in (("img", img), ("aud", aud)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"non-finite {name} features")
    prompt_rows = 0
    prefill, rates = [], []
    for q in QUERIES:
        ids = P.build_prompt_ids(q, tok)
        prompt, mask = P.build_prompt_batch([ids])
        prompt_rows = max(prompt_rows, prompt.shape[1])
        res = generate(sl.params, cfg, torch.as_tensor(prompt).long().to(dev),
                       torch.as_tensor(mask).to(dev), *sl.media, max_new_tokens=32,
                       eos_id=eos, mm_chunks=32, use_flash=True, quantize_caches=True)
        toks = res.tokens[0, : int(res.lengths[0])].cpu()
        if not ((toks >= 0) & (toks < cfg.text.vocab_size)).all():
            raise AssertionError("generated ids outside the vocabulary")
        answer = P.parse_task_output(tok.decode(toks.numpy(), skip_special_tokens=True).strip(),
                                     "tr", float(seconds))
        prefill.append(res.prefill_s)
        rates.append(res.decode_steps / res.decode_s)
        print(f"  query {q!r}: prefill {res.prefill_s:.3f} s, decode {res.decode_steps} "
              f"steps {res.decode_s:.3f} s = {rates[-1]:.2f} tok/s, answer {answer!r}")
    torch.cuda.synchronize()
    launches = _read_int8_counts()
    streams = (img.shape[1], aud.shape[1])
    want = reckon_int8_launches(cfg, len(sl.frames), sl.mels.shape[0], streams, prompt_rows,
                                len(QUERIES), qz.w8a8_min_tokens)
    want["kmajor_copy"] = reckon_kmajor_copies(
        sl.params, cfg, len(sl.frames), sl.mels.shape[0], streams, len(QUERIES),
        qz.w8a8_min_tokens, k6.KMAJOR.limit_bytes)
    print(f"  K-major cache: {k6.KMAJOR.hits} hits, {k6.KMAJOR.misses} misses, "
          f"{k6.KMAJOR.bytes / 2**20:.1f} MiB of copies held (limit "
          f"{k6.KMAJOR.limit_bytes / 2**20:.0f} MiB)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  kernel launches: {launches}; reckoned from the code: {want}")
    print(f"  encode {encode_s:.3f} s, prefill {statistics.mean(prefill):.3f} s a query, "
          f"decode {statistics.mean(rates):.2f} tok/s, peak device memory "
          f"(max_memory_allocated) {peak:.2f} GiB")
    if launches != want:
        raise AssertionError(f"launch counts differ from the reckoned ones: {launches} "
                             f"vs {want}")
    return launches


# The int8 slice's route check, two readings, both on the card:
# (1) the step-0 logits with K5 / K6 against the same model with their plain
#     versions. The plain versions compute the same int8 codes, but a
#     LayerNorm's sum and torch's tanh / erf differ in the last bits, which
#     re-round a code now and then (see INT8_REL); through 26 SigLIP, 32
#     Whisper and 42 decoder layers of random weights every such flip
#     re-rounds more codes downstream, until the two routes differ by the
#     int8 quantization noise itself: on an H100 80GB HBM3 (700 W) the
#     logits read 5.1e-2 of max|logit| and cosine 0.999972 (the bf16 slice's
#     two decode routes read 4.0e-2 too), and a K5 without its FFN
#     requantize read 4.4e-2 and 0.999974, no farther. So (1) holds the
#     route to the bf16 decode routes' limits and can see a broken kernel,
#     not a subtle one;
# (2) every K5 / K6 call of one encode and prefill against its plain version
#     on the same inputs: the real model's weights and activations, without
#     the compounding. Each call must lie within INT8_REL, as in the kernel
#     phases, and the planted fault must fail it.
INT8_LOGIT_REL = 1e-1  # max |difference| / max |logit|
INT8_LOGIT_COS = 0.9999


def _step0_logits(sl):
    """Encode, prefill QUERIES[0] with int8 caches -> (the logits of the
    first generated token, the cache bytes)."""
    from vidi_tpu_torch.models import decoder

    sl.media = _encode(sl)
    h, caches, lens, _ = _prefill(sl, QUERIES[0], quantize_caches=True)
    logits = decoder.lm_logits(sl.params["text"], h[:, int(lens[0]) - 1], sl.cfg.text)
    cache_bytes = {n: _nbytes(*_leaves(getattr(caches, n))) for n in ("img_k", "img_v")}
    del h, caches
    return logits.float(), cache_bytes


class _Shadow:
    """Wrappers that run a function's kernel route and its plain version on
    the same inputs, return the kernel's output and keep each function's
    worst relative error and call count."""

    def __init__(self):
        self.worst, self.calls = {}, {}

    def wrap(self, name, run, plain):
        def call(*args, **kw):
            got = run(*args, **kw)
            want = _flat(plain(*args, **kw))
            err = float((_flat(got) - want).norm() / want.norm().clamp_min(1e-30))
            self.worst[name] = max(self.worst.get(name, 0.0), err)
            self.calls[name] = self.calls.get(name, 0) + 1
            return got
        return call


def _shadowed_calls(sl, ln_ffn=None) -> dict:
    """One encode and one prefill of QUERIES[0] with every K5 / K6 call held
    against its plain version; `ln_ffn` replaces K5's ln_ffn (a planted
    fault). -> {function: (worst relative error, calls)}."""
    from vidi_tpu_torch.ops.cuda import fused_tower_layer as k5
    from vidi_tpu_torch.ops.cuda import quant_matmul as k6

    sh = _Shadow()
    with _swap(k5, ln_qkv=sh.wrap("ln_qkv", k5.ln_qkv, k5.ln_qkv_plain),
               o_residual=sh.wrap("o_residual", k5.o_residual, k5.o_residual_plain),
               ln_ffn=sh.wrap("ln_ffn", ln_ffn or k5.ln_ffn, k5.ln_ffn_plain)), \
            _swap(k6, quant_matmul=sh.wrap("quant_matmul", k6.quant_matmul,
                                           k6.quant_matmul_plain),
                  quant_gated_mlp=sh.wrap("quant_gated_mlp", k6.quant_gated_mlp,
                                          k6.quant_gated_mlp_plain)):
        sl.media = _encode(sl)
        _prefill(sl, QUERIES[0], quantize_caches=True)
    torch.cuda.synchronize()
    return {n: (sh.worst[n], sh.calls[n]) for n in sh.worst}


def int8_route_check(sl) -> None:
    """The step-0 logits and every K5 / K6 call against the plain versions
    (see above); the planted fault (K5 without its FFN requantize) must fail."""
    from vidi_tpu_torch.ops.cuda import fused_tower_layer as k5
    from vidi_tpu_torch.ops.cuda import quant_matmul as k6

    kernel, cache_bytes = _step0_logits(sl)
    print("  int8 image caches: " + ", ".join(
        f"{n} {b / 1e9:.3f} GB" for n, b in cache_bytes.items()) + " (codes + scales)")
    with _swap(k5, ln_qkv=k5.ln_qkv_plain, o_residual=k5.o_residual_plain,
               ln_ffn=k5.ln_ffn_plain), \
            _swap(k6, quant_matmul=k6.quant_matmul_plain,
                  quant_gated_mlp=k6.quant_gated_mlp_plain):
        plain, _ = _step0_logits(sl)

    fault = "planted fault, K5 without the FFN requantize"
    logits = {"kernel route": _logit_gap(kernel, plain)}
    with _swap(k5, ln_ffn=_ffn_no_requant):
        logits[fault] = _logit_gap(_step0_logits(sl)[0], plain)
    calls = {"kernel route": _shadowed_calls(sl),
             fault: _shadowed_calls(sl, ln_ffn=_ffn_no_requant)}
    passes = {}
    for name, (rel, cos) in logits.items():
        worst = max(e for e, _ in calls[name].values())
        print(f"  int8 {name}: step 0 logits vs plain K5 / K6 max_abs_err = {rel:.3e} of "
              f"max|logit| (limit {INT8_LOGIT_REL}), cosine {cos:.6f} (limit "
              f"{INT8_LOGIT_COS}); each call vs its plain version, worst relative error "
              + ", ".join(f"{n} {e:.3e} ({c} calls)" for n, (e, c) in calls[name].items())
              + f" (limit {INT8_REL:.1e})")
        passes[name] = rel <= INT8_LOGIT_REL and cos >= INT8_LOGIT_COS and worst <= INT8_REL
    if not passes["kernel route"]:
        raise AssertionError("the int8 kernel and plain routes disagree")
    if passes[fault]:
        raise AssertionError("the int8 route limits do not reject the planted fault")


def profile_int8(sl) -> None:
    """torch.profiler over the int8 slice's encode, one prefill and
    PROFILE_DECODE_STEPS decode steps over int8 caches."""
    from vidi_tpu_torch.models import decoder

    _region("int8 encode", lambda: _encode(sl))
    _, caches, lens, emb = _region("int8 prefill (W8A8)",
                                   lambda: _prefill(sl, QUERIES[0], quantize_caches=True))

    def steps():
        cur, e = lens.clone(), emb
        for _ in range(PROFILE_DECODE_STEPS):
            logits = _decode_step(sl, e, cur, caches, False)
            e = decoder.embed_tokens(sl.params["text"], logits.argmax(-1)[:, None],
                                     sl.cfg.text)
            cur = cur + 1
        return logits
    _region(f"int8 decode over int8 caches x{PROFILE_DECODE_STEPS}", steps)


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
    print("K5 phase (int8 tower layer):")
    kern.update(k5_phase(dev))
    print("K6 phase (W8A8 matmuls):")
    kern.update(k6_phase(dev))
    print("K7 phase (fused RMSNorm, on no path):")
    kern.update(k7_phase(dev))
    print("reference check:")
    reference_check(dev)
    print("int8 reference check:")
    int8_reference_check(dev)
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

    from vidi_tpu_torch.infer import quantize as qz
    print("int8 slice (Vidi1.5-9B, int8 text + towers, W8A8 prefill from "
          f"{W8A8_MIN_TOKENS} rows, int8 caches, random weights):")
    qz.w8a8_min_tokens = W8A8_MIN_TOKENS
    sl = load_slice(dev, int8=True)
    serve_int8 = int8_slice_phase(sl)
    if args.profile:
        print("int8 profile:")
        profile_int8(sl)
    print("int8 routes:")
    int8_route_check(sl)
    qz.w8a8_min_tokens = None
    from vidi_tpu_torch.ops.cuda import quant_matmul as k6
    held = (len(k6.KMAJOR.entries), k6.KMAJOR.bytes)
    before = torch.cuda.memory_allocated()
    del sl
    gc.collect()
    after = torch.cuda.memory_allocated()
    print(f"  int8 slice dropped: memory_allocated {before / 2**30:.2f} -> {after / 2**30:.2f} "
          f"GiB; K-major cache {held[0]} entries / {held[1] / 2**20:.1f} MiB -> "
          f"{len(k6.KMAJOR.entries)} / {k6.KMAJOR.bytes / 2**20:.1f} MiB, no clear()")
    if k6.KMAJOR.entries or k6.KMAJOR.bytes:
        raise AssertionError("the K-major cache kept copies of a dropped model's weights")
    torch.cuda.empty_cache()

    print(f"training slice (Vidi1.5-9B, {TRAIN_LAYERS} text layers, random weights):")
    tr = load_training_slice(dev)
    train = training_phase(tr)
    if args.profile:
        print("training profile:")
        profile_training(tr)
    print("gradient routes:")
    gradient_route_check(tr)

    # launches: the path each kernel serves first (bf16 serving for K1-K3,
    # training for K4, int8 serving for K5 / K6; K7 is on no path);
    # launches_by_path gives every path's count
    paths = {"serve": serve, "serve_int8": serve_int8, "train": train}
    ids = {"flash_attention": "K1", "tower_attention": "K2", "decode_attention": "K3",
           "flash_attention_bwd": "K4"}
    print(json.dumps({"kernels": [
        {"name": name, "id": r.get("kernel", ids.get(name)), "route": "cuda",
         "source": r["src"], "replaces": r["replaces"],
         "launches": next((p[name] for p in (serve, train, serve_int8) if name in p), 0),
         "launches_by_path": {k: p.get(name, 0) for k, p in paths.items()},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], "cases": r["cases"]}
        for name, r in kern.items()]}))
    print(smi)  # name, power.limit as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
