"""GPU smoke run of the PyTorch port (vidi_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

1. Builds the hand-written CUDA kernels (K1 flash_attention, K2
   tower_attention, K3 decode_attention, K4 flash_attention_bwd, K5 the
   int8 tower layer's ln_qkv / o_residual / ln_ffn, K6 quant_matmul and
   quant_gated_mlp with the byte transpose behind their K-major weight
   copies, K7 fused_rms_norm) from vidi_tpu_torch/csrc with one nvcc per
   source, all started together.
2. Runs each kernel at the shapes the Vidi1.5-9B slices give it (and K1 /
   K3 / K4 at the 1.5B configuration's head dim 128; K1 / K2 / K3 at the
   Vidi-7B slice's: Mistral's 32 query / 8 KV heads of 128, G = 4, no
   softcap, CLIP's 4 x 257 tokens of 16 heads of 64; K3 also at G = 1 and
   G = 8) against its plain
   PyTorch version on the same inputs, and times both with CUDA events,
   beside the least time the card could take (bytes over 3.35 TB/s or
   operations over the peak of their type) and, where one PyTorch call
   computes the same function, that call's time. For K1-K4 queries are
   scaled up so that logits reach tens and the softcap of 50 binds; a bf16
   output must lie within ULPS bf16 ulps of the plain output's largest
   magnitude. K5 must lie within INT8_REL relative error of its plain
   versions (the int8 codes agree; see INT8_REL) and prints its device
   time a call, its persistent GEMM's blocks against the card's SMs,
   torch._int_mm's time for the products alone, and the registers and
   spills `nvcc -Xptxas -v` reports for that GEMM; K6 must equal its plain
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
   exact gelu or a product's last k-step dropped; K5's persistent schedule
   skipping a tile or computing one twice into another's place; gate and
   up swapped; a
   stale K-major copy served after the weight was edited in place, or after
   it was freed and another took its place; K1 with its GQA groups packed
   wrong; K2 at D = 72
   with its depth padding not zeroed, or without the keys past its last
   whole key tile; K3 with one split's partial left out of its merge, or
   the ragged last tile of the cache dropped, or on a G = 4 cache with
   Gemma2's grouping (query head h reading KV head h // 2); K4 with each GQA row's lse
   and di taken from the other head, one dq split dropped, or the band's
   tile skip off by one tile) and fails unless every fault lands outside
   the limit. K3 (bf16 on its sm90 kernel: bulk copies into a shared-memory
   ring, `decode_plan`'s splits merged by the last block, one launch a
   call) prints each case's plan, its events time, its device time a call
   (profiler) and its host time a call, and two bounds: the whole cache's
   bytes and the visible keys' (the share is taken against the latter);
   its bf16 cases run twice and must be bit-equal, a B = 2 case whose
   second row sees no key must give bit-zero there, a capless case is
   timed against SDPA, an fp32 case holds the SIMT route, and `nvcc -Xptxas
   -v` prints the sm90 kernel's registers and spills. The long-video
   slice's reads run too: K3 on the 600 s clip's image cache (60,000 keys)
   and K1 on three query rows folded into one (a prefill of 3 x T tokens, a
   decode step of 3) against a cache's layer view transposed in place, at
   S = 60,000 and 6,000, with the rows folded in the wrong order as a
   planted fault.
   K1 / K2 / K4 take bf16 through the sm90 kernels (wgmma, TMA) and fp32
   through the SIMT templates: one fp32 case each holds the SIMT route.
   Each K1 / K2 / K4 case prints its TFLOP/s and its share of the bound;
   K4's two runs must be bit-equal, and its capless cases (the 7B's G = 4
   T2T / T2V / T2A, the 9B's T2A) are timed against SDPA's backward. K1
   and K4 also run at a --pack row: 4,096 tokens in three segments, with
   the segment ids ignored as a planted fault, and at the B = 2 shapes the
   training phases hand them: train_pack's two rows with their own
   segment ids, and (K4) train_image's T2V over two anyres rows with
   per-row masks, with every row reading row 0's masks or keys as faults.
3. Checks small fp32 models end to end, the card (kernels) against the CPU
   (plain PyTorch): a prefill + greedy decode in bf16-layout fp32 at the
   9B's kernel shapes and at the 7B's (Mistral with G = 4, CLIP with its
   class token, the v1 adapters), on the int8 route, and training steps:
   the 9B's shapes; image mode with anyres grids (2, 2) and (1, 3) in one
   batch; remat "dots" on the card against full remat on the CPU;
   gradient accumulation over k = 2; the 7B's shapes with position noise.
4. Drives the serving slice: load_model(random_weights="9b") at full width,
   a synthetic 120 s clip (120 frames 384x384, 16 kHz audio), one media
   encode, then three temporal-retrieval queries through prompt ->
   generate(max_new_tokens=32) -> decode -> parse, counting kernel launches,
   and one query with use_flash_decode=True (K3). It holds the K3 decode
   route's step-0 logits against the default route's, and a planted fault
   (K3 without its kv_mask) against the same limits, and shows one K3
   decode step's K3 calls to be one launch call and one sm90 kernel each
   (the profiler, each call in a range of its own, against
   decode_attention.launches; a session is taken again only when it lost a
   kernel record whose launch call it holds), none of the SIMT route. Then the
   decoding variants (serve_decoding, on the slice's first SHALLOW_LAYERS
   text layers since the training phases grew the script): verify_step
   on a window of VERIFY_W
   tokens against as many decode steps (logits under the decode routes'
   limits, the window's text-cache slots to cosine CACHE_COS; a planted
   fault: the window written one slot late); greedy speculative decoding
   (spec_k SPEC_K; the n-gram draft and a random DRAFT_LAYERS-layer
   text-only draft) on the per-row caches, on media_prefill's caches for
   the three queries folded and (n-gram) on int8 caches, its tokens equal
   to greedy's wherever greedy's top-2 gap exceeds the logit limit; beams
   (num_beams = 1 bit-equal to greedy on the K3 route, NUM_BEAMS on the
   kernel and plain routes parting only at a near tie, the final text
   caches against a teacher-forced replay of the beams with a planted
   fault: caches not reordered by parent; NUM_BEAMS on the folded shared
   caches); sampling (one seed twice bit-equal, top-k 1 greedy); and ask
   with the n-gram draft and with two beams on the clip written as an
   mp4. Each run's K1 / K3 launches are held to the reckoned ones. Then it
   reads the bf16 forward's dependence on mm_chunks (ROADMAP Q3.10) on the
   first MMC_LAYERS layers: mm_chunks 1 and 32, each against an fp32
   forward, with a planted fault (the audio stream's ragged last chunk left
   without its update).
   Then the serving daemon (serve), SERVE_NEW new tokens a response, on two
   mp4 clips (A: the 120 s frames; B: 60 s of other frames), through
   serve_loop fed by its own JSONL reader: (a) batch_queries 2,
   media_cache 2 over three A queries, one B query and a vqa request with
   options, with three planted bad requests (a line that is not JSON, a
   request without a query, a missing file); (b) batch_videos 2 (one
   generate over the two videos' caches stacked on the batch axis); (c)
   quantize_kv; (d) spec_ngram; (e) media_cache 1 over A, B, A. Each run's
   stats and K1 / K2 launches (no K3: the reference's decode route) are
   held to the reckoned ones, its only errors must be the planted ones,
   and each response's generated ids (recorded by the tokenizer) and
   step-0 logits are held to a generate of its query alone on the full
   forward (ids equal but where the anchor's top-2 gap is within the logit
   limit; logits within the decode routes' limits). Two planted faults
   must leave the limits: _stack_media padding the masks with True, an
   LRU handing back the other video's caches. Then the batch runner
   (run_benchmark.make_ask_batch + run_task) on made-up ground truths for
   tr, vqa, character and stg, its TR rows held like the daemon's, and the
   evals (vue_tr, vue_plot, vue_stg) on its predictions.
5. Drives the long-video slice on the same weights, the 120 s media
   dropped: media_prefill_chunked's caches of the 120 s media held against
   forward's layer by layer (cosine, a planted fault: each layer against
   the one before); then a synthetic 600 s clip (600 frames decoded at
   360x640, 20 Whisper windows), the device resize held against the CPU
   (a planted fault: no antialiasing), a streamed encode of five chunks of
   120 frames resized on the card (encode_frame_stream), the step-0 logits
   of one query through the full forward (its 21.2 GiB of caches then
   dropped), the media caches prefilled once in chunks of 32,768 tokens
   (media_prefill_chunked, peak memory printed), and the three queries as
   three rows folded onto those shared caches (generate(media_caches=):
   folded K1 prefill and decode) and one alone (K1 prefill, K3 decode),
   each run's K1 / K3 launches held to the reckoned ones. It holds the
   shared-cache query's step-0 logits against the full forward's and the
   three folded rows' against the rows one by one, under the decode
   routes' logit limits, with a planted fault each (the tail chunk's
   caches left zero; the rows unfolded in the wrong order).
6. Drives the checkpoint slice on the same weights, made distinct first
   (seeded noise on every leaf: random init leaves biases at 0 and norms at
   0 or 1): the 120 s clip's frames written as an mp4 and `ask` run twice
   on the in-memory tree (K2, K1, K3); save_pretrained into a temporary
   directory (free disk checked against the reckoned bytes first),
   load_model(model_path=...) on the card: every tensor bit-equal to the one written and
   config_from_hf(config_to_hf(cfg)) == cfg; `ask` on the loaded tree, its
   step-0 logits and tokens equal to the in-memory tree's; four planted
   faults (a square weight left untransposed, two text layers swapped, a
   tensor read one element off, a bias dropped), each through the whole
   load, must fail the tree check; load_model(load_8bit=True,
   load_8bit_towers=True) from the directory, bit-equal to quantizing the
   in-memory tree layer by layer; the full-precision tree dropped and one
   int8 `ask` (K5, K6). It prints bytes written, write and load times and
   rates, host (VmRSS sampled) and device peaks, with the card's name and
   power limit. Last, the daemon's CLI, serve.main(["--model-path", DIR,
   "--in", ..., "--out", ...]), at full width on the directory, its stats
   and launches held to the reckoned ones.
   Frees it and drives Vidi-7B (serve_7b): load_model(random_weights="7b")
   at full width (Mistral-7B, CLIP ViT-L/14, Whisper-large-v3, the v1
   adapters), a synthetic 120 s clip at 224 px, one encode of its arrays
   (7,680 image and 1,200 audio tokens), then the clip written as an mp4
   and asked three TR queries on the plain decode route and one on the K3
   route (32 new tokens each); K1 / K2 / K3 launches held to the ones
   reckoned from the code, each answer a string of v1 spans (seconds with
   two decimals), the routes' step-0 logits under the decode routes'
   limits with a planted fault (K3 with Gemma2's G = 2 grouping); it
   prints weight and cache bytes, encode and prefill s, decode tok/s on
   each route and the peak beside the card's name and power limit.
7. Frees it and drives the int8 serving slice: the same model loaded with
   load_8bit=True, load_8bit_towers=True (int8 text and towers), W8A8
   prefill from 512 rows, int8 image / audio caches: one encode (K2, K5),
   three TR queries (K1, K6), launch counts (the K-major copies among
   them, none of a tower weight: the towers store theirs K-major) held to
   the ones reckoned from the code, then the step-0 logits
   with K5 / K6 against their plain
   versions, and every K5 / K6 call of one encode and prefill against its
   plain version on the same inputs, each with a planted fault (K5 without
   the FFN requantize) that the per-call limit must reject; and two
   requests through serve_loop with quantize_kv (K2 + K5 encode, K1 + K6
   stream prefill), launches and answers held as in the bf16 daemon.
8. Frees it and drives the training slice: Vidi1.5-9B at full width with
   TRAIN_LAYERS text layers (bf16, towers frozen, remat, use_flash), four
   train_steps on synthetic batches of 256 text tokens, 120 frames and 4
   Whisper windows, counting K1 / K2 / K4 launches. It then holds the
   gradients of a few leaves on the kernel route against the
   plain-attention route, and a planted fault (K4 without di) against the
   same limits. Then, each from a fresh optimizer: remat "dots" against
   full remat (loss and gradients within one bf16 rounding, step time and
   peak of each, the ops the policy keeps); gradient accumulation k = 2
   (parameters untouched until the second optimizer step); image-mode
   training (the slice's text and towers, fresh image adapters, B = 2
   anyres samples of 5 and 4 tiles, 3 steps); --pack rows (PackedBatcher,
   2 x 4,096 tokens: each segment's logits against its sample alone, a
   planted fault with the segment ids dropped, one backward); each with
   K1 / K2 / K4 launches held to the reckoned ones. Frees it and trains
   Vidi-7B at full width with TRAIN_LAYERS text layers (the 120 s clip at
   224 px, position noise at the v1 side, launches reckoned; the gradient
   routes at G = 4 with their planted fault), then runs the train CLI on
   the card as a subprocess (tiny image-mode model, anyres batches,
   gradient accumulation, remat "dots", a profile trace, tensorboard):
   its trace must exist and its metrics carry the optimizer steps'
   learning rates. Draft distillation runs before the checkpoint phase
   (which replaces the weights), on the full-depth 9B serving slice as
   the teacher: a 2-layer student
   of width 512, 16 steps on rollouts of 8 x (32 + 32) tokens, the KL
   falling on each rollout batch, no kernel launched (as the reference:
   the plain route), the student saved, reloaded and run as
   speculative_generate's draft with greedy's tokens.
9. Last, the parallel slice (parallel/): the 9B's T2V at full width (T =
   128, S = 23,520 with the last 30 frames padding) cut into PAR_SEQ
   virtual seq ranks of 5,880 keys in one process: the ring's flash
   partials (K1 on each shard) merged in shard order against K1 on the
   whole cache, the ring backward (K4 on each shard against the final out
   / lse) against K4 on the whole cache, with planted faults (a shard's lse
   left at K1's sentinel, a shard dropped, dk / dv handed to the wrong
   owner), the ring's K1 / K4 launches read around its run alone, its
   times beside one call on the whole cache; Ulysses' head slices (K1 on 4
   query / 2 KV heads each) stitched against K1 on all heads; the train
   CLI (tiny, --sp_mode ring) under `torchrun --nproc_per_node 1` (a
   one-rank NCCL world) against the plain CLI, losses within CLI_LOSS_REL.
   Then the parallel inference slice: K3 with its lse (`return_lse`) at
   the 9B's image, audio and text caches and the 7B's image cache, lse
   within LSE_ATOL of the plain version's (planted fault: one split's lse
   for the merged one), out bit-equal to the call without lse; the 9B
   image cache cut into PAR_SEQ virtual seq ranks, each shard's K3 partial
   merged in shard order as `sharding.seq_merge` merges (against K3 on the
   whole cache; faults: the lse dropped, a shard dropped, the empty
   shard's sentinel unmapped; PAR_SEQ K3 launches); one 9B Dattn decode
   step cut over "model" on MODEL_RANKS virtual ranks in threads (the
   partials summed in rank order) against the uncut step (fault: one
   rank's partial alone); and the serving path as two processes on the
   card over gloo, seq 2 and model 2, against one process. One card
   holds no multi-card collective.
10. With --profile, profiles both serving slices' encode, one prefill and
   eight decode steps (each decode route of the bf16 one; the 7B's eight
   on the K3 route), the long-video
   slice's streamed encode, chunked media prefill, shared-cache prefills
   and decode steps (three folded rows, one row), one cache-hit group of
   the daemon (two queries' text prefill on shared caches and the decode
   steps), and one training step of the 9B (full remat, remat "dots",
   image mode, a packed backward) and of the 7B, with torch.profiler.

Exits non-zero on any failure (no CUDA device, a kernel that does not build,
launch or agree, a planted fault the checks cannot see, a launch count off
the reckoned one, a wrong output). The line before the last is a JSON
object with one entry per kernel function; the last line is {"ok": true,
"device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types
import warnings

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
# Vidi-7B (the serve_7b slice): 120 frames at 224 px pooled to 8 x 8 tokens
# each by the v1 adapters; the masks as above (24 frames of padding)
IMG7_S, IMG7_VALID = 7680, 7680 - 24 * 64
K3_7B_FAULTS = ("mask", "cap", "split", "g2")

# The long-video slice: a 600 s clip, 600 frames decoded at 360x640 (resized
# on the card to 384x384; the token budget, budget_hw(600) = (20, 20), pools
# each to 10 x 10 tokens) and 20 Whisper windows (300 tokens each), streamed
# in chunks of 120 frames; its media caches are prefilled in chunks of
# 32,768 tokens (two image chunks, the second a padded tail; one audio chunk)
LONG_SECONDS, LONG_DECODE_HW, LONG_CHUNK_FRAMES = 600, (360, 640), 120
LONG_FRAME_TOKENS = 100
LONG_IMG_S, LONG_AUD_S = LONG_SECONDS * LONG_FRAME_TOKENS, 6000
LONG_CHUNK_TOKENS = 32768

# --pack rows (train_pack, and the K1 / K4 packed cases): PackedBatcher rows
# of 4,096 tokens; the kernel cases take train_pack's two rows, and one row
# of three segments and 96 pad tokens
PACK_T, PACK_SEGS = 4096, (1500, 1400, 1100)

K1_SRC = "vidi_tpu_torch/csrc/flash_attention.cu"
K2_SRC = "vidi_tpu_torch/csrc/tower_attention.cu"
K3_SRC = "vidi_tpu_torch/csrc/decode_attention_sm90.cuh"
K4_SRC = "vidi_tpu_torch/csrc/flash_attention_bwd.cu"
TRAIN_T = 256  # text rows of the training slice's batch

QUERIES = ("a red car driving past", "someone opens a door",
           "a dog runs across the grass")
# The decoding variants (serve_decoding): speculative rounds of SPEC_K drafts
# verified in one pass of VERIFY_W tokens, NUM_BEAMS beams, DECODE_NEW new
# tokens a run, the sampler's warp, and the random draft model's depth and seed
SPEC_K = 4
VERIFY_W = SPEC_K + 1
NUM_BEAMS = 4
DECODE_NEW = 32
SAMPLING = dict(temperature=0.7, top_k=50, top_p=0.9)
DRAFT_LAYERS, DRAFT_SEED = 2, 1
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


def _segments(dev, t: int, lengths) -> torch.Tensor:
    """[1, t] int32 segment ids 1, 2, ... of the given lengths, 0 after."""
    segs = torch.zeros((1, t), dtype=torch.int32, device=dev)
    start = 0
    for i, n in enumerate(lengths, start=1):
        segs[0, start:start + n] = i
        start += n
    return segs


def _rate(label: str, ops: float, ms: float, bound: dict, unit: str = "TFLOP/s") -> dict:
    """10^12 operations a second (`unit`: TFLOP/s, or TOP/s for int8) and
    share of the bound of one timed case, printed and kept."""
    out = {"tflops": ops / ms / 1e9, "bound_share": bound["bound_ms"] / ms}
    print(f"  {label}: {out['tflops']:.1f} {unit}, {out['bound_share']:.3f} of the "
          f"{bound['bound_by']} bound")
    return out


def _prompt_lengths(mm_version: str = "v1.5", length: float = 120.0) -> tuple:
    """(real tokens, padded length) of the first query's TR prompt: the T
    that prefill gives K1 and the text-cache length that decode gives K3
    (v1.5: Vidi1.5's prompt; v1: Vidi-7B's, which states the 120 s length)."""
    from vidi_tpu_torch import ByteTokenizer
    from vidi_tpu_torch.infer import pipeline as P

    ids = P.build_prompt_ids(QUERIES[0], ByteTokenizer(), mm_version, length)
    return len(ids), P.build_prompt_batch([ids])[0].shape[1]


def kernel_phases(dev) -> dict:
    """Each kernel against its plain version at the shapes the slice gives
    it (Vidi1.5-9B: 16 query / 8 KV heads of 256, softcap 50; 120 frames ->
    23,520 image tokens; 4 Whisper windows -> 1,200 audio tokens; the 1.5B
    configuration: 12 / 6 heads of 128), plus a sliding window short enough
    to bind and one case with the softcap off."""
    from vidi_tpu_torch.ops.cuda import flash_attention as k1
    from vidi_tpu_torch.ops.cuda import tower_attention as k2

    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {}
    n_real, t = _prompt_lengths()
    n7, t7 = _prompt_lengths("v1")

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
            # Vidi-7B: Mistral's 32 query / 8 KV heads of 128 (G = 4: 32
            # tokens a 128-row tile), every layer sliding, no softcap
            (f"7b t2t T=S={t7} causal window=4096", 32, 8, 128, t7, True, 4096, None,
             n7, ("causal", "mask", "cap", "gqa"), torch.bfloat16),
            (f"7b t2v T={t7} S={IMG7_S} mask", 32, 8, 128, IMG7_S, False, None, None,
             IMG7_VALID, ("mask", "cap", "gqa"), torch.bfloat16),
            (f"7b t2a T={t7} S={AUD_S} mask", 32, 8, 128, AUD_S, False, None, None,
             AUD_VALID, ("mask", "cap", "gqa"), torch.bfloat16),
            (f"fp32 9b t2a T={t} S={AUD_S} mask cap=50", 16, 8, 256, AUD_S, False,
             None, 50.0, AUD_VALID, ("mask", "cap"), torch.float32)):
        tq = t7 if label.startswith("7b") else t
        args = dict(q=_randn(gen, (1, tq, hq, d), dev, Q_GAIN, dtype),
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
        seen = k1.visible_mask(1, tq, s, args["kv_mask"], causal, window, None, None, dev)
        ops = 4 * hq * d * int(seen.sum())
        bound = _bound(ops, _nbytes(args["q"], args["k"], args["v"], out, lse,
                                    args["kv_mask"]), "bf16" if dtype == torch.bfloat16 else "fp32")
        lib_ms = None
        if cap is None:  # one PyTorch call computes the capless function: SDPA
            # with the keys each row sees (causal and window included) as a mask
            lib_ms = _time_ms(lambda: _sdpa(args["q"], args["k"], args["v"], d**-0.5,
                                            seen if causal else args["kv_mask"]))
        call_ms = _call_ms(lambda: k1.flash_attention(**args))
        print(f"  K1 {label}: kernel {ms:.4f} ms (one call from idle {call_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}), library {lib_ms} ms")
        cases.append({"shape": label, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, **bound,
                      "library_ms": lib_ms, **_rate(f"K1 {label}", ops, ms, bound)})
    e, c = k1_cache_cases(dev, gen, t)
    errs, cases = errs + e, cases + c
    e, c = k1_packed_case(dev, gen)
    errs, cases = errs + e, cases + c
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
            # Vidi-7B's CLIP ViT-L/14 at 224 px: a class token and 256
            # patches, a tail of one row past two 128-row tiles
            ("clip B=4 T=257 H=16 D=64", 4, 257, 16, 64, torch.bfloat16),
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

    res.update(k3_phase(dev, t, n_real))
    return res


def k1_packed_case(dev, gen) -> tuple:
    """K1 at --pack rows of the training slice (train_pack), causal, window
    4096, cap 50, the 9B's heads: one row of T = S = 4,096 tokens in three
    segments (PACK_SEGS) and 96 pad tokens, and the phase's own B = 2 rows
    (`_pack_layout`: per-row segment ids and pad tails); planted faults:
    the segment ids ignored, no causal mask, no softcap, and at B = 2 every
    row read with row 0's segment ids and kv_mask. -> (errs, cases)."""
    from vidi_tpu_torch.ops.cuda import flash_attention as k1

    hq, hk, d = 16, 8, 256
    rows_segs, rows_valid = _pack_layout(dev)
    errs, cases = [], []
    for label, segs, valid in (
            (f"9b packed t2t T=S={PACK_T} {len(PACK_SEGS)} segments cap=50",
             _segments(dev, PACK_T, PACK_SEGS), [sum(PACK_SEGS)]),
            (f"9b packed t2t B=2 T=S={PACK_T} {int(rows_segs.max(1).values.sum())} "
             "segments (train_pack's rows) cap=50", rows_segs, rows_valid)):
        b = len(valid)
        kv_mask = torch.cat([_kv_mask(PACK_T, n, dev) for n in valid])
        args = dict(q=_randn(gen, (b, PACK_T, hq, d), dev, Q_GAIN),
                    k=_randn(gen, (b, PACK_T, hk, d), dev),
                    v=_randn(gen, (b, PACK_T, hk, d), dev), kv_mask=kv_mask,
                    sm_scale=d**-0.5, causal=True, window=4096, softcap=50.0,
                    q_segs=segs, kv_segs=segs)
        out, lse = k1.flash_attention(**args)
        ref, ref_lse = k1.flash_attention_plain(**args)
        planted = _faults(k1.flash_attention_plain, args, ("causal", "cap"))
        planted["segment ids ignored"] = k1.flash_attention_plain(
            **{**args, "q_segs": None, "kv_segs": None})[0]
        if b > 1:
            planted["every row read with row 0's segment ids and kv_mask"] = \
                k1.flash_attention_plain(**{**args, **_row0(args)})[0]
        errs.append(_check(f"K1 {label}", out, ref, planted))
        live = ref_lse < k1.EMPTY_ROW_LSE
        lse_err = float((lse[live] - ref_lse[live]).abs().max())
        print(f"  K1 {label} lse: max_abs_err={lse_err:.3e} (limit {LSE_ATOL})")
        if not lse_err <= LSE_ATOL:
            raise AssertionError(f"K1 {label}: lse disagrees")
        del ref, ref_lse, planted
        ms = _time_ms(lambda: k1.flash_attention(**args))
        plain_ms = _time_ms(lambda: k1.flash_attention_plain(**args))
        seen = k1.visible_mask(b, PACK_T, PACK_T, kv_mask, True, 4096, segs, segs, dev)
        ops = 4 * hq * d * int(seen.sum())
        bound = _bound(ops, _nbytes(args["q"], args["k"], args["v"], out, lse, kv_mask,
                                    segs), "bf16")
        call_ms = _call_ms(lambda: k1.flash_attention(**args))
        print(f"  K1 {label}: kernel {ms:.4f} ms (one call from idle {call_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
              "library None (capped)")
        cases.append({"shape": label, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                      **bound, "library_ms": None, **_rate(f"K1 {label}", ops, ms, bound)})
    return errs, cases


def _pack_layout(dev) -> tuple:
    """train_pack's B = 2 rows (`_packed_batch` on the 9B's config):
    -> (segment ids [2, PACK_T] int32 on dev, real tokens per row)."""
    from vidi_tpu_torch import DattnConfig

    batch = _packed_batch(DattnConfig.vidi15_9b())[0]
    segs = torch.from_numpy(batch["segment_ids"]).to(dev, torch.int32)
    return segs, [int(n) for n in batch["text_mask"].sum(1)]


def _row0(args: dict) -> dict:
    """The masks of a kernel that drops the batch stride of kv_mask and of
    the segment ids: every row reads row 0's."""
    def first(x):
        return None if x is None else x[:1].expand_as(x)
    return {"kv_mask": first(args["kv_mask"]), "q_segs": first(args["q_segs"]),
            "kv_segs": first(args["kv_segs"])}


def k1_cache_cases(dev, gen, t: int) -> tuple:
    """K1 on the long-video slice's reads of shared caches: the three query
    rows folded into one row of 3 x T tokens (the text prefill) or of 3
    tokens (a decode step), against a [L,1,Hk,S,D] cache's layer view
    transposed in place to [1,S,Hk,D] (no copy), the 600 s clip's image
    cache (LONG_IMG_S keys, the last 24 frames' masked) and audio cache
    (LONG_AUD_S, the last window masked), cap 50; and the decoding
    variants' reads of the 120 s clip's caches: a verify window of VERIFY_W
    tokens (image and audio caches) and NUM_BEAMS beams folded (image).
    Planted faults: the mask or the cap dropped, the rows folded in the
    wrong order, the window collapsed to its first token. -> (errors,
    cases)."""
    from vidi_tpu_torch.ops.cuda import flash_attention as k1

    errs, cases = [], []
    hq, hk, d = 16, 8, 256
    # (label, rows, query tokens a row, S, valid keys); the serving slice's
    # decoding variants add a verify window (1 row x VERIFY_W tokens) and a
    # beam step (NUM_BEAMS rows x 1 folded) against the 120 s clip's caches
    for label, n_rows, tq, s, n_valid in (
            (f"9b folded prefill 3x{t} vs image cache view S={LONG_IMG_S} mask cap=50",
             3, t, LONG_IMG_S, LONG_IMG_S - 24 * LONG_FRAME_TOKENS),
            (f"9b folded prefill 3x{t} vs audio cache view S={LONG_AUD_S} mask cap=50",
             3, t, LONG_AUD_S, LONG_AUD_S - 300),
            (f"9b folded decode 3x1 vs image cache view S={LONG_IMG_S} mask cap=50",
             3, 1, LONG_IMG_S, LONG_IMG_S - 24 * LONG_FRAME_TOKENS),
            (f"9b folded decode 3x1 vs audio cache view S={LONG_AUD_S} mask cap=50",
             3, 1, LONG_AUD_S, LONG_AUD_S - 300),
            (f"9b verify window 1x{VERIFY_W} vs image cache view S={IMG_S} mask cap=50",
             1, VERIFY_W, IMG_S, IMG_VALID),
            (f"9b verify window 1x{VERIFY_W} vs audio cache view S={AUD_S} mask cap=50",
             1, VERIFY_W, AUD_S, AUD_VALID),
            (f"9b beams {NUM_BEAMS}x1 folded vs image cache view S={IMG_S} mask cap=50",
             NUM_BEAMS, 1, IMG_S, IMG_VALID)):
        cache_k = _randn(gen, (2, 1, hk, s, d), dev)
        cache_v = _randn(gen, (2, 1, hk, s, d), dev)
        rows = _randn(gen, (n_rows, tq, hq, d), dev, Q_GAIN)
        args = dict(q=rows.reshape(1, n_rows * tq, hq, d), k=cache_k[1].transpose(1, 2),
                    v=cache_v[1].transpose(1, 2), kv_mask=_kv_mask(s, n_valid, dev),
                    sm_scale=d**-0.5, causal=False, window=None, softcap=50.0)
        out, lse = k1.flash_attention(**args)
        ref, ref_lse = k1.flash_attention_plain(**args)
        planted = _faults(k1.flash_attention_plain, args, ("mask", "cap"))
        if n_rows > 1:
            planted["rows folded in the wrong order"] = k1.flash_attention_plain(
                **{**args, "q": rows.roll(1, 0).reshape(1, n_rows * tq, hq, d)})[0]
        else:  # the window read as its first token only (a q[:, 0] slip)
            planted["window collapsed to its first token"] = k1.flash_attention_plain(
                **{**args, "q": rows[:, :1].expand(1, tq, hq, d)})[0]
        errs.append(_check(f"K1 {label}", out, ref, planted))
        lse_err = float((lse - ref_lse).abs().max())
        print(f"  K1 {label} lse: max_abs_err={lse_err:.3e} (limit {LSE_ATOL})")
        if not lse_err <= LSE_ATOL:
            raise AssertionError(f"K1 {label}: lse disagrees")
        ms = _time_ms(lambda: k1.flash_attention(**args))
        plain_ms = _time_ms(lambda: k1.flash_attention_plain(**args))
        # as K3's bound: K / V bytes of the visible keys only (a correct
        # kernel need not read a masked key), q, out, lse and the mask whole
        ops = 4 * hq * d * n_rows * tq * n_valid
        small = _nbytes(args["q"], out, lse, args["kv_mask"])
        row = 2 * hk * d * args["k"].element_size()  # K and V bytes of one key
        whole = _bound(ops, small + row * s, "bf16")
        bound = _bound(ops, small + row * n_valid, "bf16")
        call_ms = _call_ms(lambda: k1.flash_attention(**args))
        print(f"  K1 {label}: kernel {ms:.4f} ms (one call from idle {call_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms, bound {whole['bound_ms']:.4f} ms (whole cache) / "
              f"{bound['bound_ms']:.4f} ms ({n_valid} visible keys, {bound['bound_by']}), "
              f"library None ms")
        cases.append({"shape": label, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                      **bound, "bound_whole_ms": whole["bound_ms"], "library_ms": None,
                      **_rate(f"K1 {label}", ops, ms, bound)})
        del cache_k, cache_v, args, out, ref, planted
    e, c = k1_stacked_cases(dev, gen)
    return errs + e, cases + c


def _pair_prompt_len() -> int:
    """Padded length of the daemon's cross-video bundle prompt (run (b):
    QUERIES[0] on clip A, QUERIES[2] on clip B)."""
    from vidi_tpu_torch import ByteTokenizer
    from vidi_tpu_torch.infer import pipeline as P

    tok = ByteTokenizer()
    return P.build_prompt_batch([P.build_prompt_ids(q, tok)
                                 for q in (QUERIES[0], QUERIES[2])])[0].shape[1]


def k1_stacked_cases(dev, gen) -> tuple:
    """K1 on the daemon's cross-video bundle (serve run (b)): two query rows,
    each against its own row of a [L,2,Hk,S,D] cache stacked by
    serve._stack_media (the layer view transposed in place to [2,S,Hk,D]).
    Row 0 is clip A's stream, every key valid; row 1 is clip B's, half as
    long, padded to A's length and masked False past its end. The padded
    keys hold random values, not _stack_media's zeros: against this sharp
    softmax zero keys weigh nothing, and a kernel must ignore them whatever
    they hold. Image (S = IMG_S) and audio (S = AUD_S) caches, cap 50.
    Planted faults: the
    mask or the cap dropped, row 1 reading row 0's mask (its padded slots
    attended), row 1 reading row 0's cache rows. -> (errors, cases)."""
    from vidi_tpu_torch.ops.cuda import flash_attention as k1

    errs, cases = [], []
    hq, hk, d, t = 16, 8, 256, _pair_prompt_len()
    for label, s, n_b in (
            (f"9b stacked 2x{t} vs per-row image caches S={IMG_S}, row 1 valid to "
             f"{IMG_S // 2} cap=50", IMG_S, IMG_S // 2),
            (f"9b stacked 2x{t} vs per-row audio caches S={AUD_S}, row 1 valid to "
             f"{AUD_S // 2} cap=50", AUD_S, AUD_S // 2)):
        cache_k = _randn(gen, (2, 2, hk, s, d), dev)
        cache_v = _randn(gen, (2, 2, hk, s, d), dev)
        mask = torch.ones((2, s), dtype=torch.bool, device=dev)
        mask[1, n_b:] = False
        args = dict(q=_randn(gen, (2, t, hq, d), dev, Q_GAIN), k=cache_k[1].transpose(1, 2),
                    v=cache_v[1].transpose(1, 2), kv_mask=mask, sm_scale=d**-0.5,
                    causal=False, window=None, softcap=50.0)
        out, lse = k1.flash_attention(**args)
        ref, ref_lse = k1.flash_attention_plain(**args)
        planted = _faults(k1.flash_attention_plain, args, ("mask", "cap"))
        row0 = torch.tensor([0, 0], device=dev)
        planted["row 1 reads row 0's mask"] = k1.flash_attention_plain(
            **{**args, "kv_mask": mask[row0]})[0]
        planted["row 1 reads row 0's cache rows"] = k1.flash_attention_plain(
            **{**args, "k": args["k"][row0], "v": args["v"][row0]})[0]
        errs.append(_check(f"K1 {label}", out, ref, planted))
        lse_err = float((lse - ref_lse).abs().max())
        print(f"  K1 {label} lse: max_abs_err={lse_err:.3e} (limit {LSE_ATOL})")
        if not lse_err <= LSE_ATOL:
            raise AssertionError(f"K1 {label}: lse disagrees")
        ms = _time_ms(lambda: k1.flash_attention(**args))
        plain_ms = _time_ms(lambda: k1.flash_attention_plain(**args))
        n_valid = s + n_b  # visible keys over both rows
        ops = 4 * hq * d * t * n_valid
        small = _nbytes(args["q"], out, lse, mask)
        row = 2 * hk * d * args["k"].element_size()  # K and V bytes of one key
        whole = _bound(ops, small + row * 2 * s, "bf16")
        bound = _bound(ops, small + row * n_valid, "bf16")
        call_ms = _call_ms(lambda: k1.flash_attention(**args))
        print(f"  K1 {label}: kernel {ms:.4f} ms (one call from idle {call_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms, bound {whole['bound_ms']:.4f} ms (whole caches) / "
              f"{bound['bound_ms']:.4f} ms ({n_valid} visible keys, {bound['bound_by']}), "
              f"library None ms")
        cases.append({"shape": label, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                      **bound, "bound_whole_ms": whole["bound_ms"], "library_ms": None,
                      **_rate(f"K1 {label}", ops, ms, bound)})
        del cache_k, cache_v, args, out, ref, planted
    return errs, cases


def _k3_hidden(args: dict, ranges) -> dict:
    """K3's arguments with the keys of `ranges` ([lo, hi) pairs) hidden: what
    the kernel computes if it drops them (a split's partial left out of the
    merge, a tile never read)."""
    b, s = args["q"].shape[0], args["k"].shape[2]
    mask = torch.ones((b, s), dtype=torch.bool, device=args["q"].device)
    if args["kv_mask"] is not None:
        mask = args["kv_mask"].clone()
    for lo, hi in ranges:
        mask[:, lo:hi] = False
    return {**args, "kv_mask": mask}


def _k3_faults(k3, args: dict, names, plan) -> dict:
    """The plain K3 with one feature dropped each (`_faults`), plus the
    sm90 schedule's own: the split holding row 0's largest logit dropped
    from the merge (the keys of all its tiles), and the ragged last tile of
    S (keys past its last whole tile) dropped; and for beam rows, each row
    reading the next row's cache."""
    plain = k3.decode_attention_plain
    out = _faults(plain, args, [n for n in names if n not in ("split", "ragged", "rows", "g2")])
    tile, _, n_split = plan
    s = args["k"].shape[2]
    if "split" in names:
        q, k = args["q"].float(), args["k"].float()
        seen = k3.visible_keys(q.shape[0], s, args["kv_mask"], args["window"],
                               args["q_pos"], q.device)
        logits = torch.einsum("d,sd->s", q[0, 0], k[0, 0]).masked_fill(~seen[0], -math.inf)
        split = int(logits.argmax()) // tile % n_split
        out[f"split {split} dropped from the merge"] = plain(**_k3_hidden(
            args, [(t * tile, (t + 1) * tile) for t in k3.split_tiles(split, s, plan)]))
    if "ragged" in names:
        out[f"ragged tile {s // tile * tile}..{s} dropped"] = plain(
            **_k3_hidden(args, [(s // tile * tile, s)]))
    if "rows" in names:  # beam rows: each row must read its own cache row
        out["rows read the next row's cache"] = plain(
            **{**args, "k": args["k"].roll(1, 0), "v": args["v"].roll(1, 0)})
    if "g2" in names:  # Gemma2's grouping on a G = 4 cache
        out["G = 2 grouping (head h reads KV head h // 2)"] = plain(
            **{**args, **_g2_grouping(args["q"], args["k"], args["v"])})
    return out


def _g2_grouping(q, k, v) -> dict:
    """k / v [B,Hk,S,D] spread to one KV head a query head, query head h
    reading KV head (h // 2) % Hk: a kernel that kept G = 2's grouping,
    as a G = 1 call."""
    heads = (torch.arange(q.shape[1], device=k.device) // 2) % k.shape[1]
    return {"k": k[:, heads], "v": v[:, heads]}


def _k3_sdpa(q, k, v, scale, kv_mask):
    """SDPA for one decode token (q [B,Hq,1,D], a [B,1,1,S] bool mask, the
    GQA heads shared): K3's capless function, the yardstick the port never
    calls."""
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=kv_mask[:, None, None, :], scale=scale,
        enable_gqa=True)[:, :, 0]


def k3_phase(dev, t: int, n_real: int) -> dict:
    """K3 against its plain version for one decode step against a
    [L,B,Hk,S,D] cache's layer view: the 9B's image and audio caches
    (global), its text cache grown by 32 decode slots (window 4096 on
    sliding layers), a binding window, a capless image case timed against
    SDPA, the 1.5B's image cache, a B = 2 ragged case whose second row sees
    no key (bit-zero) and an fp32 case on the SIMT route; Vidi-7B's caches
    (G = 4, D = 128, no cap: image, audio, text through q_pos, a B = 2
    case with an empty row, an fp32 case on the SIMT route; each with
    Gemma2's G = 2 grouping as a planted fault) and a small case each at
    G = 1 and G = 8. Capless cases are timed against SDPA. Each bf16 case
    runs twice (bit-equal), prints the events time of 20 calls back to back
    and the profiler's device time a call, and two bounds: the whole
    cache's bytes and the visible keys' (what a correct kernel must read;
    the share is taken against it)."""
    from vidi_tpu_torch.ops.cuda import _lib
    from vidi_tpu_torch.ops.cuda import decode_attention as k3

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    sms = _lib.sm_count(dev)
    n7, t7 = _prompt_lengths("v1")
    errs, cases = [], []
    # (label, b, hq, hk, d, s, n_valid, window, q_pos, cap, q gain, faults, dtype)
    for label, b, hq, hk, d, s, n_valid, window, q_pos, cap, gain, faults, dtype in (
            (f"9b image cache S={IMG_S} global", 1, 16, 8, 256, IMG_S, IMG_VALID,
             None, None, 50.0, Q_GAIN, ("mask", "cap", "split"), torch.bfloat16),
            (f"9b image cache S={IMG_S} window=4096", 1, 16, 8, 256, IMG_S,
             IMG_S - 301, 4096, IMG_S - 302, 50.0, Q_GAIN, ("window", "cap", "split"),
             torch.bfloat16),
            (f"9b image cache S={IMG_S} no cap", 1, 16, 8, 256, IMG_S, IMG_VALID,
             None, None, None, Q_GAIN, ("mask", "cap", "split"), torch.bfloat16),
            (f"9b audio cache S={AUD_S} global", 1, 16, 8, 256, AUD_S, AUD_VALID,
             None, None, 50.0, Q_GAIN, ("mask", "cap", "split"), torch.bfloat16),
            (f"9b text cache S={t + 32} window=4096", 1, 16, 8, 256, t + 32,
             n_real + 6, 4096, n_real + 5, 50.0, Q_GAIN, ("mask", "cap", "split"),
             torch.bfloat16),
            # beam search: NUM_BEAMS beam rows of one query's text cache
            (f"9b beam rows B={NUM_BEAMS} text cache S={t + 32} window=4096", NUM_BEAMS, 16,
             8, 256, t + 32, n_real + 6, 4096, n_real + 5, 50.0, Q_GAIN,
             ("mask", "cap", "split", "rows"), torch.bfloat16),
            # the 600 s clip's image cache, every key visible as in its slice
            (f"9b image cache S={LONG_IMG_S} global (600 s)", 1, 16, 8, 256, LONG_IMG_S,
             LONG_IMG_S, None, None, 50.0, Q_GAIN, ("cap", "split"), torch.bfloat16),
            (f"1.5b image cache S={IMG_S} global", 1, 12, 6, 128, IMG_S, IMG_VALID,
             None, None, 50.0, Q_GAIN, ("mask", "cap", "split"), torch.bfloat16),
            # q unscaled: a flat softmax, so every dropped key moves the output
            ("9b B=2 S=1000 ragged, row 1 sees no key", 2, 16, 8, 256, 1000, None,
             None, None, 50.0, 1.0, ("mask", "split", "ragged"), torch.bfloat16),
            (f"fp32 9b audio cache S={AUD_S} global (SIMT route)", 1, 16, 8, 256, AUD_S,
             AUD_VALID, None, None, 50.0, Q_GAIN, ("mask", "cap"), torch.float32),
            # Vidi-7B: 32 query / 8 KV heads of 128 (G = 4), no softcap,
            # every layer sliding at 4096
            (f"7b image cache S={IMG7_S} mask", 1, 32, 8, 128, IMG7_S, IMG7_VALID, None,
             None, None, Q_GAIN, K3_7B_FAULTS, torch.bfloat16),
            (f"7b audio cache S={AUD_S} mask", 1, 32, 8, 128, AUD_S, AUD_VALID, None, None,
             None, Q_GAIN, K3_7B_FAULTS, torch.bfloat16),
            (f"7b text cache S={t7 + 32} window=4096", 1, 32, 8, 128, t7 + 32, n7 + 6, 4096,
             n7 + 5, None, Q_GAIN, K3_7B_FAULTS, torch.bfloat16),
            ("7b B=2 S=1000 ragged, row 1 sees no key", 2, 32, 8, 128, 1000, None, None,
             None, None, 1.0, ("mask", "split", "ragged", "g2"), torch.bfloat16),
            (f"fp32 7b audio cache S={AUD_S} mask (SIMT route)", 1, 32, 8, 128, AUD_S,
             AUD_VALID, None, None, None, Q_GAIN, ("mask", "cap", "g2"), torch.float32),
            ("G=1 S=1000 D=256 cap=50", 1, 8, 8, 256, 1000, 900, None, None, 50.0, Q_GAIN,
             ("mask", "cap", "split"), torch.bfloat16),
            # q unscaled and a short window: the few keys of each fault move
            # a flat softmax over 64 keys
            ("G=8 S=1000 D=128 window=64", 1, 16, 2, 128, 1000, 995, 64, 994, None,
             1.0, ("mask", "window", "split", "ragged"), torch.bfloat16)):
        cache_k = _randn(gen, (2, b, hk, s, d), dev, dtype=dtype)
        cache_v = _randn(gen, (2, b, hk, s, d), dev, dtype=dtype)
        if n_valid is None:  # row 0 sees every key, row 1 none
            mask = torch.zeros((b, s), dtype=torch.bool, device=dev)
            mask[0] = True
        else:
            mask = _kv_mask(s, n_valid, dev).expand(b, s).contiguous()
        if q_pos is not None:
            q_pos = torch.full((b,), q_pos, dtype=torch.int64, device=dev)
        args = dict(q=_randn(gen, (b, hq, d), dev, gain, dtype), k=cache_k[1],
                    v=cache_v[1], kv_mask=mask, sm_scale=d**-0.5, softcap=cap,
                    window=window, q_pos=q_pos)
        plan = k3.decode_plan(b, hk, s, d, sms, g=hq // hk)
        run = lambda: k3.decode_attention(**args)  # noqa: E731
        out, again = run(), run()
        ref = k3.decode_attention_plain(**args)
        errs.append(_check(f"K3 {label}", out, ref, _k3_faults(k3, args, faults, plan)))
        twice = torch.equal(out, again)
        split = f", plan (tile, chunk, n_split) = {plan}" if dtype == torch.bfloat16 else ""
        print(f"  K3 {label}: {k3.route(dtype)}{split}; two runs "
              f"{'bit-equal' if twice else 'DIFFER'}")
        if dtype == torch.bfloat16 and not twice:
            raise AssertionError(f"K3 {label}: two runs differ")
        if n_valid is None and (out[1] != 0).any():
            raise AssertionError(f"K3 {label}: the row with no visible key is not zero")
        ms = _time_ms(run)
        plain_ms = _time_ms(lambda: k3.decode_attention_plain(**args))
        device_ms, host_ms = _device_us(run) / 1e3, _host_us(run) / 1e3
        seen = k3.visible_keys(b, s, mask, window, q_pos, dev)
        n_seen = int(seen.sum())
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        row = 2 * hk * d * args["k"].element_size()  # K and V bytes of one key
        small = _nbytes(args["q"], out, mask)
        whole = _bound(4 * hq * d * n_seen, small + row * b * s, kind)
        bound = _bound(4 * hq * d * n_seen, small + row * n_seen, kind)
        lib_ms = None
        if cap is None:  # one PyTorch call computes the capless function
            lib_ms = _time_ms(lambda: _k3_sdpa(args["q"], args["k"], args["v"],
                                               d**-0.5, seen))
        print(f"  K3 {label}: events {ms:.4f} ms, device {device_ms:.4f} ms a call, host "
              f"{host_ms:.4f} ms a call, "
              f"plain {plain_ms:.4f} ms, bound {whole['bound_ms']:.4f} ms (whole cache) / "
              f"{bound['bound_ms']:.4f} ms ({n_seen} visible keys, {bound['bound_by']}), "
              f"{bound['bound_ms'] / device_ms:.3f} of the visible bound on device time, "
              f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms")
        cases.append({"shape": label, "ms": ms, "device_ms": device_ms, "host_ms": host_ms,
                      "plain_ms": plain_ms,
                      **bound, "bound_whole_ms": whole["bound_ms"], "library_ms": lib_ms,
                      "plan": plan, "bound_share_device": bound["bound_ms"] / device_ms})
    return {"decode_attention": dict(
        src=K3_SRC, replaces="vidi_tpu/ops/pallas/decode_attention.py:80",
        max_abs_err=max(errs), cases=cases, **_times(cases, "9b image cache"))}


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
        "row0": ("every row read with row 0's kv_mask and segment ids",
                 lambda: plain(**{**args, **_row0(args)})),
        "kv_row0": ("every row read with row 0's keys and values",
                    lambda: plain(**{**args, "k": args["k"][:1].expand_as(args["k"]),
                                     "v": args["v"][:1].expand_as(args["v"])})),
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
    through one call with enable_gqa and the keys each row sees as its
    mask: the kv_mask, or the visible pairs of a causal or packed case) on
    the case's inputs: the one library call that computes K4's function
    when there is no cap and every row sees a key. The port never calls it."""
    from vidi_tpu_torch.ops.cuda.flash_attention import visible_mask

    q, k, v = (args[n].detach().transpose(1, 2).requires_grad_(True) for n in ("q", "k", "v"))
    if args["causal"] or args["q_segs"] is not None:
        mask = visible_mask(q.shape[0], q.shape[2], k.shape[2], args["kv_mask"],
                            args["causal"], args["window"], args["q_segs"],
                            args["kv_segs"], q.device)[:, None]
    else:
        mask = args["kv_mask"][:, None, None, :]
    out = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=args["sm_scale"], enable_gqa=True)
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
    packed = _segments(dev, t, (90, 80, n_valid - 170))
    packed4k = _segments(dev, PACK_T, PACK_SEGS)
    pack_segs, pack_valid = _pack_layout(dev)
    img_valid = [SIGLIP_T * (1 + gw * gh) for gw, gh in IMAGE_GRIDS]
    img_s = max(img_valid)
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
             None, 50.0, AUD_VALID, None, ("mask", "di", "cap"), f32),
            # Vidi-7B training (train_7b): 32 query / 8 KV heads of 128 (G = 4),
            # no softcap; 120 frames at 224 px -> 7,680 image keys
            (f"7b t2t T=S={t} causal window=4096", 32, 8, 128, t, True, 4096, None,
             n_valid, None, ("causal", "di", "gqa", "band"), bf16),
            (f"7b t2v T={t} S={IMG7_S} mask", 32, 8, 128, IMG7_S, False, None, None,
             IMG7_VALID, None, ("mask", "di", "gqa", "split"), bf16),
            (f"7b t2a T={t} S={AUD_S} mask", 32, 8, 128, AUD_S, False, None, None,
             AUD_VALID, None, ("mask", "di", "gqa", "split"), bf16),
            # --pack rows (train_pack): three segments in 4,096 tokens, and the
            # phase's own two rows with their per-row segment ids
            (f"9b packed t2t T=S={PACK_T} {len(PACK_SEGS)} segments cap=50", 16, 8, 256,
             PACK_T, True, 4096, 50.0, sum(PACK_SEGS), packed4k,
             ("segs", "di", "cap", "band"), bf16),
            (f"9b packed t2t B=2 T=S={PACK_T} train_pack's rows cap=50", 16, 8, 256,
             PACK_T, True, 4096, 50.0, pack_valid, pack_segs,
             ("segs", "di", "cap", "band", "row0", "kv_row0", "split"), bf16),
            # image mode (train_image): B = 2 anyres rows against their tiles'
            # tokens, per-row masks (the (1, 3) sample's pad tile masked)
            (f"9b image t2v B=2 T={t} S={img_s} per-row mask cap=50", 16, 8, 256, img_s,
             False, None, 50.0, img_valid, None,
             ("mask", "di", "cap", "gqa", "split", "row0", "kv_row0"), bf16)):
        per_row = n_keys if isinstance(n_keys, list) else [n_keys]
        b = len(per_row)
        tq = s if causal else t  # a T2T case's rows are its keys
        q = _randn(gen, (b, tq, hq, d), dev, Q_GAIN, dtype)
        k = _randn(gen, (b, s, hk, d), dev, dtype=dtype)
        v = _randn(gen, (b, s, hk, d), dev, dtype=dtype)
        kv_mask = torch.cat([_kv_mask(s, n, dev) for n in per_row])
        fwd = dict(sm_scale=d**-0.5, causal=causal, window=window, softcap=cap,
                   q_segs=segs, kv_segs=segs)
        out, lse = k1.flash_attention(q, k, v, kv_mask, **fwd)
        do = _randn(gen, (b, tq, hq, d), dev, dtype=dtype)
        for i, n in enumerate(per_row):
            do[i, n if causal else tq:] = 0  # T2T rows past the prompt are padding
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
        pairs = int(k1.visible_mask(b, tq, s, kv_mask, causal, window, segs, segs,
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


def _sched_faults(plan, plain) -> dict:
    """The outputs of two wrong persistent schedules (csrc/int8_gemm_pp.cuh),
    made from the plain output by the schedule's plan (`tower_plan`): one
    consumer skips a tile (block 0's second consumer's first, or block 0's
    first: its place keeps zeros), or a tile is computed twice, the second
    time into the place of that skipped one."""
    from vidi_tpu_torch.ops.cuda import fused_tower_layer as k5

    t0 = (plan.consumer_tiles(0, 1) or plan.consumer_tiles(0, 0))[0]
    t1 = next(t for b in range(1, plan.blocks) for t in plan.block_tiles(b)
              if t != t0 and t[1] < plan.m)

    def mats():
        out = plain()
        return [o.reshape(-1, o.shape[-1]).clone()
                for o in (out if isinstance(out, tuple) else (out,))]

    def region(t):
        z, m0, n0 = t
        return z, slice(m0, m0 + k5.PP_TILE_M), slice(n0, n0 + k5.PP_TILE_N)

    def skipped():
        bad = mats()
        z, r, c = region(t0)
        bad[z][r, c] = 0
        return tuple(bad)

    def twice():
        bad = mats()
        (z, r, c), (zs, rs, cs) = region(t0), region(t1)
        dst, src = bad[z][r, c], bad[zs][rs, cs].clone()
        h, w = min(dst.shape[0], src.shape[0]), min(dst.shape[1], src.shape[1])
        dst[:h, :w] = src[:h, :w]
        return tuple(bad)

    return {"scheduler skips a tile": skipped,
            "a tile computed twice, into another's place": twice}


def _ptxas_start(source: str = "fused_tower_layer.cu"):
    """nvcc -Xptxas -v of one kernel source (K5's by default), started
    beside the library's build; `_ptxas_report` reads it."""
    from vidi_tpu_torch.ops.cuda import _lib

    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = _lib.BUILD_DIR / f"ptxas-probe.{os.getpid()}.{source}.o"
    return obj, subprocess.Popen(
        [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
         str(_lib.CSRC / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _ptxas_report(probe, fn: str = "int8_gemm_pp_sm90") -> dict:
    """Registers and spill bytes ptxas reports for each instantiation of
    `fn` (mangled template arguments -> (registers, spill stores, spill
    loads)), and its warnings about them, printed."""
    import re

    obj, proc = probe
    text = proc.communicate()[0]
    obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise AssertionError(f"nvcc -Xptxas -v failed:\n{text}")
    res, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            cur = m.group(1) if fn in m.group(1) else None
        if cur is None:
            continue
        args = re.search(fn + r"I(.+?)EEv", cur)
        key = args.group(1) if args else cur
        if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            res.setdefault(key, [None, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        if (m := re.search(r"Used (\d+) registers", line)):
            res.setdefault(key, [None, 0, 0])[0] = int(m.group(1))
        if "warning" in line.lower():
            print(f"  ptxas: {line.strip()}")
    for key, (regs, st, ld) in res.items():
        print(f"  ptxas -v {fn}<{key}>: {regs} registers, {st} bytes spill stores, "
              f"{ld} bytes spill loads")
    if not res:
        raise AssertionError(f"ptxas reported no instantiation of {fn}")
    return {k: tuple(v) for k, v in res.items()}


def _k5_int_mm_ms(x, ws) -> tuple:
    """torch._int_mm over the int8 codes of x and each weight of `ws` in
    turn (the products alone; a yardstick the port never calls)."""
    from vidi_tpu_torch.infer import quantize as qz

    xq = qz.quantize_act(x.reshape(-1, x.shape[-1]))[0]
    mats = [(xq, w["qi8"]) if w["qi8"].shape[0] == xq.shape[1] else
            (torch.zeros((xq.shape[0], w["qi8"].shape[0]), dtype=torch.int8,
                         device=x.device), w["qi8"]) for w in ws]
    try:
        for a, w in mats:
            torch._int_mm(a, w)
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return _time_ms(lambda: [torch._int_mm(a, w) for a, w in mats]), None


def k5_phase(dev, probe=None) -> dict:
    """K5's three pieces at SigLIP-so400m's encode chunk (4 frames x 729
    patches, d 1152, ff 4304 padded to 4352, gelu_tanh, eps 1e-6) and
    Whisper-large-v3's window (1500 x 1280, ff 5120, exact gelu, eps 1e-5,
    no k bias) against their plain versions, with planted faults (among
    them two wrong persistent schedules); each case's device time a call,
    the persistent GEMM's blocks against the card's SMs, torch._int_mm for
    the products alone, and ptxas's registers and spills (`probe`)."""
    from vidi_tpu_torch.ops.cuda import _lib
    from vidi_tpu_torch.ops.cuda import fused_tower_layer as k5

    if probe is not None:
        _ptxas_report(probe)
    sms = _lib.sm_count(dev)
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
        plans = k5.piece_plans(m, d, ffp, sms)
        print(f"  K5 {label.split()[0]}: persistent GEMM on {sms} SMs: " + "; ".join(
            f"{n} {p.total} tiles of {k5.PP_TILE_M} x {k5.PP_TILE_N} ({p.n_mats} x "
            f"{p.tiles_m} x {p.tiles_n}), {p.steps} k-steps, {p.blocks} blocks "
            f"({p.total / p.blocks:.2f} tiles a block, {p.blocks / sms:.2f} of the SMs)"
            for n, p in plans.items()))
        no_bias = {k: torch.zeros_like(v) if k.endswith("_b") else v for k, v in lp.items()}
        per_tensor = lambda f: lambda: _with(k5, quantize_act=_per_tensor_act)(f)  # noqa: E731

        qkv_w = [lp[k] for k in ("q_w", "k_w", "v_w")]
        qkv_plain = lambda: k5.ln_qkv_plain(x, lp, eps)  # noqa: E731
        cases = [("ln_qkv", _int8_case(
            f"K5 ln_qkv {label}", lambda: k5.ln_qkv(x, lp, eps), qkv_plain,
            {"per-tensor scale": per_tensor(qkv_plain),
             "bias dropped": lambda: k5.ln_qkv_plain(x, no_bias, eps),
             **_sched_faults(plans["qkv"], qkv_plain)},
            3 * 2 * m * d * d, _nbytes(x, x, x, x) + sum(_qbytes(w) for w in qkv_w)),
            lambda: k5.ln_qkv(x, lp, eps), (x, qkv_w))]
        o_plain = lambda: k5.o_residual_plain(attn, x, lp)  # noqa: E731
        cases.append(("o_residual", _int8_case(
            f"K5 o_residual {label}", lambda: k5.o_residual(attn, x, lp), o_plain,
            {"per-tensor scale": per_tensor(o_plain),
             "bias dropped": lambda: k5.o_residual_plain(attn, x, no_bias),
             "residual dropped": lambda: k5.o_residual_plain(attn, torch.zeros_like(x), lp),
             **_sched_faults(plans["o"], o_plain)},
            2 * m * d * d, _nbytes(attn, x, x) + _qbytes(lp["o_w"])),
            lambda: k5.o_residual(attn, x, lp), (attn, [lp["o_w"]])))
        ffn_plain = lambda: k5.ln_ffn_plain(x, lp, eps, act)  # noqa: E731
        faults = {"per-tensor scale": per_tensor(ffn_plain),
                  "no requantize of the FFN hidden":
                      lambda: _ffn_no_requant(x, lp, eps, act),
                  "bias dropped": lambda: k5.ln_ffn_plain(x, no_bias, eps, act),
                  "residual dropped": lambda: k5.ln_ffn_plain(x, lp, eps, act) - x,
                  **_sched_faults(plans["fc2"], ffn_plain)}
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
        cases.append(("ln_ffn", _int8_case(
            f"K5 ln_ffn {label}", lambda: k5.ln_ffn(x, lp, eps, act), ffn_plain, faults,
            2 * 2 * m * d * ffp, _nbytes(x, x) + _qbytes(lp["fc1_w"]) + _qbytes(lp["fc2_w"])),
            lambda: k5.ln_ffn(x, lp, eps, act), (x, [lp["fc1_w"], lp["fc2_w"]])))
        for n, case, run, (x_in, ws) in cases:
            case["device_ms"] = _device_us(run) / 1e3
            case["int_mm_ms"], why = _k5_int_mm_ms(x_in, ws)
            case["device_bound_share"] = case["bound_ms"] / case["device_ms"]
            print(f"  K5 {n} {label.split()[0]}: device {case['device_ms']:.4f} ms a call "
                  f"({case['device_bound_share']:.3f} of the bound); torch._int_mm "
                  f"(products only) "
                  + (f"{case['int_mm_ms']:.4f} ms" if why is None else f"none ({why})"))
            res[n]["cases"].append(case)
        del lp, cases
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
    kernel times summed over `reps` calls, over `reps`. A profiler session
    that records no kernel at all (seen once in a plain run on an H100,
    after several sessions in one process) is taken again, up to three
    sessions; then the run fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type.name == "CUDA") / reps
        if us > 0:
            return us
    raise AssertionError("torch.profiler recorded no kernel in three sessions")


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
    calls it); kv_mask [B,S] or the visible pairs [B,T,S]."""
    mask = None if kv_mask is None else (
        kv_mask[:, None, None, :] if kv_mask.dim() == 2 else kv_mask[:, None])
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


def _small_config_7b():
    """A few-layer Vidi-7B whose kernel shapes are the 7B's: Mistral with 8
    query / 2 KV heads of 128 (G = 4, every layer sliding at 16 keys, so
    the window binds), CLIP with a class token (17 tokens, heads of 64),
    the v1 adapters, Whisper heads of 64."""
    import dataclasses

    from vidi_tpu_torch import AudioConfig, DattnConfig, TextConfig, VisionConfig
    return dataclasses.replace(
        DattnConfig.tiny("mistral"),
        text=dataclasses.replace(TextConfig.tiny("mistral"), hidden_size=256, num_heads=8,
                                 num_kv_heads=2, head_dim=128, num_layers=2),
        vision=dataclasses.replace(VisionConfig.tiny("clip"), hidden_size=128,
                                   num_heads=2, image_size=56),
        audio=dataclasses.replace(AudioConfig.tiny(), d_model=128, num_heads=2))


def reference_check(dev) -> None:
    """End to end at a small size in fp32: the port on the card (kernels)
    against the port on the CPU (plain PyTorch, the parity-tested path),
    same weights and inputs, for the 9B's shape (`_small_config`) and the
    7B's (`_small_config_7b`). Tokens must be identical; prefill hidden
    states within atol = rtol = 1e-3 (fp32, different summation orders)."""
    for shape, cfg in (("9b", _small_config()), ("7b", _small_config_7b())):
        _reference_check(dev, shape, cfg)


def _reference_check(dev, shape: str, cfg) -> None:
    from vidi_tpu_torch.infer import generate as gen
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.models import dattn

    params = dattn.init_params(cfg, torch.float32, torch.device("cpu"), SEED)
    to_dev = lambda t: t.to(dev)  # noqa: E731
    gparams = _tree_map(to_dev, params)
    rng = np.random.default_rng(SEED)
    size = cfg.vision.image_size
    frames = rng.integers(0, 256, (6, size, size, 3), dtype=np.uint8)
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
    print(f"  small fp32 model ({shape}'s shape), card (kernels) vs cpu (plain): hidden "
          f"max_abs_err={err:.3e} (atol=rtol=1e-3) {'ok' if ok else 'FAIL'}; tokens "
          f"{'identical' if same else 'DIFFER'}: {outs['cuda'][1].tolist()}")
    if not (ok and same):
        raise AssertionError(f"small-model reference check ({shape}) failed")


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

    prompt, mask = P.build_prompt_batch([P.build_prompt_ids(
        query, sl.tok, sl.cfg.mm_version, sl.seconds)])
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


def _kernel_counts() -> dict:
    from vidi_tpu_torch.ops.cuda import decode_attention as k3
    from vidi_tpu_torch.ops.cuda import flash_attention as k1
    from vidi_tpu_torch.ops.cuda import tower_attention as k2
    return {"flash_attention": k1.launches, "tower_attention": k2.launches,
            "decode_attention": k3.launches}


def _reset_kernel_counts() -> None:
    from vidi_tpu_torch.ops.cuda import decode_attention as k3
    from vidi_tpu_torch.ops.cuda import flash_attention as k1
    from vidi_tpu_torch.ops.cuda import tower_attention as k2
    k1.launches = k2.launches = k3.launches = 0


def slice_phase(sl) -> dict:
    """One media encode, three TR queries on the default decode route, one
    on the K3 route, with every kernel's launch count read around them."""
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.infer.generate import generate

    cfg, tok, dev, seconds = sl.cfg, sl.tok, sl.dev, sl.seconds
    eos = P.pick_eos(cfg, tok)

    _reset_kernel_counts()
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
    launches = _kernel_counts()
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


def profile_decoding(sl) -> None:
    """torch.profiler over PROFILE_DECODE_STEPS verify passes of VERIFY_W
    tokens (K1 route) and as many beam steps of NUM_BEAMS beams (K3 for the
    beam rows' T2T, K1 folded for the image / audio reads, the caches
    gathered by parent) on one prefill's caches (see `_region`)."""
    from vidi_tpu_torch.infer import generate as gen
    from vidi_tpu_torch.models import dattn

    _, caches, lens, emb = _prefill(sl, QUERIES[0])
    window = emb.expand(1, VERIFY_W, -1)

    def verify():
        for _ in range(PROFILE_DECODE_STEPS):
            out = dattn.verify_step(sl.params, sl.cfg, window, lens, caches,
                                    img_mask=sl.media[1], aud_mask=sl.media[3],
                                    use_flash=True)[0]
        return out

    _region(f"verify pass ({VERIFY_W} tokens, K1 route) x{PROFILE_DECODE_STEPS}", verify)
    beams = caches._replace(text_k=caches.text_k.repeat_interleave(NUM_BEAMS, dim=1),
                            text_v=caches.text_v.repeat_interleave(NUM_BEAMS, dim=1))
    spare = (torch.empty_like(beams.text_k), torch.empty_like(beams.text_v))
    parent = torch.arange(NUM_BEAMS, device=sl.dev).roll(1)
    tok = emb.expand(NUM_BEAMS, 1, -1)

    def steps():
        nonlocal beams, spare
        cur = lens.repeat_interleave(NUM_BEAMS)
        for _ in range(PROFILE_DECODE_STEPS):
            logits, beams = dattn.decode_step(sl.params, sl.cfg, tok, cur, beams,
                                              img_mask=sl.media[1], aud_mask=sl.media[3],
                                              use_flash=True)
            gen._top(torch.log_softmax(logits.float(), dim=-1).reshape(1, -1), NUM_BEAMS)
            beams, spare = gen._reorder(beams, spare, parent)
            cur = cur + 1
        return logits

    _region(f"beam step ({NUM_BEAMS} beams, K3 + folded K1) x{PROFILE_DECODE_STEPS}", steps)


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


def _k3_without_mask(real):
    return lambda q, k, v, kv_mask, *a, **kw: real(q, k, v, None, *a, **kw)


def _k3_g2(real):
    """K3 reading a G = 4 cache with Gemma2's grouping (`_g2_grouping`)."""
    def run(q, k, v, *a, **kw):
        kv = _g2_grouping(q, k, v)
        return real(q, kv["k"], kv["v"], *a, **kw)
    return run


K3_RANGE = "chip_smoke: K3 call"


def _profiled_k3_calls(run) -> tuple:
    """Runs `run()` under the profiler with each K3 call inside a range of
    its own, and reads for each range the kernel launch calls the host
    recorded in it (on its thread, within its time, made by no torch op)
    and the kernels the device recorded for them (by the launch call's
    correlation id).
    -> (run's result, K3 calls by decode_attention.launches,
        [(launch call names, kernel names)] one entry a range)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from vidi_tpu_torch.ops.cuda import decode_attention as k3

    real = k3.decode_attention

    def ranged(*a, **kw):
        with record_function(K3_RANGE):
            return real(*a, **kw)

    before = k3.launches
    k3.decode_attention = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = run()
            torch.cuda.synchronize()
    finally:
        k3.decode_attention = real
    calls = k3.launches - before
    events = prof.profiler.kineto_results.events()
    kernels = {}
    for e in events:
        if e.device_type().name == "CUDA":
            kernels.setdefault(e.correlation_id(), []).append(e.name())
    # direct launch calls: a torch op's launches are linked to the op
    launches = [(e.start_ns(), e.end_ns(), e.start_thread_id(), e.correlation_id(), e.name())
                for e in events if e.device_type().name == "CPU"
                and "LaunchKernel" in e.name() and not e.linked_correlation_id()]
    per_call = []
    for r in (e for e in events if e.name() == K3_RANGE and e.device_type().name == "CPU"):
        inside = [x for x in launches if r.start_ns() <= x[0] and x[1] <= r.end_ns()
                  and x[2] == r.start_thread_id()]
        per_call.append(([x[4] for x in inside],
                         [n for x in inside for n in kernels.get(x[3], [])]))
    return out, calls, per_call


def _k3_launch_reading(calls: int, per_call) -> dict:
    """What a profiled K3 run shows: calls whose one launch call gave one
    sm90 kernel, calls with no launch call, calls whose launch call has no
    kernel record (the trace lost it), and any other kernel names."""
    sm90 = sum(len(lc) == 1 and len(kn) == 1 and "decode_attention_sm90" in kn[0]
               for lc, kn in per_call)
    return {"calls": calls, "ranges": len(per_call), "one sm90 kernel": sm90,
            "no launch call": sum(not lc for lc, _ in per_call),
            "kernel record lost": sum(bool(lc) and not kn for lc, kn in per_call),
            "other kernels": sorted({n[:60] for _, kn in per_call for n in kn
                                     if "decode_attention_sm90" not in n})}


def decode_route_check(sl, fault=("K3 without kv_mask", _k3_without_mask)) -> None:
    """The K3 route's step-0 logits against the default route's on one
    prefill; a planted fault (`fault`: its label and a wrapper of the real
    K3; by default K3 without its kv_mask) must fail the limits."""
    from vidi_tpu_torch.ops.cuda import decode_attention as k3

    _, caches, lens, emb = _prefill(sl, QUERIES[0])
    plain = _decode_step(sl, emb, lens, caches, False)
    # Each K3 call of one decode step must be one launch call and one
    # decode_attention_sm90 kernel. The session is taken again only when
    # the trace lost a kernel record whose launch call it holds; a call
    # with no launch call fails.
    for attempt in range(3):
        step, calls, per_call = _profiled_k3_calls(
            lambda: _decode_step(sl, emb, lens, caches, True))
        seen = _k3_launch_reading(calls, per_call)
        print(f"  K3 route, one decode step (try {attempt + 1}): {seen}")
        if not seen["kernel record lost"]:
            break
    if not calls or seen["ranges"] != calls or seen["one sm90 kernel"] != calls:
        raise AssertionError("a K3 call on the bf16 decode route must be one sm90 kernel")
    real = k3.decode_attention
    k3.decode_attention = lambda q, *a, **kw: torch.empty_like(q)
    try:
        _, _, per_call = _profiled_k3_calls(lambda: _decode_step(sl, emb, lens, caches, True))
    finally:
        k3.decode_attention = real
    unlaunched = _k3_launch_reading(0, per_call)
    print(f"  planted fault, K3 returning without a launch: {unlaunched}")
    if unlaunched["no launch call"] != seen["ranges"]:
        raise AssertionError("the launch reading does not see K3 calls that launch nothing")
    readings = {"K3 route": _logit_gap(step, plain)}
    planted = f"planted fault, {fault[0]}"
    k3.decode_attention = fault[1](real)
    try:
        readings[planted] = _logit_gap(_decode_step(sl, emb, lens, caches, True), plain)
    finally:
        k3.decode_attention = real
    for name, (rel, cos) in readings.items():
        print(f"  decode step 0 logits, {name} vs plain route: max_abs_err = "
              f"{rel:.3e} of max|logit| (limit {LOGIT_REL}), cosine {cos:.6f} "
              f"(limit {LOGIT_COS})")
    passes = {n: rel <= LOGIT_REL and cos >= LOGIT_COS for n, (rel, cos) in readings.items()}
    if not passes["K3 route"]:
        raise AssertionError("decode routes disagree on the step-0 logits")
    if passes[planted]:
        raise AssertionError("the step-0 logit limits do not reject the planted fault")


# ---------------------------------------------------------------------------
# The decoding variants: verify_step, speculative decoding, beams, sampling
# ---------------------------------------------------------------------------

class _LogitLog:
    """Records, for each lm_logits call inside a `with` block (a prefill's
    last-token logits, then one call a decode step), each row's fp32 top-2
    gap and the logit limit LOGIT_REL * max|logit|: where the gap exceeds
    the limit, the routes' differences cannot flip the greedy choice."""

    def __init__(self):
        from vidi_tpu_torch.models import decoder
        self.decoder, self.real = decoder, decoder.lm_logits
        self.gaps, self.limits = [], []

    def __enter__(self):
        def lm_logits(*a, **kw):
            out = self.real(*a, **kw)
            top = out.float().topk(2, dim=-1).values
            self.gaps.append((top[..., 0] - top[..., 1]).reshape(-1).cpu())
            self.limits.append(LOGIT_REL * out.float().abs().amax(dim=-1).reshape(-1).cpu())
            return out
        self.decoder.lm_logits = lm_logits
        return self

    def __exit__(self, *exc):
        self.decoder.lm_logits = self.real


def _first_difference(got, want):
    """Index of the first token where two [L] rows differ, or None."""
    diff = (got.cpu() != want.cpu()).nonzero()
    return int(diff[0]) if len(diff) else None


def _near_tie_rule(label: str, got, greedy, log: _LogitLog) -> None:
    """Tokens [B,N] against greedy's: equal, or first different at a step
    whose greedy top-2 gap is within the logit limit (printed); a first
    difference at a clear choice fails."""
    for r in range(greedy.shape[0]):
        i = _first_difference(got[r], greedy[r])
        if i is None:
            continue
        gap, limit = float(log.gaps[i][r]), float(log.limits[i][r])
        print(f"  {label}: row {r} first differs from greedy at token {i}, greedy's top-2 "
              f"gap {gap:.4f} vs the logit limit {limit:.4f}: "
              f"{'a near tie' if gap <= limit else 'FAIL'}")
        if gap > limit:
            raise AssertionError(f"{label}: row {r} leaves greedy at token {i}, "
                                 f"a clear choice")


def _held(label: str, run: dict, want: dict) -> None:
    """Launch counts of one run against the ones reckoned from the code."""
    got = {k: run[k] for k in want}
    print(f"  {label}: launches K1 {run['flash_attention']}, K3 {run['decode_attention']} "
          f"(reckoned K1 {want['flash_attention']}, K3 {want['decode_attention']})")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, reckoned {want}")


def _counted(fn):
    """(fn's result, K1 / K2 / K3 launches during it)."""
    before = _kernel_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in _kernel_counts().items()}


def _add(total: dict, *runs: dict) -> dict:
    """Launch counts summed over runs."""
    for run in runs:
        total = {k: total.get(k, 0) + v for k, v in run.items()}
    return total


def _draft_model(sl):
    """A random text-only draft at the 9B's vocabulary and widths with
    DRAFT_LAYERS layers, from DRAFT_SEED (about 2.6 GB in bf16)."""
    import dataclasses

    from vidi_tpu_torch.models import decoder
    dcfg = dataclasses.replace(sl.cfg, text=dataclasses.replace(
        sl.cfg.text, num_layers=DRAFT_LAYERS))
    gen = torch.Generator(device=sl.dev).manual_seed(DRAFT_SEED)
    dtype = sl.params["text"]["embed"].dtype
    return {"text": decoder.init_params(dcfg.text, dtype, sl.dev, gen)}, dcfg


def verify_check(sl) -> None:
    """verify_step on a window of VERIFY_W tokens (the K1 route: dense T2T,
    K1 reads of the image / audio caches) against VERIFY_W sequential
    decode_steps (K3) on copies of one prefill's caches: each position's
    logits under the decode routes' limits, each layer's written text-cache
    slots to cosine CACHE_COS. Planted fault: the window written at
    cur_len + 1."""
    from vidi_tpu_torch.models import dattn, decoder

    n_layers = sl.cfg.text.num_layers
    _, base, lens, _ = _prefill(sl, QUERIES[0])
    gen = torch.Generator(device=sl.dev).manual_seed(SEED + 12)
    window = torch.randint(3, sl.cfg.text.vocab_size, (1, VERIFY_W), generator=gen,
                           device=sl.dev)
    emb = decoder.embed_tokens(sl.params["text"], window, sl.cfg.text)

    def copy():
        return base._replace(text_k=base.text_k.clone(), text_v=base.text_v.clone())

    def verify(caches):
        return dattn.verify_step(sl.params, sl.cfg, emb, lens, caches, img_mask=sl.media[1],
                                 aud_mask=sl.media[3], use_flash=True)[0]

    ver = copy()
    logits, run = _counted(lambda: verify(ver))
    _held(f"one verify pass of {VERIFY_W} tokens", run,
          {"flash_attention": 2 * n_layers, "decode_attention": 0})
    seq = copy()
    steps = [_decode_step(sl, emb[:, i:i + 1], lens + i, seq, True) for i in range(VERIFY_W)]
    n = int(lens[0])
    # a pass rewrites the same slots with the same values, so it can repeat
    verify_ms = _time_ms(lambda: verify(ver), reps=5)
    step_ms = _time_ms(lambda: _decode_step(sl, emb[:, :1], lens, seq, True), reps=5)
    print(f"  one verify pass of {VERIFY_W} tokens (K1 route) {verify_ms:.2f} ms, one decode "
          f"step (K3 route) {step_ms:.2f} ms: {verify_ms / step_ms:.2f}x (CUDA events around "
          f"5 calls back to back; both host-bound)")

    def slots_cos(caches):  # the least cosine of the window's slots a layer
        return min(_cos(getattr(caches, name)[layer, :, :, n:n + VERIFY_W],
                        getattr(seq, name)[layer, :, :, n:n + VERIFY_W])
                   for name in ("text_k", "text_v") for layer in range(n_layers))

    def within(out, caches):
        gaps = [_logit_gap(out[:, i], steps[i]) for i in range(VERIFY_W)]
        cos = slots_cos(caches)
        return gaps, cos, (all(r <= LOGIT_REL and c >= LOGIT_COS for r, c in gaps)
                           and cos >= CACHE_COS)

    real = dattn.dattn_layer

    def shifted(*a, **kw):  # the window's K/V written one slot late
        return real(*a, **{**kw, "write_at": kw["write_at"] + 1})

    bad = copy()
    with _swap(dattn, dattn_layer=shifted):
        fault = verify(bad)
    (gaps, cos, ok), (f_gaps, f_cos, f_ok) = within(logits, ver), within(fault, bad)
    for i in range(VERIFY_W):
        print(f"  verify vs {VERIFY_W} decode steps, position {i}: max_abs_err = "
              f"{gaps[i][0]:.3e} of max|logit| (limit {LOGIT_REL}), cosine {gaps[i][1]:.6f} "
              f"(limit {LOGIT_COS}); planted fault (written at cur_len + 1): "
              f"{f_gaps[i][0]:.3e}, {f_gaps[i][1]:.6f}")
    print(f"  verify vs decode steps: the window's text-cache slots, least cosine a layer "
          f"over {n_layers} layers x (k, v) {cos:.6f} (limit {CACHE_COS}); planted fault "
          f"{f_cos:.6f}")
    if not ok:
        raise AssertionError("verify_step disagrees with sequential decode steps")
    if f_ok:
        raise AssertionError("the limits do not reject the window written at cur_len + 1")


def _spec_rate(res) -> float:
    """Tokens a second after the first, over the rows."""
    return float((res.lengths - 1).sum()) / res.decode_s


def speculative_check(sl, draft, route: str, prompts, kw):
    """Greedy generate and greedy speculative decoding (the n-gram draft
    and the draft model; with `quantize_caches` the n-gram draft alone) on
    one route (K3 / folded K1 decode), tokens under the near-tie rule,
    launches held to the reckoned ones. -> (the greedy run, the launches
    of these runs)."""
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.infer.generate import generate, speculative_generate

    n_layers = sl.cfg.text.num_layers
    pr, pm = prompts
    rows = pr.shape[0]
    kw = dict(kw, max_new_tokens=DECODE_NEW, eos_id=P.pick_eos(sl.cfg, sl.tok),
              mm_chunks=32, use_flash=True, use_flash_decode=True)
    quantized = kw.get("quantize_caches", False)
    with _LogitLog() as log:
        greedy, run = _counted(lambda: generate(sl.params, sl.cfg, pr, pm, **kw))
    folded = "media_caches" in kw and rows > 1
    per_step = ({"flash_attention": 2 * n_layers, "decode_attention": n_layers} if folded
                else {"flash_attention": 0,
                      "decode_attention": (1 if quantized else 3) * n_layers})
    _held(f"{route}: greedy generate", run, {
        k: 3 * n_layers * (k == "flash_attention") + greedy.decode_steps * v
        for k, v in per_step.items()})
    path = run
    g_rate = rows * greedy.decode_steps / greedy.decode_s
    print(f"  {route}: greedy {rows} row(s), {greedy.decode_steps} steps, "
          f"{g_rate:.2f} tok/s over the rows")
    drafts = [("n-gram", (None, None))] + ([] if quantized else [("draft model", draft)])
    for name, (dp, dc) in drafts:
        res, run = _counted(lambda: speculative_generate(
            sl.params, sl.cfg, dp, dc, pr, pm, spec_k=SPEC_K, **kw))
        # prefill K1 T2T / T2V / T2A; a verify pass: K1 on the image / audio
        # caches (none on int8 caches), dense T2T; the draft's prefill: K1
        # T2T a layer; its decode steps: no kernel
        _held(f"{route}: speculative, {name}", run, {
            "flash_attention": n_layers * (3 + (0 if quantized else 2) * res.n_target_steps)
            + (dc.text.num_layers if dc is not None else 0),
            "decode_attention": 0})
        path = _add(path, run)
        acc, drafted = int(res.n_accepted.sum()), max(int(res.n_drafted.sum()), 1)
        print(f"  {route}: speculative ({name}, spec_k {SPEC_K}): {res.n_target_steps} target "
              f"passes for {int(res.lengths.sum())} tokens, accepted {acc}/{drafted} "
              f"({acc / drafted:.0%}), {_spec_rate(res):.2f} tok/s over the rows vs greedy "
              f"{g_rate:.2f} (prefill {res.prefill_s:.3f} s vs {greedy.prefill_s:.3f} s)")
        _near_tie_rule(f"{route}: speculative, {name}", res.tokens, greedy.tokens, log)
    return greedy, path


class _BeamLog:
    """Records each frontier choice of beam_generate inside a `with` block:
    the top NUM_BEAMS + 1 candidate scores and the chosen NUM_BEAMS
    (`generate._top`), the step's logit limit (LOGIT_REL * max|logit|,
    from lm_logits), and the text caches after the last reorder
    (`generate._reorder`, or `reorder` in its place: a planted fault)."""

    def __init__(self, reorder=None):
        from vidi_tpu_torch.infer import generate as gen
        from vidi_tpu_torch.models import decoder
        self.gen, self.decoder = gen, decoder
        self.reorder = reorder or gen._reorder
        self.vals, self.idx, self.limits, self.caches = [], [], [], None

    def __enter__(self):
        real_top, real_logits, reorder = self.gen._top, self.decoder.lm_logits, self.reorder

        def top(x, k):
            vals, idx = real_top(x, k + 1)
            self.vals.append(vals.cpu())
            self.idx.append(idx[:, :k].cpu())
            return vals[:, :k], idx[:, :k]

        def lm_logits(*a, **kw):
            out = real_logits(*a, **kw)
            self.limits.append(LOGIT_REL * float(out.float().abs().max()))
            return out

        def reordered(caches, spare, parent):
            out = reorder(caches, spare, parent)
            self.caches = out[0]
            return out

        self.saved = real_top, real_logits, self.gen._reorder
        self.gen._top, self.decoder.lm_logits, self.gen._reorder = top, lm_logits, reordered
        return self

    def __exit__(self, *exc):
        self.gen._top, self.decoder.lm_logits, self.gen._reorder = self.saved

    def frontiers(self, v: int) -> list:
        """Each step's frontier: for each query, its beams' token tuples in
        beam-row order (a candidate index is parent * v + token, v the
        vocabulary; the prefill's are tokens)."""
        out, hyps = [], None
        for idx in self.idx:
            if hyps is None:
                hyps = [[(int(t),) for t in row] for row in idx]
            else:
                hyps = [[hyps[q][int(i) // v] + (int(i) % v,) for i in row]
                        for q, row in enumerate(idx)]
            out.append(hyps)
        return out


def _beam_rule(label: str, got: _BeamLog, want: _BeamLog, v: int) -> bool:
    """Two beam runs' frontiers (as sets of hypotheses: an order swap inside
    the frontier changes nothing) step by step: True if equal throughout,
    or if the first step where they part has the K-th and (K+1)-th
    candidates of `want` within that step's logit limit (printed); False
    if they part at a clear choice."""
    for step, (a, b) in enumerate(zip(got.frontiers(v), want.frontiers(v))):
        parted = [q for q in range(len(b)) if set(a[q]) != set(b[q])]
        if not parted:
            continue
        vals = want.vals[step]
        gap = min(float(vals[q, NUM_BEAMS - 1] - vals[q, NUM_BEAMS]) for q in parted)
        limit = want.limits[step]
        print(f"  {label}: the frontiers part at step {step}; the K-th and (K+1)-th "
              f"candidates' gap {gap:.4f} vs the logit limit {limit:.4f}: "
              f"{'a near tie' if gap <= limit else 'a clear choice'}")
        return gap <= limit
    print(f"  {label}: the frontiers are equal at all {len(want.idx)} steps")
    return True


def _replay_cos(sl, prefill, log: _BeamLog) -> float:
    """Least cosine, over the layers, k and v and the final beams, between a
    beam run's final text caches and a teacher-forced replay of each final
    beam's tokens on `prefill`'s caches (the text cache repeated, decode
    steps on the K3 route): each beam row's cache must hold its own
    tokens."""
    from vidi_tpu_torch.models import dattn, decoder

    _, caches, lens = prefill
    img_mask, aud_mask = sl.media[1], sl.media[3]
    beams = log.frontiers(sl.cfg.text.vocab_size)[-1]
    toks = torch.tensor([h for q in beams for h in q], device=sl.dev)  # [B*K, S+1]
    caches = caches._replace(text_k=caches.text_k.repeat_interleave(NUM_BEAMS, dim=1),
                             text_v=caches.text_v.repeat_interleave(NUM_BEAMS, dim=1))
    cur = lens.repeat_interleave(NUM_BEAMS)
    n_steps = toks.shape[1] - 1
    for j in range(n_steps):
        emb = decoder.embed_tokens(sl.params["text"], toks[:, j:j + 1], sl.cfg.text)
        dattn.decode_step(sl.params, sl.cfg, emb, cur + j, caches, img_mask=img_mask,
                          aud_mask=aud_mask, use_flash=True)
    n = int(lens[0])
    return min(_cos(getattr(log.caches, name)[layer, r, :, n:n + n_steps],
                    getattr(caches, name)[layer, r, :, n:n + n_steps])
               for name in ("text_k", "text_v") for layer in range(sl.cfg.text.num_layers)
               for r in range(toks.shape[0]))


def beam_check(sl, prompts, media_caches, greedy) -> None:
    """num_beams = 1 bit-equal to `greedy` (a greedy run of the first query
    on the per-row caches, K3 route); NUM_BEAMS beams on
    the kernel route and on the plain route under the near-tie rule, the
    kernel route's final text caches against a teacher-forced replay of
    its beams (cosine CACHE_COS); a planted fault (text caches not
    reordered by parent) that the replay must reject; once with
    media_caches (the three queries folded). -> the launches of the path's
    runs (num_beams = 1, NUM_BEAMS on the kernel route and on
    media_caches), without the plain route, the fault and the replays."""
    from vidi_tpu_torch.infer import generate as gen
    from vidi_tpu_torch.infer import pipeline as P

    n_layers, v = sl.cfg.text.num_layers, sl.cfg.text.vocab_size
    pr, pm = prompts
    kw = dict(max_new_tokens=DECODE_NEW, eos_id=P.pick_eos(sl.cfg, sl.tok), mm_chunks=32,
              use_flash=True)
    one = (pr[:1], pm[:1], *sl.media)

    path = {}

    def counted(label, fn, want, on_path=True):
        nonlocal path
        res, run = _counted(fn)
        _held(label, run, want(res.decode_steps))
        if on_path:
            path = _add(path, run)
        return res

    beam1 = counted("num_beams = 1, K3 route", lambda: gen.beam_generate(
        sl.params, sl.cfg, *one, num_beams=1, use_flash_decode=True, **kw),
        lambda n: {"flash_attention": 3 * n_layers, "decode_attention": 3 * n_layers * n})
    equal = torch.equal(beam1.tokens, greedy.tokens)
    print(f"  num_beams = 1 vs greedy generate (K3 route, {greedy.decode_steps} steps): "
          f"tokens {'bit-equal' if equal else 'DIFFER'}")
    if not equal:
        raise AssertionError("num_beams = 1 must give greedy's tokens")

    # a beam step: K3 for the T2T of the B*K beam rows, K1 for the beams
    # folded onto each image / audio cache row
    logs = {}
    for route, flash in (("kernel", True), ("plain", False)):
        with _BeamLog() as logs[route]:
            res = counted(f"num_beams = {NUM_BEAMS}, {route} route", lambda: gen.beam_generate(
                sl.params, sl.cfg, *one, num_beams=NUM_BEAMS, use_flash_decode=flash, **kw),
                lambda n: ({"flash_attention": n_layers * (3 + 2 * n),
                            "decode_attention": n_layers * n} if flash else
                           {"flash_attention": 3 * n_layers, "decode_attention": 0}),
                on_path=flash)
        rate = res.decode_steps / res.decode_s
        print(f"  num_beams = {NUM_BEAMS}, {route} route: {res.decode_steps} steps, "
              f"{rate:.2f} steps/s = {NUM_BEAMS * rate:.2f} beam tokens/s, best beam "
              f"{int(res.lengths[0])} tokens {res.tokens[0, :8].tolist()}...")
    if not _beam_rule(f"num_beams = {NUM_BEAMS}, kernel vs plain route", logs["kernel"],
                      logs["plain"], v):
        raise AssertionError("the beam routes part at a clear choice")
    with _BeamLog(reorder=lambda caches, spare, parent: (caches, spare)) as fault:
        gen.beam_generate(sl.params, sl.cfg, *one, num_beams=NUM_BEAMS,
                          use_flash_decode=True, **kw)
    prefill = gen._prefill(sl.params, sl.cfg, *one, max_new_tokens=DECODE_NEW, mm_chunks=32,
                           use_flash=True)
    cos, fault_cos = _replay_cos(sl, prefill, logs["kernel"]), _replay_cos(sl, prefill, fault)
    print(f"  num_beams = {NUM_BEAMS}, kernel route: final text caches vs a teacher-forced "
          f"replay of the beams, least cosine {cos:.6f} (limit {CACHE_COS}); planted fault "
          f"(caches not reordered by parent) {fault_cos:.6f}")
    if cos < CACHE_COS:
        raise AssertionError("the beams' text caches do not hold their own tokens")
    if fault_cos >= CACHE_COS:
        raise AssertionError("the replay does not reject caches left unreordered")

    res = counted(f"num_beams = {NUM_BEAMS}, {pr.shape[0]} queries on media_caches",
                  lambda: gen.beam_generate(
                      sl.params, sl.cfg, pr, pm, img_mask=sl.media[1], aud_mask=sl.media[3],
                      num_beams=NUM_BEAMS, use_flash_decode=True, media_caches=media_caches,
                      **kw),
                  lambda n: {"flash_attention": n_layers * (3 + 2 * n),
                             "decode_attention": n_layers * n})
    print(f"  num_beams = {NUM_BEAMS}, {pr.shape[0]} queries x {NUM_BEAMS} beams folded onto "
          f"media_caches: {res.decode_steps} steps, {res.decode_steps / res.decode_s:.2f} "
          f"steps/s, lengths {res.lengths.tolist()}")
    return path


def sampling_check(sl, greedy) -> dict:
    """Sampled generate (SAMPLING) on the K3 route: one seed twice gives
    bit-equal tokens; top-k 1 gives greedy's. -> the launches of the first
    run (the others are its checks)."""
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.infer.generate import generate

    kw = dict(max_new_tokens=DECODE_NEW, eos_id=P.pick_eos(sl.cfg, sl.tok), mm_chunks=32,
              use_flash=True, use_flash_decode=True)
    pr, pm = _long_prompts(sl)
    one = (pr[:1], pm[:1], *sl.media)

    def sample(seed, **warp):
        gen = torch.Generator(device=sl.dev).manual_seed(seed)
        return generate(sl.params, sl.cfg, *one, generator=gen, **{**kw, **SAMPLING, **warp})

    a, path = _counted(lambda: sample(3))
    b, k1 = sample(3), sample(3, top_k=1)
    same, greedy_equal = torch.equal(a.tokens, b.tokens), torch.equal(k1.tokens, greedy.tokens)
    print(f"  sampling {SAMPLING}: seed 3 twice {'bit-equal' if same else 'DIFFER'} "
          f"({a.decode_steps / a.decode_s:.2f} tok/s), top-k 1 vs greedy "
          f"{'bit-equal' if greedy_equal else 'DIFFER'}; tokens {a.tokens[0, :8].tolist()}...")
    if not (same and greedy_equal):
        raise AssertionError("sampling is not reproducible, or top-k 1 is not greedy")
    return path


SHALLOW_LAYERS = 14  # text depth of the decoding-variants phase


def _shallow(sl, n_layers: int):
    """The slice cut to its first `n_layers` text layers: the same towers,
    adapters, media and tensors (nothing copied), a configuration of that
    depth."""
    import dataclasses

    text = {**sl.params["text"], "layers": sl.params["text"]["layers"][:n_layers]}
    cfg = dataclasses.replace(sl.cfg, text=dataclasses.replace(sl.cfg.text,
                                                              num_layers=n_layers))
    return types.SimpleNamespace(**{**vars(sl), "params": {**sl.params, "text": text},
                                    "cfg": cfg})


def serve_decoding_phase(sl) -> dict:
    """The decoding variants on the 120 s slice (Vidi1.5-9B, random
    weights): verify_step against sequential decode steps; greedy
    speculative decoding (n-gram and a random DRAFT_LAYERS-layer draft) on
    the per-row caches, on media_prefill's caches for three folded queries,
    and (n-gram) on int8 caches; beams; sampling; `ask` with a draft and
    with beams. -> the kernel launches of the path's own runs (greedy,
    speculative, beams on the kernel route and on media_caches, the first
    sampled run, the two `ask` calls), without the checks' runs (the
    verify check, timing repetitions, plain-route runs, planted faults,
    replays)."""
    import tempfile

    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.models import dattn

    t0 = time.perf_counter()
    verify_check(sl)
    pr, pm = _long_prompts(sl)
    draft = _draft_model(sl)
    img, img_mask, aud, aud_mask = sl.media
    media = dattn.media_prefill(sl.params, sl.cfg, img, img_mask, aud, aud_mask,
                                mm_chunks=32, use_flash=True)
    per_row = dict(img=img, img_mask=img_mask, aud=aud, aud_mask=aud_mask)
    shared = dict(img_mask=img_mask, aud_mask=aud_mask, media_caches=media)
    greedy, launches = speculative_check(sl, draft, "per-row caches, K3 route",
                                         (pr[:1], pm[:1]), per_row)
    launches = _add(launches, speculative_check(
        sl, draft, "media_caches, 3 queries folded (K1 route)", (pr, pm), shared)[1])
    launches = _add(launches, speculative_check(
        sl, draft, "int8 caches, K3 route", (pr[:1], pm[:1]),
        dict(per_row, quantize_caches=True))[1])
    del draft
    launches = _add(launches, beam_check(sl, (pr, pm), media, greedy))
    del media
    launches = _add(launches, sampling_check(sl, greedy))
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.mp4")
        _write_clip(sl.frames, clip)
        for label, extra in (("draft='ngram'", dict(draft="ngram")),
                             ("num_beams=2", dict(num_beams=2))):
            t1 = time.perf_counter()
            answer, run = _counted(lambda: P.ask(
                QUERIES[0], clip, sl.params, sl.cfg, sl.tok, max_new_tokens=DECODE_NEW // 2,
                use_flash_decode=True, **extra))
            launches = _add(launches, run)
            print(f"  ask({label}) on the {sl.seconds} s mp4: {answer!r} in "
                  f"{time.perf_counter() - t1:.3f} s")
    print(f"  kernel launches in the decoding variants' own runs: {launches}; phase wall time "
          f"{time.perf_counter() - t0:.1f} s")
    if launches["flash_attention"] == 0 or launches["decode_attention"] == 0:
        raise AssertionError(f"a kernel of the decoding path was never launched: {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# The serving daemon, the batch runner and the evals
# ---------------------------------------------------------------------------

# The daemon's slice: SERVE_NEW new tokens a response; clip A is the 120 s
# clip, clip B a second clip of SERVE_B_SECONDS s from SERVE_B_SEED (both
# mp4v at 1 fps, no audio track: cv2 decodes and the audio is silence)
SERVE_NEW = 16
SERVE_B_SECONDS, SERVE_B_SEED = 60, SEED + 30
SERVE_VQA = ("which object crosses the frame first?",
             ["a red car", "a dog", "a door", "nothing"])


class _RecordingTokenizer:
    """A tokenizer that keeps every id sequence it decodes: a response's
    generated tokens (random weights decode to "" through the byte
    tokenizer, so the text alone would compare nothing)."""

    def __init__(self, tok):
        self.tok, self.decoded = tok, []

    def __getattr__(self, name):
        return getattr(self.tok, name)

    def __call__(self, *a, **kw):
        return self.tok(*a, **kw)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        self.decoded.append([int(t) for t in ids])
        return self.tok.decode(ids, skip_special_tokens)


class _FirstLogits:
    """Within `with`: the first lm_logits output (the prefill's last-token
    logits [B,V], fp32) of every generate / speculative_generate call, in
    call order; the daemon and the runner emit their rows in that order."""

    def __init__(self):
        from vidi_tpu_torch.infer import generate as G
        from vidi_tpu_torch.models import decoder
        self.G, self.decoder, self.calls, self.armed = G, decoder, [], False

    def __enter__(self):
        self.real = (self.decoder.lm_logits, self.G.generate, self.G.speculative_generate)
        real_lm = self.real[0]

        def lm_logits(*a, **kw):
            out = real_lm(*a, **kw)
            if self.armed:
                self.calls.append(out.float())
                self.armed = False
            return out

        def armed(fn):
            def call(*a, **kw):
                self.armed = True
                return fn(*a, **kw)
            return call

        self.decoder.lm_logits = lm_logits
        self.G.generate, self.G.speculative_generate = armed(self.real[1]), armed(self.real[2])
        return self

    def __exit__(self, *exc):
        self.decoder.lm_logits, self.G.generate, self.G.speculative_generate = self.real

    def rows(self):
        """Each call's rows' logits [V], in emit order."""
        return [c[r] for c in self.calls for r in range(c.shape[0])]


def _tower_launches(cfg, n_frames: int, n_windows: int, mm_chunks: int = 32) -> int:
    """K2 launches (and each K5 piece's on int8 towers) of one encode: every
    SigLIP layer it runs once per frame chunk, every Whisper layer once per
    window chunk (`dattn.chunked_map`)."""
    vis_layers = cfg.vision.num_layers + 1 + cfg.vision.select_layer
    return (vis_layers * _map_chunks(n_frames, mm_chunks)
            + cfg.audio.num_layers * _map_chunks(n_windows, mm_chunks))


def _serve_clips(sl, tmp: str, names=("clipA", "clipB")) -> dict:
    """Clip A (the 120 s frames) and clip B (SERVE_B_SECONDS s of other
    frames) written as <name>.mp4 in `tmp`, each decoded once on the host
    (frame and window counts, for the reckoning)."""
    from vidi_tpu_torch.infer import pipeline as P

    rng = np.random.default_rng(SERVE_B_SEED)
    size = sl.cfg.vision.image_size
    frames = {"clipA": sl.frames,
              "clipB": rng.integers(0, 256, (SERVE_B_SECONDS, size, size, 3), dtype=np.uint8)}
    clips = {}
    for name in names:
        frames_n = frames[name]
        path = os.path.join(tmp, name + ".mp4")
        _write_clip(frames_n, path)
        pixels, mels, _ = P.decode_media_host(path, sl.cfg)
        clips[name] = types.SimpleNamespace(path=path, n_frames=len(pixels),
                                            n_windows=mels.shape[0], enc=None)
    return clips


def _anchor(sl, clip, query: str, task: str = "tr", options=None,
            quantize: bool = False):
    """The reference's anchor for one request: a generate of the query alone
    on the full forward over the clip's decoded features (K1 prefill, K3
    decode route; int8 caches with `quantize`), SERVE_NEW tokens -> its
    ids, its step-0 logits [V] and each step's greedy top-2 gap and logit
    limit."""
    from vidi_tpu_torch.infer import generate as G
    from vidi_tpu_torch.infer import pipeline as P

    if clip.enc is None:
        clip.enc = P.encode_media(sl.params, sl.cfg, clip.path, mm_chunks=32, use_flash=True)
    prompt, mask = P.build_prompt_batch([P.build_prompt_ids(query, sl.tok, task=task,
                                                            options=options)])
    with _LogitLog() as log, _FirstLogits() as first:
        res = G.generate(sl.params, sl.cfg, torch.as_tensor(prompt).long().to(sl.dev),
                         torch.as_tensor(mask).to(sl.dev), *clip.enc,
                         max_new_tokens=SERVE_NEW, eos_id=P.pick_eos(sl.cfg, sl.tok),
                         mm_chunks=32, use_flash=True, use_flash_decode=True,
                         quantize_caches=quantize)
    return types.SimpleNamespace(ids=res.tokens[0, : int(res.lengths[0])].tolist(),
                                 logits=first.calls[0][0],
                                 gaps=[float(g[0]) for g in log.gaps],
                                 limits=[float(x[0]) for x in log.limits])


def _tie_rule(label: str, got: list, a) -> None:
    """Generated ids against the anchor's: equal, or first different at a
    step whose anchor top-2 gap is within the logit limit (printed)."""
    i = next((j for j, (x, y) in enumerate(zip(got, a.ids)) if x != y), None)
    if i is None:
        return
    near = a.gaps[i] <= a.limits[i]
    print(f"  {label}: parts from the anchor at token {i}, its top-2 gap {a.gaps[i]:.4f} "
          f"vs the logit limit {a.limits[i]:.4f}: {'a near tie' if near else 'FAIL'}")
    if not near:
        raise AssertionError(f"{label}: leaves the anchor at token {i}, a clear choice")


def _logits_held(label: str, got, want) -> bool:
    rel, cos = _logit_gap(got, want)
    ok = rel <= LOGIT_REL and cos >= LOGIT_COS
    print(f"  {label}: step-0 logits vs the anchor's: max_abs_err = {rel:.3e} of max|logit| "
          f"(limit {LOGIT_REL}), cosine {cos:.6f} (limit {LOGIT_COS})")
    return ok


class _CacheProvenance:
    """Within `with`: for each generate call serve_loop makes, the video key
    it looked up last in its MediaLRU and the image cache (img_k) it was
    handed; and each key's own image cache, as the key's media prefill put
    it in the LRU. A call handed another tensor than its key's own is
    foreign: exact, whatever the weights. On exit it keeps only the count
    of calls and the foreign ones (`n_calls`, `foreign`), so no cache
    outlives its LRU."""

    def __init__(self):
        from vidi_tpu_torch.infer import generate as G
        from vidi_tpu_torch.infer import serve as S
        self.G, self.S, self.own, self.calls, self.last = G, S, {}, [], None

    def __enter__(self):
        rec, real = self, self.G.generate

        class Recording(self.S.MediaLRU):
            def get(self, key):
                rec.last = key
                return super().get(key)

            def put(self, key, value):
                rec.own[key] = value[3].img_k
                super().put(key, value)

        def generate(*a, **kw):
            rec.calls.append((rec.last, kw["media_caches"].img_k))
            return real(*a, **kw)

        self.swaps = (_swap(self.S, MediaLRU=Recording), _swap(self.G, generate=generate))
        for sw in self.swaps:
            sw.__enter__()
        return self

    def __exit__(self, *exc):
        for sw in reversed(self.swaps):
            sw.__exit__(*exc)
        # (call, key) of each generate handed another img_k than its key's
        self.n_calls, self.foreign = len(self.calls), [
            (i, os.path.basename(k)) for i, (k, t) in enumerate(self.calls)
            if t is not self.own.get(k)]
        self.own, self.calls = {}, []


def _daemon(sl, lines, read=_kernel_counts, **kw):
    """serve_loop on JSONL `lines` (through the daemon's own reader) ->
    (responses, stats, recorded ids, step-0 logits of each row, the
    launches `read` counts)."""
    import io
    import queue

    from vidi_tpu_torch.infer import serve as S

    q = queue.Queue()
    S._reader(io.StringIO("\n".join(lines) + "\n"), q)
    tok, out = _RecordingTokenizer(sl.tok), []
    before = read()
    with _FirstLogits() as first:
        stats = S.serve_loop(sl.params, sl.cfg, tok, q, out.append, **{
            "max_new_tokens": SERVE_NEW, **kw})
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in read().items()}
    return out, stats, tok.decoded, first.rows(), launches


def _serve_check(sl, label, lines, anchors, want_stats, want_launches, planted=(),
                 read=_kernel_counts, **kw):
    """One daemon run held to the reckoned stats and launches, its only
    error responses the planted ones, each response's ids under the
    near-tie rule against its anchor and its step-0 logits within the logit
    limits. -> the run's launches."""
    out, stats, ids, rows, launches = _daemon(sl, lines, read, **kw)
    errors = sorted(str(o.get("id")) for o in out if "error" in o)
    served = [o for o in out if "error" not in o]
    got = {k: stats[k] for k in want_stats}
    print(f"  {label}: {stats['served']} served, {stats['errors']} errors in "
          f"{stats['wall_s']:.3f} s = {stats['queries_per_s']:.3f} queries/s; stats {got} "
          f"(reckoned {want_stats}); launches {launches} (reckoned {want_launches})")
    for o in out:
        if "error" in o:
            print(f"    planted error {o.get('id')!r}: {o['error'][:100]}")
    if errors != sorted(planted):
        raise AssertionError(f"{label}: error responses {errors}, planted {sorted(planted)}: "
                             f"{[o for o in out if 'error' in o]}")
    if got != want_stats:
        raise AssertionError(f"{label}: stats {got}, reckoned {want_stats}")
    if {k: launches[k] for k in want_launches} != want_launches:
        raise AssertionError(f"{label}: launches {launches}, reckoned {want_launches}")
    if not len(served) == len(ids) == len(rows):
        raise AssertionError(f"{label}: {len(served)} responses, {len(ids)} decodes, "
                             f"{len(rows)} rows")
    for o, got_ids, logits in zip(served, ids, rows):
        a = anchors[o["id"]]
        if not all(0 <= t < sl.cfg.text.vocab_size for t in got_ids):
            raise AssertionError(f"{label}: ids outside the vocabulary")
        _tie_rule(f"{label} {o['id']}", got_ids, a)
        if not _logits_held(f"{label} {o['id']}", logits, a.logits):
            raise AssertionError(f"{label} {o['id']}: step-0 logits outside the limits")
    return launches


def _serve_stats(served, errors, calls, hits, misses) -> dict:
    return {"served": served, "errors": errors, "generate_calls": calls,
            "media_cache_hits": hits, "media_cache_misses": misses, "overlapped_decodes": 0}


def _req(rid: str, clip, query: str, **extra) -> str:
    return json.dumps({"id": rid, "video": clip.path, "query": query, **extra})


def _planted_daemon_faults(sl, clips, anchors) -> None:
    """Two planted faults, each must put a row's step-0 logits outside the
    limits: _stack_media padding the masks with True (the shorter video's
    padded slots attended) in run (b)'s bundle, and an LRU that hands back
    the other video's caches on a hit, which the cache provenance check
    (_CacheProvenance) must also find. One new token a row: only the
    step-0 logits are read."""
    from vidi_tpu_torch.infer import serve as S

    A, B = clips["clipA"], clips["clipB"]
    real_pad = S._pad_tail
    with _swap(S, _pad_tail=lambda x, dim, n, value: real_pad(
            x, dim, n, True if value is False else value)):
        out, _, _, rows, _ = _daemon(sl, [_req("a0", A, QUERIES[0]), _req("b0", B, QUERIES[2])],
                                     batch_videos=2, max_new_tokens=1)
    row = {o["id"]: r for o, r in zip(out, rows)}
    if _logits_held("planted fault, masks padded with True: b0", row["b0"],
                    anchors["b0"].logits):
        raise AssertionError("the limits do not see the planted fault: masks padded with True")

    class WrongLRU(S.MediaLRU):
        def get(self, key):
            other = [k for k in self._od if k != key]
            if key in self._od and other:
                self.hits += 1
                return self._od[other[-1]]
            return super().get(key)

    with _swap(S, MediaLRU=WrongLRU), _CacheProvenance() as prov:
        out, _, _, rows, _ = _daemon(
            sl, [_req("a0", A, QUERIES[0]), _req("b0", B, QUERIES[2]),
                 _req("a1", A, QUERIES[1])], batch_queries=1, media_cache=2, max_new_tokens=1)
    row = {o["id"]: (o, r) for o, r in zip(out, rows)}
    print(f"  planted fault, the LRU hands back the other video's caches: a1 answered with "
          f"video_s {row['a1'][0]['video_s']}; foreign caches (call, key) {prov.foreign}")
    if not prov.foreign:
        raise AssertionError("the cache provenance check does not see the planted fault: "
                             "the other video's caches")
    if _logits_held("planted fault, the other video's caches: a1", row["a1"][1],
                    anchors["a1"].logits):
        raise AssertionError("the limits do not see the planted fault: the other video's caches")


def _runner(sl, clips, anchors, tmp: str) -> dict:
    """The batch runner (run_benchmark.make_ask_batch + run_task, the body
    of its main) on made-up ground truths for tr (four queries over A and
    B), vqa, character and stg, then the evals on its predictions. -> the
    runs' launches."""
    from vidi_tpu_torch.evals import vue_plot, vue_stg, vue_tr
    from vidi_tpu_torch.infer import run_benchmark as rb

    cfg, n_layers = sl.cfg, sl.cfg.text.num_layers
    A, B = clips["clipA"], clips["clipB"]
    secs = {"clipA": float(sl.seconds), "clipB": float(SERVE_B_SECONDS)}
    tr_q = [("t0", "clipA", QUERIES[0], "a0"), ("t1", "clipA", QUERIES[1], "a1"),
            ("t2", "clipA", QUERIES[2], "a2"), ("t3", "clipB", QUERIES[2], "b0")]
    gts = {
        "tr": [{"query_id": qid, "video_id": v, "query": q, "duration": secs[v],
                "gt": [[10.0, 25.0]], "duration_category": "medium",
                "query_format": "phrase", "query_modality": "vision"}
               for qid, v, q, _ in tr_q],
        "vqa": [{"problem_id": 1, "video_id": "clipA", "problem": SERVE_VQA[0],
                 "options": [f"{'ABCD'[i]}. {o}" for i, o in enumerate(SERVE_VQA[1])],
                 "answer": "A", "task_type": "Perception and Understanding"}],
        "character": [{"query_id": "c0", "video_id": "clipB", "character": "the pilot",
                       "duration": secs["clipB"],
                       "gt": [{"start": 3.0, "end": 9.0, "text": "hello there",
                               "boxes": [{"timestamp": 4.0,
                                          "box_2d": [0.1, 0.2, 0.4, 0.6]}]}]}],
        "stg": [{"query_id": "s0", "video_id": "clipA", "query": QUERIES[0]},
                {"query_id": "s1", "video_id": "clipB", "query": QUERIES[1]}],
    }
    # (videos encoded, generate calls) of each task: one encode and one
    # generate a video (batch_queries 4 holds each video's queries)
    shape = {"tr": (("clipA", "clipB"), 2), "vqa": (("clipA",), 1),
             "character": (("clipB",), 1), "stg": (("clipA", "clipB"), 2)}
    launches, outs = {}, {}
    for task, gt in gts.items():
        gt_path = os.path.join(tmp, f"{task}_gt.json")
        with open(gt_path, "w") as f:
            json.dump(gt, f)
        outs[task] = os.path.join(tmp, f"{task}_pred.{'csv' if task == 'stg' else 'json'}")
        args = rb.build_parser().parse_args([
            "--task", task, "--gt", gt_path, "--video-dir", tmp, "--out", outs[task],
            "--max-new-tokens", str(SERVE_NEW), "--batch-queries", "4"])
        tok = _RecordingTokenizer(sl.tok)
        t0 = time.perf_counter()
        with _FirstLogits() as first:
            _, run = _counted(lambda: rb.run_task(args, rb.make_ask_batch(
                sl.params, cfg, tok, args)))
        wall = time.perf_counter() - t0
        vids, calls = shape[task]
        want = {"flash_attention": 3 * n_layers * (len(vids) + calls),
                "tower_attention": sum(_tower_launches(cfg, clips[v].n_frames,
                                                       clips[v].n_windows) for v in vids),
                "decode_attention": 0}
        print(f"  run_benchmark --task {task}: {len(gt)} queries in {wall:.3f} s = "
              f"{len(gt) / wall:.3f} queries/s; launches {run} (reckoned {want})")
        if run != want:
            raise AssertionError(f"runner {task}: launches {run}, reckoned {want}")
        launches = _add(launches, run)
        if task == "tr":
            with open(outs[task]) as f:
                preds = json.load(f)
            order = [p["query_id"] for p in preds]
            if order != [t[0] for t in tr_q] or len(tok.decoded) != 4:
                raise AssertionError(f"runner tr: predictions {order}")
            for (qid, _, _, anchor), ids, logits in zip(tr_q, tok.decoded, first.rows()):
                _tie_rule(f"runner {qid}", ids, anchors[anchor])
                if not _logits_held(f"runner {qid}", logits, anchors[anchor].logits):
                    raise AssertionError(f"runner {qid}: step-0 logits outside the limits")

    # the evals on the runner's predictions (the scores of random weights)
    with warnings.catch_warnings():  # an empty precision list's mean is NaN
        warnings.simplefilter("ignore", RuntimeWarning)
        tr = vue_tr.evaluate(outs["tr"], os.path.join(tmp, "tr_gt.json"))
    vqa = vue_plot.evaluate_vqa(outs["vqa"])
    char = vue_plot.evaluate_character(outs["character"])
    ds = os.path.join(tmp, "stg_dataset")
    os.makedirs(ds, exist_ok=True)
    with open(os.path.join(ds, "video.csv"), "w") as f:
        f.write("video_id,video_duration\n" + "".join(f"{v},{s}\n" for v, s in secs.items()))
    with open(os.path.join(ds, "query.csv"), "w") as f:
        f.write("query_id,video_id\ns0,clipA\ns1,clipB\n")
    with open(os.path.join(ds, "tubes.csv"), "w") as f:
        f.write("query_id,time_ms,x0,y0,x1,y1\n" + "".join(
            f"{q},{t * 1000},0.2,0.2,0.6,0.7\n" for q in ("s0", "s1") for t in range(5, 12)))
    ev = vue_stg.SpatioTemporalEvaluator()
    ev.load_dataset(ds)
    stg = vue_stg.summarize(ev.evaluate_pred_file(outs["stg"]))
    print("  evals on the runner's predictions (random weights: the scores mean nothing "
          "of the model):")
    print(f"    vue_tr: {tr['n_query']} queries, overall {tr['overall']}")
    print(f"    vue_plot vqa: {vqa['total']} questions, accuracy {vqa['overall_accuracy']:.2f}%")
    print(f"    vue_plot character: {char['num_questions']} questions, temporal IoU "
          f"{char['temporal_iou_avg']:.4f}, WER {char['word_error_rate']:.4f}")
    print(f"    vue_stg: {[{k: (round(v, 4) if isinstance(v, float) else v) for k, v in r.items()} for r in stg[:1]]}")
    if tr["n_query"] != 4 or vqa["total"] != 1 or char["num_questions"] != 1 or not stg:
        raise AssertionError("the evals did not score the runner's predictions")
    return launches


def serve_phase(sl) -> tuple:
    """The serving daemon on the bf16 9B (random weights) over two mp4
    clips: runs (a) grouping, hits and the planted bad requests, (b) a
    cross-video bundle, (c) int8 caches, (d) n-gram speculative decoding,
    (e) eviction; two planted faults; the batch runner on four tasks and
    the evals on its predictions. Every response's ids and step-0 logits
    are held to a generate of its query alone on the full forward. ->
    (the daemon's and the runner's launches, the clips for the profile)."""
    import shutil
    import tempfile

    from vidi_tpu_torch.infer import serve as S

    cfg, n_layers = sl.cfg, sl.cfg.text.num_layers
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="vidi_serve_")
    try:
        clips = _serve_clips(sl, tmp)
        A, B = clips["clipA"], clips["clipB"]
        k2 = {n: _tower_launches(cfg, c.n_frames, c.n_windows) for n, c in clips.items()}
        print(f"  clips: A {A.n_frames} frames + {A.n_windows} windows, B {B.n_frames} frames "
              f"+ {B.n_windows} windows (cv2 decode, silent audio)")
        t0 = time.perf_counter()
        anchors = {"a0": _anchor(sl, A, QUERIES[0]), "a1": _anchor(sl, A, QUERIES[1]),
                   "a2": _anchor(sl, A, QUERIES[2]), "b0": _anchor(sl, B, QUERIES[2]),
                   "v0": _anchor(sl, A, SERVE_VQA[0], task="mcq", options=SERVE_VQA[1])}
        quant = {"a0": _anchor(sl, A, QUERIES[0], quantize=True),
                 "a1": _anchor(sl, A, QUERIES[1], quantize=True)}
        print(f"  anchors: {len(anchors) + len(quant)} generates on the full forward in "
              f"{time.perf_counter() - t0:.3f} s")

        def want(encodes, calls, per_call=3):
            return {"flash_attention": n_layers * (3 * len(encodes) + per_call * calls),
                    "tower_attention": sum(k2[e] for e in encodes), "decode_attention": 0}

        stats = _serve_stats
        # (a) two A groups (a miss, then a hit), B, and the planted bad requests
        lines = [_req("a0", A, QUERIES[0]), _req("a1", A, QUERIES[1]), "not json {",
                 json.dumps({"id": "noquery", "video": A.path}),
                 _req("b0", B, QUERIES[2]), _req("a2", A, QUERIES[2]),
                 _req("v0", A, SERVE_VQA[0], task="vqa", options=SERVE_VQA[1]),
                 _req("missing", types.SimpleNamespace(path=os.path.join(tmp, "none.mp4")),
                      QUERIES[0])]
        with _CacheProvenance() as prov:
            launches = _serve_check(sl, "(a) batch_queries 2, media_cache 2", lines, anchors,
                                    stats(5, 3, 3, 1, 3), want(("clipA", "clipB"), 3),
                                    planted=("None", "noquery", "missing"),
                                    batch_queries=2, media_cache=2)
        print(f"  (a) cache provenance: {prov.n_calls} generate calls, foreign caches "
              f"{prov.foreign} (each call must be handed its video's own img_k)")
        if prov.n_calls != 3 or prov.foreign:
            raise AssertionError(f"(a): a generate was handed another video's caches: "
                                 f"{prov.foreign}")

        # (b) a cross-video bundle: one generate over caches stacked on B
        stacked = []
        real_stack = S._stack_media

        def stack(entries):
            out = real_stack(entries)
            stacked.append(_nbytes(*[t for c in out[2][2:] if c is not None
                                     for t in (c.values() if isinstance(c, dict) else [c])]))
            return out

        with _swap(S, _stack_media=stack):
            launches = _add(launches, _serve_check(
                sl, "(b) batch_videos 2", [_req("a0", A, QUERIES[0]), _req("b0", B, QUERIES[2])],
                anchors, stats(2, 0, 1, 0, 2), want(("clipA", "clipB"), 1), batch_videos=2))
        print(f"  (b) stacked caches: {_gib(stacked[0])} (B padded to A's length)")

        # (c) int8 caches, (d) n-gram speculative decoding, (e) eviction
        pair = [_req("a0", A, QUERIES[0]), _req("a1", A, QUERIES[1])]
        launches = _add(launches, _serve_check(
            sl, "(c) quantize_kv", pair, quant, stats(2, 0, 1, 0, 1),
            want(("clipA",), 1, per_call=1), quantize_kv=True))
        launches = _add(launches, _serve_check(
            sl, "(d) spec_ngram", pair, anchors, stats(2, 0, 1, 0, 1), want(("clipA",), 1),
            spec_ngram=True, spec_k=SPEC_K))
        launches = _add(launches, _serve_check(
            sl, "(e) media_cache 1, A B A", [_req("a0", A, QUERIES[0]),
                                             _req("b0", B, QUERIES[2]),
                                             _req("a1", A, QUERIES[1])],
            anchors, stats(3, 0, 3, 0, 3), want(("clipA", "clipB", "clipA"), 3),
            batch_queries=1, media_cache=1))
        _planted_daemon_faults(sl, clips, anchors)
        runner = _runner(sl, clips, anchors, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"  kernel launches of the daemon's runs (a)-(e): {launches}; the runner's: {runner}; "
          f"peak device memory {_gib(peak)}; phase wall time "
          f"{time.perf_counter() - t_phase:.1f} s")
    if launches["flash_attention"] == 0 or launches["tower_attention"] == 0:
        raise AssertionError(f"a kernel of the daemon's path was never launched: {launches}")
    return launches, runner, clips


def profile_serve(sl, clips) -> None:
    """torch.profiler over one cache-hit group of the daemon: two queries'
    text prefill on clip A's shared caches plus SERVE_NEW - 1 decode steps
    (the generate call serve_loop makes for a group whose video is in the
    LRU)."""
    from vidi_tpu_torch.infer import generate as G
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.models import dattn

    img, im, aud, am = clips["clipA"].enc
    media = dattn.media_prefill(sl.params, sl.cfg, img, im, aud, am, mm_chunks=32,
                                use_flash=True)
    prompt, mask = P.build_prompt_batch([P.build_prompt_ids(q, sl.tok) for q in QUERIES[:2]])
    pr, pm = torch.as_tensor(prompt).long().to(sl.dev), torch.as_tensor(mask).to(sl.dev)
    _region(f"serve: cache-hit group of 2 queries (text prefill on the shared caches + "
            f"{SERVE_NEW - 1} decode steps, plain decode route)",
            lambda: G.generate(sl.params, sl.cfg, pr, pm, img_mask=im, aud_mask=am,
                               media_caches=media, max_new_tokens=SERVE_NEW,
                               eos_id=P.pick_eos(sl.cfg, sl.tok), use_flash=True,
                               mm_chunks=32))


def int8_daemon(sl) -> dict:
    """Two TR requests on clip A through serve_loop on the int8 model with
    int8 caches (quantize_kv) and W8A8 from qz.w8a8_min_tokens rows: K2 and
    K5 in the encode, K1 and K6 in the stream prefill, K1 (T2T) in the text
    prefill on the int8 caches. Launches held to the reckoned ones, ids and
    step-0 logits to each query's int8 full-forward generate."""
    import shutil
    import tempfile

    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.infer import quantize as qz

    cfg = sl.cfg
    tmp = tempfile.mkdtemp(prefix="vidi_serve8_")
    try:
        A = _serve_clips(sl, tmp, ("clipA",))["clipA"]
        anchors = {"a0": _anchor(sl, A, QUERIES[0], quantize=True),
                   "a1": _anchor(sl, A, QUERIES[1], quantize=True)}
        img, _, aud, _ = A.enc
        prompt, _ = P.build_prompt_batch([P.build_prompt_ids(q, sl.tok) for q in QUERIES[:2]])
        # the stream prefill as one query's forward; the text prefill's rows
        # (both prompts) stay below the W8A8 threshold
        want = reckon_int8_launches(cfg, A.n_frames, A.n_windows, (img.shape[1], aud.shape[1]),
                                    prompt.size, 1, qz.w8a8_min_tokens)
        want["flash_attention"] += cfg.text.num_layers  # the text prefill's T2T
        launches = _serve_check(sl, "int8 daemon, quantize_kv", [
            _req("a0", A, QUERIES[0]), _req("a1", A, QUERIES[1])], anchors,
            _serve_stats(2, 0, 1, 0, 1), want, read=_read_int8_counts, quantize_kv=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if min(launches[k] for k in ("ln_qkv", "o_residual", "ln_ffn", "quant_matmul",
                                 "quant_gated_mlp")) == 0:
        raise AssertionError(f"a K5 / K6 kernel was never launched under the daemon: {launches}")
    return launches


def serve_cli(sl, model_dir: str, clip: str, mem) -> dict:
    """The daemon's CLI at full width: serve.main(["--model-path", model_dir,
    "--in", ..., "--out", ...]) loads the 9B from the directory and answers
    two TR queries on the clip (one group: a K2 encode, K1 stream and text
    prefills). The first response's ids against the in-memory tree's `ask`
    (`mem`, the K3 decode route) under the near-tie rule, with the CLI's own
    top-2 gaps. -> its launches."""
    from vidi_tpu_torch.infer import loader as L
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.infer import serve as S

    n_layers = sl.cfg.text.num_layers
    req, resp = model_dir + ".req.jsonl", model_dir + ".resp.jsonl"
    with open(req, "w") as f:
        f.write(json.dumps({"id": "c0", "video": clip, "query": QUERIES[0]}) + "\n"
                + json.dumps({"id": "c1", "video": clip, "query": QUERIES[1]}) + "\n")
    pixels, mels, _ = P.decode_media_host(clip, sl.cfg)
    toks, real = [], L.load_tokenizer

    def load_tokenizer(*a, **kw):
        toks.append(_RecordingTokenizer(real(*a, **kw)))
        return toks[-1]

    t0 = time.perf_counter()
    with _swap(L, load_tokenizer=load_tokenizer), _LogitLog() as log:
        stats, run = _counted(lambda: S.main(["--model-path", model_dir, "--in", req, "--out",
                                              resp, "--max-new-tokens", str(SERVE_NEW)]))
    wall = time.perf_counter() - t0
    with open(resp) as f:
        out = [json.loads(x) for x in f]
    want = {"flash_attention": 6 * n_layers, "decode_attention": 0,
            "tower_attention": _tower_launches(sl.cfg, len(pixels), mels.shape[0])}
    got = {k: stats[k] for k in ("served", "errors", "generate_calls", "media_cache_hits",
                                 "media_cache_misses")}
    print(f"  serve.main(--model-path): {wall:.3f} s with the load, serving "
          f"{stats['wall_s']:.3f} s = {stats['queries_per_s']:.3f} queries/s; stats {got}; "
          f"launches {run} (reckoned {want}); responses {[sorted(o) for o in out]}")
    if got != {"served": 2, "errors": 0, "generate_calls": 1, "media_cache_hits": 0,
               "media_cache_misses": 1} or any("error" in o for o in out) or len(out) != 2:
        raise AssertionError(f"the CLI's run: {got}, {out}")
    if run != want:
        raise AssertionError(f"the CLI's launches {run}, reckoned {want}")
    ids = toks[0].decoded[0]
    n = min(len(ids), len(mem.tokens))
    _near_tie_rule("the CLI's c0 vs the in-memory tree's ask", torch.tensor([ids[:n]]),
                   mem.tokens[None, :n], log)
    return run


# ---------------------------------------------------------------------------
# The long-video slice
# ---------------------------------------------------------------------------

# The chunked caches of the 120 s slice against forward's, per layer and per
# cache. Forward runs the diagonal update in mm_chunks chunks of the stream;
# cuBLAS picks its bf16 products by row count, and rows of another count may
# round differently and carry it through the later layers (forward with
# mm_chunks 32 against 1 reads cosine 0.9996 on the 1,200 audio tokens, 38
# rows a chunk; H100 80GB HBM3, 700 W). The reference is forward with one
# chunk, whose products run on whole streams as media_prefill_chunked's do.
CACHE_COS = 0.9999
RESIZE_ATOL = 1e-2  # on the 0-255 scale: the resize on the card vs the CPU


def _cos(a, b) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def long_cache_check(sl) -> None:
    """media_prefill_chunked on the 120 s slice's media (chunks of 8,192
    tokens: the image stream in two whole chunks and a padded tail of
    7,136, the audio in one) against the caches of one query's forward
    (mm_chunks=1), layer by layer: cosine >= CACHE_COS for every layer of
    the four caches. The planted fault (each layer's chunked caches held
    against the layer before's) must fail it. Also printed: the least
    cosine against forward with the slice's mm_chunks=32, and that
    forward's against mm_chunks=1 (the rounding of other row counts)."""
    from vidi_tpu_torch.infer import generate as gen
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.models import dattn

    prompt, mask = P.build_prompt_batch([P.build_prompt_ids(QUERIES[0], sl.tok)])
    pr, pm = torch.as_tensor(prompt).long().to(sl.dev), torch.as_tensor(mask).to(sl.dev)

    def forward_caches(mm_chunks):
        return gen._prefill(sl.params, sl.cfg, pr, pm, *sl.media, max_new_tokens=32,
                            mm_chunks=mm_chunks, use_flash=True)[1]

    img, _, aud, _ = sl.media
    chunked = dattn.media_prefill_chunked(sl.params, sl.cfg, img, aud, chunk_tokens=8192)
    whole, split = forward_caches(1), forward_caches(32)
    names = ("img_k", "img_v", "aud_k", "aud_v")
    n_layers = whole.img_k.shape[0]

    def least(a, b, shift=0):
        return min(_cos(getattr(a, n)[i], getattr(b, n)[i - shift])
                   for n in names for i in range(shift, n_layers))

    got, fault = least(chunked, whole), least(chunked, whole, shift=1)
    print(f"  120 s caches, media_prefill_chunked(chunk_tokens=8192) vs forward "
          f"(mm_chunks=1): least cosine over {n_layers} layers x {len(names)} caches "
          f"{got:.6f} (limit {CACHE_COS}); planted fault (layer i against forward's layer "
          f"i - 1) {fault:.6f}; against forward with mm_chunks=32 {least(chunked, split):.6f}, "
          f"forward mm_chunks=32 vs 1 {least(split, whole):.6f}")
    if not got >= CACHE_COS:
        raise AssertionError("the chunked media caches disagree with forward's")
    if fault >= CACHE_COS:
        raise AssertionError("the cache limit does not reject the planted fault")


# The bf16 forward's dependence on mm_chunks (the chunking of the streams'
# diagonal update), read on the first MMC_LAYERS layers of the 9B on the
# 120 s media: forward with mm_chunks 1 and 32, each against an fp32 forward
# of the same layers and inputs (plain attention, TF32 off), over the text
# hidden states and each layer's image / audio caches. Exact arithmetic gives
# the same result for every chunking, so the chunked run must lie no farther
# from fp32 than MMC_FACTOR times the whole-stream run's distance (1 - cosine).
MMC_LAYERS, MMC_CHUNKS, MMC_FACTOR = 4, 32, 2.0


def mm_chunks_reading(sl) -> dict:
    """The readings above (-> {output: (1 - cos, rel err) by run}); fails if
    the chunked run drifts beyond MMC_FACTOR, or if the planted fault (the
    chunked run's audio stream left without its diagonal update in the last
    chunk) stays inside it."""
    import dataclasses

    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.models import dattn, decoder

    prompt, mask = P.build_prompt_batch([P.build_prompt_ids(QUERIES[0], sl.tok)])
    ids, pm = torch.as_tensor(prompt).long().to(sl.dev), torch.as_tensor(mask).to(sl.dev)
    pos = torch.clamp(torch.cumsum(pm.long(), dim=1) - 1, min=0)
    cfg = dataclasses.replace(sl.cfg, text=dataclasses.replace(sl.cfg.text,
                                                               num_layers=MMC_LAYERS))
    text = sl.params["text"]
    p16 = {"text": {"layers": text["layers"][:MMC_LAYERS], "final_ln": text["final_ln"]}}
    p32 = _tree_map(lambda t: t.float(), p16)
    emb = decoder.embed_tokens(text, ids, cfg.text)
    img, img_mask, aud, aud_mask = sl.media

    def run(params, dtype, k, flash):
        h, c = dattn.forward(params, cfg, emb.to(dtype), pm, pos, img.to(dtype), img_mask,
                             aud.to(dtype), aud_mask, mm_chunks=k, return_caches=True,
                             use_flash=flash)
        return {"h": h.float(), **{n: getattr(c, n).float()
                                   for n in ("img_k", "img_v", "aud_k", "aud_v")}}

    ref = run(p32, torch.float32, 1, False)
    runs = {"mm_chunks=1": run(p16, torch.bfloat16, 1, True),
            f"mm_chunks={MMC_CHUNKS}": run(p16, torch.bfloat16, MMC_CHUNKS, True)}
    real = dattn._diag_update
    size = -(-aud.shape[1] // MMC_CHUNKS)  # rows a chunk; the audio's last is shorter
    last = aud.shape[1] - size * (aud.shape[1] // size)

    def tail_dropped(lp, stream, v, o_w, tcfg):
        return stream if stream.shape[1] == last else real(lp, stream, v, o_w, tcfg)

    with _swap(dattn, _diag_update=tail_dropped):
        fault = run(p16, torch.bfloat16, MMC_CHUNKS, True)

    def gap(got, want):
        return {n: (1 - _cos(got[n], want[n]),
                    float((got[n] - want[n]).abs().max() / want[n].abs().max()))
                for n in want}

    out = {name: gap(r, ref) for name, r in runs.items()}
    out["planted fault"] = gap(fault, ref)
    whole, split = out["mm_chunks=1"], out[f"mm_chunks={MMC_CHUNKS}"]
    between = gap(runs[f"mm_chunks={MMC_CHUNKS}"], runs["mm_chunks=1"])
    for name in ref:
        print(f"  Q3.10, 9B first {MMC_LAYERS} layers, 120 s media, {name}: vs fp32 "
              + ", ".join(f"{run} 1-cos {g[name][0]:.3e} rel {g[name][1]:.3e}"
                          for run, g in out.items())
              + f"; mm_chunks={MMC_CHUNKS} vs 1: 1-cos {between[name][0]:.3e}")
    ok = all(split[n][0] <= MMC_FACTOR * whole[n][0] for n in ref)
    seen = any(out["planted fault"][n][0] > MMC_FACTOR * whole[n][0] for n in ref)
    if not ok:
        raise AssertionError(f"the chunked forward drifts from fp32 beyond {MMC_FACTOR}x "
                             "the whole-stream forward's distance")
    if not seen:
        raise AssertionError("the mm_chunks reading does not see the planted fault")
    return out


def _long_clip(cfg):
    """The 600 s clip from SEED: uint8 frames at LONG_DECODE_HW (the
    decoder's output, resized on the card) and the mel windows of a 16 kHz
    waveform (tones + noise)."""
    from vidi_tpu_torch.infer import pipeline as P

    rng = np.random.default_rng(SEED + 10)
    frames = rng.integers(0, 256, (LONG_SECONDS, *LONG_DECODE_HW, 3), dtype=np.uint8)
    sr = cfg.audio.sampling_rate
    t = np.arange(LONG_SECONDS * sr, dtype=np.float32) / sr
    wave = (0.3 * np.sin(2 * np.pi * 330.0 * t) + 0.05 * rng.standard_normal(t.shape)
            ).astype(np.float32)
    mels, audio_len = P.process_audio(wave, cfg.audio)
    return frames, mels, audio_len


def _resize_check(dev, frames, size: int) -> None:
    """The device resize of a few decoded frames on the card against the
    CPU within RESIZE_ATOL; the planted fault (no antialiasing) must fail."""
    from vidi_tpu_torch.ops.preprocess import resize_bicubic

    x = torch.from_numpy(frames)
    want = resize_bicubic(x, size)
    err = float((resize_bicubic(x.to(dev), size).cpu() - want).abs().max())
    nchw = x.permute(0, 3, 1, 2).float().to(dev)
    plain = torch.nn.functional.interpolate(nchw, size=(size, size), mode="bicubic",
                                            align_corners=False).clamp(0, 255)
    fault = float((plain.permute(0, 2, 3, 1).cpu() - want).abs().max())
    print(f"  device resize {tuple(frames.shape[1:3])} -> {size}x{size}, card vs cpu: "
          f"max_abs_err={err:.3e} (limit {RESIZE_ATOL}); planted fault (no antialias) "
          f"{fault:.3e}")
    if not err <= RESIZE_ATOL:
        raise AssertionError("the device resize disagrees with the CPU")
    if fault <= RESIZE_ATOL:
        raise AssertionError("the resize limit does not reject the planted fault")


def _long_prompts(sl):
    """The three TR queries' prompts, right-padded to one length, on the card."""
    from vidi_tpu_torch.infer import pipeline as P

    prompt, mask = P.build_prompt_batch([P.build_prompt_ids(q, sl.tok) for q in QUERIES])
    return torch.as_tensor(prompt).long().to(sl.dev), torch.as_tensor(mask).to(sl.dev)


def _step0(sl, pr, pm, media, media_caches=None):
    """Logits [B,V] of the token each row's prefill chooses: the full forward
    over the media features, or (media_caches) the text prefill against
    them (media then gives the masks)."""
    from vidi_tpu_torch.infer import generate as gen
    from vidi_tpu_torch.models import decoder

    img, img_mask, aud, aud_mask = media
    if media_caches is not None:
        img = aud = None
    h, _, lens = gen._prefill(sl.params, sl.cfg, pr, pm, img, img_mask, aud, aud_mask,
                              max_new_tokens=32, mm_chunks=32, use_flash=True,
                              media_caches=media_caches)
    h_last = h[torch.arange(h.shape[0], device=h.device), lens - 1]
    return decoder.lm_logits(sl.params["text"], h_last, sl.cfg.text)


def _gib(nbytes: float) -> str:
    return f"{nbytes / 2**30:.2f} GiB"


def long_video_phase(sl) -> tuple:
    """The long-video path at full width: a streamed encode of the 600 s
    clip with the resize on the card, the one-row plain path's step-0
    logits (full forward; its caches dropped), the media caches prefilled
    once in chunks, then three TR queries as three rows folded onto the
    shared caches and one of them alone, and the checks. -> (the path's
    kernel launches, the clip's state for the profile)."""
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.infer.generate import generate
    from vidi_tpu_torch.models import dattn

    cfg, tok, dev, params = sl.cfg, sl.tok, sl.dev, sl.params
    n_layers = cfg.text.num_layers
    frames, mels, audio_len = _long_clip(cfg)
    _resize_check(dev, frames[:4], cfg.vision.image_size)

    # 1. streamed encode, chunks shipped at their decode resolution
    _reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chunks = (frames[a:a + LONG_CHUNK_FRAMES] for a in range(0, LONG_SECONDS, LONG_CHUNK_FRAMES))
    media = P.encode_frame_stream(params, cfg, chunks, LONG_SECONDS, mels, audio_len,
                                  mm_chunks=32, use_flash=True, device_resize=True)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    img, img_mask, aud, aud_mask = media
    path = _kernel_counts()
    hw = P.budget_hw(LONG_SECONDS, cfg.mm_image_pool_size, cfg.vision.num_patches_per_side)
    side = hw[0] // cfg.mm_image_pool_size
    print(f"  streamed encode: {LONG_SECONDS} frames {LONG_DECODE_HW[0]}x{LONG_DECODE_HW[1]} "
          f"in {LONG_SECONDS // LONG_CHUNK_FRAMES} chunks of {LONG_CHUNK_FRAMES} (device "
          f"resize) + {mels.shape[0]} audio windows -> img {tuple(img.shape)} "
          f"({int(img_mask.sum())} valid; budget_hw {hw}: {side}x{side} tokens a frame), "
          f"aud {tuple(aud.shape)} ({int(aud_mask.sum())} valid) in {encode_s:.3f} s; "
          f"K2 launches {path['tower_attention']}; peak "
          f"{_gib(torch.cuda.max_memory_allocated())}")
    if img.shape != (1, LONG_IMG_S, cfg.text.hidden_size) or \
            aud.shape != (1, LONG_AUD_S, cfg.text.hidden_size) or \
            LONG_SECONDS * side * side != LONG_IMG_S:
        raise AssertionError("unexpected long-video feature shapes")
    if not (torch.isfinite(img).all() and torch.isfinite(aud).all()):
        raise AssertionError("non-finite long-video features")

    # 2. the one-row plain path: full forward over the streams, caches dropped
    pr, pm = _long_prompts(sl)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plain = _step0(sl, pr[:1], pm[:1], media)
    torch.cuda.synchronize()
    print(f"  one-row plain path (full forward at {LONG_SECONDS} s): "
          f"{time.perf_counter() - t0:.3f} s, peak {_gib(torch.cuda.max_memory_allocated())}")
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the media caches, prefilled once in chunks
    _reset_kernel_counts()
    param_bytes = sum(_nbytes(t) for t in _leaves(params))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    caches = dattn.media_prefill_chunked(params, cfg, img, aud, chunk_tokens=LONG_CHUNK_TOKENS)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache_bytes = _nbytes(caches.img_k, caches.img_v, caches.aud_k, caches.aud_v)
    n_chunks = -(-LONG_IMG_S // LONG_CHUNK_TOKENS)
    print(f"  media_prefill_chunked(chunk_tokens={LONG_CHUNK_TOKENS}): {n_chunks} image "
          f"chunks (tail {LONG_IMG_S - (n_chunks - 1) * LONG_CHUNK_TOKENS} padded) + 1 audio "
          f"chunk in {prefill_s:.3f} s; caches {_gib(cache_bytes)} "
          f"({LONG_IMG_S + LONG_AUD_S} tokens x {n_layers} layers x 8,192 B), weights "
          f"{_gib(param_bytes)}, peak {_gib(torch.cuda.max_memory_allocated())} (reckoned "
          f"~{_gib(cache_bytes + param_bytes + _nbytes(img, aud) + 2.6e9)} with one "
          f"chunk's ~2.6 GB of transients)")

    # 4. three TR queries folded onto the shared caches, and one alone
    eos = P.pick_eos(cfg, tok)
    for rows in (3, 1):
        before = _kernel_counts()
        res = generate(params, cfg, pr[:rows], pm[:rows], img_mask=img_mask,
                       aud_mask=aud_mask, max_new_tokens=32, eos_id=eos, use_flash=True,
                       use_flash_decode=True, media_caches=caches)
        run = {k: v - before[k] for k, v in _kernel_counts().items()}
        steps = res.decode_steps
        # K1: each layer's T2T, T2V and T2A prefill; the folded rows' T2V and
        # T2A in each decode step. K3: each step's T2T, and one row's T2V / T2A
        want = ({"flash_attention": n_layers * (3 + 2 * steps),
                 "decode_attention": n_layers * steps} if rows > 1 else
                {"flash_attention": 3 * n_layers, "decode_attention": 3 * n_layers * steps})
        answers = []
        for r in range(rows):
            toks = res.tokens[r, : int(res.lengths[r])].cpu()
            if not ((toks >= 0) & (toks < cfg.text.vocab_size)).all():
                raise AssertionError("generated ids outside the vocabulary")
            text = tok.decode(toks.numpy(), skip_special_tokens=True).strip()
            answers.append(P.parse_task_output(text, "tr", float(LONG_SECONDS)))
        route = "folded K1" if rows > 1 else "K3"
        print(f"  {rows} row(s) on the shared caches: prefill {res.prefill_s:.3f} s, decode "
              f"{steps} steps {res.decode_s:.3f} s = {steps / res.decode_s:.2f} tok/s "
              f"({route} decode route, {rows * steps / res.decode_s:.2f} tokens/s over the "
              f"rows); launches K1 {run['flash_attention']}, K2 {run['tower_attention']}, K3 "
              f"{run['decode_attention']} (reckoned K1 {want['flash_attention']}, K3 "
              f"{want['decode_attention']}); answers {answers}")
        if {k: run[k] for k in want} != want:
            raise AssertionError(f"the {rows}-row queries did not take the {route} routes")
    torch.cuda.synchronize()
    path = {k: v + path[k] for k, v in _kernel_counts().items()}
    print(f"  kernel launches on the long-video path (encode, media prefill, queries): "
          f"{path}; peak {_gib(torch.cuda.max_memory_allocated())}")
    if min(path.values()) == 0:
        raise AssertionError(f"a kernel of the long-video path was never launched: {path}")

    # 5. checks, under the step-0 logit limits of the decode routes
    readings = {}
    readings["shared caches, one row, vs the one-row plain path"] = _logit_gap(
        _step0(sl, pr[:1], pm[:1], media, caches), plain)
    folded = _step0(sl, pr, pm, media, caches)
    alone = torch.cat([_step0(sl, pr[r:r + 1], pm[r:r + 1], media, caches) for r in range(3)])
    readings["three folded rows vs the rows one by one"] = _logit_gap(folded, alone)
    real = dattn._unfold_rows
    dattn._unfold_rows = lambda out, bq, tq: real(out, bq, tq).roll(1, 0)
    try:
        faults = {"planted fault, rows unfolded in the wrong order": _logit_gap(
            _step0(sl, pr, pm, media, caches), alone)}
    finally:
        dattn._unfold_rows = real
    tail = (n_chunks - 1) * LONG_CHUNK_TOKENS
    for name in ("img_k", "img_v"):  # the last check: it spoils the caches
        getattr(caches, name)[:, :, :, tail:].zero_()
    faults["planted fault, the tail chunk's caches left zero"] = _logit_gap(
        _step0(sl, pr[:1], pm[:1], media, caches), plain)
    for name, (rel, cos) in {**readings, **faults}.items():
        print(f"  step-0 logits, {name}: max_abs_err = {rel:.3e} of max|logit| (limit "
              f"{LOGIT_REL}), cosine {cos:.6f} (limit {LOGIT_COS})")
    for name, (rel, cos) in readings.items():
        if not (rel <= LOGIT_REL and cos >= LOGIT_COS):
            raise AssertionError(f"long video: {name} outside the limits")
    for name, (rel, cos) in faults.items():
        if rel <= LOGIT_REL and cos >= LOGIT_COS:
            raise AssertionError(f"long video: the limits do not reject the {name}")
    del caches
    gc.collect()
    torch.cuda.empty_cache()
    return path, types.SimpleNamespace(frames=frames, mels=mels, audio_len=audio_len,
                                       media=media, prompts=(pr, pm))


def profile_long(sl, clip) -> None:
    """torch.profiler over the long-video path (see `_region`): the streamed
    encode, the chunked media prefill (its caches dropped after each run),
    the shared-cache text prefill of three folded rows and of one row, and
    PROFILE_DECODE_STEPS decode steps of each on its route (folded K1, one
    row K3)."""
    from vidi_tpu_torch.infer import generate as gen
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.models import dattn, decoder

    params, cfg = sl.params, sl.cfg
    img, img_mask, aud, aud_mask = clip.media

    def encode():
        chunks = (clip.frames[a:a + LONG_CHUNK_FRAMES]
                  for a in range(0, LONG_SECONDS, LONG_CHUNK_FRAMES))
        return P.encode_frame_stream(params, cfg, chunks, LONG_SECONDS, clip.mels,
                                     clip.audio_len, mm_chunks=32, use_flash=True,
                                     device_resize=True)

    def media_prefill():
        return dattn.media_prefill_chunked(params, cfg, img, aud,
                                           chunk_tokens=LONG_CHUNK_TOKENS)

    _region(f"long encode ({LONG_SECONDS} frames, device resize)", lambda: (encode(), None)[1])
    _region(f"media_prefill_chunked ({LONG_SECONDS} s)", lambda: (media_prefill(), None)[1])
    caches = media_prefill()
    pr, pm = clip.prompts
    for rows in (3, 1):
        def prefill():
            h, c, lens = gen._prefill(params, cfg, pr[:rows], pm[:rows], None, img_mask,
                                      None, aud_mask, max_new_tokens=32, mm_chunks=32,
                                      use_flash=True, media_caches=caches)
            h_last = h[torch.arange(rows, device=h.device), lens - 1]
            tok0 = decoder.lm_logits(params["text"], h_last, cfg.text).argmax(-1)
            return c, lens, decoder.embed_tokens(params["text"], tok0[:, None], cfg.text)

        c, lens, emb = _region(f"shared-cache text prefill, {rows} row(s)", prefill)

        def steps():
            cur, e = lens.clone(), emb
            for _ in range(PROFILE_DECODE_STEPS):
                logits = dattn.decode_step(params, cfg, e, cur, c, img_mask=img_mask,
                                           aud_mask=aud_mask, use_flash=True)[0]
                e = decoder.embed_tokens(params["text"], logits.argmax(-1)[:, None], cfg.text)
                cur = cur + 1
            return logits

        route = "folded K1" if rows > 1 else "K3"
        _region(f"decode on the shared caches, {rows} row(s), {route} route "
                f"x{PROFILE_DECODE_STEPS}", steps)
    del caches
    gc.collect()
    torch.cuda.empty_cache()


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
    cache's rule (no copy of a weight stored K-major, as the towers' are; a
    copy per weight not held; least recently used out once the copies'
    bytes pass `limit`; an entry leaves when its weight dies).
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
                        for k in ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w")
                        if not lp[k]["qi8"].t().is_contiguous()]
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
    tower = _tower_launches(cfg, n_frames, n_windows, mm_chunks)
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
    held to the reckoned counts; then the daemon on the int8 model
    (`int8_daemon`). -> (the slice's launches, the daemon's)."""
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
    tower_copies = k6.launches["kmajor_copy"]  # the encode runs the towers alone
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
    want_towers = reckon_kmajor_copies(sl.params, cfg, len(sl.frames), sl.mels.shape[0],
                                       streams, 0, qz.w8a8_min_tokens, k6.KMAJOR.limit_bytes)
    print(f"  K-major copies: towers {tower_copies} (reckoned {want_towers}), text "
          f"{launches['kmajor_copy'] - tower_copies} (reckoned "
          f"{want['kmajor_copy'] - want_towers})")
    if tower_copies != want_towers:
        raise AssertionError(f"the encode made {tower_copies} K-major copies of tower "
                             f"weights, {want_towers} reckoned")
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
    return launches, int8_daemon(sl)


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
# The checkpoint slice: save_pretrained and load_model at full width
# ---------------------------------------------------------------------------

# Random init leaves biases at 0 and norm weights at 0 or 1, so a dropped or
# swapped tensor could read equal to the one written: every floating leaf
# gets seeded noise of CKPT_NOISE times its standard deviation (1 for a
# constant leaf) first.
CKPT_NOISE = 0.05
CKPT_MARGIN = 2**30  # free disk demanded beyond the reckoned file bytes
# the planted faults: one square tensor left untransposed (SigLIP's q_w is
# 1152 x 1152), two text layers swapped, one tensor read one element off
# its offset, one bias dropped (each must fail the bit-equal tree check)
CKPT_UNTRANSPOSED = "encoder.layers.0.self_attn.q_proj.weight"
CKPT_SHIFTED = "model.layers.0.self_attn.o_proj.weight"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _distinct(params, seed: int) -> None:
    """CKPT_NOISE (above) on every floating leaf, from `seed`, in place."""
    gen = None
    with torch.no_grad():
        for t in _leaves(params):
            if not t.is_floating_point():
                continue
            if gen is None:
                gen = torch.Generator(device=t.device).manual_seed(seed)
            std = float(t.float().std()) if t.numel() > 1 else 0.0
            noise = torch.randn(t.shape, generator=gen, device=t.device)
            t.add_((noise * (CKPT_NOISE * (std or 1.0))).to(t.dtype))


def _tree_diff(got, want, path: str = "") -> list:
    """The paths where two trees differ in keys, length, dtype, shape or
    any bit of a value."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [f"{path} keys {sorted(set(got) ^ set(want)) if isinstance(got, dict) else got}"]
        return [d for k in want for d in _tree_diff(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return [f"{path} length"]
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in _tree_diff(g, w, f"{path}/{i}")]
    same = (isinstance(got, torch.Tensor) and got.dtype == want.dtype
            and got.shape == want.shape and torch.equal(got, want))
    return [] if same else [path]


def _write_clip(frames, path: str) -> None:
    """The 120 s clip's frames as an mp4 at 1 fps (cv2 writes no audio
    track, so ask reads silence: load_audio's fallback)."""
    import cv2

    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 1, (w, h))
    if not writer.isOpened():
        raise AssertionError(f"cv2 cannot write {path}")
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()


def _ask(params, cfg, tok, clip: str, quantize_caches: bool = False,
         query: str = QUERIES[0], flash_decode=None):
    """pipeline.ask on `query` (32 new tokens; bf16: the K3 decode route
    unless `flash_decode` is False) -> (answer, step-0 logits, generated
    tokens, seconds, generate's result)."""
    if flash_decode is None:
        flash_decode = not quantize_caches
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.models import decoder

    first, results = [], []
    real_logits, real_generate = decoder.lm_logits, P.generate

    def lm_logits(*a, **kw):
        out = real_logits(*a, **kw)
        if not first:
            first.append(out.float())
        return out

    def generate(*a, **kw):
        results.append(real_generate(*a, **kw))
        return results[-1]

    t0 = time.perf_counter()
    with _swap(decoder, lm_logits=lm_logits), _swap(P, generate=generate):
        answer = P.ask(query, clip, params, cfg, tok, max_new_tokens=32,
                       use_flash_decode=flash_decode, quantize_caches=quantize_caches)
    torch.cuda.synchronize()
    res = results[0]
    return types.SimpleNamespace(answer=answer, logits=first[0],
                                 tokens=res.tokens[0, : int(res.lengths[0])].cpu(),
                                 s=time.perf_counter() - t0, res=res)


def _vm_rss() -> int:
    """The process's resident set in bytes (/proc/self/status VmRSS: some
    kernels have no RssAnon and refuse a VmHWM reset)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise KeyError("VmRSS")


class _HostPeak:
    """Peak host memory over a `with` block: VmRSS sampled every 5 ms, and
    where it ends (a load or save keeps no staging buffer past its end)."""

    def __enter__(self):
        import threading

        self.base = self.peak = _vm_rss()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._sample, daemon=True)
        self.thread.start()
        return self

    def _sample(self):
        while not self.stop.wait(0.005):
            self.peak = max(self.peak, _vm_rss())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.end = _vm_rss()
        self.peak = max(self.peak, self.end)

    def __str__(self):
        return (f"host VmRSS {_gib(self.base)} -> peak {_gib(self.peak)} "
                f"(+{_gib(self.peak - self.base)}, sampled every 5 ms) -> "
                f"{_gib(self.end)} after")


def _ckpt_faults():
    """{name: a context that plants the fault in load_model's path}."""
    from vidi_tpu_torch.infer import convert as C
    from vidi_tpu_torch.infer import loader as L

    real_getter, real_index = C._getter, L.load_safetensors_dir

    def getter(rename=None, untranspose=None):
        def make(sd, prefix, dtype, device):
            get = real_getter(sd, prefix, dtype, device)

            def faulty(name, transpose=False):
                if rename is not None:
                    name = rename(prefix, name)
                return get(name, transpose and name != untranspose)
            return faulty
        return make

    def swap01(prefix, name):
        if prefix == "model." and name.startswith(("layers.0.", "layers.1.")):
            return ("layers.1." if name[7] == "0" else "layers.0.") + name[9:]
        return name

    def shifted(path):
        index = real_index(path)
        ref = index.refs[CKPT_SHIFTED]
        index.refs[CKPT_SHIFTED] = ref._replace(offset=ref.offset + ref.nbytes // math.prod(ref.shape))
        return index

    return {
        f"SigLIP {CKPT_UNTRANSPOSED} left untransposed":
            _swap(C, _getter=getter(untranspose=CKPT_UNTRANSPOSED)),
        "text layers 0 and 1 swapped": _swap(C, _getter=getter(rename=swap01)),
        f"{CKPT_SHIFTED} read one element past its offset":
            _swap(L, load_safetensors_dir=shifted),
        "SigLIP q_proj bias dropped":
            _swap(C, VIT_LAYER_NAMES={k: v for k, v in C.VIT_LAYER_NAMES.items()
                                      if k != "q_b"}),
    }


def _quant_diff(q, params) -> list:
    """The int8 load against quantizing the full-precision tree, layer by
    layer (one quantized layer alive at a time)."""
    from vidi_tpu_torch.infer import quantize as qz

    diff = []
    for module, fn in (("text", qz.quantize_text_layer), ("vision", qz.quantize_tower_layer),
                       ("audio", qz.quantize_tower_layer)):
        for i, lp in enumerate(params[module]["layers"]):
            diff += _tree_diff(q[module]["layers"][i], fn(lp), f"/{module}/layers/{i}")
        diff += _tree_diff({k: v for k, v in q[module].items() if k != "layers"},
                           {k: v for k, v in params[module].items() if k != "layers"},
                           f"/{module}")
    return diff + _tree_diff(q["mm"], params["mm"], "/mm")


def checkpoint_phase(sl) -> tuple:
    """Vidi1.5-9B at full width through save_pretrained and load_model on
    the card, in a temporary directory, the in-memory tree made distinct
    first (_distinct) and then dropped from `sl`. -> (the bf16 asks'
    launches, the int8 ask's, the daemon CLI's)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="vidi_ckpt_")
    try:
        return _checkpoint_steps(sl, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _checkpoint_steps(sl, tmp: str) -> tuple:
    import shutil

    from vidi_tpu_torch.infer import export as E
    from vidi_tpu_torch.infer import loader as L
    from vidi_tpu_torch.infer import quantize as qz
    from vidi_tpu_torch.infer import safetensors_io as sio

    dev, cfg, params = sl.dev, sl.cfg, sl.params
    card = _card()
    _distinct(params, SEED + 20)
    clip = os.path.join(tmp, "clip.mp4")
    _write_clip(sl.frames, clip)

    # (d)'s reference: the in-memory tree's ask, twice
    _reset_kernel_counts()
    mem = [_ask(params, cfg, sl.tok, clip) for _ in range(2)]
    self_gap = float((mem[0].logits - mem[1].logits).abs().max())
    print(f"  ask on the in-memory tree (K2 encode, K1 prefill, K3 decode): {mem[0].s:.3f} / "
          f"{mem[1].s:.3f} s, {len(mem[0].tokens)} tokens, answer {mem[0].answer!r}; "
          f"two runs: step-0 logits max|diff| {self_gap:.3e}, tokens equal "
          f"{torch.equal(mem[0].tokens, mem[1].tokens)}")

    # (b) write, after checking the disk
    out = os.path.join(tmp, "vidi15_9b")
    need = sum(sio.nbytes(t) for t in E.export_state_dict(params, cfg).values())
    free = shutil.disk_usage(tmp).free
    print(f"  disk: {free / 1e9:.3f} GB free under {tmp}, {need / 1e9:.3f} GB of tensors "
          f"reckoned (+{CKPT_MARGIN / 2**30:.0f} GiB margin)")
    if free < need + CKPT_MARGIN:
        raise AssertionError(f"{free} bytes free for a checkpoint of {need} bytes "
                             f"(+{CKPT_MARGIN} margin)")
    torch.cuda.synchronize()
    with _HostPeak() as host_w:
        t0 = time.perf_counter()
        E.save_pretrained(params, cfg, out)
        write_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(out, "model.safetensors"))

    # (c) load back: every tensor bit-equal, the configuration equal
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _HostPeak() as host_r:
        t0 = time.perf_counter()
        loaded, lcfg, ltok = L.load_model(model_path=out, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    dev_peak = torch.cuda.max_memory_allocated() - base
    n_tensors = sum(1 for _ in _leaves(loaded))
    diff = _tree_diff(loaded, params)
    cfg_ok = L.config_from_hf(E.config_to_hf(cfg)) == cfg and lcfg == cfg
    print(f"  card: {card}")
    print(f"  save_pretrained: {nbytes} bytes ({nbytes / 1e9:.3f} GB) in {write_s:.3f} s = "
          f"{nbytes / 1e9 / write_s:.3f} GB/s (fsync included); {host_w}")
    print(f"  load_model(model_path) of the file just written: {load_s:.3f} s = "
          f"{nbytes / 1e9 / load_s:.3f} GB/s; {host_r}; device peak above the "
          f"resident tree {_gib(dev_peak)} (tree {_gib(base)} resident)")
    print(f"  loaded tree: {n_tensors} tensors, {len(diff)} differ from the written ones "
          f"{diff[:4]}; config_from_hf(config_to_hf(cfg)) == cfg and the loaded config "
          f"equal: {cfg_ok}")
    if diff or not cfg_ok:
        raise AssertionError("the checkpoint does not load back bit-equal")

    # (d) ask on the loaded tree
    got = _ask(loaded, lcfg, ltok, clip)
    gap = float((got.logits - mem[0].logits).abs().max())
    launches = _kernel_counts()
    print(f"  ask on the loaded tree: {got.s:.3f} s, answer {got.answer!r}; step-0 logits "
          f"max|diff| vs the in-memory tree {gap:.3e} (the tree against itself "
          f"{self_gap:.3e}), tokens equal {torch.equal(got.tokens, mem[0].tokens)}; "
          f"launches over the three asks {launches}")
    if not (torch.equal(got.tokens, mem[0].tokens) and gap <= self_gap
            and got.answer == mem[0].answer):
        raise AssertionError("the loaded tree's ask differs from the in-memory tree's")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    del loaded, got
    gc.collect()
    torch.cuda.empty_cache()

    # (f) planted faults, each through the whole load: the tree check must
    # see each one (an exception fails the run, it is not a fault caught)
    for name, fault in _ckpt_faults().items():
        with fault:
            bad = L.load_model(model_path=out, device=dev)[0]
        found = _tree_diff(bad, params)
        del bad
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  planted fault, {name}: {len(found)} tensors differ {found[:2]}")
        if not found:
            raise AssertionError(f"the tree check does not see the planted fault: {name}")

    # (e) the int8 load from the directory
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _HostPeak() as host_q:
        t0 = time.perf_counter()
        q, qcfg, qtok = L.load_model(model_path=out, device=dev, load_8bit=True,
                                     load_8bit_towers=True)
        torch.cuda.synchronize()
        q_s = time.perf_counter() - t0
    q_peak = torch.cuda.max_memory_allocated() - base
    qdiff = _quant_diff(q, params)
    print(f"  load_model(load_8bit=True, load_8bit_towers=True): {q_s:.3f} s (page cache "
          f"warm), {_gib(_nbytes(*_leaves(q)))} of parameters, device peak above the "
          f"resident tree {_gib(q_peak)}; {host_q}; {len(qdiff)} tensors differ from "
          f"quantizing the in-memory tree {qdiff[:4]}")
    if qdiff:
        raise AssertionError("the int8 load differs from quantizing the in-memory tree")
    del params
    sl.params = None
    gc.collect()
    torch.cuda.empty_cache()
    qz.w8a8_min_tokens = W8A8_MIN_TOKENS
    _reset_int8_counts()
    try:
        r8 = _ask(q, qcfg, qtok, clip, quantize_caches=True)
    finally:
        qz.w8a8_min_tokens = None
    launches8 = _read_int8_counts()
    print(f"  int8 ask (W8A8 from {W8A8_MIN_TOKENS} rows, int8 caches): {r8.s:.3f} s, "
          f"{len(r8.tokens)} tokens, answer {r8.answer!r}; launches {launches8}")
    if not torch.isfinite(r8.logits).all():
        raise AssertionError("non-finite int8 logits")
    if min(launches8[k] for k in ("ln_qkv", "o_residual", "ln_ffn", "quant_matmul",
                                  "quant_gated_mlp")) == 0:
        raise AssertionError(f"a K5 / K6 kernel was never launched: {launches8}")

    # (g) the daemon's CLI on the directory, the phase's other trees freed
    del q
    gc.collect()
    torch.cuda.empty_cache()
    cli = serve_cli(sl, out, clip, mem[0])
    return launches, launches8, cli


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Vidi-7B: Mistral (G = 4), CLIP ViT-L/14, the v1 adapters
# ---------------------------------------------------------------------------

SECONDS_7B = 120


def load_7b(dev):
    """Vidi-7B at full width on random weights, and the synthetic 120 s
    clip at CLIP's 224 px with its mel windows."""
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.infer.loader import load_model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cfg, tok = load_model(random_weights="7b", dtype=torch.bfloat16, device=dev,
                                  seed=SEED)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params, n_bytes = sum(t.numel() for t in leaves), _nbytes(*leaves)
    print(f"  load_model(random_weights='7b'): {n_params / 1e9:.3f} B values, weights "
          f"{n_bytes / 1e9:.3f} GB, {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB ({_card()})")
    frames, wave = _synthetic_clip(SECONDS_7B, cfg.vision.image_size, cfg.audio.sampling_rate)
    mels, audio_len = P.process_audio(wave, cfg.audio)
    return types.SimpleNamespace(dev=dev, params=params, cfg=cfg, tok=tok, seconds=SECONDS_7B,
                                 frames=frames, mels=mels, audio_len=audio_len, media=None)


def _reckon_7b(cfg, n_frames: int, n_windows: int, encodes: int, prefills: int,
               k3_steps: int) -> dict:
    """K1 / K2 / K3 launches: K2 once a CLIP / Whisper layer a frame or
    window chunk an encode (`_tower_launches`), K1 three a layer a prefill
    (T2T, T2V, T2A), K3 three a layer a decode step on the K3 route."""
    per_layer = 3 * cfg.text.num_layers
    return {"flash_attention": per_layer * prefills,
            "tower_attention": encodes * _tower_launches(cfg, n_frames, n_windows),
            "decode_attention": per_layer * k3_steps}


def serve_7b_phase(s7) -> dict:
    """One encode of the 120 s clip's arrays, then the clip written as an
    mp4 and asked three TR queries on the plain decode route and one on
    the K3 route (32 new tokens each; each ask encodes the mp4 again):
    launches held to the reckoned ones, the v1 prompt and parse, the step-0
    logits of the two routes (a planted fault: K3 with G = 2's grouping)."""
    import re
    import tempfile

    from vidi_tpu_torch.infer import pipeline as P

    cfg, smi = s7.cfg, _card()
    _reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s7.media = img, img_mask, aud, aud_mask = _encode(s7)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    n_img = s7.seconds * cfg.mm_image_pool_size**2
    n_win = s7.mels.shape[0]
    print(f"  encode: {s7.seconds} frames {s7.frames.shape[1]}x{s7.frames.shape[2]} + "
          f"{n_win} audio windows -> img {tuple(img.shape)} ({int(img_mask.sum())} valid), "
          f"aud {tuple(aud.shape)} ({int(aud_mask.sum())} valid) in {encode_s:.3f} s ({smi})")
    if img.shape != (1, n_img, cfg.text.hidden_size) or \
            aud.shape != (1, n_win * 300, cfg.text.hidden_size):
        raise AssertionError("unexpected 7B media feature shapes")
    for name, x in (("img", img), ("aud", aud)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"non-finite 7B {name} features")
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip7b.mp4")
        _write_clip(s7.frames, clip)
        pixels, mels, _ = P.decode_media_host(clip, cfg)
        runs = [(_ask(s7.params, cfg, s7.tok, clip, query=q, flash_decode=False), False)
                for q in QUERIES]
        runs.append((_ask(s7.params, cfg, s7.tok, clip, flash_decode=True), True))
    torch.cuda.synchronize()
    launches = _kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    k3_steps = runs[-1][0].res.decode_steps
    want = _reckon_7b(cfg, pixels.shape[0], mels.shape[0], 1 + len(runs), len(runs), k3_steps)
    print(f"  kernel launches: {launches} (reckoned {want}: {len(runs) + 1} encodes of "
          f"{pixels.shape[0]} frames and {mels.shape[0]} windows, {len(runs)} prefills, "
          f"{k3_steps} K3-route decode steps)")
    if launches != want:
        raise AssertionError(f"7B launches {launches}, reckoned {want}")
    spans = re.compile(r"^(\d+:\d\d:\d+\.\d\d-\d+:\d\d:\d+\.\d\d(, )?)*$")
    for r, flash in runs:
        res = r.res
        if not ((r.tokens >= 0) & (r.tokens < cfg.text.vocab_size)).all():
            raise AssertionError("generated ids outside the vocabulary")
        if not spans.match(r.answer):
            raise AssertionError(f"the v1 answer {r.answer!r} is not v1 spans")
        print(f"  ask ({'K3' if flash else 'plain'} decode route): prefill {res.prefill_s:.3f} s, "
              f"decode {res.decode_steps} steps {res.decode_s:.3f} s = "
              f"{res.decode_steps / res.decode_s:.2f} tok/s, ask {r.s:.2f} s, "
              f"answer {r.answer!r}")
    if not torch.equal(runs[-1][0].tokens[:1], runs[0][0].tokens[:1]):
        raise AssertionError("the first token must not depend on the decode route")
    probe = P.format_spans(P.parse_time_ranges("12.5-30.25, 40-55", "v1"), 1.0, "v1")
    print(f"  v1 parse: '12.5-30.25, 40-55' at length 1 -> {probe!r}")
    if probe != "00:00:12.00-00:00:30.00, 00:00:40.00-00:00:55.00":
        raise AssertionError(f"v1 format_spans gave {probe!r}")
    plain_rate = statistics.mean(r.res.decode_steps / r.res.decode_s for r, f in runs if not f)
    k3 = runs[-1][0].res
    _, caches, _, _ = _prefill(s7, QUERIES[0])
    cache_bytes = _nbytes(*[c for c in caches if c is not None])
    tokens = caches.text_k.shape[3] + caches.img_k.shape[3] + caches.aud_k.shape[3]
    del caches
    print(f"  caches: {cache_bytes / 2**30:.3f} GiB for {tokens} tokens "
          f"({cache_bytes / tokens / 1024:.0f} KiB a token); decode tok/s: plain route "
          f"{plain_rate:.2f}, K3 route {k3.decode_steps / k3.decode_s:.2f}; encode "
          f"{encode_s:.3f} s, prefill {statistics.mean(r.res.prefill_s for r, _ in runs):.3f} s; "
          f"peak device memory {peak:.2f} GiB ({smi})")
    print("  decode routes (7B):")
    decode_route_check(s7, ("K3 with G = 2's grouping", _k3_g2))
    return launches


def profile_7b(s7) -> None:
    """torch.profiler over PROFILE_DECODE_STEPS decode steps of the 7B on
    the K3 route (see `_region`)."""
    from vidi_tpu_torch.models import decoder

    _, caches, lens, emb = _prefill(s7, QUERIES[0])

    def steps():
        cur, e = lens.clone(), emb
        for _ in range(PROFILE_DECODE_STEPS):
            logits = _decode_step(s7, e, cur, caches, True)
            e = decoder.embed_tokens(s7.params["text"], logits.argmax(-1)[:, None],
                                     s7.cfg.text)
            cur = cur + 1
        return logits

    _region(f"7b decode K3 route x{PROFILE_DECODE_STEPS}", steps)


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
    from vidi_tpu_torch.models.dattn import frame_side
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
    h2, w2 = frame_side(cfg, hw)
    n_tokens = int(batch["text_mask"].sum()) + int(batch["frame_counts"].sum()) * h2 * w2
    return batch, hw, n_tokens


def _noise(cfg, batch, hw, step: int) -> dict:
    """Position-noise draws from a CPU generator seeded with the step (the
    same numbers whatever device then holds them)."""
    from vidi_tpu_torch.models.dattn import draw_pos_noise

    b, n = batch["images"].shape[:2]
    return draw_pos_noise(cfg, b, n, batch["mels"].shape[1], hw,
                          torch.Generator().manual_seed(SEED + step))


def _image_train_batch(cfg, step: int, b: int, t: int, grids, gen_seed: int):
    """An anyres image-conversation batch (collate_images' layout):
    synthetic_image_batch(seed=step) with random tiles for each sample's
    grid (gw, gh) (1 + gw * gh tiles, padded to the largest count with
    zeros) and per-sample `grids`; -> (numpy batch, tokens counted as the
    training CLI counts them: text + s^2 a sample with an image)."""
    from vidi_tpu_torch.train.data import synthetic_image_batch

    batch = synthetic_image_batch(cfg, b=b, t=t, seed=step)
    side = cfg.vision.image_size
    n = [1 + gw * gh for gw, gh in grids]
    rng = np.random.default_rng(gen_seed + step)
    images = np.zeros((b, max(n), side, side, 3), np.float32)
    for i, k in enumerate(n):
        images[i, :k] = rng.standard_normal((k, side, side, 3))
    batch["images"], batch["grids"] = images, np.asarray(grids, np.int32)
    n_tokens = int(batch["text_mask"].sum()) + b * cfg.vision.num_patches_per_side ** 2
    return batch, n_tokens


def _image_noise(cfg, batch, step: int) -> dict:
    """encode_images' position-noise draws (per-sample grids) from a CPU
    generator seeded with the step."""
    from vidi_tpu_torch.models.dattn import draw_image_noise

    b, p = batch["images"].shape[:2]
    return draw_image_noise(cfg, b, p, torch.Generator().manual_seed(SEED + step),
                            per_sample=True)


def _train_reference(dev, label: str, cfg, batches, steps: int = 2, remat_card=True,
                     remat_cpu=True, grad_accum: int = 1) -> None:
    """`steps` train_steps of a small fp32 model on the card (K1, K2, K4)
    and on the CPU (their plain versions), same weights, batches and noise
    (`batches(step)` -> (numpy batch, hw, noise)): losses within
    REF_LOSS_REL, parameters after the last step within REF_PARAM_ATOL and
    moved by more than 10x that."""
    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.ops.cuda import flash_attention_bwd as k4
    from vidi_tpu_torch.train import data, optimizer, train_step

    cpu = torch.device("cpu")
    params = dattn.init_params(cfg, torch.float32, cpu, SEED)
    hp = optimizer.TrainHParams(total_steps=4, learning_rate=1e-3, mm_rand_lr=2e-3)
    runs, k4_before = {}, k4.launches
    for name, d, remat in (("cpu", cpu, remat_cpu), ("cuda", dev, remat_card)):
        p = _tree_map(lambda x: x.to(d, copy=True), params)
        tx = optimizer.make_optimizer(p, hp, grad_accum=grad_accum)
        state = train_step.opt_init(tx, p)
        losses = []
        for step in range(steps):
            batch, hw, noise = batches(step)
            p, state, loss = train_step.train_step(
                p, state, data.to_device(batch, d), {k: v.to(d) for k, v in noise.items()},
                cfg=cfg, tx=tx, hw=hw, mm_chunks=2, remat=remat, use_flash=True,
                frozen=TRAIN_FROZEN)
            losses.append(float(loss))
        runs[name] = (losses, p)
    (l_cpu, p_cpu), (l_gpu, p_gpu) = runs["cpu"], runs["cuda"]
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_gpu))
    err = max(float((a - b.cpu()).abs().max())
              for a, b in zip(_leaves(p_cpu), _leaves(p_gpu)))
    moved = max(float((a - b).abs().max()) for a, b in zip(_leaves(p_cpu),
                                                            _leaves(params)))
    ok = loss_rel <= REF_LOSS_REL and err <= REF_PARAM_ATOL
    print(f"  {label}, {steps} train_steps, card (K1/K2/K4) vs cpu (plain): "
          f"losses {l_gpu} vs {l_cpu} (rel {loss_rel:.2e}, limit {REF_LOSS_REL}); "
          f"params max_abs_err {err:.3e} (limit {REF_PARAM_ATOL}; largest move "
          f"{moved:.3e}) {'ok' if ok else 'FAIL'}")
    if not (ok and moved > 10 * REF_PARAM_ATOL):
        raise AssertionError(f"training reference check failed: {label}")
    if k4.launches == k4_before:
        raise AssertionError(f"the card's training step never launched K4: {label}")


def training_reference_check(dev) -> None:
    """Small fp32 models trained on the card and on the CPU
    (`_train_reference`): the 9B's shapes; image mode with anyres batches
    of mixed grids; remat "dots" on the card against full remat on the
    CPU; gradient accumulation over k = 2 (four micro-steps: the first
    optimizer step's learning rate is 0); the 7B's shapes (G = 4) with
    position noise at a pool size whose v1 side differs from hw // pool."""
    import dataclasses

    cfg = dataclasses.replace(_small_config(), loss_thres=0.1)

    def video(c):
        def batches(step):
            batch, hw, _ = _train_batch(c, step, b=2, t=20, n_frames=3, n_windows=1,
                                        ragged=True)
            return batch, hw, _noise(c, batch, hw, step)
        return batches

    _train_reference(dev, "small fp32 model", cfg, video(cfg))
    img = dataclasses.replace(cfg, mm_input_type="image", mm_image_aspect_ratio="anyres")

    def images(step):
        batch, _ = _image_train_batch(img, step, 2, 20, ((2, 2), (1, 3)), SEED)
        return batch, (0, 0), _image_noise(img, batch, step)

    _train_reference(dev, "small fp32 image-mode model, anyres grids (2, 2) and (1, 3)", img,
                     images)
    _train_reference(dev, 'small fp32 model, remat "dots" on the card, full on the cpu', cfg,
                     video(cfg), remat_card="dots")
    _train_reference(dev, "small fp32 model, gradient accumulation k = 2", cfg, video(cfg),
                     steps=4, grad_accum=2)
    c7 = dataclasses.replace(_small_config_7b(), mm_image_pool_size=3, loss_thres=0.1)
    _train_reference(dev, "small fp32 7B-shaped model (G = 4), position noise, pool 3", c7,
                     video(c7))


def load_training_slice(dev, base=None):
    """`base` (default Vidi1.5-9B) at full width with TRAIN_LAYERS text
    layers, bf16 random weights on the card, and its optimizer state."""
    import dataclasses

    from vidi_tpu_torch import DattnConfig
    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.train import optimizer, train_step

    base = base or DattnConfig.vidi15_9b()
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
    name = "Vidi-7B" if cfg.mm_version == "v1" else "Vidi1.5-9B"
    print(f"  {name}, {TRAIN_LAYERS} text layers: {n_all / 1e9:.3f} B params, "
          f"{n_train / 1e9:.3f} B trainable; params + fp32 moments "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB in "
          f"{time.perf_counter() - t0:.2f} s")
    return types.SimpleNamespace(dev=dev, cfg=cfg, params=params, tx=tx, state=state)


def _train_step(tr, step: int, tx=None, state=None, remat=True):
    from vidi_tpu_torch.train import data, train_step

    batch, hw, n_tokens = _train_batch(tr.cfg, step, b=1, t=TRAIN_T,
                                       n_frames=TRAIN_FRAMES, n_windows=TRAIN_WINDOWS)
    batch = data.to_device(batch, tr.dev)
    noise = {k: v.to(tr.dev) for k, v in _noise(tr.cfg, batch, hw, step).items()}

    def run():
        _, _, loss = train_step.train_step(
            tr.params, tr.state if state is None else state, batch, noise, cfg=tr.cfg,
            tx=tr.tx if tx is None else tx, hw=hw, mm_chunks=4, remat=remat,
            use_flash=True, frozen=TRAIN_FROZEN)
        return loss
    return run, n_tokens


def _train_counts() -> dict:
    from vidi_tpu_torch.ops.cuda import flash_attention as k1
    from vidi_tpu_torch.ops.cuda import flash_attention_bwd as k4
    from vidi_tpu_torch.ops.cuda import tower_attention as k2
    return {"flash_attention": k1.launches, "tower_attention": k2.launches,
            "flash_attention_bwd": k4.launches}


def _reset_train_counts() -> None:
    from vidi_tpu_torch.ops.cuda import flash_attention as k1
    from vidi_tpu_torch.ops.cuda import flash_attention_bwd as k4
    from vidi_tpu_torch.ops.cuda import tower_attention as k2
    k1.launches = k2.launches = k4.launches = 0


def _reckon_train(cfg, steps: int, streams: int, tower_launches: int) -> dict:
    """K1 / K4 / K2 launches of `steps` loss + backward passes with remat
    (True or "dots"): each layer's T2T and its `streams` cross attentions
    launch K1 in the forward and again when the backward recomputes the
    layer, and K4 once each; the frozen towers launch K2 in the forward
    only (`tower_launches` a step)."""
    per_layer = cfg.text.num_layers * (1 + streams)
    return {"flash_attention": 2 * per_layer * steps, "flash_attention_bwd": per_layer * steps,
            "tower_attention": tower_launches * steps}


def _held_train(label: str, got: dict, want: dict) -> None:
    print(f"  {label}: kernel launches {got} (reckoned {want})")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, reckoned {want}")


WATCH = {"text layer 0 q_w": ("text", "layers", 0, "q_w"),
         "vision patch_w": ("vision", "patch_w"), "audio conv1_w": ("audio", "conv1_w")}


def _watch(params, extra: dict) -> dict:
    """name -> a copy of each watched tensor (WATCH plus `extra`)."""
    out = {}
    for name, path in {**WATCH, **extra}.items():
        node = params
        for key in path:
            node = node[key]
        out[name] = (node, node.clone())
    return out


def _changed(watched: dict) -> dict:
    return {k: not torch.equal(x, was) for k, (x, was) in watched.items()}


def training_phase(tr, label: str = "training") -> dict:
    """TRAIN_STEPS train_steps of the slice, with the K1 / K2 / K4 launch
    counts read around them and held to the reckoned ones."""
    watched = _watch(tr.params, {"mm img_projector w0": ("mm", "img_projector", "w0")})
    _reset_train_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for step in range(TRAIN_STEPS):
        run, n_tokens = _train_step(tr, step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(run())
        dt = time.perf_counter() - t0
        losses.append(loss)
        changed = _changed(watched)
        print(f"  step {step}: loss {loss:.4f}, {dt:.3f} s, {n_tokens / dt:.1f} tok/s "
              f"({n_tokens} tokens), max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; changed: "
              + ", ".join(k for k, c in changed.items() if c))
        if step == 1 and not (changed["text layer 0 q_w"] and changed["mm img_projector w0"]):
            raise AssertionError("a trainable tensor did not change after step 1")
    launches = _train_counts()
    _held_train(f"{label}, {TRAIN_STEPS} steps", launches, _reckon_train(
        tr.cfg, TRAIN_STEPS, 2, _tower_launches(tr.cfg, TRAIN_FRAMES, TRAIN_WINDOWS, 4)))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if changed["vision patch_w"] or changed["audio conv1_w"]:
        raise AssertionError("a frozen tower tensor changed")
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


def _leaf_grads(params, leaves_at, loss_of):
    """(loss, [grad of each leaf at `leaves_at`]) of loss_of(); only those
    leaves take gradients, so no full gradient tree is held."""
    leaves = []
    for path in leaves_at:
        node = params
        for key in path:
            node = node[key]
        leaves.append(node.requires_grad_(True))
    try:
        with torch.enable_grad():
            loss = loss_of()
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for x in leaves:
            x.requires_grad_(False)
    return float(loss.detach()), grads


def _route_grads(tr, use_flash: bool, remat=True):
    """(loss, [grad of each ROUTE_LEAVES leaf]) of the slice's first batch."""
    from vidi_tpu_torch.train import data, train_step

    batch, hw, _ = _train_batch(tr.cfg, 0, b=1, t=TRAIN_T, n_frames=TRAIN_FRAMES,
                                n_windows=TRAIN_WINDOWS)
    noise = {k: v.to(tr.dev) for k, v in _noise(tr.cfg, batch, hw, 0).items()}
    batch = data.to_device(batch, tr.dev)
    return _leaf_grads(tr.params, ROUTE_LEAVES, lambda: train_step.loss_fn(
        tr.params, tr.cfg, batch, noise, hw=hw, mm_chunks=4, remat=remat,
        use_flash=use_flash, frozen=TRAIN_FROZEN))


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


def _fresh_optimizer(tr, params, grad_accum: int = 1):
    """A new AdamW (TRAIN_STEPS schedule; wrapped for gradient
    accumulation when grad_accum > 1) and its fp32 state over `params`."""
    from vidi_tpu_torch.train import optimizer, train_step

    tx = optimizer.make_optimizer(params, optimizer.TrainHParams(total_steps=TRAIN_STEPS),
                                  grad_accum=grad_accum)
    return tx, train_step.opt_init(tx, params)


def _timed(fn):
    """(fn(), wall s, peak device GiB since the call began)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def remat_phase(tr) -> dict:
    """remat="dots" against remat=True on the 9B slice: the loss and the
    ROUTE_LEAVES gradients of the first batch, bit-equal or within one
    bf16 rounding of each leaf's largest magnitude; then one train_step
    each from a fresh optimizer (step 0's learning rate is 0, so both see
    the same weights), timed with its peak memory. The policy's saved ops
    in one layer are printed. -> launches of the "dots" runs."""
    from vidi_tpu_torch.models import dattn

    saved, real = {}, dattn.dots_policy

    def recording(ctx, op, *args, **kwargs):
        decision = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            key = (str(op), decision.name)
            saved[key] = saved.get(key, 0) + 1
        return decision

    loss_t, grads_t = _route_grads(tr, True, remat=True)
    _reset_train_counts()
    dattn.dots_policy = recording
    try:
        loss_d, grads_d = _route_grads(tr, True, remat="dots")
    finally:
        dattn.dots_policy = real
    launches = _train_counts()
    n_layers = tr.cfg.text.num_layers
    print('  remat="dots" policy, one layer\'s forward: kept '
          + ", ".join(f"{op} x{n // n_layers}" for (op, d), n in sorted(saved.items())
                      if d == "MUST_SAVE")
          + f"; recomputed {sum(n for (_, d), n in saved.items() if d != 'MUST_SAVE') // n_layers}"
          " other ops")
    ok = abs(loss_d - loss_t) <= _bf16_ulp(abs(loss_t))
    print(f'  loss: remat "dots" {loss_d!r} vs full {loss_t!r} '
          f"({'bit-equal' if loss_d == loss_t else 'differ'})")
    for path, g, w in zip(ROUTE_LEAVES, grads_d, grads_t):
        err = float((g.float() - w.float()).abs().max())
        top = float(w.float().abs().max())
        leaf_ok = err <= _bf16_ulp(top)
        ok = ok and leaf_ok
        print(f"    {'.'.join(map(str, path))}: max_abs_err {err:.3e} "
              f"(one bf16 rounding of max|grad| {top:.3e}: {_bf16_ulp(top):.3e}) "
              f"{'ok' if leaf_ok else 'FAIL'}")
    if not ok:
        raise AssertionError('remat="dots" and full remat disagree')
    _held_train('remat="dots" loss + gradients', launches, _reckon_train(
        tr.cfg, 1, 2, _tower_launches(tr.cfg, TRAIN_FRAMES, TRAIN_WINDOWS, 4)))
    tx, state = _fresh_optimizer(tr, tr.params)
    for mode in (True, "dots", True, "dots"):
        run, n_tokens = _train_step(tr, 0, tx, state, remat=mode)
        loss, dt, peak = _timed(run)
        print(f"  train_step remat={mode!r}: loss {float(loss):.4f}, {dt:.3f} s, "
              f"{n_tokens / dt:.1f} tok/s, peak {peak:.2f} GiB")
    del tx, state
    return launches


def grad_accum_phase(tr) -> dict:
    """Gradient accumulation k = 2 (`optimizer.MultiSteps`) on the 9B slice
    from a fresh optimizer: four micro-steps; the parameters are
    bit-unchanged after micro-steps 1 and 3, and after 2 (the first
    optimizer step, whose learning rate is 0), and the trainable ones
    changed after micro-step 4 while the frozen towers did not."""
    tx, state = _fresh_optimizer(tr, tr.params, grad_accum=2)
    watched = _watch(tr.params, {"mm img_projector w0": ("mm", "img_projector", "w0")})
    _reset_train_counts()
    for micro in range(1, 5):
        run, n_tokens = _train_step(tr, micro, tx, state)
        loss, dt, peak = _timed(run)
        changed = _changed(watched)
        print(f"  micro-step {micro}: loss {float(loss):.4f}, {dt:.3f} s, peak {peak:.2f} "
              f"GiB, mini_step {state['mini_step']}, optimizer steps "
              f"{state['gradient_step']}; changed: "
              + (", ".join(k for k, c in changed.items() if c) or "none"))
        want_change = micro == 4
        if any(changed.values()) != want_change or (
                want_change and not (changed["text layer 0 q_w"]
                                     and changed["mm img_projector w0"])):
            raise AssertionError(f"gradient accumulation: micro-step {micro} changed "
                                 f"{changed}")
    if changed["vision patch_w"] or changed["audio conv1_w"]:
        raise AssertionError("a frozen tower tensor changed")
    launches = _train_counts()
    _held_train("gradient accumulation, 4 micro-steps", launches, _reckon_train(
        tr.cfg, 4, 2, _tower_launches(tr.cfg, TRAIN_FRAMES, TRAIN_WINDOWS, 4)))
    return launches


IMAGE_GRIDS = ((2, 2), (1, 3))  # (gw, gh): 1 + 4 and 1 + 3 SigLIP tiles
IMAGE_STEPS = 3


def _image_model(tr):
    """The training slice as an image-conversation model (mm_input_type
    "image", anyres): its text and tower weights, fresh image adapters."""
    import dataclasses

    from vidi_tpu_torch.models import dattn

    cfg = dataclasses.replace(tr.cfg, mm_input_type="image", mm_image_aspect_ratio="anyres")
    gen = torch.Generator(device=tr.dev).manual_seed(SEED + 7)
    params = {**tr.params, "mm": dattn.init_mm_params(cfg, torch.bfloat16, tr.dev, gen)}
    return cfg, params


def _image_step(tr, cfg, params, tx, state, step: int):
    from vidi_tpu_torch.train import data, train_step

    batch, n_tokens = _image_train_batch(cfg, step, 2, TRAIN_T, IMAGE_GRIDS, SEED + 100)
    noise = {k: v.to(tr.dev) for k, v in _image_noise(cfg, batch, step).items()}
    batch = data.to_device(batch, tr.dev)

    def run():
        return train_step.train_step(params, state, batch, noise, cfg=cfg, tx=tx, hw=(0, 0),
                                     mm_chunks=4, remat=True, use_flash=True,
                                     frozen=TRAIN_FROZEN)[2]
    return run, n_tokens


def train_image_phase(tr) -> dict:
    """Image-conversation training on the slice (`_image_model`): B = 2
    anyres samples with grids (2, 2) and (1, 3) (5 and 4 SigLIP tiles,
    3,645 and 2,916 image tokens), T = TRAIN_T, IMAGE_STEPS steps; launches
    held to the reckoned ones, trainable tensors changed and the towers
    not."""
    cfg, params = _image_model(tr)
    tx, state = _fresh_optimizer(tr, params)
    watched = _watch(params, {"mm projector w0": ("mm", "projector", "w0")})
    _reset_train_counts()
    for step in range(IMAGE_STEPS):
        run, n_tokens = _image_step(tr, cfg, params, tx, state, step)
        loss, dt, peak = _timed(run)
        changed = _changed(watched)
        print(f"  image step {step}: loss {float(loss):.4f}, {dt:.3f} s, "
              f"{n_tokens / dt:.1f} tok/s ({n_tokens} tokens), peak {peak:.2f} GiB; "
              "changed: " + (", ".join(k for k, c in changed.items() if c) or "none"))
        if not math.isfinite(float(loss)):
            raise AssertionError("non-finite image-mode loss")
    if not (changed["text layer 0 q_w"] and changed["mm projector w0"]):
        raise AssertionError("a trainable tensor did not change in image-mode training")
    if changed["vision patch_w"] or changed["audio conv1_w"]:
        raise AssertionError("a frozen tower tensor changed")
    tiles = sum(1 + gw * gh for gw, gh in IMAGE_GRIDS)
    vis_layers = cfg.vision.num_layers + 1 + cfg.vision.select_layer
    launches = _train_counts()
    # T2T and T2V (no audio); the pad tile of the (1, 3) sample is encoded too
    _held_train(f"image mode, {IMAGE_STEPS} steps", launches, _reckon_train(
        cfg, IMAGE_STEPS, 1, vis_layers * _map_chunks(2 * (1 + max(
            gw * gh for gw, gh in IMAGE_GRIDS)), 4)))
    print(f"  ({tiles} valid tiles a step)")
    return launches


def _packed_batch(cfg):
    """A PackedBatcher batch: B = 2 rows of PACK_T tokens from synthetic
    text-only samples of 307-1,535 tokens (0.075-0.375 of a row), fed until
    one does not fit.
    -> (numpy batch, the samples by row and segment)."""
    from vidi_tpu_torch.train.packing import PackedBatcher

    rng = np.random.default_rng(SEED + 8)
    packer, batch, fed = PackedBatcher(cfg, 2, PACK_T), None, []
    while batch is None:
        n = int(rng.integers(PACK_T * 3 // 40, PACK_T * 3 // 8))
        ids = rng.integers(3, 259, n).astype(np.int32)
        labels = ids.copy()
        labels[: n // 3] = -100
        fed.append({"input_ids": ids, "labels": labels, "has_image": False})
        batch = packer.add(fed[-1])
    return batch, fed[:-1]


def _packed_hidden(tr, batch, segs=True):
    """Final hidden states of a packed batch on the kernel route (zero-count
    media, as packed rows carry), without gradients."""
    from vidi_tpu_torch.models import dattn, decoder
    from vidi_tpu_torch.train import data, train_step

    b = data.to_device(batch, tr.dev)
    hw = train_step.make_batch_hw(tr.cfg, 1)
    with torch.no_grad():
        img, im = dattn.encode_video_images(tr.params, tr.cfg, b["images"],
                                            b["frame_counts"], hw, mm_chunks=4,
                                            use_flash=True)
        aud, am = dattn.encode_video_audios(tr.params, tr.cfg, b["mels"], b["audio_sizes"],
                                            mm_chunks=4, use_flash=True)
        emb = decoder.embed_tokens(tr.params["text"], b["input_ids"], tr.cfg.text)
        h, _ = dattn.forward(tr.params, tr.cfg, emb, b["text_mask"], b["positions"],
                             img=img, img_mask=im, aud=aud, aud_mask=am, mm_chunks=4,
                             use_flash=True, text_segs=b["segment_ids"] if segs else None)
    return h


def _packed_backward(tr, batch):
    """A callable: the packed batch's loss and ROUTE_LEAVES' gradients on
    the kernel route (K1 / K4 with the segment ids)."""
    from vidi_tpu_torch.train import data, train_step

    b = data.to_device(batch, tr.dev)
    hw = train_step.make_batch_hw(tr.cfg, 1)
    noise = {k: v.to(tr.dev) for k, v in _noise(tr.cfg, batch, hw, 0).items()}
    return lambda: _leaf_grads(tr.params, ROUTE_LEAVES, lambda: train_step.loss_fn(
        tr.params, tr.cfg, b, noise, hw=hw, mm_chunks=4, remat=True, use_flash=True,
        frozen=TRAIN_FROZEN))


def train_pack_phase(tr) -> dict:
    """--pack batches on the slice: each segment's logits at its last 32
    positions against the same sample run alone (LOGIT_REL / LOGIT_COS; a
    planted fault, the segment ids dropped, must fail), then one loss +
    backward of the packed rows (ROUTE_LEAVES' gradients: K1 / K4 with the
    segment ids) with its launches held to the reckoned ones."""
    from vidi_tpu_torch.models import decoder
    from vidi_tpu_torch.train.packing import pack_batch

    batch, samples = _packed_batch(tr.cfg)
    n_segs = int((batch["segment_ids"].max(axis=1)).sum())
    print(f"  PackedBatcher: {len(samples)} samples in 2 rows of {PACK_T} tokens "
          f"({n_segs} segments, {int(batch['text_mask'].sum())} real tokens)")
    h = {"packed": _packed_hidden(tr, batch), "planted fault, segment ids dropped":
         _packed_hidden(tr, batch, segs=False)}
    worst = {k: (0.0, 1.0) for k in h}
    for row in range(2):
        segs = batch["segment_ids"][row]
        for seg in range(1, int(segs.max()) + 1):
            where = np.flatnonzero(segs == seg)
            alone = pack_batch([{"input_ids": batch["input_ids"][row, where],
                                 "labels": batch["labels"][row, where]}], tr.cfg,
                               seq_len=len(where))
            want_h = _packed_hidden(tr, alone)[0, -32:]
            want = decoder.lm_logits(tr.params["text"], want_h, tr.cfg.text)
            for k, hk in h.items():
                got = decoder.lm_logits(tr.params["text"], hk[row, where[-32:]], tr.cfg.text)
                rel, cos = _logit_gap(got, want)
                worst[k] = (max(worst[k][0], rel), min(worst[k][1], cos))
    for k, (rel, cos) in worst.items():
        print(f"  {k}: worst segment's logits {rel:.3e} of max|logit| (limit {LOGIT_REL}), "
              f"cosine {cos:.6f} (limit {LOGIT_COS})")
    if not (worst["packed"][0] <= LOGIT_REL and worst["packed"][1] >= LOGIT_COS):
        raise AssertionError("a packed segment's logits differ from its sample alone")
    bad = worst["planted fault, segment ids dropped"]
    if bad[0] <= LOGIT_REL and bad[1] >= LOGIT_COS:
        raise AssertionError("the logit limits do not reject the segment ids dropped")
    del h
    _reset_train_counts()
    (loss, grads), dt, peak = _timed(_packed_backward(tr, batch))
    launches = _train_counts()
    n_tokens = int(batch["text_mask"].sum())
    print(f"  packed loss + backward: loss {loss:.4f}, {dt:.3f} s, {n_tokens / dt:.1f} tok/s, "
          f"peak {peak:.2f} GiB")
    if not (math.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)):
        raise AssertionError("non-finite packed loss or gradients")
    n_frames, n_windows = batch["images"].shape[0] * batch["images"].shape[1], 2
    _held_train("packed rows, one backward", launches, _reckon_train(
        tr.cfg, 1, 2, _tower_launches(tr.cfg, n_frames, n_windows, 4)))
    return launches


def train_7b_phase(dev) -> tuple:
    """Vidi-7B training at full width with TRAIN_LAYERS text layers: the
    120 s clip's shapes at 224 px (7,680 image + 1,200 audio tokens),
    T = TRAIN_T, position noise on (the v1 tables' lengths), TRAIN_STEPS
    steps with launches held to the reckoned ones; the gradient routes at
    G = 4 with their planted fault. -> (launches, the slice)."""
    from vidi_tpu_torch import DattnConfig

    tr7 = load_training_slice(dev, DattnConfig.vidi_7b())
    noise = _noise(tr7.cfg, _train_batch(tr7.cfg, 0, 1, TRAIN_T, TRAIN_FRAMES,
                                         TRAIN_WINDOWS)[0], (17, 17), 0)
    print(f"  position noise draws: img_h {tuple(noise['img_h'].shape)}, img_w "
          f"{tuple(noise['img_w'].shape)} (the v1 side {tr7.cfg.mm_image_pool_size})")
    launches = training_phase(tr7, "7B training")
    print("  gradient routes (7B, G = 4):")
    gradient_route_check(tr7)
    return launches, tr7


def profile_train_extras(tr) -> None:
    cfg, params = _image_model(tr)
    tx, state = _fresh_optimizer(tr, params)
    run, _ = _image_step(tr, cfg, params, tx, state, 0)
    _region("image-mode train step (Vidi1.5-9B, 8 text layers, grids (2, 2), (1, 3))", run)
    del tx, state
    tx, state = _fresh_optimizer(tr, tr.params)
    run, _ = _train_step(tr, 0, tx, state, remat="dots")
    _region('train step remat="dots" (Vidi1.5-9B, 8 text layers)', run)
    del tx, state
    _region(f"packed rows, loss + backward (2 x {PACK_T} tokens)",
            _packed_backward(tr, _packed_batch(tr.cfg)[0]))


def profile_7b_training(tr7) -> None:
    run, _ = _train_step(tr7, 0)
    _region("train step (Vidi-7B, 8 text layers)", run)


DISTILL_STEPS, DISTILL_RESAMPLE = 16, 8
DISTILL_ROWS, DISTILL_PROMPT, DISTILL_GEN = 8, 32, 32


def distill_phase(sl) -> dict:
    """Draft distillation from the serving slice's full-depth 9B (bf16): a
    2-layer student of width 512 (fp32), DISTILL_STEPS AdamW steps on
    rollouts of DISTILL_ROWS x (DISTILL_PROMPT + DISTILL_GEN) tokens
    resampled every DISTILL_RESAMPLE; the KL must fall on each rollout
    batch; the student saved with save_pretrained, reloaded with
    load_model, and run as speculative_generate's draft: tokens equal
    greedy's (the near-tie rule). No kernel runs (as in the reference:
    rollouts and logits take the plain route)."""
    import tempfile

    from vidi_tpu_torch.infer.export import save_pretrained
    from vidi_tpu_torch.infer.generate import generate, speculative_generate
    from vidi_tpu_torch.infer.loader import load_model
    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.train import distill
    from vidi_tpu_torch.train.optimizer import adamw

    dev, cfg = sl.dev, sl.cfg
    scfg = distill.student_config(cfg, layers=2, hidden=512, heads=8, kv_heads=4,
                                  head_dim=64, ffn=2048)
    student = dattn.init_params(scfg, torch.float32, dev, SEED)
    tx = adamw(student, 3e-4)
    state = tx.init(student)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    _reset_kernel_counts()
    _reset_train_counts()
    losses, t0 = [], time.perf_counter()
    for i in range(DISTILL_STEPS):
        if i % DISTILL_RESAMPLE == 0:
            seqs = distill.sample_trajectories(gen, sl.params, cfg, batch=DISTILL_ROWS,
                                               prompt_len=DISTILL_PROMPT,
                                               gen_len=DISTILL_GEN)
            soft = distill._teacher_targets(sl.params, cfg, seqs)
        losses.append(float(distill.distill_step(student, scfg, tx, state, seqs, soft)))
    torch.cuda.synchronize()
    launches = {**_kernel_counts(), **_train_counts()}
    print(f"  {DISTILL_STEPS} steps in {time.perf_counter() - t0:.2f} s; kl by step: "
          + ", ".join(f"{x:.4f}" for x in losses))
    falls = all(losses[j + DISTILL_RESAMPLE - 1] < losses[j]
                for j in range(0, DISTILL_STEPS, DISTILL_RESAMPLE))
    if not falls:
        raise AssertionError("the distillation KL did not fall on a rollout batch")
    if any(launches.values()):
        raise AssertionError(f"distillation launched kernels: {launches}")
    with tempfile.TemporaryDirectory() as tmp:
        save_pretrained(student, scfg, tmp)
        draft, dcfg, _ = load_model(tmp, dtype=torch.bfloat16, device=dev)
    ids = seqs[:2, :DISTILL_PROMPT]
    mask = torch.ones_like(ids, dtype=torch.bool)
    with _LogitLog() as log:
        greedy = generate(sl.params, cfg, ids, mask, max_new_tokens=16, eos_id=-1)
    spec = speculative_generate(sl.params, cfg, draft, dcfg, ids, mask, max_new_tokens=16,
                                eos_id=-1, spec_k=SPEC_K)
    acc, drafted = int(spec.n_accepted.sum()), max(int(spec.n_drafted.sum()), 1)
    print(f"  the reloaded draft ({dcfg.text.num_layers} layers of {dcfg.text.hidden_size}) "
          f"in speculative_generate: {spec.n_target_steps} target passes, accepted "
          f"{acc}/{drafted} ({acc / drafted:.0%})")
    _near_tie_rule("distilled draft", spec.tokens, greedy.tokens, log)
    return launches


def train_cli_phase(device: str = "cuda") -> None:
    """The train CLI on the card as a subprocess: the tiny image-mode model
    with anyres synthetic batches, gradient accumulation 2, remat "dots",
    a profile of steps 2-4 and tensorboard, 5 steps. The trace file must
    exist and the metrics lines carry the learning rates of the optimizer
    steps (step // 2)."""
    import tempfile

    from vidi_tpu_torch.train.optimizer import TrainHParams, lr_schedule

    with tempfile.TemporaryDirectory() as tmp:
        prof = os.path.join(tmp, "prof")
        cmd = [sys.executable, "-m", "vidi_tpu_torch.train.train", "--tiny",
               "--mm_input_type", "image", "--mm_image_aspect_ratio", "anyres",
               "--dataset_type", "image-conv", "--data_path", "synthetic",
               "--gradient_accumulation_steps", "2", "--remat", "dots", "--profile_dir",
               prof, "--report_to", "tensorboard", "--max_steps", "5", "--device", device,
               "--output_dir", os.path.join(tmp, "run")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"train CLI failed ({res.returncode}): {res.stderr[-2000:]}")
        with open(os.path.join(tmp, "run", "metrics.jsonl")) as f:
            lines = [json.loads(x) for x in f]
        traces = os.listdir(prof) if os.path.isdir(prof) else []
        sizes = [os.path.getsize(os.path.join(prof, x)) for x in traces]
        tb = os.path.isdir(os.path.join(tmp, "run", "runs"))
    sched = lr_schedule(TrainHParams(total_steps=5), 1e-5)
    want = [sched(s // 2) for s in range(5)]
    got = [m["learning_rate"] for m in lines]
    print(f"  {' '.join(cmd[1:])}: {wall:.1f} s, exit 0; learning rates {got} (want {want}); "
          f"losses {[round(m['loss'], 4) for m in lines]}; trace {traces} ({sizes} bytes); "
          f"tensorboard events {'written' if tb else 'not written (no tensorboard)'}")
    if got != want or traces != ["trace_steps_2-4.json"] or not all(sizes):
        raise AssertionError("the train CLI's metrics or trace are not as expected")
    warn = [x for x in res.stdout.splitlines() if "tensorboard" in x]
    if warn:
        print(f"  {warn[0]}")


# ---------------------------------------------------------------------------
# Parallelism (parallel/): the ring's and Ulysses' local steps on virtual
# ranks, and the train CLI in a one-rank NCCL world
# ---------------------------------------------------------------------------

# The 9B's T2V at full width: 128 text rows against a 120 s clip's 23,520
# image keys, of which the last 30 frames (5,880 keys) are padding (a 90 s
# clip batched with a 120 s one), cut into PAR_SEQ shards of 5,880 keys: the
# last virtual rank holds no valid key.
PAR_SEQ, PAR_T = 4, 128
PAR_S, PAR_VALID = IMG_S, IMG_S - 30 * 196
CLI_LOSS_REL = 1e-6


def _ring_virtual(q, shards, dout, scale: float, cap, fault=None):
    """One ring rank's work at PAR_SEQ virtual ranks, through the ring's own
    helpers: the flash partial of every shard (K1), merged in shard order,
    then the backward of every shard against the final out / lse (K4) ->
    (out, lse, dq, dk, dv), dk / dv concatenated in shard order. `fault`:
    "sentinel" (a shard's empty-row lse left at K1's sentinel), "dropped"
    (shard 1 left out of the merge and of dq), "owner" (dk / dv handed to
    the next shard's owner)."""
    from vidi_tpu_torch.ops.cuda.flash_attention import EMPTY_ROW_LSE
    from vidi_tpu_torch.parallel import ring_attention as ra

    partials = [ra._local_attn_lse(q, k, v, m, scale, cap, True) for k, v, m in shards]
    if fault == "sentinel":
        partials = [(o, torch.where(torch.isinf(l), EMPTY_ROW_LSE, l)) for o, l in partials]
    keep = [i for i in range(len(shards)) if not (fault == "dropped" and i == 1)]
    out, lse = ra.merge([partials[i] for i in keep])
    grads = [ra.shard_grads(q, k, v, m, out, lse, dout, scale, cap, True)
             for k, v, m in shards]
    dq = sum(grads[i][0].float() for i in keep).to(q.dtype)
    order = list(range(len(shards)))
    if fault == "owner":
        order = order[1:] + order[:1]
    dk = torch.cat([grads[i][1] for i in order], dim=1)
    dv = torch.cat([grads[i][2] for i in order], dim=1)
    return out, lse, dq, dk, dv


def parallel_phase(dev) -> dict:
    """The parallel slice on one card. (a) The ring at the 9B's full width,
    PAR_SEQ virtual ranks in one process: `_local_attn_lse` (K1) on each
    shard merged by `_combine`, against K1 on the whole cache within ULPS
    bf16 ulps; the ring backward (K4 on each shard with the final out /
    lse) against K4 on the whole cache at the K4 rows' limits; planted
    faults: a shard's lse left at the sentinel, one shard dropped, dk / dv
    handed to the wrong owner. Launches: PAR_SEQ K1 and PAR_SEQ K4 calls
    (each a dq and a dk / dv kernel), read around the ring's run alone.
    (b) Ulysses' local step: K1 on each Hq / PAR_SEQ head slice (G = 2),
    stitched, against K1 on all heads. (c) The train CLI under torchrun in a
    one-rank NCCL world (tiny, --sp_mode ring) against the same CLI without
    torchrun: losses within CLI_LOSS_REL. -> K1 / K4 launches of the ring's
    run, and the shard shapes' cases for the kernel line."""
    from vidi_tpu_torch.ops.cuda import _lib
    from vidi_tpu_torch.ops.cuda import flash_attention as k1
    from vidi_tpu_torch.ops.cuda import flash_attention_bwd as k4
    from vidi_tpu_torch.parallel import ring_attention as ra

    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    hq, hk, d, t, s, cap = 16, 8, 256, PAR_T, PAR_S, 50.0
    scale, n = d**-0.5, PAR_S // PAR_SEQ
    q = _randn(gen, (1, t, hq, d), dev, Q_GAIN)
    k = _randn(gen, (1, s, hk, d), dev)
    v = _randn(gen, (1, s, hk, d), dev)
    mask = _kv_mask(s, PAR_VALID, dev)
    dout = _randn(gen, (1, t, hq, d), dev)
    shards = [(k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n], mask[:, i * n:(i + 1) * n])
              for i in range(PAR_SEQ)]
    label = f"9b t2v T={t} S={s} mask cap=50, {PAR_SEQ} virtual ranks of {n} keys"

    # (a) the ring's run, its launches read around it alone
    _reset_train_counts()
    out, lse, dq, dk, dv = _ring_virtual(q, shards, dout, scale, cap)
    torch.cuda.synchronize()
    counts = _train_counts()
    launches = {"flash_attention": counts["flash_attention"],
                "flash_attention_bwd": counts["flash_attention_bwd"]}
    print(f"  ring {label}: launches {launches}")
    if launches != {"flash_attention": PAR_SEQ, "flash_attention_bwd": PAR_SEQ}:
        raise AssertionError(f"the ring's launches {launches}, expected {PAR_SEQ} each")
    whole_out, whole_lse = k1.flash_attention(q, k, v, mask, scale, False, None, cap)
    whole = k4.flash_attention_bwd(q, k, v, mask, whole_out, whole_lse, dout, scale,
                                   False, None, cap)
    faults = {f: _ring_virtual(q, shards, dout, scale, cap, f)
              for f in ("sentinel", "dropped", "owner")}
    errs = [_check(f"ring out {label}", out, whole_out,
                   {"shard lse left at the sentinel": faults["sentinel"][0],
                    "shard 1 dropped": faults["dropped"][0]}),
            _check(f"ring dq {label}", dq, whole[0],
                   {"shard 1 dropped": faults["dropped"][2]})]
    for i, name in ((3, "dk"), (4, "dv")):
        errs.append(_check(f"ring {name} {label}", (out, lse, dq, dk, dv)[i], whole[i - 2],
                           {"dk / dv to the wrong owner": faults["owner"][i]}))
    lse_gap = float((lse.transpose(1, 2) - whole_lse).abs().max())
    print(f"  ring lse against K1's on the whole cache: {lse_gap:.3e} (limit {LSE_ATOL})")
    if not lse_gap <= LSE_ATOL:
        raise AssertionError(f"ring lse {lse_gap:.3e} over {LSE_ATOL}")
    del faults

    # times: the ring's forward and backward against one K1 / K4 call on the
    # whole cache, and K1 / K4 at one shard's shape (the new case rows)
    ring_fwd_ms = _time_ms(lambda: ra.merge(
        [ra._local_attn_lse(q, kk, vv, m, scale, cap, True) for kk, vv, m in shards]))
    ring_bwd_ms = _time_ms(lambda: [ra.shard_grads(q, kk, vv, m, out, lse, dout, scale, cap,
                                                   True) for kk, vv, m in shards])
    whole_fwd_ms = _time_ms(lambda: k1.flash_attention(q, k, v, mask, scale, False, None, cap))
    whole_bwd_ms = _time_ms(lambda: k4.flash_attention_bwd(q, k, v, mask, whole_out,
                                                           whole_lse, dout, scale, False,
                                                           None, cap))
    print(f"  ring forward {ring_fwd_ms:.4f} ms ({PAR_SEQ} K1 calls + merges) against K1 on "
          f"the whole cache {whole_fwd_ms:.4f} ms; ring backward {ring_bwd_ms:.4f} ms "
          f"({PAR_SEQ} K4 calls) against K4 on the whole cache {whole_bwd_ms:.4f} ms "
          f"[{_card()}]")
    kq, kv_, km = shards[0]
    sh_out, sh_lse = k1.flash_attention(q, kq, kv_, km, scale, False, None, cap)
    visible = t * int(km.sum())
    cases = {}
    for name, run, plain, ops, nbytes in (
            ("flash_attention",
             lambda: k1.flash_attention(q, kq, kv_, km, scale, False, None, cap),
             lambda: k1.flash_attention_plain(q, kq, kv_, km, scale, False, None, cap),
             4 * hq * d * visible, _nbytes(q, kq, kv_, km, sh_out, sh_lse)),
            ("flash_attention_bwd",
             lambda: k4.flash_attention_bwd(q, kq, kv_, km, sh_out, sh_lse, dout, scale,
                                            False, None, cap),
             lambda: k4.flash_attention_bwd_plain(q, kq, kv_, km, sh_out, sh_lse, dout,
                                                  scale, False, None, cap),
             10 * hq * d * visible, 2 * _nbytes(q, kq, kv_, km, sh_out, sh_lse, dout))):
        ms, plain_ms = _time_ms(run), _time_ms(plain)
        bound = _bound(ops, nbytes, "bf16")
        shape = f"9b ring shard t2v T={t} S={n} mask cap=50"
        print(f"  {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        cases[name] = {"shape": shape, "ms": ms, "plain_ms": plain_ms, **bound,
                       "library_ms": None, **_rate(f"{name} {shape}", ops, ms, bound)}

    # (b) Ulysses' local step: each virtual rank's head slice over the whole
    # stream (its k / v heads after the all-to-all), stitched
    g = hq // hk
    hq_r, hk_r = hq // PAR_SEQ, hk // PAR_SEQ
    heads = torch.cat([k1.flash_attention(q[:, :, r * hq_r:(r + 1) * hq_r],
                                          k[:, :, r * hk_r:(r + 1) * hk_r],
                                          v[:, :, r * hk_r:(r + 1) * hk_r], mask, scale,
                                          False, None, cap)[0]
                       for r in range(PAR_SEQ)], dim=2)
    same = torch.equal(heads, whole_out)
    sms = _lib.sm_count(dev)
    plans = (k1.sm90_plan(1, t, s, hq, hk, d, sms), k1.sm90_plan(1, t, s, hq_r, hk_r, d, sms))
    wrong = torch.cat([heads[:, :, hq_r:], heads[:, :, :hq_r]], dim=2)
    errs.append(_check(f"Ulysses head slices (G = {g}, {hq_r} query / {hk_r} KV heads a rank) "
                       f"stitched, {label}", heads, whole_out,
                       {"slices stitched one rank off": wrong}))
    diff = int((heads != whole_out).sum())
    print(f"  Ulysses slices {'bit-equal' if same else 'not bit-equal'} to K1 on all heads "
          f"({diff} of {heads.numel()} elements differ; sm90_plan (splits, keys a split): "
          f"all heads {plans[0]}, a slice {plans[1]})")

    # (c) the train CLI under torchrun in a one-rank NCCL world
    cli = train_cli_ranks_check()
    return {"launches": launches, "max_abs_err": max(errs), "cases": cases,
            "ulysses_bit_equal": same, "cli": cli,
            "ring_ms": {"forward": ring_fwd_ms, "backward": ring_bwd_ms,
                        "whole_forward": whole_fwd_ms, "whole_backward": whole_bwd_ms}}


def train_cli_ranks_check(device: str = "cuda") -> dict:
    """The train CLI (tiny, --sp_mode ring, 2 steps) under `torchrun
    --standalone --nproc_per_node 1` (a one-rank NCCL world: mesh (1, 1, 1))
    and as a plain process: the two runs' losses within CLI_LOSS_REL."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    losses, walls = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        args = ["-m", "vidi_tpu_torch.train.train", "--tiny", "--data_path", "synthetic",
                "--sp_mode", "ring", "--max_steps", "2", "--device", device]
        for name, pre in (("torchrun", [sys.executable, "-m", "torch.distributed.run",
                                        "--standalone", "--nproc_per_node", "1"]),
                          ("plain", [sys.executable])):
            out = os.path.join(tmp, name)
            t0 = time.perf_counter()
            res = subprocess.run([*pre, *args, "--output_dir", out], capture_output=True,
                                 text=True, timeout=300, cwd=root)
            walls[name] = time.perf_counter() - t0
            if res.returncode != 0:
                raise AssertionError(f"train CLI ({name}) failed ({res.returncode}): "
                                     f"{res.stderr[-2000:]}")
            with open(os.path.join(out, "metrics.jsonl")) as f:
                losses[name] = [json.loads(x)["loss"] for x in f]
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses["torchrun"], losses["plain"]))
    print(f"  train CLI --sp_mode ring: torchrun (one rank) losses {losses['torchrun']} "
          f"in {walls['torchrun']:.1f} s, plain {losses['plain']} in {walls['plain']:.1f} s; "
          f"largest relative gap {gap:.2e} (limit {CLI_LOSS_REL})")
    if len(losses["torchrun"]) != 2 or not gap <= CLI_LOSS_REL:
        raise AssertionError("the one-rank torchrun CLI's losses differ from the plain CLI's")
    return {"losses": losses, "rel_gap": gap, "wall_s": walls}


# ---------------------------------------------------------------------------
# The parallel inference slice on one card: K3 with its lse, the read of a
# seq-cut cache on PAR_SEQ virtual ranks, and one Dattn decode step of the
# 9B cut over "model" on MODEL_RANKS virtual ranks
# ---------------------------------------------------------------------------

MODEL_RANKS = 2
PAR_IMG_VALID = IMG_S - 30 * 196  # the last of PAR_SEQ shards holds padding only


def _lse_cases(t: int, n_real: int):
    """(label, b, hq, hk, d, s, n_valid, window, q_pos, cap) of K3's lse
    cases: the 9B's image, audio and text caches (the K3 rows' shapes) and
    the 7B's image cache (G = 4)."""
    return ((f"9b image cache S={IMG_S} global", 1, 16, 8, 256, IMG_S, IMG_VALID, None,
             None, 50.0),
            (f"9b audio cache S={AUD_S} global", 1, 16, 8, 256, AUD_S, AUD_VALID, None,
             None, 50.0),
            (f"9b text cache S={t + 32} window=4096", 1, 16, 8, 256, t + 32, n_real + 6,
             4096, n_real + 5, 50.0),
            (f"7b image cache S={IMG7_S} mask", 1, 32, 8, 128, IMG7_S, IMG7_VALID, None,
             None, None))


def _check_lse(name: str, got, want, faults: dict) -> float:
    """lse [B,Hq] against the plain version's within LSE_ATOL; every planted
    fault must land outside it."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    seen = {lab: float((f - want).abs().max()) for lab, f in faults.items()}
    print(f"  {name}: lse max_abs_err={err:.3e}, limit {LSE_ATOL} "
          f"{'ok' if err <= LSE_ATOL else 'FAIL'}; planted faults: "
          + ", ".join(f"{lab} {e:.3e}" for lab, e in seen.items()))
    if not err <= LSE_ATOL:
        raise AssertionError(f"{name}: lse max_abs_err {err:.3e} over {LSE_ATOL}")
    blind = [lab for lab, e in seen.items() if not e > LSE_ATOL]
    if blind:
        raise AssertionError(f"{name}: the lse limit does not reject {blind}")
    return err


def k3_lse_cases(dev) -> tuple:
    """K3 with `return_lse` at the K3 rows' shapes: lse against the plain
    version's within LSE_ATOL (planted fault: one split's lse, the keys of
    its tiles alone, in place of the merged one), out bit-equal to the call
    without lse; the device time a call with and without lse. -> (cases,
    largest lse error)."""
    from vidi_tpu_torch.ops.cuda import _lib
    from vidi_tpu_torch.ops.cuda import decode_attention as k3

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    n_real, t = _prompt_lengths()
    sms = _lib.sm_count(dev)
    cases, errs = [], []
    for label, b, hq, hk, d, s, n_valid, window, q_pos, cap in _lse_cases(t, n_real):
        if q_pos is not None:
            q_pos = torch.full((b,), q_pos, dtype=torch.int64, device=dev)
        args = dict(q=_randn(gen, (b, hq, d), dev, Q_GAIN), k=_randn(gen, (b, hk, s, d), dev),
                    v=_randn(gen, (b, hk, s, d), dev), kv_mask=_kv_mask(s, n_valid, dev),
                    sm_scale=d**-0.5, softcap=cap, window=window, q_pos=q_pos)
        plan = k3.decode_plan(b, hk, s, d, sms, g=hq // hk)
        out, lse = k3.decode_attention(**args, return_lse=True)
        same = torch.equal(out, k3.decode_attention(**args))
        _, want = k3.decode_attention_plain(**args, return_lse=True)
        # a split other than the one holding row 0's largest logit: its
        # keys' lse alone is what a merge that wrote one split's lse gives
        tile, _, n_split = plan
        seen = k3.visible_keys(b, s, args["kv_mask"], window, q_pos, dev)
        logits = torch.einsum("d,sd->s", args["q"][0, 0].float(), args["k"][0, 0].float())
        top = int(logits.masked_fill(~seen[0], -math.inf).argmax()) // tile % n_split
        split = (top + 1) % n_split
        others = [(i * tile, (i + 1) * tile) for i in range(-(-s // tile))
                  if i % n_split != split]
        _, one = k3.decode_attention_plain(**_k3_hidden(args, others), return_lse=True)
        errs.append(_check_lse(f"K3 lse {label}", lse, want,
                               {f"split {split}'s lse in place of the merged one": one}))
        print(f"  K3 lse {label}: out {'bit-equal' if same else 'DIFFERS'} to the call "
              f"without lse; plan {plan}")
        if not same:
            raise AssertionError(f"K3 lse {label}: out differs from the call without lse")
        with_lse = lambda: k3.decode_attention(**args, return_lse=True)  # noqa: E731
        ms, plain_ms = _time_ms(with_lse), _time_ms(
            lambda: k3.decode_attention_plain(**args, return_lse=True))
        dev_us = _device_us(with_lse)
        dev_us_no = _device_us(lambda: k3.decode_attention(**args))
        n_seen = int(seen.sum())
        row = 2 * hk * d * 2
        bound = _bound(4 * hq * d * n_seen, _nbytes(args["q"], out, lse, args["kv_mask"])
                       + row * n_seen, "bf16")
        print(f"  K3 lse {label}: events {ms:.4f} ms, device {dev_us:.2f} us a call with lse, "
              f"{dev_us_no:.2f} us without ({dev_us - dev_us_no:+.2f} us), plain "
              f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({n_seen} visible keys) "
              f"[{_card()}]")
        cases.append({"shape": f"lse {label}", "ms": ms, "plain_ms": plain_ms,
                      "device_ms": dev_us / 1e3, "device_ms_without_lse": dev_us_no / 1e3,
                      **bound, "library_ms": None, "plan": plan})
    return cases, max(errs)


def _seq_merge_virtual(q, shards, scale: float, cap, fault=None):
    """One seq rank group's read of a seq-cut cache at PAR_SEQ virtual ranks,
    through the path's own helpers: each shard's (out, lse) from
    `dattn.cache_partial` (K3 with its lse, the empty-row sentinel mapped to
    -inf), merged in shard order by `ring_attention.merge` (what
    `sharding.seq_merge` runs after its all-gather). `fault`: "no lse"
    (every lse 0: equal weights), "dropped" (shard 1 left out), "sentinel"
    (the empty shard's lse left at K3's sentinel)."""
    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.ops.cuda.flash_attention import EMPTY_ROW_LSE
    from vidi_tpu_torch.parallel import ring_attention as ra

    tcfg = types.SimpleNamespace(q_scale=scale, attn_softcap=cap)
    parts = [dattn.cache_partial(q[:, None], k, v, m, tcfg, True) for k, v, m in shards]
    if fault == "no lse":
        parts = [(o, torch.zeros_like(l)) for o, l in parts]
    if fault == "sentinel":
        parts = [(o, torch.where(torch.isinf(l), EMPTY_ROW_LSE, l)) for o, l in parts]
    if fault == "dropped":
        parts = parts[:1] + parts[2:]
    return ra.merge(parts)[0][:, 0]


def seq_read_check(dev) -> tuple:
    """The 9B image cache (23,520 keys, the last 30 frames padding) cut into
    PAR_SEQ shards of 5,880 keys, one decode token: each shard's K3 with its
    lse merged in shard order against K3 on the whole cache within ULPS bf16
    ulps of max|want|; planted faults: the lse dropped (equal weights), a
    shard dropped, the empty shard's sentinel left unmapped. -> (launches
    of the shards' run, case rows, error, times)."""
    from vidi_tpu_torch.ops.cuda import decode_attention as k3

    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    hq, hk, d, s, cap = 16, 8, 256, IMG_S, 50.0
    scale, n = d**-0.5, s // PAR_SEQ
    q = _randn(gen, (1, hq, d), dev, Q_GAIN)
    k = _randn(gen, (1, hk, s, d), dev)
    v = _randn(gen, (1, hk, s, d), dev)
    mask = _kv_mask(s, PAR_IMG_VALID, dev)
    # each virtual rank's cache is its own tensor, as a rank's would be
    shards = [(k[:, :, i * n:(i + 1) * n].contiguous(), v[:, :, i * n:(i + 1) * n].contiguous(),
               mask[:, i * n:(i + 1) * n].contiguous()) for i in range(PAR_SEQ)]
    label = f"9b image cache S={s}, {PAR_SEQ} virtual seq ranks of {n} keys"
    before = k3.launches
    out = _seq_merge_virtual(q, shards, scale, cap)
    torch.cuda.synchronize()
    launches = {"decode_attention": k3.launches - before}
    print(f"  seq-cut read {label}: launches {launches}")
    if launches["decode_attention"] != PAR_SEQ:
        raise AssertionError(f"the seq-cut read launched K3 {launches}, not {PAR_SEQ} times")
    whole = k3.decode_attention(q, k, v, mask, scale, cap)
    err = _check(f"seq-cut read {label}", out, whole,
                 {f: _seq_merge_virtual(q, shards, scale, cap, f)
                  for f in ("no lse", "dropped", "sentinel")})
    merged_ms = _time_ms(lambda: _seq_merge_virtual(q, shards, scale, cap))
    whole_ms = _time_ms(lambda: k3.decode_attention(q, k, v, mask, scale, cap))
    cases = []
    for i in (0, PAR_SEQ - 1):
        kk, vv, mm = shards[i]
        run = lambda: k3.decode_attention(q, kk, vv, mm, scale, cap, return_lse=True)  # noqa
        o, l = run()
        n_seen = int(mm.sum())
        bound = _bound(4 * hq * d * n_seen, _nbytes(q, o, l, mm) + 2 * hk * d * 2 * n_seen,
                       "bf16")
        ms, dev_ms = _time_ms(run), _device_us(run) / 1e3
        plain_ms = _time_ms(lambda: k3.decode_attention_plain(q, kk, vv, mm, scale, cap,
                                                              return_lse=True))
        shape = f"lse 9b seq shard {i} of {PAR_SEQ}: S={n}, {n_seen} visible keys"
        print(f"  K3 {shape}: events {ms:.4f} ms, device {dev_ms:.4f} ms a call, plain "
              f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}) "
              f"[{_card()}]")
        cases.append({"shape": shape, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      **bound, "library_ms": None})
    print(f"  seq-cut read: {PAR_SEQ} K3 calls with lse + merge {merged_ms:.4f} ms against "
          f"K3 on the whole cache {whole_ms:.4f} ms [{_card()}]")
    return launches, cases, err, {"merged": merged_ms, "whole": whole_ms}


def _layer_9b(dev, gen, cfg):
    """One random text layer of the 9B at full width (bf16)."""
    from vidi_tpu_torch.models import decoder

    tc = dataclasses.replace(cfg.text, num_layers=1, vocab_size=8)
    lp = decoder.init_params(tc, torch.bfloat16, dev, gen)["layers"][0]
    for name in ("input_ln", "post_attn_ln", "pre_ffn_ln", "post_ffn_ln"):
        lp[name] = 0.1 * _randn(gen, lp[name].shape, dev)
    return lp


def _model_slice(lp, r: int, n: int) -> dict:
    """Rank r of n's leaves of a text layer under the "model" cut: the
    `_TP_DIM` leaves' slice, the norms whole."""
    from vidi_tpu_torch.parallel import sharding

    out = {}
    for name, t in lp.items():
        dim = sharding._TP_DIM.get(name)
        out[name] = t if dim is None else t.chunk(n, dim=dim - 1)[r].contiguous()
    return out


def _model_ranks(run, n: int, alone=None):
    """`run(r)` for the n virtual ranks in n threads, `sharding.model_sum`
    standing in for the collective: each rank's partial is handed to the
    others and summed in rank order in fp32 (what the all-gather and sum
    give every rank). `alone`: that rank keeps its own partial (the planted
    fault). -> the ranks' results."""
    import threading

    from vidi_tpu_torch.parallel import sharding

    slots, results, errors = [None] * n, [None] * n, []
    barrier = threading.Barrier(n)
    local = threading.local()
    real = sharding.model_sum

    def exchange(x, w=None):
        r = local.rank
        slots[r] = x
        barrier.wait()
        total = slots[0].float()
        for p in slots[1:]:
            total = total + p.float()
        barrier.wait()  # every rank has read the slots before the next exchange
        return x if r == alone else total.to(x.dtype)

    def body(r):
        local.rank = r
        try:
            results[r] = run(r)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)
            barrier.abort()

    sharding.model_sum = exchange
    try:
        threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        sharding.model_sum = real
    if errors:
        raise errors[0]
    return results


def model_cut_check(dev) -> tuple:
    """One Dattn decode step of the 9B at full width (a global layer: T2T on
    a text cache, T2V on the 120 s clip's image cache, T2A on its audio
    cache, one query token, K3 for all three) uncut, and cut over "model" on
    MODEL_RANKS virtual ranks: each rank's q / k / v heads, its KV heads of
    every cache, its o / down rows and gate / up columns, the o_proj and FFN
    row partials summed in rank order (`_model_ranks`). The cut layer's
    output against the uncut one within ULPS bf16 ulps of max|want|;
    planted fault: rank 0's partials alone. -> (K3 launches of the cut
    step, error)."""
    from vidi_tpu_torch.core.config import DattnConfig
    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.ops.cuda import decode_attention as k3
    from vidi_tpu_torch.ops.rope import rope_cos_sin

    cfg = DattnConfig.vidi15_9b()
    tcfg = cfg.text
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    n_real, t = _prompt_lengths()
    hk, d, tc = tcfg.num_kv_heads, tcfg.head_dim, t + 32
    lp = _layer_9b(dev, gen, cfg)
    h = _randn(gen, (1, 1, tcfg.hidden_size), dev)
    caches = {name: (_randn(gen, (1, hk, s, d), dev), _randn(gen, (1, hk, s, d), dev))
              for name, s in (("text", tc), ("img", IMG_S), ("aud", AUD_S))}
    cur = torch.tensor([n_real], device=dev)
    masks = {"text": torch.arange(tc, device=dev)[None] <= cur[:, None],
             "img": _kv_mask(IMG_S, IMG_VALID, dev), "aud": _kv_mask(AUD_S, AUD_VALID, dev)}
    rope = rope_cos_sin(cur[:, None], d, tcfg.rope_theta)

    def step(layer, heads: slice):
        kv = {n: (k[:, heads].clone(), v[:, heads].clone()) for n, (k, v) in caches.items()}
        out, *_ = dattn.dattn_layer(
            layer, False, h, None, None, tcfg=tcfg, rope_cs=rope,
            q_positions=cur[:, None],
            kv_positions=torch.arange(tc, device=dev)[None], text_mask=masks["text"],
            img_mask=masks["img"], aud_mask=masks["aud"], text_kv=kv["text"],
            img_kv=kv["img"], aud_kv=kv["aud"], write_at=cur, use_flash=True)
        return out

    n = MODEL_RANKS
    with torch.no_grad():
        whole = step(lp, slice(None))
        parts = [_model_slice(lp, r, n) for r in range(n)]
        heads = [slice(r * hk // n, (r + 1) * hk // n) for r in range(n)]
        before = k3.launches
        cut = _model_ranks(lambda r: step(parts[r], heads[r]), n)
        torch.cuda.synchronize()
        launches = k3.launches - before
        same = all(torch.equal(c, cut[0]) for c in cut[1:])
        alone = _model_ranks(lambda r: step(parts[r], heads[r]), n, alone=0)[0]
    label = (f"9b Dattn decode step cut over model on {n} virtual ranks ({hk // n} KV heads, "
             f"{tcfg.intermediate_size // n} FFN columns a rank)")
    print(f"  {label}: {launches} K3 launches (T2T, T2V, T2A a rank); ranks "
          f"{'bit-equal' if same else 'DIFFER'}")
    if not same or launches != 3 * n:
        raise AssertionError(f"{label}: ranks differ or {launches} K3 launches, not {3 * n}")
    err = _check(label, cut[0], whole, {"rank 0's partials alone": alone})
    return launches, err


GLOO_LAYERS, GLOO_SECONDS, GLOO_NEW = 2, 16, 4


def gloo_ranks_check() -> dict:
    """The 9B's serving path (full width, GLOO_LAYERS text layers, a
    GLOO_SECONDS s clip, GLOO_NEW greedy tokens on K1 / K2 / K3) as two
    processes on the one card over gloo (NCCL refuses two ranks on one
    GPU), with --seq-parallel 2 and with --model-parallel 2
    (`vidi_tpu_torch/tools/ranks_one_card.compare`), against one process:
    each rank's step-0 logits within LOGIT_REL of max|logit| and cosine
    LOGIT_COS (the decode-route check's limits), its tokens equal but from
    a near tie (the reference's top-2 gap there within LOGIT_REL of
    max|logit|, as `_near_tie_rule`)."""
    from vidi_tpu_torch.tools import ranks_one_card

    report = ranks_one_card.compare(layers=GLOO_LAYERS, new=GLOO_NEW, seconds=GLOO_SECONDS,
                                    mm_chunks=1)
    for mode, ranks in report.items():
        if isinstance(ranks, dict):
            raise AssertionError(f"two ranks over gloo, {mode}: a rank failed: {ranks}")
        for r, got in enumerate(ranks):
            tokens_ok = got["tokens_equal"] or got["gap_there"] <= LOGIT_REL
            if not (got["rel"] <= LOGIT_REL and got["cos"] >= LOGIT_COS and tokens_ok):
                raise AssertionError(f"two ranks over gloo, {mode} rank {r}: {got} (limits "
                                     f"{LOGIT_REL} of max|logit|, cosine {LOGIT_COS}, "
                                     "tokens equal but from a near tie)")
    print(f"  two ranks over gloo on one card: within {LOGIT_REL} / {LOGIT_COS}, tokens "
          f"equal or from a near tie [{_card()}]")
    return report


def parallel_infer_phase(dev) -> dict:
    """The inference half of the parallel slice on one card: K3's lse cases
    (`k3_lse_cases`), the seq-cut cache read on PAR_SEQ virtual ranks
    (`seq_read_check`), the 9B's decode step cut over "model" on
    MODEL_RANKS virtual ranks (`model_cut_check`), and the serving path as
    two processes over gloo (`gloo_ranks_check`). -> K3's launches on the
    seq-cut read, its new case rows, the largest error."""
    t0 = time.perf_counter()
    cases, lse_err = k3_lse_cases(dev)
    launches, shard_cases, seq_err, times = seq_read_check(dev)
    tp_launches, tp_err = model_cut_check(dev)
    gc.collect()
    torch.cuda.empty_cache()
    gloo = gloo_ranks_check()
    print(f"  parallel inference phase: {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "cases": cases + shard_cases, "lse_err": lse_err,
            "max_abs_err": max(seq_err, tp_err), "seq_read_ms": times,
            "model_cut_launches": tp_launches, "gloo": gloo}


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
    smi = _card()
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    from vidi_tpu_torch.ops.cuda import _lib
    probe = _ptxas_start()  # K5's registers and spills, beside the build
    probe_k3 = _ptxas_start("decode_attention.cu")  # K3's sm90 kernel's
    t0 = time.perf_counter()
    _lib.library()
    print(f"kernels: {_lib.library_path().name} ready in "
          f"{time.perf_counter() - t0:.1f} s (nvcc build "
          f"{'%.1f s' % _lib.build_seconds if _lib.build_seconds else 'cached'})")

    print("kernel phases:")
    _ptxas_report(probe_k3, "decode_attention_sm90")
    kern = kernel_phases(dev)
    print("K4 phase:")
    kern["flash_attention_bwd"] = k4_phase(dev)
    print("K5 phase (int8 tower layer):")
    kern.update(k5_phase(dev, probe))
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
    # the decoding variants run the slice's first SHALLOW_LAYERS text
    # layers (time: the script's limit); the daemon keeps all 42, where its
    # planted fault (the other video's caches) reads 0.135 of max|logit|
    # against the limit's 0.1 (0.064 at 14 layers)
    shallow = _shallow(sl, SHALLOW_LAYERS)
    print("decoding variants (verify_step, speculative, beams, sampling; the 120 s slice, "
          f"{SHALLOW_LAYERS} of {sl.cfg.text.num_layers} text layers):")
    serve_decoding = serve_decoding_phase(shallow)
    if args.profile:
        print("decoding variants' profile:")
        profile_decoding(shallow)
    del shallow
    print(f"serving daemon, batch runner and evals (Vidi1.5-9B bf16, {SERVE_NEW} new tokens, "
          f"a {sl.seconds} s and a {SERVE_B_SECONDS} s mp4):")
    serve_daemon, serve_runner, serve_clips = serve_phase(sl)
    if args.profile:
        print("serving daemon's profile:")
        profile_serve(sl, serve_clips)
    del serve_clips
    gc.collect()
    torch.cuda.empty_cache()
    print(f"mm_chunks reading (ROADMAP Q3.10; the first {MMC_LAYERS} layers):")
    mm_chunks_reading(sl)
    print("long-video cache check (the 120 s slice's media):")
    long_cache_check(sl)
    sl.media = None  # the 120 s slice is dropped; its weights serve the long one
    gc.collect()
    torch.cuda.empty_cache()
    print(f"long-video slice (Vidi1.5-9B, a {LONG_SECONDS} s clip, random weights):")
    serve_long, clip = long_video_phase(sl)
    if args.profile:
        print("long-video profile:")
        profile_long(sl, clip)
    del clip
    gc.collect()
    torch.cuda.empty_cache()
    print("draft distillation (teacher: the full-depth 9B slice, bf16; a 2-layer student "
          "of width 512):")
    distill = distill_phase(sl)
    print("checkpoint slice (Vidi1.5-9B at full width: save_pretrained, load_model, ask):")
    ckpt, ckpt_int8, serve_cli_run = checkpoint_phase(sl)
    del sl
    gc.collect()
    torch.cuda.empty_cache()

    print("Vidi-7B slice (Mistral-7B G = 4, CLIP ViT-L/14, v1 adapters; random weights, "
          f"a {SECONDS_7B} s clip at 224 px):")
    s7 = load_7b(dev)
    serve_7b = serve_7b_phase(s7)
    if args.profile:
        print("7B profile:")
        profile_7b(s7)
    del s7
    gc.collect()
    torch.cuda.empty_cache()

    from vidi_tpu_torch.infer import quantize as qz
    print("int8 slice (Vidi1.5-9B, int8 text + towers, W8A8 prefill from "
          f"{W8A8_MIN_TOKENS} rows, int8 caches, random weights):")
    qz.w8a8_min_tokens = W8A8_MIN_TOKENS
    sl = load_slice(dev, int8=True)
    serve_int8, serve_daemon_int8 = int8_slice_phase(sl)
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
    tr.tx = tr.state = None  # each phase below makes its own optimizer
    gc.collect()
    torch.cuda.empty_cache()
    print('remat "dots" against full remat (the 9B slice):')
    remat = remat_phase(tr)
    print("gradient accumulation k = 2 (the 9B slice):")
    grad_accum = grad_accum_phase(tr)
    print("image-mode training (the 9B slice as an image model, anyres):")
    train_image = train_image_phase(tr)
    print(f"packed rows (--pack: 2 rows of {PACK_T} tokens, the 9B slice):")
    train_pack = train_pack_phase(tr)
    if args.profile:
        print("image-mode and remat \"dots\" training profile:")
        profile_train_extras(tr)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"Vidi-7B training slice ({TRAIN_LAYERS} text layers, random weights, "
          "the 120 s clip at 224 px):")
    train_7b, tr7 = train_7b_phase(dev)
    if args.profile:
        print("7B training profile:")
        profile_7b_training(tr7)
    del tr7
    gc.collect()
    torch.cuda.empty_cache()
    print("train CLI (a subprocess on the card):")
    train_cli_phase()
    print(f"parallel slice (the 9B's T2V at full width on {PAR_SEQ} virtual seq ranks: the "
          "ring, Ulysses' local step; the train CLI in a one-rank NCCL world):")
    parallel = parallel_phase(dev)
    for name, case in parallel["cases"].items():
        kern[name]["cases"].append(case)
    print(f"parallel inference slice (K3 with its lse; the 9B image cache read on {PAR_SEQ} "
          f"virtual seq ranks; a 9B decode step cut over model on {MODEL_RANKS} virtual "
          "ranks):")
    parallel_infer = parallel_infer_phase(dev)
    kern["decode_attention"]["cases"].extend(parallel_infer["cases"])

    # launches: the path each kernel serves first (bf16 serving for K1-K3,
    # training for K4, int8 serving for K5 / K6; K7 is on no path);
    # launches_by_path gives every path's count
    paths = {"serve": serve, "serve_decoding": serve_decoding, "serve_long": serve_long,
             "serve_daemon": serve_daemon, "serve_runner": serve_runner,
             "checkpoint": ckpt, "serve_cli": serve_cli_run, "serve_7b": serve_7b,
             "checkpoint_int8": ckpt_int8, "serve_int8": serve_int8,
             "serve_daemon_int8": serve_daemon_int8, "train": train, "remat": remat,
             "grad_accum": grad_accum, "train_image": train_image, "train_pack": train_pack,
             "train_7b": train_7b, "distill": distill, "parallel": parallel["launches"],
             "parallel_infer": parallel_infer["launches"]}
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
