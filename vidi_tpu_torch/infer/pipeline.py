"""End-to-end temporal-retrieval inference for the port, plus its CLI
(port of vidi_tpu/infer/pipeline.py).

decode video -> uint8 frames + log-mel windows (host) -> SigLIP or CLIP /
Whisper towers and adapters (device) -> TR prompt -> generate (greedy,
sampled, beam search or speculative) -> parse the normalized `a.aaa-b.bbb`
ranges -> "HH:MM:SS-HH:MM:SS" spans. `cfg.mm_version` picks the
generation's prompt and parse: "v1.5" (Vidi1.5, Gemma2 chat) as above;
"v1" (Vidi-7B, Mistral chat) states the video length in the TR prompt,
parses a looser number pattern and prints seconds with two decimals.

The encode runs whole (`encode_media_arrays`: every frame decoded first)
or streamed (`stream_chunk > 0`: `encode_media_streaming`, the device
encoding one chunk of frames while the host decodes the next, the audio
decoded on its own thread; `encode_frame_stream` is its device half for
any iterable of uint8 frame chunks). `device_resize` ships the streamed
chunks at decode resolution and resizes them on the device.

    python -m vidi_tpu_torch.infer.pipeline --video-path v.mp4 --query "a red car" \
        --model-path DIR | --random-weights 9b|1.5b|7b|tiny|tiny7b \
        --device cuda|cpu --dtype bfloat16|float32 \
        [--load-8bit | --load-4bit] [--load-8bit-towers] [--quantize-kv] \
        [--w8a8-prefill MIN_TOKENS] [--stream-chunk FRAMES [--device-resize]] \
        [--random-weights-seed N] [--temperature T [--top-k K] [--top-p P] [--seed N]] \
        [--num-beams K] [--spec-ngram | --draft-model-path DIR | \
         --draft-random-weights 9b|1.5b|7b|tiny|tiny7b] [--spec-k K]

On N ranks (`torchrun --nproc_per_node N -m vidi_tpu_torch.infer.pipeline
... --seq-parallel S --model-parallel M`, N = S * M): the weights are
loaded as each rank's shards, the encode and the caches are cut over seq,
the text decoder's heads over model; every rank answers the same and rank
0 alone prints.
"""
from __future__ import annotations

import argparse
import contextlib
import re
import sys
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from vidi_tpu_torch.constants import DEFAULT_IMAGE_TOKEN, GEMMA_EOS_TOKEN_ID, IMAGE_TOKEN_INDEX
from vidi_tpu_torch.core.config import DattnConfig
from vidi_tpu_torch.media.audio import process_audio
from vidi_tpu_torch.media.text import preprocess_chat, tokenizer_image_token
from vidi_tpu_torch.infer.generate import (beam_generate, generate, speculative_generate,
                                           tokenize_stop_keywords)
from vidi_tpu_torch.models import dattn
from vidi_tpu_torch.models.adapters import budget_hw
from vidi_tpu_torch.parallel import sharding

TIME_RANGE_RE = re.compile(r"(\d\.\d+)-(\d\.\d+)")
TR_PROMPT = "During which time segments in the video can we see {}?"
# Vidi-7B (mm_version "v1"): a looser number pattern, and a prompt asking
# for percentage ranges with the video length stated
TIME_RANGE_RE_V1 = re.compile(r"([\d|\.]+)-([\d|\.]+)")
TR_PROMPT_V1 = ("Given the frames from a video, answer the time range in "
                "percentage that corresponds to query text split by comma. "
                "Video length is: {:.2f} and text query is: {}.")
TASKS = ("tr", "stg", "chapter", "highlight", "qa", "mcq", "character")


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pick_eos(cfg: DattnConfig, tokenizer) -> int:
    """Gemma2 stops at <end_of_turn> = 107, or at the tokenizer's eos when
    its vocabulary is smaller (the byte tokenizer)."""
    eos = GEMMA_EOS_TOKEN_ID if cfg.text.arch == "gemma2" else tokenizer.eos_token_id
    if getattr(tokenizer, "vocab_size", 1 << 30) <= eos:
        eos = tokenizer.eos_token_id
    return eos


def format_spans(ranges: List[Tuple[float, float]], length: float,
                 mm_version: str = "v1.5") -> str:
    """Normalized (t0, t1) pairs -> 'HH:MM:SS-HH:MM:SS, ...'; v1 prints the
    seconds with two decimals ('HH:MM:SS.00')."""
    fmt = ("{:02d}:{:02d}:{:.2f}-{:02d}:{:02d}:{:.2f}" if mm_version == "v1"
           else "{:02d}:{:02d}:{:02d}-{:02d}:{:02d}:{:02d}")
    out = []
    for r0, r1 in ranges:
        t0, t1 = r0 * length, r1 * length
        out.append(fmt.format(
            int(t0 / 3600), (int(t0) % 3600) // 60, int(t0) % 60,
            int(t1 / 3600), (int(t1) % 3600) // 60, int(t1) % 60))
    return ", ".join(out)


def parse_time_ranges(text: str, mm_version: str = "v1.5") -> List[Tuple[float, float]]:
    """The (t0, t1) number pairs of `text`; v1's loose pattern may match
    what is not a number ('..'), which is skipped."""
    pattern = TIME_RANGE_RE_V1 if mm_version == "v1" else TIME_RANGE_RE
    pairs = []
    for a, b in pattern.findall(text):
        try:
            pairs.append((float(a), float(b)))
        except ValueError:
            continue
    return pairs


def decode_media_host(vid_path: str, cfg: DattnConfig, *, fps: float = 1.0):
    """Host half of the encode: decode + PIL resize + log-mel -> (uint8
    frames [N,S,S,3], mel windows [W,n_mels,3000], audio_len). The video
    and image modules need libav or cv2, and PIL, so they load here only."""
    from vidi_tpu_torch.media.images import resize_frames_uint8
    from vidi_tpu_torch.media.video import load_audio, load_video

    frames = load_video(vid_path, fps=fps)
    pixels = resize_frames_uint8(frames, cfg.vision.image_size)
    mels, audio_len = process_audio(load_audio(vid_path, cfg.audio.sampling_rate),
                                    cfg.audio)
    return pixels, mels, audio_len


def encode_media_arrays(params, cfg: DattnConfig, pixels, mels, audio_len, *,
                        mm_chunks: int = 32, use_flash: bool = False):
    """Device half: uint8 frames + mel windows -> (img, img_mask, aud,
    aud_mask) on the parameters' device."""
    dev = params["text"]["embed"].device
    n = pixels.shape[0]
    hw = budget_hw(n, cfg.mm_image_pool_size, cfg.vision.num_patches_per_side,
                   cfg.mm_max_tokens_base)
    img, img_mask = dattn.encode_video_images(
        params, cfg, torch.as_tensor(np.asarray(pixels)).to(dev)[None],
        torch.tensor([n], device=dev), hw, mm_chunks=mm_chunks,
        use_flash=use_flash)
    return (img, img_mask,
            *_encode_audio(params, cfg, mels, audio_len, mm_chunks, use_flash))


def _encode_audio(params, cfg: DattnConfig, mels, audio_len, mm_chunks: int,
                  use_flash: bool):
    """Mel windows [W,n_mels,3000] -> (aud, aud_mask) on the parameters'
    device."""
    dev = params["text"]["embed"].device
    return dattn.encode_video_audios(
        params, cfg, torch.as_tensor(np.asarray(mels, np.float32)).to(dev)[None],
        torch.tensor([audio_len], device=dev), mm_chunks=mm_chunks,
        use_flash=use_flash)


def _encode_frame_chunks(params, cfg: DattnConfig, chunks, n_frames: int, *,
                        use_flash: bool = False, device_resize: bool = False):
    """Image half of the streamed encode: uint8 frame chunks [C,H,W,3] (any
    iterable; each goes to the device and through the tower while the
    producer makes the next) -> (img [1, N*h2*w2, d], img_mask). The token
    grid is fixed from `n_frames` before the first frame arrives
    (`budget_hw`). With `device_resize` the chunks ship at their decode
    resolution and are resized on the device; otherwise the host's PIL
    resize runs on each chunk first. Under a seq mesh only this rank's
    ceil(N / seq) frames are encoded (the rest are decoded and dropped)
    and its slice of the stream is returned, as `encode_video_images`
    gives it."""
    dev = params["text"]["embed"].device
    params = sharding.gathered(params, skip_layers=True)
    hw = budget_hw(n_frames, cfg.mm_image_pool_size, cfg.vision.num_patches_per_side,
                   cfg.mm_max_tokens_base)
    first, n_loc = sharding.seq_cut(n_frames)
    toks, seen = [], 0
    for chunk in chunks:
        start, seen = seen, seen + len(chunk)
        mine = chunk[max(first - start, 0):max(first + n_loc - start, 0)]
        if len(mine) == 0:
            continue
        if device_resize:
            pixels = np.ascontiguousarray(mine)
        else:
            from vidi_tpu_torch.media.images import resize_frames_uint8
            pixels = resize_frames_uint8(mine, cfg.vision.image_size)
        toks.append(dattn.frame_tokens_chunk(params, torch.as_tensor(pixels).to(dev),
                                             cfg, hw, use_flash))
    if seen != n_frames:
        raise ValueError(f"the chunks held {seen} frames, not {n_frames}")
    if toks:
        tok = torch.cat(toks)[None]  # [1, frames of this rank, h2, w2, d]
    else:  # a rank past the last frame
        emb = params["text"]["embed"]
        tok = emb.new_zeros((1, 0, *dattn.frame_side(cfg, hw), emb.shape[-1]))
    if tok.shape[1] < n_loc:  # an uneven cut's last rank: padding frames
        tok = sharding.take_padded(tok, 1, 0, n_loc)
    return dattn.finish_video_tokens(params, cfg, tok, torch.tensor([n_frames], device=dev),
                                     frames=(first, n_frames))


def encode_frame_stream(params, cfg: DattnConfig, chunks, n_frames: int, mels,
                        audio_len, *, mm_chunks: int = 32, use_flash: bool = False,
                        device_resize: bool = False):
    """Streamed device encode from frame chunks already decoded (or decoded
    as they are iterated) and the clip's mel windows -> (img, img_mask,
    aud, aud_mask), as `encode_media_arrays` gives them for the same
    frames. See `_encode_frame_chunks`."""
    img, img_mask = _encode_frame_chunks(params, cfg, chunks, n_frames,
                                        use_flash=use_flash,
                                        device_resize=device_resize)
    return (img, img_mask,
            *_encode_audio(params, cfg, mels, audio_len, mm_chunks, use_flash))


def encode_media_streaming(params, cfg: DattnConfig, vid_path: str, *,
                           fps: float = 1.0, chunk_frames: int = 112,
                           mm_chunks: int = 32, use_flash: bool = False,
                           device_resize: bool = False):
    """Video file -> (img, img_mask, aud, aud_mask), streamed: the frames
    are decoded in `chunk_frames` chunks, each encoded on the device while
    the host decodes the next, and the audio is decoded on its own thread
    meanwhile (its error re-raised after the frames). The frame count, so
    the token grid, comes from the container before any frame is decoded.
    Numerics equal `encode_media_arrays`': every per-frame step is local to
    its chunk."""
    from vidi_tpu_torch.media.video import _frame_indices, load_audio, probe, stream_video

    _, avg_fps, n_total, _, _ = probe(vid_path)
    n = len(_frame_indices(n_total, avg_fps, fps, None))
    audio = {}

    def decode_audio():
        try:
            audio["mels"] = process_audio(load_audio(vid_path, cfg.audio.sampling_rate),
                                          cfg.audio)
        except Exception as e:  # noqa: BLE001 -- re-raised after the join
            audio["err"] = e

    thread = threading.Thread(target=decode_audio, daemon=True)
    thread.start()
    try:
        img, img_mask = _encode_frame_chunks(
            params, cfg, stream_video(vid_path, fps=fps, chunk=chunk_frames), n,
            use_flash=use_flash, device_resize=device_resize)
    finally:
        thread.join()
    if "err" in audio:
        raise audio["err"]
    return (img, img_mask,
            *_encode_audio(params, cfg, *audio["mels"], mm_chunks, use_flash))


def encode_media(params, cfg: DattnConfig, vid_path: str, *, fps: float = 1.0,
                 mm_chunks: int = 32, use_flash: bool = False,
                 stream_chunk: int = 0, device_resize: bool = False):
    """Video file -> (img, img_mask, aud, aud_mask): streamed in
    `stream_chunk`-frame chunks when it is > 0, else decoded whole first.
    `device_resize` needs `stream_chunk`: the whole path would hold every
    raw-resolution frame on the device at once."""
    if stream_chunk > 0:
        return encode_media_streaming(params, cfg, vid_path, fps=fps,
                                      chunk_frames=stream_chunk, mm_chunks=mm_chunks,
                                      use_flash=use_flash, device_resize=device_resize)
    if device_resize:
        raise ValueError("device_resize needs stream_chunk > 0 (the whole-video "
                         "path would stage every raw-resolution frame on the "
                         "device at once)")
    return encode_media_arrays(params, cfg, *decode_media_host(vid_path, cfg, fps=fps),
                               mm_chunks=mm_chunks, use_flash=use_flash)


def build_prompt_ids(question: str, tokenizer, mm_version: str = "v1.5",
                     length: float = 0.0, task: str = "tr",
                     options=None) -> np.ndarray:
    """Chat-templated prompt ids with the <image> token spliced out (video
    reaches Dattn through cross attention, not the text stream): the
    Gemma2 template for v1.5, Mistral's for v1, whose TR prompt states the
    video's `length` in seconds."""
    from vidi_tpu_torch.infer.tasks import build_task_prompt

    qs = DEFAULT_IMAGE_TOKEN + "\n" + build_task_prompt(
        task, question, mm_version=mm_version, length=length, options=options)
    prompt = preprocess_chat([{"from": "human", "value": qs}], tokenizer,
                             arch="mistral" if mm_version == "v1" else "gemma2")
    ids = tokenizer_image_token(prompt, tokenizer, IMAGE_TOKEN_INDEX)
    return np.asarray([t for t in ids if t != IMAGE_TOKEN_INDEX], np.int32)


def build_prompt_batch(ids_list, pad_to: int = 64):
    """Right-pad token-id sequences to a shared multiple of `pad_to`
    -> (prompt [Q,T] int32, mask [Q,T] bool)."""
    t = _round_up(max(len(i) for i in ids_list), pad_to)
    prompt = np.zeros((len(ids_list), t), np.int32)
    mask = np.zeros((len(ids_list), t), bool)
    for r, ids in enumerate(ids_list):
        prompt[r, : len(ids)] = ids
        mask[r, : len(ids)] = True
    return prompt, mask


def ask(question: str, vid_path: str, params, cfg: DattnConfig, tokenizer, *,
        task: str = "tr", fps: float = 1.0, max_new_tokens: int = 1024,
        mm_chunks: int = 32, eos_id: Optional[int] = None, pad_to: int = 64,
        use_flash: Optional[bool] = None, use_flash_decode: bool = False,
        quantize_caches: bool = False, stream_chunk: int = 0,
        device_resize: bool = False, stop_keywords: tuple = (),
        temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
        seed: int = 0, num_beams: int = 1, draft=None, spec_k: int = 4) -> str:
    """Answer one query about one video -> the task's display string.
    `use_flash=None` means "the parameters are on a CUDA device": the CUDA
    kernels run there and the reference ops on the CPU. `quantize_caches`
    keeps the image / audio KV caches as per-token int8; `stream_chunk` and
    `device_resize` select the encode (`encode_media`).

    Decoding: greedy by default; `temperature > 0` samples (with `top_k`,
    `top_p`) from a generator seeded with `seed` on the model's device;
    `num_beams > 1` runs beam search; `draft` ("ngram", or (params, cfg)
    of a small text-only model sharing the vocabulary) runs speculative
    decoding with `spec_k` drafts a pass, and prints its acceptance on
    stderr. A draft with `num_beams > 1` is ignored (with a warning). The
    beam and speculative routes stop at eos only; `stop_keywords` then act
    on the text."""
    from vidi_tpu_torch.media.video import get_media_length

    dev = params["text"]["embed"].device
    if use_flash is None:
        use_flash = dev.type == "cuda"
    length = get_media_length(vid_path)
    img, img_mask, aud, aud_mask = encode_media(
        params, cfg, vid_path, fps=fps, mm_chunks=mm_chunks, use_flash=use_flash,
        stream_chunk=stream_chunk, device_resize=device_resize)
    prompt, mask = build_prompt_batch(
        [build_prompt_ids(question, tokenizer, cfg.mm_version, length, task)], pad_to)
    args = (params, cfg, torch.as_tensor(prompt).long().to(dev),
            torch.as_tensor(mask).to(dev), img, img_mask, aud, aud_mask)
    kw = dict(max_new_tokens=max_new_tokens,
              eos_id=eos_id if eos_id is not None else pick_eos(cfg, tokenizer),
              mm_chunks=mm_chunks, use_flash=use_flash,
              use_flash_decode=use_flash_decode, quantize_caches=quantize_caches)
    sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                    generator=(torch.Generator(device=dev).manual_seed(seed)
                               if temperature > 0 else None))
    if draft is not None and num_beams > 1:
        print("warning: speculative decoding does not compose with beam search; "
              "the draft is IGNORED with num_beams > 1", file=sys.stderr)
    if draft is not None and num_beams == 1:
        d_params, d_cfg = (None, None) if draft == "ngram" else draft
        result = speculative_generate(params, cfg, d_params, d_cfg, *args[2:],
                                      spec_k=spec_k, **kw, **sampling)
        n_acc, n_draft = int(result.n_accepted.sum()), int(result.n_drafted.sum())
        if sharding.is_root():
            print(f"speculative: {result.n_target_steps} target passes, accept "
                  f"{n_acc}/{max(n_draft, 1)} ({n_acc / max(n_draft, 1):.0%})",
                  file=sys.stderr)
    elif num_beams > 1:
        result = beam_generate(*args, num_beams=num_beams, **kw)
    else:
        result = generate(*args, **kw, **sampling,
                          stop_sequences=tokenize_stop_keywords(stop_keywords, tokenizer))
    n = int(result.lengths[0])
    text = tokenizer.decode(result.tokens[0, :n].cpu().numpy(),
                            skip_special_tokens=True).strip()
    if stop_keywords:
        from vidi_tpu_torch.media.text import truncate_at_keywords
        text = truncate_at_keywords(text, stop_keywords).strip()
    return parse_task_output(text, task, length, cfg.mm_version)


def parse_task_output(text: str, task: str, length: float,
                      mm_version: str = "v1.5") -> str:
    """Decoded model text -> the task's display string."""
    from vidi_tpu_torch.infer import tasks

    if task == "tr":
        return format_spans(parse_time_ranges(text, mm_version), length, mm_version)
    if task == "chapter":
        return "\n".join(f"{c['start']:.1f}-{c['end']:.1f}s {c['title']}"
                         for c in tasks.parse_chapters(text, length, mm_version))
    if task == "highlight":
        return ", ".join(f"{a:.1f}-{b:.1f}s"
                         for a, b in tasks.parse_highlights(text, length, mm_version))
    if task == "mcq":
        return tasks.parse_mcq(text)
    if task == "character":
        import json
        return json.dumps(tasks.parse_character(text, length))
    return text  # qa / stg: the raw model text


def main(argv=None):
    from vidi_tpu_torch.infer import quantize
    from vidi_tpu_torch.infer.loader import CONFIGS, load_model

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video-path", required=True)
    p.add_argument("--query", required=True)
    p.add_argument("--task", default="tr", choices=TASKS)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model-path", help="an HF-format Vidi checkpoint directory "
                                          "(config.json + *.safetensors)")
    src.add_argument("--random-weights", choices=sorted(CONFIGS),
                     help="random weights at this configuration's widths")
    p.add_argument("--device", default="cuda",
                   help="cuda (raises without a card) or cpu")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--random-weights-seed", type=int, default=0,
                   help="seed of --random-weights and --draft-random-weights")
    p.add_argument("--fps", type=float, default=1.0)
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--mm-splits", type=int, default=32)
    p.add_argument("--load-8bit", action="store_true",
                   help="int8 weight-only text decoder (bitsandbytes load_in_8bit)")
    p.add_argument("--load-4bit", action="store_true",
                   help="group-wise int4 weight-only text decoder (load_4bit)")
    p.add_argument("--load-8bit-towers", action="store_true",
                   help="int8 SigLIP / Whisper layers with per-row int8 activations")
    p.add_argument("--quantize-kv", action="store_true",
                   help="per-token int8 image / audio KV caches")
    p.add_argument("--w8a8-prefill", type=int, default=None, metavar="MIN_TOKENS",
                   help="with --load-8bit: int8 activations for decoder products "
                        "of at least MIN_TOKENS rows (the modality-stream prefill); "
                        "decode stays weight-only")
    p.add_argument("--stream-chunk", type=int, default=0, metavar="FRAMES",
                   help="encode while decoding, in chunks of FRAMES frames "
                        "(0: decode the whole video first)")
    p.add_argument("--device-resize", action="store_true",
                   help="with --stream-chunk: ship frames at their decode "
                        "resolution and resize them on the device")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0: greedy; > 0: sample from the warped distribution")
    p.add_argument("--top-k", type=int, default=0,
                   help="with --temperature: keep the k best logits (and their ties)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="with --temperature: nucleus sampling mass")
    p.add_argument("--seed", type=int, default=0,
                   help="sampling seed (runs are reproducible)")
    p.add_argument("--num-beams", type=int, default=1,
                   help="> 1: beam search; the image / audio caches stay shared "
                        "across a query's beams")
    p.add_argument("--draft-model-path",
                   help="a small text-only HF checkpoint with the target's "
                        "vocabulary: speculative decoding (greedy output equals "
                        "plain greedy)")
    p.add_argument("--draft-random-weights", choices=sorted(CONFIGS),
                   help="random draft weights at this configuration's widths")
    p.add_argument("--spec-k", type=int, default=4,
                   help="speculative window: draft tokens verified a target pass")
    p.add_argument("--spec-ngram", action="store_true",
                   help="speculative decoding drafting from 2-gram matches in "
                        "the prompt and generated history (no draft model)")
    p.add_argument("--seq-parallel", type=int, default=1, metavar="N",
                   help="ranks (torchrun) over which the modality streams and "
                        "their KV caches are cut (data stays 1)")
    p.add_argument("--model-parallel", type=int, default=1, metavar="N",
                   help="ranks (torchrun) over which the text decoder's heads and "
                        "FFN columns are cut (tensor parallelism)")
    args = p.parse_args(argv)

    if args.w8a8_prefill is not None:
        quantize.w8a8_min_tokens = args.w8a8_prefill
    dtype = getattr(torch, args.dtype)
    with mesh_from_flags(args.device, 1, args.seq_parallel, args.model_parallel) as (dev, mesh):
        params, cfg, tokenizer = load_model(
            args.model_path, args.random_weights, dtype=dtype, device=dev,
            seed=args.random_weights_seed, load_8bit=args.load_8bit,
            load_8bit_towers=args.load_8bit_towers, load_4bit=args.load_4bit, mesh=mesh)
        draft = "ngram" if args.spec_ngram else None
        if args.draft_model_path or args.draft_random_weights:
            d_params, d_cfg, _ = load_model(
                args.draft_model_path, args.draft_random_weights, dtype=dtype,
                device=dev, seed=args.random_weights_seed,
                load_8bit=args.load_8bit, mesh=mesh)
            draft = (d_params, d_cfg)
        out = ask(args.query, args.video_path, params, cfg, tokenizer,
                  task=args.task, fps=args.fps, max_new_tokens=args.max_new_tokens,
                  mm_chunks=args.mm_splits, quantize_caches=args.quantize_kv,
                  stream_chunk=args.stream_chunk, device_resize=args.device_resize,
                  temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                  seed=args.seed, num_beams=args.num_beams, draft=draft,
                  spec_k=args.spec_k)
        if sharding.is_root():
            print(out if out else "(no parsed output)")


@contextlib.contextmanager
def mesh_from_flags(device, data: int, seq: int, model: int):
    """The CLIs' mesh: -> (this rank's device, the (data, seq, model) mesh
    over torchrun's ranks, active for the block; None for one process).
    More than one rank needs torchrun (SystemExit otherwise): NCCL on
    cuda, gloo on cpu. The process group is torn down after the block."""
    from vidi_tpu_torch.core.mesh import init_from_env, make_mesh, shutdown
    from vidi_tpu_torch.infer.loader import resolve_device

    dev = resolve_device(device)
    if data * seq * model == 1:
        yield dev, None
        return
    launched = init_from_env(dev.type)
    if launched is None:
        raise SystemExit("--data-parallel / --seq-parallel / --model-parallel > 1 need "
                         "ranks: launch with torchrun --nproc_per_node N")
    mesh = make_mesh(data=data, seq=seq, model=model, device_type=dev.type)
    with sharding.use_mesh(mesh):
        yield launched, mesh
    # reached only when this rank's run ended well (a failing rank exits at
    # once and torchrun tears the job down)
    shutdown(mesh)


if __name__ == "__main__":
    main()
