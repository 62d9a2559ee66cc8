"""Online serving daemon: JSONL requests in, JSONL responses out (port of
vidi_tpu/infer/serve.py).

- **Request micro-batching**: the loop blocks for one request, then drains
  whatever else has already arrived (plus an optional ``--linger`` wait, one
  deadline) and groups pending queries by video. Up to ``--batch-queries``
  same-video rows share ONE generate call: the media caches are batch-1 and
  shared across the rows (``dattn.media_prefill``), so an extra query costs
  its text prefill and its share of the decode steps.
- **Cross-video bundles** (``--batch-videos N``): up to N single-query
  videos ride one generate call, each row carrying its own video's caches,
  padded along S and stacked on the batch axis (``_stack_media``). Videos
  whose modalities differ from the first's are requeued.
- **Media-cache LRU**: the last ``--media-cache`` videos' stream caches stay
  on the card. A repeat query against a resident video skips host decode,
  tower encode and stream prefill. Eviction drops the Python references;
  the caching allocator reuses the blocks.
- **Decode-ahead** (``--decode-ahead``, off by default): while the current
  bundle runs on the card, the next pending video decodes on a host thread
  (host work only: every CUDA call stays on the loop's thread). The payload
  feeds ``encode_media_arrays``, the split ``encode_media`` uses, so the
  numbers are the same. ``--stream-chunk`` overlaps decode within each
  video instead and turns the thread off.
- **Speculative decode**: n-gram drafts (``--spec-ngram``) or a small draft
  model (``--draft-model-path``); greedy output equals plain greedy.
- **Sampling** (``--temperature``): one ``torch.Generator`` on the model's
  device, seeded with ``--seed`` when the loop starts and drawn from in
  call order, so the same seed and request stream give the same answers.
- **Per-request error isolation**: a failed request answers
  ``{"id": ..., "error": ...}`` without ending the loop.

Request line:  {"id": str, "video": path, "query": str, "task": "tr",
                "options": [..]?}   (task defaults to "tr")
Response line: {"id": str, "text": str, "parsed": str, "video_s": float,
                "cached_media": bool} | {"id": str, "error": str}

    python -m vidi_tpu_torch.infer.serve --model-path DIR | --random-weights 9b \
        [--device cuda|cpu] [--dtype bfloat16|float32] [--in req.jsonl] \
        [--out resp.jsonl] [--media-cache 4] [--batch-queries 4] \
        [--batch-videos 1] [--spec-ngram] [--load-8bit --quantize-kv ...]

EOF on the request stream drains pending work, prints the stats to stderr,
and returns.
"""
from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Iterable, Optional

import torch


class MediaLRU:
    """The most recently used videos' (length, img_mask, aud_mask,
    media_caches) tuples. Eviction drops the Python references; the
    caching allocator reuses the blocks once no generate holds them."""

    def __init__(self, capacity: int):
        self.capacity = max(capacity, 1)
        self._od: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        if key in self._od:
            self._od.move_to_end(key)
            self.hits += 1
            return self._od[key]
        self.misses += 1
        return None

    def put(self, key, value):
        self._od[key] = value
        self._od.move_to_end(key)
        while len(self._od) > self.capacity:
            self._od.popitem(last=False)

    def __contains__(self, key):  # peek without touching the hit / miss counts
        return key in self._od


def _pad_tail(x: torch.Tensor, dim: int, n: int, value) -> torch.Tensor:
    """x with n slots of `value` appended along `dim`."""
    if n == 0:
        return x
    shape = list(x.shape)
    shape[dim] = n
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim)


def _stack_media(entries):
    """[(img_mask, aud_mask, media_caches)] of B distinct videos -> batch-B
    masks and caches, padded along S to the longest stream: masks with
    False (padded slots are never attended), bf16 caches and int8 codes
    with 0, int8 scales with 1. Caches are [L,B,Hk,S,D] (int8: {qi8
    [L,B,Hk,S,D], scale [L,B,Hk,S,1]}). Each row then carries its own
    video's caches. Every video must carry the same modalities (serve_loop
    requeues those that do not); a mixed bundle raises ValueError."""

    def stack_masks(ms):
        if all(m is None for m in ms):
            return None
        if any(m is None for m in ms):
            raise ValueError("a cross-video bundle mixes present and absent modalities")
        s = max(m.shape[1] for m in ms)
        return torch.cat([_pad_tail(m, 1, s - m.shape[1], False) for m in ms], 0)

    def seq_len(c):
        return (c["qi8"] if isinstance(c, dict) else c).shape[3]

    def pad_leaf(x, s):
        if isinstance(x, dict):
            d = s - x["qi8"].shape[3]
            return {**x, "qi8": _pad_tail(x["qi8"], 3, d, 0),
                    "scale": _pad_tail(x["scale"], 3, d, 1)}
        return _pad_tail(x, 3, s - x.shape[3], 0)

    def stack_caches(cs):
        if all(c is None for c in cs):
            return None
        if any(c is None for c in cs):
            raise ValueError("a cross-video bundle mixes present and absent "
                             "modality caches")
        s = max(seq_len(c) for c in cs)
        padded = [pad_leaf(c, s) for c in cs]
        if isinstance(padded[0], dict):
            return {k: torch.cat([p[k] for p in padded], 1) for k in padded[0]}
        return torch.cat(padded, 1)

    ims, ams, medias = zip(*entries)
    media = medias[0]._replace(
        img_k=stack_caches([m.img_k for m in medias]),
        img_v=stack_caches([m.img_v for m in medias]),
        aud_k=stack_caches([m.aud_k for m in medias]),
        aud_v=stack_caches([m.aud_v for m in medias]))
    return stack_masks(ims), stack_masks(ams), media


def _reader(stream, q: "queue.Queue"):
    """stdin / file -> queue; one JSON object a line; None = EOF."""
    for line in stream:
        line = line.strip()
        if not line:
            continue
        try:
            q.put(json.loads(line))
        except json.JSONDecodeError as e:
            q.put({"_bad_line": line, "_err": str(e)})
    q.put(None)


def _drop(items, gone):
    """`items` without the entries of `gone`, compared by identity (an
    entry holds tensors, whose == is elementwise)."""
    return [o for o in items if not any(o is g for g in gone)]


def serve_loop(
    params,
    cfg,
    tokenizer,
    requests: "queue.Queue",
    emit: Callable[[dict], None],
    *,
    fps: float = 1.0,
    mm_splits: int = 32,
    max_new_tokens: int = 1024,
    batch_queries: int = 4,
    batch_videos: int = 1,
    media_cache: int = 4,
    quantize_kv: bool = False,
    stream_chunk: int = 0,
    spec_ngram: bool = False,
    draft=None,  # (draft_params, draft_cfg): model-draft speculative decode
    spec_k: int = 4,
    linger_s: float = 0.0,
    decode_ahead: bool = False,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
    chunked_prefill_tokens: int = 131072,
) -> dict:
    """Drain `requests` (a Queue fed by a reader thread; None = EOF),
    emitting one response dict a request. Returns the serving stats.
    Prefills run on the kernels when the parameters are on a CUDA device
    (`use_flash`); decode steps take the reference ops, as in vidi_tpu."""
    from vidi_tpu_torch.infer import pipeline
    from vidi_tpu_torch.infer.generate import generate, speculative_generate
    from vidi_tpu_torch.media.video import get_media_length
    from vidi_tpu_torch.models import dattn

    dev = params["text"]["embed"].device
    use_flash = dev.type == "cuda"
    lru = MediaLRU(media_cache)
    pending: deque = deque()
    eof = False
    served = 0
    errors = 0
    generate_calls = 0
    overlapped_decodes = 0
    generator = (torch.Generator(device=dev).manual_seed(seed)
                 if temperature > 0 else None)
    t_start = time.perf_counter()

    def pull(timeout: Optional[float] = None) -> bool:
        """Move one queue item into `pending`; False on EOF / empty.
        timeout None blocks until something arrives; 0 does not block."""
        nonlocal eof, errors
        if eof:
            return False
        try:
            if timeout is None:
                item = requests.get()
            elif timeout == 0:
                item = requests.get_nowait()
            else:
                item = requests.get(timeout=timeout)
        except queue.Empty:
            return False
        if item is None:
            eof = True
            return False
        if not isinstance(item, dict) or "_bad_line" in item:
            why = (item.get("_err") if isinstance(item, dict)
                   else f"not a JSON object: {item!r}")
            emit({"id": None, "error": f"bad request line: {why}"})
            errors += 1
            return True
        if not item.get("video") or "query" not in item:
            emit({"id": item.get("id"),
                  "error": "request needs 'video' and 'query' fields"})
            errors += 1
            return True
        pending.append(item)
        return True

    # decode-ahead: one host thread decodes the next pending video that is
    # not cached while the card works on the current bundle
    ahead: dict = {"path": None, "thread": None, "payload": None}

    def _ahead_worker(path):
        try:
            ahead["payload"] = pipeline.decode_media_host(path, cfg, fps=fps)
        except Exception as e:  # noqa: BLE001 -- re-raised at encode()
            ahead["payload"] = e

    def start_ahead():
        if not decode_ahead or stream_chunk or ahead["thread"] is not None:
            return
        for r in pending:
            v = r.get("video")
            if v and v not in lru:
                ahead.update(path=v, payload=None,
                             thread=threading.Thread(target=_ahead_worker,
                                                     args=(v,), daemon=True))
                ahead["thread"].start()
                return

    def encode(vid_path: str):
        nonlocal overlapped_decodes
        got = lru.get(vid_path)
        if got is not None:
            return got + (True,)
        host = None
        if ahead["path"] == vid_path and ahead["thread"] is not None:
            ahead["thread"].join()
            payload = ahead["payload"]
            ahead.update(path=None, thread=None, payload=None)
            if isinstance(payload, Exception):
                raise payload
            host = payload
            overlapped_decodes += 1
        if host is not None:
            enc = pipeline.encode_media_arrays(
                params, cfg, *host, mm_chunks=mm_splits, use_flash=use_flash)
        else:
            enc = pipeline.encode_media(
                params, cfg, vid_path, fps=fps, mm_chunks=mm_splits,
                use_flash=use_flash, stream_chunk=stream_chunk)
        img, im, aud, am = enc
        n_stream = ((im.shape[1] if im is not None else 0)
                    + (am.shape[1] if am is not None else 0))
        if chunked_prefill_tokens and n_stream > chunked_prefill_tokens:
            # long streams: chunk-major, the peak bounded at the caches plus
            # one chunk's transients; the same numbers
            media = dattn.media_prefill_chunked(
                params, cfg, img=img, aud=aud, quantize_caches=quantize_kv)
        else:
            media = dattn.media_prefill(
                params, cfg, img=img, img_mask=im, aud=aud, aud_mask=am,
                mm_chunks=mm_splits, use_flash=use_flash,
                quantize_caches=quantize_kv)
        val = (get_media_length(vid_path), im, am, media)
        lru.put(vid_path, val)
        return val + (False,)

    while True:
        if not pending:
            while not pending and not eof:  # block for the next request or EOF
                pull()
            if not pending:
                break
        # drain what has already arrived (the micro-batch window), then
        # linger for stragglers until one deadline
        while len(pending) < batch_queries * 4 and pull(0):
            pass
        if linger_s > 0:
            deadline = time.monotonic() + linger_s
            while len(pending) < batch_queries * 4:
                left = deadline - time.monotonic()
                if left <= 0 or not pull(left):
                    break

        vid = pending[0]["video"]
        group = [r for r in pending if r.get("video") == vid][:batch_queries]
        bundles = [(vid, group)]
        if batch_videos > 1 and len(group) == 1:
            # bundle more single-query videos into this generate; videos with
            # several queries keep their shared batch-1 caches
            seen = {vid}
            for r in list(pending):
                if len(bundles) >= min(batch_videos, batch_queries):
                    break
                v = r.get("video")
                if v in seen:
                    continue
                seen.add(v)
                rows = [x for x in pending if x.get("video") == v]
                if len(rows) == 1:
                    bundles.append((v, rows))
        for _, g in bundles:
            for r in g:
                pending.remove(r)
        start_ahead()  # the next pending video decodes under this bundle

        ok = []  # (group, length, im, am, media, cached)
        for v, g in bundles:
            try:
                length, im, am, media, cached = encode(v)
                ok.append((g, length, im, am, media, cached))
            except Exception as e:  # noqa: BLE001 -- isolate the bad video
                for r in g:
                    emit({"id": r.get("id"), "error": f"media: {e}"})
                    errors += 1
        if not ok:
            continue

        if len(ok) > 1:
            # stacking needs one modality signature across the bundle; the
            # misfits go back to the front of the queue (their caches are in
            # the LRU, so the retry hits)
            sig = (ok[0][2] is not None, ok[0][3] is not None)
            misfit = [o for o in ok[1:]
                      if (o[2] is not None, o[3] is not None) != sig]
            if misfit:
                ok = _drop(ok, misfit)
                for o in reversed(misfit):
                    pending.extendleft(reversed(o[0]))

        if len(ok) == 1:
            g, length, im, am, media, cached = ok[0]
            rows = [(r, length, cached) for r in g]
        else:
            im, am, media = _stack_media([(o[2], o[3], o[4]) for o in ok])
            rows = [(o[0][0], o[1], o[5]) for o in ok]

        answered = 0
        group = [r for r, _, _ in rows]
        try:
            tasks = [r.get("task", "tr") for r in group]
            ids_list = [
                pipeline.build_prompt_ids(r["query"], tokenizer, cfg.mm_version, length_r,
                                          task="mcq" if t == "vqa" else t,
                                          options=r.get("options"))
                for (r, length_r, _), t in zip(rows, tasks)]
            prompt, mask = pipeline.build_prompt_batch(ids_list)
            prompt = torch.as_tensor(prompt).long().to(dev)
            mask = torch.as_tensor(mask).to(dev)
            kw = dict(img_mask=im, aud_mask=am, media_caches=media,
                      max_new_tokens=max_new_tokens,
                      eos_id=pipeline.pick_eos(cfg, tokenizer),
                      use_flash=use_flash, mm_chunks=mm_splits)
            if temperature > 0:
                kw.update(temperature=temperature, top_k=top_k, top_p=top_p,
                          generator=generator)
            if draft is not None:
                res = speculative_generate(params, cfg, draft[0], draft[1], prompt,
                                           mask, spec_k=spec_k, **kw)
            elif spec_ngram:
                res = speculative_generate(params, cfg, None, None, prompt, mask,
                                           spec_k=spec_k, **kw)
            else:
                res = generate(params, cfg, prompt, mask, **kw)
            generate_calls += 1
            toks = res.tokens.cpu().numpy()
            lens = res.lengths.cpu().numpy()
            for row, ((r, length_r, cached_r), t) in enumerate(zip(rows, tasks)):
                text = tokenizer.decode(toks[row, : lens[row]],
                                        skip_special_tokens=True).strip()
                emit({"id": r.get("id"), "text": text,
                      "parsed": pipeline.parse_task_output(
                          text, "mcq" if t == "vqa" else t, length_r, cfg.mm_version),
                      "video_s": length_r, "cached_media": cached_r})
                served += 1
                answered += 1
        except Exception as e:  # noqa: BLE001 -- isolate the failing group;
            # only rows not yet answered get an error
            for r in group[answered:]:
                emit({"id": r.get("id"), "error": str(e)})
                errors += 1

    wall = time.perf_counter() - t_start
    return {"served": served, "errors": errors, "wall_s": round(wall, 3),
            "queries_per_s": round(served / wall, 3) if wall else 0.0,
            "generate_calls": generate_calls,
            "media_cache_hits": lru.hits, "media_cache_misses": lru.misses,
            "overlapped_decodes": overlapped_decodes}


def main(argv: Optional[Iterable[str]] = None) -> dict:
    from vidi_tpu_torch.infer.loader import CONFIGS

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--random-weights", choices=sorted(CONFIGS), default=None,
                    help="random weights at this configuration's widths")
    ap.add_argument("--random-weights-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    ap.add_argument("--in", dest="infile", default=None,
                    help="JSONL request file (default: stdin)")
    ap.add_argument("--out", dest="outfile", default=None,
                    help="JSONL response file (default: stdout)")
    ap.add_argument("--fps", type=float, default=1.0)
    ap.add_argument("--mm-splits", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=1024)
    ap.add_argument("--batch-queries", type=int, default=4)
    ap.add_argument("--batch-videos", type=int, default=1,
                    help=">1: bundle up to N single-query videos into one "
                         "generate, each row with its own video's caches "
                         "stacked on the batch axis (the stacked caches are "
                         "the sum of the videos', padded to the longest)")
    ap.add_argument("--media-cache", type=int, default=4,
                    help="videos whose media caches stay on the card")
    ap.add_argument("--linger", type=float, default=0.0, metavar="SECONDS",
                    help="wait this long for more requests before running a "
                         "partial batch (bigger micro-batches, more latency)")
    ap.add_argument("--load-8bit", action="store_true")
    ap.add_argument("--load-8bit-towers", action="store_true")
    ap.add_argument("--load-4bit", action="store_true")
    ap.add_argument("--quantize-kv", action="store_true")
    ap.add_argument("--w8a8-prefill", type=int, default=None)
    ap.add_argument("--stream-chunk", type=int, default=0)
    ap.add_argument("--spec-ngram", action="store_true")
    ap.add_argument("--draft-model-path", default=None,
                    help="small text-only draft checkpoint for model-draft "
                         "speculative decoding; overrides --spec-ngram")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--decode-ahead", action="store_true",
                    help="decode the next pending video on a host thread under "
                         "the current bundle's card work (off by default; "
                         "--stream-chunk overlaps within each video instead)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help=">0: sample (temperature -> top-k -> top-p)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0, help="the sampling seed")
    ap.add_argument("--chunked-prefill-tokens", type=int, default=131072,
                    help="streams longer than this many tokens prefill chunk-"
                         "major (media_prefill_chunked); 0 disables")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    args = ap.parse_args(list(argv) if argv is not None else None)

    from vidi_tpu_torch.infer import quantize
    from vidi_tpu_torch.infer.loader import load_model

    if args.w8a8_prefill is not None:
        quantize.w8a8_min_tokens = args.w8a8_prefill
    dtype = getattr(torch, args.dtype)
    params, cfg, tokenizer = load_model(
        args.model_path, args.random_weights, dtype=dtype, device=args.device,
        seed=args.random_weights_seed, load_8bit=args.load_8bit,
        load_8bit_towers=args.load_8bit_towers, load_4bit=args.load_4bit)
    draft = None
    if args.draft_model_path:
        d_params, d_cfg, _ = load_model(args.draft_model_path, dtype=dtype,
                                        device=args.device)
        draft = (d_params, d_cfg)

    q: "queue.Queue" = queue.Queue()
    instream = open(args.infile) if args.infile else sys.stdin
    out = open(args.outfile, "w") if args.outfile else sys.stdout
    reader = threading.Thread(target=_reader, args=(instream, q), daemon=True)
    reader.start()

    def emit(obj: dict):
        out.write(json.dumps(obj) + "\n")
        out.flush()

    try:
        stats = serve_loop(
            params, cfg, tokenizer, q, emit,
            fps=args.fps, mm_splits=args.mm_splits,
            max_new_tokens=args.max_new_tokens,
            batch_queries=args.batch_queries, batch_videos=args.batch_videos,
            media_cache=args.media_cache,
            quantize_kv=args.quantize_kv, stream_chunk=args.stream_chunk,
            spec_ngram=args.spec_ngram, draft=draft, spec_k=args.spec_k,
            linger_s=args.linger, decode_ahead=args.decode_ahead,
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            seed=args.seed, chunked_prefill_tokens=args.chunked_prefill_tokens)
    finally:
        if args.outfile:
            out.close()
        if args.infile:
            instream.close()
    print(f"serve: {json.dumps(stats)}", file=sys.stderr)
    return stats


if __name__ == "__main__":
    main()
