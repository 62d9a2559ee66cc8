"""Batch benchmark-prediction runner: GT json + video dir -> results file
(port of vidi_tpu/infer/run_benchmark.py).

Writes prediction files in the formats the evaluation harnesses
(`vidi_tpu_torch.evals`) read:

- TR / TR-V2: a json list of {"query_id", "video_id", "duration", "query",
  "answer": [[t0_s, t1_s], ...], "task"}; `answer` spans in seconds (the
  model emits duration-normalized fractions, scaled here).
- STG: tubes.csv rows `query_id,time_ms,x0,y0,x1,y1` with 0-1 boxes. The
  model's STG text is `t0-t1: x0,y0,x1,y1; ...` with normalized times and
  boxes (`parse_stg_tubes`).
- VQA (VUE-PLOT Reasoning): the GT MCQ records + "pred_answer".
- Character (VUE-PLOT Character Grounding): {query_id, video_id, character,
  gt, pred, duration}.

Queries group by video (one encode and one stream prefill a video, the
same-video queries batched into one generate call on the shared caches).
The next video decodes on a host thread while the card works on the current
one (`train/prefetch.Prefetcher`); `--stream-chunk` overlaps decode within
each video instead.

    python -m vidi_tpu_torch.infer.run_benchmark --task tr \\
        --gt VUE-TRv2_ground_truth.json --video-dir vids/ \\
        --out results_mine.json [--limit N] [--model-path DIR | \\
        --random-weights 9b|1.5b|7b|tiny|tiny7b] [--device cuda|cpu] [--dtype ...]

On N ranks (`torchrun --nproc_per_node N -m vidi_tpu_torch.infer.run_benchmark
... --data-parallel D --seq-parallel S --model-parallel M`, N = D * S * M):
each data rank takes its rows of every same-video query batch (padded to
a multiple of D), each data group prefills the video's shared caches cut
over seq, the text decoder runs cut over model; rank 0 gathers the rows
and alone prints and writes the predictions.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import re
import sys
from typing import List, Tuple

import torch

from vidi_tpu_torch.parallel import sharding

STG_SEG_RE = re.compile(
    r"(\d\.\d+)-(\d\.\d+)\s*:\s*"
    r"([\d.]+)\s*,\s*([\d.]+)\s*,\s*([\d.]+)\s*,\s*([\d.]+)")


def parse_stg_tubes(text: str, duration_s: float,
                    step_ms: int = 1000) -> List[Tuple[int, Tuple[float, float, float, float]]]:
    """Model STG text -> [(time_ms, (x0, y0, x1, y1)), ...], one row a
    quantization step inside each segment. Coordinates are divided by 1000
    when any is > 1 (the 0-1000 convention)."""
    rows = []
    for m in STG_SEG_RE.finditer(text):
        t0, t1 = float(m.group(1)) * duration_s, float(m.group(2)) * duration_s
        box = [float(m.group(i)) for i in range(3, 7)]
        if any(c > 1 for c in box):
            box = [c / 1000.0 for c in box]
        t_ms = int(t0 * 1000)
        end_ms = int(t1 * 1000)
        while t_ms <= end_ms:
            rows.append((t_ms, tuple(box)))
            t_ms += step_ms
    return rows


def schedule_videos(ask_batch, gts, args):
    """Announce the ordered unique video paths of a sweep, so the runner can
    decode video i+1 on a host thread while the card works on video i."""
    vids = []
    for g in gts:
        p = os.path.join(args.video_dir, g["video_id"] + args.video_ext)
        if not vids or vids[-1] != p:
            vids.append(p)
    set_schedule = getattr(ask_batch, "set_schedule", None)
    if set_schedule is not None:
        set_schedule(vids)


def group_by_video(gts):
    """Stable-sort records so same-video queries are adjacent (one encode a
    video). The evals join predictions to GT by query_id, so output order
    is free."""
    return sorted(gts, key=lambda g: g["video_id"])


def video_batches(gts, batch_size):
    """Yield lists of same-video records, at most `batch_size` long: the
    unit that runs as one generate call."""
    batch = []
    for g in gts:
        if batch and (g["video_id"] != batch[0]["video_id"]
                      or len(batch) >= batch_size):
            yield batch
            batch = []
        batch.append(g)
    if batch:
        yield batch


def ask_group(ask_batch, group, vid):
    """Run one same-video batch; on failure retry each query alone, so one
    bad query costs one prediction, not the group's. Returns (video
    length, [text a query]). Under a mesh of several ranks a failure is
    raised: a rank that retried alone would leave its peers' collectives
    waiting, and a fault of the mesh path would hide behind the retries."""
    try:
        return ask_batch([g["query"] for g in group], vid,
                         options=[g.get("_options") for g in group])
    except Exception as e:  # noqa: BLE001 -- keep the sweep going
        mesh = sharding.get_mesh()
        if mesh is not None and mesh.size > 1:
            raise
        print(f"batch {group[0]['video_id']} x{len(group)}: {e!r}; "
              "retrying queries individually")
    length, texts = 0.0, []
    for g in group:
        try:
            length, (text,) = ask_batch([g["query"]], vid,
                                        options=[g.get("_options")])
        except Exception as e:  # noqa: BLE001
            print(f"{g['query_id']}: {e!r}")
            text = ""
        texts.append(text)
    return length, texts


def _out_path(args) -> str:
    """Where this rank writes the predictions: `args.out` on rank 0, the
    null device on the others (every rank computes them all)."""
    return args.out if sharding.is_root() else os.devnull


def _load_gts(args):
    with open(args.gt) as f:
        gts = json.load(f)
    return gts[: args.limit] if args.limit else gts


def run_tr(args, ask_batch, parse_spans):
    gts = group_by_video(_load_gts(args))
    schedule_videos(ask_batch, gts, args)
    out = []
    for group in video_batches(gts, args.batch_queries):
        vid = os.path.join(args.video_dir, group[0]["video_id"] + args.video_ext)
        length, texts = ask_group(ask_batch, group, vid)
        for g, text in zip(group, texts):
            spans = parse_spans(text, length)
            out.append({
                "query_id": g["query_id"],
                "video_id": g["video_id"],
                "duration": g.get("duration"),
                "query": g["query"],
                "answer": spans,
                "task": g.get("task", "temporal_retrieval"),
            })
            print(f"[{len(out)}/{len(gts)}] {g['query_id']} -> {spans}")
    with open(_out_path(args), "w") as f:
        json.dump(out, f)
    print(f"wrote {args.out} ({len(out)} predictions)")


_OPT_LETTER_RE = re.compile(r"^[A-Z]\.\s*")


def run_vqa(args, ask_batch):
    """VUE-PLOT Reasoning VQA: MCQ records (problem_id / video_id / problem
    / options / answer / task_type) -> the same records + "pred_answer",
    the input of `vidi_tpu_torch.evals.vue_plot vqa`."""
    from vidi_tpu_torch.infer.tasks import parse_mcq

    gts = _load_gts(args)
    for g in gts:
        g.setdefault("query_id", g.get("problem_id"))
        g["query"] = g["problem"]
        # the GT options carry their "A. " letters; the mcq prompt re-letters
        g["_options"] = [_OPT_LETTER_RE.sub("", o) for o in g["options"]]
    gts = group_by_video(gts)
    schedule_videos(ask_batch, gts, args)
    out = []
    for group in video_batches(gts, args.batch_queries):
        vid = os.path.join(args.video_dir, group[0]["video_id"] + args.video_ext)
        _, texts = ask_group(ask_batch, group, vid)
        for g, text in zip(group, texts):
            rec = {k: v for k, v in g.items() if k not in ("_options", "query")}
            rec["pred_answer"] = parse_mcq(text)
            out.append(rec)
            print(f"[{len(out)}/{len(gts)}] {g['query_id']} -> "
                  f"{rec['pred_answer']!r}")
    with open(_out_path(args), "w") as f:
        json.dump(out, f)
    print(f"wrote {args.out} ({len(out)} predictions)")


def run_character(args, ask_batch):
    """VUE-PLOT Character Grounding: GT records {query_id, video_id,
    character, gt: [segments], duration?} -> {query_id, video_id,
    character, gt, pred, duration}, the input of
    `vidi_tpu_torch.evals.vue_plot character`."""
    from vidi_tpu_torch.infer.tasks import parse_character

    gts = _load_gts(args)
    for g in gts:
        g["query"] = g.get("character", g.get("query", ""))
    gts = group_by_video(gts)
    schedule_videos(ask_batch, gts, args)
    out = []
    for group in video_batches(gts, args.batch_queries):
        vid = os.path.join(args.video_dir, group[0]["video_id"] + args.video_ext)
        length, texts = ask_group(ask_batch, group, vid)
        for g, text in zip(group, texts):
            duration = g.get("duration") or length
            segs = parse_character(text, duration)
            out.append({"query_id": g["query_id"],
                        "video_id": g["video_id"],
                        "character": g["query"],
                        "gt": g.get("gt", []),
                        "pred": segs,
                        "duration": duration})
            print(f"[{len(out)}/{len(gts)}] {g['query_id']}: "
                  f"{len(segs)} segments")
    with open(_out_path(args), "w") as f:
        json.dump(out, f)
    print(f"wrote {args.out} ({len(out)} predictions)")


def run_stg(args, ask_batch):
    """STG: one tubes.csv over all queries."""
    gts = group_by_video(_load_gts(args))
    schedule_videos(ask_batch, gts, args)
    done = 0
    with open(_out_path(args), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["query_id", "time_ms", "x0", "y0", "x1", "y1"])
        for group in video_batches(gts, args.batch_queries):
            vid = os.path.join(args.video_dir, group[0]["video_id"] + args.video_ext)
            duration, texts = ask_group(ask_batch, group, vid)
            for g, text in zip(group, texts):
                rows = parse_stg_tubes(text, duration)
                for t_ms, box in rows:
                    w.writerow([g["query_id"], t_ms, *box])
                done += 1
                print(f"[{done}/{len(gts)}] {g['query_id']}: {len(rows)} rows")
    print(f"wrote {args.out}")


def make_ask_batch(params, cfg, tokenizer, args, draft=(None, None)):
    """-> ask_batch(queries, vid_path, options=None) for `args` (main's
    namespace), with `ask_batch.set_schedule` for decode-ahead. The video
    of the last call is kept encoded and stream-prefilled (one video at a
    time). `draft`: (draft_params, draft_cfg) of a small text-only model
    for speculative decoding, or (None, None)."""
    from vidi_tpu_torch.infer import pipeline
    from vidi_tpu_torch.infer.generate import generate, speculative_generate
    from vidi_tpu_torch.media.video import get_media_length
    from vidi_tpu_torch.models import dattn

    dev = params["text"]["embed"].device
    use_flash = dev.type == "cuda"
    media_memo = {}  # the last video only: {path: (length, im, am, media_caches)}
    decode_ahead = {"it": None}

    def set_schedule(vids):
        # --stream-chunk already overlaps decode with encode inside each
        # video; the decode-ahead thread covers the whole-video path
        if args.stream_chunk or len(vids) < 2:
            return
        from vidi_tpu_torch.train.prefetch import Prefetcher

        def host_decode_all():
            for v in vids:
                try:
                    yield v, pipeline.decode_media_host(v, cfg, fps=args.fps)
                except Exception as e:  # noqa: BLE001 -- surfaced per video
                    yield v, e

        decode_ahead["it"] = iter(Prefetcher(host_decode_all(), depth=1))

    def encode_once(vid_path: str):
        prev = media_memo.get(vid_path)
        if isinstance(prev, Exception):
            raise prev  # a failed decode: do not pull from the schedule again
        if vid_path not in media_memo:
            media_memo.clear()  # hold one video's encoding at a time
            if args.stream_chunk:
                enc = pipeline.encode_media(
                    params, cfg, vid_path, fps=args.fps, mm_chunks=args.mm_splits,
                    use_flash=use_flash, stream_chunk=args.stream_chunk)
            else:
                host = None
                if decode_ahead["it"] is not None:
                    v, payload = next(decode_ahead["it"])
                    if v != vid_path:
                        raise RuntimeError(
                            f"decode schedule out of order: {v} != {vid_path}")
                    if isinstance(payload, Exception):
                        media_memo[vid_path] = payload
                        raise payload
                    host = payload
                if host is None:
                    host = pipeline.decode_media_host(vid_path, cfg, fps=args.fps)
                enc = pipeline.encode_media_arrays(
                    params, cfg, *host, mm_chunks=args.mm_splits, use_flash=use_flash)
            # one batch-1 stream prefill a video: every query on it shares
            # the caches
            img, im, aud, am = enc
            media = dattn.media_prefill(
                params, cfg, img=img, img_mask=im, aud=aud, aud_mask=am,
                mm_chunks=args.mm_splits, use_flash=use_flash,
                quantize_caches=args.quantize_kv)
            media_memo[vid_path] = (get_media_length(vid_path), im, am, media)
        return media_memo[vid_path]

    prompt_task = "mcq" if args.task == "vqa" else args.task

    def ask_batch(queries: List[str], vid_path: str, options=None):
        """Q same-video queries through one generate call on the video's
        shared caches -> (video length, [text a query])."""
        length, im, am, media = encode_once(vid_path)
        q = len(queries)
        ids_list = [pipeline.build_prompt_ids(qy, tokenizer, cfg.mm_version, length,
                                              task=prompt_task,
                                              options=(options or [None] * q)[i])
                    for i, qy in enumerate(queries)]
        prompt, mask = pipeline.build_prompt_batch(ids_list)
        prompt, mask = _data_rows(torch.as_tensor(prompt).long().to(dev),
                                  torch.as_tensor(mask).to(dev))
        kw = dict(img_mask=im, aud_mask=am, media_caches=media,
                  max_new_tokens=args.max_new_tokens,
                  eos_id=pipeline.pick_eos(cfg, tokenizer), use_flash=use_flash,
                  mm_chunks=args.mm_splits)
        if args.spec_ngram or draft[0] is not None:
            res = speculative_generate(params, cfg, draft[0], draft[1], prompt, mask,
                                       spec_k=args.spec_k, **kw)
            drafted = max(int(res.n_drafted.sum()), 1)
            print(f"  spec: {int(res.n_target_steps)} target passes, accept "
                  f"{int(res.n_accepted.sum())}/{drafted}")
        else:
            res = generate(params, cfg, prompt, mask, **kw)
        toks = _gather_rows(res.tokens)[:q].cpu().numpy()
        lens = _gather_rows(res.lengths)[:q].cpu().numpy()
        texts = [tokenizer.decode(toks[r, : lens[r]], skip_special_tokens=True).strip()
                 for r in range(q)]
        return length, texts

    ask_batch.set_schedule = set_schedule
    ask_batch.mm_version = cfg.mm_version
    return ask_batch


def _data_rows(prompt, mask):
    """This data rank's rows of a query batch (prompt, mask [Q,T]), the
    batch padded to a multiple of the data axis with copies of its last
    row; the whole batch without a data axis."""
    mesh = sharding.get_mesh()
    if mesh is None or mesh.shape["data"] == 1:
        return prompt, mask
    pad = -prompt.shape[0] % mesh.shape["data"]
    if pad:
        prompt = torch.cat([prompt, prompt[-1:].expand(pad, -1)])
        mask = torch.cat([mask, mask[-1:].expand(pad, -1)])
    rows = sharding.data_rows({"prompt": prompt, "mask": mask}, prompt.shape[0])
    return rows["prompt"], rows["mask"]


def _gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The data ranks' rows of x, all-gathered in rank order (x without a
    data axis)."""
    mesh = sharding.get_mesh()
    if mesh is None or mesh.shape["data"] == 1:
        return x
    return sharding.all_gather_dim(x, 0, mesh.group(("data",)), mesh.shape["data"])


def run_task(args, ask_batch):
    """Run `args.task` over `args.gt` with `ask_batch`, writing `args.out`.
    TR answers are parsed by `ask_batch.mm_version` (the model's prompt
    generation; v1.5 when the callable does not say)."""
    from vidi_tpu_torch.infer import pipeline

    mm_version = getattr(ask_batch, "mm_version", "v1.5")

    def parse_spans(text: str, length: float) -> List[List[float]]:
        return [[r0 * length, r1 * length]
                for r0, r1 in pipeline.parse_time_ranges(text, mm_version)]

    if args.task == "tr":
        run_tr(args, ask_batch, parse_spans)
    elif args.task == "vqa":
        run_vqa(args, ask_batch)
    elif args.task == "character":
        run_character(args, ask_batch)
    else:
        run_stg(args, ask_batch)


def build_parser() -> argparse.ArgumentParser:
    from vidi_tpu_torch.infer.loader import CONFIGS

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--task", choices=["tr", "stg", "vqa", "character"], default="tr")
    ap.add_argument("--gt", required=True)
    ap.add_argument("--video-dir", required=True)
    ap.add_argument("--video-ext", default=".mp4")
    ap.add_argument("--out", required=True)
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--random-weights", choices=sorted(CONFIGS), default=None,
                    help="random weights at this configuration's widths")
    ap.add_argument("--random-weights-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--fps", type=float, default=1.0)
    ap.add_argument("--mm-splits", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=1024)
    ap.add_argument("--load-8bit", action="store_true")
    ap.add_argument("--load-4bit", action="store_true",
                    help="group-wise int4 weight-only decoder")
    ap.add_argument("--load-8bit-towers", action="store_true",
                    help="int8 encoder towers with per-row int8 activations")
    ap.add_argument("--quantize-kv", action="store_true")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16",
                    help="model compute dtype (float32 for CPU runs)")
    ap.add_argument("--w8a8-prefill", type=int, default=None, metavar="MIN_TOKENS")
    ap.add_argument("--batch-queries", type=int, default=4,
                    help="max same-video queries a generate call (the batch-1 "
                         "media caches are shared across the rows)")
    ap.add_argument("--stream-chunk", type=int, default=0, metavar="FRAMES",
                    help="overlap host decode with the encode in FRAMES-frame "
                         "chunks (0: decode each video fully first)")
    ap.add_argument("--seq-parallel", type=int, default=1, metavar="N",
                    help="ranks (torchrun) over which the modality streams and "
                         "their KV caches are cut")
    ap.add_argument("--model-parallel", type=int, default=1, metavar="N",
                    help="ranks (torchrun) over which the text decoder's heads and "
                         "FFN columns are cut (tensor parallelism)")
    ap.add_argument("--data-parallel", type=int, default=1, metavar="N",
                    help="ranks (torchrun) over which a same-video query batch's "
                         "rows are spread")
    ap.add_argument("--spec-ngram", action="store_true",
                    help="model-free speculative decoding (output equals greedy)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative window with --spec-ngram / --draft-model-path")
    ap.add_argument("--draft-model-path", default=None,
                    help="small text-only draft checkpoint for model-draft "
                         "speculative decoding; overrides --spec-ngram")
    return ap


def main(argv=None):
    import contextlib

    from vidi_tpu_torch.infer import quantize
    from vidi_tpu_torch.infer.loader import load_model
    from vidi_tpu_torch.infer.pipeline import mesh_from_flags

    args = build_parser().parse_args(argv)
    if args.w8a8_prefill is not None:
        quantize.w8a8_min_tokens = args.w8a8_prefill
    dtype = getattr(torch, args.dtype)
    with mesh_from_flags(args.device, args.data_parallel, args.seq_parallel,
                         args.model_parallel) as (dev, mesh):
        params, cfg, tokenizer = load_model(
            args.model_path, args.random_weights, dtype=dtype, device=dev,
            seed=args.random_weights_seed, load_8bit=args.load_8bit,
            load_8bit_towers=args.load_8bit_towers, load_4bit=args.load_4bit, mesh=mesh)
        draft = (None, None)
        if args.draft_model_path:
            d_params, d_cfg, _ = load_model(args.draft_model_path, dtype=dtype,
                                            device=dev, mesh=mesh)
            draft = (d_params, d_cfg)
        # rank 0 alone prints (and writes, `_out_path`)
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(
                sys.stdout if sharding.is_root() else null):
            run_task(args, make_ask_batch(params, cfg, tokenizer, args, draft))


if __name__ == "__main__":
    main()
