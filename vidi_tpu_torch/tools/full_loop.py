"""Full capability loop in one command: train -> export -> serve -> score
(port of scripts/full_loop_smoke.py).

The arc the reference demonstrates with its finetune smoke recipe
(reference: Vidi1.5_9B/README.md:20-28 + example.json: 48 copies of one
conversation over the bundled dummy.mp4): make the fixture, write a start
checkpoint of random weights, finetune it until it memorizes the
fixture's TR answer ("0.000-1.000"), export to HF format, reload the
exported checkpoint through the benchmark runner, and score the
predictions with the VUE-TR evaluator: data -> the train and serve CLIs
-> eval, with learning in the loop.

    python -m vidi_tpu_torch.tools.full_loop [--work-dir DIR] [--steps 300]
        [--start 1.5b|tiny|...] [--device cuda|cpu] [--learning-rate 1e-3]
        [--plain]

The start is `loader.CONFIGS[start]` with random weights from seed
SEED, saved with `save_pretrained` and handed to the train CLI as
`--model_path`; where the init's logits reach past the final softcap
(the 1.5b, the 9B) its tied embedding is scaled first (START_LOGIT_STD).
On CUDA the loop runs bf16 on the attention kernels (`--use_flash` in
training, the runner's own choice in serving), which take every head dim
up to 256: `--start tiny --device cuda` runs the tiny model (head dim 16)
on them; `--plain` trains and reads the margins on the plain route
instead, in the same dtype, to tell the kernels from bf16 rounding. On
the CPU it runs fp32 (`--start tiny --device cpu` is the
reference loop's model, its init unscaled). Both CLIs run in this
process through their `main(argv)`; prints the IoU and the answer
tokens' least top-2 margin (`answer_margins`), and exits 0 when the
overall IoU exceeds 0.5.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import tempfile

import torch

LEARNING_RATE = 1e-3
SEED = 0  # the start's random weights
QUERY = "a moving gradient"
# The random init draws the tied embedding at unit variance, which the tiny
# model's 64 dims turn into raw logits of standard deviation 8. At the
# 1.5b's 1,536 dims they reach 39, past the final softcap of 30: about 1,700
# of its 32,768 tokens then sit where tanh is flat, no gradient reaches
# them, and the port's loss stopped near log(1700) = 7.44 at every learning
# rate tried (H100 runs of this loop). Scaled to the tiny model's 8 the
# 1.5b still stalled (the embedding outweighs the layers in the residual
# stream: each position predicts its own token); at 1 it learns the span.
# The start scales the tied embedding to that where the init's logits
# reach past the final softcap, and leaves the tiny model's init as it is.
START_LOGIT_STD = 1.0


def paths(work_dir: str) -> dict:
    """Where each stage writes under `work_dir`."""
    j = lambda *p: os.path.join(work_dir, *p)  # noqa: E731
    return {"data": j("example.json"), "video": j("dummy.mp4"), "start": j("start"),
            "run": j("ckpt"), "hf": j("hf_out"), "gt": j("gt.json"),
            "preds": j("preds.json"), "metrics": j("ckpt", "metrics.jsonl")}


def _dtype(device) -> str:
    return "bfloat16" if torch.device(device).type == "cuda" else "float32"


def write_start(work_dir: str, start: str = "1.5b", device="cuda") -> str:
    """Random weights of `loader.CONFIGS[start]` from SEED, in the loop's
    dtype on `device`, a tied embedding scaled to logits of std
    START_LOGIT_STD where the init's (std sqrt(hidden)) reach past the
    final softcap, saved with `save_pretrained` -> the directory."""
    from vidi_tpu_torch.infer.export import save_pretrained
    from vidi_tpu_torch.infer.loader import load_model, resolve_device

    dev = resolve_device(device)
    params, cfg, _ = load_model(random_weights=start, dtype=getattr(torch, _dtype(dev)),
                                device=dev, seed=SEED)
    t = cfg.text
    if t.tie_word_embeddings and t.final_softcap and t.hidden_size**0.5 > t.final_softcap:
        params["text"]["embed"].mul_(START_LOGIT_STD / t.hidden_size**0.5)
    out = save_pretrained(params, cfg, paths(work_dir)["start"])
    del params
    _release(dev)
    return out


def train_argv(work_dir: str, steps: int, device="cuda",
               learning_rate: float = LEARNING_RATE, plain: bool = False) -> list:
    """The train CLI's arguments: the start checkpoint finetuned on the
    fixture (text and adapters trained, towers frozen), exported at the
    end; the kernels on CUDA, as the runner decides (`run_benchmark`),
    unless `plain`."""
    p = paths(work_dir)
    argv = ["--model_path", p["start"], "--data_path", p["data"],
            "--video_folder", work_dir, "--max_steps", str(steps),
            "--learning_rate", str(learning_rate), "--mm_rand_lr", str(learning_rate),
            "--train_llm", "true", "--output_dir", p["run"], "--export_hf", p["hf"],
            "--device", str(device), "--dtype", _dtype(device)]
    if torch.device(device).type == "cuda" and not plain:
        argv.append("--use_flash")
    return argv


def write_gt(work_dir: str) -> str:
    """The reference loop's ground truth: one TR query whose span is the
    whole clip."""
    p = paths(work_dir)
    with open(p["data"]) as f:
        duration = json.load(f)[0]["length"]
    gt = [{"query_id": "q0", "video_id": "dummy", "duration": duration,
           "query": QUERY, "task": "temporal_retrieval",
           "gt": [[0.0, duration]],
           # evaluator breakdown fields (VUE-TRv2_ground_truth.json schema)
           "duration_category": "short", "query_format": "phrase",
           "query_modality": "vision"}]
    with open(p["gt"], "w") as f:
        json.dump(gt, f)
    return p["gt"]


def serve(work_dir: str, model_dir: str, device="cuda", out=None) -> str:
    """The benchmark runner (`run_benchmark.main`) on `model_dir` over the
    loop's ground truth -> the predictions file."""
    from vidi_tpu_torch.infer import run_benchmark

    p = paths(work_dir)
    out = out or p["preds"]
    run_benchmark.main(["--task", "tr", "--gt", p["gt"], "--video-dir", work_dir,
                        "--out", out, "--model-path", model_dir,
                        "--max-new-tokens", "24", "--device", str(device),
                        "--dtype", _dtype(device)])
    _release(torch.device(device))
    return out


def score(work_dir: str, pred_path=None) -> dict:
    from vidi_tpu_torch.evals.vue_tr import evaluate

    p = paths(work_dir)
    return evaluate(pred_path or p["preds"], p["gt"], breakdown=False)


def answer_margins(work_dir: str, device="cuda", plain: bool = False) -> list:
    """The top-2 margin (nats) of each labelled token of the fixture's
    first record under the loop's exported model: log p(label) - log p(the
    likeliest other token), teacher-forced with no position noise. Greedy
    decoding emits the memorized answer only while every margin is
    positive, so the least one says how near a run came to failing. On
    the kernels on CUDA unless `plain`."""
    import torch.nn.functional as F

    from vidi_tpu_torch.constants import IGNORE_INDEX
    from vidi_tpu_torch.infer.loader import load_model
    from vidi_tpu_torch.models import dattn, decoder
    from vidi_tpu_torch.train import data, train_step

    dev = torch.device(device)
    params, cfg, tok = load_model(paths(work_dir)["hf"], dtype=getattr(torch, _dtype(dev)),
                                  device=dev)
    ds = data.VideoConvDataset(paths(work_dir)["data"], work_dir, tok, cfg, fps=1.0)
    batch = data.to_device(data.collate([ds[0]], cfg), dev)
    hw = train_step.make_batch_hw(cfg, int(batch["frame_counts"].sum()))
    flash = dev.type == "cuda" and not plain
    with torch.no_grad():
        img, img_mask = dattn.encode_video_images(
            params, cfg, batch["images"], batch["frame_counts"], hw, mm_chunks=4,
            use_flash=flash)
        aud, aud_mask = dattn.encode_video_audios(
            params, cfg, batch["mels"], batch["audio_sizes"], mm_chunks=4, use_flash=flash)
        mask = batch["text_mask"]
        positions = torch.clamp(torch.cumsum(mask.long(), dim=1) - 1, min=0)
        embeds = decoder.embed_tokens(params["text"], batch["input_ids"].long(), cfg.text)
        h, _ = dattn.forward(params, cfg, embeds, mask, positions, img=img,
                             img_mask=img_mask, aud=aud, aud_mask=aud_mask, mm_chunks=4,
                             remat=False, use_flash=flash)
        logp = torch.log_softmax(decoder.lm_logits(params["text"], h, cfg.text)[0].float(), -1)
    del params, img, aud, h
    _release(dev)
    labels = F.pad(batch["labels"][0].long(), (0, 1), value=IGNORE_INDEX)[1:]
    out = []
    for t in torch.nonzero(labels != IGNORE_INDEX)[:, 0].tolist():
        y = int(labels[t])
        other = logp[t].clone()
        other[y] = -float("inf")
        out.append(float(logp[t, y] - other.max()))
    return out


def _release(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_full_loop(work_dir: str, steps: int = 300, copies: int = 8, seconds: float = 25.0,
                  *, start: str = "1.5b", device="cuda",
                  learning_rate: float = LEARNING_RATE, verbose: bool = True, stage=None,
                  plain: bool = False) -> dict:
    """Run the stages; returns the vue_tr evaluate() dict. `plain`: train
    on the plain route on CUDA (serving stays the runner's). `stage(name)`,
    when given, returns a context manager entered around each stage:
    "fixture", "start", "train" (the train CLI with its export), "serve"
    (the runner: reload and generate) and "score"."""
    from vidi_tpu_torch.infer.loader import resolve_device
    from vidi_tpu_torch.tools.make_example import write_example
    from vidi_tpu_torch.train import train

    stage = stage or (lambda name: contextlib.nullcontext())
    dev = resolve_device(device)
    with contextlib.ExitStack() as quiet:
        if not verbose:
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
        # 1. fixture: dummy.mp4 + example.json (the reference's smoke recipe)
        with stage("fixture"):
            write_example(work_dir, seconds, copies)
            write_gt(work_dir)
        # 2. the start checkpoint, finetuned until it memorizes the span
        #    answer, exported in HF format
        with stage("start"):
            write_start(work_dir, start, dev)
        with stage("train"):
            train.main(train_argv(work_dir, steps, dev, learning_rate, plain))
            _release(dev)  # the trainer's parameters and moments
        # 3. reload the EXPORTED checkpoint and run the benchmark runner
        with stage("serve"):
            pred = serve(work_dir, paths(work_dir)["hf"], dev)
        # 4. score with the VUE-TR evaluator
        with stage("score"):
            scores = score(work_dir, pred)
    if verbose:
        print(json.dumps(scores))
    return scores


def main(argv=None) -> int:
    from vidi_tpu_torch.infer.loader import CONFIGS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir", default=None, help="default: a fresh temp dir")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--copies", type=int, default=8)
    ap.add_argument("--start", choices=sorted(CONFIGS), default="1.5b",
                    help="the configuration of the random start checkpoint")
    ap.add_argument("--device", default="cuda", help="cuda (raises without a card) or cpu")
    ap.add_argument("--learning-rate", type=float, default=LEARNING_RATE)
    ap.add_argument("--plain", action="store_true",
                    help="train and read the margins on the plain route (no kernels)")
    args = ap.parse_args(argv)

    work = args.work_dir or tempfile.mkdtemp(prefix="vidi_full_loop_")
    os.makedirs(work, exist_ok=True)
    scores = run_full_loop(work, steps=args.steps, copies=args.copies, start=args.start,
                           device=args.device, learning_rate=args.learning_rate,
                           plain=args.plain)
    iou = scores["overall"]["iou"]
    ok = iou > 0.5
    margins = answer_margins(work, args.device, args.plain)
    print(f"full loop: IoU {iou:.4f} over {scores['n_query']} queries, least top-2 margin "
          f"of the answer's tokens {min(margins):.2f} nats -> "
          f"{'OK' if ok else 'FAILED (model did not converge to the span)'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
