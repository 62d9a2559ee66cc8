"""Finetune CLI of the port (the flags of vidi_tpu/train/train.py
that the port implements, plus --device and --dtype).

    python -m vidi_tpu_torch.train.train --tiny --data_path synthetic \
        --max_steps 2 --device cpu --output_dir out/
    python -m vidi_tpu_torch.train.train --tiny --data_path example.json \
        --video_folder /data --use_flash --device cuda

Each step writes one metrics.jsonl line with the JAX CLI's keys; the
run saves every --save_steps steps and at the end, and resumes from the
newest readable checkpoint under --output_dir.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch


def _flag(s: str) -> bool:
    return s == "true"


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_path", type=str, default=None,
                   help="a Vidi checkpoint (loading one into the port is not "
                        "implemented yet)")
    p.add_argument("--tiny", action="store_true", help="random tiny model")
    p.add_argument("--data_path", type=str, required=True,
                   help="conversation JSON, or 'synthetic'")
    p.add_argument("--video_folder", type=str, default=".")
    p.add_argument("--output_dir", type=str, default="checkpoint/run")
    p.add_argument("--max_steps", type=int, default=100)
    p.add_argument("--per_device_train_batch_size", type=int, default=1)
    p.add_argument("--use_flash", action="store_true",
                   help="the CUDA attention kernels (K1 forward, K4 backward, "
                        "K2 in the towers)")
    p.add_argument("--remat", choices=["full", "none"], default="full",
                   help="recompute each decoder layer in the backward pass "
                        "(reference gradient checkpointing), or keep everything")
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--mm_rand_lr", type=float, default=2e-5)
    p.add_argument("--mm_vis_lr", type=float, default=None)
    p.add_argument("--mm_aud_lr", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=0.1)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--train_rand", type=_flag, default=True)
    p.add_argument("--train_vis", type=_flag, default=False)
    p.add_argument("--train_aud", type=_flag, default=False)
    p.add_argument("--train_llm", type=_flag, default=True)
    p.add_argument("--loss_thres", type=float, default=0.1)
    p.add_argument("--mm_splits", type=int, default=4)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--save_total_limit", type=int, default=2)
    p.add_argument("--video_fps", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=45678)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' without a card raises")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    return p.parse_args()


def main():
    args = parse_args()
    from vidi_tpu.train.prefetch import Prefetcher
    from vidi_tpu.utils import StepMeter, build_logger
    from vidi_tpu_torch.infer.loader import load_model, resolve_device
    from vidi_tpu_torch.models.dattn import draw_pos_noise
    from vidi_tpu_torch.train import data as data_mod
    from vidi_tpu_torch.train.checkpoint import Checkpointer
    from vidi_tpu_torch.train.optimizer import TrainHParams, lr_schedule, make_optimizer
    from vidi_tpu_torch.train.train_step import make_batch_hw, opt_init, train_step

    if args.model_path is None and not args.tiny:
        raise SystemExit("pass --tiny (random weights) or --model_path")
    dev = resolve_device(args.device)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.dtype]
    params, cfg, tokenizer = load_model(args.model_path, "tiny", dtype=dtype,
                                        device=dev, seed=args.seed)
    cfg = dataclasses.replace(cfg, loss_thres=args.loss_thres)
    hp = TrainHParams(
        learning_rate=args.learning_rate, mm_rand_lr=args.mm_rand_lr,
        mm_vis_lr=args.mm_vis_lr, mm_aud_lr=args.mm_aud_lr,
        weight_decay=args.weight_decay, warmup_ratio=args.warmup_ratio,
        total_steps=args.max_steps, train_rand=args.train_rand,
        train_vis=args.train_vis, train_aud=args.train_aud,
        train_llm=args.train_llm)
    tx = make_optimizer(params, hp)
    frozen = tuple(mod for flag, mod in (
        (args.train_llm, "text"), (args.train_vis, "vision"),
        (args.train_aud, "audio"), (args.train_rand, "mm")) if not flag)
    opt_state = opt_init(tx, params)

    ckpt = Checkpointer(args.output_dir, args.save_total_limit)
    start_step = 0
    if ckpt.latest_step() is not None:  # auto-resume
        start_step, params, opt_state = ckpt.restore(map_location=dev)
        print(f"resumed from step {start_step}")

    synthetic = args.data_path == "synthetic"
    if not synthetic:
        ds = data_mod.VideoConvDataset(args.data_path, args.video_folder, tokenizer,
                                       cfg, fps=args.video_fps)
        order = np.random.default_rng(args.seed).permutation(len(ds))
    bsz = args.per_device_train_batch_size

    def batch_source():
        """Host-side batch prep on the prefetch thread."""
        for step in range(start_step, args.max_steps):
            if synthetic:
                batch = data_mod.synthetic_batch(cfg, b=bsz, seed=step)
            else:
                idx = [int(order[(step * bsz + j) % len(order)]) for j in range(bsz)]
                batch = data_mod.collate([ds[i] for i in idx], cfg)
            # the token budget counts real frames, not the padded bucket
            hw = make_batch_hw(cfg, max(int(batch["frame_counts"].sum()), 1))
            n_tokens = int(batch["text_mask"].sum()) + int(
                batch["frame_counts"].sum()) * (hw[0] // cfg.mm_image_pool_size) ** 2
            yield batch, hw, n_tokens

    meter = StepMeter()
    logger = build_logger("vidi_tpu_torch.train", "train.log",
                          log_dir=os.path.join(args.output_dir, "logs"))
    os.makedirs(args.output_dir, exist_ok=True)
    lr_fn = lr_schedule(hp, hp.learning_rate)
    gen = torch.Generator(device=dev)
    batches = iter(Prefetcher(batch_source(), depth=2))
    with open(os.path.join(args.output_dir, "metrics.jsonl"), "a") as metrics_f:
        for step in range(start_step, args.max_steps):
            meter.start()
            batch, hw, n_tokens = next(batches)
            batch = data_mod.to_device(batch, dev)
            gen.manual_seed(args.seed + step)  # the same noise on a resumed run
            b, n = batch["images"].shape[:2]
            noise = draw_pos_noise(cfg, b, n, batch["mels"].shape[1], hw, gen)
            params, opt_state, loss = train_step(
                params, opt_state, batch, noise, cfg=cfg, tx=tx, hw=hw,
                mm_chunks=args.mm_splits, remat=args.remat == "full",
                use_flash=args.use_flash, frozen=frozen)
            loss = float(loss)
            dt = meter.stop(n_tokens)
            logger.info(f"step {step}  loss {loss:.4f}  {dt:.2f}s  "
                        f"[{meter.summary()}]  (device={dev})")
            metrics_f.write(json.dumps({
                "step": step, "loss": loss, "step_time_s": round(dt, 4),
                "tokens_per_sec": round(meter.tokens_per_sec, 1),
                "learning_rate": lr_fn(step)}) + "\n")
            metrics_f.flush()
            if (step + 1) % args.save_steps == 0 or step + 1 == args.max_steps:
                ckpt.save(step + 1, params, opt_state)
    ckpt.close()
    print("training done")


if __name__ == "__main__":
    main()
