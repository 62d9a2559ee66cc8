"""Finetune CLI of the port: the 46 flags of vidi_tpu/train/train.py, plus
--device and --dtype.

    python -m vidi_tpu_torch.train.train --tiny --data_path synthetic \
        --max_steps 2 --device cpu --output_dir out/
    python -m vidi_tpu_torch.train.train --tiny --data_path example.json \
        --video_folder /data --use_flash --device cuda
    python -m vidi_tpu_torch.train.train --model_path gemma2/ \
        --mm_vision_tower siglip/ --mm_audio_tower whisper/ --mm_std 0.029 \
        --data_path synthetic --export_hf out/hf
    python -m vidi_tpu_torch.train.train --tiny --mm_input_type image \
        --mm_image_aspect_ratio anyres --dataset_type image-conv \
        --data_path synthetic --gradient_accumulation_steps 2 --remat dots \
        --profile_dir prof/ --report_to tensorboard --device cpu
    torchrun --standalone --nproc_per_node 8 -m vidi_tpu_torch.train.train \
        --tiny --data_path synthetic --seq_parallel_size 2 --sp_mode ring

Each step writes one metrics.jsonl line with the JAX CLI's keys (the
learning rate of the optimizer step, step // gradient_accumulation_steps);
the run saves every --save_steps steps and at the end, and resumes from
the newest readable checkpoint under --output_dir. --profile_dir writes a
torch.profiler Chrome trace of steps start+2 to start+4.

Under torchrun (RANK / WORLD_SIZE / LOCAL_RANK in the environment) each
process is one rank of a (data, seq, 1) mesh (`core.mesh.make_mesh`: NCCL
for cuda, gloo for cpu; data = ranks / --seq_parallel_size): parameters
and optimizer state are ZeRO-3 slices (`parallel.sharding.shard_params`),
every rank decodes only its data rows of the global batch of
per_device_train_batch_size x data rows (the seq ranks of a data group
the same ones; with --pack each data group packs its own share of the
samples), padded to the global batch's sizes (one all-gather over "data"
a step, which also counts the global batch's frames and tokens); the
modality streams are cut over "seq" and cross-attended as --sp_mode says.
The step is the same function of the global batch as one process's. Rank 0 alone logs, writes metrics,
tensorboard and traces, and saves (the gathered tree; a resume cuts it
again). --seq_parallel_size > 1 needs torchrun; --model_parallel_size > 1
(the backward of tensor parallelism) is ROADMAP Q1.16c.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import types
from typing import Dict, Tuple

import numpy as np
import torch


def _flag(s: str) -> bool:
    return s == "true"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_path", type=str, default=None,
                   help="a full Vidi checkpoint, or (with --mm_vision_tower) a "
                        "plain Gemma2 / Mistral HF checkpoint to assemble from")
    p.add_argument("--tiny", action="store_true", help="random tiny model")
    # assembly from a base LLM + tower checkpoints (mm_rand_* adapters drawn fresh)
    p.add_argument("--mm_vision_tower", type=str, default=None,
                   help="vision tower checkpoint dir (e.g. siglip2-so400m-patch14-384); "
                        "triggers assembly")
    p.add_argument("--mm_audio_tower", type=str, default=None,
                   help="audio tower checkpoint dir (whisper-large-v3)")
    p.add_argument("--mm_std", type=float, default=None,
                   help="init scale of mm_rand_llm_norm")
    p.add_argument("--mm_image_pool_size", type=int, default=None)
    p.add_argument("--mm_audio_pool_size", type=int, default=None)
    p.add_argument("--mm_time_interval", type=int, default=None)
    p.add_argument("--mm_input_type", choices=["video", "image"], default=None)
    p.add_argument("--mm_image_aspect_ratio",
                   choices=["pad", "resize", "anyres", "crop"], default=None)
    p.add_argument("--model_max_length", type=int, default=None)
    p.add_argument("--data_path", type=str, required=True,
                   help="conversation JSON, or 'synthetic'")
    p.add_argument("--dataset_type", choices=["video-conv", "image-conv"],
                   default="video-conv")
    p.add_argument("--video_folder", type=str, default=".")
    p.add_argument("--image_folder", type=str, default=None,
                   help="image root for --dataset_type image-conv")
    p.add_argument("--output_dir", type=str, default="checkpoint/run")
    p.add_argument("--max_steps", type=int, default=100)
    p.add_argument("--per_device_train_batch_size", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1,
                   help="micro-steps per optimizer step (fp32 gradient means)")
    p.add_argument("--group_by_length", action="store_true",
                   help="modality-aware length-grouped batch order")
    p.add_argument("--pack", action="store_true",
                   help="pack text-only conversations into dense rows with "
                        "segment-id block-diagonal attention")
    p.add_argument("--pack_seq_len", type=int, default=None,
                   help="packed row length (default model_max_length)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of steps start+2 to "
                        "start+4 here")
    p.add_argument("--use_flash", action="store_true",
                   help="the CUDA attention kernels (K1 forward, K4 backward, "
                        "K2 in the towers)")
    p.add_argument("--remat", choices=["full", "dots", "none"], default="full",
                   help="per decoder layer in the backward pass: recompute "
                        "everything (reference gradient checkpointing), keep the "
                        "weight products and recompute the rest, or keep everything")
    p.add_argument("--sp_mode", choices=["gspmd", "ring", "ulysses"], default="gspmd",
                   help="the modality cross attention's plan when "
                        "--seq_parallel_size > 1 (parallel/)")
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
    p.add_argument("--seq_parallel_size", type=int, default=1)
    p.add_argument("--model_parallel_size", type=int, default=1)
    p.add_argument("--report_to", choices=["none", "tensorboard"], default="none",
                   help="metric sink beyond metrics.jsonl; tensorboard events land "
                        "in <output_dir>/runs")
    p.add_argument("--export_hf", type=str, default=None, metavar="DIR",
                   help="after training, also write HF-format safetensors + "
                        "config.json to DIR (loadable with --model-path)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' without a card raises")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    return p


def _step_profiler(out_dir, start_step: int, device: torch.device):
    """torch.profiler over steps start+2 to start+4 (the JAX CLI's trace
    window; step start+1 warms it up), written as a Chrome trace into
    `out_dir` when the window closes or the run ends; `.step()` after each
    step. A no-op without `out_dir`."""
    if not out_dir:
        return contextlib.nullcontext(types.SimpleNamespace(step=lambda: None))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(out_dir, f"trace_steps_{start_step + 2}-{start_step + 4}.json")

    def write(prof):
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(path)
        print(f"profile trace written to {path}")

    return torch.profiler.profile(
        activities=acts, on_trace_ready=write,
        schedule=torch.profiler.schedule(wait=1, warmup=1, active=3, repeat=1))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.model_parallel_size > 1:
        raise NotImplementedError(
            "--model_parallel_size > 1: training under tensor parallelism on the "
            "'model' axis is ROADMAP Q1.16c")
    import torch.distributed as dist
    from vidi_tpu_torch.core.mesh import init_from_env, make_mesh
    from vidi_tpu_torch.infer.loader import resolve_device
    from vidi_tpu_torch.parallel import sharding

    dev = resolve_device(args.device)
    launched = init_from_env(dev.type)
    if launched is None and args.seq_parallel_size > 1:
        raise SystemExit("--seq_parallel_size > 1 needs ranks: launch with torchrun "
                         "--nproc_per_node N")
    dev = launched or dev
    mesh = make_mesh(seq=args.seq_parallel_size, model=1, device_type=dev.type)
    sharding.set_mesh(mesh)
    try:
        _run(args, dev, mesh)
    finally:
        sharding.set_mesh(None)
    # reached only when this rank's run ended well: a failing rank exits at
    # once, unblocked by its peers, and torchrun tears the job down
    if launched is not None:
        # no rank tears its groups down while another still uses them (rank
        # 0 writing the last checkpoint): without the barrier a gloo rank
        # could abort at exit
        dist.barrier()
        dist.destroy_process_group()


def _global_batch(batch: Dict, cfg, mesh, dev) -> Tuple[Dict, Tuple[int, int], int]:
    """This rank's rows of a global batch, padded along dim 1 to the global
    batch's sizes (the largest over the data ranks: the bucket of a global
    collate), with the global batch's `hw` token budget and token count.
    One all-gather over "data" when it has several ranks."""
    from vidi_tpu_torch.constants import IGNORE_INDEX
    from vidi_tpu_torch.models.dattn import frame_side
    from vidi_tpu_torch.parallel import sharding
    from vidi_tpu_torch.train.train_step import make_batch_hw

    padded = sorted(k for k, x in batch.items() if x.ndim >= 2)
    video = "frame_counts" in batch
    if video:
        real = int(batch["frame_counts"].sum())
    else:  # the images that carry the modality
        real = int((np.abs(batch["images"]).reshape(len(batch["images"]), -1)
                    .sum(axis=1) > 0).sum())
    local = [batch[k].shape[1] for k in padded] + [real, int(batch["text_mask"].sum())]
    group, n = mesh.group(("data",)), mesh.shape["data"]
    if group is None:
        sizes, (real, text) = local[:-2], local[-2:]
    else:
        got = sharding.all_gather_dim(torch.tensor([local], dtype=torch.int64, device=dev),
                                      0, group, n).cpu()
        sizes = got[:, :-2].max(dim=0).values.tolist()
        real, text = got[:, -2:].sum(dim=0).tolist()
        for k, size in zip(padded, sizes):
            x = batch[k]
            if x.shape[1] < size:
                pad = np.full((x.shape[0], size - x.shape[1], *x.shape[2:]),
                              IGNORE_INDEX if k == "labels" else 0, x.dtype)
                batch[k] = np.concatenate([x, pad], axis=1)
    if video:
        # the token budget counts real frames, not the padded bucket; a
        # frame's tokens follow the adapter's rule (`frame_side`: the JAX
        # CLI's hw // pool undercounts v1's fixed 8 x 8 side)
        hw = make_batch_hw(cfg, max(real, 1))
        h2, w2 = frame_side(cfg, hw)
        return batch, hw, text + real * h2 * w2
    # hw is not read by the image path
    return batch, make_batch_hw(cfg, 1), text + real * cfg.vision.num_patches_per_side ** 2


def _run(args, dev: torch.device, mesh):
    from vidi_tpu_torch.parallel import sharding
    from vidi_tpu_torch.train.prefetch import Prefetcher
    from vidi_tpu_torch.utils import StepMeter, build_logger
    from vidi_tpu_torch.infer.loader import load_model
    from vidi_tpu_torch.models.dattn import draw_image_noise, draw_pos_noise
    from vidi_tpu_torch.train import data as data_mod
    from vidi_tpu_torch.train.checkpoint import Checkpointer
    from vidi_tpu_torch.train.optimizer import TrainHParams, lr_schedule, make_optimizer
    from vidi_tpu_torch.train.tb import TBReporter
    from vidi_tpu_torch.train.train_step import opt_init, train_step

    if args.model_path is None and not args.tiny:
        raise SystemExit("pass --tiny (random weights) or --model_path")
    rank0, sharded = mesh.rank == 0, mesh.size > 1
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.dtype]
    mm_overrides = {k: getattr(args, k) for k in (
        "mm_std", "mm_image_pool_size", "mm_audio_pool_size", "mm_time_interval",
        "mm_input_type", "mm_image_aspect_ratio", "model_max_length")}
    params, cfg, tokenizer = load_model(
        args.model_path, "tiny" if args.tiny else None, dtype=dtype, device=dev,
        seed=args.seed, mm_vision_tower=args.mm_vision_tower,
        mm_audio_tower=args.mm_audio_tower, mm_overrides=mm_overrides)
    cfg = dataclasses.replace(cfg, loss_thres=args.loss_thres)
    image_ds = args.dataset_type == "image-conv"
    if image_ds and cfg.mm_input_type != "image":
        raise ValueError("--dataset_type image-conv needs an image-mode model "
                         "(--mm_input_type image, or an image-type checkpoint); "
                         f"got mm_input_type={cfg.mm_input_type!r}")
    if image_ds and args.pack:
        raise ValueError("--pack is for text / video-conv data")
    if not image_ds and cfg.mm_input_type != "video":
        raise ValueError("video-conv data needs a video-mode model; got "
                         f"mm_input_type={cfg.mm_input_type!r} (pass --dataset_type "
                         "image-conv for image models)")
    ga = args.gradient_accumulation_steps
    if sharded:
        params = sharding.shard_params(params, mesh)
    hp = TrainHParams(
        learning_rate=args.learning_rate, mm_rand_lr=args.mm_rand_lr,
        mm_vis_lr=args.mm_vis_lr, mm_aud_lr=args.mm_aud_lr,
        weight_decay=args.weight_decay, warmup_ratio=args.warmup_ratio,
        total_steps=args.max_steps, train_rand=args.train_rand,
        train_vis=args.train_vis, train_aud=args.train_aud,
        train_llm=args.train_llm)
    tx = make_optimizer(params, hp, grad_accum=ga)
    frozen = tuple(mod for flag, mod in (
        (args.train_llm, "text"), (args.train_vis, "vision"),
        (args.train_aud, "audio"), (args.train_rand, "mm")) if not flag)
    opt_state = opt_init(tx, params)

    ckpt = Checkpointer(args.output_dir, args.save_total_limit)
    start_step = 0
    if ckpt.latest_step() is not None:  # auto-resume
        if sharded:  # the whole tree, memory-mapped, cut again for this rank
            start_step, full, full_state = ckpt.restore(map_location="cpu", mmap=True)
            params = sharding.shard_params(full, mesh, device=dev)
            opt_state = sharding.shard_state(full_state, params)
            del full, full_state
        else:
            start_step, params, opt_state = ckpt.restore(map_location=dev)
        if rank0:
            print(f"resumed from step {start_step}")

    synthetic = args.data_path == "synthetic"
    # the global batch; this rank trains on its data rows of it
    n_data, data_rank = mesh.shape["data"], mesh.coord("data")
    bsz = args.per_device_train_batch_size * n_data
    rows = slice(data_rank * args.per_device_train_batch_size,
                 (data_rank + 1) * args.per_device_train_batch_size)
    if not synthetic:
        if image_ds:
            ds = data_mod.ImageConvDataset(args.data_path,
                                           args.image_folder or args.video_folder,
                                           tokenizer, cfg)
        else:
            ds = data_mod.VideoConvDataset(args.data_path, args.video_folder, tokenizer,
                                           cfg, fps=args.video_fps)
        if args.group_by_length:
            from vidi_tpu_torch.train.samplers import length_grouped_epoch_indices
            order = np.asarray(length_grouped_epoch_indices(
                ds.lengths, bsz, world_size=1, grad_accum=ga, sp_size=1, dp_size=1,
                seed=args.seed))
        else:
            order = np.random.default_rng(args.seed).permutation(len(ds))

    def batch_source():
        """Host-side prep of this rank's rows on the prefetch thread: only
        they are decoded."""
        pack_cursor, packer = data_rank, None
        for step in range(start_step, args.max_steps):
            if synthetic:
                batch = (data_mod.synthetic_image_batch(cfg, b=bsz, seed=step) if image_ds
                         else data_mod.synthetic_batch(cfg, b=bsz, seed=step))
                batch = {k: x[rows] for k, x in batch.items()}
            elif args.pack:
                # stream this data group's share of the samples (every
                # n_data-th) into its packer until a batch flushes
                from vidi_tpu_torch.train.packing import PackedBatcher
                if packer is None:
                    packer = PackedBatcher(cfg, args.per_device_train_batch_size,
                                           args.pack_seq_len)
                batch = None
                while batch is None:
                    i = int(order[pack_cursor % len(order)])
                    pack_cursor += n_data
                    batch = packer.add(ds[i])
            else:
                idx = [int(order[(step * bsz + j) % len(order)]) for j in range(bsz)]
                collate = data_mod.collate_images if image_ds else data_mod.collate
                batch = collate([ds[i] for i in idx[rows]], cfg)
            yield batch

    meter = StepMeter()
    os.makedirs(args.output_dir, exist_ok=True)
    if rank0:
        logger = build_logger("vidi_tpu_torch.train", "train.log",
                              log_dir=os.path.join(args.output_dir, "logs"))
    tb = TBReporter(args.output_dir, enabled=rank0 and args.report_to == "tensorboard")
    # every configured parameter group's schedule, at the optimizer step
    lr_fns = {"learning_rate": lr_schedule(hp, hp.learning_rate),
              "learning_rate_mm_rand": lr_schedule(hp, hp.mm_rand_lr or hp.learning_rate)}
    if hp.mm_vis_lr is not None:
        lr_fns["learning_rate_mm_vis"] = lr_schedule(hp, hp.mm_vis_lr)
    if hp.mm_aud_lr is not None:
        lr_fns["learning_rate_mm_aud"] = lr_schedule(hp, hp.mm_aud_lr)
    remat = {"full": True, "dots": "dots", "none": False}[args.remat]
    gen = torch.Generator(device=dev)
    batches = iter(Prefetcher(batch_source(), depth=2))
    metrics_path = os.path.join(args.output_dir, "metrics.jsonl")
    with (open(metrics_path, "a") if rank0 else contextlib.nullcontext()) as metrics_f, \
            _step_profiler(args.profile_dir if rank0 else None, start_step, dev) as prof:
        for step in range(start_step, args.max_steps):
            meter.start()
            batch, hw, n_tokens = _global_batch(next(batches), cfg, mesh, dev)
            batch = data_mod.to_device(batch, dev)
            gen.manual_seed(args.seed + step)  # the same noise on a resumed run
            images = batch["images"]
            # the global batch's draws, of which this rank takes its rows
            if image_ds:
                anyres = images.dim() == 5
                noise = draw_image_noise(cfg, bsz, images.shape[1] if anyres else 1, gen,
                                         per_sample=anyres and "grids" in batch)
            else:
                noise = draw_pos_noise(cfg, bsz, images.shape[1],
                                       batch["mels"].shape[1], hw, gen)
            noise = sharding.data_rows(noise, bsz, min_ndim=2)
            params, opt_state, loss = train_step(
                params, opt_state, batch, noise, cfg=cfg, tx=tx, hw=hw,
                mm_chunks=args.mm_splits, remat=remat, use_flash=args.use_flash,
                frozen=frozen, sp_mode=args.sp_mode)
            loss = float(loss)
            dt = meter.stop(n_tokens)
            if (step + 1) % args.save_steps == 0 or step + 1 == args.max_steps:
                ckpt.save(step + 1, params, opt_state)  # collective under a mesh
            if not rank0:
                continue
            logger.info(f"step {step}  loss {loss:.4f}  {dt:.2f}s  "
                        f"[{meter.summary()}]  (device={dev}, ranks={mesh.size})")
            # the schedules advance once per optimizer step
            lrs = {k: fn(step // ga) for k, fn in lr_fns.items()}
            metrics_f.write(json.dumps({
                "step": step, "loss": loss, "step_time_s": round(dt, 4),
                "tokens_per_sec": round(meter.tokens_per_sec, 1),
                "learning_rate": lrs["learning_rate"]}) + "\n")
            metrics_f.flush()
            tb.report({"loss": loss, **lrs, "step_time_s": dt,
                       "tokens_per_sec": meter.tokens_per_sec}, step)
            prof.step()
    ckpt.close()
    tb.close()
    if args.export_hf:
        from vidi_tpu_torch.infer.export import save_pretrained
        if sharded:
            params = sharding.full_tree(params)  # collective
        if rank0:
            save_pretrained(params, cfg, args.export_hf, tokenizer_src=args.model_path)
            print(f"exported HF checkpoint to {args.export_hf}")
    if rank0:
        print("training done")


if __name__ == "__main__":
    main()
