"""Two ranks of the port's serving path on one card, over gloo.

    python3 vidi_tpu_torch/tools/ranks_one_card.py [MODE ...] [--layers N]
        [--new N] [--seconds S] [--mm-chunks N] [--device cuda|cpu]
        [--config 9b|tiny]

Run from the root of a checkout. MODE is "seq" (`--seq-parallel 2`) or
"model" (`--model-parallel 2`); default both. NCCL puts no two ranks of a
communicator on one GPU, so the two ranks talk over gloo, which has to
take the path's collectives on CUDA tensors. The parent first runs the
one-process reference: the configuration (default Vidi1.5-9B at full
width, random weights from seed 0, the first N text layers, bf16 on the
card) on chip_smoke.py's synthetic clip (--seconds, default 120) and one
TR query, greedy generate of --new tokens on the kernel routes (K1 / K2 /
K3). Then, for
each mode, two child processes (a gloo group at tcp://localhost, both on
card 0) run the same with `load_model(mesh=)`; the parent holds each
rank's step-0 logits against the reference's (the largest difference over
the largest |logit|, and the cosine) and its tokens (with the reference's
top-2 gap where they first differ), and prints them. A
child that fails prints its error, and the parent prints the last lines
of it and goes on with the next mode.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())
QUERY = "a red car driving past"


def _model(config: str, layers: int, device: str, mesh=None):
    """(params, cfg, tokenizer): random weights from seed 0, cut to the
    first `layers` text layers."""
    import dataclasses

    from vidi_tpu_torch.infer.loader import CONFIGS, load_model

    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    base = CONFIGS[config]()
    cfg = dataclasses.replace(base, text=dataclasses.replace(
        base.text, num_layers=min(layers, base.text.num_layers)))
    overrides = {"text": cfg.text}
    return load_model(random_weights=config, dtype=dtype, device=device, mesh=mesh,
                      mm_overrides=overrides)


def _clip(cfg, seconds: int):
    """chip_smoke.py's synthetic clip at the tower's size: (uint8 frames,
    mel windows, audio length)."""
    import chip_smoke as c
    from vidi_tpu_torch.media.audio import process_audio

    frames, wave = c._synthetic_clip(seconds, cfg.vision.image_size, cfg.audio.sampling_rate)
    mels, audio_len = process_audio(wave, cfg.audio)
    return frames, mels, audio_len


def run(config: str, layers: int, new: int, device: str, mesh=None, seconds: int = 120,
        mm_chunks: int = 32) -> dict:
    """The path once: encode, prefill (step-0 logits), greedy generate."""
    from vidi_tpu_torch.infer import generate as g
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.parallel import sharding

    params, cfg, tok = _model(config, layers, device, mesh)
    flash = device == "cuda"
    with torch.no_grad():
        t0 = time.perf_counter()
        img, im, aud, am = P.encode_media_arrays(params, cfg, *_clip(cfg, seconds),
                                                 mm_chunks=mm_chunks, use_flash=flash)
        prompt, mask = P.build_prompt_batch([P.build_prompt_ids(QUERY, tok, cfg.mm_version,
                                                                float(seconds))])
        dev = params["text"]["embed"].device
        ids, mask = torch.as_tensor(prompt).long().to(dev), torch.as_tensor(mask).to(dev)
        whole = sharding.gathered(params, skip_layers=True)
        h, _, lens = g._prefill(whole, cfg, ids, mask, img, im, aud, am, max_new_tokens=1,
                                mm_chunks=mm_chunks, use_flash=flash)
        logits = g._last_logits(whole, cfg, h, lens).float().cpu()
        del whole, h
        res, gaps = _with_gaps(lambda: g.generate(
            params, cfg, ids, mask, img, im, aud, am, max_new_tokens=new, eos_id=-1,
            mm_chunks=mm_chunks, use_flash=flash, use_flash_decode=flash))
        wall = time.perf_counter() - t0
    return {"logits": logits, "tokens": res.tokens.cpu(), "gaps": gaps, "wall_s": wall}


def _with_gaps(fn):
    """(fn(), each lm_logits call's top-2 gap over its max|logit|): the
    margin of each greedy choice."""
    from vidi_tpu_torch.models import decoder

    real, gaps = decoder.lm_logits, []

    def logged(*a, **kw):
        out = real(*a, **kw).float()
        top = out.topk(2, dim=-1).values
        gaps.append(float((top[..., 0] - top[..., 1]).min() / out.abs().max()))
        return out

    decoder.lm_logits = logged
    try:
        return fn(), gaps
    finally:
        decoder.lm_logits = real


def child(mode: str, port: int, rank: int, out: str, args) -> None:
    """One rank: a gloo group of two on card 0 (or the CPU), the mesh of
    `mode`, the path, its results to `out`."""
    import torch.distributed as dist

    from vidi_tpu_torch.core.mesh import make_mesh
    from vidi_tpu_torch.parallel import sharding

    if args.device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    try:
        mesh = make_mesh(data=1, seq=2 if mode == "seq" else 1,
                         model=2 if mode == "model" else 1, device_type=args.device)
        with sharding.use_mesh(mesh):
            res = run(args.config, args.layers, args.new, args.device, mesh, args.seconds,
                      args.mm_chunks)
        torch.save(res, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _held(label: str, got: dict, want: dict) -> dict:
    """Step-0 logits (largest |difference| over max|logit|, cosine) and the
    tokens' first difference, with the reference's top-2 gap there (over
    its max|logit|)."""
    a, b = got["logits"].flatten(), want["logits"].flatten()
    rel = float((a - b).abs().max() / b.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    same = torch.equal(got["tokens"], want["tokens"])
    diff = (got["tokens"] != want["tokens"]).nonzero()
    first = None if same else int(diff[0, 1])
    gap = None if same else want["gaps"][first]
    print(f"  {label}: step-0 logits rel {rel:.3e}, cosine {cos:.6f}; tokens "
          f"{'equal' if same else f'differ from step {first} (top-2 gap {gap:.4f})'}; "
          f"wall {got['wall_s']:.1f} s")
    return {"rel": rel, "cos": cos, "tokens_equal": same, "first_difference": first,
            "gap_there": gap, "wall_s": got["wall_s"]}


def compare(modes=("seq", "model"), *, layers: int = 4, new: int = 8, device: str = "cuda",
            config: str = "9b", seconds: int = 120, mm_chunks: int = 32) -> dict:
    """The one-process reference, then each mode's two ranks held against
    it -> {mode: [each rank's `_held`] or {"failed": the ranks' last lines}}."""
    want = run(config, layers, new, device, None, seconds, mm_chunks)
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"  one process: wall {want['wall_s']:.1f} s; tokens {want['tokens'].tolist()}; "
          "top-2 gaps over max|logit| " + ", ".join(f"{x:.4f}" for x in want["gaps"]))
    report = {}
    flags = ["--layers", str(layers), "--new", str(new), "--device", device, "--config",
             config, "--seconds", str(seconds), "--mm-chunks", str(mm_chunks)]
    with tempfile.TemporaryDirectory() as tmp:
        for mode in modes:
            port = _free_port()
            outs = [os.path.join(tmp, f"{mode}{r}.pt") for r in range(2)]
            procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *flags,
                                       "--child", mode, str(port), str(r), outs[r]],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
                     for r in range(2)]
            logs = []
            for p in procs:
                try:
                    logs.append(p.communicate(timeout=900)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    logs.append(p.communicate()[0] + "\n(killed after 900 s)")
            if any(p.returncode for p in procs):
                print(f"  {mode}: a rank failed ({[p.returncode for p in procs]}):\n"
                      + "\n".join(x[-3000:] for x in logs))
                report[mode] = {"failed": [x.strip().splitlines()[-1:] for x in logs]}
                continue
            report[mode] = [_held(f"{mode} rank {r}", torch.load(outs[r]), want)
                            for r in range(2)]
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", default=["seq", "model"])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="9b")
    ap.add_argument("--seconds", type=int, default=120)
    ap.add_argument("--mm-chunks", type=int, default=32)
    ap.add_argument("--child", nargs=4, metavar=("MODE", "PORT", "RANK", "OUT"))
    args = ap.parse_args()
    if args.child:
        mode, port, rank, out = args.child
        child(mode, int(port), int(rank), out, args)
        return
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    print(json.dumps(compare(args.modes, layers=args.layers, new=args.new, device=args.device,
                             config=args.config, seconds=args.seconds,
                             mm_chunks=args.mm_chunks)))


if __name__ == "__main__":
    main()
