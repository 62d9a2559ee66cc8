"""Two ranks of the port's serving path, or of its train CLI, on one card,
over gloo.

    python3 vidi_tpu_torch/tools/ranks_one_card.py [MODE ...] [--layers N]
        [--new N] [--seconds S] [--mm-chunks N] [--device cuda|cpu]
        [--config 9b|tiny] [--w8a8 ROWS] [--steps N]

Run from the root of a checkout. MODE is "seq" (`--seq-parallel 2`),
"model" (`--model-parallel 2`), "model_int8" (`--model-parallel 2` with
`--load-8bit` and W8A8 products from --w8a8 rows, default 512),
"train_model" (the train CLI with `--model_parallel_size 2`) or
"train_model_fault" (the same with a planted fault: the backward of
`sharding.to_model` sums nothing over the model group, as if its
all-reduce were dropped); default "seq" and "model". NCCL puts no two
ranks of a communicator on one GPU, so the two ranks talk over gloo,
which has to take the path's collectives on CUDA tensors. For the
serving modes the parent first runs the one-process reference (bf16, or
int8 for "model_int8"): the
configuration (default Vidi1.5-9B at full width, random weights from
seed 0, the first N text layers, bf16 on the card) on chip_smoke.py's
synthetic clip (--seconds, default 120) and one TR query, greedy
generate of --new tokens on the kernel routes (K1 / K2 / K3, and K5 /
K6 for int8). Then two child processes (a gloo group that meets in a
file of the parent's temporary directory, so that no two runs race for
a port; both on card 0) run the same with `load_model(mesh=)`; the parent holds
each rank's step-0 logits against the reference's (the largest
difference over the largest |logit|, and the cosine) and its tokens
(with the reference's top-2 gap where they first differ), and prints
them with each rank's K6 launches. For "train_model" the reference is
the CLI in one process (--steps steps on its synthetic batches, the
configuration's first N text layers, towers frozen) and the two children
run it as the two ranks of a (1, 1, 2) mesh; the parent holds each
step's loss, and the AdamW first moments of the checkpoint written at
the end (linear in the steps' gradients: the text layers' backward,
cut over "model", carries the adapters' gradients). A child that fails
prints its error, and the parent prints the last lines of it and goes
on with the next mode.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())
QUERY = "a red car driving past"


def _text_layers(config: str, layers: int):
    """mm_overrides giving `config`'s first `layers` text layers."""
    import dataclasses

    from vidi_tpu_torch.infer.loader import CONFIGS

    base = CONFIGS[config]()
    return {"text": dataclasses.replace(base.text,
                                        num_layers=min(layers, base.text.num_layers))}


def _model(config: str, layers: int, device: str, mesh=None, int8: bool = False):
    """(params, cfg, tokenizer): random weights from seed 0, cut to the
    first `layers` text layers; with `int8` the text layers int8."""
    from vidi_tpu_torch.infer.loader import load_model

    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    return load_model(random_weights=config, dtype=dtype, device=device, mesh=mesh,
                      mm_overrides=_text_layers(config, layers), load_8bit=int8)


def _clip(cfg, seconds: int):
    """chip_smoke.py's synthetic clip at the tower's size: (uint8 frames,
    mel windows, audio length)."""
    import chip_smoke as c
    from vidi_tpu_torch.media.audio import process_audio

    frames, wave = c._synthetic_clip(seconds, cfg.vision.image_size, cfg.audio.sampling_rate)
    mels, audio_len = process_audio(wave, cfg.audio)
    return frames, mels, audio_len


def run(config: str, layers: int, new: int, device: str, mesh=None, seconds: int = 120,
        mm_chunks: int = 32, w8a8=None) -> dict:
    """The path once: encode, prefill (step-0 logits), greedy generate; with
    `w8a8` (rows) on int8 text layers whose products of at least that many
    rows are W8A8 (K6), with K6's launches counted."""
    from vidi_tpu_torch.infer import quantize as qz
    from vidi_tpu_torch.ops.cuda import quant_matmul as k6

    params, cfg, tok = _model(config, layers, device, mesh, int8=w8a8 is not None)
    before = dict(k6.launches)
    keep, qz.w8a8_min_tokens = qz.w8a8_min_tokens, w8a8
    try:
        out = _path(params, cfg, tok, new, device, seconds, mm_chunks)
    finally:
        qz.w8a8_min_tokens = keep
    out["k6_launches"] = {k: n - before[k] for k, n in k6.launches.items()}
    return out


def _path(params, cfg, tok, new: int, device: str, seconds: int, mm_chunks: int) -> dict:
    from vidi_tpu_torch.infer import generate as g
    from vidi_tpu_torch.infer import pipeline as P
    from vidi_tpu_torch.parallel import sharding

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


def train_cli(args, out_dir: str) -> list:
    """The train CLI on `args.config`'s first --layers text layers (random
    weights from seed 0; its synthetic batches, --steps steps, the
    adapters trained: the text layers and towers frozen, so that the
    checkpoint it writes at the end holds no moments of the 9B's
    embedding, while the gradient still crosses every text layer's
    backward) in this process: one rank of the process group already
    made, or one process -> the steps' losses (rank 0's)."""
    from vidi_tpu_torch.infer import loader
    from vidi_tpu_torch.train import train

    real = loader.load_model

    def load(model_path, random_weights, **kw):  # --tiny stands for the configuration
        over = {**(kw.pop("mm_overrides") or {}), **_text_layers(args.config, args.layers)}
        return real(model_path, args.config, mm_overrides=over, **kw)

    loader.load_model = load
    try:
        train.main(["--tiny", "--data_path", "synthetic", "--max_steps", str(args.steps),
                    "--device", args.device, "--output_dir", out_dir, "--save_steps", "1000",
                    "--learning_rate", "1e-4", "--mm_rand_lr", "1e-3", "--train_llm",
                    "false",
                    *(["--model_parallel_size", "2"] if "WORLD_SIZE" in os.environ else [])])
    finally:
        loader.load_model = real
    return _losses(out_dir)


def _losses(run_dir: str) -> list:
    """The losses of the train CLI's metrics.jsonl in `run_dir`."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(x)["loss"] for x in f]


def child(mode: str, store: str, rank: int, out: str, args) -> None:
    """One rank: a gloo group of two on card 0 (or the CPU) that meets in
    the file `store`, the mesh of `mode`, the path (or the train CLI), its
    results to `out`."""
    import torch.distributed as dist

    from vidi_tpu_torch.core.mesh import make_mesh, shutdown
    from vidi_tpu_torch.parallel import sharding

    if args.device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    try:
        if mode.startswith("train_model"):
            # the CLI takes its rank from torchrun's variables; the group is
            # made already (gloo: NCCL takes no two ranks on one card), and
            # the CLI ends it. Both ranks share the output directory, where
            # rank 0 writes the metrics and the checkpoint
            os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
            if mode == "train_model_fault":
                sharding._ToModel.backward = staticmethod(lambda ctx, g: (g, None))
            train_cli(args, os.path.join(os.path.dirname(out), f"{mode}.run"))
            return
        mesh = make_mesh(data=1, seq=2 if mode == "seq" else 1,
                         model=1 if mode == "seq" else 2, device_type=args.device)
        with sharding.use_mesh(mesh):
            res = run(args.config, args.layers, args.new, args.device, mesh,
                      args.seconds, args.mm_chunks, args.w8a8 if mode == "model_int8" else None)
        torch.save(res, out)
        shutdown(mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


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


def _moments(run_dir: str, steps: int) -> dict:
    """The AdamW first moments {key: fp32} of the checkpoint the train CLI
    wrote in `run_dir` at its last step."""
    path = os.path.join(run_dir, "checkpoints", f"step_{steps}.pt")
    return torch.load(path, map_location="cpu", weights_only=True)["opt_state"]["mu"]


def _reference(mode: str, args, tmp: str):
    """The one-process run that `mode`'s ranks are held against."""
    if mode.startswith("train_model"):
        t0 = time.perf_counter()
        losses = train_cli(args, os.path.join(tmp, "one"))
        print(f"  train CLI, one process: losses {losses}, wall "
              f"{time.perf_counter() - t0:.1f} s")
        return {"losses": losses, "mu": _moments(os.path.join(tmp, "one"), args.steps)}
    want = run(args.config, args.layers, args.new, args.device, None, args.seconds,
               args.mm_chunks, args.w8a8 if mode == "model_int8" else None)
    print(f"  one process{' (int8)' if mode == 'model_int8' else ''}: wall "
          f"{want['wall_s']:.1f} s; tokens {want['tokens'].tolist()}; top-2 gaps over "
          "max|logit| " + ", ".join(f"{x:.4f}" for x in want["gaps"]))
    return want


def _held_train(label: str, got: dict, want: dict) -> dict:
    """Each step's loss against one process's (the largest relative gap),
    and the first moments: the largest over the trained leaves of
    |mu - mu one process| / |mu one process| (Frobenius norms)."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    mu = {k: float((got["mu"][k] - m).norm() / m.norm())
          for k, m in want["mu"].items() if m.norm() > 0}
    top = max(mu, key=mu.get)
    print(f"  {label}: losses {got['losses']} (one process {want['losses']}), largest "
          f"relative gap {rel:.3e}; first moments off by {mu[top]:.3e} ({top}) at most")
    return {"losses": got["losses"], "want": want["losses"], "rel": rel,
            "steps": len(got["losses"]), "mu_rel": mu[top], "mu_leaf": top}


def compare(modes=("seq", "model"), *, layers: int = 4, new: int = 8, device: str = "cuda",
            config: str = "9b", seconds: int = 120, mm_chunks: int = 32, w8a8: int = 512,
            steps: int = 2) -> dict:
    """Each mode's one-process reference (shared by the bf16 serving
    modes, and by the train modes), then its two ranks held against it ->
    {mode: [each rank's `_held`] (serving), [the pair's `_held_train`]
    (training) or {"failed": the ranks' last lines}}. The train modes'
    pairs run at once (no wall time is read from them); each serving
    mode's pair runs alone."""
    args = argparse.Namespace(layers=layers, new=new, device=device, config=config,
                              seconds=seconds, mm_chunks=mm_chunks, w8a8=w8a8, steps=steps)
    report, refs = {}, {}
    flags = ["--layers", str(layers), "--new", str(new), "--device", device, "--config",
             config, "--seconds", str(seconds), "--mm-chunks", str(mm_chunks), "--w8a8",
             str(w8a8), "--steps", str(steps)]
    kinds = {m: {"model_int8": m, "train_model": m, "train_model_fault": "train_model"}
             .get(m, "bf16") for m in modes}
    train = [m for m in modes if kinds[m] == "train_model"]
    groups = [[m] for m in modes if m not in train] + ([train] if train else [])
    with tempfile.TemporaryDirectory() as tmp:
        def spawn(mode):
            store = os.path.join(tmp, f"{mode}.store")
            outs = [os.path.join(tmp, f"{mode}{r}.pt") for r in range(2)]
            return outs, [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), *flags, "--child", mode,
                 store, str(r), outs[r]], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
                for r in range(2)]

        for group in groups:
            for mode in group:
                if kinds[mode] not in refs:
                    refs[kinds[mode]] = _reference(mode, args, tmp)
                    if device == "cuda":
                        torch.cuda.empty_cache()
            started = {mode: spawn(mode) for mode in group}
            for mode in group:
                want, (outs, procs) = refs[kinds[mode]], started[mode]
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
                if kinds[mode] == "train_model":
                    # the pair's losses and moments: rank 0 writes both (the
                    # model ranks compute one loss; the moments are gathered)
                    run_dir = os.path.join(tmp, f"{mode}.run")
                    got = {"losses": _losses(run_dir), "mu": _moments(run_dir, steps)}
                    report[mode] = [_held_train(f"{mode} (rank 0's log)", got, want)]
                    continue
                report[mode] = [_held(f"{mode} rank {r}", torch.load(outs[r]), want)
                                for r in range(2)]
                if mode == "model_int8":
                    for r, got in enumerate(report[mode]):
                        got["k6_launches"] = torch.load(outs[r])["k6_launches"]
                    print(f"  {mode}: K6 launches a rank "
                          f"{[g['k6_launches'] for g in report[mode]]} (one process "
                          f"{want['k6_launches']})")
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
    ap.add_argument("--w8a8", type=int, default=512)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--child", nargs=4, metavar=("MODE", "STORE", "RANK", "OUT"))
    args = ap.parse_args()
    if args.child:
        mode, store, rank, out = args.child
        child(mode, store, int(rank), out, args)
        return
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    print(json.dumps(compare(args.modes, layers=args.layers, new=args.new, device=args.device,
                             config=args.config, seconds=args.seconds,
                             mm_chunks=args.mm_chunks, w8a8=args.w8a8, steps=args.steps)))


if __name__ == "__main__":
    main()
