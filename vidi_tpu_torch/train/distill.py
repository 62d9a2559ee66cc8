"""Draft-model distillation for speculative decoding (port of
vidi_tpu/train/distill.py).

Trains a small text-only Dattn draft to imitate a (finetuned) target's
next-token behavior on the target's OWN greedy trajectories, so
`speculative_generate`'s acceptance rate is maximized where it is
evaluated: on the sequences the target actually produces. The loss is a
soft-label KL against the teacher distribution (sequence-level knowledge
distillation). The draft is exported with `infer.export.save_pretrained`,
which `pipeline --draft-model-path` reads back.

Usage:
    python -m vidi_tpu_torch.train.distill --model_path TEACHER_DIR \
        --export_dir draft/ --draft_layers 4 --draft_hidden 512 \
        --steps 2000 --batch 8 --prompt_len 32 --gen_len 96 \
        [--load-8bit] [--dtype bfloat16] [--device cuda] \
        [--prompts_path queries.jsonl --prompt_task tr]
    python -m vidi_tpu_torch.train.distill --random-weights tiny \
        --export_dir draft/ --draft_layers 2 --draft_hidden 64 --draft_heads 4 \
        --draft_kv_heads 2 --draft_head_dim 16 --draft_ffn 128 --steps 8 \
        --device cpu --dtype float32

Differences of form from the JAX module: randomness comes from one
`torch.Generator` (the random prompt ids and the pool rows, in that order)
in place of the key splits, and the student's AdamW is the port's
(`optimizer.adamw`, optax.adamw's defaults). As in JAX, the teacher's
rollouts and both models' logits run without the attention kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from vidi_tpu_torch.core.config import DattnConfig
from vidi_tpu_torch.models import dattn, decoder


def student_config(cfg: DattnConfig, *, layers: int, hidden: int,
                   heads: int, kv_heads: int, head_dim: int,
                   ffn: int) -> DattnConfig:
    """Teacher config -> draft config: same arch / vocab / specials (the
    tokenizer contract speculative decoding requires), a scaled-down text
    stack, and tiny towers (the draft never sees media)."""
    from vidi_tpu_torch.core.config import AudioConfig, VisionConfig
    t = dataclasses.replace(
        cfg.text, num_layers=layers, hidden_size=hidden, num_heads=heads,
        num_kv_heads=kv_heads, head_dim=head_dim, intermediate_size=ffn)
    return dataclasses.replace(cfg, text=t, vision=VisionConfig.tiny(),
                               audio=AudioConfig.tiny())


def rollout(teacher, cfg: DattnConfig, ids: torch.Tensor, gen_len: int) -> torch.Tensor:
    """Prompt ids [B,P] -> [B, P + gen_len] teacher-greedy rollouts; eos_id
    -1 never matches, so every row runs to full length."""
    from vidi_tpu_torch.infer.generate import generate
    mask = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    res = generate(teacher, cfg, ids, mask, max_new_tokens=gen_len, eos_id=-1)
    return torch.cat([ids, res.tokens], dim=1)


def sample_trajectories(generator: torch.Generator, teacher, cfg: DattnConfig, *,
                        batch: int, prompt_len: int, gen_len: int,
                        prompt_pool=None, random_frac: float = 0.5) -> torch.Tensor:
    """[B, prompt_len + gen_len] teacher-greedy rollouts. Prompts are
    uniform-random token ids in [3, vocab); with `prompt_pool` ([N,
    prompt_len] int, `build_prompt_pool`) the first `1 - random_frac` of
    the rows are pool prompts instead."""
    dev = generator.device
    ids = torch.randint(3, cfg.text.vocab_size, (batch, prompt_len), generator=generator,
                        device=dev)
    if prompt_pool is not None and len(prompt_pool):
        n_pool = batch - int(round(batch * random_frac))
        pool = torch.as_tensor(prompt_pool, dtype=torch.long, device=dev)
        pick = torch.randint(0, pool.shape[0], (n_pool,), generator=generator, device=dev)
        ids = torch.cat([pool[pick], ids[n_pool:]], dim=0)
    return rollout(teacher, cfg, ids, gen_len)


def build_prompt_pool(prompts_path: str, tokenizer, cfg: DattnConfig, *,
                      prompt_len: int, task: str = "none",
                      video_seconds: float = 600.0):
    """Real task prompts -> [N, prompt_len] int32 pool for
    sample_trajectories. One prompt per line: a JSON object ({"query": ...}
    / {"text": ...} / {"prompt": ...}) or a raw text line. `task != "none"`
    wraps each query in the production prompt template
    (pipeline.build_prompt_ids). Rows keep their last `prompt_len` tokens
    and are left-padded with pad / bos."""
    import json as _json

    import numpy as np

    from vidi_tpu_torch.infer import pipeline

    texts = []
    with open(prompts_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = _json.loads(line)
            except _json.JSONDecodeError:
                obj = None
            if isinstance(obj, dict):
                t = obj.get("query") or obj.get("text") or obj.get("prompt")
                if t:
                    texts.append(str(t))
            else:
                texts.append(line)
    pad_id = getattr(tokenizer, "pad_token_id", None)
    if pad_id is None:
        pad_id = getattr(tokenizer, "bos_token_id", 0) or 0
    rows = []
    for t in texts:
        if task != "none":
            ids = list(map(int, pipeline.build_prompt_ids(t, tokenizer, cfg.mm_version,
                                                          video_seconds, task)))
        else:
            ids = list(map(int, tokenizer(t).input_ids))
        ids = ids[-prompt_len:]
        rows.append([pad_id] * (prompt_len - len(ids)) + ids)
    return np.asarray(rows, np.int32) if rows else None


def _logits(params, cfg: DattnConfig, seqs: torch.Tensor) -> torch.Tensor:
    """[B,T] ids -> [B,T,V] fp32 logits, text only, on the plain route."""
    tcfg = cfg.text
    b, t = seqs.shape
    mask = torch.ones((b, t), dtype=torch.bool, device=seqs.device)
    pos = torch.arange(t, device=seqs.device).expand(b, t)
    embeds = decoder.embed_tokens(params["text"], seqs, tcfg)
    h, _ = dattn.forward(params, cfg, embeds, mask, pos)
    return decoder.lm_logits(params["text"], h, tcfg)


@torch.no_grad()
def _teacher_targets(teacher, cfg: DattnConfig, seqs: torch.Tensor,
                     temperature: float = 1.0) -> torch.Tensor:
    return torch.softmax(_logits(teacher, cfg, seqs)[:, :-1] / temperature, dim=-1)


def distill_loss(student, scfg: DattnConfig, seqs: torch.Tensor, soft: torch.Tensor,
                 temperature: float = 1.0) -> torch.Tensor:
    """KL(teacher || student) over next-token positions (the constant
    teacher entropy dropped: a soft cross entropy)."""
    ls = _logits(student, scfg, seqs)[:, :-1] / temperature
    return -(soft * torch.log_softmax(ls, dim=-1)).sum(-1).mean()


def distill_step(student, scfg: DattnConfig, tx, state, seqs, soft,
                 temperature: float = 1.0) -> torch.Tensor:
    """One AdamW step on every student leaf (a leaf the loss does not
    reach, as the towers, has gradient zero and still decays) -> loss."""
    from vidi_tpu_torch.train.optimizer import leaves
    keys, ps = zip(*[(key, p) for key, _, p in leaves(student)])
    for p in ps:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = distill_loss(student, scfg, seqs, soft, temperature)
            got = torch.autograd.grad(loss, ps, allow_unused=True)
    finally:
        for p in ps:
            p.requires_grad_(False)
    tx.apply(student, {k: torch.zeros_like(p) if g is None else g
                       for k, p, g in zip(keys, ps, got)}, state)
    return loss.detach()


def run_distill(teacher, cfg: DattnConfig, scfg: DattnConfig, *,
                steps: int, batch: int, prompt_len: int, gen_len: int,
                lr: float = 3e-4, temperature: float = 1.0,
                resample_every: int = 8, seed: int = 0,
                log_every: int = 50, prompt_pool=None,
                random_frac: float = 0.5, device=None) -> Tuple[dict, float]:
    """-> (trained draft params (fp32, on the teacher's device unless
    `device`), final loss). Fresh teacher rollouts every `resample_every`
    steps."""
    from vidi_tpu_torch.train.optimizer import adamw
    dev = torch.device(device) if device is not None else teacher["text"]["embed"].device
    student = dattn.init_params(scfg, torch.float32, dev, seed)
    tx = adamw(student, lr)
    state = tx.init(student)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    loss = float("inf")
    seqs = soft = None
    for i in range(steps):
        if i % resample_every == 0:
            seqs = sample_trajectories(gen, teacher, cfg, batch=batch,
                                       prompt_len=prompt_len, gen_len=gen_len,
                                       prompt_pool=prompt_pool, random_frac=random_frac)
            soft = _teacher_targets(teacher, cfg, seqs, temperature)
        loss = float(distill_step(student, scfg, tx, state, seqs, soft, temperature))
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"distill step {i}: kl {loss:.4f}")
    return student, loss


def main(argv: Optional[list] = None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", default=None, help="teacher checkpoint")
    ap.add_argument("--random-weights", default=None,
                    help="tiny|9b|7b random teacher (plumbing check)")
    ap.add_argument("--export_dir", required=True)
    ap.add_argument("--draft_layers", type=int, default=4)
    ap.add_argument("--draft_hidden", type=int, default=512)
    ap.add_argument("--draft_heads", type=int, default=8)
    ap.add_argument("--draft_kv_heads", type=int, default=4)
    ap.add_argument("--draft_head_dim", type=int, default=64)
    ap.add_argument("--draft_ffn", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt_len", type=int, default=32)
    ap.add_argument("--gen_len", type=int, default=96)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--resample_every", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16",
                    help="teacher load dtype (the draft trains in fp32)")
    ap.add_argument("--load-8bit", action="store_true",
                    help="int8 weight-only teacher")
    ap.add_argument("--load-8bit-towers", action="store_true")
    ap.add_argument("--prompts_path", default=None,
                    help="file of real task prompts (JSONL with query/text/prompt "
                         "fields, or raw lines) seeding teacher rollouts")
    ap.add_argument("--prompt_task", default="tr",
                    help="wrap --prompts_path queries in this task's production "
                         "prompt template ('none' = tokenize the raw text)")
    ap.add_argument("--prompt_video_seconds", type=float, default=600.0,
                    help="nominal video length baked into templated prompts")
    ap.add_argument("--random_frac", type=float, default=0.5,
                    help="with --prompts_path: fraction of rollout rows that keep "
                         "uniform-random prompts")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' without a card raises")
    args = ap.parse_args(argv)

    from vidi_tpu_torch.infer.export import save_pretrained
    from vidi_tpu_torch.infer.loader import load_model, resolve_device

    dev = resolve_device(args.device)
    teacher, cfg, tok = load_model(args.model_path, args.random_weights,
                                   dtype=getattr(torch, args.dtype), device=dev,
                                   load_8bit=args.load_8bit,
                                   load_8bit_towers=args.load_8bit_towers)
    scfg = student_config(
        cfg, layers=args.draft_layers, hidden=args.draft_hidden,
        heads=args.draft_heads, kv_heads=args.draft_kv_heads,
        head_dim=args.draft_head_dim, ffn=args.draft_ffn)
    pool = None
    if args.prompts_path:
        pool = build_prompt_pool(args.prompts_path, tok, cfg, prompt_len=args.prompt_len,
                                 task=args.prompt_task,
                                 video_seconds=args.prompt_video_seconds)
        if pool is not None:
            print(f"prompt pool: {pool.shape[0]} templated prompts "
                  f"({args.prompt_task}), random_frac {args.random_frac}")
    student, loss = run_distill(
        teacher, cfg, scfg, steps=args.steps, batch=args.batch,
        prompt_len=args.prompt_len, gen_len=args.gen_len, lr=args.lr,
        temperature=args.temperature, resample_every=args.resample_every,
        seed=args.seed, prompt_pool=pool, random_frac=args.random_frac)
    save_pretrained(student, scfg, args.export_dir, tokenizer_src=args.model_path)
    print(f"draft exported to {args.export_dir} (final kl {loss:.4f}); use "
          f"with: pipeline --draft-model-path {args.export_dir}")


if __name__ == "__main__":
    main()
