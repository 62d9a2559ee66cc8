"""The port's train -> export -> serve -> score loop
(`vidi_tpu_torch.tools.full_loop`) against vidi_tpu's
(`scripts/full_loop_smoke.py`), on the CPU at the tiny configuration:

- the fixture: the port's `make_example` and vidi_tpu's
  `scripts/make_example.py` write equal JSON files and clips that decode
  to equal frames with equal lengths;
- the loop: `run_full_loop(start="tiny", device="cpu", steps=3)` runs end
  to end in fp32; its logged losses and its exported tensors are the
  port's `train_step` replayed on the batches and position noise the CLI
  made (bit for bit), and the same steps on the same start checkpoint and
  batches agree with vidi_tpu's jitted `train_step` (noise drawn from
  JAX's key tree as its CLI splits it) to LOSS_TOL / LEAF_TOL. The two
  CLIs draw their position noise from different generators (torch's and
  JAX's), so their losses are held through the step, in process, rather
  than CLI against CLI;
- the scores: the port's dict equals vidi_tpu's `evaluate` on the same
  predictions file, key for key;
- the tiny start is its init unscaled, and `answer_margins` gives one
  finite margin a labelled token;
- `device="cuda"` without a card raises;
- the launch scripts parse (`bash -n`).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidi_tpu.evals import vue_tr as jvue_tr
from vidi_tpu.infer import loader as jloader
from vidi_tpu.media import video as jvideo
from vidi_tpu.train import optimizer as jopt
from vidi_tpu.train import train_step as jstep
from vidi_tpu_torch.constants import IGNORE_INDEX
from vidi_tpu_torch.infer.loader import load_model
from vidi_tpu_torch.media import video as tvideo
from vidi_tpu_torch.models.dattn import draw_pos_noise
from vidi_tpu_torch.tools import full_loop
from vidi_tpu_torch.tools.make_example import write_example
from vidi_tpu_torch.train import data as tdata
from vidi_tpu_torch.train import optimizer as topt
from vidi_tpu_torch.train import train as tcli
from vidi_tpu_torch.train import train_step as tstep
import torch_init  # noqa: F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, COPIES, SECONDS = 3, 8, 25.0
# fp32 on both sides: the loss to 1e-5 relative, every parameter after
# each step within 1e-4 of its leaf's largest magnitude (as
# test_torch_train_step holds the same step on synthetic batches)
LOSS_TOL, LEAF_TOL, LEAF_FLOOR = 1e-5, 1e-4, 1e-7
FROZEN = ("vision", "audio")  # the CLI's defaults: --train_vis / --train_aud false


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("loop"))
    scores = full_loop.run_full_loop(work, steps=STEPS, copies=COPIES, seconds=SECONDS,
                                     start="tiny", device="cpu", verbose=False)
    return work, scores


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_fixture_matches_make_example(tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    write_example(port, SECONDS, COPIES)
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "make_example.py"), "--out-dir", ref,
         "--seconds", str(SECONDS), "--copies", str(COPIES)],
        cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    for name in ("example.json", "example_images.json"):
        assert _json(os.path.join(port, name)) == _json(os.path.join(ref, name)), name
    from PIL import Image
    assert np.array_equal(np.asarray(Image.open(os.path.join(port, "dummy.png"))),
                          np.asarray(Image.open(os.path.join(ref, "dummy.png"))))
    clips = [os.path.join(d, "dummy.mp4") for d in (port, ref)]
    lengths = {tvideo.get_media_length(c) for c in clips} | \
        {jvideo.get_media_length(c) for c in clips}
    assert lengths == {_json(os.path.join(port, "example.json"))[0]["length"]}
    got, want = tvideo.load_video(clips[0], 1.0), jvideo.load_video(clips[1], 1.0)
    assert len(got) == len(want) == int(SECONDS)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def _cli_run(work):
    """What the port's train CLI set up for the loop: the start's weights,
    config (with --loss_thres) and tokenizer, the optimizer of its flags,
    and the first batch (every record is the same conversation)."""
    args = tcli.build_parser().parse_args(full_loop.train_argv(work, STEPS, "cpu"))
    params, cfg, tok = load_model(args.model_path, dtype=torch.float32, device="cpu",
                                  seed=args.seed)
    cfg = dataclasses.replace(cfg, loss_thres=args.loss_thres)
    hp = topt.TrainHParams(
        learning_rate=args.learning_rate, mm_rand_lr=args.mm_rand_lr,
        weight_decay=args.weight_decay, warmup_ratio=args.warmup_ratio,
        total_steps=args.max_steps, train_llm=args.train_llm)
    ds = tdata.VideoConvDataset(args.data_path, args.video_folder, tok, cfg,
                                fps=args.video_fps)
    batch = tdata.collate([ds[0]], cfg)
    hw = jstep.make_batch_hw(cfg, int(batch["frame_counts"].sum()))
    return args, params, cfg, hp, batch, hw


def _jax_noise(rng, cfg, batch, hw):
    """The draws vidi_tpu's loss_fn makes from `rng` (its encoders' splits:
    split(rng, 3); images split(rngs[0], 3) -> h, w, t; audio rngs[1])."""
    rngs = jax.random.split(rng, 3)
    img = jax.random.split(rngs[0], 3)
    pool = cfg.mm_image_pool_size
    b, n = batch["images"].shape[:2]
    n_aud = batch["mels"].shape[1] * cfg.audio.max_source_positions // cfg.mm_audio_pool_size
    draws = {"img_h": jax.random.normal(img[0], (hw[0] // pool,)),
             "img_w": jax.random.normal(img[1], (hw[1] // pool,)),
             "img_t": jax.random.normal(img[2], (b, n)),
             "aud_t": jax.random.normal(rngs[1], (b, n_aud))}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _jax_leaf(tree, path):
    node, layer = tree, None
    for key in path:
        if isinstance(key, int):
            layer = key
        else:
            node = node[key]
    return node if layer is None else node[layer]


def test_loop_replays_the_port_step(loop):
    """The CLI's logged losses and the export are the port's train_step
    replayed on the CLI's batch and its noise (the generator seeded with
    seed + step): bit for bit."""
    work, _ = loop
    args, params, cfg, hp, batch, hw = _cli_run(work)
    tx = topt.make_optimizer(params, hp)
    state = tstep.opt_init(tx, params)
    on_cpu = tdata.to_device(batch, "cpu")
    gen, losses = torch.Generator(), []
    for step in range(STEPS):
        gen.manual_seed(args.seed + step)
        noise = draw_pos_noise(cfg, 1, on_cpu["images"].shape[1], on_cpu["mels"].shape[1],
                               hw, gen)
        params, state, loss = tstep.train_step(
            params, state, on_cpu, noise, cfg=cfg, tx=tx, hw=hw, mm_chunks=args.mm_splits,
            remat=True, use_flash=False, frozen=FROZEN)
        losses.append(float(loss))
    with open(full_loop.paths(work)["metrics"]) as f:
        logged = [json.loads(line) for line in f]
    assert [m["step"] for m in logged] == list(range(STEPS))
    assert [m["loss"] for m in logged] == losses
    exported, _, _ = load_model(full_loop.paths(work)["hf"], dtype=torch.float32,
                                device="cpu")
    start, _, _ = load_model(full_loop.paths(work)["start"], dtype=torch.float32,
                             device="cpu")
    got = {k: p for k, _, p in topt.leaves(exported)}
    was = {k: p for k, _, p in topt.leaves(start)}
    moved = 0
    for key, _, p in topt.leaves(params):
        assert torch.equal(got[key], p), key
        moved += not torch.equal(was[key], p)
    assert moved > 0


def test_loop_step_matches_jax(loop):
    """The loop's steps from its start checkpoint on its batch, the port's
    train_step against vidi_tpu's (the start read by each package's own
    loader; JAX's key split per step as its CLI splits it)."""
    work, _ = loop
    args, tp, cfg, hp, batch, hw = _cli_run(work)
    jp, jcfg, _ = jloader.load_model(args.model_path, dtype=jnp.float32)
    jcfg = dataclasses.replace(jcfg, loss_thres=args.loss_thres)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jtx = jopt.make_optimizer(jp, jopt.TrainHParams(**dataclasses.asdict(hp)))
    ttx = topt.make_optimizer(tp, hp)
    j_state, t_state = jstep.opt_init(jtx, jp), tstep.opt_init(ttx, tp)
    kw = dict(hw=hw, mm_chunks=args.mm_splits, remat=True, use_flash=False, frozen=FROZEN)
    rng = jax.random.PRNGKey(args.seed)
    for step in range(STEPS):
        rng, sub = jax.random.split(rng)
        jp, j_state, j_loss = jstep.train_step(
            jp, j_state, {k: jnp.asarray(v) for k, v in batch.items()}, sub, cfg=jcfg,
            tx=jtx, **kw)
        tp, t_state, t_loss = tstep.train_step(
            tp, t_state, tdata.to_device(batch, "cpu"), _jax_noise(sub, cfg, batch, hw),
            cfg=cfg, tx=ttx, **kw)
        assert abs(float(t_loss) - float(j_loss)) <= LOSS_TOL * abs(float(j_loss)), step
        host = jax.device_get(jp)
        for key, path, p in topt.leaves(tp):
            want = np.asarray(_jax_leaf(host, path))
            err = float(np.abs(p.numpy() - want).max())
            top = float(np.abs(want).max())
            assert err <= LEAF_TOL * top + LEAF_FLOOR, f"step {step} {key}: {err:.3e}"


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def test_scores_match_jax_evaluate(loop, tmp_path):
    """On the loop's predictions, and on a file of partial spans where every
    number is nonzero."""
    work, scores = loop
    p = full_loop.paths(work)
    assert scores["n_query"] == 1
    assert _same(scores, jvue_tr.evaluate(p["preds"], p["gt"], breakdown=False))
    preds = _json(p["preds"])
    duration = preds[0]["duration"]
    preds[0]["answer"] = [[0.0, 0.4 * duration], [0.6 * duration, 0.9 * duration]]
    other = str(tmp_path / "preds.json")
    with open(other, "w") as f:
        json.dump(preds, f)
    got = full_loop.score(work, other)
    assert 0 < got["overall"]["iou"] < 1
    assert _same(got, jvue_tr.evaluate(other, p["gt"], breakdown=False))


def test_tiny_start_keeps_its_init(loop):
    """The tiny model's init logits (std 8) stay inside the final softcap
    (30), so its start is the init as drawn: the reference loop's model."""
    work, _ = loop
    got, cfg, _ = load_model(full_loop.paths(work)["start"], dtype=torch.float32,
                             device="cpu")
    want, _, _ = load_model(random_weights="tiny", dtype=torch.float32, device="cpu",
                            seed=full_loop.SEED)
    assert cfg.text.hidden_size**0.5 < cfg.text.final_softcap
    assert torch.equal(got["text"]["embed"], want["text"]["embed"])


def test_answer_margins(loop):
    """One finite margin for each labelled token of the fixture's record."""
    work, _ = loop
    _, cfg, tok = load_model(full_loop.paths(work)["hf"], dtype=torch.float32, device="cpu")
    ds = tdata.VideoConvDataset(full_loop.paths(work)["data"], work, tok, cfg, fps=1.0)
    labelled = int((tdata.collate([ds[0]], cfg)["labels"][0] != IGNORE_INDEX).sum())
    margins = full_loop.answer_margins(work, "cpu")
    assert len(margins) == labelled > 0
    assert all(map(math.isfinite, margins))


@pytest.mark.parametrize("device,plain,flash", [
    ("cuda", False, True), ("cuda", True, False), ("cpu", False, False)])
def test_train_argv_route(device, plain, flash):
    """The loop's training takes the kernels on CUDA unless `plain`, and
    runs in bf16 there either way; the CPU runs the plain route in fp32."""
    argv = full_loop.train_argv("w", STEPS, device, plain=plain)
    args = tcli.build_parser().parse_args(argv)
    assert args.use_flash is flash
    assert args.dtype == ("bfloat16" if device == "cuda" else "float32")


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the refusal where no card is")
def test_cuda_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        full_loop.run_full_loop(str(tmp_path), steps=1, start="tiny", device="cuda",
                                verbose=False)
    assert not os.listdir(tmp_path)  # refused before the fixture


@pytest.mark.parametrize("script,device", [
    ("inference_torch.sh", "cuda"), ("inference_torch.sh", "cpu"),
    ("finetune_torch.sh", "cuda"), ("finetune_torch.sh", "cpu")])
def test_launch_scripts(script, device, tmp_path):
    """`bash -n` parses each script; run with `python3` and `torchrun`
    standing in as argument printers, each launches the port's CLI with
    arguments its parser takes (the kernels on the card)."""
    path = os.path.join(ROOT, "scripts", script)
    res = subprocess.run(["bash", "-n", path], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    for name in ("python3", "torchrun"):
        stub = tmp_path / name
        stub.write_text('#!/bin/sh\nprintf "%s\\n" "$@"\n')
        stub.chmod(0o755)
    res = subprocess.run(["bash", path], capture_output=True, text=True, env={
        **os.environ, "PATH": f"{tmp_path}{os.pathsep}{os.environ['PATH']}",
        "DEVICE": device})
    assert res.returncode == 0, res.stderr
    argv = res.stdout.splitlines()
    module = argv[argv.index("-m") + 1]
    rest = argv[argv.index("-m") + 2:]
    if script.startswith("finetune"):
        assert argv[:4] == ["--standalone", "--nproc_per_node", "1", "-m"]
        assert module == "vidi_tpu_torch.train.train"
        args = tcli.build_parser().parse_args(rest)
        assert (args.use_flash, args.dtype) == (
            (True, "bfloat16") if device == "cuda" else (False, "float32"))
        assert (args.learning_rate, args.mm_rand_lr, args.seed) == (1e-5, 2e-5, 45678)
    else:
        assert module == "vidi_tpu_torch.infer.pipeline"
        flags = dict(zip(rest[::2], rest[1::2]))
        assert flags["--device"] == device
        assert flags["--dtype"] == ("bfloat16" if device == "cuda" else "float32")
