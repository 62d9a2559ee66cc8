"""The rest of the port's training surface against vidi_tpu, on the CPU:

- the copies `train/samplers.py` and `train/packing.py`: the same outputs
  as the originals on the same inputs (exact);
- a packed batch (three text-only segments a row, zero-count media) through
  encode -> forward -> logits: each segment's hidden states equal to its
  sample run alone (2e-5), and the logits equal to JAX's on both routes
  (2e-4, test_torch_dattn's tolerance);
- `optimizer.MultiSteps` against `optax.MultiSteps(tx, k)` for k = 2, 3 on
  the same gradients: parameters within 1e-6 after every micro-step,
  bit-unchanged between optimizer steps, frozen leaves never moved, and its
  state through `Checkpointer` save / resume;
- `forward(remat=...)`: True, "dots" and False give the same loss and
  parameters (the reference's tolerances among its modes: loss rtol 1e-6,
  params rtol 1e-5, atol 1e-6), and JAX's within test_torch_train_step's
  limits; the "dots" policy keeps only the weight products;
- `TBReporter` with tensorboard (events read back) and without (a no-op);
- the train CLI's new flags, run in process: image-conv anyres batches with
  gradient accumulation, remat "dots", a profile trace and tensorboard;
  --pack and --group_by_length on conversation files; the reference's mode
  checks as ValueErrors; the mesh flags that a process without torchrun
  cannot serve raising; all 46 of the reference CLI's flags accepted.
"""
import dataclasses
import functools
import json
import os
import re
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.models import dattn as jdattn
from vidi_tpu.models import decoder as jdecoder
from vidi_tpu.ops.pallas import flash_attention as jfa
from vidi_tpu.train import optimizer as jopt
from vidi_tpu.train import packing as jpacking
from vidi_tpu.train import samplers as jsamplers
from vidi_tpu.train import train_step as jstep
from vidi_tpu.train.data import synthetic_batch
from vidi_tpu_torch.models import dattn as tdattn
from vidi_tpu_torch.models import decoder as tdecoder
from vidi_tpu_torch.train import checkpoint as tckpt
from vidi_tpu_torch.train import optimizer as topt
from vidi_tpu_torch.train import packing as tpacking
from vidi_tpu_torch.train import samplers as tsamplers
from vidi_tpu_torch.train import train as tcli
from vidi_tpu_torch.train import train_step as tstep
from vidi_tpu_torch.train.data import to_device
from vidi_tpu_torch.train.tb import TBReporter

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_vidi7b import init_both  # noqa: E402

jfa.INTERPRET = True

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(DattnConfig.tiny(), loss_thres=0.1)
FROZEN = ("vision", "audio")


@pytest.fixture(scope="module")
def params():
    return init_both(CFG)


def _jax_leaf(tree, path):
    node, layer = tree, None
    for key in path:
        if isinstance(key, int):
            layer = key
        else:
            node = node[key]
    return node if layer is None else node[layer]


# --- samplers and packing: the copies give the originals' outputs ---------------

SAMPLER_CASES = {
    "length_grouped": lambda m, s: m.length_grouped_indices(
        np.random.default_rng(s).integers(1, 100, 40).tolist(), 4, 2,
        np.random.default_rng(s + 1)),
    "mm_length_grouped": lambda m, s: m.mm_length_grouped_indices(
        [int(x) for x in np.random.default_rng(s).integers(-60, 60, 37) if x],
        3, np.random.default_rng(s + 1)),
    "sp_data": lambda m, s: m.sp_data_indices(list(range(16)), 2, 2, 2),
    "random_epoch": lambda m, s: m.random_epoch_indices(23, 2, 1, 1, s),
    "length_grouped_epoch": lambda m, s: m.length_grouped_epoch_indices(
        [int(x) for x in np.random.default_rng(s).integers(-80, 80, 30) if x],
        2, 1, 2, 1, 1, s),
}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", sorted(SAMPLER_CASES))
def test_samplers_match(name, seed):
    assert SAMPLER_CASES[name](tsamplers, seed) == SAMPLER_CASES[name](jsamplers, seed)


def _samples(lengths, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        ids = rng.integers(3, CFG.text.vocab_size, n).astype(np.int32)
        labels = ids.copy()
        labels[: n // 3] = -100
        out.append({"input_ids": ids, "labels": labels, "has_image": False})
    return out


def _equal_batches(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_packing_matches():
    lengths = [9, 4, 7, 3, 12, 5, 2, 8]
    samples = _samples(lengths)
    assert tpacking.first_fit_pack(lengths, 12) == jpacking.first_fit_pack(lengths, 12)
    assert tpacking.first_fit_pack([20, 3], 12) == jpacking.first_fit_pack([20, 3], 12)
    _equal_batches(tpacking.pack_rows(samples, 12), jpacking.pack_rows(samples, 12))
    _equal_batches(tpacking.pack_batch(samples, CFG, seq_len=16, rows_per_batch=5),
                   jpacking.pack_batch(samples, CFG, seq_len=16, rows_per_batch=5))
    t, j = tpacking.PackedBatcher(CFG, 2, 16), jpacking.PackedBatcher(CFG, 2, 16)
    for s in _samples(lengths * 2, seed=1):
        _equal_batches(t.add(s), j.add(s))
    _equal_batches(t.flush(), j.flush())
    with pytest.raises(ValueError, match="text-only"):
        t.add({**samples[0], "has_image": True})


# --- a packed forward ----------------------------------------------------------

def _packed_logits(pkg, params, batch, use_flash):
    """encode (zero-count media) -> forward with the segment ids -> logits,
    with `pkg`'s modules (vidi_tpu or the port)."""
    hw = jstep.make_batch_hw(CFG, 1)
    if pkg == "jax":
        return np.asarray(_jax_packed_logits(params, {k: jnp.asarray(v)
                                                      for k, v in batch.items()},
                                             use_flash))
    b = to_device(batch, "cpu")
    img, im = tdattn.encode_video_images(params, CFG, b["images"], b["frame_counts"], hw)
    aud, am = tdattn.encode_video_audios(params, CFG, b["mels"], b["audio_sizes"])
    emb = tdecoder.embed_tokens(params["text"], b["input_ids"], CFG.text)
    h, _ = tdattn.forward(params, CFG, emb, b["text_mask"], b["positions"], img=img,
                          img_mask=im, aud=aud, aud_mask=am, use_flash=use_flash,
                          text_segs=b["segment_ids"])
    return h, tdecoder.lm_logits(params["text"], h, CFG.text).numpy()


@functools.partial(jax.jit, static_argnames="use_flash")
def _jax_packed_logits(params, b, use_flash):
    hw = jstep.make_batch_hw(CFG, 1)
    img, im = jdattn.encode_video_images(params, CFG, b["images"], b["frame_counts"], hw)
    aud, am = jdattn.encode_video_audios(params, CFG, b["mels"], b["audio_sizes"])
    emb = jdecoder.embed_tokens(params["text"], b["input_ids"], CFG.text)
    h, _ = jdattn.forward(params, CFG, emb, b["text_mask"], b["positions"], img=img,
                          img_mask=im, aud=aud, aud_mask=am, use_flash=use_flash,
                          text_segs=b["segment_ids"])
    return jdecoder.lm_logits(params["text"], h, CFG.text)


@pytest.mark.parametrize("use_flash", [False, True])
def test_packed_forward_matches(params, use_flash):
    """Rows of three segments (24 + 20 + 12 tokens: longer than the 16-key
    window) with zero-count media, each route against JAX's same route:
    the T2V / T2A reads of a row with no visible key are zero on both (the
    rows attend everywhere and the output is masked by `has`); a padding
    row's T2T sees no key, where K1 gives zeros and the reference's
    attention averages V (ROADMAP Q3.3), as in JAX."""
    jp, tp = params
    samples = _samples([24, 20, 12, 22, 17, 9], seed=2)
    batch = tpacking.pack_batch(samples, CFG, seq_len=64, rows_per_batch=2)
    h, got = _packed_logits("port", tp, batch, use_flash)
    want = _packed_logits("jax", jp, batch, use_flash)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    for row in range(2):
        segs = batch["segment_ids"][row]
        for seg in set(segs[segs > 0].tolist()):
            where = np.flatnonzero(segs == seg)
            ids = torch.from_numpy(batch["input_ids"][row, where]).long()[None]
            n = len(where)
            alone, _ = tdattn.forward(tp, CFG, tdecoder.embed_tokens(tp["text"], ids, CFG.text),
                                      torch.ones((1, n), dtype=torch.bool),
                                      torch.arange(n)[None], use_flash=use_flash)
            torch.testing.assert_close(h[row, where], alone[0], atol=2e-5, rtol=2e-5)


# --- gradient accumulation -----------------------------------------------------

def _grads(params, rng):
    return jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 1e-2,
                        params)


@pytest.mark.parametrize("k", [2, 3])
def test_multisteps_matches_optax(params, k, tmp_path):
    """2k micro-steps on the same random gradients (the towers frozen, as
    the CLI's defaults have them); after micro-step k the state is saved,
    and a copy resumed from the save finishes the run equal."""
    jp, tp = params
    hp = dict(total_steps=6, learning_rate=1e-2, mm_rand_lr=2e-2)
    jtx = optax.MultiSteps(jopt.make_optimizer(jp, jopt.TrainHParams(**hp)), k)
    ttx = topt.make_optimizer(tp, topt.TrainHParams(**hp), grad_accum=k)
    assert isinstance(ttx, topt.MultiSteps) and ttx.labels == ttx.inner.labels
    j_params = jax.tree.map(jnp.asarray, jp)
    j_state = jtx.init(j_params)

    @jax.jit
    def j_step(g, state, p):
        upd, state = jtx.update(g, state, p)
        return jax.tree.map(lambda a, u: a + u, p, upd), state

    t_params = jax.tree.map(torch.clone, tp)
    t_state = ttx.init(t_params)
    assert set(t_state["acc"]) == {key for key, lab in ttx.labels.items() if lab != "frozen"}
    rng = np.random.default_rng(k)
    ckpt = tckpt.Checkpointer(str(tmp_path / "run"))
    resumed = None
    for step in range(2 * k):
        g = _grads(jp, rng)
        j_params, j_state = j_step(g, j_state, j_params)
        before = [p.clone() for _, _, p in topt.leaves(t_params)]
        tg = {key: torch.from_numpy(np.asarray(_jax_leaf(g, path)))
              for key, path, _ in topt.leaves(t_params) if ttx.labels[key] != "frozen"}
        ttx.apply(t_params, tg, t_state)
        if resumed is not None:
            ttx.apply(resumed[0], tg, resumed[1])
        emitted = step % k == k - 1
        assert t_state["mini_step"] == int(j_state.mini_step) == (step + 1) % k
        assert t_state["gradient_step"] == int(j_state.gradient_step) == (step + 1) // k
        host = jax.device_get(j_params)
        for (key, path, p), b in zip(topt.leaves(t_params), before):
            np.testing.assert_allclose(p.numpy(), np.asarray(_jax_leaf(host, path)),
                                       atol=1e-6, rtol=0, err_msg=f"{step} {key}")
            if not emitted or ttx.labels[key] == "frozen":
                assert torch.equal(p, b), key
        if step == k - 1:
            ckpt.save(step + 1, t_params, t_state)
            _, rp, rs = ckpt.restore()
            resumed = (rp, rs)
    for (key, _, a), (_, _, b) in zip(topt.leaves(t_params), topt.leaves(resumed[0])):
        assert torch.equal(a, b), key


# --- remat ---------------------------------------------------------------------

def _video_draws(key, batch, hw):
    """The draws JAX's loss_fn makes from `key` for a video batch (as
    test_torch_train_step's `_noise`)."""
    rngs = jax.random.split(key, 3)
    img = jax.random.split(rngs[0], 3)
    pool = CFG.mm_image_pool_size
    b, n = batch["images"].shape[:2]
    n_aud = batch["mels"].shape[1] * CFG.audio.max_source_positions // CFG.mm_audio_pool_size
    draws = {"img_h": jax.random.normal(img[0], (hw[0] // pool,)),
             "img_w": jax.random.normal(img[1], (hw[1] // pool,)),
             "img_t": jax.random.normal(img[2], (b, n)),
             "aud_t": jax.random.normal(rngs[1], (b, n_aud))}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def test_remat_modes_match(params):
    """Two train_steps (lr 1e-2; step 0's is 0) under each remat mode, and
    JAX's under its full remat."""
    jp, tp = params
    hp = dict(total_steps=4, learning_rate=1e-2, mm_rand_lr=2e-2)
    hw = jstep.make_batch_hw(CFG, 2)
    batches = [synthetic_batch(CFG, b=1, t=16, n_frames=2, n_windows=1, seed=s)
               for s in range(2)]
    jtx = jopt.make_optimizer(jp, jopt.TrainHParams(**hp))
    j_params = jax.tree.map(jnp.asarray, jp)
    j_state = jstep.opt_init(jtx, j_params)
    keys = [jax.random.PRNGKey(30 + i) for i in range(2)]
    for b, key in zip(batches, keys):
        j_params, j_state, j_loss = jstep.train_step(
            j_params, j_state, {k: jnp.asarray(v) for k, v in b.items()}, key, cfg=CFG,
            tx=jtx, hw=hw, remat=True, frozen=FROZEN)
    outs = {}
    for mode in (True, "dots", False):
        p = jax.tree.map(torch.clone, tp)
        tx = topt.make_optimizer(p, topt.TrainHParams(**hp))
        state = tstep.opt_init(tx, p)
        for b, key in zip(batches, keys):
            p, state, loss = tstep.train_step(p, state, to_device(b, "cpu"),
                                              _video_draws(key, b, hw), cfg=CFG, tx=tx,
                                              hw=hw, remat=mode, frozen=FROZEN)
        outs[mode] = (float(loss), p)
    host = jax.device_get(j_params)
    for mode in ("dots", False):
        np.testing.assert_allclose(outs[mode][0], outs[True][0], rtol=1e-6)
        for (key, _, a), (_, _, b) in zip(topt.leaves(outs[mode][1]),
                                          topt.leaves(outs[True][1])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{mode} {key}")
    assert abs(outs[True][0] - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    for key, path, p in topt.leaves(outs["dots"][1]):
        want = np.asarray(_jax_leaf(host, path))
        assert float(np.abs(p.numpy() - want).max()) <= 1e-4 * float(np.abs(want).max()) \
            + 1e-7, key


def test_dots_policy_keeps_only_weight_products(params):
    """One checkpointed layer under remat="dots": the policy sees the
    layer's ops and keeps exactly the mm / addmm outputs."""
    _, tp = params
    seen = []
    real = tdattn.dots_policy

    def recording(ctx, op, *args, **kwargs):
        decision = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append((str(op), decision.name))
        return decision

    b = to_device(synthetic_batch(CFG, b=1, t=8, n_frames=2, n_windows=1), "cpu")
    emb = tdecoder.embed_tokens(tp["text"], b["input_ids"], CFG.text).requires_grad_(True)
    pos = torch.arange(8)[None]
    tdattn.dots_policy = recording
    try:
        with torch.enable_grad():
            h, _ = tdattn.forward({**tp, "text": {**tp["text"],
                                                  "layers": tp["text"]["layers"][:1]}},
                                  CFG, emb, b["text_mask"], pos, remat="dots")
            h.sum().backward()
    finally:
        tdattn.dots_policy = real
    saved = {op for op, d in seen if d == "MUST_SAVE"}
    assert saved == {"aten.mm.default"} or saved == {"aten.mm.default", "aten.addmm.default"}
    assert any("bmm" in op and d == "PREFER_RECOMPUTE" for op, d in seen)
    assert emb.grad is not None and torch.isfinite(emb.grad).all()


# --- tensorboard ---------------------------------------------------------------

@pytest.fixture
def no_tensorflow(monkeypatch):
    """tensorboard writes and reads events without TensorFlow (its own
    stub); keeping TensorFlow out saves its import, ~15 s here."""
    if "tensorflow" not in sys.modules:
        monkeypatch.setitem(sys.modules, "tensorflow", None)


def test_tb_reporter_with_and_without_tensorboard(tmp_path, monkeypatch, capsys,
                                                  no_tensorflow):
    tb = TBReporter(str(tmp_path), enabled=True)
    assert tb.enabled
    tb.report({"loss": 2.5, "learning_rate": 1e-5, "skipped": None}, step=0)
    tb.report({"loss": 2.25}, step=1)
    tb.close()
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    acc = EventAccumulator(str(tmp_path / "runs"))
    acc.Reload()
    assert [e.step for e in acc.Scalars("train/loss")] == [0, 1]
    assert abs(acc.Scalars("train/learning_rate")[0].value - 1e-5) < 1e-9
    assert "train/skipped" not in acc.Tags()["scalars"]

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    off = TBReporter(str(tmp_path / "none"), enabled=True)
    assert not off.enabled and "tensorboard reporting disabled" in capsys.readouterr().out
    off.report({"loss": 1.0}, 0)
    off.close()
    assert not (tmp_path / "none").exists()


# --- the CLI -------------------------------------------------------------------

def _cli(out, *argv):
    tcli.main(["--tiny", "--output_dir", str(out), "--device", "cpu", "--dtype", "float32",
               *argv])
    with open(out / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_cli_image_anyres_ga_dots_profile_tensorboard(tmp_path, no_tensorflow):
    out = tmp_path / "img"
    lines = _cli(out, "--mm_input_type", "image", "--mm_image_aspect_ratio", "anyres",
                 "--dataset_type", "image-conv", "--data_path", "synthetic",
                 "--gradient_accumulation_steps", "2", "--remat", "dots",
                 "--profile_dir", str(out / "prof"), "--report_to", "tensorboard",
                 "--max_steps", "5")
    sched = topt.lr_schedule(topt.TrainHParams(total_steps=5), 1e-5)
    assert [m["learning_rate"] for m in lines] == [sched(s // 2) for s in range(5)]
    assert lines[1]["learning_rate"] == 0.0 and lines[2]["learning_rate"] > 0
    assert all(np.isfinite(m["loss"]) for m in lines)
    assert os.listdir(out / "prof") == ["trace_steps_2-4.json"]
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(out / "runs"))
    state = torch.load(out / "checkpoints" / "step_5.pt", weights_only=True)["opt_state"]
    assert state["mini_step"] == 1 and state["gradient_step"] == 2


def _conversations(tmp_path, n=6, image=False):
    from PIL import Image
    recs = []
    for i in range(n):
        rec = {"length": 10 + 3 * i,
               "conversations": [{"from": "human", "value": "tell me " + "more " * i},
                                 {"from": "gpt", "value": f"answer {i} " * (1 + i % 3)}]}
        if image and i % 3:
            Image.new("RGB", (60 + 20 * i, 40), (10 * i, 20, 30)).save(tmp_path / f"i{i}.png")
            rec["image"] = f"i{i}.png"
            rec["conversations"][0]["value"] = "<image>\n" + rec["conversations"][0]["value"]
        recs.append(rec)
    path = tmp_path / "data.json"
    path.write_text(json.dumps(recs))
    return str(path)


def test_cli_pack_and_group_by_length(tmp_path):
    data = _conversations(tmp_path)
    lines = _cli(tmp_path / "run", "--data_path", data, "--pack", "--pack_seq_len", "48",
                 "--group_by_length", "--per_device_train_batch_size", "2",
                 "--max_steps", "2", "--use_flash")
    assert [m["step"] for m in lines] == [0, 1]
    assert all(np.isfinite(m["loss"]) and m["tokens_per_sec"] > 0 for m in lines)


def test_cli_image_conv_dataset_anyres(tmp_path):
    data = _conversations(tmp_path, image=True)
    lines = _cli(tmp_path / "run", "--mm_input_type", "image",
                 "--mm_image_aspect_ratio", "anyres", "--dataset_type", "image-conv",
                 "--data_path", data, "--image_folder", str(tmp_path),
                 "--per_device_train_batch_size", "3", "--group_by_length",
                 "--max_steps", "2")
    assert len(lines) == 2 and all(np.isfinite(m["loss"]) for m in lines)


@pytest.mark.parametrize("argv,match", [
    (["--dataset_type", "image-conv"], "image-mode model"),
    (["--mm_input_type", "image", "--dataset_type", "image-conv", "--pack"], "--pack"),
    (["--mm_input_type", "image"], "video-mode model"),
])
def test_cli_mode_checks_raise(tmp_path, argv, match):
    with pytest.raises(ValueError, match=match):
        _cli(tmp_path, "--data_path", "synthetic", "--max_steps", "1", *argv)


@pytest.mark.parametrize("flag", [["--sp_mode", "ring", "--seq_parallel_size", "2"],
                                  ["--seq_parallel_size", "2"],
                                  ["--model_parallel_size", "2"]])
def test_cli_mesh_flags_raise(tmp_path, flag):
    """A seq mesh needs ranks (torchrun; tests/test_torch_parallel.py runs
    one); training under tensor parallelism is ROADMAP Q1.16c."""
    err, match = ((NotImplementedError, "Q1.16c") if "--model_parallel_size" in flag
                  else (SystemExit, "torchrun"))
    with pytest.raises(err, match=match):
        _cli(tmp_path, "--data_path", "synthetic", *flag)


def test_cli_has_every_reference_flag():
    src = open(os.path.join(ROOT, "vidi_tpu", "train", "train.py")).read()
    ref = set(re.findall(r'add_argument\(\s*"(--[a-z_]+)"', src))
    ours = {s for a in tcli.build_parser()._actions for s in a.option_strings
            if s.startswith("--")}
    assert len(ref) == 46 and ref <= ours
    assert ours - ref == {"--help", "--device", "--dtype"}
