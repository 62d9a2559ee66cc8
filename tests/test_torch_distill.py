"""The port's draft distillation (`train/distill.py`) against vidi_tpu's at
the tiny configuration, fp32 on the CPU, on the same weights (the port's
init, stacked into vidi_tpu's layout):

- `student_config`: the same configuration;
- teacher rollouts from the same prompt ids: the same greedy tokens;
- the teacher targets (atol 1e-6) and `distill_loss` (1e-5 relative);
- `optimizer.adamw` against `optax.adamw(lr)` on the same gradients:
  parameters within 1e-6 after each of three steps;
- three distillation steps in lockstep with JAX's `make_step`, each from
  the port's parameters of that step: losses within 1e-5 relative;
- three distillation steps run free against JAX's `make_step`, from
  vidi_tpu's own init (its jitted init_params): losses within 1e-5
  relative, parameters within 2% of the learning rate (Adam's first steps
  move a weight by up to lr whatever its gradient's size, so the
  gradients' rounding differences reach the parameters at a fraction of
  lr). From the port's init this free run parts by 1.02e-5 at step 1: a
  weight whose gradient is rounding noise (7e-10 here, 4.2e-9 in JAX, of a
  largest 9.4e-3) moves by 0.07 lr in one and 0.30 lr in the other
  (optax's eps is 1e-8), and the next loss of this small KL (0.015) moves
  with it. Run as a script, this file prints the evidence: per step, the
  port in fp32 and in float64 (its fp32 casts lifted) and JAX in fp32,
  each run free, and the two losses on the same parameters;
- `build_prompt_pool` on the same file: equal pools;
- `main` on the CPU: the exported draft reloads with `load_model` and, as
  `speculative_generate`'s draft, gives greedy's tokens.
"""
import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.infer.generate import generate as jgenerate
from vidi_tpu.media.text import ByteTokenizer as JTokenizer
from vidi_tpu.models import dattn as jdattn
from vidi_tpu.train import distill as jdistill
from vidi_tpu_torch.core.config import DattnConfig as TConfig
from vidi_tpu_torch.infer import generate as tgen
from vidi_tpu_torch.infer import loader as tloader
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.media.text import ByteTokenizer
from vidi_tpu_torch.models import dattn as tdattn
from vidi_tpu_torch.train import distill as tdistill
from vidi_tpu_torch.train import optimizer as topt

CFG, TCFG = DattnConfig.tiny(), TConfig.tiny()
STUDENT = dict(layers=2, hidden=32, heads=2, kv_heads=1, head_dim=16, ffn=64)
LR = 1e-2


def _stacked(tree):
    """The port's tree in vidi_tpu's layout (numpy leaves, layers stacked).
    Each leaf is a copy: `jnp.asarray` may alias a host buffer, and JAX's
    step still reads it, dispatched asynchronously, while the port's step
    updates its parameters in place."""
    if isinstance(tree, dict):
        return {k: jax.tree.map(lambda *xs: np.stack(xs), *map(_stacked, v))
                if k == "layers" and isinstance(v, list) else _stacked(v)
                for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _init(cfg, seed):
    """The port's init at `cfg` (a port config), in vidi_tpu's layout."""
    return _stacked(tdattn.init_params(cfg, torch.float32, "cpu", seed))


def _jax_init(cfg, seed):
    return jax.device_get(jax.jit(lambda k: jdattn.init_params(k, cfg, jnp.float32))(
        jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def models():
    """(jax teacher, port teacher, jax student, port student, student cfgs)."""
    jscfg = jdistill.student_config(CFG, **STUDENT)
    jt, js = _init(TCFG, 0), _init(tdistill.student_config(TCFG, **STUDENT), 1)
    return jt, params_from_jax(jt), js, params_from_jax(js), jscfg


@pytest.fixture(scope="module")
def jax_models():
    """`models` drawn by vidi_tpu's init."""
    jscfg = jdistill.student_config(CFG, **STUDENT)
    jt, js = _jax_init(CFG, 0), _jax_init(jscfg, 1)
    return jt, params_from_jax(jt), js, params_from_jax(js), jscfg


@pytest.fixture(scope="module")
def seqs(models):
    return _rollouts(models)


@pytest.fixture(scope="module")
def jax_seqs(jax_models):
    return _rollouts(jax_models)


def _rollouts(models):
    """Teacher rollouts of the same random prompts: (jax, port)."""
    jt, tt = models[:2]
    ids = np.random.default_rng(0).integers(3, CFG.text.vocab_size, (4, 8)).astype(np.int32)
    res = jgenerate(jt, CFG, jnp.asarray(ids), jnp.ones((4, 8), bool), max_new_tokens=8,
                    eos_id=-1)
    return (np.concatenate([ids, np.asarray(res.tokens)], axis=1),
            tdistill.rollout(tt, TCFG, torch.from_numpy(ids).long(), 8))


def _leaf(tree, path):
    node, layer = tree, None
    for key in path:
        if isinstance(key, int):
            layer = key
        else:
            node = node[key]
    return node if layer is None else node[layer]


def test_student_config_matches():
    got = tdistill.student_config(TCFG, **STUDENT)
    assert dataclasses.asdict(got) == dataclasses.asdict(jdistill.student_config(CFG, **STUDENT))


def test_rollouts_equal_jax_greedy(seqs):
    want, got = seqs
    assert got.shape == (4, 16) and np.array_equal(got.numpy(), want)


def test_targets_and_loss_match(models, seqs):
    jt, tt, js, ts, jscfg = models
    jseq, tseq = seqs
    soft_j = jdistill._teacher_targets(jt, CFG, jnp.asarray(jseq))
    soft_t = tdistill._teacher_targets(tt, TCFG, tseq)
    np.testing.assert_allclose(soft_t.numpy(), np.asarray(soft_j), atol=1e-6, rtol=0)
    want = float(jax.jit(jdistill.distill_loss, static_argnums=1)(js, jscfg, jnp.asarray(jseq),
                                                                  soft_j))
    got = float(tdistill.distill_loss(ts, tdistill.student_config(TCFG, **STUDENT), tseq,
                                      soft_t))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_adamw_matches_optax(models):
    _, _, js, ts, _ = models
    tx = optax.adamw(LR)
    state = tx.init(js)
    jp = jax.tree.map(jnp.asarray, js)
    tp = jax.tree.map(torch.clone, ts)
    ttx = topt.adamw(tp, LR)
    tstate = ttx.init(tp)
    assert set(tstate["mu"]) == {key for key, _, _ in topt.leaves(tp)}  # every leaf
    rng = np.random.default_rng(0)

    @jax.jit
    def j_step(g, state, p):
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state

    for _ in range(3):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), js)
        jp, state = j_step(g, state, jp)
        ttx.apply(tp, {key: torch.from_numpy(np.asarray(_leaf(g, path)))
                       for key, path, _ in topt.leaves(tp)}, tstate)
        host = jax.device_get(jp)
        for key, path, p in topt.leaves(tp):
            np.testing.assert_allclose(p.numpy(), np.asarray(_leaf(host, path)), atol=1e-6,
                                       rtol=0, err_msg=key)


def test_distill_steps_lockstep_on_port_init(models, seqs):
    jt, tt, js, ts, jscfg = models
    jseq, tseq = seqs
    scfg = tdistill.student_config(TCFG, **STUDENT)
    soft_j = jdistill._teacher_targets(jt, CFG, jnp.asarray(jseq))
    soft_t = tdistill._teacher_targets(tt, TCFG, tseq)
    tx = optax.adamw(LR)
    step = jdistill.make_step(jscfg, tx)
    state = tx.init(js)
    tp = jax.tree.map(torch.clone, ts)
    ttx = topt.adamw(tp, LR)
    tstate = ttx.init(tp)
    for _ in range(3):
        # JAX steps from the port's parameters of this step
        jp, state, j_loss = step(jax.tree.map(jnp.asarray, _stacked(tp)), state,
                                 jnp.asarray(jseq), soft_j)
        t_loss = tdistill.distill_step(tp, scfg, ttx, tstate, tseq, soft_t)
        assert abs(float(t_loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))


def test_distill_steps_match(jax_models, jax_seqs):
    jt, tt, js, ts, jscfg = jax_models
    jseq, tseq = jax_seqs
    scfg = tdistill.student_config(TCFG, **STUDENT)
    soft_j = jdistill._teacher_targets(jt, CFG, jnp.asarray(jseq))
    soft_t = tdistill._teacher_targets(tt, TCFG, tseq)
    tx = optax.adamw(LR)
    step = jdistill.make_step(jscfg, tx)
    jp, state = jax.tree.map(jnp.asarray, js), tx.init(js)
    tp = jax.tree.map(torch.clone, ts)
    ttx = topt.adamw(tp, LR)
    tstate = ttx.init(tp)
    for _ in range(3):
        jp, state, j_loss = step(jp, state, jnp.asarray(jseq), soft_j)
        t_loss = tdistill.distill_step(tp, scfg, ttx, tstate, tseq, soft_t)
        assert abs(float(t_loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    host = jax.device_get(jp)
    for key, path, p in topt.leaves(tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(_leaf(host, path)), atol=0.02 * LR,
                                   rtol=0, err_msg=key)


def test_prompt_pool_matches(tmp_path):
    path = tmp_path / "prompts.jsonl"
    lines = [json.dumps({"query": "where does the red car stop?"}), "",
             json.dumps({"text": "a door opens"}), "a raw line of text that runs long",
             json.dumps({"prompt": "x"}), json.dumps({"other": 1})]
    path.write_text("\n".join(lines) + "\n")
    for task in ("none", "tr"):
        want = jdistill.build_prompt_pool(str(path), JTokenizer(), CFG, prompt_len=24,
                                          task=task)
        got = tdistill.build_prompt_pool(str(path), ByteTokenizer(), TCFG, prompt_len=24,
                                         task=task)
        assert got.dtype == want.dtype and np.array_equal(got, want), task


def test_main_exports_a_draft_that_speculative_decoding_reloads(tmp_path, capsys):
    out = tmp_path / "draft"
    tdistill.main(["--random-weights", "tiny", "--export_dir", str(out), "--draft_layers",
                   "2", "--draft_hidden", "32", "--draft_heads", "2", "--draft_kv_heads", "1",
                   "--draft_head_dim", "16", "--draft_ffn", "64", "--steps", "3", "--batch",
                   "2", "--prompt_len", "8", "--gen_len", "8", "--resample_every", "2",
                   "--device", "cpu", "--dtype", "float32"])
    printed = capsys.readouterr().out
    assert "distill step 2: kl" in printed and f"draft exported to {out}" in printed
    draft, dcfg, _ = tloader.load_model(str(out), dtype=torch.float32, device="cpu")
    assert dcfg.text.num_layers == 2 and dcfg.text.hidden_size == 32
    teacher, cfg, _ = tloader.load_model(random_weights="tiny", dtype=torch.float32,
                                         device="cpu")
    ids = torch.from_numpy(np.random.default_rng(4).integers(3, 259, (2, 12))).long()
    mask = torch.ones_like(ids, dtype=torch.bool)
    greedy = tgen.generate(teacher, cfg, ids, mask, max_new_tokens=12, eos_id=-1)
    spec = tgen.speculative_generate(teacher, cfg, draft, dcfg, ids, mask, max_new_tokens=12,
                                     eos_id=-1, spec_k=3)
    assert torch.equal(spec.tokens, greedy.tokens)


def _free_losses(tt, ts, seq, dtype, lift_casts: bool = False):
    """The port's three distillation losses run free from (tt, ts) in
    `dtype`; `lift_casts` makes `.float()` keep float64 (the port's fp32
    casts), so the float64 run is float64 throughout."""
    orig = torch.Tensor.float
    if lift_casts:
        torch.Tensor.float = lambda x, *a, **k: x if x.dtype == torch.float64 else orig(x, *a, **k)
    try:
        cast = lambda tree: jax.tree.map(lambda x: x.to(dtype, copy=True), tree)  # noqa: E731
        t, st = cast(tt), cast(ts)
        soft = tdistill._teacher_targets(t, TCFG, seq)
        scfg = tdistill.student_config(TCFG, **STUDENT)
        ttx = topt.adamw(st, LR)
        state = ttx.init(st)
        return [float(tdistill.distill_step(st, scfg, ttx, state, seq, soft))
                for _ in range(3)]
    finally:
        torch.Tensor.float = orig


if __name__ == "__main__":
    # ROADMAP Q3.12's evidence (JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_distill.py)
    import conftest  # noqa: F401  (JAX on the CPU, highest matmul precision)
    jt, tt, js, ts, jscfg = models.__wrapped__()
    jseq, tseq = _rollouts((jt, tt, js, ts, jscfg))
    port32 = _free_losses(tt, ts, tseq, torch.float32)
    port64 = _free_losses(tt, ts, tseq, torch.float64, lift_casts=True)
    tx = optax.adamw(LR)
    step = jdistill.make_step(jscfg, tx)
    soft_j = jdistill._teacher_targets(jt, CFG, jnp.asarray(jseq))
    jp, state, jax32, same = jax.tree.map(jnp.asarray, js), tx.init(js), [], []
    for _ in range(3):
        before = jax.device_get(jp)
        jp, state, loss = step(jp, state, jnp.asarray(jseq), soft_j)
        jax32.append(float(loss))
        same.append(float(tdistill.distill_loss(
            params_from_jax(before), tdistill.student_config(TCFG, **STUDENT), tseq,
            tdistill._teacher_targets(tt, TCFG, tseq))))
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    print("step  port fp32        port fp64        jax fp32         port-jax (free)  "
          "port32-fp64  jax32-fp64  port-jax (same params)")
    for i in range(3):
        print(f"{i}     {port32[i]:.10f}  {port64[i]:.10f}  {jax32[i]:.10f}  "
              f"{rel(port32[i], jax32[i]):.2e}         {rel(port32[i], port64[i]):.2e}     "
              f"{rel(jax32[i], port64[i]):.2e}    {rel(same[i], jax32[i]):.2e}")
