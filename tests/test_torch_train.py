"""The port's loss, learning-rate schedule, parameter groups and optimizer
against vidi_tpu's (optax) on the same inputs, fp32 on the CPU.

Tolerance: 1e-6. The loss is one log-softmax and a mean in fp32; the
schedule is a closed form (JAX evaluates it in fp32, the port in fp64);
one AdamW update is a few elementwise fp32 operations per leaf. Each is
held to 1e-6 of its scale (the loss value, the peak learning rate, each
leaf's largest update).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.constants import IGNORE_INDEX
from vidi_tpu.core.config import DattnConfig
from vidi_tpu.train import losses as jlosses
from vidi_tpu.train import optimizer as jopt
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.train import losses as tlosses
from vidi_tpu_torch.train import optimizer as topt
from torch_init import port_init  # noqa: E402

TOL = 1e-6
CFG = DattnConfig.tiny()


def _jax_leaf(tree, path):
    """The JAX leaf for a port path: a per-layer leaf is a row of the
    stacked [L, ...] leaf (a label tree has one label for all rows)."""
    node, layer = tree, None
    for key in path:
        if isinstance(key, int):
            layer = key
        else:
            node = node[key]
    return node if layer is None or isinstance(node, str) else node[layer]


@pytest.fixture(scope="module")
def params():
    jp = jax.device_get(port_init(CFG, 0))
    return jp, params_from_jax(jp)


@pytest.mark.parametrize("thres,mode", [
    (None, "mean"), (2.0, "threshold"), (1e9, "all below")])
def test_shifted_cross_entropy(thres, mode):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 12, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (2, 12)).astype(np.int32)
    labels[0, :5] = IGNORE_INDEX
    labels[1, 9:] = IGNORE_INDEX
    want = float(jlosses.shifted_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                               thres))
    got = float(tlosses.shifted_cross_entropy(torch.from_numpy(logits),
                                              torch.from_numpy(labels), thres))
    assert abs(got - want) <= TOL * abs(want), (mode, got, want)


@pytest.mark.parametrize("total,ratio", [(1000, 0.03), (4, 0.03), (50, 0.2)])
def test_lr_schedule_matches_optax(total, ratio):
    hp = jopt.TrainHParams(total_steps=total, warmup_ratio=ratio)
    want_fn = jopt.lr_schedule(hp, 2e-5)
    got_fn = topt.lr_schedule(topt.TrainHParams(total_steps=total, warmup_ratio=ratio),
                              2e-5)
    for step in range(total + 2):
        assert abs(got_fn(step) - float(want_fn(step))) <= TOL * 2e-5, step


@pytest.mark.parametrize("flags", [
    {}, {"train_vis": True, "train_aud": True}, {"train_llm": False}])
def test_param_labels_match_leaf_for_leaf(params, flags):
    jp, tp = params
    want = jopt.param_labels(jp, jopt.TrainHParams(**flags))
    got = topt.param_labels(tp, topt.TrainHParams(**flags))
    for key, path, _ in topt.leaves(tp):
        assert got[key] == _jax_leaf(want, path), key
    # every JAX leaf is covered: a stacked leaf is L port leaves
    rows = jax.tree_util.tree_map_with_path(
        lambda p, x: x.shape[0] if any(getattr(k, "key", None) == "layers" for k in p)
        else 1, jp)
    assert len(got) == sum(jax.tree.leaves(rows))
    assert len(set(got.values())) > 2


@pytest.mark.parametrize("clip", [None, 0.5])
def test_one_update_matches_optax(params, clip):
    """Two updates (the schedule's step 0 has lr 0) on fixed grads over
    decay, nodecay and frozen groups, with and without clipping; each
    update against optax's, leaf for leaf."""
    jp, tp = params
    flags = dict(train_vis=True, total_steps=10, warmup_ratio=0.1, grad_clip=clip,
                 learning_rate=1e-3, mm_rand_lr=3e-3)
    jtx = jopt.make_optimizer(jp, jopt.TrainHParams(**flags))
    ttx = topt.make_optimizer(tp, topt.TrainHParams(**flags))
    rng = np.random.default_rng(1)
    j_state = jtx.init(jp)
    t_state = ttx.init(tp)
    seen = set()
    for step in range(2):
        grads = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1, jp)
        want, j_state = jtx.update(grads, j_state, jp)
        t_grads = {key: torch.from_numpy(np.array(_jax_leaf(grads, path)))
                   for key, path, _ in topt.leaves(tp)}
        got = ttx.update(t_grads, t_state, tp)
        for key, path, _ in topt.leaves(tp):
            label = ttx.labels[key]
            w = np.asarray(_jax_leaf(want, path))
            if label == "frozen":
                assert key not in got and not w.any()
                continue
            seen.add(label)
            scale = max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(got[key].numpy() - w).max())
            assert err <= TOL * scale, (key, err, scale)
    assert {"base_decay", "base_nodecay", "mm_rand_decay", "mm_rand_nodecay",
            "mm_vis_decay", "mm_vis_nodecay"} <= seen
    assert t_state["count"] == 2


def test_apply_writes_bf16_params_in_place():
    """`apply` casts each fp32 result back to the parameter's dtype in place
    and leaves frozen leaves untouched, with no state for them."""
    w = torch.linspace(-1, 1, 8).to(torch.bfloat16)
    tree = {"text": {"final_ln": w.clone()},
            "vision": {"patch_b": torch.ones(4, dtype=torch.bfloat16)}}
    tx = topt.make_optimizer(tree, topt.TrainHParams(total_steps=4, warmup_ratio=0.25,
                                                     learning_rate=0.1))
    state = tx.init(tree)
    ref = tree["text"]["final_ln"]
    for _ in range(2):
        tx.apply(tree, {"text/final_ln": torch.ones(8)}, state)
    assert tree["text"]["final_ln"] is ref and ref.dtype == torch.bfloat16
    assert (ref.float() < w.float()).all()  # stepped against the gradient
    assert torch.equal(tree["vision"]["patch_b"], torch.ones(4, dtype=torch.bfloat16))
    assert list(state["mu"]) == ["text/final_ln"]
