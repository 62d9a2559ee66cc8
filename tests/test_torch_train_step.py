"""The port's `loss_fn` and `train_step` against vidi_tpu's at the tiny
configuration: the same weights (params_from_jax), the same numpy batch and
the same position noise (drawn from JAX's key tree as its encoders draw it),
fp32 on the CPU. With `use_flash` JAX runs its Pallas kernels interpreted
(the backward through K4's `_dq_kernel` / `_dkv_kernel`) and the port runs
the kernels' plain versions through their autograd Functions.

Tolerance: loss 1e-5 relative; every gradient leaf, and every parameter
after each step, within 1e-4 of that leaf's largest magnitude. Four Dattn
layers with three attentions and the stream FFNs, the towers and the
adapters compound the ops' fp32 differences (the forward alone agrees to
2e-4 absolute in test_torch_dattn). A leaf whose exact gradient is zero
(an attention key bias: softmax ignores a constant added to a whole row)
holds only rounding noise of order 1e-9 on both sides, so the limit has an
absolute floor of 1e-7.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.constants import IGNORE_INDEX
from vidi_tpu.core.config import DattnConfig
from vidi_tpu.ops.pallas import flash_attention as jfa
from vidi_tpu.ops.pallas import tower_attention as jta
from vidi_tpu.train import optimizer as jopt
from vidi_tpu.train import train_step as jstep
from vidi_tpu.train.data import synthetic_batch
from vidi_tpu_torch.infer.convert import params_from_jax
from vidi_tpu_torch.models import dattn as tdattn
from vidi_tpu_torch.train import optimizer as topt
from vidi_tpu_torch.train import train_step as tstep
from vidi_tpu_torch.train.data import to_device
from torch_init import port_init  # noqa: E402

jfa.INTERPRET = True
jta.INTERPRET = True

CFG = dataclasses.replace(DattnConfig.tiny(), loss_thres=0.1)
HW = jstep.make_batch_hw(CFG, 3)
LOSS_TOL, LEAF_TOL, LEAF_FLOOR = 1e-5, 1e-4, 1e-7
FROZEN = ("vision", "audio")


def _jax_leaf(tree, path):
    node, layer = tree, None
    for key in path:
        if isinstance(key, int):
            layer = key
        else:
            node = node[key]
    return node if layer is None else node[layer]


def _batch(packed: bool):
    """Two rows: 2 and 1 real frames, 1 and 0.6 Whisper windows; row 1's
    text is right-padded. The packed form holds three segments in row 0
    with positions restarting per segment."""
    b = synthetic_batch(CFG, b=2, t=24, n_frames=2, n_windows=1, seed=3)
    b["frame_counts"][1] = 1
    b["audio_sizes"][1] = 1800
    b["text_mask"][1, 19:] = False
    b["labels"][1, 19:] = IGNORE_INDEX
    if packed:
        segs = np.zeros((2, 24), np.int32)
        segs[0, :9], segs[0, 9:17], segs[0, 17:22] = 1, 2, 3
        segs[1, :19] = 1
        pos = np.zeros((2, 24), np.int32)
        for r in range(2):
            for sid in range(1, 4):
                idx = np.flatnonzero(segs[r] == sid)
                pos[r, idx] = np.arange(len(idx))
        b["text_mask"] = segs > 0
        b["labels"][~b["text_mask"]] = IGNORE_INDEX
        b["labels"][0, [8, 16]] = IGNORE_INDEX  # no prediction across a seam
        b["segment_ids"], b["positions"] = segs, pos
    return b


def _noise(rng, batch):
    """The draws JAX's loss_fn makes from `rng` (train_step.py:44,
    dattn.py:176 / :326): split(rng, 3); images split(rngs[0], 3) -> h, w,
    t; audio rngs[1]."""
    rngs = jax.random.split(rng, 3)
    img = jax.random.split(rngs[0], 3)
    pool = CFG.mm_image_pool_size
    b, n = batch["images"].shape[:2]
    n_aud = batch["mels"].shape[1] * CFG.audio.max_source_positions // CFG.mm_audio_pool_size
    draws = {"img_h": jax.random.normal(img[0], (HW[0] // pool,)),
             "img_w": jax.random.normal(img[1], (HW[1] // pool,)),
             "img_t": jax.random.normal(img[2], (b, n)),
             "aud_t": jax.random.normal(rngs[1], (b, n_aud))}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.fixture(scope="module")
def params():
    jp = jax.device_get(port_init(CFG, 0))
    return jp, params_from_jax(jp)


def _leaf_close(got, want, key):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    top = float(np.abs(want).max())
    assert err <= LEAF_TOL * top + LEAF_FLOOR, \
        f"{key}: max |err| {err:.3e} over {LEAF_TOL} x {top:.3e} + {LEAF_FLOOR}"


@pytest.mark.parametrize("use_flash,remat,frozen,packed", [
    (False, True, FROZEN, False),
    (True, True, FROZEN, False),
    (True, False, (), False),    # towers train: K2's Function backward
    (False, True, FROZEN, True),
    (True, True, FROZEN, True),  # packed rows through K1 / K4 with segment ids
])
def test_loss_and_grads_match(params, use_flash, remat, frozen, packed):
    jp, tp = params
    batch = _batch(packed)
    rng = jax.random.PRNGKey(11)
    kw = dict(hw=HW, mm_chunks=2, remat=remat, use_flash=use_flash, frozen=frozen)
    j_loss = jax.value_and_grad(lambda p, b, r: jstep.loss_fn(p, CFG, b, r, **kw))
    want_loss, want = jax.jit(j_loss)(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                                      rng)
    leaves = list(topt.leaves(tp))
    for _, _, p in leaves:
        p.requires_grad_(True)
    try:
        loss = tstep.loss_fn(tp, CFG, to_device(batch, "cpu"), _noise(rng, batch), **kw)
        got = torch.autograd.grad(loss, [p for _, _, p in leaves], allow_unused=True)
    finally:
        for _, _, p in leaves:
            p.requires_grad_(False)
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= LOSS_TOL * abs(float(want_loss))
    for (key, path, _), g in zip(leaves, got):
        w = np.asarray(_jax_leaf(want, path))
        assert g is None or path[0] not in frozen, key  # frozen: detached
        if g is None:  # frozen, or unused (SigLIP's last layer): JAX's is zero
            assert not w.any(), key
        else:
            _leaf_close(g, w, key)


def test_two_train_steps_match(params):
    """Two `train_step`s from the same weights: the loss of each and every
    parameter after each (step 0's learning rate is 0; step 1 moves the
    trainable leaves by ~lr)."""
    jp, tp = params
    tp = jax.tree.map(torch.clone, tp)
    flags = dict(total_steps=4, learning_rate=1e-2, mm_rand_lr=2e-2)
    jtx = jopt.make_optimizer(jp, jopt.TrainHParams(**flags))
    ttx = topt.make_optimizer(tp, topt.TrainHParams(**flags))
    j_params = jax.tree.map(jnp.asarray, jp)
    j_state = jstep.opt_init(jtx, j_params)
    t_state = tstep.opt_init(ttx, tp)
    kw = dict(hw=HW, mm_chunks=2, remat=True, use_flash=False, frozen=FROZEN)
    for step in range(2):
        batch = _batch(False)
        rng = jax.random.PRNGKey(100 + step)
        j_params, j_state, j_loss = jstep.train_step(
            j_params, j_state, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
            cfg=CFG, tx=jtx, **kw)
        tp, t_state, t_loss = tstep.train_step(
            tp, t_state, to_device(batch, "cpu"), _noise(rng, batch), cfg=CFG,
            tx=ttx, **kw)
        assert abs(float(t_loss) - float(j_loss)) <= LOSS_TOL * abs(float(j_loss))
        host = jax.device_get(j_params)
        moved = 0
        for key, path, p in topt.leaves(tp):
            want = _jax_leaf(host, path)
            _leaf_close(p, want, f"step {step} {key}")
            moved += step == 1 and not np.array_equal(np.asarray(want),
                                                       np.asarray(_jax_leaf(jp, path)))
        assert step == 0 or moved > 0
    assert t_state["count"] == 2


def test_policy_remat_is_not_ported(params):
    """remat="dots" (save the weight products, recompute the rest; ported
    since the name was given) gives full remat's loss and gradients
    bit for bit on the CPU; a mode that is neither raises."""
    _, tp = params
    batch = to_device(_batch(False), "cpu")
    got = {}
    for mode in (True, "dots"):
        leaves = [p for _, _, p in topt.leaves(tp) if p.dtype.is_floating_point]
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = tstep.loss_fn(tp, CFG, batch, None, hw=HW, mm_chunks=2, remat=mode,
                                 frozen=FROZEN)
            got[mode] = (loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True))
        finally:
            for p in leaves:
                p.requires_grad_(False)
    assert torch.equal(got[True][0], got["dots"][0])
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got[True][1], got["dots"][1]))
    with pytest.raises(ValueError, match="dots"):
        tdattn.forward(tp, CFG, None, None, None, remat="full")
