"""The port's image path (mm_input_type "image") against vidi_tpu's at the
tiny configuration, fp32 on the CPU, on the same weights (params_from_jax):

- `encode_images` in its three forms (plain, static anyres with one grid,
  anyres with per-sample grids), without position noise and with the
  port fed the draws JAX makes from its key (`draw_image_noise`'s shapes):
  atol = rtol = 2e-5; a sample whose image is all zero is masked and
  zero; a batch of mixed grids gives each sample the tokens it gets alone;
- an image-mode `train_step` (loss within 1e-5 relative; every parameter
  after the second step within rtol 1e-4, atol 1e-5), anyres tiles
  through the kernels' plain versions (`use_flash`);
- an image-mode checkpoint written by `save_pretrained` and read back by
  `load_model`, bit-equal, with the same tokens.
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.models import dattn as jdattn
from vidi_tpu.ops.pallas import flash_attention as jfa
from vidi_tpu.train import optimizer as jopt
from vidi_tpu.train import train_step as jstep
from vidi_tpu.train.data import synthetic_image_batch
from vidi_tpu_torch.infer import export as texport
from vidi_tpu_torch.infer import loader as tloader
from vidi_tpu_torch.models import dattn as tdattn
from vidi_tpu_torch.train import optimizer as topt
from vidi_tpu_torch.train import train_step as tstep
from vidi_tpu_torch.train.data import to_device

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_vidi7b import init_both  # noqa: E402

jfa.INTERPRET = True

CFG = dataclasses.replace(DattnConfig.tiny(), mm_input_type="image",
                          mm_image_aspect_ratio="anyres", loss_thres=0.1)
S = CFG.vision.num_patches_per_side
SIDE = CFG.vision.image_size
TOL = dict(atol=2e-5, rtol=2e-5)
GRIDS = ((2, 1), (1, 3))  # (gw, gh) of the two samples of a mixed batch
FROZEN = ("vision", "audio")


@pytest.fixture(scope="module")
def params():
    return init_both(CFG)


def _images(form: str, seed: int = 0):
    """(images, grid_shape, grids) of a two-sample batch (one for the
    static grid)."""
    rng = np.random.default_rng(seed)
    if form == "plain":
        return rng.standard_normal((2, SIDE, SIDE, 3)).astype(np.float32), None, None
    if form == "static":
        return rng.standard_normal((1, 3, SIDE, SIDE, 3)).astype(np.float32), (2, 1), None
    n = [1 + gw * gh for gw, gh in GRIDS]
    x = np.zeros((2, max(n), SIDE, SIDE, 3), np.float32)
    for i, k in enumerate(n):
        x[i, :k] = rng.standard_normal((k, SIDE, SIDE, 3))
    return x, None, np.asarray(GRIDS, np.int32)


def _jax_draws(key, form: str, b: int, n_tiles: int, grid_shape):
    """The normal draws JAX's encode_images makes from `key` (split 6:
    base h, base w, plane h, plane w), in `draw_image_noise`'s keys."""
    ks = jax.random.split(key, 6)
    shapes = {"img_h": (S,), "img_w": (S,)}
    if form == "static":
        shapes.update(plane_h=(grid_shape[1] * S,), plane_w=(grid_shape[0] * S,))
    elif form == "dynamic":
        shapes.update(plane_h=(b, n_tiles - 1, S), plane_w=(b, n_tiles - 1, S))
    names = ("img_h", "img_w", "plane_h", "plane_w")
    return {k: torch.from_numpy(np.array(jax.random.normal(ks[names.index(k)], shp)))
            for k, shp in shapes.items()}


@functools.partial(jax.jit, static_argnames="grid_shape")
def _jax_encode(params, x, grids, key, grid_shape):
    return jdattn.encode_images(params, CFG, x, grid_shape=grid_shape, grids=grids,
                                mm_chunks=2, pos_rng=key)


def _encode_both(params, x, grid_shape, grids, key=None, form="plain"):
    jp, tp = params
    j = _jax_encode(jp, jnp.asarray(x), None if grids is None else jnp.asarray(grids), key,
                    grid_shape)
    noise = None if key is None else _jax_draws(key, form, x.shape[0],
                                                x.shape[1] if x.ndim == 5 else 1,
                                                grid_shape)
    t = tdattn.encode_images(tp, CFG, torch.from_numpy(x), grid_shape=grid_shape,
                             grids=None if grids is None else torch.from_numpy(grids),
                             mm_chunks=2, pos_noise=noise)
    return j, t


@pytest.mark.parametrize("form,noisy", [("plain", True), ("static", True),
                                        ("dynamic", True), ("dynamic", False)])
def test_encode_images_matches(params, form, noisy):
    x, grid_shape, grids = _images(form)
    (jt, jm), (tt, tm) = _encode_both(params, x, grid_shape, grids,
                                      jax.random.PRNGKey(7) if noisy else None, form)
    assert tm.dtype == torch.bool and np.array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)


def test_draw_image_noise_shapes():
    gen = torch.Generator().manual_seed(0)
    plain = tdattn.draw_image_noise(CFG, 2, 1, gen)
    static = tdattn.draw_image_noise(CFG, 1, 3, gen, grid_shape=(2, 1))
    dyn = tdattn.draw_image_noise(CFG, 2, 4, gen, per_sample=True)
    assert {k: tuple(v.shape) for k, v in plain.items()} == {"img_h": (S,), "img_w": (S,)}
    assert {k: tuple(v.shape) for k, v in static.items()} == {
        "img_h": (S,), "img_w": (S,), "plane_h": (S,), "plane_w": (2 * S,)}
    assert {k: tuple(v.shape) for k, v in dyn.items()} == {
        "img_h": (S,), "img_w": (S,), "plane_h": (2, 3, S), "plane_w": (2, 3, S)}


@pytest.mark.parametrize("form", ["plain", "dynamic"])
def test_zero_image_carries_no_modality(params, form):
    x, grid_shape, grids = _images(form)
    x[1] = 0.0
    (jt, jm), (tt, tm) = _encode_both(params, x, grid_shape, grids)
    assert tm[0].any() and not tm[1].any()
    assert not tt[1].any()
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)


def test_mixed_grids_equal_each_sample_alone(params):
    """Per-sample grids: each sample's valid tokens are the ones the static
    path gives it alone, in the same order; the padding is masked."""
    _, tp = params
    x, _, grids = _images("dynamic")
    tok, mask = tdattn.encode_images(tp, CFG, torch.from_numpy(x),
                                     grids=torch.from_numpy(grids))
    for i, (gw, gh) in enumerate(GRIDS):
        n = 1 + gw * gh
        alone, m1 = tdattn.encode_images(tp, CFG, torch.from_numpy(x[i:i + 1, :n]),
                                         grid_shape=(gw, gh))
        k = alone.shape[1]
        assert int(mask[i].sum()) == k and bool(m1.all())
        torch.testing.assert_close(tok[i, :k], alone[0], **TOL)
        assert not tok[i, k:].any()


def _jax_leaf(tree, path):
    node, layer = tree, None
    for key in path:
        if isinstance(key, int):
            layer = key
        else:
            node = node[key]
    return node if layer is None else node[layer]


def test_image_train_step_matches(params):
    """Two train_steps (step 0's learning rate is 0) from the same weights
    and anyres batches of mixed grids, with the same position noise."""
    form = "dynamic"
    jp, tp = params
    tp = jax.tree.map(torch.clone, tp)
    flags = dict(total_steps=4, learning_rate=1e-2, mm_rand_lr=2e-2)
    jtx = jopt.make_optimizer(jp, jopt.TrainHParams(**flags))
    ttx = topt.make_optimizer(tp, topt.TrainHParams(**flags))
    j_params = jax.tree.map(jnp.asarray, jp)
    j_state, t_state = jstep.opt_init(jtx, j_params), tstep.opt_init(ttx, tp)
    for step in range(2):
        batch = synthetic_image_batch(CFG, b=2, t=16, seed=step)
        x, _, grids = _images(form, seed=10 + step)
        batch["images"] = x
        if grids is not None:
            batch["grids"] = grids
        key = jax.random.PRNGKey(20 + step)
        noise = _jax_draws(jax.random.split(key, 3)[0], form, 2,
                           x.shape[1] if x.ndim == 5 else 1, None)
        kw = dict(hw=(0, 0), mm_chunks=2, remat=True, frozen=FROZEN)
        j_params, j_state, j_loss = jstep.train_step(
            j_params, j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
            cfg=CFG, tx=jtx, **kw)
        tp, t_state, t_loss = tstep.train_step(tp, t_state, to_device(batch, "cpu"), noise,
                                               cfg=CFG, tx=ttx, use_flash=True, **kw)
        assert abs(float(t_loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    host = jax.device_get(j_params)
    moved = 0
    for key, path, p in topt.leaves(tp):
        want = np.asarray(_jax_leaf(host, path))
        np.testing.assert_allclose(p.numpy(), want, rtol=1e-4, atol=1e-5, err_msg=key)
        moved += not np.array_equal(want, np.asarray(_jax_leaf(jp, path)))
    assert moved > 0


def test_image_checkpoint_round_trip(params, tmp_path):
    """save_pretrained -> load_model: the image adapters come back bit-equal
    and give the same tokens."""
    _, tp = params
    out = texport.save_pretrained(tp, CFG, str(tmp_path / "img"))
    got, cfg, _ = tloader.load_model(out, dtype=torch.float32, device="cpu")
    assert cfg.mm_input_type == "image" and cfg.mm_image_aspect_ratio == "anyres"
    assert set(got["mm"]) == {"llm_norm", "projector", "norm", "pos_w", "pos_h"}
    want_mm = {key: x for key, _, x in topt.leaves(tp["mm"])}
    for key, _, x in topt.leaves(got["mm"]):
        assert torch.equal(x, want_mm.pop(key)), key
    assert not want_mm
    x, _, grids = _images("dynamic")
    want = tdattn.encode_images(tp, CFG, torch.from_numpy(x), grids=torch.from_numpy(grids))
    have = tdattn.encode_images(got, cfg, torch.from_numpy(x), grids=torch.from_numpy(grids))
    assert torch.equal(want[0], have[0]) and torch.equal(want[1], have[1])
