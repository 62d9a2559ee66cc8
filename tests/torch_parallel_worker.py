"""One rank of the multi-rank CPU checks of tests/test_torch_parallel.py.

    RANK=r WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_parallel_worker.py OUT_DIR DATA SEQ [MODEL]

Builds the (DATA, SEQ, MODEL) gloo mesh (`core.mesh.make_mesh`), runs every
case on this rank's rows and stream slice and writes its results to
OUT_DIR/rank<r>.pt; the test assembles the ranks' pieces. It imports the
port and never jax. The inputs come from numpy seeds (`attention_inputs`,
`forward_inputs`, `train_batch`, `image_batch`), which the test calls too;
under MODEL > 1 the position noise draws of the train steps are JAX's,
which the test writes to OUT_DIR/noise.pt before it starts the ranks.
"""
from __future__ import annotations

import os
import sys
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SCALE, CAP = 0.125, 50.0
MODES = ("gspmd", "ring", "ulysses")
TRAIN_STEPS = 2


def attention_inputs(hk: int = 4, masked_first: int = 0, seed: int = 0):
    """q [2,16,8,32], k / v [2,64,hk,32], mask [2,64] (the JAX test's
    `_qkv`); `masked_first` keys at the start masked in every row."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 16, 8, 32)).astype(np.float32)
    k = rng.standard_normal((2, 64, 4, 32)).astype(np.float32)[:, :, :hk]
    v = rng.standard_normal((2, 64, 4, 32)).astype(np.float32)[:, :, :hk]
    mask = rng.random((2, 64)) > 0.3
    mask[:, :masked_first] = False
    return q, np.ascontiguousarray(k), np.ascontiguousarray(v), mask


ATTN_CASES = {  # name -> (kv heads, masked keys at the start, softcap)
    "plain": (4, 0, CAP),
    "masked_shard": (4, 16, None),  # seq 4: the first shard has no key
    "gqa": (2, 0, CAP),             # seq 4 > 2 KV heads: Ulysses expands them
}


def tiny_cfg():
    import dataclasses
    from vidi_tpu_torch.core.config import DattnConfig
    return dataclasses.replace(DattnConfig.tiny(), loss_thres=0.1)


def forward_inputs(cfg, seed: int = 0):
    """(ids [2,8], img [2,32,d], img_mask [2,32]) of the JAX forward test."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.text.vocab_size, (2, 8)).astype(np.int32)
    img = rng.standard_normal((2, 32, cfg.text.hidden_size)).astype(np.float32)
    return ids, img, rng.random((2, 32)) > 0.2


def train_hparams():
    from vidi_tpu_torch.train.optimizer import TrainHParams
    return TrainHParams(learning_rate=1e-3, mm_rand_lr=1e-3, total_steps=4,
                        train_vis=True, train_aud=True)


def train_arrays(cfg, step: int):
    """(numpy global batch of a step, hw): two rows, 3 frames (an uneven cut
    over seq 2) of which row 1 has 2, one Whisper window (seq rank 1 holds
    only padding) of which row 1 has 0.6; row 1's text right-padded."""
    from vidi_tpu_torch.constants import IGNORE_INDEX
    from vidi_tpu_torch.train.data import synthetic_batch
    from vidi_tpu_torch.train.train_step import make_batch_hw

    b = synthetic_batch(cfg, b=2, t=24, n_frames=3, n_windows=1, seed=10 + step)
    b["frame_counts"][1] = 2
    b["audio_sizes"][1] = 1800
    b["text_mask"][1, 19:] = False
    b["labels"][1, 19:] = IGNORE_INDEX
    return b, make_batch_hw(cfg, int(b["frame_counts"].sum()))


def train_batch(cfg, step: int):
    """The global batch of a step (`train_arrays`) with its position noise
    draws (global)."""
    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.train.data import to_device

    b, hw = train_arrays(cfg, step)
    gen = torch.Generator().manual_seed(100 + step)
    noise = dattn.draw_pos_noise(cfg, 2, 3, 1, hw, gen)
    return to_device(b, "cpu"), noise, hw


# the (1, 2, 2) steps: as __graft_entry__.dryrun_multichip(4) runs JAX's
# (towers frozen), with the gradient clipped (the first step's global norm
# is 19.6)
MODEL_HP = dict(learning_rate=1e-3, mm_rand_lr=1e-3, total_steps=4, grad_clip=5.0)
MODEL_FROZEN = ("vision", "audio")


def model_batch_fn(noise):
    """batch_fn of `train_cases` taking each step's position noise from
    `noise` (JAX's draws, one dict a step)."""
    from vidi_tpu_torch.train.data import to_device

    def fn(cfg, step):
        b, hw = train_arrays(cfg, step)
        return to_device(b, "cpu"), noise[step], hw

    return fn


IMAGE_GRIDS = ((2, 2), (1, 3))  # (gw, gh): 5 and 4 tiles with the base view


def image_cfg():
    import dataclasses
    return dataclasses.replace(tiny_cfg(), mm_input_type="image",
                               mm_image_aspect_ratio="anyres")


def image_batch(cfg, step: int):
    """The global image-conv batch of a step: two anyres rows of grids
    `IMAGE_GRIDS`, padded to 5 tiles (an uneven cut of the tower's tiles
    over seq 2), with its per-sample position noise draws (global)."""
    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.train.data import synthetic_image_batch, to_device
    from vidi_tpu_torch.train.train_step import make_batch_hw

    b = synthetic_image_batch(cfg, b=2, t=24, seed=30 + step)
    rng = np.random.default_rng(40 + step)
    side = cfg.vision.image_size
    tiles = [1 + gw * gh for gw, gh in IMAGE_GRIDS]
    b["images"] = np.zeros((2, max(tiles), side, side, 3), np.float32)
    for i, k in enumerate(tiles):
        b["images"][i, :k] = rng.standard_normal((k, side, side, 3))
    b["grids"] = np.asarray(IMAGE_GRIDS, np.int32)
    gen = torch.Generator().manual_seed(200 + step)
    noise = dattn.draw_image_noise(cfg, 2, max(tiles), gen, per_sample=True)
    return to_device(b, "cpu"), noise, make_batch_hw(cfg, 1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def attention_cases(mesh) -> dict:
    """Each mode's output rows and gradients (dq this rank's share, dk / dv
    its slice) of sum(out^2), seeded with 1 / seq as the train step does."""
    from vidi_tpu_torch.parallel import ring_attention, ulysses
    fns = {"gspmd": ring_attention.gspmd_cross_attention,
           "ring": ring_attention.ring_cross_attention,
           "ulysses": ulysses.ulysses_cross_attention_sharded}
    sp, dr = mesh.shape["seq"], mesh.coord("data")
    nd = mesh.shape["data"]
    out = {}
    for case, (hk, masked, cap) in ATTN_CASES.items():
        q, k, v, mask = map(_t, attention_inputs(hk, masked))
        rows = slice(dr * 2 // nd, (dr + 1) * 2 // nd)
        s_loc = k.shape[1] // sp
        cut = slice(mesh.coord("seq") * s_loc, (mesh.coord("seq") + 1) * s_loc)
        for mode in MODES:
            for flash in (False, True):
                qq = q[rows].clone().requires_grad_(True)
                kk = k[rows, cut].clone().requires_grad_(True)
                vv = v[rows, cut].clone().requires_grad_(True)
                o = fns[mode](qq, kk, vv, mask[rows, cut], mesh, sm_scale=SCALE,
                              softcap=cap, use_flash=flash)
                gq, gk, gv = torch.autograd.grad((o.square().sum()) / sp, (qq, kk, vv))
                out[f"attn/{case}/{mode}/{int(flash)}"] = {
                    "out": o.detach(), "dq": gq, "dk": gk, "dv": gv}
    return out


def all_to_all_cases(mesh) -> dict:
    """seq_to_heads of this rank's slice of x [2,32,8,4], and its round trip."""
    from vidi_tpu_torch.parallel.ulysses import heads_to_seq, seq_to_heads
    group, sp, r = mesh.group(("seq",)), mesh.shape["seq"], mesh.coord("seq")
    x = _t(np.random.default_rng(0).standard_normal((2, 32, 8, 4)).astype(np.float32))
    piece = x[:, r * 32 // sp:(r + 1) * 32 // sp]
    heads = seq_to_heads(piece, group)
    return {"a2a": {"heads": heads, "back": heads_to_seq(heads, group)}}


def forward_cases(mesh, params, cfg) -> dict:
    """dattn.forward's hidden rows in each mode, on this rank's rows and
    slice of the image stream."""
    from vidi_tpu_torch.models import dattn, decoder
    ids, img, img_mask = forward_inputs(cfg)
    dr, nd = mesh.coord("data"), mesh.shape["data"]
    rows = slice(dr * 2 // nd, (dr + 1) * 2 // nd)
    s_loc = img.shape[1] // mesh.shape["seq"]
    cut = slice(mesh.coord("seq") * s_loc, (mesh.coord("seq") + 1) * s_loc)
    ids = _t(ids[rows]).long()
    mask = torch.ones(ids.shape, dtype=torch.bool)
    pos = torch.arange(ids.shape[1])[None].expand(ids.shape[0], -1)
    emb = decoder.embed_tokens(params["text"], ids, cfg.text)
    out = {}
    for mode in MODES:
        with torch.no_grad():
            h, _ = dattn.forward(params, cfg, emb, mask, pos, img=_t(img[rows, cut]),
                                 img_mask=_t(img_mask[rows, cut]), sp_mode=mode)
        out[f"fwd/{mode}"] = {"h": h}
    return out


def train_cases(mesh, cfg, batch_fn=train_batch, name: str = "train", hp=None,
                frozen=()) -> dict:
    """Two FSDP steps in each mode from the same init on the global batches
    of `batch_fn`: the step losses, the first step's gradients (this
    rank's slices, and their global squared norm as `sharding.sq_norm`
    counts it for the clip) and the parameters after both (this rank's
    slices), and every leaf's and moment's local / whole element counts. `hp`: the optimizer's
    TrainHParams (default `train_hparams()`); `frozen`: the step's."""
    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.parallel import sharding
    from vidi_tpu_torch.train.optimizer import leaves, make_optimizer
    from vidi_tpu_torch.train.train_step import train_step, value_and_grads

    out = {}
    for mode in MODES:
        full = dattn.init_params(cfg, torch.float32, "cpu", seed=0)
        params = sharding.shard_params(full, mesh, kv_heads=cfg.text.num_kv_heads)
        tx = make_optimizer(params, hp or train_hparams())
        state = tx.init(params)
        sizes = {key: (p.numel(), w.numel()) for (key, _, p), (_, _, w)
                 in zip(leaves(params), leaves(full))}
        sizes.update({f"mu/{key}": (m.numel(), sizes[key][1])
                      for key, m in state["mu"].items()})
        del full
        losses = []
        for step in range(TRAIN_STEPS):
            batch, noise, hw = batch_fn(cfg, step)
            batch, noise = sharding.data_rows(batch, 2), sharding.data_rows(noise, 2, 2)
            kw = dict(cfg=cfg, hw=hw, remat=True, sp_mode=mode, frozen=frozen)
            if step == 0:
                loss, grads = value_and_grads(params, batch, noise, labels=tx.labels, **kw)
                sq = sharding.sq_norm([(p, grads[key]) for key, _, p in leaves(params)
                                       if key in grads], mesh)
                tx.apply(params, grads, state)
            else:
                params, state, loss = train_step(params, state, batch, noise, tx=tx, **kw)
            losses.append(float(loss))
        out[f"{name}/{mode}"] = {
            "losses": torch.tensor(losses, dtype=torch.float64), "grads": grads,
            "sq_norm": float(sq),
            "params": {key: p.clone() for key, _, p in leaves(params)},
            "sizes": sizes}
    return out


def model_train_cases(mesh, cfg, noise) -> dict:
    """The (1, 2, 2) steps in each mode (`train_cases` with MODEL_HP, the
    towers frozen, JAX's noise draws), and the first step's gradients with
    the planted fault of `sharding.to_model`'s backward summing nothing."""
    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.parallel import sharding
    from vidi_tpu_torch.train.optimizer import TrainHParams, make_optimizer
    from vidi_tpu_torch.train.train_step import value_and_grads

    batch_fn = model_batch_fn(noise)
    out = train_cases(mesh, cfg, batch_fn, "train_model", TrainHParams(**MODEL_HP),
                      MODEL_FROZEN)
    params = sharding.shard_params(dattn.init_params(cfg, torch.float32, "cpu", seed=0), mesh,
                                   kv_heads=cfg.text.num_kv_heads)
    tx = make_optimizer(params, TrainHParams(**MODEL_HP))
    batch, step_noise, hw = batch_fn(cfg, 0)
    keep = sharding._ToModel.backward
    sharding._ToModel.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        _, grads = value_and_grads(params, batch, step_noise, labels=tx.labels, cfg=cfg,
                                   hw=hw, remat=True, frozen=MODEL_FROZEN)
    finally:
        sharding._ToModel.backward = keep
    out["train_model_fault"] = {"grads": grads}
    return out


def main() -> None:
    out_dir, data, seq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    model = int(sys.argv[4]) if len(sys.argv) > 4 else 1
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore", category=FutureWarning)
    from vidi_tpu_torch.core.mesh import make_mesh, shutdown
    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.parallel import sharding

    mesh = make_mesh(data=data, seq=seq, model=model, device_type="cpu")
    cfg = tiny_cfg()
    res = {}
    with sharding.use_mesh(mesh):
        if model > 1:
            noise = torch.load(os.path.join(out_dir, "noise.pt"))
            res.update(model_train_cases(mesh, cfg, noise))
        else:
            res.update(attention_cases(mesh))
            res.update(all_to_all_cases(mesh))
            res.update(forward_cases(mesh, dattn.init_params(cfg, torch.float32, "cpu", 0),
                                     cfg))
        if (data, seq) == (2, 2):
            res.update(train_cases(mesh, cfg))
            res.update(train_cases(mesh, image_cfg(), image_batch, "train_image"))
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    shutdown(mesh)


if __name__ == "__main__":
    main()
