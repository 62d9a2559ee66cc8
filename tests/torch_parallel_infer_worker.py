"""One rank of the multi-rank inference checks of
tests/test_torch_parallel_infer.py.

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_parallel_infer_worker.py OUT_DIR DATA SEQ MODEL [quant]

Builds the (DATA, SEQ, MODEL) gloo mesh (`core.mesh.make_mesh`), cuts the
tiny model's weights to this rank's shards (`sharding.shard_params`, the
"model" cut included), runs the serving path on this rank's query rows and
stream slice (under MODEL > 1 also on int8 / int4 weights loaded under
the mesh; with `quant` only those and the loads), and writes its results
to OUT_DIR/rank<r>.pt. It imports the port and never jax. The inputs come from numpy seeds (`generate_inputs`,
`query_rows`), which the test calls too.
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

NEW_TOKENS, EOS = 6, 1
SPEC_K, BEAMS = 3, 2


def tiny_cfg():
    from vidi_tpu_torch.core.config import DattnConfig
    return DattnConfig.tiny()


def generate_inputs(cfg, b: int = 2, t: int = 8, s: int = 32, seed: int = 1):
    """(ids [b,t], mask [b,t], img [b,s,d], img_mask [b,s]): the inputs of
    vidi_tpu's tests/test_parallel.py::test_generate_matches_under_seq_mesh."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.text.vocab_size, (b, t)).astype(np.int32)
    img = rng.standard_normal((b, s, cfg.text.hidden_size)).astype(np.float32)
    img_mask = rng.random((b, s)) > 0.2
    return ids, np.ones((b, t), bool), img, img_mask


def query_rows(cfg, q: int = 4, t: int = 8, seed: int = 5):
    """(ids [q,t], mask [q,t]) of q queries on one video (the shared-cache
    case), right-padded to different lengths."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.text.vocab_size, (q, t)).astype(np.int32)
    mask = np.ones((q, t), bool)
    for r in range(q):
        mask[r, t - r:] = False
    return ids, mask


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rows(mesh, n: int) -> slice:
    d, nd = mesh.coord("data"), mesh.shape["data"]
    return slice(d * n // nd, (d + 1) * n // nd)


def _cut(mesh, s: int) -> slice:
    size = s // mesh.shape["seq"]
    return slice(mesh.coord("seq") * size, (mesh.coord("seq") + 1) * size)


def step_logits(params, cfg, ids, mask, img, img_mask, flash: bool, **kw):
    """(step-0 logits, step-1 logits): the prefill's last-token logits and
    those of one decode step on its greedy token (the cached branch)."""
    from vidi_tpu_torch.infer import generate as g
    from vidi_tpu_torch.models import dattn, decoder
    from vidi_tpu_torch.parallel import sharding

    params = sharding.gathered(params, skip_layers=True)
    h, caches, lens = g._prefill(params, cfg, ids, mask, img, img_mask, None, None,
                                 max_new_tokens=2, mm_chunks=1, use_flash=flash, **kw)
    l0 = g._last_logits(params, cfg, h, lens)
    emb = decoder.embed_tokens(params["text"], l0.argmax(-1)[:, None], cfg.text)
    l1, _ = dattn.decode_step(params, cfg, emb, lens, caches, img_mask=img_mask,
                              use_flash=flash)
    return l0, l1


def generate_cases(mesh, params, cfg) -> dict:
    """Greedy generate (tokens, lengths, step logits) with the reference
    route and the kernel wrappers' route (their plain versions here) and
    with int8 caches, n-gram speculative decoding, beam search, and the
    prefill caches this rank holds, on its rows and image slice."""
    from vidi_tpu_torch.infer.generate import beam_generate, generate, speculative_generate
    from vidi_tpu_torch.models import dattn, decoder
    from vidi_tpu_torch.parallel import sharding

    ids, mask, img, img_mask = generate_inputs(cfg)
    rows, cut = _rows(mesh, ids.shape[0]), _cut(mesh, img.shape[1])
    args = (_t(ids[rows]).long(), _t(mask[rows]), _t(img[rows, cut]),
            _t(img_mask[rows, cut]))
    out = {}
    with torch.no_grad():
        for flash in (False, True):
            res = generate(params, cfg, *args, max_new_tokens=NEW_TOKENS, eos_id=EOS,
                           use_flash=flash, use_flash_decode=flash)
            l0, l1 = step_logits(params, cfg, *args, flash)
            out[f"gen/{int(flash)}"] = {"tokens": res.tokens, "lengths": res.lengths,
                                        "logits0": l0, "logits1": l1}
        res = generate(params, cfg, *args, max_new_tokens=NEW_TOKENS, eos_id=EOS,
                       quantize_caches=True)
        l0, l1 = step_logits(params, cfg, *args, False, quantize_caches=True)
        out["int8"] = {"tokens": res.tokens, "lengths": res.lengths, "logits0": l0,
                       "logits1": l1}
        spec = speculative_generate(params, cfg, None, None, *args,
                                    max_new_tokens=NEW_TOKENS, eos_id=EOS, spec_k=SPEC_K)
        out["spec"] = {"tokens": spec.tokens, "lengths": spec.lengths}
        beam = beam_generate(params, cfg, *args, max_new_tokens=NEW_TOKENS, eos_id=EOS,
                             num_beams=BEAMS)
        out["beam"] = {"tokens": beam.tokens, "lengths": beam.lengths}
        emb = decoder.embed_tokens(sharding.gathered(params["text"], skip_layers=True),
                                   args[0], cfg.text)
        pos = torch.cumsum(args[1].long(), 1) - 1
        _, caches = dattn.forward(params, cfg, emb, args[1], pos.clamp(min=0),
                                  img=args[2], img_mask=args[3], return_caches=True)
        out["caches"] = {k: getattr(caches, k) for k in ("text_k", "text_v", "img_k",
                                                         "img_v")}
    return out


def shared_cases(mesh, params, cfg) -> dict:
    """One video's caches prefilled once (`media_prefill` on its slice)
    serving this rank's rows of 4 queries, folded: generate's tokens and
    step logits with both routes, and on the reference route from the
    chunked prefill (`media_prefill_chunked`) of the same slice."""
    from vidi_tpu_torch.infer.generate import generate
    from vidi_tpu_torch.models import dattn

    _, _, img, img_mask = generate_inputs(cfg)
    ids, mask = query_rows(cfg)
    cut, rows = _cut(mesh, img.shape[1]), _rows(mesh, ids.shape[0])
    vid, vmask = _t(img[:1, cut]), _t(img_mask[:1, cut])
    out = {}
    with torch.no_grad():
        for flash in (False, True):
            media = dattn.media_prefill(params, cfg, img=vid, img_mask=vmask,
                                        use_flash=flash)
            qargs = (_t(ids[rows]).long(), _t(mask[rows]), None, vmask)
            res = generate(params, cfg, *qargs, media_caches=media, max_new_tokens=NEW_TOKENS,
                           eos_id=EOS, use_flash=flash, use_flash_decode=flash)
            l0, l1 = step_logits(params, cfg, *qargs, flash, media_caches=media)
            out[f"shared/{int(flash)}"] = {"tokens": res.tokens, "lengths": res.lengths,
                                           "logits0": l0, "logits1": l1}
        # the chunked stream prefill on the same slice (uneven chunks)
        media = dattn.media_prefill_chunked(params, cfg, img=vid, chunk_tokens=5)
        res = generate(params, cfg, *qargs, media_caches=media, max_new_tokens=NEW_TOKENS,
                       eos_id=EOS)
        l0, l1 = step_logits(params, cfg, *qargs, False, media_caches=media)
        out["shared/chunked"] = {"tokens": res.tokens, "lengths": res.lengths,
                                 "logits0": l0, "logits1": l1}
    return out


def stream_frames(cfg, n: int = 5, seed: int = 7):
    """n uint8 frames at the tower's size, and their chunks of 2 (the last
    short)."""
    rng = np.random.default_rng(seed)
    side = cfg.vision.image_size
    frames = rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)
    return frames, [frames[i:i + 2] for i in range(0, n, 2)]


def stream_cases(params, cfg) -> dict:
    """The streamed encode's image stream (chunks of 2 of 5 frames): this
    rank's slice of it under a seq mesh."""
    from vidi_tpu_torch.infer import pipeline

    frames, chunks = stream_frames(cfg)
    with torch.no_grad():
        img, mask = pipeline._encode_frame_chunks(params, cfg, chunks, len(frames))
    return {"stream": {"img": img, "mask": mask}}


LOAD_FLAGS = ("", "load_8bit", "load_4bit", "load_8bit_towers")


def load_cases(mesh, flags=LOAD_FLAGS) -> dict:
    """`load_model(random_weights="tiny", mesh=)`, plain and with each
    quantized format of `flags`: this rank's leaves (with whether each is
    stored K-major), and every leaf made whole again (`sharding.whole`) on
    rank 0. And a K-major matrix cut over the world and gathered back."""
    from vidi_tpu_torch.core.tree import leaves
    from vidi_tpu_torch.infer.loader import load_model
    from vidi_tpu_torch.parallel import sharding

    out = {}
    for flag in flags:
        params, _, _ = load_model(random_weights="tiny", dtype=torch.float32, device="cpu",
                                  mesh=mesh, **({flag: True} if flag else {}))
        local = {key: p.clone() for key, _, p in leaves(params)}
        kmajor = {key: sharding._kmajor(p) for key, _, p in leaves(params)}
        whole = {key: sharding.whole(p) for key, _, p in leaves(params)}
        out[f"load/{flag}"] = {"local": local, "kmajor": kmajor,
                               "whole": whole if mesh.rank == 0 else None}
    w = torch.arange(64 * 48, dtype=torch.int8).reshape(48, 64).t()  # K-major [64, 48]
    cut = sharding._cut_leaf(w, ((0, ("data", "seq", "model")), None), mesh, "cpu")
    back = sharding.all_gather_dim(cut, 0, mesh.group(("data", "seq", "model")), mesh.size)
    out["kmajor_cut"] = {"cut": cut.clone(), "cut_kmajor": sharding._kmajor(cut), "back": back,
                         "back_kmajor": sharding._kmajor(back)}
    return out


# the quantized serving cases: name -> (load_model flag, W8A8 rows, int8
# caches). W8A8 from 32 rows sends the stream's diagonal update (2 x 32
# rows, 2 x 16 a rank under seq 2: its folded o, the gated MLP and its
# down) through dynamic_qdense and keeps the prompt's 2 x 8 rows and the
# decode steps weight-only: W8A8 on the prompt's rows flips int8 codes
# that sit within an fp32 rounding of a boundary, by which vidi_tpu's and
# the port's fp32 ops differ (the hidden states then differ by 1.8e-3 of
# their largest, JAX run op by op, one process on each side).
QUANT_CASES = {"q8": ("load_8bit", None, False), "w8a8": ("load_8bit", 32, True),
               "q4": ("load_4bit", None, False)}


def quant_generate(params, cfg, args, w8a8, caches: bool, fault: bool = False) -> dict:
    """Greedy generate's tokens and the step logits under `w8a8`
    (`qz.w8a8_min_tokens`); with `fault` each rank's W8A8 products take
    their own row absmax (the planted fault), logits only."""
    from vidi_tpu_torch.infer import quantize as qz
    from vidi_tpu_torch.infer.generate import generate

    keep = qz.w8a8_min_tokens, qz.shared_row_amax
    qz.w8a8_min_tokens = w8a8
    if fault:
        qz.shared_row_amax = lambda x, wq: None
    try:
        with torch.no_grad():
            l0, l1 = step_logits(params, cfg, *args, False, quantize_caches=caches)
            if fault:
                return {"logits0": l0, "logits1": l1}
            res = generate(params, cfg, *args, max_new_tokens=NEW_TOKENS, eos_id=EOS,
                           quantize_caches=caches)
    finally:
        qz.w8a8_min_tokens, qz.shared_row_amax = keep
    return {"tokens": res.tokens, "lengths": res.lengths, "logits0": l0, "logits1": l1}


def quant_cases(mesh) -> dict:
    """`QUANT_CASES` on weights loaded quantized under the mesh (this
    rank's rows and image slice), the W8A8 one also with the planted
    fault; and the streamed encode through int8 towers."""
    from vidi_tpu_torch.infer.loader import load_model

    ids, mask, img, img_mask = generate_inputs(tiny_cfg())
    rows, cut = _rows(mesh, ids.shape[0]), _cut(mesh, img.shape[1])
    args = (_t(ids[rows]).long(), _t(mask[rows]), _t(img[rows, cut]),
            _t(img_mask[rows, cut]))
    out = {}
    for name, (flag, w8a8, caches) in QUANT_CASES.items():
        params, cfg, _ = load_model(random_weights="tiny", dtype=torch.float32, device="cpu",
                                    mesh=mesh, **{flag: True})
        out[f"quant/{name}"] = quant_generate(params, cfg, args, w8a8, caches)
        if name == "w8a8":
            out["quant/w8a8_fault"] = quant_generate(params, cfg, args, w8a8, caches, True)
    params, cfg, _ = load_model(random_weights="tiny", dtype=torch.float32, device="cpu",
                                mesh=mesh, load_8bit_towers=True)
    out["quant/towers"] = stream_cases(params, cfg)["stream"]
    return out


def main() -> None:
    out_dir, data, seq, model = sys.argv[1], *map(int, sys.argv[2:5])
    only_quant = sys.argv[5:] == ["quant"]
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore", category=FutureWarning)
    from vidi_tpu_torch.core.mesh import make_mesh, shutdown
    from vidi_tpu_torch.models import dattn
    from vidi_tpu_torch.parallel import sharding

    mesh = make_mesh(data=data, seq=seq, model=model, device_type="cpu")
    cfg = tiny_cfg()
    full = dattn.init_params(cfg, torch.float32, "cpu", 0)
    params = sharding.shard_params(full, mesh, kv_heads=cfg.text.num_kv_heads)
    del full
    res = {}
    with sharding.use_mesh(mesh):
        if not only_quant:
            res.update(generate_cases(mesh, params, cfg))
            res.update(shared_cases(mesh, params, cfg))
            res.update(stream_cases(params, cfg))
        if model > 1:
            res.update(quant_cases(mesh))
    if not only_quant:  # the quantized loads are checked at (1, 2, 2)
        res.update(load_cases(mesh, LOAD_FLAGS if model > 1 else LOAD_FLAGS[:1]))
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    shutdown(mesh)


if __name__ == "__main__":
    main()
