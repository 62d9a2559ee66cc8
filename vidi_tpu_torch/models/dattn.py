"""Dattn, the decomposed-attention multimodal decoder (port of
vidi_tpu/models/dattn.py: Vidi1.5's Gemma2 decoder with the v1.5 adapters,
and Vidi-7B's Mistral decoder with the v1 adapters).

Each decoder layer runs
  (1) T2T causal self attention over the short text stream,
  (2) T2V and T2A non-causal cross attention from the text queries into the
      video / audio token streams, sharing the layer's QKV / O weights,
  (3) the per-token "diagonal" update of each modality stream
      (stream += post_attn_norm(o_proj(v_proj(input_norm(stream)))), then
      the layer FFN), skipped when the stream's KV comes from a cache,
  (4) hidden = residual + post_attn_norm(t2t + t2v + t2a), then the FFN.

Differences of form from the JAX module: the `lax.scan` over layers is a
Python loop (each layer's sliding flag is a plain bool), the `lax.map`
chunking is a loop over chunks, and decode writes the text cache in place.
Training position noise comes as explicit standard-normal draws
(`draw_pos_noise`) instead of a JAX key; `remat=True` checkpoints each
layer (`torch.utils.checkpoint`), the counterpart of `jax.checkpoint`.
`use_flash` routes attention to the CUDA kernels (K1 for the T2T prefill,
the stream cross attention and several query tokens against a cache; K3
for one query token against a cache); without it the reference ops of
`ops/attention.py` run. Long video: `media_prefill` /
`media_prefill_chunked` compute a video's image / audio caches once (the
latter chunk by chunk through all layers, into preallocated buffers), and
`text_prefill_with_caches` / `decode_step` read them for any number of
query rows, batch-1 caches folded across the rows (`_xattn_block`).
`verify_step` (speculative decoding) runs a window of W tokens a row
against the caches in one pass, as W decode steps would.
Caches keep the decode-native [L,B,Hk,S,D] layout;
with `quantize_caches` the image / audio caches are per-token int8 dicts
({qi8 [L,B,Hk,S,D], scale [L,B,Hk,S,1]}) that decode reads through
`quantized_cache_cross_attention`. Layer weights may be int8 / int4 dicts
(`infer.quantize`); every projection goes through `qdot`.
All `*_mask` arguments are bool [B,S]; `*_counts` are int [B].

Under a mesh with seq > 1 (`parallel.sharding.use_mesh`) the modality
streams are cut over the seq group: the encoders encode this rank's
contiguous frames / audio windows (an uneven cut padded with masked
tokens; global positions) and return its slice of the stream, which stays
cut through every layer (the diagonal update is per token); the T2V / T2A
cross attention runs as `sp_mode` says ("gspmd", "ring" or "ulysses",
parallel/). The image / audio caches any entry point builds from such a
stream (`forward`, `media_prefill`, `media_prefill_chunked`,
`stream_chunk_caches`) are the rank's slice of S, and their masks the
slice's; every read of them (`_cache_attention`: decode, the text prefill
on shared caches, `verify_step`, folded rows, int8 caches) merges the
slices' (out, lse) over the seq group. The batch rows are this rank's
"data" rows. Layer weights sharded by `sharding.shard_params` are gathered
one layer at a time inside the layer (and again in remat's recompute), the
other leaves once at each entry point. Under a "model" cut of the text
layers (tensor parallelism, inference only) each rank runs its q / k / v
heads and its FFN columns, holds its KV heads of every cache, and the o /
down row partials are summed over the model group.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from vidi_tpu_torch.core.config import DattnConfig, TextConfig
from vidi_tpu_torch.infer import quantize as qz
from vidi_tpu_torch.infer.quantize import qdot
from vidi_tpu_torch.models import adapters, decoder, siglip, whisper
from vidi_tpu_torch.ops.attention import (cross_attention,
                                          quantized_cache_cross_attention,
                                          self_attention)
from vidi_tpu_torch.ops.norms import rms_norm, scaled_rms_norm
from vidi_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from vidi_tpu_torch.parallel import ring_attention, sharding, ulysses

Params = Dict


class Caches(NamedTuple):
    """KV caches in the decode-native [L,B,Hk,S,D] layout; img_* / aud_*
    are None when the modality is absent, and int8 dicts (see the module
    docstring) when quantized."""

    text_k: Optional[torch.Tensor]  # None in media-only caches (media_prefill)
    text_v: Optional[torch.Tensor]
    img_k: Optional[torch.Tensor]
    img_v: Optional[torch.Tensor]
    aud_k: Optional[torch.Tensor]
    aud_v: Optional[torch.Tensor]


def _layer_slice(cache, i: int):
    """Layer i of a [L,...] cache or of a quantized cache dict."""
    if isinstance(cache, dict):
        return {k: v[i] for k, v in cache.items()}
    return cache[i]


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_mm_params(cfg: DattnConfig, dtype, device, gen: torch.Generator) -> Params:
    """Adapters with the JAX init's shapes and scales: the image branch
    (mm_input_type "image": a projector straight off the tower, its norm
    and the h / w position MLPs; no pooling, no audio), or the video
    adapters of v1.5 (9B) or v1 (7B: a conv pool that keeps d_vis, an
    audio pool that keeps d_aud, projectors that lift both to d_llm)."""
    d_llm, d_vis, d_aud = cfg.text.hidden_size, cfg.vision.hidden_size, cfg.audio.d_model
    depth = cfg.mm_projector_depth
    if cfg.mm_input_type == "image":
        return {"llm_norm": adapters.init_rms_norm(d_llm, cfg.mm_std or 1.0, dtype, device),
                "projector": adapters.init_mlp_projector(gen, d_vis, d_llm, depth, dtype,
                                                         device),
                "norm": adapters.init_rms_norm(d_llm, 1.0, dtype, device),
                "pos_w": adapters.init_pos_embed(gen, d_llm, device),
                "pos_h": adapters.init_pos_embed(gen, d_llm, device)}
    v1 = cfg.mm_version == "v1"
    mm = {"llm_norm": adapters.init_rms_norm(d_llm, cfg.mm_std or 1.0, dtype, device)}
    if v1:
        mm["img_pool"] = adapters.init_conv2d_pool_v1(
            gen, d_vis, cfg.vision.num_patches_per_side, cfg.mm_image_pool_size,
            dtype, device)
    img_in = d_vis if v1 else d_vis * cfg.mm_image_pool_size**2
    aud_mid = d_aud if v1 else d_llm
    mm.update({
        "img_projector": adapters.init_mlp_projector(gen, img_in, d_llm, depth, dtype, device),
        "img_norm": adapters.init_rms_norm(d_llm, 1.0, dtype, device),
        "pos_w": adapters.init_pos_embed(gen, d_llm, device),
        "pos_h": adapters.init_pos_embed(gen, d_llm, device),
        "pos_t": adapters.init_pos_embed(gen, d_llm, device),
        "aud_pool": adapters.init_audio_pool(
            gen, d_aud, aud_mid, cfg.mm_audio_pool_size, dtype, device),
        "aud_projector": adapters.init_mlp_projector(
            gen, aud_mid, d_llm, depth, dtype, device),
        "aud_norm": adapters.init_rms_norm(d_llm, 1.0, dtype, device),
    })
    return mm


def init_params(cfg: DattnConfig, dtype, device, seed: int = 0,
                layer_fns: Optional[Dict] = None) -> Params:
    """Random weights drawn directly on `device` in `dtype` from one
    generator seeded with `seed`. `layer_fns` ({"text" | "vision" |
    "audio": fn}) maps each layer dict of those modules as it is drawn
    (the loader cuts it to a rank's shards there)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    fns = layer_fns or {}
    return {
        "text": decoder.init_params(cfg.text, dtype, device, gen, fns.get("text")),
        "vision": siglip.init_params(cfg.vision, dtype, device, gen, fns.get("vision")),
        "audio": whisper.init_params(cfg.audio, dtype, device, gen, fns.get("audio")),
        "mm": init_mm_params(cfg, dtype, device, gen),
    }


# ---------------------------------------------------------------------------
# Chunked execution (mm_splits equivalent)
# ---------------------------------------------------------------------------

def chunked_map(fn, x: torch.Tensor, num_chunks: int) -> torch.Tensor:
    """Apply `fn` to `num_chunks` leading-dim chunks in turn and concatenate,
    capping peak activation memory (the JAX `lax.map` form)."""
    n = x.shape[0]
    if num_chunks <= 1 or n <= 1:
        return fn(x)
    size = -(-n // min(num_chunks, n))
    return torch.cat([fn(x[i:i + size]) for i in range(0, n, size)], dim=0)


def _embed_scale(x: torch.Tensor, tcfg: TextConfig) -> torch.Tensor:
    """Gemma2's sqrt(d) scaling, with sqrt(d) rounded to x's dtype."""
    return x * torch.tensor(math.sqrt(tcfg.hidden_size), dtype=x.dtype)


# ---------------------------------------------------------------------------
# Modality encoders
# ---------------------------------------------------------------------------

def frame_side(cfg: DattnConfig, hw: Tuple[int, int]) -> Tuple[int, int]:
    """(h2, w2): a frame's token grid after the image pool. v1 resizes to
    a fixed side (mm_image_pool_size); v1.5 merges pool x pool cells of
    the budget size hw (space_to_depth)."""
    pool = cfg.mm_image_pool_size
    if cfg.mm_version == "v1":
        return pool, pool
    return hw[0] // pool, hw[1] // pool


def _draw(generator: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def draw_pos_noise(cfg: DattnConfig, b: int, n_frames: int, n_windows: int,
                   hw: Tuple[int, int], generator: torch.Generator) -> Dict:
    """Standard-normal draws for one training step's position noise, on the
    generator's device: {"img_h": [h2], "img_w": [w2], "img_t": [B,N],
    "aud_t": [B,A]}, (h2, w2) = `frame_side`, the lengths of the tables
    they jitter. One h and one w vector serve every frame chunk, as the
    JAX encoder's fixed key per chunk does."""
    h2, w2 = frame_side(cfg, hw)
    n_aud = n_windows * cfg.audio.max_source_positions // cfg.mm_audio_pool_size
    return {"img_h": _draw(generator, h2), "img_w": _draw(generator, w2),
            "img_t": _draw(generator, b, n_frames), "aud_t": _draw(generator, b, n_aud)}


def draw_image_noise(cfg: DattnConfig, b: int, n_tiles: int, generator: torch.Generator,
                     grid_shape: Optional[Tuple[int, int]] = None,
                     per_sample: bool = False) -> Dict:
    """Standard-normal draws for `encode_images`' position noise, of the
    JAX encoder's shapes: {"img_h": [s], "img_w": [s]} for the plain path
    and the anyres base view, plus the plane's {"plane_h": [gh*s],
    "plane_w": [gw*s]} (static anyres, `grid_shape` (gw, gh)) or
    {"plane_h": [B,P,s], "plane_w": [B,P,s]} (`per_sample` grids, P =
    n_tiles - 1 tiles a sample)."""
    s = cfg.vision.num_patches_per_side
    out = {"img_h": _draw(generator, s), "img_w": _draw(generator, s)}
    if per_sample:
        out.update(plane_h=_draw(generator, b, n_tiles - 1, s),
                   plane_w=_draw(generator, b, n_tiles - 1, s))
    elif grid_shape is not None:
        gw, gh = grid_shape
        out.update(plane_h=_draw(generator, gh * s), plane_w=_draw(generator, gw * s))
    return out


def _needs_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    if isinstance(tree, list):
        return any(_needs_grad(v) for v in tree)
    return tree.requires_grad


def _tower_grad(tower_params):
    """Autograd for a tower only when one of its params requires grad: a
    frozen (detached) tower runs under no_grad, as the reference runs frozen
    towers; JAX's stop_gradient on its params gives the same numbers."""
    return torch.set_grad_enabled(torch.is_grad_enabled() and _needs_grad(tower_params))


def encode_video_images(params: Params, cfg: DattnConfig, images: torch.Tensor,
                        frame_counts: torch.Tensor, hw: Tuple[int, int], *,
                        mm_chunks: int = 1, use_flash: bool = False,
                        pos_noise: Optional[Dict] = None):
    """images [B,N,H,W,3] (uint8 at image_size, or normalized float) ->
    (image features [B, N*h2*w2, d_llm], image mask [B, N*h2*w2]).
    `pos_noise` (training) holds the draws of `draw_pos_noise`. Under a
    seq mesh: this rank's ceil(N / seq) frames and their slice of the
    stream."""
    params = sharding.gathered(params, skip_layers=True)
    b, n, h_img, w_img, _ = images.shape
    d = cfg.text.hidden_size
    first, n_loc = sharding.seq_cut(n)
    if n_loc != n:
        images = sharding.take_padded(images, 1, first, n_loc)
    flat = images.reshape(b * n_loc, h_img, w_img, 3)
    noise = pos_noise or {}
    tok = chunked_map(lambda x: _frame_tokens(params, x, cfg, hw, use_flash, noise),
                      flat, mm_chunks)
    h2, w2 = tok.shape[1], tok.shape[2]
    return finish_video_tokens(params, cfg, tok.reshape(b, n_loc, h2, w2, d),
                               frame_counts, t_noise=noise.get("img_t"),
                               frames=(first, n))


def _frame_tokens(params, x, cfg: DattnConfig, hw, use_flash, noise=None):
    """Tower -> pool -> projector -> norm -> h/w positions for one chunk of
    frames [C,H,W,3] -> [C,h2,w2,d]. uint8 frames are normalized with the
    tower's own processor statistics. v1 pools with its learned conv and
    the align-corners resize to a fixed side (no token budget: `hw` is
    not read)."""
    if x.dtype == torch.uint8:
        from vidi_tpu_torch.ops.preprocess import preprocess_uint8, tower_stats
        mean, std = tower_stats(cfg.vision.arch)
        x = preprocess_uint8(x, cfg.vision.image_size, mean, std)
    mm = params["mm"]
    noise = noise or {}
    s = cfg.vision.num_patches_per_side
    d = cfg.text.hidden_size
    with _tower_grad(params["vision"]):
        feats = siglip.forward_features(params["vision"], x, cfg.vision,
                                        use_flash=use_flash)
    feats = feats.reshape(x.shape[0], s, s, cfg.vision.hidden_size)
    if cfg.mm_version == "v1":
        pooled = adapters.conv2d_pool_v1(mm["img_pool"], feats, cfg.mm_image_pool_size)
    else:
        pooled = adapters.conv2d_pool(feats, hw, cfg.mm_image_pool_size)
    t = adapters.mlp_projector(mm["img_projector"], pooled, cfg.mm_projector_depth)
    t = scaled_rms_norm(t, mm["img_norm"]["weight"], cfg.mm_rms_eps)
    h2, w2 = frame_side(cfg, hw)
    pe_h = adapters.pos_embed(mm["pos_h"], h2, cfg.mm_image_pool_size,
                              d, device=t.device, noise=noise.get("img_h"))
    pe_w = adapters.pos_embed(mm["pos_w"], w2, cfg.mm_image_pool_size,
                              d, device=t.device, noise=noise.get("img_w"))
    t = adapters.add_pos(t, pe_h, axis=1, eps=cfg.mm_rms_eps)
    return adapters.add_pos(t, pe_w, axis=2, eps=cfg.mm_rms_eps)


def frame_tokens_chunk(params: Params, x: torch.Tensor, cfg: DattnConfig,
                       hw: Tuple[int, int], use_flash: bool = False) -> torch.Tensor:
    """One chunk of a streamed encode: frames [C,H,W,3] (uint8 at any
    decode resolution, or normalized float) -> tokens [C,h2,w2,d], with no
    position noise (inference). The streamed pipeline concatenates the
    chunks and passes them to `finish_video_tokens` (JAX:
    `frame_tokens_chunk` and `finish_video_tokens_jit`)."""
    params = sharding.gathered(params, skip_layers=True)
    return _frame_tokens(params, x, cfg, hw, use_flash)


def finish_video_tokens(params: Params, cfg: DattnConfig, tok: torch.Tensor,
                        frame_counts: torch.Tensor, *,
                        t_noise: Optional[torch.Tensor] = None,
                        frames: Optional[Tuple[int, int]] = None):
    """Temporal positions + final norms + validity mask over per-frame
    tokens [B,N,h2,w2,d] -> ([B,N*h2*w2,d], mask). `t_noise` [B,N]:
    training position noise draws. `frames` (first, total): the N frames
    are frames first.. of a video of `total` (a seq rank's cut; frames
    past the end are padding)."""
    params = sharding.gathered(params, skip_layers=True)
    mm = params["mm"]
    d = cfg.text.hidden_size
    b, n, h2, w2, _ = tok.shape
    first, total = frames or (0, n)
    counts = frame_counts.to(tok.device)
    pe_t = rms_norm(_pos_embed_batch(mm["pos_t"], total, counts, cfg.mm_time_interval,
                                     d, t_noise), cfg.mm_rms_eps)
    if (first, total) != (0, n):
        pe_t = sharding.take_padded(pe_t, 1, first, n)
    tok = tok + pe_t[:, :, None, None, :].to(tok.dtype)
    tok = tok.reshape(b, n * h2 * w2, d)
    frame_valid = (first + torch.arange(n, device=tok.device))[None, :] < counts[:, None]
    mask = frame_valid.repeat_interleave(h2 * w2, dim=1) & (counts > 0)[:, None]
    tok = scaled_rms_norm(tok, mm["llm_norm"]["weight"], cfg.mm_rms_eps)
    return tok * mask[..., None], mask


def _pos_embed_batch(pe_params, length: int, counts: torch.Tensor,
                     n_anchors: int, d: int, noise=None) -> torch.Tensor:
    """Per-sample fractional positions normalized by each sample's true
    count -> [B, length, d] (fp32); `noise` [B, length] jitters them
    (training) when length > 1."""
    p = torch.arange(length, dtype=torch.float32, device=counts.device)[None, :]
    denom = torch.clamp(counts[:, None] - 1, min=1).float()
    if noise is not None and length > 1:
        p = adapters.jitter(p, noise, denom)
    return adapters.pos_mlp(pe_params, p / denom * (n_anchors - 1), d)


def encode_video_audios(params: Params, cfg: DattnConfig, mels: torch.Tensor,
                        audio_sizes: torch.Tensor, *, mm_chunks: int = 1,
                        use_flash: bool = False, pos_noise: Optional[Dict] = None):
    """mels [B,W,n_mels,3000] Whisper windows, audio_sizes [B] real mel
    frames -> (audio features [B, W*1500//pool, d_llm], audio mask).
    `pos_noise["aud_t"]` [B,A]: training position noise draws. Under a
    seq mesh: this rank's ceil(W / seq) windows and their slice of the
    stream (1500 % pool == 0, so a window pools alone)."""
    params = sharding.gathered(params, skip_layers=True)
    b, w, n_mels, t_mel = mels.shape
    mm = params["mm"]
    d = cfg.text.hidden_size
    per_window = cfg.audio.max_source_positions
    pool = cfg.mm_audio_pool_size
    first, w_loc = sharding.seq_cut(w)
    if w_loc != w:
        if per_window % pool:
            raise ValueError(f"a seq cut of the audio needs {per_window} % pool "
                             f"{pool} == 0")
        mels = sharding.take_padded(mels, 1, first, w_loc)
    flat = mels.reshape(b * w_loc, n_mels, t_mel)
    with _tower_grad(params["audio"]):
        enc = chunked_map(lambda x: whisper.forward(params["audio"], x, cfg.audio,
                                                    use_flash=use_flash),
                          flat, mm_chunks)
    enc = enc.reshape(b, w_loc * per_window, cfg.audio.d_model)
    ratio = cfg.audio.max_source_positions / cfg.audio.nb_max_frames
    sizes = audio_sizes.to(enc.device)
    enc_len = torch.floor(sizes.float() * ratio).to(torch.int32)
    enc_pos = first * per_window + torch.arange(enc.shape[1], device=enc.device)
    enc = enc * (enc_pos[None, :] < enc_len[:, None])[..., None]

    tok = adapters.audio_pool(mm["aud_pool"], enc, pool)
    tok_len = enc_len // pool
    tok = adapters.mlp_projector(mm["aud_projector"], tok, cfg.mm_projector_depth)
    tok = scaled_rms_norm(tok, mm["aud_norm"]["weight"], cfg.mm_rms_eps)
    a_first, a_total = first * per_window // pool, w * per_window // pool
    pe_t = rms_norm(_pos_embed_batch(mm["pos_t"], a_total, tok_len, cfg.mm_time_interval,
                                     d, (pos_noise or {}).get("aud_t")), cfg.mm_rms_eps)
    if w_loc != w:
        pe_t = sharding.take_padded(pe_t, 1, a_first, tok.shape[1])
    tok = tok + pe_t.to(tok.dtype)
    tok_pos = a_first + torch.arange(tok.shape[1], device=tok.device)
    mask = tok_pos[None, :] < tok_len[:, None]
    mask = mask & (tok_len > 0)[:, None]
    tok = scaled_rms_norm(tok, mm["llm_norm"]["weight"], cfg.mm_rms_eps)
    return tok * mask[..., None], mask


def encode_images(params: Params, cfg: DattnConfig, images: torch.Tensor, *,
                  grid_shape: Optional[Tuple[int, int]] = None,
                  grids: Optional[torch.Tensor] = None, mm_chunks: int = 1,
                  use_flash: bool = False, pos_noise: Optional[Dict] = None):
    """The image path (mm_input_type "image") -> (tokens [B,L,d_llm], mask
    [B,L]). images [B,H,W,3] (processor-normalized) take the plain path:
    projector -> norm -> h / w positions over the s x s grid. Anyres
    images [B,P,H,W,3] hold the base view at [:, 0] and the grid tiles
    after it; the tiles are laid out as one (gh*s, gw*s) plane, and both
    views are position-embedded with anchors s * max(grid_points), the
    base view without the norm. `grid_shape` (gw, gh) is one grid for the
    whole batch; `grids` [B,2] gives each sample its own (`_anyres_dynamic`).
    A sample whose image is all zero carries no modality. `pos_noise`
    (training) holds the draws of `draw_image_noise`. Under a seq mesh the
    tower's images are fanned out over the seq group (features
    all-gathered) and this rank's slice of the tokens is returned."""
    params = sharding.gathered(params, skip_layers=True)
    mm = params["mm"]
    s = cfg.vision.num_patches_per_side
    d = cfg.text.hidden_size
    anyres = images.dim() == 5
    b = images.shape[0]
    n_tiles = images.shape[1] if anyres else 1
    noise = pos_noise or {}
    flat = images.reshape(-1, *images.shape[-3:])
    with _tower_grad(params["vision"]):
        feats = sharding.fan_out(lambda part: chunked_map(lambda x: siglip.forward_features(
            params["vision"], x, cfg.vision, use_flash=use_flash), part, mm_chunks), flat)
    feats = adapters.mlp_projector(mm["projector"], feats, cfg.mm_projector_depth)
    dev = feats.device

    def add_pos(x, view, n_anchors):
        """Rows (axis 1) take pos_h, columns (axis 2) pos_w, with the noise
        draws of `view` ("img": the s x s grid, "plane": the tile plane)."""
        for axis, hw in ((1, "h"), (2, "w")):
            pe = adapters.pos_embed(mm[f"pos_{hw}"], x.shape[axis], n_anchors, d,
                                    device=dev, noise=noise.get(f"{view}_{hw}"))
            x = adapters.add_pos(x, pe, axis=axis, eps=cfg.mm_rms_eps)
        return x

    if not anyres:
        x = scaled_rms_norm(feats.reshape(b, s, s, d), mm["norm"]["weight"], cfg.mm_rms_eps)
        x = add_pos(x, "img", s)
        tok = x.reshape(b, s * s, d)
        mask = torch.ones((b, s * s), dtype=torch.bool, device=dev)
    else:
        anchors = s * max(max(p) for p in cfg.mm_image_grid_points)
        feats = feats.reshape(b, n_tiles, s, s, d)
        # the base view skips mm["norm"], as the reference does
        base = add_pos(feats[:, 0], "img", anchors)
        if grids is not None:
            tok, mask = _anyres_dynamic(mm, cfg, base, feats[:, 1:], grids.to(dev),
                                        anchors, noise)
        else:
            if cfg.mm_image_aspect_ratio != "anyres":
                raise ValueError("anyres images need mm_image_aspect_ratio='anyres'")
            gw, gh = grid_shape
            if 1 + gw * gh != n_tiles:
                raise ValueError(f"grid {grid_shape} does not make {n_tiles} tiles")
            tiles = feats[:, 1:].reshape(b, gh, gw, s, s, d).permute(0, 1, 3, 2, 4, 5)
            tiles = tiles.reshape(b, gh * s, gw * s, d)
            tiles = add_pos(tiles, "plane", anchors)
            tok = torch.cat([base.reshape(b, s * s, d),
                             tiles.reshape(b, gh * s * gw * s, d)], dim=1)
            mask = torch.ones(tok.shape[:2], dtype=torch.bool, device=dev)
    nonzero = images.reshape(b, -1).abs().sum(dim=-1) != 0
    mask = mask & nonzero.to(dev)[:, None]
    first, size = sharding.seq_cut(tok.shape[1])
    if size != tok.shape[1]:
        tok = sharding.take_padded(tok, 1, first, size)
        mask = sharding.take_padded(mask, 1, first, size)
    tok = scaled_rms_norm(tok, mm["llm_norm"]["weight"], cfg.mm_rms_eps)
    return tok * mask[..., None], mask


def _anyres_dynamic(mm, cfg: DattnConfig, base, tiles, grids, anchors: int, noise: Dict):
    """Anyres with per-sample grids (gw, gh) = grids[b]: tiles [B,P,s,s,d]
    padded to the batch's largest count. Tile t sits at (r, c) = (t // gw,
    t % gw); its row i / column j is plane row r*s + i / column c*s + j,
    where the position MLPs are evaluated pointwise (noise [B,P,s]:
    jittered by +-0.45 and clipped to [0, L - 1] per sample). The tokens
    are then permuted into the plane-row-major order of the static path,
    the base view first and padding tiles last, with a validity mask."""
    b, p_tiles, s, _, d = tiles.shape
    dev = tiles.device
    gw = torch.clamp(grids[:, 0].long(), min=1)
    gh = torch.clamp(grids[:, 1].long(), min=1)
    t_idx = torch.arange(p_tiles, device=dev)
    ii = torch.arange(s, device=dev)
    row_g = (t_idx[None, :] // gw[:, None])[..., None] * s + ii  # [B,P,s]
    col_g = (t_idx[None, :] % gw[:, None])[..., None] * s + ii
    lh = (gh * s).float()[:, None, None]
    lw = (gw * s).float()[:, None, None]
    rows, cols = row_g.float(), col_g.float()
    if "plane_h" in noise:
        rows = adapters.jitter(rows, noise["plane_h"], lh - 1.0)
        cols = adapters.jitter(cols, noise["plane_w"], lw - 1.0)
    frac_h = rows / torch.clamp(lh - 1.0, min=1.0) * (anchors - 1)
    frac_w = cols / torch.clamp(lw - 1.0, min=1.0) * (anchors - 1)
    pe_h = rms_norm(adapters.pos_mlp(mm["pos_h"], frac_h, d), cfg.mm_rms_eps)
    pe_w = rms_norm(adapters.pos_mlp(mm["pos_w"], frac_w, d), cfg.mm_rms_eps)
    tiles = tiles + pe_h[:, :, :, None, :].to(tiles.dtype)
    tiles = tiles + pe_w[:, :, None, :, :].to(tiles.dtype)

    l_base, l_max = s * s, (1 + p_tiles) * s * s
    n_valid = gw * gh
    dest = row_g[..., :, None] * (gw[:, None, None, None] * s) + col_g[..., None, :]
    pad_dest = l_max + torch.arange(p_tiles * s * s, device=dev).reshape(1, p_tiles, s, s)
    dest = torch.where((t_idx[None, :] < n_valid[:, None])[..., None, None],
                       l_base + dest, pad_dest)
    dest = torch.cat([torch.arange(l_base, device=dev).expand(b, l_base),
                      dest.reshape(b, -1)], dim=1)
    tok = torch.cat([base.reshape(b, l_base, d), tiles.reshape(b, -1, d)], dim=1)
    perm = torch.argsort(dest, dim=1)  # destinations are distinct
    tok = torch.gather(tok, 1, perm[..., None].expand(-1, -1, d))
    mask = torch.arange(l_max, device=dev)[None, :] < (l_base + n_valid * s * s)[:, None]
    return tok, mask


# ---------------------------------------------------------------------------
# Decoder layer
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, tcfg: TextConfig) -> torch.Tensor:
    """[..., n*D] -> [..., n, D]: n the heads this rank holds (all of them,
    or its slice under a "model" cut of the weights)."""
    return decoder.split_heads(x, -1, tcfg.head_dim)


def _qkv(lp, x, tcfg: TextConfig):
    """q, k, v on the heads of the rank's q_w / k_w / v_w columns."""
    return (_heads(qdot(x, lp["q_w"]), tcfg), _heads(qdot(x, lp["k_w"]), tcfg),
            _heads(qdot(x, lp["v_w"]), tcfg))


def _fold_o_w(o_w, tcfg: TextConfig):
    """[H*D, d] o_proj -> [Hk*D, d] with the g GQA row blocks of each KV head
    summed in fp32 and re-rounded once to o_w's dtype (repeat(v, g) @ o_w ==
    v @ folded o_w); a "model" slice of o_w (whole KV heads' rows) folds
    the same way. A quantized o_w is dequantized to fp32, folded and
    requantized in its own format."""
    g = tcfg.num_heads // tcfg.num_kv_heads
    hd = tcfg.head_dim

    def fold(wf):
        return wf.reshape(-1, g, hd, wf.shape[-1]).sum(1).reshape(-1, wf.shape[-1])

    if qz.is_quantized(o_w):
        if qz.QUANT4_KEY in o_w:
            return qz.quantize_weight4(fold(qz.dequantize_weight4(o_w, torch.float32)))
        return qz.quantize_weight(fold(qz.dequantize_weight(o_w, torch.float32)))
    return fold(o_w.float()).to(o_w.dtype)


def _fold_rows(q: torch.Tensor, kb: int) -> torch.Tensor:
    """[bq,tq,H,D] query rows -> [kb,(bq//kb)*tq,H,D]: the rows that share
    a cache entry laid end to end along the query axis."""
    return q.reshape(kb, (q.shape[0] // kb) * q.shape[1], *q.shape[2:])


def _unfold_rows(out: torch.Tensor, bq: int, tq: int) -> torch.Tensor:
    """The inverse of `_fold_rows` on the output [kb,(bq//kb)*tq,d]."""
    return out.reshape(bq, tq, out.shape[-1])


_SP_ATTENTION = {"gspmd": ring_attention.gspmd_cross_attention,
                 "ring": ring_attention.ring_cross_attention,
                 "ulysses": ulysses.ulysses_cross_attention_sharded}


def _xattn_block(lp, q, stream, stream_mask, tcfg: TextConfig, mm_chunks: int,
                 kv=None, use_flash: bool = False, sp_mode: str = "gspmd"):
    """T2V / T2A cross attention plus the diagonal stream update. Returns
    (xattn out [B,T,d], updated stream, (k, v)). With `kv` (the
    cache-native [Bc,Hk,S,D] layer slices: decode, or a text prefill against
    shared caches) the stream update is skipped; a cache batch Bc that
    divides B without equalling it serves B / Bc rows each (folded). Under a
    seq mesh `stream` (or the cache) is this rank's slice: the stream's
    attention runs as `sp_mode` says (`_SP_ATTENTION`), a cache read as
    `_cache_attention`. Under a "model" cut the out is this rank's row
    partial (its heads' o_w rows), summed by the caller."""
    mesh = sharding.get_mesh()
    cut = mesh is not None and mesh.shape["seq"] > 1
    has = stream_mask.any(dim=-1)  # [B] sample has this modality
    if cut:
        has = sharding.seq_any(has)
    # samples without the modality attend everywhere (finite), then zeroed;
    # this also keeps every row non-empty before K1 / K3 see it
    kv_valid = torch.where(has[:, None], stream_mask, torch.ones_like(stream_mask))
    if kv is not None:
        mk, mv = kv
        # shared media: a cache of batch kb serving bq = kb * G query rows
        # (rows [b*G, (b+1)*G) read cache b; kb == 1 is one video's caches
        # prefilled once, media_prefill) folds the rows into the query axis:
        # cross attention is non-causal, so rows stay independent and the
        # cache is read once, never replicated per row
        bq, tq = q.shape[0], q.shape[1]
        kb = (mk[qz.QUANT_KEY] if qz.is_quantized(mk) else mk).shape[0]
        folded = kb != bq and bq % kb == 0
        if folded:
            q = _fold_rows(q, kb)
        attn = _cache_attention(q, mk, mv, kv_valid, tcfg, use_flash, cut)
        out = qdot(decoder.merge_heads(attn), lp["o_w"]) * has[:, None, None]
        if folded:
            out = _unfold_rows(out, bq, tq)
        return out, stream, (mk, mv)

    mk, mv = _stream_kv(lp, stream, tcfg)
    if cut:
        attn = _SP_ATTENTION[sp_mode](q, mk, mv, kv_valid, mesh, sm_scale=tcfg.q_scale,
                                      softcap=tcfg.attn_softcap, use_flash=use_flash)
    elif use_flash:
        from vidi_tpu_torch.ops.cuda.flash_attention import flash_attention
        attn = flash_attention(q, mk, mv, kv_valid, tcfg.q_scale, False, None,
                               tcfg.attn_softcap)[0]
    else:
        attn = cross_attention(q, mk, mv, kv_valid=kv_valid, scale=tcfg.q_scale,
                               softcap=tcfg.attn_softcap)
    out = qdot(decoder.merge_heads(attn), lp["o_w"]) * has[:, None, None]

    o_w = _diag_o_w(lp, tcfg)
    s = stream.shape[1]
    if mm_chunks > 1 and s > mm_chunks:
        # chunk along the token axis (the update is per token)
        size = -(-s // mm_chunks)
        new = torch.empty_like(stream)
        for a in range(0, s, size):
            new[:, a:a + size] = _diag_update(lp, stream[:, a:a + size],
                                              mv[:, a:a + size], o_w, tcfg)
    else:
        new = _diag_update(lp, stream, mv, o_w, tcfg)
    return out, new, (mk, mv)


def _cache_attention(q, mk, mv, kv_valid, tcfg: TextConfig, use_flash: bool, cut: bool):
    """q [B,T,H,D] against one layer's cache [B,Hk,S,D] -> [B,T,H,D]: int8
    caches read as they are (ahead of K3, which reads bf16 caches); with
    `use_flash` K3 for one query token a row, K1 for several (a text
    prefill, or folded rows; it reads the transposed view in place); else
    the reference math. With `cut` (a seq mesh) the cache is this rank's
    slice of S: `cache_partial` gives its (out, lse) and
    `sharding.seq_merge` merges the seq group's partials in shard order."""
    if cut:
        return sharding.seq_merge(*cache_partial(q, mk, mv, kv_valid, tcfg, use_flash))
    scale, cap = tcfg.q_scale, tcfg.attn_softcap
    if qz.is_quantized(mk):
        return quantized_cache_cross_attention(q, mk, mv, kv_valid=kv_valid, scale=scale,
                                               softcap=cap)
    if use_flash and q.shape[1] == 1:
        from vidi_tpu_torch.ops.cuda.decode_attention import decode_attention
        return decode_attention(q[:, 0], mk, mv, kv_valid, scale, cap)[:, None]
    if use_flash:
        from vidi_tpu_torch.ops.cuda.flash_attention import flash_attention
        return flash_attention(q, mk.transpose(1, 2), mv.transpose(1, 2), kv_valid,
                               scale, False, None, cap)[0]
    return cross_attention(q, mk.transpose(1, 2), mv.transpose(1, 2),
                           kv_valid=kv_valid, scale=scale, softcap=cap)


def cache_partial(q, mk, mv, kv_valid, tcfg: TextConfig, use_flash: bool):
    """One shard's partial of `_cache_attention`, by the same routes: (out
    [B,T,H,D], lse [B,T,H] fp32), -inf where the shard has no visible key
    (K1's / K3's empty-row sentinel mapped, as `ring_attention.
    _local_attn_lse` maps K1's), so that such a shard weighs nothing in
    `ring_attention.merge`."""
    scale, cap = tcfg.q_scale, tcfg.attn_softcap
    if qz.is_quantized(mk):
        return quantized_cache_cross_attention(q, mk, mv, kv_valid=kv_valid, scale=scale,
                                               softcap=cap, return_lse=True)
    if use_flash and q.shape[1] == 1:
        from vidi_tpu_torch.ops.cuda.decode_attention import decode_attention
        from vidi_tpu_torch.ops.cuda.flash_attention import EMPTY_ROW_LSE
        out, lse = decode_attention(q[:, 0], mk, mv, kv_valid, scale, cap, return_lse=True)
        return out[:, None], torch.where(lse >= EMPTY_ROW_LSE, float("-inf"), lse)[:, None]
    return ring_attention._local_attn_lse(q, mk.transpose(1, 2), mv.transpose(1, 2),
                                          kv_valid, scale, cap, use_flash)


def _stream_kv(lp, stream, tcfg: TextConfig):
    """A stream's k / v [B,S,Hk,D] (its cache entries, on the rank's KV
    heads) from the input norm."""
    sn = decoder.norm(stream, lp["input_ln"], tcfg)
    return _heads(qdot(sn, lp["k_w"]), tcfg), _heads(qdot(sn, lp["v_w"]), tcfg)


def _diag_o_w(lp, tcfg: TextConfig):
    """The o_proj of the diagonal update: o_proj over GQA-repeated values ==
    v @ folded o_w."""
    g = tcfg.num_heads // tcfg.num_kv_heads
    return _fold_o_w(lp["o_w"], tcfg) if g > 1 else lp["o_w"]


def _diag_update(lp, stream, v, o_w, tcfg: TextConfig):
    """The stream's diagonal update, token by token: its values through
    `o_w` (`_diag_o_w`; under a "model" cut the rank's KV heads' rows, the
    partials summed), the post-attention norm, then the FFN."""
    dv = sharding.model_sum(qdot(decoder.merge_heads(v), o_w), lp["o_w"])
    if tcfg.double_norms:
        dv = decoder.norm(dv, lp["post_attn_ln"], tcfg)
    return decoder.ffn_block(lp, stream + dv, tcfg)


def _self_attn_switch(q, k, v, q_pos, kv_pos, kv_valid, tcfg: TextConfig,
                      is_sliding: bool, use_flash: bool = False, segs=None):
    """T2T self attention with the layer's mask: sliding window on sliding
    layers; `segs` [B,T] (packing segment ids) make it block-diagonal. The
    kernel masks by absolute index, which equals the position rule for
    right-padded contiguous prompts (build_prompt_batch) and, since segments
    are contiguous, for packed rows whose positions restart per segment."""
    window = tcfg.sliding_window if is_sliding else None
    if use_flash:
        from vidi_tpu_torch.ops.cuda.flash_attention import flash_attention
        return flash_attention(q, k, v, kv_valid, tcfg.q_scale, True, window,
                               tcfg.attn_softcap, q_segs=segs, kv_segs=segs)[0]
    return self_attention(q, k, v, q_positions=q_pos, kv_positions=kv_pos,
                          kv_valid=kv_valid, scale=tcfg.q_scale,
                          sliding_window=window, softcap=tcfg.attn_softcap,
                          q_segment_ids=segs, kv_segment_ids=segs)


def dattn_layer(lp: Params, is_sliding: bool, h, img, aud, *, tcfg: TextConfig,
                rope_cs, q_positions, kv_positions, text_mask, img_mask,
                aud_mask, mm_chunks: int = 1, text_kv=None, img_kv=None,
                aud_kv=None, write_at=None, use_flash: bool = False,
                text_segs=None, sp_mode: str = "gspmd"):
    """One Dattn decoder layer -> (h, img, aud, (text_kv, img_kv, aud_kv)).
    The layer's sharded weights are gathered here (`sharding.gathered`).
    Under a "model" cut the attention runs on the rank's heads (its text
    cache holds those) and the three o_proj partials are summed once
    (`sharding.model_sum`) before the post-attention norm; the FFN sums
    its own (`decoder.mlp`)."""
    lp = sharding.gathered(lp)
    res = h
    hn = decoder.norm(h, lp["input_ln"], tcfg)
    q, k, v = _qkv(lp, hn, tcfg)
    cos, sin = rope_cs
    q_r = apply_rope(q, cos, sin)
    k_r = apply_rope(k, cos, sin)

    if text_kv is not None:
        # decode / verify: write the step's K/V into the layer's text cache
        # IN PLACE (ck / cv are views of the [L,B,Hk,S,D] cache), one indexed
        # write for all rows: at slot write_at [B] for one token a row, at
        # slots write_at [B,W] for a window (slot == absolute position)
        ck, cv = text_kv
        w = h.shape[1]
        bidx = torch.arange(ck.shape[0], device=ck.device)
        if write_at.dim() == 1:
            ck[bidx, :, write_at] = k_r[:, 0]
            cv[bidx, :, write_at] = v[:, 0]
        else:
            ck[bidx[:, None], :, write_at] = k_r
            cv[bidx[:, None], :, write_at] = v
        new_text_kv = (ck, cv)
        if use_flash and w == 1:
            from vidi_tpu_torch.ops.cuda.decode_attention import decode_attention
            window = tcfg.sliding_window if is_sliding else None
            t2t = decode_attention(q_r[:, 0], ck, cv, text_mask, tcfg.q_scale,
                                   tcfg.attn_softcap, window,
                                   q_pos=q_positions[:, 0])[:, None]
        else:
            # a verify window (W > 1) takes the dense, position-masked path:
            # K1 masks causality by absolute index (query i of the window
            # would see keys 0..i only) and K3 takes one query token
            t2t = _self_attn_switch(q_r, ck.transpose(1, 2), cv.transpose(1, 2),
                                    q_positions, kv_positions, text_mask, tcfg,
                                    is_sliding)
    else:
        new_text_kv = (k_r, v)
        t2t = _self_attn_switch(q_r, k_r, v, q_positions, kv_positions,
                                text_mask, tcfg, is_sliding, use_flash=use_flash,
                                segs=text_segs)
    out = qdot(decoder.merge_heads(t2t), lp["o_w"])

    img_kv_out = aud_kv_out = None
    if img is not None or img_kv is not None:
        t2v, img, img_kv_out = _xattn_block(lp, q, img, img_mask, tcfg, mm_chunks,
                                            kv=img_kv, use_flash=use_flash,
                                            sp_mode=sp_mode)
        out = out + t2v
    if aud is not None or aud_kv is not None:
        t2a, aud, aud_kv_out = _xattn_block(lp, q, aud, aud_mask, tcfg, mm_chunks,
                                            kv=aud_kv, use_flash=use_flash,
                                            sp_mode=sp_mode)
        out = out + t2a
    out = sharding.model_sum(out, lp["o_w"])

    if tcfg.double_norms:
        h = res + decoder.norm(out, lp["post_attn_ln"], tcfg)
    else:
        h = res + out
    h = decoder.ffn_block(lp, h, tcfg)
    return h, img, aud, (new_text_kv, img_kv_out, aud_kv_out)


def _is_sliding(layer_idx: int, tcfg: TextConfig) -> bool:
    if tcfg.sliding_window is None:
        return False
    if tcfg.arch == "gemma2":
        return layer_idx % 2 == 0
    return True


# ---------------------------------------------------------------------------
# Full forward (prefill)
# ---------------------------------------------------------------------------

def _caches_ys(caches, quantize: bool = False):
    """One layer's cache outputs in the decode-native [B,Hk,S,D] layout
    (prefill computes [B,S,Hk,D]; these are transposed views), the image /
    audio ones quantized per token with `quantize`."""
    (tk, tv), img_kv, aud_kv = caches
    t = lambda x: None if x is None else x.transpose(1, 2)  # noqa: E731

    def mm(x):
        x = t(x)
        return qz.quantize_cache(x) if quantize and x is not None else x

    ik, iv = img_kv if img_kv is not None else (None, None)
    ak, av = aud_kv if aud_kv is not None else (None, None)
    return t(tk), t(tv), mm(ik), mm(iv), mm(ak), mm(av)


def _cache_buffer(y, n_layers: int, length: Optional[int] = None):
    """An empty [L, ...] buffer for one layer's cache output y [...,S,D] (a
    dict of buffers for a quantized one), `length` tokens long (default
    y's S)."""
    if y is None:
        return None
    if isinstance(y, dict):
        return {k: _cache_buffer(v, n_layers, length) for k, v in y.items()}
    shape = (*y.shape[:-2], length or y.shape[-2], y.shape[-1])
    return torch.empty((n_layers, *shape), dtype=y.dtype, device=y.device)


def _write_cache_slice(buf, i: int, piece, start: int) -> None:
    """Write one layer's cache slice `piece` [...,c,D] (or an int8 dict of
    such) into layer i of the [L,...,S,D] buffer at token `start`, in place;
    tokens past S (a padded tail chunk's) are dropped."""
    if isinstance(buf, dict):
        for k in buf:
            _write_cache_slice(buf[k], i, piece[k], start)
    elif buf is not None:
        n = min(piece.shape[-2], buf.shape[-2] - start)
        buf[i, ..., start:start + n, :].copy_(piece[..., :n, :])


# remat="dots": the counterpart of jax.checkpoint_policies.
# dots_with_no_batch_dims_saveable. A product of a [.., K] activation with a
# [K, N] weight reaches aten as mm (or addmm with a bias) after its leading
# dims are flattened; these outputs are kept. Batched products (bmm: the
# attention scores and P @ V of the plain route, the GQA einsums),
# elementwise ops, norms and the K1 autograd.Function (its kernel launch is
# not an aten op, so it reruns with its inputs) are recomputed.
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(dots_policy)


def forward(params: Params, cfg: DattnConfig, inputs_embeds, text_mask,
            positions, img=None, img_mask=None, aud=None, aud_mask=None, *,
            mm_chunks: int = 1, return_caches: bool = False,
            use_flash: bool = False, remat: bool = False, text_segs=None,
            quantize_caches: bool = False, sp_mode: str = "gspmd"):
    """Run all layers -> (final hidden [B,T,d] pre-lm_head, Caches or None).
    The caches are written layer by layer into preallocated [L,B,Hk,S,D]
    buffers; with `quantize_caches` the image / audio ones are quantized per
    token layer by layer, so only one layer's full-precision modality KV is
    ever live. `remat=True` recomputes each layer in the backward pass
    (non-reentrant checkpoint) instead of keeping its activations;
    `remat="dots"` keeps the layer's weight products (`DOTS_SAVED`) and
    recomputes the rest (`dots_policy`); `text_segs` [B,T] are packing
    segment ids for the T2T attention. `sp_mode` ("gspmd", "ring",
    "ulysses") picks the cross attention's plan under a seq mesh."""
    params = sharding.gathered(params, skip_layers=True)
    if remat not in (False, True, "dots"):
        raise ValueError(f"remat must be False, True or 'dots', got {remat!r}")
    if sp_mode not in _SP_ATTENTION:
        raise ValueError(f"sp_mode must be one of {sorted(_SP_ATTENTION)}, got {sp_mode!r}")
    tcfg = cfg.text
    h = inputs_embeds
    if tcfg.embed_scale:
        h = _embed_scale(h, tcfg)
        img = _embed_scale(img, tcfg) if img is not None else None
        aud = _embed_scale(aud, tcfg) if aud is not None else None
    rope_cs = rope_cos_sin(positions, tcfg.head_dim, tcfg.rope_theta)

    bufs = None
    layers = params["text"]["layers"]
    for i, lp in enumerate(layers):
        layer = functools.partial(
            dattn_layer, lp, _is_sliding(i, tcfg), tcfg=tcfg, rope_cs=rope_cs,
            q_positions=positions, kv_positions=positions, text_mask=text_mask,
            img_mask=img_mask, aud_mask=aud_mask, mm_chunks=mm_chunks,
            use_flash=use_flash, text_segs=text_segs, sp_mode=sp_mode)
        if remat and torch.is_grad_enabled():
            h, img, aud, caches = checkpoint(
                layer, h, img, aud, use_reentrant=False,
                **({"context_fn": _dots_context} if remat == "dots" else {}))
        else:
            h, img, aud, caches = layer(h, img, aud)
        if return_caches:
            ys = _caches_ys(caches, quantize_caches)
            if bufs is None:
                bufs = [_cache_buffer(y, len(layers)) for y in ys]
            for buf, y in zip(bufs, ys):
                _write_cache_slice(buf, i, y, 0)
    h = decoder.norm(h, params["text"]["final_ln"], tcfg)
    return h, (Caches(*bufs) if return_caches else None)


# ---------------------------------------------------------------------------
# Shared media caches (one video's stream caches serve many queries)
# ---------------------------------------------------------------------------

def media_prefill(params: Params, cfg: DattnConfig, img=None, img_mask=None,
                  aud=None, aud_mask=None, *, mm_chunks: int = 1,
                  use_flash: bool = False, quantize_caches: bool = False) -> Caches:
    """The modality streams alone -> per-layer image / audio caches (text
    caches None). The stream evolution reads only the stream (text attends
    into it, never the other way), so one video's caches, computed once,
    serve every query on it (`generate(media_caches=)`). Runs `forward`
    over one dummy text token and drops its text cache."""
    ref = img if img is not None else aud
    b, dev = ref.shape[0], ref.device
    _, caches = forward(
        params, cfg, ref.new_zeros((b, 1, cfg.text.hidden_size)),
        torch.ones((b, 1), dtype=torch.bool, device=dev),
        torch.zeros((b, 1), dtype=torch.long, device=dev),
        img=img, img_mask=img_mask, aud=aud, aud_mask=aud_mask,
        mm_chunks=mm_chunks, return_caches=True, use_flash=use_flash,
        quantize_caches=quantize_caches)
    return caches._replace(text_k=None, text_v=None)


def _stream_chunk_layers(params: Params, cfg: DattnConfig, chunk: torch.Tensor,
                         quantize_caches: bool):
    """Yield each layer's (k, v) cache slices [B,Hk,c,D] of one stream chunk
    [B,c,d] (raw adapter output, before the sqrt(d) scale), carrying only
    the chunk from layer to layer: input norm -> k / v projections (the
    cache entries) -> diagonal update through the folded o_w -> post-
    attention norm -> FFN, the stream branch of `_xattn_block` token by
    token (`_stream_kv`, `_diag_update`)."""
    tcfg = cfg.text
    s = _embed_scale(chunk, tcfg) if tcfg.embed_scale else chunk
    for lp in params["text"]["layers"]:
        lp = sharding.gathered(lp)
        k, v = _stream_kv(lp, s, tcfg)
        s = _diag_update(lp, s, v, _diag_o_w(lp, tcfg), tcfg)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        if quantize_caches:
            kt, vt = qz.quantize_cache(kt), qz.quantize_cache(vt)
        yield kt, vt


def stream_chunk_caches(params: Params, cfg: DattnConfig, chunk: torch.Tensor, *,
                        quantize_caches: bool = False):
    """One stream chunk [B,c,d] (raw adapter output) through all layers ->
    (k, v) cache slices [L,B,Hk,c,D] (per-token int8 dicts with
    `quantize_caches`). The stream update is per token, so chunks of a
    stream can run one after another with the same result."""
    params = sharding.gathered(params, skip_layers=True)
    n_layers = len(params["text"]["layers"])
    ks = vs = None
    for i, (k, v) in enumerate(_stream_chunk_layers(params, cfg, chunk, quantize_caches)):
        if ks is None:
            ks, vs = _cache_buffer(k, n_layers), _cache_buffer(v, n_layers)
        _write_cache_slice(ks, i, k, 0)
        _write_cache_slice(vs, i, v, 0)
    return ks, vs


def media_prefill_chunked(params: Params, cfg: DattnConfig, img=None, aud=None, *,
                          chunk_tokens: int = 32768,
                          quantize_caches: bool = False) -> Caches:
    """`media_prefill` with bounded peak memory: each stream runs in
    `chunk_tokens` slices through all layers (`_stream_chunk_layers`), each
    layer's slice written in place into [L,B,Hk,S,D] buffers of exactly S
    tokens (never gathered and concatenated, which would hold the caches
    twice). The tail chunk is padded to `chunk_tokens`, so every chunk has
    one shape and the allocator reuses one chunk's blocks; its padding's
    cache entries are not written. Peak memory: the caches plus one
    chunk's transients. Masks are not needed: a masked token's entries are
    computed and never attended."""
    params = sharding.gathered(params, skip_layers=True)
    n_layers = len(params["text"]["layers"])

    def run_stream(stream):
        s = stream.shape[1]
        c = min(chunk_tokens, s)
        ks = vs = None
        for start in range(0, s, c):
            piece = stream[:, start:start + c]
            if piece.shape[1] < c:
                piece = torch.nn.functional.pad(piece, (0, 0, 0, c - piece.shape[1]))
            for i, (k, v) in enumerate(
                    _stream_chunk_layers(params, cfg, piece, quantize_caches)):
                if ks is None:
                    ks, vs = _cache_buffer(k, n_layers, s), _cache_buffer(v, n_layers, s)
                _write_cache_slice(ks, i, k, start)
                _write_cache_slice(vs, i, v, start)
        return ks, vs

    ik, iv = run_stream(img) if img is not None else (None, None)
    ak, av = run_stream(aud) if aud is not None else (None, None)
    return Caches(None, None, ik, iv, ak, av)


def text_prefill_with_caches(params: Params, cfg: DattnConfig, inputs_embeds,
                             text_mask, positions, media: Caches, img_mask=None,
                             aud_mask=None, use_flash: bool = False):
    """The text side of B query rows against precomputed media caches (of
    batch 1 or B; their masks `img_mask` / `aud_mask` of the same batch):
    per layer the causal T2T prefill and the T2V / T2A reads of the caches
    (folded when their batch is 1), the stream work skipped. -> (final
    hidden [B,T,d], Caches with a fresh text cache [L,B,Hk,T,D] and the
    media caches passed through)."""
    params = sharding.gathered(params, skip_layers=True)
    tcfg = cfg.text
    h = _embed_scale(inputs_embeds, tcfg) if tcfg.embed_scale else inputs_embeds
    rope_cs = rope_cos_sin(positions, tcfg.head_dim, tcfg.rope_theta)
    has_img, has_aud = media.img_k is not None, media.aud_k is not None
    layers = params["text"]["layers"]
    tk = tv = None
    for i, lp in enumerate(layers):
        h, _, _, ((k_r, v), _, _) = dattn_layer(
            lp, _is_sliding(i, tcfg), h, None, None, tcfg=tcfg, rope_cs=rope_cs,
            q_positions=positions, kv_positions=positions, text_mask=text_mask,
            img_mask=img_mask, aud_mask=aud_mask,
            img_kv=((_layer_slice(media.img_k, i), _layer_slice(media.img_v, i))
                    if has_img else None),
            aud_kv=((_layer_slice(media.aud_k, i), _layer_slice(media.aud_v, i))
                    if has_aud else None),
            use_flash=use_flash)
        k_r, v = k_r.transpose(1, 2), v.transpose(1, 2)  # [B,Hk,T,D] views
        if tk is None:
            tk, tv = _cache_buffer(k_r, len(layers)), _cache_buffer(v, len(layers))
        _write_cache_slice(tk, i, k_r, 0)
        _write_cache_slice(tv, i, v, 0)
    h = decoder.norm(h, params["text"]["final_ln"], tcfg)
    return h, media._replace(text_k=tk, text_v=tv)


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _cached_layers(params: Params, cfg: DattnConfig, token_embeds, cur_len,
                   caches: Caches, img_mask, aud_mask, use_flash: bool):
    """W tokens a row [B,W,d] at positions cur_len + 0..W-1 through every
    layer against the caches, their K/V written into the text cache in
    place at those slots -> the final-normed hidden [B,W,d]. The text
    cache is valid below cur_len + W; causality inside the window rides
    on the positions."""
    tcfg = cfg.text
    h = _embed_scale(token_embeds, tcfg) if tcfg.embed_scale else token_embeds
    b, w = h.shape[:2]
    positions = (cur_len[:, None] if w == 1 else
                 cur_len[:, None] + torch.arange(w, dtype=cur_len.dtype, device=h.device))
    rope_cs = rope_cos_sin(positions, tcfg.head_dim, tcfg.rope_theta)
    s_max = caches.text_k.shape[3]
    kv_positions = torch.arange(s_max, dtype=positions.dtype,
                                device=h.device)[None].expand(b, s_max)
    text_valid = kv_positions < (cur_len + w)[:, None]
    has_img, has_aud = caches.img_k is not None, caches.aud_k is not None
    for i, lp in enumerate(params["text"]["layers"]):
        h, _, _, _ = dattn_layer(
            lp, _is_sliding(i, tcfg), h, None, None, tcfg=tcfg, rope_cs=rope_cs,
            q_positions=positions, kv_positions=kv_positions,
            text_mask=text_valid, img_mask=img_mask, aud_mask=aud_mask,
            text_kv=(caches.text_k[i], caches.text_v[i]),
            img_kv=((_layer_slice(caches.img_k, i), _layer_slice(caches.img_v, i))
                    if has_img else None),
            aud_kv=((_layer_slice(caches.aud_k, i), _layer_slice(caches.aud_v, i))
                    if has_aud else None),
            write_at=cur_len if w == 1 else positions, use_flash=use_flash)
    return decoder.norm(h, params["text"]["final_ln"], tcfg)


def decode_step(params: Params, cfg: DattnConfig, token_embeds, cur_len,
                caches: Caches, *, img_mask=None, aud_mask=None,
                use_flash: bool = False):
    """One greedy-decode step: token_embeds [B,1,d], cur_len [B] tokens
    already cached -> (logits [B,V] fp32, caches). The text cache is updated
    in place; the returned Caches is the same object."""
    params = sharding.gathered(params, skip_layers=True)
    h = _cached_layers(params, cfg, token_embeds, cur_len, caches, img_mask,
                       aud_mask, use_flash)
    return decoder.lm_logits(params["text"], h[:, 0], cfg.text), caches


def verify_step(params: Params, cfg: DattnConfig, token_embeds, cur_len,
                caches: Caches, *, img_mask=None, aud_mask=None,
                use_flash: bool = False):
    """The speculative verify pass: a window of W tokens a row
    (token_embeds [B,W,d]) at per-row offsets cur_len [B] in one forward
    -> (logits [B,W,V] fp32, position i predicting the token after window
    token i; caches). The window's K/V are written in place at cur_len ..
    cur_len + W - 1; slots past an accepted prefix hold stale entries that
    lie beyond the next pass's validity mask, so a rollback is not
    advancing cur_len. T2T runs dense (see `dattn_layer`); with
    `use_flash` the image / audio reads take K1 (W query tokens a row, or
    the rows folded onto a shared cache)."""
    params = sharding.gathered(params, skip_layers=True)
    h = _cached_layers(params, cfg, token_embeds, cur_len, caches, img_mask,
                       aud_mask, use_flash)
    return decoder.lm_logits(params["text"], h, cfg.text), caches
