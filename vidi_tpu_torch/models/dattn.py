"""Dattn, the decomposed-attention multimodal decoder (port of
vidi_tpu/models/dattn.py, the v1.5 / Gemma2 inference path).

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
`use_flash` routes attention to the CUDA kernels (K1 for prefill T2T and
stream cross attention, K3 for decode); without it the reference ops of
`ops/attention.py` run. Caches keep the decode-native [L,B,Hk,S,D] layout.
All `*_mask` arguments are bool [B,S]; `*_counts` are int [B].
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from vidi_tpu.core.config import DattnConfig, TextConfig
from vidi_tpu_torch.models import adapters, decoder, siglip, whisper
from vidi_tpu_torch.ops.attention import cross_attention, self_attention
from vidi_tpu_torch.ops.norms import rms_norm, scaled_rms_norm
from vidi_tpu_torch.ops.rope import apply_rope, rope_cos_sin

Params = Dict

# SigLIP processor statistics (vidi_tpu/media/images.py, which imports PIL)
SIGLIP_MEAN = 0.5
SIGLIP_STD = 0.5


class Caches(NamedTuple):
    """KV caches in the decode-native [L,B,Hk,S,D] layout; img_* / aud_*
    are None when the modality is absent."""

    text_k: torch.Tensor
    text_v: torch.Tensor
    img_k: Optional[torch.Tensor]
    img_v: Optional[torch.Tensor]
    aud_k: Optional[torch.Tensor]
    aud_v: Optional[torch.Tensor]


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_mm_params(cfg: DattnConfig, dtype, device, gen: torch.Generator) -> Params:
    """v1.5 adapters with the JAX init's shapes and scales."""
    if cfg.mm_version != "v1.5" or cfg.mm_input_type != "video":
        raise NotImplementedError("only the v1.5 video adapters are ported")
    d_llm, d_vis, d_aud = cfg.text.hidden_size, cfg.vision.hidden_size, cfg.audio.d_model
    depth = cfg.mm_projector_depth
    pool2 = cfg.mm_image_pool_size**2
    return {
        "llm_norm": adapters.init_rms_norm(d_llm, cfg.mm_std or 1.0, dtype, device),
        "img_projector": adapters.init_mlp_projector(
            gen, d_vis * pool2, d_llm, depth, dtype, device),
        "img_norm": adapters.init_rms_norm(d_llm, 1.0, dtype, device),
        "pos_w": adapters.init_pos_embed(gen, d_llm, device),
        "pos_h": adapters.init_pos_embed(gen, d_llm, device),
        "pos_t": adapters.init_pos_embed(gen, d_llm, device),
        "aud_pool": adapters.init_audio_pool(
            gen, d_aud, d_llm, cfg.mm_audio_pool_size, dtype, device),
        "aud_projector": adapters.init_mlp_projector(
            gen, d_llm, d_llm, depth, dtype, device),
        "aud_norm": adapters.init_rms_norm(d_llm, 1.0, dtype, device),
    }


def init_params(cfg: DattnConfig, dtype, device, seed: int = 0) -> Params:
    """Random weights drawn directly on `device` in `dtype` from one
    generator seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "text": decoder.init_params(cfg.text, dtype, device, gen),
        "vision": siglip.init_params(cfg.vision, dtype, device, gen),
        "audio": whisper.init_params(cfg.audio, dtype, device, gen),
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

def draw_pos_noise(cfg: DattnConfig, b: int, n_frames: int, n_windows: int,
                   hw: Tuple[int, int], generator: torch.Generator) -> Dict:
    """Standard-normal draws for one training step's position noise, on the
    generator's device: {"img_h": [h2], "img_w": [w2], "img_t": [B,N],
    "aud_t": [B,A]}. One h and one w vector serve every frame chunk, as the
    JAX encoder's fixed key per chunk does."""
    pool = cfg.mm_image_pool_size
    n_aud = n_windows * cfg.audio.max_source_positions // cfg.mm_audio_pool_size

    def draw(*shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    return {"img_h": draw(hw[0] // pool), "img_w": draw(hw[1] // pool),
            "img_t": draw(b, n_frames), "aud_t": draw(b, n_aud)}


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
    `pos_noise` (training) holds the draws of `draw_pos_noise`."""
    b, n, h_img, w_img, _ = images.shape
    d = cfg.text.hidden_size
    flat = images.reshape(b * n, h_img, w_img, 3)
    noise = pos_noise or {}
    tok = chunked_map(lambda x: _frame_tokens(params, x, cfg, hw, use_flash, noise),
                      flat, mm_chunks)
    h2, w2 = tok.shape[1], tok.shape[2]
    return finish_video_tokens(params, cfg, tok.reshape(b, n, h2, w2, d),
                               frame_counts, t_noise=noise.get("img_t"))


def _frame_tokens(params, x, cfg: DattnConfig, hw, use_flash, noise=None):
    """Tower -> pool -> projector -> norm -> h/w positions for one chunk of
    frames [C,H,W,3] -> [C,h2,w2,d]."""
    if x.dtype == torch.uint8:
        from vidi_tpu_torch.ops.preprocess import preprocess_uint8
        x = preprocess_uint8(x, cfg.vision.image_size, SIGLIP_MEAN, SIGLIP_STD)
    mm = params["mm"]
    noise = noise or {}
    s = cfg.vision.num_patches_per_side
    d = cfg.text.hidden_size
    with _tower_grad(params["vision"]):
        feats = siglip.forward_features(params["vision"], x, cfg.vision,
                                        use_flash=use_flash)
    feats = feats.reshape(x.shape[0], s, s, cfg.vision.hidden_size)
    pooled = adapters.conv2d_pool(feats, hw, cfg.mm_image_pool_size)
    t = adapters.mlp_projector(mm["img_projector"], pooled, cfg.mm_projector_depth)
    t = scaled_rms_norm(t, mm["img_norm"]["weight"], cfg.mm_rms_eps)
    pe_h = adapters.pos_embed(mm["pos_h"], t.shape[1], cfg.mm_image_pool_size,
                              d, device=t.device, noise=noise.get("img_h"))
    pe_w = adapters.pos_embed(mm["pos_w"], t.shape[2], cfg.mm_image_pool_size,
                              d, device=t.device, noise=noise.get("img_w"))
    t = adapters.add_pos(t, pe_h, axis=1, eps=cfg.mm_rms_eps)
    return adapters.add_pos(t, pe_w, axis=2, eps=cfg.mm_rms_eps)


def finish_video_tokens(params: Params, cfg: DattnConfig, tok: torch.Tensor,
                        frame_counts: torch.Tensor, *,
                        t_noise: Optional[torch.Tensor] = None):
    """Temporal positions + final norms + validity mask over per-frame
    tokens [B,N,h2,w2,d] -> ([B,N*h2*w2,d], mask). `t_noise` [B,N]:
    training position noise draws."""
    mm = params["mm"]
    d = cfg.text.hidden_size
    b, n, h2, w2, _ = tok.shape
    counts = frame_counts.to(tok.device)
    pe_t = _pos_embed_batch(mm["pos_t"], n, counts, cfg.mm_time_interval, d,
                            t_noise)
    tok = tok + rms_norm(pe_t, cfg.mm_rms_eps)[:, :, None, None, :].to(tok.dtype)
    tok = tok.reshape(b, n * h2 * w2, d)
    frame_valid = torch.arange(n, device=tok.device)[None, :] < counts[:, None]
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
    `pos_noise["aud_t"]` [B,A]: training position noise draws."""
    b, w, n_mels, t_mel = mels.shape
    mm = params["mm"]
    d = cfg.text.hidden_size
    flat = mels.reshape(b * w, n_mels, t_mel)
    with _tower_grad(params["audio"]):
        enc = chunked_map(lambda x: whisper.forward(params["audio"], x, cfg.audio,
                                                    use_flash=use_flash),
                          flat, mm_chunks)
    enc = enc.reshape(b, w * cfg.audio.max_source_positions, cfg.audio.d_model)
    ratio = cfg.audio.max_source_positions / cfg.audio.nb_max_frames
    sizes = audio_sizes.to(enc.device)
    enc_len = torch.floor(sizes.float() * ratio).to(torch.int32)
    enc_valid = torch.arange(enc.shape[1], device=enc.device)[None, :] < enc_len[:, None]
    enc = enc * enc_valid[..., None]

    tok = adapters.audio_pool(mm["aud_pool"], enc, cfg.mm_audio_pool_size)
    tok_len = enc_len // cfg.mm_audio_pool_size
    tok = adapters.mlp_projector(mm["aud_projector"], tok, cfg.mm_projector_depth)
    tok = scaled_rms_norm(tok, mm["aud_norm"]["weight"], cfg.mm_rms_eps)
    pe_t = _pos_embed_batch(mm["pos_t"], tok.shape[1], tok_len,
                            cfg.mm_time_interval, d, (pos_noise or {}).get("aud_t"))
    tok = tok + rms_norm(pe_t, cfg.mm_rms_eps).to(tok.dtype)
    mask = torch.arange(tok.shape[1], device=tok.device)[None, :] < tok_len[:, None]
    mask = mask & (tok_len > 0)[:, None]
    tok = scaled_rms_norm(tok, mm["llm_norm"]["weight"], cfg.mm_rms_eps)
    return tok * mask[..., None], mask


# ---------------------------------------------------------------------------
# Decoder layer
# ---------------------------------------------------------------------------

def _qkv(lp, x, tcfg: TextConfig):
    q = decoder.split_heads(x @ lp["q_w"], tcfg.num_heads, tcfg.head_dim)
    k = decoder.split_heads(x @ lp["k_w"], tcfg.num_kv_heads, tcfg.head_dim)
    v = decoder.split_heads(x @ lp["v_w"], tcfg.num_kv_heads, tcfg.head_dim)
    return q, k, v


def _fold_o_w(o_w: torch.Tensor, tcfg: TextConfig) -> torch.Tensor:
    """[H*D, d] o_proj -> [Hk*D, d] with the g GQA row blocks of each KV head
    summed in fp32 and re-rounded once to o_w's dtype (repeat(v, g) @ o_w ==
    v @ folded o_w)."""
    g = tcfg.num_heads // tcfg.num_kv_heads
    hd = tcfg.head_dim
    wf = o_w.float().reshape(tcfg.num_kv_heads, g, hd, -1).sum(1)
    return wf.reshape(tcfg.num_kv_heads * hd, -1).to(o_w.dtype)


def _xattn_block(lp, q, stream, stream_mask, tcfg: TextConfig, mm_chunks: int,
                 kv=None, use_flash: bool = False):
    """T2V / T2A cross attention plus the diagonal stream update. Returns
    (xattn out [B,T,d], updated stream, (k, v)). With `kv` (decode, the
    cache-native [B,Hk,S,D] layer slices) the stream update is skipped."""
    has = stream_mask.any(dim=-1)  # [B] sample has this modality
    # samples without the modality attend everywhere (finite), then zeroed
    kv_valid = torch.where(has[:, None], stream_mask, torch.ones_like(stream_mask))
    if kv is not None:
        mk, mv = kv
        if use_flash:
            from vidi_tpu_torch.ops.cuda.decode_attention import decode_attention
            attn = decode_attention(q[:, 0], mk, mv, kv_valid, tcfg.q_scale,
                                    tcfg.attn_softcap)[:, None]
        else:
            attn = cross_attention(q, mk.transpose(1, 2), mv.transpose(1, 2),
                                   kv_valid=kv_valid, scale=tcfg.q_scale,
                                   softcap=tcfg.attn_softcap)
        out = (decoder.merge_heads(attn) @ lp["o_w"]) * has[:, None, None]
        return out, stream, (mk, mv)

    sn = decoder.norm(stream, lp["input_ln"], tcfg)
    mk = decoder.split_heads(sn @ lp["k_w"], tcfg.num_kv_heads, tcfg.head_dim)
    mv = decoder.split_heads(sn @ lp["v_w"], tcfg.num_kv_heads, tcfg.head_dim)
    if use_flash:
        from vidi_tpu_torch.ops.cuda.flash_attention import flash_attention
        attn = flash_attention(q, mk, mv, kv_valid, tcfg.q_scale, False, None,
                               tcfg.attn_softcap)[0]
    else:
        attn = cross_attention(q, mk, mv, kv_valid=kv_valid, scale=tcfg.q_scale,
                               softcap=tcfg.attn_softcap)
    out = (decoder.merge_heads(attn) @ lp["o_w"]) * has[:, None, None]

    # diagonal update: o_proj over GQA-repeated values == v @ folded o_w
    g = tcfg.num_heads // tcfg.num_kv_heads
    o_w = _fold_o_w(lp["o_w"], tcfg) if g > 1 else lp["o_w"]

    def diag_update(s_chunk, v_chunk):
        dv = decoder.merge_heads(v_chunk) @ o_w
        if tcfg.double_norms:
            dv = decoder.norm(dv, lp["post_attn_ln"], tcfg)
        return decoder.ffn_block(lp, s_chunk + dv, tcfg)

    s = stream.shape[1]
    if mm_chunks > 1 and s > mm_chunks:
        # chunk along the token axis (the update is per token)
        size = -(-s // mm_chunks)
        new = torch.empty_like(stream)
        for a in range(0, s, size):
            new[:, a:a + size] = diag_update(stream[:, a:a + size], mv[:, a:a + size])
    else:
        new = diag_update(stream, mv)
    return out, new, (mk, mv)


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
                text_segs=None):
    """One Dattn decoder layer -> (h, img, aud, (text_kv, img_kv, aud_kv))."""
    res = h
    hn = decoder.norm(h, lp["input_ln"], tcfg)
    q, k, v = _qkv(lp, hn, tcfg)
    cos, sin = rope_cs
    q_r = apply_rope(q, cos, sin)
    k_r = apply_rope(k, cos, sin)

    if text_kv is not None:
        # decode: write this step's K/V into the layer's text cache IN PLACE
        # (ck / cv are views of the [L,B,Hk,S,D] cache) at slot `write_at`
        ck, cv = text_kv
        bidx = torch.arange(ck.shape[0], device=ck.device)
        ck[bidx, :, write_at] = k_r[:, 0]
        cv[bidx, :, write_at] = v[:, 0]
        new_text_kv = (ck, cv)
        if use_flash:
            from vidi_tpu_torch.ops.cuda.decode_attention import decode_attention
            window = tcfg.sliding_window if is_sliding else None
            t2t = decode_attention(q_r[:, 0], ck, cv, text_mask, tcfg.q_scale,
                                   tcfg.attn_softcap, window,
                                   q_pos=q_positions[:, 0])[:, None]
        else:
            t2t = _self_attn_switch(q_r, ck.transpose(1, 2), cv.transpose(1, 2),
                                    q_positions, kv_positions, text_mask, tcfg,
                                    is_sliding)
    else:
        new_text_kv = (k_r, v)
        t2t = _self_attn_switch(q_r, k_r, v, q_positions, kv_positions,
                                text_mask, tcfg, is_sliding, use_flash=use_flash,
                                segs=text_segs)
    out = decoder.merge_heads(t2t) @ lp["o_w"]

    img_kv_out = aud_kv_out = None
    if img is not None or img_kv is not None:
        t2v, img, img_kv_out = _xattn_block(lp, q, img, img_mask, tcfg, mm_chunks,
                                            kv=img_kv, use_flash=use_flash)
        out = out + t2v
    if aud is not None or aud_kv is not None:
        t2a, aud, aud_kv_out = _xattn_block(lp, q, aud, aud_mask, tcfg, mm_chunks,
                                            kv=aud_kv, use_flash=use_flash)
        out = out + t2a

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

def _caches_ys(caches):
    """One layer's cache outputs in the decode-native [B,Hk,S,D] layout
    (prefill computes [B,S,Hk,D]; these are transposed views)."""
    (tk, tv), img_kv, aud_kv = caches
    t = lambda x: None if x is None else x.transpose(1, 2)  # noqa: E731
    ik, iv = img_kv if img_kv is not None else (None, None)
    ak, av = aud_kv if aud_kv is not None else (None, None)
    return t(tk), t(tv), t(ik), t(iv), t(ak), t(av)


def forward(params: Params, cfg: DattnConfig, inputs_embeds, text_mask,
            positions, img=None, img_mask=None, aud=None, aud_mask=None, *,
            mm_chunks: int = 1, return_caches: bool = False,
            use_flash: bool = False, remat: bool = False, text_segs=None):
    """Run all layers -> (final hidden [B,T,d] pre-lm_head, Caches or None).
    The caches are written layer by layer into preallocated [L,B,Hk,S,D]
    buffers. `remat=True` recomputes each layer in the backward pass
    (non-reentrant checkpoint) instead of keeping its activations;
    `text_segs` [B,T] are packing segment ids for the T2T attention."""
    if remat not in (False, True):
        raise NotImplementedError(f"remat={remat!r}: only full remat (True) or "
                                  "none (False) is ported")
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
            use_flash=use_flash, text_segs=text_segs)
        if remat and torch.is_grad_enabled():
            h, img, aud, caches = checkpoint(layer, h, img, aud, use_reentrant=False)
        else:
            h, img, aud, caches = layer(h, img, aud)
        if return_caches:
            ys = _caches_ys(caches)
            if bufs is None:
                bufs = [None if y is None else
                        torch.empty((len(layers), *y.shape), dtype=y.dtype,
                                    device=y.device) for y in ys]
            for buf, y in zip(bufs, ys):
                if buf is not None:
                    buf[i].copy_(y)
    h = decoder.norm(h, params["text"]["final_ln"], tcfg)
    return h, (Caches(*bufs) if return_caches else None)


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def decode_step(params: Params, cfg: DattnConfig, token_embeds, cur_len,
                caches: Caches, *, img_mask=None, aud_mask=None,
                use_flash: bool = False):
    """One greedy-decode step: token_embeds [B,1,d], cur_len [B] tokens
    already cached -> (logits [B,V] fp32, caches). The text cache is updated
    in place; the returned Caches is the same object."""
    tcfg = cfg.text
    h = _embed_scale(token_embeds, tcfg) if tcfg.embed_scale else token_embeds
    b = h.shape[0]
    positions = cur_len[:, None]
    rope_cs = rope_cos_sin(positions, tcfg.head_dim, tcfg.rope_theta)
    s_max = caches.text_k.shape[3]
    kv_positions = torch.arange(s_max, dtype=positions.dtype,
                                device=h.device)[None].expand(b, s_max)
    text_valid = kv_positions < (cur_len + 1)[:, None]
    has_img, has_aud = caches.img_k is not None, caches.aud_k is not None
    for i, lp in enumerate(params["text"]["layers"]):
        h, _, _, _ = dattn_layer(
            lp, _is_sliding(i, tcfg), h, None, None, tcfg=tcfg, rope_cs=rope_cs,
            q_positions=positions, kv_positions=kv_positions,
            text_mask=text_valid, img_mask=img_mask, aud_mask=aud_mask,
            text_kv=(caches.text_k[i], caches.text_v[i]),
            img_kv=(caches.img_k[i], caches.img_v[i]) if has_img else None,
            aud_kv=(caches.aud_k[i], caches.aud_v[i]) if has_aud else None,
            write_at=cur_len, use_flash=use_flash)
    h = decoder.norm(h, params["text"]["final_ln"], tcfg)
    return decoder.lm_logits(params["text"], h[:, 0], tcfg), caches
