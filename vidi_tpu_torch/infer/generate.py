"""Greedy generation over fixed-size caches (port of vidi_tpu/infer/generate.py,
the greedy `generate`).

Prefill fills the three KV caches (the text cache padded with
`max_new_tokens` decode slots), then a host loop decodes one token per step
until `max_new_tokens` or until every row has stopped at `eos_id` or at one
of the tokenized `stop_sequences`. The JAX version runs this loop as a
`lax.while_loop`; here each step reads `done` back to the host (one sync
per step). With `media_caches` (a video's image / audio caches from
`dattn.media_prefill` or `media_prefill_chunked`, batch 1 or B) the prefill
runs only the text side against them (`dattn.text_prefill_with_caches`)
and every step reads them folded across the rows: the stream prefill is
not repeated per query. Sampling, beams and speculative decoding are not
ported yet.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from vidi_tpu_torch.core.config import DattnConfig
from vidi_tpu_torch.models import dattn, decoder


class GenerateResult(NamedTuple):
    tokens: torch.Tensor   # [B, max_new] (eos included; padded with eos)
    lengths: torch.Tensor  # [B] tokens emitted incl. eos
    prefill_s: float       # host seconds for prefill + the first token
    decode_s: float        # host seconds for the decode steps after it
    decode_steps: int      # decode_step calls made


def tokenize_stop_keywords(keywords, tokenizer) -> tuple:
    """Keyword strings -> token-id tuples for `stop_sequences` (the leading
    bos of each tokenization is dropped)."""
    out = []
    for kw in keywords:
        ids = list(tokenizer(kw).input_ids)
        if len(ids) > 1 and ids[0] == getattr(tokenizer, "bos_token_id", None):
            ids = ids[1:]
        if ids:
            out.append(tuple(int(t) for t in ids))
    return tuple(out)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prefill(params, cfg: DattnConfig, prompt_ids, prompt_mask, img, img_mask,
             aud, aud_mask, *, max_new_tokens: int, mm_chunks: int,
             use_flash: bool, quantize_caches: bool = False, media_caches=None):
    """Full forward (or, with `media_caches`, the text prefill against
    them), then the text cache grown by `max_new_tokens` slots.
    -> (hidden [B,T,d], caches, prompt lengths [B])."""
    if media_caches is not None:
        if img is not None or aud is not None:
            raise ValueError("media_caches replaces the raw img / aud features "
                             "(their masks still apply)")
        if quantize_caches:
            raise ValueError("quantize_caches applies to caches built here; "
                             "media_caches are read in the form they were built in")
    lens = prompt_mask.sum(dim=1)
    positions = torch.clamp(torch.cumsum(prompt_mask.long(), dim=1) - 1, min=0)
    embeds = decoder.embed_tokens(params["text"], prompt_ids, cfg.text)
    if media_caches is not None:
        h, caches = dattn.text_prefill_with_caches(
            params, cfg, embeds, prompt_mask, positions, media_caches,
            img_mask=img_mask, aud_mask=aud_mask, use_flash=use_flash)
    else:
        h, caches = dattn.forward(params, cfg, embeds, prompt_mask, positions,
                                  img=img, img_mask=img_mask, aud=aud,
                                  aud_mask=aud_mask, mm_chunks=mm_chunks,
                                  return_caches=True, use_flash=use_flash,
                                  quantize_caches=quantize_caches)

    def grow(c):  # [L,B,Hk,T,D] -> [L,B,Hk,T+max_new,D], new slots zero
        out = c.new_zeros((*c.shape[:3], c.shape[3] + max_new_tokens, c.shape[4]))
        out[:, :, :, : c.shape[3]] = c
        return out

    caches = caches._replace(text_k=grow(caches.text_k), text_v=grow(caches.text_v))
    return h, caches, lens


def _keyword_done(tokens, step: int, stops) -> torch.Tensor:
    """[B] whether each row's output ending at `step` ends with a stop
    keyword."""
    hit = torch.zeros(tokens.shape[0], dtype=torch.bool, device=tokens.device)
    for kw in stops:
        m = kw.shape[0]
        if step + 1 >= m:
            hit |= (tokens[:, step - m + 1: step + 1] == kw).all(dim=1)
    return hit


def generate(params, cfg: DattnConfig, prompt_ids, prompt_mask, img=None,
             img_mask=None, aud=None, aud_mask=None, *,
             max_new_tokens: int = 1024, eos_id: int = 107, mm_chunks: int = 1,
             use_flash: bool = False, use_flash_decode: bool = False,
             quantize_caches: bool = False,
             stop_sequences: tuple = (), media_caches=None) -> GenerateResult:
    """Greedy decode. prompt_ids / prompt_mask [B,T] right-padded (long /
    bool, on the model's device). `use_flash` runs prefill attention on the
    K1 kernel; `use_flash_decode` runs decode attention on the kernels
    (default off, as in vidi_tpu): K3 for one query token a cache row, K1
    for rows folded onto a shared cache; `quantize_caches` keeps the image /
    audio caches as per-token int8 (their decode reads then skip K3).
    `media_caches`: precomputed image / audio caches (`dattn.Caches` with
    text caches None, batch 1 or B) in place of img / aud, which must be
    None; img_mask / aud_mask are then of the caches' batch. The caches'
    own form (bf16 or int8) decides how they are read, so `quantize_caches`
    must then be False, and `mm_chunks` (which chunks the stream work) has
    nothing to act on."""
    tcfg = cfg.text
    dev = prompt_ids.device
    b = prompt_ids.shape[0]
    t0 = time.perf_counter()
    h, caches, lens = _prefill(
        params, cfg, prompt_ids, prompt_mask, img, img_mask, aud, aud_mask,
        max_new_tokens=max_new_tokens, mm_chunks=mm_chunks, use_flash=use_flash,
        quantize_caches=quantize_caches, media_caches=media_caches)
    h_last = h[torch.arange(b, device=dev), torch.clamp(lens - 1, min=0)]
    tok = decoder.lm_logits(params["text"], h_last, tcfg).argmax(dim=-1)
    tokens = torch.full((b, max_new_tokens), eos_id, dtype=torch.long, device=dev)
    tokens[:, 0] = tok
    done = tok == eos_id
    stops = [torch.tensor(kw, dtype=torch.long, device=dev)
             for kw in stop_sequences if 0 < len(kw) <= max_new_tokens]
    if stops:
        done |= _keyword_done(tokens, 0, stops)
    _sync(dev)
    t1 = time.perf_counter()

    cur_len = lens.clone()
    step = 1
    while step < max_new_tokens and not bool(done.all()):
        emb = decoder.embed_tokens(params["text"], tok[:, None], tcfg)
        logits, caches = dattn.decode_step(
            params, cfg, emb, cur_len, caches, img_mask=img_mask,
            aud_mask=aud_mask, use_flash=use_flash_decode)
        nxt = torch.where(done, torch.full_like(tok, eos_id), logits.argmax(dim=-1))
        tokens[:, step] = nxt
        done |= nxt == eos_id
        if stops:
            done |= _keyword_done(tokens, step, stops)
        tok = nxt
        cur_len = cur_len + 1
        step += 1
    _sync(dev)
    t2 = time.perf_counter()

    is_eos = tokens == eos_id
    first_eos = is_eos.int().argmax(dim=1)
    lengths = torch.where(is_eos.any(dim=1), first_eos + 1,
                          torch.full_like(first_eos, max_new_tokens))
    return GenerateResult(tokens, lengths, t1 - t0, t2 - t1, step - 1)
