"""Generation over fixed-size caches (port of vidi_tpu/infer/generate.py):
greedy and sampled `generate`, `beam_generate` and `speculative_generate`.

Prefill fills the three KV caches (the text cache padded with decode
slots), then a host loop decodes until `max_new_tokens` or until every row
has stopped at `eos_id` (or, in `generate`, at one of the tokenized
`stop_sequences`). The JAX version runs each loop as a `lax.while_loop`;
here each step reads `done` back to the host (one sync per step). With
`media_caches` (a video's image / audio caches from `dattn.media_prefill`
or `media_prefill_chunked`, batch 1 or B) the prefill runs only the text
side against them (`dattn.text_prefill_with_caches`) and every step reads
them folded across the rows: the stream prefill is not repeated per query.

Sampling (`temperature > 0`) warps fp32 logits by temperature, then top-k,
then top-p (`_warp_logits`) and draws from one `torch.Generator` on the
model's device, in a fixed order; `temperature == 0` is greedy. Beam
search keeps K text caches a query and reorders them by parent each step;
the image / audio caches serve the K beams of a query folded. Speculative
decoding drafts `spec_k` tokens (from an n-gram lookup in the history, or
from a small text-only draft model), verifies them in one target pass
(`dattn.verify_step`) and commits the accepted prefix and one token of the
target's: greedy output equals greedy `generate`'s, sampled output follows
sampled `generate`'s law.
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


class SpecGenerateResult(NamedTuple):
    tokens: torch.Tensor      # [B, max_new] (eos included; padded with eos)
    lengths: torch.Tensor     # [B] tokens emitted incl. eos
    n_target_steps: int       # verify passes run
    n_drafted: torch.Tensor   # [B] draft tokens proposed
    n_accepted: torch.Tensor  # [B] draft tokens accepted
    prefill_s: float          # host seconds for both prefills + the first token
    decode_s: float           # host seconds for the draft / verify rounds


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


def _grow_text(caches, n: int):
    """The text cache [L,B,Hk,T,D] grown by n zero slots."""
    def grow(c):
        out = c.new_zeros((*c.shape[:3], c.shape[3] + n, c.shape[4]))
        out[:, :, :, : c.shape[3]] = c
        return out

    return caches._replace(text_k=grow(caches.text_k), text_v=grow(caches.text_v))


def _positions(prompt_mask):
    return torch.clamp(torch.cumsum(prompt_mask.long(), dim=1) - 1, min=0)


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
    positions = _positions(prompt_mask)
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
    return h, _grow_text(caches, max_new_tokens), lens


def _last_logits(params, cfg: DattnConfig, h, lens):
    """Logits [B,V] at each row's last prompt token."""
    h_last = h[torch.arange(h.shape[0], device=h.device), torch.clamp(lens - 1, min=0)]
    return decoder.lm_logits(params["text"], h_last, cfg.text)


def _keyword_done(tokens, step: int, stops) -> torch.Tensor:
    """[B] whether each row's output ending at `step` ends with a stop
    keyword."""
    hit = torch.zeros(tokens.shape[0], dtype=torch.bool, device=tokens.device)
    for kw in stops:
        m = kw.shape[0]
        if step + 1 >= m:
            hit |= (tokens[:, step - m + 1: step + 1] == kw).all(dim=1)
    return hit


def _lengths(tokens, eos_id: int, max_new_tokens: int):
    is_eos = tokens == eos_id
    first_eos = is_eos.int().argmax(dim=1)
    return torch.where(is_eos.any(dim=1), first_eos + 1,
                       torch.full_like(first_eos, max_new_tokens))


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _warp_logits(logits, temperature: float, top_k: int, top_p: float):
    """The logits-warper stack of HF's GenerationMixin on fp32 logits
    [B,V]: temperature, then top-k (every logit tied with the k-th kept),
    then top-p. Top-p keeps a token while the mass sorted before it is
    below top_p (the first always), scattered back by the sorted index: an
    exact prefix even where logits tie at the nucleus boundary (Gemma2's
    final softcap saturates many logits to the cap). The sort is stable on
    -logits, as the reference's argsort, so the same tied tokens survive."""
    if temperature != 1.0:
        logits = logits / torch.tensor(temperature, dtype=logits.dtype,
                                       device=logits.device)
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if top_p < 1.0:
        order = torch.sort(-logits, dim=-1, stable=True).indices
        probs = torch.softmax(logits.gather(-1, order), dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        logits = logits.masked_fill(~keep, -torch.inf)
    return logits


def _draw(weights, generator: torch.Generator):
    """One draw a row from nonnegative weights [N,V] (any scale): the
    exponential race argmax w / E, E = -log U ~ Exp(1) from `generator`,
    picks index i with probability w_i / sum(w). A row of zeros gives 0
    (the speculative residual of a position whose draft is always
    accepted, never committed)."""
    u = torch.rand(weights.shape, generator=generator, device=weights.device)
    return (weights / -torch.log(u)).argmax(dim=-1)


def _warped_probs(logits, temperature: float, top_k: int, top_p: float):
    return torch.softmax(_warp_logits(logits.float(), temperature, top_k, top_p), dim=-1)


def _need_generator(temperature: float, generator) -> bool:
    """Whether the run samples; sampling takes an explicit generator."""
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 samples: pass a torch.Generator on the "
                         "model's device")
    return temperature > 0.0


# ---------------------------------------------------------------------------
# Greedy / sampled decode
# ---------------------------------------------------------------------------

def generate(params, cfg: DattnConfig, prompt_ids, prompt_mask, img=None,
             img_mask=None, aud=None, aud_mask=None, *,
             max_new_tokens: int = 1024, eos_id: int = 107, mm_chunks: int = 1,
             use_flash: bool = False, use_flash_decode: bool = False,
             quantize_caches: bool = False,
             stop_sequences: tuple = (), media_caches=None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             generator: Optional[torch.Generator] = None) -> GenerateResult:
    """Greedy (temperature 0) or sampled decode. prompt_ids / prompt_mask
    [B,T] right-padded (long / bool, on the model's device). `use_flash`
    runs prefill attention on the K1 kernel; `use_flash_decode` runs decode
    attention on the kernels (default off, as in vidi_tpu): K3 for one
    query token a cache row, K1 for rows folded onto a shared cache;
    `quantize_caches` keeps the image / audio caches as per-token int8
    (their decode reads then skip K3). `media_caches`: precomputed image /
    audio caches (`dattn.Caches` with text caches None, batch 1 or B) in
    place of img / aud, which must be None; img_mask / aud_mask are then
    of the caches' batch. The caches' own form (bf16 or int8) decides how
    they are read, so `quantize_caches` must then be False, and
    `mm_chunks` (which chunks the stream work) has nothing to act on.
    With `temperature > 0` each step draws one token a row from the warped
    distribution (`_warp_logits`) with `generator` (on the model's device,
    required then), in step order."""
    tcfg = cfg.text
    dev = prompt_ids.device
    b = prompt_ids.shape[0]
    do_sample = _need_generator(temperature, generator)

    def select(logits):
        if not do_sample:
            return logits.argmax(dim=-1)
        return _draw(_warped_probs(logits, temperature, top_k, top_p), generator)

    t0 = time.perf_counter()
    h, caches, lens = _prefill(
        params, cfg, prompt_ids, prompt_mask, img, img_mask, aud, aud_mask,
        max_new_tokens=max_new_tokens, mm_chunks=mm_chunks, use_flash=use_flash,
        quantize_caches=quantize_caches, media_caches=media_caches)
    tok = select(_last_logits(params, cfg, h, lens))
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
        nxt = torch.where(done, torch.full_like(tok, eos_id), select(logits))
        tokens[:, step] = nxt
        done |= nxt == eos_id
        if stops:
            done |= _keyword_done(tokens, step, stops)
        tok = nxt
        cur_len = cur_len + 1
        step += 1
    _sync(dev)
    t2 = time.perf_counter()
    return GenerateResult(tokens, _lengths(tokens, eos_id, max_new_tokens),
                          t1 - t0, t2 - t1, step - 1)


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def _top(x, k: int):
    """The k largest of each row of x [N,M] in descending order, ties by
    the lower index (jax.lax.top_k's order; torch.topk promises none):
    a stable descending sort. -> (values, indices) [N,k]."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _reorder(caches, spare, parent):
    """Text caches gathered by beam `parent` [B*K] into the spare buffers
    -> (reordered caches, the old buffers as the next spare)."""
    torch.index_select(caches.text_k, 1, parent, out=spare[0])
    torch.index_select(caches.text_v, 1, parent, out=spare[1])
    return caches._replace(text_k=spare[0], text_v=spare[1]), (caches.text_k, caches.text_v)


def beam_generate(params, cfg: DattnConfig, prompt_ids, prompt_mask, img=None,
                  img_mask=None, aud=None, aud_mask=None, *,
                  max_new_tokens: int = 1024, eos_id: int = 107,
                  num_beams: int = 4, length_penalty: float = 1.0,
                  mm_chunks: int = 1, use_flash: bool = False,
                  use_flash_decode: bool = False, quantize_caches: bool = False,
                  media_caches=None) -> GenerateResult:
    """Static beam search over B independent queries, K = num_beams beams
    each -> each query's best beam. The prefill runs once; only the text
    caches repeat K ways ([L,B*K,Hk,S,D], beams row-major by query) and are
    reordered by parent every step (a gather into a second buffer, the two
    swapped). The image / audio caches are never replicated: `_xattn_block`
    folds the K beams of a query onto its cache row (K1 with
    `use_flash_decode` when K > 1; K3 when K == 1). A finished beam is
    frozen (its only continuation is eos at zero added log-prob); scores
    are summed log-probs, normalized by length**length_penalty at the final
    pick, finished hypotheses preferred. Arguments as `generate`'s."""
    tcfg = cfg.text
    dev = prompt_ids.device
    b, k = prompt_ids.shape[0], num_beams
    t0 = time.perf_counter()
    h, caches, lens = _prefill(
        params, cfg, prompt_ids, prompt_mask, img, img_mask, aud, aud_mask,
        max_new_tokens=max_new_tokens, mm_chunks=mm_chunks, use_flash=use_flash,
        quantize_caches=quantize_caches, media_caches=media_caches)
    logp0 = torch.log_softmax(_last_logits(params, cfg, h, lens).float(), dim=-1)
    v = logp0.shape[-1]
    scores, toks = _top(logp0, k)                              # [B, K]
    caches = caches._replace(text_k=caches.text_k.repeat_interleave(k, dim=1),
                             text_v=caches.text_v.repeat_interleave(k, dim=1))
    spare = (torch.empty_like(caches.text_k), torch.empty_like(caches.text_v))

    tokens = torch.full((b * k, max_new_tokens), eos_id, dtype=torch.long, device=dev)
    tokens[:, 0] = toks.reshape(-1)
    done = toks == eos_id                                      # [B, K]
    lengths = torch.ones((b, k), dtype=torch.long, device=dev)
    cur_len = lens.repeat_interleave(k)
    cur_tok = toks.reshape(-1)
    frozen = torch.full((v,), -torch.inf, device=dev)
    frozen[eos_id] = 0.0
    first = (torch.arange(b, device=dev) * k)[:, None]         # row of each query's beam 0
    _sync(dev)
    t1 = time.perf_counter()

    step = 1
    while step < max_new_tokens and not bool(done.all()):
        emb = decoder.embed_tokens(params["text"], cur_tok[:, None], tcfg)
        logits, caches = dattn.decode_step(
            params, cfg, emb, cur_len, caches, img_mask=img_mask,
            aud_mask=aud_mask, use_flash=use_flash_decode)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
        logp = torch.where(done[..., None], frozen, logp)
        scores, idx = _top((scores[..., None] + logp).reshape(b, k * v), k)
        parent, tok = idx // v, idx % v                        # [B, K]
        rows = (first + parent).reshape(-1)
        tokens = tokens[rows]
        tokens[:, step] = tok.reshape(-1)
        caches, spare = _reorder(caches, spare, rows)
        was_done = done.gather(1, parent)
        done = was_done | (tok == eos_id)
        lengths = torch.where(was_done, lengths.gather(1, parent),
                              torch.full_like(lengths, step + 1))
        cur_tok = tok.reshape(-1)
        cur_len = cur_len + 1
        step += 1
    _sync(dev)
    t2 = time.perf_counter()

    lengths = torch.where(done, lengths, torch.full_like(lengths, max_new_tokens))
    norm_scores = scores / lengths.float() ** length_penalty
    # finished hypotheses first: unfinished beams compete only when none of
    # the query's beams finished
    final = torch.where(done.any(dim=1, keepdim=True),
                        norm_scores.masked_fill(~done, -torch.inf), norm_scores)
    best = final.argmax(dim=1)
    q = torch.arange(b, device=dev)
    return GenerateResult(tokens.reshape(b, k, max_new_tokens)[q, best],
                          lengths[q, best], t1 - t0, t2 - t1, step - 1)


# ---------------------------------------------------------------------------
# Speculative decoding
# ---------------------------------------------------------------------------

def _ngram_drafts(hist, hist_len, k: int):
    """Prompt-lookup drafts: for each row, the k tokens that followed the
    latest earlier occurrence of the history's trailing 2-gram (hist [B,H],
    -1 past each row's `hist_len`). -> (drafts [B,k], -1 where a row found
    none; found [B])."""
    b, n = hist.shape
    rows = torch.arange(b, device=hist.device)
    g1 = hist[rows, torch.clamp(hist_len - 2, min=0)]
    g2 = hist[rows, torch.clamp(hist_len - 1, min=0)]
    wpos = torch.arange(n - 1, device=hist.device)
    hit = (hist[:, :-1] == g1[:, None]) & (hist[:, 1:] == g2[:, None])
    hit &= wpos[None] < (hist_len - 2)[:, None]  # strictly before the trailing one
    p = torch.where(hit, wpos, -1).max(dim=1).values
    found = p >= 0
    # the slice start clamped so the slice fits (lax.dynamic_slice's rule)
    width = max(k, 1)
    start = torch.clamp(torch.where(found, p + 2, 0), max=n - width)
    drafts = hist.gather(1, start[:, None] + torch.arange(width, device=hist.device))[:, :k]
    return torch.where(found[:, None], drafts, -1), found


def speculative_generate(params, cfg: DattnConfig, draft_params,
                         draft_cfg: Optional[DattnConfig], prompt_ids, prompt_mask,
                         img=None, img_mask=None, aud=None, aud_mask=None, *,
                         max_new_tokens: int = 1024, eos_id: int = 107,
                         spec_k: int = 4, mm_chunks: int = 1,
                         use_flash: bool = False, use_flash_decode: bool = False,
                         quantize_caches: bool = False, media_caches=None,
                         temperature: float = 0.0, top_k: int = 0,
                         top_p: float = 1.0,
                         generator: Optional[torch.Generator] = None) -> SpecGenerateResult:
    """Speculative decoding: each round drafts K = spec_k tokens a row,
    verifies the window [current token, drafts] in one target pass
    (`dattn.verify_step`), and commits the accepted drafts plus one token
    of the target's (1..K+1 tokens a pass).

    Drafts: `draft_params=None` looks up the trailing 2-gram of the prompt
    and generated history and proposes the K tokens after its latest
    earlier occurrence (-1, never accepted, where there is none); else a
    small text-only draft model (`draft_params`, `draft_cfg`, the target's
    vocabulary) runs K+1 decode steps (the last writes the last proposal's
    K/V) without kernels, as the reference runs them; its prefill takes
    `use_flash` (K1 for its T2T), as the reference's does.

    Greedy (temperature 0): the longest prefix of drafts equal to the
    target's argmax is accepted; the output equals greedy `generate`'s for
    any draft. Sampled: the draft samples x_j ~ q_j (q_j a delta for the
    n-gram draft), the target accepts x_j with probability
    min(1, p_j(x_j) / q_j(x_j)) and on the first rejection draws from
    max(p_j - q_j, 0) (p_j without x_j for a delta draft); a window
    accepted whole commits a bonus token drawn from p_K. The output then
    follows sampled `generate`'s law. A round's randomness comes from
    `generator` in one fixed order (the draft samples, the uniforms, the
    residual draws), so no two draws share a stream position.

    Commits stop at eos and at the output buffer. The target's text cache
    is grown by max_new_tokens + K + 1 slots; a rollback is not advancing
    cur_len (stale slots lie past the validity mask). Other arguments as
    `generate`'s."""
    tcfg = cfg.text
    dev = prompt_ids.device
    b, k = prompt_ids.shape[0], spec_k
    use_ngram = draft_params is None
    do_sample = _need_generator(temperature, generator)
    warp = (temperature, top_k, top_p)

    t0 = time.perf_counter()
    h, caches, lens = _prefill(
        params, cfg, prompt_ids, prompt_mask, img, img_mask, aud, aud_mask,
        max_new_tokens=max_new_tokens + k + 1, mm_chunks=mm_chunks,
        use_flash=use_flash, quantize_caches=quantize_caches,
        media_caches=media_caches)
    if use_ngram:
        # the history: prompt tokens, then the committed ones; a sink
        # column past the end takes the writes of uncommitted slots
        hist_buf = torch.full((b, prompt_ids.shape[1] + max_new_tokens + 1), -1,
                              dtype=torch.long, device=dev)
        hist_buf[:, : prompt_ids.shape[1]] = torch.where(prompt_mask, prompt_ids, -1)
        hist = hist_buf[:, :-1]
    else:
        d_emb = decoder.embed_tokens(draft_params["text"], prompt_ids, draft_cfg.text)
        _, dcaches = dattn.forward(draft_params, draft_cfg, d_emb, prompt_mask,
                                   _positions(prompt_mask), return_caches=True,
                                   use_flash=use_flash)
        dcaches = _grow_text(dcaches, max_new_tokens + k + 1)

    logits0 = _last_logits(params, cfg, h, lens)
    tok = (_draw(_warped_probs(logits0, *warp), generator) if do_sample
           else logits0.argmax(dim=-1))
    # a sink column past the end takes the writes of uncommitted slots
    tokens = torch.full((b, max_new_tokens + 1), eos_id, dtype=torch.long, device=dev)
    tokens[:, 0] = tok
    done = tok == eos_id
    rows = torch.arange(b, device=dev)
    iota = torch.arange(k + 1, device=dev)
    if use_ngram:
        hist[rows, lens] = tok
    out_len = torch.ones_like(lens)
    cur_len, dlen = lens.clone(), lens.clone()
    drafted, accepted = torch.zeros_like(lens), torch.zeros_like(lens)
    steps = 0
    _sync(dev)
    t1 = time.perf_counter()

    while not bool(done.all()):
        qs = []
        if use_ngram:
            drafts, found = _ngram_drafts(hist, lens + out_len, k)
            new_drafted = torch.where(done | ~found, 0, k)
        else:
            x, proposals = tok, []
            for j in range(k + 1):
                emb = decoder.embed_tokens(draft_params["text"], x[:, None], draft_cfg.text)
                dlogits, dcaches = dattn.decode_step(draft_params, draft_cfg, emb,
                                                     dlen + j, dcaches)
                if j < k:
                    if do_sample:
                        qs.append(_warped_probs(dlogits, *warp))
                        x = _draw(qs[-1], generator)
                    else:
                        x = dlogits.argmax(dim=-1)
                    proposals.append(x)
            drafts = (torch.stack(proposals, dim=1) if k
                      else torch.zeros((b, 0), dtype=torch.long, device=dev))
            new_drafted = torch.where(done, 0, k)

        window = torch.cat([tok[:, None], drafts], dim=1)
        vlogits, caches = dattn.verify_step(
            params, cfg, decoder.embed_tokens(params["text"], window, tcfg), cur_len,
            caches, img_mask=img_mask, aud_mask=aud_mask, use_flash=use_flash_decode)
        padded = torch.nn.functional.pad(drafts, (0, 1))
        if do_sample:
            v = vlogits.shape[-1]
            p = _warped_probs(vlogits.reshape(b * (k + 1), v), *warp).reshape(b, k + 1, v)
            valid = drafts >= 0  # an n-gram miss (-1) has target probability 0
            dsafe = drafts.clamp(0, v - 1)[..., None]
            p_at = p[:, :k].gather(2, dsafe)[..., 0]
            px = torch.where(valid, p_at, 0.0)
            if use_ngram:
                qx = torch.ones_like(px)
                # p without the proposal (a miss leaves p as it is)
                resid = p[:, :k].scatter(2, dsafe, torch.where(valid, 0.0, p_at)[..., None])
            else:
                q = (torch.stack(qs, dim=1) if k
                     else p.new_zeros((b, 0, v)))
                qx = q.gather(2, dsafe)[..., 0]
                resid = torch.clamp(p[:, :k] - q, min=0.0)
            u = torch.rand((b, k), generator=generator, device=dev)
            n = torch.cumprod((u * qx < px).long(), dim=1).sum(dim=1)
            resid = torch.cat([resid, p[:, k:]], dim=1)
            r = _draw(resid.reshape(b * (k + 1), v), generator).reshape(b, k + 1)
            c = torch.where(iota < n[:, None], padded, r)
        else:
            g = vlogits.argmax(dim=-1)                          # [B, K+1]
            n = torch.cumprod((drafts == g[:, :k]).long(), dim=1).sum(dim=1)
            c = torch.where(iota < n[:, None], padded, g)

        # commits capped at the first eos, then at the output buffer
        is_eos = c == eos_id
        e = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1), n)
        m = torch.minimum(e, n) + 1
        m = torch.where(done, 0, torch.minimum(m, max_new_tokens - out_len))
        commit = iota < m[:, None]
        tokens.scatter_(1, torch.where(commit, out_len[:, None] + iota, max_new_tokens), c)
        if use_ngram:
            hist_buf.scatter_(1, torch.where(commit, (lens + out_len)[:, None] + iota,
                                             hist.shape[1]), c)
        done = done | (is_eos & commit).any(dim=1) | (out_len + m >= max_new_tokens)
        tok = torch.where(m > 0, c[rows, torch.clamp(m - 1, min=0)], tok)
        out_len, cur_len, dlen = out_len + m, cur_len + m, dlen + m
        drafted += new_drafted
        accepted += torch.minimum(n, m)
        steps += 1
    _sync(dev)
    t2 = time.perf_counter()

    tokens = tokens[:, :max_new_tokens]
    return SpecGenerateResult(tokens, _lengths(tokens, eos_id, max_new_tokens), steps,
                              drafted, accepted, t1 - t0, t2 - t1)
