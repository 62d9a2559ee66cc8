"""Chat templating, <image>-token splicing, and label masking.

Behavior-identical rebuild of Vidi1.5_9B/vidi/dataset/txt_utils.py for the
Gemma2 family, plus the Mistral [INST] variant
(reference: Vidi_7B/model/txt_utils.py:78-124).

Tokenizers are duck-typed: anything with `__call__(text).input_ids`,
`.bos_token_id` works (HF tokenizers, or the ByteTokenizer below for
weightless testing).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from vidi_tpu_torch.constants import (
    DEFAULT_IMAGE_TOKEN,
    GEMMA_TURN_MODEL,
    GEMMA_TURN_USER,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
)


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX) -> List[int]:
    """Splice <image> placeholders in as `image_token_index`
    (txt_utils.py:15-34): tokenize the pieces, keep a single leading bos."""
    chunks = [tokenizer(piece).input_ids for piece in prompt.split(DEFAULT_IMAGE_TOKEN)]

    input_ids: List[int] = []
    offset = 0
    if chunks and len(chunks[0]) > 0 and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(chunks[0][0])

    sep = [image_token_index] * (offset + 1)
    merged: List[List[int]] = []
    for i, ch in enumerate(chunks):
        merged.append(ch)
        if i < len(chunks) - 1:
            merged.append(sep)
    for x in merged:
        input_ids.extend(x[offset:])
    return input_ids


def normalize_mm_turn(conversations: Sequence[Dict[str, str]]) -> List[Dict[str, str]]:
    """Move <image> to the front of its turn + newline (txt_utils.py:37-44)."""
    out = []
    for s in conversations:
        v = s["value"]
        if DEFAULT_IMAGE_TOKEN in v:
            v = v.replace(DEFAULT_IMAGE_TOKEN, "").strip()
            v = (DEFAULT_IMAGE_TOKEN + "\n" + v).strip()
        out.append({**s, "value": v})
    return out


def chat_template_gemma2(conversations: Sequence[Dict[str, str]],
                         generation: bool = False) -> str:
    """Gemma2 chat string, bos stripped (txt_utils.py:66-96). Data roles are
    human/gpt; chat roles user/model."""
    roles = {"human": "user", "gpt": "model"}
    parts = []
    for i, s in enumerate(conversations):
        expected = "human" if i % 2 == 0 else "gpt"
        assert s["from"] == expected, (i, s["from"])
        parts.append(
            f"<start_of_turn>{roles[s['from']]}\n{s['value']}<end_of_turn>\n")
    out = "".join(parts)
    if generation:
        out += GEMMA_TURN_MODEL
    return out


def chat_template_mistral(conversations: Sequence[Dict[str, str]],
                          generation: bool = False) -> str:
    """Mistral [INST] template (Vidi_7B/model/txt_utils.py:78-96)."""
    parts = []
    for i, s in enumerate(conversations):
        if i % 2 == 0:
            assert s["from"] == "human"
            parts.append(f"[INST] {s['value']} [/INST]")
        else:
            assert s["from"] == "gpt"
            parts.append(f" {s['value']}</s>")
    out = "".join(parts)
    return out


def targets_gemma2(conversation: str, input_ids: np.ndarray, tokenizer,
                   has_image: bool, model_max_length: int = 4096) -> np.ndarray:
    """Label mask: supervise only model turns (txt_utils.py:99-134), with the
    reference's +2 round / +5 instruction token offsets and the
    mismatch->all-IGNORE fallback."""
    targets = np.array(input_ids, dtype=np.int64).copy()
    cur_len = 1  # bos
    targets[:cur_len] = IGNORE_INDEX

    def tok_len(text: str) -> int:
        if has_image:
            return len(tokenizer_image_token(text, tokenizer))
        return len(tokenizer(text).input_ids)

    for rou in conversation.split(GEMMA_TURN_USER):
        if rou == "":
            continue
        parts = rou.split(GEMMA_TURN_MODEL)
        assert len(parts) == 2, "each round must contain one model turn"
        round_len = tok_len(rou) + 2
        instruction_len = tok_len(parts[0]) + 5
        targets[cur_len - 1: cur_len + instruction_len] = IGNORE_INDEX
        cur_len += round_len

    if cur_len < model_max_length and cur_len != len(targets):
        targets[:] = IGNORE_INDEX
        print(f"WARNING: tokenization mismatch: {cur_len} vs. {len(targets)}. (ignored)")
    return targets


def targets_mistral(conversation: str, input_ids: np.ndarray, tokenizer,
                    has_image: bool, model_max_length: int = 4096) -> np.ndarray:
    """Mistral label mask (Vidi_7B/model/txt_utils.py:89-120): supervise only
    assistant spans; rounds split on "[INST]", instruction ends at "[/INST] ";
    mismatch falls back to all-IGNORE."""
    targets = np.array(input_ids, dtype=np.int64).copy()
    cur_len = 1  # bos
    targets[:cur_len] = IGNORE_INDEX

    def tok_len(text: str) -> int:
        if has_image:
            return len(tokenizer_image_token(text, tokenizer))
        return len(tokenizer(text).input_ids)

    for rou in conversation.split("[INST]"):
        if rou == "":
            continue
        parts = rou.split("[/INST] ")
        assert len(parts) == 2, "each round must contain one assistant turn"
        round_len = tok_len(rou)
        instruction_len = tok_len(parts[0]) + 1
        targets[cur_len: cur_len + instruction_len] = IGNORE_INDEX
        cur_len += round_len

    if cur_len < model_max_length and cur_len != len(targets):
        targets[:] = IGNORE_INDEX
        print(f"WARNING: tokenization mismatch: {cur_len} vs. {len(targets)}. (ignored)")
    return targets


def preprocess_conv(conversations, tokenizer, has_image: bool,
                    model_max_length: int = 4096,
                    arch: str = "gemma2") -> Dict[str, np.ndarray]:
    """Training sample -> input_ids + labels (txt_utils.py:140-147)."""
    if arch == "gemma2":
        conv = chat_template_gemma2(conversations)
    else:
        conv = chat_template_mistral(conversations)
    if has_image:
        ids = tokenizer_image_token(conv, tokenizer)
    else:
        ids = tokenizer(conv).input_ids[:model_max_length]
    ids = np.asarray(ids, np.int64)
    if arch == "gemma2":
        labels = targets_gemma2(conv, ids, tokenizer, has_image, model_max_length)
    else:
        labels = targets_mistral(conv, ids, tokenizer, has_image, model_max_length)
    return {"input_ids": ids, "labels": labels}


def preprocess_chat(conversations, tokenizer, arch: str = "gemma2") -> str:
    """Inference prompt string (txt_utils.py:150-155; 7B txt_utils.py:122-127)."""
    if arch == "gemma2":
        return chat_template_gemma2(conversations, generation=True)
    return chat_template_mistral(conversations, generation=True)


def truncate_at_keywords(text: str, keywords: Sequence[str]) -> str:
    """Host-side equivalent of the reference's KeywordsStoppingCriteria
    (img_utils.py:326-358): cut the decoded output at the first stop keyword.
    Our decode loop is a device-side while_loop keyed on eos; keyword stops
    are applied to the decoded text, which yields the same final string."""
    cut = len(text)
    for kw in keywords:
        i = text.find(kw)
        if i != -1:
            cut = min(cut, i)
    return text[:cut]


# ---------------------------------------------------------------------------
# Weightless test tokenizer
# ---------------------------------------------------------------------------

class _Enc:
    def __init__(self, ids):
        self.input_ids = ids


class ByteTokenizer:
    """Deterministic byte-level tokenizer for tests / random-weight demos.

    ids: 0=pad, 1=bos, 2=eos(<end_of_turn> analog), bytes at 3..258.
    Special strings are mapped to single tokens so chat-turn arithmetic
    behaves like a real tokenizer.
    """

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    model_max_length = 4096
    padding_side = "right"

    # "user"/"model" are single tokens so the turn prefix
    # "<start_of_turn>user\n" is 3 tokens — the structure the reference's
    # +2/+5 label offsets assume of the real Gemma tokenizer. [INST]/[/INST]
    # are single tokens so the Mistral masking arithmetic (each round's
    # leading [INST] offset by the re-tokenized bos) also balances.
    SPECIALS = {
        "<start_of_turn>": 259,
        "<end_of_turn>": 2,
        "user": 260,
        "model": 261,
        "[INST]": 262,
        "[/INST]": 263,
        "</s>": 2,
    }
    vocab_size = 264

    def __call__(self, text: str):
        ids = [self.bos_token_id]
        i = 0
        while i < len(text):
            for s, tid in self.SPECIALS.items():
                if text.startswith(s, i):
                    ids.append(tid)
                    i += len(s)
                    break
            else:
                ids.append(3 + text[i].encode("utf-8", "replace")[0])
                i += 1
        return _Enc(ids)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = []
        for t in ids:
            t = int(t)
            if t >= 3 + 256:
                if not skip_special_tokens:
                    out.append("<sot>")
            elif t >= 3:
                out.append(chr(t - 3))
            elif not skip_special_tokens:
                out.append({0: "<pad>", 1: "<bos>", 2: "<eot>"}[t])
        return "".join(out)
