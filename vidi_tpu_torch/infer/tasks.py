"""Task prompts and answer parsers (restated from vidi_tpu/infer/tasks.py,
whose module imports the JAX pipeline). `mm_version` "v1" (Vidi-7B) takes
its own TR prompt, which states the video length, and its looser range
pattern.

Output contracts: TR gives normalized `a.aaa-b.bbb` ranges (scaled to
seconds by the video length); chapters and highlights use the same ranges
per line; MCQ a letter, optionally in <answer></answer>; character
grounding `t0-t1: "text" [ts: x0,y0,x1,y1; ...]` lines.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from vidi_tpu_torch.infer.pipeline import (TIME_RANGE_RE, TIME_RANGE_RE_V1, TR_PROMPT,
                                           TR_PROMPT_V1, parse_time_ranges)

STG_PROMPT = ("During which time segments in the video can we see {}? For "
              "each segment, give the bounding box of the target as "
              "t0-t1: x0,y0,x1,y1.")
CHAPTER_PROMPT = ("Divide the video into chapters. For each chapter, answer "
                  "the time range as normalized values followed by a short "
                  "title, one per line.")
HIGHLIGHT_PROMPT = ("Which time segments of the video are the highlights"
                    "{}? Answer the time ranges as normalized values.")
QA_PROMPT = "{}"
MCQ_PROMPT = ("{question}\nOptions:\n{options}\nAnswer with the letter of "
              "the correct option.")
CHARACTER_PROMPT = (
    'Transcribe what {} says in the video. For each utterance, answer the '
    'normalized time range, the transcript in quotes, and the bounding box '
    'of the speaker at each timestamp, like '
    '0.123-0.145: "the transcript" [0.130: 0.21,0.30,0.45,0.92; '
    '0.140: 0.22,0.31,0.46,0.93], one utterance per line.')

CHARACTER_SEG_RE = re.compile(
    r'(\d\.\d+)-(\d\.\d+)\s*:\s*"([^"]*)"\s*\[([^\]]*)\]')
CHARACTER_BOX_RE = re.compile(
    r"(\d\.\d+)\s*:\s*([\d.]+)\s*,\s*([\d.]+)\s*,\s*([\d.]+)\s*,\s*([\d.]+)")


def build_task_prompt(task: str, query: str = "", *, mm_version: str = "v1.5",
                      length: float = 0.0,
                      options: Optional[List[str]] = None) -> str:
    """-> the user-turn text (before chat templating / <image> splicing)."""
    q = query[:-1] if query.endswith(".") else query
    if task == "tr":
        return TR_PROMPT_V1.format(length, q) if mm_version == "v1" else TR_PROMPT.format(q)
    if task == "stg":
        return STG_PROMPT.format(q)
    if task == "chapter":
        return CHAPTER_PROMPT
    if task == "highlight":
        return HIGHLIGHT_PROMPT.format(f" related to {q}" if q else "")
    if task == "qa":
        return QA_PROMPT.format(query)
    if task == "mcq":
        opts = "\n".join(f"{chr(65 + i)}. {o}" for i, o in enumerate(options or []))
        return MCQ_PROMPT.format(question=query, options=opts)
    if task == "character":
        return CHARACTER_PROMPT.format(q)
    raise ValueError(f"unknown task: {task}")


def parse_character(text: str, duration: float) -> List[Dict]:
    """Character-grounding text -> [{"start", "end", "text", "boxes":
    [{"timestamp", "box_2d"}]}], times in seconds; 0-1000 boxes scaled to
    0-1."""
    segs = []
    for m in CHARACTER_SEG_RE.finditer(text):
        boxes = []
        for bm in CHARACTER_BOX_RE.finditer(m.group(4)):
            box = [float(bm.group(i)) for i in range(2, 6)]
            if any(c > 1.0 for c in box):
                box = [c / 1000.0 for c in box]
            boxes.append({"timestamp": float(bm.group(1)) * duration,
                          "box_2d": box})
        segs.append({"start": float(m.group(1)) * duration,
                     "end": float(m.group(2)) * duration,
                     "text": m.group(3).strip(), "boxes": boxes})
    return segs


def parse_chapters(text: str, length: float,
                   mm_version: str = "v1.5") -> List[Dict]:
    """Chaptering output -> [{"start", "end", "title"}] in seconds."""
    pattern = TIME_RANGE_RE_V1 if mm_version == "v1" else TIME_RANGE_RE
    out = []
    for line in text.splitlines():
        m = pattern.search(line)
        if not m:
            continue
        try:
            t0, t1 = float(m.group(1)), float(m.group(2))
        except ValueError:  # v1's loose pattern may match '..'
            continue
        title = line[m.end():].strip(" :–-\t")
        out.append({"start": t0 * length, "end": t1 * length, "title": title})
    return out


def parse_highlights(text: str, length: float,
                     mm_version: str = "v1.5") -> List[Tuple[float, float]]:
    return [(a * length, b * length) for a, b in parse_time_ranges(text, mm_version)]


def extract_answer(text: str) -> str:
    m = re.search(r"<answer>\s*(.*?)\s*</answer>", text, re.DOTALL)
    # bare-text fallback: first char, whitespace included, exactly like the
    # reference's text[0] (VUE_PLOT/character_eval.py:252) — a leading-space
    # output scores its space char (wrong answer). [:1] only avoids the
    # reference's IndexError crash on fully-empty output.
    return m.group(1).strip() if m else text[:1]


def parse_mcq(text: str) -> str:
    """MCQ letter, <answer>-wrapped or bare."""
    return extract_answer(text)
