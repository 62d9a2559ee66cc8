"""VUE-PLOT evaluation: Character Grounding + Reasoning VQA (a copy of
vidi_tpu/evals/vue_plot.py for the port).

Behavior-identical rebuild of VUE_PLOT/character_eval.py and
VUE_PLOT/vqa_eval.py:
- Character grounding: greedy best-temporal-IoU (>=0.5) GT->pred segment
  matching; metrics = mean matched IoU, corpus WER over matched segments
  (clamped to [0,1]), bbox IoU on timestamp-matched boxes (20 ms tolerance),
  plus overall word accuracy ignoring timestamps.
- Reasoning VQA: exact-match (strip+upper) MCQ accuracy with per-task-type
  breakdown.

WER is computed with a built-in word-level Levenshtein (the reference uses
jiwer; same definition: edits / reference length).

    python -m vidi_tpu_torch.evals.vue_plot character --input_file results.json
    python -m vidi_tpu_torch.evals.vue_plot vqa --input results.json
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import re
from collections import defaultdict, namedtuple
from typing import Dict, List, Sequence

Segment = namedtuple("Segment", ["start", "end", "text", "boxes"])


# ---------------------------------------------------------------------------
# WER
# ---------------------------------------------------------------------------

def _words(s: str) -> List[str]:
    return [w for w in s.strip().split() if w]


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate = word-level edit distance / len(reference words)."""
    ref, hyp = _words(reference), _words(hypothesis)
    if not ref:
        return 0.0 if not hyp else float("inf")
    prev = list(range(len(hyp) + 1))
    for i, rw in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, hw in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (rw != hw))
        prev = cur
    return prev[-1] / len(ref)


def _clamped_wer(ref: str, hyp: str) -> float:
    if not ref:
        return 1.0
    w = wer(ref, hyp)
    return min(max(w, 0.0), 1.0)


# ---------------------------------------------------------------------------
# Character grounding
# ---------------------------------------------------------------------------

def temporal_iou(a: Segment, b: Segment) -> float:
    inter = max(0.0, min(a.end, b.end) - max(a.start, b.start))
    union = (a.end - a.start) + (b.end - b.start) - inter
    return inter / union if union != 0 else 0.0


def box_iou(b1: Sequence[float], b2: Sequence[float]) -> float:
    ix0, iy0 = max(b1[0], b2[0]), max(b1[1], b2[1])
    ix1, iy1 = min(b1[2], b2[2]), min(b1[3], b2[3])
    inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
    union = ((b1[2] - b1[0]) * (b1[3] - b1[1])
             + (b2[2] - b2[0]) * (b2[3] - b2[1]) - inter)
    return inter / union if union != 0 else 0.0


def compare_transcripts(pred_segments: List[Segment], gt_segments: List[Segment],
                        iou_threshold: float = 0.5,
                        bbox_time_tolerance: float = 0.02) -> Dict:
    """Greedy GT->pred matching by best temporal IoU (character_eval.py:92-113)."""
    matches = []
    used = set()
    for gt_seg in gt_segments:
        best_iou, best_idx = -1.0, -1
        for pi, pred_seg in enumerate(pred_segments):
            if pi in used:
                continue
            iou = temporal_iou(gt_seg, pred_seg)
            if iou > best_iou:
                best_iou, best_idx = iou, pi
        if best_iou >= iou_threshold:
            matches.append({"gt": gt_seg, "pred": pred_segments[best_idx],
                            "iou": best_iou})
            used.add(best_idx)

    overall_gt = " ".join(s.text for s in gt_segments).lower()
    overall_pred = " ".join(s.text for s in pred_segments).lower()
    overall_wer = _clamped_wer(overall_gt, overall_pred)

    if not matches:
        return {"metrics": {
            "temporal_iou_avg": 0,
            "word_error_rate": 1.0,
            "overall_word_accuracy": 1.0 - overall_wer,
            "overall_word_error": overall_wer,
            "average_box_iou": 0,
            "total_gt_segments": len(gt_segments),
            "total_pred_segments": len(pred_segments),
            "matched_segments": 0,
        }, "matches": []}

    total_iou = sum(m["iou"] for m in matches)
    gt_corpus = " ".join(m["gt"].text for m in matches).lower()
    pred_corpus = " ".join(m["pred"].text for m in matches).lower()
    matched_wer = _clamped_wer(gt_corpus, pred_corpus)

    total_box_iou, box_matches = 0.0, 0
    for m in matches:
        gt_seg, pred_seg = m["gt"], m["pred"]
        if gt_seg.boxes and pred_seg.boxes:
            for gt_box in gt_seg.boxes:
                best_dt, best_pred_box = float("inf"), None
                for pred_box in pred_seg.boxes:
                    dt = abs(gt_box["timestamp"] - pred_box["timestamp"])
                    if dt < best_dt:
                        best_dt, best_pred_box = dt, pred_box
                if float(best_dt) < bbox_time_tolerance:
                    try:
                        biou = box_iou(gt_box["box_2d"], best_pred_box["box_2d"])
                    except Exception:  # noqa: BLE001 — reference swallows too
                        biou = 0.0
                    total_box_iou += biou
                    box_matches += 1

    return {"metrics": {
        "temporal_iou_avg": total_iou / len(matches),
        "average_box_iou": total_box_iou / box_matches if box_matches else 0,
        "word_error_rate": matched_wer,
        "overall_word_accuracy": 1.0 - overall_wer,
        "overall_word_error": overall_wer,
        "total_gt_segments": len(gt_segments),
        "total_pred_segments": len(pred_segments),
        "matched_segments": len(matches),
    }, "matches": [{"gt": m["gt"]._asdict(), "pred": m["pred"]._asdict(),
                    "iou": m["iou"]} for m in matches]}


def _norm_boxes(items: List[Dict]):
    """Coordinates may be 0-1 or 0-1000 (divided by 1000 when any > 1,
    character_eval.py:293-295)."""
    for item in items:
        item["start"] = float(item["start"])
        item["end"] = float(item["end"])
        for box in item.get("boxes", []):
            box["timestamp"] = float(box["timestamp"])
            if any(c > 1.0 for c in box["box_2d"]):
                box["box_2d"] = [float(c / 1000) for c in box["box_2d"]]


def extract_answer(text: str) -> str:
    m = re.search(r"<answer>\s*(.*?)\s*</answer>", text, re.DOTALL)
    # bare-text fallback: first char, whitespace included, exactly like the
    # reference's text[0] (VUE_PLOT/character_eval.py:252) — a leading-space
    # output scores its space char (wrong answer). [:1] only avoids the
    # reference's IndexError crash on fully-empty output.
    return m.group(1).strip() if m else text[:1]


def evaluate_character(input_file: str) -> Dict:
    with open(input_file) as f:
        results = json.load(f)
    by_qid = {r["query_id"]: r for r in results}
    totals = defaultdict(float)
    num_pred = 0
    for ques in copy.deepcopy(results):
        pred = by_qid.get(ques["query_id"])
        if pred is None:
            continue
        num_pred += 1
        gt_json, pred_json = pred["gt"], pred["pred"]
        _norm_boxes(gt_json)
        _norm_boxes(pred_json)
        gt_segs = [Segment(i["start"], i["end"], i.get("text", ""),
                           i.get("boxes", [])) for i in gt_json]
        pred_segs = [Segment(i["start"], i["end"], i.get("text", ""),
                             i.get("boxes", [])) for i in pred_json]
        for k, v in compare_transcripts(pred_segs, gt_segs)["metrics"].items():
            totals[k] += v
    out = dict(totals)
    if num_pred:
        for k in out:
            if "total" not in k and "matched" not in k:
                out[k] /= num_pred
    out["num_questions"] = len(results)
    return out


# summary key order is the reference's total_metrics insertion order
# (VUE_PLOT/character_eval.py:262-271)
_SUMMARY_KEYS = (
    "temporal_iou_avg", "average_box_iou", "word_error_rate",
    "overall_word_accuracy", "overall_word_error", "total_gt_segments",
    "total_pred_segments", "matched_segments")


def write_summary(metrics: Dict, output_dir: str) -> str:
    """Write eval_summary.txt byte-identical to the reference writer
    (VUE_PLOT/character_eval.py:352-359, cf. the shipped
    Character_Grounding/results/eval_summary.txt)."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "eval_summary.txt")
    with open(path, "w") as f:
        f.write("Evaluation Summary:\n")
        f.write("===================\n")
        for key in _SUMMARY_KEYS:
            f.write(f"{key}: {float(metrics.get(key, 0.0)):.4f}\n")
        f.write(f"\nTotal Questions: {metrics['num_questions']}\n")
    return path


# ---------------------------------------------------------------------------
# Reasoning VQA
# ---------------------------------------------------------------------------

def evaluate_vqa(input_file: str) -> Dict:
    with open(input_file, encoding="utf-8") as f:
        data = json.load(f)
    total_correct = total = 0
    per_task = defaultdict(lambda: {"correct": 0, "total": 0})
    for item in data:
        pred, ans = item.get("pred_answer"), item.get("answer")
        if pred is None or ans is None:
            continue
        task = item.get("task_type", "Unknown")
        ok = str(pred).strip().upper() == str(ans).strip().upper()
        total += 1
        per_task[task]["total"] += 1
        if ok:
            total_correct += 1
            per_task[task]["correct"] += 1
    return {
        "overall_accuracy": total_correct / total * 100 if total else 0.0,
        "total": total,
        "correct": total_correct,
        "per_task": {
            k: {"accuracy": v["correct"] / v["total"] * 100 if v["total"] else 0.0,
                **v}
            for k, v in sorted(per_task.items())
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="VUE-PLOT evaluation")
    sub = ap.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("character")
    c.add_argument("--input_file", required=True)
    c.add_argument("--output_dir", default=None,
                   help="also write eval_summary.txt here (reference "
                        "character_eval.py:352-359 format)")
    c.add_argument("--visualize", action="store_true",
                   help="render pred (red) / gt (green) tubes onto the "
                        "videos (reference character_eval.py --visualize)")
    c.add_argument("--video_dir", default="",
                   help="video files for --visualize (named <video_id>.mp4)")
    v = sub.add_parser("vqa")
    v.add_argument("--input", required=True)
    args = ap.parse_args(argv)
    if args.mode == "character":
        out = evaluate_character(args.input_file)
        for k, val in out.items():
            print(f"{k}: {val:.4f}" if isinstance(val, float) else f"{k}: {val}")
        if args.output_dir:
            print("summary:", write_summary(out, args.output_dir))
        if args.visualize:
            from vidi_tpu_torch.evals.visualize import draw_tubes_video

            vis_dir = args.output_dir or "."
            os.makedirs(vis_dir, exist_ok=True)
            with open(args.input_file) as f:
                for rec in json.load(f):
                    vid = os.path.join(args.video_dir,
                                       str(rec.get("video_id",
                                                   rec["query_id"])) + ".mp4")
                    if not os.path.exists(vid):
                        print(f"skip {rec['query_id']}: no video at {vid}")
                        continue
                    dst = os.path.join(vis_dir, f"{rec['query_id']}_vis.mp4")
                    frames = draw_tubes_video(vid, dst, rec.get("pred", []),
                                              rec.get("gt"))
                    print(f"wrote {dst} ({frames} frames)")
    else:
        out = evaluate_vqa(args.input)
        print("-" * 60)
        for task, st in out["per_task"].items():
            print(f"{task:<45} | {st['accuracy']:.2f}% "
                  f"({st['correct']}/{st['total']})")
        print("-" * 60)
        print(f"{'Overall Accuracy':<45} | {out['overall_accuracy']:.2f}% "
              f"({out['correct']}/{out['total']})")


if __name__ == "__main__":
    main()
