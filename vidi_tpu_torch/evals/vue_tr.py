"""VUE-TR / VUE-TR-V2 temporal-retrieval evaluation (a copy of
vidi_tpu/evals/vue_tr.py for the port).

Behavior-identical rebuild of the reference scorers
(reference: VUE_TR_V2/qa_eval.py, VUE_TR/qa_eval.py): interval IoU with
floor/ceil prediction snapping, merged-span IoU, 101-threshold success curves
integrated with the trapezoid rule (AUC), interval precision/recall AUCs, and
breakdown over 12 attributes (5 duration buckets x 3 query formats x
3 modalities + overall).

v1 vs v2 delta (qa_eval diff at VUE_TR_V2/qa_eval.py:283-285): v2 counts a
query with empty GT *and* empty prediction as precision 1.0; v1 drops it.

    python -m vidi_tpu_torch.evals.vue_tr --pred_path results.json --gt_path gt.json
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
from typing import Dict, List, Sequence, Tuple

import numpy as np

ATTRIBUTES = (
    "ultra-short", "short", "medium", "long", "ultra-long",
    "keyword", "phrase", "sentence",
    "vision", "audio", "vision+audio",
    "overall",
)
_THRES = np.linspace(0, 1, 101)
_trapz = getattr(np, "trapezoid", None) or np.trapz


def merge_time_spans(intervals: np.ndarray) -> np.ndarray:
    """Sort by start and merge overlapping/adjacent spans."""
    if len(intervals) == 0:
        return np.array([])
    order = np.argsort(intervals[:, 0])
    intervals = intervals[order]
    merged = [intervals[0].astype(float).copy()]
    for start, end in intervals[1:]:
        if start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append(np.array([start, end], float))
    return np.array(merged)


def overlap_ratio(pred: np.ndarray, gt: np.ndarray) -> float:
    """Merged-interval IoU; empty-vs-empty scores 1, empty-pred scores 0."""
    gt = np.asarray(gt, float)
    pred = np.asarray(pred, float)
    if gt.size == 0:
        return 1.0 if pred.size == 0 else 0.0
    if pred.size == 0:
        return 0.0
    pred = merge_time_spans(pred)
    pred = pred[pred[:, 0] <= pred[:, 1]]
    len_gt = float(np.sum(gt[:, 1] - gt[:, 0]))
    len_pred = float(np.sum(pred[:, 1] - pred[:, 0])) if pred.size else 0.0
    inter = 0.0
    for p0, p1 in pred:
        lo = np.maximum(p0, gt[:, 0])
        hi = np.minimum(p1, gt[:, 1])
        inter += float(np.sum(np.maximum(0.0, hi - lo)))
    union = len_pred + len_gt - inter
    return float(np.clip(inter / (union + 1e-16), 0.0, 1.0))


def success_overlap(results: Sequence[Dict]) -> Tuple[np.ndarray, float]:
    """Per-query IoUs -> success-rate curve over 101 thresholds -> AUC."""
    iou = np.array([overlap_ratio(np.asarray(r["answer"]), r["gt"]) for r in results])
    n = len(results)
    success = np.array([np.sum(iou > t) / float(n + 1e-16) for t in _THRES])
    return success, float(_trapz(success, _THRES))


def _intersection(a: List[List[float]], b: List[List[float]]) -> List[Tuple[float, float]]:
    i = j = 0
    out = []
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if a[i][0] <= b[j][1] and b[j][0] <= a[i][1]:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _union(a: List[List[float]], b: List[List[float]]) -> List[List[float]]:
    ivs = sorted([list(x) for x in a] + [list(x) for x in b])
    out: List[List[float]] = []
    for iv in ivs:
        if out and iv[0] <= out[-1][1]:
            out[-1][1] = max(out[-1][1], iv[1])
        else:
            out.append(iv)
    return out


def compute_precision_recall(results: Sequence[Dict], avg: bool = True,
                             v1: bool = False):
    """Interval precision/recall; `avg` integrates the 101-threshold curves."""
    recall, precision = [], []
    for item in results:
        gt = [[min(iv), max(iv)] for iv in item["gt"] if len(iv) == 2]
        pred = [[min(iv), max(iv)] for iv in np.asarray(item["answer"]).tolist()
                if len(iv) == 2]
        # NOTE: the reference's two-pointer sweep runs on the lists in file
        # order, NOT sorted (qa_eval.py:221-240) — unsorted predictions can
        # lose overlap. Behavior-identical means replicating that quirk.
        inter = sum(e - s for s, e in _intersection(gt, pred))
        g = sum(e - s for s, e in gt)
        p = sum(e - s for s, e in pred)
        if g != 0:
            recall.append(inter / g)
        if g == 0 and p == 0:
            if not v1:
                precision.append(1.0)
        elif p != 0:
            precision.append(inter / p)
    precision = np.array(precision)
    recall = np.array(recall)
    if not avg:
        return precision, recall
    p_curve = np.array([np.mean(precision >= t) for t in _THRES])
    r_curve = np.array([np.mean(recall >= t) for t in _THRES])
    return float(_trapz(p_curve, _THRES)), float(_trapz(r_curve, _THRES))


def precision_recall_thres(results, v1: bool = False):
    precision, recall = compute_precision_recall(results, avg=False, v1=v1)
    p_curve = np.array([np.mean(precision >= t) for t in _THRES])
    r_curve = np.array([np.mean(recall >= t) for t in _THRES])
    return p_curve, r_curve


def load_result(gt_path: str, res_path: str) -> List[Dict]:
    """Join predictions to GT on query_id; floor starts / ceil ends of
    predictions (second-snapping, qa_eval.py:334-336)."""
    with open(gt_path) as f:
        gts = {g["query_id"]: g for g in json.load(f)}
    if res_path.endswith(".jsonl"):
        with open(res_path) as f:
            preds = [json.loads(x) for x in f]
    else:
        with open(res_path) as f:
            preds = json.load(f)
    for p in preds:
        qid = p.get("query_id", p.get("id"))
        ans = p["answer"]
        if len(ans) == 0 or (len(ans) == 1 and len(ans[0]) == 0):
            p["answer"] = np.array([])
        else:
            a = np.array(ans, float)
            a[:, 0] = np.floor(a[:, 0])
            a[:, 1] = np.ceil(a[:, 1])
            p["answer"] = a
        p.update(gts[qid])
        p["gt"] = np.array(p["gt"])
    return preds


def _subset(results, attr: str):
    if attr in ("ultra-short", "short", "medium", "long", "ultra-long"):
        return [r for r in results if r["duration_category"] == attr]
    if attr in ("keyword", "phrase", "sentence"):
        return [r for r in results if r["query_format"] == attr]
    if attr in ("audio", "vision", "vision+audio"):
        return [r for r in results if r["query_modality"] == attr]
    return list(results)


def evaluate(res_path: str, gt_path: str, v1: bool = False,
             breakdown: bool = True) -> Dict:
    results = load_result(gt_path, res_path)
    _, iou_auc = success_overlap(results)
    pre_auc, rec_auc = compute_precision_recall(results, v1=v1)
    out = {
        "n_query": len(results),
        "overall": {"iou": iou_auc, "precision": pre_auc, "recall": rec_auc},
    }
    if breakdown:
        per_attr = {}
        for attr in ATTRIBUTES:
            sub = _subset(results, attr)
            if not sub:
                continue
            _, iou = success_overlap(sub)
            p, r = compute_precision_recall(sub, v1=v1)
            per_attr[attr] = {"iou": iou, "precision": p, "recall": r, "n": len(sub)}
        out["attributes"] = per_attr
    return out


def evaluate_results(output_dir: str, res_paths: Sequence[str], gt_path: str,
                     v1: bool = False, plots: bool = True) -> Dict:
    """Multi-method comparison with per-attribute curves, radar plot, and the
    long-format results table CSV (qa_eval.py:340-370 evaluate_results +
    breakdown_results + print_attribute_result)."""
    import os

    all_results = {}
    for path in res_paths:
        name = osp.splitext(osp.basename(path))[0].replace("results_", "")
        results = load_result(gt_path, path)
        all_results[name] = results
        _, iou_auc = success_overlap(results)
        pre_auc, rec_auc = compute_precision_recall(results, v1=v1)
        print("-----------------------------------------------------")
        print(f"{name} # query={len(results)}")
        print(f"Precision: {pre_auc*100:.2f}%, Recall: {rec_auc*100:.2f}%, "
              f"IoU: {iou_auc*100:.2f}%")
        print("-----------------------------------------------------")

    # per-attribute breakdown for every method
    pre_scores = {m: np.zeros(len(ATTRIBUTES)) for m in all_results}
    rec_scores = {m: np.zeros(len(ATTRIBUTES)) for m in all_results}
    iou_scores = {m: np.zeros(len(ATTRIBUTES)) for m in all_results}
    curves = {metric: [dict() for _ in ATTRIBUTES]
              for metric in ("IoU", "Precision", "Recall")}
    for m, results in all_results.items():
        for j, attr in enumerate(ATTRIBUTES):
            sub = _subset(results, attr)
            curves["IoU"][j][m], iou_scores[m][j] = success_overlap(sub)
            curves["Precision"][j][m], curves["Recall"][j][m] = \
                precision_recall_thres(sub, v1=v1)
            pre_scores[m][j], rec_scores[m][j] = \
                compute_precision_recall(sub, v1=v1)

    if plots:
        from vidi_tpu_torch.evals.plots import draw_plot, radar_plot
        os.makedirs(output_dir, exist_ok=True)
        for j, attr in enumerate(ATTRIBUTES):
            for metric in ("IoU", "Precision", "Recall"):
                draw_plot(curves[metric][j], attr, metric, output_dir=output_dir)
        radar_plot(ATTRIBUTES, iou_scores, "IoU", output_dir)

    # long-format (attribute, method) table like results/results_table.csv
    import csv
    os.makedirs(output_dir, exist_ok=True)
    table_path = osp.join(output_dir, "results_table.csv")
    with open(table_path, "w", newline="") as f:
        # lineterminator: csv defaults to \r\n; the shipped reference table
        # (VUE_TR_V2/results/results_table.csv) is LF — keep byte-identity
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["attribute", "method", "precision", "recall", "iou"])
        for j, attr in enumerate(ATTRIBUTES):
            for m in all_results:
                w.writerow([attr, m,
                            f"{pre_scores[m][j]*100:.2f}%",
                            f"{rec_scores[m][j]*100:.2f}%",
                            f"{iou_scores[m][j]*100:.2f}%"])
                print(f"{attr:12s} {m:24s} P {pre_scores[m][j]*100:6.2f}%  "
                      f"R {rec_scores[m][j]*100:6.2f}%  "
                      f"IoU {iou_scores[m][j]*100:6.2f}%")
    return {"precision": pre_scores, "recall": rec_scores, "iou": iou_scores,
            "table": table_path}


def main(argv=None):
    ap = argparse.ArgumentParser(description="VUE-TR evaluation")
    ap.add_argument("--pred_path", required=True)
    ap.add_argument("--gt_path", required=True)
    ap.add_argument("--v1", action="store_true",
                    help="VUE-TR v1 precision semantics (drop empty-empty)")
    ap.add_argument("--output_csv", default=None)
    ap.add_argument("--output_dir", default=None,
                    help="write per-attribute curve plots, a radar plot, and "
                         "results_table.csv here (qa_eval.py evaluate_results)")
    ap.add_argument("--compare", nargs="*", default=[],
                    help="additional results_*.json files to compare against")
    args = ap.parse_args(argv)

    if args.output_dir or args.compare:
        evaluate_results(args.output_dir or "results",
                         [args.pred_path] + list(args.compare),
                         args.gt_path, v1=args.v1)
        return

    res = evaluate(args.pred_path, args.gt_path, v1=args.v1)
    o = res["overall"]
    name = osp.splitext(osp.basename(args.pred_path))[0].replace("results_", "")
    print("-----------------------------------------------------")
    print(f"{name} # query={res['n_query']}")
    print(f"Precision: {o['precision']*100:.2f}%, Recall: {o['recall']*100:.2f}%, "
          f"IoU: {o['iou']*100:.2f}%")
    print("-----------------------------------------------------")
    rows = []
    for attr, v in res.get("attributes", {}).items():
        rows.append((attr, f"{v['precision']*100:.2f}%", f"{v['recall']*100:.2f}%",
                     f"{v['iou']*100:.2f}%"))
        print(f"{attr:12s} P {rows[-1][1]:>8s}  R {rows[-1][2]:>8s}  IoU {rows[-1][3]:>8s}")
    if args.output_csv:
        import csv
        with open(args.output_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["attribute", "precision", "recall", "iou"])
            w.writerows(rows)


if __name__ == "__main__":
    main()
