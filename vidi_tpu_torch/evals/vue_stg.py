"""VUE-STG spatio-temporal grounding evaluation (port of
vidi_tpu/evals/vue_stg.py, without pandas: the CSVs are read with `csv`
and the tables are lists of row dicts, averaged with numpy; the numbers
and the summary CSV's columns are the reference's).

Behavior-identical rebuild of the reference scorer
(reference: VUE_STG/evaluate.py, VUE_STG/tube.py): tubes are
{quantized time_ms -> [sanitized bbox]} with 1-s round-half-up quantization;
per-frame region IoU uses a rectangle-union sweep-line; metric families are
temporal (frame-hit), 3D volume, and legacy mean-2D-IoU, with grouped
breakdowns over object size / video duration / GT duration.

The reference's self-check (single-box region math vs closed-form box IoU,
evaluate.py:229-237) is kept.

    python -m vidi_tpu_torch.evals.vue_stg --dataset vue-stg-benchmark \
        --pred results/vidi2/tubes.csv
"""
from __future__ import annotations

import argparse
import csv
import math
import os
import os.path as osp
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# pandas.read_csv's default missing-value strings
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
       "nan", "null"}
_INT_RE = re.compile(r"^[+-]?\d+$")


def _is_na(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _column(cells: List[str]) -> list:
    """One CSV column's cells typed as pandas.read_csv types them: int when
    every cell is an integer, float when every present cell parses as one
    (missing cells NaN), else str (missing cells None)."""
    present = [c for c in cells if c not in _NA]
    if len(present) == len(cells) and all(_INT_RE.match(c) for c in present):
        return [int(c) for c in cells]
    try:
        return [float("nan") if c in _NA else float(c) for c in cells]
    except ValueError:
        return [None if c in _NA else c for c in cells]


def read_csv(path: str) -> List[Dict]:
    """A CSV file -> its rows as dicts, typed column by column (`_column`)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return []
    header, body = rows[0], rows[1:]
    body = [r + [""] * (len(header) - len(r)) for r in body]
    cols = {h: _column([r[i] for r in body]) for i, h in enumerate(header)}
    return [{h: cols[h][j] for h in header} for j in range(len(body))]

BBox = Tuple[float, float, float, float]
EPS = np.finfo(float).eps


def sanitize_bbox(b: BBox) -> BBox:
    x0, y0, x1, y1 = b
    if x0 > x1:
        x0, x1 = x1, x0
    if y0 > y1:
        y0, y1 = y1, y0
    clamp = lambda v: max(0.0, min(1.0, v))  # noqa: E731
    return (clamp(x0), clamp(y0), clamp(x1), clamp(y1))


def quantize_time_ms(t_ms: int, step_ms: int = 1000) -> int:
    """Round-half-up to the step grid (tube.py:22-25)."""
    if step_ms <= 0:
        raise ValueError("step_ms must be positive")
    return ((t_ms * 2 + step_ms) // (2 * step_ms)) * step_ms


class Tube:
    def __init__(self, step_ms: int = 1000):
        self.step_ms = step_ms
        self.slices: Dict[int, List[BBox]] = {}

    def add_bbox(self, t_ms: int, bbox: BBox):
        t = quantize_time_ms(int(t_ms), self.step_ms)
        self.slices.setdefault(t, []).append(sanitize_bbox(bbox))

    def avg_area(self) -> float:
        areas = [
            (x1 - x0) * (y1 - y0)
            for boxes in self.slices.values() for x0, y0, x1, y1 in boxes
        ]
        return sum(areas) / len(areas) if areas else 0.0

    def length(self) -> int:
        return sum(1 for v in self.slices.values() if v)

    @staticmethod
    def from_csv(path: str, step_ms: int = 1000) -> Dict[str, "Tube"]:
        rows = read_csv(path)
        req = ["query_id", "time_ms", "x0", "y0", "x1", "y1"]
        with open(path, newline="") as f:
            header = next(csv.reader(f), [])
        missing = [c for c in req if c not in header]
        if missing:
            raise ValueError(f"CSV missing columns: {missing}")
        tubes: Dict[str, Tube] = {}
        for row in rows:
            if any(_is_na(row[c]) for c in req):
                continue
            qid = row["query_id"]
            tubes.setdefault(qid, Tube(step_ms)).add_bbox(
                int(row["time_ms"]), (float(row["x0"]), float(row["y0"]),
                                      float(row["x1"]), float(row["y1"])))
        return tubes


def union_area(rects: List[BBox]) -> float:
    """Union area of axis-aligned rectangles via x-strip sweep."""
    if not rects:
        return 0.0
    xs = sorted({x for r in rects for x in (r[0], r[2])})
    total = 0.0
    for x0, x1 in zip(xs, xs[1:]):
        dx = x1 - x0
        if dx <= 0:
            continue
        ys = sorted((r[1], r[3]) for r in rects if not (r[2] <= x0 or r[0] >= x1))
        if not ys:
            continue
        covered = 0.0
        cy0, cy1 = ys[0]
        for y0, y1 in ys[1:]:
            if y0 > cy1:
                covered += cy1 - cy0
                cy0, cy1 = y0, y1
            elif y1 > cy1:
                cy1 = y1
        covered += cy1 - cy0
        total += covered * dx
    return total


def region_inter_union(a: List[BBox], b: List[BBox]):
    area_a, area_b = union_area(a), union_area(b)
    if not a or not b:
        return 0.0, area_a + area_b, area_a, area_b
    inters = []
    for ax0, ay0, ax1, ay1 in a:
        for bx0, by0, bx1, by1 in b:
            ix0, iy0 = max(ax0, bx0), max(ay0, by0)
            ix1, iy1 = min(ax1, bx1), min(ay1, by1)
            if ix1 > ix0 and iy1 > iy0:
                inters.append((ix0, iy0, ix1, iy1))
    inter = union_area(inters)
    return inter, area_a + area_b - inter, area_a, area_b


def box_iou_parts(a: Optional[BBox], b: Optional[BBox]):
    """Closed-form single-box case, used as the internal cross-check."""
    area = lambda r: max(0.0, r[2] - r[0]) * max(0.0, r[3] - r[1]) if r else 0.0  # noqa: E731
    area_a, area_b = area(a), area(b)
    if a is None or b is None:
        return 0.0, area_a + area_b, area_a, area_b
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    return inter, area_a + area_b - inter, area_a, area_b


def compare_tubes(gt: Tube, pred: Tube, multi_boxes_policy: str = "first") -> Dict:
    ts = gt.slices.keys() | pred.slices.keys()
    assert ts, "Both tubes are empty; there is no frame to compare."
    inter_l, union_l, a_l, b_l = [], [], [], []
    for t in ts:
        sa = gt.slices.get(t, [])
        sb = pred.slices.get(t, [])
        if multi_boxes_policy == "first":
            sa, sb = sa[:1], sb[:1]
        elif multi_boxes_policy == "last":
            sa, sb = sa[-1:], sb[-1:]
        inter, union, area_a, area_b = region_inter_union(sa, sb)
        if len(sa) == 1 and len(sb) == 1:  # self-verifying metric
            ref = box_iou_parts(sa[0], sb[0])
            assert np.isclose(inter, ref[0]) and np.isclose(union, ref[1])
        inter_l.append(inter)
        union_l.append(union)
        a_l.append(area_a)
        b_l.append(area_b)

    inter = np.asarray(inter_l)
    union = np.asarray(union_l)
    aa = np.asarray(a_l)
    bb = np.asarray(b_l)
    n_a = int((aa > 0).sum())
    n_b = int((bb > 0).sum())
    n_i = int(np.logical_and(aa > 0, bb > 0).sum())
    n_u = int(np.logical_or(aa > 0, bb > 0).sum())
    iou2d = inter / (union + EPS)

    def safe(num, den):
        return None if den == 0 else num / den

    return {
        "t_iou": safe(n_i, n_u),
        "t_recall": safe(n_i, n_a),
        "t_precision": safe(n_i, n_b),
        "3d_iou": None if n_u == 0 else inter.sum() / (union.sum() + EPS),
        "3d_recall": None if n_a == 0 else inter.sum() / (aa.sum() + EPS),
        "3d_precision": None if n_b == 0 else inter.sum() / (bb.sum() + EPS),
        "v_iou": safe(iou2d.sum(), n_u),
        "v_recall": safe(iou2d.sum(), n_a),
        "v_precision": safe(iou2d.sum(), n_b),
        "v_iou_int": safe(iou2d.sum(), n_i),
    }


_COLS = {
    "t_iou": "t_IoU", "t_recall": "t_Recall", "t_precision": "t_Precision",
    "3d_iou": "3D_IoU", "3d_recall": "3D_Recall", "3d_precision": "3D_Precision",
    "v_iou": "v_IoU", "v_recall": "v_Recall", "v_precision": "v_Precision",
    "v_iou_int": "v_IoU_Int",
}


# (column, group column, right-open bin edges, labels): pd.cut(right=False)
_GROUPS = (
    ("avg_area", "area_group", (-np.inf, 0.10, 0.30, np.inf),
     ("<10%", "10%-30%", ">30%")),
    ("video_length", "video_length_group", (-np.inf, 60, 600, 1800),
     ("<1min", "1-10min", "10-30min")),
    ("gt_length", "gt_length_group", (-np.inf, 3, 10, 60),
     ("<3s", "3-10s", "10-60s")),
)
_SUMMARY_GROUPS = (("area_group", "object size"),
                   ("video_length_group", "video duration"),
                   ("gt_length_group", "gt duration"))
_SUMMARY_METRICS = ("t_Precision", "t_Recall", "t_IoU",
                    "v_Precision", "v_Recall", "v_IoU", "v_IoU_Int")


def _cut(x, edges, labels) -> Optional[str]:
    """The label of the bin [edges[i], edges[i+1]) holding x; None outside
    the edges or for NaN (pd.cut with right=False)."""
    if _is_na(x):
        return None
    i = int(np.digitize(x, edges, right=False))
    return labels[i - 1] if 1 <= i <= len(labels) else None


def add_groups(rows: List[Dict]) -> List[Dict]:
    out = []
    for r in rows:
        r = dict(r)
        for col, name, edges, labels in _GROUPS:
            r[name] = _cut(r[col], edges, labels)
        out.append(r)
    return out


class SpatioTemporalEvaluator:
    def __init__(self, step_ms: int = 1000):
        self.step_ms = step_ms
        self.video_info: Dict = {}
        self.query_info: Dict = {}
        self.gt_tubes: Dict[str, Tube] = {}

    def load_dataset(self, root: str):
        self.video_info = {v["video_id"]: v
                           for v in read_csv(osp.join(root, "video.csv"))}
        self.query_info = {q["query_id"]: q
                           for q in read_csv(osp.join(root, "query.csv"))}
        self.gt_tubes = Tube.from_csv(osp.join(root, "tubes.csv"), self.step_ms)

    def evaluate_pred_file(self, path: str, grouped: bool = True,
                           ignore_missing_pred: bool = False) -> List[Dict]:
        """-> one row dict a GT query: query_id, avg_area, video_length,
        gt_length, the metrics under their report names (NaN where a
        metric is undefined) and, with `grouped`, the group labels."""
        preds = Tube.from_csv(path, self.step_ms)
        rows = []
        for qid, gt in self.gt_tubes.items():
            if qid in preds:
                pred = preds[qid]
            elif ignore_missing_pred:
                continue
            else:
                pred = Tube(self.step_ms)
            vid = self.query_info[qid]["video_id"]
            row = {
                "query_id": qid,
                "avg_area": gt.avg_area(),
                "video_length": self.video_info[vid]["video_duration"],
                "gt_length": gt.length(),
            }
            for k, v in compare_tubes(gt, pred).items():
                row[_COLS[k]] = float("nan") if v is None else float(v)
            rows.append(row)
        return add_groups(rows) if grouped else rows


def _mean(rows: Sequence[Dict], col: str) -> float:
    vals = np.array([r[col] for r in rows], np.float64)
    vals = vals[~np.isnan(vals)]
    return float(vals.sum() / len(vals)) if len(vals) else float("nan")


def summarize(rows: List[Dict]) -> List[Dict]:
    """-> the overall row, then each group's rows (labels in bin order, the
    rows outside every bin last, category None): {"group", "category",
    metric: mean over the rows where it is defined}. A metric undefined on
    every row is left out, as pandas leaves out an all-None column."""
    if rows and "area_group" not in rows[0]:
        rows = add_groups(rows)
    metrics = [m for m in _SUMMARY_METRICS
               if any(not _is_na(r.get(m)) for r in rows)]

    def line(group, category, sub):
        return {"group": group, "category": category,
                **{m: _mean(sub, m) for m in metrics}}

    out = [line("overall", "overall", rows)]
    for col, group in _SUMMARY_GROUPS:
        labels = next(lab for _, name, _, lab in _GROUPS if name == col)
        for label in (*labels, None):
            sub = [r for r in rows if r[col] == label]
            if sub:
                out.append(line(group, label, sub))
    return out


def format_table(summary: List[Dict], digits: int = 4) -> str:
    """The summary as an aligned text table, values rounded to `digits`."""
    if not summary:
        return "(empty)"
    cols = list(summary[0])
    cells = [[("NaN" if _is_na(r[c]) else str(round(r[c], digits)))
              if c not in ("group", "category") else str(r[c]) for c in cols]
             for r in summary]
    width = [max(len(c), *(len(row[i]) for row in cells)) for i, c in enumerate(cols)]
    lines = ["  ".join(c.rjust(w) for c, w in zip(cols, width))]
    lines += ["  ".join(v.rjust(w) for v, w in zip(row, width)) for row in cells]
    return "\n".join(lines)


def write_csv(summary: List[Dict], path: str) -> None:
    """The summary as CSV, as DataFrame.to_csv(index=False) writes it:
    floats by repr, NaN and None as empty cells."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        cols = list(summary[0]) if summary else ["group", "category"]
        w.writerow(cols)
        for r in summary:
            w.writerow(["" if _is_na(r[c]) else r[c] for c in cols])


def main(argv=None):
    ap = argparse.ArgumentParser(description="VUE-STG evaluation")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--pred", required=True, nargs="+",
                    help="one or more tubes.csv files (the reference's "
                         "__main__ loops over several models' results)")
    ap.add_argument("--out_csv", default=None,
                    help="summary csv; with multiple --pred files, a "
                         "suffix per prediction file's parent dir")
    ap.add_argument("--ignore-missing-pred", action="store_true",
                    help="skip GT queries absent from predictions instead "
                         "of scoring them as empty tubes "
                         "(evaluate.py ignore_missing_pred)")
    args = ap.parse_args(argv)
    ev = SpatioTemporalEvaluator(step_ms=1000)
    ev.load_dataset(args.dataset)
    for pred in args.pred:
        if len(args.pred) > 1:
            print("=" * 64)
            print(f"Predictions: {pred}")
        rows = ev.evaluate_pred_file(
            pred, ignore_missing_pred=args.ignore_missing_pred)
        summary = summarize(rows)
        print(format_table(summary))
        if args.out_csv:
            out = args.out_csv
            if len(args.pred) > 1:
                tag = os.path.basename(os.path.dirname(pred)) or \
                    os.path.splitext(os.path.basename(pred))[0]
                root, ext = os.path.splitext(args.out_csv)
                out = f"{root}_{tag}{ext}"
            write_csv(summary, out)
            print(f"Saved: {out}")


if __name__ == "__main__":
    main()
