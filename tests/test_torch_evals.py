"""The port's evals (`vidi_tpu_torch/evals`) against vidi_tpu's: the unit
cases of tests/test_evals.py run on both packages, and every eval function
and CLI on seeded made-up predictions and ground truths. vue_stg has no
pandas in the port: its rows and summaries are held to the reference's
DataFrame values within 1e-12 (the reference's groupby means sum in another
order), with the same summary CSV columns.
"""
import contextlib
import csv
import io
import json
import math
import os
import sys

import numpy as np
import pytest

from vidi_tpu.evals import vue_plot as j_plot
from vidi_tpu.evals import vue_stg as j_stg
from vidi_tpu.evals import vue_tr as j_tr
from vidi_tpu_torch.evals import vue_plot as t_plot
from vidi_tpu_torch.evals import vue_stg as t_stg
from vidi_tpu_torch.evals import vue_tr as t_tr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"vidi_tpu": (j_tr, j_stg, j_plot), "vidi_tpu_torch": (t_tr, t_stg, t_plot)}
TOL = 1e-12


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _cli(main, argv, monkeypatch, takes_argv):
    """stdout of one CLI run (the reference's mains read sys.argv)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if takes_argv:
            main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["eval", *argv])
            main()
    return buf.getvalue()


# ---------------------------------------------------------------------------
# tests/test_evals.py's unit cases, on both packages
# ---------------------------------------------------------------------------

def test_merge_time_spans(pkg):
    out = pkg[0].merge_time_spans(np.array([[5.0, 7.0], [1.0, 3.0], [3.0, 4.0]]))
    np.testing.assert_allclose(out, [[1, 4], [5, 7]])


def test_overlap_ratio_edges(pkg):
    tr = pkg[0]
    assert tr.overlap_ratio(np.array([]), np.array([])) == 1.0
    assert tr.overlap_ratio(np.array([[1, 2]]), np.array([])) == 0.0
    assert tr.overlap_ratio(np.array([]), np.array([[1, 2]])) == 0.0
    assert tr.overlap_ratio(np.array([[1, 3]]), np.array([[1, 3]])) == pytest.approx(1.0)
    assert tr.overlap_ratio(np.array([[0, 2]]), np.array([[1, 3]])) == \
        pytest.approx(1 / 3, abs=1e-9)


def test_precision_recall_v1_vs_v2_empty_empty(pkg):
    results = [{"gt": [], "answer": np.array([])}]
    p2, _ = pkg[0].compute_precision_recall(results, avg=False, v1=False)
    p1, _ = pkg[0].compute_precision_recall(results, avg=False, v1=True)
    assert list(p2) == [1.0] and list(p1) == []


def test_quantize_round_half_up(pkg):
    q = pkg[1].quantize_time_ms
    assert [q(499), q(500), q(1499), q(1500)] == [0, 1000, 1000, 2000]


def test_union_area_vs_grid(pkg):
    rects = [(0.0, 0.0, 0.5, 0.5), (0.25, 0.25, 0.75, 0.75), (0.6, 0.0, 0.9, 0.2)]
    got = pkg[1].union_area(rects)
    n = 400
    xs = (np.arange(n) + 0.5) / n
    grid = np.zeros((n, n), bool)
    for x0, y0, x1, y1 in rects:
        grid |= ((xs[:, None] > x0) & (xs[:, None] < x1)
                 & (xs[None, :] > y0) & (xs[None, :] < y1))
    assert abs(got - grid.mean()) < 5e-3


def test_compare_tubes_simple(pkg):
    stg = pkg[1]
    gt, pred = stg.Tube(), stg.Tube()
    gt.add_bbox(1000, (0.0, 0.0, 0.5, 0.5))
    gt.add_bbox(2000, (0.0, 0.0, 0.5, 0.5))
    pred.add_bbox(1000, (0.0, 0.0, 0.5, 0.5))
    pred.add_bbox(3000, (0.0, 0.0, 0.5, 0.5))
    m = stg.compare_tubes(gt, pred)
    assert m["t_iou"] == pytest.approx(1 / 3)
    assert m["t_recall"] == pytest.approx(1 / 2)
    assert m["t_precision"] == pytest.approx(1 / 2)
    assert m["v_iou_int"] == pytest.approx(1.0, abs=1e-9)


def test_sanitize_bbox_swaps_and_clamps(pkg):
    assert pkg[1].sanitize_bbox((0.9, 1.5, 0.1, -0.2)) == (0.1, 0.0, 0.9, 1.0)


def test_wer_basic(pkg):
    wer = pkg[2].wer
    assert wer("a b c", "a b c") == 0.0
    assert wer("a b c", "a x c") == pytest.approx(1 / 3)
    assert wer("a b c", "") == pytest.approx(1.0)
    assert wer("a", "a b b b") == pytest.approx(3.0)


def test_compare_transcripts_fixture(pkg):
    S = pkg[2].Segment
    gt = [S(0.0, 10.0, "hello world", [{"timestamp": 5.0, "box_2d": [0.0, 0.0, 0.5, 0.5]}])]
    pred = [S(1.0, 10.0, "hello world", [{"timestamp": 5.01, "box_2d": [0.0, 0.0, 0.5, 0.5]}])]
    out = pkg[2].compare_transcripts(pred, gt)["metrics"]
    assert out["matched_segments"] == 1
    assert out["temporal_iou_avg"] == pytest.approx(0.9)
    assert out["word_error_rate"] == 0.0
    assert out["average_box_iou"] == pytest.approx(1.0)
    pred2 = [S(1.0, 10.0, "hello world", [{"timestamp": 5.5, "box_2d": [0.0, 0.0, 0.5, 0.5]}])]
    assert pkg[2].compare_transcripts(pred2, gt)["metrics"]["average_box_iou"] == 0


def test_box_norm_0_1000(pkg):
    items = [{"start": 0, "end": 1, "boxes": [
        {"timestamp": 0.5, "box_2d": [100, 200, 500, 900]}]}]
    pkg[2]._norm_boxes(items)
    assert items[0]["boxes"][0]["box_2d"] == [0.1, 0.2, 0.5, 0.9]


def test_extract_answer(pkg):
    ea = pkg[2].extract_answer
    assert ea("<answer> B </answer>") == "B"
    assert ea("Cats") == "C"
    assert ea("") == "" and ea("   ") == " " and ea(" B) late") == " "


# ---------------------------------------------------------------------------
# Seeded made-up data through both packages
# ---------------------------------------------------------------------------

def _tr_data(tmp_path, seed):
    """A TR ground truth of 24 queries over the 12 attributes and two
    prediction files (the second with empty and unsorted answers)."""
    rng = np.random.default_rng(seed)
    cats = ("ultra-short", "short", "medium", "long", "ultra-long")
    gts, preds = [], [[], []]
    for i in range(24):
        dur = float(rng.integers(20, 3000))
        gt = sorted([sorted(rng.uniform(0, dur, 2).round(2).tolist())
                     for _ in range(rng.integers(0, 3))])
        gts.append({"query_id": i, "video_id": f"v{i % 7}", "duration": dur,
                    "gt": gt, "duration_category": cats[i % 5],
                    "query_format": ("keyword", "phrase", "sentence")[i % 3],
                    "query_modality": ("vision", "audio", "vision+audio")[(i // 3) % 3]})
        for k, p in enumerate(preds):
            n = int(rng.integers(0, 4)) if k else 1 + int(rng.integers(0, 2))
            ans = [sorted(rng.uniform(0, dur, 2).round(3).tolist()) for _ in range(n)]
            if k and i % 5 == 0:
                ans = [[]]
            p.append({"query_id": i, "answer": ans[::-1] if k else ans})
    gt_path = tmp_path / "gt.json"
    gt_path.write_text(json.dumps(gts))
    paths = []
    for k, p in enumerate(preds):
        paths.append(tmp_path / f"results_m{k}.json")
        paths[-1].write_text(json.dumps(p))
    return str(gt_path), [str(p) for p in paths]


@pytest.mark.parametrize("v1", [False, True], ids=["v2", "v1"])
def test_vue_tr_evaluate_matches(tmp_path, v1):
    gt, preds = _tr_data(tmp_path, 3)
    for pred in preds:
        want = j_tr.evaluate(pred, gt, v1=v1)
        got = t_tr.evaluate(pred, gt, v1=v1)
        # equal, NaN (an empty subset's mean) included
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_vue_tr_cli_and_plots_match(tmp_path, monkeypatch):
    """The CLIs' output, CSVs and plot files; the plots are saved at a low
    dpi to keep the test short (both packages draw through pyplot)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    real = plt.savefig
    monkeypatch.setattr(plt, "savefig", lambda *a, **kw: real(*a, **{**kw, "dpi": 10}))
    gt, preds = _tr_data(tmp_path, 4)
    outs = {}
    for name, main, takes in (("j", j_tr.main, False), ("t", t_tr.main, True)):
        d = tmp_path / name
        text = _cli(main, ["--pred_path", preds[0], "--gt_path", gt, "--output_csv",
                           str(tmp_path / f"{name}.csv")], monkeypatch, takes)
        table = _cli(main, ["--pred_path", preds[0], "--gt_path", gt, "--compare",
                            preds[1], "--output_dir", str(d)], monkeypatch, takes)
        files = sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())
        outs[name] = (text, (tmp_path / f"{name}.csv").read_bytes(), table,
                      (d / "results_table.csv").read_bytes(), files)
    assert outs["t"] == outs["j"]
    assert "overall_IoU_plot.pdf" in outs["t"][4] and len(outs["t"][4]) == 41


def _plot_data(tmp_path, seed):
    rng = np.random.default_rng(seed)
    words = ["hello", "there", "bye", "the", "red", "car", "now"]

    def seg(t0):
        n = int(rng.integers(0, 3))
        boxes = [{"timestamp": round(t0 + float(rng.uniform(0, 2)), 3),
                  "box_2d": (rng.uniform(0, 1, 4) * (1000 if rng.random() < 0.3 else 1))
                  .round(3).tolist()} for _ in range(n)]
        return {"start": t0, "end": round(t0 + float(rng.uniform(0.5, 4)), 2),
                "text": " ".join(rng.choice(words, int(rng.integers(1, 5)))),
                "boxes": boxes}

    char = []
    for i in range(8):
        gt = [seg(float(5 * k)) for k in range(int(rng.integers(0, 4)))]
        pred = ([dict(s, start=s["start"] + float(rng.uniform(-0.5, 0.5))) for s in gt]
                if i % 3 else [seg(float(3 * k)) for k in range(2)])
        char.append({"query_id": f"c{i}", "video_id": f"v{i}", "character": "x",
                     "gt": gt, "pred": pred, "duration": 60.0})
    vqa = [{"problem_id": i, "video_id": f"v{i % 3}", "answer": "ABCD"[i % 4],
            "pred_answer": (None if i == 5 else ["A", "b ", " C", "D", "E"][i % 5]),
            "task_type": ("Perception", "Narrative", "Audio")[i % 3]}
           for i in range(20)]
    cp, vp = tmp_path / "char.json", tmp_path / "vqa.json"
    cp.write_text(json.dumps(char))
    vp.write_text(json.dumps(vqa))
    return str(cp), str(vp)


def test_vue_plot_matches(tmp_path, monkeypatch):
    cp, vp = _plot_data(tmp_path, 5)
    assert t_plot.evaluate_character(cp) == j_plot.evaluate_character(cp)
    assert t_plot.evaluate_vqa(vp) == j_plot.evaluate_vqa(vp)
    outs = {}
    for name, main, takes in (("j", j_plot.main, False), ("t", t_plot.main, True)):
        d = tmp_path / name
        outs[name] = (
            _cli(main, ["character", "--input_file", cp, "--output_dir", str(d)],
                 monkeypatch, takes).replace(str(d), "DIR"),
            (d / "eval_summary.txt").read_text(),
            _cli(main, ["vqa", "--input", vp], monkeypatch, takes))
    assert outs["t"] == outs["j"]


def test_vue_plot_visualize_uses_the_port(tmp_path, monkeypatch):
    """--visualize renders with the port's `visualize` (no vidi_tpu module)."""
    import cv2
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from make_example import make_video

    make_video(str(tmp_path / "v1.mp4"), seconds=2, fps=5, size=64)
    recs = [{"query_id": "q1", "video_id": "v1",
             "gt": [{"start": 0.0, "end": 1.0, "text": "alice",
                     "boxes": [{"timestamp": 0.0, "box_2d": [0.1, 0.1, 0.5, 0.5]}]}],
             "pred": [{"start": 0.0, "end": 1.0, "text": "alice",
                       "boxes": [{"timestamp": 0.0, "box_2d": [0.1, 0.1, 0.5, 0.5]},
                                 {"timestamp": 1.0, "box_2d": [0.2, 0.2, 0.6, 0.6]}]}]}]
    inp = tmp_path / "char.json"
    inp.write_text(json.dumps(recs))
    calls = []
    from vidi_tpu_torch.evals import visualize as t_vis
    real = t_vis.draw_tubes_video
    monkeypatch.setattr(t_vis, "draw_tubes_video",
                        lambda *a, **kw: calls.append(a[:2]) or real(*a, **kw))
    text = _cli(t_plot.main, ["character", "--input_file", str(inp), "--output_dir",
                              str(tmp_path / "out"), "--visualize", "--video_dir",
                              str(tmp_path)], monkeypatch, True)
    out = tmp_path / "out" / "q1_vis.mp4"
    assert len(calls) == 1 and out.exists() and "wrote" in text
    cap = cv2.VideoCapture(str(out))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 10
    cap.release()


def test_visualize_matches(tmp_path):
    from vidi_tpu.evals import visualize as j_vis
    from vidi_tpu_torch.evals import visualize as t_vis

    segs = [{"text": "alice",
             "boxes": [{"timestamp": 0.0, "box_2d": [0.1, 0.1, 0.5, 0.5]},
                       {"timestamp": 1.0, "box_2d": [0.2, 0.2, 0.6, 0.6]},
                       {"timestamp": 0.5, "box_2d": [10, 20, 50, 60]}]},
            {"text": "bob", "boxes": [{"timestamp": 4.0, "box_2d": [0, 0, 1, 1]}]}]
    by = {}
    for name, mod in (("j", j_vis), ("t", t_vis)):
        by[name] = {}
        mod.collect_boxes_by_frame(segs, duration=3.0, fps=5, frame_count=20, width=100,
                                   height=80, color=(0, 0, 255), caption_prefix="p",
                                   boxes_by_frame=by[name], interpolate=True)
    assert by["t"] == by["j"] and set(by["t"]) >= {0, 1, 2, 3, 4, 5}


# ---------------------------------------------------------------------------
# VUE-STG: the pandas-free port against the reference's DataFrames
# ---------------------------------------------------------------------------

def _write_csv(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _stg_data(tmp_path, seed, ids, pred_kind):
    """A VUE-STG dataset dir (video.csv, query.csv, tubes.csv) of 14 queries
    over 6 videos whose durations and tube lengths cover every group and
    fall outside the last bins too, and a prediction tubes.csv."""
    rng = np.random.default_rng(seed)
    root = tmp_path / "ds"
    root.mkdir()
    durations = [30.0, 59.5, 200, 600, 1200, 2400]
    _write_csv(root / "video.csv", ["video_id", "video_duration"],
               [[f"vid{i}", d] for i, d in enumerate(durations)])
    qid = (lambda i: 100 + i) if ids == "int" else (lambda i: f"q{i:02d}")
    lengths = [1, 2, 3, 5, 9, 10, 20, 59, 60, 75, 4, 1, 30, 12]
    _write_csv(root / "query.csv", ["query_id", "video_id", "text"],
               [[qid(i), f"vid{i % 6}", f"query {i}"] for i in range(len(lengths))])
    gt_rows, pred_rows = [], []
    for i, n in enumerate(lengths):
        t0 = int(rng.integers(0, 50)) * 1000
        area = (0.02, 0.2, 0.6)[i % 3]
        side = math.sqrt(area)
        for k in range(n):
            x, y = rng.uniform(0, 1 - side, 2)
            box = [x, y, x + side, y + side]
            gt_rows.append([qid(i), t0 + 1000 * k + int(rng.integers(-400, 400)),
                            *np.round(box, 4)])
            if pred_kind != "empty" and i % 4 != 3 and rng.random() < 0.8:
                jit = rng.normal(0, 0.03, 4)
                pred_rows.append([qid(i), t0 + 1000 * (k + 1),
                                  *np.round(np.array(box) + jit, 4)])
                if rng.random() < 0.2:  # a second box at one time
                    pred_rows.append([qid(i), t0 + 1000 * (k + 1), 0.9, 0.9, 0.1, 0.1])
    gt_rows.append([qid(0), "", 0.1, 0.1, 0.2, 0.2])  # a row dropped as NaN
    _write_csv(root / "tubes.csv", ["query_id", "time_ms", "x0", "y0", "x1", "y1"], gt_rows)
    pred = tmp_path / "run" / "tubes.csv"
    pred.parent.mkdir()
    _write_csv(pred, ["query_id", "time_ms", "x0", "y0", "x1", "y1"], pred_rows)
    return str(root), str(pred)


def _same(got, want):
    """Equal within TOL; a missing value (NaN, or None in a column pandas
    keeps as objects because every value is None) matches NaN or None."""
    if want is None or (isinstance(want, float) and math.isnan(want)):
        return got is None or (isinstance(got, float) and math.isnan(got))
    if isinstance(want, (float, np.floating)):
        return abs(float(got) - float(want)) <= TOL
    return got == want


def _df_rows(df):
    return [{k: (None if (isinstance(v, float) and math.isnan(v)) and k.endswith("group")
                 else (v.item() if hasattr(v, "item") else v))
             for k, v in rec.items()} for rec in df.astype(object).to_dict("records")]


STG_CASES = [("int", "partial", False), ("str", "partial", False),
             ("str", "partial", True), ("int", "empty", False)]


@pytest.mark.parametrize("ids, pred_kind, ignore", STG_CASES,
                         ids=["int_ids", "str_ids", "ignore_missing", "empty_preds"])
def test_vue_stg_matches_reference(tmp_path, ids, pred_kind, ignore):
    root, pred = _stg_data(tmp_path, 7, ids, pred_kind)
    jev, tev = j_stg.SpatioTemporalEvaluator(), t_stg.SpatioTemporalEvaluator()
    jev.load_dataset(root)
    tev.load_dataset(root)
    want_df = jev.evaluate_pred_file(pred, ignore_missing_pred=ignore)
    got = tev.evaluate_pred_file(pred, ignore_missing_pred=ignore)
    want = _df_rows(want_df)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        bad = [k for k in w if not _same(g[k], w[k])]
        assert not bad, (bad, g, w)
    want_s = j_stg.summarize(want_df)
    got_s = t_stg.summarize(got)
    assert list(got_s[0]) == list(want_s.columns)
    rows = _df_rows(want_s)
    assert len(got_s) == len(rows)
    for g, w in zip(got_s, rows):
        cat = None if isinstance(w["category"], float) else w["category"]
        assert g["category"] == cat and g["group"] == w["group"]
        bad = [k for k in w if k not in ("group", "category") and not _same(g[k], w[k])]
        assert not bad, (bad, g, w)
    if pred_kind == "empty":  # undefined on every row: left out, as pandas does
        assert "t_Precision" not in got_s[0] and "v_Precision" not in got_s[0]


def test_vue_stg_cli_matches(tmp_path, monkeypatch):
    root, pred = _stg_data(tmp_path, 8, "str", "partial")
    j_csv, t_csv = tmp_path / "j.csv", tmp_path / "t.csv"
    _cli(j_stg.main, ["--dataset", root, "--pred", pred, "--out_csv", str(j_csv)],
         monkeypatch, False)
    text = _cli(t_stg.main, ["--dataset", root, "--pred", pred, "--out_csv", str(t_csv)],
                monkeypatch, True)
    assert "overall" in text and f"Saved: {t_csv}" in text
    with open(j_csv) as f:
        want = list(csv.reader(f))
    with open(t_csv) as f:
        got = list(csv.reader(f))
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        for a, b in zip(g, w):
            try:
                assert abs(float(a) - float(b)) <= TOL
            except ValueError:
                assert a == b


def test_vue_stg_reads_csv_as_pandas_types(tmp_path):
    p = tmp_path / "x.csv"
    p.write_text("a,b,c,d\n1,2.5,x,\n2,,y,\n3,4,NA,\n")
    rows = t_stg.read_csv(str(p))
    assert [r["a"] for r in rows] == [1, 2, 3]
    assert rows[0]["b"] == 2.5 and math.isnan(rows[1]["b"]) and rows[2]["b"] == 4.0
    assert [r["c"] for r in rows] == ["x", "y", None]
    assert all(math.isnan(r["d"]) for r in rows)
