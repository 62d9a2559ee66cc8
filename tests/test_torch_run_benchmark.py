"""The batch prediction runner: the port's `infer/run_benchmark` against
vidi_tpu's. The helpers (parse_stg_tubes, group_by_video, video_batches,
ask_group) on the same inputs; `main` of each task on the same argv, with
both packages' `load_model` handing back the same tiny random weights
(params_from_jax, fp32, use_flash=False on the CPU) and a recording
tokenizer, on two make_video clips named <video_id>.mp4. The output files
(TR json, STG csv, VQA json, character json) must be equal byte for byte
and the generated token ids equal.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.infer import run_benchmark as jrb
from vidi_tpu.media.text import ByteTokenizer
from vidi_tpu.models import dattn as jdattn
from vidi_tpu_torch.infer import run_benchmark as trb
from vidi_tpu_torch.infer.convert import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from make_example import make_video  # noqa: E402

CFG = DattnConfig.tiny()


class _RecordingTokenizer(ByteTokenizer):
    def __init__(self):
        super().__init__()
        self.decoded = []

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        self.decoded.append([int(t) for t in ids])
        return super().decode(ids, skip_special_tokens)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench_media")
    make_video(str(d / "vid_a.mp4"), seconds=6.0)
    make_video(str(d / "vid_b.mp4"), seconds=3.0)
    return str(d)


@pytest.fixture(scope="module")
def model():
    jp = jdattn.init_params(jax.random.PRNGKey(11), CFG, jnp.float32)
    return jp, params_from_jax(jax.device_get(jp))


GTS = {
    "tr": [
        {"query_id": f"t{i}", "video_id": v, "query": q, "duration": d,
         "gt": [[0.0, 1.0]], "duration_category": "short", "query_format": "phrase",
         "query_modality": "vision"}
        for i, (v, q, d) in enumerate([
            ("vid_b", "a moving gradient", 3.0), ("vid_a", "the opening shot", 6.0),
            ("vid_a", "a red square", 6.0), ("vid_a", "a blue line", 6.0)])],
    "vqa": [
        {"problem_id": 1, "video_id": "vid_a", "problem": "Who speaks?",
         "options": ["A. Alice", "B. Bob"], "answer": "A",
         "task_type": "Perception and Understanding"},
        {"problem_id": 2, "video_id": "vid_b", "problem": "What colour?",
         "options": ["A. Red", "B. Blue", "C. Green"], "answer": "C",
         "task_type": "Narrative and Structural Understanding"}],
    "character": [
        {"query_id": "c1", "video_id": "vid_a", "character": "Alice", "duration": 6.0,
         "gt": [{"start": 1.0, "end": 2.0, "text": "hello",
                 "boxes": [{"timestamp": 1.0, "box_2d": [0.1, 0.2, 0.3, 0.4]}]}]}],
    "stg": [
        {"query_id": "s1", "video_id": "vid_a", "query": "the red square"},
        {"query_id": "s2", "video_id": "vid_b", "query": "the gradient"}],
}


def _run_both(model, videos, tmp_path, monkeypatch, task, *extra):
    """main() of both packages on one argv -> (port file bytes, reference
    file bytes, port ids, reference ids)."""
    jp, tp = model
    gt = tmp_path / f"{task}_gt.json"
    gt.write_text(json.dumps(GTS[task]))
    ext = "csv" if task == "stg" else "json"
    toks = {}

    def loader(pkg, params):
        def load_model(*a, **kw):
            toks[pkg] = _RecordingTokenizer()
            return params, CFG, toks[pkg]
        return load_model

    monkeypatch.setattr("vidi_tpu.infer.loader.load_model", loader("jax", jp))
    monkeypatch.setattr("vidi_tpu_torch.infer.loader.load_model", loader("torch", tp))
    monkeypatch.setattr("vidi_tpu.core.compile_cache.setup_compile_cache", lambda: None)
    base = ["--task", task, "--gt", str(gt), "--video-dir", videos,
            "--max-new-tokens", "6", "--mm-splits", "4", "--batch-queries", "2",
            "--dtype", "float32", *extra]
    j_out, t_out = tmp_path / f"j.{ext}", tmp_path / f"t.{ext}"
    monkeypatch.setattr(sys, "argv", ["run_benchmark", *base, "--out", str(j_out)])
    jrb.main()
    trb.main([*base, "--out", str(t_out), "--device", "cpu"])
    return t_out.read_bytes(), j_out.read_bytes(), toks["torch"].decoded, toks["jax"].decoded


@pytest.mark.parametrize("task, extra", [
    ("tr", ()), ("tr", ("--spec-ngram", "--spec-k", "3")), ("tr", ("--quantize-kv",)),
    ("stg", ()), ("vqa", ()), ("character", ())],
    ids=["tr", "tr_spec_ngram", "tr_quantize_kv", "stg", "vqa", "character"])
def test_main_matches_reference(model, videos, tmp_path, monkeypatch, task, extra):
    got, want, got_ids, want_ids = _run_both(model, videos, tmp_path, monkeypatch,
                                             task, *extra)
    assert got == want
    assert got_ids == want_ids and got_ids and any(got_ids)
    if task == "tr":
        out = json.loads(got)
        assert sorted(o["query_id"] for o in out) == ["t0", "t1", "t2", "t3"]
        from vidi_tpu_torch.evals import vue_tr
        res = vue_tr.evaluate(str(tmp_path / "t.json"), str(tmp_path / "tr_gt.json"))
        assert res["n_query"] == 4


@pytest.mark.parametrize("text, duration", [
    ("0.100-0.102: 0.2,0.1,0.8,0.9; 0.500-0.500: 200,100,800,900", 1000.0),
    ("0.000-0.900: 0.0,0.0,1.0,1.0", 7.5),
    ("no tube here 1.2-3.4", 10.0),
    ("0.250-0.260: 0.5, 0.5 ,0.75,0.9 and 0.3-0.31:1,1,2,2", 123.0)])
def test_parse_stg_tubes_matches(text, duration):
    assert trb.parse_stg_tubes(text, duration) == jrb.parse_stg_tubes(text, duration)
    assert trb.parse_stg_tubes(text, duration, step_ms=250) == \
        jrb.parse_stg_tubes(text, duration, step_ms=250)


def test_grouping_helpers_match():
    gts = [{"query_id": i, "video_id": v} for i, v in enumerate("bacabbcaab")]
    assert trb.group_by_video(gts) == jrb.group_by_video(gts)
    grouped = trb.group_by_video(gts)
    for size in (1, 2, 3, 5):
        assert list(trb.video_batches(grouped, size)) == list(jrb.video_batches(grouped, size))


def test_ask_group_retries_alone():
    """A failing batch is retried query by query; a failing query answers ""."""
    group = [{"query_id": "a", "query": "ok 1", "video_id": "v"},
             {"query_id": "b", "query": "bad", "video_id": "v"},
             {"query_id": "c", "query": "ok 2", "video_id": "v"}]

    def make():
        calls = []

        def ask_batch(queries, vid, options=None):
            calls.append(list(queries))
            if len(queries) > 1 or queries[0] == "bad":
                raise RuntimeError("boom")
            return 4.0, [queries[0].upper()]
        return ask_batch, calls

    (ta, t_calls), (ja, j_calls) = make(), make()
    assert trb.ask_group(ta, group, "v.mp4") == jrb.ask_group(ja, group, "v.mp4") == \
        (4.0, ["OK 1", "", "OK 2"])
    assert t_calls == j_calls


def test_schedule_videos_matches():
    import argparse
    args = argparse.Namespace(video_dir="/d", video_ext=".mp4")
    gts = [{"video_id": v} for v in "aabcca"]
    seen = {}

    def fake(name):
        def ask_batch(*a, **kw):
            raise AssertionError("not called")
        ask_batch.set_schedule = lambda vids: seen.__setitem__(name, vids)
        return ask_batch

    trb.schedule_videos(fake("t"), gts, args)
    jrb.schedule_videos(fake("j"), gts, args)
    assert seen["t"] == seen["j"] == ["/d/a.mp4", "/d/b.mp4", "/d/c.mp4", "/d/a.mp4"]


def test_multi_card_flags_raise(tmp_path, monkeypatch):
    """Several ranks need torchrun (tests/test_torch_parallel_infer.py runs
    them): a process not launched so exits naming it."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for flag in ("--seq-parallel", "--model-parallel", "--data-parallel"):
        with pytest.raises(SystemExit, match="torchrun"):
            trb.main(["--gt", "g.json", "--video-dir", ".", "--out", "o.json",
                      "--device", "cpu", flag, "2"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_main_defaults_to_cuda(tmp_path):
    gt = tmp_path / "gt.json"
    gt.write_text("[]")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        trb.main(["--gt", str(gt), "--video-dir", ".", "--out", str(tmp_path / "o.json"),
                  "--random-weights", "tiny"])
