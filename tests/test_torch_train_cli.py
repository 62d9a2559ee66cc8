"""`python -m vidi_tpu_torch.train.train` on the CPU: two steps of the tiny
model on synthetic batches write metrics.jsonl with the JAX CLI's keys
and a checkpoint; a longer rerun resumes from it; a torn newest checkpoint
falls back to the older one; `--device cuda` without a card raises.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"step", "loss", "step_time_s", "tokens_per_sec", "learning_rate"}


def _run(out_dir, *extra, check=True):
    res = subprocess.run(
        [sys.executable, "-m", "vidi_tpu_torch.train.train", "--tiny",
         "--data_path", "synthetic", "--output_dir", str(out_dir), *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if check:
        assert res.returncode == 0, res.stderr[-3000:]
    return res


def _metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _ckpts(out_dir):
    return sorted(os.listdir(os.path.join(out_dir, "checkpoints")))


def test_train_resume_and_torn_checkpoint(tmp_path):
    out = tmp_path / "run"
    _run(out, "--max_steps", "2", "--device", "cpu")
    lines = _metrics(out)
    assert [m["step"] for m in lines] == [0, 1]
    assert all(set(m) == KEYS for m in lines)
    assert all(m["loss"] == m["loss"] and m["loss"] > 0 for m in lines)  # finite
    assert lines[0]["learning_rate"] == 0.0 and lines[1]["learning_rate"] > 0
    assert _ckpts(out) == ["step_2.pt"]

    res = _run(out, "--max_steps", "3", "--device", "cpu", "--use_flash")
    assert "resumed from step 2" in res.stdout
    assert [m["step"] for m in _metrics(out)] == [0, 1, 2]
    assert _ckpts(out) == ["step_2.pt", "step_3.pt"]

    with open(out / "checkpoints" / "step_3.pt", "r+b") as f:  # a save cut short
        f.truncate(100)
    res = _run(out, "--max_steps", "4", "--device", "cpu")
    assert "checkpoint step 3 unreadable" in res.stdout
    assert "resumed from step 2" in res.stdout
    assert [m["step"] for m in _metrics(out)] == [0, 1, 2, 2, 3]
    assert _ckpts(out) == ["step_3.pt", "step_4.pt"]  # save_total_limit 2


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    res = _run(tmp_path / "run", "--max_steps", "1", "--device", "cuda", check=False)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
    assert not (tmp_path / "run" / "metrics.jsonl").exists()
