"""The port imports torch and never jax, and builds nothing at import time.

Each check runs in a fresh interpreter, because this test process has jax
loaded already (tests/conftest.py).
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "vidi_tpu_torch",
    "vidi_tpu_torch.ops.norms",
    "vidi_tpu_torch.ops.rope",
    "vidi_tpu_torch.ops.basic",
    "vidi_tpu_torch.ops.attention",
    "vidi_tpu_torch.ops.preprocess",
    "vidi_tpu_torch.ops.cuda.flash_attention",
    "vidi_tpu_torch.ops.cuda.tower_attention",
    "vidi_tpu_torch.ops.cuda.decode_attention",
    "vidi_tpu_torch.models.siglip",
    "vidi_tpu_torch.models.whisper",
    "vidi_tpu_torch.models.adapters",
    "vidi_tpu_torch.models.decoder",
    "vidi_tpu_torch.models.dattn",
    "vidi_tpu_torch.infer.convert",
    "vidi_tpu_torch.infer.loader",
    "vidi_tpu_torch.infer.generate",
    "vidi_tpu_torch.infer.pipeline",
    "vidi_tpu_torch.infer.tasks",
]

PROBE = """
import importlib, json, sys
for m in {modules!r}:
    importlib.import_module(m)
import vidi_tpu_torch
for name in ("DattnConfig", "load_model", "generate", "ask"):
    getattr(vidi_tpu_torch, name)
from vidi_tpu_torch.ops.cuda import _lib
print(json.dumps({{
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "lib_loaded": _lib._lib is not None,
    "built": _lib.build_seconds is not None,
    "cv2_or_pil": sorted(m for m in ("cv2", "PIL") if m in sys.modules),
}}))
"""


@pytest.fixture(scope="module")
def probe():
    return _run(PROBE.format(modules=MODULES))


TRAIN_MODULES = [
    "vidi_tpu_torch.ops.cuda.flash_attention_bwd",
    "vidi_tpu_torch.train",
    "vidi_tpu_torch.train.losses",
    "vidi_tpu_torch.train.optimizer",
    "vidi_tpu_torch.train.train_step",
    "vidi_tpu_torch.train.data",
    "vidi_tpu_torch.train.checkpoint",
    "vidi_tpu_torch.train.train",
]
# the training path imports vidi_tpu.train.data (jax-free, PIL at the top)
TRAIN_PROBE = """
import importlib, json, sys
for m in {modules!r}:
    importlib.import_module(m)
print(json.dumps(sorted(m for m in sys.modules
                        if m in ("jax", "optax", "orbax") or m.startswith(("jax.", "orbax.")))))
"""


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    import json
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_port_never_imports_jax(probe):
    assert probe["jax"] == []


def test_training_path_never_imports_jax():
    assert _run(TRAIN_PROBE.format(modules=TRAIN_MODULES)) == []


def test_no_kernel_library_at_import(probe):
    assert not probe["lib_loaded"] and not probe["built"]


def test_media_backends_load_lazily(probe):
    """cv2 / PIL are imported only inside decode_media_host (the GPU
    machine may lack them)."""
    assert probe["cv2_or_pil"] == []
