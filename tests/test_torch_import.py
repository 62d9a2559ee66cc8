"""The port imports torch and never jax, nothing of vidi_tpu (it keeps its
own copies of the host code it shares), neither safetensors nor
transformers, and builds nothing at import time.

Each check runs in a fresh interpreter, because this test process has jax
and vidi_tpu loaded already (tests/conftest.py and the other tests).
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

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
    "vidi_tpu_torch.ops.cuda.quant_matmul",
    "vidi_tpu_torch.ops.cuda.fused_tower_layer",
    "vidi_tpu_torch.ops.cuda.fused_rmsnorm",
    "vidi_tpu_torch.constants",
    "vidi_tpu_torch.core.config",
    "vidi_tpu_torch.core.mesh",
    "vidi_tpu_torch.core.tree",
    "vidi_tpu_torch.parallel",
    "vidi_tpu_torch.parallel.sharding",
    "vidi_tpu_torch.parallel.ring_attention",
    "vidi_tpu_torch.parallel.ulysses",
    "vidi_tpu_torch.media.text",
    "vidi_tpu_torch.media.audio",
    "vidi_tpu_torch.utils",
    "vidi_tpu_torch.models.siglip",
    "vidi_tpu_torch.models.whisper",
    "vidi_tpu_torch.models.adapters",
    "vidi_tpu_torch.models.decoder",
    "vidi_tpu_torch.models.dattn",
    "vidi_tpu_torch.infer.convert",
    "vidi_tpu_torch.infer.safetensors_io",
    "vidi_tpu_torch.infer.export",
    "vidi_tpu_torch.infer.quantize",
    "vidi_tpu_torch.infer.loader",
    "vidi_tpu_torch.infer.generate",
    "vidi_tpu_torch.infer.pipeline",
    "vidi_tpu_torch.infer.tasks",
    "vidi_tpu_torch.infer.serve",
    "vidi_tpu_torch.infer.run_benchmark",
    "vidi_tpu_torch.evals.vue_tr",
    "vidi_tpu_torch.evals.vue_plot",
    "vidi_tpu_torch.evals.vue_stg",
    "vidi_tpu_torch.evals.plots",
    "vidi_tpu_torch.evals.visualize",
    "vidi_tpu_torch.tools.ranks_one_card",
    "vidi_tpu_torch.tools.make_example",
    "vidi_tpu_torch.tools.full_loop",
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
    "vidi_tpu": sorted(m for m in sys.modules
                       if m == "vidi_tpu" or m.startswith("vidi_tpu.")),
    "lib_loaded": _lib._lib is not None,
    "built": _lib.build_seconds is not None,
    "cv2_or_pil": sorted(m for m in ("cv2", "PIL") if m in sys.modules),
    "hf": sorted(m for m in sys.modules
                 if m.split(".")[0] in ("safetensors", "transformers")),
    "pandas": sorted(m for m in sys.modules if m.split(".")[0] == "pandas"),
    "matplotlib": sorted(m for m in sys.modules if m.split(".")[0] == "matplotlib"),
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
    "vidi_tpu_torch.train.prefetch",
    "vidi_tpu_torch.train.packing",
    "vidi_tpu_torch.train.samplers",
    "vidi_tpu_torch.train.tb",
    "vidi_tpu_torch.train.distill",
    "vidi_tpu_torch.media.images",
    "vidi_tpu_torch.media.video",
]
# the training path's data module imports PIL and the video decoders at the top
TRAIN_PROBE = """
import importlib, json, sys
for m in {modules!r}:
    importlib.import_module(m)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "optax", "orbax", "vidi_tpu",
                                               "safetensors", "transformers"))))
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


def test_port_never_imports_vidi_tpu(probe):
    assert probe["vidi_tpu"] == []


def test_port_never_imports_pandas(probe):
    """The card's machine has no pandas: the evals read CSVs with `csv`."""
    assert probe["pandas"] == []


def test_plots_import_matplotlib_lazily(probe):
    assert probe["matplotlib"] == []


def test_chip_smoke_imports_neither_jax_nor_vidi_tpu():
    """chip_smoke.py's imports (its module body, not main) load no jax and no
    vidi_tpu module."""
    code = ("import importlib.util, json, sys\n"
            "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'vidi_tpu'))))")
    assert _run(code) == []


# `vidi_tpu` as a whole word: `vidi_tpu_torch` does not match
_IMPORT_RE = re.compile(r"^\s*(from\s+vidi_tpu(\.\w+)*\s+import\b|import\s+vidi_tpu(\.\w+)*\b)",
                        re.M)


_PANDAS_RE = re.compile(r"^\s*(from\s+pandas(\.\w+)*\s+import\b|import\s+pandas\b)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*Path(ROOT, "vidi_tpu_torch").rglob("*.py"),
                                       Path(ROOT, "chip_smoke.py"),
                                       Path(ROOT, "scripts", "native_decode_probe.py")]))
def test_no_source_line_imports_vidi_tpu(path):
    text = Path(ROOT, path).read_text()
    assert not _IMPORT_RE.search(text), f"{path} imports vidi_tpu"
    assert not re.search(r"[\"']vidi_tpu(\.[a-z_.]+)?[\"']", text), \
        f"{path} names a vidi_tpu module in a string (a lazy import)"
    assert not _PANDAS_RE.search(text), f"{path} imports pandas"


@pytest.mark.parametrize("ctor", ["tiny", "vidi15_9b", "bench_1_5b", "vidi_7b",
                                  "tiny:mistral"])
def test_config_copy_has_not_drifted(ctor):
    """The port's copy of core/config.py builds the same configurations
    (`name:arg` calls the constructor with one argument)."""
    from vidi_tpu.core import config as jcfg
    from vidi_tpu_torch.core import config as tcfg

    name, *args = ctor.split(":")
    assert dataclasses.asdict(getattr(tcfg.DattnConfig, name)(*args)) == \
        dataclasses.asdict(getattr(jcfg.DattnConfig, name)(*args))


def test_port_never_imports_safetensors_or_transformers(probe):
    """The port reads and writes checkpoints itself (a CUDA host may have
    neither package); transformers is imported only to read a checkpoint's
    tokenizer files."""
    assert probe["hf"] == []


def test_training_path_never_imports_jax_or_vidi_tpu():
    assert _run(TRAIN_PROBE.format(modules=TRAIN_MODULES)) == []


def test_no_module_imports_tensorboard_at_import():
    """tensorboard (and the TensorFlow it may pull in) is imported only
    inside TBReporter, when --report_to tensorboard asks for it."""
    code = ("import importlib, json, sys\n"
            f"for m in {MODULES + TRAIN_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('tensorboard', 'tensorflow') or m.startswith('torch.utils.tensorboard'))))")
    assert _run(code) == []


def test_no_kernel_library_at_import(probe):
    assert not probe["lib_loaded"] and not probe["built"]


def test_media_backends_load_lazily(probe):
    """cv2 / PIL are imported only inside decode_media_host (the GPU
    machine may lack them)."""
    assert probe["cv2_or_pil"] == []
