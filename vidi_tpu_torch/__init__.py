"""vidi-tpu-torch: the PyTorch + CUDA (Hopper) port of vidi_tpu.

Public surface (lazy imports, the same names as `vidi_tpu`):

    from vidi_tpu_torch import DattnConfig, load_model, ask, generate

    params, cfg, tok = load_model(random_weights="9b", device="cuda")
    print(ask("a red car", "video.mp4", params, cfg, tok))

The package imports torch and never jax, and nothing of `vidi_tpu`: it
keeps its own copies of the host code it shares with it (configs,
constants, tokenizer, audio / image / video decode, training data); the
kernels that `vidi_tpu` writes in Pallas are CUDA C++ under `csrc/`, built
with nvcc at first use (see ops/cuda/_lib.py).
"""

__version__ = "0.1.0"

_LAZY = {
    "DattnConfig": ("vidi_tpu_torch.core.config", "DattnConfig"),
    "TextConfig": ("vidi_tpu_torch.core.config", "TextConfig"),
    "VisionConfig": ("vidi_tpu_torch.core.config", "VisionConfig"),
    "AudioConfig": ("vidi_tpu_torch.core.config", "AudioConfig"),
    "ByteTokenizer": ("vidi_tpu_torch.media.text", "ByteTokenizer"),
    "load_model": ("vidi_tpu_torch.infer.loader", "load_model"),
    "generate": ("vidi_tpu_torch.infer.generate", "generate"),
    "ask": ("vidi_tpu_torch.infer.pipeline", "ask"),
}

__all__ = sorted(_LAZY) + ["__version__"]


def __getattr__(name):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'vidi_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), attr)
