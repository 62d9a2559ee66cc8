"""Model loading for the port: random-weight models with the byte tokenizer.

`load_model(random_weights="tiny" | "9b" | "1.5b")` builds the configuration
(`DattnConfig.tiny`, `vidi15_9b`, `bench_1_5b`) and draws random weights
directly on `device` in `dtype` from `seed` -- a host-side fp32 init of the
9B would need ~41 GB of RAM. Loading a released HF checkpoint into the port
comes later.
"""
from __future__ import annotations

from typing import Optional

import torch

from vidi_tpu.core.config import DattnConfig
from vidi_tpu.media.text import ByteTokenizer
from vidi_tpu_torch.models import dattn

CONFIGS = {
    "tiny": DattnConfig.tiny,
    "9b": DattnConfig.vidi15_9b,
    "1.5b": DattnConfig.bench_1_5b,
}


def resolve_device(device) -> torch.device:
    """torch.device from a name; a CUDA device without a card raises (the
    port never drops to the CPU behind the caller's back)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    return dev


def load_model(model_path: Optional[str] = None,
               random_weights: Optional[str] = None, *,
               dtype: torch.dtype = torch.bfloat16, device="cuda",
               seed: int = 0):
    """-> (params, cfg, tokenizer)."""
    if model_path is not None:
        raise NotImplementedError("loading HF checkpoints into the port is not "
                                  "implemented yet; use random_weights")
    if random_weights not in CONFIGS:
        raise ValueError(f"random_weights must be one of {sorted(CONFIGS)}, "
                         f"got {random_weights!r}")
    cfg = CONFIGS[random_weights]()
    params = dattn.init_params(cfg, dtype, resolve_device(device), seed)
    return params, cfg, ByteTokenizer()
