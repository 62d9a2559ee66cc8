"""Model loading for the port: random-weight models with the byte tokenizer.

`load_model(random_weights="tiny" | "9b" | "1.5b")` builds the configuration
(`DattnConfig.tiny`, `vidi15_9b`, `bench_1_5b`) and draws random weights
directly on `device` in `dtype` from `seed` -- a host-side fp32 init of the
9B would need ~41 GB of RAM. `load_8bit` / `load_4bit` quantize the text
decoder's layer matmuls to int8 / group-wise int4 and `load_8bit_towers`
the encoder towers to int8 (the reference's bitsandbytes options): the
same draws are quantized layer by layer where they lie, each layer's
full-precision weights freed as its quantized copy replaces them. Loading a
released HF checkpoint into the port comes later.
"""
from __future__ import annotations

from typing import Optional

import torch

from vidi_tpu_torch.core.config import DattnConfig
from vidi_tpu_torch.infer import quantize as qz
from vidi_tpu_torch.media.text import ByteTokenizer
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
               seed: int = 0, load_8bit: bool = False,
               load_8bit_towers: bool = False, load_4bit: bool = False):
    """-> (params, cfg, tokenizer)."""
    if model_path is not None:
        raise NotImplementedError("loading HF checkpoints into the port is not "
                                  "implemented yet; use random_weights")
    if random_weights not in CONFIGS:
        raise ValueError(f"random_weights must be one of {sorted(CONFIGS)}, "
                         f"got {random_weights!r}")
    cfg = CONFIGS[random_weights]()
    params = dattn.init_params(cfg, dtype, resolve_device(device), seed)
    if load_8bit or load_4bit:
        layers = params["text"]["layers"]
        for i, lp in enumerate(layers):
            layers[i] = qz.quantize_text_layer(lp, bits=4 if load_4bit else 8)
    if load_8bit_towers:
        for tower in ("vision", "audio"):
            layers = params[tower]["layers"]
            for i, lp in enumerate(layers):
                layers[i] = qz.quantize_tower_layer(lp)
    return params, cfg, ByteTokenizer()
