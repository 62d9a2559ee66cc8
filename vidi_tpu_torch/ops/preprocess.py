"""Device-side frame preprocessing (port of vidi_tpu/ops/preprocess.py):
uint8 frames cross to the device and are rescaled / normalized there.

Only frames already at the tower's `image_size` are taken; the device
bicubic resize (`resize_bicubic`) is not ported yet and raises.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

Stats = Union[float, Sequence[float]]


def normalize_uint8(x: torch.Tensor, mean: Stats, std: Stats,
                    dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., 3] -> ((x/255) - mean)/std in float32, then cast."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return ((x.float() / 255.0 - mean) / std).to(dtype)


def resize_bicubic(x: torch.Tensor, size: int) -> torch.Tensor:
    raise NotImplementedError(
        "device-side bicubic resize is not ported yet: pass frames already "
        "resized to the tower's image_size (host PIL resize)")


def preprocess_uint8(x: torch.Tensor, size: int, mean: Stats, std: Stats,
                     dtype=torch.float32) -> torch.Tensor:
    """uint8 [N,H,W,3] -> normalized [N,size,size,3]."""
    if x.shape[1] != size or x.shape[2] != size:
        x = resize_bicubic(x, size)
    return normalize_uint8(x, mean, std, dtype)
