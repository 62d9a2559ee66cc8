"""Device-side frame preprocessing (port of vidi_tpu/ops/preprocess.py):
uint8 frames cross to the device and are (resized,) rescaled and normalized
there.

- `normalize_uint8`: the normalize of frames already at the tower's size
  (the default path: the host's PIL bicubic resize keeps bit parity with
  the reference processor).
- `resize_bicubic`: an antialiased Keys-cubic (a = -0.5, PIL's bicubic
  family) resize on the device, so raw decode-resolution frames can ship
  as they are (`pipeline.encode_media(device_resize=True)`).
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

Stats = Union[float, Sequence[float]]

# The towers' processor statistics, as media/images.py (a verbatim copy of
# the reference's host module, which imports PIL) has them: the model
# normalizes uint8 frames on the device without importing PIL.
SIGLIP_MEAN = 0.5
SIGLIP_STD = 0.5
# openai/clip-vit-large-patch14 processor stats (the 7B tower's preprocessing)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def tower_stats(arch: str):
    """(mean, std) for a tower's processor ('siglip' | 'clip')."""
    if arch == "clip":
        return CLIP_MEAN, CLIP_STD
    return SIGLIP_MEAN, SIGLIP_STD


def normalize_uint8(x: torch.Tensor, mean: Stats, std: Stats,
                    dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., 3] -> ((x/255) - mean)/std in float32, then cast."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return ((x.float() / 255.0 - mean) / std).to(dtype)


def resize_bicubic(x: torch.Tensor, size: int) -> torch.Tensor:
    """[N,H,W,3] (uint8 or float) -> [N,size,size,3] fp32: antialiased
    bicubic resize in fp32 (torch's antialiased bicubic takes a = -0.5, the
    kernel of `jax.image.resize(method="cubic")`), clipped to [0, 255] as
    PIL's uint8 resample saturates the cubic's overshoot at hard edges."""
    nchw = x.permute(0, 3, 1, 2).float()
    out = F.interpolate(nchw, size=(size, size), mode="bicubic",
                        align_corners=False, antialias=True)
    return out.clamp(0.0, 255.0).permute(0, 2, 3, 1)


def preprocess_uint8(x: torch.Tensor, size: int, mean: Stats, std: Stats,
                     dtype=torch.float32) -> torch.Tensor:
    """uint8 [N,H,W,3] at any decode resolution -> normalized
    [N,size,size,3]; the resize (when the frames are not at `size`) runs in
    fp32 before the normalize, as PIL resamples in the uint8 domain."""
    if x.shape[1] != size or x.shape[2] != size:
        x = resize_bicubic(x, size)
    return normalize_uint8(x, mean, std, dtype)
