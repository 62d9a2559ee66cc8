"""Training data for the port. The dataset, collation and synthetic batches
are `vidi_tpu.train.data`'s own (jax-free host code that builds numpy
batches), imported rather than copied; `to_device` turns a batch into
torch tensors on the training device."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vidi_tpu.train.data import VideoConvDataset, collate, synthetic_batch  # noqa: F401


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on `device`; integer arrays become int64."""
    out = {}
    for key, val in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(val))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        out[key] = t.to(device)
    return out
