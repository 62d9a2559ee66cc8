"""Training loss: shifted cross entropy with the hard-example `loss_thres`
filter (port of vidi_tpu/train/losses.py)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vidi_tpu_torch.constants import IGNORE_INDEX


def shifted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          loss_thres: Optional[float] = None) -> torch.Tensor:
    """logits [B,T,V] (already final-softcapped), labels [B,T] with
    IGNORE_INDEX masking. Labels are padded by one and shifted so token t
    predicts t+1; ignored positions lose 0. With `loss_thres` the mean runs
    over tokens whose loss exceeds it, unless every token is below it, in
    which case over all tokens with a non-zero loss."""
    labels = F.pad(labels.long(), (0, 1), value=IGNORE_INDEX)
    shift = labels[:, 1:].reshape(-1)
    logits = logits.float().reshape(-1, logits.shape[-1])
    valid = shift != IGNORE_INDEX
    safe = torch.where(valid, shift, 0)
    logp = torch.log_softmax(logits, dim=-1)
    tok = -logp.gather(1, safe[:, None])[:, 0]
    tok = torch.where(valid, tok, 0.0)
    if loss_thres is None:
        return tok.sum() / torch.clamp(valid.sum(), min=1)
    thres = torch.where((tok < loss_thres).all(), 0.0, loss_thres)
    sel = tok > thres
    return torch.where(sel, tok, 0.0).sum() / torch.clamp(sel.sum(), min=1)
