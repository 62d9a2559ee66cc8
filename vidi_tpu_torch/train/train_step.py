"""The training step of the Dattn LMM (port of vidi_tpu/train/train_step.py).

Batch layout as in JAX (dense, mask-based), as torch tensors (`data.to_device`):
  input_ids [B,T], labels [B,T] (IGNORE_INDEX-masked), text_mask [B,T] bool,
  images [B,N,S,S,3], frame_counts [B], mels [B,W,n_mels,3000],
  audio_sizes [B]; packed batches add positions [B,T] and segment_ids [B,T].
Image-conversation batches (`data.collate_images`, mm_input_type "image")
have no frame_counts: images [B,S,S,3], or anyres [B,P,S,S,3] with
per-sample grids [B,2], and no audio.
The position noise comes as explicit draws (`dattn.draw_pos_noise`, or
`dattn.draw_image_noise` for image batches), not as a key. `remat=True`
checkpoints each decoder layer, `remat="dots"` keeps its weight products.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vidi_tpu_torch.core.config import DattnConfig
from vidi_tpu_torch.models import dattn, decoder
from vidi_tpu_torch.models.adapters import budget_hw
from vidi_tpu_torch.train.losses import shifted_cross_entropy
from vidi_tpu_torch.train.optimizer import leaves


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detached(v) for v in tree]
    return tree.detach()


def loss_fn(params, cfg: DattnConfig, batch: Dict, pos_noise: Optional[Dict], *,
            hw: Tuple[int, int], mm_chunks: int = 1, remat=True,
            use_flash: bool = False, frozen: Tuple[str, ...] = ()) -> torch.Tensor:
    """Scalar loss of one batch. Frozen top-level modules ("vision",
    "audio", "text", "mm") are detached, the counterpart of JAX's
    stop_gradient; a detached tower then runs under no_grad."""
    params = {k: (_detached(v) if k in frozen else v) for k, v in params.items()}
    if "frame_counts" in batch:
        img, img_mask = dattn.encode_video_images(
            params, cfg, batch["images"], batch["frame_counts"], hw,
            mm_chunks=mm_chunks, use_flash=use_flash, pos_noise=pos_noise)
        aud, aud_mask = dattn.encode_video_audios(
            params, cfg, batch["mels"], batch["audio_sizes"], mm_chunks=mm_chunks,
            use_flash=use_flash, pos_noise=pos_noise)
    else:
        img, img_mask = dattn.encode_images(
            params, cfg, batch["images"], grids=batch.get("grids"),
            mm_chunks=mm_chunks, use_flash=use_flash, pos_noise=pos_noise)
        aud = aud_mask = None
    mask = batch["text_mask"]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.clamp(torch.cumsum(mask.long(), dim=1) - 1, min=0)
    embeds = decoder.embed_tokens(params["text"], batch["input_ids"].long(), cfg.text)
    h, _ = dattn.forward(params, cfg, embeds, mask, positions, img=img,
                         img_mask=img_mask, aud=aud, aud_mask=aud_mask,
                         mm_chunks=mm_chunks, remat=remat, use_flash=use_flash,
                         text_segs=batch.get("segment_ids"))
    logits = decoder.lm_logits(params["text"], h, cfg.text)
    return shifted_cross_entropy(logits, batch["labels"], cfg.loss_thres)


def opt_init(tx, params) -> Dict:
    """fp32 optimizer state (the reference accumulates in fp32 under ZeRO-3)."""
    return tx.init(params)


def train_step(params, opt_state, batch: Dict, pos_noise: Optional[Dict], *,
               cfg: DattnConfig, tx, hw: Tuple[int, int],
               mm_chunks: int = 1, remat=True, use_flash: bool = False,
               frozen: Tuple[str, ...] = ()):
    """One step -> (params, opt_state, loss). `tx` is an `optimizer.AdamW`
    or `optimizer.MultiSteps`. Gradients of the trainable leaves (the
    optimizer's non-frozen labels) are cast to fp32, the update is made in
    fp32 and written back in each parameter's dtype, in place: the
    returned params and state are the objects passed in."""
    train = [(key, p) for key, _, p in leaves(params) if tx.labels[key] != "frozen"]
    for _, p in train:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params, cfg, batch, pos_noise, hw=hw, mm_chunks=mm_chunks,
                           remat=remat, use_flash=use_flash, frozen=frozen)
            got = torch.autograd.grad(loss, [p for _, p in train], allow_unused=True)
    finally:
        for _, p in train:
            p.requires_grad_(False)
    # a leaf of a detached (frozen) module has no gradient: JAX's is zero
    grads = {key: torch.zeros_like(p) if g is None else g
             for (key, p), g in zip(train, got)}
    del got
    tx.apply(params, grads, opt_state)
    return params, opt_state, loss.detach()


def make_batch_hw(cfg: DattnConfig, total_frames: int) -> Tuple[int, int]:
    return budget_hw(total_frames, cfg.mm_image_pool_size,
                     cfg.vision.num_patches_per_side, cfg.mm_max_tokens_base)
