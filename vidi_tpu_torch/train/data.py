"""Training dataset + dense collation.

Rebuilds the reference data path (Vidi1.5_9B/vidi/dataset/video.py:21-104 +
collator.py:12-74) for static-shape TPU batches:
- JSON conversation list with {"video", "length", "conversations"};
- per-sample retry x5 with random resample on IO errors (video.py:57-96);
- duration-vs-metadata assert < 1 s (video.py:73-75);
- <image> placeholder spliced out of input_ids (Dattn: video never enters the
  text stream), labels IGNORE-masked on instruction turns;
- dense padding to shape buckets (frames / text / audio windows) so jit
  recompiles stay bounded — replacing torch's ragged pad_sequence.
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from vidi_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from vidi_tpu_torch.core.config import DattnConfig
from vidi_tpu_torch.media.audio import process_audio
from vidi_tpu_torch.media.images import (
    preprocess_frames_crop,
    preprocess_frames_pad,
    preprocess_frames_resize,
    get_anyres_grid_shape,
    process_anyres_image,
    tower_stats,
)
from vidi_tpu_torch.media.text import normalize_mm_turn, preprocess_conv
from vidi_tpu_torch.media.video import get_media_length, load_audio, load_video


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class VideoConvDataset:
    def __init__(self, data_path: str, video_folder: str, tokenizer,
                 cfg: DattnConfig, fps: float = 1.0):
        with open(data_path) as f:
            self.records = json.load(f)
        self.video_folder = Path(video_folder)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.fps = fps

    def __len__(self):
        return len(self.records)

    @property
    def lengths(self) -> List[int]:
        """For length-grouped batching (video.py:30-32)."""
        return [r.get("length", 0) for r in self.records]

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        num_try, max_try = 0, 5
        while True:
            try:
                return self._load(self.records[i])
            except Exception as e:  # noqa: BLE001 — mirrors video.py:88-96
                print(repr(e))
                num_try += 1
                if num_try == max_try:
                    raise IOError("Error reading data.")
                i = random.randint(0, len(self.records) - 1)

    def _load(self, rec: Dict) -> Dict[str, np.ndarray]:
        """Three record types like the reference (video.py:56-84): "video"
        (frames + audio), "image" (document image swept into slideshow
        frames, no audio), or text-only (zero-filled dummies)."""
        cfg = self.cfg
        mean, std = tower_stats(cfg.vision.arch)
        dummy_mels = np.zeros(
            (1, cfg.audio.num_mel_bins, cfg.audio.nb_max_frames), np.float32)
        if "video" in rec:
            assert cfg.mm_image_aspect_ratio == "resize"  # video.py:67
            path = str(self.video_folder / rec["video"])
            duration = get_media_length(path)
            assert abs(duration - rec["length"]) < 1, \
                f"Video duration mismatch, got {duration} vs {rec['length']}"
            frames = load_video(path, self.fps)
            assert len(frames) > 1, "Input video should have more than one frame."
            pixels = preprocess_frames_resize(frames, cfg.vision.image_size,
                                              mean, std)
            wave = load_audio(path, cfg.audio.sampling_rate)
            mels, audio_len = process_audio(wave, cfg.audio)
            conv = normalize_mm_turn(rec["conversations"])
            has_image = True
        elif "image" in rec:
            # document image -> slideshow scan-order frames (video.py:58-64)
            from PIL import Image

            from vidi_tpu_torch.media.images import process_slideshow_image

            img = Image.open(self.video_folder / rec["image"]).convert("RGB")
            pixels, _boxes = process_slideshow_image(img, cfg.vision.image_size)
            mels, audio_len = dummy_mels, 0
            conv = normalize_mm_turn(rec["conversations"])
            has_image = True
        else:
            pixels = np.zeros(
                (2, cfg.vision.image_size, cfg.vision.image_size, 3), np.float32)
            mels, audio_len = dummy_mels, cfg.audio.nb_max_frames
            conv = rec["conversations"]
            has_image = False
        out = preprocess_conv(conv, self.tokenizer, has_image=has_image,
                              model_max_length=cfg.model_max_length,
                              arch=cfg.text.arch)
        ids = out["input_ids"]
        labels = out["labels"]
        keep = ids != IMAGE_TOKEN_INDEX  # splice video token out of the text
        return {
            "input_ids": ids[keep].astype(np.int32),
            "labels": labels[keep].astype(np.int32),
            "pixels": pixels,
            "mels": mels,
            "audio_len": audio_len,
            "has_image": has_image,
        }


class ImageConvDataset:
    """Image-conversation data (reference: vidi/dataset/image.py).

    Records: {"image": file, "conversations": [...]} or text-only
    {"conversations": [...]}. Aspect policy from cfg.mm_image_aspect_ratio
    ("pad" | "resize" | "anyres"); anyres samples return pixels [P, H, W, 3]
    (base view + grid tiles).
    """

    def __init__(self, data_path: str, image_folder: str, tokenizer,
                 cfg: DattnConfig):
        with open(data_path) as f:
            self.records = json.load(f)
        self.image_folder = Path(image_folder)
        self.tokenizer = tokenizer
        self.cfg = cfg

    def __len__(self):
        return len(self.records)

    @property
    def lengths(self) -> List[int]:
        """Word counts + 512 image-token estimate (image.py:29-35)."""
        out = []
        for rec in self.records:
            img_tokens = 512 if "image" in rec else 0
            out.append(sum(len(c["value"].split())
                           for c in rec["conversations"]) + img_tokens)
        return out

    @property
    def modality_lengths(self) -> List[int]:
        """Signed lengths: positive = has image, negative = text-only
        (image.py:37-44) — the input to mm_length_grouped_indices."""
        out = []
        for rec in self.records:
            n = sum(len(c["value"].split()) for c in rec["conversations"])
            out.append(n if "image" in rec else -n)
        return out

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        num_try, max_try = 0, 5
        while True:
            try:
                return self._load(self.records[i])
            except Exception as e:  # noqa: BLE001 — mirrors image.py:46-70
                print(repr(e))
                num_try += 1
                if num_try == max_try:
                    raise IOError("Error reading data.")
                i = random.randint(0, len(self.records) - 1)

    def _load(self, rec: Dict) -> Dict[str, np.ndarray]:
        from PIL import Image

        cfg = self.cfg
        size = cfg.vision.image_size
        # normalize with the tower's own processor stats (the reference uses
        # the HF image processor for every policy, img_utils.py:173-198)
        mean, std = tower_stats(cfg.vision.arch)
        grid_shape = None
        if "image" in rec:
            img = Image.open(self.image_folder / rec["image"]).convert("RGB")
            image_size = img.size
            if cfg.mm_image_aspect_ratio == "anyres":
                res = [(a * size, b * size) for a, b in cfg.mm_image_grid_points]
                pixels = process_anyres_image(img, size, res, mean, std)
                grid_shape = get_anyres_grid_shape(image_size, res, size)
            elif cfg.mm_image_aspect_ratio == "pad":
                pixels = preprocess_frames_pad([np.asarray(img)], size,
                                               mean, std)[0]
            elif cfg.mm_image_aspect_ratio == "crop":
                pixels = preprocess_frames_crop([img], size, mean, std)[0]
            elif cfg.mm_image_aspect_ratio == "resize":
                pixels = preprocess_frames_resize([np.asarray(img)], size,
                                                  mean, std)[0]
            else:
                # reference raises on unknown policies (img_utils.py:195-198)
                raise NotImplementedError(cfg.mm_image_aspect_ratio)
            conv = normalize_mm_turn(rec["conversations"])
            has_image = True
        else:
            if cfg.mm_image_aspect_ratio == "anyres":
                pixels = np.zeros((2, size, size, 3), np.float32)
            else:
                pixels = np.zeros((size, size, 3), np.float32)
            image_size = (size, size)
            conv = rec["conversations"]
            has_image = False
        out = preprocess_conv(conv, self.tokenizer, has_image=has_image,
                              model_max_length=cfg.model_max_length,
                              arch=cfg.text.arch)
        ids = out["input_ids"]
        keep = ids != IMAGE_TOKEN_INDEX
        return {
            "input_ids": ids[keep].astype(np.int32),
            "labels": out["labels"][keep].astype(np.int32),
            "pixels": np.asarray(pixels, np.float32),
            "image_size": np.asarray(image_size, np.int32),
            "has_image": has_image,
            # anyres: (gw, gh) grid the tiles came from — static per sample,
            # consumed by encode_images(grid_shape=...) at batch=1
            "grid_shape": grid_shape,
        }


def collate_images(samples: List[Dict], cfg: DattnConfig, *,
                   text_buckets: Sequence[int] = (128, 256, 512, 1024, 2048, 4096),
                   tile_buckets: Sequence[int] = (2, 3, 5, 7, 10, 13, 17),
                   ) -> Dict[str, np.ndarray]:
    """Dense batch for the image path. Plain policies give images
    [B, H, W, 3]; anyres gives [B, P, H, W, 3] padded to a tile-count bucket
    (base view + grid tiles) plus "grids" [B, 2] int32 per-sample (gw, gh) —
    the batched form of the reference's variable-tile list path
    (multimodal.py:271-315); invalid padding tiles are masked inside
    encode_images from gw*gh."""
    b = len(samples)
    t = _bucket(max(len(s["input_ids"]) for s in samples),
                [x for x in text_buckets if x <= cfg.model_max_length]
                or [cfg.model_max_length])
    s_img = cfg.vision.image_size
    anyres = samples[0]["pixels"].ndim == 4
    if anyres:
        p = _bucket(max(s["pixels"].shape[0] for s in samples), tile_buckets)
        images = np.zeros((b, p, s_img, s_img, 3), np.float32)
    else:
        images = np.zeros((b, s_img, s_img, 3), np.float32)

    batch = {
        "input_ids": np.zeros((b, t), np.int32),
        "labels": np.full((b, t), IGNORE_INDEX, np.int32),
        "text_mask": np.zeros((b, t), bool),
        "images": images,
        "image_sizes": np.zeros((b, 2), np.int32),
    }
    if anyres:
        batch["grids"] = np.ones((b, 2), np.int32)
    for i, s in enumerate(samples):
        L = min(len(s["input_ids"]), t)
        batch["input_ids"][i, :L] = s["input_ids"][:L]
        batch["labels"][i, :L] = s["labels"][:L]
        batch["text_mask"][i, :L] = True
        if s["has_image"]:
            if anyres:
                batch["images"][i, : s["pixels"].shape[0]] = s["pixels"]
            else:
                batch["images"][i] = s["pixels"]
        if anyres and s.get("grid_shape") is not None:
            batch["grids"][i] = s["grid_shape"]
        batch["image_sizes"][i] = s["image_size"]
    return batch


def collate(
    samples: List[Dict],
    cfg: DattnConfig,
    *,
    text_buckets: Sequence[int] = (128, 256, 512, 1024, 2048, 4096),
    frame_buckets: Sequence[int] = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096),
    window_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
) -> Dict[str, np.ndarray]:
    b = len(samples)
    t = _bucket(max(len(s["input_ids"]) for s in samples),
                [x for x in text_buckets if x <= cfg.model_max_length] or [cfg.model_max_length])
    n = _bucket(max(s["pixels"].shape[0] for s in samples), frame_buckets)
    w = _bucket(max(s["mels"].shape[0] for s in samples), window_buckets)
    s_img = cfg.vision.image_size

    batch = {
        "input_ids": np.zeros((b, t), np.int32),
        "labels": np.full((b, t), IGNORE_INDEX, np.int32),
        "text_mask": np.zeros((b, t), bool),
        "images": np.zeros((b, n, s_img, s_img, 3), np.float32),
        "frame_counts": np.zeros((b,), np.int32),
        "mels": np.zeros((b, w, cfg.audio.num_mel_bins, cfg.audio.nb_max_frames),
                         np.float32),
        "audio_sizes": np.zeros((b,), np.int32),
    }
    for i, s in enumerate(samples):
        L = min(len(s["input_ids"]), t)
        batch["input_ids"][i, :L] = s["input_ids"][:L]
        batch["labels"][i, :L] = s["labels"][:L]
        batch["text_mask"][i, :L] = True
        nf = min(s["pixels"].shape[0], n)
        batch["images"][i, :nf] = s["pixels"][:nf]
        batch["frame_counts"][i] = nf if s["has_image"] else 0
        nw = min(s["mels"].shape[0], w)
        batch["mels"][i, :nw] = s["mels"][:nw]
        batch["audio_sizes"][i] = min(s["audio_len"], nw * cfg.audio.nb_max_frames) \
            if s["has_image"] else 0
    return batch


def synthetic_batch(cfg: DattnConfig, b: int = 1, t: int = 64, n_frames: int = 4,
                    n_windows: int = 1, seed: int = 0) -> Dict[str, np.ndarray]:
    """Weightless smoke-test batch (no media files needed)."""
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    labels = rng.integers(3, min(cfg.text.vocab_size, 259), (b, t)).astype(np.int32)
    labels[:, : t // 2] = IGNORE_INDEX
    return {
        "input_ids": rng.integers(3, min(cfg.text.vocab_size, 259), (b, t)).astype(np.int32),
        "labels": labels,
        "text_mask": np.ones((b, t), bool),
        "images": rng.standard_normal((b, n_frames, s, s, 3)).astype(np.float32),
        "frame_counts": np.full((b,), n_frames, np.int32),
        "mels": rng.standard_normal(
            (b, n_windows, cfg.audio.num_mel_bins, cfg.audio.nb_max_frames)
        ).astype(np.float32),
        "audio_sizes": np.full((b,), n_windows * cfg.audio.nb_max_frames, np.int32),
    }


def synthetic_image_batch(cfg: DattnConfig, b: int = 1, t: int = 64,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """Weightless smoke-test batch for the image path (mm_input_type="image",
    collate_images layout)."""
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    labels = rng.integers(3, min(cfg.text.vocab_size, 259), (b, t)).astype(np.int32)
    labels[:, : t // 2] = IGNORE_INDEX
    return {
        "input_ids": rng.integers(3, min(cfg.text.vocab_size, 259), (b, t)).astype(np.int32),
        "labels": labels,
        "text_mask": np.ones((b, t), bool),
        "images": rng.standard_normal((b, s, s, 3)).astype(np.float32),
        "image_sizes": np.full((b, 2), s, np.int32),
    }


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on `device`; integer arrays become int64."""
    out = {}
    for key, val in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(val))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        out[key] = t.to(device)
    return out
