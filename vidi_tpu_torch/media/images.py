"""Image / frame preprocessing (host side).

Replaces SiglipImageProcessor + the reference's aspect policies
(reference: Vidi1.5_9B/vidi/dataset/img_utils.py:173-198). The "resize"
policy — the one used for video (finetune.sh:20, dataset/video.py:71) — is
PIL bicubic resize to (S, S), rescale 1/255, normalize mean=std=0.5.

Output layout is NHWC float32 (our towers are NHWC; the reference is NCHW).
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
from PIL import Image

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


def _to_pil(frame) -> Image.Image:
    if isinstance(frame, Image.Image):
        return frame
    return Image.fromarray(np.asarray(frame)).convert("RGB")


def normalize_pixels(arr: np.ndarray, mean=SIGLIP_MEAN, std=SIGLIP_STD) -> np.ndarray:
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return ((arr.astype(np.float32) / 255.0) - mean) / std


def preprocess_frames_resize(
    frames: Sequence, output_size: int = 384,
    mean=SIGLIP_MEAN, std=SIGLIP_STD,
) -> np.ndarray:
    """"resize" aspect policy -> [N, S, S, 3] float32."""
    out = np.empty((len(frames), output_size, output_size, 3), np.float32)
    for i, f in enumerate(frames):
        img = _to_pil(f).resize((output_size, output_size), resample=Image.BICUBIC)
        out[i] = normalize_pixels(np.asarray(img), mean, std)
    return out


def resize_frames_uint8(frames: Sequence, output_size: int = 384) -> np.ndarray:
    """"resize" policy, host half only: PIL bicubic to (S, S), kept uint8
    -> [N, S, S, 3]. The rescale/normalize half runs on device
    (ops/preprocess.normalize_uint8, dispatched by frame dtype in
    dattn._frame_tokens) — the frames cross the host link at 1/4 the
    float32 bytes with bit-identical resampling."""
    out = np.empty((len(frames), output_size, output_size, 3), np.uint8)
    for i, f in enumerate(frames):
        img = _to_pil(f).resize((output_size, output_size), resample=Image.BICUBIC)
        out[i] = np.asarray(img)
    return out


def expand2square(img: Image.Image, fill: Tuple[int, int, int]) -> Image.Image:
    """Pad to square with the mean color (img_utils.py:159-171)."""
    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    out = Image.new(img.mode, (side, side), fill)
    out.paste(img, ((side - w) // 2, (side - h) // 2))
    return out


def preprocess_frames_pad(frames: Sequence, output_size: int = 384,
                          mean=SIGLIP_MEAN, std=SIGLIP_STD) -> np.ndarray:
    fill = tuple(int(m * 255) for m in np.broadcast_to(np.asarray(mean), (3,)))
    padded = [expand2square(_to_pil(f), fill) for f in frames]
    return preprocess_frames_resize(padded, output_size, mean, std)


def preprocess_frames_crop(frames: Sequence, output_size: int = 224,
                           mean=CLIP_MEAN, std=CLIP_STD) -> np.ndarray:
    """"crop" aspect policy = the HF processor default (img_utils.py:194-195):
    shortest-edge bicubic resize to `output_size`, then center crop."""
    out = np.empty((len(frames), output_size, output_size, 3), np.float32)
    for i, f in enumerate(frames):
        img = _to_pil(f)
        w, h = img.size
        if w <= h:
            nw, nh = output_size, max(round(h * output_size / w), output_size)
        else:
            nh, nw = output_size, max(round(w * output_size / h), output_size)
        img = img.resize((nw, nh), resample=Image.BICUBIC)
        left = (nw - output_size) // 2
        top = (nh - output_size) // 2
        img = img.crop((left, top, left + output_size, top + output_size))
        out[i] = normalize_pixels(np.asarray(img), mean, std)
    return out


# ---------------------------------------------------------------------------
# anyres (image mode) — grid selection (img_utils.py:16-43,103-120)
# ---------------------------------------------------------------------------

def select_best_resolution(original_size: Tuple[int, int],
                           possible: Iterable[Tuple[int, int]]) -> Tuple[int, int]:
    ow, oh = original_size
    best, best_eff, best_waste = None, 0, float("inf")
    for w, h in possible:
        scale = min(w / ow, h / oh)
        eff = min(int(ow * scale) * int(oh * scale), ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (w, h), eff, waste
    return best


def get_anyres_grid_shape(image_size: Tuple[int, int],
                          grid_res: Sequence[Tuple[int, int]],
                          patch_px: int) -> Tuple[int, int]:
    w, h = select_best_resolution(image_size, grid_res)
    return w // patch_px, h // patch_px


def resize_and_pad(img: Image.Image, target: Tuple[int, int]) -> Image.Image:
    """Aspect-preserving resize then center-pad (img_utils.py:45-77)."""
    import math
    ow, oh = img.size
    tw, th = target
    sw, sh = tw / ow, th / oh
    if sw < sh:
        nw, nh = tw, min(math.ceil(oh * sw), th)
    else:
        nh, nw = th, min(math.ceil(ow * sh), tw)
    resized = img.resize((nw, nh), resample=Image.BICUBIC)
    out = Image.new("RGB", (tw, th), (0, 0, 0))
    out.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return out


def divide_to_patches(img: Image.Image, patch_px: int) -> List[Image.Image]:
    patches = []
    w, h = img.size
    for top in range(0, h, patch_px):
        for left in range(0, w, patch_px):
            patches.append(img.crop((left, top, left + patch_px, top + patch_px)))
    return patches


def process_anyres_image(img: Image.Image, output_size: int,
                         grid_res: Sequence[Tuple[int, int]],
                         mean=SIGLIP_MEAN, std=SIGLIP_STD) -> np.ndarray:
    """-> [1 + n_patches, S, S, 3]: global resize view + grid crops.

    The reference resizes directly to the best grid resolution (the
    resize-and-pad variant is commented out, img_utils.py:141-142)."""
    best = select_best_resolution(img.size, grid_res)
    resized = img.resize(best, resample=Image.BICUBIC)
    patches = divide_to_patches(resized, output_size)
    base = img.resize((output_size, output_size), resample=Image.BICUBIC)
    return preprocess_frames_resize([base] + patches, output_size, mean, std)


# ---------------------------------------------------------------------------
# slideshow (document-style scan order, img_utils.py:201-314)
# ---------------------------------------------------------------------------

def divide_to_slides(img: Image.Image, patch_px: int, min_interval: float,
                     max_interval: float, rng: np.random.Generator):
    """Overlapping patch sweep in a random boustrophedon scan order.
    Returns (patches, boxes) in scan order (img_utils.py:201-266)."""
    import itertools

    patches, boxes = [], []
    width, height = img.size
    interval_h = rng.uniform(min_interval, max_interval)
    interval_w = rng.uniform(min_interval, max_interval)
    starting_point = int(rng.integers(0, 3, endpoint=True))

    if starting_point in (0, 1):  # row-major, alternating direction
        reverse_flag = starting_point == 1
        for i in range(0, height - patch_px + 1, int(patch_px / interval_h)):
            row_p, row_b = [], []
            for j in range(0, width - patch_px + 1, int(patch_px / interval_w)):
                box = (j, i, j + patch_px, i + patch_px)
                row_b.append(box)
                row_p.append(img.crop(box))
            if reverse_flag:
                boxes.append(row_b[::-1])
                patches.append(row_p[::-1])
            else:
                boxes.append(row_b)
                patches.append(row_p)
            reverse_flag = not reverse_flag
    else:  # column-major, alternating direction
        reverse_flag = starting_point == 3
        for j in range(0, width - patch_px + 1, int(patch_px / interval_w)):
            col_p, col_b = [], []
            for i in range(0, height - patch_px + 1, int(patch_px / interval_h)):
                box = (j, i, j + patch_px, i + patch_px)
                col_b.append(box)
                col_p.append(img.crop(box))
            if reverse_flag:
                boxes.append(col_b[::-1])
                patches.append(col_p[::-1])
            else:
                boxes.append(col_b)
                patches.append(col_p)
            reverse_flag = not reverse_flag

    if int(rng.integers(0, 1, endpoint=True)) == 1:
        patches.reverse()
        boxes.reverse()
    patches = list(itertools.chain.from_iterable(patches))
    boxes = list(itertools.chain.from_iterable(boxes))
    return patches, boxes


def process_slideshow_image(
    img: Image.Image, output_size: int,
    min_scale: float = 2.0, max_scale: float = 4.0,
    min_interval: float = 2.0, max_interval: float = 6.0,
    rng: np.random.Generator = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Upscale the document image by a random factor, sweep overlapping
    output_size patches in scan order, return (pixels [P, S, S, 3],
    boxes [P, 4] normalized) (img_utils.py:269-314)."""
    import math
    if rng is None:
        rng = np.random.default_rng()

    w, h = img.size
    if w < h:
        _h = math.ceil(rng.uniform(min_scale, max_scale) * output_size)
        _w = math.ceil(w * _h / h)
        if _w < output_size:
            _w = output_size
            _h = math.ceil(h * _w / w)
    else:
        _w = math.ceil(rng.uniform(min_scale, max_scale) * output_size)
        _h = math.ceil(h * _w / w)
        if _h < output_size:
            _h = output_size
            _w = math.ceil(w * _h / h)
    resized = img.resize((_w, _h), resample=Image.BICUBIC)

    patches, boxes = divide_to_slides(
        resized, output_size, min_interval, max_interval, rng)
    pixels = preprocess_frames_resize(patches, output_size)
    boxes = np.asarray(boxes, float)
    boxes[:, 0] /= _w
    boxes[:, 1] /= _h
    boxes[:, 2] /= _w
    boxes[:, 3] /= _h
    return pixels, boxes
