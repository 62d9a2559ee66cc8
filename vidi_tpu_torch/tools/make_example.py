"""Generate the finetune smoke fixture: a synthetic test clip + example.json
(port of scripts/make_example.py).

The reference ships `Vidi1.5_9B/example.json` pointing 48 copies of one
conversation at a bundled 25 s dummy.mp4 (reference: Vidi1.5_9B/README.md:20-28).
We synthesize our own clip (moving gradient, cv2 VideoWriter) instead of
shipping binary media.

    python -m vidi_tpu_torch.tools.make_example [--out-dir .] [--seconds 25] [--copies 48]
"""
from __future__ import annotations

import argparse
import json
import os


def make_video(path: str, seconds: float, fps: int = 5, size: int = 128) -> float:
    import cv2
    import numpy as np

    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(path, fourcc, fps, (size, size))
    n = int(seconds * fps)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        t = i / max(n - 1, 1)
        frame = np.stack([
            (xx * 255 * t) % 255,
            (yy * 255 * (1 - t)) % 255,
            ((xx + yy) * 127.5 + i) % 255,
        ], axis=-1).astype(np.uint8)
        writer.write(frame)
    writer.release()

    from vidi_tpu_torch.media.video import get_media_length
    return get_media_length(path)


def write_example(out_dir: str, seconds: float = 25.0, copies: int = 48) -> str:
    """Write dummy.mp4, example.json, dummy.png and example_images.json into
    `out_dir` -> the path of example.json."""
    os.makedirs(out_dir, exist_ok=True)
    vid_path = os.path.join(out_dir, "dummy.mp4")
    duration = make_video(vid_path, seconds)

    conv = {
        "video": "dummy.mp4",
        "length": duration,
        "conversations": [
            {"from": "human",
             "value": "<image>\nDuring which time segments in the video can "
                      "we see a moving gradient?"},
            {"from": "gpt", "value": "0.000-1.000"},
        ],
    }
    records = [conv for _ in range(copies)]
    out = os.path.join(out_dir, "example.json")
    with open(out, "w") as f:
        json.dump(records, f, indent=1)
    print(f"wrote {vid_path} ({duration:.2f}s) and {out} ({copies} records)")

    # image-conv stage fixture (train --dataset_type image-conv)
    from PIL import Image
    import numpy as np

    rng = np.random.default_rng(0)
    img_path = os.path.join(out_dir, "dummy.png")
    Image.fromarray(rng.integers(0, 255, (96, 128, 3), np.uint8)).save(img_path)
    img_conv = {
        "image": "dummy.png",
        "conversations": [
            {"from": "human", "value": "<image>\nWhat is in the image?"},
            {"from": "gpt", "value": "Random noise."},
        ],
    }
    out_img = os.path.join(out_dir, "example_images.json")
    with open(out_img, "w") as f:
        json.dump([img_conv for _ in range(copies)], f, indent=1)
    print(f"wrote {img_path} and {out_img} ({copies} records)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--copies", type=int, default=48)
    args = ap.parse_args(argv)
    write_example(args.out_dir, args.seconds, args.copies)


if __name__ == "__main__":
    main()
